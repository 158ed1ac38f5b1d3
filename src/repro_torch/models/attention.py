"""GQA self-attention: full-sequence prefill and KV-cache decode
(``repro.models.attention``).

Features required by the assigned architectures: grouped-query attention,
rotary or no positions, sliding windows (gemma2 local layers and the
long-context variant), attention-logit softcaps (gemma2), QK-RMSNorm
(qwen3), QKV biases (qwen2/internvl), custom query scale (gemma2).

Prefill (``attention_train``) has two routes, chosen by
``attention_route``:
- ``"flash"``: the flash-attention kernel (K9, ``kernels.ops.flash_mha``),
  causal, on the rope'd and pre-scaled queries, with the layer's sliding
  window (gemma2's local layers, the long-context variant) and the
  config's logit softcap (gemma2) computed in the kernel. The default on
  CUDA.
- ``"plain"``: ``repro``'s query-chunked scan as a loop over
  ``cfg.attn_chunk`` query rows, so the (chunk, S) score tile is the only
  score buffer. The default on the CPU, and what the comparisons on the
  card call by name. Training takes it by name on every device, each
  chunk recomputed in the backward (``repro``'s ``jax.checkpoint``
  chunk): K9 has no backward, and neither has ``repro``'s kernel.

Decode (``attention_decode``) is plain torch on every device, as ``repro``'s
is plain XLA: a ring-buffer cache whose ``slot_pos`` tracks the absolute
position in each slot, which makes the sliding-window mask implicit
(overwritten slots fall out of the window). The cache is written in place.

Over a mesh (`repro_torch.sharding.ctx`) a rank computes the heads that
``head_slice`` gives it from the rules' specs: its H/M query heads where
``wq`` is sharded over ``model`` (then ``wo``'s partial sums are reduced
over ``model`` by the caller), the local KV heads where ``wk`` is sharded,
else the whole KV set, of which attention reads the heads its query heads
map to (query head h reads KV head h // (H / KV)). Every function here
takes its head counts from the tensors it is given.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import recording
from repro_torch.kernels.ops import flash_mha
from repro_torch.models.layers import (Params, checkpointed, rope, rounded,
                                       softcap, truncated_normal)

NEG_INF = -2.0 ** 30  # large-but-finite: keeps padded rows NaN-free

ROUTES = ("flash", "plain")


def attn_init(cfg: ModelConfig, *, generator, device) -> Params:
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    draw = dict(generator=generator, device=device)
    p: Params = {
        "wq": truncated_normal((d, h, hd), d ** -0.5, **draw),
        "wk": truncated_normal((d, kv, hd), d ** -0.5, **draw),
        "wv": truncated_normal((d, kv, hd), d ** -0.5, **draw),
        "wo": truncated_normal((h, hd, d), (h * hd) ** -0.5, **draw),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), device=device)
        p["bk"] = torch.zeros((kv, hd), device=device)
        p["bv"] = torch.zeros((kv, hd), device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), device=device)
        p["k_norm"] = torch.ones((hd,), device=device)
    return p


def _qkv(cfg: ModelConfig, p: Params, x: torch.Tensor):
    dt = x.dtype
    q = torch.einsum("btd,dhk->bthk", x, p["wq"].to(dt))
    k = torch.einsum("btd,dgk->btgk", x, p["wk"].to(dt))
    v = torch.einsum("btd,dgk->btgk", x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.qk_norm:
        q = _rms(q) * p["q_norm"].to(dt)
        k = _rms(k) * p["k_norm"].to(dt)
    return q, k, v


def _rms(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + eps)
    return y.to(x.dtype)


def _scale(cfg: ModelConfig) -> float:
    return (cfg.query_scale if cfg.query_scale is not None
            else cfg.resolved_head_dim ** -0.5)


class HeadSlice(NamedTuple):
    """The heads a model rank computes. ``kv`` picks, out of the KV heads
    it projects (its local ones, or all), the run its query heads read
    (None: all). ``reduce``: ``wo``'s output is a partial sum over
    ``model``."""

    kv: Optional[slice]
    reduce: bool


def head_slice(cfg: ModelConfig, spec, plan) -> HeadSlice:
    """The rank's heads under ``spec`` (the attention dict's specs) on
    ``plan`` (`repro_torch.sharding.ctx.RankPlan`)."""
    if not plan.model_sharded(spec["wq"], 1):
        return HeadSlice(None, False)       # whole on every model rank
    if plan.model_sharded(spec["wk"], 1):
        return HeadSlice(None, True)        # local KV heads, rep kept
    h, kv = cfg.num_heads, cfg.num_kv_heads
    rep = h // kv
    hl = h // plan.m_size
    h0 = plan.m * hl
    lo, hi = h0 // rep, (h0 + hl - 1) // rep + 1
    # K9 maps local query head j to KV head j // (hl / (hi - lo))
    if hl % (hi - lo) or any((h0 + j) // rep != lo + j * (hi - lo) // hl
                             for j in range(hl)):
        raise ValueError(f"{cfg.name}: a model rank's {hl} query heads "
                         f"read their {hi - lo} KV heads unevenly")
    return HeadSlice(slice(lo, hi), True)


def select_kv(t: torch.Tensor, sel: Optional[slice],
              dim: int = 2) -> torch.Tensor:
    """The KV heads ``sel`` (``HeadSlice.kv``) of ``t`` along ``dim``."""
    if sel is None:
        return t
    return t.narrow(dim, sel.start, sel.stop - sel.start)


# ---------------------------------------------------------------------------
# prefill — K9, or the q-chunked causal scan
# ---------------------------------------------------------------------------

def attention_route(device, attention: Optional[str] = None) -> str:
    """The route of a full-sequence attention: ``"flash"`` (K9) or
    ``"plain"`` (the chunked scan).

    ``attention`` None picks by device: the plain scan on the CPU, K9
    elsewhere. ``"plain"`` is taken on any device when asked for by name;
    ``"flash"`` on the CPU runs K9's plain twin. K9 computes causal softmax
    attention with the layer's sliding window and the config's logit
    softcap, so every layer of every config has the K9 route.
    """
    if attention is not None and attention not in ROUTES:
        raise ValueError(f"attention={attention!r}; expected one of "
                         f"{ROUTES} or None")
    if attention == "plain" or (attention is None
                                and torch.device(device).type == "cpu"):
        return "plain"
    return "flash"


def _chunked_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, positions: torch.Tensor,
                       window: Optional[int]) -> torch.Tensor:
    """``repro``'s scan over query chunks. q (B, S, H, hd), pre-scaled;
    k, v (B, S, KV, hd) → (B, S, H, hd). The bf16 logits are cast to fp32
    before the mask and the softmax, as in ``repro``. Where autograd
    records, each chunk runs under ``torch.utils.checkpoint`` and is
    recomputed in the backward, as ``repro``'s ``jax.checkpoint`` chunk is:
    no (chunk, S) score tile outlives its chunk."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    rep = h // kv
    # pad queries to the chunk grid; padded rows are sliced off afterwards
    # and padded keys are masked out by the causal test (their positions
    # exceed every real query position).
    c = min(cfg.attn_chunk, s)
    s_pad = ((s + c - 1) // c) * c
    kpos = positions.expand(s)
    qpos_all = kpos
    if s_pad != s:
        qpos_all = torch.cat([kpos, kpos[-1] + 1 + torch.arange(
            s_pad - s, device=kpos.device)])
    qg = q.reshape(b, s, kv, rep, hd)
    if s_pad != s:
        qg = torch.nn.functional.pad(qg, (0, 0, 0, 0, 0, 0, 0, s_pad - s))

    def chunk(qi, qpos, k, v):
        logits = torch.einsum("bqgrk,bsgk->bgrqs", qi, k)  # (B,kv,rep,c,S)
        logits = softcap(logits, cfg.attn_logit_softcap)
        mask = qpos[:, None] >= kpos[None, :]              # causal (c, S)
        if window is not None:
            mask &= qpos[:, None] - kpos[None, :] < window
        logits = torch.where(mask, logits.float(), NEG_INF)
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        return torch.einsum("bgrqs,bsgk->bqgrk", w, v)

    if recording(q, k, v):
        chunk = checkpointed(chunk)
    outs = [chunk(qg[:, i * c:(i + 1) * c], qpos_all[i * c:(i + 1) * c], k,
                  v) for i in range(s_pad // c)]
    return torch.cat(outs, dim=1).reshape(b, s_pad, h, hd)[:, :s]


def prefill_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor):
    """q, k, v of a full sequence as both routes take them: rope'd, and q
    multiplied by the scale rounded to q's dtype and rounded once after
    it, as in ``repro``. K9 then runs at scale 1 on the very q the plain
    scan uses."""
    q, k, v = _qkv(cfg, p, x)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q * rounded(_scale(cfg), q.dtype), k, v


def attention_train(cfg: ModelConfig, p: Params, x: torch.Tensor,
                    window: Optional[int] = None,
                    positions: Optional[torch.Tensor] = None, *,
                    attention: Optional[str] = None,
                    heads: Optional[HeadSlice] = None) -> torch.Tensor:
    """Causal (optionally sliding-window) self-attention over full
    sequences. x: (B, S, D) → (B, S, D); positions (S,) default to
    arange(S), the only positions the K9 route takes (its causal mask is
    by index). ``attention`` picks the route (``attention_route``).
    ``heads``: a model rank's (``head_slice``); ``p`` then holds its
    heads, and the output is its partial sum where ``heads.reduce``."""
    route = attention_route(x.device, attention)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    q, k, v = prefill_qkv(cfg, p, x, positions)
    if heads is not None:
        k, v = select_kv(k, heads.kv), select_kv(v, heads.kv)
    if route == "flash":
        out = flash_mha(q, k, v, causal=True, scale=1.0, window=window,
                        softcap=cfg.attn_logit_softcap)
    else:
        out = _chunked_attention(cfg, q, k, v, positions, window)
    return torch.einsum("bthk,hkd->btd", out, p["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# decode — ring-buffer KV cache
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor          # (B, W, kv, hd) — rope already applied
    v: torch.Tensor          # (B, W, kv, hd)
    slot_pos: torch.Tensor   # (B, W) int32 absolute position per slot (−1)


def init_cache(cfg: ModelConfig, batch: int, window: int,
               dtype=torch.bfloat16, device=None) -> KVCache:
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return KVCache(
        k=torch.zeros((batch, window, kv, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, window, kv, hd), dtype=dtype, device=device),
        slot_pos=torch.full((batch, window), -1, dtype=torch.int32,
                            device=device),
    )


def attention_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     cache: KVCache, pos: torch.Tensor,
                     window: Optional[int] = None,
                     heads: Optional[HeadSlice] = None
                     ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode. x: (B, 1, D); pos: (B,) absolute positions.

    The new token's K/V overwrite slot ``pos % W`` (ring), in place.
    Attention runs over the updated cache; masking = slot occupied ∧
    causal ∧ (window if given). Returns (y, the same cache). ``heads``: a
    model rank's; the cache then holds the KV heads ``p`` projects.
    """
    b = x.shape[0]
    w_slots = cache.k.shape[1]

    q, k, v = _qkv(cfg, p, x)                    # q (B,1,h,hd), k/v (B,1,kv,hd)
    if cfg.use_rope:
        q = rope(q, pos[:, None], cfg.rope_theta)
        k = rope(k, pos[:, None], cfg.rope_theta)
    q = q * rounded(_scale(cfg), q.dtype)

    slot = (pos % w_slots).long()                # (B,)
    index = (torch.arange(b, device=x.device), slot)
    cache.k.index_put_(index, k[:, 0].to(cache.k.dtype))
    cache.v.index_put_(index, v[:, 0].to(cache.v.dtype))
    cache.slot_pos.index_put_(index, pos.to(torch.int32))

    sel = None if heads is None else heads.kv
    ck, cv = select_kv(cache.k, sel), select_kv(cache.v, sel)
    h, kv, hd = q.shape[2], ck.shape[2], q.shape[3]
    qg = q.reshape(b, kv, h // kv, hd)
    logits = torch.einsum("bgrk,bsgk->bgrs", qg, ck.to(q.dtype))
    logits = softcap(logits, cfg.attn_logit_softcap)
    sp = cache.slot_pos
    valid = (sp >= 0) & (sp <= pos[:, None])     # (B, W)
    if window is not None:
        valid &= sp > (pos[:, None] - window)
    logits = torch.where(valid[:, None, None, :], logits.float(), NEG_INF)
    wgt = torch.softmax(logits, dim=-1).to(cv.dtype)
    out = torch.einsum("bgrs,bsgk->bgrk", wgt, cv).reshape(b, 1, h, hd)
    y = torch.einsum("bthk,hkd->btd", out.to(x.dtype), p["wo"].to(x.dtype))
    return y, cache
