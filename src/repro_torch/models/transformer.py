"""Decoder assembly for every architecture of the LM template
(``repro.models.transformer``).

``repro`` segments the per-layer ``layer_pattern`` into stages of
``(cycle, reps)``, stacks a stage's parameters on a leading ``reps`` axis
and applies them with ``lax.scan``. The port keeps ``segment_pattern`` and
``stage_layout`` (the checkpoint layout, `repro_torch.convert`), but holds
one parameter dict a layer, ``params["layers"][i]`` for
``cfg.pattern[i]``, and applies the layers one after another.

Served here, for full-sequence prefill (``forward``) and single-token
decode (``decode_step``), and trained (``loss_fn``): the ``ATTN``,
``ATTN_LOCAL`` and ``ATTN_PARALLEL`` blocks, the ``MOE`` block
(`repro_torch.models.moe`),
the recurrent blocks ``MAMBA2``, ``MLSTM`` and ``SLSTM``
(`repro_torch.models.recurrent`), ``MAMBA2_SHARED`` with zamba2's shared
attention block (one parameter set, ``params["shared_attn"]``, applied at
many depths to the concatenation of the stream and the embedded input),
the VLM patch-embedding prefix and MusicGen's multi-codebook embedding and
readout. Sharding over a mesh raises naming ROADMAP §1 item 10.4.

Training runs on the fp32 masters (``init_params``), each weight cast to
``cfg.dtype`` at its use, so the gradients reach the masters in fp32;
never on the serving copy from ``cast_params``. With ``cfg.remat`` each
layer (a ``MAMBA2_SHARED`` layer with the shared block it applies) runs
under ``torch.utils.checkpoint`` and is recomputed in the backward.
``repro`` checkpoints a stage's scanned cycle body; with one parameter
dict a layer the port checkpoints one layer: the same values, and a cycle
of several layers (gemma2's local/global pair) keeps one boundary more.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import (ATTN, ATTN_LOCAL, ATTN_PARALLEL, MAMBA2,
                                      MAMBA2_SHARED, MLSTM, MOE, SLSTM,
                                      ModelConfig, effective_window)
from repro_torch.core.types import resolve_device
from repro_torch.kernels.flash_attention import recording
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec_mod
from repro_torch.models.layers import (Params, apply_mlp, apply_norm,
                                       checkpointed, compute_dtype, mlp_init,
                                       norm_init, rounded, sinusoidal,
                                       softcap, truncated_normal)
from repro_torch.models.moe import mesh_not_ported

AuxDict = Dict[str, torch.Tensor]

# what ``cast_params`` leaves in the param dtype: the parameter dicts
# ``norm_init`` makes, and the leaves ``repro`` reads in fp32 (not cast to
# ``cfg.dtype`` at use): Mamba2's ``dt_bias`` and ``a_log``, the recurrent
# blocks' ``norm_scale``, the sLSTM's recurrent ``r``
KEEP_FP32 = frozenset({"norm", "norm1", "norm2", "norm1_post", "norm2_post",
                       "norm_in", "final_norm", "dt_bias", "a_log",
                       "norm_scale", "r"})


def check_ctx(ctx=None) -> None:
    """Raise for a mesh: one card runs with ``ctx=None``."""
    if ctx is not None:
        raise mesh_not_ported()


# ---------------------------------------------------------------------------
# pattern segmentation
# ---------------------------------------------------------------------------

def segment_pattern(pattern: Sequence[str],
                    max_cycle: int = 8) -> List[Tuple[Tuple[str, ...], int]]:
    """Greedy left-to-right factorisation into (cycle, reps) stages."""
    segs: List[Tuple[Tuple[str, ...], int]] = []
    i, L = 0, len(pattern)
    while i < L:
        best_p, best_r = 1, 1
        for p in range(1, max_cycle + 1):
            if i + p > L:
                break
            r = 1
            while (i + p * (r + 1) <= L
                   and tuple(pattern[i + p * r: i + p * (r + 1)])
                   == tuple(pattern[i: i + p])):
                r += 1
            # only multi-layer cycles that actually repeat are worth a
            # stage; otherwise emit single layers
            if r >= 2 and p * r > best_p * best_r:
                best_p, best_r = p, r
        segs.append((tuple(pattern[i: i + best_p]), best_r))
        i += best_p * best_r
    # merge adjacent single-kind stages of the same kind
    merged: List[Tuple[Tuple[str, ...], int]] = []
    for cyc, reps in segs:
        if merged and merged[-1][0] == cyc:
            merged[-1] = (cyc, merged[-1][1] + reps)
        else:
            merged.append((cyc, reps))
    return merged


def stage_layout(cfg: ModelConfig) -> List[Tuple[Tuple[str, ...], int]]:
    return segment_pattern(cfg.pattern)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _attn_layer_init(cfg: ModelConfig, moe: bool, *, generator,
                     device) -> Params:
    draw = dict(generator=generator, device=device)
    p: Params = {"norm1": norm_init(cfg, cfg.d_model, device),
                 "attn": attn_mod.attn_init(cfg, **draw),
                 "norm2": norm_init(cfg, cfg.d_model, device)}
    if moe:
        p["moe"] = moe_mod.moe_init(cfg, **draw)
    else:
        p["mlp"] = mlp_init(cfg, cfg.d_model, cfg.dense_d_ff or cfg.d_ff,
                            gated=cfg.mlp_gated, **draw)
    if cfg.post_block_norm:
        p["norm1_post"] = norm_init(cfg, cfg.d_model, device)
        p["norm2_post"] = norm_init(cfg, cfg.d_model, device)
    return p


def layer_init(cfg: ModelConfig, kind: str, *, generator, device) -> Params:
    draw = dict(generator=generator, device=device)
    if kind in (ATTN, ATTN_LOCAL, MOE):
        return _attn_layer_init(cfg, kind == MOE, **draw)
    if kind == ATTN_PARALLEL:
        return {"norm": norm_init(cfg, cfg.d_model, device),
                "attn": attn_mod.attn_init(cfg, **draw),
                "mlp": mlp_init(cfg, cfg.d_model, cfg.d_ff,
                                gated=cfg.mlp_gated, **draw)}
    if kind in (MAMBA2, MAMBA2_SHARED):
        return {"norm": norm_init(cfg, cfg.d_model, device),
                "mamba": rec_mod.mamba2_init(cfg, **draw)}
    if kind == MLSTM:
        return {"norm": norm_init(cfg, cfg.d_model, device),
                "cell": rec_mod.mlstm_init(cfg, **draw)}
    if kind == SLSTM:
        return {"norm": norm_init(cfg, cfg.d_model, device),
                "cell": rec_mod.slstm_init(cfg, **draw)}
    raise ValueError(kind)


def shared_attn_init(cfg: ModelConfig, *, generator, device) -> Params:
    """Zamba2 shared block: consumes concat(x, emb0) (2D → D) then
    attn + MLP."""
    draw = dict(generator=generator, device=device)
    d2 = 2 * cfg.d_model
    return {"norm_in": norm_init(cfg, d2, device),
            "in_proj": truncated_normal((d2, cfg.d_model), d2 ** -0.5,
                                        **draw),
            "attn": attn_mod.attn_init(cfg, **draw),
            "norm2": norm_init(cfg, cfg.d_model, device),
            "mlp": mlp_init(cfg, cfg.d_model, cfg.d_ff, **draw)}


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None,
                cast: bool = False) -> Params:
    """Fresh parameters in ``cfg.param_dtype`` (fp32) from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (CUDA unless
    named): ``repro``'s shapes and distributions, not its draws. One dict
    a layer under ``"layers"``, zamba2's shared block under
    ``"shared_attn"``.

    ``cast`` returns the compute copy instead, each array cast as soon as
    it is drawn (one fp32 layer at a time beside the copy): the same
    draws, bit-equal to ``cast_params(cfg, init_params(cfg, seed))``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = dict(generator=gen, device=device)
    dtype = compute_dtype(cfg)

    def done(node, key=None):
        return _cast_tree(node, dtype, key) if cast else node

    d, v = cfg.d_model, cfg.vocab_size
    params: Params = {}
    if cfg.modality == "audio":
        params["embed"] = done(truncated_normal((cfg.num_codebooks, v, d),
                                                d ** -0.5, **draw))
        params["heads"] = done(truncated_normal((cfg.num_codebooks, d, v),
                                                d ** -0.5, **draw))
    else:
        params["embed"] = done(truncated_normal((v, d), d ** -0.5, **draw))
        if not cfg.tie_embeddings:
            params["lm_head"] = done(truncated_normal((d, v), d ** -0.5,
                                                      **draw))
    params["final_norm"] = norm_init(cfg, d, device)
    if MAMBA2_SHARED in cfg.pattern:
        params["shared_attn"] = done(shared_attn_init(cfg, **draw))
    params["layers"] = [done(layer_init(cfg, kind, **draw))
                        for kind in cfg.pattern]
    return params


def _cast_tree(node, dtype, key=None):
    if key in KEEP_FP32:
        return node
    if isinstance(node, dict):
        return {k: _cast_tree(v, dtype, k) for k, v in node.items()}
    if isinstance(node, list):
        return [_cast_tree(v, dtype) for v in node]
    return node.to(dtype)


def cast_params(cfg: ModelConfig, params: Params) -> Params:
    """The compute copy: every weight and bias in ``cfg.dtype``, the
    ``KEEP_FP32`` parameters as they are.

    ``repro`` casts each weight to ``cfg.dtype`` at every use; the cast is
    elementwise, so a copy made once computes the same bits, and at decode
    it is what a step reads (bf16: half the fp32 masters' bytes)."""
    return _cast_tree(params, compute_dtype(cfg))


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _zero_aux(cfg: ModelConfig, device) -> AuxDict:
    return {"lb_loss": torch.zeros((), device=device),
            "counts": torch.zeros((max(cfg.num_experts, 1),), device=device),
            "dropped": torch.zeros((), device=device)}


def _embed(cfg: ModelConfig, params: Params,
           batch: Dict[str, torch.Tensor],
           dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B, S, D), positions (S,)). Rows are gathered, then cast:
    ``repro`` casts the whole table first, the same bits."""
    tokens = batch["tokens"]
    emb = params["embed"]
    if cfg.modality == "audio":
        # tokens: (B, S, C) — sum the codebook embeddings
        x = sum(emb[c][tokens[..., c]].to(dtype)
                for c in range(cfg.num_codebooks))
    else:
        x = emb[tokens].to(dtype)                            # (B, S, D)
    if cfg.scale_embeddings:
        x = x * rounded(cfg.d_model ** 0.5, dtype)
    if cfg.modality == "vision" and "vision_embeds" in batch:
        x = torch.cat([batch["vision_embeds"].to(dtype), x], dim=1)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    if not cfg.use_rope and cfg.modality == "audio":
        x = x + sinusoidal(positions, cfg.d_model).to(dtype)[None]
    return x, positions


def _readout(cfg: ModelConfig, params: Params,
             x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    x = apply_norm(cfg, params["final_norm"], x)
    if cfg.modality == "audio":
        logits = torch.einsum("bsd,cdv->bscv", x, params["heads"].to(dt))
    elif cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"].to(dt))
    else:
        logits = x @ params["lm_head"].to(dt)
    if cfg.logit_scale != 1.0:
        logits = logits * rounded(cfg.logit_scale, dt)
    return softcap(logits, cfg.final_logit_softcap)


def _acc_aux(a: AuxDict, b: AuxDict) -> AuxDict:
    return {k: a[k] + b[k] for k in a}


def _shared_block(cfg: ModelConfig, shared: Params, x: torch.Tensor,
                  emb0: torch.Tensor) -> torch.Tensor:
    """Zamba2's shared block's input: the normed concat(x, emb0) through
    its 2D → D projection."""
    cat = torch.cat([x, emb0], dim=-1)
    return apply_norm(cfg, shared["norm_in"], cat) \
        @ shared["in_proj"].to(x.dtype)


def apply_layer(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None, *,
                emb0: Optional[torch.Tensor] = None,
                shared: Optional[Params] = None,
                attention: Optional[str] = None
                ) -> Tuple[torch.Tensor, Optional[AuxDict]]:
    """Full-sequence application of one block. x: (B, S, D). Returns the
    new x and, for a MoE block, its aux statistics (None otherwise: the
    zeros ``repro`` adds change no sum)."""
    window = effective_window(cfg, kind)
    if kind in (ATTN, ATTN_LOCAL, MOE):
        h = attn_mod.attention_train(cfg, p["attn"],
                                     apply_norm(cfg, p["norm1"], x),
                                     window=window, positions=positions,
                                     attention=attention)
        if cfg.post_block_norm:
            h = apply_norm(cfg, p["norm1_post"], h)
        x = x + h
        hin = apply_norm(cfg, p["norm2"], x)
        aux = None
        if kind == MOE:
            h, aux = moe_mod.moe_ffn(cfg, p["moe"], hin)
        else:
            h = apply_mlp(cfg, p["mlp"], hin)
        if cfg.post_block_norm:
            h = apply_norm(cfg, p["norm2_post"], h)
        return x + h, aux
    if kind == ATTN_PARALLEL:
        n = apply_norm(cfg, p["norm"], x)
        return (x + attn_mod.attention_train(cfg, p["attn"], n, window=window,
                                             positions=positions,
                                             attention=attention)
                + apply_mlp(cfg, p["mlp"], n)), None
    if kind in (MAMBA2, MAMBA2_SHARED):
        x = x + rec_mod.mamba2_train(cfg, p["mamba"],
                                     apply_norm(cfg, p["norm"], x))
        if kind == MAMBA2_SHARED:
            h = _shared_block(cfg, shared, x, emb0)
            x = x + attn_mod.attention_train(cfg, shared["attn"], h,
                                             positions=positions,
                                             attention=attention)
            x = x + apply_mlp(cfg, shared["mlp"],
                              apply_norm(cfg, shared["norm2"], x))
        return x, None
    if kind == MLSTM:
        return x + rec_mod.mlstm_train(cfg, p["cell"],
                                       apply_norm(cfg, p["norm"], x)), None
    if kind == SLSTM:
        return x + rec_mod.slstm_train(cfg, p["cell"],
                                       apply_norm(cfg, p["norm"], x)), None
    raise ValueError(kind)


def forward_hidden(cfg: ModelConfig, params: Params,
                   batch: Dict[str, torch.Tensor], ctx=None, *,
                   attention: Optional[str] = None
                   ) -> Tuple[torch.Tensor, AuxDict]:
    """Full-sequence forward up to (but not including) the readout, and
    the MoE layers' aux statistics summed over the layers. ``attention``
    picks the prefill attention's route
    (`repro_torch.models.attention.attention_route`). Where autograd
    records and ``cfg.remat`` is set, each layer is checkpointed."""
    check_ctx(ctx)
    x, positions = _embed(cfg, params, batch, compute_dtype(cfg))
    emb0 = x if MAMBA2_SHARED in cfg.pattern else None
    shared = params.get("shared_attn")
    aux = _zero_aux(cfg, x.device)
    layer = functools.partial(apply_layer, cfg, positions=positions,
                              emb0=emb0, shared=shared, attention=attention)
    if cfg.remat and recording(x):
        layer = checkpointed(layer)
    for kind, p in zip(cfg.pattern, params["layers"], strict=True):
        x, ai = layer(kind, p, x)
        if ai is not None:
            aux = _acc_aux(aux, ai)
    return x, aux


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            ctx=None, *, attention: Optional[str] = None
            ) -> Tuple[torch.Tensor, AuxDict]:
    """Full-sequence forward. Returns (logits, aux)."""
    x, aux = forward_hidden(cfg, params, batch, ctx, attention=attention)
    return _readout(cfg, params, x), aux


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            ctx=None, lb_coef: float = 0.01, loss_chunk: int = 1024
            ) -> Tuple[torch.Tensor, AuxDict]:
    """Next-token cross entropy (labels pre-shifted; −1 = masked), as
    ``repro``'s. Returns (total, {"loss", "ce", **aux}).

    The forward takes the plain chunked attention on every device (K9 has
    no backward). The readout and its fp32 log-softmax run in sequence
    chunks of ``loss_chunk`` (the last padded, its labels −1), each under
    ``torch.utils.checkpoint`` where autograd records, so the (B, S, V)
    logits never exist. ``ce = Σ nll / max(#labels, 1)``; a pattern with
    MoE layers adds ``lb_coef · lb_loss / n_moe``. The labels are (B, S),
    MusicGen's (B, S, C); a VLM's cover its patch prefix too."""
    hidden, aux = forward_hidden(cfg, params, batch, ctx, attention="plain")
    labels = batch["labels"]
    b, s = hidden.shape[:2]
    c = min(loss_chunk, s)
    s_pad = ((s + c - 1) // c) * c
    if s_pad != s:
        hidden = F.pad(hidden, (0, 0, 0, s_pad - s))
        pad_lab = (0, 0) * (labels.ndim - 2) + (0, s_pad - s)
        labels = F.pad(labels, pad_lab, value=-1)

    def chunk_ce(h, lab):
        logits = _readout(cfg, params, h)
        m = (lab >= 0).float()
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.take_along_dim(logp, lab.clamp(min=0)[..., None],
                                    dim=-1)[..., 0]
        return (nll * m).sum(), m.sum()

    if recording(hidden):
        chunk_ce = checkpointed(chunk_ce)
    tot = cnt = torch.zeros((), device=hidden.device)
    for i in range(s_pad // c):
        t, n = chunk_ce(hidden[:, i * c:(i + 1) * c],
                        labels[:, i * c:(i + 1) * c])
        tot, cnt = tot + t, cnt + n
    ce = tot / torch.clamp(cnt, min=1.0)
    n_moe = cfg.pattern.count(MOE)
    total = ce + lb_coef * aux["lb_loss"] / n_moe if n_moe else ce
    return total, {"loss": total, "ce": ce, **aux}


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch_size: int, cache_len: int,
                dtype=torch.bfloat16, device=None) -> List:
    """One cache a layer: a ring-buffer ``KVCache`` of ``cache_len`` slots
    (or the layer's window where that is shorter) for the attention and
    MoE blocks in ``dtype``; a ``Mamba2Cache``, ``MLSTMCache`` or
    ``SLSTMCache`` in fp32 for the recurrent ones, as ``repro`` makes
    them; for ``MAMBA2_SHARED`` the pair (``Mamba2Cache``, the shared
    block's full ``KVCache``)."""
    device = resolve_device(device)

    def one(kind):
        if kind in (ATTN, ATTN_LOCAL, ATTN_PARALLEL, MOE):
            w = effective_window(cfg, kind)
            return attn_mod.init_cache(cfg, batch_size,
                                       min(w or cache_len, cache_len), dtype,
                                       device)
        if kind == MAMBA2:
            return rec_mod.mamba2_init_cache(cfg, batch_size, device)
        if kind == MAMBA2_SHARED:
            return (rec_mod.mamba2_init_cache(cfg, batch_size, device),
                    attn_mod.init_cache(cfg, batch_size, cache_len, dtype,
                                        device))
        if kind == MLSTM:
            return rec_mod.mlstm_init_cache(cfg, batch_size, device)
        if kind == SLSTM:
            return rec_mod.slstm_init_cache(cfg, batch_size, device)
        raise ValueError(kind)

    return [one(kind) for kind in cfg.pattern]


def apply_layer_decode(cfg: ModelConfig, kind: str, p: Params,
                       x: torch.Tensor, cache, pos: torch.Tensor,
                       emb0: Optional[torch.Tensor] = None,
                       shared: Optional[Params] = None):
    """x: (B, 1, D); pos: (B,) absolute positions. Returns the new x and
    the layer's cache: a ``KVCache`` written in place, a recurrent state
    as a new named tuple."""
    window = effective_window(cfg, kind)
    if kind == ATTN_PARALLEL:
        n = apply_norm(cfg, p["norm"], x)
        h, cache = attn_mod.attention_decode(cfg, p["attn"], n, cache, pos,
                                             window)
        return x + h + apply_mlp(cfg, p["mlp"], n), cache
    if kind in (ATTN, ATTN_LOCAL, MOE):
        h, cache = attn_mod.attention_decode(
            cfg, p["attn"], apply_norm(cfg, p["norm1"], x), cache, pos,
            window)
        if cfg.post_block_norm:
            h = apply_norm(cfg, p["norm1_post"], h)
        x = x + h
        hin = apply_norm(cfg, p["norm2"], x)
        if kind == MOE:
            h, _ = moe_mod.moe_ffn(cfg, p["moe"], hin)
        else:
            h = apply_mlp(cfg, p["mlp"], hin)
        if cfg.post_block_norm:
            h = apply_norm(cfg, p["norm2_post"], h)
        return x + h, cache
    if kind in (MAMBA2, MAMBA2_SHARED):
        mcache = cache[0] if kind == MAMBA2_SHARED else cache
        h, mcache = rec_mod.mamba2_step(cfg, p["mamba"],
                                        apply_norm(cfg, p["norm"], x), mcache)
        x = x + h
        if kind == MAMBA2_SHARED:
            hin = _shared_block(cfg, shared, x, emb0)
            h, acache = attn_mod.attention_decode(cfg, shared["attn"], hin,
                                                  cache[1], pos, None)
            x = x + h
            x = x + apply_mlp(cfg, shared["mlp"],
                              apply_norm(cfg, shared["norm2"], x))
            return x, (mcache, acache)
        return x, mcache
    if kind == MLSTM:
        h, cache = rec_mod.mlstm_step(cfg, p["cell"],
                                      apply_norm(cfg, p["norm"], x), cache)
        return x + h, cache
    if kind == SLSTM:
        h, cache = rec_mod.slstm_step(cfg, p["cell"],
                                      apply_norm(cfg, p["norm"], x), cache)
        return x + h, cache
    raise ValueError(kind)


def decode_step(cfg: ModelConfig, params: Params, caches,
                tokens: torch.Tensor, pos: torch.Tensor, ctx=None):
    """One-token decode. tokens: (B,) (or (B, C) audio); pos: (B,).

    Returns (logits (B, V) or (B, C, V), the new caches: one a layer, the
    KV caches written in place, the recurrent states new).
    """
    check_ctx(ctx)
    dtype = compute_dtype(cfg)
    emb = params["embed"]
    if cfg.modality == "audio":
        x = sum(emb[c][tokens[:, c]].to(dtype)
                for c in range(cfg.num_codebooks))[:, None]
    else:
        x = emb[tokens].to(dtype)[:, None]                  # (B, 1, D)
    if cfg.scale_embeddings:
        x = x * rounded(cfg.d_model ** 0.5, dtype)
    if not cfg.use_rope and cfg.modality == "audio":
        x = x + sinusoidal(pos, cfg.d_model).to(dtype)[:, None]
    emb0 = x if MAMBA2_SHARED in cfg.pattern else None
    shared = params.get("shared_attn")
    new_caches = []
    for kind, p, cache in zip(cfg.pattern, params["layers"], caches,
                              strict=True):
        x, cache = apply_layer_decode(cfg, kind, p, x, cache, pos, emb0,
                                      shared)
        new_caches.append(cache)
    return _readout(cfg, params, x)[:, 0], new_caches
