"""Decoder assembly for the attention-block architectures
(``repro.models.transformer``).

``repro`` segments the per-layer ``layer_pattern`` into stages of
``(cycle, reps)``, stacks a stage's parameters on a leading ``reps`` axis
and applies them with ``lax.scan``. The port keeps ``segment_pattern`` and
``stage_layout`` (the checkpoint layout, `repro_torch.convert`), but holds
one parameter dict a layer, ``params["layers"][i]`` for
``cfg.pattern[i]``, and applies the layers one after another.

Served here: the ``ATTN``, ``ATTN_LOCAL`` and ``ATTN_PARALLEL`` blocks,
the VLM patch-embedding prefix and MusicGen's multi-codebook embedding and
readout, for full-sequence prefill (``forward``) and single-token decode
(``decode_step``). The MoE blocks, the recurrent blocks and sharding over a
mesh raise ``NotImplementedError`` naming their ROADMAP item; ``loss_fn``
waits for the training slice.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import (ATTN, ATTN_LOCAL, ATTN_PARALLEL, MAMBA2,
                                      MAMBA2_SHARED, MLSTM, MOE, SLSTM,
                                      ModelConfig, effective_window)
from repro_torch.core.types import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (Params, apply_mlp, apply_norm,
                                       compute_dtype, mlp_init, norm_init,
                                       rounded, sinusoidal, softcap,
                                       truncated_normal)

AuxDict = Dict[str, torch.Tensor]

SERVED_KINDS = (ATTN, ATTN_LOCAL, ATTN_PARALLEL)
# the block kinds not ported yet, by the ROADMAP §1 item that ports them
NOT_PORTED = {MOE: ("the MoE block (models/moe.py)", "10.1"),
              MAMBA2: ("the Mamba2 block (models/recurrent.py)", "10.2"),
              MAMBA2_SHARED: ("the Mamba2 block with zamba2's shared "
                              "attention (models/recurrent.py)", "10.2"),
              MLSTM: ("the mLSTM block (models/recurrent.py)", "10.2"),
              SLSTM: ("the sLSTM block (models/recurrent.py)", "10.2")}
# the parameter dicts ``norm_init`` makes: repro multiplies fp32
# normalised activations by them, so they keep the param dtype
NORM_KEYS = frozenset({"norm", "norm1", "norm2", "norm1_post", "norm2_post",
                       "norm_in", "final_norm"})


def kind_not_ported(cfg: ModelConfig, kind: str) -> NotImplementedError:
    what, item = NOT_PORTED[kind]
    return NotImplementedError(
        f"{cfg.name}: {what} is not ported to repro_torch yet (ROADMAP §1 "
        f"item {item}); the port serves the attention blocks "
        f"{', '.join(SERVED_KINDS)}")


def mesh_not_ported(what: str = "ctx") -> NotImplementedError:
    """The error of a ``MeshCtx``: ``repro``'s sharded layout (its
    ``_shard`` constraints, the MoE ``shard_map`` islands) is not ported;
    on one card ``_shard`` is the identity."""
    return NotImplementedError(
        f"{what}: sharding the LM over a mesh (repro's sharding/ and "
        "launch/dryrun.py) is not ported to repro_torch yet (ROADMAP §1 "
        "item 10.4); one card runs with ctx=None")


def training_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: LM training (loss_fn, make_train_step, optim/, "
        "launch/train.py lm) is not ported to repro_torch yet (ROADMAP §1 "
        "item 10.3); the port serves (prefill and decode)")


def _refused(cfg: ModelConfig, kind: str) -> Exception:
    """The error of a block kind the port does not serve."""
    return kind_not_ported(cfg, kind) if kind in NOT_PORTED \
        else ValueError(kind)


def check_supported(cfg: ModelConfig, ctx=None) -> None:
    """Raise for a mesh or for any block kind the port does not serve."""
    if ctx is not None:
        raise mesh_not_ported()
    for kind in cfg.pattern:
        if kind not in SERVED_KINDS:
            raise _refused(cfg, kind)


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

def layer_init(cfg: ModelConfig, kind: str, *, generator, device) -> Params:
    draw = dict(generator=generator, device=device)
    if kind in (ATTN, ATTN_LOCAL):
        p: Params = {"norm1": norm_init(cfg, cfg.d_model, device),
                     "attn": attn_mod.attn_init(cfg, **draw),
                     "norm2": norm_init(cfg, cfg.d_model, device),
                     "mlp": mlp_init(cfg, cfg.d_model,
                                     cfg.dense_d_ff or cfg.d_ff,
                                     gated=cfg.mlp_gated, **draw)}
        if cfg.post_block_norm:
            p["norm1_post"] = norm_init(cfg, cfg.d_model, device)
            p["norm2_post"] = norm_init(cfg, cfg.d_model, device)
        return p
    if kind == ATTN_PARALLEL:
        return {"norm": norm_init(cfg, cfg.d_model, device),
                "attn": attn_mod.attn_init(cfg, **draw),
                "mlp": mlp_init(cfg, cfg.d_model, cfg.d_ff,
                                gated=cfg.mlp_gated, **draw)}
    raise _refused(cfg, kind)


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None) -> Params:
    """Fresh parameters in ``cfg.param_dtype`` (fp32) from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (CUDA unless
    named): ``repro``'s shapes and distributions, not its draws. One dict
    a layer under ``"layers"``."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = dict(generator=gen, device=device)
    d, v = cfg.d_model, cfg.vocab_size
    params: Params = {}
    if cfg.modality == "audio":
        params["embed"] = truncated_normal((cfg.num_codebooks, v, d),
                                           d ** -0.5, **draw)
        params["heads"] = truncated_normal((cfg.num_codebooks, d, v),
                                           d ** -0.5, **draw)
    else:
        params["embed"] = truncated_normal((v, d), d ** -0.5, **draw)
        if not cfg.tie_embeddings:
            params["lm_head"] = truncated_normal((d, v), d ** -0.5, **draw)
    params["final_norm"] = norm_init(cfg, d, device)
    params["layers"] = [layer_init(cfg, kind, **draw)
                        for kind in cfg.pattern]
    return params


def cast_params(cfg: ModelConfig, params: Params) -> Params:
    """The compute copy: every weight and bias in ``cfg.dtype``, the norms'
    parameters as they are.

    ``repro`` casts each weight to ``cfg.dtype`` at every use; the cast is
    elementwise, so a copy made once computes the same bits, and at decode
    it is what a step reads (bf16: half the fp32 masters' bytes)."""
    dtype = compute_dtype(cfg)

    def walk(node, key=None):
        if key in NORM_KEYS:
            return node
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node.to(dtype)

    return walk(params)


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


def apply_layer(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None, *,
                attention: Optional[str] = None) -> torch.Tensor:
    """Full-sequence application of one block. x: (B, S, D)."""
    window = effective_window(cfg, kind)
    if kind in (ATTN, ATTN_LOCAL):
        h = attn_mod.attention_train(cfg, p["attn"],
                                     apply_norm(cfg, p["norm1"], x),
                                     window=window, positions=positions,
                                     attention=attention)
        if cfg.post_block_norm:
            h = apply_norm(cfg, p["norm1_post"], h)
        x = x + h
        h = apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x))
        if cfg.post_block_norm:
            h = apply_norm(cfg, p["norm2_post"], h)
        return x + h
    if kind == ATTN_PARALLEL:
        n = apply_norm(cfg, p["norm"], x)
        return (x + attn_mod.attention_train(cfg, p["attn"], n, window=window,
                                             positions=positions,
                                             attention=attention)
                + apply_mlp(cfg, p["mlp"], n))
    raise _refused(cfg, kind)


def forward_hidden(cfg: ModelConfig, params: Params,
                   batch: Dict[str, torch.Tensor], ctx=None, *,
                   attention: Optional[str] = None
                   ) -> Tuple[torch.Tensor, AuxDict]:
    """Full-sequence forward up to (but not including) the readout.
    ``attention`` picks the prefill attention's route
    (`repro_torch.models.attention.attention_route`)."""
    check_supported(cfg, ctx)
    x, positions = _embed(cfg, params, batch, compute_dtype(cfg))
    for kind, p in zip(cfg.pattern, params["layers"], strict=True):
        x = apply_layer(cfg, kind, p, x, positions, attention=attention)
    return x, _zero_aux(cfg, x.device)


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            ctx=None, *, attention: Optional[str] = None
            ) -> Tuple[torch.Tensor, AuxDict]:
    """Full-sequence forward. Returns (logits, aux)."""
    x, aux = forward_hidden(cfg, params, batch, ctx, attention=attention)
    return _readout(cfg, params, x), aux


def loss_fn(*args, **kwargs):
    """Not ported: the training slice (ROADMAP §1 item 10.3)."""
    raise training_not_ported("loss_fn")


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch_size: int, cache_len: int,
                dtype=torch.bfloat16, device=None) -> List[attn_mod.KVCache]:
    """One ring-buffer cache a layer: ``cache_len`` slots, or the layer's
    window where that is shorter."""
    check_supported(cfg)
    device = resolve_device(device)
    caches = []
    for kind in cfg.pattern:
        w = effective_window(cfg, kind)
        caches.append(attn_mod.init_cache(
            cfg, batch_size, min(w or cache_len, cache_len), dtype, device))
    return caches


def apply_layer_decode(cfg: ModelConfig, kind: str, p: Params,
                       x: torch.Tensor, cache: attn_mod.KVCache,
                       pos: torch.Tensor):
    """x: (B, 1, D); pos: (B,) absolute positions."""
    window = effective_window(cfg, kind)
    if kind == ATTN_PARALLEL:
        n = apply_norm(cfg, p["norm"], x)
        h, cache = attn_mod.attention_decode(cfg, p["attn"], n, cache, pos,
                                             window)
        return x + h + apply_mlp(cfg, p["mlp"], n), cache
    if kind in (ATTN, ATTN_LOCAL):
        h, cache = attn_mod.attention_decode(
            cfg, p["attn"], apply_norm(cfg, p["norm1"], x), cache, pos,
            window)
        if cfg.post_block_norm:
            h = apply_norm(cfg, p["norm1_post"], h)
        x = x + h
        h = apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x))
        if cfg.post_block_norm:
            h = apply_norm(cfg, p["norm2_post"], h)
        return x + h, cache
    raise _refused(cfg, kind)


def decode_step(cfg: ModelConfig, params: Params, caches,
                tokens: torch.Tensor, pos: torch.Tensor, ctx=None):
    """One-token decode. tokens: (B,) (or (B, C) audio); pos: (B,).

    Returns (logits (B, V) or (B, C, V), caches), the caches updated in
    place.
    """
    check_supported(cfg, ctx)
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
    for kind, p, cache in zip(cfg.pattern, params["layers"], caches,
                              strict=True):
        x, _ = apply_layer_decode(cfg, kind, p, x, cache, pos)
    return _readout(cfg, params, x)[:, 0], caches
