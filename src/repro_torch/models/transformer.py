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
readout.

Over a device mesh (a ``MeshCtx``, `repro_torch.sharding`) ``forward``,
``forward_hidden`` and ``decode_step`` run as one program a rank: the
inputs are the global batch, of which the rank takes its rows; its
parameters and caches are its blocks (``init_params(..., ctx=)``,
``init_caches(..., ctx=)``); each layer gathers its leaves over the data
axes when it runs, computes its heads, FFN columns or experts, and sums
the partials over ``model``; the embedding is vocab-parallel (a masked
lookup of the rank's vocabulary range, summed over ``model``) and the
logits are gathered over ``model``. The recurrent blocks and zamba2's
shared block compute the rank's heads too (`repro_torch.models.recurrent.
Share`; the shared block through its own ``LayerPlan``). ``loss_fn``
over a mesh is ``repro``'s sharded one, under autograd: the readout is
vocab-parallel (each rank's vocabulary range, the softmax's max, Σ exp and
the target's logit combined over ``model``) and the loss's sums are taken
over the data axes, so every rank returns the global batch's loss. With
``seq_shard`` the residual stream between layers holds the rank's S / M
rows (`repro_torch.sharding.ctx`).

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
from repro_torch.sharding.ctx import (RankPlan, ShardedCaches,
                                      check_mesh_ctx, ctx_param_specs)
from repro_torch.sharding.rules import cache_specs, shard_tree

AuxDict = Dict[str, torch.Tensor]

# what ``cast_params`` leaves in the param dtype: the parameter dicts
# ``norm_init`` makes, and the leaves ``repro`` reads in fp32 (not cast to
# ``cfg.dtype`` at use): Mamba2's ``dt_bias`` and ``a_log``, the recurrent
# blocks' ``norm_scale``, the sLSTM's recurrent ``r``
KEEP_FP32 = frozenset({"norm", "norm1", "norm2", "norm1_post", "norm2_post",
                       "norm_in", "final_norm", "dt_bias", "a_log",
                       "norm_scale", "r"})


def check_ctx(ctx=None):
    """None for one card, else the ``MeshCtx``."""
    return check_mesh_ctx(ctx)


def mesh_plan(cfg: ModelConfig, ctx, batch: int,
              seq_len: Optional[int] = None) -> Optional[RankPlan]:
    """The rank's plan of a call with a global batch of ``batch`` rows of
    ``seq_len`` positions (None for one card)."""
    ctx = check_ctx(ctx)
    return None if ctx is None else RankPlan(cfg, ctx, batch, seq_len)


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
                cast: bool = False, ctx=None) -> Params:
    """Fresh parameters in ``cfg.param_dtype`` (fp32) from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (CUDA unless
    named): ``repro``'s shapes and distributions, not its draws. One dict
    a layer under ``"layers"``, zamba2's shared block under
    ``"shared_attn"``.

    ``cast`` returns the compute copy instead, each array cast as soon as
    it is drawn (one fp32 layer at a time beside the copy): the same
    draws, bit-equal to ``cast_params(cfg, init_params(cfg, seed))``.

    ``ctx`` (a ``MeshCtx``) keeps the rank's blocks alone
    (`repro_torch.sharding.shard_tree` under ``param_specs``): each array
    or layer is drawn whole, as without it, cut, and freed, so no rank
    holds the whole model. On ``meta`` the shapes alone."""
    device = resolve_device(device)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    draw = dict(generator=gen, device=device)
    dtype = compute_dtype(cfg)
    ctx = check_ctx(ctx)
    specs = None if ctx is None else ctx_param_specs(cfg, ctx)

    def done(node, key=None, spec_key=None):
        node = _cast_tree(node, dtype, key) if cast else node
        if specs is None:
            return node
        spec = specs[spec_key] if not isinstance(spec_key, tuple) \
            else specs[spec_key[0]][spec_key[1]]
        return shard_tree(ctx.mesh, node, spec, ctx.comm.coords)

    d, v = cfg.d_model, cfg.vocab_size
    params: Params = {}
    if cfg.modality == "audio":
        params["embed"] = done(truncated_normal((cfg.num_codebooks, v, d),
                                                d ** -0.5, **draw),
                               spec_key="embed")
        params["heads"] = done(truncated_normal((cfg.num_codebooks, d, v),
                                                d ** -0.5, **draw),
                               spec_key="heads")
    else:
        params["embed"] = done(truncated_normal((v, d), d ** -0.5, **draw),
                               spec_key="embed")
        if not cfg.tie_embeddings:
            params["lm_head"] = done(truncated_normal((d, v), d ** -0.5,
                                                      **draw),
                                     spec_key="lm_head")
    params["final_norm"] = norm_init(cfg, d, device)
    if MAMBA2_SHARED in cfg.pattern:
        params["shared_attn"] = done(shared_attn_init(cfg, **draw),
                                     spec_key="shared_attn")
    params["layers"] = [done(layer_init(cfg, kind, **draw),
                             spec_key=("layers", i))
                        for i, kind in enumerate(cfg.pattern)]
    return params


@functools.lru_cache(maxsize=32)
def param_shapes(cfg: ModelConfig) -> Params:
    """The full parameter tree of ``cfg`` on ``meta`` (shapes and dtypes,
    no storage): what the placement rules read."""
    return init_params(cfg, device="meta")


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


def _lookup(cfg: ModelConfig, params: Params, tokens: torch.Tensor, dtype,
            plan: Optional[RankPlan] = None) -> torch.Tensor:
    """The embedded tokens ((B, S) or (B,) ids, MusicGen's with a
    codebook axis last), cast to ``dtype``. Rows are gathered, then cast:
    ``repro`` casts the whole table first, the same bits. Over a mesh the
    table is gathered over the data axes; where its vocabulary is sharded
    over ``model`` each rank looks up the ids in its range (the others
    exact zeros) and the ranks' rows are summed."""
    emb = params["embed"]
    vdim = 1 if cfg.modality == "audio" else 0
    v0 = None
    if plan is not None:
        spec = plan.specs["embed"]
        emb = plan.gather_data(emb, spec)
        if plan.model_sharded(spec, vdim):
            v0 = plan.m * emb.shape[vdim]

    def rows(table, ids):
        if v0 is None:
            return table[ids].to(dtype)
        local = ids - v0
        mine = (local >= 0) & (local < table.shape[0])
        got = table[local.clamp(0, table.shape[0] - 1)].to(dtype)
        return torch.where(mine[..., None], got, torch.zeros((), dtype=dtype,
                                                             device=got.device))

    if cfg.modality == "audio":
        # tokens: (..., C) — sum the codebook embeddings
        x = sum(rows(emb[c], tokens[..., c])
                for c in range(cfg.num_codebooks))
    else:
        x = rows(emb, tokens)
    return x if v0 is None else plan.msum(x)


def _embed(cfg: ModelConfig, params: Params,
           batch: Dict[str, torch.Tensor], dtype,
           plan: Optional[RankPlan] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B, S, D), positions (S,))."""
    x = _lookup(cfg, params, batch["tokens"], dtype, plan)   # (B, S, D)
    if cfg.scale_embeddings:
        x = x * rounded(cfg.d_model ** 0.5, dtype)
    if cfg.modality == "vision" and "vision_embeds" in batch:
        x = torch.cat([batch["vision_embeds"].to(dtype), x], dim=1)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    if not cfg.use_rope and cfg.modality == "audio":
        x = x + sinusoidal(positions, cfg.d_model).to(dtype)[None]
    return x, positions


def _head(cfg: ModelConfig, params: Params, plan: Optional[RankPlan] = None):
    """The readout's weights as the rank computes with them: (the head's
    name, the final norm, the head, whether the rank holds a block of the
    vocabulary over ``model``). Over a mesh both are gathered over the
    data axes."""
    name = "heads" if cfg.modality == "audio" else \
        "embed" if cfg.tie_embeddings else "lm_head"
    vdim = {"heads": 2, "embed": 0, "lm_head": 1}[name]
    fn, w = params["final_norm"], params[name]
    sharded = False
    if plan is not None:
        fn = plan.gather_data(fn, plan.specs["final_norm"])
        w = plan.gather_data(w, plan.specs[name])
        sharded = plan.model_sharded(plan.specs[name], vdim)
    return name, fn, w, sharded


def _logits(cfg: ModelConfig, head, x: torch.Tensor,
            plan: Optional[RankPlan] = None) -> torch.Tensor:
    """The logits of x under ``head`` (``_head``'s): where the vocabulary
    is sharded, the rank's range, its normed input entering through *f*."""
    name, fn, w, sharded = head
    dt = x.dtype
    x = apply_norm(cfg, fn, x)
    if sharded:
        x = plan.enter(x)
    if cfg.modality == "audio":
        logits = torch.einsum("bsd,cdv->bscv", x, w.to(dt))
    elif cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, w.to(dt))
    else:
        logits = x @ w.to(dt)
    if cfg.logit_scale != 1.0:
        logits = logits * rounded(cfg.logit_scale, dt)
    return softcap(logits, cfg.final_logit_softcap)


def _readout(cfg: ModelConfig, params: Params, x: torch.Tensor,
             plan: Optional[RankPlan] = None) -> torch.Tensor:
    """The logits of x. Over a mesh the head is gathered over the data
    axes; where its vocabulary is sharded over ``model`` each rank computes
    its range and the ranks' logits are gathered."""
    head = _head(cfg, params, plan)
    logits = _logits(cfg, head, x, plan)
    return plan.mgather(logits, logits.ndim - 1) if head[3] else logits


def _acc_aux(a: AuxDict, b: AuxDict) -> AuxDict:
    return {k: a[k] + b[k] for k in a}


def _shared_block(cfg: ModelConfig, shared: Params, x: torch.Tensor,
                  emb0: torch.Tensor, tp=None, part: bool = False,
                  rows: bool = False) -> torch.Tensor:
    """Zamba2's shared block's input: the normed concat(x, emb0) through
    its 2D → D projection. ``tp``: a model rank's ``LayerPlan`` of the
    block; the projection is then whole on every rank (its columns
    gathered, or with ``rows`` its product's rows), entered through *f*
    where the attention after it is ``part``ial."""
    cat = torch.cat([x, emb0], dim=-1)
    n = _enter(tp, apply_norm(cfg, shared["norm_in"], cat), part)
    if tp is None:
        return n @ shared["in_proj"].to(x.dtype)
    return tp.project(n, shared["in_proj"], tp.spec["in_proj"],
                      [(0, cfg.d_model)], rows, part or tp.plan.seq)


def _shared_train(cfg: ModelConfig, shared: Params, x: torch.Tensor,
                  emb0: torch.Tensor, positions, attention, tp
                  ) -> torch.Tensor:
    """Zamba2's shared attention and MLP after a MAMBA2_SHARED layer's
    Mamba2 block, the rank's heads and FFN columns under ``tp``."""
    heads = None if tp is None else tp.heads()
    part = heads is not None and heads.reduce
    h = _shared_block(cfg, shared, x, emb0, tp, part)
    x = x + _leave(tp, attn_mod.attention_train(
        cfg, shared["attn"], h, positions=positions, attention=attention,
        heads=heads), part)
    m_part = tp is not None and tp.mlp_sharded()
    return x + _leave(tp, apply_mlp(cfg, shared["mlp"], _enter(
        tp, apply_norm(cfg, shared["norm2"], x), m_part)), m_part)


def _enter(tp, x: torch.Tensor, partial: bool) -> torch.Tensor:
    return x if tp is None else tp.enter(x, partial)


def _leave(tp, h: torch.Tensor, partial: bool) -> torch.Tensor:
    return h if tp is None else tp.leave(h, partial)


def apply_layer(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None, *,
                emb0: Optional[torch.Tensor] = None,
                shared: Optional[Params] = None,
                attention: Optional[str] = None, tp=None, shared_tp=None
                ) -> Tuple[torch.Tensor, Optional[AuxDict]]:
    """Full-sequence application of one block. x: (B, S, D). Returns the
    new x and, for a MoE block, its aux statistics (None otherwise: the
    zeros ``repro`` adds change no sum). ``tp``: a model rank's
    ``LayerPlan`` (``p`` then its leaves gathered over the data axes;
    ``shared_tp`` the shared block's); under ``seq_shard`` x (and emb0)
    holds the rank's S / M rows, and each region gathers S at its entry
    (``positions`` are the whole sequence's)."""
    window = effective_window(cfg, kind)
    if kind in _RECURRENT:
        return _recurrent_layer(cfg, kind, p, x, positions, emb0, shared,
                                attention, tp, shared_tp), None
    heads = None if tp is None else tp.heads()
    part = heads is not None and heads.reduce
    if kind in (ATTN, ATTN_LOCAL, MOE):
        n = _enter(tp, apply_norm(cfg, p["norm1"], x), part)
        h = attn_mod.attention_train(cfg, p["attn"], n, window=window,
                                     positions=positions,
                                     attention=attention, heads=heads)
        h = _leave(tp, h, part)
        if cfg.post_block_norm:
            h = apply_norm(cfg, p["norm1_post"], h)
        x = x + h
        hin = apply_norm(cfg, p["norm2"], x)
        aux = None
        if kind == MOE:
            h, aux = moe_mod.moe_ffn(cfg, p["moe"], hin, tp)
        else:
            m_part = tp is not None and tp.mlp_sharded()
            h = _leave(tp, apply_mlp(cfg, p["mlp"], _enter(tp, hin, m_part)),
                       m_part)
        if cfg.post_block_norm:
            h = apply_norm(cfg, p["norm2_post"], h)
        return x + h, aux
    if kind == ATTN_PARALLEL:
        n = apply_norm(cfg, p["norm"], x)
        m_part = tp is not None and tp.mlp_sharded()
        if tp is not None and tp.plan.seq:
            na = nm = tp.plan.seq_gather(n, partial=True)
        else:
            na, nm = _enter(tp, n, part), _enter(tp, n, m_part)
        a = attn_mod.attention_train(cfg, p["attn"], na, window=window,
                                     positions=positions,
                                     attention=attention, heads=heads)
        return x + _parallel_out(tp, a, apply_mlp(cfg, p["mlp"], nm), part,
                                 m_part), None
    raise ValueError(kind)


#: a recurrent layer's block: its parameters' key, its full-sequence and
#: decode functions
_RECURRENT = {MAMBA2: ("mamba", rec_mod.mamba2_train, rec_mod.mamba2_step),
              MAMBA2_SHARED: ("mamba", rec_mod.mamba2_train,
                              rec_mod.mamba2_step),
              MLSTM: ("cell", rec_mod.mlstm_train, rec_mod.mlstm_step),
              SLSTM: ("cell", rec_mod.slstm_train, rec_mod.slstm_step)}


def _recurrent_layer(cfg: ModelConfig, kind: str, p: Params, x, positions,
                     emb0, shared, attention, tp, shared_tp) -> torch.Tensor:
    """A recurrent layer over a full sequence: its block on the normed
    stream, the rank's heads entered through *f* (or S gathered) and summed
    over ``model`` at its exit where the model axis splits it; then
    zamba2's shared block after a MAMBA2_SHARED layer's."""
    key, block, _ = _RECURRENT[kind]
    part = tp is not None and tp.split
    n = _enter(tp, apply_norm(cfg, p["norm"], x), part)
    x = x + _leave(tp, block(cfg, p[key], n, tp), part)
    if kind == MAMBA2_SHARED:
        x = _shared_train(cfg, shared, x, emb0, positions, attention,
                          shared_tp)
    return x


def _parallel_out(tp, a: torch.Tensor, m: torch.Tensor, a_part: bool,
                  m_part: bool) -> torch.Tensor:
    """An ATTN_PARALLEL block's attention plus MLP: over a mesh the two
    partial sums reduced over ``model`` in one collective where both are
    partial."""
    if a_part and m_part:
        return _leave(tp, a + m, True)
    return _leave(tp, a, a_part) + _leave(tp, m, m_part)


def _batch_rows(batch: Dict[str, torch.Tensor]) -> int:
    return int(batch["tokens"].shape[0])


def _seq_len(cfg: ModelConfig, batch: Dict[str, torch.Tensor]) -> int:
    """The embedded sequence's length: the tokens' and a VLM's patches."""
    s = int(batch["tokens"].shape[1])
    if cfg.modality == "vision" and "vision_embeds" in batch:
        s += int(batch["vision_embeds"].shape[1])
    return s


def batch_plan(cfg: ModelConfig, ctx, batch: Dict[str, torch.Tensor]
               ) -> Optional[RankPlan]:
    """The rank's plan of a full-sequence call on the global ``batch``."""
    return mesh_plan(cfg, ctx, _batch_rows(batch), _seq_len(cfg, batch))


def _hidden(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            plan: Optional[RankPlan], attention: Optional[str]
            ) -> Tuple[torch.Tensor, AuxDict]:
    """The stack's output and aux: under ``seq_shard`` the rank's S / M
    rows of it."""
    if plan is not None:
        batch = plan.local_batch(batch)
    x, positions = _embed(cfg, params, batch, compute_dtype(cfg), plan)
    emb0 = x if MAMBA2_SHARED in cfg.pattern else None
    shared, shared_tp = params.get("shared_attn"), None
    if plan is not None and shared is not None:
        shared, shared_tp = plan.shared_block(shared)
    seq = plan is not None and plan.seq
    if seq:
        x = plan.seq_split(x)
        if emb0 is not None:
            emb0 = plan.seq_split(emb0)
    aux = _zero_aux(cfg, x.device)
    layer = functools.partial(apply_layer, cfg, positions=positions,
                              emb0=emb0, shared=shared, attention=attention,
                              shared_tp=shared_tp)

    def run(i, kind, p, x):
        """One layer: over a mesh its leaves gathered here, so a
        checkpointed layer gathers them again in its recompute."""
        if plan is None:
            return layer(kind, p, x)
        p, tp = plan.layer(i, kind, p)
        return layer(kind, p, x, tp=tp)

    if cfg.remat and recording(x):
        run = checkpointed(run)
    for i, (kind, p) in enumerate(zip(cfg.pattern, params["layers"],
                                      strict=True)):
        x, ai = run(i, kind, p, x)
        if ai is not None:
            aux = _acc_aux(aux, ai)
    return x, aux


def forward_hidden(cfg: ModelConfig, params: Params,
                   batch: Dict[str, torch.Tensor], ctx=None, *,
                   attention: Optional[str] = None, plan=None
                   ) -> Tuple[torch.Tensor, AuxDict]:
    """Full-sequence forward up to (but not including) the readout, and
    the MoE layers' aux statistics summed over the layers. ``attention``
    picks the prefill attention's route
    (`repro_torch.models.attention.attention_route`). Where autograd
    records and ``cfg.remat`` is set, each layer is checkpointed.

    With a ``MeshCtx`` ``batch`` is the global batch and the result the
    rank's rows (``plan``: the rank's plan of the call, made here unless
    given), every position."""
    if plan is None:
        plan = batch_plan(cfg, ctx, batch)
    x, aux = _hidden(cfg, params, batch, plan, attention)
    if plan is not None and plan.seq:
        x = plan.seq_gather(x, partial=False)
    return x, aux


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            ctx=None, *, attention: Optional[str] = None
            ) -> Tuple[torch.Tensor, AuxDict]:
    """Full-sequence forward. Returns (logits, aux); over a mesh the
    rank's rows of the logits, every vocabulary entry."""
    plan = batch_plan(cfg, ctx, batch)
    x, aux = forward_hidden(cfg, params, batch, ctx, attention=attention,
                            plan=plan)
    return _readout(cfg, params, x, plan), aux


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _nll(cfg: ModelConfig, logits: torch.Tensor, lab: torch.Tensor,
         plan: Optional[RankPlan] = None) -> torch.Tensor:
    """−log softmax(logits)[lab] in fp32 (lab ≥ 0 where it counts). With a
    ``plan`` the logits are the rank's vocabulary range: the max from
    every rank's (no gradient), Σ exp and the target's logit (from the
    rank whose range holds it) summed over ``model`` in rank order."""
    lf, lab = logits.float(), lab.long()
    if plan is None:
        logp = torch.log_softmax(lf, dim=-1)
        return -torch.take_along_dim(logp, lab.clamp(min=0)[..., None],
                                     dim=-1)[..., 0]
    comm, model = plan.comm, (plan.model,)
    vl = lf.shape[-1]
    with torch.no_grad():
        mx = comm.all_gather(lf.amax(-1, keepdim=True), lf.ndim - 1, model)
        mx = mx.amax(-1, keepdim=True)
    se = comm.ordered_sum(torch.exp(lf - mx).sum(-1), model)
    loc = lab - plan.m * vl
    mine = (loc >= 0) & (loc < vl)
    tl = torch.take_along_dim(lf, loc.clamp(0, vl - 1)[..., None],
                              dim=-1)[..., 0]
    tl = comm.ordered_sum(torch.where(mine, tl, torch.zeros_like(tl)),
                          model)
    return torch.log(se) + mx[..., 0] - tl


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
    MusicGen's (B, S, C); a VLM's cover its patch prefix too.

    With a ``MeshCtx`` (``batch`` global) every rank returns the global
    batch's loss and metrics: the readout is vocab-parallel where the
    head's vocabulary is sharded over ``model`` (`_nll`), the head
    gathered over the data axes once for every chunk, and Σ nll and the
    label count are summed over the batch's data axes in rank order."""
    ctx = check_ctx(ctx)
    plan = batch_plan(cfg, ctx, batch)
    hidden, aux = forward_hidden(cfg, params, batch, attention="plain",
                                 plan=plan)
    labels = batch["labels"] if plan is None \
        else plan.local_rows(batch["labels"])
    b, s = hidden.shape[:2]
    c = min(loss_chunk, s)
    s_pad = ((s + c - 1) // c) * c
    if s_pad != s:
        hidden = F.pad(hidden, (0, 0, 0, s_pad - s))
        pad_lab = (0, 0) * (labels.ndim - 2) + (0, s_pad - s)
        labels = F.pad(labels, pad_lab, value=-1)
    name, fn, w, sharded = _head(cfg, params, plan)
    vocab_plan = plan if sharded and plan.m_size > 1 else None

    def chunk_ce(h, lab, fn, w):
        logits = _logits(cfg, (name, fn, w, sharded), h, plan)
        m = (lab >= 0).float()
        nll = _nll(cfg, logits, lab, vocab_plan)
        return (nll * m).sum(), m.sum()

    if recording(hidden):
        chunk_ce = checkpointed(chunk_ce)
    tot = cnt = torch.zeros((), device=hidden.device)
    for i in range(s_pad // c):
        t, n = chunk_ce(hidden[:, i * c:(i + 1) * c],
                        labels[:, i * c:(i + 1) * c], fn, w)
        tot, cnt = tot + t, cnt + n
    if plan is not None:
        tot = plan.comm.ordered_sum(tot, plan.batch_axes)
        cnt = plan.comm.ordered_sum(cnt, plan.batch_axes)
    ce = tot / torch.clamp(cnt, min=1.0)
    n_moe = cfg.pattern.count(MOE)
    total = ce + lb_coef * aux["lb_loss"] / n_moe if n_moe else ce
    return total, {"loss": total, "ce": ce, **aux}


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch_size: int, cache_len: int,
                dtype=torch.bfloat16, device=None, ctx=None) -> List:
    """One cache a layer: a ring-buffer ``KVCache`` of ``cache_len`` slots
    (or the layer's window where that is shorter) for the attention and
    MoE blocks in ``dtype``; a ``Mamba2Cache``, ``MLSTMCache`` or
    ``SLSTMCache`` in fp32 for the recurrent ones, as ``repro`` makes
    them; for ``MAMBA2_SHARED`` the pair (``Mamba2Cache``, the shared
    block's full ``KVCache``).

    ``ctx`` (a ``MeshCtx``): the rank's blocks under ``cache_specs``, as
    ``ShardedCaches``; the full caches are never made."""
    device = resolve_device(device)
    ctx = check_ctx(ctx)
    if ctx is not None:
        full = init_caches(cfg, batch_size, cache_len, dtype,
                           torch.device("meta"))
        specs = cache_specs(ctx.mesh, cfg, full)
        shapes = shard_tree(ctx.mesh, full, specs, ctx.comm.coords)
        local = _fill_like(full, shapes, device)
        return ShardedCaches(local, specs, batch_size)

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


def _fill_like(full, blocks, device):
    """Fresh cache leaves of the block shapes: the ring buffers' slot
    positions −1, everything else 0, as ``init_caches`` makes them."""
    def walk(f, b, field=None):
        if isinstance(f, attn_mod.KVCache):
            return attn_mod.KVCache(*(walk(x, y, n) for x, y, n in
                                      zip(f, b, f._fields)))
        if isinstance(f, tuple):
            parts = [walk(x, y) for x, y in zip(f, b)]
            return type(f)(*parts) if hasattr(f, "_fields") \
                else tuple(parts)
        if isinstance(f, list):
            return [walk(x, y) for x, y in zip(f, b)]
        return torch.full(b.shape, -1 if field == "slot_pos" else 0,
                          dtype=f.dtype, device=device)
    return walk(full, blocks)


def shard_caches(cfg: ModelConfig, ctx, caches, batch_size: int
                 ) -> ShardedCaches:
    """The rank's blocks of full caches (``init_caches`` without a mesh,
    or a converted ``repro`` cache), as ``ShardedCaches``."""
    ctx = check_ctx(ctx)
    specs = cache_specs(ctx.mesh, cfg, caches)
    return ShardedCaches(shard_tree(ctx.mesh, caches, specs,
                                    ctx.comm.coords), specs, batch_size)


def apply_layer_decode(cfg: ModelConfig, kind: str, p: Params,
                       x: torch.Tensor, cache, pos: torch.Tensor,
                       emb0: Optional[torch.Tensor] = None,
                       shared: Optional[Params] = None, tp=None,
                       shared_tp=None):
    """x: (B, 1, D); pos: (B,) absolute positions. Returns the new x and
    the layer's cache: a ``KVCache`` written in place, a recurrent state
    as a new named tuple. ``tp``: a model rank's ``LayerPlan`` (the shared
    block's ``shared_tp``); ``cache`` then holds the KV heads its ``wk``
    projects, a recurrent state whole (the rank steps its heads and
    restores the whole)."""
    window = effective_window(cfg, kind)
    if kind in _RECURRENT:
        key, _, step = _RECURRENT[kind]
        part = tp is not None and tp.split
        rc = cache[0] if kind == MAMBA2_SHARED else cache
        h, rc = step(cfg, p[key], apply_norm(cfg, p["norm"], x), rc, tp)
        x = x + _leave(tp, h, part)
        if kind != MAMBA2_SHARED:
            return x, rc
        x, acache = _shared_decode(cfg, shared, x, emb0, cache[1], pos,
                                   shared_tp)
        return x, (rc, acache)
    heads = None if tp is None else tp.heads()
    part = heads is not None and heads.reduce
    if kind == ATTN_PARALLEL:
        n = apply_norm(cfg, p["norm"], x)
        h, cache = attn_mod.attention_decode(cfg, p["attn"], n, cache, pos,
                                             window, heads)
        m_part = tp is not None and tp.mlp_sharded()
        return x + _parallel_out(tp, h, apply_mlp(cfg, p["mlp"], n), part,
                                 m_part), cache
    if kind in (ATTN, ATTN_LOCAL, MOE):
        h, cache = attn_mod.attention_decode(
            cfg, p["attn"], apply_norm(cfg, p["norm1"], x), cache, pos,
            window, heads)
        h = _leave(tp, h, part)
        if cfg.post_block_norm:
            h = apply_norm(cfg, p["norm1_post"], h)
        x = x + h
        hin = apply_norm(cfg, p["norm2"], x)
        if kind == MOE:
            h, _ = moe_mod.moe_ffn(cfg, p["moe"], hin, tp)
        else:
            m_part = tp is not None and tp.mlp_sharded()
            h = _leave(tp, apply_mlp(cfg, p["mlp"], hin), m_part)
        if cfg.post_block_norm:
            h = apply_norm(cfg, p["norm2_post"], h)
        return x + h, cache
    raise ValueError(kind)


def _shared_decode(cfg: ModelConfig, shared: Params, x: torch.Tensor,
                   emb0: torch.Tensor, cache, pos: torch.Tensor, tp):
    """Zamba2's shared block in a decode step: its in_proj's rows gathered,
    its attention on the rank's KV heads of its cache, its MLP's
    columns."""
    heads = None if tp is None else tp.heads()
    part = heads is not None and heads.reduce
    hin = _shared_block(cfg, shared, x, emb0, tp, part, rows=True)
    h, cache = attn_mod.attention_decode(cfg, shared["attn"], hin, cache,
                                         pos, None, heads)
    x = x + _leave(tp, h, part)
    m_part = tp is not None and tp.mlp_sharded()
    return x + _leave(tp, apply_mlp(cfg, shared["mlp"], apply_norm(
        cfg, shared["norm2"], x)), m_part), cache


def _decode_layer(cfg: ModelConfig, plan: RankPlan, i: int, kind: str,
                  p: Params, x: torch.Tensor, cache, cspec, pos, emb0,
                  shared, shared_tp):
    """One decode layer on a rank: its parameters gathered, its cache
    gathered where the rank does not hold what the layer reads (the ring
    buffer's W blocks; a B = 1 recurrent state's dim 1 over the data
    axes), the layer run, and the rank's blocks of the cache kept (the new
    slot written by the rank that holds it)."""
    p, tp = plan.layer(i, kind, p)
    work = plan.cache_gather(cache, cspec)
    x, work = apply_layer_decode(cfg, kind, p, x, work, pos, emb0, shared,
                                 tp, shared_tp)
    in_place = isinstance(cache, attn_mod.KVCache)
    return x, plan.cache_block(cache, work, cspec, in_place)


def decode_step(cfg: ModelConfig, params: Params, caches,
                tokens: torch.Tensor, pos: torch.Tensor, ctx=None):
    """One-token decode. tokens: (B,) (or (B, C) audio); pos: (B,).

    Returns (logits (B, V) or (B, C, V), the new caches: one a layer, the
    KV caches written in place, the recurrent states new). With a
    ``MeshCtx``: ``tokens`` and ``pos`` global, ``caches`` the rank's
    ``ShardedCaches``; the logits are the rank's rows.
    """
    plan = mesh_plan(cfg, ctx, int(tokens.shape[0]))
    if plan is not None:
        if not isinstance(caches, ShardedCaches) \
                or caches.batch != plan.batch:
            raise ValueError("over a mesh decode_step takes the rank's "
                             "ShardedCaches of the same global batch "
                             "(init_caches(..., ctx=) or shard_caches)")
        tokens, pos = plan.local_rows(tokens), plan.local_rows(pos)
    dtype = compute_dtype(cfg)
    x = _lookup(cfg, params, tokens, dtype, plan)[:, None]  # (B, 1, D)
    if cfg.scale_embeddings:
        x = x * rounded(cfg.d_model ** 0.5, dtype)
    if not cfg.use_rope and cfg.modality == "audio":
        x = x + sinusoidal(pos, cfg.d_model).to(dtype)[:, None]
    emb0 = x if MAMBA2_SHARED in cfg.pattern else None
    shared, shared_tp = params.get("shared_attn"), None
    if plan is not None and shared is not None:
        shared, shared_tp = plan.shared_block(shared)
    new_caches = []
    for i, (kind, p, cache) in enumerate(zip(cfg.pattern, params["layers"],
                                             caches, strict=True)):
        if plan is None:
            x, cache = apply_layer_decode(cfg, kind, p, x, cache, pos, emb0,
                                          shared)
        else:
            x, cache = _decode_layer(cfg, plan, i, kind, p, x, cache,
                                     caches.specs[i], pos, emb0, shared,
                                     shared_tp)
        new_caches.append(cache)
    logits = _readout(cfg, params, x, plan)[:, 0]
    if plan is not None:
        new_caches = ShardedCaches(new_caches, caches.specs, caches.batch)
    return logits, new_caches
