"""Mixture-of-Experts FFN (``repro.models.moe``) on one card.

``repro`` sorts the (token, slot) pairs by routed expert (a stable
argsort), slices the contiguous segment of a model rank's experts (one
capacity-bounded slice), runs the expert FFNs with ``jax.lax.ragged_dot``
and scatters back; over a mesh a ``psum`` combines the ranks' partial sums.
The port keeps that order of operations with ``ctx=None`` (one rank, a
dropless capacity):
- the router's logits are a product in the activations' dtype, cast to
  fp32, then softmax and top-k; ties go to the lower expert index, as
  ``jax.lax.top_k`` breaks them (a stable descending sort);
- each expert's three products run through ``torch.mm`` on its sorted rows,
  a loop over the non-empty segments, whose sizes it reads on the host
  (one device-to-host read a call);
- each token's k expert outputs are added in ascending expert order in the
  activations' dtype, as ``repro``'s scatter-add over the sorted rows
  does: deterministic, with no atomics.

Over a mesh (``moe_ffn`` with a rank's plan, `repro_torch.sharding.ctx`)
the block follows ``repro``'s ``_moe_block``: the experts over ``model``,
the shared experts' F over ``model``, the router whole; each model rank
runs ``moe_ffn_local`` on its data shard's tokens with ``repro``'s per-rank
capacity, ``y`` is summed over ``model``, and the statistics are summed
over ``model`` and divided by its size, then over the data axes
(``lb_loss`` divided by their size). A batch the data axes do not divide
is replicated over them. ``moe_block_emulated`` is the same function in
one process. Under autograd the block's input and its router enter
through Megatron's *f* (their gradients summed over ``model``), the
capacity stays ``repro``'s per-rank one, and ``lb_loss``'s division by
the model axis's size makes the ranks' repeated statistics count once.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Params, truncated_normal
from repro_torch.sharding.ctx import MeshCtx

AuxDict = Dict[str, torch.Tensor]

__all__ = ["MeshCtx", "moe_block_emulated", "moe_ffn", "moe_ffn_local",
           "moe_init"]


def moe_init(cfg: ModelConfig, *, generator, device) -> Params:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    draw = dict(generator=generator, device=device)
    p: Params = {
        "router": truncated_normal((d, e), d ** -0.5, **draw),
        "w_gate": truncated_normal((e, d, f), d ** -0.5, **draw),
        "w_up": truncated_normal((e, d, f), d ** -0.5, **draw),
        "w_down": truncated_normal((e, f, d), f ** -0.5, **draw),
    }
    if cfg.num_shared_experts:
        fs = cfg.moe_d_ff * cfg.num_shared_experts
        p["shared"] = {
            "w_gate": truncated_normal((d, fs), d ** -0.5, **draw),
            "w_up": truncated_normal((d, fs), d ** -0.5, **draw),
            "w_down": truncated_normal((fs, d), fs ** -0.5, **draw),
        }
    return p


def _capacity(cfg: ModelConfig, n_tokens: int, m_size: int) -> int:
    """Static per-rank token-slot capacity."""
    rows = n_tokens * cfg.num_experts_per_tok
    cap = int(rows * cfg.moe_capacity_factor / m_size) + 8
    cap = max(cap, 8 * cfg.num_experts_per_tok)
    cap = min(cap, rows)
    return ((cap + 7) // 8) * 8 if cap >= 8 else cap


def route(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """The router: (probs (N, E) fp32, top-k weights (N, k) fp32, top-k
    expert ids (N, k)), the weights renormalised where
    ``cfg.norm_topk_prob`` is set. x: (N, D)."""
    logits = (x @ p["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    # the k largest, the lower index first among equals (jax.lax.top_k)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p = top_p[:, :cfg.num_experts_per_tok]
    top_i = top_i[:, :cfg.num_experts_per_tok]
    if cfg.norm_topk_prob:
        top_p = top_p / (top_p.sum(-1, keepdim=True) + 1e-20)
    return probs, top_p, top_i


def expert_ffn(p: Params, g: int, xs: torch.Tensor) -> torch.Tensor:
    """Routed expert ``g``'s SwiGLU FFN on its rows xs (M, D); ``p`` holds
    the (E, ...) stacks, or a sequence an expert of each."""
    dt = xs.dtype
    h = F.silu(xs @ p["w_gate"][g].to(dt)) * (xs @ p["w_up"][g].to(dt))
    return h @ p["w_down"][g].to(dt)


def moe_ffn_local(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  rank: int = 0, m_size: int = 1
                  ) -> Tuple[torch.Tensor, AuxDict]:
    """Routed-expert FFN for model rank ``rank`` of ``m_size``; one card
    runs rank 0 of 1. x: (N, D); ``p["w_*"]``: the rank's expert shard
    (E/m, D|F, F|D); ``p["router"]``: every expert's. Returns the partial
    output and the aux statistics."""
    n, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    el = e // m_size
    dt = x.dtype

    probs, top_p, top_i = route(cfg, p, x)
    e_flat = top_i.reshape(-1)                                  # (N·k,)
    w_flat = top_p.reshape(-1)
    e_sorted, order = torch.sort(e_flat, stable=True)           # stable
    # each expert's first sorted row (bincount would read max() on the host)
    offsets = torch.searchsorted(e_sorted, torch.arange(
        e + 1, device=x.device, dtype=e_sorted.dtype))          # (E+1,)
    counts = torch.diff(offsets)                                # (E,)

    cap = _capacity(cfg, n, m_size)
    if x.device.type == "meta":
        # shape only (the dry run): the rank's segment fills its capacity,
        # its experts' rows spread evenly, as repro's static cap-row
        # products are sized
        off = [rank * cap + (j * cap) // el for j in range(el + 1)]
    else:
        # the segment sizes on the host: one device-to-host read a call
        off = offsets[rank * el: rank * el + el + 1].tolist()
    lo, hi = off[0], off[-1]
    live = min(hi - lo, cap)
    # each (token, slot) pair's output at its sorted position; rows past
    # the capacity stay 0, as repro's ``live`` mask makes them
    out = x.new_zeros((n * k, d))
    # the expert stacks as one view an expert, taken once: in training the
    # backward then stacks the experts' gradients once a stack (indexing an
    # expert would give each its own zero-filled (E, D, F) gradient)
    experts = {w: p[w].unbind(0) for w in ("w_gate", "w_up", "w_down")}
    # under autograd an empty expert runs on no rows all the same: every
    # rank's graph then reaches every weight, so every rank runs the
    # backward's collectives of its gathered experts
    keep_empty = torch.is_grad_enabled() and p["w_up"].requires_grad
    for j in range(el):
        a, b = min(max(off[j] - lo, 0), live), min(max(off[j + 1] - lo, 0),
                                                    live)
        if a == b and not keep_empty:
            continue
        rows = order[lo + a: lo + b]
        out[lo + a: lo + b] = expert_ffn(experts, j, x[rows // k]) \
            * w_flat[rows].to(dt)[:, None]

    # each token's k rows in ascending expert order, added in ``dt``
    where = torch.empty_like(order)
    where[order] = torch.arange(n * k, device=x.device)
    slots = torch.argsort(top_i, dim=-1)                        # (N, k)
    flat = torch.arange(n, device=x.device)[:, None] * k + slots
    parts = out[where[flat]]                                    # (N, k, D)
    y = parts[:, 0]
    for j in range(1, k):
        y = y + parts[:, j]

    if cfg.num_shared_experts:
        sp = p["shared"]
        hs = F.silu(x @ sp["w_gate"].to(dt)) * (x @ sp["w_up"].to(dt))
        y = y + hs @ sp["w_down"].to(dt)

    aux = {
        "counts": counts.float(),
        "lb_loss": e * torch.sum((counts / (n * k)) * probs.mean(0)),
        "dropped": torch.full((), float(max((hi - lo) - cap, 0)),
                              device=x.device),
    }
    return y, aux


def _expert_blocks(cfg: ModelConfig, p: Params, spec, plan) -> Params:
    """The rank's experts (E/M) and shared-expert columns (F/M): the
    block's own placements, whatever the rules gave the leaves."""
    out = dict(p)
    for w in ("w_gate", "w_up", "w_down"):
        if not plan.model_sharded(spec[w], 0):
            out[w] = plan.model_block(p[w], 0)
    if cfg.num_shared_experts:
        sh, ss = p["shared"], spec["shared"]
        out["shared"] = {
            w: sh[w] if plan.model_sharded(ss[w], dim)
            else plan.model_block(sh[w], dim)
            for w, dim in (("w_gate", 1), ("w_up", 1), ("w_down", 0))}
    return out


def _packed(aux: AuxDict) -> torch.Tensor:
    return torch.cat([aux["lb_loss"].reshape(1).float(),
                      aux["dropped"].reshape(1).float(),
                      aux["counts"].float()])


def _unpacked(v: torch.Tensor) -> AuxDict:
    return {"lb_loss": v[0], "dropped": v[1], "counts": v[2:]}


def moe_ffn(cfg: ModelConfig, p: Params, x: torch.Tensor,
            tp=None) -> Tuple[torch.Tensor, AuxDict]:
    """x: (B, S, D) → (B, S, D) and the aux statistics. ``tp``: a model
    rank's layer plan (`repro_torch.sharding.ctx.LayerPlan`), in the
    place of ``repro``'s ``ctx``; ``p`` then holds the leaves gathered
    over the data axes and ``x`` the rank's rows."""
    b, s, d = x.shape
    if tp is None:
        y, aux = moe_ffn_local(cfg, p, x.reshape(-1, d))
        return y.reshape(b, s, d), aux
    plan, spec = tp.plan, tp.spec["moe"]
    m_size = plan.m_size if plan.tp else 1
    rank = plan.m if plan.tp else 0
    x = tp.enter(x, m_size > 1)
    b, s, d = x.shape
    if m_size > 1:
        p = _expert_blocks(cfg, p, spec, plan)
    y, aux = moe_ffn_local(cfg, p, x.reshape(-1, d), rank, m_size)
    y = tp.leave(y.reshape(b, s, d), m_size > 1)
    if m_size > 1:
        stats = plan.comm.ordered_sum(_packed(aux), (plan.model,)) / m_size
    else:
        stats = _packed(aux)
    if plan.batch_sharded and plan.n_data > 1:
        # reduce stats over data so outputs are fully replicated
        stats = plan.comm.ordered_sum(stats, plan.ctx.data_axes)
        stats = torch.cat([stats[:1] / plan.n_data, stats[1:]])
    return y, _unpacked(stats)


def moe_block_emulated(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                       data: int, model: int
                       ) -> Tuple[torch.Tensor, AuxDict]:
    """The MoE block over a (``data``, ``model``) mesh in one process
    (``repro``'s sharded ``_moe_block``): each data shard's tokens through
    each model rank's ``moe_ffn_local`` (its E/M experts, its F/M
    shared-expert columns, ``repro``'s per-rank capacity), the partials and
    statistics summed in rank order. ``p``: the whole block; x (B, S, D).
    A twin for the tests and the card check, on no serving path."""
    b, s, d = x.shape
    if b % data:
        data = 1                # replicated over the data axes
    e, fsh = cfg.num_experts, cfg.moe_d_ff * cfg.num_shared_experts
    ys, rows = [], b // data
    stats = None
    for i in range(data):
        xi = x[i * rows:(i + 1) * rows].reshape(-1, d)
        part, st = None, None
        for r in range(model):
            pr = dict(p)
            for w in ("w_gate", "w_up", "w_down"):
                pr[w] = p[w][r * e // model:(r + 1) * e // model]
            if cfg.num_shared_experts:
                c = slice(r * fsh // model, (r + 1) * fsh // model)
                sh = p["shared"]
                pr["shared"] = {"w_gate": sh["w_gate"][:, c],
                                "w_up": sh["w_up"][:, c],
                                "w_down": sh["w_down"][c]}
            y, aux = moe_ffn_local(cfg, pr, xi, r, model)
            part = y if part is None else part + y
            v = _packed(aux)
            st = v if st is None else st + v
        ys.append(part.reshape(rows, s, d))
        st = st / model
        stats = st if stats is None else stats + st
    if data > 1:
        stats = torch.cat([stats[:1] / data, stats[1:]])
    return torch.cat(ys), _unpacked(stats)
