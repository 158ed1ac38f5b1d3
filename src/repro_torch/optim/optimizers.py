"""Optimizers (``repro.optim.optimizers``): AdamW, SGD and IAG, with
``apply_updates``, ``clip_by_global_norm`` and ``cosine_schedule``.

IAG — *incremental aggregate gradient* — is the paper's mechanism lifted to
gradient training: as IVI memoizes per-document statistics and updates the
global accumulator by subtract-old/add-new, IAG memoizes the last gradient
of each data shard and keeps the aggregate gradient exact:

    G ← G − g_shard_old + g_shard_new ;   θ ← θ − η · G / S

(Le Roux et al. 2012's SAG). Memory is one gradient copy a shard.

The trees are the port's parameter trees: dicts and lists of tensors.
``repro`` maps each step over whole trees, and XLA fuses the temporaries
away; eagerly, each of ``m̂``, ``v̂`` and the update would be a whole fp32
tree (12.3 GB at Qwen2.5-3B's 3.086 B parameters). So every function here
works leaf by leaf, with ``repro``'s element-wise expressions, and writes
its results in place: only one leaf's temporaries are live at a time.
- ``clip_by_global_norm`` scales the gradients in place;
- ``Optimizer.update`` writes the new state into the state's buffers and
  the updates into the gradients' buffers, and returns both;
- ``apply_updates`` adds the updates into the parameters.
Pass copies to keep what goes in. The step count and the learning rate
stay 0-dim tensors on the parameters' device, so a step reads nothing
back to the host.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.sharding.rules import entry_axes
from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]   # (grads, state, params) → (upd, state)


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _count(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: lr)


@torch.no_grad()
def apply_updates(params, updates):
    """``params + updates`` in each parameter's dtype, added in place;
    returns ``params``."""
    for p, u in zip(tree_leaves(params), tree_leaves(updates), strict=True):
        p.add_(u)
    return params


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, comm=None, specs=None):
    """Scale ``grads`` in place by min(1, max_norm / (‖g‖ + 1e-9)), the
    norm's squares summed in fp32 over the leaves in ``repro``'s
    (``jax.tree_util``'s) order. Returns (grads, the norm before
    clipping).

    Over a mesh ``grads`` are a rank's blocks placed by ``specs`` (the
    parameters' ``Spec`` tree) and ``comm`` its collectives: each element
    counts once, a block replicated over an axis at that axis's first
    position only (as ``unshard_tree`` takes it), and the ranks' sums are
    added in coordinate order over every axis."""
    leaves = tree_leaves(grads)
    counted = [True] * len(leaves)
    if comm is not None:
        counted = [all(comm.coords[a] == 0 for a in comm.shape
                       if a not in {x for e in spec for x in entry_axes(e)})
                   for spec in _spec_leaves(grads, specs)]
    total = None
    for g, c in zip(leaves, counted):
        if not c:
            continue
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    if total is None:
        total = torch.zeros((), device=leaves[0].device)
    if comm is not None:
        total = comm.ordered_sum(total, tuple(comm.shape))
    norm = torch.sqrt(total)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for g in leaves:
        g.mul_(scale)
    return grads, norm


def _spec_leaves(tree, specs):
    """The ``Spec`` of each leaf of ``tree``, in ``tree_leaves``' order
    (a ``Spec`` is a tuple: the walk follows ``tree``)."""
    by_id = {}
    tree_map(lambda t, s: by_id.__setitem__(id(t), s), tree, specs)
    return [by_id[id(t)] for t in tree_leaves(tree)]


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Linear warm-up over ``warmup`` steps, then a cosine to 0 at
    ``total``; ``lr(step)`` is an fp32 tensor of ``step``'s shape."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW as ``repro`` computes it: bias correction by ``1 − b**c``, eps
    outside the square root, the decoupled weight decay added inside the
    step (skipped when it is 0)."""
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"m": tree_map(_zeros, params), "v": tree_map(_zeros, params),
                "count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params):
        c = state["count"] + 1
        neg_step = -lr_fn(c)
        bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                              tree_leaves(state["v"]), tree_leaves(params),
                              strict=True):
            g32 = g.float()
            torch.add(b1 * m, (1 - b1) * g32, out=m)
            torch.add(b2 * v, (1 - b2) * torch.square(g32), out=v)
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            torch.mul(u, neg_step, out=g)
        return grads, {"m": state["m"], "v": state["v"], "count": c}

    return Optimizer(init, update)


def sgd(lr, momentum: float = 0.9) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"mu": tree_map(_zeros, params), "count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params):
        c = state["count"] + 1
        neg_step = -lr_fn(c)
        for g, mu in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                         strict=True):
            torch.add(momentum * mu, g.float(), out=mu)
            torch.mul(mu, neg_step, out=g)
        return grads, {"mu": state["mu"], "count": c}

    return Optimizer(init, update)


def iag(lr, num_shards: int) -> Optimizer:
    """Incremental aggregate gradient (SAG). ``update`` needs ``shard=``,
    the shard's index (an int).

    The state holds each shard's memoized gradient (``memo``, a leading
    ``num_shards`` axis) and their aggregate; each call replaces one
    shard's gradient, subtract-old/add-new as IVI's eq. (4) replaces a
    document's π, and steps by the aggregate over the shards seen."""
    lr_fn = _lr_fn(lr)

    def init(params):
        leaves = tree_leaves(params)
        return {
            "memo": tree_map(lambda p: torch.zeros(
                (num_shards,) + tuple(p.shape), dtype=torch.float32,
                device=p.device), params),
            "agg": tree_map(_zeros, params),
            "seen": torch.zeros((num_shards,), dtype=torch.bool,
                                device=leaves[0].device),
            "count": _count(params),
        }

    @torch.no_grad()
    def update(grads, state, params, *, shard: int):
        shard = int(shard)
        c = state["count"] + 1
        state["seen"][shard] = True
        denom = torch.clamp(state["seen"].sum().to(torch.float32), min=1.0)
        neg_step = -lr_fn(c)
        for g, a, memo in zip(tree_leaves(grads), tree_leaves(state["agg"]),
                              tree_leaves(state["memo"]), strict=True):
            g32 = g.float()
            torch.sub(a + g32, memo[shard], out=a)
            memo[shard].copy_(g32)
            torch.div(a * neg_step, denom, out=g)
        return grads, {"memo": state["memo"], "agg": state["agg"],
                       "seen": state["seen"], "count": c}

    return Optimizer(init, update)
