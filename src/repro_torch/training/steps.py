"""Step builders (``repro.training.steps``): the train step (loss,
gradients, optimizer), and the prefill and serve steps.

``make_prefill_step`` and ``make_serve_step`` return the functions a
server calls, run under ``torch.inference_mode`` (no autograd state).
Over a mesh (a ``MeshCtx``) each rank calls them with the global inputs
and its blocks of the parameters and caches: the prefill returns the
rank's rows of the last logits, the serve step the global batch's next
tokens and the rank's rows of the logits.
``make_train_step`` runs ``T.loss_fn`` with autograd on the fp32 masters
(``cfg.remat`` checkpoints each layer), then clips, steps the optimizer
and applies the updates, all in place (`repro_torch.optim`). Over a mesh
each rank calls it with the global batch and its blocks of the
parameters and optimizer state (``shard_train_state``): the gradients of
its blocks come out of the backward summed over the ranks that shared
the work (`repro_torch.sharding.comm`), the global norm counts every
element once, and the optimizer updates the blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.optim import Optimizer, apply_updates, clip_by_global_norm
from repro_torch.sharding.ctx import ctx_param_specs
from repro_torch.sharding.rules import Spec, shard_tree, unshard_tree
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: Any


def loss_and_grads(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
                   microbatches: int = 1, ctx=None
                   ) -> Tuple[Dict[str, torch.Tensor], Any]:
    """``T.loss_fn``'s metrics and its gradients with respect to
    ``params`` (fp32, the structure of ``params``), as ``repro``'s
    ``value_and_grad`` gives them.

    With ``microbatches`` > 1 the batch splits on its leading axis into
    that many equal parts; each part's backward adds its gradients into
    the same fp32 ``.grad`` buffers, and the sums and the metrics are then
    divided by the count: the mean of per-microbatch means, as ``repro``
    takes it. One gradient tree is live, never a second accumulator.

    Over a mesh (``ctx``) ``batch`` is the global batch and ``params`` the
    rank's blocks: microbatch i is block i of the global rows (``repro``'s
    reshape of a data-sharded leading axis), of which each rank takes its
    rows; the gradients are those of the rank's blocks."""
    n = next(iter(batch.values())).shape[0]
    if n % microbatches:
        raise ValueError(f"a batch of {n} does not split into "
                         f"{microbatches} microbatches")
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    metrics = None
    for i in range(microbatches):
        part = {k: v.reshape((microbatches, n // microbatches) + v.shape[1:])
                [i] for k, v in batch.items()}
        with torch.enable_grad():
            loss, m = T.loss_fn(cfg, live, part, ctx)
            loss.backward()
        m = {k: v.detach() for k, v in m.items()}
        metrics = m if metrics is None else {k: metrics[k] + m[k]
                                             for k in metrics}
    grads = tree_map(lambda p: p.grad if p.grad is not None
                     else torch.zeros_like(p), live)
    if microbatches > 1:
        for g in tree_leaves(grads):
            g.div_(microbatches)
        metrics = {k: v / microbatches for k, v in metrics.items()}
    return metrics, grads


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, ctx=None,
                    clip_norm: float = 1.0, microbatches: int = 1):
    """Returns ``train_step(state, batch) → (state, metrics)``: the
    gradients by ``loss_and_grads``, clipped to ``clip_norm`` by global
    norm, the optimizer's update applied; ``metrics`` adds ``grad_norm``
    (before clipping). The state's parameters and optimizer buffers are
    updated in place and returned in a new ``TrainState``. With a
    ``MeshCtx`` the state holds the rank's blocks (``shard_train_state``)
    and ``batch`` is the global batch."""
    ctx = T.check_ctx(ctx)
    specs = None if ctx is None else ctx_param_specs(cfg, ctx)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        metrics, grads = loss_and_grads(cfg, state.params, batch,
                                        microbatches, ctx)
        grads, gnorm = clip_by_global_norm(
            grads, clip_norm, comm=None if ctx is None else ctx.comm,
            specs=specs)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        params = apply_updates(state.params, updates)
        return (TrainState(params, opt_state, state.step + 1),
                dict(metrics, grad_norm=gnorm))

    return train_step


def train_state_specs(cfg: ModelConfig, ctx, opt_state) -> TrainState:
    """The placement of a ``TrainState`` on ``ctx``'s mesh, as ``repro``'s
    dry run places it: ``param_specs`` of the parameters' full shapes; a
    parameter-shaped optimizer tree (AdamW's moments, SGD's momentum,
    IAG's aggregate and its memo, whose leading shard axis stays whole)
    as its parameters; the step, the counts and IAG's ``seen``
    replicated. ``opt_state``: the full state or the rank's (only its
    structure and ranks are read)."""
    pspecs = ctx_param_specs(cfg, ctx)

    def tree(v):
        if isinstance(v, dict) and set(v) == set(pspecs):
            return tree_map(lambda t, s: Spec(*([None] * (t.ndim - len(s))),
                                              *s), v, pspecs)
        return tree_map(lambda t: Spec(*([None] * t.ndim)), v)

    return TrainState(pspecs, {k: tree(v) for k, v in opt_state.items()},
                      Spec())


def shard_train_state(cfg: ModelConfig, state: TrainState, ctx
                      ) -> TrainState:
    """The rank's blocks of a full ``TrainState`` (parameters, optimizer
    state, step) on ``ctx``: copies, so the full state can be freed. A
    step that is a Python int stays one."""
    specs = train_state_specs(cfg, ctx, state.opt_state)

    def cut(part, spec):
        if not isinstance(part, (dict, torch.Tensor)):
            return part
        return shard_tree(ctx.mesh, part, spec, ctx.comm.coords)
    return TrainState(cut(state.params, specs.params),
                      cut(state.opt_state, specs.opt_state),
                      cut(state.step, specs.step))


def unshard_train_state(cfg: ModelConfig, ctx, states) -> TrainState:
    """``shard_train_state``'s inverse: the full ``TrainState`` from every
    rank's (``states[r]`` rank r's, in ``mesh_coords``' order; a block
    replicated over an axis taken from its first position)."""
    specs = train_state_specs(cfg, ctx, states[0].opt_state)

    def join(field, spec):
        parts = [getattr(st, field) for st in states]
        if not isinstance(parts[0], (dict, torch.Tensor)):
            return parts[0]
        return unshard_tree(ctx.mesh, parts, spec)
    return TrainState(join("params", specs.params),
                      join("opt_state", specs.opt_state),
                      join("step", specs.step))


def make_prefill_step(cfg: ModelConfig, ctx=None, *,
                      attention: Optional[str] = None):
    """Inference forward over full sequences (no grads, no labels).

    Returns only the **last position's** logits (what the decode loop
    consumes): (B, V), or (B, C, V) for audio. ``attention`` picks the
    attention's route (`repro_torch.models.attention.attention_route`): by
    default K9 on CUDA, the plain chunked scan on the CPU.
    """
    T.check_ctx(ctx)

    @torch.inference_mode()
    def prefill_step(params, batch):
        plan = T.batch_plan(cfg, ctx, batch)
        hidden, _ = T.forward_hidden(cfg, params, batch, attention=attention,
                                     plan=plan)
        return T._readout(cfg, params, hidden[:, -1:], plan)[:, 0]

    return prefill_step


def make_serve_step(cfg: ModelConfig, ctx=None, greedy: bool = True):
    """One-token decode against the caches (`T.decode_step`).
    ``serve_step(params, caches, tokens, pos)`` returns (next tokens, int32
    argmax of the logits; logits; the new caches). ``greedy`` is ``repro``'s flag,
    which its step does not read either."""
    T.check_ctx(ctx)

    @torch.inference_mode()
    def serve_step(params, caches, tokens, pos):
        logits, caches = T.decode_step(cfg, params, caches, tokens, pos, ctx)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        if ctx is not None:
            plan = T.mesh_plan(cfg, ctx, int(tokens.shape[0]))
            next_tok = ctx.comm.all_gather(next_tok, 0, plan.batch_axes)
        return next_tok, logits, caches

    return serve_step
