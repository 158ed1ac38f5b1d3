"""Step builders (``repro.training.steps``): the train step (loss,
gradients, optimizer), and the prefill and serve steps.

``make_prefill_step`` and ``make_serve_step`` return the functions a
server calls, run under ``torch.inference_mode`` (no autograd state).
Over a mesh (a ``MeshCtx``) each rank calls them with the global inputs
and its blocks of the parameters and caches: the prefill returns the
rank's rows of the last logits, the serve step the global batch's next
tokens and the rank's rows of the logits. ``make_train_step`` over a mesh
raises naming ROADMAP §1 item 10.5.
``make_train_step`` runs ``T.loss_fn`` with autograd on the fp32 masters
(``cfg.remat`` checkpoints each layer), then clips, steps the optimizer
and applies the updates, all in place (`repro_torch.optim`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.optim import Optimizer, apply_updates, clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: Any


def loss_and_grads(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
                   microbatches: int = 1) -> Tuple[Dict[str, torch.Tensor],
                                                    Any]:
    """``T.loss_fn``'s metrics and its gradients with respect to
    ``params`` (fp32, the structure of ``params``), as ``repro``'s
    ``value_and_grad`` gives them.

    With ``microbatches`` > 1 the batch splits on its leading axis into
    that many equal parts; each part's backward adds its gradients into
    the same fp32 ``.grad`` buffers, and the sums and the metrics are then
    divided by the count: the mean of per-microbatch means, as ``repro``
    takes it. One gradient tree is live, never a second accumulator."""
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
            loss, m = T.loss_fn(cfg, live, part)
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
    updated in place and returned in a new ``TrainState``; ``ctx`` (a
    mesh) raises."""
    T.check_ctx(ctx, training=True)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        metrics, grads = loss_and_grads(cfg, state.params, batch,
                                        microbatches)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        params = apply_updates(state.params, updates)
        return (TrainState(params, opt_state, state.step + 1),
                dict(metrics, grad_norm=gnorm))

    return train_step


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
        plan = T.mesh_plan(cfg, ctx, T._batch_rows(batch))
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
