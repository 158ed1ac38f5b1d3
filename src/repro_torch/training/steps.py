"""Step builders: the prefill and serve steps (``repro.training.steps``).

``make_prefill_step`` and ``make_serve_step`` return the functions a
server calls, run under ``torch.inference_mode`` (no autograd state;
``repro``'s ``remat`` applies to training only). ``make_train_step`` and
``TrainState`` wait for the training slice (ROADMAP §1 item 10.3).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


class TrainState:
    """Not ported: the training slice (ROADMAP §1 item 10.3)."""

    def __init__(self, *args, **kwargs):
        raise T.training_not_ported("TrainState")


def make_train_step(cfg: ModelConfig, optimizer=None, ctx=None, **kwargs):
    """Not ported: the training slice (ROADMAP §1 item 10.3)."""
    raise T.training_not_ported("make_train_step")


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
        hidden, _ = T.forward_hidden(cfg, params, batch, attention=attention)
        return T._readout(cfg, params, hidden[:, -1:])[:, 0]

    return prefill_step


def make_serve_step(cfg: ModelConfig, ctx=None, greedy: bool = True):
    """One-token decode against the caches (`T.decode_step`).
    ``serve_step(params, caches, tokens, pos)`` returns (next tokens, int32
    argmax of the logits; logits; the new caches). ``greedy`` is ``repro``'s flag,
    which its step does not read either."""
    T.check_ctx(ctx)

    @torch.inference_mode()
    def serve_step(params, caches, tokens, pos):
        logits, caches = T.decode_step(cfg, params, caches, tokens, pos)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, caches

    return serve_step
