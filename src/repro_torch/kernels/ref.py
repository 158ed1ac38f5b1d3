"""Plain torch oracles of the dense E-step and of attention.

The dense (TPU) formulation of the E-step:

  P = Eθ · Eφᵀ              (B, V)   "phinorm"
  R = C ⊘ (P + ε)           (B, V)
  sweep:  γ' = α₀ + Eθ ⊙ (R · Eφ)            — one fixed-point iteration
  sstats: S  = Eφ ⊙ (Rᵀ · Eθ)                — Σ_d cnt·π scattered to (V, K)

and multi-head attention over (BH, S, hd). These are the functions the
hand-written kernels compute; the kernels' plain twins call them.
"""
from __future__ import annotations

from typing import Optional

import torch

_EPS = 1e-30  # fp32-safe (1e-100 underflows to 0)
NEG_INF = -1e30


def estep_sweep_ref(c: torch.Tensor, etheta: torch.Tensor, eb: torch.Tensor,
                    alpha0: float) -> torch.Tensor:
    """One dense fixed-point sweep: γ' (B, K)."""
    p = etheta @ eb.T + _EPS                   # (B, V)
    return alpha0 + etheta * ((c / p) @ eb)


def sstats_ref(c: torch.Tensor, etheta: torch.Tensor,
               eb: torch.Tensor) -> torch.Tensor:
    """Expected topic-word counts for the batch: S (V, K)."""
    p = etheta @ eb.T + _EPS                   # (B, V)
    return eb * ((c / p).T @ etheta)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool = True, scale: Optional[float] = None
            ) -> torch.Tensor:
    """Oracle for the flash-attention kernel. q, k, v: (BH, S, hd)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q, k).to(torch.float32) * scale
    if causal:
        n = q.shape[1]
        mask = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w.to(v.dtype), v)
