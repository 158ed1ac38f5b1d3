"""Symmetric Dirichlet hyperparameter learning (Minka's fixed point).

The port's copy of ``repro.core.hyper``. Real LDA deployments learn α₀
and β₀ rather than hand-setting them; the paper fixes them (§6), so these
updates are off by default, helpers for the examples and benchmarks.

The fixed point for a symmetric Dirichlet prior a over dimension K, given
posterior parameter rows θ_d ~ Dir(γ_d):

    a ← a · Σ_d Σ_k [ψ(γ_dk) − ψ(a_old)] / (K · Σ_d [ψ(Σ_k γ_dk) − ψ(K a_old)])

On torch tensors on their own device, with ``torch.special.digamma``, in
the posterior's dtype (``repro`` computes in fp32).
"""
from __future__ import annotations

import torch


def minka_update(a, post: torch.Tensor, iters: int = 5,
                 floor: float = 1e-4) -> torch.Tensor:
    """``iters`` Minka fixed-point steps for the symmetric prior ``a``.

    post: (N, K) posterior Dirichlet parameters whose prior is a·1_K.
    Returns a 0-d tensor on ``post``'s device, in its dtype.
    """
    _, k = post.shape
    a_cur = torch.as_tensor(a, dtype=post.dtype, device=post.device)
    psi_post = torch.special.digamma(post)
    psi_sum = torch.special.digamma(post.sum(-1))
    for _ in range(iters):
        num = torch.sum(psi_post - torch.special.digamma(a_cur))
        den = k * torch.sum(psi_sum - torch.special.digamma(k * a_cur))
        a_cur = torch.clamp(a_cur * num / torch.clamp(den, min=1e-12),
                            min=floor)
    return a_cur


def update_alpha0(alpha0: float, gammas: torch.Tensor,
                  iters: int = 5) -> float:
    """Learn the document-topic prior from fitted γ (D, K)."""
    return float(minka_update(alpha0, gammas, iters))


def update_beta0(beta0: float, lam: torch.Tensor, iters: int = 5) -> float:
    """Learn the topic-word prior from λ (V, K): the Dirichlets live on V."""
    return float(minka_update(beta0, lam.T, iters))
