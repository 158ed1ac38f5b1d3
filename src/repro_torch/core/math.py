"""Shared LDA variational math: Dirichlet expectations and bound pieces."""
from __future__ import annotations

import math

import torch
from torch.special import digamma, gammaln


def dirichlet_expectation(a: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """E_q[ln x] for x ~ Dirichlet(a) along ``axis``: ψ(a) − ψ(Σa)."""
    return digamma(a) - digamma(a.sum(dim=axis, keepdim=True))


def exp_dirichlet_expectation(a: torch.Tensor,
                              axis: int = -1) -> torch.Tensor:
    return torch.exp(dirichlet_expectation(a, axis=axis))


def dirichlet_elbo_term(post: torch.Tensor, prior0: float,
                        elog: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """E_q[ln p(x; prior)] − E_q[ln q(x; post)] summed over all Dirichlets.

    ``post`` is the posterior parameter array with the Dirichlet dimension
    on ``axis``; ``elog`` is E_q[ln x] with matching shape; ``prior0`` the
    symmetric prior. Returns a scalar tensor.
    """
    n = post.shape[axis]
    kl = (((prior0 - post) * elog).sum() + gammaln(post).sum()
          - gammaln(post.sum(dim=axis)).sum())
    num = post.numel() // n
    const = num * (math.lgamma(n * prior0) - n * math.lgamma(prior0))
    return kl + const


def safe_normalize(x: torch.Tensor, axis: int = -1,
                   eps: float = 1e-30) -> torch.Tensor:
    return x / (x.sum(dim=axis, keepdim=True) + eps)
