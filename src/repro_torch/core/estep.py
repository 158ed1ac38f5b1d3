"""Batched variational E-step for LDA, behind one backend contract.

Every engine consumes the E-step through ``EStepBackend``:

* ``solve(cfg, exp_elog_beta, batch, gamma0) -> EStepResult`` — run the
  per-document fixed point (Alg. 1 lines 4–7) on a padded BOW mini-batch.
* ``solve_correction(cfg, exp_elog_beta, batch, old_pi, visited)`` — the
  IVI hot path: E-step **plus** the subtract-old/add-new memo correction
  Σ_d cnt·(π_new − π_old) scattered into (V, K), with γ warm-started from
  the memo for visited documents.

Three backends:

* ``gather`` — token-aligned: gathers rows of exp(E[ln φ]) at the batch's
  token ids, shape (B, L, K); the reference the others are held to.
* ``dense`` — densifies the mini-batch into a count matrix C (B, V) so one
  sweep is two matrix products (the TPU formulation, kept as an oracle).
* ``cuda`` — the hand-written kernels (`repro_torch.kernels.ops`): the
  whole fixed point in one launch, then token π and a deterministic
  segment scatter.

All backends return γ and the token-aligned π (B, L, K) that IVI stores.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.math import exp_dirichlet_expectation
from repro_torch.core.types import LDAConfig

_EPS = 1e-30  # fp32-safe (1e-100 underflows to 0)


class BowBatch(NamedTuple):
    """A padded unique-token bag-of-words mini-batch (both (B, L))."""

    token_ids: torch.Tensor
    counts: torch.Tensor


class EStepResult(NamedTuple):
    gamma: torch.Tensor   # (B, K)
    pi: torch.Tensor      # (B, L, K) token-aligned responsibilities
    sstats: torch.Tensor  # (V, K) Σ_d Σ_l cnt·π scattered at token ids
    iters: torch.Tensor   # () int32 fixed-point iterations used


def _fixed_point(cfg: LDAConfig,
                 update_fn: Callable[[torch.Tensor], torch.Tensor],
                 gamma0: torch.Tensor):
    """Run γ ← update(γ) until mean |Δγ| ≤ tol or max_iters (batch-wide)."""
    tol = np.float32(cfg.estep_tol)     # compared in fp32, as in repro
    gamma, it, live = gamma0, 0, True
    while live and it < cfg.estep_max_iters:
        gamma_new = update_fn(gamma)
        delta = (gamma_new - gamma).abs().mean()
        gamma, it = gamma_new, it + 1
        live = bool(delta > float(tol))
    return gamma, torch.tensor(it, dtype=torch.int32, device=gamma.device)


def scatter_sstats(token_ids: torch.Tensor, weighted_pi: torch.Tensor,
                   vocab_size: int) -> torch.Tensor:
    """Scatter (B, L, K) token-aligned weighted responsibilities into (V, K)."""
    k = weighted_pi.shape[-1]
    out = torch.zeros((vocab_size, k), dtype=weighted_pi.dtype,
                      device=weighted_pi.device)
    return out.index_add_(0, token_ids.reshape(-1).long(),
                          weighted_pi.reshape(-1, k))


def quantize_pi(pi: torch.Tensor, pi_dtype: str) -> torch.Tensor:
    """Round π through the memo store's wire dtype (fp32 result)."""
    if pi_dtype == "float32":
        return pi
    return pi.to(getattr(torch, pi_dtype)).to(torch.float32)


def warm_start_gamma(cfg: LDAConfig, counts: torch.Tensor,
                     old_pi: torch.Tensor,
                     visited: torch.Tensor) -> torch.Tensor:
    """Memo-derived γ₀ (Alg. 1 line 6) for visited docs, fresh otherwise.

    Coordinate ascent from the memoized point can only improve the bound,
    which is what makes IVI's monotonicity exact.
    """
    gamma_memo = cfg.alpha0 + torch.einsum("blk,bl->bk", old_pi, counts)
    fresh = torch.full_like(gamma_memo, cfg.alpha0 + 1.0)
    return torch.where(visited[:, None], gamma_memo, fresh)


def _fresh_gamma(cfg: LDAConfig, b: int, device) -> torch.Tensor:
    return torch.full((b, cfg.num_topics), cfg.alpha0 + 1.0,
                      dtype=torch.float32, device=device)


def estep_gather(cfg: LDAConfig, exp_elog_beta: torch.Tensor,
                 token_ids: torch.Tensor, counts: torch.Tensor,
                 gamma0: Optional[torch.Tensor] = None) -> EStepResult:
    """Token-aligned batched E-step (Algorithm 1, lines 4–7).

    Args:
      exp_elog_beta: (V, K) exp(E[ln φ]).
      token_ids / counts: (B, L) padded unique-token BOW batch.
    """
    eb = exp_elog_beta[token_ids.long()]               # (B, L, K)
    if gamma0 is None:
        gamma0 = _fresh_gamma(cfg, token_ids.shape[0], eb.device)

    def update(gamma):
        etheta = exp_dirichlet_expectation(gamma)      # (B, K)
        p = torch.einsum("bk,blk->bl", etheta, eb) + _EPS
        return cfg.alpha0 + etheta * torch.einsum("bl,blk->bk",
                                                  counts / p, eb)

    gamma, iters = _fixed_point(cfg, update, gamma0)

    etheta = exp_dirichlet_expectation(gamma)
    p = torch.einsum("bk,blk->bl", etheta, eb) + _EPS
    pi = etheta[:, None, :] * eb / p[:, :, None]       # (B, L, K)
    pi = torch.where(counts[:, :, None] > 0, pi, 0.0)
    sstats = scatter_sstats(token_ids, counts[:, :, None] * pi,
                            exp_elog_beta.shape[0])
    return EStepResult(gamma=gamma, pi=pi, sstats=sstats, iters=iters)


def densify(token_ids: torch.Tensor, counts: torch.Tensor,
            vocab_size: int) -> torch.Tensor:
    """(B, L) BOW → dense count matrix C (B, V)."""
    c = torch.zeros((token_ids.shape[0], vocab_size), dtype=counts.dtype,
                    device=counts.device)
    return c.scatter_add_(1, token_ids.long(), counts)


def estep_dense(cfg: LDAConfig, exp_elog_beta: torch.Tensor,
                token_ids: torch.Tensor, counts: torch.Tensor,
                gamma0: Optional[torch.Tensor] = None) -> EStepResult:
    """Dense-count E-step: one sweep = two (B, V)×(V, K) products.

    The TPU formulation; the same fixed point and π as ``estep_gather``.
    """
    c = densify(token_ids, counts, exp_elog_beta.shape[0])   # (B, V)
    if gamma0 is None:
        gamma0 = _fresh_gamma(cfg, token_ids.shape[0], c.device)

    def update(gamma):
        etheta = exp_dirichlet_expectation(gamma)      # (B, K)
        p = etheta @ exp_elog_beta.T + _EPS            # (B, V)
        return cfg.alpha0 + etheta * ((c / p) @ exp_elog_beta)

    gamma, iters = _fixed_point(cfg, update, gamma0)

    etheta = exp_dirichlet_expectation(gamma)
    p = etheta @ exp_elog_beta.T + _EPS
    sstats = exp_elog_beta * ((c / p).T @ etheta)      # (V, K)
    # token-aligned π for the memo, recovered by gathering the dense solution
    eb = exp_elog_beta[token_ids.long()]
    p_tok = torch.einsum("bk,blk->bl", etheta, eb) + _EPS
    pi = etheta[:, None, :] * eb / p_tok[:, :, None]
    pi = torch.where(counts[:, :, None] > 0, pi, 0.0)
    return EStepResult(gamma=gamma, pi=pi, sstats=sstats, iters=iters)


# ---------------------------------------------------------------------------
# The backend contract
# ---------------------------------------------------------------------------

class EStepBackend:
    """One E-step contract for all engines.

    Subclasses implement ``solve``; ``solve_correction`` has a default in
    terms of ``solve`` (token-aligned subtract-old/add-new) that the CUDA
    backend overrides with its kernels.
    """

    name: str = "abstract"

    def solve(self, cfg: LDAConfig, exp_elog_beta: torch.Tensor,
              batch: BowBatch,
              gamma0: Optional[torch.Tensor] = None) -> EStepResult:
        raise NotImplementedError

    def solve_correction(
            self, cfg: LDAConfig, exp_elog_beta: torch.Tensor,
            batch: BowBatch, old_pi: torch.Tensor, visited: torch.Tensor,
            pi_dtype: str = "float32",
    ) -> Tuple[torch.Tensor, torch.Tensor, EStepResult]:
        """E-step + memo correction: the hot path of IVI / S-IVI.

        ``pi_dtype`` is the memo store's wire dtype: π is rounded to it
        BEFORE the add-new side of the correction, so what ⟨m_vk⟩ adds is
        bit-identical to what the store holds (and will later subtract).

        Returns (correction (V, K), first-visit word count, EStepResult);
        the result's π is the rounded value the caller must store.
        """
        ids, cnts = batch
        gamma0 = warm_start_gamma(cfg, cnts, old_pi, visited)
        res = self.solve(cfg, exp_elog_beta, batch, gamma0)
        pi = quantize_pi(res.pi, pi_dtype)
        snew = scatter_sstats(ids, cnts[:, :, None] * pi, cfg.vocab_size)
        res = res._replace(pi=pi, sstats=snew)
        sold = scatter_sstats(ids, cnts[:, :, None] * old_pi, cfg.vocab_size)
        correction = snew - sold
        words_first = torch.where(~visited, cnts.sum(-1), 0.0).sum()
        return correction, words_first, res


class GatherBackend(EStepBackend):
    name = "gather"

    def solve(self, cfg, exp_elog_beta, batch, gamma0=None):
        return estep_gather(cfg, exp_elog_beta, batch.token_ids,
                            batch.counts, gamma0)


class DenseBackend(EStepBackend):
    name = "dense"

    def solve(self, cfg, exp_elog_beta, batch, gamma0=None):
        return estep_dense(cfg, exp_elog_beta, batch.token_ids,
                           batch.counts, gamma0)


class CudaBackend(EStepBackend):
    """The hand-written kernels (`repro_torch.kernels.ops`): one fixed-point
    launch, then token π and the deterministic segment scatter — no
    (B, L, K) Eφ gather and no dense (B, V) counts. The fixed point's
    stopping tile is ``cfg.kernel_policy.block_b`` (default 128)."""

    name = "cuda"

    def solve(self, cfg, exp_elog_beta, batch, gamma0=None):
        from repro_torch.kernels import ops as kops
        return kops.estep_cuda(cfg, exp_elog_beta, batch.token_ids,
                               batch.counts, gamma0)

    def solve_correction(self, cfg, exp_elog_beta, batch, old_pi, visited,
                         pi_dtype="float32"):
        from repro_torch.kernels import ops as kops
        return kops.memo_correction_cuda(cfg, exp_elog_beta, batch.token_ids,
                                         batch.counts, old_pi, visited,
                                         pi_dtype=pi_dtype)


_BACKENDS: Dict[str, EStepBackend] = {
    b.name: b for b in (GatherBackend(), DenseBackend(), CudaBackend())
}


def get_backend(name: str) -> EStepBackend:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown estep backend: {name!r} (have {sorted(_BACKENDS)})"
        ) from None


def estep(cfg: LDAConfig, exp_elog_beta: torch.Tensor,
          token_ids: torch.Tensor, counts: torch.Tensor,
          gamma0: Optional[torch.Tensor] = None) -> EStepResult:
    """Functional shim: dispatch on ``cfg.estep_backend``."""
    return get_backend(cfg.estep_backend).solve(
        cfg, exp_elog_beta, BowBatch(token_ids, counts), gamma0)
