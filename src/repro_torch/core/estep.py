"""Batched variational E-step for LDA, behind one backend contract.

Every engine consumes the E-step through ``EStepBackend``:

* ``solve(cfg, exp_elog_beta, batch, gamma0) -> EStepResult`` — run the
  per-document fixed point (Alg. 1 lines 4–7) on a padded BOW mini-batch.
* ``solve_correction(cfg, exp_elog_beta, batch, old_pi, visited)`` — the
  IVI hot path: E-step **plus** the subtract-old/add-new memo correction
  Σ_d cnt·(π_new − π_old) scattered into (V, K), with γ warm-started from
  the memo for visited documents.
* ``solve_correction_grouped(..., group)`` — the same on B / group batches
  stacked (D-IVI's live workers of one sub-round), each solved as if
  alone, their corrections summed: one group at a time by default, all of
  them in one fixed-point launch and one scatter on ``cuda``.

Four backends:

* ``gather`` — token-aligned: gathers rows of exp(E[ln φ]) at the batch's
  token ids, shape (B, L, K); the reference the others are held to.
* ``dense`` — densifies the mini-batch into a count matrix C (B, V) so one
  sweep is two matrix products (the TPU formulation, kept as an oracle).
* ``cuda`` — the hand-written kernels (`repro_torch.kernels.ops`): the
  whole fixed point in one launch, then token π and a deterministic
  segment scatter.
* ``csr`` — the flat-token CUDA kernels behind the padded contract (a
  (B, L) batch flattens losslessly to a token stream), so the equivalence
  tests can pin them against ``gather``.

Every backend also implements the **flat-token contract**
(``solve_tokens`` / ``solve_correction_tokens`` over a ``CSRTokenBatch``: a
concatenated (T,) token stream with per-token segment ids): the plain
``estep_csr_ref`` by default, the CSR kernels on ``cuda`` and ``csr``. The
CSR stream engine and ragged serving run on it.

All backends return γ and the token-aligned π that IVI stores: (B, L, K)
on the padded contract, (T, K) on the flat one.
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


class CSRTokenBatch(NamedTuple):
    """A flat CSR mini-batch: every document's tokens concatenated (all
    (T,)). ``segments[t]`` is the local document row owning token ``t``;
    padding slots carry segment 0 and count 0 (inert in every reduction)."""

    token_ids: torch.Tensor  # int32
    counts: torch.Tensor     # float32
    segments: torch.Tensor   # int32 in [0, B)


class EStepResult(NamedTuple):
    gamma: torch.Tensor   # (B, K)
    pi: torch.Tensor      # (B, L, K) token-aligned responsibilities
                          # (flat-token paths: (T, K))
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


# ---------------------------------------------------------------------------
# flat-token (CSR) formulation
# ---------------------------------------------------------------------------

def segment_sum_docs(values: torch.Tensor, segments: torch.Tensor,
                     num_docs: int) -> torch.Tensor:
    """Σ over each document's tokens: (T, ...) → (num_docs, ...), summed in
    the same order on every call. On CUDA ``index_add_`` adds in whatever
    order its float atomics land, which would make the CSR update's warm
    start γ₀, and with it a resumed run, differ from run to run: there the
    tokens are sorted by document (stably, no host sync) and each
    document's run is summed in order by ``segment_reduce``. The CPU's
    ``index_add_`` already adds in token order. Tokens whose segment lies
    outside [0, num_docs) add nothing on CUDA."""
    if values.device.type != "cuda":
        out = torch.zeros((num_docs,) + tuple(values.shape[1:]),
                          dtype=values.dtype, device=values.device)
        return out.index_add_(0, segments.long(), values)
    segs, order = torch.sort(segments.long(), stable=True)
    bounds = torch.searchsorted(
        segs, torch.arange(num_docs + 1, dtype=segs.dtype,
                           device=segs.device))
    return torch.segment_reduce(values[order], "sum", offsets=bounds,
                                axis=0, unsafe=True)


def scatter_sstats_flat(token_ids: torch.Tensor, weighted_pi: torch.Tensor,
                        vocab_size: int) -> torch.Tensor:
    """Scatter (T, K) flat weighted responsibilities into (V, K)."""
    return scatter_sstats(token_ids, weighted_pi, vocab_size)


def warm_start_gamma_flat(cfg: LDAConfig, tok: CSRTokenBatch,
                          old_pi: torch.Tensor,
                          visited: torch.Tensor) -> torch.Tensor:
    """``warm_start_gamma`` on the flat layout: the memo term is a segment
    sum of cnt·π_old over each document's tokens."""
    gamma_memo = cfg.alpha0 + segment_sum_docs(
        tok.counts[:, None] * old_pi, tok.segments, visited.shape[0])
    fresh = torch.full_like(gamma_memo, cfg.alpha0 + 1.0)
    return torch.where(visited[:, None], gamma_memo, fresh)


def estep_csr_ref(cfg: LDAConfig, exp_elog_beta: torch.Tensor,
                  token_ids: torch.Tensor, counts: torch.Tensor,
                  segments: torch.Tensor, num_docs: int,
                  gamma0: Optional[torch.Tensor] = None) -> EStepResult:
    """The plain flat-token E-step, the reference of the CSR kernels.

    ``estep_gather``'s fixed point with the (B, L) einsums replaced by
    per-token gathers and segment sums over the flat stream; zero-count
    padding tokens are exact no-ops. π comes back flat (T, K).
    """
    eb_tok = exp_elog_beta[token_ids.long()]            # (T, K)
    segs = segments.long()
    if gamma0 is None:
        gamma0 = _fresh_gamma(cfg, num_docs, eb_tok.device)

    def update(gamma):
        etheta = exp_dirichlet_expectation(gamma)       # (B, K)
        p = (etheta[segs] * eb_tok).sum(-1) + _EPS      # (T,)
        acc = segment_sum_docs((counts / p)[:, None] * eb_tok, segs,
                               num_docs)
        return cfg.alpha0 + etheta * acc

    gamma, iters = _fixed_point(cfg, update, gamma0)

    etheta = exp_dirichlet_expectation(gamma)
    et_tok = etheta[segs]                               # (T, K)
    p = (et_tok * eb_tok).sum(-1) + _EPS
    pi = torch.where(counts[:, None] > 0, et_tok * eb_tok / p[:, None], 0.0)
    sstats = scatter_sstats_flat(token_ids, counts[:, None] * pi,
                                 exp_elog_beta.shape[0])
    return EStepResult(gamma=gamma, pi=pi, sstats=sstats, iters=iters)


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

    def solve_correction_grouped(
            self, cfg: LDAConfig, exp_elog_beta: torch.Tensor,
            batch: BowBatch, old_pi: torch.Tensor, visited: torch.Tensor,
            group: int, pi_dtype: str = "float32",
    ) -> Tuple[torch.Tensor, torch.Tensor, EStepResult]:
        """``solve_correction`` on B / ``group`` batches of ``group`` rows
        stacked row-wise, each solved as if it were alone (its own stop):
        the corrections and first-visit words summed over the groups, γ and
        π for every row, the sweeps the most of any group. Here one group
        at a time, in order; the sum runs group by group."""
        b = batch.token_ids.shape[0]
        if group < 1 or b % group:
            raise ValueError(f"group={group} does not divide B={b}")
        if b == group:
            return self.solve_correction(cfg, exp_elog_beta, batch, old_pi,
                                         visited, pi_dtype)
        corr = words = sstats = None
        parts = []
        for lo in range(0, b, group):
            rows = slice(lo, lo + group)
            c, w, res = self.solve_correction(
                cfg, exp_elog_beta,
                BowBatch(batch.token_ids[rows], batch.counts[rows]),
                old_pi[rows], visited[rows], pi_dtype)
            if corr is None:
                corr, words, sstats = c, w, res.sstats
            else:
                corr, words = corr + c, words + w
                sstats = sstats + res.sstats
            parts.append(res)
        res = EStepResult(
            gamma=torch.cat([r.gamma for r in parts]),
            pi=torch.cat([r.pi for r in parts]), sstats=sstats,
            iters=torch.stack([r.iters for r in parts]).max())
        return corr, words, res

    def solve_gamma(self, cfg: LDAConfig, exp_elog_beta: torch.Tensor,
                    batch: BowBatch,
                    gamma0: Optional[torch.Tensor] = None) -> torch.Tensor:
        """γ alone, what serving needs: ``solve(...).gamma``. The CUDA
        backend runs its fixed point without the π finish and the scatter
        that serving would throw away."""
        return self.solve(cfg, exp_elog_beta, batch, gamma0).gamma

    # -- flat-token (CSR) contract --------------------------------------
    def solve_tokens(self, cfg: LDAConfig, exp_elog_beta: torch.Tensor,
                     tok: CSRTokenBatch, num_docs: int,
                     gamma0: Optional[torch.Tensor] = None) -> EStepResult:
        """``solve`` on a flat CSR token stream; π comes back (T, K).
        Default: the plain ``estep_csr_ref``."""
        return estep_csr_ref(cfg, exp_elog_beta, tok.token_ids, tok.counts,
                             tok.segments, num_docs, gamma0)

    def solve_tokens_gamma(self, cfg: LDAConfig,
                           exp_elog_beta: torch.Tensor, tok: CSRTokenBatch,
                           num_docs: int,
                           gamma0: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
        """``solve_gamma`` on the flat layout."""
        return self.solve_tokens(cfg, exp_elog_beta, tok, num_docs,
                                 gamma0).gamma

    def solve_correction_tokens(
            self, cfg: LDAConfig, exp_elog_beta: torch.Tensor,
            tok: CSRTokenBatch, old_pi: torch.Tensor, visited: torch.Tensor,
            pi_dtype: str = "float32",
    ) -> Tuple[torch.Tensor, torch.Tensor, EStepResult]:
        """``solve_correction`` on the flat layout (old_pi is (T, K)), with
        the same quantize-then-rescatter discipline. The document axis is
        ``visited``'s: rows that own no token still count in the fixed
        point's batch-wide mean."""
        num_docs = visited.shape[0]
        gamma0 = warm_start_gamma_flat(cfg, tok, old_pi, visited)
        res = self.solve_tokens(cfg, exp_elog_beta, tok, num_docs, gamma0)
        pi = quantize_pi(res.pi, pi_dtype)
        snew = scatter_sstats_flat(tok.token_ids, tok.counts[:, None] * pi,
                                   cfg.vocab_size)
        res = res._replace(pi=pi, sstats=snew)
        sold = scatter_sstats_flat(tok.token_ids,
                                   tok.counts[:, None] * old_pi,
                                   cfg.vocab_size)
        correction = snew - sold
        doc_words = segment_sum_docs(tok.counts, tok.segments, num_docs)
        words_first = torch.where(~visited, doc_words, 0.0).sum()
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
    launch that ends by writing token π, then the deterministic segment
    scatter — no (B, L, K) Eφ gather and no dense (B, V) counts. On the padded contract
    the fixed point (K1) stops per tile of ``cfg.kernel_policy.block_b``
    documents (default 128); on the flat contract (K4) it stops batch-wide,
    as ``gather`` does."""

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

    def solve_correction_grouped(self, cfg, exp_elog_beta, batch, old_pi,
                                 visited, group, pi_dtype="float32"):
        """Every group in one K1 launch (its tiles cut within each group,
        so each group stops as if alone) and one K3 over all their tokens:
        the summed correction in one scatter."""
        from repro_torch.kernels import ops as kops
        return kops.memo_correction_cuda(cfg, exp_elog_beta, batch.token_ids,
                                         batch.counts, old_pi, visited,
                                         pi_dtype=pi_dtype, group=group)

    def solve_gamma(self, cfg, exp_elog_beta, batch, gamma0=None):
        from repro_torch.kernels import ops as kops
        return kops.estep_gamma_cuda(cfg, exp_elog_beta, batch.token_ids,
                                     batch.counts, gamma0)

    def solve_tokens(self, cfg, exp_elog_beta, tok, num_docs, gamma0=None):
        from repro_torch.kernels import ops as kops
        return kops.estep_cuda_csr(cfg, exp_elog_beta, tok.token_ids,
                                   tok.counts, tok.segments, gamma0,
                                   num_docs=num_docs)

    def solve_tokens_gamma(self, cfg, exp_elog_beta, tok, num_docs,
                           gamma0=None):
        from repro_torch.kernels import ops as kops
        return kops.estep_gamma_cuda_csr(cfg, exp_elog_beta, tok.token_ids,
                                         tok.counts, tok.segments, gamma0,
                                         num_docs=num_docs)

    def solve_correction_tokens(self, cfg, exp_elog_beta, tok, old_pi,
                                visited, pi_dtype="float32"):
        from repro_torch.kernels import ops as kops
        return kops.memo_correction_cuda_csr(
            cfg, exp_elog_beta, tok.token_ids, tok.counts, tok.segments,
            old_pi, visited, pi_dtype=pi_dtype)


class CSRBackend(CudaBackend):
    """The flat-token CUDA kernels behind the PADDED ``solve`` /
    ``solve_correction`` contract: a (B, L) batch flattens losslessly to a
    (B·L,) stream whose segment ids are the row indices, so the backend
    equivalence tests pin the CSR kernels against ``gather``. Its fixed
    point stops batch-wide, as ``gather`` does. Flat-token callers use the
    inherited ``solve_tokens`` / ``solve_correction_tokens`` directly."""

    name = "csr"
    # K4 stops batch-wide: stacked groups run one at a time
    solve_correction_grouped = EStepBackend.solve_correction_grouped

    @staticmethod
    def flatten(batch: BowBatch) -> CSRTokenBatch:
        b, l = batch.token_ids.shape
        segs = torch.arange(b, dtype=torch.int32,
                            device=batch.token_ids.device)
        return CSRTokenBatch(batch.token_ids.reshape(-1),
                             batch.counts.reshape(-1),
                             segs.repeat_interleave(l))

    def solve(self, cfg, exp_elog_beta, batch, gamma0=None):
        b, l = batch.token_ids.shape
        res = self.solve_tokens(cfg, exp_elog_beta, self.flatten(batch),
                                num_docs=b, gamma0=gamma0)
        return res._replace(pi=res.pi.reshape(b, l, -1))

    def solve_gamma(self, cfg, exp_elog_beta, batch, gamma0=None):
        return self.solve_tokens_gamma(cfg, exp_elog_beta,
                                       self.flatten(batch),
                                       num_docs=batch.token_ids.shape[0],
                                       gamma0=gamma0)

    def solve_correction(self, cfg, exp_elog_beta, batch, old_pi, visited,
                         pi_dtype="float32"):
        b, l = batch.token_ids.shape
        corr, words_first, res = self.solve_correction_tokens(
            cfg, exp_elog_beta, self.flatten(batch),
            old_pi.reshape(b * l, -1), visited, pi_dtype=pi_dtype)
        return corr, words_first, res._replace(pi=res.pi.reshape(b, l, -1))


_BACKENDS: Dict[str, EStepBackend] = {
    b.name: b for b in (GatherBackend(), DenseBackend(), CudaBackend(),
                        CSRBackend())
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
