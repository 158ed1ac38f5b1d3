"""The E-step entry points over the CUDA kernels.

Padded (B, L) layout: ``estep_cuda`` is the counterpart of
``repro.kernels.ops.estep_pallas`` (serving, ``EStepBackend.solve``) and
``memo_correction_cuda`` of ``memo_correction_pallas`` (the IVI update,
``solve_correction``). Each runs three kernel launches: the fixed point
(K1), token π (K2) and the segment scatter (K3). No count matrix is
densified: the fixed point works on the token layout directly.

Flat CSR layout: ``estep_cuda_csr`` and ``memo_correction_cuda_csr`` are
the counterparts of ``estep_pallas_csr`` and ``memo_correction_pallas_csr``
(``solve_tokens`` / ``solve_correction_tokens``): the CSR fixed point (K4),
flat π (K5) and K3. ``repro``'s ``csr_effective_block_t`` has no
counterpart: it promotes the TPU kernel's token tile to the whole stream
when it fits VMEM, and K4 has no token tile (each warp walks its
document's range of the stream).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.estep import (CSRTokenBatch, EStepResult,
                                    segment_sum_docs, warm_start_gamma,
                                    warm_start_gamma_flat)
from repro_torch.core.types import (DEFAULT_KERNEL_POLICY, KernelPolicy,
                                    LDAConfig)
from repro_torch.kernels import lda_estep


def resolve_policy(cfg: LDAConfig) -> KernelPolicy:
    """``cfg.kernel_policy``, else the built-in defaults."""
    return cfg.kernel_policy or DEFAULT_KERNEL_POLICY


def _check_pi_dtype(pi_dtype: str) -> None:
    if pi_dtype not in ("float32", "bfloat16"):
        # the in-kernel quantize only implements the bf16 wire; refuse
        # rather than silently skip the round-trip and drift ⟨m_vk⟩
        raise ValueError(f"cuda memo correction supports pi_dtype "
                         f"float32|bfloat16, got {pi_dtype!r}")


def _fixed_point_start(cfg: LDAConfig, num_docs: int, device,
                       gamma0: Optional[torch.Tensor]) -> torch.Tensor:
    """Refuse what the fixed-point kernels do not stream; γ₀ default."""
    if cfg.estep_stream_dtype != "float32":
        raise ValueError(
            f"estep_stream_dtype={cfg.estep_stream_dtype!r}: the CUDA fixed "
            "point streams float32 only (bf16 streaming: ROADMAP.md)")
    if gamma0 is None:
        return torch.full((num_docs, cfg.num_topics), cfg.alpha0 + 1.0,
                          dtype=torch.float32, device=device)
    return gamma0.contiguous()


def _run_fixed_point(cfg: LDAConfig, exp_elog_beta: torch.Tensor,
                     token_ids: torch.Tensor, counts: torch.Tensor,
                     gamma0: Optional[torch.Tensor]):
    """γ₀ default, then K1 with the policy's stopping tile. Returns
    (γ, Eθ, the most sweeps of any tile)."""
    gamma0 = _fixed_point_start(cfg, token_ids.shape[0],
                                exp_elog_beta.device, gamma0)
    gamma, et, iters = lda_estep.estep_fixed_point(
        token_ids, counts, exp_elog_beta, gamma0, cfg.alpha0,
        cfg.estep_tol, cfg.estep_max_iters,
        block_b=resolve_policy(cfg).block_b)
    return gamma, et, iters.max()


def estep_cuda(cfg: LDAConfig, exp_elog_beta: torch.Tensor,
               token_ids: torch.Tensor, counts: torch.Tensor,
               gamma0: Optional[torch.Tensor] = None) -> EStepResult:
    """Batched E-step: fixed point, then token π and its scatter."""
    gamma, et, iters = _run_fixed_point(cfg, exp_elog_beta, token_ids,
                                        counts, gamma0)
    pi, snew = lda_estep.memo_delta(token_ids, counts, exp_elog_beta, et,
                                    exp_elog_beta.shape[0])
    return EStepResult(gamma=gamma, pi=pi, sstats=snew, iters=iters)


def memo_correction_cuda(cfg: LDAConfig, exp_elog_beta: torch.Tensor,
                         token_ids: torch.Tensor, counts: torch.Tensor,
                         old_pi: torch.Tensor, visited: torch.Tensor, *,
                         pi_dtype: str = "float32"
                         ) -> Tuple[torch.Tensor, torch.Tensor, EStepResult]:
    """The IVI hot path: E-step plus the subtract-old/add-new correction.

    Returns (correction (V, K), first-visit word count, EStepResult), the
    ``EStepBackend.solve_correction`` contract; the correction is
    ``S_new − S_old`` from the scatter.
    """
    _check_pi_dtype(pi_dtype)
    gamma0 = warm_start_gamma(cfg, counts, old_pi, visited)
    gamma, et, iters = _run_fixed_point(cfg, exp_elog_beta, token_ids,
                                        counts, gamma0)
    pi, snew, sold = lda_estep.memo_delta(
        token_ids, counts, exp_elog_beta, et, exp_elog_beta.shape[0],
        old_pi=old_pi, quantize=(pi_dtype == "bfloat16"))
    correction = snew - sold
    words_first = torch.where(~visited, counts.sum(-1), 0.0).sum()
    res = EStepResult(gamma=gamma, pi=pi, sstats=snew, iters=iters)
    return correction, words_first, res


# ---------------------------------------------------------------------------
# flat CSR layout
# ---------------------------------------------------------------------------

def _run_fixed_point_csr(cfg: LDAConfig, exp_elog_beta: torch.Tensor,
                         token_ids: torch.Tensor, counts: torch.Tensor,
                         segments: torch.Tensor, num_docs: int,
                         gamma0: Optional[torch.Tensor]):
    """γ₀ default, then K4 (batch-wide stop). Returns (γ, Eθ, sweeps)."""
    gamma0 = _fixed_point_start(cfg, num_docs, exp_elog_beta.device, gamma0)
    gamma, et, iters = lda_estep.estep_fixed_point_csr(
        token_ids, counts, segments, exp_elog_beta, gamma0, cfg.alpha0,
        cfg.estep_tol, cfg.estep_max_iters)
    return gamma, et, iters[0]


def estep_cuda_csr(cfg: LDAConfig, exp_elog_beta: torch.Tensor,
                   token_ids: torch.Tensor, counts: torch.Tensor,
                   segments: torch.Tensor,
                   gamma0: Optional[torch.Tensor] = None, *,
                   num_docs: int) -> EStepResult:
    """Flat-token E-step (ragged serving): K4, then K5 and K3. The flat
    (T,) stream's padding slots carry segment 0 and count 0; π comes back
    flat (T, K)."""
    gamma, et, iters = _run_fixed_point_csr(cfg, exp_elog_beta, token_ids,
                                            counts, segments, num_docs,
                                            gamma0)
    pi, snew = lda_estep.memo_delta_csr(token_ids, counts, segments,
                                        exp_elog_beta, et,
                                        exp_elog_beta.shape[0])
    return EStepResult(gamma=gamma, pi=pi, sstats=snew, iters=iters)


def memo_correction_cuda_csr(cfg: LDAConfig, exp_elog_beta: torch.Tensor,
                             token_ids: torch.Tensor, counts: torch.Tensor,
                             segments: torch.Tensor, old_pi: torch.Tensor,
                             visited: torch.Tensor, *,
                             pi_dtype: str = "float32"
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        EStepResult]:
    """The CSR IVI hot path: flat E-step plus subtract-old/add-new, with
    old_pi (T, K) in the same flat layout. The document axis is
    ``visited``'s, so rows that own no token count in the fixed point's
    batch-wide mean, as in ``repro``."""
    _check_pi_dtype(pi_dtype)
    num_docs = visited.shape[0]
    tok = CSRTokenBatch(token_ids, counts, segments)
    gamma0 = warm_start_gamma_flat(cfg, tok, old_pi, visited)
    gamma, et, iters = _run_fixed_point_csr(cfg, exp_elog_beta, token_ids,
                                            counts, segments, num_docs,
                                            gamma0)
    pi, snew, sold = lda_estep.memo_delta_csr(
        token_ids, counts, segments, exp_elog_beta, et,
        exp_elog_beta.shape[0], old_pi=old_pi,
        quantize=(pi_dtype == "bfloat16"))
    correction = snew - sold
    doc_words = segment_sum_docs(counts, segments, num_docs)
    words_first = torch.where(~visited, doc_words, 0.0).sum()
    res = EStepResult(gamma=gamma, pi=pi, sstats=snew, iters=iters)
    return correction, words_first, res
