"""The E-step entry points over the CUDA kernels.

Padded (B, L) layout: ``estep_cuda`` is the counterpart of
``repro.kernels.ops.estep_pallas`` (serving, ``EStepBackend.solve``) and
``memo_correction_cuda`` of ``memo_correction_pallas`` (the IVI update,
``solve_correction``). Each runs two kernel launches: the fixed point
(K1), whose finish writes token π (K2's function), and the segment
scatter (K3). No count matrix is densified: the fixed point works on the
token layout directly.

Flat CSR layout: ``estep_cuda_csr`` and ``memo_correction_cuda_csr`` are
the counterparts of ``estep_pallas_csr`` and ``memo_correction_pallas_csr``
(``solve_tokens`` / ``solve_correction_tokens``): the CSR fixed point (K4),
whose finish writes flat π (K5's function), and K3; the tokens may come in
any order. ``repro``'s ``csr_effective_block_t`` has no counterpart: it
promotes the TPU kernel's token tile to the whole stream when it fits
VMEM, and K4 has no token tile (each warp walks its document's range of
the stream).

``cfg.estep_stream_dtype`` is ``repro``'s: "bfloat16" streams Eφ through
the fixed point rounded through bf16 (and, on the padded layout, the
counts), with fp32 arithmetic; π and the scatter use the fp32 Eφ and
counts.

The pre-fusion baseline: ``estep_cuda_sweeps`` is the counterpart of
``estep_pallas_sweeps``: one dense sweep kernel (K6) launch per sweep,
the stopping rule checked on the host between sweeps, a separate sstats
kernel (K7) and π recovered in torch. ``pad_inputs`` pads its inputs to
the grid.

Attention: ``flash_mha`` is the grouped-query wrapper around the flash
attention kernel (K9).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.estep import (CSRTokenBatch, EStepResult, densify,
                                    segment_sum_docs, warm_start_gamma,
                                    warm_start_gamma_flat)
from repro_torch.core.types import (DEFAULT_KERNEL_POLICY, KernelPolicy,
                                    LDAConfig)
from repro_torch.kernels import lda_estep
from repro_torch.kernels.flash_attention import (flash_attention,
                                               refuse_autograd)

#: Host syncs of ``estep_cuda_sweeps`` (one per stopping-rule check) since
#: the last reset; the baseline's own cost, counted.
HOST_SYNCS: Dict[str, int] = {"estep_cuda_sweeps": 0}


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
    """Refuse a stream type the fixed point does not know; γ₀ default."""
    lda_estep.check_stream_dtype(cfg.estep_stream_dtype)
    if gamma0 is None:
        return torch.full((num_docs, cfg.num_topics), cfg.alpha0 + 1.0,
                          dtype=torch.float32, device=device)
    return gamma0.contiguous()


def _run_fixed_point(cfg: LDAConfig, exp_elog_beta: torch.Tensor,
                     token_ids: torch.Tensor, counts: torch.Tensor,
                     gamma0: Optional[torch.Tensor], quantize: bool,
                     group: Optional[int] = None):
    """γ₀ default, then K1 with the policy's stopping tile (cut within
    groups of ``group`` rows) and its π finish. Returns (γ, the most sweeps
    of any tile, π)."""
    gamma0 = _fixed_point_start(cfg, token_ids.shape[0],
                                exp_elog_beta.device, gamma0)
    gamma, _, iters, pi = lda_estep.estep_fixed_point_pi(
        token_ids, counts, exp_elog_beta, gamma0, cfg.alpha0,
        cfg.estep_tol, cfg.estep_max_iters,
        block_b=resolve_policy(cfg).block_b,
        stream_dtype=cfg.estep_stream_dtype, quantize=quantize, group=group)
    return gamma, iters.max(), pi


def estep_cuda(cfg: LDAConfig, exp_elog_beta: torch.Tensor,
               token_ids: torch.Tensor, counts: torch.Tensor,
               gamma0: Optional[torch.Tensor] = None) -> EStepResult:
    """Batched E-step: the fixed point with its π finish, then the
    scatter."""
    gamma, iters, pi = _run_fixed_point(cfg, exp_elog_beta, token_ids,
                                        counts, gamma0, False)
    snew, _ = lda_estep.segment_scatter(
        token_ids.reshape(-1), counts.reshape(-1),
        pi.reshape(-1, pi.shape[-1]), None, exp_elog_beta.shape[0])
    return EStepResult(gamma=gamma, pi=pi, sstats=snew, iters=iters)


def estep_gamma_cuda(cfg: LDAConfig, exp_elog_beta: torch.Tensor,
                     token_ids: torch.Tensor, counts: torch.Tensor,
                     gamma0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """γ alone, for serving: K1 without its π finish and no scatter, one
    launch. ``estep_cuda(...).gamma``'s bits (the finish does not touch
    γ)."""
    gamma0 = _fixed_point_start(cfg, token_ids.shape[0],
                                exp_elog_beta.device, gamma0)
    return lda_estep.estep_fixed_point(
        token_ids, counts, exp_elog_beta, gamma0, cfg.alpha0, cfg.estep_tol,
        cfg.estep_max_iters, block_b=resolve_policy(cfg).block_b,
        stream_dtype=cfg.estep_stream_dtype)[0]


def memo_correction_cuda(cfg: LDAConfig, exp_elog_beta: torch.Tensor,
                         token_ids: torch.Tensor, counts: torch.Tensor,
                         old_pi: torch.Tensor, visited: torch.Tensor, *,
                         pi_dtype: str = "float32",
                         group: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, EStepResult]:
    """The IVI hot path: E-step plus the subtract-old/add-new correction.

    Returns (correction (V, K), first-visit word count, EStepResult), the
    ``EStepBackend.solve_correction`` contract; the correction is
    ``S_new − S_old`` from the scatter. With ``group`` the rows are
    B / group batches stacked (``solve_correction_grouped``): K1 stops
    each group's tiles on their own, and the one scatter sums every
    group's correction.
    """
    _check_pi_dtype(pi_dtype)
    gamma0 = warm_start_gamma(cfg, counts, old_pi, visited)
    gamma, iters, pi = _run_fixed_point(cfg, exp_elog_beta, token_ids,
                                        counts, gamma0,
                                        pi_dtype == "bfloat16", group)
    k = pi.shape[-1]
    snew, sold = lda_estep.segment_scatter(
        token_ids.reshape(-1), counts.reshape(-1), pi.reshape(-1, k),
        old_pi.reshape(-1, k), exp_elog_beta.shape[0])
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
                         gamma0: Optional[torch.Tensor], quantize: bool):
    """γ₀ default, then K4 (batch-wide stop) with its π finish. Returns
    (γ, sweeps, π)."""
    gamma0 = _fixed_point_start(cfg, num_docs, exp_elog_beta.device, gamma0)
    gamma, _, iters, pi = lda_estep.estep_fixed_point_csr_pi(
        token_ids, counts, segments, exp_elog_beta, gamma0, cfg.alpha0,
        cfg.estep_tol, cfg.estep_max_iters,
        stream_dtype=cfg.estep_stream_dtype, quantize=quantize)
    return gamma, iters[0], pi


def estep_cuda_csr(cfg: LDAConfig, exp_elog_beta: torch.Tensor,
                   token_ids: torch.Tensor, counts: torch.Tensor,
                   segments: torch.Tensor,
                   gamma0: Optional[torch.Tensor] = None, *,
                   num_docs: int) -> EStepResult:
    """Flat-token E-step (ragged serving): K4 with its π finish, then K3.
    The flat (T,) stream's padding slots carry count 0; π comes back flat
    (T, K)."""
    gamma, iters, pi = _run_fixed_point_csr(cfg, exp_elog_beta, token_ids,
                                            counts, segments, num_docs,
                                            gamma0, False)
    snew, _ = lda_estep.segment_scatter(token_ids, counts, pi, None,
                                        exp_elog_beta.shape[0])
    return EStepResult(gamma=gamma, pi=pi, sstats=snew, iters=iters)


def estep_gamma_cuda_csr(cfg: LDAConfig, exp_elog_beta: torch.Tensor,
                         token_ids: torch.Tensor, counts: torch.Tensor,
                         segments: torch.Tensor,
                         gamma0: Optional[torch.Tensor] = None, *,
                         num_docs: int) -> torch.Tensor:
    """γ alone on the flat layout, for serving: K4 without its π finish
    and no scatter, one launch."""
    gamma0 = _fixed_point_start(cfg, num_docs, exp_elog_beta.device, gamma0)
    return lda_estep.estep_fixed_point_csr(
        token_ids, counts, segments, exp_elog_beta, gamma0, cfg.alpha0,
        cfg.estep_tol, cfg.estep_max_iters,
        stream_dtype=cfg.estep_stream_dtype)[0]


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
    gamma, iters, pi = _run_fixed_point_csr(cfg, exp_elog_beta, token_ids,
                                            counts, segments, num_docs,
                                            gamma0, pi_dtype == "bfloat16")
    snew, sold = lda_estep.segment_scatter(token_ids, counts, pi, old_pi,
                                           exp_elog_beta.shape[0])
    correction = snew - sold
    doc_words = segment_sum_docs(counts, segments, num_docs)
    words_first = torch.where(~visited, doc_words, 0.0).sum()
    res = EStepResult(gamma=gamma, pi=pi, sstats=snew, iters=iters)
    return correction, words_first, res


# ---------------------------------------------------------------------------
# pre-fusion per-sweep E-step (benchmark baseline)
# ---------------------------------------------------------------------------

def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pad_inputs(c: torch.Tensor, eb: torch.Tensor, block_b: int, block_v: int,
               block_k: int = 128):
    """Pad C (B, V) and Eφ (V, K) to the kernel grid.

    Padded documents have zero counts (they contribute nothing). Padded
    vocabulary rows of Eφ are 1.0, not 0: a zero row makes the phinorm P
    exactly 0 on that tile (the fp32 epsilon underflows) and C/P would be
    0/0; their C is 0, so they contribute nothing either way. Padded topics
    get Eφ = 0, so they never win responsibilities. Returns (C, Eφ, (B, V,
    K) before padding).
    """
    b, v = c.shape
    k = eb.shape[1]
    bp, vp, kp = (_round_up(b, block_b), _round_up(v, block_v),
                  _round_up(k, block_k))
    c = F.pad(c, (0, vp - v, 0, bp - b))
    eb = F.pad(eb, (0, 0, 0, vp - v), value=1.0)
    eb = F.pad(eb, (0, kp - k))
    return c, eb, (b, v, k)


def padded_exp_elog_theta(g: torch.Tensor, k: int) -> torch.Tensor:
    """exp(E[ln θ]) over the first k (real) topics; padded topics carry
    exactly α₀ and a zero Eφ column, and get Eθ = 0."""
    real = torch.arange(g.shape[1], device=g.device) < k
    s = torch.where(real, g, 0.0).sum(-1, keepdim=True)
    et = torch.exp(torch.special.digamma(g.clamp_min(1e-10))
                   - torch.special.digamma(s))
    return torch.where(real, et, 0.0)


def estep_sweeps(cfg: LDAConfig, exp_elog_beta: torch.Tensor,
                 token_ids: torch.Tensor, counts: torch.Tensor,
                 gamma0: Optional[torch.Tensor], *, block_b: int,
                 block_v: int, sweep: Callable,
                 sstats: Callable) -> EStepResult:
    """The pre-fusion E-step over given ``sweep(c, Eθ, Eφ, α₀)`` and
    ``sstats(c, Eθ, Eφ)``: the kernels (``estep_cuda_sweeps``), or their
    plain twins, which run the same loop on the card as its reference."""
    bsz = token_ids.shape[0]
    v = exp_elog_beta.shape[0]
    c = densify(token_ids, counts, v)
    cpad, ebpad, (b, _, k) = pad_inputs(c, exp_elog_beta, block_b, block_v)
    if gamma0 is None:
        gamma0 = torch.full((bsz, cfg.num_topics), cfg.alpha0 + 1.0,
                            dtype=torch.float32, device=counts.device)
    g = F.pad(gamma0, (0, ebpad.shape[1] - k, 0, cpad.shape[0] - b),
              value=cfg.alpha0)
    real = torch.arange(g.shape[1], device=g.device) < k

    # repro's lax.while_loop(delta > tol and it < max_iters), with delta
    # read on the host: one sync after every sweep but one at the cap
    it = 0
    while it < cfg.estep_max_iters:
        et = padded_exp_elog_theta(g, k)
        g_new = sweep(cpad, et, ebpad, cfg.alpha0)
        g_new = torch.where(real, g_new, cfg.alpha0)
        # the mean over the whole padded (Bp, Kp) array, as repro's loop
        delta = (g_new - g).abs().mean()
        g, it = g_new, it + 1
        if it < cfg.estep_max_iters:
            HOST_SYNCS["estep_cuda_sweeps"] += 1
            if not bool(delta > cfg.estep_tol):   # compared in fp32
                break

    et = padded_exp_elog_theta(g, k)
    spad = sstats(cpad, et, ebpad)
    gamma = g[:bsz, :k]
    sstats_out = spad[:v, :k]

    # token-aligned π for the IVI memo
    pi = lda_estep._pi_of_tokens(exp_elog_beta[token_ids.long()], counts,
                                 et[:bsz, :k], False)
    return EStepResult(gamma=gamma, pi=pi, sstats=sstats_out,
                       iters=torch.tensor(it, dtype=torch.int32,
                                          device=g.device))


def estep_cuda_sweeps(cfg: LDAConfig, exp_elog_beta: torch.Tensor,
                      token_ids: torch.Tensor, counts: torch.Tensor,
                      gamma0: Optional[torch.Tensor] = None, *,
                      block_b: int = 128,
                      block_v: int = 512) -> EStepResult:
    """Pre-fusion E-step, the counterpart of ``estep_pallas_sweeps``: one
    K6 launch per sweep with Eθ recomputed in torch between sweeps, the
    stopping rule (mean |Δγ| over the padded (Bp, Kp) array ≤ tol, or
    ``estep_max_iters`` sweeps) read on the host after each, one K7 launch
    after the loop, token π recovered in torch. Kept as the baseline the
    fused kernels are measured against."""
    blocks = dict(block_b=block_b, block_v=block_v)
    return estep_sweeps(cfg, exp_elog_beta, token_ids, counts, gamma0,
                        **blocks, sweep=partial(lda_estep.estep_sweep,
                                                **blocks),
                        sstats=partial(lda_estep.sstats, **blocks))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, scale: Optional[float] = None,
              window: Optional[int] = None,
              softcap: Optional[float] = None) -> torch.Tensor:
    """GQA-aware wrapper: q (B, S, H, hd), k/v (B, S, KV, hd) → (B, S, H,
    hd).

    Flattens (B, H) and pads S to the 128-block grid (S itself below 128)
    before invoking the flash kernel. Query head h reads key/value head
    h // (H / KV) in place (no repeated copy), and the kernel masks the
    padded keys, so the result is ``mha_ref`` on the unpadded inputs,
    causal or not. ``window`` and ``softcap`` go to the kernel as they are
    (``flash_attention``: a causal sliding window, a logit softcap). K9 has
    no backward: with autograd recording through q, k or v it raises
    (``flash_attention.refuse_autograd``).
    """
    refuse_autograd("flash_mha", q, k, v)
    b, s, h, hd = q.shape
    kv = k.shape[2]
    if h % kv:
        raise ValueError(f"flash_mha: {h} query heads do not divide into "
                         f"{kv} key/value heads")

    def flat(x):
        return x.permute(0, 2, 1, 3).reshape(b * x.shape[2], s, hd)

    blk = 128 if s >= 128 else s
    s_pad = _round_up(s, blk)
    qf, kf, vf = flat(q), flat(k), flat(v)
    if s_pad != s:
        qf, kf, vf = (F.pad(x, (0, 0, 0, s_pad - s)) for x in (qf, kf, vf))
    out = flash_attention(qf.contiguous(), kf.contiguous(), vf.contiguous(),
                          causal=causal, scale=scale, block_q=blk,
                          block_k=blk, kv_len=s, window=window,
                          softcap=softcap)
    return out[:, :s].reshape(b, h, s, hd).permute(0, 2, 1, 3)
