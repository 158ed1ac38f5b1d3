"""The plain reference of one IVI update (eq. 4) with the π memo in bf16.

The configuration states the memo in bfloat16: the old π of a visited
document is read as stored (bf16 values, exact in float32), the new π is
rounded to bf16 (to nearest, ties to even) before the add side of the
correction, and that rounded π is what the memo holds afterwards. So λ =
β₀ + ⟨m_vk⟩ stays exact with respect to the stored memo. Everything else
is ``perfbench/reference/lda.py``'s update, in float32 with TF32 off; like
it, this file imports nothing of the program and reads the program's
outputs only to judge them.

**Judging a stored π.** Two rounded values are never compared: a float32
difference of 1e-7 across a rounding edge puts them a whole bf16 ulp apart
(up to 3.9e-3), the size of the gap a lower-precision path leaves. The
program's stored bf16 π is held instead to the reference's unrounded
float32 π, in units of the bf16 ulp at the reference's value:
``ulp_excess`` is |stored − π_ref| / ulp(π_ref) − ½, at least 0. A stored
value that is π_ref correctly rounded reads 0; a program whose float32 π
lies δ from the reference's reads at most |δ| / ulp.

**Rounding at an edge.** Where the reference's float32 π lies within
``ROUND_TIE`` ulp of the midpoint between its two bf16 neighbours, another
summation order can round it the other way. Such an element offers both
neighbours, and takes the one the program stored when that is one of them
(as ``lda.py``'s ``TIE`` lets a tile stop at the program's sweep): each
neighbour lies within ½ + ``ROUND_TIE`` ulp of the reference's value, so no
error larger than that can hide there. Elsewhere the rounding is the
reference's own.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from perfbench.reference.lda import (EStepCfg, IVIState, UpdateOut,
                                     exp_elog, fixed_point, scatter,
                                     strict_fp32, token_pi)

__all__ = ["ROUND_TIE", "EStepCfg", "IVIState", "UpdateOutBf16",
           "bf16_neighbours", "ivi_update", "round_bf16", "strict_fp32",
           "ulp_excess"]

#: Half-width, in bf16 ulps, of the band about a rounding midpoint inside
#: which the reference offers both neighbours (see the module docstring).
ROUND_TIE = 1e-2

_LOW = 0xFFFF          # the 16 bits a bf16 drops from a float32
_STEP = 0x10000        # one bf16 ulp in float32's bit pattern


def bf16_neighbours(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """For float32 ``x`` ≥ 0: the bf16 values just below (or at) and just
    above ``x``, as float32, and where ``x`` lies between them (0 at the
    lower, ½ at the midpoint), from ``x``'s bits."""
    bits = x.contiguous().view(torch.int32)
    lo_bits = bits & ~_LOW
    lo = lo_bits.view(torch.float32)
    hi = (lo_bits + _STEP).view(torch.float32)
    frac = (bits & _LOW).to(torch.float32) / _STEP
    return lo, hi, frac


def round_bf16(pi: torch.Tensor,
               stored: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``pi`` (float32, ≥ 0) rounded to bf16, to nearest with ties to even,
    as float32; with ``stored`` (the program's stored π), an element within
    ``ROUND_TIE`` ulp of a midpoint takes ``stored`` where that is one of
    its two neighbours."""
    out = pi.to(torch.bfloat16).to(torch.float32)
    if stored is None:
        return out
    lo, hi, frac = bf16_neighbours(pi)
    stored = stored.to(torch.float32)
    edge = ((frac - 0.5).abs() <= ROUND_TIE) & ((stored == lo)
                                                | (stored == hi))
    return torch.where(edge, stored, out)


def ulp_excess(stored: torch.Tensor, pi_ref: torch.Tensor) -> torch.Tensor:
    """|stored − π_ref| / ulp(π_ref) − ½, at least 0, elementwise: how far
    a stored bf16 π lies outside the rounding of the reference's float32
    π, in bf16 ulps at π_ref."""
    lo, hi, _ = bf16_neighbours(pi_ref)
    gap = (stored.to(torch.float32) - pi_ref).abs().double()
    return (gap / (hi - lo).double() - 0.5).clamp(min=0.0)


@dataclass
class UpdateOutBf16(UpdateOut):
    """``UpdateOut`` with ``pi`` the unrounded float32 π, and ``pi_stored``
    the π the memo holds after the update (``pi`` rounded to bf16)."""

    pi_stored: torch.Tensor


def ivi_update(st: IVIState, ids: torch.Tensor, cnts: torch.Tensor,
               old_pi: torch.Tensor, visited: torch.Tensor,
               words_total: float, beta0: float, c: EStepCfg,
               pi_prog: Optional[torch.Tensor] = None) -> UpdateOutBf16:
    """One IVI update on a padded batch with the memo in bf16: the E-step
    warm-started from the stored π_old (bf16 values) for visited
    documents, π, the correction Σ cnt·(bf16(π_new) − π_old), the first
    visits' share of the initial mass retired, and λ = β₀ + ⟨m_vk⟩ +
    frac·mass. ``pi_prog``, the program's stored π (when given), chooses a
    tied tile's stop (the candidate whose π lies nearest it) and an edge
    element's rounding (``round_bf16``), and nothing else."""
    v = st.lam.shape[0]
    old_pi = old_pi.to(torch.float32)
    eb = exp_elog(st.lam, 0)
    warm = c.alpha0 + (old_pi * cnts[:, :, None]).sum(1)
    gamma0 = torch.where(visited[:, None], warm,
                         torch.full_like(warm, c.alpha0 + 1.0))
    pick = None
    if pi_prog is not None:
        prog = pi_prog.to(torch.float32)

        def pick(lo, hi, cands):
            live = (cnts[lo:hi] > 0)[:, :, None]
            gaps = [float(torch.where(
                live, (token_pi(ids[lo:hi], cnts[lo:hi], eb, g)
                       - prog[lo:hi]).abs(), 0.0).max()) for g in cands]
            return gaps.index(min(gaps))
    gamma, sweeps = fixed_point(ids, cnts, eb, gamma0, c, pick)
    pi = token_pi(ids, cnts, eb, gamma)
    pi_stored = round_bf16(pi, pi_prog)
    corr = scatter(ids, cnts, pi_stored, v) - scatter(ids, cnts, old_pi, v)
    first = float(cnts[~visited].double().sum())
    frac = max(st.init_frac - first / words_total, 0.0)
    frac = 0.0 if frac < 1e-6 else frac
    m_vk = st.m_vk + corr
    lam = beta0 + m_vk + frac * st.init_mass
    return UpdateOutBf16(IVIState(lam, m_vk, st.init_mass, frac), gamma, pi,
                         sweeps, pi_stored)
