"""The plain reference of the LDA E-step and of one IVI update (eq. 4).

Plain PyTorch in float32 with TF32 off: no kernel, no cache, no batching
of its own. It imports nothing of the program: it works the answers out
from the inputs the benchmark made (and, where the benchmark says so, from
the program's state at a stated point) and only reads the program's outputs
to judge them.

The fixed point is the configuration's: per document
γ ← α₀ + Eθ(γ) · Σ_l cnt_l Eφ_l / (Eθ(γ)·Eφ_l + ε), with Eθ = exp(ψ(γ) −
ψ(Σγ)) and Eφ = exp(ψ(λ) − ψ(Σ_v λ)); the documents of a stop tile of
``tile`` rows sweep together until the tile's mean |Δγ| is at most ``tol``
(compared in float32), at most ``max_sweeps`` times. The tile is what
couples documents, so the caller lays the rows out as the configuration
states they are batched.

A tile whose stopping test lies within ``TIE`` (relative) of ``tol`` may
stop one sweep apart under another summation order: the mean |Δγ| is a
sum of differences of γ near convergence (one such tile read 9.999847e-5
against 1e-4). Such a tile offers the neighbouring stop as a candidate
too, and the caller's ``pick`` (which sees the program's answer only to
judge it) chooses the candidate the tile is held to.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch

EPS = 1e-30
TIE = 1e-3

#: pick(first row, end row, candidate γ of the tile's rows) -> the index
#: of the candidate the tile takes (0: the reference's own stop)
Pick = Callable[[int, int, Sequence[torch.Tensor]], int]


def strict_fp32() -> None:
    """Keep every float32 product in float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def exp_elog(a: torch.Tensor, dim: int) -> torch.Tensor:
    """exp(E[ln x]) of Dirichlet(a) along ``dim``."""
    return torch.exp(torch.special.digamma(a)
                     - torch.special.digamma(a.sum(dim, keepdim=True)))


@dataclass(frozen=True)
class EStepCfg:
    alpha0: float
    tol: float
    max_sweeps: int
    tile: int


def _sweep(g: torch.Tensor, e: torch.Tensor, cn: torch.Tensor,
           alpha0: float) -> Tuple[torch.Tensor, float]:
    """One sweep of a tile: (γ', the mean |γ' − γ| in float32)."""
    et = exp_elog(g, -1)
    p = (et[:, None, :] * e).sum(-1) + EPS              # (rows, L)
    g_new = alpha0 + et * ((cn / p)[:, :, None] * e).sum(1)
    return g_new, float((g_new - g).abs().sum() / g.numel())


def fixed_point(ids: torch.Tensor, cnts: torch.Tensor, eb: torch.Tensor,
                gamma0: torch.Tensor, c: EStepCfg,
                pick: Optional[Pick] = None
                ) -> Tuple[torch.Tensor, List[int]]:
    """γ of a padded (B, L) batch, tile by tile. Returns (γ (B, K), the
    reference's sweeps of each tile)."""
    b = gamma0.shape[0]
    tol = float(torch.tensor(c.tol, dtype=torch.float32))
    cap = max(c.max_sweeps, 1)
    out, sweeps = [], []
    for lo in range(0, b, c.tile):
        hi = min(lo + c.tile, b)
        e = eb[ids[lo:hi].long()]                       # (rows, L, K)
        cn = cnts[lo:hi]
        g, prev, deltas = gamma0[lo:hi], None, []
        while len(deltas) < cap:
            prev, (g, d) = g, _sweep(g, e, cn, c.alpha0)
            deltas.append(d)
            if d <= tol:
                break
        cands = [g]
        if pick is not None:
            n = len(deltas)
            if n < cap and deltas[-1] > tol * (1 - TIE):
                cands.append(_sweep(g, e, cn, c.alpha0)[0])
            if n >= 2 and deltas[-2] <= tol * (1 + TIE):
                cands.append(prev)
        out.append(cands[pick(lo, hi, cands)] if len(cands) > 1 else g)
        sweeps.append(len(deltas))
    gamma = torch.cat(out) if out else gamma0.clone()
    return gamma, sweeps


def token_pi(ids: torch.Tensor, cnts: torch.Tensor, eb: torch.Tensor,
             gamma: torch.Tensor) -> torch.Tensor:
    """π (B, L, K) of each slot at γ; 0 on padding (count 0)."""
    et = exp_elog(gamma, -1)
    e = eb[ids.long()]
    p = (et[:, None, :] * e).sum(-1, keepdim=True) + EPS
    return torch.where(cnts[:, :, None] > 0, et[:, None, :] * e / p, 0.0)


def scatter(ids: torch.Tensor, cnts: torch.Tensor, pi: torch.Tensor,
            v: int) -> torch.Tensor:
    """Σ cnt·π at the token ids, (V, K), summed in float64."""
    k = pi.shape[-1]
    out = torch.zeros((v, k), dtype=torch.float64, device=pi.device)
    out.index_add_(0, ids.reshape(-1).long(),
                   (cnts[:, :, None] * pi).reshape(-1, k).double())
    return out.float()


@dataclass
class IVIState:
    """λ, ⟨m_vk⟩, the initial mass and its share still unretired."""

    lam: torch.Tensor
    m_vk: torch.Tensor
    init_mass: torch.Tensor
    init_frac: float


@dataclass
class UpdateOut:
    state: IVIState
    gamma: torch.Tensor
    pi: torch.Tensor
    sweeps: List[int]


def ivi_update(st: IVIState, ids: torch.Tensor, cnts: torch.Tensor,
               old_pi: torch.Tensor, visited: torch.Tensor,
               words_total: float, beta0: float, c: EStepCfg,
               pi_prog: Optional[torch.Tensor] = None) -> UpdateOut:
    """One IVI update (Algorithm 1, eq. 4) on a padded batch: the E-step
    warm-started from the memo for visited documents, π, the correction
    Σ cnt·(π_new − π_old), the first visits' share of the initial mass
    retired, and λ = β₀ + ⟨m_vk⟩ + frac·mass. A tied tile takes the stop
    whose π lies nearest ``pi_prog``, the program's π (when given)."""
    v = st.lam.shape[0]
    eb = exp_elog(st.lam, 0)
    warm = c.alpha0 + (old_pi * cnts[:, :, None]).sum(1)
    gamma0 = torch.where(visited[:, None], warm,
                         torch.full_like(warm, c.alpha0 + 1.0))
    pick = None
    if pi_prog is not None:
        def pick(lo, hi, cands):
            live = (cnts[lo:hi] > 0)[:, :, None]
            gaps = [float(torch.where(
                live, (token_pi(ids[lo:hi], cnts[lo:hi], eb, g)
                       - pi_prog[lo:hi]).abs(), 0.0).max()) for g in cands]
            return gaps.index(min(gaps))
    gamma, sweeps = fixed_point(ids, cnts, eb, gamma0, c, pick)
    pi = token_pi(ids, cnts, eb, gamma)
    corr = scatter(ids, cnts, pi, v) - scatter(ids, cnts, old_pi, v)
    first = float(cnts[~visited].double().sum())
    frac = max(st.init_frac - first / words_total, 0.0)
    frac = 0.0 if frac < 1e-6 else frac
    m_vk = st.m_vk + corr
    lam = beta0 + m_vk + frac * st.init_mass
    return UpdateOut(IVIState(lam, m_vk, st.init_mass, frac), gamma, pi,
                     sweeps)


def doc_gaps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Σ_k |γ − γ_ref| / Σ_k γ_ref of each document, in float64."""
    want = want.double()
    return (got.double() - want).abs().sum(-1) / want.sum(-1)


def gamma_only(ids: torch.Tensor, cnts: torch.Tensor, eb: torch.Tensor,
               c: EStepCfg, gamma_prog: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, List[int]]:
    """Serving's E-step: γ from the fresh start α₀ + 1. A tied tile takes
    the stop nearest ``gamma_prog``, the program's γ of the batch's first
    rows (when given)."""
    gamma0 = torch.full((ids.shape[0], eb.shape[1]), c.alpha0 + 1.0,
                        dtype=torch.float32, device=eb.device)
    pick = None
    if gamma_prog is not None:
        n = gamma_prog.shape[0]

        def pick(lo, hi, cands):
            if lo >= n:
                return 0
            gaps = [float(doc_gaps(gamma_prog[lo:hi], g[:n - lo]).max())
                    for g in cands]
            return gaps.index(min(gaps))
    return fixed_point(ids, cnts, eb, gamma0, c, pick)
