"""Bytes and operations of the port's E-step kernels, and the card's peaks.

A frozen copy of the formulas the port keeps in
``repro_torch/tune/model.py`` and of the H100 row of
``repro_torch/obs/roofline.py``: the benchmark's yardstick, which the
program under test cannot move. Each input is counted as read once and each
output as written once. Where the work depends on the data (tiles that stop
early, live slots, distinct ids) the caller passes what the inputs need: the
sweeps of each stop tile come from the plain reference on the same batch.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

#: Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W).
HW = {"name": "NVIDIA H100 80GB HBM3 (data sheet)",
      "hbm_bw": 3.35e12,            # bytes/s
      "peak_flops_fp32": 67e12,     # op/s, outside the tensor cores
      "hbm_bytes": 80e9}

#: Operations a row of exp(E[ln θ]): two series digammas (8 divisions, 8
#: additions, a log and 6 series terms each), a subtraction and an exp.
ETHETA_OPS = 34
#: Operations an element of exp(E[ln φ]) = exp(ψ(λ) − ψ(Σ_v λ)): one
#: digamma, its share of the column sum, the subtraction and the exp.
EPHI_OPS = ETHETA_OPS // 2 + 2

Work = Tuple[float, float]   # (bytes, operations)


def bound_s(work: Work) -> Tuple[float, str]:
    """(the least seconds the card could take, "bytes" or "operations":
    which of the two sets it), against the fp32 peak."""
    nbytes, ops = work
    t_bytes = nbytes / HW["hbm_bw"]
    t_ops = ops / HW["peak_flops_fp32"]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def batch_counts(ids: np.ndarray, counts: np.ndarray, tile: int
                 ) -> Tuple[List[int], List[int], int]:
    """What a padded (B, L) batch's inputs need: the live slots and the
    rows of each stop tile of ``tile`` rows, and the distinct live ids."""
    live = counts > 0
    b = ids.shape[0]
    tiles = [(lo, min(lo + tile, b)) for lo in range(0, b, tile)]
    return ([int(live[lo:hi].sum()) for lo, hi in tiles],
            [hi - lo for lo, hi in tiles], int(np.unique(ids[live]).size))


def bound_split(name: str, works: Sequence[Work]) -> str:
    """How many of ``works``' launches each term bounds, as a note."""
    by = [bound_s(w)[1] for w in works]
    return (f"{name} bound by bytes {by.count('bytes')}, by operations "
            f"{by.count('operations')} of {len(by)}")


def fixed_point_work(b: int, l: int, k: int, distinct: int,
                     tile_live: Sequence[int], tile_rows: Sequence[int],
                     sweeps: Sequence[int]) -> Work:
    """K1 without its finish: 4·K operations a live slot and Eθ's series a
    row each sweep of its tile, plus the series once more for the final
    Eθ; the (B, L) ids and counts, the ``distinct`` Eφ rows and γ₀ read,
    γ, Eθ and the tiles' sweep counts written."""
    ops = sum(s * (4 * k * live + (ETHETA_OPS + 4) * k * rows)
              for s, live, rows in zip(sweeps, tile_live, tile_rows))
    ops += ETHETA_OPS * b * k
    nbytes = b * l * 8 + distinct * k * 4 + 3 * b * k * 4 + len(sweeps) * 4
    return float(nbytes), float(ops)


def pi_finish_work(slots: int, k: int, live: int) -> Work:
    """What the π finish adds to K1: π written for every slot, 4
    operations a live slot's topic."""
    return float(slots * k * 4), 4.0 * k * live


def scatter_work(live: int, v: int, k: int, pis: int = 2) -> Work:
    """K3 over ``pis`` π inputs (new, and old): the live rows' index and
    count, their π rows read, one (V, K) sum written per input; 2
    operations a live row's topic per input."""
    return (float(live * 8 + pis * live * k * 4 + pis * v * k * 4),
            2.0 * pis * live * k)


def update_glue_ops(b: int, l: int, v: int, k: int) -> float:
    """The operations of one IVI update outside K1 and K3: Eφ over (V, K),
    the warm start's Σ_l cnt·π_old (2 a slot's topic), the correction's
    subtraction and the global step m += corr, λ = β₀ + m + frac·mass
    (4 an element of (V, K))."""
    return float(EPHI_OPS * v * k + 2 * b * l * k + 4 * v * k)
