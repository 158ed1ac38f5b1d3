"""Bytes and operations of the CUDA E-step kernels: their bounds, and the
tuner's modeled objective.

A kernel's bound is the least time the card could take for its work: the
larger of the bytes it must move (each input read once, each output
written once) over the memory rate, and its operations over the peak rate
for their type, from the H100 row of `repro_torch.obs.roofline.HW`. These
are the one copy of the formulas: ``chip_smoke.py`` bounds every kernel of
its ``kernels`` line with them (PERF.md §6's Bound column). Where the work
depends on the data (tiles that stop early, live slots, distinct ids) the
caller passes what its inputs need.

``modeled_cost_seconds`` is the tuner's objective when the tune's device
is not a card (every record then carries ``proxy_regime: true``): the
bounds of one IVI update's two launches at a tune shape, the fixed point
with its π finish and K3, with every slot live and every tile at
``iters`` sweeps. ``repro``'s model priced the Pallas kernels' VMEM tiles,
which have no counterpart here. Only ``block_b`` enters, through the
sweep count written per tile; the kernels' launches are their own and do
not. A modeled search therefore returns the default with
``improvement == 1.0`` or a tile whose few bytes fewer the gate then
judges: the card, not the model, decides.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from repro_torch.core.types import DEFAULT_KERNEL_POLICY, KernelPolicy
from repro_torch.obs.roofline import HW

HBM_BYTES_PER_S = HW["hbm_bw"]
FP32_OPS_PER_S = HW["peak_flops_fp32"]
BF16_OPS_PER_S = HW["peak_flops_bf16"]
# operations per element of the in-kernel exp(E[ln θ]): two series digammas
# (8 divisions + 8 additions + log + 6 series terms each), a subtraction and
# an exp, counting a division, log or exp as one operation
ETHETA_OPS = 34

Work = Tuple[float, float]   # (bytes, operations)


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = FP32_OPS_PER_S) -> Tuple[float, str]:
    """(the bound in ms, "bytes" or "operations": which of the two sets
    it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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


def fixed_point_csr_work(live: int, b: int, k: int, distinct: int,
                         sweeps: int) -> Work:
    """K4 without its finish: K1's operations over the batch as one tile;
    the live tokens' ids, counts and segments, the distinct Eφ rows and γ₀
    read, γ, Eθ and the sweep count written."""
    ops = sweeps * (4 * k * live + (ETHETA_OPS + 4) * k * b) \
        + ETHETA_OPS * b * k
    nbytes = live * 12 + distinct * k * 4 + 3 * b * k * 4 + 4
    return float(nbytes), float(ops)


def pi_finish_work(slots: int, k: int, live: int) -> Work:
    """What the π finish adds to K1/K4: π written for every slot, 4
    operations a live slot's topic."""
    return float(slots * k * 4), 4.0 * k * live


def token_pi_work(slot_bytes: int, slots: int, b: int, k: int,
                  distinct: int, live: int) -> Work:
    """K2 or K5: each slot's ``slot_bytes`` (id and count; K5 its segment
    too), the distinct Eφ rows and Eθ read, π written; 4 operations a live
    slot's topic."""
    return (float(slot_bytes * slots + distinct * k * 4 + b * k * 4
                  + slots * k * 4), 4.0 * live * k)


def scatter_work(live: int, v: int, k: int, pis: int = 2) -> Work:
    """K3 over ``pis`` π inputs (new, and old): the live rows' index and
    count, their π rows read, one (V, K) sum written per input; 2
    operations a live row's topic per input."""
    return (float(live * 8 + pis * live * k * 4 + pis * v * k * 4),
            2.0 * pis * live * k)


def onehot_work(slots: int, k: int, v: int, live: int,
                etheta_rows: int = 0) -> Work:
    """K8: the slots' ids and counts, their Eφ rows and old π read, π
    written, ``etheta_rows`` rows of Eθ read and S_new, S_old written; π's
    4 and the two sums' 4 operations a live slot's topic."""
    return (float(slots * 8 + 3 * slots * k * 4 + etheta_rows * k * 4
                  + 2 * v * k * 4), 8.0 * live * k)


def dense_bound(b: int, v: int, k: int) -> Tuple[float, str]:
    """K6's or K7's fp32 bound on (B, V) counts and K topics: C, Eθ and Eφ
    read once, one (B, K) or (V, K) output; two products of 2·B·V·K
    operations plus the ε add and the division per (b, v)."""
    nbytes = (b * v + b * k + v * k + max(b, v) * k) * 4
    return bound_ms(nbytes, 4.0 * b * v * k + 2.0 * b * v)


def sweep_tc_bound(b: int, v: int, k: int,
                   out_rows: Optional[int] = None) -> Tuple[float, str]:
    """K6's (or, with ``out_rows`` = V, K7's) floor on the tensor cores: C,
    Eθ and Eφ read once, the (B, K) or (V, K) output written once; the
    bf16 x 3 split does six bf16 products of each of the two
    2·B·V·K-operation products (a multiply-add counts two operations, as
    the 989 TFLOP/s peak counts them)."""
    out_rows = b if out_rows is None else out_rows
    return bound_ms((b * v + b * k + v * k + out_rows * k) * 4,
                    24.0 * b * v * k, BF16_OPS_PER_S)


def attention_work(b: int, s: int, h: int, kvh: int, hd: int,
                   window: Optional[int] = None) -> Work:
    """K9 causal in bf16: Q, K, V read and O written once; Q·Kᵀ and P·V
    over the (query, key) pairs a causal mask keeps, with a ``window``
    the pairs of its band (``kernels.flash_attention.kept_pairs``)."""
    from repro_torch.kernels.flash_attention import kept_pairs
    pairs = b * h * kept_pairs(s, s, True, window)
    return float(2 * (2 * b * s * h * hd + 2 * b * s * kvh * hd)), \
        4.0 * hd * pairs


# ---------------------------------------------------------------------------
# the tuner's modeled objective
# ---------------------------------------------------------------------------

def modeled_update_work(task: str, *, policy: Optional[KernelPolicy],
                        b_or_t: int, v: int, k: int, w: Optional[int],
                        iters: int, num_docs: Optional[int] = None
                        ) -> Tuple[Work, Work]:
    """(the fixed point with its π finish, K3) of one IVI update at a tune
    shape: every slot live, each tile at ``iters`` sweeps, as many
    distinct ids as slots up to V. ``task`` is ``"padded"`` (``b_or_t`` =
    B, ``w`` = L) or ``"csr"`` (``b_or_t`` = T, ``num_docs`` = B)."""
    pol = policy or DEFAULT_KERNEL_POLICY
    if task == "padded":
        if w is None:
            raise ValueError("padded task needs a token width w")
        from repro_torch.kernels.lda_estep import fixed_point_tiles
        b, slots = b_or_t, b_or_t * w
        rows = [n for _, n in fixed_point_tiles(b, pol.block_b)]
        fp = fixed_point_work(b, w, k, min(v, slots), [n * w for n in rows],
                              rows, [iters] * len(rows))
    elif task == "csr":
        b, slots = num_docs or 64, b_or_t
        fp = fixed_point_csr_work(slots, b, k, min(v, slots), iters)
    else:
        raise ValueError(f"unknown tune task {task!r}")
    fin = pi_finish_work(slots, k, slots)
    return (fp[0] + fin[0], fp[1] + fin[1]), scatter_work(slots, v, k)


def modeled_cost_seconds(task: str, *, policy: Optional[KernelPolicy],
                         b_or_t: int, v: int, k: int, w: Optional[int],
                         iters: int, num_docs: Optional[int] = None
                         ) -> float:
    """The modeled seconds of one IVI update: the sum of its two launches'
    bounds (``modeled_update_work``)."""
    return sum(bound_ms(*work)[0] for work in modeled_update_work(
        task, policy=policy, b_or_t=b_or_t, v=v, k=k, w=w, iters=iters,
        num_docs=num_docs)) / 1e3
