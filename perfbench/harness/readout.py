"""Shared arithmetic of the metric readers (``perfbench/metrics/``).

Each reader takes the run's record: ``kind`` (the traffic driver's), and
from a traced run ``segment`` (the profiler's window), ``work`` (each
traced launch's bytes and operations from ``perfbench/reference/work.py``)
and the counters the traffic driver read. A reader returns None where
the record has nothing for it; a share of a roofline or a peak is never
made up.
"""
from __future__ import annotations

from typing import Callable, Optional

from perfbench.reference.work import HW, bound_s

#: Kernel names of the port, as the profiler prints them.
K1 = "fixed_point"          # K1, the fixed point (with its π finish)
K3 = "segment_scatter"      # K3, the segment scatter


def is_k1(name: str) -> bool:
    return K1 in name


def is_k3(name: str) -> bool:
    return K3 in name


def traced(rec: dict, kind: str) -> bool:
    return rec.get("kind") == kind and "segment" in rec and "work" in rec


def roofline(rec: dict, kind: str, key: str,
             match: Callable[[str], bool]) -> Optional[float]:
    """The launches' summed bounds over their summed device time, in %."""
    if not traced(rec, kind) or not rec["work"][key]:
        return None
    seconds = rec["segment"].device_seconds(match)
    if seconds <= 0:
        return None
    bound = sum(bound_s(w)[0] for w in rec["work"][key])
    return 100.0 * bound / seconds


def mfu(rec: dict, kind: str) -> Optional[float]:
    """The traced work's counted operations over the traced window's wall
    seconds at the card's fp32 peak, in %."""
    if not traced(rec, kind):
        return None
    w = rec["work"]
    ops = sum(o for _, o in w["k1"]) + sum(o for _, o in w["k3"]) \
        + w["other_ops"]
    return 100.0 * ops / (rec["segment"].window_s * HW["peak_flops_fp32"])


def idle_share(rec: dict, kind: str) -> Optional[float]:
    """The share of the traced window in which no device op ran, in %."""
    if not traced(rec, kind):
        return None
    seg = rec["segment"]
    return 100.0 * (1.0 - seg.busy_s / seg.window_s)
