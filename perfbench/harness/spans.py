"""The device's idle time by the program layer the host was in.

The program opens a ``record_function`` range for each of its spans while
a profiler records (``repro_torch/obs/trace.py``): ``train/...`` and
``serve/...`` ranges, which the traced segment keeps among its host ops,
on the device ops' timeline. ``idle_by_span`` splits every idle interval
of the traced window (the window less the union of the device ops) at the
ranges' boundaries and puts each piece down to the innermost program
range that covers it, or to ``OUTSIDE`` where none does. The pieces sum
to the window's idle time.

Readers (``perfbench/metrics/*_idle_*``) go through ``layer_idle_s`` and
``unattributed_share``: None unless the record is traced and of the
reader's kind. A traced record with no program range reads 0 for every
layer and 100% outside.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

from perfbench.harness.readout import traced
from perfbench.harness.trace import Segment

#: The name prefixes of the program's ranges.
PROGRAM = ("train/", "serve/")
#: Idle time no program range covers.
OUTSIDE = "outside"


def is_program(name: str) -> bool:
    return name.startswith(PROGRAM)


def _labels(seg: Segment) -> Tuple[List[float], List[str]]:
    """The window cut at every program range's start and end: the cuts in
    order, and for each interval between two cuts the name of the
    innermost range covering it (the latest-starting one still open), or
    ``OUTSIDE``."""
    lo, hi = seg.start_us, seg.end_us
    ranges = [(max(s, lo), min(e, hi), n) for n, s, e in seg.host
              if is_program(n)]
    ranges = [r for r in ranges if r[1] > r[0]]
    cuts = sorted({lo, hi} | {t for s, e, _ in ranges for t in (s, e)})
    opens: Dict[float, list] = defaultdict(list)
    closes: Dict[float, list] = defaultdict(list)
    for i, (s, e, _) in enumerate(ranges):
        opens[s].append(i)
        closes[e].append(i)
    active: set = set()
    names: List[str] = []
    for t in cuts[:-1]:
        active.difference_update(closes.get(t, ()))
        active.update(opens.get(t, ()))
        if active:
            inner = max(active, key=lambda i: (ranges[i][0], -ranges[i][1]))
            names.append(ranges[inner][2])
        else:
            names.append(OUTSIDE)
    return cuts, names


def _idle_intervals(seg: Segment) -> Iterable[Tuple[float, float]]:
    edges = [seg.start_us] + [x for iv in seg.busy_intervals() for x in iv] \
        + [seg.end_us]
    return ((s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s)


def idle_by_span(seg: Segment) -> Dict[str, float]:
    """Idle seconds of the traced window by the innermost program range
    covering them (``OUTSIDE`` where none does)."""
    cuts, names = _labels(seg)
    out: Dict[str, float] = defaultdict(float)
    for s, e in _idle_intervals(seg):
        i = bisect.bisect_right(cuts, s) - 1
        while i < len(names) and cuts[i] < e:
            piece = min(e, cuts[i + 1]) - max(s, cuts[i])
            if piece > 0:
                out[names[i]] += piece / 1e6
            i += 1
    return dict(out)


def _idle(rec: dict) -> Dict[str, float]:
    """``idle_by_span`` of the record's segment, worked out once a run."""
    if "idle_by_span" not in rec:
        rec["idle_by_span"] = idle_by_span(rec["segment"])
    return rec["idle_by_span"]


def layer_idle_s(rec: dict, kind: str, names: Tuple[str, ...]
                 ) -> Optional[float]:
    """Idle seconds whose innermost program range is one of ``names``."""
    if not traced(rec, kind):
        return None
    idle = _idle(rec)
    return sum(idle.get(n, 0.0) for n in names)


def unattributed_share(rec: dict, kind: str) -> Optional[float]:
    """The share of the window's idle time outside every program range,
    in %; None where the window had no idle time to share out."""
    if not traced(rec, kind):
        return None
    idle = _idle(rec)
    total = sum(idle.values())
    if total <= 0:
        return None
    return 100.0 * idle.get(OUTSIDE, 0.0) / total
