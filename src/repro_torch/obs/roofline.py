"""The H100 row the port's roofline readers share, and the span aggregate.

``spans_by_name`` aggregates a ``SpanRecorder``'s records per span name
(count, total, min, mean). For kernel timings the recorder should run with
``device_sync=True`` so a span measures compute, not dispatch.

``HW`` is the one hardware row the port's roofline consumers share: the
published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit) — the figures ``chip_smoke.py`` bounds its
kernels by — and the data sheet's NVLink rate between cards (900 GB/s a
card, both directions together), which the dry run's collective term
divides by.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable

HW = {"name": "NVIDIA H100 80GB HBM3 (data sheet)",
      "hbm_bw": 3.35e12,            # bytes/s
      "peak_flops_fp32": 67e12,     # op/s, outside the tensor cores
      "peak_flops_bf16": 989e12,    # op/s, dense tensor cores
      "hbm_bytes": 80e9,
      "nvlink_bw": 900e9}           # bytes/s, NVLink, the data sheet's
HBM_GB = HW["hbm_bytes"] / 1e9


def spans_by_name(records: Iterable[dict]) -> Dict[str, dict]:
    """Aggregate trace records per span name → measured-seconds summary.

    Accepts the raw record dicts of a ``SpanRecorder`` (or a loaded trace
    JSONL); non-span records are ignored. Durations convert from the
    trace's microseconds to seconds.
    """
    out: Dict[str, dict] = {}
    for r in records:
        if r.get("type") != "span":
            continue
        agg = out.setdefault(r["name"], {"count": 0, "total_s": 0.0,
                                         "min_s": math.inf})
        dur_s = r["dur_us"] / 1e6
        agg["count"] += 1
        agg["total_s"] += dur_s
        if dur_s < agg["min_s"]:
            agg["min_s"] = dur_s
    for agg in out.values():
        agg["mean_s"] = agg["total_s"] / agg["count"]
    return out
