"""Measured-vs-modeled accounting: the roofline check.

A modeled time (bytes a kernel must move, divided by the card's memory
rate) is only trustworthy while measurement agrees with it; this module is
the join:

* ``spans_by_name`` aggregates a ``SpanRecorder``'s records per span name
  (count, total, min, mean) — the **measured** side. For kernel timings
  the recorder should run with ``device_sync=True`` so a span measures
  compute, not dispatch; ``min_s`` is the aggregate the check uses
  (minimum over repetitions is the standard noise-robust estimator for
  a deterministic workload).
* ``roofline_check`` joins measured seconds against each kernel's modeled
  HBM bytes: ``modeled_s = bytes / bandwidth`` is the memory-bound time,
  and ``measured_vs_modeled = measured_s / modeled_s`` should sit near
  1.0 for a genuinely memory-bound kernel on the modeled hardware. A
  ratio outside ``band`` flags the kernel: **> band** means the kernel is
  slower than its memory traffic explains (it is NOT memory-bound there —
  compute- or overhead-dominated, and the bytes model must not be used to
  claim speedups at that shape); **< band** means the model over-counts
  bytes (the kernel reuses more than the model credits).
* ``proxy_regime`` records that the measured side is a proxy (a CPU run
  of the kernels' plain versions, which says nothing of the card): the
  record is still emitted but ``agrees`` is expected False and is no bar.

``HW`` is the one hardware row the port's roofline consumers share: the
published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit) — the figures ``chip_smoke.py`` bounds its
kernels by — and the data sheet's NVLink rate between cards (900 GB/s a
card, both directions together), which the dry run's collective term
divides by.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

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


def roofline_check(records: Sequence[dict], *, hbm_gbps: float,
                   band: Tuple[float, float] = (0.5, 2.0),
                   proxy_regime: bool = False) -> dict:
    """Join measured kernel seconds against modeled HBM bytes.

    ``records``: ``[{"name": str, "measured_s": float,
    "modeled_hbm_bytes": int|float, ...}]`` — extra keys pass through.
    Returns a summary dict with per-record verdicts (see module
    docstring for how to read the flags).
    """
    if hbm_gbps <= 0:
        raise ValueError("hbm_gbps must be positive")
    lo, hi = band
    if not (0 < lo < hi):
        raise ValueError(f"band must be 0 < lo < hi, got {band}")
    out: List[dict] = []
    for r in records:
        modeled_s = float(r["modeled_hbm_bytes"]) / (hbm_gbps * 1e9)
        measured_s = float(r["measured_s"])
        ratio = measured_s / modeled_s if modeled_s > 0 else math.inf
        out.append({
            **r,
            "modeled_s": modeled_s,
            "measured_vs_modeled": ratio,
            "agrees_with_memory_bound_model": lo <= ratio <= hi,
            "verdict": ("memory_bound" if lo <= ratio <= hi else
                        "slower_than_memory_model" if ratio > hi else
                        "model_overcounts_bytes"),
        })
    flagged = [r["name"] for r in out
               if not r["agrees_with_memory_bound_model"]]
    return {
        "hbm_gbps": hbm_gbps,
        "band": [lo, hi],
        "proxy_regime": proxy_regime,
        "records": out,
        "n_records": len(out),
        "n_agree": len(out) - len(flagged),
        "flagged": flagged,
    }


def roofline_from_trace(trace_records: Iterable[dict],
                        modeled_bytes: Dict[str, float], *,
                        hbm_gbps: float,
                        band: Tuple[float, float] = (0.5, 2.0),
                        proxy_regime: bool = False,
                        use: str = "min_s") -> dict:
    """``roofline_check`` fed straight from a span trace.

    ``modeled_bytes`` maps span names to their modeled HBM bytes; span
    names absent from the trace are skipped (and listed under
    ``missing_spans`` so a renamed instrumentation point cannot silently
    empty the check).
    """
    agg = spans_by_name(trace_records)
    rows, missing = [], []
    for name, bytes_ in modeled_bytes.items():
        if name not in agg:
            missing.append(name)
            continue
        rows.append({"name": name, "measured_s": agg[name][use],
                     "measured_calls": agg[name]["count"],
                     "modeled_hbm_bytes": bytes_})
    out = roofline_check(rows, hbm_gbps=hbm_gbps, band=band,
                         proxy_regime=proxy_regime)
    out["missing_spans"] = missing
    return out
