"""Metrics registry: counters, gauges, histograms — with labels (the
port's copy of ``repro.obs.metrics``).

One ``MetricsRegistry`` instance rides inside a ``Telemetry`` bundle and
collects the run's operational numbers from every instrumented layer:

* **counters** (``inc``) — monotone totals: tokens ingested, documents
  trained/served, batches per bucket width, jit-cache hits/misses,
  watchdog violations;
* **gauges** (``set_gauge``) — last-written values: per-bucket pad
  fraction, memo-store resident bytes, effective-topics count;
* **histograms** (``observe``) — full value distributions: request
  latency, per-phase batch timings, double-buffer queue depth. Raw
  observations are kept (bounded by ``max_samples`` per series via
  reservoir-free head-truncation: count/sum/min/max stay exact, the
  percentile basis is the first ``max_samples`` values), so the exported
  percentiles are real percentiles, not bucket interpolations.

Labels are kwargs: ``reg.inc("serve.batches", width=64)`` — each distinct
label set is its own series. ``snapshot()`` renders everything to a
JSON-able dict (``dump_json`` writes it), with p50/p95/p99 precomputed
for histograms.

``NULL_METRICS`` is the disabled registry: every method is a no-op and
reads return empties/NaN — the null object the hot paths branch on.

Thread safety: every mutation takes the registry lock (mutations are tiny
— a dict lookup and a float add — so the lock is uncontended in
practice; the serving packer thread and the consumer thread both write).
"""
from __future__ import annotations

import json
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

LabelKey = Tuple[str, Tuple[Tuple[str, object], ...]]


def _key(name: str, labels: dict) -> LabelKey:
    return (name, tuple(sorted(labels.items())) if labels else ())


class NullMetrics:
    """The disabled registry: no-op writes, empty reads, no allocations."""

    enabled = False

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        pass

    def set_gauge(self, name: str, value: float, **labels) -> None:
        pass

    def observe(self, name: str, value: float, **labels) -> None:
        pass

    def value(self, name: str, **labels) -> float:
        return 0.0

    def total(self, name: str) -> float:
        return 0.0

    def percentiles(self, name: str, ps: Sequence[int] = (50, 95, 99),
                    **labels) -> Dict[str, float]:
        return {f"p{p}": float("nan") for p in ps}

    def snapshot(self) -> dict:
        return {"counters": [], "gauges": [], "histograms": []}


NULL_METRICS = NullMetrics()


class _Hist:
    __slots__ = ("values", "count", "total", "vmin", "vmax")

    def __init__(self):
        self.values: List[float] = []
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def add(self, v: float, max_samples: int) -> None:
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if len(self.values) < max_samples:
            self.values.append(v)


class MetricsRegistry:
    """Labelled counters / gauges / histograms (see module docstring)."""

    enabled = True

    def __init__(self, *, max_samples: int = 100_000):
        self.max_samples = max_samples
        self._lock = threading.Lock()
        self._counters: Dict[LabelKey, float] = {}
        self._gauges: Dict[LabelKey, float] = {}
        self._hists: Dict[LabelKey, _Hist] = {}

    # -- writes ----------------------------------------------------------
    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        k = _key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + value

    def set_gauge(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._gauges[_key(name, labels)] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        k = _key(name, labels)
        with self._lock:
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = _Hist()
            h.add(float(value), self.max_samples)

    # -- reads -----------------------------------------------------------
    def value(self, name: str, **labels) -> float:
        """One series' counter total or gauge value (0.0 if unwritten)."""
        k = _key(name, labels)
        with self._lock:
            if k in self._counters:
                return self._counters[k]
            return self._gauges.get(k, 0.0)

    def total(self, name: str) -> float:
        """A counter summed across all of its label sets."""
        with self._lock:
            return sum(v for (n, _), v in self._counters.items()
                       if n == name)

    def histogram_values(self, name: str, **labels) -> List[float]:
        with self._lock:
            h = self._hists.get(_key(name, labels))
            return list(h.values) if h is not None else []

    def percentiles(self, name: str, ps: Sequence[int] = (50, 95, 99),
                    **labels) -> Dict[str, float]:
        """Real percentiles over a histogram series; NaNs when the series
        has no observations (callers skip the report row)."""
        vals = sorted(self.histogram_values(name, **labels))
        if not vals:
            return {f"p{p}": float("nan") for p in ps}
        out = {}
        for p in ps:
            # linear interpolation between closest ranks (numpy default)
            idx = (len(vals) - 1) * p / 100.0
            lo, hi = int(math.floor(idx)), int(math.ceil(idx))
            frac = idx - lo
            out[f"p{p}"] = vals[lo] * (1 - frac) + vals[hi] * frac
        return out

    # -- export ----------------------------------------------------------
    def snapshot(self) -> dict:
        """Everything, JSON-able: the ``--metrics-json`` payload."""
        with self._lock:
            counters = [{"name": n, "labels": dict(lb), "value": v}
                        for (n, lb), v in sorted(self._counters.items())]
            gauges = [{"name": n, "labels": dict(lb), "value": v}
                      for (n, lb), v in sorted(self._gauges.items())]
            hists = []
            for (n, lb), h in sorted(self._hists.items(),
                                     key=lambda kv: kv[0]):
                hists.append({
                    "name": n, "labels": dict(lb), "count": h.count,
                    "sum": h.total,
                    "min": h.vmin if h.count else float("nan"),
                    "max": h.vmax if h.count else float("nan"),
                    "sampled": len(h.values),
                })
        for rec in hists:
            rec.update(self.percentiles(rec["name"], **rec["labels"]))
        return {"counters": counters, "gauges": gauges, "histograms": hists}

    def dump_json(self, path: str) -> dict:
        snap = self.snapshot()
        with open(path, "w") as f:
            json.dump(snap, f, indent=2)
        return snap
