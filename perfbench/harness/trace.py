"""What a traced segment of a run reads from the device: the profiler's
timeline, and the host syncs counted by torch's sync debug mode.

``profile_segment`` runs ``fn`` under ``torch.profiler`` inside one
``record_function`` range, synchronised at both ends, and reads the chrome
trace the profiler exports: every device operation (kernels, copies,
fills) with its interval, the range's own interval (the traced window),
and the host operations, by which the idle gaps are named.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import warnings
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

WINDOW = "perfbench/window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


@dataclass
class Segment:
    """One traced window: device ops as (name, start µs, end µs), host ops
    likewise, and the window's own bounds."""

    start_us: float
    end_us: float
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device ops' intervals, clipped to the window."""
        spans = sorted((max(s, self.start_us), min(e, self.end_us))
                       for _, s, e in self.device)
        out: List[Tuple[float, float]] = []
        for s, e in spans:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def device_seconds(self, match: Callable[[str], bool]) -> float:
        """Summed device time of the ops whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.device if match(n)) / 1e6

    def top_device_ops(self, n: int = 10) -> List[List[object]]:
        tot: Dict[str, float] = defaultdict(float)
        for name, s, e in self.device:
            tot[name] += (e - s) / 1e6
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List[object]]:
        """Idle device time by what the host was doing: each gap between
        busy intervals is named by the innermost host op that covers its
        midpoint (host ops nest, so the latest-starting op that still
        covers it), and the gaps are summed by name."""
        busy = self.busy_intervals()
        edges = [self.start_us] + [x for iv in busy for x in iv] \
            + [self.end_us]
        host = sorted((h for h in self.host if h[0] != WINDOW),
                      key=lambda h: h[1])
        starts = [h[1] for h in host]
        tot: Dict[str, float] = defaultdict(float)
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            mid = 0.5 * (s + e)
            name = "(host, no torch op)"
            for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                if host[i][2] >= mid:
                    name = host[i][0]
                    break
            tot[name] += (e - s) / 1e6
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:n]]


def profile_segment(fn: Callable[[], object]) -> Segment:
    """Run ``fn`` under the profiler; return its traced window."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return segment_from_events(events)


def segment_from_events(events: List[dict]) -> Segment:
    """The traced window of a chrome trace's events."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"the trace has no {WINDOW!r} range")
    w = win[0]
    seg = Segment(float(w["ts"]), float(w["ts"]) + float(w["dur"]))
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        item = (e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if e.get("cat") in _DEVICE_CATS:
            seg.device.append(item)
        elif e.get("cat") in _HOST_CATS:
            seg.host.append(item)
    return seg


def count_host_syncs(fn: Callable[[], object]) -> int:
    """Synchronizing CUDA operations in one call of ``fn``, as torch's
    sync debug mode "warn" reports them (one warning each)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("called a synchronizing" in str(w.message) for w in caught)
