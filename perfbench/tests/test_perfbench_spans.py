"""The device's idle time by program layer: ``idle_by_span`` on a segment
laid out by hand, and the eight readers over real CPU ``--trace 1`` runs
of the tiny cells, the program's ranges from a CPU profiler."""
from __future__ import annotations

import io
import json
import os
import tempfile
import time

import pytest

from perfbench.harness import spans, trace
from perfbench.harness.runner import run

TRAIN_LAYERS = ("facade_idle_ms_per_update.train",
                "engine_idle_ms_per_update.train",
                "memo_idle_ms_per_update.train",
                "solve_idle_ms_per_update.train")
INFER_LAYERS = ("stage_idle_ms_per_request.infer",
                "dispatch_idle_ms_per_request.infer")


def test_idle_by_span_splits_gaps_at_range_boundaries():
    """Window 0–100 µs, device busy 10–20 and 50–60. Ranges:
    ``train/step`` 5–95 holding ``train/update`` 15–70, which holds
    ``train/solve`` 40–55; a torch op and a non-program range are ignored. Idle pieces:
    0–5 outside, 5–10 step, 20–40 update, 40–50 solve, 60–70 update,
    70–95 step, 95–100 outside."""
    seg = trace.Segment(0.0, 100.0, device=[("k", 10.0, 20.0),
                                            ("k", 50.0, 60.0)],
                        host=[(trace.WINDOW, 0.0, 100.0),
                              ("train/step", 5.0, 95.0),
                              ("train/update", 15.0, 70.0),
                              ("train/solve", 40.0, 55.0),
                              ("aten::index", 22.0, 30.0),
                              ("other/range", 0.0, 100.0)])
    got = spans.idle_by_span(seg)
    want = {spans.OUTSIDE: 10e-6, "train/step": 30e-6,
            "train/update": 30e-6, "train/solve": 10e-6}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v), k
    assert sum(got.values()) == pytest.approx(seg.window_s - seg.busy_s)


def test_idle_by_span_clips_to_the_window_and_prefers_the_inner():
    """A range that starts before the window counts from the window's
    start; of two ranges opened at one instant the shorter is the inner
    (idle 10–30 and 40–50: request 10–20, bucket 20–22, stage 22–25,
    request 25–30 and 40–45, outside 45–50); a window with no program
    range is idle outside alone."""
    seg = trace.Segment(10.0, 50.0, device=[("k", 30.0, 40.0)],
                        host=[("serve/request", 0.0, 45.0),
                              ("serve/stage", 20.0, 25.0),
                              ("serve/bucket", 20.0, 22.0)])
    got = spans.idle_by_span(seg)
    assert got == pytest.approx({"serve/request": 20e-6,
                                 "serve/bucket": 2e-6, "serve/stage": 3e-6,
                                 spans.OUTSIDE: 5e-6})
    bare = trace.Segment(0.0, 10.0, device=[("k", 2.0, 4.0)],
                         host=[("aten::copy_", 4.0, 10.0)])
    assert spans.idle_by_span(bare) == pytest.approx({spans.OUTSIDE: 8e-6})


def test_readers_find_nothing_outside_their_kind():
    seg = trace.Segment(0.0, 10.0, host=[("train/step", 0.0, 10.0)])
    rec = {"kind": "infer", "segment": seg, "work": {}, "trace_requests": 1}
    assert spans.layer_idle_s(rec, "train", ("train/step",)) is None
    assert spans.unattributed_share(rec, "train") is None
    assert spans.unattributed_share({"kind": "infer"}, "infer") is None
    assert spans.unattributed_share(rec, "infer") == 0.0


def _cpu_profile(fn):
    """``trace.profile_segment`` on the CPU: the same window and export,
    no device to synchronise (so no device op: the window is idle)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW):
            fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return trace.segment_from_events(events)


@pytest.mark.parametrize("cell,layers,count", [
    ("tiny-train", TRAIN_LAYERS, "trace_updates"),
    ("tiny-infer", INFER_LAYERS, "trace_requests")])
def test_cpu_traced_run_reads_every_layer(tiny_bench, monkeypatch, cell,
                                          layers, count):
    """A real ``--trace 1`` run on the CPU with the program's ranges in the
    profiler's trace: every new metric of the cell is read, the layers
    and the outside share account for the window's idle time, and the
    program's ranges hold most of it (no device op runs on the CPU, so
    the whole window is idle)."""
    monkeypatch.setattr(trace, "profile_segment", _cpu_profile)
    monkeypatch.setattr(trace, "count_host_syncs", lambda fn: fn() or 4)
    out, err = io.StringIO(), io.StringIO()
    rc = run(tiny_bench, cell, 2**31 + 11, 0.2, True,
             t0=time.perf_counter(), device="cpu", out=out, err=err)
    assert rc == 0, err.getvalue()
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    kind = cell.split("-")[1]
    share = f"unattributed_idle_share.{kind}"
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(layers) | {share} <= m.keys()
    traffic = "tiny-epochs" if kind == "train" else "tiny-requests"
    with open(tiny_bench / "perfbench" / "traffic" / f"{traffic}.json") as f:
        n = json.load(f)[count]
    idle = res["device"]["window_s"] - res["device"]["busy_s"]
    layered = sum(m[k] for k in layers) * n / 1e3
    assert layered + m[share] / 100 * idle == pytest.approx(idle, rel=1e-6)
    assert all(m[k] >= 0 for k in layers)
    assert m[share] < 50.0
