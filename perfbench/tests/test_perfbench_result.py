"""The result line's schema, and the run's refusals."""
from __future__ import annotations

import io
import json
import subprocess
import sys
import time

import pytest

from perfbench.harness.runner import FORBIDDEN, forbidden_modules, run


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-infer"])
def test_last_line_schema(tiny_bench, cell):
    out, err = io.StringIO(), io.StringIO()
    rc = run(tiny_bench, cell, 2**31 + 5, 0.2, False,
             t0=time.perf_counter(), device="cpu", out=out, err=err)
    assert rc == 0, err.getvalue()
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert isinstance(res["correct"], bool)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert "setup_s" in res["metrics"]
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    # the compared numbers close standard error too, each beside its limit
    tail = err.getvalue().strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") and "(limit " in line
               for line in tail)


def test_no_card_no_result():
    """On a machine without a card the command prints no result and exits
    non-zero."""
    from conftest import REPO
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "train-arxiv-k100", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert p.returncode != 0
    assert "{" not in p.stdout


def test_without_the_program_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files has
    no program to run: non-zero, no result."""
    import shutil
    from conftest import REPO
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "train-arxiv-k100", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert p.returncode != 0
    assert "{" not in p.stdout


def test_forbidden_names_compare_whole():
    assert FORBIDDEN == ("jax", "jaxlib", "flax", "repro")
    assert forbidden_modules(["repro_torch", "repro_torch.lda.api",
                              "jaxtyping", "reprox", "flaxen"]) == []
    assert forbidden_modules(["repro", "repro.lda", "jax.numpy", "jaxlib",
                              "flax.linen", "numpy"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro", "repro.lda"]


def test_reference_and_harness_import_nothing_forbidden():
    """No file of the benchmark imports JAX or the JAX package, and the
    plain reference imports nothing of the program either."""
    import ast
    from conftest import REPO
    for path in (REPO / "perfbench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module]
        assert not forbidden_modules(names), (path, names)
        if "reference" in path.parts:
            assert not [n for n in names
                        if n.split(".")[0] in ("repro_torch", "repro")], path


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-infer"])
def test_traced_run_schema(tiny_bench, monkeypatch, cell):
    """A ``--trace 1`` run on the CPU, the profiler's timeline stubbed (one
    K1, one K3 and one other op, half the window idle): every per-layer
    metric of the cell is read, and ``device`` and ``breakdown`` carry
    what a result line must carry."""
    from perfbench.harness import trace

    def stub_profile(fn):
        fn()
        return trace.Segment(0.0, 1000.0, device=[
            ("fixed_point_kernel<4>", 0.0, 300.0),
            ("segment_scatter_kernel<4>", 300.0, 400.0),
            ("elementwise_kernel", 400.0, 500.0)],
            host=[("aten::copy_", 500.0, 1000.0)])

    monkeypatch.setattr(trace, "profile_segment", stub_profile)
    monkeypatch.setattr(trace, "count_host_syncs", lambda fn: fn() or 8)
    out, err = io.StringIO(), io.StringIO()
    rc = run(tiny_bench, cell, 2**31 + 5, 0.2, True,
             t0=time.perf_counter(), device="cpu", out=out, err=err)
    assert rc == 0, err.getvalue()
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    from perfbench.harness.bench import Bench
    want = {m["name"] for m in Bench(tiny_bench).cell(cell).per_layer}
    assert set(res["metrics"]) == want
    assert res["device"]["busy_s"] == pytest.approx(5e-4)
    assert res["device"]["window_s"] == pytest.approx(1e-3)
    idle = "idle_share." + cell.split("-")[1]
    assert res["metrics"][idle]["value"] == pytest.approx(50.0)
    assert res["breakdown"]["idle_gaps"] == [["aten::copy_",
                                              pytest.approx(5e-4)]]
    assert len(res["breakdown"]["device_ops"]) == 3
    assert list(res)[-1] == "checks"
