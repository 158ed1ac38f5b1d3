"""Whole runs of the tiny cells on the CPU (the program's plain twins),
the harness's look for a chip skipped: a sound run is correct, and a run
whose timed path is broken underneath is not, once for each fault the
cells can have. One chip: no exchange between chips to leave out."""
from __future__ import annotations

import io
import json
import time

import pytest

from perfbench.control import readings
from perfbench.faults import FAULTS, plant
from perfbench.harness.bench import Bench
from perfbench.harness.runner import run


def run_cell(root, cell, seed=2**31 + 99):
    out, err = io.StringIO(), io.StringIO()
    rc = run(root, cell, seed, 0.3, False, t0=time.perf_counter(),
             device="cpu", out=out, err=err)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-infer"])
def test_sound_run_is_correct(tiny_bench, cell):
    res = run_cell(tiny_bench, cell)
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", ["tiny-train", "tiny-infer"])
def test_fault_is_refused(tiny_bench, monkeypatch, cell, fault):
    plant(monkeypatch.setattr, cell.split("-")[1], fault)
    res = run_cell(tiny_bench, cell)
    assert res["correct"] is False, (fault, res["checks"])


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-infer"])
def test_control_is_refused_on_the_cpu(tiny_bench, cell):
    """The program's bf16 stream of Eφ (its lower-precision path) fails a
    check at the tiny size too."""
    limits = Bench(tiny_bench).cell(cell).limits
    for r in readings(tiny_bench, cell, [2**31 + 7], True, "cpu"):
        assert any(r[k] > lim for k, lim in limits.items()), r
