"""The harness is driven by data: a configuration, a cell, a traffic mix
or a metric reader dropped in is found by its name, with no edit."""
from __future__ import annotations

import io
import json
import time

from perfbench.harness.bench import Bench
from perfbench.harness.runner import run

REAL_CELLS = ("train-arxiv-k100", "train-nyt-k100", "infer-arxiv-k100")


def test_every_cell_of_the_benchmark_resolves():
    from conftest import REPO
    bench = Bench(REPO)
    assert tuple(w["name"] for w in bench.spec["workloads"]) == REAL_CELLS
    for name in REAL_CELLS:
        cell = bench.cell(name)
        assert cell.limits
        assert bench.driver(cell.traffic).make
        for m in cell.end_to_end + cell.per_layer:
            assert callable(bench.reader(m["name"]).read)
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)


def test_dropped_in_files_are_found(tiny_bench):
    bench = Bench(tiny_bench)
    cell = bench.cell("tiny-train")
    assert cell.config["name"] == "tiny"
    assert cell.traffic["driver"] == "train_epochs"
    # a new per-layer metric: a reader file and an entry, no other edit
    (tiny_bench / "perfbench" / "metrics" / "updates_seen.py").write_text(
        "def read(rec):\n"
        "    w = rec.get('window')\n"
        "    return None if w is None else float(w['updates'])\n")
    spec = json.loads((tiny_bench / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "updates_seen", "unit": "count",
                               "better": "higher", "bound": 0.01,
                               "source": "host_clock",
                               "workloads": ["tiny-train"]})
    (tiny_bench / "BENCHMARK.json").write_text(json.dumps(spec))
    out, err = io.StringIO(), io.StringIO()
    rc = run(tiny_bench, "tiny-train", 5, 0.2, False,
             t0=time.perf_counter(), device="cpu", out=out, err=err)
    assert rc == 0, err.getvalue()
    res = json.loads(out.getvalue().splitlines()[-1])
    assert res["metrics"]["updates_seen"]["value"] == res["attempted"]


def test_a_reader_that_finds_nothing_leaves_its_metric_out(tiny_bench):
    bench = Bench(tiny_bench)
    rec = {"kind": "infer", "setup_s": 1.0}
    got = bench.read_metrics(bench.cell("tiny-train").per_layer, rec)
    assert got == {}
