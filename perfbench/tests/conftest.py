"""A tiny copy of the benchmark, for driving whole runs on the CPU.

``tiny_bench`` copies the benchmark's data and code folders under
``tmp_path`` and adds a tiny configuration and two tiny cells (one a
traffic driver), as a later change would add them: new files and new
entries, no edit.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CORPUS = {"num_train": 100, "num_test": 48, "vocab_size": 300,
               "mean_len": 24, "min_len": 4, "true_topics": 6,
               "alpha": 0.1, "beta": 0.01, "corpus_seed": 7}
TINY_MODEL = {"num_topics": 6, "algo": "ivi", "batch_size": 16,
              "layout": "padded", "memo_store": "dense",
              "estep_backend": "cuda", "alpha0": 0.5, "beta0": 0.05,
              "estep_max_iters": 100, "estep_tol": 1e-4, "stop_tile": 128,
              "precision": "float32"}


def _dump(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_tiny_bench(root: Path, corpus=None, model=None) -> Path:
    for sub in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(REPO / "perfbench" / sub, root / "perfbench" / sub)
    with open(REPO / "BENCHMARK.json") as f:
        spec = json.load(f)
    _dump(root / "perfbench" / "configs" / "tiny.json",
          {"name": "tiny", "corpus": corpus or TINY_CORPUS,
           "model": model or TINY_MODEL})
    _dump(root / "perfbench" / "traffic" / "tiny-epochs.json",
          {"driver": "train_epochs", "setup_epochs": 1, "check_steps": 2,
           "sync_updates": 2, "trace_updates": 2})
    _dump(root / "perfbench" / "traffic" / "tiny-requests.json",
          {"driver": "infer_requests", "request_docs": 20,
           "batch_size": 8, "warm_requests": 1, "check_requests": 3,
           "trace_requests": 2, "keep_share": 0.5})
    for cell, limits in (("tiny-train", {"pi_max_abs": 1e-4,
                                          "dlam_rel": 1e-3}),
                         ("tiny-infer", {"gamma_rel": 1e-4})):
        _dump(root / "perfbench" / "workloads" / f"{cell}.json",
              {"limits": limits})
    spec["configs"].append({"name": "tiny", "source": "tests",
                            "file": "perfbench/configs/tiny.json",
                            "reduced": [], "why": "tests"})
    spec["workloads"] += [
        {"name": "tiny-train", "config": "tiny", "traffic": "tiny-epochs",
         "chips": 1, "why": "tests"},
        {"name": "tiny-infer", "config": "tiny",
         "traffic": "tiny-requests", "chips": 1, "why": "tests"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            kind = "train" if any(w.startswith("train")
                                  for w in m["workloads"]) else "infer"
            m["workloads"].append(f"tiny-{kind}")
    _dump(root / "BENCHMARK.json", spec)
    return root


@pytest.fixture
def tiny_bench(tmp_path):
    return make_tiny_bench(tmp_path / "bench")
