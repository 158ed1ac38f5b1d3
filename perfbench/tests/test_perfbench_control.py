"""The control on the card: the program's bfloat16 stream of Eφ and the
counts (its own lower-precision path) must fail a cell's check, and sound
runs must pass it, at each real cell's widths with the document counts cut
to what a test run holds (the full-size readings are in PERF.md).

Run on the machine with the card:
``python -m pytest -q -m gpu perfbench/tests/test_perfbench_control.py``.
"""
from __future__ import annotations

import json

import pytest
import torch

from perfbench.control import readings

CELLS = ("train-arxiv-k100", "train-nyt-k100", "infer-arxiv-k100")
SEEDS = (2147483901, 2147483902, 2147483903)


def _cut_bench(tmp_path, cell):
    """A copy of the benchmark whose configurations hold 1/16 of the
    documents (every width, length and hyper-parameter as committed)."""
    from conftest import make_tiny_bench
    root = make_tiny_bench(tmp_path / "bench")
    for p in (root / "perfbench" / "configs").glob("*-k100.json"):
        cfg = json.loads(p.read_text())
        for key in ("num_train", "num_test"):
            cfg["corpus"][key] //= 16
        p.write_text(json.dumps(cfg))
    return root


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes_on_the_card(tmp_path, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    root = _cut_bench(tmp_path, cell)
    limits = json.loads((root / "perfbench" / "workloads"
                         / f"{cell}.json").read_text())["limits"]
    for r in readings(root, cell, SEEDS, False):
        assert all(r[k] <= lim for k, lim in limits.items()), r
    for r in readings(root, cell, SEEDS, True):
        assert any(r[k] > lim for k, lim in limits.items()), r
