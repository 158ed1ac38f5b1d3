"""The bf16 host-chunked memo cell at CPU size: its reference
(``perfbench/reference/lda_bf16memo.py``) against the program's facade over
two epochs, the reference's rounding and ulp arithmetic, whole runs of a
tiny cell of the ``train_epochs_chunked`` traffic held to the real cell's
limits (a sound run passes; every fault and the bf16-Eφ control fail),
and the three memo readers, with the program's ranges and counters and
without them."""
from __future__ import annotations

import io
import json
import os
import tempfile
import time

import numpy as np
import pytest
import torch

from perfbench.control import readings
from perfbench.faults import FAULTS, plant
from perfbench.harness import corpus, trace
from perfbench.harness.bench import Bench
from perfbench.harness.runner import run
from perfbench.reference import lda_bf16memo as ref
from perfbench.reference.link import PCIE_GEN5_X16_BYTES_PER_S

CELL = "tiny-train-chunked"
REAL = "train-arxiv-k300-chunked"
MEMO_READERS = ("memo_host_idle_ms_per_update.train",
                "memo_wait_idle_ms_per_update.train",
                "memo_link_share.train")


def make_chunked_bench(root):
    """The tiny benchmark with a tiny chunked configuration and cell,
    held to the real cell's limits and read by the real cell's metrics."""
    from conftest import REPO, TINY_MODEL, _dump, make_tiny_bench
    make_tiny_bench(root)
    tiny = json.loads((root / "perfbench" / "configs"
                       / "tiny.json").read_text())
    model = dict(TINY_MODEL, memo_store="chunked", chunk_docs=32,
                 memo_dtype="bfloat16")
    _dump(root / "perfbench" / "configs" / "tinyc.json",
          {"name": "tinyc", "corpus": tiny["corpus"], "model": model})
    _dump(root / "perfbench" / "traffic" / "tiny-epochs-chunked.json",
          {"driver": "train_epochs_chunked", "setup_epochs": 1,
           "check_steps": 2, "sync_updates": 2, "trace_updates": 2})
    limits = json.loads((REPO / "perfbench" / "workloads"
                         / f"{REAL}.json").read_text())["limits"]
    _dump(root / "perfbench" / "workloads" / f"{CELL}.json",
          {"limits": limits})
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tinyc", "source": "tests",
                            "file": "perfbench/configs/tinyc.json",
                            "reduced": [], "why": "tests"})
    spec["workloads"].append({"name": CELL, "config": "tinyc",
                              "traffic": "tiny-epochs-chunked", "chips": 1,
                              "why": "tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if REAL in m.get("workloads", ()):
            m["workloads"].append(CELL)
    _dump(root / "BENCHMARK.json", spec)
    return root


@pytest.fixture
def chunked_bench(tmp_path):
    return make_chunked_bench(tmp_path / "bench")


def run_cell(root, trace_on=False, seed=2**31 + 99):
    out, err = io.StringIO(), io.StringIO()
    rc = run(root, CELL, seed, 0.3, trace_on, t0=time.perf_counter(),
             device="cpu", out=out, err=err)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])


# -- the reference ------------------------------------------------------------

def test_round_bf16_is_round_to_nearest_even_off_the_edges():
    """Without the program's π the rounding is torch's (to nearest, ties to
    even); its neighbours bracket every value, and a correctly rounded
    value reads no excess, the other neighbour ½ less its distance, and
    a value two ulps off at least 1."""
    gen = torch.Generator().manual_seed(5)
    x = torch.rand(20000, generator=gen) * 10.0 ** torch.randint(
        -12, 1, (20000,), generator=gen)
    x = torch.cat([x, torch.tensor([0.0, 1.0, 1.00390625, 1.001953125])])
    r = ref.round_bf16(x)
    assert torch.equal(r, x.to(torch.bfloat16).float())
    lo, hi, frac = ref.bf16_neighbours(x)
    assert bool(((lo <= x) & (x < hi)).all())
    assert bool(((r == lo) | (r == hi)).all())
    assert bool(((frac >= 0) & (frac < 1)).all())
    assert float(ref.ulp_excess(r, x).max()) == 0.0
    ulp = (hi - lo).double()
    own = (r - x).abs().double() / ulp
    other = ref.ulp_excess(torch.where(r == lo, hi, lo), x)
    assert torch.allclose(other + own, torch.full_like(own, 0.5))
    assert float(ref.ulp_excess(r + 2 * (hi - lo), x).min()) >= 1 - 1e-6


def test_an_edge_takes_the_programs_neighbour_and_nothing_else():
    """Within ROUND_TIE ulp of a midpoint the reference takes the
    program's stored value if it is one of the two neighbours; off the
    edge, or a stored value that is no neighbour, it keeps its own."""
    one = torch.tensor(1.0)
    ulp = float(ref.bf16_neighbours(one)[1] - one)
    mid = 1.0 + 0.5 * ulp
    near = torch.tensor([mid * (1 - 1e-7), mid * (1 + 1e-7)])
    far = torch.tensor([1.0 + 0.3 * ulp, 1.0 + 0.7 * ulp])
    lo, hi = 1.0, 1.0 + ulp
    for stored in (lo, hi):
        s = torch.full((2,), stored)
        assert torch.equal(ref.round_bf16(near, s), s)
        assert torch.equal(ref.round_bf16(far, s), ref.round_bf16(far))
    wrong = torch.full((2,), 1.0 + 2 * ulp)
    assert torch.equal(ref.round_bf16(near, wrong), ref.round_bf16(near))


def test_reference_keeps_fp32_products():
    torch.backends.cuda.matmul.allow_tf32 = True
    ref.strict_fp32()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_chunked_lda_matches_the_bf16_reference():
    """``LDA(memo_store="chunked")`` against the bf16-memo reference over
    two epochs (every document revisited), each side chaining its own
    state and memo: every stored π within 1e-2 bf16 ulp of the rounding of
    the reference's float32 π, the stored memo the reference's, and λ
    within float32 rounding of two trajectories."""
    from repro_torch.core.types import Corpus
    from repro_torch.lda.api import LDA
    gen = torch.Generator().manual_seed(3)
    n, v, k, b = 40, 200, 5, 16
    phi = corpus.topics(v, k, 0.05, gen)
    s = corpus.make_split(phi, n, 20, 4, 0.1, gen)
    lam0 = torch._standard_gamma(torch.full((v, k), 100.0),
                                 generator=gen) * 0.01
    lda = LDA(num_topics=k, vocab_size=v, algo="ivi", backend="cuda",
              batch_size=b, seed=9, memo_store="chunked", chunk_docs=16,
              device="cpu")
    lda.partial_fit(Corpus(s.ids, s.counts), steps=0)
    lda.warm_start(lam0)
    c = ref.EStepCfg(0.5, 1e-4, 100, 128)
    total = float(s.counts.double().sum())
    rng = np.random.default_rng(9)
    order = np.concatenate([rng.permutation(n), rng.permutation(n)])
    bounds = [0, 16, 32, 40, 56, 72, 80]
    st = ref.IVIState(lam0.clone(), torch.zeros_like(lam0), lam0 - 0.05,
                      1.0)
    memo = torch.zeros(s.ids.shape + (k,), dtype=torch.bfloat16)
    seen = torch.zeros(n, dtype=torch.bool)
    for lo, hi in zip(bounds, bounds[1:]):
        rows = torch.as_tensor(order[lo:hi])
        lda.partial_fit(steps=1)
        stored, vis = lda.trainer.eng.memo.gather(rows.numpy())
        assert bool(vis.all())
        out = ref.ivi_update(st, s.ids[rows], s.counts[rows], memo[rows],
                             seen[rows], total, 0.05, c, stored)
        live = (s.counts[rows] > 0)[:, :, None]
        excess = torch.where(live, ref.ulp_excess(stored, out.pi), 0.0)
        assert float(excess.max()) < 1e-2
        assert torch.equal(stored, out.pi_stored)
        assert torch.allclose(lda.lam, out.state.lam, rtol=1e-5, atol=1e-5)
        memo[rows], seen[rows] = out.pi_stored.to(torch.bfloat16), True
        st = out.state
    assert st.init_frac == 0.0


# -- whole runs of the tiny cell ----------------------------------------------

def test_sound_chunked_run_is_correct(chunked_bench):
    res = run_cell(chunked_bench)
    assert set(res["checks"]) == {"pi_ulp_excess", "dlam_rel"}
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("fault", FAULTS)
def test_chunked_fault_is_refused(chunked_bench, monkeypatch, fault):
    plant(monkeypatch.setattr, "train", fault)
    res = run_cell(chunked_bench)
    assert res["correct"] is False, (fault, res["checks"])


def test_chunked_control_is_refused(chunked_bench):
    """The program's bf16 stream of Eφ fails the cell's check at the tiny
    size too."""
    limits = Bench(chunked_bench).cell(CELL).limits
    for r in readings(chunked_bench, CELL, [2**31 + 7], True, "cpu"):
        assert any(r[k] > lim for k, lim in limits.items()), r


# -- the memo readers ---------------------------------------------------------

def _cpu_profile(fn):
    """``trace.profile_segment`` on the CPU: the same window and export,
    with no device to synchronise."""
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


def test_traced_chunked_run_reads_the_memo_layers(chunked_bench,
                                                  monkeypatch):
    """A CPU ``--trace 1`` run with the program's ranges: both memo idle
    readers read (the CPU runs no device op, so all is idle), and the
    link share is left out, with no copy on a device to read."""
    monkeypatch.setattr(trace, "profile_segment", _cpu_profile)
    monkeypatch.setattr(trace, "count_host_syncs", lambda fn: fn() or 4)
    res = run_cell(chunked_bench, trace_on=True)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["memo_host_idle_ms_per_update.train"] > 0
    assert m["memo_wait_idle_ms_per_update.train"] > 0
    assert "memo_link_share.train" not in m
    assert "memo_idle_ms_per_update.train" in m


def test_memo_link_share_reads_the_counters_over_the_copies(chunked_bench,
                                                            monkeypatch):
    """With a stubbed timeline of one copy each way: the counters' bytes
    over the copies' device time at the link's rate."""
    def stub(fn):
        fn()
        return trace.Segment(0.0, 1000.0, device=[
            ("Memcpy HtoD (Pinned -> Device)", 0.0, 100.0),
            ("fixed_point_kernel<4>", 100.0, 300.0),
            ("Memcpy DtoH (Device -> Pinned)", 300.0, 350.0)],
            host=[("train/memo_assemble", 400.0, 500.0),
                  ("train/memo_copy_out", 500.0, 600.0)])

    monkeypatch.setattr(trace, "profile_segment", stub)
    monkeypatch.setattr(trace, "count_host_syncs", lambda fn: fn() or 4)
    out, err = io.StringIO(), io.StringIO()
    rc = run(chunked_bench, CELL, 2**31 + 99, 0.3, True,
             t0=time.perf_counter(), device="cpu", out=out, err=err)
    assert rc == 0, err.getvalue()
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    m = {k: v["value"] for k, v in res["metrics"].items()}
    width = int(err.getvalue().split(" width=")[1].split()[0])
    spec = json.loads((chunked_bench / "perfbench" / "configs"
                       / "tinyc.json").read_text())
    b, k = spec["model"]["batch_size"], spec["model"]["num_topics"]
    moved = 2 * 2 * b * width * k * 2        # 2 updates, B·W·K·2 each way
    assert m["memo_link_share.train"] == pytest.approx(
        100.0 * moved / (150e-6 * PCIE_GEN5_X16_BYTES_PER_S))
    assert m["memo_host_idle_ms_per_update.train"] == pytest.approx(0.05)
    assert m["memo_wait_idle_ms_per_update.train"] == pytest.approx(0.05)


def test_memo_readers_find_nothing_without_the_programs_ranges():
    """A program with neither the store's ranges nor its counters (as
    before they were added): each memo reader returns None, no raise."""
    seg = trace.Segment(0.0, 10.0, host=[("train/memo_gather", 0.0, 10.0)])
    rec = {"kind": "train", "segment": seg, "work": {}, "trace_updates": 1}
    from conftest import REPO
    bench = Bench(REPO)
    for name in MEMO_READERS:
        assert bench.reader(name).read(rec) is None, name
        assert bench.reader(name).read({"kind": "train"}) is None, name
