"""The port's telemetry (`repro_torch.obs`) and quality metrics
(`repro_torch.core.metrics`): ``tests/test_obs.py``'s recorder, registry,
watchdog and bundle cases on the port's copies, the H100 row, the engine's
hooks (off: the same bits as on; on: the span names and counter totals of
``repro``'s engine on the same batches, plus the port's own spans), the
spans as ranges of a ``torch.profiler`` trace, and the metrics against
``repro``'s."""
import json
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.core import LDAConfig as JConfig
from repro.core import LDAEngine as JEngine
from repro.core import metrics as j_metrics
from repro.core.types import init_global_state as j_init_global_state
from repro.data import PAPER_CORPORA as J_CORPORA
from repro.data import make_corpus as j_make_corpus
from repro.data import stream as j_stream
from repro.obs import Telemetry as JTelemetry
from repro_torch.core import metrics
from repro_torch.core.engines import LDAEngine
from repro_torch.core.types import LDAConfig
from repro_torch.data.stream import CorpusDocStream
from repro_torch.data.synthetic import PAPER_CORPORA, make_corpus
from repro_torch.lda import LDA
from repro_torch.obs import (NULL_TELEMETRY, BoundMonotonicityError,
                             ElboMonotonicityWarning, ElboWatchdog,
                             MetricsRegistry, SpanRecorder, Telemetry,
                             as_telemetry, chrome_trace_from_jsonl,
                             load_jsonl, roofline, spans_by_name,
                             validate_jsonl)

CPU = "cpu"
SPEC = PAPER_CORPORA["tiny"]
SPANS = ("train/update", "train/memo_gather", "train/solve",
         "train/memo_update")
#: The port's spans beyond ``repro``'s, by engine path: the materialized
#: batch's cut (``run_minibatch``); the stream paths add none.
PORT_SPANS = {"padded": {"train/batch"}, "csr": set()}


# ---------------------------------------------------------------------------
# trace
# ---------------------------------------------------------------------------

def test_span_recorder_nesting_and_roundtrip(tmp_path):
    rec = SpanRecorder()
    with rec.span("outer", phase="a"):
        with rec.span("inner"):
            pass
        rec.event("marker", n=3)
    tok = rec.begin("manual")
    rec.end(tok)
    assert rec.num_records == 4
    by_name = {r["name"]: r for r in rec.records}
    assert by_name["inner"]["depth"] == 1
    assert by_name["outer"]["depth"] == 0
    assert by_name["outer"]["dur_us"] >= by_name["inner"]["dur_us"]
    assert by_name["marker"]["type"] == "event"

    jsonl = str(tmp_path / "t.jsonl")
    chrome = str(tmp_path / "t.chrome.json")
    assert rec.dump_jsonl(jsonl) == 4
    assert validate_jsonl(jsonl) == 4
    # Chrome conversion is count-exact: 1 record -> 1 traceEvent
    assert chrome_trace_from_jsonl(jsonl, chrome) == 4
    with open(chrome) as f:
        ct = json.load(f)
    assert len(ct["traceEvents"]) == 4
    assert {e["ph"] for e in ct["traceEvents"]} == {"X", "i"}


def test_validate_rejects_malformed(tmp_path):
    rec = SpanRecorder()
    rec.event("ok")
    jsonl = str(tmp_path / "bad.jsonl")
    rec.dump_jsonl(jsonl)
    meta, records = load_jsonl(jsonl)
    records[0].pop("ts_us")
    with open(jsonl, "w") as f:
        f.write(json.dumps(meta) + "\n")
        for r in records:
            f.write(json.dumps(r) + "\n")
    with pytest.raises(ValueError, match="missing 'ts_us'"):
        validate_jsonl(jsonl)


def test_spans_by_name_aggregates():
    rec = SpanRecorder()
    for _ in range(3):
        with rec.span("train/solve"):
            pass
    agg = spans_by_name(rec.records)
    assert agg["train/solve"]["count"] == 3
    assert agg["train/solve"]["min_s"] <= agg["train/solve"]["mean_s"]


def test_device_sync_span_waits_only_when_asked():
    """``end(sync=t)`` waits for a CUDA tensor's device only with
    ``device_sync=True``; a CPU tensor never needs it."""
    for sync in (False, True):
        rec = SpanRecorder(device_sync=sync)
        tok = rec.begin("train/solve")
        rec.end(tok, sync=torch.zeros(2))
        assert rec.num_records == 1 and rec.device_sync == sync


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_metrics_counters_gauges_labels():
    m = MetricsRegistry()
    m.inc("train.batches", width=64)
    m.inc("train.batches", width=64)
    m.inc("train.batches", width=128)
    assert m.value("train.batches", width=64) == 2.0
    assert m.total("train.batches") == 3.0
    m.set_gauge("pack.pad_frac", 0.25, width=64)
    m.set_gauge("pack.pad_frac", 0.5, width=64)       # gauges overwrite
    assert m.value("pack.pad_frac", width=64) == 0.5
    snap = m.snapshot()
    assert any(c["name"] == "train.batches" and c["labels"] == {"width": 128}
               for c in snap["counters"])


def test_metrics_percentiles_and_empty():
    m = MetricsRegistry()
    for v in range(1, 101):
        m.observe("lat", float(v))
    pct = m.percentiles("lat")
    assert pct["p50"] == pytest.approx(50.5)
    assert pct["p99"] == pytest.approx(np.percentile(np.arange(1, 101), 99))
    empty = m.percentiles("nothing")
    assert all(np.isnan(v) for v in empty.values())
    assert m.histogram_values("nothing") == []


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------

def test_watchdog_warns_then_raises_on_injected_decrease():
    wd = ElboWatchdog(policy="warn", tol=1e-6)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert not wd.observe(-100.0, step=1)
        assert not wd.observe(-99.0, step=2)          # increase: fine
        assert wd.observe(-99.5, step=3)              # injected decrease
    assert len(w) == 1 and issubclass(w[0].category, ElboMonotonicityWarning)
    assert wd.status()["violations"] == 1 and not wd.status()["ok"]

    hard = ElboWatchdog(policy="raise", tol=1e-6)
    hard.observe(-100.0, step=1)
    with pytest.raises(BoundMonotonicityError, match="monotonicity"):
        hard.observe(-101.0, step=2)


def test_watchdog_unarmed_and_slack():
    wd = ElboWatchdog(policy="raise", tol=1e-6)
    # unarmed readings (random-init mass still retiring) never enforce
    wd.observe(-100.0, armed=False)
    assert not wd.observe(-200.0, armed=False)
    # an armed reading right after an unarmed one has no armed baseline
    assert not wd.observe(-300.0, armed=True)
    # within-slack jitter passes: slack = max(tol, rel_tol * |prev|)
    loose = ElboWatchdog(policy="raise", tol=5e-3)
    loose.observe(-100.0)
    assert not loose.observe(-100.004)
    assert wd.status()["armed_checks"] == 1


def test_watchdog_counts_into_metrics_and_cadence():
    m = MetricsRegistry()
    wd = ElboWatchdog(policy="warn", tol=1e-6, check_every=4, metrics=m)
    assert not wd.should_check(3)
    assert wd.should_check(8)
    assert not ElboWatchdog(check_every=0).should_check(7)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        wd.observe(-1.0)
        wd.observe(-2.0)
    assert m.value("watchdog.violations") == 1.0
    assert wd.bound_tail(1) == [-2.0]


# ---------------------------------------------------------------------------
# the bundle, the null object, the roofline join
# ---------------------------------------------------------------------------

def test_as_telemetry_coercions():
    assert as_telemetry(None) is NULL_TELEMETRY
    assert as_telemetry(False) is NULL_TELEMETRY
    t = as_telemetry(True)
    assert isinstance(t, Telemetry) and t.enabled
    assert t.watchdog.check_every == 0     # default: observe at evaluate()
    assert t.watchdog.metrics is t.metrics  # bundle wires them together
    assert as_telemetry(t) is t
    with pytest.raises(TypeError):
        as_telemetry("yes")


def test_null_telemetry_is_inert():
    assert not NULL_TELEMETRY.enabled
    assert NULL_TELEMETRY.trace.begin("x") is None
    NULL_TELEMETRY.trace.end(None)
    NULL_TELEMETRY.metrics.inc("x")
    assert NULL_TELEMETRY.trace.num_records == 0
    assert NULL_TELEMETRY.trace.records == []
    assert NULL_TELEMETRY.metrics.snapshot() == {"counters": [], "gauges": [],
                                                 "histograms": []}
    assert not NULL_TELEMETRY.watchdog.observe(-1e9)


def test_roofline_join_over_the_h100_row():
    """The row holds the H100 data sheet's figures and nothing else."""
    hw = roofline.HW
    assert hw["name"] == "NVIDIA H100 80GB HBM3 (data sheet)"
    assert (hw["hbm_bw"], hw["peak_flops_fp32"], hw["peak_flops_bf16"],
            roofline.HBM_GB) == (3.35e12, 67e12, 989e12, 80.0)


# ---------------------------------------------------------------------------
# the engine's hooks
# ---------------------------------------------------------------------------

def _engine(layout="padded", algo="ivi", telemetry=None, store="dense",
            seed=0):
    cfg = LDAConfig(num_topics=4, vocab_size=SPEC.vocab_size,
                    estep_max_iters=15)
    train = make_corpus(SPEC, seed=0, device=CPU)
    if layout == "csr":
        train = CorpusDocStream(train, SPEC.vocab_size)
    return LDAEngine(cfg, train, algo=algo, batch_size=16, seed=seed,
                     layout=layout, token_budget=256 if layout == "csr"
                     else None, memo_store=store, telemetry=telemetry,
                     device=CPU)


@pytest.mark.parametrize("layout,algo,store", [
    ("padded", "ivi", "dense"), ("csr", "ivi", "dense"),
    ("padded", "svi", "dense"), ("padded", "sivi", "chunked"),
    ("csr", "sivi", "chunked"),
])
def test_telemetry_off_bit_equals_on(layout, algo, store):
    """The same two epochs with telemetry off (the null object) and on: the
    same λ bits, and the live bundle recorded every update."""
    off = _engine(layout, algo, None, store)
    tel = Telemetry()
    on = _engine(layout, algo, tel, store)
    assert off.tel is NULL_TELEMETRY
    for _ in range(2):
        off.run_epoch()
        on.run_epoch()
    for f in ("lam", "m_vk", "init_frac", "t"):
        assert torch.equal(getattr(off.state, f), getattr(on.state, f)), f
    agg = spans_by_name(tel.trace.records)
    assert agg["train/update"]["count"] == on._updates > 0
    assert off.tel.trace.num_records == 0


def _repro_pair(layout, algo, seed=0):
    """``repro``'s engine and the port's on the same batches (the same seed,
    or the same stream), both with a live bundle, from one λ₀."""
    jcfg = JConfig(num_topics=4, vocab_size=SPEC.vocab_size,
                   estep_max_iters=15)
    jtrain = j_make_corpus(J_CORPORA["tiny"], seed=0)
    budget = None
    if layout == "csr":
        jtrain = j_stream.CorpusDocStream(jtrain, SPEC.vocab_size)
        budget = 256
    jtel, ttel = JTelemetry(), Telemetry()
    jeng = JEngine(jcfg, jtrain, algo=algo, batch_size=16, seed=seed,
                   layout=layout, token_budget=budget, telemetry=jtel)
    teng = _engine(layout, algo, ttel, seed=seed)
    teng.state.lam.copy_(torch.from_numpy(np.array(
        j_init_global_state(jcfg, jax.random.key(seed)).lam)))
    return jeng, jtel, teng, ttel


@pytest.mark.parametrize("layout,algo", [("padded", "ivi"), ("csr", "ivi"),
                                         ("padded", "svi"), ("csr", "sivi")])
def test_span_names_and_counters_equal_repro(layout, algo):
    """After one epoch each: ``repro``'s span names with ``repro``'s counts
    and exactly the port's added names (``PORT_SPANS``, one a batch), and
    the same counters (``train.*`` and, on a stream, the packer's
    ``pack.*``) with the same labels and totals, and the same memo gauge;
    then ``evaluate`` sets the effective-topics gauge and feeds the
    watchdog on the incremental path."""
    jeng, jtel, teng, ttel = _repro_pair(layout, algo)
    jeng.run_epoch()
    teng.run_epoch()
    jagg = spans_by_name(jtel.trace.records)
    tagg = spans_by_name(ttel.trace.records)
    added = PORT_SPANS[layout]
    assert {n: a["count"] for n, a in tagg.items() if n not in added} == \
        {n: a["count"] for n, a in jagg.items()}
    updates = jagg["train/update"]["count"]
    assert {n: tagg[n]["count"] for n in added} == \
        {n: updates for n in added}
    want = set(SPANS) if algo != "svi" else {"train/update"}
    assert set(jagg) == want
    assert set(tagg) == want | added
    jsnap, tsnap = jtel.metrics.snapshot(), ttel.metrics.snapshot()
    assert tsnap["counters"] == jsnap["counters"]
    assert tsnap["gauges"] == jsnap["gauges"]
    assert ttel.metrics.total("train.docs") == 96
    teng.evaluate()
    assert ttel.metrics.value("train.effective_topics") > 1.0
    checks = ttel.watchdog.status()["checks"]
    assert checks == (1 if algo != "svi" else 0)


def test_watchdog_catches_real_bound_decrease():
    """``repro``'s test on the port: corrupting λ out from under the
    memoized statistics breaks eq. 4's bookkeeping, and the next armed
    per-update check raises; before that, a full armed epoch passes."""
    tel = Telemetry(watchdog=ElboWatchdog(policy="raise", check_every=1))
    eng = _engine(telemetry=tel)
    eng.run_epoch()                       # retires init mass -> armed
    eng.run_epoch()                       # a full armed epoch: no violation
    assert float(eng.state.init_frac) == 0.0
    assert tel.watchdog.status()["armed_checks"] > 0
    assert tel.watchdog.status()["ok"]
    eng.state.lam.copy_(eng.state.lam.flip(1) * 7.0 + 11.0)
    with pytest.raises(BoundMonotonicityError):
        eng.run_epoch()
    assert tel.watchdog.status()["violations"] >= 1


# ---------------------------------------------------------------------------
# the spans on the profiler's clock
# ---------------------------------------------------------------------------

def _lda(telemetry=None):
    cfg = LDAConfig(num_topics=4, vocab_size=SPEC.vocab_size,
                    estep_max_iters=15)
    return LDA(cfg, algo="ivi", batch_size=16, seed=3, telemetry=telemetry,
               device=CPU)


def _profiled(fn, tmp_path):
    """Run ``fn`` under a CPU ``torch.profiler``; the program's ranges of
    the exported trace as (name, start, end, thread)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e["tid"]) for e in events
            if e.get("ph") == "X" and e["name"].startswith(("train/",
                                                            "serve/"))]


def _parent(ranges, r):
    """The innermost other range of ``r``'s thread that contains it."""
    outer = [o for o in ranges if o is not r and o[3] == r[3]
             and o[1] <= r[1] and r[2] <= o[2]]
    return min(outer, key=lambda o: o[2] - o[1])[0] if outer else None


@pytest.mark.parametrize("telemetry", [False, True])
def test_spans_are_profiler_ranges(tmp_path, telemetry):
    """Two facade steps and one request under a profiler, telemetry off
    or on: each span is a range of the trace, as often as stated and
    nested as stated; with telemetry on the JSONL records the same spans
    as often."""
    train = make_corpus(SPEC, seed=0, device=CPU)
    tel = Telemetry() if telemetry else None
    lda = _lda(tel).partial_fit(train, steps=0)
    inf = lda.inferencer(batch_size=16)
    request = make_corpus(SPEC, seed=1, device=CPU)
    from repro_torch.data.stream import bucket_rows
    batches = sum(-(-len(rows) // 16) for rows, _ in
                  bucket_rows(request.counts.numpy()))

    def run():
        lda.partial_fit(steps=2)
        inf.posterior(request)

    ranges = _profiled(run, tmp_path)
    counts = {}
    for name, *_ in ranges:
        counts[name] = counts.get(name, 0) + 1
    assert counts == {"train/step": 2, "train/batch": 2, "train/update": 2,
                      "train/memo_gather": 2, "train/solve": 2,
                      "train/memo_update": 2, "serve/request": 1,
                      "serve/bucket": 1, "serve/stage": 1 + batches,
                      "serve/solve": batches, "serve/gather": 1}
    parent = {"train/step": None, "train/batch": "train/step",
              "train/update": "train/step",
              "train/memo_gather": "train/update",
              "train/solve": "train/update",
              "train/memo_update": "train/update",
              "serve/request": None, "serve/bucket": "serve/request",
              "serve/stage": "serve/request", "serve/solve": "serve/request",
              "serve/gather": "serve/request"}
    for r in ranges:
        assert _parent(ranges, r) == parent[r[0]], r
    # within a step the batch's cut comes before the update
    order = sorted((r for r in ranges
                    if r[0] in ("train/batch", "train/update")),
                   key=lambda r: r[1])
    assert [r[0] for r in order] == ["train/batch", "train/update"] * 2
    if telemetry:
        agg = spans_by_name(tel.trace.records)
        assert {n: a["count"] for n, a in agg.items()} == counts
        assert tel.metrics.total("train.docs") == 32
    else:
        assert lda.telemetry is NULL_TELEMETRY


def test_no_range_without_telemetry_or_profiler(monkeypatch):
    """With telemetry off and no profiler, no range is entered; the same
    calls under a profiler do enter one (the patched entry raises)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import trace

    def refuse(*a, **k):
        raise AssertionError("a profiler range was entered")

    monkeypatch.setattr(trace, "_RecordFunctionFast", refuse)
    train = make_corpus(SPEC, seed=0, device=CPU)
    lda = _lda().partial_fit(train, steps=2)
    inf = lda.inferencer(batch_size=16)
    inf.posterior(make_corpus(SPEC, seed=1, device=CPU))
    with pytest.raises(AssertionError, match="range was entered"):
        with profile(activities=[ProfilerActivity.CPU]):
            lda.partial_fit(steps=1)


def test_profiler_leaves_the_bits():
    """λ after the same steps with and without a profiler recording: the
    same bits."""
    from torch.profiler import ProfilerActivity, profile
    train = make_corpus(SPEC, seed=0, device=CPU)
    plain = _lda().partial_fit(train, steps=3)
    traced = _lda().partial_fit(train, steps=0)
    with profile(activities=[ProfilerActivity.CPU]):
        traced.partial_fit(steps=3)
    assert torch.equal(plain.lam, traced.lam)
    assert torch.equal(plain.trainer.state.m_vk, traced.trainer.state.m_vk)


# ---------------------------------------------------------------------------
# quality metrics
# ---------------------------------------------------------------------------

def test_quality_metrics_equal_repro():
    """``top_words`` and ``npmi_coherence`` equal ``repro``'s on the same λ
    and corpus, from a tensor or an array; ``effective_topics`` to fp32
    rounding."""
    jc = j_make_corpus(J_CORPORA["tiny"], seed=0)
    tc = make_corpus(SPEC, seed=0, device=CPU)
    lam = np.random.default_rng(3).gamma(
        2.0, 1.0, size=(SPEC.vocab_size, 6)).astype(np.float32)
    for arg in (lam, torch.from_numpy(lam)):
        np.testing.assert_array_equal(metrics.top_words(arg, 6),
                                      j_metrics.top_words(lam, 6))
        assert metrics.npmi_coherence(arg, tc, k=6) == pytest.approx(
            j_metrics.npmi_coherence(lam, jc, k=6), abs=1e-12)
        assert metrics.effective_topics(arg) == pytest.approx(
            j_metrics.effective_topics(jax.numpy.asarray(lam)), rel=1e-6)


# ---------------------------------------------------------------------------
# the chunked memo store's spans
# ---------------------------------------------------------------------------

CHUNKED_SPANS = {"train/memo_assemble": "train/memo_gather",
                 "train/memo_copy_in": "train/memo_gather",
                 "train/memo_copy_out": "train/memo_update",
                 "train/memo_scatter": "train/memo_update"}


def _chunked_lda(telemetry=None, store="chunked"):
    cfg = LDAConfig(num_topics=4, vocab_size=SPEC.vocab_size,
                    estep_max_iters=15)
    return LDA(cfg, algo="ivi", batch_size=16, seed=3, memo_store=store,
               chunk_docs=40, telemetry=telemetry, device=CPU)


def _record_parent(records, r):
    """The innermost other span of ``r``'s thread, one level out, that
    holds it, in a recorder's records."""
    outer = [o for o in records if o is not r and o["type"] == "span"
             and o["tid"] == r["tid"] and o["depth"] == r["depth"] - 1
             and o["ts_us"] <= r["ts_us"]
             and r["ts_us"] + r["dur_us"] <= o["ts_us"] + o["dur_us"]]
    return outer[0]["name"] if len(outer) == 1 else None


@pytest.mark.parametrize("telemetry", [False, True])
def test_chunked_store_spans_nest_in_the_memo_spans(tmp_path, telemetry):
    """Two facade steps over the chunked store, two epochs in (every
    document revisited), under a profiler with telemetry off or on: each
    of the store's four spans is a range once a step, inside the engine's
    ``train/memo_gather`` (assembly, copy in) or ``train/memo_update``
    (copy out, scatter), in that order; with telemetry on the JSONL
    records the same spans, one level deeper than their parents."""
    tel = Telemetry() if telemetry else None
    train = make_corpus(SPEC, seed=0, device=CPU)
    lda = _chunked_lda(tel).partial_fit(train, steps=2 * 96 // 16)
    ranges = _profiled(lambda: lda.partial_fit(steps=2), tmp_path)
    for name, parent in CHUNKED_SPANS.items():
        mine = [r for r in ranges if r[0] == name]
        assert len(mine) == 2, name
        assert all(_parent(ranges, r) == parent for r in mine), name
    order = [r[0] for r in sorted(ranges, key=lambda r: r[1])
             if r[0] in CHUNKED_SPANS]
    assert order == list(CHUNKED_SPANS) * 2
    if telemetry:
        spans = [r for r in tel.trace.records if r["type"] == "span"
                 and r["name"] in CHUNKED_SPANS]
        assert len(spans) == 4 * (2 * 96 // 16 + 2)
        for r in spans:
            assert _record_parent(tel.trace.records, r) == \
                CHUNKED_SPANS[r["name"]], r


def test_dense_store_opens_no_chunked_span(tmp_path):
    """The dense store opens none of the chunked store's spans, with
    telemetry on and under a profiler: the dense cells' layers read as
    before."""
    tel = Telemetry()
    train = make_corpus(SPEC, seed=0, device=CPU)
    lda = _chunked_lda(tel, store="dense").partial_fit(train, steps=2)
    ranges = _profiled(lambda: lda.partial_fit(steps=2), tmp_path)
    names = {r[0] for r in ranges} | {r["name"] for r in tel.trace.records}
    assert "train/memo_gather" in names
    assert not names & set(CHUNKED_SPANS)
    assert tel.metrics.total("memo.link_bytes_in") == 0
