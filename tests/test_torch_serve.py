"""Port parity, the online serving service: ``repro_torch.serve``,
``QueueDocStream`` and ``launch.serve_lda`` against ``repro.serve`` on the
same numpy inputs.

* the traffic generators and ``QueueDocStream`` (positions, drops, clips,
  late appends): bit for bit;
* ``AdmissionController`` fed the same ``offer``/``poll``/``take``/
  ``close`` sequence as ``repro``'s (each scenario of
  ``tests/test_serve_service.py``'s admission block, on both layouts where
  it applies, and a seeded random trace): the emitted batches' arrays, the
  shed set, ``next_due`` and the ``admit.*`` metrics equal;
* ``SnapshotStore.publish``: Eφ within 1e-6 of ``repro``'s, the same
  versions and (under one injected clock) the same stall;
* ``ServingService`` under one injected fake clock and sleep: the same
  batches, shed set, ``done_s`` and SLO report; γ per request within
  ``repro``'s backend bar, rtol = atol = 2e-3, on the ``gather`` and
  ``cuda`` twins against ``repro``'s ``gather``; served γ bit-equal to the
  port's own ``posterior_docs``; each package's validator accepts the
  other's report;
* ``OnlineLearner`` from one ``lam0`` with the same documents: λ within
  1e-3 of ``repro``'s, the same versions and armed readings;
* ``python -m repro_torch.launch.serve_lda --device cpu`` from a
  ``repro`` checkpoint, replayed and ``--online``; ``--dryrun`` raises.
"""
import json
import math
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as jserve
from repro.core import LDAConfig as JConfig
from repro.data import PAPER_CORPORA as J_CORPORA
from repro.data import make_corpus as j_make_corpus
from repro.data.stream import QueueDocStream as JQueue
from repro.lda import LDA as JLDA
from repro.lda import TopicInferencer as JInferencer
from repro.obs import ElboWatchdog as JWatchdog
from repro.obs import MetricsRegistry as JMetrics
import repro_torch.serve as tserve
from repro_torch.core.types import LDAConfig
from repro_torch.data.stream import QueueDocStream
from repro_torch.data.synthetic import PAPER_CORPORA
from repro_torch.lda import TopicInferencer
from repro_torch.obs import ElboWatchdog, MetricsRegistry, Telemetry

CPU = "cpu"
SPEC = PAPER_CORPORA["tiny"]
V = SPEC.vocab_size
K = 5
BATCH = 8
TOL = dict(rtol=2e-3, atol=2e-3)


def _ragged(n_docs, *, vocab=V, max_n=24, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_docs):
        n = int(rng.integers(2, max_n))
        ids = np.sort(rng.choice(vocab, size=n, replace=False)).astype(
            np.int32)
        cnts = (rng.poisson(1.0, n) + 1).astype(np.float32)
        out.append((ids, cnts))
    return out


@pytest.fixture(scope="module")
def lams():
    rng = np.random.default_rng(5)
    return [rng.gamma(2.0, 0.5, (V, K)).astype(np.float32)
            for _ in range(2)]


def _cfgs(backend="gather", iters=30):
    kw = dict(num_topics=K, vocab_size=V, estep_max_iters=iters)
    return (JConfig(estep_backend="gather", **kw),
            LDAConfig(estep_backend=backend, **kw))


def _same_batch(a, b):
    """Two packed batches (``repro``'s and the port's) field for field."""
    assert type(a).__name__ == type(b).__name__
    assert a._fields == b._fields
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        else:
            assert x == y, f


def _same_batches(xs, ys):
    assert len(xs) == len(ys)
    for a, b in zip(xs, ys):
        _same_batch(a, b)


# ---------------------------------------------------------------------------
# traffic generators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_arrivals_bit_for_bit(seed):
    for args, kw in (((64, 100.0), dict(seed=seed)),
                     ((40, 7.5), dict(seed=seed, t0=2.25))):
        a = tserve.poisson_arrivals(*args, **kw)
        assert a.dtype == np.float64
        assert np.array_equal(a, jserve.poisson_arrivals(*args, **kw))
    for on_s, off_s in ((0.02, 1.0), (0.1, 0.1), (0.05, 0.0)):
        kw = dict(on_s=on_s, off_s=off_s, seed=seed, t0=0.5)
        assert np.array_equal(tserve.onoff_arrivals(80, 200.0, **kw),
                              jserve.onoff_arrivals(80, 200.0, **kw))
    for rate in (None, 10.0, 333.0):
        assert np.array_equal(tserve.replay_arrivals(7, rate, t0=1.5),
                              np.asarray(jserve.replay_arrivals(7, rate,
                                                                t0=1.5)))


@pytest.mark.parametrize("call", [
    lambda m: m.poisson_arrivals(-1, 1.0),
    lambda m: m.poisson_arrivals(3, 0.0),
    lambda m: m.onoff_arrivals(3, 1.0, on_s=0.0, off_s=1.0),
    lambda m: m.onoff_arrivals(3, 1.0, on_s=1.0, off_s=-1.0),
    lambda m: m.replay_arrivals(-1),
    lambda m: m.replay_arrivals(3, -2.0),
    lambda m: m.requests_from_docs([], [0.0]),
])
def test_traffic_refusals_match_repro(call):
    with pytest.raises(ValueError):
        call(jserve)
    with pytest.raises(ValueError):
        call(tserve)


def test_requests_from_docs_bit_for_bit():
    docs = _ragged(3, seed=1) + [np.array([4, 4, 9, 1, 9, 9])]
    arr = tserve.poisson_arrivals(9, 50.0, seed=2)
    for deadline in (math.inf, 0.5):
        got = tserve.requests_from_docs(docs, arr, deadline_s=deadline,
                                        start_id=7)
        want = jserve.requests_from_docs(docs, arr, deadline_s=deadline,
                                         start_id=7)
        assert len(got) == len(want) == 9
        for g, w in zip(got, want):
            assert (g.rid, g.arrival_s, g.deadline_s) == \
                (w.rid, w.arrival_s, w.deadline_s)
            for x, y in ((g.ids, w.ids), (g.cnts, w.cnts)):
                assert x.dtype == y.dtype and np.array_equal(x, y)
    assert tserve.requests_from_docs(docs, []) == []


# ---------------------------------------------------------------------------
# QueueDocStream
# ---------------------------------------------------------------------------

def _same_docs(got, want):
    assert len(got) == len(want)
    for (gi, gc), (wi, wc) in zip(got, want):
        assert gi.dtype == wi.dtype and np.array_equal(gi, wi)
        assert gc.dtype == wc.dtype and np.array_equal(gc, wc)


@pytest.mark.parametrize("capacity,max_unique", [(3, 256), (8, 4), (20, 7)])
def test_queue_stream_positions_drops_clips(capacity, max_unique):
    rng = np.random.default_rng(capacity)
    docs = _ragged(12, vocab=100, seed=capacity)
    # count ties, so the clip's argsort order is exercised
    docs = [(i, rng.integers(1, 4, len(i)).astype(np.float32))
            for i, _ in docs]
    docs.append(np.array([3, 3, 7, 1, 7, 7, 2]))       # raw tokens
    q = QueueDocStream(100, capacity=capacity, max_unique=max_unique)
    j = JQueue(100, capacity=capacity, max_unique=max_unique)
    assert [q.append(d) for d in docs] == [j.append(d) for d in docs]
    for attr in ("num_docs", "appended", "dropped", "num_words",
                 "max_unique", "capacity", "vocab_size"):
        assert getattr(q, attr) == getattr(j, attr), attr
    _same_docs(list(q.iter_from(0)), list(j.iter_from(0)))
    _same_docs(list(q.iter_from(2)), list(j.iter_from(2)))


def test_queue_stream_late_appends():
    docs = _ragged(6, vocab=100, seed=10)
    q, j = (QueueDocStream(100, capacity=8), JQueue(100, capacity=8))
    got, want = [], []
    for s, out in ((q, got), (j, want)):
        s.append(docs[0])
        it = s.iter_from(0)
        out.append(next(it))
        for d in docs[1:4]:
            s.append(d)                 # appended after the iterator began
        out.extend(it)
        it2 = s.iter_from(1)
        out.append(next(it2))
        for d in docs[4:]:
            s.append(d)
        out.extend(it2)
    assert len(got) == 1 + 3 + 1 + 4
    _same_docs(got, want)
    assert q.num_words == j.num_words


def test_queue_stream_refusals_and_threads():
    for kw in (dict(capacity=0), dict(capacity=2, max_unique=0)):
        with pytest.raises(ValueError):
            JQueue(10, **kw)
        with pytest.raises(ValueError):
            QueueDocStream(10, **kw)
    q = QueueDocStream(1000, capacity=500)
    with pytest.raises(ValueError, match="vocabulary"):
        q.append((np.array([1000], np.int32), np.ones(1, np.float32)))
    # sixteen appenders with a short switch interval: stable positions
    # 0..capacity-1, the rest dropped, every kept document once, the words
    # of exactly the kept documents
    docs = _ragged(800, vocab=1000, seed=4)
    got = [[] for _ in range(16)]

    def appender(i):
        for d in docs[i::16]:
            got[i].append((q.append(d), d))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=appender, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    kept = {p: d for g in got for p, d in g if p is not None}
    assert sorted(kept) == list(range(500))
    assert q.appended == 500 and q.dropped == 300
    for p, (ids, _) in zip(range(500), q.iter_from(0)):
        assert np.array_equal(ids, kept[p][0])
    assert q.num_words == sum(float(c.sum()) for _, c in kept.values())


def test_launch_counts_survive_concurrent_launchers():
    """The kernels' launch counters are bumped under a lock: a serving
    thread and a learner thread may launch at once."""
    from repro_torch.kernels import lda_estep
    lda_estep.reset_launches()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            lda_estep._count("fixed_point") for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert lda_estep.LAUNCHES["fixed_point"] == 16 * 2000
    lda_estep.reset_launches()
    assert sum(lda_estep.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# admission control: the same offer/poll/take/close sequence, both packages
# ---------------------------------------------------------------------------

LAYOUT_KW = {"padded": dict(batch_size=4, vocab_size=V, layout="padded",
                            token_budget=None),
             "csr": dict(batch_size=4, vocab_size=V, layout="csr",
                         token_budget=64)}


def _req(mod, rid, doc, arrival=0.0, deadline=math.inf):
    ids, cnts = doc
    return mod.Request(rid=rid, ids=ids, cnts=cnts, arrival_s=arrival,
                       deadline_s=deadline)


def _drive(mod, metrics, kw, ctl_kw, ops):
    """Run ``ops`` on one package's controller; returns everything it
    emitted, in order."""
    ac = mod.AdmissionController(kw, metrics=metrics, **ctl_kw)
    out = []
    for op, *a in ops:
        if op == "offer":
            rid, doc, now, deadline = a
            admitted, batch = ac.offer(
                _req(mod, rid, doc, arrival=now, deadline=deadline), now)
            out.append(("offer", admitted, [batch] if batch else []))
        elif op in ("poll", "close"):
            out.append((op, None, getattr(ac, op)(a[0])))
        elif op == "next_due":
            out.append(("next_due", ac.next_due(a[0]), []))
        elif op == "take":
            last = [b for _, _, bs in out for b in bs][a[1]]
            out.append(("take", [r.rid for r in ac.take(last.rows, a[0])],
                        []))
        out.append(("state", (ac.pending, ac.offered,
                              [r.rid for r in ac.shed]), []))
    return out


def _same_trace(kw, ctl_kw, ops):
    jm, tm = JMetrics(), MetricsRegistry()
    want = _drive(jserve, jm, kw, ctl_kw, ops)
    got = _drive(tserve, tm, kw, ctl_kw, ops)
    assert len(got) == len(want)
    for (op, g, gb), (wop, w, wb) in zip(got, want):
        assert op == wop and g == w, (op, g, w)
        _same_batches(wb, gb)
    for name in ("admit.admitted", "admit.shed", "admit.partial_flushes"):
        assert tm.total(name) == jm.total(name), name
    assert (tm.histogram_values("admit.queue_wait_ms")
            == jm.histogram_values("admit.queue_wait_ms"))
    return got


def _same_docs_of(n, n_tokens=6, seed=0):
    rng = np.random.default_rng(seed)
    return [(np.sort(rng.choice(V, size=n_tokens, replace=False))
             .astype(np.int32),
             (rng.poisson(1.0, n_tokens) + 1).astype(np.float32))
            for _ in range(n)]


INF = math.inf
ADMISSION_SCENARIOS = {
    # nothing pending: no flush, no horizon, an empty close
    "empty_window": (dict(flush_timeout_s=0.01),
                     [("poll", 1e9), ("next_due", 0.0), ("close", 0.0)]),
    # a bucket emits the moment it fills
    "full_bucket": (dict(flush_timeout_s=10.0),
                    [("offer", i, d, 0.0, INF) for i, d in
                     enumerate(_same_docs_of(4, seed=1))]
                    + [("take", 0.0, 0), ("close", 0.0)]),
    # the oldest request waited the timeout
    "timeout_flush": (dict(flush_timeout_s=0.05),
                      [("offer", 0, _ragged(1, seed=2)[0], 0.0, INF),
                       ("poll", 0.049), ("poll", 0.05), ("take", 0.05, 0),
                       ("poll", 1.0)]),
    # a request inside the shed margin is refused outright
    "shed": (dict(shed_margin_s=0.01),
             [("offer", 0, _ragged(1, seed=3)[0], 0.995, 1.0),
              ("offer", 1, _ragged(1, seed=3)[0], 0.5, 1.0),
              ("close", 0.6)]),
    # a near deadline flushes before the timeout
    "deadline_headroom": (dict(flush_timeout_s=10.0,
                               deadline_headroom_s=0.02),
                          [("offer", 0, _ragged(1, seed=4)[0], 0.0, 1.0),
                           ("poll", 0.5), ("poll", 0.985),
                           ("next_due", 0.0)]),
    # next_due is the sleep horizon, clamped to now once due
    "next_due": (dict(flush_timeout_s=0.05),
                 [("offer", 0, _ragged(1, seed=5)[0], 1.0, INF),
                  ("next_due", 1.0), ("next_due", 2.0)]),
}


@pytest.mark.parametrize("layout", ["padded", "csr"])
@pytest.mark.parametrize("scenario", sorted(ADMISSION_SCENARIOS))
def test_admission_scenarios_match_repro(scenario, layout):
    ctl_kw, ops = ADMISSION_SCENARIOS[scenario]
    got = _same_trace(LAYOUT_KW[layout], ctl_kw, ops)
    if scenario == "full_bucket":
        offers = [bs for op, _, bs in got if op == "offer"]
        assert [len(bs) for bs in offers] == [0, 0, 0, 1]


def test_admission_csr_over_budget_doc_serves_clipped():
    """An over-budget document at the head of a CSR flush is clipped to its
    most frequent tokens, never wedged: the same batch as ``repro``'s."""
    kw = dict(LAYOUT_KW["csr"], token_budget=16)
    ids = np.arange(40, dtype=np.int32)
    cnts = np.arange(1, 41, dtype=np.float32)
    got = _same_trace(kw, dict(flush_timeout_s=0.05),
                      [("offer", 0, (ids, cnts), 0.0, INF),
                       ("poll", 0.05), ("take", 0.05, 0)])
    batch = [b for _, _, bs in got for b in bs][0]
    assert set(batch.token_ids[batch.counts > 0]) == set(range(24, 40))


@pytest.mark.parametrize("layout", ["padded", "csr"])
@pytest.mark.parametrize("seed", [0, 1])
def test_admission_random_trace_matches_repro(layout, seed):
    """A seeded trace of offers (some inside their deadline's margin),
    polls, horizons and takes of every emitted batch, then a close."""
    rng = np.random.default_rng(seed)
    docs = _ragged(60, seed=seed + 20, max_n=40)
    ops, now, emitted = [], 0.0, 0
    for i, doc in enumerate(docs):
        now += float(rng.exponential(0.004))
        deadline = now + float(rng.choice([0.001, 0.05, INF]))
        ops += [("offer", i, doc, now, deadline), ("next_due", now),
                ("poll", now + float(rng.uniform(0, 0.01)))]
    ops.append(("close", now + 1.0))
    ctl_kw = dict(flush_timeout_s=0.01, shed_margin_s=0.002,
                  deadline_headroom_s=0.001)
    got = _same_trace(LAYOUT_KW[layout], ctl_kw, ops)
    emitted = sum(len(bs) for _, _, bs in got)
    assert emitted > 3
    # every batch taken, in emission order: the pending set drains
    ops += [("take", now + 1.0, i) for i in range(emitted)]
    got = _same_trace(LAYOUT_KW[layout], ctl_kw, ops)
    assert got[-1][1][0] == 0                  # nothing pending at the end


# ---------------------------------------------------------------------------
# snapshot publication
# ---------------------------------------------------------------------------

class FakeClock:
    """A clock that moves ``tick`` on every read and by the requested time
    on every sleep: two packages that read it alike see the same times."""

    def __init__(self, tick=1e-4):
        self.t, self.tick = 0.0, tick

    def __call__(self):
        self.t += self.tick
        return self.t

    def sleep(self, s):
        self.t += max(s, 0.0)


def test_snapshot_store_publish_matches_repro(lams):
    lam, lam2 = lams
    jcfg, cfg = _cfgs()
    jinf = JInferencer(jcfg, jnp.asarray(lam), batch_size=BATCH)
    inf = TopicInferencer(cfg, lam, batch_size=BATCH, device=CPU)
    jm, tm = JMetrics(), MetricsRegistry()
    jstore = jserve.SnapshotStore(jinf, metrics=jm, clock=FakeClock())
    store = tserve.SnapshotStore(inf, metrics=tm, clock=FakeClock())
    assert store.device == torch.device(CPU)
    assert store.current is None
    for i, x in enumerate((lam * 1.2, lam2)):
        w = jstore.publish(x, docs_trained=17 + i)
        g = store.publish(x, docs_trained=17 + i)
        assert g.version == w.version == inf.model_version == i + 1
        assert (g.docs_trained, g.published_s, g.swap_stall_s) == \
            (w.docs_trained, w.published_s, w.swap_stall_s)
        np.testing.assert_allclose(g.exp_elog_beta.numpy(),
                                   np.asarray(w.exp_elog_beta),
                                   rtol=0, atol=1e-6)
        assert inf.exp_elog_beta is g.exp_elog_beta
        assert store.current is g
    assert store.swap_stalls_ms() == jstore.swap_stalls_ms()
    assert tm.total("serve.publishes") == jm.total("serve.publishes") == 2
    assert (tm.histogram_values("serve.swap_stall_ms")
            == jm.histogram_values("serve.swap_stall_ms"))
    # a second replica picks up the next publish, at the same version
    other = TopicInferencer(cfg, lam, batch_size=BATCH, device=CPU)
    store.attach(other)
    snap = store.publish(lam)
    assert snap.version == 3 and other.model_version == 1
    assert torch.equal(other.exp_elog_beta, inf.exp_elog_beta)
    with pytest.raises(ValueError, match="no inferencer"):
        tserve.SnapshotStore(device=CPU).publish(lam)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tserve.SnapshotStore()


# ---------------------------------------------------------------------------
# the serving loop under one injected clock
# ---------------------------------------------------------------------------

def _scenario(name, docs):
    n = len(docs)
    if name == "replay":
        return tserve.replay_arrivals(n), math.inf, 0.0
    if name == "poisson":
        return tserve.poisson_arrivals(n, 300.0, seed=0), math.inf, 0.0
    if name == "onoff":
        return (tserve.onoff_arrivals(n, 900.0, on_s=0.01, off_s=0.03,
                                      seed=1), math.inf, 0.0)
    # deadlines: every third request arrives already expired (below)
    return tserve.poisson_arrivals(n, 300.0, seed=2), 0.05, 0.001


def _serve(mod, inf, reqs, flush_s, margin_s):
    clock = FakeClock()
    svc = mod.ServingService(
        inf, config=mod.ServiceConfig(flush_timeout_s=flush_s,
                                      shed_margin_s=margin_s,
                                      slo_ms={"p95": 50.0, "p99": 1e6}),
        clock=clock, sleep=clock.sleep)
    batches = []
    real = svc._serve_batch

    def record(batch):
        batches.append(batch)
        real(batch)

    svc._serve_batch = record
    return svc, svc.run(reqs), batches


def _requests(mod, docs, arrivals, deadline):
    reqs = mod.requests_from_docs(docs, arrivals, deadline_s=deadline)
    if deadline < math.inf:
        for r in reqs[::3]:
            r.deadline_s = r.arrival_s
    return reqs


@pytest.mark.parametrize("backend", ["gather", "cuda"])
@pytest.mark.parametrize("layout", ["padded", "csr"])
@pytest.mark.parametrize("scenario", ["replay", "poisson", "onoff",
                                      "deadline"])
def test_service_matches_repro(lams, scenario, layout, backend):
    lam = lams[0]
    jcfg, cfg = _cfgs(backend)
    kw = dict(batch_size=BATCH, layout=layout)
    if layout == "csr":
        kw["token_budget"] = 96
    docs = _ragged(29, seed=14)
    arrivals, deadline, margin = _scenario(scenario, docs)
    jinf = JInferencer(jcfg, jnp.asarray(lam), **kw)
    inf = TopicInferencer(cfg, lam, device=CPU, **kw)
    flush_s = 0.01
    jsvc, jresp, jbatches = _serve(jserve, jinf,
                                   _requests(jserve, docs, arrivals,
                                             deadline), flush_s, margin)
    svc, resp, batches = _serve(tserve, inf,
                                _requests(tserve, docs, arrivals, deadline),
                                flush_s, margin)
    _same_batches(jbatches, batches)
    assert [(r.rid, r.status, r.model_version, r.arrival_s, r.done_s)
            for r in resp] == \
        [(r.rid, r.status, r.model_version, r.arrival_s, r.done_s)
         for r in jresp]
    shed = {r.rid for r in resp if r.status == "shed"}
    assert shed == {r.rid for r in jsvc.admission.shed}
    assert all(r.gamma is None for r in resp if r.rid in shed)
    if scenario == "deadline":
        assert 0 < len(shed) < len(docs)
    else:
        assert not shed
    if scenario in ("poisson", "onoff"):
        assert svc.metrics.total("admit.partial_flushes") > 0
    jg = {r.rid: np.asarray(r.gamma) for r in jresp if r.ok}
    for r in resp:
        if r.ok:
            assert r.gamma.dtype == np.float32
            np.testing.assert_allclose(r.gamma, jg[r.rid], **TOL)
    # each served batch's γ is the port's own posterior_packed of it;
    # admission positions count the admitted requests in offer order
    rid_of = [r.rid for r in sorted(resp, key=lambda r: r.rid)
              if r.rid not in shed]
    by_rid = {r.rid: r for r in resp}
    for batch in batches:
        _, gamma, n, _ = inf.posterior_packed(batch)
        served = np.stack([by_rid[rid_of[p]].gamma for p in batch.rows])
        np.testing.assert_array_equal(served, gamma[:n].numpy())
    rep, jrep = svc.slo_report(), jsvc.slo_report()
    assert json.dumps(rep, sort_keys=True) == \
        json.dumps(jrep, sort_keys=True)
    jserve.validate_slo_report(rep)
    tserve.validate_slo_report(jrep)
    for name in ("serve.batches", "serve.docs", "serve.shed"):
        assert svc.metrics.total(name) == jsvc.metrics.total(name), name
    if scenario == "replay":
        # one burst, one flush at the close: the offline packing exactly
        offline = inf.posterior_docs(docs)
        for r in resp:
            np.testing.assert_array_equal(r.gamma, offline[r.rid])


def test_service_telemetry_span_and_refusals(lams):
    """One ``serve/request_batch`` span a served batch, as ``repro``'s."""
    _, cfg = _cfgs("cuda")
    tel = Telemetry()
    inf = TopicInferencer(cfg, lams[0], batch_size=BATCH, device=CPU)
    clock = FakeClock()
    svc = tserve.ServingService(inf, telemetry=tel, clock=clock,
                                sleep=clock.sleep)
    docs = _ragged(13, seed=3)
    svc.run(tserve.requests_from_docs(docs, tserve.replay_arrivals(13)))
    spans = [r for r in tel.trace.records
             if r.get("name") == "serve/request_batch"]
    assert len(spans) == svc.metrics.total("serve.batches") >= 2
    assert svc.metrics is tel.metrics
    rep = svc.slo_report()
    for bad in (dict(rep, schema="bogus/v0"),
                dict(rep, served=rep["served"] + 1, conservation_ok=False),
                dict(rep, latency_ms={"p50": 1.0}),
                dict(rep, offered="3")):
        for validate in (tserve.validate_slo_report,
                         jserve.validate_slo_report):
            with pytest.raises(ValueError):
                validate(bad)
    assert tserve.SLO_SCHEMA == jserve.SLO_SCHEMA == "repro.serve.slo/v1"


# ---------------------------------------------------------------------------
# the online learner
# ---------------------------------------------------------------------------

def _learners(lam0, **kw):
    jcfg, cfg = _cfgs(iters=40)
    jinf = JInferencer(jcfg, jnp.asarray(lam0), batch_size=BATCH)
    inf = TopicInferencer(cfg, lam0, batch_size=BATCH, device=CPU)
    jl = jserve.OnlineLearner(jcfg, jserve.SnapshotStore(jinf), lam0=lam0,
                              watchdog=JWatchdog(policy="warn"), **kw)
    tl = tserve.OnlineLearner(cfg, tserve.SnapshotStore(inf), lam0=lam0,
                              watchdog=ElboWatchdog(policy="warn"),
                              device=CPU, **kw)
    return (jl, jinf), (tl, inf)


def test_online_learner_matches_repro(lams):
    """The same gating, versions and armed readings, and λ within 1e-3 of
    ``repro``'s, through a forced update, a gated one and ``drain(2)``."""
    lam0 = lams[0]
    docs = _ragged(30, seed=13, max_n=30)
    out = {}
    for key, (learner, inf) in zip(("repro", "port"), _learners(
            lam0, capacity=24, max_unique=12, batch_size=BATCH,
            min_new_docs=4, seed=0)):
        steps = [learner.update_once(), learner.update_once(force=True)]
        learner.observe(docs[:10])
        steps.append(learner.update_once(force=True))
        learner.observe(docs[10:12])
        steps.append(learner.update_once())          # 2 < min_new_docs
        learner.observe(docs[12:])                   # 6 of 18 dropped
        steps.append(learner.update_once())
        steps += learner.drain(2)
        out[key] = dict(
            steps=steps, updates=learner.updates,
            armed=learner.armed_observations,
            trained=learner.docs_trained, dropped=learner.stream.dropped,
            versions=[s.version for s in learner.store.history],
            readings=[(r["step"], r["armed"])
                      for r in learner.watchdog.history],
            bounds=[r["bound"] for r in learner.watchdog.history],
            violations=len(learner.watchdog.violations),
            lam=np.asarray(learner.model.lam),
            eb=np.asarray(inf.exp_elog_beta), version=inf.model_version)
    j, t = out["repro"], out["port"]
    assert t["steps"] == j["steps"] == [None, None, 1, None, 2, 3, 4]
    for k in ("updates", "armed", "trained", "dropped", "versions",
              "readings", "violations", "version"):
        assert t[k] == j[k], k
    assert t["armed"] >= 1 and t["violations"] == 0 and t["dropped"] == 6
    np.testing.assert_allclose(t["lam"], j["lam"], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(t["eb"], j["eb"], rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(t["bounds"], j["bounds"], rtol=1e-4)


def test_online_learner_background_thread(lams):
    """``start``/``stop`` on the CPU: the cadence publishes, ``stop`` joins
    within its timeout, and a second start is refused."""
    _, (learner, inf) = _learners(lams[0], batch_size=BATCH, cadence_s=0.01,
                                  min_new_docs=4)
    learner.observe(_ragged(12, seed=21))
    with learner:
        with pytest.raises(ValueError, match="already started"):
            learner.start()
        t0 = time.perf_counter()
        while inf.model_version == 0 and time.perf_counter() - t0 < 60:
            time.sleep(0.01)
    assert learner._thread is None and inf.model_version >= 1
    learner.stop(timeout=1.0)                     # idempotent
    if not torch.cuda.is_available():             # the card unless named
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tserve.OnlineLearner(learner.cfg, learner.store)


def test_service_online_versions_match_repro(lams):
    """The service with the learner, as ``repro``'s end-to-end test: two
    waves with a synchronous update between (the swap lands mid-stream
    deterministically), then ``drain(2)``. The same versions on every
    response as ``repro``'s, each batch's γ its version's snapshot's."""
    lam0 = lams[0]
    docs = _ragged(24, seed=18)
    arrivals = tserve.poisson_arrivals(len(docs), 400.0, seed=0)
    runs = {}
    for key, mod, (learner, inf) in zip(("repro", "port"), (jserve, tserve),
                                        _learners(lam0, batch_size=BATCH,
                                                  min_new_docs=4, seed=0)):
        clock = FakeClock()
        svc = mod.ServingService(
            inf, config=mod.ServiceConfig(flush_timeout_s=0.005),
            learner=learner, clock=clock, sleep=clock.sleep)
        batches = []
        real = svc._serve_batch

        def record(batch, real=real, svc=svc, batches=batches):
            n0 = len(svc.responses)
            real(batch)
            batches.append((batch, svc.responses[n0:]))

        svc._serve_batch = record
        reqs = mod.requests_from_docs(docs, arrivals)
        svc.run(reqs[:12])
        assert learner.update_once(force=True) == 1
        svc.run(reqs[12:])
        learner.drain(2)
        rep = mod.validate_slo_report(svc.slo_report())
        runs[key] = (svc, learner, inf, batches, rep)
    (jsvc, jl, _, _, jrep), (svc, tl, inf, batches, rep) = \
        runs["repro"], runs["port"]
    assert [(r.rid, r.model_version) for r in svc.responses] == \
        [(r.rid, r.model_version) for r in jsvc.responses]
    assert rep["every_response_versioned"]
    assert rep["model_versions"] == jrep["model_versions"] == [0, 1]
    assert tl.store.current.version == inf.model_version == 3
    assert max(tl.store.swap_stalls_ms()) < 50.0
    # each batch's γ against a fresh solve on its version's snapshot
    _, cfg = _cfgs(iters=40)
    snaps = {0: TopicInferencer(cfg, lam0, batch_size=BATCH, device=CPU)}
    for snap in tl.store.history:
        ref = TopicInferencer(cfg, lam0, batch_size=BATCH, device=CPU)
        ref.swap_model(exp_elog_beta=snap.exp_elog_beta,
                       version=snap.version)
        snaps[snap.version] = ref
    for batch, responses in batches:
        version = responses[0].model_version
        assert {r.model_version for r in responses} == {version}
        _, gamma, n, v = snaps[version].posterior_packed(batch)
        assert v == version
        np.testing.assert_array_equal(np.stack([r.gamma for r in responses]),
                                      gamma[:n].numpy())
    jg = {r.rid: np.asarray(r.gamma) for r in jsvc.responses}
    for r in svc.responses:
        np.testing.assert_allclose(r.gamma, jg[r.rid], **TOL)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def repro_ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("serve") / "repro_ckpt")
    train = j_make_corpus(J_CORPORA["tiny"], split="train", seed=0,
                          scale=0.25)
    JLDA(num_topics=K, vocab_size=V, estep_max_iters=10, algo="ivi",
         seed=0).fit(train, epochs=1).save(path)
    return path


@pytest.mark.parametrize("extra", [
    [],
    ["--traffic", "poisson", "--rate", "2000", "--online",
     "--cadence-s", "0.005", "--layout", "csr", "--backend", "cuda",
     "--trace", "TMP/run.jsonl", "--metrics-json", "TMP/m.json"],
])
def test_serve_lda_launcher_from_repro_checkpoint(repro_ckpt, tmp_path,
                                                  capsys, extra):
    from repro_torch.launch import serve_lda
    from repro_torch.obs import load_jsonl
    out = str(tmp_path / "serve.jsonl")
    extra = [a.replace("TMP", str(tmp_path)) for a in extra]
    serve_lda.main(["--device", "cpu", "--corpus", "tiny", "--ckpt",
                    repro_ckpt, "--requests", "3", "--batch", "8",
                    "--slo-p95-ms", "1e6", "--out", out,
                    "--ragged"] + extra)
    text = capsys.readouterr().out
    assert f"topics from {repro_ckpt}: V={V} K={K}" in text
    assert "deprecated no-ops" in text
    rec = json.loads(open(out).read().splitlines()[-1])
    rep = rec["slo_report"]
    tserve.validate_slo_report(rep)
    jserve.validate_slo_report(rep)
    assert rep["served"] == rep["offered"] == 24 and rep["shed"] == 0
    assert rec["device"] == "cpu" and rec["online"] == ("--online" in extra)
    assert rep["slo"]["p95"]["attained"]
    if "--online" in extra:
        assert rec["layout"] == "csr" and rec["backend"] == "cuda"
        updates = int(text.split(" online updates")[0].rsplit("(", 1)[1])
        assert updates >= 2                  # drain's passes at least
        _, records = load_jsonl(str(tmp_path / "run.jsonl"))
        spans = [r for r in records if r.get("name") ==
                 "serve/request_batch"]
        assert spans and all(r["attrs"]["docs"] >= 1 for r in spans)
        metrics = json.loads(open(tmp_path / "m.json").read())
        assert "serve.latency_ms" in json.dumps(metrics)


def test_serve_lda_dryrun_names_its_roadmap_item(capsys, tmp_path):
    """``--dryrun`` (ROADMAP item 9, done) runs the serving batch at the
    Arxiv shape on ``meta`` tensors and prints ``repro``'s summary line;
    ``--out`` appends its record."""
    from repro_torch.launch import serve_lda
    out = tmp_path / "dry.jsonl"
    serve_lda.main(["--dryrun", "--out", str(out)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[OK ] lda-serve arxiv  compile=")
    assert "widths=[32, 64, 128]" in line and "jit_entries=3" in line
    rec = json.loads(out.read_text().splitlines()[-1])
    assert rec["ok"] and rec["device"] == "meta" and rec["shape"] == "b32"
    assert all(m["launches"] == 1 for m in rec["memory"].values())
