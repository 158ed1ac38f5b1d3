"""Port parity, D-IVI (the paper's §4, P workers simulated on one device):
`repro_torch.dist` against ``repro.dist``'s vmap path, from one λ₀.

* The round's inputs (drop coins, the workers' packed batches, their memo
  rows) are ``repro``'s bit for bit.
* One round on the ``gather`` backend: the worker memos at rtol 1e-5 /
  atol 1e-4, λ and ⟨m_vk⟩ at rtol = atol = 1e-4. Both packages run the
  same fp32 fixed point and stop rule and only sum in other orders, but
  here the fixed point runs to its 40-sweep cap and the difference grows
  with the sweeps: one single-host gather E-step of 16 of these documents
  already differs by 4.7e-4 in its sstats (entries up to 37), and λ and
  ⟨m_vk⟩ after a round by 2.2e-5 to 2.9e-5 relative. With P = 1, S = 1 a
  round is the single-host S-IVI step: the port's ``sivi_step`` on a raw
  ``Memo`` bit for bit, and ``repro``'s at the same bars.
* The fully delayed round and the staleness bookkeeping match ``repro``.
* Four rounds at P = 4, S = 2, half the sub-rounds dropped: λ at
  ``tests/test_torch_engine.py``'s trajectory bar, rtol = atol = 1e-3.
* The ``cuda`` backend's CPU twin (K1's grouped stop at B = 12, where one
  128-row tile would hold four workers) against ``repro``'s ``pallas``
  backend in interpret mode under vmap: the correction (⟨m_vk⟩ after the
  first round) at rtol = atol = 2e-3, the bars of
  ``tests/test_estep_backend.py``.
* The trainer, the facade and checkpoints: the memoized bound against
  ``repro``'s on one state, a mid-run save → resume bit-equal inside the
  port, each package resuming the other's checkpoint within 1e-3, the
  launcher.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import LDAConfig as JConfig
from repro.core.engines import sivi_step as j_sivi_step
from repro.core.types import Memo as JMemo
from repro.core.types import init_global_state as j_init_global_state
from repro.data import PAPER_CORPORA as J_CORPORA
from repro.data import make_corpus as j_make_corpus
from repro.dist import DIVIConfig as JDIVIConfig
from repro.dist import DIVIEngine as JDIVIEngine
from repro.lda import LDA as JLDA
from repro.lda.trainer import DIVITrainer as JDIVITrainer
from repro_torch.convert import state_from_numpy
from repro_torch.core.engines import ivi_step, sivi_step
from repro_torch.core.estep import BowBatch, EStepBackend, get_backend
from repro_torch.core.math import exp_dirichlet_expectation
from repro_torch.core.types import LDAConfig, init_memo
from repro_torch.data.stream import CorpusDocStream, ShardedDocStream
from repro_torch.data.synthetic import PAPER_CORPORA, make_corpus
from repro_torch.dist import DIVIConfig, DIVIEngine
from repro_torch.kernels import lda_estep
from repro_torch.lda import LDA
from repro_torch.lda.trainer import DIVITrainer

CPU = "cpu"
SPEC = PAPER_CORPORA["tiny"]
FIELDS = ("lam", "m_vk", "init_mass", "init_frac", "t")


@pytest.fixture(scope="module")
def corpora():
    return (make_corpus(SPEC, seed=0, device=CPU),
            make_corpus(SPEC, split="test", seed=0, device=CPU),
            j_make_corpus(J_CORPORA["tiny"], seed=0))


@pytest.fixture
def world1_mesh(tmp_path):
    """A (1, 1) CPU mesh over a one-process gloo group in this process."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield make_host_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def _cfgs(backend="gather", jbackend="gather", **kw):
    kw.setdefault("estep_max_iters", 40)
    return (JConfig(num_topics=8, vocab_size=SPEC.vocab_size,
                    estep_backend=jbackend, **kw),
            LDAConfig(num_topics=8, vocab_size=SPEC.vocab_size,
                      estep_backend=backend, **kw))


def _pair(corpora, seed=0, backend="gather", jbackend="gather", **dkw):
    """The same D-IVI engine in both packages, from ``repro``'s λ₀."""
    train, _, jtrain = corpora
    jcfg, cfg = _cfgs(backend, jbackend)
    jeng = JDIVIEngine(jcfg, JDIVIConfig(**dkw), jtrain, seed=seed)
    lam0 = np.asarray(jeng.state.lam).copy()
    eng = DIVIEngine(cfg, DIVIConfig(**dkw), train, seed=seed, device=CPU,
                     lam0=lam0)
    return jeng, eng


def _close(eng, jeng, rtol, atol, fields=("lam", "m_vk")):
    # repro's rounds donate their inputs: read its arrays after the round
    for f in fields:
        np.testing.assert_allclose(getattr(eng.state, f).numpy(),
                                   np.asarray(getattr(jeng.state, f)),
                                   rtol=rtol, atol=atol, err_msg=f)


# ---------------------------------------------------------------------------
# the round's inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("partitioner", ["range", "hash"])
def test_round_inputs_are_repros(corpora, partitioner):
    """Coins, batches and memo rows of three rounds, bit for bit: the port
    keeps the live (worker, sub-round) slots, sub-round-major, where
    ``repro`` zero-fills the dropped ones."""
    jeng, eng = _pair(corpora, num_workers=3, batch_size=8, staleness=2,
                      delay_prob=0.3, partitioner=partitioner,
                      partition_seed=5)
    for _ in range(3):
        jids, jcnts, jidx, jdelay = jeng._ingest_round()
        ids, cnts, rows, delay = eng._ingest_round()
        np.testing.assert_array_equal(delay, jdelay)
        live = [(i, j) for j in range(2) for i in range(3)
                if not jdelay[i, j]]
        assert ids.shape[0] == len(live)
        for k, (i, j) in enumerate(live):
            np.testing.assert_array_equal(ids[k], jids[i, j])
            np.testing.assert_array_equal(cnts[k], jcnts[i, j])
            np.testing.assert_array_equal(
                rows[k], i * eng.docs_per_worker + jidx[i, j])
    for a, b in zip(eng.ingest, jeng.ingest):
        assert a.capture()[0] == b.capture()[0]


# ---------------------------------------------------------------------------
# one round, one step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("staleness", [1, 2])
def test_one_round_matches_repro(corpora, staleness):
    jeng, eng = _pair(corpora, num_workers=4, batch_size=16,
                      staleness=staleness)
    jeng.run_round()
    eng.run_round()
    _close(eng, jeng, 1e-4, 1e-4)
    np.testing.assert_allclose(eng.shard.pi.numpy(),
                               np.asarray(jeng.shard.pi), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(eng.shard.visited.numpy(),
                                  np.asarray(jeng.shard.visited))
    assert float(eng.state.init_frac) == pytest.approx(
        float(jeng.state.init_frac), abs=1e-6)
    assert int(eng.state.t) == int(jeng.state.t) == staleness
    assert eng.docs_seen == jeng.docs_seen == 4 * 16 * staleness


def test_single_worker_round_equals_sivi_step(corpora):
    """P = 1, S = 1, no drops: one round is the S-IVI step on documents
    0 … B−1 (the range shard of one worker is the corpus in order), the
    port's own ``sivi_step`` on a raw ``Memo`` bit for bit, and
    ``repro``'s at the module's bars."""
    train, _, jtrain = corpora
    jeng, eng = _pair(corpora, num_workers=1, batch_size=16)
    eng.run_round()
    jcfg, cfg = _cfgs()
    lam0 = np.asarray(jeng.state.lam).copy()
    ref = state_from_numpy({f: np.asarray(getattr(
        j_init_global_state(jcfg, jax.random.key(0)), f)) for f in FIELDS},
        CPU)
    np.testing.assert_array_equal(ref.lam.numpy(), lam0)
    memo = init_memo(cfg, train.num_docs, train.max_unique, device=CPU)
    rows = torch.arange(16)
    nw = torch.tensor(float(train.counts.numpy().sum()))
    ref, memo = sivi_step(cfg, ref, memo, train.token_ids[rows],
                          train.counts[rows], rows, nw)
    for f in FIELDS:
        assert torch.equal(getattr(eng.state, f), getattr(ref, f)), f
    assert torch.equal(eng.shard.pi[0][rows], memo.pi[rows])
    # and repro's step on the same inputs
    jref = j_init_global_state(jcfg, jax.random.key(0))
    jmemo = JMemo(pi=jax.numpy.zeros((train.num_docs, train.max_unique, 8)),
                  visited=jax.numpy.zeros((train.num_docs,), bool))
    jrows = jax.numpy.arange(16)
    jref, jmemo = j_sivi_step(jcfg, jref, jmemo, jtrain.token_ids[jrows],
                              jtrain.counts[jrows], jrows,
                              jax.numpy.asarray(float(nw)))
    np.testing.assert_allclose(eng.state.lam.numpy(), np.asarray(jref.lam),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(eng.shard.pi[0][:16].numpy(),
                               np.asarray(jmemo.pi[:16]), rtol=1e-5,
                               atol=1e-4)
    assert int(eng.state.t) == int(jref.t) == 1


@pytest.mark.parametrize("step,averaged", [(ivi_step, False),
                                           (sivi_step, True)])
def test_raw_memo_steps_match_repro(corpora, step, averaged):
    """``ivi_step`` / ``sivi_step`` on a raw ``Memo``: two steps on
    overlapping rows against ``repro``'s, at the module's bars."""
    from repro.core.engines import ivi_step as j_ivi_step
    train, _, jtrain = corpora
    jcfg, cfg = _cfgs()
    jstate = j_init_global_state(jcfg, jax.random.key(3))
    state = state_from_numpy({f: np.asarray(getattr(jstate, f))
                              for f in FIELDS}, CPU)
    jstep = j_sivi_step if averaged else j_ivi_step
    memo = init_memo(cfg, train.num_docs, train.max_unique, device=CPU)
    jmemo = JMemo(pi=jax.numpy.zeros((train.num_docs, train.max_unique, 8)),
                  visited=jax.numpy.zeros((train.num_docs,), bool))
    nw = float(train.counts.numpy().sum())
    for lo in (0, 8):
        rows = np.arange(lo, lo + 16)
        state, memo = step(cfg, state, memo, train.token_ids[rows],
                           train.counts[rows], torch.from_numpy(rows),
                           torch.tensor(nw))
        jstate, jmemo = jstep(jcfg, jstate, jmemo, jtrain.token_ids[rows],
                              jtrain.counts[rows], jax.numpy.asarray(rows),
                              jax.numpy.asarray(nw))
    np.testing.assert_allclose(state.lam.numpy(), np.asarray(jstate.lam),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(memo.pi.numpy(), np.asarray(jmemo.pi),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(memo.visited.numpy(),
                                  np.asarray(jmemo.visited))


def test_fully_delayed_round_matches_repro(corpora):
    """Every worker drops every sub-round: no correction, no visit, no
    retired mass, no document pulled, and the master still updates once a
    sub-round (t = S), λ decaying toward β₀ + ⟨m_vk⟩ as ``repro``'s."""
    jeng, eng = _pair(corpora, num_workers=2, batch_size=8, staleness=2,
                      delay_prob=1.0)
    lda_estep.reset_launches()
    jeng.run_round()
    eng.run_round()
    assert not bool(eng.shard.visited.any())
    assert torch.equal(eng.state.m_vk, torch.zeros_like(eng.state.m_vk))
    assert float(eng.state.init_frac) == 1.0
    assert int(eng.state.t) == int(jeng.state.t) == 2
    assert all(ing.cursor == 0 and ing.docs_pulled == 0
               for ing in eng.ingest)
    assert eng.docs_seen == jeng.docs_seen == 0
    _close(eng, jeng, 1e-5, 1e-5)


def test_staleness_processes_s_batches_per_round(corpora):
    _, eng = _pair(corpora, num_workers=2, batch_size=8, staleness=3)
    eng.run_round()
    assert int(eng.state.t) == 3
    assert eng.docs_seen == 2 * 3 * 8
    assert all(ing.docs_pulled == 3 * 8 for ing in eng.ingest)


def test_init_mass_retired_exactly_after_one_cover(corpora):
    """P = 4, B = 24: one round visits all 96 documents, after which
    init_frac is exactly 0 and λ = β₀ + ⟨m_vk⟩ at the λ̂ level."""
    _, eng = _pair(corpora, num_workers=4, batch_size=24)
    eng.run_round()
    assert bool(eng.shard.visited.all())
    assert float(eng.state.init_frac) == 0.0


# ---------------------------------------------------------------------------
# longer runs, determinism
# ---------------------------------------------------------------------------

def test_longer_run_tracks_repro(corpora):
    """Four rounds at P = 4, S = 2, delay_prob = 0.5: λ within 1e-3."""
    jeng, eng = _pair(corpora, seed=2, num_workers=4, batch_size=16,
                      staleness=2, delay_prob=0.5)
    for _ in range(4):
        jeng.run_round()
        eng.run_round()
        assert eng.docs_seen == jeng.docs_seen
    _close(eng, jeng, 1e-3, 1e-3, fields=("lam",))
    np.testing.assert_array_equal(eng.shard.visited.numpy(),
                                  np.asarray(jeng.shard.visited))
    assert int(eng.state.t) == int(jeng.state.t) == 8


@pytest.mark.parametrize("partitioner", ["range", "hash"])
def test_deterministic_and_stream_fed_bit_equal(corpora, partitioner):
    """Same seed, same bits: a second engine, and one fed a ``DocStream``
    where the first was fed the padded corpus."""
    train, _, _ = corpora
    _, cfg = _cfgs()
    dcfg = DIVIConfig(num_workers=4, batch_size=8, staleness=2,
                      delay_prob=0.3, partitioner=partitioner,
                      partition_seed=5)
    a = DIVIEngine(cfg, dcfg, train, seed=3, device=CPU)
    b = DIVIEngine(cfg, dcfg, CorpusDocStream(train), seed=3, device=CPU)
    for _ in range(4):
        a.run_round()
        b.run_round()
    assert a.docs_seen == b.docs_seen
    assert torch.equal(a.state.lam, b.state.lam)
    assert torch.equal(a.shard.pi, b.shard.pi)
    assert torch.equal(a.shard.visited, b.shard.visited)


# ---------------------------------------------------------------------------
# the cuda backend's grouped stop
# ---------------------------------------------------------------------------

def test_grouped_twin_stops_each_worker_alone(corpora):
    """K1's twin with ``group``: four 12-row workers stacked, the even ones
    warm and the odd ones cold, stop exactly as four separate batches; as
    one 48-row tile they would stop together."""
    train, _, _ = corpora
    ids = train.token_ids[:48].contiguous()
    cnts = train.counts[:48].contiguous()
    lam = torch.from_numpy(np.random.default_rng(0).gamma(
        100.0, 0.01, (SPEC.vocab_size, 8)).astype(np.float32))
    eb = exp_dirichlet_expectation(lam, axis=0)
    cold = torch.full((48, 8), 1.5)
    near = lda_estep.estep_fixed_point_plain(ids, cnts, eb, cold, 0.5, 0.0,
                                             150)[0]
    even = (torch.arange(48) // 12) % 2 == 0
    gamma0 = torch.where(even[:, None], near, cold).contiguous()
    args = (ids, cnts, eb, gamma0, 0.5, 1e-2, 60)
    got = lda_estep.estep_fixed_point_pi(*args, group=12)
    for w in range(4):
        sl = slice(12 * w, 12 * w + 12)
        alone = lda_estep.estep_fixed_point_pi(
            ids[sl], cnts[sl], eb, gamma0[sl].contiguous(), *args[4:])
        assert torch.equal(got[0][sl], alone[0])
        assert torch.equal(got[3][sl], alone[3])
        assert torch.equal(got[2][w:w + 1], alone[2])
    assert got[2].tolist() == [1, 60, 1, 60]
    assert lda_estep.estep_fixed_point(*args)[2].tolist() == [60]
    with pytest.raises(ValueError, match="does not divide"):
        lda_estep.estep_fixed_point(*args, group=10)


def test_cuda_grouped_correction_equals_worker_loop(corpora):
    """``CudaBackend.solve_correction_grouped`` (one K1, one K3) against the
    default loop over the workers (one ``solve_correction`` each, the sum
    group by group): π bit for bit, the summed correction within 1e-5
    (K3 adds all workers' rows of an id in one sum)."""
    train, _, _ = corpora
    _, cfg = _cfgs("cuda")
    rows = np.arange(48)
    ids, cnts = train.token_ids[rows], train.counts[rows]
    lam = torch.from_numpy(np.random.default_rng(1).gamma(
        100.0, 0.01, (SPEC.vocab_size, 8)).astype(np.float32))
    eb = exp_dirichlet_expectation(lam, axis=0)
    old = torch.rand((48, ids.shape[1], 8),
                     generator=torch.Generator().manual_seed(0))
    old = torch.where(cnts[:, :, None] > 0, old / old.sum(-1, keepdim=True),
                      0.0)
    visited = (torch.arange(48) % 3) != 0
    backend = get_backend("cuda")
    got = backend.solve_correction_grouped(cfg, eb, BowBatch(ids, cnts), old,
                                           visited, 12)
    want = EStepBackend.solve_correction_grouped(
        backend, cfg, eb, BowBatch(ids, cnts), old, visited, 12)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    assert float(got[1]) == pytest.approx(float(want[1]), rel=1e-6)
    assert torch.equal(got[2].pi, want[2].pi)
    assert torch.equal(got[2].gamma, want[2].gamma)


def test_cuda_twin_round_matches_pallas_under_vmap(corpora):
    """The port's ``cuda`` backend (its CPU twins: K1 grouped, one group a
    worker) against ``repro``'s ``pallas`` backend in interpret mode under
    vmap, P = 4 at B = 12: after the first round ⟨m_vk⟩ is the summed
    correction, held at rtol = atol = 2e-3; λ and the memo likewise."""
    jeng, eng = _pair(corpora, backend="cuda", jbackend="pallas",
                      num_workers=4, batch_size=12)
    jeng.run_round()
    eng.run_round()
    _close(eng, jeng, 2e-3, 2e-3)
    np.testing.assert_allclose(eng.shard.pi.numpy(),
                               np.asarray(jeng.shard.pi), rtol=2e-3,
                               atol=2e-3)


# ---------------------------------------------------------------------------
# trainer, facade, checkpoints, launcher
# ---------------------------------------------------------------------------

def test_full_bound_matches_repro(corpora):
    """The memoized bound over the worker memos, on one state: ``repro``'s
    trainer state restored into the port's (the cross-package hand-over),
    the two bounds within rtol 1e-5."""
    train, _, jtrain = corpora
    jcfg, cfg = _cfgs()
    dkw = dict(num_workers=3, batch_size=8, staleness=2)
    jtr = JDIVITrainer(jcfg, JDIVIConfig(**dkw), jtrain, seed=1)
    for _ in range(3):
        jtr.run_pass()
    meta, arrays = jtr.capture()
    tr = DIVITrainer(cfg, DIVIConfig(**dkw), train, seed=1, device=CPU)
    tr.restore(meta, arrays)
    assert tr.full_bound() == pytest.approx(jtr.full_bound(), rel=1e-5)
    assert tr.docs_seen == jtr.docs_seen


def test_facade_trains_scores_saves_and_resumes(corpora, tmp_path):
    """``LDA(algo="divi")`` on the CPU: fit(rounds=) with held-out LPP,
    then a mid-run save → load → resume bit-equal to the run that never
    stopped; the telemetry counters of the rounds."""
    from repro_torch.obs import Telemetry
    train, test, _ = corpora
    _, cfg = _cfgs()
    dcfg = DIVIConfig(num_workers=4, batch_size=8, staleness=2,
                      delay_prob=0.25, partitioner="hash")
    tel = Telemetry()
    a = LDA(cfg, algo="divi", distributed=dcfg, seed=4, telemetry=tel,
            device=CPU)
    a.fit(train, rounds=3, test_corpus=test, eval_every=3)
    assert np.isfinite(a.history.lpp[-1]) and np.isfinite(a.score(test))
    assert tel.metrics.total("divi.rounds") == 3
    assert tel.metrics.total("divi.docs") == a.docs_seen
    path = os.path.join(tmp_path, "ck")
    a.save(path)
    a.partial_fit(steps=3)
    b = LDA.load(path, device=CPU)
    assert b.distributed == dcfg and b.algo == "divi"
    b.resume(train).partial_fit(steps=3)
    for f in FIELDS:
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    assert torch.equal(a.trainer.eng.shard.pi, b.trainer.eng.shard.pi)
    assert a.docs_seen == b.docs_seen
    assert np.isfinite(b.bound())


def test_facade_refusals_in_repros_words(corpora, tmp_path):
    train, _, _ = corpora
    _, cfg = _cfgs()
    lda = LDA(cfg, algo="divi", distributed=DIVIConfig(num_workers=2,
                                                       batch_size=8),
              device=CPU).partial_fit(train, steps=0)
    with pytest.raises(ValueError, match="seed a distributed run"):
        lda.warm_start(np.ones((SPEC.vocab_size, 8), np.float32))
    with pytest.raises(ValueError, match="rounds= applies"):
        LDA(cfg, algo="sivi", device=CPU).fit(train, rounds=1)
    sharded = ShardedDocStream(CorpusDocStream(train), 2)
    with pytest.raises(ValueError, match="distributed ingest form"):
        LDA(cfg, algo="sivi", device=CPU).fit(sharded)
    with pytest.raises(ValueError, match="data_axes names axes of a mesh"):
        LDA(cfg, algo="divi", data_axes=("data",), device=CPU)
    # a tune store is accepted: one lookup at the per-worker batch shape
    # (one tune.cache hit), and the workers' engine runs the policy
    from repro_torch.core.types import KernelPolicy
    from repro_torch.obs import Telemetry
    from repro_torch.tune import PolicyKey, PolicyStore
    store = PolicyStore(os.path.join(tmp_path, "store.json"))
    pol = KernelPolicy(double_buffer_depth=3)
    store.put(PolicyKey(backend="cuda", layout="padded", b_or_t=8,
                        v=SPEC.vocab_size, k=8, w=train.max_unique,
                        device_kind="cpu:cpu"), pol)
    tel = Telemetry()
    tuned = LDA(dataclasses.replace(cfg, estep_backend="cuda"), algo="divi",
                distributed=DIVIConfig(num_workers=2, batch_size=8),
                tune_store=store, telemetry=tel,
                device=CPU).partial_fit(train, steps=0)
    assert tuned.cfg.kernel_policy == pol
    assert tuned.trainer.eng.cfg.kernel_policy == pol
    assert tel.metrics.value("tune.cache", result="hit") == 1
    with pytest.raises(ValueError, match="csr"):
        LDA(cfg, algo="divi", layout="csr", device=CPU).fit(train)
    # a pre-dealt ShardedDocStream trains as it is
    pre = LDA(cfg, algo="divi", distributed=DIVIConfig(num_workers=2,
                                                       batch_size=8),
              device=CPU).fit(sharded, rounds=2)
    assert pre.trainer.eng.sharded is sharded and pre.docs_seen == 32


def test_facade_on_a_one_rank_mesh_is_the_simulation(corpora, world1_mesh):
    """``LDA(algo="divi", mesh=, data_axes=("data",))`` on a (1, 1) mesh:
    the mesh round at one data rank is the simulation bit for bit, through
    ``fit``, ``evaluate``, ``bound`` and ``score`` (collectives on one
    rank), against ``repro``'s vmap engine at the module's bars."""
    train, test, jtrain = corpora
    jeng, _ = _pair(corpora, num_workers=2, batch_size=8, staleness=2)
    _, cfg = _cfgs()
    dcfg = DIVIConfig(num_workers=2, batch_size=8, staleness=2)
    a = LDA(cfg, algo="divi", distributed=dcfg, mesh=world1_mesh,
            data_axes=("data",), device=CPU)
    b = LDA(cfg, algo="divi", distributed=dcfg, device=CPU)
    for lda in (a, b):
        lda.fit(train, rounds=3, test_corpus=test, eval_every=3)
    for f in FIELDS:
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    assert a.history.lpp == b.history.lpp
    assert a.bound() == b.bound() and a.score(test) == b.score(test)
    assert np.array_equal(a.top_words(3), b.top_words(3))
    with pytest.raises(ValueError, match="gather_lam"):
        a.lam
    eng = DIVIEngine(cfg, dcfg, train, seed=0, device=CPU,
                     lam0=np.asarray(jeng.state.lam).copy(),
                     mesh=world1_mesh)
    for _ in range(3):
        eng.run_round()
        jeng.run_round()
    np.testing.assert_allclose(eng.gather_lam().numpy(),
                               np.asarray(jeng.state.lam), rtol=1e-3,
                               atol=1e-3)


def test_port_resumes_repro_divi_checkpoint(corpora, tmp_path):
    """A ``repro`` D-IVI run saved after two rounds: the port loads and
    resumes it, and its next three rounds stay within 1e-3 of ``repro``'s
    own continuation."""
    train, _, jtrain = corpora
    jcfg, _ = _cfgs()
    jdcfg = JDIVIConfig(num_workers=2, batch_size=8, staleness=2,
                        delay_prob=0.25)
    ja = JLDA(jcfg, algo="divi", distributed=jdcfg, seed=0).fit(jtrain,
                                                                rounds=2)
    path = os.path.join(tmp_path, "jck")
    ja.save(path)
    b = LDA.load(path, device=CPU).resume(train)
    assert b.docs_seen == ja.docs_seen
    np.testing.assert_array_equal(b.lam.numpy(), np.asarray(ja.lam))
    ja.partial_fit(steps=3)
    b.partial_fit(steps=3)
    assert b.docs_seen == ja.docs_seen
    np.testing.assert_allclose(b.lam.numpy(), np.asarray(ja.lam),
                               rtol=1e-3, atol=1e-3)


def test_repro_resumes_port_divi_checkpoint(corpora, tmp_path):
    """The port's D-IVI checkpoint after two rounds: ``repro`` loads and
    resumes it (the constructor's DIVIConfig, every worker's cursor and
    open packer documents, the memos), within 1e-3 of the port's own
    continuation over three rounds."""
    train, _, jtrain = corpora
    _, cfg = _cfgs()
    dcfg = DIVIConfig(num_workers=2, batch_size=7, staleness=2,
                      delay_prob=0.25)
    a = LDA(cfg, algo="divi", distributed=dcfg, seed=0, device=CPU).fit(
        train, rounds=2)
    path = os.path.join(tmp_path, "ck")
    a.save(path)
    jb = JLDA.load(path).resume(jtrain)
    assert jb.distributed == JDIVIConfig(**vars(dcfg))
    assert jb.docs_seen == a.docs_seen
    a.partial_fit(steps=3)
    jb.partial_fit(steps=3)
    assert jb.docs_seen == a.docs_seen
    np.testing.assert_allclose(np.asarray(jb.lam), a.lam.numpy(),
                               rtol=1e-3, atol=1e-3)


def test_launcher_divi_runs_and_resumes(tmp_path, monkeypatch, capsys):
    """``launch.train lda --algo divi --device cpu``: rounds with held-out
    LPP, a checkpoint, and a resume that ends where one run of all the
    rounds ends, bit for bit."""
    from repro_torch.launch import train as launcher
    path = os.path.join(tmp_path, "run")
    common = ["train", "lda", "--corpus", "tiny", "--topics", "4",
              "--device", "cpu", "--algo", "divi", "--workers", "4",
              "--batch", "12", "--staleness", "2", "--delay-prob", "0.25",
              "--estep-iters", "20", "--backend", "cuda", "--eval-every",
              "2"]
    monkeypatch.setattr("sys.argv", common + ["--rounds", "2", "--ckpt",
                                              path])
    launcher.main()
    out = capsys.readouterr().out
    assert "workers=4" in out and "round=2" in out and "lpp=" in out
    monkeypatch.setattr("sys.argv", common + ["--rounds", "2", "--resume",
                                              path, "--ckpt", path])
    launcher.main()
    b = LDA.load(path, device=CPU)
    train = make_corpus(SPEC, seed=0, device=CPU)
    cfg = LDAConfig(num_topics=4, vocab_size=SPEC.vocab_size,
                    estep_max_iters=20, estep_backend="cuda")
    a = LDA(cfg, algo="divi", distributed=DIVIConfig(
        num_workers=4, batch_size=12, staleness=2, delay_prob=0.25),
        device=CPU).fit(train, rounds=4)
    np.testing.assert_array_equal(b.lam.numpy(), a.lam.numpy())
