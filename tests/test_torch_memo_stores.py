"""Port parity, the memo stores: the bf16 host-chunked store bit for bit
against ``repro``'s (its chunks compared as raw 16-bit patterns, at chunk
boundaries and at widths below L), the γ-only store's reconstruction
against ``repro``'s on the same updates, the footprint formulas, and the
engine-level invariants ``repro``'s own store tests hold.

Tolerances: the chunked store is exact (both sides round fp32 → bf16 to
nearest even); the γ-only store's gather at 1e-5 (one fp32 reconstruction
in another summation order); the mass identity at ``repro``'s 5e-4
(dense) and 2e-3 (chunked); the reconstructed π against the dense store's
at ``repro``'s 2e-2 (a bf16 snapshot of Eφ).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LDAConfig as JConfig
from repro.core import memo as j_memo
from repro.data import PAPER_CORPORA as J_CORPORA
from repro.data import make_corpus as j_make_corpus
from repro_torch.core import memo
from repro_torch.core.engines import LDAEngine
from repro_torch.core.estep import scatter_sstats
from repro_torch.core.types import LDAConfig
from repro_torch.data.synthetic import PAPER_CORPORA, make_corpus
from repro_torch.lda import LDA
from repro_torch.obs import Telemetry

CPU = "cpu"
SPEC = PAPER_CORPORA["tiny"]


def _updates(seed, num_docs, width, k, n=4, batch=7):
    """``n`` (rows, π) writes: rows drawn across chunk boundaries, π fp32
    with values at every magnitude bf16 rounds differently."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rows = rng.choice(num_docs, size=batch, replace=False)
        w = width if i % 2 == 0 else max(1, width - 3)
        pi = (rng.random((batch, w, k)) * 10.0 ** rng.integers(-4, 2))
        out.append((rows, pi.astype(np.float32)))
    return out


@pytest.mark.parametrize("num_docs,chunk_docs", [(37, 8), (16, 16), (9, 4)])
def test_chunked_store_bit_equal_to_repro(num_docs, chunk_docs):
    """gather, state_dict and footprint after the same writes, bit for bit;
    a read below L returns the first ``width`` columns, and a narrow write
    zeroes the columns past it."""
    l, k = 10, 4
    jcfg, tcfg = JConfig(num_topics=k), LDAConfig(num_topics=k)
    js = j_memo.ChunkedMemoStore(jcfg, num_docs, l, chunk_docs=chunk_docs)
    ts = memo.make_memo_store("chunked", tcfg, num_docs, l,
                              chunk_docs=chunk_docs, device=CPU)
    assert ts.pi_wire_dtype == js.pi_wire_dtype == "bfloat16"
    for rows, pi in _updates(num_docs, num_docs, l, k):
        js = js.update(rows, jnp.asarray(pi))
        ts = ts.update(rows, torch.from_numpy(pi))
    every = np.arange(num_docs)
    for width in (None, l - 4, 1):
        jpi, jvis = js.gather(every[::-1], width=width)
        tpi, tvis = ts.gather(every[::-1], width=width)
        assert tpi.dtype == torch.float32
        np.testing.assert_array_equal(tpi.numpy(), np.asarray(jpi))
        np.testing.assert_array_equal(tvis.numpy(), np.asarray(jvis))
    jsd, tsd = js.state_dict(), ts.state_dict()
    assert sorted(jsd) == sorted(tsd)
    for key, arr in jsd.items():
        if key.startswith("chunk_"):
            assert tsd[key].dtype == np.uint16
            np.testing.assert_array_equal(tsd[key],
                                          np.asarray(arr).view(np.uint16))
        else:
            np.testing.assert_array_equal(tsd[key], arr)
    assert ts.footprint_bytes() == js.footprint_bytes()


def test_chunked_store_loads_repro_state():
    """A ``repro`` chunked state (ml_dtypes bf16 chunks) and the port's own
    uint16 export both restore the same bits; a wrong shape is refused."""
    jcfg, tcfg = JConfig(num_topics=3), LDAConfig(num_topics=3)
    js = j_memo.ChunkedMemoStore(jcfg, 11, 5, chunk_docs=4)
    for rows, pi in _updates(1, 11, 5, 3):
        js = js.update(rows, jnp.asarray(pi))
    want = {key: np.asarray(v).view(np.uint16) if key.startswith("chunk_")
            else np.asarray(v) for key, v in js.state_dict().items()}
    for state in (js.state_dict(), want):
        ts = memo.make_memo_store("chunked", tcfg, 11, 5, chunk_docs=4,
                                  device=CPU).load_state_dict(state)
        for key, arr in ts.state_dict().items():
            np.testing.assert_array_equal(arr, want[key])
    small = memo.make_memo_store("chunked", tcfg, 11, 4, chunk_docs=4,
                                 device=CPU)
    with pytest.raises(ValueError, match="checkpoint shape"):
        small.load_state_dict(want)


@pytest.mark.parametrize("kind", ["dense", "chunked", "gamma"])
def test_footprint_formulas_equal_repro(kind):
    """``memo_footprint_bytes`` (the full Arxiv corpus, arithmetic only) and
    a live store's ``footprint_bytes`` equal ``repro``'s."""
    args = (782_385, 163, 100)
    assert memo.memo_footprint_bytes(kind, *args, vocab_size=141_927) == \
        j_memo.memo_footprint_bytes(kind, *args, vocab_size=141_927)
    jcorpus = j_make_corpus(J_CORPORA["tiny"], seed=0)
    tcorpus = make_corpus(SPEC, seed=0, device=CPU)
    d, l = tcorpus.num_docs, tcorpus.max_unique
    js = j_memo.make_memo_store(kind, JConfig(num_topics=5), d, l,
                                corpus=jcorpus, chunk_docs=40)
    ts = memo.make_memo_store(kind, LDAConfig(num_topics=5), d, l,
                              corpus=tcorpus, chunk_docs=40, device=CPU)
    rows = np.arange(30, 50)                     # two chunks
    pi = np.full((20, l, 5), 0.2, np.float32)
    eb = np.full((SPEC.vocab_size, 5), 0.5, np.float32)
    js = js.update(rows, jnp.asarray(pi), exp_elog_beta=jnp.asarray(eb))
    ts = ts.update(rows, torch.from_numpy(pi),
                   exp_elog_beta=torch.from_numpy(eb))
    assert ts.footprint_bytes() == js.footprint_bytes()


def _mass_identity_gap(eng):
    """max |⟨m_vk⟩ − Σ_d scatter(cnt·π_store)| over the corpus."""
    pi, _ = eng.memo.gather(np.arange(eng.num_docs))
    rebuilt = scatter_sstats(eng.corpus.token_ids,
                             eng.corpus.counts[:, :, None] * pi,
                             eng.cfg.vocab_size)
    return float((eng.state.m_vk - rebuilt).abs().max())


@pytest.mark.parametrize("store,tol", [("dense", 5e-4), ("chunked", 2e-3)])
def test_memo_store_mass_identity(store, tol):
    """``repro``'s test: after a covering pass and four more updates,
    ⟨m_vk⟩ == Σ_d scatter(cnt·π) through the store, the bf16 one included
    (π is rounded through the wire dtype before the add-new side)."""
    cfg = LDAConfig(num_topics=8, vocab_size=SPEC.vocab_size,
                    estep_max_iters=50)
    eng = LDAEngine(cfg, make_corpus(SPEC, seed=0, device=CPU), algo="ivi",
                    batch_size=16, seed=0, memo_store=store, chunk_docs=40,
                    device=CPU)
    eng.run_epoch()
    for _ in range(4):
        eng.run_minibatch()
    assert float(eng.state.init_frac) == 0.0
    gap = _mass_identity_gap(eng)
    assert gap < tol, gap
    if store == "dense":
        np.testing.assert_allclose(eng.state.lam.numpy(),
                                   cfg.beta0 + eng.state.m_vk.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_gamma_store_gather_tracks_repro():
    """The γ-only store after the same writes (two snapshots, one chunk
    never written, unvisited rows in a written chunk): gather within 1e-5 of
    ``repro``'s, γ and the snapshots' bits equal."""
    jcorpus = j_make_corpus(J_CORPORA["tiny"], seed=0)
    tcorpus = make_corpus(SPEC, seed=0, device=CPU)
    k, v = 6, SPEC.vocab_size
    js = j_memo.make_memo_store("gamma", JConfig(num_topics=k), 96, 0,
                                corpus=jcorpus, chunk_docs=32)
    ts = memo.make_memo_store("gamma", LDAConfig(num_topics=k), 96, 0,
                              corpus=tcorpus, chunk_docs=32, device=CPU)
    rng = np.random.default_rng(4)
    l = tcorpus.max_unique
    for rows, w in ((np.arange(0, 20), l), (np.arange(25, 40), l - 5)):
        pi = rng.dirichlet(np.ones(k), size=(len(rows), w)).astype(np.float32)
        eb = rng.gamma(1.0, 1.0, (v, k)).astype(np.float32)
        js = js.update(rows, jnp.asarray(pi), exp_elog_beta=jnp.asarray(eb))
        ts = ts.update(rows, torch.from_numpy(pi),
                       exp_elog_beta=torch.from_numpy(eb))
    idx = np.concatenate([np.arange(0, 40), np.arange(70, 80)])
    for width in (None, 9):
        jpi, jvis = js.gather(idx, width=width)
        tpi, tvis = ts.gather(idx, width=width)
        np.testing.assert_array_equal(tvis.numpy(), np.asarray(jvis))
        np.testing.assert_allclose(tpi.numpy(), np.asarray(jpi), rtol=1e-5,
                                   atol=1e-5)
    assert not tpi[-10:].any()                  # chunk 2 was never written
    jsd, tsd = js.state_dict(), ts.state_dict()
    assert sorted(jsd) == sorted(tsd)
    np.testing.assert_allclose(tsd["gamma"], jsd["gamma"], rtol=1e-6)
    for key in ("snap_00000", "snap_00001"):
        np.testing.assert_array_equal(tsd[key],
                                      np.asarray(jsd[key]).view(np.uint16))
    back = memo.make_memo_store("gamma", LDAConfig(num_topics=k), 96, 0,
                                corpus=tcorpus, chunk_docs=32, device=CPU)
    back = back.load_state_dict(tsd)
    np.testing.assert_array_equal(back.gather(idx)[0].numpy(),
                                  ts.gather(idx)[0].numpy())


def test_gamma_store_reconstructs_pi():
    """``repro``'s test: right after a write the γ-only store reproduces the
    dense store's π (same λ-epoch), and its footprint is smaller."""
    cfg = LDAConfig(num_topics=8, vocab_size=SPEC.vocab_size,
                    estep_max_iters=50)
    train = make_corpus(SPEC, seed=0, device=CPU)
    dense = LDAEngine(cfg, train, algo="sivi", batch_size=16, seed=0,
                      device=CPU)
    gamma = LDAEngine(cfg, train, algo="sivi", batch_size=16, seed=0,
                      memo_store="gamma", chunk_docs=train.num_docs,
                      device=CPU)
    rows = np.arange(16)
    dense.run_minibatch(rows)
    gamma.run_minibatch(rows)
    pi_d, vis_d = dense.memo.gather(rows)
    pi_g, vis_g = gamma.memo.gather(rows)
    np.testing.assert_array_equal(vis_d.numpy(), vis_g.numpy())
    np.testing.assert_allclose(pi_g.numpy(), pi_d.numpy(), rtol=2e-2,
                               atol=2e-2)
    assert gamma.memo.footprint_bytes() < dense.memo.footprint_bytes()


def test_gamma_store_refusals():
    """``repro``'s refusals: IVI with the γ-only store (eq. 4 needs the true
    π), a γ-only store without the corpus, an update without Eφ."""
    cfg = LDAConfig(num_topics=4, vocab_size=SPEC.vocab_size)
    train = make_corpus(SPEC, seed=0, device=CPU)
    with pytest.raises(ValueError, match="eq. 4"):
        LDAEngine(cfg, train, algo="ivi", batch_size=16, memo_store="gamma",
                  device=CPU)
    with pytest.raises(ValueError, match="needs the corpus"):
        memo.make_memo_store("gamma", cfg, 96, 4, device=CPU)
    store = memo.make_memo_store("gamma", cfg, 96, 0, corpus=train,
                                 device=CPU)
    with pytest.raises(ValueError, match="exp_elog_beta"):
        store.update(np.arange(2), torch.zeros((2, 3, 4)))


@pytest.mark.parametrize("store", ["chunked", "gamma"])
def test_host_store_engine_tracks_repro(store):
    """One S-IVI epoch through each host store in both packages, from one
    λ₀: λ within 1e-3, the bar of the dense path."""
    import jax
    from repro.core import LDAEngine as JEngine
    from repro.core.types import init_global_state as j_init

    jcfg = JConfig(num_topics=6, vocab_size=SPEC.vocab_size,
                   estep_max_iters=50)
    tcfg = LDAConfig(num_topics=6, vocab_size=SPEC.vocab_size,
                     estep_max_iters=50)
    jeng = JEngine(jcfg, j_make_corpus(J_CORPORA["tiny"], seed=0),
                   algo="sivi", batch_size=16, seed=0, memo_store=store,
                   chunk_docs=40)
    teng = LDAEngine(tcfg, make_corpus(SPEC, seed=0, device=CPU),
                     algo="sivi", batch_size=16, seed=0, memo_store=store,
                     chunk_docs=40, device=CPU,
                     lam0=np.array(j_init(jcfg, jax.random.key(0)).lam))
    for _ in range(2):
        jeng.run_epoch()
        teng.run_epoch()
    np.testing.assert_allclose(teng.state.lam.numpy(),
                               np.asarray(jeng.state.lam), rtol=1e-3,
                               atol=1e-3)
    assert teng.memo.footprint_bytes() == jeng.memo.footprint_bytes()


# ---------------------------------------------------------------------------
# the chunked store's link counters
# ---------------------------------------------------------------------------

def test_chunked_store_link_counters_count_each_call():
    """``link_stats`` after gathers and updates at two widths: the π bytes
    each way are rows × width × K × 2, and each call touches each chunk
    its rows fall in once; with telemetry on the registry holds the same
    totals, with it off the counters run all the same."""
    k, l = 5, 10
    tel = Telemetry()
    on = memo.make_memo_store("chunked", LDAConfig(num_topics=k), 37, l,
                              chunk_docs=8, device=CPU, telemetry=tel)
    off = memo.make_memo_store("chunked", LDAConfig(num_topics=k), 37, l,
                               chunk_docs=8, device=CPU)
    assert off.tel.enabled is False
    want = {"bytes_in": 0, "bytes_out": 0, "chunks_in": 0, "chunks_out": 0}
    for rows, w in ((np.array([0, 7, 8, 36]), l),      # chunks 0, 1, 4
                    (np.array([9, 10, 11]), 4),         # chunk 1
                    (np.arange(37)[::-1], l)):          # chunks 0-4
        chunks = len(np.unique(rows // 8))
        for s in (on, off):
            pi, _ = s.gather(rows, width=w)
            s.update(rows, pi + 0.25)
        for d in ("in", "out"):
            want["bytes_" + d] += len(rows) * w * k * 2
            want["chunks_" + d] += chunks
        assert on.link_stats() == off.link_stats() == want
    m = tel.metrics
    assert m.total("memo.link_bytes_in") == want["bytes_in"]
    assert m.total("memo.link_bytes_out") == want["bytes_out"]
    assert m.total("memo.chunks_touched") == want["chunks_in"] \
        + want["chunks_out"]
    # the counters change nothing the store holds
    np.testing.assert_array_equal(on.gather(np.arange(37))[0].numpy(),
                                  off.gather(np.arange(37))[0].numpy())


def test_chunked_store_moves_bwk2_bytes_each_way_an_update():
    """Two IVI epochs of the facade over the chunked store (every document
    revisited): each update moves B·W·K·2 bytes of π each way, W the
    corpus's width, and the store's counters equal the engine's registry
    totals when telemetry is on."""
    k, b = 6, 16
    train = make_corpus(SPEC, seed=0, device=CPU)
    tel = Telemetry()
    lda = LDA(LDAConfig(num_topics=k, vocab_size=SPEC.vocab_size,
                        estep_max_iters=15), algo="ivi", batch_size=b,
              seed=2, memo_store="chunked", chunk_docs=40, telemetry=tel,
              device=CPU)
    lda.partial_fit(train, steps=0)
    store = lda.trainer.eng.memo
    steps = 2 * (train.num_docs // b)
    lda.partial_fit(steps=steps)
    per = b * train.max_unique * k * 2
    stats = store.link_stats()
    assert stats["bytes_in"] == stats["bytes_out"] == steps * per
    assert steps <= stats["chunks_in"] == stats["chunks_out"] <= 3 * steps
    assert tel.metrics.total("memo.link_bytes_in") == steps * per
    assert tel.metrics.total("memo.link_bytes_out") == steps * per
