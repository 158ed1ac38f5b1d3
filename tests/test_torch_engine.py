"""Port parity, engine: IVI trajectories against ``repro`` from the same λ₀
and seed, the paper's §3 claims on the port, and the state/memo hand-over
through `repro_torch.convert`.

λ is held at rtol 1e-3 and atol 1e-3: both packages run the same fixed
point in fp32 to the same ``estep_tol``, but sum in other orders, so γ and
π differ at rounding level and a fixed point may stop one sweep apart; over
a few epochs that moves λ (entries of order 0.05–10) by far less than 1e-3.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import LDAConfig as JConfig
from repro.core import LDAEngine as JEngine
from repro.core.types import init_global_state as j_init_global_state
from repro.data import PAPER_CORPORA as J_CORPORA
from repro.data import make_corpus as j_make_corpus
from repro_torch.convert import memo_from_numpy, state_from_numpy
from repro_torch.core.engines import LDAEngine
from repro_torch.core.estep import scatter_sstats
from repro_torch.core.memo import make_memo_store
from repro_torch.core.types import LDAConfig
from repro_torch.data.bow import corpus_from_docs
from repro_torch.data.stream import CorpusDocStream
from repro_torch.data.synthetic import PAPER_CORPORA, make_corpus

CPU = "cpu"
FIELDS = ("lam", "m_vk", "init_mass", "init_frac", "t")


def _numpy_state(state):
    return {f: np.asarray(getattr(state, f)) for f in FIELDS}


def _pair(backend, jbackend, seed=0, batch=16, algo="ivi", **kw):
    """The same tiny-corpus run in both packages, from one λ₀."""
    spec = PAPER_CORPORA["tiny"]
    jcfg = JConfig(num_topics=8, vocab_size=spec.vocab_size,
                   estep_max_iters=50, estep_backend=jbackend, **kw)
    tcfg = LDAConfig(num_topics=8, vocab_size=spec.vocab_size,
                     estep_max_iters=50, estep_backend=backend, **kw)
    jeng = JEngine(jcfg, j_make_corpus(J_CORPORA["tiny"], seed=0),
                   algo=algo, batch_size=batch, seed=seed)
    teng = LDAEngine(tcfg, make_corpus(spec, seed=0, device=CPU), algo=algo,
                     batch_size=batch, seed=seed, device=CPU)
    lam0 = _numpy_state(j_init_global_state(jcfg, jax.random.key(seed)))
    teng.state = state_from_numpy(lam0, CPU)
    return jeng, teng


def _assert_lam_close(teng, jeng):
    np.testing.assert_allclose(teng.state.lam.numpy(),
                               np.asarray(jeng.state.lam),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("algo,backend,jbackend,epochs", [
    ("ivi", "gather", "gather", 3),
    ("sivi", "gather", "gather", 2),
    # the CUDA backend runs its kernels' plain twins on CPU tensors; the
    # Pallas reference runs in interpret mode, so one epoch keeps it short
    ("ivi", "cuda", "pallas", 1),
])
def test_trajectory_tracks_repro(algo, backend, jbackend, epochs):
    jeng, teng = _pair(backend, jbackend, algo=algo)
    np.testing.assert_array_equal(teng.state.lam.numpy(),
                                  np.asarray(jeng.state.lam))
    for _ in range(epochs):
        jeng.run_epoch()
        teng.run_epoch()
        assert teng.docs_seen == jeng.docs_seen
        _assert_lam_close(teng, jeng)
        np.testing.assert_array_equal(teng.memo.visited.numpy(),
                                      np.asarray(jeng.memo.visited))
    assert float(teng.state.init_frac) == float(jeng.state.init_frac) == 0.0
    assert int(teng.state.t) == int(jeng.state.t)


def _random_corpus(seed, n_docs, vocab, mean_len):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(0, vocab, size=max(2, int(rng.poisson(mean_len))))
            for _ in range(n_docs)]
    return corpus_from_docs(docs, vocab, device=CPU)


@pytest.mark.parametrize("backend", ["gather", "cuda"])
@pytest.mark.parametrize("seed,k,batch", [(0, 5, 8), (7, 3, 4)])
def test_ivi_monotone_bound(backend, seed, k, batch):
    """Once the init mass has retired every IVI update raises the memoized
    ELBO, with ``tests/test_monotone.py``'s fp32 slack."""
    corpus = _random_corpus(seed, 32, 120, 30)
    cfg = LDAConfig(num_topics=k, vocab_size=120, estep_max_iters=100,
                    estep_tol=1e-6, estep_backend=backend)
    eng = LDAEngine(cfg, corpus, algo="ivi", batch_size=batch, seed=seed,
                    device=CPU)
    eng.run_epoch()
    assert float(eng.state.init_frac) == 0.0
    prev = eng.full_bound()
    for _ in range(12):
        eng.run_minibatch()
        cur = eng.full_bound()
        assert cur >= prev - max(5e-3, 2e-6 * abs(prev)), (prev, cur)
        prev = cur


@pytest.mark.parametrize("backend", ["gather", "cuda"])
def test_accumulator_matches_memo_and_lambda(backend):
    """⟨m_vk⟩ equals the scatter of the memoized π (rtol 1e-3, atol 1e-2,
    as ``tests/test_monotone.py``), and λ = β₀ + ⟨m_vk⟩ after a covering
    pass (1e-5, eq. 4)."""
    corpus = _random_corpus(3, 24, 80, 20)
    cfg = LDAConfig(num_topics=4, vocab_size=80, estep_max_iters=50,
                    estep_backend=backend)
    eng = LDAEngine(cfg, corpus, algo="ivi", batch_size=8, seed=3,
                    device=CPU)
    eng.run_epoch()
    np.testing.assert_allclose(eng.state.lam.numpy(),
                               cfg.beta0 + eng.state.m_vk.numpy(),
                               rtol=1e-5, atol=1e-5)
    for _ in range(5):
        eng.run_minibatch()
    rebuilt = scatter_sstats(corpus.token_ids,
                             corpus.counts[:, :, None] * eng.memo.pi,
                             cfg.vocab_size)
    np.testing.assert_allclose(eng.state.m_vk.numpy(), rebuilt.numpy(),
                               rtol=1e-3, atol=1e-2)


def test_state_and_memo_round_trip_through_convert():
    """A ``repro`` state and memo continue in the port: one more update on
    the same rows in both packages agrees."""
    jeng, teng = _pair("gather", "gather", seed=2)
    jeng.run_epoch()
    state, memo = _numpy_state(jeng.state), jeng.memo.state_dict()
    teng.state = state_from_numpy(state, CPU)
    teng.memo = memo_from_numpy(memo, CPU)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(teng.state, f).numpy(),
                                      state[f])
    assert teng.state.t.dtype == torch.int32
    for key, arr in teng.memo.state_dict().items():
        np.testing.assert_array_equal(arr, memo[key])
    fresh = make_memo_store("dense", teng.cfg, teng.num_docs,
                            teng.corpus.max_unique, device=CPU)
    for key, arr in fresh.load_state_dict(memo).state_dict().items():
        np.testing.assert_array_equal(arr, memo[key])
    rows = np.arange(5, 21)
    jeng.run_minibatch(rows)
    teng.run_minibatch(rows)
    _assert_lam_close(teng, jeng)
    assert int(teng.state.t) == int(jeng.state.t)
    np.testing.assert_allclose(teng.memo.pi.numpy(),
                               np.asarray(jeng.memo.pi), rtol=2e-3,
                               atol=1e-4)


def test_engine_refuses_unported_modes():
    """``repro``'s refusals (engines.py:392-400, :429-433, :447-449), each
    a ``ValueError`` as there: every algo and store is ported, and what
    ``repro`` refuses the port refuses too."""
    corpus = _random_corpus(0, 8, 20, 5)
    stream = CorpusDocStream(corpus, 20)
    cfg = LDAConfig(num_topics=3, vocab_size=20)
    with pytest.raises(ValueError, match="full-batch"):
        LDAEngine(cfg, stream, algo="mvi", device=CPU)
    with pytest.raises(ValueError, match="eq. 4"):
        LDAEngine(cfg, corpus, algo="ivi", memo_store="gamma", device=CPU)
    with pytest.raises(ValueError, match="resident corpus"):
        LDAEngine(cfg, stream, algo="sivi", memo_store="gamma", device=CPU)
    with pytest.raises(ValueError, match="mini-batch engines"):
        LDAEngine(cfg, corpus, algo="mvi", bucket_by_length=True,
                  device=CPU)
    with pytest.raises(ValueError, match="vocab_size"):
        LDAEngine(LDAConfig(num_topics=3, vocab_size=10), corpus,
                  algo="ivi", device=CPU)
    with pytest.raises(ValueError, match="unknown algo"):
        LDAEngine(cfg, corpus, algo="divi", device=CPU)
    with pytest.raises(ValueError, match="needs the corpus"):
        make_memo_store("gamma", cfg, 8, 4, device=CPU)
    with pytest.raises(ValueError, match="unknown memo store"):
        make_memo_store("sparse", cfg, 8, 4, device=CPU)
    with pytest.raises(ValueError, match="full-batch"):
        LDAEngine(cfg, corpus, algo="mvi", device=CPU).epoch_batches()


def test_memo_state_dict_is_a_snapshot():
    """``state_dict`` copies: later updates do not reach a saved state."""
    store = make_memo_store("dense", LDAConfig(num_topics=2), 3, 2,
                            device=CPU)
    saved = store.state_dict()
    store.update(np.array([1]), torch.ones((1, 2, 2)))
    assert not saved["visited"].any() and not saved["pi"].any()
    assert bool(store.visited[1]) and float(store.pi.sum()) == 4.0
