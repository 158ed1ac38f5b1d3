"""Port parity, the paper's baselines: MVI and SVI (padded and CSR) against
``repro`` from the same λ₀ and seed, the collapsed bound on both corpus
kinds, full-batch IVI = MVI in the port, and the held-out LPP each engine
improves.

λ (entries of order 0.05–10) and MVI's γ warm-start buffer are held at
rtol/atol 1e-3, the bar ``tests/test_torch_engine.py`` holds IVI to: both
packages run the same fp32 fixed point to the same tolerance in other
summation orders. The collapsed bound, one E-step of the same λ, is held at
rtol 1e-4.
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
from repro.data import stream as j_stream
from repro_torch.core.bound import elbo_collapsed_stream
from repro_torch.core.engines import LDAEngine
from repro_torch.core.types import LDAConfig
from repro_torch.data.bow import corpus_from_docs
from repro_torch.data.stream import CorpusDocStream
from repro_torch.data.synthetic import PAPER_CORPORA, make_corpus

CPU = "cpu"
SPEC = PAPER_CORPORA["tiny"]


def _close(got, want, rtol=1e-3, atol=1e-3):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _lam0(jcfg, seed):
    return np.array(j_init_global_state(jcfg, jax.random.key(seed)).lam)


def _pair(algo, backend="gather", jbackend="gather", batch=16, seed=0,
          layout="padded", k=8, **kw):
    """The same tiny-corpus engine in both packages from one λ₀: the
    materialized corpus, or a CorpusDocStream for ``layout="csr"``."""
    jcfg = JConfig(num_topics=k, vocab_size=SPEC.vocab_size,
                   estep_max_iters=50, estep_backend=jbackend)
    tcfg = LDAConfig(num_topics=k, vocab_size=SPEC.vocab_size,
                     estep_max_iters=50, estep_backend=backend)
    jtrain = j_make_corpus(J_CORPORA["tiny"], seed=0)
    ttrain = make_corpus(SPEC, seed=0, device=CPU)
    if layout == "csr":
        jtrain = j_stream.CorpusDocStream(jtrain, SPEC.vocab_size)
        ttrain = CorpusDocStream(ttrain, SPEC.vocab_size)
    jeng = JEngine(jcfg, jtrain, algo=algo, batch_size=batch, seed=seed,
                   layout=layout, **kw)
    teng = LDAEngine(tcfg, ttrain, algo=algo, batch_size=batch, seed=seed,
                     layout=layout, device=CPU, lam0=_lam0(jcfg, seed), **kw)
    return jeng, teng


@pytest.mark.parametrize("backend,jbackend,epochs", [
    ("gather", "gather", 2),
    # K1/K3's twins against the Pallas kernels in interpret mode, B ≤ 128
    ("cuda", "pallas", 1),
])
def test_mvi_tracks_repro(backend, jbackend, epochs):
    """MVI's λ and its per-document γ warm-start buffer (sentinel row D
    included: 96 documents in batches of 20 pad the tail batch) track
    ``repro``'s epoch by epoch."""
    jeng, teng = _pair("mvi", backend, jbackend, batch=20)
    assert teng._gamma_buf.shape == (97, 8)
    for _ in range(epochs):
        jeng.run_epoch()
        teng.run_epoch()
        assert teng.docs_seen == jeng.docs_seen
        _close(teng.state.lam, jeng.state.lam)
        _close(teng._gamma_buf, jeng._gamma_buf)
    assert int(teng.state.t) == int(jeng.state.t) == epochs
    assert teng.memo is None


@pytest.mark.parametrize("layout,backend,jbackend", [
    ("padded", "gather", "gather"),
    ("csr", "gather", "gather"),
    ("padded", "cuda", "pallas"),
    ("csr", "cuda", "pallas"),
])
def test_svi_tracks_repro(layout, backend, jbackend):
    """SVI (eq. 3) over one epoch, padded and on the CSR stream (phantom
    documents pad the CSR tail batch; the scale divides by the live
    ones)."""
    jeng, teng = _pair("svi", backend, jbackend, layout=layout)
    jeng.run_epoch()
    teng.run_epoch()
    assert teng.docs_seen == jeng.docs_seen == 96
    _close(teng.state.lam, jeng.state.lam)
    assert int(teng.state.t) == int(jeng.state.t)
    assert teng.memo is None and int(teng.last_iters) > 0


@pytest.mark.parametrize("layout", ["padded", "csr"])
def test_collapsed_full_bound_tracks_repro(layout):
    """``full_bound``'s collapsed branch (MVI on the materialized corpus,
    SVI on a stream: ``elbo_collapsed_stream``) on the same λ."""
    algo = "mvi" if layout == "padded" else "svi"
    jeng, teng = _pair(algo, layout=layout)
    jeng.run_epoch()
    teng.state.lam.copy_(torch.from_numpy(np.array(jeng.state.lam)))
    want = jeng.full_bound()
    np.testing.assert_allclose(teng.full_bound(), want, rtol=1e-4)
    if layout == "padded":
        # the stream read-through agrees with the one-shot corpus bound
        stream = CorpusDocStream(teng.corpus, SPEC.vocab_size)
        got = float(elbo_collapsed_stream(teng.cfg, stream, teng.state.lam,
                                          batch_docs=32))
        np.testing.assert_allclose(got, want, rtol=1e-4)


def test_fullbatch_ivi_equals_mvi():
    """``repro``'s test_fullbatch_ivi_equals_mvi in the port: IVI with
    batch = corpus is batch MVI (subtract-old/add-new over the whole corpus
    reproduces the full M-step), LPP within 5e-3, and λ within rtol
    1e-3."""
    train = make_corpus(SPEC, split="train", seed=0, device=CPU)
    test = make_corpus(SPEC, split="test", seed=0, device=CPU)
    cfg = LDAConfig(num_topics=8, vocab_size=SPEC.vocab_size,
                    estep_max_iters=60)
    lam0 = _lam0(JConfig(num_topics=8, vocab_size=SPEC.vocab_size), 0)
    mvi = LDAEngine(cfg, train, algo="mvi", batch_size=train.num_docs,
                    seed=0, test_corpus=test, device=CPU, lam0=lam0)
    ivi = LDAEngine(cfg, train, algo="ivi", batch_size=train.num_docs,
                    seed=0, test_corpus=test, device=CPU, lam0=lam0)
    for _ in range(4):
        mvi.run_epoch()
        ivi.run_minibatch(rows=np.arange(train.num_docs))
    lm, li = mvi.evaluate()["lpp"], ivi.evaluate()["lpp"]
    assert abs(lm - li) < 5e-3, (lm, li)
    _close(ivi.state.lam, mvi.state.lam, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("algo", ["mvi", "svi", "ivi", "sivi"])
def test_engines_improve_lpp(algo):
    """``repro``'s test_engines_improve_lpp on the port: four epochs on
    ``tiny`` raise held-out LPP by more than 0.05."""
    train = make_corpus(SPEC, split="train", seed=0, device=CPU)
    test = make_corpus(SPEC, split="test", seed=0, device=CPU)
    cfg = LDAConfig(num_topics=8, vocab_size=SPEC.vocab_size,
                    estep_max_iters=40)
    eng = LDAEngine(cfg, train, algo=algo, batch_size=16, seed=0,
                    test_corpus=test, device=CPU)
    first = eng.evaluate()["lpp"]
    for _ in range(4):
        eng.run_epoch()
    last = eng.evaluate()["lpp"]
    assert np.isfinite(last)
    assert last > first + 0.05, f"{algo}: {first} → {last}"


def test_svi_not_required_monotone_but_converges():
    """``repro``'s contrast (tests/test_monotone.py): SVI may lower the
    collapsed bound between steps, yet the trend improves."""
    rng = np.random.default_rng(3)
    docs = [rng.integers(0, 120, size=max(2, int(rng.poisson(30))))
            for _ in range(32)]
    corpus = corpus_from_docs(docs, 120, device=CPU)
    cfg = LDAConfig(num_topics=5, vocab_size=120, estep_max_iters=60)
    eng = LDAEngine(cfg, corpus, algo="svi", batch_size=8, seed=0,
                    device=CPU)
    bounds = []
    for _ in range(15):
        eng.run_minibatch()
        bounds.append(eng.full_bound())
    assert bounds[-1] > bounds[0]
