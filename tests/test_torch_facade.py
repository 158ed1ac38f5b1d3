"""Port parity, the facade: ``repro_torch.lda.LDA`` against ``repro.lda.LDA``
from the same ``repro`` checkpoint, for MVI, SVI, IVI and S-IVI, both
layouts and the three memo stores; the facade against the port's own
engine; ``warm_start``; K = 300 through the ``cuda`` backend's twins; the
public surface.

Tolerances: λ and ⟨m_vk⟩ at ``tests/test_torch_engine.py``'s rtol 1e-3 /
atol 1e-3 (both packages run the same fixed points in fp32 to the same
``estep_tol`` but sum in other orders); ``docs_seen`` and the restored
state exactly. The facade against the port's own engine, bit for bit.
"""
import os

import numpy as np
import pytest
import torch

from repro.core import LDAConfig as JConfig
from repro.data import PAPER_CORPORA as J_CORPORA
from repro.data import make_corpus as j_make_corpus
from repro.lda import LDA as JLDA
from repro_torch.core.engines import LDAEngine
from repro_torch.core.types import LDAConfig, init_global_state
from repro_torch.data.synthetic import PAPER_CORPORA, make_corpus
from repro_torch.lda import LDA

CPU = "cpu"
SPEC = PAPER_CORPORA["tiny"]


@pytest.fixture(scope="module")
def corpora():
    """The tiny corpus in both packages (the port's make_corpus is
    ``repro``'s bit for bit)."""
    return (j_make_corpus(J_CORPORA["tiny"], seed=0),
            make_corpus(SPEC, seed=0, device=CPU),
            make_corpus(SPEC, split="test", seed=0, device=CPU))


def _cfgs(jbackend="gather", backend="gather", **kw):
    kw.setdefault("estep_max_iters", 30)
    return (JConfig(num_topics=4, vocab_size=SPEC.vocab_size,
                    estep_backend=jbackend, **kw),
            LDAConfig(num_topics=4, vocab_size=SPEC.vocab_size,
                      estep_backend=backend, **kw))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("algo,layout,store,steps", [
    ("ivi", "padded", "dense", 3),
    ("ivi", "padded", "chunked", 3),
    ("sivi", "padded", "gamma", 3),
    ("svi", "padded", "dense", 3),
    ("ivi", "csr", "dense", 3),
    ("ivi", "csr", "chunked", 3),
    ("svi", "csr", "dense", 2),
    ("mvi", "padded", "dense", 0),
])
def test_facade_resumes_repro_checkpoint_like_repro(tmp_path, corpora, algo,
                                                    layout, store, steps):
    """One ``repro`` checkpoint, resumed by both facades: the restored state
    is the checkpoint's, bit for bit, and two more steps (MVI: one more
    epoch) agree in λ, ⟨m_vk⟩ and docs_seen."""
    jtrain, train, _ = corpora
    jcfg, _ = _cfgs()
    kw = dict(algo=algo, batch_size=16, seed=7, memo_store=store,
              chunk_docs=16, layout=layout)
    if layout == "csr":
        kw["token_budget"] = 256
    path = os.path.join(tmp_path, "ck")
    j = JLDA(jcfg, **kw)
    if algo == "mvi":
        j.fit(jtrain, epochs=1)
    else:
        j.partial_fit(jtrain, steps=steps)
    j.save(path)

    t = LDA.load(path, device=CPU).resume(train)
    jr = JLDA.load(path).resume(jtrain)
    for f in ("lam", "m_vk", "init_mass", "init_frac", "t"):
        np.testing.assert_array_equal(getattr(t.state, f).numpy(),
                                      np.asarray(getattr(jr.state, f)))
    assert t.docs_seen == jr.docs_seen
    if algo == "mvi":
        t.fit(epochs=1)
        jr.fit(epochs=1)
    else:
        t.partial_fit(steps=2)
        jr.partial_fit(steps=2)
    _close(t.lam.numpy(), jr.lam)
    _close(t.state.m_vk.numpy(), jr.state.m_vk)
    assert t.docs_seen == jr.docs_seen


def test_facade_resumes_pallas_checkpoint_on_cuda_backend(tmp_path, corpora):
    """A ``repro`` checkpoint of the ``pallas`` backend resumes in the port
    on ``cuda`` (the kernels' twins here), and both continue alike."""
    jtrain, train, _ = corpora
    jcfg, _ = _cfgs("pallas")
    path = os.path.join(tmp_path, "ck")
    JLDA(jcfg, algo="ivi", batch_size=16, seed=2).partial_fit(
        jtrain, steps=2).save(path)
    t = LDA.load(path, device=CPU).resume(train)
    assert t.cfg.estep_backend == "cuda"
    jr = JLDA.load(path).resume(jtrain)
    t.partial_fit(steps=1)
    jr.partial_fit(steps=1)
    _close(t.lam.numpy(), jr.lam)
    _close(t.state.m_vk.numpy(), jr.state.m_vk)


@pytest.mark.parametrize("algo", ["mvi", "svi", "ivi", "sivi"])
def test_facade_bit_equal_to_engine(corpora, algo):
    """The facade drives ``LDAEngine``: the same seed gives the same bits."""
    _, train, _ = corpora
    _, cfg = _cfgs()
    lda = LDA(cfg, algo=algo, batch_size=16, seed=3,
              device=CPU).fit(train, epochs=2)
    eng = LDAEngine(cfg, train, algo=algo, batch_size=16, seed=3, device=CPU)
    eng.run_epoch()
    eng.run_epoch()
    assert torch.equal(lda.lam, eng.state.lam)
    assert torch.equal(lda.state.m_vk, eng.state.m_vk)
    assert lda.docs_seen == eng.docs_seen


def test_warm_start_books_lam0_as_init_global_state(corpora):
    """``warm_start(λ₀)`` leaves the state ``init_global_state(lam0=λ₀)``
    builds, and the run then equals an engine started from λ₀."""
    _, train, _ = corpora
    _, cfg = _cfgs()
    lam0 = np.random.default_rng(0).gamma(100.0, 0.01, (SPEC.vocab_size, 4))
    lda = LDA(cfg, algo="ivi", batch_size=16, seed=1, device=CPU)
    lda.partial_fit(train, steps=0).warm_start(lam0)
    want = init_global_state(cfg, device=CPU, lam0=lam0)
    for f in ("lam", "m_vk", "init_mass", "init_frac", "t"):
        assert torch.equal(getattr(lda.state, f), getattr(want, f)), f
    lda.fit(epochs=1)
    eng = LDAEngine(cfg, train, algo="ivi", batch_size=16, seed=1,
                    device=CPU, lam0=lam0)
    eng.run_epoch()
    assert torch.equal(lda.lam, eng.state.lam)
    with pytest.raises(ValueError, match="untrained"):
        lda.warm_start(lam0)


def test_facade_at_300_topics_through_cuda_twins(corpora):
    """K = 300 on the ``cuda`` backend (the kernels' twins on the CPU): the
    Python path has no cap. One covering pass retires the init mass."""
    _, train, test = corpora
    cfg = LDAConfig(num_topics=300, vocab_size=SPEC.vocab_size,
                    estep_backend="cuda", estep_max_iters=10)
    lda = LDA(cfg, algo="ivi", batch_size=32, device=CPU).fit(train,
                                                              epochs=1)
    assert lda.lam.shape == (SPEC.vocab_size, 300)
    assert float(lda.state.init_frac) == 0.0
    torch.testing.assert_close(lda.lam, cfg.beta0 + lda.state.m_vk,
                               rtol=1e-5, atol=1e-5)
    theta = lda.transform(test, backend="cuda", batch_size=16)
    assert theta.shape == (test.num_docs, 300)
    np.testing.assert_allclose(theta.sum(-1), 1.0, atol=1e-5)


def test_facade_views_and_metrics(corpora):
    _, train, test = corpora
    _, cfg = _cfgs()
    lda = LDA(cfg, algo="ivi", batch_size=16, device=CPU)
    lda.fit(train, epochs=2, test_corpus=test, eval_every=1)
    assert len(lda.history.lpp) == 2 and np.isfinite(lda.history.lpp).all()
    assert np.isfinite(lda.bound())
    assert lda.perplexity(test) == pytest.approx(np.exp(-lda.score(test)))
    assert lda.top_words(3).shape == (4, 3)
    assert 1.0 <= lda.effective_topics() <= 4.0
    assert np.isfinite(lda.coherence(test, k=3))
    assert "lpp" in lda.evaluate()


def test_public_api_surface_matches_repro():
    """``repro_torch.lda.__all__`` is ``repro.lda``'s; the D-IVI names are
    present and raise."""
    import repro.lda as jpkg
    import repro_torch.lda as pkg
    from repro_torch.lda import DIVITrainer, make_trainer
    from repro_torch.dist import DIVIConfig
    assert set(pkg.__all__) == set(jpkg.__all__)
    for name in pkg.__all__:
        assert getattr(pkg, name) is not None
    with pytest.raises(NotImplementedError, match="item 6"):
        DIVITrainer()
    _, cfg = _cfgs()
    with pytest.raises(NotImplementedError, match="item 6"):
        make_trainer(cfg, None, algo="sivi", distributed=DIVIConfig())
