"""Port parity, serving: ``repro_torch.lda.TopicInferencer`` against
``repro.lda.TopicInferencer`` on the same λ, on both layouts; the
double-buffered path bit-equal to the synchronous one; ``swap_model``
under a concurrent swapper; the bookkeeping.

Tolerances: γ at ``tests/test_torch_estep.py``'s backend bar, rtol 2e-3 /
atol 2e-3 (the fixed points stop at a mean |Δγ| of ``estep_tol``, so two
packages agree to about that); θ̄ likewise; bookkeeping (padding, widths,
versions) exactly.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LDAConfig as JConfig
from repro.data import PAPER_CORPORA as J_CORPORA
from repro.data import make_corpus as j_make_corpus
from repro.data.stream import CorpusDocStream as JStream
from repro.lda import TopicInferencer as JInferencer
from repro_torch.core.types import LDAConfig
from repro_torch.data.stream import BatchPacker, CorpusDocStream
from repro_torch.data.synthetic import PAPER_CORPORA, make_corpus
from repro_torch.lda import TopicInferencer, topic_posterior

CPU = "cpu"
SPEC = PAPER_CORPORA["tiny"]
K = 6


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(3)
    lam = rng.gamma(2.0, 0.5, (SPEC.vocab_size, K)).astype(np.float32)
    lam2 = rng.gamma(2.0, 0.5, (SPEC.vocab_size, K)).astype(np.float32)
    return (lam, lam2, j_make_corpus(J_CORPORA["tiny"], split="test", seed=0),
            make_corpus(SPEC, split="test", seed=0, device=CPU),
            make_corpus(SPEC, seed=0, device=CPU))


def _cfgs(backend="gather", jbackend="gather"):
    kw = dict(num_topics=K, vocab_size=SPEC.vocab_size, estep_max_iters=50)
    return (JConfig(estep_backend=jbackend, **kw),
            LDAConfig(estep_backend=backend, **kw))


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("backend", ["gather", "cuda"])
@pytest.mark.parametrize("layout", ["padded", "csr"])
def test_posterior_matches_repro(setup, backend, layout):
    """``posterior`` and ``posterior_docs`` (both paths) against ``repro``'s
    gather inferencer on the same λ; padding and widths as ``repro``'s."""
    lam, _, jtest, test, _ = setup
    jcfg, cfg = _cfgs(backend)
    kw = dict(batch_size=8, layout=layout)
    if layout == "csr":
        kw["token_budget"] = 128
    jinf = JInferencer(jcfg, jnp.asarray(lam), **kw)
    inf = TopicInferencer(cfg, lam, device=CPU, **kw)
    want = jinf.posterior(jtest)
    _close(inf.posterior(test), want)
    assert inf.padding_stats() == jinf.padding_stats()
    assert (inf.cache_info()["batches_per_width"]
            == jinf.cache_info()["batches_per_width"])
    want_docs = jinf.posterior_docs(JStream(jtest))
    for double_buffer in (True, False):
        got = inf.posterior_docs(CorpusDocStream(test),
                                 double_buffer=double_buffer)
        _close(got, want_docs)
    _close(inf.transform(test), jinf.transform(jtest))


@pytest.mark.parametrize("layout", ["padded", "csr"])
def test_double_buffer_bit_equal_to_synchronous(setup, layout):
    lam, _, _, test, train = setup
    _, cfg = _cfgs("cuda")
    inf = TopicInferencer(cfg, lam, batch_size=16, layout=layout,
                          token_budget=256 if layout == "csr" else None,
                          device=CPU)
    docs = [(ids[c > 0].numpy(), c[c > 0].numpy())
            for ids, c in zip(train.token_ids, train.counts)]
    a = inf.posterior_docs(docs, double_buffer=True)
    b = inf.posterior_docs(docs, double_buffer=False)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (train.num_docs, K)
    np.testing.assert_array_equal(inf.posterior_docs(docs[:0]),
                                  np.zeros((0, K), np.float32))


def test_posterior_packed_and_packer_kwargs(setup):
    """A batch packed with ``packer_kwargs`` gives ``posterior_docs``'s bits
    and reports the snapshot's version."""
    lam, _, _, test, _ = setup
    _, cfg = _cfgs("cuda")
    inf = TopicInferencer(cfg, lam, batch_size=8, device=CPU)
    packer = BatchPacker(**inf.packer_kwargs())
    stream = CorpusDocStream(test)
    batches = [b for b in (packer.add(p, i, c) for p, (i, c)
                           in enumerate(stream.iter_from(0))) if b]
    batches += packer.flush()
    want = inf.posterior_docs(CorpusDocStream(test))
    for batch in batches:
        rows, gamma, n, version = inf.posterior_packed(batch)
        assert version == 0
        np.testing.assert_array_equal(gamma[:n].numpy(), want[rows])


def test_swap_model_under_traffic(setup):
    """A swapper thread flips between two snapshots while batches are
    served: each batch's γ is the result of the snapshot whose version it
    reports, and the versions only advance."""
    lam, lam2, _, test, _ = setup
    _, cfg = _cfgs("cuda")
    inf = TopicInferencer(cfg, lam, batch_size=4, device=CPU)
    want = {0: TopicInferencer(cfg, lam, batch_size=4, device=CPU),
            1: TopicInferencer(cfg, lam2, batch_size=4, device=CPU)}
    packer = BatchPacker(**inf.packer_kwargs())
    batches = [b for b in (packer.add(p, i, c) for p, (i, c)
                           in enumerate(CorpusDocStream(test).iter_from(0)))
               if b] + packer.flush()
    stop = threading.Event()

    def swapper():
        n = 0
        while not stop.is_set() and n < 200:
            n += 1
            inf.swap_model(lam2 if n % 2 else lam)

    t = threading.Thread(target=swapper)
    t.start()
    seen = []
    try:
        for _ in range(3):
            for batch in batches:
                rows, gamma, n, version = inf.posterior_packed(batch)
                ref = want[version % 2].posterior_packed(batch)[1]
                assert torch.equal(gamma, ref)
                seen.append(version)
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive()
    assert seen == sorted(seen)
    assert inf.model_version >= seen[-1]
    with pytest.raises(ValueError, match="advance"):
        inf.swap_model(lam, version=inf.model_version)
    with pytest.raises(ValueError, match="exactly one"):
        inf.swap_model()
    with pytest.raises(ValueError, match="geometry"):
        inf.swap_model(lam[:, :2])


def test_inferencer_refusals_and_one_shot(setup):
    lam, _, jtest, test, _ = setup
    jcfg, cfg = _cfgs()
    with pytest.raises(NotImplementedError, match="item 8"):
        TopicInferencer(cfg, lam, tune_store="store.json", device=CPU)
    with pytest.raises(ValueError, match="layout"):
        TopicInferencer(cfg, lam, layout="ragged", device=CPU)
    with pytest.raises(ValueError, match="estep backend"):
        TopicInferencer(cfg, lam, backend="pallas", device=CPU)
    gamma, theta = topic_posterior(cfg, lam, test, batch_size=8, device=CPU)
    jinf = JInferencer(jcfg, jnp.asarray(lam), batch_size=8)
    _close(gamma, jinf.posterior(jtest))
    np.testing.assert_allclose(theta.sum(-1), 1.0, atol=1e-5)
