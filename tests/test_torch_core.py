"""Port parity, core pieces: the Dirichlet math, the synthetic corpora, the
padded layout and the held-out split, held against ``repro`` on the same
numpy inputs."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bound as jbound
from repro.core import math as jmath
from repro.core.predictive import log_predictive as j_log_predictive
from repro.core.predictive import split_heldout as j_split_heldout
from repro.core.types import LDAConfig as JConfig
from repro.data import PAPER_CORPORA as J_CORPORA
from repro.data import make_corpus as j_make_corpus
from repro.data.bow import corpus_from_docs as j_corpus_from_docs
from repro_torch.core import bound as tbound
from repro_torch.core import math as tmath
from repro_torch.core.predictive import log_predictive, split_heldout
from repro_torch.core.types import Corpus, LDAConfig
from repro_torch.data.bow import corpus_from_docs
from repro_torch.data.synthetic import PAPER_CORPORA, make_corpus

CPU = "cpu"


def _pos(seed, shape):
    return np.random.default_rng(seed).gamma(2.0, 1.0, shape).astype(
        np.float32) + 0.05


@pytest.mark.parametrize("axis", [0, -1])
def test_dirichlet_expectations_match(axis):
    a = _pos(0, (37, 11))
    for name in ("dirichlet_expectation", "exp_dirichlet_expectation"):
        want = np.asarray(getattr(jmath, name)(jnp.asarray(a), axis=axis))
        got = getattr(tmath, name)(torch.from_numpy(a), axis=axis).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("axis", [0, -1])
def test_dirichlet_elbo_term_matches(axis):
    post = _pos(1, (23, 9))
    elog = np.array(jmath.dirichlet_expectation(jnp.asarray(post),
                                                axis=axis))
    want = float(jmath.dirichlet_elbo_term(jnp.asarray(post), 0.3,
                                           jnp.asarray(elog), axis=axis))
    got = float(tmath.dirichlet_elbo_term(torch.from_numpy(post), 0.3,
                                          torch.from_numpy(elog), axis=axis))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_safe_normalize_matches():
    x = _pos(2, (13, 7))
    want = np.asarray(jmath.safe_normalize(jnp.asarray(x)))
    got = tmath.safe_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _assert_corpus_equal(got: Corpus, want) -> None:
    np.testing.assert_array_equal(got.token_ids.numpy(),
                                  np.asarray(want.token_ids))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    assert got.token_ids.dtype == torch.int32
    assert got.counts.dtype == torch.float32


@pytest.mark.parametrize("name,split,scale", [
    ("tiny", "train", 1.0), ("tiny", "test", 1.0), ("small", "train", 1.0),
    # 8 documents at the full Arxiv vocabulary: exercises the cached
    # per-topic CDF over V = 141,927
    ("arxiv", "train", 1e-6),
])
def test_make_corpus_bit_equal(name, split, scale):
    assert (dataclasses.astuple(PAPER_CORPORA[name])
            == dataclasses.astuple(J_CORPORA[name]))
    got = make_corpus(PAPER_CORPORA[name], split=split, seed=3, scale=scale,
                      device=CPU)
    want = j_make_corpus(J_CORPORA[name], split=split, seed=3, scale=scale)
    _assert_corpus_equal(got, want)


@pytest.mark.parametrize("max_unique", [None, 6])
def test_corpus_from_docs_bit_equal(max_unique):
    rng = np.random.default_rng(5)
    docs = [rng.integers(0, 90, size=rng.integers(1, 30)) for _ in range(17)]
    got = corpus_from_docs(docs, 90, max_unique, device=CPU)
    _assert_corpus_equal(got, j_corpus_from_docs(docs, 90, max_unique))


def test_split_heldout_bit_equal():
    spec = PAPER_CORPORA["tiny"]
    corpus = make_corpus(spec, split="test", seed=0, device=CPU)
    jcorpus = j_make_corpus(J_CORPORA["tiny"], split="test", seed=0)
    for got, want in zip(split_heldout(corpus, seed=4),
                         j_split_heldout(jcorpus, seed=4)):
        _assert_corpus_equal(got, want)


def _bound_inputs():
    """A tiny corpus in both packages, with λ, γ and a memo-like π."""
    spec = PAPER_CORPORA["tiny"]
    corpus = make_corpus(spec, seed=1, device=CPU)
    jcorpus = j_make_corpus(J_CORPORA["tiny"], seed=1)
    rng = np.random.default_rng(9)
    d, l = corpus.token_ids.shape
    lam = rng.gamma(100.0, 0.01, (spec.vocab_size, 8)).astype(np.float32)
    gamma = _pos(3, (d, 8))
    pi = rng.random((d, l, 8)).astype(np.float32)
    pi *= (corpus.counts.numpy() > 0)[:, :, None]
    pi /= np.maximum(pi.sum(-1, keepdims=True), 1e-30)
    cfgs = (JConfig(num_topics=8, vocab_size=spec.vocab_size),
            LDAConfig(num_topics=8, vocab_size=spec.vocab_size))
    return corpus, jcorpus, lam, gamma, pi, cfgs


def test_bounds_match():
    """The memoized and collapsed ELBOs against ``repro`` (rtol 1e-5: sums
    of ~1e4 fp32 terms in another order)."""
    corpus, jcorpus, lam, gamma, pi, (jcfg, tcfg) = _bound_inputs()
    want = float(jbound.elbo_memoized(jcfg, jcorpus, jnp.asarray(gamma),
                                      jnp.asarray(pi), jnp.asarray(lam)))
    got = float(tbound.elbo_memoized(tcfg, corpus, torch.from_numpy(gamma),
                                     torch.from_numpy(pi),
                                     torch.from_numpy(lam)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    want = float(jbound.elbo_collapsed(jcfg, jcorpus, jnp.asarray(gamma),
                                       jnp.asarray(lam)))
    got = float(tbound.elbo_collapsed(tcfg, corpus, torch.from_numpy(gamma),
                                      torch.from_numpy(lam)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_log_predictive_matches():
    """Held-out LPP against ``repro`` (rtol 1e-4: its γ comes from a fixed
    point stopped at ``estep_tol``)."""
    corpus, jcorpus, lam, _, _, (jcfg, tcfg) = _bound_inputs()
    obs, held = split_heldout(corpus, seed=2)
    jobs, jheld = j_split_heldout(jcorpus, seed=2)
    want = float(j_log_predictive(jcfg, jnp.asarray(lam), jobs, jheld))
    got = float(log_predictive(tcfg, torch.from_numpy(lam), obs, held))
    np.testing.assert_allclose(got, want, rtol=1e-4)
