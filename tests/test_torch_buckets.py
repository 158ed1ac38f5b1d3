"""Port parity, corpus-side length buckets: ``bucket_corpus``,
``bucket_padding_stats`` and ``pad_corpus`` equal ``repro``'s, the bucketed
epoch draws ``repro``'s batches (rows and widths) from the same seed, and
bucketed training tracks ``repro``'s (λ at rtol/atol 1e-3, the bar of
``tests/test_torch_engine.py``)."""
import jax
import numpy as np
import pytest

from repro.core import LDAConfig as JConfig
from repro.core import LDAEngine as JEngine
from repro.core.types import init_global_state as j_init_global_state
from repro.data import PAPER_CORPORA as J_CORPORA
from repro.data import bow as j_bow
from repro.data import make_corpus as j_make_corpus
from repro_torch.core.engines import LDAEngine
from repro_torch.core.types import LDAConfig
from repro_torch.data import bow
from repro_torch.data.synthetic import PAPER_CORPORA, make_corpus

CPU = "cpu"


def _corpora(name, seed=0):
    return (j_make_corpus(J_CORPORA[name], seed=seed),
            make_corpus(PAPER_CORPORA[name], seed=seed, device=CPU))


def _ragged(seed=5, n=70, vocab=300):
    """Lengths spread over several ladder rungs, two empty documents."""
    rng = np.random.default_rng(seed)
    docs = [rng.integers(0, vocab, size=int(rng.integers(1, 90)))
            for _ in range(n)]
    docs[3] = docs[40] = np.zeros(0, np.int64)
    return (j_bow.corpus_from_docs(docs, vocab),
            bow.corpus_from_docs(docs, vocab, device=CPU))


@pytest.mark.parametrize("which", ["tiny", "ragged"])
def test_buckets_and_padding_stats_equal_repro(which):
    jc, tc = _corpora("tiny") if which == "tiny" else _ragged()
    jb, tb = j_bow.bucket_corpus(jc), bow.bucket_corpus(tc)
    assert tb.widths == jb.widths and tb.num_buckets == jb.num_buckets
    for got, want in zip(tb.doc_idx, jb.doc_idx):
        np.testing.assert_array_equal(got, want)
    covered = np.sort(np.concatenate(tb.doc_idx))
    np.testing.assert_array_equal(covered, np.arange(tc.num_docs))
    stats = bow.bucket_padding_stats(tc, tb)
    assert stats == j_bow.bucket_padding_stats(jc, jb)
    assert stats["slot_ratio"] <= 1.0
    jb16 = j_bow.bucket_corpus(jc, boundaries=(4, 16))
    tb16 = bow.bucket_corpus(tc, boundaries=(4, 16))
    assert tb16.widths == jb16.widths


def test_pad_corpus_equals_repro():
    jc, tc = _ragged()
    for n in (10, 70, 75):
        jp, tp = j_bow.pad_corpus(jc, n), bow.pad_corpus(tc, n)
        np.testing.assert_array_equal(tp.token_ids.numpy(),
                                      np.asarray(jp.token_ids))
        np.testing.assert_array_equal(tp.counts.numpy(), np.asarray(jp.counts))
    assert bow.pad_corpus(tc, 10) is tc


def _pair(algo, batch=16, seed=0, **kw):
    jc, tc = _corpora("tiny")
    v = PAPER_CORPORA["tiny"].vocab_size
    jcfg = JConfig(num_topics=6, vocab_size=v, estep_max_iters=50)
    tcfg = LDAConfig(num_topics=6, vocab_size=v, estep_max_iters=50)
    jeng = JEngine(jcfg, jc, algo=algo, batch_size=batch, seed=seed, **kw)
    teng = LDAEngine(tcfg, tc, algo=algo, batch_size=batch, seed=seed,
                     device=CPU, lam0=np.array(j_init_global_state(
                         jcfg, jax.random.key(seed)).lam), **kw)
    return jeng, teng


@pytest.mark.parametrize("bucketed", [True, False])
def test_epoch_batches_equal_repro(bucketed):
    """Three epochs' (rows, width) pairs from the same seed: ``repro``'s rng
    draws in ``repro``'s order."""
    jeng, teng = _pair("ivi", batch=12, seed=3, bucket_by_length=bucketed)
    assert teng.bucket_stats == jeng.bucket_stats
    for _ in range(3):
        jb, tb = jeng.epoch_batches(), teng.epoch_batches()
        assert len(tb) == len(jb)
        for (trows, tw), (jrows, jw) in zip(tb, jb):
            np.testing.assert_array_equal(trows, jrows)
            assert tw == jw
        if bucketed:
            assert {w for _, w in tb} == set(teng._buckets.widths)
        else:
            assert {w for _, w in tb} == {None}


@pytest.mark.parametrize("algo", ["ivi", "svi"])
def test_bucketed_training_tracks_repro(algo):
    """Two bucketed epochs: every document visited once an epoch, batches at
    their bucket widths, λ within 1e-3 of ``repro``'s."""
    jeng, teng = _pair(algo, bucket_by_length=True)
    for epoch in (1, 2):
        jeng.run_epoch()
        teng.run_epoch()
        assert teng.docs_seen == jeng.docs_seen == epoch * 96
        np.testing.assert_allclose(teng.state.lam.numpy(),
                                   np.asarray(jeng.state.lam), rtol=1e-3,
                                   atol=1e-3)
    if algo == "ivi":
        assert bool(teng.memo.visited.all())
        assert float(teng.state.init_frac) == 0.0
