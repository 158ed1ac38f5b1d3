"""Port parity, stream ingest: the port's ``repro_torch.data.stream`` emits
what ``repro.data.stream`` emits on the same ragged documents, bit for bit,
in both packer layouts, and its streams and utilities agree with
``repro``'s."""
import numpy as np
import pytest
import torch

from repro.data import PAPER_CORPORA as J_CORPORA
from repro.data import make_corpus as j_make_corpus
from repro.data import stream as j_stream
from repro_torch.data import stream
from repro_torch.data.synthetic import PAPER_CORPORA, make_corpus

CPU = "cpu"
BATCH_FIELDS = {"padded": ("rows", "token_ids", "counts"),
                "csr": ("rows", "token_ids", "counts", "segments",
                        "offsets")}


def _ragged_docs(seed, n=60, vocab=500, max_len=40):
    """Ragged unique-id documents: empty, single-token and long ones."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        ln = [0, 1][i % 2] if i % 7 == 0 else int(rng.integers(0, max_len))
        ids = np.sort(rng.choice(vocab, size=ln, replace=False))
        cnts = (rng.poisson(1.0, ln) + 1).astype(np.float32)
        docs.append((ids.astype(np.int32), cnts))
    return docs


def _pack(module, docs, layout, **kw):
    packer = module.BatchPacker(6, layout=layout, **kw)
    out = []
    for pos, (ids, cnts) in enumerate(docs):
        b = packer.add(pos, ids, cnts)
        if b is not None:
            out.append(b)
    return out, packer


def _assert_batches_equal(got, want, layout):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        for f in BATCH_FIELDS[layout]:
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b)
        if layout == "csr":
            assert g.token_budget == w.token_budget
        else:
            assert g.width == w.width


@pytest.mark.parametrize("layout,kw", [
    ("padded", {"max_width": 24}),
    ("padded", {}),                          # serving: open ladder
    ("csr", {"max_width": 24, "token_budget": 64}),
    ("csr", {"token_budget": 30}),           # docs clipped to the budget
])
@pytest.mark.parametrize("seed", [0, 5])
def test_packer_schedule_bit_equals_repro(layout, kw, seed):
    """The same schedule as ``repro``'s packer: every batch's rows, ids,
    counts (and segments, offsets) bit for bit, the same pending documents
    and their round trip, and the same padding stats."""
    docs = _ragged_docs(seed)
    got, tp = _pack(stream, docs, layout, **kw)
    want, jp = _pack(j_stream, docs, layout, **kw)
    _assert_batches_equal(got + tp.flush(), want + jp.flush(), layout)
    assert tp.padding_stats() == jp.padding_stats()

    _, tp = _pack(stream, docs[:41], layout, **kw)
    _, jp = _pack(j_stream, docs[:41], layout, **kw)
    pend, jpend = tp.pending_docs(), jp.pending_docs()
    assert len(pend) == len(jpend) > 0
    for (p, i, c), (jpos, ji, jc) in zip(pend, jpend):
        assert p == jpos
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_array_equal(c, jc)
    resumed = stream.BatchPacker(6, layout=layout, **kw)
    resumed.load_pending(pend)
    _assert_batches_equal(resumed.flush(), jp.flush(), layout)


def test_packer_resumed_schedule_matches_uninterrupted():
    """Pack half the stream, persist ``pending_docs``, restore into a fresh
    packer: the rest of the schedule equals the uninterrupted one."""
    docs = _ragged_docs(3)
    full, _ = _pack(stream, docs, "csr", max_width=24, token_budget=64)
    first, a = _pack(stream, docs[:30], "csr", max_width=24, token_budget=64)
    b = stream.BatchPacker(6, layout="csr", max_width=24, token_budget=64)
    b.load_pending(a.pending_docs())
    rest = [x for pos, (i, c) in enumerate(docs[30:], start=30)
            if (x := b.add(pos, i, c)) is not None]
    _assert_batches_equal(first + rest, full, "csr")


def test_packer_refusals_match_repro():
    for module in (stream, j_stream):
        with pytest.raises(ValueError, match="token_budget"):
            module.BatchPacker(8, layout="csr")
        with pytest.raises(ValueError, match="layout"):
            module.BatchPacker(8, layout="ragged")
        with pytest.raises(ValueError, match="vocabulary"):
            module.BatchPacker(8, vocab_size=10).add(
                0, np.array([3, 12], np.int32), np.ones(2, np.float32))
        p = module.BatchPacker(2, max_width=8)
        p.add(0, np.array([1], np.int32), np.ones(1, np.float32))
        with pytest.raises(ValueError, match="fresh"):
            p.load_pending([])


@pytest.mark.parametrize("max_width", [1, 5, 8, 24, 163, 512, 700])
def test_width_ladder_matches_repro(max_width):
    assert stream.width_ladder(max_width) == j_stream.width_ladder(max_width)
    packer = stream.BatchPacker(4, max_width=max_width)
    jpacker = j_stream.BatchPacker(4, max_width=max_width)
    for n in (0, 1, 7, 9, 100, 600, 2000):
        assert packer.width_for(n) == jpacker.width_for(n)


def test_bucket_rows_matches_repro():
    rng = np.random.default_rng(2)
    counts = (rng.random((40, 70)) < 0.3).astype(np.float32)
    counts[3] = 0.0                                  # an empty row
    counts[5, 1::2] = 0.0                            # interleaved zeros
    got = stream.bucket_rows(counts)
    want = j_stream.bucket_rows(counts)
    assert [w for _, w in got] == [w for _, w in want]
    for (a, _), (b, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_corpus_doc_stream_matches_repro_and_materializes_back():
    spec = PAPER_CORPORA["tiny"]
    corpus = make_corpus(spec, seed=0, device=CPU)
    jcorpus = j_make_corpus(J_CORPORA["tiny"], seed=0)
    s = stream.CorpusDocStream(corpus, spec.vocab_size)
    js = j_stream.CorpusDocStream(jcorpus, spec.vocab_size)
    assert (s.num_docs, s.max_unique, s.vocab_size) == \
        (js.num_docs, js.max_unique, js.vocab_size)
    assert s.num_words == js.num_words
    for (a, b), (c, d) in zip(s.iter_from(7), js.iter_from(7)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    back = stream.materialize(s, device=CPU)
    assert torch.equal(back.token_ids, corpus.token_ids)
    assert torch.equal(back.counts, corpus.counts)


def test_list_stream_and_ragged_docs_match_repro():
    raw = [[3, 3, 1], (np.array([4, 2]), np.array([1.0, 5.0])), [], [7]]
    s = stream.ListDocStream(raw, 10)
    js = j_stream.ListDocStream(raw, 10)
    assert (s.num_docs, s.num_words, s.max_unique) == \
        (js.num_docs, js.num_words, js.max_unique)
    for (a, b), (c, d) in zip(s.iter_from(0), js.iter_from(0)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    back = stream.materialize(s, max_unique=1, device=CPU)
    jback = j_stream.materialize(js, max_unique=1)
    np.testing.assert_array_equal(back.token_ids.numpy(),
                                  np.asarray(jback.token_ids))
    np.testing.assert_array_equal(back.counts.numpy(),
                                  np.asarray(jback.counts))


def test_iter_padded_chunks_matches_repro():
    docs = _ragged_docs(9, n=23)
    s = stream.ListDocStream(docs, 500)
    js = j_stream.ListDocStream(docs, 500)
    got = list(stream.iter_padded_chunks(s, 5, s.max_unique))
    want = list(j_stream.iter_padded_chunks(js, 5, js.max_unique))
    assert len(got) == len(want) == 5
    for (a, b, c), (d, e, f) in zip(got, want):
        assert a == d
        np.testing.assert_array_equal(b, e)
        np.testing.assert_array_equal(c, f)
