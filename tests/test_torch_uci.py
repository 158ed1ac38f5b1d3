"""`repro_torch.data.uci` against `repro.data.uci`: the UCI bag-of-words
format, the lazy ``UCIDocStream`` (resume index, ``<path>.idx.npz``
sidecar), ``load_uci``/``save_uci``, stream-fed training on both layouts
and sharded over D-IVI's workers, and ``launch.train --stream
[--docword]``.

The port's tests of ``repro``'s UCI tests (``test_data_pipeline.py``'s
round trip and ``max_docs``, ``test_stream_pipeline.py``'s stream tests,
``test_csr_pipeline.py``'s resume-index tests, ``test_sharded_stream.py``'s
sidecar tests), plus the two packages on one file: the same bytes
written, the same documents and cursors read, sidecars interchangeable.
No UCI file is downloaded: every test writes its own.
"""
import importlib
import os

import numpy as np
import pytest
import torch

from repro.core.types import Corpus as JCorpus
from repro.data import PAPER_CORPORA as J_CORPORA
from repro.data import make_corpus as j_make_corpus
from repro.data.uci import UCIDocStream as JStream
from repro.data.uci import load_uci as j_load_uci
from repro.data.uci import save_uci as j_save_uci
from repro_torch.core.engines import LDAEngine
from repro_torch.core.types import LDAConfig
from repro_torch.data.bow import corpus_from_docs
from repro_torch.data.stream import (BatchPacker, CorpusDocStream,
                                     ShardedDocStream, materialize)
from repro_torch.data.synthetic import PAPER_CORPORA, make_corpus
from repro_torch.data.uci import (UCIDocStream, load_uci, load_vocab,
                                  save_uci)

CPU = "cpu"
SPEC = PAPER_CORPORA["tiny"]


@pytest.fixture(scope="module")
def train():
    return make_corpus(SPEC, split="train", seed=0, device=CPU)


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _docs_equal(got, want):
    assert len(got) == len(want)
    for (gi, gc), (wi, wc) in zip(got, want):
        _same(gi, wi)
        _same(gc, wc)


def _cfg(**kw):
    kw.setdefault("estep_max_iters", 15)
    return LDAConfig(num_topics=4, vocab_size=SPEC.vocab_size, **kw)


def _packer_schedule(stream, batch_size):
    """The batch schedule the stream engine runs."""
    packer = BatchPacker(batch_size, max_width=stream.max_unique)
    out = []
    for pos, (ids, cnts) in enumerate(stream.iter_from(0)):
        b = packer.add(pos, ids, cnts)
        if b is not None:
            out.append(b)
    return out + packer.flush()


# ---------------------------------------------------------------------------
# the format (test_data_pipeline.py)
# ---------------------------------------------------------------------------

def test_uci_roundtrip(tmp_path, train):
    """save_uci → load_uci reproduces the corpus counts exactly."""
    path = os.path.join(tmp_path, "docword.txt.gz")
    save_uci(train, path)
    loaded, vocab = load_uci(path, device=CPU)
    assert vocab == []
    a = np.zeros((train.num_docs, SPEC.vocab_size))
    b = np.zeros_like(a)
    for c, out in ((train, a), (loaded, b)):
        ids, cnt = c.token_ids.numpy(), c.counts.numpy()
        for d in range(ids.shape[0]):
            np.add.at(out[d], ids[d], cnt[d])
    np.testing.assert_array_equal(a, b)


def test_uci_max_docs(tmp_path, train):
    path = os.path.join(tmp_path, "docword.txt")
    save_uci(train, path)
    loaded, _ = load_uci(path, max_docs=10, device=CPU)
    assert loaded.num_docs == 10


def test_load_vocab(tmp_path):
    path = os.path.join(tmp_path, "vocab.txt")
    with open(path, "w") as f:
        f.write("alpha\nbeta\ngamma\n")
    assert load_vocab(path) == ["alpha", "beta", "gamma"]
    assert load_vocab(None) == []
    assert load_vocab(os.path.join(tmp_path, "absent.txt")) == []


# ---------------------------------------------------------------------------
# the two packages on one file
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["docword.txt", "docword.txt.gz"])
def test_same_bytes_as_repro(tmp_path, train, name):
    """A corpus written by either package's ``save_uci`` is the same file
    (the gzip stream decompressed, its header holds a timestamp)."""
    import gzip
    jtrain = j_make_corpus(J_CORPORA["tiny"], seed=0)
    _same(jtrain.token_ids, train.token_ids)
    mine, theirs = (os.path.join(tmp_path, f"{who}_{name}")
                    for who in ("port", "repro"))
    save_uci(train, mine)
    j_save_uci(jtrain, theirs)
    opener = gzip.open if name.endswith(".gz") else open
    with opener(mine, "rb") as a, opener(theirs, "rb") as b:
        assert a.read() == b.read()


def test_same_documents_and_cursors_as_repro(tmp_path, train):
    """Either reader gives the other's documents, at every cursor, and the
    same stats; the materialized loaders the same padded corpus."""
    path = os.path.join(tmp_path, "docword.txt.gz")
    save_uci(train, path)
    mine = UCIDocStream(path, index_every=9, use_index_cache=False)
    theirs = JStream(path, index_every=9, use_index_cache=False)
    assert (mine.num_docs, mine.vocab_size, mine.max_unique,
            mine.num_words) == (theirs.num_docs, theirs.vocab_size,
                                theirs.max_unique, theirs.num_words)
    assert mine._index == theirs._index
    for cursor in (0, 1, 9, 10, 50, mine.num_docs - 1):
        _docs_equal(list(mine.iter_from(cursor)),
                    list(theirs.iter_from(cursor)))
    eager, _ = load_uci(path, device=CPU)
    jeager, _ = j_load_uci(path)
    assert isinstance(jeager, JCorpus)
    _same(eager.token_ids, jeager.token_ids)
    _same(eager.counts, jeager.counts)


@pytest.mark.parametrize("writer", ["port", "repro"])
def test_sidecars_interchangeable(tmp_path, train, writer):
    """A sidecar written by one package serves the other's stream with no
    rescan (the parser disabled to prove it)."""
    path = os.path.join(tmp_path, "docword.txt")
    save_uci(train, path)
    first = (UCIDocStream if writer == "port" else JStream)(path,
                                                            index_every=10)
    stats = (first.num_words, first.max_unique)
    assert os.path.exists(first.index_path)
    other = (JStream if writer == "port" else UCIDocStream)(path,
                                                            index_every=10)
    other._iter_docs = None            # any scan attempt would blow up
    assert (other.num_words, other.max_unique) == stats
    assert other._index == first._index and len(other._index) > 1


# ---------------------------------------------------------------------------
# the lazy stream (test_stream_pipeline.py)
# ---------------------------------------------------------------------------

def test_uci_stream_matches_materialized_loader(tmp_path, train):
    path = os.path.join(tmp_path, "docword.txt.gz")
    save_uci(train, path)
    eager, _ = load_uci(path, device=CPU)
    stream = UCIDocStream(path)
    assert stream.num_docs == eager.num_docs
    assert stream.max_unique == eager.max_unique
    assert stream.num_words == float(eager.counts.sum())
    got = materialize(stream, device=CPU)
    _same(got.token_ids, eager.token_ids)
    _same(got.counts, eager.counts)


def test_uci_stream_cursor_resume(tmp_path, train):
    path = os.path.join(tmp_path, "docword.txt")
    save_uci(train, path)
    stream = UCIDocStream(path)
    full = list(stream.iter_from(0))
    tail = list(stream.iter_from(40))
    assert len(tail) == len(full) - 40
    _docs_equal(tail, full[40:])


def test_uci_stream_empty_doc_gaps(tmp_path):
    """docIDs absent from the file are empty docs: the stream mirrors the
    eager loader's placeholder and keeps positions aligned."""
    path = os.path.join(tmp_path, "docword.txt")
    with open(path, "w") as f:
        f.write("4\n9\n3\n")                   # doc 2 (1-based) is absent
        f.write("1 3 2\n3 5 1\n4 9 4\n")
    eager, _ = load_uci(path, device=CPU)
    stream = UCIDocStream(path)
    got = materialize(stream, device=CPU)
    assert stream.num_docs == 4
    _same(got.token_ids, eager.token_ids)
    _same(got.counts, eager.counts)
    jeager, _ = j_load_uci(path)
    _same(got.token_ids, jeager.token_ids)
    _same(got.counts, jeager.counts)


def test_uci_stream_rejects_ungrouped_lines(tmp_path):
    path = os.path.join(tmp_path, "docword.txt")
    with open(path, "w") as f:
        f.write("2\n10\n3\n")
        f.write("1 5 2\n2 7 1\n1 9 1\n")    # doc 1 resumes after doc 2
    with pytest.raises(ValueError, match="not grouped"):
        list(UCIDocStream(path).iter_from(0))


@pytest.mark.parametrize("layout", ["padded", "csr"])
def test_uci_stream_fed_training_matches_materialized(tmp_path, train,
                                                      layout):
    """IVI fed by the lazy UCI stream == IVI on the eagerly loaded corpus
    under the same schedule: the padded layout by the packer's batches,
    the CSR layout on the corpus viewed as a stream."""
    path = os.path.join(tmp_path, "docword.txt.gz")
    save_uci(train, path)
    eager, _ = load_uci(path, device=CPU)
    stream = UCIDocStream(path)
    lam0 = np.random.default_rng(0).gamma(100.0, 0.01, (SPEC.vocab_size, 4))
    kw = dict(algo="ivi", batch_size=16, seed=0, device=CPU, lam0=lam0,
              layout=layout)
    if layout == "csr":
        kw["token_budget"] = 512
    se = LDAEngine(_cfg(), stream, **kw)
    se.run_epoch()
    if layout == "csr":
        ce = LDAEngine(_cfg(), CorpusDocStream(eager), **kw)
        ce.run_epoch()
    else:
        ce = LDAEngine(_cfg(), eager, **kw)
        for b in _packer_schedule(stream, 16):
            ce.run_minibatch(b.rows, width=b.width)
    _same(se.state.lam, ce.state.lam)
    _same(se.state.m_vk, ce.state.m_vk)


# ---------------------------------------------------------------------------
# the resume index (test_csr_pipeline.py)
# ---------------------------------------------------------------------------

class _CountingFile:
    def __init__(self, f, counter):
        self._f, self._c = f, counter

    def readline(self):
        line = self._f.readline()
        self._c["bytes"] += len(line)
        return line

    def seek(self, off):
        return self._f.seek(off)

    def tell(self):
        return self._f.tell()

    def __enter__(self):
        self._f.__enter__()
        return self

    def __exit__(self, *a):
        return self._f.__exit__(*a)


def test_uci_deep_resume_touches_o1_leading_bytes(tmp_path, monkeypatch):
    """iter_from(deep cursor) seeks to the nearest indexed docID group: the
    same documents as a full scan, from a small tail of the file."""
    rng = np.random.default_rng(11)
    docs = [rng.integers(0, 120, size=int(rng.integers(1, 12)))
            for _ in range(240)]
    corpus = corpus_from_docs(docs, 120, device=CPU)
    path = os.path.join(tmp_path, "docword.txt")
    save_uci(corpus, path)
    size = os.path.getsize(path)
    stream = UCIDocStream(path, index_every=20)
    full = list(stream.iter_from(0))
    assert stream.num_words > 0          # stats scan done: index is built
    uci_mod = importlib.import_module("repro_torch.data.uci")
    counter = {"bytes": 0}
    real_open = uci_mod._open_binary
    monkeypatch.setattr(uci_mod, "_open_binary",
                        lambda p: _CountingFile(real_open(p), counter))
    got = list(stream.iter_from(230))
    _docs_equal(got, full[230:])
    assert 0 < counter["bytes"] < size // 4, (counter["bytes"], size)
    counter["bytes"] = 0
    got1 = list(stream.iter_from(1))
    assert len(got1) == len(full) - 1
    _same(got1[0][0], full[1][0])


def test_uci_resume_index_equivalence_every_boundary(tmp_path):
    rng = np.random.default_rng(13)
    docs = [rng.integers(0, 50, size=int(rng.integers(0, 6)))
            for _ in range(103)]                     # empty docs included
    corpus = corpus_from_docs(docs, 50, device=CPU)
    path = os.path.join(tmp_path, "docword.txt.gz")
    save_uci(corpus, path)
    stream = UCIDocStream(path, index_every=25)
    full = list(stream.iter_from(0))
    for cursor in (0, 1, 24, 25, 26, 49, 75, 102):
        _docs_equal(list(stream.iter_from(cursor)), full[cursor:])


# ---------------------------------------------------------------------------
# the sidecar (test_sharded_stream.py)
# ---------------------------------------------------------------------------

def _write_uci(tmp_path, seed=0):
    corpus = make_corpus(SPEC, seed=seed, device=CPU)
    path = str(tmp_path / "docword.txt")
    save_uci(corpus, path)
    return path


def test_uci_sidecar_persists_and_serves_the_scan(tmp_path):
    path = _write_uci(tmp_path)
    s1 = UCIDocStream(path, index_every=10)
    words, maxu = s1.num_words, s1.max_unique
    assert os.path.exists(s1.index_path)
    s2 = UCIDocStream(path, index_every=10)
    s2._iter_docs = None               # any scan attempt would now blow up
    assert (s2.num_words, s2.max_unique) == (words, maxu)
    assert s2._index == s1._index and len(s2._index) > 1


def test_uci_sidecar_invalidated_on_file_change(tmp_path):
    path = _write_uci(tmp_path)
    words = UCIDocStream(path, index_every=10).num_words
    _write_uci(tmp_path, seed=9)
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))
    s2 = UCIDocStream(path, index_every=10)
    assert s2.num_words != words       # stale sidecar ignored, rescanned
    s3 = UCIDocStream(path, index_every=5)
    assert s3.num_words == s2.num_words
    assert len(s3._index) > len(s2._index)


def test_uci_sidecar_resume_matches_full_read(tmp_path):
    path = _write_uci(tmp_path)
    full = list(UCIDocStream(path, index_every=7).iter_from(0))
    r = UCIDocStream(path, index_every=7)
    for cursor in (13, 40, 95):
        _docs_equal(list(r.iter_from(cursor)), full[cursor:])


def test_uci_opt_out_skips_sidecar(tmp_path):
    path = _write_uci(tmp_path)
    s = UCIDocStream(path, use_index_cache=False)
    s.num_words
    assert not os.path.exists(s.index_path)


def test_uci_stream_shards_over_divi_workers(tmp_path, train):
    """D-IVI shards a UCI stream into worker views: the same deal and
    documents as sharding the corpus itself."""
    path = os.path.join(tmp_path, "docword.txt")
    save_uci(train, path)
    a = ShardedDocStream(UCIDocStream(path), 4, partitioner="hash", seed=3)
    b = ShardedDocStream(CorpusDocStream(train), 4, partitioner="hash",
                         seed=3)
    assert a.shard_sizes == b.shard_sizes
    for w in range(4):
        _same(a.positions(w), b.positions(w))
        _docs_equal(list(a.shard(w).iter_from(2)),
                    list(b.shard(w).iter_from(2)))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _launch(monkeypatch, capsys, *extra):
    from repro_torch.launch import train as launcher
    monkeypatch.setattr("sys.argv", [
        "train", "lda", "--corpus", "tiny", "--topics", "4", "--device",
        "cpu", "--batch", "16", "--estep-iters", "10", *extra])
    launcher.main()
    return capsys.readouterr().out


def test_launch_stream_docword(tmp_path, monkeypatch, capsys, train):
    """``--stream --docword`` trains from the file: the run's λ is the one
    a facade run over the same stream reaches."""
    from repro_torch.lda import LDA
    path = os.path.join(tmp_path, "docword.txt.gz")
    save_uci(train, path)
    ck = os.path.join(tmp_path, "ck")
    out = _launch(monkeypatch, capsys, "--stream", "--docword", path,
                  "--epochs", "1", "--ckpt", ck)
    assert f"stream={path}" in out and "stream_padding_stats" in out
    want = LDA(LDAConfig(num_topics=4, vocab_size=SPEC.vocab_size,
                         estep_max_iters=10, estep_backend="cuda"),
               algo="ivi", batch_size=16, device=CPU).fit(
        UCIDocStream(path), epochs=1)
    _same(LDA.load(ck, device=CPU).lam, want.lam)


def test_launch_stream_writes_synthetic_and_divi(tmp_path, monkeypatch,
                                                 capsys):
    """``--stream`` alone writes the synthetic corpus in UCI format and
    streams it back; ``--algo divi --stream`` shards it over the
    workers."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    out = _launch(monkeypatch, capsys, "--stream", "--epochs", "1")
    assert any(p.name.startswith("lda_stream_") for p in tmp_path.iterdir())
    assert "stream=" in out and "docword.txt.gz" in out
    out = _launch(monkeypatch, capsys, "--stream", "--algo", "divi",
                  "--workers", "2", "--rounds", "2", "--eval-every", "1")
    assert "workers=2" in out


def test_launch_stream_refusals(tmp_path, monkeypatch, capsys):
    with pytest.raises(SystemExit, match="mini-batch"):
        _launch(monkeypatch, capsys, "--stream", "--algo", "mvi")
    with pytest.raises(SystemExit, match="goes with --stream"):
        _launch(monkeypatch, capsys, "--docword", "x.txt")


def test_materialized_loader_lands_on_the_device(tmp_path, train):
    path = os.path.join(tmp_path, "docword.txt")
    save_uci(train, path)
    loaded, _ = load_uci(path, device=CPU)
    assert loaded.token_ids.dtype == torch.int32
    assert loaded.counts.dtype == torch.float32
    assert loaded.token_ids.device.type == "cpu"
