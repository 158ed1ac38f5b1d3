"""Port parity, streaming shards (D-IVI's ingest): ``ShardedDocStream``,
``ShardDocStream`` and ``WorkerIngest`` against ``repro``'s, bit for bit.

* The partition: the same shard assignment, local positions and shard
  sizes under both partitioners (a hypothesis property beside
  ``tests/test_sharded_stream.py``'s), every document in exactly one shard.
* Shard iteration, per-shard packing in both layouts, and the workers'
  batches, cursors and pass counts equal ``repro``'s.
* The refusals: bad shard counts, an engine whose worker count is not the
  shard count, a checkpoint with another assignment.
* ``WorkerIngest`` mid-batch capture → restore, and a ``DIVITrainer``
  mid-pass save → resume, bit-equal to the run that never stopped.

Every comparison here is exact: the ingest is integer bookkeeping and
copies of the same float32 counts.
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.data import PAPER_CORPORA as J_CORPORA
from repro.data import ShardedDocStream as JSharded
from repro.data import make_corpus as j_make_corpus
from repro.data.stream import CorpusDocStream as JCorpusDocStream
from repro.data.stream import ListDocStream as JListDocStream
from repro.dist import WorkerIngest as JWorkerIngest
from repro_torch.core.types import LDAConfig
from repro_torch.data.stream import (SHARD_PARTITIONERS, CorpusDocStream,
                                     ListDocStream, ShardedDocStream)
from repro_torch.data.synthetic import PAPER_CORPORA, make_corpus
from repro_torch.dist import DIVIConfig, DIVIEngine, WorkerIngest
from repro_torch.lda.trainer import DIVITrainer

CPU = "cpu"
SPEC = PAPER_CORPORA["tiny"]


def _docs(num_docs, rng):
    return [rng.integers(0, 50, size=rng.integers(1, 12))
            for _ in range(num_docs)]


@pytest.fixture(scope="module")
def corpora():
    return (make_corpus(SPEC, seed=0, device=CPU),
            j_make_corpus(J_CORPORA["tiny"], seed=0))


def _same_batch(a, b):
    np.testing.assert_array_equal(a.rows, b.rows)
    np.testing.assert_array_equal(a.token_ids, b.token_ids)
    np.testing.assert_array_equal(a.counts, b.counts)
    assert a.width == b.width


# ---------------------------------------------------------------------------
# the partition
# ---------------------------------------------------------------------------

@settings(max_examples=25)
@given(num_docs=st.integers(min_value=1, max_value=173),
       num_shards=st.integers(min_value=1, max_value=9),
       partitioner=st.sampled_from(SHARD_PARTITIONERS),
       seed=st.integers(min_value=0, max_value=5))
def test_assignment_is_repros(num_docs, num_shards, partitioner, seed):
    from hypothesis import assume
    assume(num_shards <= num_docs)
    docs = _docs(num_docs, np.random.default_rng(num_docs))
    got = ShardedDocStream(ListDocStream(docs, vocab_size=50), num_shards,
                           partitioner=partitioner, seed=seed)
    want = JSharded(JListDocStream(docs, vocab_size=50), num_shards,
                    partitioner=partitioner, seed=seed)
    for w in range(num_shards):
        np.testing.assert_array_equal(got.positions(w), want.positions(w))
        assert (np.diff(got.positions(w)) > 0).all()
    assert got.shard_sizes == want.shard_sizes
    assert max(got.shard_sizes) - min(got.shard_sizes) <= 1
    np.testing.assert_array_equal(
        np.sort(np.concatenate([got.positions(w)
                                for w in range(num_shards)])),
        np.arange(num_docs))
    assert got.signature() == want.signature()


def test_range_partition_covers_corpus_in_order(corpora):
    train, _ = corpora
    sharded = ShardedDocStream(CorpusDocStream(train), 4)
    pos = np.concatenate([sharded.positions(w) for w in range(4)])
    np.testing.assert_array_equal(pos, np.arange(train.num_docs))
    assert sharded.shard_sizes == [24, 24, 24, 24]
    ids, _ = next(sharded.shard(1).iter_from(0))
    row = train.token_ids[24].numpy()
    np.testing.assert_array_equal(ids, row[train.counts[24].numpy() > 0])


@pytest.mark.parametrize("partitioner", SHARD_PARTITIONERS)
def test_shard_iteration_is_repros(corpora, partitioner):
    """Each shard yields ``repro``'s documents in ``repro``'s order, from
    the start and from a mid-shard cursor."""
    train, jtrain = corpora
    got = ShardedDocStream(CorpusDocStream(train), 3,
                           partitioner=partitioner, seed=2)
    want = JSharded(JCorpusDocStream(jtrain), 3, partitioner=partitioner,
                    seed=2)
    for w in range(3):
        sh, jsh = got.shard(w), want.shard(w)
        assert sh.num_docs == jsh.num_docs
        assert sh.num_words == jsh.num_words
        for cursor in (0, sh.num_docs // 2):
            pairs = list(zip(sh.iter_from(cursor), jsh.iter_from(cursor)))
            assert len(pairs) == sh.num_docs - cursor
            for (a, ca), (b, cb) in pairs:
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(ca, cb)


@pytest.mark.parametrize("layout", ["padded", "csr"])
def test_per_shard_packing_is_repros(corpora, layout):
    """Each shard's own packer emits ``repro``'s batches, flush included,
    and one pass covers every document of the shard exactly once."""
    train, jtrain = corpora
    got = ShardedDocStream(CorpusDocStream(train), 3, partitioner="hash",
                           seed=4)
    want = JSharded(JCorpusDocStream(jtrain), 3, partitioner="hash", seed=4)
    kw = dict(layout=layout, token_budget=8 * train.max_unique)
    for w in range(3):
        sh, jsh = got.shard(w), want.shard(w)
        pk, jpk = sh.make_packer(8, **kw), jsh.make_packer(8, **kw)
        seen, out, jout = [], [], []
        for pos, (doc, jdoc) in enumerate(zip(sh.iter_from(0),
                                              jsh.iter_from(0))):
            b, jb = pk.add(pos, *doc), jpk.add(pos, *jdoc)
            assert (b is None) == (jb is None)
            if b is not None:
                out.append(b)
                jout.append(jb)
        out += pk.flush()
        jout += jpk.flush()
        assert len(out) == len(jout)
        for b, jb in zip(out, jout):
            for x, y in zip(b, jb):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
            seen.extend(int(r) for r in b.rows)
        assert sorted(seen) == list(range(sh.num_docs))


@pytest.mark.parametrize("partitioner", SHARD_PARTITIONERS)
def test_worker_ingest_is_repros(corpora, partitioner):
    """``WorkerIngest`` emits ``repro``'s batches across two passes (48-doc
    shards, batch 7: the pass length is no batch multiple), with the same
    cursors, pass counts and pulled tokens."""
    train, jtrain = corpora
    got = ShardedDocStream(CorpusDocStream(train), 2,
                           partitioner=partitioner, seed=11)
    want = JSharded(JCorpusDocStream(jtrain), 2, partitioner=partitioner,
                    seed=11)
    for w in range(2):
        a, b = WorkerIngest(got.shard(w), 7), JWorkerIngest(want.shard(w), 7)
        for _ in range(15):
            _same_batch(a.next_batch(), b.next_batch())
            assert (a.cursor, a.passes, a.docs_pulled, a.tokens_pulled) == \
                (b.cursor, b.passes, b.docs_pulled, b.tokens_pulled)
        assert a.passes == 2
        assert a.capture()[0] == b.capture()[0]


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_sharded_stream_rejects_bad_shard_counts(corpora):
    train, _ = corpora
    stream = CorpusDocStream(train)
    with pytest.raises(ValueError, match="1 <= num_shards"):
        ShardedDocStream(stream, 0)
    with pytest.raises(ValueError, match="1 <= num_shards"):
        ShardedDocStream(stream, train.num_docs + 1)
    with pytest.raises(ValueError, match="unknown partitioner"):
        ShardedDocStream(stream, 2, partitioner="modulo")


def test_engine_rejects_shard_count_mismatch(corpora):
    train, _ = corpora
    cfg = LDAConfig(num_topics=8, vocab_size=SPEC.vocab_size,
                    estep_max_iters=20)
    sharded = ShardedDocStream(CorpusDocStream(train), 3)
    with pytest.raises(ValueError, match="3 shards .* 4 workers"):
        DIVIEngine(cfg, DIVIConfig(num_workers=4, batch_size=8), sharded,
                   device=CPU)
    with pytest.raises(ValueError, match="batch_size=32 exceeds"):
        DIVIEngine(cfg, DIVIConfig(num_workers=4, batch_size=32), train,
                   device=CPU)


def test_signature_refusals_name_the_mismatch(corpora):
    train, _ = corpora
    live = ShardedDocStream(CorpusDocStream(train), 4, partitioner="hash",
                            seed=1)
    ok = live.signature()
    live.check_signature(dict(ok))
    with pytest.raises(ValueError, match="num_workers=2"):
        live.check_signature({**ok, "num_shards": 2})
    with pytest.raises(ValueError, match="partitioner"):
        live.check_signature({**ok, "partitioner": "range"})
    with pytest.raises(ValueError, match="seed"):
        live.check_signature({**ok, "seed": 9})
    with pytest.raises(ValueError, match="num_docs"):
        live.check_signature({**ok, "num_docs": 7})


# ---------------------------------------------------------------------------
# ingest checkpointing
# ---------------------------------------------------------------------------

def test_worker_ingest_mid_batch_capture_restore_bit_equal(corpora):
    """Capture with an open packer (mid-batch), restore into a fresh
    ingest, and the batch sequences stay bit-identical across the next
    emission and the pass boundary; ``repro``'s ingest restores the port's
    capture to the same batches."""
    train, jtrain = corpora
    sharded = ShardedDocStream(CorpusDocStream(train), 2,
                               partitioner="hash", seed=3)
    jsharded = JSharded(JCorpusDocStream(jtrain), 2, partitioner="hash",
                        seed=3)
    a = WorkerIngest(sharded.shard(0), 8)
    for _ in range(8 + 3):             # one emitted batch + 3 docs pending
        a.pull_doc()
    meta, arrays = a.capture()
    assert len(meta["pending_pos"]) == 3
    b = WorkerIngest(sharded.shard(0), 8)
    b.restore(meta, arrays)
    c = JWorkerIngest(jsharded.shard(0), 8)
    c.restore(meta, arrays)
    assert (b.cursor, b.passes, b.docs_pulled) == (11, 0, 11)
    for _ in range(6):                 # past the 48-doc pass boundary
        ba = a.next_batch()
        _same_batch(ba, b.next_batch())
        _same_batch(ba, c.next_batch())
    assert a.passes == b.passes == c.passes == 1


@pytest.mark.parametrize("partitioner", SHARD_PARTITIONERS)
def test_divi_trainer_mid_pass_save_resume_bit_equal(corpora, partitioner):
    """Multi-worker capture → restore → resume equals the run that never
    stopped, bit for bit, with the worker cursors mid-pass at the save."""
    train, _ = corpora
    cfg = LDAConfig(num_topics=8, vocab_size=SPEC.vocab_size,
                    estep_max_iters=25)
    dcfg = DIVIConfig(num_workers=2, batch_size=7, staleness=2,
                      delay_prob=0.25, partitioner=partitioner,
                      partition_seed=11)
    a = DIVITrainer(cfg, dcfg, CorpusDocStream(train), seed=5, device=CPU)
    for _ in range(3):
        a.run_pass()
    meta, arrays = a.capture()
    assert any(0 < ing.cursor < ing.stream.num_docs for ing in a.eng.ingest)
    b = DIVITrainer(cfg, dcfg, CorpusDocStream(train), seed=5, device=CPU)
    b.restore(meta, arrays)
    for _ in range(3):
        a.run_pass()
        b.run_pass()
    assert a.docs_seen == b.docs_seen
    for f in ("lam", "m_vk", "init_mass", "init_frac", "t"):
        assert np.array_equal(getattr(a.state, f).numpy(),
                              getattr(b.state, f).numpy()), f
    assert np.array_equal(a.eng.shard.pi.numpy(), b.eng.shard.pi.numpy())
    assert np.array_equal(a.eng.shard.visited.numpy(),
                          b.eng.shard.visited.numpy())


def test_divi_restore_refuses_foreign_shard_assignment(corpora):
    train, _ = corpora
    cfg = LDAConfig(num_topics=8, vocab_size=SPEC.vocab_size,
                    estep_max_iters=20)

    def mk(dcfg):
        return DIVITrainer(cfg, dcfg, CorpusDocStream(train), seed=0,
                           device=CPU)

    src = mk(DIVIConfig(num_workers=2, batch_size=8))
    src.run_pass()
    meta, arrays = src.capture()
    with pytest.raises(ValueError, match="num_workers=2"):
        mk(DIVIConfig(num_workers=4, batch_size=8)).restore(meta, arrays)
    with pytest.raises(ValueError, match="partitioner"):
        mk(DIVIConfig(num_workers=2, batch_size=8,
                      partitioner="hash")).restore(meta, arrays)
    legacy = {k: v for k, v in meta.items() if k != "sharding"}
    with pytest.raises(ValueError, match="predates streaming shards"):
        mk(DIVIConfig(num_workers=2, batch_size=8)).restore(legacy, arrays)
    with pytest.raises(ValueError, match="not a D-IVI checkpoint"):
        mk(DIVIConfig(num_workers=2, batch_size=8)).restore(
            {**meta, "algo": "ivi"}, arrays)
