"""Ragged token pipeline: ``DocStream`` ingest and packed device batches.

The port's copy of ``repro.data.stream`` (numpy only, so it runs on the
host whatever the device): the ingest contract that stream-fed training
consumes.

* ``DocStream`` — an iterator of ragged ``(token_ids, counts)`` documents
  with a known ``vocab_size``, resumable by a **cursor** (a document
  position). One pass over the stream is one epoch.
* ``BatchPacker`` — packs ragged documents into device batches, in one of
  two layouts:

  - ``padded``: bucketed ``(B, W)`` batches, ``W`` the rung of the width
    ladder ``(8, 16, 32, 64, 128, 256, 512)`` that covers a document's last
    live slot (capped at ``max_width``, the memo's L, when the stream
    declares one; extended by doubling past the top rung when it does not);
  - ``csr``: one flat ``token_budget``-slot stream per batch, documents
    concatenated in order with a per-token segment id, zero-count padding
    (segment 0) at the tail only.

Packing is bit-transparent: a padded batch packed from ragged documents
equals the same rows gathered from a padded ``Corpus`` and sliced to the
bucket width, and both layouts emit what ``repro``'s packer emits on the
same documents, bit for bit.

* ``ShardedDocStream`` — D-IVI's ingest: the positions of one base stream
  dealt to P worker shards (``range`` or seeded ``hash``), each a
  ``ShardDocStream`` with its own cursor and packer. The assignment, the
  shard-local positions and the packed batches are ``repro``'s bit for
  bit.
* ``QueueDocStream`` — an append-only request queue behind the
  ``DocStream`` contract, so the online learner (`repro_torch.serve.online`)
  trains on documents a serving loop is still collecting.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.types import Corpus, resolve_device

# THE width ladder, shared by training and serving
WIDTH_BOUNDARIES = (8, 16, 32, 64, 128, 256, 512)

RaggedDoc = Tuple[np.ndarray, np.ndarray]      # (ids int32, counts float32)


# ---------------------------------------------------------------------------
# width policy
# ---------------------------------------------------------------------------

def width_ladder(max_width: int,
                 boundaries: Sequence[int] = WIDTH_BOUNDARIES) -> List[int]:
    """Bucket widths for documents up to ``max_width`` live slots: every
    ladder rung below it plus ``max_width`` itself as the final rung."""
    l = max(int(max_width), 1)
    return sorted({min(b, l) for b in boundaries if b < l} | {l})


def _last_live(counts: np.ndarray) -> np.ndarray:
    """Per row, the index of its last live column + 1 (0 for an empty row)."""
    live = counts > 0
    l = counts.shape[1]
    return np.where(live.any(1), l - np.argmax(live[:, ::-1], axis=1), 0)


def bucket_rows(counts: np.ndarray,
                boundaries: Sequence[int] = WIDTH_BOUNDARIES,
                ) -> List[Tuple[np.ndarray, int]]:
    """Group padded rows by the ladder width covering their LAST live slot.

    Returns ``[(row_indices int64, width)]`` with ascending widths; every
    row appears in exactly one bucket (empty rows in the first)."""
    counts = np.asarray(counts)
    return bucket_last(_last_live(counts), counts.shape[1], boundaries)


def bucket_last(last: np.ndarray, max_width: int,
                boundaries: Sequence[int] = WIDTH_BOUNDARIES,
                ) -> List[Tuple[np.ndarray, int]]:
    """``bucket_rows`` from each row's last live column + 1 (``_last_live``,
    0 for an empty row) and the padded width ``max_width``."""
    out: List[Tuple[np.ndarray, int]] = []
    lo = -1                   # first rung includes last == 0 (empty docs)
    for w in width_ladder(max_width, boundaries):
        rows = np.nonzero((last > lo) & (last <= w))[0]
        if len(rows):
            out.append((rows.astype(np.int64), int(w)))
        lo = w
    return out


# ---------------------------------------------------------------------------
# ragged documents
# ---------------------------------------------------------------------------

def as_ragged_doc(doc) -> RaggedDoc:
    """Normalise one document to ``(ids int32, cnts fp32)``.

    Accepts a ``(token_ids, counts)`` pair (already unique) or a raw token
    array with repeats (uniquified, ids ascending)."""
    if isinstance(doc, tuple) and len(doc) == 2:
        ids, cnts = doc
        return (np.asarray(ids, np.int32).ravel(),
                np.asarray(cnts, np.float32).ravel())
    tokens = np.asarray(doc, np.int64).ravel()
    ids, cnts = np.unique(tokens, return_counts=True)
    return ids.astype(np.int32), cnts.astype(np.float32)


class DocStream:
    """Iterator of ragged documents, resumable by a cursor.

    * ``vocab_size`` — token ids are ``< vocab_size``;
    * ``num_docs`` — documents per pass (one pass is one epoch);
    * ``num_words`` — total token count; the incremental engines need it up
      front to retire the random-init mass;
    * ``max_unique`` — an upper bound on any document's live extent (the
      memo width L);
    * ``iter_from(cursor)`` — documents ``cursor, cursor + 1, …`` as
      ``(ids int32, counts float32)`` pairs.
    """

    vocab_size: int

    @property
    def num_docs(self) -> int:
        raise NotImplementedError

    @property
    def num_words(self) -> float:
        raise NotImplementedError

    @property
    def max_unique(self) -> int:
        raise NotImplementedError

    def iter_from(self, cursor: int = 0) -> Iterator[RaggedDoc]:
        raise NotImplementedError


class CorpusDocStream(DocStream):
    """A padded ``Corpus`` viewed as a ``DocStream``, each row trimmed to its
    last live slot. The corpus is copied to the host once; streaming it is
    bit-equal to slicing the corpus."""

    def __init__(self, corpus: Corpus, vocab_size: Optional[int] = None):
        self._ids = corpus.token_ids.cpu().numpy()
        self._cnts = corpus.counts.cpu().numpy()
        self.vocab_size = (int(self._ids.max(initial=0)) + 1
                           if vocab_size is None else vocab_size)
        self._last = _last_live(self._cnts)

    @property
    def num_docs(self) -> int:
        return self._ids.shape[0]

    @property
    def num_words(self) -> float:
        # the same accumulation as the corpus-fed engine (fp32 numpy sum)
        return float(self._cnts.sum())

    @property
    def max_unique(self) -> int:
        return self._cnts.shape[1]

    def iter_from(self, cursor: int = 0) -> Iterator[RaggedDoc]:
        for d in range(cursor, self._ids.shape[0]):
            n = int(self._last[d])
            yield self._ids[d, :n], self._cnts[d, :n]


class ListDocStream(DocStream):
    """Ragged documents held in host memory."""

    def __init__(self, docs, vocab_size: int):
        self._docs = [as_ragged_doc(d) for d in docs]
        self.vocab_size = vocab_size

    @property
    def num_docs(self) -> int:
        return len(self._docs)

    @property
    def num_words(self) -> float:
        return float(sum(float(c.sum()) for _, c in self._docs))

    @property
    def max_unique(self) -> int:
        return max((len(i) for i, _ in self._docs), default=1)

    def iter_from(self, cursor: int = 0) -> Iterator[RaggedDoc]:
        yield from self._docs[cursor:]


class QueueDocStream(DocStream):
    """An append-only request queue behind the ``DocStream`` contract: the
    bridge that lets the incremental engines train on documents a serving
    loop is still collecting (`repro_torch.serve.online`).

    The engines want the corpus geometry up front (``num_docs`` sizes the π
    memo at construction, ``num_words`` retires the init mass); an open
    request stream has neither. The reconciliation, as ``repro``'s:

    * ``capacity`` plays ``num_docs``: the memo is sized once for the whole
      online window; ``append`` hands out stable, strictly increasing
      positions below it and returns ``None`` (counted in ``dropped``) once
      the window is full. Stable positions keep IVI's per-document memo
      bookkeeping exact when a later pass revisits a document appended
      mid-pass.
    * ``num_words`` / ``max_unique`` report the words appended so far and
      the declared per-document cap. An engine binding the stream reads both
      once, so the learner binds only after traffic exists (an
      underestimate of the eventual total retires the init mass early;
      ``retire_init_frac`` clamps at 0).
    * ``iter_from`` is a lock-free index walk that sees documents appended
      after the iterator was made: one training pass drains everything
      present by the time it reaches the tail, and the engine's
      epoch-boundary rewind makes the next pass revisit from 0.

    Documents longer than ``max_unique`` are clipped to their most frequent
    tokens on append (``np.argsort(-counts)``, the ``corpus_from_docs``
    rule), so ``num_words`` counts what will train. Thread-safe: any number
    of appenders and one training consumer.
    """

    def __init__(self, vocab_size: int, *, capacity: int,
                 max_unique: int = 256):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if max_unique < 1:
            raise ValueError("max_unique must be >= 1")
        self.vocab_size = int(vocab_size)
        self.capacity = int(capacity)
        self._max_unique = int(max_unique)
        self._docs: List[RaggedDoc] = []
        self._words = 0.0
        self._dropped = 0
        self._lock = threading.Lock()

    def append(self, doc) -> Optional[int]:
        """File one document; returns its stable position, or ``None`` when
        the window is full (the document is counted in ``dropped`` and not
        kept). Accepts anything ``as_ragged_doc`` does."""
        ids, cnts = as_ragged_doc(doc)
        if len(ids) and not (0 <= int(ids.min())
                             and int(ids.max()) < self.vocab_size):
            raise ValueError(
                f"token ids in [{ids.min()}, {ids.max()}] fall outside "
                f"the vocabulary [0, {self.vocab_size})")
        if len(ids) > self._max_unique:
            top = np.argsort(-cnts)[: self._max_unique]
            ids, cnts = ids[top], cnts[top]
        with self._lock:
            if len(self._docs) >= self.capacity:
                self._dropped += 1
                return None
            pos = len(self._docs)
            self._docs.append((ids, cnts))
            self._words += float(cnts.sum())
            return pos

    @property
    def num_docs(self) -> int:
        """The capacity (the engine sizes the memo with it), not the
        documents appended so far (``appended``)."""
        return self.capacity

    @property
    def appended(self) -> int:
        return len(self._docs)

    @property
    def dropped(self) -> int:
        return self._dropped

    @property
    def num_words(self) -> float:
        return self._words

    @property
    def max_unique(self) -> int:
        return self._max_unique

    def iter_from(self, cursor: int = 0) -> Iterator[RaggedDoc]:
        i = cursor
        while True:
            # list.append is atomic; a stale length only ends the pass a
            # document early, and that document trains on the next pass
            if i >= len(self._docs):
                return
            yield self._docs[i]
            i += 1


def is_doc_stream(obj) -> bool:
    """Duck-typed DocStream check (protocol, not inheritance)."""
    return hasattr(obj, "iter_from") and hasattr(obj, "vocab_size")


def as_doc_stream(data, vocab_size: Optional[int] = None) -> DocStream:
    """A ``DocStream`` as is, a padded ``Corpus`` as a ``CorpusDocStream``,
    any other iterable of documents as a ``ListDocStream``."""
    if is_doc_stream(data):
        return data
    if isinstance(data, Corpus):
        return CorpusDocStream(data, vocab_size)
    if vocab_size is None:
        raise ValueError("wrapping a raw document iterable needs vocab_size")
    return ListDocStream(data, vocab_size)


# ---------------------------------------------------------------------------
# sharding: one stream, P worker views
# ---------------------------------------------------------------------------

_U64 = np.uint64


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """The splitmix64 finalizer, vectorised: the position hash of
    ``partitioner="hash"``. Integer mixing only, so an assignment is the
    same on every machine."""
    with np.errstate(over="ignore"):
        x = (x + _U64(0x9E3779B97F4A7C15)) & _U64(0xFFFFFFFFFFFFFFFF)
        x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
        return x ^ (x >> _U64(31))


SHARD_PARTITIONERS = ("range", "hash")


class ShardDocStream(DocStream):
    """One worker's view of a partitioned base stream, itself a
    ``DocStream`` with local positions: ``iter_from(local_cursor)`` opens
    the base stream at the shard's ``local_cursor``-th member and walks
    forward, yielding only member documents (one forward pass over the
    base for either partitioner: member positions are ascending)."""

    def __init__(self, base: DocStream, positions: np.ndarray,
                 shard_index: int):
        self.base = base
        self.shard_index = int(shard_index)
        self._positions = np.asarray(positions, np.int64)
        self.vocab_size = base.vocab_size
        self._words: Optional[float] = None

    @property
    def positions(self) -> np.ndarray:
        """Global positions of this shard's documents, ascending (local
        position i is global ``positions[i]``)."""
        return self._positions

    @property
    def num_docs(self) -> int:
        return len(self._positions)

    @property
    def num_words(self) -> float:
        if self._words is None:
            self._words = sum(float(c.sum()) for _, c in self.iter_from(0))
        return self._words

    @property
    def max_unique(self) -> int:
        return self.base.max_unique

    def iter_from(self, cursor: int = 0) -> Iterator[RaggedDoc]:
        pos = self._positions
        n = len(pos)
        if cursor >= n:
            return
        k = cursor
        g = int(pos[k])                       # global position of next yield
        for doc in self.base.iter_from(g):
            if g == pos[k]:
                yield doc
                k += 1
                if k == n:
                    return
            g += 1

    def make_packer(self, batch_size: int, *, layout: str = "padded",
                    token_budget: Optional[int] = None, boundaries=None,
                    metrics=None) -> "BatchPacker":
        """A ``BatchPacker`` for this shard: the ladder capped at the base
        stream's ``max_unique``, ids checked against its vocabulary.
        ``boundaries=()`` gives the single-rung (B, L) packing the
        distributed round consumes."""
        return BatchPacker(
            batch_size, max_width=self.base.max_unique,
            boundaries=WIDTH_BOUNDARIES if boundaries is None else boundaries,
            vocab_size=self.vocab_size, layout=layout,
            token_budget=token_budget, metrics=metrics)


class ShardedDocStream:
    """Deal the positions of any ``DocStream`` to ``num_shards`` worker
    views, once, on the host.

    Either partitioner puts every document in exactly one shard, balances
    the shard sizes to within one document and keeps each shard's
    positions ascending:

    * ``"range"``: contiguous position blocks (``np.array_split``); with one
      shard the view is the base stream in order, which keeps P = 1
      comparable with single-host S-IVI;
    * ``"hash"``: documents dealt round-robin by the rank of their
      splitmix64-hashed position (seeded), so shard content does not follow
      the file's order.

    The assignment is a function of ``(num_docs, num_shards, partitioner,
    seed)`` alone; ``signature()`` is that tuple, and a resume refuses a
    checkpoint whose signature differs.
    """

    def __init__(self, base: DocStream, num_shards: int, *,
                 partitioner: str = "range", seed: int = 0):
        if partitioner not in SHARD_PARTITIONERS:
            raise ValueError(f"unknown partitioner {partitioner!r} "
                             f"(have {SHARD_PARTITIONERS})")
        d = int(base.num_docs)
        if not 1 <= int(num_shards) <= d:
            raise ValueError(
                f"cannot deal {d} documents to {num_shards} shards: need "
                f"1 <= num_shards <= num_docs (every worker must own at "
                "least one document)")
        self.base = base
        self.num_shards = int(num_shards)
        self.partitioner = partitioner
        self.seed = int(seed)
        if partitioner == "range":
            parts = np.array_split(np.arange(d, dtype=np.int64),
                                   self.num_shards)
        else:
            h = _splitmix64(np.arange(d, dtype=_U64)
                            + _splitmix64(np.asarray(self.seed, _U64)))
            order = np.argsort(h, kind="stable")     # rank by hash, stable
            shard_of = np.empty(d, np.int64)
            shard_of[order] = np.arange(d) % self.num_shards  # deal by rank
            parts = [np.nonzero(shard_of == w)[0].astype(np.int64)
                     for w in range(self.num_shards)]
        self._positions: List[np.ndarray] = parts
        self._shards: Dict[int, ShardDocStream] = {}

    @property
    def vocab_size(self) -> int:
        return self.base.vocab_size

    @property
    def num_docs(self) -> int:
        return self.base.num_docs

    @property
    def max_unique(self) -> int:
        return self.base.max_unique

    @property
    def shard_sizes(self) -> List[int]:
        return [len(p) for p in self._positions]

    def positions(self, shard: int) -> np.ndarray:
        """Global positions owned by ``shard`` (ascending)."""
        return self._positions[shard]

    def shard(self, shard: int) -> ShardDocStream:
        if not 0 <= shard < self.num_shards:
            raise ValueError(f"shard {shard} out of range "
                             f"[0, {self.num_shards})")
        if shard not in self._shards:
            self._shards[shard] = ShardDocStream(
                self.base, self._positions[shard], shard)
        return self._shards[shard]

    def shards(self) -> List[ShardDocStream]:
        return [self.shard(w) for w in range(self.num_shards)]

    def signature(self) -> Dict[str, object]:
        """The assignment's identity, as a checkpoint records it: equal
        signatures deal every document to the same shard at the same local
        position."""
        return {"partitioner": self.partitioner,
                "num_shards": self.num_shards,
                "seed": self.seed,
                "num_docs": int(self.base.num_docs)}

    def check_signature(self, saved: Dict[str, object]) -> None:
        """Raise ``ValueError`` when ``saved`` (a checkpoint's ``sharding``)
        is not this assignment: resuming across a mismatch would hand
        workers the wrong documents beside stale memo rows."""
        live = self.signature()
        if saved == live:
            return
        if int(saved.get("num_shards", -1)) != live["num_shards"]:
            raise ValueError(
                f"checkpoint was taken with {saved.get('num_shards')} "
                f"worker shards but this run has {live['num_shards']}: "
                "the per-worker cursors/memos only make sense under the "
                "shard count that produced them; resume with "
                f"num_workers={saved.get('num_shards')}")
        diffs = {k: (saved.get(k), live[k]) for k in live
                 if saved.get(k) != live[k]}
        raise ValueError(
            "checkpoint shard assignment does not match this stream's: "
            + ", ".join(f"{k}: saved={s!r} != live={l!r}"
                        for k, (s, l) in sorted(diffs.items()))
            + "; a mismatched partition would hand workers the wrong "
            "documents: rebuild the engine with the saved settings")


# ---------------------------------------------------------------------------
# the packer
# ---------------------------------------------------------------------------

class PackedBatch(NamedTuple):
    """One padded batch packed from ragged documents."""

    rows: np.ndarray        # (B',) int64 — document positions
    token_ids: np.ndarray   # (B', width) int32, leading-column layout
    counts: np.ndarray      # (B', width) float32
    width: int


class CSRBatch(NamedTuple):
    """One flat CSR batch: every document's tokens concatenated.

    The flat arrays are always exactly ``token_budget`` long (tail padded
    with count 0). ``segments[t]`` is the local row (index into ``rows``)
    owning token ``t``; padding slots carry segment 0 with count 0, which
    every segment reduction treats as an exact no-op. ``offsets`` are the
    CSR row pointers into the live prefix (``offsets[-1]`` is the live
    token count)."""

    rows: np.ndarray        # (B',) int64 — document positions
    token_ids: np.ndarray   # (T,) int32 flat, zero-padded to token_budget
    counts: np.ndarray      # (T,) float32, 0.0 on padding slots
    segments: np.ndarray    # (T,) int32 — local doc index per token
    offsets: np.ndarray     # (B'+1,) int64 — row offsets, offsets[-1]=live
    token_budget: int

    @property
    def num_docs(self) -> int:
        return len(self.rows)

    @property
    def live_tokens(self) -> int:
        return int(self.offsets[-1])

    @property
    def doc_lengths(self) -> np.ndarray:
        return np.diff(self.offsets)


@dataclasses.dataclass
class _WidthStats:
    docs: int = 0
    live_slots: int = 0
    padded_slots: int = 0


# one staged token slot = int32 id + float32 count
TOKEN_SLOT_BYTES = 8


class BatchPacker:
    """Pack ragged documents into device batches (see module docstring).

    Stateful: ``add`` files each document and returns a batch the moment
    one fills; ``flush`` emits what is still open. Emission is a
    deterministic function of the input document sequence, so a mid-epoch
    checkpoint needs only ``pending_docs`` and the stream cursor.

    * ``padded``: a document goes to the bucket of the ladder width
      covering it; a bucket emits a ``PackedBatch`` when it holds
      ``batch_size`` documents; ``flush`` emits the partial buckets in
      ascending width.
    * ``csr``: documents are concatenated into one ``CSRBatch`` of
      ``token_budget`` slots, emitted when the next document would overflow
      the budget or when ``batch_size`` documents are open, so a batch never
      splits a document.

    ``max_width`` is the stream's ``max_unique`` (training: caps the ladder
    at the memo width) or ``None`` (serving). A document with more unique
    tokens than its cap (``max_width``, and in CSR mode also
    ``token_budget``) keeps its most frequent tokens. ``vocab_size``, when
    given, is checked against every packed token id. ``metrics``, an
    optional `repro_torch.obs` ``MetricsRegistry``, gets ``repro``'s
    per-width ``pack.*`` counters and gauges for each emitted batch.
    """

    def __init__(self, batch_size: int, *, max_width: Optional[int] = None,
                 boundaries: Sequence[int] = WIDTH_BOUNDARIES,
                 vocab_size: Optional[int] = None, metrics=None,
                 layout: str = "padded",
                 token_budget: Optional[int] = None):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if layout not in ("padded", "csr"):
            raise ValueError(f"unknown packer layout {layout!r} "
                             "(expected 'padded' or 'csr')")
        if layout == "csr":
            if token_budget is None:
                raise ValueError("layout='csr' needs a token_budget")
            if token_budget < 1:
                raise ValueError("token_budget must be >= 1")
        self.batch_size = batch_size
        self.max_width = max_width
        self.vocab_size = vocab_size
        self.metrics = metrics
        self.layout = layout
        self.token_budget = int(token_budget) if token_budget else None
        self.boundaries = tuple(boundaries)
        self._widths = (width_ladder(max_width, boundaries)
                        if max_width is not None else sorted(boundaries))
        self._open: Dict[int, List[Tuple[int, np.ndarray, np.ndarray]]] = {}
        self._csr_open: List[Tuple[int, np.ndarray, np.ndarray]] = []
        self._csr_tokens = 0
        self._stats: Dict[int, _WidthStats] = {}

    # -- width policy ----------------------------------------------------
    def width_for(self, n_live: int) -> int:
        """The ladder rung covering a document with ``n_live`` live slots."""
        if self.max_width is not None and n_live > self.max_width:
            n_live = self.max_width
        for w in self._widths:
            if n_live <= w:
                return w
        # unbounded ladder (serving): extend by doubling past the top rung
        w = self._widths[-1]
        while w < n_live:
            w *= 2
            self._widths.append(w)
        return w

    # -- packing ---------------------------------------------------------
    def add(self, pos: int, ids: np.ndarray, cnts: np.ndarray):
        """File one ragged document; return a batch the moment one fills
        (``PackedBatch`` or ``CSRBatch`` by layout), else None."""
        ids = np.asarray(ids, np.int32).ravel()
        cnts = np.asarray(cnts, np.float32).ravel()
        if self.vocab_size is not None and len(ids) \
                and not (0 <= int(ids.min())
                         and int(ids.max()) < self.vocab_size):
            raise ValueError(
                f"document {pos}: token ids in [{ids.min()}, {ids.max()}] "
                f"fall outside the vocabulary [0, {self.vocab_size})")
        cap = self.max_width
        if self.layout == "csr":
            cap = (self.token_budget if cap is None
                   else min(cap, self.token_budget))
        if cap is not None and len(ids) > cap:
            # keep the most frequent tokens (the corpus_from_docs rule)
            top = np.argsort(-cnts)[:cap]
            ids, cnts = ids[top], cnts[top]
        if self.layout == "csr":
            return self._add_csr(int(pos), ids, cnts)
        w = self.width_for(len(ids))
        bucket = self._open.setdefault(w, [])
        bucket.append((int(pos), ids, cnts))
        if len(bucket) == self.batch_size:
            return self._emit(w)
        return None

    def _record(self, width: int, docs: int, live: int, padded: int,
                counts: np.ndarray) -> None:
        st = self._stats.setdefault(width, _WidthStats())
        st.docs += docs
        st.live_slots += live
        st.padded_slots += padded
        if self.metrics is not None:
            m = self.metrics
            m.inc("pack.batches", width=width)
            m.inc("pack.docs", docs, width=width)
            m.inc("pack.tokens", float(counts.sum()), width=width)
            m.set_gauge("pack.pad_frac",
                        1.0 - st.live_slots / max(st.padded_slots, 1),
                        width=width)
            m.set_gauge("pack.wasted_token_bytes",
                        (st.padded_slots - st.live_slots) * TOKEN_SLOT_BYTES,
                        width=width)

    def _emit(self, width: int) -> PackedBatch:
        docs = self._open.pop(width)
        b = len(docs)
        rows = np.asarray([p for p, _, _ in docs], np.int64)
        out_ids = np.zeros((b, width), np.int32)
        out_cnt = np.zeros((b, width), np.float32)
        for r, (_, ids, cnts) in enumerate(docs):
            out_ids[r, : len(ids)] = ids
            out_cnt[r, : len(cnts)] = cnts
        self._record(width, b, sum(len(i) for _, i, _ in docs), b * width,
                     out_cnt)
        return PackedBatch(rows, out_ids, out_cnt, width)

    def _add_csr(self, pos: int, ids: np.ndarray,
                 cnts: np.ndarray) -> Optional[CSRBatch]:
        out = None
        if self._csr_open and \
                self._csr_tokens + len(ids) > self.token_budget:
            # the new doc would overflow the flat budget: close the batch
            # first, so no document ever splits across two batches
            out = self._emit_csr()
        self._csr_open.append((pos, ids, cnts))
        self._csr_tokens += len(ids)
        if len(self._csr_open) == self.batch_size:
            # a pre-emit leaves exactly one open doc, and batch_size == 1
            # never pre-emits, so at most one of the two triggers fires
            assert out is None
            out = self._emit_csr()
        return out

    def _emit_csr(self) -> CSRBatch:
        docs = self._csr_open
        self._csr_open, self._csr_tokens = [], 0
        t = self.token_budget
        rows = np.asarray([p for p, _, _ in docs], np.int64)
        out_ids = np.zeros(t, np.int32)
        out_cnt = np.zeros(t, np.float32)
        out_seg = np.zeros(t, np.int32)
        offsets = np.zeros(len(docs) + 1, np.int64)
        cur = 0
        for r, (_, ids, cnts) in enumerate(docs):
            n = len(ids)
            out_ids[cur: cur + n] = ids
            out_cnt[cur: cur + n] = cnts
            out_seg[cur: cur + n] = r
            cur += n
            offsets[r + 1] = cur
        self._record(t, len(docs), cur, t, out_cnt)
        return CSRBatch(rows, out_ids, out_cnt, out_seg, offsets, t)

    def flush(self) -> list:
        """Emit every partially filled bucket (padded: ascending widths;
        CSR: the single open tail batch)."""
        if self.layout == "csr":
            return [self._emit_csr()] if self._csr_open else []
        return [self._emit(w) for w in sorted(self._open) if self._open[w]]

    # -- checkpointing ---------------------------------------------------
    def pending_docs(self) -> List[Tuple[int, np.ndarray, np.ndarray]]:
        """The open buckets' documents, in an order whose replay through
        ``add`` rebuilds this exact packer state."""
        if self.layout == "csr":
            return list(self._csr_open)
        out: List[Tuple[int, np.ndarray, np.ndarray]] = []
        for w in sorted(self._open):
            out.extend(self._open[w])
        return out

    def load_pending(self,
                     docs: List[Tuple[int, np.ndarray, np.ndarray]]) -> None:
        """Restore ``pending_docs`` output into a fresh packer."""
        if self._open or self._csr_open:
            raise ValueError("load_pending needs a fresh packer")
        for pos, ids, cnts in docs:
            if self.add(pos, ids, cnts) is not None:
                raise ValueError("pending docs overflowed a bucket — the "
                                 "checkpoint does not match this batch_size")

    # -- introspection ---------------------------------------------------
    def padding_stats(self) -> dict:
        """Pad-waste accounting over everything emitted so far: per-width
        document counts, pad fractions and wasted staged bytes, plus the
        overall slot ratio. (CSR mode: one 'width' = the token budget.)"""
        per_width = [
            {"width": w, "docs": st.docs,
             "pad_frac": 1.0 - st.live_slots / max(st.padded_slots, 1),
             "wasted_token_bytes":
                 (st.padded_slots - st.live_slots) * TOKEN_SLOT_BYTES}
            for w, st in sorted(self._stats.items())
        ]
        live = sum(st.live_slots for st in self._stats.values())
        padded = sum(st.padded_slots for st in self._stats.values())
        return {"per_width": per_width,
                "live_slots": live, "padded_slots": padded,
                "pad_frac": 1.0 - live / max(padded, 1),
                "wasted_token_bytes": (padded - live) * TOKEN_SLOT_BYTES}


# ---------------------------------------------------------------------------
# stream utilities
# ---------------------------------------------------------------------------

def _pad_docs(docs: List[RaggedDoc], width: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    out_ids = np.zeros((len(docs), width), np.int32)
    out_cnt = np.zeros((len(docs), width), np.float32)
    for r, (ids, cnts) in enumerate(docs):
        if len(ids) > width:                # keep the most frequent tokens
            top = np.argsort(-cnts)[:width]
            ids, cnts = ids[top], cnts[top]
        out_ids[r, : len(ids)] = ids
        out_cnt[r, : len(cnts)] = cnts
    return out_ids, out_cnt


def materialize(stream: DocStream, max_unique: Optional[int] = None, *,
                device=None) -> Corpus:
    """Drain a stream into the padded ``Corpus`` layout on ``device`` (the
    inverse of ``CorpusDocStream``; over-long docs keep their most frequent
    tokens)."""
    device = resolve_device(device)
    docs = [(np.asarray(i, np.int32), np.asarray(c, np.float32))
            for i, c in stream.iter_from(0)]
    width = max((len(i) for i, _ in docs), default=1)
    if max_unique is not None:
        width = min(width, max_unique)
    out_ids, out_cnt = _pad_docs(docs, max(width, 1))
    if out_ids.max(initial=0) >= stream.vocab_size:
        raise ValueError(f"token ids reach past vocab_size="
                         f"{stream.vocab_size}")
    return Corpus(torch.from_numpy(out_ids).to(device),
                  torch.from_numpy(out_cnt).to(device))


def iter_padded_chunks(stream: DocStream, batch_docs: int, width: int
                       ) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
    """Yield ``(start, ids (b, width), cnts (b, width))`` sequential chunks,
    the read-through path of the streamed memoized ELBO (the same document
    order as ``MemoStore.iter_chunks``)."""
    buf: List[RaggedDoc] = []
    start = 0
    for doc in stream.iter_from(0):
        buf.append(doc)
        if len(buf) == batch_docs:
            yield start, *_pad_docs(buf, width)
            start += len(buf)
            buf = []
    if buf:
        yield start, *_pad_docs(buf, width)
