"""UCI bag-of-words format (docword.txt / vocab.txt), lazily streamable.

The port's copy of ``repro.data.uci`` (numpy only, over the port's own
``Corpus`` and ``DocStream``): the same parser, resume index and
``<path>.idx.npz`` sidecar, so a file and its sidecar written by either
package read the same in both. It is the standard distribution format of
the paper's corpora (NYT, Enron, ... on the UCI repository):

    docword.txt:  D\n W\n NNZ\n  then lines "docID wordID count" (1-based,
                  grouped by docID)
    vocab.txt:    one token per line (line i+1 = wordID i+1)

``UCIDocStream`` exposes such a file as a
`repro_torch.data.stream.DocStream`: the header is read eagerly (D, W),
documents lazily, one per-doc group of lines at a time, so a corpus
streams through training without ever being materialized as a dense
``(D, L)`` padded array (``launch/train.py --stream``). ``load_uci`` is
``materialize(UCIDocStream(...))``, so the parser exists exactly once.
Files may be gzip-compressed. No network access is required: the tests
write synthetic files in this format to exercise the loader.
"""
from __future__ import annotations

import bisect
import gzip
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core.types import Corpus
from repro_torch.data.stream import DocStream, RaggedDoc, materialize


def _open(path: str):
    return gzip.open(path, "rt") if path.endswith(".gz") else open(path)


def _open_binary(path: str):
    """The docword parser reads BINARY lines: ``int()`` accepts bytes, and
    binary ``tell``/``seek`` are cheap positions (text-mode tell is an
    opaque cookie with real per-call cost) - the resume index depends on
    them."""
    return (gzip.open(path, "rb") if path.endswith(".gz")
            else open(path, "rb"))


class UCIDocStream(DocStream):
    """Lazy ``DocStream`` over a UCI docword file (see module docstring).

    Only the 3-line header is read at construction. ``num_words`` and
    ``max_unique`` need one pass over the file; it runs lazily on first
    access and is cached. That same pass records a byte-offset **resume
    index** - the file position of one docID group start every
    ``index_every`` documents - so ``iter_from(cursor)`` seeks to the
    nearest indexed group at or below the cursor and parses O(index_every)
    documents instead of re-reading the whole prefix: a deep mid-epoch
    resume (the distributed-streaming restart path) touches O(1) leading
    bytes of an uncompressed file. (Gzip members still decompress their
    prefix on seek - that is a property of the format, not the parser.)

    The stats scan persists its result to a sidecar ``<path>.idx.npz``
    (atomic tmp+rename, best-effort - a read-only directory just skips the
    cache). N workers sharing one docword file - the ``ShardedDocStream``
    deployment - then pay the O(corpus) scan ONCE: every later stream over
    the same file loads stats + index from the sidecar, which is
    invalidated on any mtime/size mismatch with the docword file (and on a
    differing ``max_docs`` / ``max_unique`` / ``index_every``, which change
    what the scan would have produced). ``use_index_cache=False`` opts out.

    Quirks mirrored from the materialized loader for exact equivalence:
    docIDs absent from the file (empty documents) yield the placeholder
    ``([0], [1.0])`` that ``load_uci`` has always produced for them, and
    ``max_unique``/per-doc clipping keep the most frequent tokens.
    """

    _IDX_VERSION = 1

    def __init__(self, docword_path: str, *, max_docs: Optional[int] = None,
                 max_unique: Optional[int] = None, index_every: int = 1000,
                 use_index_cache: bool = True):
        self.path = docword_path
        self.max_unique_cap = max_unique
        self.index_every = max(1, int(index_every))
        self.use_index_cache = bool(use_index_cache)
        with _open(docword_path) as f:
            d = int(f.readline())
            w = int(f.readline())
            int(f.readline())                     # NNZ, unused
        self.vocab_size = w
        self._num_docs = min(d, max_docs) if max_docs else d
        self._stats: Optional[Tuple[float, int]] = None   # (words, max_uniq)
        self._index: Optional[List[Tuple[int, int]]] = None  # (doc, offset)

    # -- DocStream contract ---------------------------------------------
    @property
    def num_docs(self) -> int:
        return self._num_docs

    @property
    def num_words(self) -> float:
        return self._scan_stats()[0]

    @property
    def max_unique(self) -> int:
        return self._scan_stats()[1]

    def iter_from(self, cursor: int = 0) -> Iterator[RaggedDoc]:
        if cursor <= 0:
            yield from self._iter_docs()
            return
        # the resume index rides the stats scan - which every training
        # run pays anyway (num_words/max_unique) and is cached, so
        # forcing it here keeps deep resumes O(index_every), not O(cursor)
        self._scan_stats()
        start, offset = 0, None
        if self._index:
            i = bisect.bisect_right([d for d, _ in self._index], cursor) - 1
            if i >= 0:
                start, offset = self._index[i]
        it = self._iter_docs(next_doc=start, offset=offset)
        for pos, doc in enumerate(it, start=start):
            if pos >= cursor:
                yield doc

    # -- internals -------------------------------------------------------
    def _iter_docs(self, next_doc: int = 0, offset: Optional[int] = None,
                   track=None) -> Iterator[RaggedDoc]:
        """Documents ``next_doc``..num_docs-1 in order, clipping applied.

        ``offset``: byte position of the first line of docID group
        ``next_doc`` (from the resume index); None starts past the header.
        ``track(doc, cookie)``: called with the byte offset of each docID
        group's first line - the stats scan's hook that builds the index.
        """
        empty = (np.asarray([0], np.int32), np.asarray([1.0], np.float32))
        words: List[int] = []
        cnts: List[int] = []
        with _open_binary(self.path) as f:
            if offset is None:
                for _ in range(3):
                    f.readline()
            else:
                f.seek(offset)
            while True:
                cookie = f.tell() if track is not None else None
                line = f.readline()
                if not line:
                    break
                parts = line.split()
                if len(parts) != 3:
                    continue
                doc, word, cnt = (int(parts[0]) - 1, int(parts[1]) - 1,
                                  int(parts[2]))
                if doc >= self._num_docs:
                    continue
                if doc < next_doc:
                    # a line for an already-emitted document: the file is
                    # not grouped by docID - a lazy reader cannot go back,
                    # so fail loudly instead of emitting phantom documents
                    raise ValueError(
                        f"{self.path!r}: docword lines are not grouped by "
                        f"docID (doc {doc + 1} after doc {next_doc + 1}) - "
                        "sort the file or use the eager load path")
                if doc != next_doc and words:
                    yield self._finish_doc(words, cnts)
                    next_doc += 1
                    words, cnts = [], []
                while next_doc < doc:    # gap in docIDs: empty documents
                    yield empty
                    next_doc += 1
                if track is not None and not words:
                    track(doc, cookie)   # first line of this docID group
                words.append(word)
                cnts.append(cnt)
        if words:
            yield self._finish_doc(words, cnts)
            next_doc += 1
        while next_doc < self._num_docs:
            yield empty
            next_doc += 1

    def _finish_doc(self, words: List[int], cnts: List[int]) -> RaggedDoc:
        """Aggregate one doc's lines: duplicate wordIDs summed, ids
        ascending (the np.unique-of-repeats order ``load_uci`` produced),
        clipped to the most frequent under a ``max_unique`` cap."""
        w = np.asarray(words, np.int64)
        c = np.asarray(cnts, np.int64)
        uw, inv = np.unique(w, return_inverse=True)
        uc = np.zeros(len(uw), np.int64)
        np.add.at(uc, inv, c)
        ids = uw.astype(np.int32)
        out = uc.astype(np.float32)
        cap = self.max_unique_cap
        if cap is not None and len(ids) > cap:
            top = np.argsort(-out)[:cap]
            ids, out = ids[top], out[top]
        return ids, out

    def _scan_stats(self) -> Tuple[float, int]:
        if self._stats is None:
            if self.use_index_cache and self._load_sidecar():
                return self._stats
            words, maxu = 0.0, 1
            index: List[Tuple[int, int]] = []

            def track(doc: int, cookie: int) -> None:
                if not index or doc >= index[-1][0] + self.index_every:
                    index.append((doc, cookie))

            for ids, cnts in self._iter_docs(track=track):
                words += float(cnts.sum())
                maxu = max(maxu, len(ids))
            self._stats = (words, maxu)
            self._index = index
            if self.use_index_cache:
                self._save_sidecar()
        return self._stats

    # -- sidecar stats/index cache ---------------------------------------
    @property
    def index_path(self) -> str:
        return self.path + ".idx.npz"

    def _sidecar_key(self) -> np.ndarray:
        """The validity key: docword identity (mtime ns + size) plus every
        knob that changes what the scan produces."""
        st = os.stat(self.path)
        return np.asarray([self._IDX_VERSION, st.st_mtime_ns, st.st_size,
                           self._num_docs,
                           -1 if self.max_unique_cap is None
                           else self.max_unique_cap,
                           self.index_every], np.int64)

    def _load_sidecar(self) -> bool:
        """True iff a valid sidecar filled ``_stats``/``_index``. A stale
        sidecar (docword rewritten, different knobs) is simply ignored:
        the scan reruns and overwrites it."""
        try:
            with np.load(self.index_path) as z:
                if not np.array_equal(z["key"], self._sidecar_key()):
                    return False
                self._stats = (float(z["words"]), int(z["max_unique"]))
                self._index = [(int(d), int(o)) for d, o in z["index"]]
            return True
        except (OSError, KeyError, ValueError):
            return False

    def _save_sidecar(self) -> None:
        """Best-effort atomic write (tmp + rename): failing to persist (a
        read-only dir, a race with a sibling worker) never fails the scan
        (the rename makes concurrent writers last-wins, both valid)."""
        tmp = f"{self.index_path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:       # handle, not name: np.savez
                np.savez(f, key=self._sidecar_key(),  # appends .npz to names
                         words=np.asarray(self._stats[0]),
                         max_unique=np.asarray(self._stats[1]),
                         index=np.asarray(self._index or
                                          np.empty((0, 2)), np.int64)
                         .reshape(-1, 2))
            os.replace(tmp, self.index_path)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass


def load_vocab(vocab_path: Optional[str]) -> List[str]:
    """The vocab.txt side of the format (empty list if absent)."""
    if not (vocab_path and os.path.exists(vocab_path)):
        return []
    with _open(vocab_path) as f:
        return [ln.strip() for ln in f]


def load_uci(docword_path: str, vocab_path: Optional[str] = None,
             max_docs: Optional[int] = None,
             max_unique: Optional[int] = None, *,
             device=None) -> Tuple[Corpus, List[str]]:
    """Parse UCI bag-of-words files into the padded Corpus layout on
    ``device`` (the card unless named): ``materialize`` over the lazy
    stream (one parser, two consumers)."""
    stream = UCIDocStream(docword_path, max_docs=max_docs,
                          max_unique=max_unique)
    return (materialize(stream, max_unique=max_unique, device=device),
            load_vocab(vocab_path))


def save_uci(corpus: Corpus, docword_path: str) -> None:
    """Write a Corpus back out in UCI format (round-trip / interchange):
    the bytes ``repro``'s ``save_uci`` writes for the same corpus."""
    ids = corpus.token_ids.cpu().numpy()
    cnt = corpus.counts.cpu().numpy().astype(np.int64)
    rows = []
    for d in range(ids.shape[0]):
        live = cnt[d] > 0
        for word, c in zip(ids[d][live], cnt[d][live]):
            rows.append((d + 1, int(word) + 1, int(c)))
    opener = gzip.open(docword_path, "wt") if docword_path.endswith(".gz") \
        else open(docword_path, "w")
    with opener as f:
        f.write(f"{ids.shape[0]}\n{int(ids.max()) + 1}\n{len(rows)}\n")
        for r in rows:
            f.write(f"{r[0]} {r[1]} {r[2]}\n")
