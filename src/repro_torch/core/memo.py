"""Per-document memo stores: the π memo behind one contract.

IVI's defining cost (Alg. 1 / eq. 4) is the per-document memo of
token-aligned responsibilities π. Engines reach it only through
``MemoStore``:

    gather(doc_idx, width=None)           -> (π_old (B, width, K) fp32,
                                              visited (B,))
    update(doc_idx, π_new, exp_elog_beta=) -> store

with three implementations, as in ``repro``:

* ``DenseMemoStore`` — on the device in fp32 ``(D, L, K)``: exact.
* ``ChunkedMemoStore`` — bf16 in host-memory chunks, staged through
  pinned buffers when the wire device is CUDA, fp32 only on the device:
  half the dense bytes and no memo on the device at all. Each gather
  copies the touched rows to the device as bf16 and widens them there;
  each update rounds π to bf16 on the device and copies it back (the
  engines round π through bf16 before the add-new side, so that rounding
  is exact).
* ``GammaMemoStore`` — γ (D, K) fp32 plus one bf16 snapshot of Eφ per
  touched chunk, on the device; π_old is reconstructed on gather as
  Eθ(γ)·Eφ_snap[ids]/φnorm. Exact only while every document of a chunk was
  last visited under the chunk's snapshot, so it serves the averaged
  (S-IVI) path only, never eq. 4's exact accumulator.

``gather`` takes an optional ``width`` (≤ L) and returns the first
``width`` memo columns; ``update`` takes π at any width ≤ L and zero-pads
it to L. Stream-fed and length-bucketed batches are packed at a ladder
width, so the E-step and the memo traffic shrink to that width.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.math import exp_dirichlet_expectation
from repro_torch.core.types import Corpus, LDAConfig, resolve_device

_EPS = 1e-30


def _bits16(v) -> np.ndarray:
    """bf16 values as their 16-bit patterns: a ``torch.bfloat16`` tensor (a
    manifest's "bfloat16" tag) or any 2-byte numpy array (``uint16`` bits,
    or ``repro``'s ``ml_dtypes`` bf16), unchanged."""
    if isinstance(v, torch.Tensor):
        if v.dtype != torch.bfloat16:
            raise ValueError(f"expected bf16 bits, got a {v.dtype} tensor")
        return v.contiguous().view(torch.int16).numpy().view(np.uint16)
    v = np.asarray(v)
    if v.dtype.itemsize != 2:
        raise ValueError(f"expected bf16 bits (2 bytes an element), got "
                         f"{v.dtype}")
    return np.ascontiguousarray(v).view(np.uint16)


def bits_as_bf16(bits: np.ndarray) -> torch.Tensor:
    """uint16 bf16 patterns as a ``torch.bfloat16`` CPU tensor (a copy)."""
    return torch.from_numpy(_bits16(bits).view(np.int16).copy()) \
        .view(torch.bfloat16)


def _chunk_partition(idx: np.ndarray, chunk_docs: int
                     ) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
    """Partition doc indices by chunk: yields (chunk, sel, local) where
    ``idx[sel]`` are the documents landing in ``chunk`` and ``local`` their
    row offsets within it (callers that address whole chunks ignore it)."""
    cid = idx // chunk_docs
    for c in np.unique(cid):
        sel = np.nonzero(cid == c)[0]
        yield int(c), sel, idx[sel] - int(c) * chunk_docs


class MemoStore:
    """One memo contract for every engine (see module docstring)."""

    kind: str = "abstract"
    # keys of ``state_dict`` that hold bf16 patterns (as uint16) start with
    # this, so a checkpoint can tag them "bfloat16"
    bf16_prefix: Optional[str] = None
    # wire dtype of the stored π: engines round π through it BEFORE the
    # add-new side of the correction so ⟨m_vk⟩ adds exactly what the store
    # will later subtract
    pi_wire_dtype: str = "float32"
    num_docs: int
    max_unique: int
    num_topics: int

    def gather(self, doc_idx, width: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Return (π_old (B, width, K) fp32, visited (B,) bool); ``width``
        defaults to L."""
        raise NotImplementedError

    def update(self, doc_idx, pi: torch.Tensor, *,
               exp_elog_beta: Optional[torch.Tensor] = None) -> "MemoStore":
        """Write a batch's new π (B, width ≤ L, K), zero-padded to L, and
        mark it visited.

        The return value is the handle valid after the call; callers that
        need a before/after comparison copy out (``gather``) first.
        ``exp_elog_beta`` is the Eφ the E-step ran against; only the γ-only
        store reads it (its chunk snapshot).
        """
        raise NotImplementedError

    def footprint_bytes(self) -> int:
        raise NotImplementedError

    def state_dict(self) -> Dict[str, np.ndarray]:
        """The store's full durable state as flat {key: host array}, in the
        store's own storage dtype."""
        raise NotImplementedError

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> "MemoStore":
        """Restore from ``state_dict`` output. Returns the live handle."""
        raise NotImplementedError

    def iter_chunks(self, batch_docs: int = 512
                    ) -> Iterator[Tuple[np.ndarray, torch.Tensor,
                                        torch.Tensor]]:
        """Yield (doc_idx, π, visited) over the corpus — the read-through
        path of the memoized ELBO."""
        for lo in range(0, self.num_docs, batch_docs):
            idx = np.arange(lo, min(lo + batch_docs, self.num_docs))
            pi, vis = self.gather(idx)
            yield idx, pi, vis


class DenseMemoStore(MemoStore):
    """Device-resident fp32 memo, the exact store."""

    kind = "dense"

    def __init__(self, pi: torch.Tensor, visited: torch.Tensor):
        self.pi = pi                   # (D, L, K) float32
        self.visited = visited         # (D,) bool

    @property
    def num_docs(self) -> int:
        return self.pi.shape[0]

    @property
    def max_unique(self) -> int:
        return self.pi.shape[1]

    @property
    def num_topics(self) -> int:
        return self.pi.shape[2]

    def _index(self, doc_idx) -> torch.Tensor:
        return torch.as_tensor(np.asarray(doc_idx), dtype=torch.int64,
                               device=self.pi.device)

    def gather(self, doc_idx, width: Optional[int] = None):
        idx = self._index(doc_idx)
        pi = self.pi[idx] if width is None or width == self.max_unique \
            else self.pi[idx, :width]
        return pi, self.visited[idx]

    def update(self, doc_idx, pi, *,
               exp_elog_beta=None) -> "DenseMemoStore":
        # in place: repro donates the memo buffers to this scatter
        # (memo.py:153), so the old handle is consumed either way
        idx = self._index(doc_idx)
        w = pi.shape[1]
        self.pi[idx, :w] = pi
        if w < self.max_unique:
            self.pi[idx, w:] = 0.0
        self.visited[idx] = True
        return self

    def footprint_bytes(self) -> int:
        return self.pi.numel() * 4 + self.visited.numel()

    def state_dict(self) -> Dict[str, np.ndarray]:
        # copies, never views: on the CPU .cpu() would alias the live memo
        return {"pi": self.pi.to("cpu", copy=True).numpy(),
                "visited": self.visited.to("cpu", copy=True).numpy()}

    def load_state_dict(self, state) -> "DenseMemoStore":
        pi = np.asarray(state["pi"])
        if pi.shape != tuple(self.pi.shape):
            raise ValueError(f"memo: checkpoint shape {pi.shape} != store "
                             f"{tuple(self.pi.shape)} — the checkpoint "
                             "belongs to a different corpus/config")
        self.pi.copy_(torch.from_numpy(np.array(pi, dtype=np.float32)))
        self.visited.copy_(torch.from_numpy(
            np.array(state["visited"], dtype=bool)))
        return self


# ---------------------------------------------------------------------------
# bf16 chunked host store
# ---------------------------------------------------------------------------

class ChunkedMemoStore(MemoStore):
    """bf16 memo in host-memory chunks; fp32 only on the device.

    Each chunk is an independent ``(chunk_docs, L, K)`` bf16 tensor in host
    memory, so a host with ≥ D·L·K·2 bytes of memory holds the Arxiv-scale
    memo with none of it on the device. Rows cross the link only through
    one staging buffer per direction, pinned when ``device`` is CUDA (so
    the copies run at the link's rate; the chunks themselves stay pageable:
    no copy reads them directly, and torch's pinned allocator rounds each
    block up to a power of two, which would nearly double the host bytes).
    ``gather`` assembles the touched rows in its staging buffer and copies
    them to the device as bf16, then widens them to fp32 on the device;
    ``update`` rounds π to bf16 on the device (exact: the engines round π
    through bf16 before the add-new side), copies it back and writes it
    into the chunks. Each ``update`` waits for its copy, as ``repro``'s
    does (the host needs the values).

    ``state_dict`` exports each chunk as its raw 16-bit patterns
    (``uint16``; numpy has no bf16 dtype without ``ml_dtypes``), the bits
    ``repro``'s bf16 chunks hold: ``repro_chunk.view(np.uint16)`` compares
    with them, and ``load_state_dict`` takes either.
    """

    kind = "chunked"
    pi_wire_dtype = "bfloat16"
    bf16_prefix = "chunk_"

    def __init__(self, cfg: LDAConfig, num_docs: int, max_unique: int, *,
                 chunk_docs: int = 8192, device=None):
        self.device = resolve_device(device)
        self.num_docs = num_docs
        self.max_unique = max_unique
        self.num_topics = cfg.num_topics
        self.chunk_docs = chunk_docs
        self._pin = self.device.type == "cuda"
        n_chunks = -(-num_docs // chunk_docs)
        self._chunks: List[torch.Tensor] = [
            torch.zeros((min(chunk_docs, num_docs - c * chunk_docs),
                         max_unique, cfg.num_topics), dtype=torch.bfloat16)
            for c in range(n_chunks)
        ]
        self._visited = np.zeros((num_docs,), bool)
        self._stage = {"in": None, "out": None}
        self._copied_in: Optional[torch.cuda.Event] = None

    def _staging(self, direction: str, shape) -> torch.Tensor:
        """A ``shape`` view of the direction's staging buffer, grown (never
        shrunk) to fit; pinned when the wire device is CUDA."""
        n = int(np.prod(shape))
        buf = self._stage[direction]
        if buf is None or buf.numel() < n:
            buf = torch.empty(n, dtype=torch.bfloat16, pin_memory=self._pin)
            self._stage[direction] = buf
        return buf[:n].view(shape)

    def gather(self, doc_idx, width: Optional[int] = None):
        idx = np.asarray(doc_idx)
        w = self.max_unique if width is None else width
        if self._copied_in is not None:
            # the previous gather's copy may still read the staging buffer
            self._copied_in.synchronize()
        host = self._staging("in", (len(idx), w, self.num_topics))
        for c, sel, local in _chunk_partition(idx, self.chunk_docs):
            host[torch.from_numpy(sel)] = \
                self._chunks[c][torch.from_numpy(local), :w]
        pi = host.to(self.device, non_blocking=True)
        if self._pin:
            self._copied_in = torch.cuda.Event()
            self._copied_in.record()
        visited = torch.from_numpy(self._visited[idx]).to(self.device)
        return pi.float(), visited

    def update(self, doc_idx, pi, *,
               exp_elog_beta=None) -> "ChunkedMemoStore":
        idx = np.asarray(doc_idx)
        w = pi.shape[1]
        host = self._staging("out", tuple(pi.shape))
        host.copy_(pi.to(torch.bfloat16))      # device→host, waits
        for c, sel, local in _chunk_partition(idx, self.chunk_docs):
            rows = torch.from_numpy(local)
            self._chunks[c][rows, :w] = host[torch.from_numpy(sel)]
            if w < self.max_unique:
                self._chunks[c][rows, w:] = 0
        self._visited[idx] = True
        return self

    def footprint_bytes(self) -> int:
        return (sum(ch.numel() * ch.element_size() for ch in self._chunks)
                + self._visited.nbytes)

    def state_dict(self) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {"visited": self._visited.copy()}
        for c, chunk in enumerate(self._chunks):
            # the stored bits, no rounding: int16 is the 2-byte view numpy
            # can take, re-read as uint16
            out[f"chunk_{c:05d}"] = \
                chunk.view(torch.int16).numpy().view(np.uint16).copy()
        return out

    def load_state_dict(self, state) -> "ChunkedMemoStore":
        for c, chunk in enumerate(self._chunks):
            bits = _bits16(state[f"chunk_{c:05d}"])
            if bits.shape != tuple(chunk.shape):
                raise ValueError(f"memo chunk {c}: checkpoint shape "
                                 f"{bits.shape} != store "
                                 f"{tuple(chunk.shape)}")
            chunk.view(torch.int16).copy_(
                torch.from_numpy(bits.view(np.int16)))
        self._visited[:] = np.asarray(state["visited"], bool)
        return self


# ---------------------------------------------------------------------------
# γ-only store with per-chunk λ-epoch snapshots
# ---------------------------------------------------------------------------

class GammaMemoStore(MemoStore):
    """Store γ, recompute π — for the averaged (S-IVI) path.

    On update the store keeps γ_memo = α₀ + Σ_l cnt·π (Alg. 1 line 6) per
    document plus ONE bf16 snapshot of Eφ per chunk (the "λ-epoch" of the
    chunk's most recent update). On gather it reconstructs

        π̃ = Eθ(γ_memo) ⊙ Eφ_snap[ids] / φnorm

    which equals the memoized π exactly when every document of the chunk
    was last visited under the snapshot's λ, and is otherwise a bounded
    approximation: acceptable where the correction is folded into the
    Robbins–Monro average (eq. 5), not for the exact eq. 4 accumulator.
    γ, the snapshots and the reconstruction live on the corpus's device, in
    plain torch; the visited flags and the chunk map on the host.
    """

    kind = "gamma"
    bf16_prefix = "snap_"

    def __init__(self, cfg: LDAConfig, corpus: Corpus, *,
                 chunk_docs: int = 8192):
        self.cfg = cfg
        self.num_docs = corpus.num_docs
        self.max_unique = corpus.max_unique
        self.num_topics = cfg.num_topics
        self.chunk_docs = chunk_docs
        self._ids = corpus.token_ids
        self._cnts = corpus.counts
        self.device = corpus.token_ids.device
        self._gamma = torch.full((self.num_docs, cfg.num_topics), cfg.alpha0,
                                 dtype=torch.float32, device=self.device)
        self._snap: Dict[int, torch.Tensor] = {}   # chunk → (V, K) bf16
        self._visited = np.zeros((self.num_docs,), bool)

    def _rows(self, idx: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(idx, dtype=torch.int64, device=self.device)

    def gather(self, doc_idx, width: Optional[int] = None):
        idx = np.asarray(doc_idx)
        w = self.max_unique if width is None else width
        out = torch.zeros((len(idx), w, self.num_topics),
                          dtype=torch.float32, device=self.device)
        vis = self._visited[idx]
        for c, sel, _local in _chunk_partition(idx, self.chunk_docs):
            if c not in self._snap:
                continue
            rows = self._rows(idx[sel])
            eb = self._snap[c].float()
            et = exp_dirichlet_expectation(self._gamma[rows])
            ebg = eb[self._ids[rows, :w].long()]                # (b, w, K)
            p = torch.einsum("bk,blk->bl", et, ebg) + _EPS
            pi = et[:, None, :] * ebg / p[:, :, None]
            pi = torch.where(self._cnts[rows, :w][:, :, None] > 0, pi, 0.0)
            live = torch.from_numpy(vis[sel]).to(self.device)
            pi = torch.where(live[:, None, None], pi, 0.0)
            out[self._rows(sel)] = pi
        return out, torch.from_numpy(vis).to(self.device)

    def update(self, doc_idx, pi, *,
               exp_elog_beta=None) -> "GammaMemoStore":
        if exp_elog_beta is None:
            raise ValueError("GammaMemoStore.update needs exp_elog_beta "
                             "(the Eφ the E-step ran against)")
        idx = np.asarray(doc_idx)
        w = pi.shape[1]
        rows = self._rows(idx)
        self._gamma[rows] = self.cfg.alpha0 + torch.einsum(
            "blk,bl->bk", pi, self._cnts[rows, :w])
        snap = exp_elog_beta.to(torch.bfloat16)
        for c, _sel, _local in _chunk_partition(idx, self.chunk_docs):
            self._snap[c] = snap
        self._visited[idx] = True
        return self

    def footprint_bytes(self) -> int:
        return (self._gamma.numel() * 4 + self._visited.nbytes
                + sum(s.numel() * 2 for s in self._snap.values()))

    def state_dict(self) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {
            "gamma": self._gamma.to("cpu", copy=True).numpy(),
            "visited": self._visited.copy()}
        for c, snap in self._snap.items():
            # the λ-epoch snapshots as their bf16 bits (uint16)
            out[f"snap_{c:05d}"] = snap.cpu().view(torch.int16).numpy() \
                .view(np.uint16).copy()
        return out

    def load_state_dict(self, state) -> "GammaMemoStore":
        self._gamma.copy_(torch.from_numpy(
            np.asarray(state["gamma"], np.float32)))
        self._visited[:] = np.asarray(state["visited"], bool)
        self._snap = {
            int(k[len("snap_"):]): torch.from_numpy(
                _bits16(v).view(np.int16).copy()).to(self.device)
            .view(torch.bfloat16)
            for k, v in state.items() if k.startswith("snap_")}
        return self


# ---------------------------------------------------------------------------
# construction + footprint math
# ---------------------------------------------------------------------------

def make_memo_store(kind: str, cfg: LDAConfig, num_docs: int,
                    max_unique: int, *, corpus: Optional[Corpus] = None,
                    chunk_docs: int = 8192, device=None) -> MemoStore:
    """A zeroed store with nothing visited. ``device`` is the wire device
    (where ``gather`` returns π); the γ-only store lives on the corpus's."""
    if kind == "dense":
        device = resolve_device(device)
        return DenseMemoStore(
            pi=torch.zeros((num_docs, max_unique, cfg.num_topics),
                           dtype=torch.float32, device=device),
            visited=torch.zeros((num_docs,), dtype=torch.bool,
                                device=device))
    if kind == "chunked":
        return ChunkedMemoStore(cfg, num_docs, max_unique,
                                chunk_docs=chunk_docs, device=device)
    if kind == "gamma":
        if corpus is None:
            raise ValueError("gamma store needs the corpus (π reconstruction)")
        return GammaMemoStore(cfg, corpus, chunk_docs=chunk_docs)
    raise ValueError(f"unknown memo store kind: {kind!r} "
                     "(have dense | chunked | gamma)")


def memo_footprint_bytes(kind: str, num_docs: int, max_unique: int,
                         num_topics: int, vocab_size: int = 0,
                         chunk_docs: int = 8192) -> int:
    """Footprint math without allocating: ``repro``'s formulas."""
    if kind == "dense":
        return num_docs * max_unique * num_topics * 4 + num_docs
    if kind == "chunked":
        return num_docs * max_unique * num_topics * 2 + num_docs
    if kind == "gamma":
        n_chunks = -(-num_docs // chunk_docs)
        return (num_docs * num_topics * 4 + num_docs
                + n_chunks * vocab_size * num_topics * 2)
    raise ValueError(f"unknown memo store kind: {kind!r}")
