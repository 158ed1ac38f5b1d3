"""D-IVI master/worker round semantics (paper §4), P workers on one device.

The port's counterpart of ``repro.dist.protocol``. The paper's asynchronous
distributed algorithm: *P* workers each own a disjoint shard of the corpus
and its π memo; the master owns the global state (λ, ⟨m_vk⟩, the
un-retired random-init mass). A worker repeatedly

  1. fetches (possibly stale) topics λ from the master,
  2. runs the partial E-step on a mini-batch of its own documents,
     warm-starting γ from its memo (Alg. 1 lines 4–7),
  3. sends the subtract-old/add-new correction Σ_d cnt·(π_new − π_memo)
     back to the master, one (V, K) message.

The corrections are exact memo deltas, so they commute: the master folds
them into the S-IVI Robbins–Monro update (eq. 5) in any order and at any
lag, and ⟨m_vk⟩ stays a faithful, if stale, accumulator.

Worker state splits along the ingest line:

* ``WorkerIngest`` (host): one worker's shard view of the corpus stream
  (`data.stream.ShardedDocStream`), its single-rung ``BatchPacker`` and its
  pass cursor; the cursor and the packer's open documents are its
  checkpointable state.
* ``WorkerShard`` (device): every worker's π memo in one (W, D_w, L, K)
  tensor and ``visited`` (W, D_w). Memo rows are shard-local document
  positions; a (worker, position) pair is row ``w·D_w + position`` of the
  flat (W·D_w, L, K) view.

A global round is ``staleness`` sub-rounds. Every worker runs its
``staleness`` mini-batches against the round-start λ while the master
advances one S-IVI update a sub-round, so corrections arrive at parameter
lag 0 … S−1 (the paper's staleness model). Each worker drops a sub-round
with probability ``delay_prob`` (Fig. 5): it pulls no documents, sends no
correction and leaves its memo untouched, and the master still updates.

``repro`` runs the workers of a sub-round under ``jax.vmap``, which turns
each kernel call into one call over a worker axis. The port's counterpart:
the live workers' batches are stacked row-wise and solved by one
``EStepBackend.solve_correction_grouped`` call, one group a worker. On the
``cuda`` backend that is one fixed-point launch (K1, its stop tiles cut
within each worker's rows, with the π finish) and one segment scatter (K3)
over all their tokens, whose single (V, K) output is the summed
correction; one memo gather and one write-back on the flat view. Dropped
workers put no rows into the launch (``repro``'s zero-filled slots add
exact zeros). The summed correction adds in another order than ``repro``'s
``corr_w.sum(0)``, so the two agree to a tolerance; the port's own runs are
bit-reproducible.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engines import retire_init_frac, sivi_global_update
from repro_torch.core.estep import BowBatch, get_backend
from repro_torch.core.math import exp_dirichlet_expectation
from repro_torch.core.types import GlobalState, LDAConfig
from repro_torch.data.stream import BatchPacker, PackedBatch, ShardDocStream


@dataclasses.dataclass(frozen=True)
class DIVIConfig:
    """Distribution hyper-parameters (``repro``'s fields and defaults).

    ``partitioner`` / ``partition_seed`` select how the corpus stream is
    dealt to workers (`data.stream.ShardedDocStream`); a pre-built
    ``ShardedDocStream`` passed as the data overrides them.
    """

    num_workers: int = 4
    batch_size: int = 64
    delay_prob: float = 0.0   # P(worker drops a sub-round), Fig. 5
    staleness: int = 1        # sub-rounds per global round (parameter lag)
    partitioner: str = "range"
    partition_seed: int = 0


# the master state is the engines' state: one constructor for both
DIVIState = GlobalState


@dataclasses.dataclass
class WorkerShard:
    """Every worker's π memo, leading axis = worker: ``pi`` (W, D_w, L, K)
    and ``visited`` (W, D_w). D_w is the largest shard's size; a smaller
    shard never touches its last row."""

    pi: torch.Tensor
    visited: torch.Tensor

    @classmethod
    def zeros(cls, workers: int, docs_per_worker: int, width: int,
              topics: int, device) -> "WorkerShard":
        return cls(pi=torch.zeros((workers, docs_per_worker, width, topics),
                                  dtype=torch.float32, device=device),
                   visited=torch.zeros((workers, docs_per_worker),
                                       dtype=torch.bool, device=device))

    def gather(self, rows: torch.Tensor):
        """(π, visited) of flat rows ``w·D_w + position``."""
        w, d, l, k = self.pi.shape
        return (self.pi.view(w * d, l, k)[rows],
                self.visited.view(w * d)[rows])

    def write(self, rows: torch.Tensor, pi: torch.Tensor) -> None:
        """Store π at flat rows and mark them visited, in place (the value
        of the fill goes to the kernel as an argument: no host copy)."""
        w, d, l, k = self.pi.shape
        self.pi.view(w * d, l, k).index_copy_(0, rows, pi)
        self.visited.view(w * d).index_fill_(0, rows, True)


class WorkerIngest:
    """Host ingest of ONE worker: its shard stream, packer and cursor.

    The packer is single-rung (``boundaries=()``: one width, the memo's L),
    so every batch is a full (batch_size, L) ``PackedBatch`` and the
    workers' batches stack. One batch emits per ``batch_size`` documents
    pulled, in shard order; at the shard's end the cursor wraps
    (``passes`` += 1) and the packer fills across the boundary. A batch
    never holds one document twice while ``batch_size <= shard.num_docs``
    (the engine enforces it). ``capture``/``restore`` persist the cursor,
    the pass count and the packer's open documents.
    """

    def __init__(self, stream: ShardDocStream, batch_size: int, *,
                 metrics=None):
        self.stream = stream
        self.batch_size = int(batch_size)
        self.cursor = 0             # documents pulled in the current pass
        self.passes = 0
        self.docs_pulled = 0        # lifetime counters
        self.tokens_pulled = 0.0
        self._metrics = metrics
        self._packer = self._make_packer()
        self._iter = None

    def _make_packer(self) -> BatchPacker:
        return self.stream.make_packer(self.batch_size, boundaries=(),
                                       metrics=self._metrics)

    def pull_doc(self) -> Optional[PackedBatch]:
        """Pull ONE document into the packer; the batch it completes, if
        any."""
        if self._iter is None:
            self._iter = self.stream.iter_from(self.cursor)
        try:
            ids, cnts = next(self._iter)
        except StopIteration:
            # the pass ends: the shard cycles, from local position 0
            self.cursor = 0
            self.passes += 1
            self._iter = self.stream.iter_from(0)
            ids, cnts = next(self._iter)
        pos = self.cursor
        self.cursor += 1
        self.docs_pulled += 1
        self.tokens_pulled += float(np.sum(cnts))
        return self._packer.add(pos, ids, cnts)

    def next_batch(self) -> PackedBatch:
        """Pull documents until one (batch_size, L) batch emits."""
        while True:
            batch = self.pull_doc()
            if batch is not None:
                return batch

    def capture(self) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
        """(json-able meta, ragged pending arrays): this ingest state, in
        ``repro``'s keys."""
        pend = self._packer.pending_docs()
        meta: Dict[str, Any] = {
            "cursor": int(self.cursor),
            "passes": int(self.passes),
            "docs_pulled": int(self.docs_pulled),
            "tokens_pulled": float(self.tokens_pulled),
            "pending_pos": [int(p) for p, _, _ in pend],
        }
        arrays: Dict[str, np.ndarray] = {}
        for i, (_pos, ids, cnts) in enumerate(pend):
            arrays[f"pend_{i:05d}_ids"] = np.asarray(ids, np.int32)
            arrays[f"pend_{i:05d}_cnts"] = np.asarray(cnts, np.float32)
        return meta, arrays

    def restore(self, meta: Dict[str, Any],
                arrays: Dict[str, np.ndarray]) -> None:
        packer = self._make_packer()
        packer.load_pending([
            (pos, arrays[f"pend_{i:05d}_ids"], arrays[f"pend_{i:05d}_cnts"])
            for i, pos in enumerate(meta["pending_pos"])])
        self._packer = packer
        self.cursor = int(meta["cursor"])
        self.passes = int(meta["passes"])
        self.docs_pulled = int(meta["docs_pulled"])
        self.tokens_pulled = float(meta["tokens_pulled"])
        self._iter = None            # re-seated at the cursor lazily


def worker_correction(cfg: LDAConfig, eb: torch.Tensor,
                      token_ids: torch.Tensor, counts: torch.Tensor,
                      shard: WorkerShard, rows: torch.Tensor, batch_size: int):
    """The live workers of one sub-round, against stale topics ``eb``.

    ``token_ids``/``counts`` (n·B, L) are n workers' packed batches stacked
    row-wise, ``rows`` (n·B,) their flat memo rows (duplicate-free within a
    worker's batch). One memo gather, one grouped E-step and correction
    (one group a worker), one write-back. Returns (the correction summed
    over the n workers (V, K), their first-visit word count)."""
    old_pi, visited = shard.gather(rows)
    corr, words, res = get_backend(cfg.estep_backend).solve_correction_grouped(
        cfg, eb, BowBatch(token_ids, counts), old_pi, visited, batch_size)
    shard.write(rows, res.pi)
    return corr, words


def master_update(cfg: LDAConfig, state: DIVIState, corr: torch.Tensor,
                  words_retired: torch.Tensor,
                  num_words_total: torch.Tensor) -> DIVIState:
    """Fold the reduced correction into the S-IVI master step (eq. 5), in
    place: the single-host S-IVI update's arithmetic."""
    frac = retire_init_frac(state.init_frac, words_retired, num_words_total)
    lam, m_vk = sivi_global_update(cfg, state, corr, frac)
    state.m_vk.copy_(m_vk)
    state.lam.copy_(lam)
    state.init_frac.copy_(frac)
    state.t.add_(1)
    return state


def divi_round(cfg: LDAConfig, state: DIVIState,
               shard: WorkerShard, token_ids: torch.Tensor,
               counts: torch.Tensor, rows: torch.Tensor, delay: np.ndarray,
               num_words_total: torch.Tensor
               ) -> Tuple[DIVIState, WorkerShard]:
    """One D-IVI global round, the state and memo updated in place.

    Args:
      token_ids/counts: (n, B, L) the round's live (worker, sub-round)
        batches, sub-round-major and in worker order within a sub-round
        (dropped slots are absent, not zero-filled).
      rows: (n, B) int64 flat memo rows of their documents.
      delay: (W, S) host bool, the dropped (worker, sub-round) slots: it
        says how many of the n batches each sub-round holds.

    All E-steps use the round-start λ (``eb``); the master advances one
    update a sub-round, also when every worker dropped it.
    """
    eb = exp_dirichlet_expectation(state.lam, axis=0)
    b, l = token_ids.shape[1:]
    start = 0
    for live in (~np.asarray(delay)).sum(axis=0):
        n = int(live)
        if n:
            part = slice(start, start + n)
            corr, words = worker_correction(
                cfg, eb, token_ids[part].reshape(n * b, l),
                counts[part].reshape(n * b, l), shard,
                rows[part].reshape(n * b), b)
        else:
            corr = torch.zeros_like(state.lam)
            words = torch.zeros((), dtype=torch.float32,
                                device=state.lam.device)
        master_update(cfg, state, corr, words, num_words_total)
        start += n
    return state, shard
