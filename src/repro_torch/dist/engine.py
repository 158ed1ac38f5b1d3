"""The host side of D-IVI: stream sharding, round ingest, the device round.

The port's counterpart of ``repro.dist.engine``. The engine owns what is
host-side in the paper's system: the deal of documents to workers
(`data.stream.ShardedDocStream`: each worker reads a shard view of the
corpus stream, never a resident slice of it), each round's batch pulling
and packing through the workers' ``WorkerIngest``, and the Bernoulli
drop coins. Coins, shard cursors and packed batches are ``repro``'s bit
for bit (the same ``np.random.default_rng(seed)`` draws in the same
order), so the two packages train on identical inputs.

A round's live batches go to the device once, pinned and non-blocking;
the round itself (`dist.protocol.divi_round`) makes two kernel launches a
sub-round on the ``cuda`` backend, whatever the worker count.

With a mesh (`dist.divi.make_divi_round`) the engine is one rank's: every
rank builds the same shard deal and the same generator and flips the same
coins, but pulls batches for its own block of workers only, holds their
memos and its rows of λ, and runs the mesh round. A full λ (evaluation,
the bound, saving) comes from ``gather_lam``, a collective every rank
calls.
"""
from __future__ import annotations

from functools import partial
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import LDAConfig, init_global_state, resolve_device
from repro_torch.data.stream import ShardedDocStream, as_doc_stream
from repro_torch.dist.divi import make_divi_round
from repro_torch.dist.protocol import (DIVIConfig, DIVIState, WorkerIngest,
                                       WorkerShard, divi_round)
from repro_torch.launch.mesh import check_mesh
from repro_torch.obs import as_telemetry


class DIVIEngine:
    """The paper's §4 engine: P workers, staleness S, Bernoulli
    round-dropping.

    ``data`` is anything ``as_doc_stream`` accepts (a padded ``Corpus``, any
    ``DocStream``) or a pre-built ``ShardedDocStream`` whose shard count is
    ``num_workers``. λ₀ is ``lam0`` when given (how parity tests start both
    packages from one point: ``jax.random.gamma`` cannot be reproduced in
    torch), else a Gamma(100, 0.01) draw from a ``torch.Generator`` seeded
    with ``seed``, as ``LDAEngine`` draws it.

    ``mesh=None`` simulates the P workers on ``device``. A ``DeviceMesh``
    (`repro_torch.launch.mesh.make_host_mesh`) makes this engine one rank of
    the mesh round, with ``data_axes`` (default: every axis but
    ``model``) sharding the workers: ``workers`` is its block, ``rows`` its
    slice of V, and λ₀ is taken whole on every rank and then sliced. The
    ``state`` then holds the rank's rows; ``gather_lam`` returns the full λ
    on every rank that calls it, and every rank must.
    """

    def __init__(self, cfg: LDAConfig, dcfg: DIVIConfig, data, *,
                 seed: int = 0, mesh=None,
                 data_axes: Optional[Tuple[str, ...]] = None,
                 telemetry=None, device=None, lam0=None):
        if mesh is None and data_axes is not None:
            raise ValueError("data_axes names axes of a mesh: pass mesh=")
        self.cfg, self.dcfg = cfg, dcfg
        self.device = resolve_device(device)
        if mesh is not None:
            check_mesh(mesh)
            if mesh.device_type != self.device.type:
                raise ValueError(f"the mesh is on {mesh.device_type!r} but "
                                 f"the engine on {self.device}")
        self.tel = as_telemetry(telemetry)
        self.rng = np.random.default_rng(seed)
        if isinstance(data, ShardedDocStream):
            if data.num_shards != dcfg.num_workers:
                raise ValueError(
                    f"ShardedDocStream deals {data.num_shards} shards but "
                    f"DIVIConfig asks for {dcfg.num_workers} workers: the "
                    "assignment must be one shard per worker")
            self.sharded = data
        else:
            self.sharded = ShardedDocStream(
                as_doc_stream(data), dcfg.num_workers,
                partitioner=dcfg.partitioner, seed=dcfg.partition_seed)
        self.mesh = mesh
        if mesh is None:
            self._round = partial(divi_round, cfg)
            self.workers = range(dcfg.num_workers)
            self.rows = slice(0, cfg.vocab_size)
        else:
            self._round = make_divi_round(cfg, dcfg, mesh, data_axes)
            self.workers, self.rows = self._round.workers, self._round.rows
        metrics = self.tel.metrics if self.tel.enabled else None
        # the ingest of this engine's workers (every worker's without a mesh)
        self.ingest: List[WorkerIngest] = [
            WorkerIngest(self.sharded.shard(w), dcfg.batch_size,
                         metrics=metrics)
            for w in self.workers]
        sizes = self.sharded.shard_sizes
        if dcfg.batch_size > min(sizes):
            # a batch wider than its shard would wrap the cyclic shard
            # stream onto itself and hold a document twice
            raise ValueError(
                f"batch_size={dcfg.batch_size} exceeds the {min(sizes)} "
                f"documents the smallest of the {dcfg.num_workers} worker "
                "shards holds; shrink the batch or the worker count")
        self.max_unique = int(self.sharded.max_unique)
        # memo rows = the largest shard's (shards differ by at most one)
        self.docs_per_worker = max(sizes)
        gen = None
        if lam0 is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state: DIVIState = init_global_state(
            cfg, device=self.device, generator=gen, lam0=lam0)
        if mesh is not None:
            self.state = self._round.local_state(self.state)
        self.shard = WorkerShard.zeros(len(self.workers),
                                       self.docs_per_worker,
                                       self.max_unique, cfg.num_topics,
                                       self.device)
        # the init mass retires against the whole stream's words: every
        # document lies in exactly one shard
        self.num_words_total = torch.tensor(
            float(self.sharded.base.num_words), dtype=torch.float32,
            device=self.device)
        self.docs_seen = 0

    # -- rounds ------------------------------------------------------------
    def _ingest_round(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray]:
        """Flip the drop coins, then pull one packed batch per live (worker,
        sub-round) slot of this engine's workers, sub-round-major
        (``repro``'s draws and pulls, in its order). Returns the live
        batches only: ids and counts (n, B, L), flat memo rows (n, B) in
        this engine's memo, and every worker's (W, S) drop flags."""
        w, s, b = (self.dcfg.num_workers, self.dcfg.staleness,
                   self.dcfg.batch_size)
        delay = self.rng.random((w, s)) < self.dcfg.delay_prob
        first = self.workers.start
        pulled = [(i - first, self.ingest[i - first].next_batch())
                  for j in range(s) for i in self.workers if not delay[i, j]]
        n, l = len(pulled), self.max_unique
        ids = np.empty((n, b, l), np.int32)
        cnts = np.empty((n, b, l), np.float32)
        rows = np.empty((n, b), np.int64)
        for k, (i, batch) in enumerate(pulled):
            ids[k], cnts[k] = batch.token_ids, batch.counts
            rows[k] = i * self.docs_per_worker + batch.rows
        return ids, cnts, rows, delay

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def round_args(self) -> tuple:
        """Ingest the next round: the round's arguments (state, memo, the
        live batches, memo rows and coins on the device, the word total)."""
        ids, cnts, rows, delay = self._ingest_round()
        return (self.state, self.shard, self._to_device(ids),
                self._to_device(cnts), self._to_device(rows), delay,
                self.num_words_total)

    def run_round(self, args: Optional[tuple] = None) -> None:
        """One global round: S sub-rounds of P concurrent worker batches
        (``args``: a ``round_args()`` not yet run; ingested here when
        None). On a mesh every rank calls it."""
        tel = self.tel
        sp = tel.trace.begin("divi/round", workers=self.dcfg.num_workers,
                             staleness=self.dcfg.staleness) \
            if tel.enabled else None
        args = self.round_args() if args is None else args
        delay = args[5]
        self.state, self.shard = self._round(*args)
        docs = int(self.dcfg.batch_size * (~delay).sum())
        self.docs_seen += docs
        if sp is not None:
            tel.trace.end(sp, sync=self.state.lam)
            m = tel.metrics
            m.inc("divi.rounds")
            m.inc("divi.docs", docs)
            m.inc("divi.dropped_batches", float(delay.sum()))

    # -- views -------------------------------------------------------------
    @property
    def lam(self) -> torch.Tensor:
        """λ (V, K); on a mesh it is sharded: ``gather_lam()`` instead."""
        if self.mesh is not None:
            raise ValueError(
                "on a mesh λ is sharded over the model axis: call "
                "gather_lam() on every rank")
        return self.state.lam

    def gather_lam(self) -> torch.Tensor:
        """The full λ (V, K). On a mesh a collective: every rank calls it
        and gets the same tensor."""
        return self.gather_rows(self.state.lam)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """A (V, K) leaf whole from this engine's ``rows`` of it (on a mesh
        a collective of the model line)."""
        if self.mesh is None:
            return x
        return self._round.gather_lam(x)

    def gather_workers(self, obj) -> list:
        """Each worker block's picklable ``obj``, in worker order: ``[obj]``
        without a mesh, a collective of the data line on one."""
        if self.mesh is None:
            return [obj]
        return self._round.data.all_gather_object(obj)

    def gather_memo(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every worker's memo, (π (W, D_w, L, K), visited (W, D_w)). On a
        mesh a collective: the data line's all-gather on every rank."""
        if self.mesh is None:
            return self.shard.pi, self.shard.visited
        data = self._round.data
        visited = data.all_gather(self.shard.visited.to(torch.uint8))
        return (torch.cat(data.all_gather(self.shard.pi)),
                torch.cat(visited).to(torch.bool))
