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
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import LDAConfig, init_global_state, resolve_device
from repro_torch.data.stream import ShardedDocStream, as_doc_stream
from repro_torch.dist.protocol import (DIVIConfig, DIVIState, WorkerIngest,
                                       WorkerShard, divi_round)
from repro_torch.obs import as_telemetry


def mesh_not_ported(what: str = "mesh / data_axes") -> NotImplementedError:
    """The error of the multi-card path: ``repro``'s ``shard_map`` round is
    not ported (ROADMAP §1 item 11)."""
    return NotImplementedError(
        f"{what}: D-IVI over several cards (repro's shard_map round on a "
        "sharding mesh, as torch.distributed over NCCL) is not ported to "
        "repro_torch yet (ROADMAP §1 item 11); the one-card simulation of "
        "P workers runs without a mesh")


class DIVIEngine:
    """The paper's §4 engine: P workers, staleness S, Bernoulli
    round-dropping, simulated on one device.

    ``data`` is anything ``as_doc_stream`` accepts (a padded ``Corpus``, any
    ``DocStream``) or a pre-built ``ShardedDocStream`` whose shard count is
    ``num_workers``. λ₀ is ``lam0`` when given (how parity tests start both
    packages from one point: ``jax.random.gamma`` cannot be reproduced in
    torch), else a Gamma(100, 0.01) draw from a ``torch.Generator`` seeded
    with ``seed``, as ``LDAEngine`` draws it. ``mesh``/``data_axes`` (the
    multi-card path) raise.
    """

    def __init__(self, cfg: LDAConfig, dcfg: DIVIConfig, data, *,
                 seed: int = 0, mesh=None,
                 data_axes: Optional[Tuple[str, ...]] = None,
                 telemetry=None, device=None, lam0=None):
        if mesh is not None or data_axes is not None:
            raise mesh_not_ported()
        self.cfg, self.dcfg = cfg, dcfg
        self.device = resolve_device(device)
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
        metrics = self.tel.metrics if self.tel.enabled else None
        self.ingest: List[WorkerIngest] = [
            WorkerIngest(self.sharded.shard(w), dcfg.batch_size,
                         metrics=metrics)
            for w in range(dcfg.num_workers)]
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
        self.shard = WorkerShard.zeros(dcfg.num_workers, self.docs_per_worker,
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
        sub-round) slot, sub-round-major (``repro``'s draws and pulls, in
        its order). Returns the live batches only: ids and counts (n, B, L),
        flat memo rows (n, B), and the (W, S) drop flags."""
        w, s, b = (self.dcfg.num_workers, self.dcfg.staleness,
                   self.dcfg.batch_size)
        delay = self.rng.random((w, s)) < self.dcfg.delay_prob
        pulled = [(i, self.ingest[i].next_batch())
                  for j in range(s) for i in range(w) if not delay[i, j]]
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

    def run_round(self) -> None:
        """One global round: S sub-rounds of P concurrent worker batches."""
        tel = self.tel
        sp = tel.trace.begin("divi/round", workers=self.dcfg.num_workers,
                             staleness=self.dcfg.staleness) \
            if tel.enabled else None
        ids, cnts, rows, delay = self._ingest_round()
        self.state, self.shard = divi_round(
            self.cfg, self.state, self.shard,
            self._to_device(ids), self._to_device(cnts),
            self._to_device(rows), delay, self.num_words_total)
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
        return self.state.lam
