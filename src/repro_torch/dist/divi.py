"""D-IVI over a device mesh: one global round as one program a rank.

The port's counterpart of ``repro.dist.divi`` (``make_divi_round``, a
``shard_map`` round). The layout is ``repro``'s, on a ``("data",
"model")`` mesh (or ``("pod", "data", "model")``), one process a mesh
position over ``torch.distributed``:

* **master state** λ / ⟨m_vk⟩ / init_mass: each rank holds the V/M rows
  its model coordinate owns; init_frac and t are replicated;
* **worker state** (the π memos) and the round's inputs: each rank holds
  the W/D workers of its data coordinate, block ``[d·W/D, (d+1)·W/D)``
  (``repro``'s ``P(data_axes)``), replicated across ``model``;
* **the λ fetch** is one all-gather of the model-sharded rows a round;
  Eφ is taken from the full λ, as in the simulation;
* **the E-step** runs each sub-round's live workers of the rank through
  ``worker_correction`` (one grouped K1 with its π finish and one K3 on
  the ``cuda`` backend), replicated across ``model``;
* **the reduction**, one a sub-round: each rank all-gathers over the data
  axes the rows of the correction its model coordinate owns, with the
  first-visit word count, and sums them in data-rank order. All-reduce
  and reduce-scatter are not used: their order belongs to the backend, so
  gloo and NCCL would give different bits. Each rank receives D·(V/M)·K
  floats a sub-round;
* **the master step** ``master_update`` on the local rows: it is
  elementwise in V.

The backend is the caller's process group's. With gloo every collective
runs on host copies (gloo's CUDA support does not cover all-gather); with
NCCL on device tensors; any other backend raises.

Two contracts hold the round:

* ``divi_round_emulated(..., data=D, model=M)``, one process, computes
  each data rank's correction with the same ``worker_correction`` and sums
  them in the same order: the mesh round at any layout gives its bits.
* At D = 1 that is the one-device simulation
  (`dist.protocol.divi_round`) bit for bit. At D > 1 the simulation runs
  one K3 over every worker's rows, which groups the sums differently;
  there the two agree to ``repro``'s bar for its ``shard_map`` round, max
  |Δλ| < 5e-4 after 5 rounds.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.math import exp_dirichlet_expectation
from repro_torch.core.types import LDAConfig
from repro_torch.dist.protocol import (DIVIConfig, DIVIState, WorkerShard,
                                       master_update, worker_correction)
from repro_torch.launch.mesh import AbstractMesh, mesh_layout

__all__ = ["DIVIConfig", "DIVIState", "MeshRound", "WorkerShard",
           "divi_round_emulated", "make_divi_round", "ordered_sum"]

_STATE_FIELDS = ("lam", "m_vk", "init_mass", "init_frac", "t")


def ordered_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Σ parts, left to right: the reduction's fixed order."""
    acc = parts[0].clone()
    for p in parts[1:]:
        acc.add_(p)
    return acc


def _packed(corr: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """The sub-round's message: the correction rows, flat, then the
    first-visit word count."""
    return torch.cat([corr.reshape(-1), words.reshape(1).to(corr.dtype)])


class _Group:
    """The ranks of one mesh line (the data axes, or ``model``) around this
    rank, and the all-gather over them in the line's coordinate order."""

    def __init__(self, mesh, axes: Tuple[str, ...]):
        names, sizes = mesh_layout(mesh)
        pos = [names.index(a) for a in axes]
        self.size = math.prod(sizes[i] for i in pos)
        self.received_bytes = 0       # by this rank, over its life
        if isinstance(mesh, AbstractMesh):
            self.group = None
            return
        ranks = mesh.mesh
        rest = [i for i in range(len(names)) if i not in pos]
        table = ranks.permute(rest + pos).reshape(-1, self.size).tolist()
        me = dist.get_rank()
        self.group = self.members = None
        for line in table:        # every rank makes every group, in order
            g = dist.new_group(line)
            if me in line:
                self.group, self.members = g, line
        self.backend = dist.get_backend(self.group)
        if self.backend not in ("gloo", "nccl"):
            raise ValueError(f"D-IVI's mesh round runs on gloo or NCCL, not "
                             f"{self.backend!r}")
        # the all-gather's slots are group ranks: read them in line order
        self.slot = [dist.get_group_rank(self.group, r)
                     for r in self.members]

    @property
    def index(self) -> int:
        """This rank's coordinate along the line (0 on an abstract mesh)."""
        if self.group is None:
            return 0
        return self.members.index(dist.get_rank())

    def all_gather_object(self, obj) -> list:
        """Every member's picklable ``obj``, in line order."""
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return [out[s] for s in self.slot]

    def all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every member's ``x`` in line order, on ``x``'s device. An
        abstract mesh returns tensors of the output shapes."""
        self.received_bytes += self.size * x.numel() * x.element_size()
        if self.group is None:
            return [torch.empty_like(x) for _ in range(self.size)]
        if self.backend == "gloo":
            host = x.to("cpu").contiguous()
            out = [torch.empty_like(host) for _ in range(self.size)]
            dist.all_gather(out, host, group=self.group)
            out = [t.to(x.device) for t in out]
        else:
            x = x.contiguous()
            out = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(out, x, group=self.group)
        return [out[s] for s in self.slot]


class MeshRound:
    """``make_divi_round``'s callable: one global round on this rank.

    ``round(state, shard, token_ids, counts, rows, delay, num_words_total)``
    updates the rank's state and memo in place and returns them, with

      state: DIVIState whose (V, K) leaves hold this rank's ``rows`` of V;
      shard: WorkerShard of this rank's ``workers``;
      token_ids/counts: (n, B, L) this rank's live (worker, sub-round)
        batches, sub-round-major, in worker order within a sub-round;
      rows: (n, B) int64 flat memo rows in the rank's shard;
      delay: (W, S) host bool, every worker's drop coins;
      num_words_total: () float32.

    Every rank calls it once a round: it holds one all-gather over
    ``model`` and one over the data axes a sub-round.
    """

    def __init__(self, cfg: LDAConfig, dcfg: DIVIConfig, mesh,
                 data_axes: Optional[Sequence[str]] = None):
        names, sizes = mesh_layout(mesh)
        if data_axes is None:
            data_axes = tuple(a for a in names if a != "model")
        data_axes = tuple(data_axes)
        unknown = [a for a in data_axes if a not in names]
        if unknown:
            raise ValueError(f"data axes {unknown} are not mesh axes "
                             f"{names}")
        n_data = math.prod(sizes[names.index(a)] for a in data_axes)
        has_model = "model" in names
        n_model = sizes[names.index("model")] if has_model else 1
        if math.prod(sizes) != n_data * n_model:
            raise ValueError(f"mesh axes {names} are neither data axes "
                             f"{data_axes} nor 'model'")
        if dcfg.num_workers % n_data:
            raise ValueError(
                f"num_workers={dcfg.num_workers} not divisible by the "
                f"data-mesh size {n_data} ({data_axes})")
        if cfg.vocab_size % n_model:
            raise ValueError(
                f"vocab_size={cfg.vocab_size} not divisible by the model "
                f"axis ({n_model}) — pad V")
        self.cfg, self.dcfg, self.mesh = cfg, dcfg, mesh
        self.data_axes, self.n_data, self.n_model = data_axes, n_data, n_model
        self.abstract = isinstance(mesh, AbstractMesh)
        self.data = _Group(mesh, data_axes)
        self.model = _Group(mesh, ("model",) if has_model else ())
        v_local = cfg.vocab_size // n_model
        m = self.model.index
        self.rows = slice(m * v_local, (m + 1) * v_local)
        w_local = dcfg.num_workers // n_data
        d = self.data.index
        self.workers = range(d * w_local, (d + 1) * w_local)

    # -- the rank's pieces of the full state ---------------------------
    def local_state(self, full: DIVIState) -> DIVIState:
        """This rank's rows of a full state (copies; scalars replicated)."""
        return DIVIState(**{
            f: (getattr(full, f)[self.rows].clone() if f in
                ("lam", "m_vk", "init_mass") else getattr(full, f).clone())
            for f in _STATE_FIELDS})

    def gather_lam(self, lam_local: torch.Tensor) -> torch.Tensor:
        """The full (V, K) λ from every model coordinate's rows: a
        collective of the model line."""
        return torch.cat(self.model.all_gather(lam_local))

    # -- the round -----------------------------------------------------
    def __call__(self, state: DIVIState, shard: WorkerShard,
                 token_ids: torch.Tensor, counts: torch.Tensor,
                 rows: torch.Tensor, delay: np.ndarray,
                 num_words_total: torch.Tensor
                 ) -> Tuple[DIVIState, WorkerShard]:
        cfg = self.cfg
        # "fetch λ from the master", then Eφ of the full λ as the
        # simulation takes it
        eb = exp_dirichlet_expectation(self.gather_lam(state.lam), axis=0)
        v_local = state.lam.shape[0]
        b, l = token_ids.shape[1:]
        live_local = ~np.asarray(delay)[self.workers.start:self.workers.stop]
        start = 0
        for live in live_local.sum(axis=0):
            n = int(live)
            if n:
                part = slice(start, start + n)
                corr, words = worker_correction(
                    cfg, eb, token_ids[part].reshape(n * b, l),
                    counts[part].reshape(n * b, l), shard,
                    rows[part].reshape(n * b), b)
                corr = corr[self.rows]
            else:
                corr = torch.zeros_like(state.lam)
                words = torch.zeros((), dtype=torch.float32,
                                    device=state.lam.device)
            # "send the correction to the master": the sub-round's message
            total = ordered_sum(self.data.all_gather(_packed(corr, words)))
            master_update(cfg, state, total[:-1].view(v_local, -1),
                          total[-1], num_words_total)
            start += n
        return state, shard


def make_divi_round(cfg: LDAConfig, dcfg: DIVIConfig, mesh,
                    data_axes: Optional[Sequence[str]] = None) -> MeshRound:
    """The D-IVI round for this rank of ``mesh`` (a ``DeviceMesh`` over the
    caller's process group, or an ``AbstractMesh`` for a shape-only run on
    ``meta`` tensors). ``data_axes`` defaults to every axis but
    ``model``. Refuses a worker count the data axes do not divide and a V
    the model axis does not divide, in ``repro``'s words."""
    return MeshRound(cfg, dcfg, mesh, data_axes)


def divi_round_emulated(cfg: LDAConfig, state: DIVIState, shard: WorkerShard,
                        token_ids: torch.Tensor, counts: torch.Tensor,
                        rows: torch.Tensor, delay: np.ndarray,
                        num_words_total: torch.Tensor, *, data: int,
                        model: int = 1) -> Tuple[DIVIState, WorkerShard]:
    """The mesh round at layout (``data``, ``model``), in one process: the
    one-device simulation's arguments (`dist.protocol.divi_round`: the
    full state and every worker's memo), each data rank's correction by
    ``worker_correction`` over its block of workers, summed in data-rank
    order, then the master step. The model axis changes no bit (the
    E-step is replicated and the master step elementwise in V); it is
    checked as the mesh checks it. A twin for the tests and the card
    check, on no training path."""
    w = shard.pi.shape[0]
    if w % data:
        raise ValueError(f"num_workers={w} not divisible by the data-mesh "
                         f"size {data}")
    if cfg.vocab_size % model:
        raise ValueError(f"vocab_size={cfg.vocab_size} not divisible by the "
                         f"model axis ({model}) — pad V")
    eb = exp_dirichlet_expectation(state.lam, axis=0)
    b, l = token_ids.shape[1:]
    live = ~np.asarray(delay)
    block = w // data
    start = 0
    for j in range(live.shape[1]):
        parts = []
        for d in range(data):
            n = int(live[d * block:(d + 1) * block, j].sum())
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
            parts.append(_packed(corr, words))
            start += n
        total = ordered_sum(parts)
        master_update(cfg, state, total[:-1].view(state.lam.shape),
                      total[-1], num_words_total)
    return state, shard
