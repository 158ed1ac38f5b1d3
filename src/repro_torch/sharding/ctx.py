"""The mesh context of the LM template and a rank's plan of one call.

``MeshCtx`` is ``repro``'s (``repro.models.moe.MeshCtx``: the mesh, the
data axes, the model axis, the sequence-sharding lever) with one field
more, ``comm``: the collectives every sharded module goes through
(`repro_torch.sharding.comm`). ``make_ctx`` builds it as
``repro.launch.dryrun.make_ctx`` does, the fsdp_only profile adding
``model`` to the data axes.

A sharded call runs as one program a rank. ``RankPlan`` holds what a rank
decides once a call, from the rules (`repro_torch.sharding.rules`) and
nothing else:
* its rows of the batch: a block over the data axes where they divide the
  global batch (``batch_specs``), else every row;
* the spec of every parameter (``param_specs`` of the config's full
  shapes) and of every cache (``cache_specs``, carried by
  ``ShardedCaches``);
* a leaf sharded over the data axes is all-gathered over them when its
  layer runs (``gather_data``) and dropped after it;
* a leaf sharded over ``model`` is computed on in parallel, its partial
  sums reduced over ``model`` (``msum``); a leaf the rules replicate over
  ``model`` is computed on whole on every model rank;
* the recurrent blocks (and zamba2's shared block) gather every leaf and
  compute whole (``gather_whole``): the same function, more bytes.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import MAMBA2, MAMBA2_SHARED, MLSTM, SLSTM
from repro_torch.sharding.comm import Collectives, make_collectives
from repro_torch.sharding.rules import (Spec, entry_axes, fsdp_axes,
                                        mesh_shape, param_specs)
from repro_torch.tree import is_namedtuple

#: ROADMAP §1's next item, named by the refusals.
TRAINING_ITEM = "ROADMAP §1 item 10.5"


class MeshCtx(NamedTuple):
    """Axis names and collectives of a sharded call (None → one card)."""

    mesh: object                  # DeviceMesh, or AbstractMesh (dry run)
    data_axes: Tuple[str, ...]    # e.g. ("pod", "data")
    model_axis: str               # "model"
    seq_shard: bool = False       # sequence-parallel residual stream (SP)
    comm: Optional[Collectives] = None


def make_ctx(mesh, seq_shard: bool = False, profile: str = "tp_fsdp",
             coords=None) -> MeshCtx:
    """The context of ``mesh``: a live ``DeviceMesh`` (this process's
    position) or an ``AbstractMesh`` at ``coords`` (the dry run)."""
    data_axes = fsdp_axes(mesh)
    if profile == "fsdp_only":
        # no tensor parallelism: the model axis carries batch/data too
        data_axes = data_axes + ("model",)
    elif profile != "tp_fsdp":
        raise ValueError(f"profile={profile!r}; expected 'tp_fsdp' or "
                         "'fsdp_only'")
    return MeshCtx(mesh=mesh, data_axes=data_axes, model_axis="model",
                   seq_shard=seq_shard, comm=make_collectives(mesh, coords))


def ctx_profile(ctx: MeshCtx) -> str:
    return "fsdp_only" if ctx.model_axis in ctx.data_axes else "tp_fsdp"


def training_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: training over a mesh (autograd through the collectives, "
        "the vocab-parallel loss, the FSDP gradients, the optimizer on the "
        f"local blocks) is not ported to repro_torch yet ({TRAINING_ITEM}); "
        "serving runs over a MeshCtx, training with ctx=None")


def seq_shard_not_ported() -> NotImplementedError:
    return NotImplementedError(
        "seq_shard=True: the sequence-parallel residual stream is not "
        f"ported to repro_torch yet ({TRAINING_ITEM})")


def check_mesh_ctx(ctx, *, training: bool = False,
                   what: str = "ctx") -> Optional[MeshCtx]:
    """None for one card; a ``MeshCtx`` that serving runs on; raises for
    training over a mesh and for ``seq_shard``."""
    if ctx is None:
        return None
    if not isinstance(ctx, MeshCtx):
        raise TypeError(f"{what}: expected a MeshCtx (sharding.make_ctx) or "
                        f"None, got {type(ctx).__name__}")
    if training:
        raise training_not_ported(what)
    if ctx.seq_shard:
        raise seq_shard_not_ported()
    if ctx.comm is None:
        raise ValueError(f"{what}: the MeshCtx has no collectives; build it "
                         "with sharding.make_ctx")
    return ctx


# ---------------------------------------------------------------------------
# the full shapes the rules place
# ---------------------------------------------------------------------------

def _layout(ctx: MeshCtx) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    shape = mesh_shape(ctx.mesh)
    return tuple(shape), tuple(shape.values())


@functools.lru_cache(maxsize=64)
def _param_specs(cfg, names, sizes, profile):
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.models.transformer import param_shapes
    return param_specs(make_abstract_mesh(sizes, names), param_shapes(cfg),
                       profile)


def ctx_param_specs(cfg, ctx: MeshCtx):
    """``param_specs`` of ``cfg``'s full parameter shapes on ``ctx``'s mesh
    and profile (cached)."""
    return _param_specs(cfg, *_layout(ctx), ctx_profile(ctx))


class ShardedCaches(list):
    """A rank's decode caches (one a layer, each leaf its block) with the
    placement they were cut by: ``specs`` (``cache_specs`` of the full
    caches) and the global ``batch``. ``init_caches(..., ctx=)`` makes
    them; ``decode_step`` takes and returns them."""

    def __init__(self, caches, specs, batch: int):
        super().__init__(caches)
        self.specs = specs
        self.batch = int(batch)


#: the blocks a rank runs whole, every leaf gathered (no head-parallel
#: form yet: ROADMAP §1 item 10.6)
WHOLE_KINDS = (MAMBA2, MAMBA2_SHARED, MLSTM, SLSTM)


def whole_blocks(cfg) -> set:
    """The block kinds of ``cfg`` a rank runs whole, and zamba2's shared
    block."""
    kinds = {k for k in cfg.pattern if k in WHOLE_KINDS}
    return kinds | ({"shared_attn"} if MAMBA2_SHARED in cfg.pattern
                    else set())


# ---------------------------------------------------------------------------
# a rank's plan of one call
# ---------------------------------------------------------------------------

def _map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map(fn, v, specs[k]) for k, v in tree.items()}
    if is_namedtuple(tree):
        return type(tree)(*(_map(fn, v, s) for v, s in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


class RankPlan:
    """What this rank computes in one sharded call of ``cfg`` with a
    global batch of ``batch`` rows."""

    def __init__(self, cfg, ctx: MeshCtx, batch: int):
        self.cfg, self.ctx, self.comm = cfg, ctx, ctx.comm
        self.specs = ctx_param_specs(cfg, ctx)
        self.model = ctx.model_axis
        shape = self.comm.shape
        self.m_size = shape.get(self.model, 1)
        self.m = self.comm.coords.get(self.model, 0)
        self.tp = self.model not in ctx.data_axes
        self.batch = int(batch)
        # the batch's axes: repro's input_specs (fsdp_only tries every
        # axis, then the data axes alone)
        fs = tuple(a for a in ctx.data_axes if a != self.model)
        tries = [ctx.data_axes] + ([fs] if not self.tp else [])
        self.batch_axes: Tuple[str, ...] = ()
        for axes in tries:
            if self.batch % self.comm.size(axes) == 0:
                self.batch_axes = tuple(axes)
                break
        self.n_data = self.comm.size(ctx.data_axes)
        n = self.comm.size(self.batch_axes)
        b_local = self.batch // n
        i = self.comm.index(self.batch_axes)
        self.rows = slice(i * b_local, (i + 1) * b_local)
        self.b_local = b_local

    # -- the batch -----------------------------------------------------
    @property
    def batch_sharded(self) -> bool:
        """Whether the data axes divide the batch (``repro``'s MoE
        ``data_sharded``)."""
        return self.batch % self.n_data == 0

    def local_batch(self, batch: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        return {k: v[self.rows] for k, v in batch.items()}

    def local_rows(self, t: torch.Tensor) -> torch.Tensor:
        return t[self.rows]

    # -- parameters ----------------------------------------------------
    def _gather_leaf(self, t: torch.Tensor, spec: Spec) -> torch.Tensor:
        for dim, entry in enumerate(spec):
            axes = entry_axes(entry)
            if axes:
                t = self.comm.all_gather(t, dim, axes)
        return t

    def gather_data(self, tree, specs):
        """``tree``'s leaves gathered over the data axes (model-sharded
        dims stay the rank's block): one all-gather a dtype for the whole
        tree (a layer's FSDP gather, as XLA combines it), its leaves'
        blocks packed into one flat buffer and cut back out."""
        jobs = {}                       # (dtype, axes) -> [(leaf, dim)]

        def plan(t, s):
            for dim, entry in enumerate(s):
                axes = entry_axes(entry)
                if axes and self.model not in axes:
                    jobs.setdefault((t.dtype, axes), []).append((t, dim))
                    return t
                if len(axes) > 1:
                    raise ValueError(f"spec {s}: a dim over {axes}")
            return t

        _map(plan, tree, specs)
        done = {}
        for (_, axes), leaves in jobs.items():
            g = self.comm.size(axes)
            flat = torch.cat([t.reshape(-1) for t, _ in leaves])
            parts = self.comm.all_gather(flat[None], 0, axes)   # (G, n)
            off = 0
            for t, dim in leaves:
                n = t.numel()
                block = parts[:, off:off + n].reshape((g,) + tuple(t.shape))
                shape = list(t.shape)
                shape[dim] *= g
                # coordinate-major along ``dim``: (.., G, block dim, ..)
                done[id(t)] = block.movedim(0, dim).reshape(shape)
                off += n
        return _map(lambda t, s: done.get(id(t), t), tree, specs)

    def gather_whole(self, tree, specs):
        """``tree``'s leaves gathered over every axis."""
        return _map(self._gather_leaf, tree, specs)

    def model_sharded(self, spec: Spec, dim: int) -> bool:
        return self.model in entry_axes(spec[dim])

    def model_block(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``t`` along ``dim`` over ``model``."""
        n = t.shape[dim]
        if n % self.m_size:
            raise ValueError(f"dim {n} does not divide over the model axis "
                             f"({self.m_size})")
        step = n // self.m_size
        return t.narrow(dim, self.m * step, step)

    def msum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the model ranks' partials."""
        return self.comm.all_reduce(x, self.model)

    def mgather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The model ranks' blocks along ``dim``, concatenated."""
        return self.comm.all_gather(x, dim, (self.model,))

    def layer(self, i: int, kind: str, p):
        """Layer ``i``'s parameters as the rank computes with them, and
        its ``LayerPlan`` (None for a block computed whole)."""
        spec = self.specs["layers"][i]
        if kind in WHOLE_KINDS:
            return self.gather_whole(p, spec), None
        return self.gather_data(p, spec), LayerPlan(self, spec)

    def shared_block(self, shared):
        """zamba2's shared block, whole."""
        return self.gather_whole(shared, self.specs["shared_attn"])

    # -- caches --------------------------------------------------------
    def cache_sub_rows(self, spec: Spec) -> Optional[slice]:
        """The rows of a cache block that this rank's batch rows are, where
        the cache's batch axes are fewer than the batch's (fsdp_only)."""
        cache_axes = entry_axes(spec[0]) if len(spec) else ()
        if tuple(cache_axes) == self.batch_axes:
            return None
        extra = [a for a in self.batch_axes if a not in cache_axes]
        if list(cache_axes) + extra != list(self.batch_axes):
            raise ValueError(f"cache batch axes {cache_axes} against the "
                             f"batch's {self.batch_axes}")
        i = self.comm.index(tuple(extra))
        return slice(i * self.b_local, (i + 1) * self.b_local)

    def cache_gather(self, cache, specs, dims=None):
        """A cache's leaves gathered over the axes of their dims past the
        batch (``dims``: which, default all), restricted to this rank's
        rows."""
        def one(t, s):
            sub = self.cache_sub_rows(s)
            if sub is not None:
                t = t[sub]
            for d in range(1, len(s)):
                if dims is None or d in dims:
                    axes = entry_axes(s[d])
                    if axes:
                        t = self.comm.all_gather(t, d, axes)
            return t
        return _map(one, cache, specs)

    def cache_block(self, local, work, specs, dims=None, in_place=False):
        """``cache_gather``'s inverse: the rank's block of each gathered
        leaf of ``work``, written into ``local`` in place (``in_place``)
        or returned as new leaves."""
        def one(t_local, t_work, s):
            sl = [slice(None)] * t_work.ndim
            for d in range(1, len(s)):
                if dims is None or d in dims:
                    axes = entry_axes(s[d])
                    if axes:
                        n = t_work.shape[d] // self.comm.size(axes)
                        i = self.comm.index(axes)
                        sl[d] = slice(i * n, (i + 1) * n)
            sub = self.cache_sub_rows(s)
            if t_work is t_local:       # nothing gathered: written in place
                return t_local
            cut = any(x != slice(None) for x in sl)
            block = t_work[tuple(sl)]
            if in_place:
                (t_local if sub is None else t_local[sub]).copy_(block)
                return t_local
            if sub is None:
                return block.clone(memory_format=torch.contiguous_format) \
                    if cut else block
            out = t_local.clone()
            out[sub] = block
            return out

        def walk(lo, wo, s):
            if is_namedtuple(lo):
                return type(lo)(*(walk(a, b, c) for a, b, c in zip(lo, wo, s)))
            if isinstance(lo, (list, tuple)):
                return type(lo)(walk(a, b, c) for a, b, c in zip(lo, wo, s))
            return one(lo, wo, s)
        return walk(local, work, specs)


class LayerPlan:
    """One attention-bearing layer's tensor-parallel placement: its
    parameters' specs decide which heads, FFN columns and experts the rank
    computes."""

    def __init__(self, plan: RankPlan, spec):
        self.plan = plan
        self.spec = spec

    def heads(self):
        from repro_torch.models.attention import head_slice
        return head_slice(self.plan.cfg, self.spec["attn"], self.plan)

    def mlp_sharded(self) -> bool:
        return self.plan.model_sharded(self.spec["mlp"]["w_up"], 1)

    def msum(self, x):
        return self.plan.msum(x)


__all__ = ["LayerPlan", "MeshCtx", "RankPlan", "ShardedCaches",
           "check_mesh_ctx", "ctx_param_specs", "ctx_profile", "make_ctx",
           "seq_shard_not_ported", "training_not_ported", "whole_blocks"]
