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
* a recurrent block (Mamba2, the mLSTM, the sLSTM) and zamba2's shared
  block compute the rank's heads (`repro_torch.models.recurrent.Share`):
  the rules store their leaves in contiguous blocks of concatenated
  dimensions, which do not line up with heads, so a layer assembles the
  columns its heads read (``LayerPlan.take`` and ``project``: the leaf
  gathered over ``model`` in a full-sequence call, the product's few rows
  in a decode step) and ends in one sum over ``model``;
* with ``seq_shard`` (and S > 1 divisible by the model axis) the residual
  stream between layers holds the rank's S / M rows: a tensor-parallel
  layer gathers its normed input over ``model`` and reduce-scatters its
  partial sums over S (Megatron's sequence parallelism).

Under autograd every rank returns the same loss and calls its backward;
the gradient of each of its blocks is then the global loss's. A gather
sums the ranks' cotangents of a block over the axes whose ranks each do a
part of the work (``resp``: the batch's axes, and ``model`` in a
sequence-parallel layer) and keeps the rank's own over the axes whose
ranks repeat it; a leaf replicated over such an axis has its gradient
summed over it (``sum_grad``, in coordinate order), and so has a
model-replicated leaf inside a tensor-parallel region (the router, a KV
projection whose heads do not divide ``model``, qk-norms). Each region's
replicated input enters through Megatron's *f* (``LayerPlan.enter``).
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.layers import Runs, merge_runs, take_runs
from repro_torch.sharding.comm import Collectives, make_collectives
from repro_torch.sharding.rules import (Spec, entry_axes, fsdp_axes,
                                        mesh_shape, param_specs)
from repro_torch.tree import is_namedtuple

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


def check_mesh_ctx(ctx, *, what: str = "ctx") -> Optional[MeshCtx]:
    """None for one card, else the ``MeshCtx`` that serving and training
    run on."""
    if ctx is None:
        return None
    if not isinstance(ctx, MeshCtx):
        raise TypeError(f"{what}: expected a MeshCtx (sharding.make_ctx) or "
                        f"None, got {type(ctx).__name__}")
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
    global batch of ``batch`` rows (sequences of ``seq_len`` positions;
    None for a decode step)."""

    def __init__(self, cfg, ctx: MeshCtx, batch: int,
                 seq_len: Optional[int] = None):
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
        # repro's _shard: the stream S-sharded over model where S divides
        self.seq = bool(ctx.seq_shard and self.tp and self.m_size > 1
                        and seq_len is not None and seq_len > 1
                        and seq_len % self.m_size == 0)

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

    def resp(self, seq_layer: bool = False) -> Tuple[str, ...]:
        """The axes whose ranks each compute a part of a call's work: the
        batch's, and ``model`` in a sequence-parallel layer."""
        return self.batch_axes + ((self.model,) if seq_layer and self.seq
                                  else ())

    # -- parameters ----------------------------------------------------
    def _sum_axes(self, spec: Spec, resp, partial: bool) -> Tuple[str, ...]:
        """The axes a leaf of ``spec`` is replicated over whose ranks each
        contribute a part of its gradient."""
        held = {a for e in spec for a in entry_axes(e)}
        want = set(resp) | ({self.model} if partial else set())
        return tuple(a for a in self.comm.shape
                     if a in want and a not in held
                     and self.comm.shape[a] > 1)

    def gather_data(self, tree, specs, resp=None, partial=()):
        """``tree``'s leaves gathered over the data axes (model-sharded
        dims stay the rank's block): one all-gather for the leaves of a
        dtype and placement (a layer's FSDP gather, as XLA combines it),
        their blocks packed into one flat buffer and cut back out.
        ``resp``: the axes whose ranks each use the leaves on their part
        (default the batch's); ``partial``: the top-level keys of ``tree``
        computed on in a tensor-parallel region, their model-replicated
        leaves' gradients summed over ``model``."""
        resp = self.batch_axes if resp is None else tuple(resp)
        jobs = {}           # (dtype, axes, grad-sum axes, sum axes) -> leaves

        def plan(t, s, top):
            dim, axes = None, ()
            for d, entry in enumerate(s):
                ax = entry_axes(entry)
                if ax and self.model not in ax:
                    dim, axes = d, ax
                    break
                if len(ax) > 1:
                    raise ValueError(f"spec {s}: a dim over {ax}")
            axes = self.comm.live_axes(axes)
            sums = self._sum_axes(s, resp, top in partial) \
                if torch.is_grad_enabled() and t.requires_grad else ()
            if axes or sums:
                key = (t.dtype, axes, tuple(a for a in axes if a in resp),
                       sums)
                jobs.setdefault(key, []).append((t, dim))
            return t

        _map_top(plan, tree, specs)
        done = {}
        for (_, axes, gsum, sums), leaves in jobs.items():
            g = self.comm.size(axes)
            flat = torch.cat([t.reshape(-1) for t, _ in leaves])
            flat = self.comm.sum_grad(flat, sums)
            parts = self.comm.all_gather(flat[None], 0, axes, grad_sum=gsum)
            off = 0
            for t, dim in leaves:
                n = t.numel()
                block = parts[:, off:off + n].reshape((g,) + tuple(t.shape))
                shape = list(t.shape)
                if dim is not None:
                    shape[dim] *= g
                    # coordinate-major along ``dim``: (.., G, block dim, ..)
                    block = block.movedim(0, dim)
                done[id(t)] = block.reshape(shape)
                off += n
        return _map(lambda t, s: done.get(id(t), t), tree, specs)

    def model_sharded(self, spec: Spec, dim: int) -> bool:
        return self.model in entry_axes(spec[dim])

    def model_block(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``t`` along ``dim`` over ``model`` (a
        model-replicated leaf of a tensor-parallel region: ``layer`` sums
        its gradient over ``model``)."""
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
        """The model ranks' blocks along ``dim``, concatenated (every rank
        then computes on the whole)."""
        return self.comm.all_gather(x, dim, (self.model,))

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's *f*: ``x``, which every model rank holds, into a
        computation each does a part of; the backward sums over
        ``model``."""
        return self.comm.sum_grad(x, (self.model,), ordered=False)

    # -- the sequence-parallel stream ------------------------------------
    def seq_gather(self, x: torch.Tensor, partial: bool) -> torch.Tensor:
        """The model ranks' S blocks of ``x`` (B, S / M, ...), gathered;
        ``partial``: each rank then answers for its own rows only (the
        backward sums the ranks' cotangents), else every rank computes on
        the whole (the backward keeps the rank's rows)."""
        return self.comm.all_gather(x, 1, (self.model,),
                                    grad_sum=(self.model,) if partial else ())

    def seq_split(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's S block of ``x`` (B, S, ...), which every model rank
        holds."""
        return self.comm.split(x, 1, (self.model,))

    def seq_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's S block of its own ``x`` (B, S, ...)."""
        return self.comm.own(x, 1, (self.model,))

    def _planned(self, p, spec):
        lp = LayerPlan(self, spec)
        partial = () if self.seq else lp.partial_keys()
        return self.gather_data(p, spec, self.resp(True), partial), lp

    def layer(self, i: int, kind: str, p):
        """Layer ``i``'s parameters as the rank computes with them (its
        leaves gathered over the data axes), and its ``LayerPlan``."""
        return self._planned(p, self.specs["layers"][i])

    def shared_block(self, shared):
        """zamba2's shared block as the rank computes with it, and its
        ``LayerPlan``: gathered once a call for every layer that applies
        it."""
        return self._planned(shared, self.specs["shared_attn"])

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

    def cache_gather(self, cache, specs):
        """A cache's leaves gathered over the axes of their dim 1 (a ring
        buffer's W blocks, a B = 1 recurrent state's blocks over the data
        axes; a layer reads its heads of what the rank holds past it),
        restricted to this rank's rows."""
        def one(t, s):
            sub = self.cache_sub_rows(s)
            if sub is not None:
                t = t[sub]
            axes = entry_axes(s[1]) if len(s) > 1 else ()
            return self.comm.all_gather(t, 1, axes) if axes else t
        return _map(one, cache, specs)

    def cache_block(self, local, work, specs, in_place=False):
        """``cache_gather``'s inverse: the rank's block of each gathered
        leaf of ``work``, written into ``local`` in place (``in_place``)
        or returned as new leaves."""
        def one(t_local, t_work, s):
            if t_work is t_local:       # nothing gathered: written in place
                return t_local
            axes = entry_axes(s[1]) if len(s) > 1 else ()
            block = self.comm.own(t_work, 1, axes) if axes else t_work
            sub = self.cache_sub_rows(s)
            if in_place:
                (t_local if sub is None else t_local[sub]).copy_(block)
                return t_local
            if sub is None:
                return block.clone(memory_format=torch.contiguous_format) \
                    if axes else block
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
    """One layer's tensor-parallel placement: its parameters' specs decide
    which heads, FFN columns and experts the rank computes."""

    def __init__(self, plan: RankPlan, spec):
        self.plan = plan
        self.spec = spec

    @property
    def split(self) -> bool:
        """Whether the model axis splits the layer's work over more than
        one rank (tensor parallelism; not under fsdp_only)."""
        return self.plan.tp and self.plan.m_size > 1

    def heads(self):
        from repro_torch.models.attention import head_slice
        return head_slice(self.plan.cfg, self.spec["attn"], self.plan)

    def mlp_sharded(self) -> bool:
        return "mlp" in self.spec \
            and self.plan.model_sharded(self.spec["mlp"]["w_up"], 1)


    def partial_keys(self) -> Tuple[str, ...]:
        """The top-level keys of the layer computed on in a
        tensor-parallel region (each model rank a part, summed after)."""
        keys = []
        if "attn" in self.spec and self.heads().reduce:
            keys.append("attn")
        if self.mlp_sharded():
            keys.append("mlp")
        if "moe" in self.spec and self.split:
            keys.append("moe")
        if "in_proj" in self.spec and "attn" in keys:
            keys.append("in_proj")          # zamba2's shared block
        keys += [k for k in ("mamba", "cell") if k in self.spec
                 and self.split]
        return tuple(keys)

    # -- a leaf's columns the rank's heads read ---------------------------
    def _own(self, t: torch.Tensor, dim: int) -> Runs:
        n = t.shape[dim]
        return [(self.plan.m * n, (self.plan.m + 1) * n)]

    def take(self, t: torch.Tensor, spec: Spec, dim: int, runs: Runs,
             partial: bool = True) -> torch.Tensor:
        """The entries ``runs`` ((start, stop) pairs of the full leaf) of a
        leaf along ``dim`` from the rank's block ``t``: where the rank's
        block holds exactly them, ``t``; else each dim sharded over
        ``model`` gathered first. ``partial``: the entries are computed on
        in a tensor-parallel region (each model rank a part), so the
        gather's backward sums the ranks' cotangents; else every rank
        repeats the computation and keeps its own block's."""
        plan = self.plan
        for d, entry in enumerate(spec):
            if plan.model not in entry_axes(entry) or plan.m_size == 1:
                continue
            if d == dim and merge_runs(runs) == self._own(t, d):
                return t
            t = plan.comm.all_gather(t, d, (plan.model,),
                                     grad_sum=(plan.model,) if partial
                                     else ())
        return take_runs(t, dim, runs)

    def project(self, x: torch.Tensor, t: torch.Tensor, spec: Spec,
                runs: Runs, rows: bool, partial: bool = True
                ) -> torch.Tensor:
        """``x @ W[:, runs]`` for a (K, N) leaf ``W`` of which the rank
        holds ``t``. Where ``W``'s columns are sharded over ``model`` and
        ``runs`` are not the rank's own: with ``rows`` (a decode step's few
        rows) the product of the rank's block, its rows gathered over
        ``model``; else ``take``'s columns (a full sequence: the weight's
        bytes are the smaller). Both compute the same function."""
        plan = self.plan
        if rows and plan.m_size > 1 and plan.model_sharded(spec, 1) \
                and merge_runs(runs) != self._own(t, 1):
            y = x @ t.to(x.dtype)
            y = plan.comm.all_gather(y, y.ndim - 1, (plan.model,),
                                     grad_sum=(plan.model,) if partial
                                     else ())
            return take_runs(y, y.ndim - 1, runs)
        return x @ self.take(t, spec, 1, runs, partial).to(x.dtype)

    def enter(self, x: torch.Tensor, partial: bool) -> torch.Tensor:
        """A region's normed input ``x``: under ``seq_shard`` its S blocks
        gathered (the backward a reduce-scatter), else *f* where the
        region is ``partial``."""
        if self.plan.seq:
            return self.plan.seq_gather(x, partial=True)
        return self.plan.enter(x) if partial else x

    def leave(self, h: torch.Tensor, partial: bool) -> torch.Tensor:
        """A region's output: the model ranks' partials summed (under
        ``seq_shard`` reduce-scattered over S; a whole region's rows
        kept)."""
        plan = self.plan
        if plan.seq:
            return plan.comm.reduce_scatter(h, 1, (plan.model,)) if partial \
                else plan.seq_rows(h)
        return plan.msum(h) if partial else h


def _map_top(fn, tree, specs):
    """``fn(leaf, spec, top)`` over ``tree``'s leaves, ``top`` the
    top-level key a leaf lies under (None at the top)."""
    if isinstance(tree, dict):
        return {k: _map(lambda t, s, k=k: fn(t, s, k), v, specs[k])
                for k, v in tree.items()}
    return _map(lambda t, s: fn(t, s, None), tree, specs)


__all__ = ["LayerPlan", "MeshCtx", "RankPlan", "ShardedCaches",
           "check_mesh_ctx", "ctx_param_specs", "ctx_profile", "make_ctx"]
