"""The collectives of a sharded model: one object a ``MeshCtx`` holds.

Every collective a rank of the LM template runs goes through it; no model
module calls ``torch.distributed`` itself, so a rank cannot reach a
collective the others skip. Four operations:

* ``all_gather(x, dim, axes)``: the blocks of ``x`` along ``dim`` from
  every position of ``axes`` (the first axis major), concatenated in
  coordinate order: one gather an axis, the minor axis first;
* ``all_reduce(x, axis)``: the sum over one axis (the model-axis sum of
  tensor-parallel partials), in the backend's order;
* ``ordered_sum(x, axes)``: the sum over ``axes`` in coordinate order,
  from an all-gather: exact and the same on every backend (the MoE's
  statistics, the loss's sums, the gradients of replicated leaves);
* ``reduce_scatter(x, dim, axes)``: ``x`` holds every position's block
  along ``dim`` (a rank's partial of the whole); each rank receives the
  other ranks' partials of its own block (``all_to_all``) and adds them in
  coordinate order in fp32: the same sum on gloo, NCCL and ``meta``.

Axes of size 1 cost nothing and leave ``x`` as it is. An all-gather
may name the kind its bytes count under (``kind``): a decode step's
restore of the replicated recurrent states counts as ``state_restore``,
apart from the ``all_gather`` of weights and activations.

Autograd goes through all four (``torch.autograd.Function``s where
autograd records). Where a backward goes depends on what the ranks do
with the result, which the caller says:

* ``all_gather``'s ``grad_sum`` names the gathered axes whose ranks each
  computed a part of the result's uses (an FSDP leaf's data axes when each
  data rank runs its own rows; the sequence blocks of ``seq_shard``): the
  backward sums those ranks' cotangents of a rank's block, a
  ``reduce_scatter``. Over the other gathered axes every rank repeated the
  same computation, and the backward keeps the rank's own block;
* ``all_reduce`` and ``ordered_sum`` leave every rank of the axes with the
  same value: the backward passes the cotangent through;
* ``reduce_scatter``'s backward gathers the cotangent's blocks;
* ``split(x, dim, axes)``, a rank's own block of a value every rank
  holds, gathers the cotangent's blocks in the backward;
* ``sum_grad(x, axes)`` is the identity whose backward sums over ``axes``
  (Megatron's *f*): where a value every rank of ``axes`` holds enters
  computation that each rank does a part of.

``LiveCollectives`` runs them on the process groups of a ``DeviceMesh``:
NCCL on device tensors, gloo on host copies in the tensor's own dtype.
``MetaCollectives`` is the dry run's: no process group, each output a
``meta`` tensor of its shape. Both add up the bytes that each operation
brings into the rank, by kind (``received``), counted in the tensor's own
dtype: an all-gather or a reduce-scatter over G positions brings in
(G − 1) blocks; an all-reduce over M ranks 2·(M − 1)/M of the tensor (a
ring's reduce-scatter and all-gather). A backward's collectives count
under their own kinds.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.sharding.rules import entry_axes, mesh_coords, mesh_shape


class Collectives:
    """What both implementations share: the mesh's axes, this rank's
    coordinates, the byte counts and the autograd wrappers."""

    def __init__(self, mesh, coords: Mapping[str, int]):
        self.mesh = mesh
        self.shape: Dict[str, int] = mesh_shape(mesh)
        self.coords: Dict[str, int] = dict(coords)
        self.received: Dict[str, float] = {"all_gather": 0.0,
                                           "all_reduce": 0.0,
                                           "reduce_scatter": 0.0,
                                           "state_restore": 0.0}

    # -- the rank's place ----------------------------------------------
    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in entry_axes(axes))

    def index(self, axes) -> int:
        """This rank's linear coordinate over ``axes`` (the first major)."""
        idx = 0
        for a in entry_axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def live_axes(self, axes) -> Tuple[str, ...]:
        """``axes`` without those of size 1."""
        return tuple(a for a in entry_axes(axes) if self.shape[a] > 1)

    def reset(self) -> None:
        for k in self.received:
            self.received[k] = 0.0

    @property
    def received_bytes(self) -> float:
        return sum(self.received.values())

    # -- the operations, autograd through them -------------------------
    def all_gather(self, x: torch.Tensor, dim: int, axes,
                   grad_sum=(), kind: str = "all_gather") -> torch.Tensor:
        axes = self.live_axes(axes)
        if not axes:
            return x
        if _recording(x):
            return _Gather.apply(x, self, dim, axes,
                                 tuple(a for a in axes
                                       if a in entry_axes(grad_sum)), kind)
        return self._all_gather(x, dim, axes, kind)

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        if self.shape[axis] == 1:
            return x
        if _recording(x):
            return _Reduce.apply(x, self, axis)
        return self._all_reduce(x, axis)

    def ordered_sum(self, x: torch.Tensor, axes) -> torch.Tensor:
        axes = self.live_axes(axes)
        if not axes:
            return x
        if _recording(x):
            return _OrderedSum.apply(x, self, axes)
        return self._ordered_sum(x, axes)

    def reduce_scatter(self, x: torch.Tensor, dim: int,
                       axes) -> torch.Tensor:
        axes = self.live_axes(axes)
        if not axes:
            return x
        if _recording(x):
            return _ReduceScatter.apply(x, self, dim, axes)
        return self._reduce_scatter(x, dim, axes)

    def split(self, x: torch.Tensor, dim: int, axes) -> torch.Tensor:
        """The rank's own block along ``dim`` of ``x``, which every
        position of ``axes`` holds: no communication; the backward gathers
        the cotangent's blocks, as ``reduce_scatter``'s does."""
        axes = self.live_axes(axes)
        if not axes:
            return x
        if _recording(x):
            return _Split.apply(x, self, dim, axes)
        return self.own(x, dim, axes)

    def own(self, x: torch.Tensor, dim: int, axes) -> torch.Tensor:
        """The rank's block of ``x`` along ``dim`` over ``axes`` (a view:
        no communication, and under autograd the other blocks' gradient
        is 0)."""
        n = x.shape[dim] // self.size(axes)
        return x.narrow(dim, self.index(axes) * n, n)

    def sum_grad(self, x: torch.Tensor, axes,
                 ordered: bool = True) -> torch.Tensor:
        """``x``, its gradient summed over ``axes`` in the backward: in
        coordinate order (``ordered``), else by ``all_reduce`` an axis."""
        axes = self.live_axes(axes)
        if not axes or not _recording(x):
            return x
        return _SumGrad.apply(x, self, axes, ordered)

    # -- the operations themselves (no autograd) -----------------------
    def _all_gather(self, x, dim, axes, kind="all_gather"):
        for axis in reversed(entry_axes(axes)):
            g = self.shape[axis]
            if g == 1:
                continue
            self.received[kind] += (g - 1) * _nbytes(x)
            x = self._gather(x, dim, axis)
        return x

    def _all_reduce(self, x, axis):
        m = self.shape[axis]
        self.received["all_reduce"] += 2.0 * (m - 1) / m * _nbytes(x)
        return self._reduce(x, axis)

    def _ordered_sum(self, x, axes):
        parts = self._all_gather(x[None], 0, axes)
        acc = parts[0].clone()
        for p in parts[1:]:
            acc = acc + p
        return acc

    def _reduce_scatter(self, x, dim, axes):
        """The first axis major: its super-blocks summed first, then the
        next axis's blocks within the rank's super-block."""
        for axis in entry_axes(axes):
            g = self.shape[axis]
            if g == 1:
                continue
            n = x.shape[dim]
            if n % g:
                raise ValueError(f"dim {n} does not divide over {axis} "
                                 f"({g})")
            self.received["reduce_scatter"] += (g - 1) * _nbytes(x) // g
            x = self._scatter(x, dim, axis)
        return x

    def _grad_sum(self, x, axes, ordered):
        if ordered:
            return self._ordered_sum(x, axes)
        for axis in axes:
            x = self._all_reduce(x, axis)
        return x

    def _gather(self, x, dim, axis):
        raise NotImplementedError

    def _reduce(self, x, axis):
        raise NotImplementedError

    def _scatter(self, x, dim, axis):
        raise NotImplementedError


def _recording(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def own_blocks(comm: Collectives, ct: torch.Tensor, dim: int,
               axes: Tuple[str, ...], keep: Tuple[str, ...]) -> torch.Tensor:
    """``ct`` (the blocks of every position of ``axes`` along ``dim``, the
    first axis major) cut to the rank's own blocks over the axes not in
    ``keep``: what remains holds the blocks of ``keep``'s positions."""
    sizes = [comm.shape[a] for a in axes]
    n = ct.shape[dim]
    blk = n // math.prod(sizes)
    v = ct.reshape(ct.shape[:dim] + tuple(sizes) + (blk,)
                   + ct.shape[dim + 1:])
    for i in reversed(range(len(axes))):
        if axes[i] not in keep:
            v = v.narrow(dim + i, comm.coords[axes[i]], 1).squeeze(dim + i)
    return v.reshape(ct.shape[:dim] + (-1,) + ct.shape[dim + 1:])


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, axes, grad_sum, kind):
        ctx.comm, ctx.dim, ctx.axes, ctx.grad_sum = comm, dim, axes, grad_sum
        return comm._all_gather(x, dim, axes, kind)

    @staticmethod
    def backward(ctx, ct):
        comm, dim = ctx.comm, ctx.dim
        g = own_blocks(comm, ct, dim, ctx.axes, ctx.grad_sum)
        if ctx.grad_sum:
            g = comm._reduce_scatter(g, dim, ctx.grad_sum)
        return g.contiguous(), None, None, None, None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis):
        return comm._all_reduce(x, axis)

    @staticmethod
    def backward(ctx, ct):
        return ct, None, None


class _OrderedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes):
        return comm._ordered_sum(x, axes)

    @staticmethod
    def backward(ctx, ct):
        return ct, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, axes):
        ctx.comm, ctx.dim, ctx.axes = comm, dim, axes
        return comm._reduce_scatter(x, dim, axes)

    @staticmethod
    def backward(ctx, ct):
        return (ctx.comm._all_gather(ct.contiguous(), ctx.dim, ctx.axes),
                None, None, None)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, axes):
        ctx.comm, ctx.dim, ctx.axes = comm, dim, axes
        return comm.own(x, dim, axes).clone()

    @staticmethod
    def backward(ctx, ct):
        return (ctx.comm._all_gather(ct.contiguous(), ctx.dim, ctx.axes),
                None, None, None)


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes, ordered):
        ctx.comm, ctx.axes, ctx.ordered = comm, axes, ordered
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return (ctx.comm._grad_sum(ct.contiguous(), ctx.axes, ctx.ordered),
                None, None, None)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class MetaCollectives(Collectives):
    """The dry run's collectives: output shapes on ``meta``, bytes
    counted, no process group. ``coords`` default to position 0."""

    def __init__(self, mesh, coords: Optional[Mapping[str, int]] = None):
        shape = mesh_shape(mesh)
        super().__init__(mesh, {a: 0 for a in shape} if coords is None
                         else {a: int(coords.get(a, 0)) for a in shape})

    def _gather(self, x, dim, axis):
        shp = list(x.shape)
        shp[dim] *= self.shape[axis]
        return x.new_empty(shp)

    def _reduce(self, x, axis):
        return x.new_empty(x.shape)

    def _scatter(self, x, dim, axis):
        shp = list(x.shape)
        shp[dim] //= self.shape[axis]
        return x.new_empty(shp)


class LiveCollectives(Collectives):
    """The collectives on a live ``DeviceMesh``'s process groups (one a
    mesh axis): device tensors on NCCL, host copies on gloo."""

    def __init__(self, mesh):
        names = tuple(mesh.mesh_dim_names or ())
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this process is not a position of the mesh")
        super().__init__(mesh, dict(zip(names, coord)))
        self.groups = {}
        self.slots: Dict[str, Tuple[int, ...]] = {}
        self.backends: Dict[str, str] = {}
        for axis in names:
            if self.shape[axis] == 1:
                continue
            group = mesh.get_group(axis)
            backend = dist.get_backend(group)
            if backend not in ("gloo", "nccl"):
                raise ValueError(f"the sharded LM runs on gloo or NCCL, not "
                                 f"{backend!r}")
            # the gather's slots are group ranks: read them in coordinate
            # order along the axis
            line = _line(mesh, axis, self.coords)
            self.groups[axis] = group
            self.slots[axis] = tuple(dist.get_group_rank(group, r)
                                     for r in line)
            self.backends[axis] = backend

    def _host(self, axis, x):
        return self.backends[axis] == "gloo" and x.device.type != "cpu"

    def _staged(self, x):
        """A pinned host copy of a device tensor (gloo's side)."""
        y = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return y.copy_(x)

    def _gather(self, x, dim, axis):
        g, host = self.shape[axis], self._host(axis, x)
        src = self._staged(x) if host else x.contiguous()
        out = [torch.empty(src.shape, dtype=src.dtype, device=src.device,
                           pin_memory=host) for _ in range(g)]
        dist.all_gather(out, src, group=self.groups[axis])
        parts = [out[s] for s in self.slots[axis]]
        if not host:
            return torch.cat(parts, dim=dim)
        shape = list(src.shape)
        shape[dim] *= g
        y = torch.empty(shape, dtype=src.dtype, pin_memory=True)
        return torch.cat(parts, dim=dim, out=y).to(x.device)

    def _reduce(self, x, axis):
        host = self._host(axis, x)
        y = self._staged(x) if host else x.contiguous().clone()
        dist.all_reduce(y, group=self.groups[axis])
        return y.to(x.device) if host else y

    def _scatter(self, x, dim, axis):
        """Block j of ``x`` along ``dim`` to the rank at coordinate j; the
        blocks received, in coordinate order, added in fp32."""
        g, host = self.shape[axis], self._host(axis, x)
        slots = self.slots[axis]
        blocks = x.unflatten(dim, (g, x.shape[dim] // g)).movedim(dim, 0)
        # all_to_all_single sends chunk i to group rank i
        send = torch.empty(blocks.shape, dtype=x.dtype,
                           device="cpu" if host else x.device,
                           pin_memory=host)
        for c, s in enumerate(slots):
            send[s].copy_(blocks[c])
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.groups[axis])
        acc = recv[slots[0]].float()
        for s in slots[1:]:
            acc = acc + recv[s].float()
        return acc.to(device=x.device, dtype=x.dtype)


def _line(mesh, axis: str, coords: Mapping[str, int]) -> Sequence[int]:
    """The global ranks along ``axis`` through ``coords``, in coordinate
    order."""
    names = tuple(mesh.mesh_dim_names)
    shape = mesh_shape(mesh)
    out = []
    for c in range(shape[axis]):
        at = dict(coords, **{axis: c})
        rank = 0
        for a in names:
            rank = rank * shape[a] + at[a]
        out.append(int(mesh.mesh.flatten()[rank]))
    return out


def make_collectives(mesh, coords: Optional[Mapping[str, int]] = None
                     ) -> Collectives:
    """The live collectives of a ``DeviceMesh`` (this process's position),
    or the meta ones of an ``AbstractMesh`` at ``coords``."""
    from repro_torch.launch.mesh import AbstractMesh
    if isinstance(mesh, AbstractMesh):
        return MetaCollectives(mesh, coords)
    if coords is not None:
        raise ValueError("a live mesh's position is this process's")
    return LiveCollectives(mesh)


__all__ = ["Collectives", "LiveCollectives", "MetaCollectives",
           "make_collectives", "mesh_coords"]
