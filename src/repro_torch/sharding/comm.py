"""The collectives of a sharded model: one object a ``MeshCtx`` holds.

Every collective a rank of the LM template runs goes through it; no model
module calls ``torch.distributed`` itself, so a rank cannot reach a
collective the others skip. Three operations:

* ``all_gather(x, dim, axes)``: the blocks of ``x`` along ``dim`` from
  every position of ``axes`` (the first axis major), concatenated in
  coordinate order: one gather an axis, the minor axis first;
* ``all_reduce(x, axis)``: the sum over one axis (the model-axis sum of
  tensor-parallel partials), in the backend's order;
* ``ordered_sum(x, axes)``: the sum over ``axes`` in coordinate order,
  from an all-gather: exact and the same on every backend (the MoE's
  statistics).

Axes of size 1 cost nothing and leave ``x`` as it is.

``LiveCollectives`` runs them on the process groups of a ``DeviceMesh``:
NCCL on device tensors, gloo on host copies in the tensor's own dtype.
``MetaCollectives`` is the dry run's: no process group, each output a
``meta`` tensor of its shape. Both add up the bytes that each operation
brings into the rank, by kind (``received``), counted in the tensor's own
dtype: an all-gather over G positions brings in (G − 1) blocks; an
all-reduce over M ranks 2·(M − 1)/M of the tensor (a ring's reduce-scatter
and all-gather).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.sharding.rules import entry_axes, mesh_coords, mesh_shape


class Collectives:
    """What both implementations share: the mesh's axes, this rank's
    coordinates and the byte counts."""

    def __init__(self, mesh, coords: Mapping[str, int]):
        self.mesh = mesh
        self.shape: Dict[str, int] = mesh_shape(mesh)
        self.coords: Dict[str, int] = dict(coords)
        self.received: Dict[str, float] = {"all_gather": 0.0,
                                           "all_reduce": 0.0}

    # -- the rank's place ----------------------------------------------
    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in entry_axes(axes))

    def index(self, axes) -> int:
        """This rank's linear coordinate over ``axes`` (the first major)."""
        idx = 0
        for a in entry_axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def reset(self) -> None:
        for k in self.received:
            self.received[k] = 0.0

    @property
    def received_bytes(self) -> float:
        return sum(self.received.values())

    # -- the operations ------------------------------------------------
    def all_gather(self, x: torch.Tensor, dim: int, axes) -> torch.Tensor:
        for axis in reversed(entry_axes(axes)):
            g = self.shape[axis]
            if g == 1:
                continue
            self.received["all_gather"] += (g - 1) * _nbytes(x)
            x = self._gather(x, dim, axis)
        return x

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        m = self.shape[axis]
        if m == 1:
            return x
        self.received["all_reduce"] += 2.0 * (m - 1) / m * _nbytes(x)
        return self._reduce(x, axis)

    def ordered_sum(self, x: torch.Tensor, axes) -> torch.Tensor:
        if self.size(axes) == 1:
            return x
        parts = self.all_gather(x[None], 0, axes)
        acc = parts[0].clone()
        for p in parts[1:]:
            acc = acc + p
        return acc

    def _gather(self, x, dim, axis):
        raise NotImplementedError

    def _reduce(self, x, axis):
        raise NotImplementedError


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
