"""Mesh construction: ``repro``'s ``("data", "model")`` layouts over
``torch.distributed``.

The port's counterpart of ``repro.launch.mesh``. A live mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the process group the
caller has initialised (``torchrun``, or ``spawn_ranks`` on one host): one
process a mesh position. ``make_abstract_mesh`` carries names and sizes
only, for the dry run (`repro_torch.launch.dryrun_lda`), and needs no
process group. Single pod: 256 cards as (data=16, model=16); multi-pod:
2 pods × 256 as (pod=2, data=16, model=16).

Example, one process a rank (``torchrun --nproc-per-node 4 train.py``)::

    torch.distributed.init_process_group("nccl")
    mesh = make_host_mesh(2, 2)           # ("data", "model") = (2, 2)
    LDA(cfg, algo="divi", mesh=mesh).fit(corpus, rounds=10)
"""
from __future__ import annotations

import dataclasses
import math
import os
import queue as _queue
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.types import resolve_device

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no devices and no process group
    (``repro``'s ``jax.sharding.AbstractMesh``): what the dry run lays a
    round out on. ``shape`` maps each axis name to its size."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_abstract_mesh(shape: Sequence[int],
                       axes: Sequence[str]) -> AbstractMesh:
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"{len(shape)} sizes for {len(axes)} axes")
    return AbstractMesh(shape, axes)


def mesh_layout(mesh) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """(axis names, sizes) of a ``DeviceMesh`` or an ``AbstractMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names, mesh.axis_sizes
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh needs named axes (mesh_dim_names), e.g. "
                         "('data', 'model')")
    return tuple(names), tuple(int(s) for s in mesh.mesh.shape)


def check_mesh(mesh) -> None:
    """Raise unless ``mesh`` is a live ``DeviceMesh`` (an ``AbstractMesh``
    has no process group to run on)."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch DeviceMesh over a process "
                        f"group (launch.mesh.make_host_mesh), got "
                        f"{type(mesh).__name__}")


def _device_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device):
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh needs a process group: call torch.distributed."
            "init_process_group first (torchrun, or spawn_ranks on one "
            "host)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs "
                         f"{math.prod(shape)} processes; the process group "
                         f"has {world}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        # one card a rank where there are enough, else ranks share cards
        index = dev.index
        if index is None:
            index = (int(os.environ.get("LOCAL_RANK", dist.get_rank()))
                     % torch.cuda.device_count())
        torch.cuda.set_device(index)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1, *, device=None):
    """A ``("data", "model")`` ``DeviceMesh`` over the initialised process
    group, whose size must be data · model. Its device type is
    ``resolve_device(device)``'s: the card unless the caller names the
    CPU."""
    return _device_mesh((int(data), int(model)), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """``repro``'s production layout: (16, 16) ``("data", "model")``, or
    (2, 16, 16) ``("pod", "data", "model")``, over a process group of 256
    or 512 ranks."""
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    return _device_mesh(shape, axes, device)


# ---------------------------------------------------------------------------
# a process group on one host
# ---------------------------------------------------------------------------

def _rank_main(target, rank, world, backend, init_method, timeout_s, args,
               results):
    try:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=timeout_s))
        try:
            out = (rank, True, target(rank, world, *args))
        finally:
            dist.destroy_process_group()
    except Exception:       # reported to the parent, which raises it
        out = (rank, False, traceback.format_exc())
    results.put(out)


def spawn_ranks(target: Callable[..., Any], world_size: int, *,
                backend: str = "gloo", args: Tuple = (),
                timeout_s: float = 120.0,
                collective_timeout_s: Optional[float] = None,
                store_dir: Optional[str] = None) -> List[Any]:
    """Run ``target(rank, world_size, *args)`` in ``world_size`` spawned
    processes joined in one ``backend`` process group (a ``file://`` store
    in ``store_dir``, a fresh temporary directory by default), and return
    what each returned, in rank order.

    ``target`` must be importable by name (a module-level function). The
    group's collectives time out after ``collective_timeout_s`` (default
    ``timeout_s``). The whole run is held to ``timeout_s``: past it, or
    once any rank fails, every child is killed and this raises with the
    failed ranks' tracebacks.
    """
    ctx = torch.multiprocessing.get_context("spawn")
    store_dir = store_dir or tempfile.mkdtemp(prefix="mesh_store_")
    init_method = "file://" + os.path.join(
        os.path.abspath(store_dir), f"store_{os.getpid()}_{time.time_ns()}")
    results = ctx.Queue()
    coll_s = timeout_s if collective_timeout_s is None \
        else collective_timeout_s
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, world_size, backend, init_method,
                               coll_s, args, results), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    got, failed = {}, []
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) + len(failed) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                if failed:
                    break             # the others hang on the failed rank
                raise TimeoutError(
                    f"spawn_ranks: {world_size - len(got)} of {world_size} "
                    f"ranks unfinished after {timeout_s} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except _queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                if dead and not failed:
                    raise RuntimeError(f"spawn_ranks: ranks {dead} died "
                                       "without a result")
                continue
            if ok:
                got[rank] = value
            else:
                failed.append(f"rank {rank}:\n{value}")
                # the rest may fail on it in turn: a few seconds for theirs
                deadline = min(deadline, time.monotonic() + 5.0)
        if failed:
            raise RuntimeError("spawn_ranks: " + "\n".join(failed))
    finally:
        for p in procs:
            p.join(timeout=10 if len(got) == world_size else 0.1)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
    return [got[r] for r in range(world_size)]
