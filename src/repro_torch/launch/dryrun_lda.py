"""Dry run of the paper's workload at the Arxiv scale of Table 1 (V =
141,927 padded to 141,952; K = 100 padded to 128; 782,384 documents), on
``meta`` tensors: no card, no process group, no data.

The port's counterpart of ``repro.launch.dryrun_lda``, which lowers each
program to HLO on a 512-device JAX mesh. Here each program runs once on
``meta`` tensors, which carry shapes and types and no storage: the kernel
wrappers K1 and K3 take a shape-only path there that allocates what their
launch would and counts the launch (`repro_torch.kernels.lda_estep`), and
``LiveBytes``, a ``TorchDispatchMode``, adds each new tensor's bytes and
subtracts them when it is freed. Three modes:

* ``divi``: one rank of one D-IVI global round on ``repro``'s production
  layout (`launch.mesh.make_abstract_mesh`; (16, 16) ``("data",
  "model")``, or (2, 16, 16) with ``--mesh multi``). The rank's λ rows,
  its workers' memos and its round inputs are built by the constructors
  the live engine uses; the round body is the live one
  (`dist.divi.MeshRound`) with the collectives replaced by their outputs'
  shapes. Per rank: argument bytes, peak live bytes, the bytes each
  collective brings in a sub-round, launches a sub-round, and roofline
  terms: the kernels' bounds (`repro_torch.tune.model`, every slot live,
  every tile at ``estep_max_iters`` sweeps) and the collectives' bytes
  over NVLink's data-sheet rate (`obs.roofline.HW`).
* ``ivi``: the single-host IVI update (`core.engines.incremental_update`,
  the ``cuda`` backend, bf16 stream, the chunked store's bf16 wire) at
  B = ``--batch``: its launches and bytes, and the memo stores'
  footprints (`core.memo.memo_footprint_bytes`) against 40 GB.
* ``serve``: the serving batch (the γ-only solve) at B = 256 for each
  bucket width of ``serve_lda.ARXIV_WIDTHS``: argument and peak bytes,
  one launch a batch (`launch.serve_lda.run_serve_dryrun`).

Usage: python -m repro_torch.launch.dryrun_lda [--mode divi|ivi|serve|all]
       [--mesh single|multi|both] [--batch 1024] [--staleness 1]
       [--out results/lda.jsonl]
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
import weakref
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.core.types import LDAConfig, init_global_state
from repro_torch.dist.divi import make_divi_round
from repro_torch.dist.protocol import DIVIConfig, WorkerShard
from repro_torch.kernels import lda_estep
from repro_torch.launch.mesh import PRODUCTION_SHAPES, make_abstract_mesh
from repro_torch.obs.roofline import HW
from repro_torch.tune.model import bound_ms, modeled_update_work

# Arxiv (Table 1): 782,384 training documents, V = 141,927 padded so 16
# model shards divide it, K = 100 padded to 128, L = 128 unique words
ARXIV = dict(num_docs=782_384, vocab=141_952, max_unique=128, topics=128)
META = torch.device("meta")


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class LiveBytes(TorchDispatchMode):
    """Bytes of the tensors made while the mode is on: ``live`` now,
    ``peak`` at most. Each new storage adds its ``nbytes`` and is
    subtracted when the tensor that brought it is freed and nothing else
    holds the storage (a view keeps its base alive, and so does a tensor
    that aliases it, as autograd's accumulated ``.grad`` may: such a
    storage is looked at again every ``SWEEP`` operations); views and
    in-place results share an input's storage and add nothing.
    ``last_op`` is the last operation dispatched."""

    SWEEP = 64

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self.last_op = None
        self._held: Dict[int, int] = {}
        self._storage: Dict[int, torch.UntypedStorage] = {}
        self._young: set = set()        # looked at again at the next op
        self._lingering: set = set()    # and then every SWEEP ops
        self._ops = 0

    def _uses(self, key: int) -> int:
        return torch._C._storage_Use_Count(self._storage[key]._cdata)

    def _release(self, key: int) -> None:
        del self._storage[key]
        self.live -= self._held.pop(key)

    def _free(self, key: int) -> None:
        # this mode's reference and the dying tensor's are two: any other
        # holds the bytes (a view or an alias dying with it, or living on)
        if self._uses(key) > 2:
            self._young.add(key)
        else:
            self._release(key)

    def _sweep(self, keys: set) -> set:
        left = set()
        for key in keys:
            if self._uses(key) > 1:
                left.add(key)
            else:
                self._release(key)
        return left

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.last_op = func
        self._ops += 1
        if self._young:
            self._lingering |= self._sweep(self._young)
            self._young = set()
        if self._lingering and self._ops % self.SWEEP == 0:
            self._lingering = self._sweep(self._lingering)
        out = func(*args, **(kwargs or {}))
        inputs = {_storage_key(t) for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            key = _storage_key(t)
            if key in inputs or key in self._held:
                continue
            n = t.untyped_storage().nbytes()
            self._held[key] = n
            self._storage[key] = t.untyped_storage()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, key)
        return out


def tensor_bytes(tree) -> int:
    """Σ nbytes of the tensors in a nested argument tuple (the round's
    arguments; dataclass states and memos by their fields)."""
    total = 0
    for x in tree:
        if isinstance(x, torch.Tensor):
            total += x.untyped_storage().nbytes()
        elif hasattr(x, "__dataclass_fields__"):
            total += tensor_bytes(getattr(x, f)
                                  for f in x.__dataclass_fields__)
    return total


def _launches() -> Dict[str, int]:
    return {k: v for k, v in lda_estep.LAUNCHES.items() if v}


def divi_rank_plan(cfg: LDAConfig, dcfg: DIVIConfig, mesh, *,
                   num_docs: int, max_unique: int,
                   data_axes=None) -> dict:
    """One rank of one D-IVI round of ``cfg``/``dcfg`` on ``mesh`` (an
    ``AbstractMesh``), on ``meta``: rank (0, …, 0)'s arguments, built as
    ``DIVIEngine`` builds them (memo rows = the largest shard's, every
    sub-round live), then the round under ``LiveBytes``. Returns bytes,
    launches and the collectives' traffic, per rank."""
    rnd = make_divi_round(cfg, dcfg, mesh, data_axes)
    w_local = len(rnd.workers)
    docs_per_worker = -(-num_docs // dcfg.num_workers)
    v, k = cfg.vocab_size, cfg.num_topics
    full = init_global_state(cfg, device=META,
                             lam0=torch.empty((v, k), device=META))
    state = rnd.local_state(full)
    del full
    shard = WorkerShard.zeros(w_local, docs_per_worker, max_unique, k, META)
    n, b, l = w_local * dcfg.staleness, dcfg.batch_size, max_unique
    ids = torch.empty((n, b, l), dtype=torch.int32, device=META)
    cnts = torch.empty((n, b, l), dtype=torch.float32, device=META)
    rows = torch.empty((n, b), dtype=torch.int64, device=META)
    delay = np.zeros((dcfg.num_workers, dcfg.staleness), bool)
    nwt = torch.empty((), dtype=torch.float32, device=META)
    args = (state, shard, ids, cnts, rows, delay, nwt)
    arg_bytes = tensor_bytes(args)
    lda_estep.reset_launches()
    mode = LiveBytes()
    with mode:
        rnd(*args)
    launches = _launches()
    s = dcfg.staleness
    (fp, sc) = modeled_update_work("padded", policy=cfg.kernel_policy,
                                   b_or_t=w_local * b, v=v, k=k, w=l,
                                   iters=cfg.estep_max_iters)
    kernels_ms = s * (bound_ms(*fp)[0] + bound_ms(*sc)[0])
    lam_bytes = rnd.model.received_bytes
    corr_bytes = rnd.data.received_bytes // s
    return {
        "workers": dcfg.num_workers, "workers_per_rank": w_local,
        "docs_per_worker": docs_per_worker,
        "rows_per_rank": rnd.rows.stop - rnd.rows.start,
        "argument_bytes": arg_bytes,
        "peak_bytes": arg_bytes + mode.peak,
        "temp_bytes": mode.peak,
        "launches": launches,
        "launches_per_subround": sum(launches.values()) / s,
        "collective_bytes": {"lam_gather_per_round": lam_bytes,
                             "correction_gather_per_subround": corr_bytes},
        "roofline": {
            "kernels_s": kernels_ms / 1e3,
            "collective_s": (lam_bytes + s * corr_bytes) / HW["nvlink_bw"]},
    }


def run(mesh_kind: str, batch: int, staleness: int) -> dict:
    """``divi`` on ``repro``'s production layout ``mesh_kind``."""
    shape, axes = PRODUCTION_SHAPES[mesh_kind == "multi"]
    mesh = make_abstract_mesh(shape, axes)
    out = {"arch": "lda-divi-arxiv", "shape": f"b{batch}_s{staleness}",
           "mesh": mesh_kind, "chips": mesh.size, "device": "meta"}
    t0 = time.time()
    try:
        n_data = math.prod(s for a, s in zip(axes, shape) if a != "model")
        cfg = LDAConfig(num_topics=ARXIV["topics"], vocab_size=ARXIV["vocab"],
                        estep_max_iters=100, estep_backend="cuda")
        dcfg = DIVIConfig(num_workers=n_data, batch_size=batch,
                          staleness=staleness)
        plan = divi_rank_plan(cfg, dcfg, mesh, num_docs=ARXIV["num_docs"],
                              max_unique=ARXIV["max_unique"])
        out["compile_s"] = round(time.time() - t0, 1)
        out.update(plan)
        out["memory"] = {"temp_gb": plan["temp_bytes"] / 1e9,
                         "argument_gb": plan["argument_bytes"] / 1e9}
        out["ok"] = True
    except Exception as e:  # noqa: BLE001  (the mode's result records it)
        out["ok"] = False
        out["error"] = f"{type(e).__name__}: {e}"
        out["traceback"] = traceback.format_exc()[-1500:]
    return out


def run_ivi(batch: int, estep_iters: int = 50) -> dict:
    """The single-host IVI update at the Arxiv shape, ``cuda`` backend with
    the bf16 stream and the chunked store's bf16 wire, on ``meta``; the
    memo stores' footprints."""
    from repro_torch.core.engines import incremental_update
    from repro_torch.core.memo import memo_footprint_bytes

    v, k, l, d = (ARXIV["vocab"], ARXIV["topics"], ARXIV["max_unique"],
                  ARXIV["num_docs"])
    cfg = LDAConfig(num_topics=k, vocab_size=v, estep_max_iters=estep_iters,
                    estep_backend="cuda", estep_stream_dtype="bfloat16")
    out = {"arch": "lda-ivi-arxiv", "shape": f"b{batch}", "mode": "ivi",
           "memo_store": "chunked-bf16", "device": "meta"}
    t0 = time.time()
    mode = LiveBytes()
    try:
        state = init_global_state(cfg, device=META,
                                  lam0=torch.empty((v, k), device=META))
        args = (state, torch.empty((batch, l), dtype=torch.int32, device=META),
                torch.empty((batch, l), device=META),
                torch.empty((batch, l, k), device=META),   # π_old, the store's
                torch.empty((batch,), dtype=torch.bool, device=META),
                torch.empty((), device=META))
        lda_estep.reset_launches()
        with mode:
            incremental_update(cfg, False, *args, "bfloat16")
        out["launches"] = _launches()
        out["kernels"] = sum(out["launches"].values())
        out["compile_s"] = round(time.time() - t0, 1)
        arg_bytes = tensor_bytes(args)
        out["memory"] = {"temp_gb": mode.peak / 1e9,
                         "argument_gb": arg_bytes / 1e9}
        # the memo never enters the update: the stores' footprints
        out["memo_gb"] = {
            kind: memo_footprint_bytes(kind, d, l, k, vocab_size=v) / 1e9
            for kind in ("dense", "chunked", "gamma")}
        out["memo_under_40gb"] = out["memo_gb"]["chunked"] < 40.0
        out["ok"] = True
    except Exception as e:  # noqa: BLE001  (the op that cannot run on meta)
        out["ok"] = False
        out["error"] = f"{type(e).__name__}: {e}"
        out["failed_op"] = str(mode.last_op)
        out["launches_before_failure"] = _launches()
        out["traceback"] = traceback.format_exc()[-1500:]
    return out


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="all",
                    choices=["divi", "ivi", "serve", "all"])
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--staleness", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    results = []
    if args.mode in ("divi", "all"):
        meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
        for mk in meshes:
            res = run(mk, args.batch, args.staleness)
            if res["ok"]:
                rf = res["roofline"]
                print(f"[OK ] lda-divi × {mk}  compile={res['compile_s']}s "
                      f"temp={res['memory']['temp_gb']:.2f}GB "
                      f"compute={rf['kernels_s']:.2e}s "
                      f"coll={rf['collective_s']:.2e}s "
                      f"args={res['memory']['argument_gb']:.2f}GB "
                      f"launches/subround={res['launches_per_subround']:g}")
            else:
                print(f"[FAIL] lda-divi × {mk}: {res['error'][:200]}")
            results.append(res)
    if args.mode in ("ivi", "all"):
        res = run_ivi(args.batch)
        if res["ok"]:
            mg = res["memo_gb"]
            print(f"[OK ] lda-ivi single-host  compile={res['compile_s']}s "
                  f"kernels={res['kernels']} "
                  f"memo dense={mg['dense']:.1f}GB "
                  f"chunked={mg['chunked']:.1f}GB "
                  f"gamma={mg['gamma']:.2f}GB "
                  f"(<40GB: {res['memo_under_40gb']})")
        else:
            print(f"[FAIL] lda-ivi: {res['error'][:200]} "
                  f"(op {res['failed_op']})")
        results.append(res)
    if args.mode in ("serve", "all"):
        from repro_torch.launch.serve_lda import (print_serve_dryrun,
                                                  run_serve_dryrun)
        res = run_serve_dryrun(batch=min(args.batch, 256))
        print_serve_dryrun(res, "single-host")
        results.append(res)
    if args.out:
        with open(args.out, "a") as f:
            for res in results:
                f.write(json.dumps(res) + "\n")


if __name__ == "__main__":
    main()
