"""Dry run of the LM template over ``repro``'s production meshes, on
``meta`` tensors: no card, no process group, no data.

The port's counterpart of ``repro.launch.dryrun``, which lowers each
(architecture × input shape) step with production shardings on a
512-device JAX mesh and reads the compiled HLO. Here one rank (position 0)
of the (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) with ``--mesh
multi``, runs the step once on ``meta`` tensors (`launch.mesh.
make_abstract_mesh`, the meta collectives of `repro_torch.sharding.comm`):
its blocks of the bf16 serving copy (``init_params(..., cast=True,
ctx=)``), its caches (``init_caches(..., ctx=)``) and the global inputs, of
which it takes its rows, through the entry points a server calls
(``make_prefill_step``, ``make_serve_step``); a ``train_4k`` pair runs one
``make_train_step`` (AdamW at 3e-4, clip 1.0, ``--microbatches``) under
autograd on the rank's fp32 master blocks and AdamW moments, as
``repro``'s dry run places the optimizer state: its forward, each
checkpointed layer's recompute, the backward (its reduce-scatters) and
the update. K9's wrapper takes its
shape-only path on ``meta`` (the card's route, with gemma2's softcap and
the windows of its local layers and of the ``long_500k`` variant; its
operations count only the pairs the masks keep), and the MoE's segments
fill the rank's capacity. Per pair:

* ``memory``: argument bytes (the rank's parameters, optimizer state,
  caches and rows of the inputs), the step's temporaries at their peak (`launch.dryrun_lda.
  LiveBytes`) and their sum, against the card's 80 GB;
* ``hlo``'s counterpart (`launch.cost.count_step`): the products' FLOPs
  (K9's added by its wrapper), their output bytes, the parameter bytes,
  the collectives' bytes by kind (a decode step's restore of the
  replicated recurrent states apart, ``coll_state_restore``; it is in
  ``collective_bytes``);
* ``roofline``: those over an H100's data-sheet rates (`obs.roofline.HW`:
  bf16 tensor-core peak, HBM bytes/s, and NVLink's 900 GB/s, the
  intra-node rate, for the collectives).

``--seq-shard`` runs the sequence-parallel residual stream (prefill and
train pairs).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape decode_32k
  python -m repro_torch.launch.dryrun --all --mesh both
  python -m repro_torch.launch.dryrun --all --mesh single --out d.jsonl
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ARCHS, get_config, get_shape
from repro_torch.configs.base import (INPUT_SHAPES, InputShape, ModelConfig,
                                      shape_variant)
from repro_torch.launch.cost import count_step, tree_bytes
from repro_torch.launch.mesh import PRODUCTION_SHAPES, make_abstract_mesh
from repro_torch.models import transformer as T
from repro_torch.obs.roofline import HW
from repro_torch.optim import adamw
from repro_torch.sharding import RankPlan, make_ctx
from repro_torch.sharding.ctx import MeshCtx
from repro_torch.training import (TrainState, make_prefill_step,
                                  make_serve_step, make_train_step)

META = torch.device("meta")
GB = 1e9

__all__ = ["HW", "input_specs", "make_ctx", "rank_step", "run_pair"]


def input_specs(cfg: ModelConfig, shape: InputShape
                ) -> Dict[str, torch.Tensor]:
    """The global inputs of a step as ``meta`` tensors:
    tokens and labels (B, S) (MusicGen's with a codebook axis, a VLM's
    tokens S − patches long beside its (B, P, D) bf16 patch embeddings);
    a decode step's tokens and positions (B,). ``repro``'s shapes and
    dtypes."""
    b, s = shape.global_batch, shape.seq_len
    i32 = dict(dtype=torch.int32, device=META)
    if shape.kind in ("train", "prefill"):
        if cfg.modality == "audio":
            toks = torch.zeros((b, s, cfg.num_codebooks), **i32)
        elif cfg.modality == "vision":
            toks = torch.zeros((b, s - cfg.num_patches), **i32)
        else:
            toks = torch.zeros((b, s), **i32)
        batch = {"tokens": toks}
        if cfg.modality == "vision":
            batch["vision_embeds"] = torch.zeros(
                (b, cfg.num_patches, cfg.d_model), dtype=torch.bfloat16,
                device=META)
        if shape.kind == "train":
            batch["labels"] = torch.zeros(
                (b, s) + ((cfg.num_codebooks,) if cfg.modality == "audio"
                          else ()), **i32)
        return batch
    tok_shape = (b, cfg.num_codebooks) if cfg.modality == "audio" else (b,)
    return {"tokens": torch.zeros(tok_shape, **i32),
            "pos": torch.zeros((b,), **i32)}


def rank_step(cfg: ModelConfig, shape: InputShape, ctx: MeshCtx,
              params=None, cache_dtype=torch.bfloat16,
              microbatches: int = 1) -> Dict[str, Any]:
    """One rank's step of ``shape`` on ``ctx`` (a train step, a prefill,
    or a decode step against caches of ``shape.seq_len`` slots in
    ``cache_dtype``; tensors on ``meta`` for an abstract mesh): argument
    bytes, the counts of ``count_step``.
    ``params``: the rank's blocks; unless given, the fp32 masters for a
    train step, the bf16 serving copy otherwise, built on ``meta``."""
    train = shape.kind == "train"
    if params is None:
        params = T.init_params(cfg, device=META, cast=not train, ctx=ctx)
    inputs = input_specs(cfg, shape)
    plan = RankPlan(cfg, ctx, shape.global_batch)
    local_inputs = tree_bytes(plan.local_batch(inputs))
    param_bytes = tree_bytes(params)
    opt_bytes = cache_bytes = 0
    if train:
        opt = adamw(3e-4)
        state = TrainState(params, opt.init(params),
                           torch.zeros((), dtype=torch.int32,
                                       device=next(iter(
                                           params.values())).device))
        opt_bytes = tree_bytes(state.opt_state)
        step = make_train_step(cfg, opt, ctx, microbatches=microbatches)
        out, counts = count_step(lambda: step(state, inputs), ctx.comm)
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg, ctx)
        out, counts = count_step(lambda: step(params, inputs), ctx.comm)
    else:
        caches = T.init_caches(cfg, shape.global_batch, shape.seq_len,
                               cache_dtype, META, ctx=ctx)
        cache_bytes = tree_bytes(list(caches))
        step = make_serve_step(cfg, ctx)
        out, counts = count_step(
            lambda: step(params, caches, inputs["tokens"], inputs["pos"]),
            ctx.comm)
    return {"argument_bytes": param_bytes + opt_bytes + cache_bytes
            + local_inputs,
            "param_bytes": param_bytes, "opt_bytes": opt_bytes,
            "cache_bytes": cache_bytes, "input_bytes": local_inputs,
            "batch_rows": [plan.rows.start, plan.rows.stop], **counts}


def run_pair(arch: str, shape_name: str, mesh_kind: str,
             seq_shard: bool = False, profile: str = "tp_fsdp",
             microbatches: int = 1) -> Dict[str, Any]:
    """One (arch, shape, mesh) record, ``repro``'s keys where the meaning
    is the same."""
    sizes, axes = PRODUCTION_SHAPES[mesh_kind == "multi"]
    mesh = make_abstract_mesh(sizes, axes)
    t0 = time.time()
    out: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_kind, "chips": math.prod(sizes),
                           "seq_shard": seq_shard, "profile": profile,
                           "microbatches": microbatches}
    try:
        cfg = get_config(arch)
        shape = get_shape(shape_name)
        cfg, note = shape_variant(cfg, shape)
        out.update(variant_note=note, mesh_shape=dict(zip(axes, sizes)))
        if profile == "fsdp_only" and cfg.num_experts:
            raise ValueError("fsdp_only profile is incompatible with MoE "
                             "archs")
        ctx = make_ctx(mesh, seq_shard=seq_shard, profile=profile)
        r = rank_step(cfg, shape, ctx, microbatches=microbatches)
        peak = r["argument_bytes"] + r["temp_bytes"]
        out["memory"] = {"argument_gb": r["argument_bytes"] / GB,
                         "param_gb": r["param_bytes"] / GB,
                         "opt_gb": r["opt_bytes"] / GB,
                         "cache_gb": r["cache_bytes"] / GB,
                         "temp_gb": r["temp_bytes"] / GB,
                         "peak_gb": peak / GB,
                         "card_gb": HW["hbm_bytes"] / GB,
                         "fits_card": peak <= HW["hbm_bytes"]}
        out["hlo"] = {k: r[k] for k in (
            "dot_flops", "k9_flops", "dot_bytes", "param_bytes",
            "collective_bytes", "coll_all_gather", "coll_all_reduce",
            "coll_reduce_scatter", "coll_state_restore")}
        out["k9_launches"] = r["k9_launches"]
        out["roofline"] = {
            "compute_s": r["dot_flops"] / HW["peak_flops_bf16"],
            "memory_s": max(r["dot_bytes"], r["param_bytes"])
            / HW["hbm_bw"],
            "collective_s": r["collective_bytes"] / HW["nvlink_bw"],
            "hw": HW["name"],
            "collective_rate": "NVLink 900 GB/s, the intra-node rate"}
        out["ok"] = True
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        out["ok"] = False
        out["error"] = f"{type(e).__name__}: {e}"
        out["traceback"] = traceback.format_exc()[-2000:]
    out["total_s"] = round(time.time() - t0, 1)
    return out


def _line(res: Dict[str, Any]) -> str:
    pair = f"{res['arch']} × {res['shape']} × {res['mesh']}"
    if not res["ok"]:
        return f"[FAIL] {pair}: {res.get('error', '')[:300]}"
    m, rf = res["memory"], res["roofline"]
    return (f"[OK ] {pair}  arg={m['argument_gb']:.3f}GB "
            f"temp={m['temp_gb']:.3f}GB peak={m['peak_gb']:.3f}GB "
            f"compute={rf['compute_s']:.3g}s memory={rf['memory_s']:.3g}s "
            f"collective={rf['collective_s']:.3g}s")


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--seq-shard", action="store_true",
                    help="sequence-parallel residual stream (prefill and "
                         "train shapes)")
    ap.add_argument("--profile", default="tp_fsdp",
                    choices=["tp_fsdp", "fsdp_only"],
                    help="parallelism profile")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient-accumulation microbatches (train shapes)")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        pairs = [(a, s) for a in sorted(ARCHS) for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all) required")
        pairs = [(args.arch, args.shape)]
    for arch, shape in pairs:
        for mk in meshes:
            res = run_pair(arch, shape, mk, seq_shard=args.seq_shard,
                           profile=args.profile,
                           microbatches=args.microbatches)
            print(_line(res), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(res) + "\n")


if __name__ == "__main__":
    main()
