"""The port stands alone: it imports neither ``jax`` nor ``repro``, its entry
points run on CUDA unless told otherwise, and its kernels are built for
Hopper from the CUDA source in the package."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.core.engines import LDAEngine
from repro_torch.core.types import LDAConfig, resolve_device
from repro_torch.data.bow import corpus_from_docs
from repro_torch.kernels import build

SRC = Path(__file__).resolve().parents[1] / "src"


def test_port_imports_neither_jax_nor_repro():
    script = textwrap.dedent("""
        import importlib, json, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        # the names this slice added, by name
        from repro_torch.core.memo import (ChunkedMemoStore, GammaMemoStore,
                                           memo_footprint_bytes)
        from repro_torch.core.metrics import (effective_topics,
                                              npmi_coherence, top_words)
        from repro_torch.data.bow import (LengthBuckets, bucket_corpus,
                                          bucket_padding_stats, pad_corpus)
        from repro_torch.core.engines import mvi_scan, svi_step, svi_step_csr
        from repro_torch.core.bound import elbo_collapsed_stream
        from repro_torch.obs import NULL_TELEMETRY, Telemetry, as_telemetry
        from repro_torch.obs.roofline import HW
        from repro_torch.lda import LDA, TopicInferencer, load_lda_checkpoint
        from repro_torch.checkpoint import load_manifest, save_manifest
        from repro_torch.convert import lda_from_repro_checkpoint
        from repro_torch.dist import DIVIConfig
        # D-IVI: the engine, the protocol, the sharded streams, the raw memo
        from repro_torch.dist.engine import DIVIEngine
        # D-IVI over a mesh, the mesh helpers and the meta dry run
        from repro_torch.dist import make_divi_round
        from repro_torch.dist.divi import (MeshRound, divi_round_emulated,
                                           ordered_sum)
        from repro_torch.launch.mesh import (AbstractMesh, check_mesh,
                                             make_abstract_mesh,
                                             make_host_mesh,
                                             make_production_mesh,
                                             spawn_ranks)
        from repro_torch.launch.dryrun_lda import (LiveBytes, divi_rank_plan,
                                                   run_ivi, tensor_bytes)
        from repro_torch.launch.serve_lda import run_serve_dryrun
        from repro_torch.dist.protocol import (DIVIState, WorkerIngest,
                                               WorkerShard, divi_round,
                                               master_update,
                                               worker_correction)
        from repro_torch.data.stream import (SHARD_PARTITIONERS,
                                             ShardDocStream,
                                             ShardedDocStream, as_doc_stream)
        from repro_torch.core.types import Memo, init_memo
        from repro_torch.core.engines import ivi_step, sivi_step
        from repro_torch.lda.trainer import DIVITrainer
        # the online serving service, its queue stream and launcher
        from repro_torch.serve import (SLO_SCHEMA, AdmissionController,
                                       ModelSnapshot, OnlineLearner,
                                       Request, Response, ServiceConfig,
                                       ServingService, SnapshotStore,
                                       onoff_arrivals, poisson_arrivals,
                                       replay_arrivals, requests_from_docs,
                                       validate_slo_report)
        from repro_torch.data.stream import QueueDocStream
        from repro_torch.launch.serve_lda import main as serve_main
        # the tuner, UCI ingest, CVB0 and Minka's updates
        from repro_torch.tune import (PolicyKey, PolicyResolver,
                                      PolicyStore, current_device_kind)
        from repro_torch.tune.search import TuneShape, tune_and_store
        from repro_torch.tune.model import bound_ms, modeled_cost_seconds
        from repro_torch.tune.__main__ import main as tune_main
        from repro_torch.data.uci import (UCIDocStream, load_uci,
                                          load_vocab, save_uci)
        from repro_torch.core.cvb0 import CVB0Engine, cvb0_step, init_cvb0
        from repro_torch.core.hyper import update_alpha0, update_beta0
        # the LM template's serving path
        from repro_torch.configs import ARCHS, get_config, get_shape
        from repro_torch.models.transformer import (cast_params,
                                                    decode_step, forward,
                                                    init_caches, init_params)
        from repro_torch.models.attention import (attention_route,
                                                  attention_train)
        from repro_torch.training import (make_prefill_step,
                                          make_serve_step)
        from repro_torch.checkpoint import (restore_checkpoint,
                                            save_checkpoint)
        from repro_torch.convert import (lm_params_from_repro,
                                         lm_params_to_repro)
        from repro_torch.launch.serve import generate, main as lm_serve_main
        # the MoE and recurrent blocks, zamba2's shared block
        from repro_torch.models.moe import (expert_ffn, moe_ffn,
                                            moe_ffn_local, moe_init, route)
        from repro_torch.models.recurrent import (
            MLSTMCache, Mamba2Cache, RecurrentState, SLSTMCache,
            chunked_scan, mamba2_step, mamba2_train, mlstm_step,
            mlstm_train, recurrence_step, slstm_step, slstm_train)
        from repro_torch.models.transformer import shared_attn_init
        from repro_torch.convert import (lm_caches_from_repro,
                                         lm_caches_to_repro)
        # LM training: the optimizers, the loss, the train step, the
        # state across, the launcher's lm mode
        from repro_torch.optim import (Optimizer, adamw, apply_updates,
                                       clip_by_global_norm, cosine_schedule,
                                       iag, sgd)
        from repro_torch.models.transformer import loss_fn
        from repro_torch.training import (TrainState, loss_and_grads,
                                          make_train_step)
        from repro_torch.convert import (lm_train_state_from_repro,
                                         lm_train_state_to_repro)
        from repro_torch.launch.train import lm_batch, main_lm, make_iag_step
        # the LM over a mesh: the rules, the context and its collectives,
        # the sharded entry points, the dry run and its cost counter
        from repro_torch.sharding import (MeshCtx, RankPlan, ShardedCaches,
                                          Spec, batch_specs, cache_specs,
                                          make_ctx, param_specs, shard_tree,
                                          unshard_tree)
        from repro_torch.sharding.comm import (LiveCollectives,
                                               MetaCollectives)
        from repro_torch.models.moe import moe_block_emulated
        from repro_torch.models.transformer import (param_shapes,
                                                    shard_caches)
        from repro_torch.launch.dryrun import input_specs, rank_step, run_pair
        from repro_torch.launch.cost import count_step, tree_bytes
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "repro" or m.startswith("repro."))
        print(json.dumps({"modules": names, "bad": bad}))
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    import json
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    for name in ("repro_torch.core.engines", "repro_torch.kernels.ops",
                 "repro_torch.kernels.lda_estep", "repro_torch.convert",
                 "repro_torch.launch.train", "repro_torch.data.stream",
                 "repro_torch.kernels.ref",
                 "repro_torch.kernels.flash_attention",
                 "repro_torch.core.memo", "repro_torch.core.metrics",
                 "repro_torch.data.bow", "repro_torch.obs",
                 "repro_torch.obs.trace", "repro_torch.obs.metrics",
                 "repro_torch.obs.watchdog", "repro_torch.obs.roofline",
                 "repro_torch.lda", "repro_torch.lda.api",
                 "repro_torch.lda.trainer", "repro_torch.lda.ckpt",
                 "repro_torch.lda.infer", "repro_torch.checkpoint",
                 "repro_torch.checkpoint.manifest", "repro_torch.dist",
                 "repro_torch.tune", "repro_torch.tune.store",
                 "repro_torch.tune.resolve", "repro_torch.tune.model",
                 "repro_torch.tune.search", "repro_torch.tune.__main__",
                 "repro_torch.data.uci", "repro_torch.core.cvb0",
                 "repro_torch.core.hyper",
                 "repro_torch.dist.protocol", "repro_torch.dist.engine",
                 "repro_torch.serve", "repro_torch.serve.admission",
                 "repro_torch.serve.online", "repro_torch.serve.service",
                 "repro_torch.serve.snapshot", "repro_torch.serve.traffic",
                 "repro_torch.launch.serve_lda",
                 "repro_torch.configs", "repro_torch.configs.base",
                 "repro_torch.configs.qwen2_5_3b", "repro_torch.models",
                 "repro_torch.models.layers", "repro_torch.models.attention",
                 "repro_torch.models.transformer",
                 "repro_torch.models.moe", "repro_torch.models.recurrent",
                 "repro_torch.configs.deepseek_moe_16b",
                 "repro_torch.configs.zamba2_1_2b", "repro_torch.training",
                 "repro_torch.training.steps", "repro_torch.checkpoint.io",
                 "repro_torch.launch.serve", "repro_torch.optim",
                 "repro_torch.optim.optimizers", "repro_torch.tree",
                 "repro_torch.sharding", "repro_torch.sharding.rules",
                 "repro_torch.sharding.comm", "repro_torch.sharding.ctx",
                 "repro_torch.launch.dryrun", "repro_torch.launch.cost"):
        assert name in got["modules"]


def test_entry_points_run_on_cuda_unless_told():
    corpus = corpus_from_docs([[1, 2, 2], [3, 4]], 8, device="cpu")
    cfg = LDAConfig(num_topics=2, vocab_size=8)
    if torch.cuda.is_available():
        assert resolve_device() == torch.device("cuda")
        assert LDAEngine(cfg, corpus, algo="ivi").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LDAEngine(cfg, corpus, algo="ivi")
    assert LDAEngine(cfg, corpus, algo="ivi", device="cpu").device.type == \
        "cpu"
    from repro_torch.lda import LDA, TopicInferencer
    lam = torch.ones((8, 2))
    if torch.cuda.is_available():
        assert LDA(cfg).device.type == "cuda"
        assert TopicInferencer(cfg, lam).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LDA(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TopicInferencer(cfg, lam)
    assert LDA(cfg, device="cpu").device.type == "cpu"
    assert TopicInferencer(cfg, lam, device="cpu").device.type == "cpu"


def test_build_targets_hopper_from_package_source():
    cmd = build.nvcc_command("nvcc", Path("lib.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1] == str(build.SOURCE)
    assert build.SOURCE.name == "lda_estep.cu"
    assert build.SOURCE.parent.name == "csrc"
    source = build.SOURCE.read_text()
    for entry in build._SIGNATURES:
        assert f" {entry}(" in source, entry
    for kernel in ("fixed_point_kernel", "token_pi_kernel",
                   "segment_scatter_kernel", "csr_token_pi_kernel"):
        assert f" {kernel}(" in source, kernel
    # K1 and K4 stop across their grid: one cooperative launch of one
    # kernel, K4 over each document's range of the flat stream
    assert "cudaLaunchCooperativeKernel" in source
    assert " csr_fixed_point_kernel(" not in source
    assert " row_sweep(" not in source


def test_attention_builds_its_own_library_from_package_source():
    """Flash attention is a second library with its own source digest, so
    the E-step library's build and name stay as they were."""
    src = build.ATTENTION_SOURCE
    assert src.name == "flash_attention.cu"
    assert src.parent == build.SOURCE.parent
    cmd = build.nvcc_command("nvcc", Path("lib.so"), src)
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1] == str(src)
    assert build.library_path(src).name.startswith("libflash_attention_")
    assert build.library_path().name.startswith("liblda_estep_")
    source, signatures, _ = build.LIBRARIES["flash_attention"]
    assert source == src
    text = src.read_text()
    for entry in signatures:
        assert f" {entry}(" in text, entry
    assert " flash_kernel(" in text
    assert "cudaFuncSetAttribute" in text   # its tiles need > 48 KB
    # the E-step library carries the baseline kernels K6–K8 (K6 and K7 on
    # the tensor cores only: the SIMT bodies are gone), and both libraries
    # the tensor-core helpers of the header beside them
    estep = build.SOURCE.read_text()
    for kernel in ("dense_tc_kernel", "r_pass_kernel", "et_image_kernel",
                   "onehot_kernel"):
        assert f" {kernel}(" in estep, kernel
    for kernel in ("sweep_kernel", "sstats_kernel"):
        assert f" {kernel}(" not in estep, kernel
    for text in (estep, src.read_text()):
        assert '#include "hopper_wgmma.cuh"' in text
