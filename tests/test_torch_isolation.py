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
                 "repro_torch.dist.protocol"):
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
    # the E-step library carries the baseline kernels K6–K8
    estep = build.SOURCE.read_text()
    for kernel in ("sweep_kernel", "sstats_kernel", "onehot_partials_kernel",
                   "onehot_reduce_kernel"):
        assert f" {kernel}(" in estep, kernel
