#!/usr/bin/env python3
"""Drive the PyTorch port's paths (IVI, Algorithm 1) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:  python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero. The padded
path first:
  1. device  — nvidia-smi's name and power limit, torch's device name/count
  2. build   — nvcc builds the kernels from src/repro_torch/kernels/csrc;
               K1/K4's instance at K = 100 must not spill registers
  3. kernels — each kernel against its plain twin at the path's shapes
               (Arxiv: V = 141,927, K = 100, B = 1024), then timed; K1
               and K3 also give the same bits on two launches; K1 with its
               π finish (the path's launch) gives K1's bits without it and
               K2's π bit for bit, its grid holds every document at once,
               and one bf16-streamed launch agrees with its twin more
               closely than the fp32 stream does; K2 then
               K3 driven as memo_delta; K3 again with one id in every
               document, its segment lengths, its preparation's time and
               the host syncs of one call
  4. serve   — γ for 1,024 held-out documents through the CUDA backend,
               against the gather backend
  5. train   — LDAEngine IVI on an Arxiv-shaped corpus (16,430 documents),
               two epochs; kernel launch counts (2 an update: K1 with its
               π finish, K3), LPP, the memoized ELBO after every update of
               epoch 2, the memo invariant
  6. warm    — the fixed point against its twin again, from the trained λ
               and memo warm starts, where tiles stop at different sweeps,
               and the same bits on two launches; the π finish's bits
  7. profile — torch.profiler over a few more updates: device time by
               operation, the device's idle share, and host time by
               operation
then the flat CSR token-stream path, on the same corpus:
  8. kernels_csr — the CSR kernels against their twins on the first flat
               batch (B = 1024 documents in a 131,072-slot stream), timed;
               K4 also gives the same bits on two launches, and its warps
               per document, grid and µs per sweep; K4 with its π finish
               gives K4's bits and K5's π bit for bit; one bf16-streamed
               launch against its twin, as in phase 3; K4 on a shuffled
               copy of the batch
               against its twin with no host sync, and the sort's time;
               K5 then K3 driven as memo_delta_csr
  9. serve_csr — γ for 1,024 held-out documents packed as one flat batch,
               through the CUDA backend against the plain flat reference
 10. train_csr — LDAEngine IVI over a CorpusDocStream in the CSR layout,
               two epochs, with the same checks as phase 5
 11. warm_csr  — the CSR fixed point against its twin from the trained
               memo's warm starts
 12. profile_csr — torch.profiler over a few more CSR updates
then the paper's baselines, the host memo stores, length buckets and
telemetry, each on the same corpus at the same widths:
 13. train_mvi — MVI, two epochs of 17 batches (K1 and K3 once a batch, the
               tail padded with sentinel-row documents): λ − β₀ carries the
               corpus's word mass, LPP above its start, the collapsed bound
               finite; then full-batch IVI = MVI on 4,099 documents
               (batch = D, three epochs), LPP within 5e-3: λ entry by
               entry within rtol 1e-3 under the gather E-step's batch-wide
               stop, as a whole (relative L1 1e-3) under K1's per-tile
               stop
 14. train_svi — SVI, two padded epochs (K1 then K3): the first update's λ
               against the same update through the plain path, tile by tile
 15. train_svi_csr — SVI on the CSR stream (K4 then K3), the first update
               against the plain flat reference
 16. train_chunked — IVI with the bf16 host-chunked store, two epochs from
               phase 5's λ₀: no memo bytes on the device, the memo
               invariant, the memoized ELBO over epoch 2, LPP within 0.01 of
               phase 5's, gather bit for bit what update wrote, footprints
 17. train_gamma — S-IVI with the γ-only store, two epochs; its footprint;
               the reconstructed π against the dense store's after a write
 18. train_bucketed — IVI in length buckets, one epoch: every document
               once, each batch at its bucket's width
 19. telemetry — a live bundle on each layout: the spans' split of an
               update, the same λ bits without it, the disabled update's
               host syncs against the parent's sequence, an armed watchdog
then the facade, serving and checkpoints, and the lifted K caps:
 20. facade  — LDA (IVI, cuda backend) for two epochs from warm_start of
               phase 5's λ₀, booked as init_global_state books it: 2
               launches an update, λ bit-equal to phase 5's LDAEngine run;
               then a mid-epoch save, load and resume bit-equal to the
               uninterrupted run, dense and chunked stores, both layouts,
               on the first 4,096 documents (the cut is in the line), with
               save and load ms and bytes
 21. serve_infer — TopicInferencer on the 2,100 held-out documents, padded
               (batch 1,024) and CSR (131,072-slot batches), from phase
               5's λ: 1 launch a batch, γ against the gather backend (tile
               by tile on the padded layout), double-buffered bits equal to
               synchronous ones, no host sync before the final gather,
               docs/s both ways, and a swapper thread flipping between two
               snapshots under traffic (each batch's γ one snapshot's)
 22. kcap    — K1, K4, K3, K6, K7 and K8 at K = 300 and 1,000 against
               their twins on the first 256 documents (K8: 16) at the
               Arxiv V, timed beside their bounds; every fixed-point
               instance's spills; at K = 100 the parent commit's bits
               (sha256 of each kernel's outputs on seeded inputs)
then the pre-fusion baseline and attention:
 23. legacy  — the per-sweep E-step (K6 once per sweep, K7 once) and the
               one-hot memo delta (K8) on phase 3's documents, λ and γ₀:
               each kernel against its twin and timed; the whole E-step
               against the same loop over the twins; the legacy correction
               against the fused one (K1–K3), here and at BENCH_estep's
               shape (B = 128, V = 4096, K = 128, L = 64)
 24. attention — flash_mha (K9) at Qwen2.5-3B's attention widths (16 query
               heads, 2 KV heads, hd = 128), B = 1, S = 4096, bf16, causal,
               against its twin, the same bits on two launches, timed beside
               scaled_dot_product_attention; the count of wgmma (HGMMA) and
               TMA load (UTMALDG) instructions in the built library's SASS;
               then fp32, not causal, S = 1000 against mha_ref
Then the ``kernels`` summary line and, last, the ``ok`` line.
It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 non-tensor,
# bf16 dense tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# operations per element of the in-kernel exp(E[ln θ]): two series digammas
# (8 divisions + 8 additions + log + 6 series terms each), a subtraction and
# an exp, counting a division, log or exp as one operation
ETHETA_OPS = 34

ARXIV_SCALE = 0.021      # 782,385 × 0.021 = 16,430 training documents
BATCH = 1024
TOPICS = 100
ESTEP_ITERS = 60
CSR_BUDGET = 131_072     # flat slots per CSR batch: 1024 documents fit
ESTEP_SOURCE = "src/repro_torch/kernels/csrc/lda_estep.cu"
ATTENTION_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = {"fixed_point": "src/repro/kernels/lda_estep.py:99",
            "token_pi": "src/repro/kernels/lda_estep.py:208",
            "segment_scatter": "src/repro/kernels/lda_estep.py:227",
            "fixed_point_csr": "src/repro/kernels/lda_estep.py:433",
            "token_pi_csr": "src/repro/kernels/lda_estep.py:558",
            "sweep": "src/repro/kernels/lda_estep.py:817",
            "sstats": "src/repro/kernels/lda_estep.py:870",
            "memo_delta_onehot": "src/repro/kernels/lda_estep.py:677",
            "flash_attention": "src/repro/kernels/flash_attention.py:31"}
SOURCES = {name: ATTENTION_SOURCE if name == "flash_attention"
           else ESTEP_SOURCE for name in REPLACES}
# the kernels each path launches, once an update each (K2 and K5 run
# fused in the fixed point's finish)
PADDED_KERNELS = ("fixed_point", "segment_scatter")
CSR_KERNELS = ("fixed_point_csr", "segment_scatter")
LEGACY_KERNELS = ("sweep", "sstats", "memo_delta_onehot")
# BENCH_estep's shape (benchmarks/kernel_bench.py:196-206)
BENCH_ESTEP = dict(b=128, v=4096, k=128, l=64, iters=30)
# Qwen2.5-3B's attention (src/repro/configs/qwen2_5_3b.py), one sequence
QWEN_ATTENTION = dict(b=1, s=4096, h=16, kv=2, hd=128)
# K9's bf16 output against its fp32-math twin, both rounded once to bf16:
# about two bf16 ulps (2^-7 relative) plus a floor for values near 0
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-3
# SDPA (the yardstick) may keep bf16 intermediates, a few ulps per element,
# so it is held by its relative L2 error: a different function (another
# mask, another head mapping) is off by O(1)
LIBRARY_REL_L2 = 2.0 ** -7
# K1/K4's γ in the bf16 stream against the twin in the same mode, rtol and
# atol: above the kernel's summation-order error, below the fp32 stream's
# distance from that twin, which the check requires to fail it
STREAM_BAR = 2e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def wall_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean host-clock time of ``fn`` over ``reps`` calls, the device
    synced before and after (for paths that sync the host themselves)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, kernel: str, reps: int = 10) -> float:
    """Mean device time per call of ``fn`` of the CUDA kernels whose name
    holds ``kernel``, by torch.profiler over ``reps`` calls after one
    warm-up: the kernel alone, where a wrapper's host work may outlast it
    and hold back back-to-back calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and kernel in e.key)
    check(total > 0, f"kernel_ms: no device time for {kernel}")
    return total / 1e3 / reps


def bound_ms(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    info = {"phase": "device", "nvidia_smi": line,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build():
    """Both libraries from the checkout's sources, one nvcc each, started
    together."""
    from repro_torch.kernels import build
    for source, _, _ in build.LIBRARIES.values():
        stale = build.library_path(source)
        if stale.exists():       # build from the checkout's source, always
            stale.unlink()
    t0 = time.perf_counter()
    build.build_all()
    for name in build.LIBRARIES:
        build.load(name)
    seconds = time.perf_counter() - t0
    # K1/K4's instance at the path's K: the π finish must fit the sweeps'
    # 64 registers a thread
    spills = fixed_point_spills(build.BUILD_INFO["lda_estep"]["ptxas"],
                                -(-TOPICS // 32))
    check(spills == [[0, 0]],
          f"fixed_point_kernel spills at K = {TOPICS}: {spills}")
    emit({"phase": "build", "seconds": seconds,
          "fixed_point_spill_bytes": spills,
          "libraries": build.BUILD_INFO})


def fixed_point_spills(ptxas, kpl):
    """Spill stores and loads (bytes) of each fixed_point_kernel instance
    for ``kpl`` topics a lane (0: the wide kernel above 256 topics), from
    ptxas's report."""
    return kernel_spills(ptxas, "fixed_point_wide_kernel" if kpl == 0
                         else f"fixed_point_kernelILi{kpl}E")


def kernel_spills(ptxas, fragment):
    """Spill stores and loads (bytes) of each kernel whose mangled name
    holds ``fragment``, from ptxas's report."""
    import re
    out = []
    for ln, props in zip(ptxas, ptxas[1:]):
        if "Function properties" in ln and fragment in ln:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", props)
            if m:
                out.append([int(m.group(1)), int(m.group(2))])
    return out


def phase_data(device, corpus="arxiv", scale=ARXIV_SCALE):
    from repro_torch.data.synthetic import PAPER_CORPORA, make_corpus
    spec = PAPER_CORPORA[corpus]
    t0 = time.perf_counter()
    train = make_corpus(spec, split="train", seed=0, scale=scale,
                        device=device)
    test = make_corpus(spec, split="test", seed=0, scale=scale, device=device)
    emit({"phase": "data", "corpus": corpus, "scale": scale,
          "train_docs": train.num_docs, "test_docs": test.num_docs,
          "L": train.max_unique, "V": spec.vocab_size,
          "train_words": float(train.num_words),
          "seconds": time.perf_counter() - t0})
    return spec, train, test


def check_fixed_point(args, label, block_b=128):
    """K1 against its plain twin on one set of inputs. γ is held at 2e-3
    and the tile sweeps within 1; Eθ at rtol 1e-4 / atol 1e-6 in every
    tile whose sweep count agrees with the twin's (a tile one sweep apart
    is held at γ's tolerance). A second launch must give the same bits
    (γ, Eθ and the tile sweeps). Returns the errors, the tile sweeps and
    the bound for this run's sweeps."""
    import torch
    from repro_torch.kernels import lda_estep

    ids, cnts, eb, gamma0 = args[:4]
    (b, k), l = gamma0.shape, ids.shape[1]
    g, et, it = lda_estep.estep_fixed_point(*args, block_b=block_b)
    again = lda_estep.estep_fixed_point(*args, block_b=block_b)
    check(all(torch.equal(x, y) for x, y in zip((g, et, it), again)),
          f"fixed_point ({label}): two launches differ")
    pg, pet, pit = lda_estep.estep_fixed_point_plain(*args, block_b=block_b)
    sweep_gap = int((it - pit).abs().max())
    check(sweep_gap <= 1, f"fixed_point ({label}): tile sweeps {it} vs {pit}")
    gerr = float((g - pg).abs().max())
    check(torch.allclose(g, pg, rtol=2e-3, atol=2e-3),
          f"fixed_point ({label}): γ off by {gerr}")
    same = (it == pit).repeat_interleave(block_b)[:b]
    eterr = float((et - pet)[same].abs().max()) if bool(same.any()) else 0.0
    check(torch.allclose(et[same], pet[same], rtol=1e-4, atol=1e-6)
          and torch.allclose(et, pet, rtol=2e-3, atol=2e-3),
          f"fixed_point ({label}): Eθ off by {eterr}")
    tile_live = torch.stack([(cnts[i:i + block_b] != 0).sum()
                             for i in range(0, b, block_b)]).cpu()
    tile_rows = torch.tensor([min(block_b, b - i)
                              for i in range(0, b, block_b)])
    sweeps = it.cpu().long()
    ops = float((sweeps * (4 * k * tile_live + ETHETA_OPS * k * tile_rows
                           + 4 * k * tile_rows)).sum() + ETHETA_OPS * b * k)
    distinct = int(torch.unique(ids[cnts != 0]).numel())
    nbytes = b * l * 8 + distinct * k * 4 + 3 * b * k * 4 + len(sweeps) * 4
    bms0, _ = bound_ms(nbytes, ops)
    # the π finish: the (B, L, K) π written, 4 operations a live topic
    bms, by = bound_ms(nbytes + b * l * k * 4,
                       ops + 4.0 * k * float(tile_live.sum()))
    return {"max_abs_err": gerr, "max_abs_err_etheta": eterr,
            "tol": "γ rtol=atol=2e-3; Eθ rtol=1e-4 atol=1e-6 in tiles whose "
                   "sweeps agree; tile sweeps within 1",
            "sweep_gap": sweep_gap, "tile_sweeps": sweeps.tolist(),
            "bit_equal_two_launches": True,
            "bound_ms": bms, "bound_by": by, "bound_ms_without_pi": bms0,
            "_etheta": et, "_etheta_plain": pet}


def check_fused_pi(run_pi, run_alone, standalone_pi, label):
    """The fixed point with its π finish against the same launch without
    it (γ, Eθ and the sweeps bit for bit) and its π against the standalone
    π kernel (K2 or K5) on its Eθ, bit for bit, with quantize off and on.
    ``run_pi(quantize)`` gives (γ, Eθ, sweeps, π), ``run_alone()`` (γ, Eθ,
    sweeps), ``standalone_pi(Eθ, quantize)`` π."""
    import torch
    alone = run_alone()
    for quantize in (False, True):
        g, et, it, pi = run_pi(quantize)
        check(all(torch.equal(x, y) for x, y in zip((g, et, it), alone)),
              f"{label}: γ, Eθ or the sweeps differ with the π finish")
        check(torch.equal(pi, standalone_pi(et, quantize)),
              f"{label}: π (quantize={quantize}) is not the standalone "
              "kernel's bit for bit")
    return {"bit_equal_without_pi": True, "pi_bit_equal_to_standalone": True}


def bar_ratio(got, want, tol):
    """max |got - want| / (tol + tol·|want|): above 1 fails allclose at
    rtol = atol = tol."""
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


def check_bf16(run, run_fp32, plain, label, block):
    """One bf16-streamed launch with its π finish against its twin in the
    same mode. The sweeps are equal (K4, ``block`` = B) or, per tile of
    ``block`` rows (K1), within 1; γ at 2e-3 everywhere and at rtol = atol
    = STREAM_BAR in the tiles whose sweeps agree, where the fp32 stream's
    γ (``run_fp32``) must fail that bar, so the check would catch a launch
    that skipped the rounding; π at rtol 2e-3 / atol 1e-4."""
    import torch
    g, _, it, pi = run()
    g32 = run_fp32()[0]
    pg, _, pit, ppi = plain()
    gap = int((it - pit).abs().max())
    check(gap == 0 if block == g.shape[0] else gap <= 1,
          f"{label} bf16: sweeps {it.tolist()} vs twin {pit.tolist()}")
    gerr = float((g - pg).abs().max())
    check(torch.allclose(g, pg, rtol=2e-3, atol=2e-3),
          f"{label} bf16: γ off its twin by {gerr}")
    same = (it == pit).repeat_interleave(block)[:g.shape[0]]
    check(bool(same.any()), f"{label} bf16: no tile's sweeps agree")
    ratio = bar_ratio(g[same], pg[same], STREAM_BAR)
    ratio32 = bar_ratio(g32[same], pg[same], STREAM_BAR)
    check(ratio <= 1.0 < ratio32,
          f"{label} bf16: γ at {ratio} of the {STREAM_BAR} bar, the fp32 "
          f"stream's at {ratio32}")
    perr = float((pi - ppi).abs().max())
    check(torch.allclose(pi, ppi, rtol=2e-3, atol=1e-4),
          f"{label} bf16: π off its twin by {perr}")
    return {"max_abs_err_bf16": gerr, "max_abs_err_pi_bf16": perr,
            "sweep_gap_bf16": gap, "stream_bar_ratio_bf16": ratio,
            "stream_bar_ratio_fp32": ratio32,
            "max_abs_err_fp32_vs_bf16_twin": float((g32 - pg).abs().max()),
            "tol_bf16": f"γ rtol=atol=2e-3, and {STREAM_BAR} in tiles whose "
                        "sweeps agree (the fp32 stream must fail it); π "
                        "rtol 2e-3 atol 1e-4; sweeps "
                        + ("equal" if block == g.shape[0]
                           else "within 1 a tile")}


def phase_kernels(device, spec, train, topics, batch, timer):
    """Each kernel against its plain twin on one path-shaped batch."""
    import torch
    from repro_torch.core.math import exp_dirichlet_expectation
    from repro_torch.core.types import LDAConfig, init_global_state
    from repro_torch.kernels import build, lda_estep

    cfg = LDAConfig(num_topics=topics, vocab_size=spec.vocab_size,
                    estep_max_iters=ESTEP_ITERS)
    gen = torch.Generator(device=device).manual_seed(0)
    lam = init_global_state(cfg, device=device, generator=gen).lam
    eb = exp_dirichlet_expectation(lam, axis=0).contiguous()
    ids = train.token_ids[:batch].contiguous()
    cnts = train.counts[:batch].contiguous()
    b, l = ids.shape
    k, v = topics, spec.vocab_size
    live = int((cnts != 0).sum())
    distinct = int(torch.unique(ids[cnts != 0]).numel())
    out = {}

    # K1 ------------------------------------------------------------------
    gamma0 = torch.full((b, k), cfg.alpha0 + 1.0, device=device)
    args = (ids, cnts, eb, gamma0, cfg.alpha0, cfg.estep_tol,
            cfg.estep_max_iters)
    out["fixed_point"] = check_fixed_point(args, "cold γ₀")
    et = out["fixed_point"].pop("_etheta")
    pet = out["fixed_point"].pop("_etheta_plain")
    out["fixed_point"].update(check_fused_pi(
        lambda q: lda_estep.estep_fixed_point_pi(*args, quantize=q),
        lambda: lda_estep.estep_fixed_point(*args),
        lambda e, q: lda_estep.token_pi(ids, cnts, eb, e, quantize=q),
        "fixed_point"))
    out["fixed_point"].update(check_bf16(
        lambda: lda_estep.estep_fixed_point_pi(*args,
                                               stream_dtype="bfloat16"),
        lambda: lda_estep.estep_fixed_point_pi(*args),
        lambda: lda_estep.estep_fixed_point_pi_plain(
            *args, stream_dtype="bfloat16"), "fixed_point", 128))
    # the path's launch: the fixed point with its π finish
    out["fixed_point"].update(
        ms=timer(lambda: lda_estep.estep_fixed_point_pi(*args), 10),
        ms_without_pi=timer(lambda: lda_estep.estep_fixed_point(*args), 10),
        ms_bf16=timer(lambda: lda_estep.estep_fixed_point_pi(
            *args, stream_dtype="bfloat16"), 10),
        kernel_ms=kernel_ms(lambda: lda_estep.estep_fixed_point_pi(*args),
                            "fixed_point_kernel"),
        kernel_ms_without_pi=kernel_ms(
            lambda: lda_estep.estep_fixed_point(*args), "fixed_point_kernel"),
        # the bf16 stream's kernel alone (ms_bf16 adds the wrapper's
        # rounding of Eφ and the counts through bf16)
        kernel_ms_bf16=kernel_ms(lambda: lda_estep.estep_fixed_point_pi(
            *args, stream_dtype="bfloat16"), "fixed_point_kernel"),
        plain_ms=timer(lambda: lda_estep.estep_fixed_point_pi_plain(*args),
                       2, 1),
        library_ms=None)
    lib = build.load()
    grid = lib.lda_fixed_point_blocks(b, l, k, 128)
    one_round = -(-b // (8 // lib.lda_fixed_point_warps(l)))
    check(grid == one_round, f"fixed_point: grid {grid} blocks, not the "
          f"{one_round} that hold every document at once")

    # K2 ------------------------------------------------------------------
    errs = {}
    for quantize in (False, True):
        got = lda_estep.token_pi(ids, cnts, eb, et, quantize=quantize)
        want = lda_estep.token_pi_plain(ids, cnts, eb, et, quantize=quantize)
        errs[quantize] = float((got - want).abs().max())
        rtol, atol = (2.0 ** -7, 1e-38) if quantize else (1e-5, 1e-6)
        check(torch.allclose(got, want, rtol=rtol, atol=atol),
              f"token_pi(quantize={quantize}): off by {errs[quantize]}")
    pi = lda_estep.token_pi(ids, cnts, eb, et)
    pi_old_full = lda_estep.token_pi(ids, cnts, eb, pet)
    # K2 then K3 driven as memo_delta (the counterpart of repro's), counted
    lda_estep.reset_launches()
    memo_delta = lda_estep.memo_delta(ids, cnts, eb, et, v,
                                      old_pi=pi_old_full, quantize=True)
    memo_delta_launches = dict(lda_estep.LAUNCHES)
    check(memo_delta_launches["token_pi"] == 1
          and memo_delta_launches["segment_scatter"] == 1,
          f"memo_delta: {memo_delta_launches}")
    check(torch.equal(memo_delta[0], lda_estep.token_pi(
        ids, cnts, eb, et, quantize=True)), "memo_delta: π is not K2's")
    del memo_delta
    bms, by = bound_ms(b * l * 8 + distinct * k * 4 + b * k * 4
                       + b * l * k * 4, 4.0 * live * k)
    out["token_pi"] = {
        "max_abs_err": errs[False], "max_abs_err_bf16": errs[True],
        "tol": "rtol=1e-5 atol=1e-6 fp32; 1 bf16 ulp with quantize",
        "ms": timer(lambda: lda_estep.token_pi(ids, cnts, eb, et), 20),
        "plain_ms": timer(lambda: lda_estep.token_pi_plain(ids, cnts, eb, et),
                          5),
        "bound_ms": bms, "bound_by": by, "library_ms": None}

    # K3 ------------------------------------------------------------------
    flat_ids, flat_cnts = ids.reshape(-1), cnts.reshape(-1)
    pi_new = pi.reshape(-1, k)
    pi_old = pi_old_full.reshape(-1, k)
    err = check_segment_scatter(flat_ids, flat_cnts, pi_new, pi_old, v, "path")
    # one frequent id in every document: a 1,024-row segment, split over
    # a block's warps
    skew_ids = ids.clone()
    skew_ids[:, 1:][skew_ids[:, 1:] == 7] = 8
    skew_ids[:, 0] = 7
    skew_ids = skew_ids.reshape(-1)
    skew_err = check_segment_scatter(skew_ids, flat_cnts, pi_new, pi_old, v,
                                     "one id in every document")
    idx64 = flat_ids.long()
    segments = lda_estep.scatter_segments(flat_ids, flat_cnts, v)
    seg_len = segments[1][1:] - segments[1][:-1]
    seg_len = seg_len[seg_len > 0].double()
    syncs = host_syncs(lambda: lda_estep.segment_scatter(
        flat_ids, flat_cnts, pi_new, pi_old, v))
    check(syncs == 0, f"segment_scatter: {syncs} host syncs in one call")
    # the counter sees syncs where there are some: the twin's preparation
    # (nonzero, unique_consecutive) makes them
    plain_syncs = host_syncs(lambda: lda_estep.scatter_segments_plain(
        flat_ids, flat_cnts))
    check(plain_syncs > 0, "host_syncs: the twin's preparation showed none")

    def library():
        a = torch.zeros((v, k), device=device).index_add_(
            0, idx64, flat_cnts[:, None] * pi_new)
        c = torch.zeros((v, k), device=device).index_add_(
            0, idx64, flat_cnts[:, None] * pi_old)
        return a, c

    bms, by = bound_ms(live * 8 + 2 * live * k * 4 + 2 * v * k * 4,
                       4.0 * live * k)
    skew_segments = lda_estep.scatter_segments(skew_ids, flat_cnts, v)
    out["segment_scatter"] = {
        "max_abs_err": err, "max_abs_err_skewed": skew_err,
        "tol": "rtol=atol=1e-5 vs fp64; bitwise equal across launches; "
               "also with one id in every document", "deterministic": True,
        # the launch on prepared segments (it writes every output row); the
        # wrapper adds the fixed-size preparation (sort_ms)
        "ms": timer(lambda: lda_estep.segment_scatter_prepared(
            segments, flat_cnts, pi_new, pi_old, v), 20),
        "kernel_ms": kernel_ms(lambda: lda_estep.segment_scatter_prepared(
            segments, flat_cnts, pi_new, pi_old, v), "segment_scatter_kernel"),
        "ms_skewed": timer(lambda: lda_estep.segment_scatter_prepared(
            skew_segments, flat_cnts, pi_new, pi_old, v), 20),
        "sort_ms": timer(lambda: lda_estep.scatter_segments(
            flat_ids, flat_cnts, v), 20),
        "wrapper_ms": timer(lambda: lda_estep.segment_scatter(
            flat_ids, flat_cnts, pi_new, pi_old, v), 20),
        "plain_ms": timer(lambda: lda_estep.segment_scatter_plain(
            flat_ids, flat_cnts, pi_new, pi_old, v), 5),
        "bound_ms": bms, "bound_by": by, "library_ms": timer(library, 20),
        "library_call": "2x zeros + index_add_"}
    emit({"phase": "kernels", "shape": {"B": b, "L": l, "K": k, "V": v,
                                        "live_slots": live,
                                        "distinct_ids": distinct},
          "kernels": out,
          # the blocks of K1's cooperative grid at this shape, and the
          # launches of memo_delta (K2 then K3)
          "fixed_point_grid_blocks": grid,
          "memo_delta_launches": memo_delta_launches,
          # K3's rows per live id, and the host syncs of one wrapper call
          # (torch's sync debug mode) beside the twin's preparation's
          "segment_scatter": {"segment_len_max": int(seg_len.max()),
                              "segment_len_p99": float(torch.quantile(
                                  seg_len, 0.99)),
                              "segments": int(seg_len.numel()),
                              "host_syncs": syncs,
                              "host_syncs_plain_preparation": plain_syncs}})
    return out, memo_delta_launches


def check_segment_scatter(flat_ids, flat_cnts, pi_new, pi_old, v, label):
    """K3 against an fp64 ``index_add_`` at rtol = atol = 1e-5, and the same
    bits on a second launch. Returns the largest error."""
    import torch
    from repro_torch.kernels import lda_estep
    k = pi_new.shape[1]
    s1 = lda_estep.segment_scatter(flat_ids, flat_cnts, pi_new, pi_old, v)
    s2 = lda_estep.segment_scatter(flat_ids, flat_cnts, pi_new, pi_old, v)
    check(all(torch.equal(x, y) for x, y in zip(s1, s2)),
          f"segment_scatter ({label}): two launches differ")
    err = 0.0
    for got, p in zip(s1, (pi_new, pi_old)):
        want = torch.zeros((v, k), dtype=torch.float64, device=p.device)
        want.index_add_(0, flat_ids.long(), flat_cnts[:, None].double()
                        * p.double())
        err = max(err, float((got.double() - want).abs().max()))
        check(torch.allclose(got.double(), want, rtol=1e-5, atol=1e-5),
              f"segment_scatter ({label}): off the fp64 sum by {err}")
    return err


def host_syncs(fn):
    """Host syncs in one call of ``fn``: torch's sync debug mode "warn"
    reports each synchronizing CUDA operation as a warning ("called a
    synchronizing CUDA operation"; setting the mode may warn too, that it
    is a prototype)."""
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("called a synchronizing" in str(w.message) for w in caught)


def phase_serve(device, spec, test, topics, batch, sync):
    """γ for held-out documents through the CUDA backend, held against the
    gather backend run tile by tile (the same stopping rule)."""
    import torch
    from repro_torch.core.estep import BowBatch, get_backend
    from repro_torch.core.math import exp_dirichlet_expectation
    from repro_torch.core.types import (DEFAULT_KERNEL_POLICY, LDAConfig,
                                        init_global_state)
    from repro_torch.kernels import lda_estep

    cfg = LDAConfig(num_topics=topics, vocab_size=spec.vocab_size,
                    estep_max_iters=ESTEP_ITERS, estep_backend="cuda")
    gen = torch.Generator(device=device).manual_seed(1)
    eb = exp_dirichlet_expectation(
        init_global_state(cfg, device=device, generator=gen).lam, axis=0)
    n = min(batch, test.num_docs)
    req = BowBatch(test.token_ids[:n].contiguous(),
                   test.counts[:n].contiguous())
    backend = get_backend("cuda")
    backend.solve(cfg, eb, req)                       # warm-up
    lda_estep.reset_launches()
    sync()
    t0 = time.perf_counter()
    got = backend.solve(cfg, eb, req)
    sync()
    seconds = time.perf_counter() - t0
    launches = dict(lda_estep.LAUNCHES)
    tile = DEFAULT_KERNEL_POLICY.block_b
    parts = [get_backend("gather").solve(
        cfg, eb, BowBatch(req.token_ids[i:i + tile], req.counts[i:i + tile]))
        for i in range(0, n, tile)]
    gamma = torch.cat([p.gamma for p in parts])
    pi = torch.cat([p.pi for p in parts])
    sstats = sum(p.sstats for p in parts)
    errs = {"gamma": float((got.gamma - gamma).abs().max()),
            "pi": float((got.pi - pi).abs().max()),
            "sstats": float((got.sstats - sstats).abs().max())}
    check(torch.allclose(got.gamma, gamma, rtol=2e-3, atol=2e-3),
          f"serve: γ off the gather backend by {errs['gamma']}")
    check(torch.allclose(got.pi, pi, rtol=2e-3, atol=1e-4),
          f"serve: π off by {errs['pi']}")
    check(torch.allclose(got.sstats, sstats, rtol=1e-2, atol=2e-3),
          f"serve: sstats off by {errs['sstats']}")
    check(all(launches[n] == 1 for n in PADDED_KERNELS)
          and sum(launches.values()) == 2, f"serve: {launches}")
    emit({"phase": "serve", "docs": n, "seconds": seconds,
          "docs_per_s": n / seconds, "launches": launches,
          "max_abs_err_vs_gather": errs, "iters": int(got.iters)})


def memo_invariant_gap(eng, train, topics, device):
    """⟨m_vk⟩ against Σ_d scatter(cnt·π_memo), rebuilt in fp64 from the
    memo store's ``gather``; fails outside rtol 1e-3 / atol 1e-2. Returns
    the largest gap."""
    import numpy as np
    import torch
    rebuilt = torch.zeros(eng.state.m_vk.shape, dtype=torch.float64,
                          device=device)
    for lo in range(0, eng.num_docs, 2048):
        pi, _ = eng.memo.gather(np.arange(lo, min(lo + 2048, eng.num_docs)))
        ids = train.token_ids[lo:lo + 2048].reshape(-1).long()
        w = train.counts[lo:lo + 2048, :, None].double() * pi.double()
        rebuilt.index_add_(0, ids, w.reshape(-1, topics))
    gap = float((eng.state.m_vk.double() - rebuilt).abs().max())
    check(torch.allclose(eng.state.m_vk.double(), rebuilt, rtol=1e-3,
                         atol=1e-2), f"memo invariant gap {gap}")
    return gap


def phase_train(device, spec, train, test, topics, batch, sync):
    """Two IVI epochs through LDAEngine on the CUDA backend."""
    import numpy as np
    import torch
    from repro_torch.core.engines import LDAEngine
    from repro_torch.core.types import LDAConfig
    from repro_torch.kernels import lda_estep

    cfg = LDAConfig(num_topics=topics, vocab_size=spec.vocab_size,
                    estep_max_iters=ESTEP_ITERS, estep_backend="cuda")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    eng = LDAEngine(cfg, train, algo="ivi", batch_size=batch, seed=0,
                    test_corpus=test, device=device)
    doc_tokens = train.counts.sum(1).cpu().numpy()
    update_s, docs, tokens, lpp, elbo = [], 0, 0.0, [], []
    lda_estep.reset_launches()
    for epoch in (1, 2):
        for rows, _ in eng.epoch_batches():
            sync()
            t0 = time.perf_counter()
            eng.run_minibatch(rows)
            sync()
            update_s.append(time.perf_counter() - t0)
            docs += len(rows)
            tokens += float(doc_tokens[rows].sum())
            if epoch == 2:
                elbo.append(eng.full_bound())
        if epoch == 1:
            check(float(eng.state.init_frac) == 0.0, "init mass not retired")
            check(torch.allclose(eng.state.lam, cfg.beta0 + eng.state.m_vk,
                                 rtol=1e-5, atol=1e-5),
                  "λ != β₀ + ⟨m_vk⟩ after the covering pass")
            elbo.append(eng.full_bound())    # the bound epoch 2 starts from
        lpp.append(eng.evaluate()["lpp"])
    launches = dict(lda_estep.LAUNCHES)
    updates = len(update_s)
    check(all(launches[n] == updates for n in PADDED_KERNELS)
          and sum(launches.values()) == 2 * updates,
          f"train: not 2 launches an update over {updates}: {launches}")
    drops = [(a, b_) for a, b_ in zip(elbo, elbo[1:])
             if b_ < a - max(5e-3, 2e-6 * abs(a))]
    check(not drops, f"memoized ELBO decreased in epoch 2: {drops}")
    check(all(np.isfinite(lpp)) and bool(torch.isfinite(eng.state.lam).all()),
          "non-finite LPP or λ")
    # memo invariant: ⟨m_vk⟩ == Σ_d scatter(cnt·π_memo), rebuilt in fp64
    gap = memo_invariant_gap(eng, train, topics, device)
    ms = [s * 1e3 for s in update_s]
    out = {"phase": "train", "algo": "ivi", "backend": "cuda",
           "docs": eng.num_docs, "batch": batch, "epochs": 2,
           "updates": len(ms), "median_ms_per_update": float(np.median(ms)),
           "docs_per_s": docs / sum(update_s),
           "tokens_per_s": tokens / sum(update_s), "launches": launches,
           "lpp": lpp, "elbo_epoch2": elbo, "memo_invariant_gap": gap,
           "memo_bytes": eng.memo.footprint_bytes()}
    if device.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    emit(out)
    return launches, eng, out


def phase_fixed_point_warm(eng, kernels, timer, max_batches=4):
    """K1 against its twin as training runs it: λ after two epochs and γ₀
    warm-started from the memo's π (Alg. 1 line 6), so tiles stop early
    and at different sweep counts. Checks batches of a fresh epoch order
    until two tiles have stopped at different counts (at most
    ``max_batches``) and fails if none did."""
    import torch
    from repro_torch.core.estep import warm_start_gamma
    from repro_torch.core.math import exp_dirichlet_expectation
    from repro_torch.kernels import lda_estep

    cfg = eng.cfg
    eb = exp_dirichlet_expectation(eng.state.lam, axis=0).contiguous()
    checked, sweeps, first = [], [], None
    for rows, _ in eng.epoch_batches()[:max_batches]:
        idx = torch.as_tensor(rows, dtype=torch.int64, device=eng.device)
        ids = eng.corpus.token_ids[idx].contiguous()
        cnts = eng.corpus.counts[idx].contiguous()
        old_pi, visited = eng.memo.gather(rows)
        check(bool(visited.all()), "warm K1 check: a document not visited")
        gamma0 = warm_start_gamma(cfg, cnts, old_pi, visited).contiguous()
        args = (ids, cnts, eb, gamma0, cfg.alpha0, cfg.estep_tol,
                cfg.estep_max_iters)
        res = check_fixed_point(args, "warm γ₀")
        res.pop("_etheta"), res.pop("_etheta_plain")
        if first is None:
            first = args
        checked.append(res)
        sweeps += res["tile_sweeps"]
        if len(set(sweeps)) >= 2:
            break
    check(len(set(sweeps)) >= 2, f"warm K1 check: every tile ran the same "
          f"sweeps {sweeps}, so the stopping rule was not exercised")
    fused = check_fused_pi(
        lambda q: lda_estep.estep_fixed_point_pi(*first, quantize=q),
        lambda: lda_estep.estep_fixed_point(*first),
        lambda e, q: lda_estep.token_pi(*first[:3], e, quantize=q),
        "warm fixed_point")
    warm = {"batches": len(checked), **fused,
            "max_abs_err": max(r["max_abs_err"] for r in checked),
            "max_abs_err_etheta": max(r["max_abs_err_etheta"]
                                      for r in checked),
            "sweep_gap": max(r["sweep_gap"] for r in checked),
            "tile_sweeps": [r["tile_sweeps"] for r in checked],
            "bit_equal_two_launches": all(r["bit_equal_two_launches"]
                                          for r in checked),
            "ms": timer(lambda: lda_estep.estep_fixed_point_pi(*first), 10),
            "ms_without_pi": timer(
                lambda: lda_estep.estep_fixed_point(*first), 10),
            "kernel_ms": kernel_ms(
                lambda: lda_estep.estep_fixed_point_pi(*first),
                "fixed_point_kernel"),
            "bound_ms": checked[0]["bound_ms"],
            "bound_by": checked[0]["bound_by"]}
    kernels["fixed_point"]["warm"] = warm
    emit({"phase": "kernels_warm", "fixed_point": warm})


def phase_profile(step, updates=4, phase="profile"):
    """Where one update's time goes: ``torch.profiler`` over ``updates``
    more updates (``step()`` runs one, after every check above), device
    time by operation, the device's idle share of the wall time, and the
    host's time by operation (its own CPU time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(updates):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an aten op on the host carries its
    # kernels' device time as well, and would count it twice
    ops = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0),
                 key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in ops)
    # where the host's time goes: operations by their own CPU time
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.self_cpu_time_total > 0), key=lambda r: -r[1])
    emit({"phase": phase, "updates": updates, "wall_ms": wall_ms,
          "device_busy_ms": busy_ms,
          "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
          "top_device_ms": [{"op": k[:80], "ms": ms, "count": n}
                            for k, ms, n in ops[:12]],
          "top_host_ms": [{"op": k[:80], "ms": ms, "count": n}
                          for k, ms, n in host[:12]]})


# ---------------------------------------------------------------------------
# the flat CSR token-stream path
# ---------------------------------------------------------------------------

def first_csr_batch(stream, batch, max_width=None):
    """The first CSR batch packed from a stream."""
    from repro_torch.data.stream import BatchPacker
    packer = BatchPacker(batch, max_width=max_width,
                         vocab_size=stream.vocab_size, layout="csr",
                         token_budget=CSR_BUDGET)
    for pos, (ids, cnts) in enumerate(stream.iter_from(0)):
        out = packer.add(pos, ids, cnts)
        if out is not None:
            return out
    return packer.flush()[0]


def flat_tensors(cb, device):
    import torch
    return [torch.from_numpy(a).to(device)
            for a in (cb.token_ids, cb.counts, cb.segments)]


def check_fixed_point_csr(args, label):
    """K4 against its plain twin on one set of inputs: the same batch-wide
    sweep count, γ at 2e-3, Eθ at rtol 1e-4 / atol 1e-6; a second launch
    must give the same bits. Returns the errors, the sweeps and the bound
    for this run's sweeps."""
    import torch
    from repro_torch.kernels import lda_estep

    ids, cnts, segs, eb, gamma0 = args[:5]
    b, k = gamma0.shape
    g, et, it = lda_estep.estep_fixed_point_csr(*args)
    again = lda_estep.estep_fixed_point_csr(*args)
    check(all(torch.equal(x, y) for x, y in zip((g, et, it), again)),
          f"fixed_point_csr ({label}): two launches differ")
    pg, pet, pit = lda_estep.estep_fixed_point_csr_plain(*args)
    sweeps = int(it[0])
    check(sweeps == int(pit[0]),
          f"fixed_point_csr ({label}): sweeps {sweeps} vs twin {int(pit[0])}")
    gerr = float((g - pg).abs().max())
    check(torch.allclose(g, pg, rtol=2e-3, atol=2e-3),
          f"fixed_point_csr ({label}): γ off by {gerr}")
    eterr = float((et - pet).abs().max())
    check(torch.allclose(et, pet, rtol=1e-4, atol=1e-6),
          f"fixed_point_csr ({label}): Eθ off by {eterr}")
    live = int((cnts != 0).sum())
    distinct = int(torch.unique(ids[cnts != 0]).numel())
    ops = float(sweeps * (4 * k * live + (ETHETA_OPS + 4) * k * b)
                + ETHETA_OPS * b * k)
    nbytes = live * 12 + distinct * k * 4 + 3 * b * k * 4 + 4
    bms0, _ = bound_ms(nbytes, ops)
    # the π finish: the flat (T, K) π written, 4 operations a live topic
    bms, by = bound_ms(nbytes + ids.numel() * k * 4, ops + 4.0 * k * live)
    return {"max_abs_err": gerr, "max_abs_err_etheta": eterr,
            "tol": "γ rtol=atol=2e-3; Eθ rtol=1e-4 atol=1e-6; the same "
                   "batch-wide sweep count",
            "sweeps": sweeps, "live_tokens": live, "distinct_ids": distinct,
            "bit_equal_two_launches": True,
            "bound_ms": bms, "bound_by": by, "bound_ms_without_pi": bms0,
            "_etheta": et, "_etheta_plain": pet}


def check_shuffled_csr(ids, cnts, segs, eb, gamma0, cfg, seed=0):
    """K4 with its π finish on the flat batch shuffled slot by slot (live
    tokens no longer grouped by segment, padding interleaved) against its
    twin: the same sweeps, γ at 2e-3, Eθ at rtol 1e-4 / atol 1e-6, π equal
    to K5's on the shuffled stream, and no host sync in the wrapper (sort,
    sorted search, gathers, launch)."""
    import torch
    from repro_torch.kernels import lda_estep
    gen = torch.Generator(device=ids.device).manual_seed(seed)
    perm = torch.randperm(ids.numel(), generator=gen, device=ids.device)
    flat = [x[perm].contiguous() for x in (ids, cnts, segs)]
    args = (*flat, eb, gamma0, cfg.alpha0, cfg.estep_tol, cfg.estep_max_iters)
    syncs = host_syncs(lambda: lda_estep.estep_fixed_point_csr_pi(*args))
    check(syncs == 0, f"fixed_point_csr (shuffled): {syncs} host syncs")
    g, et, it, pi = lda_estep.estep_fixed_point_csr_pi(*args)
    pg, pet, pit = lda_estep.estep_fixed_point_csr_plain(*args)
    check(int(it[0]) == int(pit[0]),
          f"fixed_point_csr (shuffled): sweeps {int(it[0])} vs twin "
          f"{int(pit[0])}")
    gerr = float((g - pg).abs().max())
    eterr = float((et - pet).abs().max())
    check(torch.allclose(g, pg, rtol=2e-3, atol=2e-3)
          and torch.allclose(et, pet, rtol=1e-4, atol=1e-6),
          f"fixed_point_csr (shuffled): γ off by {gerr}, Eθ by {eterr}")
    check(torch.equal(pi, lda_estep.token_pi_csr(*flat, eb, et)),
          "fixed_point_csr (shuffled): π is not K5's bit for bit")
    return {"max_abs_err": gerr, "max_abs_err_etheta": eterr,
            "sweeps": int(it[0]), "host_syncs": syncs,
            "pi_bit_equal_to_standalone": True,
            "ms": cuda_ms(lambda: lda_estep.estep_fixed_point_csr_pi(*args),
                          10)}


def csr_grid(b, t, k, ms, sweeps):
    """K4's warps per document (from ceil(T / B)), the blocks of its
    cooperative grid, and its µs per sweep (of the kernel's device
    time)."""
    from repro_torch.kernels import build
    lib = build.load()
    rows = -(-t // b)
    return {"warps_per_doc": lib.lda_fixed_point_warps(rows),
            "grid_blocks": lib.lda_fixed_point_blocks(b, rows, k, b),
            "us_per_sweep": ms * 1e3 / sweeps}


def phase_kernels_csr(device, spec, train, topics, batch, timer):
    """K4, K5 and memo_delta_csr (K5 + K3) against their plain twins on the
    first flat batch of the training stream, with the λ of phase 3."""
    import numpy as np
    import torch
    from repro_torch.core.math import exp_dirichlet_expectation
    from repro_torch.core.types import LDAConfig, init_global_state
    from repro_torch.data.stream import CorpusDocStream
    from repro_torch.kernels import lda_estep

    cfg = LDAConfig(num_topics=topics, vocab_size=spec.vocab_size,
                    estep_max_iters=ESTEP_ITERS)
    gen = torch.Generator(device=device).manual_seed(0)
    lam = init_global_state(cfg, device=device, generator=gen).lam
    eb = exp_dirichlet_expectation(lam, axis=0).contiguous()
    cb = first_csr_batch(CorpusDocStream(train, spec.vocab_size), batch,
                         train.max_unique)
    ids, cnts, segs = flat_tensors(cb, device)
    b, k, v, t = cb.num_docs, topics, spec.vocab_size, cb.token_budget
    out = {}

    # K4 ------------------------------------------------------------------
    gamma0 = torch.full((b, k), cfg.alpha0 + 1.0, device=device)
    args = (ids, cnts, segs, eb, gamma0, cfg.alpha0, cfg.estep_tol,
            cfg.estep_max_iters)
    out["fixed_point_csr"] = check_fixed_point_csr(args, "cold γ₀")
    et = out["fixed_point_csr"].pop("_etheta")
    pet = out["fixed_point_csr"].pop("_etheta_plain")
    live = out["fixed_point_csr"]["live_tokens"]
    distinct = out["fixed_point_csr"]["distinct_ids"]
    out["fixed_point_csr"].update(check_fused_pi(
        lambda q: lda_estep.estep_fixed_point_csr_pi(*args, quantize=q),
        lambda: lda_estep.estep_fixed_point_csr(*args),
        lambda e, q: lda_estep.token_pi_csr(ids, cnts, segs, eb, e,
                                            quantize=q),
        "fixed_point_csr"))
    out["fixed_point_csr"].update(check_bf16(
        lambda: lda_estep.estep_fixed_point_csr_pi(*args,
                                                   stream_dtype="bfloat16"),
        lambda: lda_estep.estep_fixed_point_csr_pi(*args),
        lambda: lda_estep.estep_fixed_point_csr_pi_plain(
            *args, stream_dtype="bfloat16"), "fixed_point_csr", b))
    shuffled = check_shuffled_csr(ids, cnts, segs, eb, gamma0, cfg)

    # the path's launch: the fixed point with its π finish; the wrapper
    # adds the sort by segment (sort_ms: sort and sorted search) and the
    # two gathers of the ids and counts
    out["fixed_point_csr"].update(
        ms=timer(lambda: lda_estep.estep_fixed_point_csr_pi(*args), 10),
        ms_without_pi=timer(
            lambda: lda_estep.estep_fixed_point_csr(*args), 10),
        ms_bf16=timer(lambda: lda_estep.estep_fixed_point_csr_pi(
            *args, stream_dtype="bfloat16"), 10),
        kernel_ms=kernel_ms(
            lambda: lda_estep.estep_fixed_point_csr_pi(*args),
            "fixed_point_kernel"),
        kernel_ms_without_pi=kernel_ms(
            lambda: lda_estep.estep_fixed_point_csr(*args),
            "fixed_point_kernel"),
        kernel_ms_bf16=kernel_ms(lambda: lda_estep.estep_fixed_point_csr_pi(
            *args, stream_dtype="bfloat16"), "fixed_point_kernel"),
        sort_ms=timer(lambda: lda_estep.csr_doc_ranges(cnts, segs, b), 20),
        plain_ms=timer(lambda: lda_estep.estep_fixed_point_csr_pi_plain(
            *args), 2, 1),
        library_ms=None, shuffled=shuffled,
        # phase 3 timed K1 on these documents, with this λ and γ₀
        same_docs_as_fixed_point=bool(np.array_equal(cb.rows,
                                                     np.arange(batch))))

    # K5 ------------------------------------------------------------------
    errs = {}
    for quantize in (False, True):
        got = lda_estep.token_pi_csr(ids, cnts, segs, eb, et,
                                     quantize=quantize)
        want = lda_estep.token_pi_csr_plain(ids, cnts, segs, eb, et,
                                            quantize=quantize)
        errs[quantize] = float((got - want).abs().max())
        rtol, atol = (2.0 ** -7, 1e-38) if quantize else (1e-5, 1e-6)
        check(torch.allclose(got, want, rtol=rtol, atol=atol),
              f"token_pi_csr(quantize={quantize}): off by {errs[quantize]}")
    bms, by = bound_ms(t * 12 + distinct * k * 4 + b * k * 4 + t * k * 4,
                       4.0 * live * k)
    out["token_pi_csr"] = {
        "max_abs_err": errs[False], "max_abs_err_bf16": errs[True],
        "tol": "rtol=1e-5 atol=1e-6 fp32; 1 bf16 ulp with quantize",
        "ms": timer(lambda: lda_estep.token_pi_csr(ids, cnts, segs, eb, et),
                    20),
        "plain_ms": timer(lambda: lda_estep.token_pi_csr_plain(
            ids, cnts, segs, eb, et), 5),
        "bound_ms": bms, "bound_by": by, "library_ms": None}

    # memo_delta_csr: K5 then K3 on the flat rows, driven and counted -----
    pi_old = lda_estep.token_pi_csr(ids, cnts, segs, eb, pet)
    lda_estep.reset_launches()
    pi, s_new, s_old = lda_estep.memo_delta_csr(ids, cnts, segs, eb, et, v,
                                                old_pi=pi_old)
    memo_delta_launches = dict(lda_estep.LAUNCHES)
    check(memo_delta_launches["token_pi_csr"] == 1
          and memo_delta_launches["segment_scatter"] == 1,
          f"memo_delta_csr: {memo_delta_launches}")
    check(torch.allclose(pi, lda_estep.token_pi_csr_plain(
        ids, cnts, segs, eb, et), rtol=1e-5, atol=1e-6),
        "memo_delta_csr: π off its twin")
    err = 0.0
    for got, p in ((s_new, pi), (s_old, pi_old)):
        want = torch.zeros((v, k), dtype=torch.float64, device=device)
        want.index_add_(0, ids.long(), cnts[:, None].double() * p.double())
        err = max(err, float((got.double() - want).abs().max()))
        check(torch.allclose(got.double(), want, rtol=1e-5, atol=1e-5),
              f"memo_delta_csr: S off the fp64 sum by {err}")
    k4 = out["fixed_point_csr"]
    emit({"phase": "kernels_csr",
          "shape": {"B": b, "T": t, "K": k, "V": v, "live_tokens": live,
                    "distinct_ids": distinct,
                    "longest_doc": int(cb.doc_lengths.max())},
          "memo_delta_csr": {"max_abs_err_vs_fp64": err,
                             "tol": "rtol=atol=1e-5 vs fp64",
                             "launches": memo_delta_launches},
          "fixed_point_csr_grid": csr_grid(b, t, k, k4["kernel_ms"],
                                           k4["sweeps"]),
          "kernels": out})
    return out, memo_delta_launches


def phase_serve_csr(device, spec, test, topics, batch, sync):
    """γ for held-out documents packed as one flat batch, through the CUDA
    backend's flat contract, held against the plain flat reference. Both
    stop batch-wide: the same iteration count."""
    import torch
    from repro_torch.core.estep import CSRTokenBatch, estep_csr_ref, \
        get_backend
    from repro_torch.core.math import exp_dirichlet_expectation
    from repro_torch.core.types import LDAConfig, init_global_state
    from repro_torch.data.stream import CorpusDocStream
    from repro_torch.kernels import lda_estep

    cfg = LDAConfig(num_topics=topics, vocab_size=spec.vocab_size,
                    estep_max_iters=ESTEP_ITERS, estep_backend="cuda")
    gen = torch.Generator(device=device).manual_seed(1)
    eb = exp_dirichlet_expectation(
        init_global_state(cfg, device=device, generator=gen).lam, axis=0)
    cb = first_csr_batch(CorpusDocStream(test, spec.vocab_size), batch)
    tok = CSRTokenBatch(*flat_tensors(cb, device))
    n = cb.num_docs
    backend = get_backend("cuda")
    backend.solve_tokens(cfg, eb, tok, n)                 # warm-up
    lda_estep.reset_launches()
    sync()
    t0 = time.perf_counter()
    got = backend.solve_tokens(cfg, eb, tok, n)
    sync()
    seconds = time.perf_counter() - t0
    launches = dict(lda_estep.LAUNCHES)
    want = estep_csr_ref(cfg, eb, *tok, n)
    errs = {"gamma": float((got.gamma - want.gamma).abs().max()),
            "pi": float((got.pi - want.pi).abs().max()),
            "sstats": float((got.sstats - want.sstats).abs().max())}
    check(int(got.iters) == int(want.iters),
          f"serve_csr: {int(got.iters)} iterations vs the reference's "
          f"{int(want.iters)}")
    check(torch.allclose(got.gamma, want.gamma, rtol=2e-3, atol=2e-3),
          f"serve_csr: γ off the flat reference by {errs['gamma']}")
    check(torch.allclose(got.pi, want.pi, rtol=2e-3, atol=1e-4),
          f"serve_csr: π off by {errs['pi']}")
    check(torch.allclose(got.sstats, want.sstats, rtol=1e-2, atol=2e-3),
          f"serve_csr: sstats off by {errs['sstats']}")
    check(all(launches[n] == 1 for n in CSR_KERNELS)
          and sum(launches.values()) == 2, f"serve_csr: {launches}")
    emit({"phase": "serve_csr", "docs": n, "live_tokens": cb.live_tokens,
          "seconds": seconds, "docs_per_s": n / seconds,
          "launches": launches, "max_abs_err_vs_csr_ref": errs,
          "iters": int(got.iters)})


def phase_train_csr(device, spec, train, test, topics, batch, sync):
    """Two IVI epochs through LDAEngine over a CorpusDocStream in the CSR
    layout, on the CUDA backend."""
    import numpy as np
    import torch
    from repro_torch.core.engines import LDAEngine
    from repro_torch.core.types import LDAConfig
    from repro_torch.data.stream import CorpusDocStream
    from repro_torch.kernels import lda_estep

    cfg = LDAConfig(num_topics=topics, vocab_size=spec.vocab_size,
                    estep_max_iters=ESTEP_ITERS, estep_backend="cuda")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    eng = LDAEngine(cfg, CorpusDocStream(train, spec.vocab_size), algo="ivi",
                    batch_size=batch, seed=0, test_corpus=test,
                    device=device, layout="csr", token_budget=CSR_BUDGET)
    update_s, sweeps, lpp, elbo = [], [], [], []
    lda_estep.reset_launches()
    for epoch in (1, 2):
        while True:
            sync()
            t0 = time.perf_counter()
            stepped = eng.stream_step()
            sync()
            if not stepped:
                break
            update_s.append(time.perf_counter() - t0)
            sweeps.append(int(eng.last_iters))
            if epoch == 2:
                elbo.append(eng.full_bound())
        if epoch == 1:
            check(float(eng.state.init_frac) == 0.0, "init mass not retired")
            check(torch.allclose(eng.state.lam, cfg.beta0 + eng.state.m_vk,
                                 rtol=1e-5, atol=1e-5),
                  "λ != β₀ + ⟨m_vk⟩ after the covering pass")
            elbo.append(eng.full_bound())    # the bound epoch 2 starts from
        lpp.append(eng.evaluate()["lpp"])
    launches = dict(lda_estep.LAUNCHES)
    updates = len(update_s)
    check(all(launches[n] == updates for n in CSR_KERNELS)
          and sum(launches.values()) == 2 * updates,
          f"train_csr: not 2 launches an update over {updates}: {launches}")
    drops = [(a, b_) for a, b_ in zip(elbo, elbo[1:])
             if b_ < a - max(5e-3, 2e-6 * abs(a))]
    check(not drops, f"memoized ELBO decreased in epoch 2: {drops}")
    check(all(np.isfinite(lpp)) and bool(torch.isfinite(eng.state.lam).all()),
          "non-finite LPP or λ")
    gap = memo_invariant_gap(eng, train, topics, device)
    ms = [s * 1e3 for s in update_s]
    pad = eng.stream_padding_stats()
    out = {"phase": "train_csr", "algo": "ivi", "backend": "cuda",
           "layout": "csr", "token_budget": CSR_BUDGET,
           "docs": eng.num_docs, "batch": batch, "epochs": 2,
           "updates": len(ms), "median_ms_per_update": float(np.median(ms)),
           "docs_per_s": eng.docs_seen / sum(update_s),
           "tokens_per_s": 2 * float(train.num_words) / sum(update_s),
           "pad_frac": pad["pad_frac"], "live_slots": pad["live_slots"],
           "padded_slots": pad["padded_slots"], "sweeps_per_update": sweeps,
           "launches": launches, "lpp": lpp, "elbo_epoch2": elbo,
           "memo_invariant_gap": gap,
           "memo_bytes": eng.memo.footprint_bytes()}
    if device.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    emit(out)
    return launches, eng, out


def phase_fixed_point_csr_warm(eng, kernels, timer):
    """K4 against its twin as CSR training runs it: λ after two epochs and
    γ₀ warm-started from the memo's π on the first flat batch of a fresh
    pass. Fails if the batch ran to the sweep cap."""
    import numpy as np
    from repro_torch.core.engines import _csr_gather_flat
    from repro_torch.core.estep import CSRTokenBatch, warm_start_gamma_flat
    from repro_torch.core.math import exp_dirichlet_expectation
    from repro_torch.kernels import lda_estep

    cfg = eng.cfg
    cb = first_csr_batch(eng.stream, eng.batch_size, eng.stream.max_unique)
    width = eng._packer.width_for(int(cb.doc_lengths.max()))
    rows = np.concatenate([cb.rows, np.zeros(eng.batch_size - cb.num_docs,
                                              np.int64)])
    old_pi, visited = eng.memo.gather(rows, width=width)
    check(bool(visited.all()), "warm K4 check: a document not visited")
    tok = CSRTokenBatch(*flat_tensors(cb, eng.device))
    ix = eng._to_device(eng._csr_flat_index(cb, width))
    gamma0 = warm_start_gamma_flat(cfg, tok, _csr_gather_flat(old_pi, ix),
                                   visited).contiguous()
    eb = exp_dirichlet_expectation(eng.state.lam, axis=0).contiguous()
    args = (*tok, eb, gamma0, cfg.alpha0, cfg.estep_tol, cfg.estep_max_iters)
    res = check_fixed_point_csr(args, "warm γ₀")
    res.pop("_etheta"), res.pop("_etheta_plain")
    check(res["sweeps"] < cfg.estep_max_iters,
          f"warm K4 check: the batch ran to the cap ({res['sweeps']} "
          "sweeps), so the stopping rule was not exercised")
    res.update(check_fused_pi(
        lambda q: lda_estep.estep_fixed_point_csr_pi(*args, quantize=q),
        lambda: lda_estep.estep_fixed_point_csr(*args),
        lambda e, q: lda_estep.token_pi_csr(*tok, eb, e, quantize=q),
        "warm fixed_point_csr"))
    res["ms"] = timer(lambda: lda_estep.estep_fixed_point_csr_pi(*args), 10)
    res["ms_without_pi"] = timer(
        lambda: lda_estep.estep_fixed_point_csr(*args), 10)
    res["kernel_ms"] = kernel_ms(
        lambda: lda_estep.estep_fixed_point_csr_pi(*args),
        "fixed_point_kernel")
    kernels["fixed_point_csr"]["warm"] = res
    emit({"phase": "kernels_csr_warm", "fixed_point_csr": res,
          "fixed_point_csr_grid": csr_grid(
              gamma0.shape[0], cb.token_budget, gamma0.shape[1],
              res["kernel_ms"], res["sweeps"])})


# ---------------------------------------------------------------------------
# the paper's baselines, the host memo stores, length buckets, telemetry
# ---------------------------------------------------------------------------

# full-batch IVI = MVI: 782,385 × 0.00524 = 4,099 documents, one batch
FULL_BATCH_SCALE = 0.00524
# ⟨m_vk⟩ against the bf16 store's memo (tests/test_estep_backend.py:85)
CHUNKED_GAP = 2e-3
# the γ-only store's π against the dense store's right after a write
# (tests/test_estep_backend.py:111-131)
GAMMA_PI_BAR = 2e-2
# the paper's full Arxiv training set (data/synthetic.py)
ARXIV_DOCS = 782_385


def train_config(spec, topics):
    from repro_torch.core.types import LDAConfig
    return LDAConfig(num_topics=topics, vocab_size=spec.vocab_size,
                     estep_max_iters=ESTEP_ITERS, estep_backend="cuda")


def timed_epoch(eng, sync, after=None):
    """One epoch of a materialized engine's mini-batches, each update timed
    on the host clock between two syncs; ``after()`` runs after each update,
    outside the timing. Returns the ms of each update and its width."""
    ms, widths = [], []
    for rows, width in eng.epoch_batches():
        sync()
        t0 = time.perf_counter()
        eng.run_minibatch(rows, width=width)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        widths.append(width)
        if after is not None:
            after()
    return ms, widths


def timed_stream_steps(eng, sync, steps=None):
    """Stream steps of an engine, each timed as ``timed_epoch`` times an
    update, until the epoch ends (or ``steps`` steps)."""
    ms = []
    while steps is None or len(ms) < steps:
        sync()
        t0 = time.perf_counter()
        stepped = eng.stream_step()
        sync()
        if not stepped:
            break
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def check_two_launches(label, launches, updates, fixed_point):
    """The path's fixed point (K1 or K4) and K3 once an update, nothing
    else."""
    check(launches[fixed_point] == launches["segment_scatter"] == updates
          and sum(launches.values()) == 2 * updates,
          f"{label}: not 2 launches an update over {updates}: {launches}")


def median(ms):
    import numpy as np
    return float(np.median(ms))


def phase_train_mvi(device, spec, train, test, topics, batch, sync):
    """MVI (batch coordinate ascent) through LDAEngine, two epochs of 17
    E-step batches (the tail padded with sentinel-row documents): K1 and K3
    once a batch, λ − β₀ = Σ sstats carrying the corpus's word mass, LPP
    above its start, the collapsed bound finite. Then full-batch IVI = MVI
    on 4,099 documents (batch = D) over 3 epochs, under K1's per-tile stop
    and under the gather E-step's batch-wide stop."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core.engines import LDAEngine
    from repro_torch.data.synthetic import make_corpus
    from repro_torch.kernels import lda_estep

    cfg = train_config(spec, topics)
    eng = LDAEngine(cfg, train, algo="mvi", batch_size=batch, seed=0,
                    test_corpus=test, device=device)
    words = float(train.num_words)
    n_batches = -(-eng.num_docs // batch)
    lpp = [eng.evaluate()["lpp"]]
    epochs = []
    for epoch in (1, 2):
        lda_estep.reset_launches()
        sync()
        t0 = time.perf_counter()
        eng.run_epoch()
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(lda_estep.LAUNCHES)
        check_two_launches(f"train_mvi epoch {epoch}", launches, n_batches,
                           "fixed_point")
        mass = float((eng.state.lam.double() - cfg.beta0).sum())
        check(abs(mass - words) <= 1e-5 * words,
              f"train_mvi: λ − β₀ holds {mass} words, the corpus {words}")
        lpp.append(eng.evaluate()["lpp"])
        bound = eng.full_bound()
        check(bool(np.isfinite(bound)), f"train_mvi: bound {bound}")
        epochs.append({"ms": ms, "ms_per_batch": ms / n_batches,
                       "launches": launches, "mass_rel_err":
                           abs(mass - words) / words,
                       "collapsed_bound": bound})
    check(all(np.isfinite(lpp)) and min(lpp[1:]) > lpp[0],
          f"train_mvi: LPP {lpp} not above its start")
    # the tail batch's phantom documents write α₀ + Σ 0·π into row D
    sentinel = cfg.alpha0 + (0.0 if eng.num_docs % batch else 1.0)
    check(bool(torch.all(eng._gamma_buf[-1] == sentinel)),
          f"train_mvi: the sentinel row is not {sentinel}")

    small = make_corpus(spec, split="train", seed=0, scale=FULL_BATCH_SCALE,
                        device=device)
    small_test = make_corpus(spec, split="test", seed=0,
                             scale=FULL_BATCH_SCALE, device=device)
    full = {backend: full_batch_ivi_vs_mvi(
        dataclasses.replace(cfg, estep_backend=backend), small, small_test,
        device) for backend in ("cuda", "gather")}
    emit({"phase": "train_mvi", "algo": "mvi", "backend": "cuda",
          "docs": eng.num_docs, "batch": batch, "batches_per_epoch":
              n_batches, "tail_docs": eng.num_docs % batch,
          "epochs": epochs, "lpp_start_then_epochs": lpp,
          "full_batch": full})


def full_batch_ivi_vs_mvi(cfg, train, test, device):
    """IVI with batch = D against MVI over three epochs, from one λ₀: the
    strongest check of the incremental bookkeeping (repro's
    test_fullbatch_ivi_equals_mvi). The first epoch runs the same E-step
    from the same start in both, so λ agrees to rounding. After it the
    E-steps start from λs that differ by rounding (⟨m_vk⟩ = S₁ + (S₂ − S₁)
    is not S₂ in fp32). Under the batch-wide stop (``gather``) λ stays
    within rtol 1e-3 entry by entry; under K1's per-tile stop (``cuda``,
    the Pallas kernel's rule) a tile can stop one sweep apart, which moves
    single entries of λ (a rare word's λ is β₀ plus a few tokens' π) by
    percents, so λ is held as a whole there (relative L1 1e-3). LPP within
    5e-3 on both, repro's bar."""
    import numpy as np
    from repro_torch.core.engines import LDAEngine
    from repro_torch.kernels import lda_estep

    d = train.num_docs
    mvi, ivi = (LDAEngine(cfg, train, algo=algo, batch_size=d, seed=0,
                          test_corpus=test, device=device)
                for algo in ("mvi", "ivi"))
    lda_estep.reset_launches()
    lam_err = []
    for _ in range(3):
        mvi.run_epoch()
        ivi.run_minibatch(rows=np.arange(d))
        diff = (ivi.state.lam - mvi.state.lam).double().abs()
        lam_err.append({"max_rel": float((diff / mvi.state.lam).max()),
                        "rel_l1": float(diff.sum()
                                        / mvi.state.lam.double().sum()),
                        "entries_over_1e-3": int(
                            (diff > 1e-3 * mvi.state.lam).sum())})
    launches = dict(lda_estep.LAUNCHES)
    label = f"full batch ({cfg.estep_backend})"
    if cfg.estep_backend == "cuda":
        check_two_launches(label, launches, 6, "fixed_point")
        check(lam_err[0]["max_rel"] < 1e-5 and lam_err[-1]["rel_l1"] < 1e-3,
              f"{label}: IVI λ off MVI's: {lam_err}")
    else:
        check(sum(launches.values()) == 0, f"{label}: {launches}")
        check(lam_err[-1]["max_rel"] < 1e-3,
              f"{label}: IVI λ off MVI's: {lam_err}")
    lm, li = mvi.evaluate()["lpp"], ivi.evaluate()["lpp"]
    check(abs(lm - li) < 5e-3, f"{label}: IVI LPP {li} vs MVI {lm}")
    return {"docs": d, "epochs": 3, "launches": launches, "lpp_mvi": lm,
            "lpp_ivi": li, "lam_err_by_epoch": lam_err}


def phase_train_svi(device, spec, train, test, topics, batch, sync, layout,
                    ivi):
    """SVI (eq. 3) through LDAEngine, two epochs, padded (K1 then K3) or on
    the CSR stream (K4 then K3). The first update's λ is held to the same
    update through the plain path: the gather E-step tile by tile (K1 stops
    each 128-document tile) or the plain flat reference (K4 stops
    batch-wide), at the sstats bar of phases 4 and 9 carried through the
    update (rtol 1e-2, atol 2e-3·ρ·D/B)."""
    import numpy as np
    import torch
    from repro_torch.core.engines import LDAEngine, _svi_global_update
    from repro_torch.core.estep import BowBatch, estep_csr_ref, get_backend
    from repro_torch.core.math import exp_dirichlet_expectation
    from repro_torch.core.types import DEFAULT_KERNEL_POLICY, init_global_state
    from repro_torch.data.stream import CorpusDocStream
    from repro_torch.kernels import lda_estep

    cfg = train_config(spec, topics)
    csr = layout == "csr"
    corpus = CorpusDocStream(train, spec.vocab_size) if csr else train
    eng = LDAEngine(cfg, corpus, algo="svi", batch_size=batch, seed=0,
                    test_corpus=test, device=device, layout=layout,
                    token_budget=CSR_BUDGET if csr else None)
    lam0 = eng.state.lam.clone()
    eb = exp_dirichlet_expectation(lam0, axis=0)
    lda_estep.reset_launches()
    if csr:
        cb = first_csr_batch(corpus, batch, corpus.max_unique)
        ms = timed_stream_steps(eng, sync, steps=1)
        plain = estep_csr_ref(cfg, eb, *flat_tensors(cb, device),
                              num_docs=batch)
        check(int(eng.last_iters) == int(plain.iters),
              f"train_svi_csr: {int(eng.last_iters)} sweeps, the plain "
              f"reference {int(plain.iters)}")
        sstats, b_real = plain.sstats, cb.num_docs
    else:
        batches = eng.epoch_batches()
        rows = batches[0][0]
        sync()
        t0 = time.perf_counter()
        eng.run_minibatch(rows)
        sync()
        ms = [(time.perf_counter() - t0) * 1e3]
        idx = torch.as_tensor(rows, device=device)
        ids, cnts = train.token_ids[idx], train.counts[idx]
        tile = DEFAULT_KERNEL_POLICY.block_b
        sstats = sum(get_backend("gather").solve(
            cfg, eb, BowBatch(ids[i:i + tile], cnts[i:i + tile])).sstats
            for i in range(0, len(rows), tile))
        b_real = len(rows)
    scale = eng.num_docs / b_real
    want = _svi_global_update(cfg, init_global_state(cfg, device=device,
                                                     lam0=lam0),
                              sstats, scale).lam
    atol = 2e-3 * scale * float(cfg.rho(1))
    err = float((eng.state.lam - want).abs().max())
    check(torch.allclose(eng.state.lam, want, rtol=1e-2, atol=atol),
          f"train_svi ({layout}): first update's λ off the plain path by "
          f"{err}")
    lpp = []
    for epoch in (1, 2):
        if csr:
            ms += timed_stream_steps(eng, sync)
        else:
            for rows, width in (batches[1:] if epoch == 1
                                else eng.epoch_batches()):
                sync()
                t0 = time.perf_counter()
                eng.run_minibatch(rows, width=width)
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
        lpp.append(eng.evaluate()["lpp"])
    launches = dict(lda_estep.LAUNCHES)
    check_two_launches(f"train_svi ({layout})", launches, len(ms),
                       "fixed_point_csr" if csr else "fixed_point")
    check(eng.docs_seen == 2 * eng.num_docs, f"train_svi: {eng.docs_seen}")
    check(all(np.isfinite(lpp)) and bool(torch.isfinite(eng.state.lam).all()),
          "train_svi: non-finite LPP or λ")
    emit({"phase": "train_svi_csr" if csr else "train_svi", "algo": "svi",
          "backend": "cuda", "layout": layout, "docs": eng.num_docs,
          "batch": batch, "epochs": 2, "updates": len(ms),
          "median_ms_per_update": median(ms),
          "ivi_median_ms_per_update": ivi["median_ms_per_update"],
          "launches": launches, "lpp": lpp,
          "first_update_lam_max_abs_err_vs_plain": err,
          "tol": f"rtol 1e-2, atol {atol}"})


def allocated_by(make):
    """(what ``make()`` returns, the device bytes it left allocated)."""
    import torch
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    obj = make()
    torch.cuda.synchronize()
    return obj, torch.cuda.memory_allocated() - before


def phase_train_chunked(device, spec, train, test, topics, batch, sync,
                        dense):
    """IVI with the bf16 host-chunked memo store, two padded epochs from
    phase 5's λ₀ and seed: no memo bytes on the device, the memo
    invariant, the memoized ELBO over epoch 2, LPP beside phase 5's,
    gather returning what update wrote, and the footprints."""
    import numpy as np
    import torch
    from repro_torch.core.engines import LDAEngine
    from repro_torch.core.memo import make_memo_store, memo_footprint_bytes
    from repro_torch.kernels import lda_estep

    cfg = train_config(spec, topics)
    d, l = train.num_docs, train.max_unique

    def engine(store):
        return LDAEngine(cfg, train, algo="ivi", batch_size=batch, seed=0,
                         test_corpus=test, device=device, memo_store=store)

    probe, dense_bytes = allocated_by(lambda: engine("dense"))
    del probe
    eng, chunked_bytes = allocated_by(lambda: engine("chunked"))
    _, store_bytes = allocated_by(lambda: make_memo_store(
        "chunked", cfg, d, l, device=device))
    drop = dense_bytes - chunked_bytes
    check(store_bytes == 0, f"chunked store holds {store_bytes} device bytes")
    check(drop >= d * l * topics * 4,
          f"chunked engine saves {drop} device bytes, the dense memo is "
          f"{d * l * topics * 4}")
    host_bytes = eng.memo.footprint_bytes()
    check(host_bytes == memo_footprint_bytes("chunked", d, l, topics)
          == d * l * topics * 2 + d, f"chunked footprint {host_bytes}")
    lda_estep.reset_launches()
    ms, _ = timed_epoch(eng, sync)
    check(float(eng.state.init_frac) == 0.0, "init mass not retired")
    lpp = [eng.evaluate()["lpp"]]
    elbo = [eng.full_bound()]
    ms2, _ = timed_epoch(eng, sync,
                         after=lambda: elbo.append(eng.full_bound()))
    ms += ms2
    lpp.append(eng.evaluate()["lpp"])
    launches = dict(lda_estep.LAUNCHES)
    check_two_launches("train_chunked", launches, len(ms), "fixed_point")
    drops = [(a, b_) for a, b_ in zip(elbo, elbo[1:])
             if b_ < a - max(5e-3, 2e-6 * abs(a))]
    check(not drops, f"train_chunked: memoized ELBO decreased: {drops}")
    lpp_gap = max(abs(a - b_) for a, b_ in zip(lpp, dense["lpp"]))
    check(lpp_gap < 0.01, f"train_chunked: LPP {lpp} vs dense {dense['lpp']}")
    gap = memo_invariant_gap(eng, train, topics, device)
    check(gap < CHUNKED_GAP, f"train_chunked: memo invariant gap {gap}")
    # one more update with update() spied on: gather returns its bf16 bits
    store, written = eng.memo, {}
    real_update = store.update

    def spy(doc_idx, pi, **kw):
        written["pi"] = pi.to(torch.bfloat16)
        return real_update(doc_idx, pi, **kw)

    rows = eng.epoch_batches()[0][0]
    store.update = spy
    try:
        eng.run_minibatch(rows)
    finally:
        del store.update
    got, visited = eng.memo.gather(rows)
    check(bool(visited.all()) and torch.equal(got, written["pi"].float()),
          "train_chunked: gather does not return the bf16 of what update "
          "wrote")
    full = {kind: memo_footprint_bytes(kind, ARXIV_DOCS, l, topics,
                                       vocab_size=spec.vocab_size)
            for kind in ("dense", "chunked", "gamma")}
    emit({"phase": "train_chunked", "algo": "ivi", "memo_store": "chunked",
          "chunk_docs": eng.memo.chunk_docs, "docs": d, "batch": batch,
          "epochs": 2, "updates": len(ms),
          "median_ms_per_update": median(ms),
          "dense_median_ms_per_update": dense["median_ms_per_update"],
          "launches": launches, "lpp": lpp, "dense_lpp": dense["lpp"],
          "elbo_epoch2": elbo, "memo_invariant_gap": gap,
          "gather_bit_equal_to_update": True,
          "device_bytes": {"dense_engine": dense_bytes,
                           "chunked_engine": chunked_bytes,
                           "saved": drop, "chunked_store": store_bytes},
          "host_memo_bytes": host_bytes,
          "full_arxiv_footprint_bytes": full})


def phase_train_gamma(device, spec, train, test, topics, batch, sync, dense):
    """S-IVI with the γ-only store, two epochs (K1 and K3 once an update):
    LPP finite and above its start, the footprint of γ plus three bf16 Eφ
    snapshots; then, right after one write with chunk_docs = D, the
    reconstructed π against the dense store's."""
    import numpy as np
    import torch
    from repro_torch.core.engines import LDAEngine
    from repro_torch.core.memo import memo_footprint_bytes
    from repro_torch.kernels import lda_estep

    cfg = train_config(spec, topics)
    d, l = train.num_docs, train.max_unique
    eng = LDAEngine(cfg, train, algo="sivi", batch_size=batch, seed=0,
                    test_corpus=test, device=device, memo_store="gamma")
    lpp = [eng.evaluate()["lpp"]]
    lda_estep.reset_launches()
    ms = []
    for _ in (1, 2):
        ms += timed_epoch(eng, sync)[0]
        lpp.append(eng.evaluate()["lpp"])
    launches = dict(lda_estep.LAUNCHES)
    check_two_launches("train_gamma", launches, len(ms), "fixed_point")
    check(all(np.isfinite(lpp)) and min(lpp[1:]) > lpp[0],
          f"train_gamma: LPP {lpp} not above its start")
    footprint = eng.memo.footprint_bytes()
    want = memo_footprint_bytes("gamma", d, l, topics,
                                vocab_size=spec.vocab_size)
    check(footprint == want, f"train_gamma: footprint {footprint} != {want}")
    del eng

    def one_write(store):
        e = LDAEngine(cfg, train, algo="sivi", batch_size=batch, seed=1,
                      device=device, memo_store=store, chunk_docs=d)
        e.run_minibatch(rows)
        return e.memo.gather(rows)

    rows = np.arange(batch)
    pi_g, vis_g = one_write("gamma")
    pi_d, vis_d = one_write("dense")
    err = float((pi_g - pi_d).abs().max())
    check(torch.equal(vis_g, vis_d) and torch.allclose(
        pi_g, pi_d, rtol=GAMMA_PI_BAR, atol=GAMMA_PI_BAR),
        f"train_gamma: reconstructed π off the dense store's by {err}")
    emit({"phase": "train_gamma", "algo": "sivi", "memo_store": "gamma",
          "docs": d, "batch": batch, "epochs": 2, "updates": len(ms),
          "median_ms_per_update": median(ms),
          "dense_ivi_median_ms_per_update": dense["median_ms_per_update"],
          "launches": launches, "lpp_start_then_epochs": lpp,
          "footprint_bytes": footprint,
          "reconstructed_pi_max_abs_err_vs_dense": err,
          "tol": f"rtol = atol = {GAMMA_PI_BAR}"})


def phase_train_bucketed(device, spec, train, test, topics, batch, sync,
                         dense):
    """IVI with length buckets, one epoch: every document once, each batch
    at its bucket's width (no row live past it), K1 and K3 once an
    update."""
    import numpy as np
    import torch
    from repro_torch.core.engines import LDAEngine
    from repro_torch.data.stream import _last_live
    from repro_torch.kernels import lda_estep

    cfg = train_config(spec, topics)
    eng = LDAEngine(cfg, train, algo="ivi", batch_size=batch, seed=0,
                    test_corpus=test, device=device, bucket_by_length=True)
    last = _last_live(train.counts.cpu().numpy())
    seen = np.zeros(eng.num_docs, np.int64)
    stats = eng.bucket_stats
    bucket_widths = {b["width"] for b in stats["per_bucket"]}
    lda_estep.reset_launches()
    ms = []
    for rows, width in eng.epoch_batches():
        check(width in bucket_widths and len(rows) <= batch
              and int(last[rows].max()) <= width,
              f"train_bucketed: a batch of {len(rows)} at width {width}")
        seen[rows] += 1
        sync()
        t0 = time.perf_counter()
        eng.run_minibatch(rows, width=width)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(lda_estep.LAUNCHES)
    check_two_launches("train_bucketed", launches, len(ms), "fixed_point")
    check(bool((seen == 1).all()) and eng.docs_seen == eng.num_docs
          and bool(eng.memo.visited.all()),
          "train_bucketed: not every document visited once")
    check(float(eng.state.init_frac) == 0.0
          and torch.allclose(eng.state.lam, cfg.beta0 + eng.state.m_vk,
                             rtol=1e-5, atol=1e-5),
          "train_bucketed: λ != β₀ + ⟨m_vk⟩ after the covering pass")
    lpp = eng.evaluate()["lpp"]
    check(bool(np.isfinite(lpp)), f"train_bucketed: LPP {lpp}")
    emit({"phase": "train_bucketed", "algo": "ivi", "docs": eng.num_docs,
          "batch": batch, "epochs": 1, "updates": len(ms),
          "median_ms_per_update": median(ms),
          "dense_ivi_median_ms_per_update": dense["median_ms_per_update"],
          "slot_ratio": stats["slot_ratio"],
          "per_bucket": stats["per_bucket"], "launches": launches,
          "lpp": lpp})


def parent_update(eng, rows):
    """A padded IVI update as the parent tree's engine ran it, with no
    telemetry hooks (``run_minibatch`` then ``_update_batch`` of PR 16):
    the index copy, the memo gather, ``incremental_update``, the memo
    write."""
    import numpy as np
    import torch
    from repro_torch.core.engines import incremental_update
    idx = torch.as_tensor(np.asarray(rows), dtype=torch.int64,
                          device=eng.device)
    ids, cnts = eng.corpus.token_ids[idx], eng.corpus.counts[idx]
    old_pi, visited = eng.memo.gather(rows, width=ids.shape[1])
    eng.state, res, _ = incremental_update(
        eng.cfg, eng.algo == "sivi", eng.state, ids, cnts, old_pi, visited,
        eng.num_words_total, eng.memo.pi_wire_dtype)
    eng.last_iters = res.iters
    eng.memo = eng.memo.update(rows, res.pi)
    eng.docs_seen += len(rows)


def span_ms_per_update(tel):
    """Each span's total over the run, per ``train/update``, in ms."""
    from repro_torch.obs import spans_by_name
    agg = spans_by_name(tel.trace.records)
    n = agg["train/update"]["count"]
    return {name: a["total_s"] * 1e3 / n for name, a in agg.items()}


def phase_telemetry(device, spec, train, topics, batch, sync):
    """Telemetry on the card, each layout: engines with a live bundle (spans
    that wait for the card) beside engines without one, on the same
    updates. The spans split an update's time; the bits of λ do not depend
    on the bundle; the disabled update's host syncs are no more than the
    parent's update sequence's; an armed raise-policy watchdog checking
    every update sees no violation."""
    import numpy as np
    import torch
    from repro_torch.core.engines import LDAEngine
    from repro_torch.data.stream import CorpusDocStream
    from repro_torch.obs import ElboWatchdog, SpanRecorder, Telemetry

    cfg = train_config(spec, topics)
    out = {"phase": "telemetry"}

    def bundle():
        return Telemetry(trace=SpanRecorder(device_sync=True),
                         watchdog=ElboWatchdog(check_every=1,
                                               policy="raise"))

    # padded: one covering pass (the watchdog arms at its last update), then
    # two armed updates
    tel = bundle()
    on, off = (LDAEngine(cfg, train, algo="ivi", batch_size=batch, seed=0,
                         device=device, telemetry=t) for t in (tel, None))
    for eng in (on, off):
        eng.run_epoch()
        for rows, _ in eng.epoch_batches()[:2]:
            eng.run_minibatch(rows)
    check(torch.equal(on.state.lam, off.state.lam)
          and torch.equal(on.state.m_vk, off.state.m_vk),
          "telemetry: λ with the bundle differs from λ without it")
    status = tel.watchdog.status()
    check(status["ok"] and status["armed_checks"] >= 2,
          f"telemetry: watchdog {status}")
    rows = off.epoch_batches()
    syncs = host_syncs(lambda: off.run_minibatch(rows[0][0]))
    parent_syncs = host_syncs(lambda: parent_update(off, rows[1][0]))
    check(syncs <= parent_syncs,
          f"telemetry: the disabled update syncs {syncs} times, the parent "
          f"sequence {parent_syncs}")
    out["padded"] = {"updates": on._updates,
                     "span_ms_per_update": span_ms_per_update(tel),
                     "watchdog": status, "bit_equal_off_on": True,
                     "host_syncs_disabled_update": syncs,
                     "host_syncs_parent_update": parent_syncs,
                     "counters": {n: tel.metrics.total(n) for n in (
                         "train.docs", "train.batches", "train.tokens")}}
    del on, off

    # CSR: one epoch of stream steps; packing is the step's time outside
    # its train/update span (no per-update watchdog here: its bound read
    # would run inside the step)
    tel = Telemetry(trace=SpanRecorder(device_sync=True))
    stream = CorpusDocStream(train, spec.vocab_size)
    on, off = (LDAEngine(cfg, stream, algo="ivi", batch_size=batch, seed=0,
                         device=device, telemetry=t, layout="csr",
                         token_budget=CSR_BUDGET) for t in (tel, None))
    step_ms = timed_stream_steps(on, sync)
    timed_stream_steps(off, sync)
    check(torch.equal(on.state.lam, off.state.lam),
          "telemetry: CSR λ with the bundle differs from λ without it")
    spans = span_ms_per_update(tel)
    out["csr"] = {"updates": len(step_ms), "span_ms_per_update": spans,
                  "step_ms_mean": float(np.mean(step_ms)),
                  "step_ms_median": median(step_ms),
                  "pack_ms_per_update": float(np.mean(step_ms))
                  - spans["train/update"],
                  "unspanned_ms_per_update": spans["train/update"] - sum(
                      spans[n] for n in ("train/memo_gather", "train/solve",
                                         "train/memo_update")),
                  "host_syncs_disabled_step": host_syncs(off.stream_step),
                  "bit_equal_off_on": True}
    emit(out)


# ---------------------------------------------------------------------------
# the pre-fusion baseline (K6, K7, K8) and attention (K9)
# ---------------------------------------------------------------------------

def dense_bound(b, v, k):
    """K6's or K7's bound on (B, V) counts and K topics: C, Eθ and Eφ read
    once, one (B, K) or (V, K) output; two products of 2·B·V·K operations
    plus the ε add and the division per (b, v)."""
    nbytes = (b * v + b * k + v * k + max(b, v) * k) * 4
    return bound_ms(nbytes, 4.0 * b * v * k + 2.0 * b * v)


def check_corrections(legacy, fused, label):
    """The legacy correction against the fused one, at the correction bar
    of tests/test_estep_backend.py (rtol = atol = 2e-3)."""
    import torch
    err = float((legacy - fused).abs().max())
    check(torch.allclose(legacy, fused, rtol=2e-3, atol=2e-3),
          f"legacy ({label}): correction off the fused one by {err}")
    return err


def legacy_correction(cfg, eb, ids, cnts, old_pi, **blocks):
    """The pre-fusion correction as benchmarks/kernel_bench.py:207-213
    builds it: the per-sweep E-step, then scatter of cnt·(π − old π)."""
    from repro_torch.core.estep import scatter_sstats
    from repro_torch.kernels import ops
    res = ops.estep_cuda_sweeps(cfg, eb, ids, cnts, **blocks)
    delta = cnts[:, :, None] * (res.pi - old_pi)
    return scatter_sstats(ids, delta, eb.shape[0]), res


def fused_correction(cfg, eb, ids, cnts, old_pi, visited):
    from repro_torch.kernels import ops
    corr, _, res = ops.memo_correction_cuda(cfg, eb, ids, cnts, old_pi,
                                            visited)
    return corr, res


def phase_legacy(device, spec, train, topics, batch, timer):
    """The pre-fusion baseline on phase 3's documents, λ and γ₀ (the first
    ``batch`` Arxiv-shaped documents, 60 sweeps from cold): K6 and K7 (on a
    seeded γ) and K8 against their twins and timed; the per-sweep E-step (K6 per sweep, K7
    once), then K8 on its Eθ, as one driven path with its launches
    counted; the legacy correction against the fused one, here and at
    BENCH_estep's shape."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.core.estep import densify
    from repro_torch.core.math import exp_dirichlet_expectation
    from repro_torch.core.types import LDAConfig, init_global_state
    from repro_torch.kernels import lda_estep, ops

    cfg = LDAConfig(num_topics=topics, vocab_size=spec.vocab_size,
                    estep_max_iters=ESTEP_ITERS)
    gen = torch.Generator(device=device).manual_seed(0)
    lam = init_global_state(cfg, device=device, generator=gen).lam
    eb = exp_dirichlet_expectation(lam, axis=0).contiguous()
    ids = train.token_ids[:batch].contiguous()
    cnts = train.counts[:batch].contiguous()
    b, l = ids.shape
    k, v = topics, spec.vocab_size
    live = int((cnts != 0).sum())
    out = {}

    # K6 and K7 on the padded inputs, with a seeded γ that differs by row
    # and topic, so that Eθ does too and a mis-indexed Eθ shows -----------
    cpad, ebpad, _ = ops.pad_inputs(densify(ids, cnts, v), eb, 128, 512)
    (bp, vp), kp = cpad.shape, ebpad.shape[1]
    gamma0 = torch.full((b, k), cfg.alpha0 + 1.0, device=device)
    g_rand = cfg.alpha0 + 0.1 + 20.0 * torch.rand(
        (b, k), generator=gen, device=device)
    gpad = F.pad(g_rand, (0, kp - k, 0, bp - b), value=cfg.alpha0)
    et0 = ops.padded_exp_elog_theta(gpad, k)
    for name, kern, plain, args in (
            ("sweep", lda_estep.estep_sweep, lda_estep.estep_sweep_plain,
             (cpad, et0, ebpad, cfg.alpha0)),
            ("sstats", lda_estep.sstats, lda_estep.sstats_plain,
             (cpad, et0, ebpad))):
        got, again, want = kern(*args), kern(*args), plain(*args)
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=2e-5, atol=2e-5),
              f"{name}: off its twin by {err}")
        check(torch.equal(got, again), f"{name}: two launches differ")
        bms, by = dense_bound(bp, vp, kp)
        out[name] = {
            "max_abs_err": err, "tol": "rtol=atol=2e-5 (fp32 twin, no TF32)",
            "deterministic": True,
            "ms": timer(lambda: kern(*args), 10),
            "plain_ms": timer(lambda: plain(*args), 10),
            "bound_ms": bms, "bound_by": by, "library_ms": None}

    # the driven path: the per-sweep E-step, then K8 on its Eθ -------------
    old_pi = lda_estep.token_pi(ids, cnts, eb,
                                exp_dirichlet_expectation(gamma0))
    ebt = eb[ids.long()].contiguous()
    lda_estep.reset_launches()
    ops.HOST_SYNCS["estep_cuda_sweeps"] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ops.estep_cuda_sweeps(cfg, eb, ids, cnts, gamma0)
    et = exp_dirichlet_expectation(res.gamma).contiguous()
    onehot = lda_estep.memo_delta_onehot(ids, cnts, ebt, et, v,
                                         old_pi=old_pi)
    torch.cuda.synchronize()
    path_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(lda_estep.LAUNCHES)
    syncs = ops.HOST_SYNCS["estep_cuda_sweeps"]
    sweeps = int(res.iters)
    check(all(launches[n] > 0 for n in LEGACY_KERNELS),
          f"legacy: a kernel of the path never launched: {launches}")
    check(launches["sweep"] == sweeps and launches["sstats"] == 1,
          f"legacy: {launches} for {sweeps} sweeps")
    twin = ops.estep_sweeps(cfg, eb, ids, cnts, gamma0, block_b=128,
                            block_v=512, sweep=lda_estep.estep_sweep_plain,
                            sstats=lda_estep.sstats_plain)
    check(sweeps == int(twin.iters),
          f"legacy: {sweeps} sweeps vs the twin path's {int(twin.iters)}")
    gerr = float((res.gamma - twin.gamma).abs().max())
    check(torch.allclose(res.gamma, twin.gamma, rtol=2e-3, atol=2e-3),
          f"legacy: γ off the twin path by {gerr}")
    serr = float((res.sstats - twin.sstats).abs().max())
    check(torch.allclose(res.sstats, twin.sstats, rtol=1e-2, atol=2e-3),
          f"legacy: sstats off the twin path by {serr}")
    check(bool(torch.isfinite(res.gamma).all()) and
          bool(torch.isfinite(onehot[1]).all()), "legacy: non-finite output")
    estep = {"sweeps": sweeps, "host_syncs": syncs,
             "launches": {n: launches[n] for n in LEGACY_KERNELS},
             "max_abs_err_gamma_vs_twin_path": gerr,
             "max_abs_err_sstats_vs_twin_path": serr,
             "tol": "γ rtol=atol=2e-3, sstats rtol 1e-2 atol 2e-3, the same "
                    "sweep count", "path_first_call_ms": path_ms,
             "wall_ms": wall_ms(lambda: ops.estep_cuda_sweeps(
                 cfg, eb, ids, cnts, gamma0), 3),
             "twin_path_wall_ms": wall_ms(lambda: ops.estep_sweeps(
                 cfg, eb, ids, cnts, gamma0, block_b=128, block_v=512,
                 sweep=lda_estep.estep_sweep_plain,
                 sstats=lda_estep.sstats_plain), 2)}
    for name in ("sweep", "sstats"):
        out[name]["launches_per_estep"] = launches[name]
    bms, _ = dense_bound(bp, vp, kp)
    estep["bound_ms"] = bms * (sweeps + 1)

    # the legacy correction against the fused one (cold: no memo) ---------
    zero_pi = torch.zeros((b, l, k), device=device)
    unvisited = torch.zeros(b, dtype=torch.bool, device=device)
    corr_l, _ = legacy_correction(cfg, eb, ids, cnts, zero_pi)
    corr_f, res_f = fused_correction(cfg, eb, ids, cnts, zero_pi, unvisited)
    corrections = {"arxiv": {
        "shape": {"B": b, "V": v, "K": k, "L": l, "sweeps": sweeps,
                  "fused_tile_sweeps_max": int(res_f.iters)},
        "max_abs_err": check_corrections(corr_l, corr_f, "arxiv"),
        "legacy_ms": wall_ms(lambda: legacy_correction(
            cfg, eb, ids, cnts, zero_pi), 2),
        "fused_ms": wall_ms(lambda: fused_correction(
            cfg, eb, ids, cnts, zero_pi, unvisited), 5)}}
    # ... and at BENCH_estep's shape (its ids, counts and λ, from numpy)
    be = BENCH_ESTEP
    rng = np.random.default_rng(0)
    b_ids = torch.from_numpy(rng.integers(0, be["v"], (be["b"], be["l"]))
                             .astype(np.int32)).to(device)
    b_cnts = torch.from_numpy((rng.poisson(1.5, (be["b"], be["l"])) + 1)
                              .astype(np.float32)).to(device)
    b_lam = torch.from_numpy(rng.gamma(100.0, 0.01, (be["v"], be["k"]))
                             .astype(np.float32)).to(device)
    b_eb = exp_dirichlet_expectation(b_lam, axis=0).contiguous()
    b_cfg = LDAConfig(num_topics=be["k"], vocab_size=be["v"],
                      estep_max_iters=be["iters"])
    b_old = torch.zeros((be["b"], be["l"], be["k"]), device=device)
    b_vis = torch.zeros(be["b"], dtype=torch.bool, device=device)
    b_corr_l, b_res = legacy_correction(b_cfg, b_eb, b_ids, b_cnts, b_old,
                                        block_v=be["v"])
    b_corr_f, b_res_f = fused_correction(b_cfg, b_eb, b_ids, b_cnts, b_old,
                                         b_vis)
    corrections["bench_estep"] = {
        "shape": {"B": be["b"], "V": be["v"], "K": be["k"], "L": be["l"],
                  "sweeps": int(b_res.iters),
                  "fused_tile_sweeps_max": int(b_res_f.iters)},
        "max_abs_err": check_corrections(b_corr_l, b_corr_f, "bench_estep"),
        "legacy_ms": wall_ms(lambda: legacy_correction(
            b_cfg, b_eb, b_ids, b_cnts, b_old, block_v=be["v"]), 5),
        "fused_ms": wall_ms(lambda: fused_correction(
            b_cfg, b_eb, b_ids, b_cnts, b_old, b_vis), 10)}
    for row in corrections.values():
        row["legacy_over_fused"] = row["legacy_ms"] / row["fused_ms"]

    # K8 against its twin, and against K2 + K3 ----------------------------
    pi, s_new, s_old = onehot
    want = lda_estep.memo_delta_onehot_plain(ids, cnts, ebt, et, v, old_pi)
    err = max(float((x - y).abs().max()) for x, y in zip(onehot, want))
    check(torch.allclose(pi, want[0], rtol=1e-5, atol=1e-6)
          and all(torch.allclose(x, y, rtol=1e-4, atol=1e-4)
                  for x, y in zip(onehot[1:], want[1:])),
          f"memo_delta_onehot: off its twin by {err}")
    one_q = lda_estep.memo_delta_onehot(ids, cnts, ebt, et, v, old_pi=old_pi,
                                        quantize=True)
    seg_q = lda_estep.memo_delta(ids, cnts, eb, et, v, old_pi=old_pi,
                                 quantize=True)
    check(torch.equal(one_q[0], seg_q[0]),
          "memo_delta_onehot: π is not K2's bit for bit")
    seg_err = max(float((x - y).abs().max())
                  for x, y in zip(one_q[1:], seg_q[1:]))
    check(all(torch.allclose(x, y, rtol=1e-4, atol=1e-4)
              for x, y in zip(one_q[1:], seg_q[1:])),
          f"memo_delta_onehot: S off K2 + K3 by {seg_err}")
    del one_q, seg_q, want
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lda_estep.memo_delta_onehot(ids, cnts, ebt, et, v, old_pi=old_pi)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    nb = b // lda_estep.delta_effective_block_b(b, l, k)
    vpad = -(-v // 128) * 128
    bms, by = bound_ms(b * l * 8 + 3 * b * l * k * 4 + b * k * 4
                       + 2 * v * k * 4, 4.0 * live * k + 4.0 * live * k)
    out["memo_delta_onehot"] = {
        "max_abs_err": err, "tol": "π rtol 1e-5 atol 1e-6, S rtol=atol "
        "1e-4; with quantize π equal to K2's, S within 1e-4 of K2 + K3",
        "pi_equal_to_k2": True, "max_abs_err_s_vs_k2_k3": seg_err,
        "peak_bytes_above_baseline": peak,
        "ms": timer(lambda: lda_estep.memo_delta_onehot(
            ids, cnts, ebt, et, v, old_pi=old_pi), 5),
        "plain_ms": timer(lambda: lda_estep.memo_delta_onehot_plain(
            ids, cnts, ebt, et, v, old_pi), 2, 1),
        "k2_k3_ms": timer(lambda: lda_estep.memo_delta(
            ids, cnts, eb, et, v, old_pi=old_pi), 5),
        "bound_ms": bms, "bound_by": by, "library_ms": None}
    # bounds and sizes derived from the shapes: this line only, never the
    # kernels line, which carries measured numbers and bound_ms alone
    derived = {
        "sweep_sstats_bound_ms_unpadded": dense_bound(b, v, k)[0],
        "onehot_partials": nb, "onehot_partial_bytes": 2 * nb * vpad * k * 4,
        "onehot_partials_bound_ms": 2 * 2 * nb * vpad * k * 4
        / HBM_BYTES_PER_S * 1e3}
    emit({"phase": "legacy", "shape": {"B": b, "L": l, "K": k, "V": v,
                                       "padded": [bp, vp, kp],
                                       "live_slots": live},
          "estep_cuda_sweeps": estep, "corrections": corrections,
          "kernels": out, "derived": derived})
    return out, launches


def sass_counts(library, ops=("HGMMA", "UTMALDG")):
    """How many SASS instructions of each kind the built library holds
    (``cuobjdump -sass``, beside nvcc): wgmma is HGMMA, a TMA tile load
    UTMALDG."""
    from repro_torch.kernels import build
    tool = Path(build.find_nvcc()).with_name("cuobjdump")
    lib = build.library_path(build.LIBRARIES[library][0])
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump -sass {lib}: {sass.stderr}")
    lines = sass.stdout.splitlines()
    return {op: sum(op in ln for ln in lines) for op in ops}


def phase_attention(device, timer):
    """flash_mha (K9) at Qwen2.5-3B's attention widths, bf16, causal, S =
    4096, one sequence: its launches; K9 against its twin at about two bf16
    ulps and the same bits on a second launch; its time, its bound and
    scaled_dot_product_attention's on the same inputs; the tensor-core
    (HGMMA) and TMA (UTMALDG) instructions in its library's SASS. Then fp32
    at the same shape, causal, against the twin, and fp32, not causal, S =
    1000 (padded to 1024) against mha_ref on the unpadded inputs, both at
    2e-5."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    qa = QWEN_ATTENTION
    b, s, h, kvh, hd = qa["b"], qa["s"], qa["h"], qa["kv"], qa["hd"]
    gen = torch.Generator(device=device).manual_seed(0)

    def normal(*shape, dtype):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    q = normal(b, s, h, hd, dtype=torch.bfloat16)
    k = normal(b, s, kvh, hd, dtype=torch.bfloat16)
    v = normal(b, s, kvh, hd, dtype=torch.bfloat16)
    fa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ops.flash_mha(q, k, v, causal=True)
    torch.cuda.synchronize()
    mha_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(fa.LAUNCHES)
    check(launches["flash_attention"] == 1,
          f"attention: flash_mha launched {launches}")
    check(out.shape == q.shape and out.dtype == q.dtype
          and bool(torch.isfinite(out.float()).all()),
          "attention: flash_mha output shape, dtype or values")

    def heads(x):
        return x.permute(0, 2, 1, 3).reshape(b * x.shape[2], s, hd) \
            .contiguous()

    qf, kf, vf = heads(q), heads(k), heads(v)
    got = fa.flash_attention(qf, kf, vf, causal=True)
    check(torch.equal(got, heads(out)), "attention: flash_mha is not K9")
    check(torch.equal(got, fa.flash_attention(qf, kf, vf, causal=True)),
          "flash_attention: two bf16 launches differ")
    sass = sass_counts("flash_attention")
    check(all(n > 0 for n in sass.values()),
          f"flash_attention: no wgmma or TMA instruction in the SASS: {sass}")
    want = fa.flash_attention_plain(qf, kf, vf, causal=True)
    err = float((got.float() - want.float()).abs().max())
    check(torch.allclose(got.float(), want.float(), rtol=BF16_RTOL,
                         atol=BF16_ATOL),
          f"flash_attention: off its twin by {err}")
    q4, k4, v4 = (x.view(b, x.shape[0] // b, s, hd) for x in (qf, kf, vf))

    def library():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                              enable_gqa=True)

    lib = library().reshape(b * h, s, hd).float() - want.float()
    lib_err = float(lib.abs().max())
    lib_rel = float(lib.norm() / want.float().norm())
    check(lib_rel <= LIBRARY_REL_L2,
          f"attention: SDPA off the twin by {lib_rel} relative L2")
    del lib, want
    pairs = b * h * s * (s + 1) / 2            # (query, key) pairs computed
    ops_count = 4.0 * hd * pairs               # Q·Kᵀ and P·V
    nbytes = 2 * (2 * b * s * h * hd + 2 * b * s * kvh * hd)
    bms, by = bound_ms(nbytes, ops_count, BF16_OPS_PER_S)
    row = {"max_abs_err": err, "bit_equal_two_launches": True, "sass": sass,
           "tol": f"bf16 rtol={BF16_RTOL} atol={BF16_ATOL} (SDPA: relative "
                  f"L2 {LIBRARY_REL_L2}); fp32 causal S={s} and not causal "
                  "S=1000 rtol=atol=2e-5",
           "flash_mha_first_call_ms": mha_ms,
           "ms": timer(lambda: fa.flash_attention(qf, kf, vf, causal=True),
                       10),
           "plain_ms": timer(lambda: fa.flash_attention_plain(
               qf, kf, vf, causal=True), 3),
           "bound_ms": bms, "bound_by": by,
           "library_ms": timer(library, 10),
           "library_call": "F.scaled_dot_product_attention(is_causal, "
                           "enable_gqa)",
           "max_abs_err_library_vs_twin": lib_err,
           "rel_l2_err_library_vs_twin": lib_rel}

    # fp32, causal, the same widths and S: the template's fp32 instance,
    # held tight at the main shape --------------------------------------
    qf, kf, vf = (x.float() for x in (qf, kf, vf))
    got = fa.flash_attention(qf, kf, vf, causal=True)
    want = fa.flash_attention_plain(qf, kf, vf, causal=True)
    f32_err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=2e-5, atol=2e-5),
          f"flash_attention: fp32 causal S={s} off its twin by {f32_err}")
    row["max_abs_err_fp32_causal"] = f32_err
    row["ms_fp32_causal"] = timer(
        lambda: fa.flash_attention(qf, kf, vf, causal=True), 3)
    del qf, kf, vf, got, want

    # fp32, not causal, S = 1000: the padded keys must be masked ------------
    n = 1000
    q = normal(b, n, h, hd, dtype=torch.float32)
    k = normal(b, n, kvh, hd, dtype=torch.float32)
    v = normal(b, n, kvh, hd, dtype=torch.float32)
    got = ops.flash_mha(q, k, v, causal=False)

    def flat(x, rep):
        return x.permute(0, 2, 1, 3).reshape(-1, n, hd) \
            .repeat_interleave(rep, dim=0)

    want = ref.mha_ref(flat(q, 1), flat(k, h // kvh), flat(v, h // kvh),
                       causal=False).reshape(b, h, n, hd).permute(0, 2, 1, 3)
    pad_err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=2e-5, atol=2e-5),
          f"attention: fp32 S={n} not causal off mha_ref by {pad_err}")
    row["padded_fp32"] = {"causal": False,
                          "max_abs_err_vs_mha_ref": pad_err,
                          "tol": "rtol=atol=2e-5"}
    # the shapes and the bounds derived from them: this line only, never
    # the kernels line
    emit({"phase": "attention",
          "shape": {"B": b, "S": s, "H": h, "KV": kvh, "hd": hd,
                    "dtype": "bfloat16", "causal": True},
          "padded_fp32_shape": {"S": n, "padded_to": 1024},
          "kernels": {"flash_attention": row}, "launches": launches,
          "derived": {"bound_ms_fp32_simt": ops_count / FP32_OPS_PER_S
                      * 1e3,
                      # the design's own floor: P·V twice (P_hi and P_lo)
                      "design_floor_ms": 1.5 * ops_count / BF16_OPS_PER_S
                      * 1e3}})
    return {"flash_attention": row}, launches


# ---------------------------------------------------------------------------
# the facade, its checkpoints and the inferencer
# ---------------------------------------------------------------------------

# the checkpoint round trip runs on the first 4,096 training documents: the
# dense memo of all 16,430 is 1.07 GB on disk
CKPT_DOCS = 4096
CKPT_DIR = ROOT / "_smoke_ckpt"


def dir_bytes(path):
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def phase_facade(device, spec, train, topics, batch, sync, lam_train):
    """``LDA`` with IVI on the cuda backend, two epochs on the Arxiv
    corpus from ``warm_start`` of phase train's λ₀ (booked as
    ``init_global_state`` books it): 2 launches an update, and λ bit-equal
    to phase train's direct ``LDAEngine`` run (``lam_train``). Then a
    mid-epoch save, load and resume bit-equal to the uninterrupted run, on
    the dense and chunked stores and both layouts, on ``CKPT_DOCS``
    documents, with the save and load times and bytes."""
    import shutil
    import torch
    from repro_torch.core.types import Corpus, init_global_state
    from repro_torch.kernels import lda_estep
    from repro_torch.lda import LDA

    cfg = train_config(spec, topics)
    gen = torch.Generator(device=device).manual_seed(0)
    lam0 = init_global_state(cfg, device=device, generator=gen).lam
    lda = LDA(cfg, algo="ivi", batch_size=batch, seed=0, device=device)
    lda.partial_fit(train, steps=0).warm_start(lam0)
    want = init_global_state(cfg, device=device, lam0=lam0)
    check(all(torch.equal(getattr(lda.state, f), getattr(want, f))
              for f in ("lam", "m_vk", "init_mass", "init_frac", "t")),
          "facade: warm_start did not book λ₀ as init_global_state does")
    lda_estep.reset_launches()
    sync()
    t0 = time.perf_counter()
    lda.fit(epochs=2)
    sync()
    seconds = time.perf_counter() - t0
    launches = dict(lda_estep.LAUNCHES)
    updates = 2 * -(-train.num_docs // batch)
    check_two_launches("facade", launches, updates, "fixed_point")
    check(torch.equal(lda.lam, lam_train),
          "facade: λ is not the direct LDAEngine run's bit for bit")
    out = {"phase": "facade", "docs": train.num_docs, "epochs": 2,
           "updates": updates, "launches": launches,
           "ms_per_update": seconds * 1e3 / updates,
           "bit_equal_to_engine": True, "warm_start_as_init": True,
           "round_trip": {}}
    del lda

    sub = Corpus(train.token_ids[:CKPT_DOCS].contiguous(),
                 train.counts[:CKPT_DOCS].contiguous())
    out["round_trip_docs"] = CKPT_DOCS
    out["round_trip_cut"] = (f"the first {CKPT_DOCS:,} of {train.num_docs:,} "
                             "training documents")
    try:
        for layout in ("padded", "csr"):
            for store in ("dense", "chunked"):
                shutil.rmtree(CKPT_DIR, ignore_errors=True)
                kw = dict(algo="ivi", batch_size=batch, seed=0,
                          memo_store=store, chunk_docs=CKPT_DOCS // 2,
                          layout=layout, device=device)
                if layout == "csr":
                    kw["token_budget"] = CSR_BUDGET
                a = LDA(cfg, **kw).partial_fit(sub, steps=2)
                sync()
                t0 = time.perf_counter()
                a.save(str(CKPT_DIR))
                save_ms = (time.perf_counter() - t0) * 1e3
                nbytes = dir_bytes(CKPT_DIR)
                a.partial_fit(steps=5)        # past the epoch's end
                t0 = time.perf_counter()
                b = LDA.load(str(CKPT_DIR), device=device).resume(sub)
                sync()
                load_ms = (time.perf_counter() - t0) * 1e3
                b.partial_fit(steps=5)
                same = all(torch.equal(getattr(a.state, f),
                                       getattr(b.state, f))
                           for f in ("lam", "m_vk", "init_mass",
                                     "init_frac", "t"))
                check(same and a.docs_seen == b.docs_seen,
                      f"facade: {layout}/{store} resume is not bit-equal")
                out["round_trip"][f"{layout}_{store}"] = {
                    "save_ms": save_ms, "load_resume_ms": load_ms,
                    "bytes": nbytes, "bit_equal": True}
                del a, b
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    emit(out)
    return out


def phase_serve_infer(device, spec, test, topics, lam):
    """``TopicInferencer`` on the held-out documents, padded (batch 1,024)
    and CSR (131,072-slot batches): 1 launch a batch (the fixed point
    without its finish), γ against the gather backend tile by tile (padded)
    or the flat reference (CSR) at phase serve's bar, the double-buffered
    bits equal to the synchronous ones, no host sync before the final
    gather, docs/s both ways; then a swapper thread flipping between two
    snapshots under traffic, each batch's γ one snapshot's."""
    import threading
    import numpy as np
    import torch
    from repro_torch.core.estep import BowBatch, CSRTokenBatch, get_backend
    from repro_torch.core.types import init_global_state
    from repro_torch.data.stream import BatchPacker, CorpusDocStream
    from repro_torch.kernels import lda_estep
    from repro_torch.lda import TopicInferencer

    cfg = train_config(spec, topics)
    stream = CorpusDocStream(test, spec.vocab_size)
    out = {"phase": "serve_infer", "docs": test.num_docs}
    gen = torch.Generator(device=device).manual_seed(1)
    lam2 = init_global_state(cfg, device=device, generator=gen).lam
    for layout in ("padded", "csr"):
        inf = TopicInferencer(cfg, lam, batch_size=BATCH, layout=layout,
                              token_budget=CSR_BUDGET, device=device)
        packer = BatchPacker(**inf.packer_kwargs())
        batches = [x for x in (packer.add(p, i, c) for p, (i, c)
                               in enumerate(stream.iter_from(0))) if x]
        batches += packer.flush()
        name = "fixed_point_csr" if layout == "csr" else "fixed_point"
        inf.posterior_docs(stream)                        # warm-up
        lda_estep.reset_launches()
        got = inf.posterior_docs(stream, double_buffer=True)
        launches = dict(lda_estep.LAUNCHES)
        check(launches[name] == len(batches)
              and sum(launches.values()) == len(batches),
              f"serve_infer ({layout}): not 1 launch a batch over "
              f"{len(batches)}: {launches}")
        sync_got = inf.posterior_docs(stream, double_buffer=False)
        check(np.array_equal(got, sync_got),
              f"serve_infer ({layout}): double-buffered bits differ")
        syncs = host_syncs(lambda: inf._solve_docs(stream,
                                                   double_buffer=True))
        check(syncs == 0, f"serve_infer ({layout}): {syncs} host syncs "
                          "before the final gather")
        # γ against the gather backend: tile by tile (K1's stopping tiles)
        # on the padded layout, the whole flat batch on CSR
        eb = inf.exp_elog_beta
        gather = get_backend("gather")
        err = 0.0
        for x in batches:
            rows, gamma, n, _ = inf.posterior_packed(x)
            if layout == "csr":
                tok = CSRTokenBatch(*flat_tensors(x, device))
                ref = gather.solve_tokens_gamma(cfg, eb, tok,
                                                num_docs=BATCH)[:n]
            else:
                ids = torch.zeros((BATCH, x.width), dtype=torch.int32,
                                  device=device)
                cnts = torch.zeros((BATCH, x.width), device=device)
                ids[:n] = torch.from_numpy(x.token_ids).to(device)
                cnts[:n] = torch.from_numpy(x.counts).to(device)
                ref = torch.cat([gather.solve_gamma(
                    cfg, eb, BowBatch(ids[i:i + 128], cnts[i:i + 128]))
                    for i in range(0, BATCH, 128)])[:n]
            err = max(err, float((gamma[:n] - ref).abs().max()))
            check(torch.allclose(gamma[:n], ref, rtol=2e-3, atol=2e-3),
                  f"serve_infer ({layout}): γ off the gather backend by "
                  f"{err}")
        # docs/s of whole calls (packing, copies, solves, the gather), the
        # two paths in turns; host-clock times spread, so five of each
        rates = {}
        for mode in (True, False) * 5:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inf.posterior_docs(stream, double_buffer=mode)
            rates.setdefault("double_buffered" if mode else "synchronous",
                             []).append(test.num_docs
                                        / (time.perf_counter() - t0))
        rates = {m: {"median": median(r), "all": r} for m, r in rates.items()}
        # a swapper flips the snapshot while batches are served
        other = TopicInferencer(cfg, lam2, batch_size=BATCH, layout=layout,
                                token_budget=CSR_BUDGET, device=device)
        want = [[inf.posterior_packed(x)[1], other.posterior_packed(x)[1]]
                for x in batches]
        stop = threading.Event()

        def swapper():
            n = 0
            while not stop.is_set():
                n += 1
                inf.swap_model(lam2 if n % 2 else lam)
                time.sleep(1e-3)    # let batches land between the swaps

        t = threading.Thread(target=swapper)
        t.start()
        versions = []
        try:
            for _ in range(4):
                for i, x in enumerate(batches):
                    _, gamma, _, version = inf.posterior_packed(x)
                    check(torch.equal(gamma, want[i][version % 2]),
                          f"serve_infer ({layout}): a batch's γ is not its "
                          "snapshot's")
                    versions.append(version)
        finally:
            stop.set()
            t.join(timeout=60)
        check(not t.is_alive() and versions == sorted(versions)
              and len(set(v % 2 for v in versions)) == 2,
              f"serve_infer ({layout}): swaps under traffic: {versions}")
        out[layout] = {
            "batches": len(batches), "launches": launches,
            "max_abs_err_vs_gather": err,
            "tol": "γ rtol=atol=2e-3 against gather (tile by tile padded)",
            "double_buffered_bits_equal_synchronous": True,
            "host_syncs_before_gather": syncs,
            "docs_per_s": rates,
            "padding": inf.padding_stats(),
            "swap": {"batches": len(versions),
                     "versions_seen": len(set(versions))}}
        del inf, other, want
    emit(out)
    return out


# ---------------------------------------------------------------------------
# the lifted K caps: K1/K4 above 256 topics, K3 over column chunks, K6-K8
# over K tiles
# ---------------------------------------------------------------------------

KCAP_TOPICS = (300, 1000)
KCAP_BATCH = 256          # the first 256 Arxiv-shaped documents, V = 141,927
# K8's partials are (B / B-tile, V, K) floats twice: at K = 1,000 its
# B-tile is 2, so 16 documents make 8 partials (9.1 GB with the twin's)
KCAP_ONEHOT_BATCH = 16
# sha256 of each kernel's outputs at K = 100 on ``digest_inputs``, as the
# parent commit 1391254 built them (chip run, NVIDIA H100 80GB HBM3): the
# instances at K <= 256 (K1/K4) and K <= 128 (K6-K8) keep their bits
PARENT_DIGESTS = {
    "fixed_point":
        "6a74054a1150a2687342dae805774ec7a4924a701332e6326c908aaebfb99588",
    "fixed_point_csr":
        "e4d2329444c64fd971b56cf1141cb6676dc6c8b4364fe44f5cd2acff3dc17ba9",
    "segment_scatter":
        "7156093ddcca0aeee14af409f594c74ce9982b9c72755bea9b4a42e1ba1bf410",
    "sweep":
        "0a55f40e7eaf88d446aad9d9bc44d206083fe8a77d2ce1c162d9b199d624943d",
    "sstats":
        "82296b778b6f260ac5b78c129c68416c7fc71b703d755cf5f587348cb6d3816c",
    "memo_delta_onehot":
        "e734394fe429b74b2df3ce086cf8576699ace3b9b52b3d72424567c206a64e4b",
}
# ptxas's spill bytes (stores, loads) of the fixed point's register
# instances as the parent built them: KPL = 6-8 (K = 161-256) spilled
# there already and are kept as they were (their bits); every other
# instance, and the wide kernel above 256 topics, must not spill
PARENT_SPILLS = {"kpl6": [[8, 16]], "kpl7": [[16, 52]], "kpl8": [[36, 100]]}


def digest_inputs(device, k=100, b=512, l=64, v=8192, seed=0):
    """Seeded numpy inputs of every lifted kernel at K topics: B documents
    of L unique ids (a random live length each, counts 1-5), Eφ a positive
    (V, K) matrix with unit columns."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.choice(v, l, replace=False) for _ in range(b)])
    lens = rng.integers(1, l + 1, b)
    cnts = rng.integers(1, 6, (b, l)) * (np.arange(l) < lens[:, None])
    eb = rng.gamma(1.0, 1.0, (v, k)).astype(np.float32)
    eb /= eb.sum(0, keepdims=True)
    return (torch.from_numpy(ids.astype(np.int32)).to(device),
            torch.from_numpy(cnts.astype(np.float32)).to(device),
            torch.from_numpy(eb).to(device))


def kernel_digests(device, k=100):
    """sha256 of the outputs of K1, K4 (each with its π finish), K3, K6,
    K7 and K8 on ``digest_inputs`` at K topics."""
    import hashlib
    import torch
    from repro_torch.core.estep import densify
    from repro_torch.kernels import lda_estep

    ids, cnts, eb = digest_inputs(device, k)
    (b, l), v = ids.shape, eb.shape[0]
    gamma0 = torch.full((b, k), 1.5, device=device)
    flat_ids, flat_cnts = ids.reshape(-1), cnts.reshape(-1)
    segs = torch.arange(b, dtype=torch.int32,
                        device=device).repeat_interleave(l)

    def sha(*xs):
        h = hashlib.sha256()
        for x in xs:
            h.update(x.contiguous().cpu().numpy().tobytes())
        return h.hexdigest()

    k1 = lda_estep.estep_fixed_point_pi(ids, cnts, eb, gamma0, 0.5, 1e-4,
                                        60)
    k4 = lda_estep.estep_fixed_point_csr_pi(flat_ids, flat_cnts, segs, eb,
                                            gamma0, 0.5, 1e-4, 60)
    pi1, pi4 = k1[3].reshape(-1, k), k4[3]
    c = densify(ids, cnts, v)
    return {
        "fixed_point": sha(*k1),
        "fixed_point_csr": sha(*k4),
        "segment_scatter": sha(*lda_estep.segment_scatter(
            flat_ids, flat_cnts, pi1, pi4, v)),
        "sweep": sha(lda_estep.estep_sweep(c, k1[1], eb, 0.5)),
        "sstats": sha(lda_estep.sstats(c, k1[1], eb)),
        "memo_delta_onehot": sha(*lda_estep.memo_delta_onehot(
            ids, cnts, eb[ids.long()].contiguous(), k1[1], v,
            old_pi=pi4.reshape(b, l, k), quantize=True)),
    }


def phase_kcap(device, spec, train, timer):
    """K1, K4, K3, K6, K7 and K8 at K = 300 and 1,000 against their twins
    on the first Arxiv-shaped documents (V = 141,927), timed beside their
    bounds; every fixed-point instance's spills (0 required); at K = 100
    the parent's bits."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.estep import densify
    from repro_torch.core.math import exp_dirichlet_expectation
    from repro_torch.core.types import LDAConfig, init_global_state
    from repro_torch.kernels import build, lda_estep, ops

    ptxas = build.BUILD_INFO["lda_estep"]["ptxas"]
    spills = {f"kpl{n}" if n else "wide": fixed_point_spills(ptxas, n)
              for n in range(9)}
    check(all(v == PARENT_SPILLS.get(name, [[0, 0]])
              for name, v in spills.items()),
          f"fixed_point instances spill: {spills}")
    digests = kernel_digests(device)
    same = {name: digests[name] == want
            for name, want in PARENT_DIGESTS.items()}
    check(all(same.values()) and len(same) == 6,
          f"K = 100: not the parent's bits: {same}")

    ids = train.token_ids[:KCAP_BATCH].contiguous()
    cnts = train.counts[:KCAP_BATCH].contiguous()
    (b, l), v = ids.shape, spec.vocab_size
    live = int((cnts != 0).sum())
    flat_ids, flat_cnts = ids.reshape(-1), cnts.reshape(-1)
    segs = torch.arange(b, dtype=torch.int32,
                        device=device).repeat_interleave(l)
    rows = {}
    for k in KCAP_TOPICS:
        cfg = LDAConfig(num_topics=k, vocab_size=v,
                        estep_max_iters=ESTEP_ITERS)
        gen = torch.Generator(device=device).manual_seed(k)
        eb = exp_dirichlet_expectation(init_global_state(
            cfg, device=device, generator=gen).lam, axis=0).contiguous()
        gamma0 = torch.full((b, k), cfg.alpha0 + 1.0, device=device)
        fp = (cfg.alpha0, cfg.estep_tol, cfg.estep_max_iters)

        # K1 ---------------------------------------------------------------
        args = (ids, cnts, eb, gamma0, *fp)
        k1 = check_fixed_point(args, f"K={k}")
        et = k1.pop("_etheta")
        k1.pop("_etheta_plain")
        k1.update(check_fused_pi(
            lambda q: lda_estep.estep_fixed_point_pi(*args, quantize=q),
            lambda: lda_estep.estep_fixed_point(*args),
            lambda e, q: lda_estep.token_pi(ids, cnts, eb, e, quantize=q),
            f"fixed_point K={k}"))
        k1.update(ms=timer(lambda: lda_estep.estep_fixed_point_pi(*args), 5),
                  plain_ms=timer(
                      lambda: lda_estep.estep_fixed_point_pi_plain(*args),
                      1, 1))

        # K4 on the same documents, flattened ------------------------------
        cargs = (flat_ids, flat_cnts, segs, eb, gamma0, *fp)
        k4 = check_fixed_point_csr(cargs, f"K={k}")
        et4 = k4.pop("_etheta")
        k4.pop("_etheta_plain")
        k4.update(check_fused_pi(
            lambda q: lda_estep.estep_fixed_point_csr_pi(*cargs, quantize=q),
            lambda: lda_estep.estep_fixed_point_csr(*cargs),
            lambda e, q: lda_estep.token_pi_csr(flat_ids, flat_cnts, segs,
                                                eb, e, quantize=q),
            f"fixed_point_csr K={k}"))
        k4.update(ms=timer(
            lambda: lda_estep.estep_fixed_point_csr_pi(*cargs), 5),
            plain_ms=timer(
                lambda: lda_estep.estep_fixed_point_csr_pi_plain(*cargs),
                1, 1))

        # K3 on the two fixed points' π ------------------------------------
        pi_new = lda_estep.token_pi(ids, cnts, eb, et).reshape(-1, k)
        pi_old = lda_estep.token_pi(ids, cnts, eb, et4).reshape(-1, k)
        err = check_segment_scatter(flat_ids, flat_cnts, pi_new, pi_old, v,
                                    f"K={k}")
        segments = lda_estep.scatter_segments(flat_ids, flat_cnts, v)
        bms, by = bound_ms(live * 8 + 2 * live * k * 4 + 2 * v * k * 4,
                           4.0 * live * k)
        k3 = {"max_abs_err": err, "tol": "rtol=atol=1e-5 vs fp64; bitwise "
                                         "equal across launches",
              "ms": timer(lambda: lda_estep.segment_scatter_prepared(
                  segments, flat_cnts, pi_new, pi_old, v), 10),
              "plain_ms": timer(lambda: lda_estep.segment_scatter_plain(
                  flat_ids, flat_cnts, pi_new, pi_old, v), 2, 1),
              "bound_ms": bms, "bound_by": by}
        del pi_new, pi_old, segments

        # K6 and K7 on the padded dense counts, a seeded γ -------------------
        cpad, ebpad, _ = ops.pad_inputs(densify(ids, cnts, v), eb, 128, 512)
        (bp, vp), kp = cpad.shape, ebpad.shape[1]
        g_rand = cfg.alpha0 + 0.1 + 20.0 * torch.rand(
            (b, k), generator=gen, device=device)
        et0 = ops.padded_exp_elog_theta(
            F.pad(g_rand, (0, kp - k, 0, bp - b), value=cfg.alpha0), k)
        dense = {}
        for name, kern, plain, dargs in (
                ("sweep", lda_estep.estep_sweep, lda_estep.estep_sweep_plain,
                 (cpad, et0, ebpad, cfg.alpha0)),
                ("sstats", lda_estep.sstats, lda_estep.sstats_plain,
                 (cpad, et0, ebpad))):
            got, again, want = kern(*dargs), kern(*dargs), plain(*dargs)
            derr = float((got - want).abs().max())
            check(torch.allclose(got, want, rtol=2e-5, atol=2e-5),
                  f"{name} K={k}: off its twin by {derr}")
            check(torch.equal(got, again), f"{name} K={k}: two launches "
                                           "differ")
            bms, by = dense_bound(bp, vp, kp)
            dense[name] = {"max_abs_err": derr,
                           "tol": "rtol=atol=2e-5 (fp32 twin, no TF32)",
                           "ms": timer(lambda: kern(*dargs), 3),
                           "plain_ms": timer(lambda: plain(*dargs), 3),
                           "bound_ms": bms, "bound_by": by}
        del cpad, ebpad, et0

        # K8 on the first few documents, with phase legacy's bars ----------
        n8 = KCAP_ONEHOT_BATCH
        ids8, cnts8 = ids[:n8].contiguous(), cnts[:n8].contiguous()
        ebt8 = eb[ids8.long()].contiguous()
        et8 = et[:n8].contiguous()
        old8 = lda_estep.token_pi(ids8, cnts8, eb, et4[:n8].contiguous())
        o8 = (ids8, cnts8, ebt8, et8, v, old8)
        got = lda_estep.memo_delta_onehot(*o8)
        check(all(torch.equal(x, y) for x, y in
                  zip(got, lda_estep.memo_delta_onehot(*o8))),
              f"memo_delta_onehot K={k}: two launches differ")
        want = lda_estep.memo_delta_onehot_plain(*o8)
        oerr = max(float((x - y).abs().max()) for x, y in zip(got, want))
        check(torch.allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
              and all(torch.allclose(x, y, rtol=1e-4, atol=1e-4)
                      for x, y in zip(got[1:], want[1:])),
              f"memo_delta_onehot K={k}: off its twin by {oerr}")
        del got, want
        got = lda_estep.memo_delta_onehot(*o8, quantize=True)
        seg = lda_estep.memo_delta(ids8, cnts8, eb, et8, v, old_pi=old8,
                                   quantize=True)
        check(torch.equal(got[0], seg[0]),
              f"memo_delta_onehot K={k}: π is not K2's bit for bit")
        check(all(torch.allclose(x, y, rtol=1e-4, atol=1e-4)
                  for x, y in zip(got[1:], seg[1:])),
              f"memo_delta_onehot K={k}: S off K2 + K3")
        del got, seg
        live8 = int((cnts8 != 0).sum())
        bms, by = bound_ms(n8 * l * (8 + 3 * k * 4) + 2 * v * k * 4,
                           8.0 * live8 * k)
        dense["memo_delta_onehot"] = {
            "max_abs_err": oerr,
            "tol": "π rtol=1e-5 atol=1e-6, S rtol=atol=1e-4 (phase legacy's "
                   "bars); quantized π bit-equal to K2's",
            "B": n8,
            "ms": timer(lambda: lda_estep.memo_delta_onehot(*o8), 3),
            "plain_ms": timer(lambda: lda_estep.memo_delta_onehot_plain(*o8),
                              2, 1),
            "bound_ms": bms, "bound_by": by}
        del ebt8, o8
        rows[k] = {"fixed_point": k1, "fixed_point_csr": k4,
                   "segment_scatter": k3, **dense}
        torch.cuda.empty_cache()
    emit({"phase": "kcap", "B": b, "L": l, "V": v, "live_slots": live,
          "fixed_point_spill_bytes": spills, "digests_k100": digests,
          "parent_bits_k100": same, "kernels": rows})
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    device = torch.device("cuda")
    # the dense twins' products in full fp32, as the kernels compute them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = phase_device()
    phase_build()
    spec, train, test = phase_data(device)
    kernels, memo_delta_launches = phase_kernels(device, spec, train, TOPICS,
                                                 BATCH, cuda_ms)
    phase_serve(device, spec, test, TOPICS, BATCH, torch.cuda.synchronize)
    launches, eng, ivi = phase_train(device, spec, train, test, TOPICS,
                                     BATCH, torch.cuda.synchronize)
    lam_train = eng.state.lam.clone()     # after the two epochs
    phase_fixed_point_warm(eng, kernels, cuda_ms)
    batches = iter(eng.epoch_batches())
    phase_profile(lambda: eng.run_minibatch(next(batches)[0]))
    del eng, batches

    kernels_csr, memo_delta_csr_launches = phase_kernels_csr(
        device, spec, train, TOPICS, BATCH, cuda_ms)
    kernels.update(kernels_csr)
    phase_serve_csr(device, spec, test, TOPICS, BATCH, torch.cuda.synchronize)
    launches_csr, eng, ivi_csr = phase_train_csr(
        device, spec, train, test, TOPICS, BATCH, torch.cuda.synchronize)
    phase_fixed_point_csr_warm(eng, kernels, cuda_ms)
    phase_profile(eng.stream_step, phase="profile_csr")
    del eng

    sync = torch.cuda.synchronize
    phase_train_mvi(device, spec, train, test, TOPICS, BATCH, sync)
    phase_train_svi(device, spec, train, test, TOPICS, BATCH, sync, "padded",
                    ivi)
    phase_train_svi(device, spec, train, test, TOPICS, BATCH, sync, "csr",
                    ivi_csr)
    phase_train_chunked(device, spec, train, test, TOPICS, BATCH, sync, ivi)
    phase_train_gamma(device, spec, train, test, TOPICS, BATCH, sync, ivi)
    phase_train_bucketed(device, spec, train, test, TOPICS, BATCH, sync, ivi)
    phase_telemetry(device, spec, train, TOPICS, BATCH, sync)
    phase_facade(device, spec, train, TOPICS, BATCH, sync, lam_train)
    phase_serve_infer(device, spec, test, TOPICS, lam_train)
    del lam_train
    phase_kcap(device, spec, train, cuda_ms)

    legacy, launches_legacy = phase_legacy(device, spec, train, TOPICS, BATCH,
                                           cuda_ms)
    kernels.update(legacy)
    attention, launches_attention = phase_attention(device, cuda_ms)
    kernels.update(attention)
    # each kernel's launches on the path that runs it: K2 and K5 on
    # memo_delta / memo_delta_csr (the training paths run them fused)
    launches.update(fixed_point_csr=launches_csr["fixed_point_csr"],
                    token_pi=memo_delta_launches["token_pi"],
                    token_pi_csr=memo_delta_csr_launches["token_pi_csr"],
                    **{n: launches_legacy[n] for n in LEGACY_KERNELS},
                    flash_attention=launches_attention["flash_attention"])
    kernels["segment_scatter"]["launches_csr"] = \
        launches_csr["segment_scatter"]
    check(all(launches[name] > 0 for name in REPLACES),
          f"a kernel never launched on its path: {launches}")
    emit({"phase": "summary", "card": info["nvidia_smi"],
          "seconds": time.perf_counter() - t_start,
          # the two fixed points, cold, on the same documents, λ and γ₀
          "cold_ms_same_docs": {
              "fixed_point": kernels["fixed_point"]["ms"],
              "fixed_point_csr": kernels["fixed_point_csr"]["ms"],
              "same_docs": kernels["fixed_point_csr"][
                  "same_docs_as_fixed_point"]}})
    emit({"kernels": [dict(name=name, route="cuda", source=SOURCES[name],
                           replaces=REPLACES[name], launches=launches[name],
                           **kernels[name]) for name in REPLACES]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
