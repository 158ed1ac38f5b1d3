#!/usr/bin/env python3
"""Drive the PyTorch port's paths (IVI, Algorithm 1) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:  python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero. The padded
path first:
  1. device  — nvidia-smi's name and power limit, torch's device name/count
  2. build   — nvcc builds the kernels from src/repro_torch/kernels/csrc
  3. kernels — each kernel against its plain twin at the path's shapes
               (Arxiv: V = 141,927, K = 100, B = 1024), then timed
  4. serve   — γ for 1,024 held-out documents through the CUDA backend,
               against the gather backend
  5. train   — LDAEngine IVI on an Arxiv-shaped corpus (16,430 documents),
               two epochs; kernel launch counts, LPP, the memoized ELBO
               after every update of epoch 2, the memo invariant
  6. warm    — the fixed point against its twin again, from the trained λ
               and memo warm starts, where tiles stop at different sweeps
  7. profile — torch.profiler over a few more updates: device time by
               operation and the device's idle share
then the flat CSR token-stream path, on the same corpus:
  8. kernels_csr — the CSR kernels against their twins on the first flat
               batch (B = 1024 documents in a 131,072-slot stream), timed
  9. serve_csr — γ for 1,024 held-out documents packed as one flat batch,
               through the CUDA backend against the plain flat reference
 10. train_csr — LDAEngine IVI over a CorpusDocStream in the CSR layout,
               two epochs, with the same checks as phase 5
 11. warm_csr  — the CSR fixed point against its twin from the trained
               memo's warm starts
 12. profile_csr — torch.profiler over a few more CSR updates
then the pre-fusion baseline and attention:
 13. legacy  — the per-sweep E-step (K6 once per sweep, K7 once) and the
               one-hot memo delta (K8) on phase 3's documents, λ and γ₀:
               each kernel against its twin and timed; the whole E-step
               against the same loop over the twins; the legacy correction
               against the fused one (K1–K3), here and at BENCH_estep's
               shape (B = 128, V = 4096, K = 128, L = 64)
 14. attention — flash_mha (K9) at Qwen2.5-3B's attention widths (16 query
               heads, 2 KV heads, hd = 128), B = 1, S = 4096, bf16, causal,
               against its twin and timed beside scaled_dot_product_attention;
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
# the kernels each path launches
PADDED_KERNELS = ("fixed_point", "token_pi", "segment_scatter")
CSR_KERNELS = ("fixed_point_csr", "token_pi_csr", "segment_scatter")
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
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": build.BUILD_INFO})


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
    is held at γ's tolerance). Returns the errors, the tile sweeps and
    the bound for this run's sweeps."""
    import torch
    from repro_torch.kernels import lda_estep

    ids, cnts, eb, gamma0 = args[:4]
    (b, k), l = gamma0.shape, ids.shape[1]
    g, et, it = lda_estep.estep_fixed_point(*args, block_b=block_b)
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
    bms, by = bound_ms(nbytes, ops)
    return {"max_abs_err": gerr, "max_abs_err_etheta": eterr,
            "tol": "γ rtol=atol=2e-3; Eθ rtol=1e-4 atol=1e-6 in tiles whose "
                   "sweeps agree; tile sweeps within 1",
            "sweep_gap": sweep_gap, "tile_sweeps": sweeps.tolist(),
            "bound_ms": bms, "bound_by": by, "_etheta": et,
            "_etheta_plain": pet}


def phase_kernels(device, spec, train, topics, batch, timer):
    """Each kernel against its plain twin on one path-shaped batch."""
    import torch
    from repro_torch.core.math import exp_dirichlet_expectation
    from repro_torch.core.types import LDAConfig, init_global_state
    from repro_torch.kernels import lda_estep

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
    out["fixed_point"].update(
        ms=timer(lambda: lda_estep.estep_fixed_point(*args), 10),
        plain_ms=timer(lambda: lda_estep.estep_fixed_point_plain(*args), 2, 1),
        library_ms=None)

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
    pi_old = lda_estep.token_pi(ids, cnts, eb, pet).reshape(-1, k)
    s1 = lda_estep.segment_scatter(flat_ids, flat_cnts, pi_new, pi_old, v)
    s2 = lda_estep.segment_scatter(flat_ids, flat_cnts, pi_new, pi_old, v)
    check(all(torch.equal(x, y) for x, y in zip(s1, s2)),
          "segment_scatter: two launches differ (not deterministic)")
    err = 0.0
    for got, p in zip(s1, (pi_new, pi_old)):
        want = torch.zeros((v, k), dtype=torch.float64, device=device)
        want.index_add_(0, flat_ids.long(), flat_cnts[:, None].double()
                        * p.double())
        err = max(err, float((got.double() - want).abs().max()))
        check(torch.allclose(got.double(), want, rtol=1e-5, atol=1e-5),
              f"segment_scatter: off the fp64 sum by {err}")
    idx64 = flat_ids.long()
    segments = lda_estep.scatter_segments(flat_ids, flat_cnts)

    def library():
        a = torch.zeros((v, k), device=device).index_add_(
            0, idx64, flat_cnts[:, None] * pi_new)
        c = torch.zeros((v, k), device=device).index_add_(
            0, idx64, flat_cnts[:, None] * pi_old)
        return a, c

    bms, by = bound_ms(live * 8 + 2 * live * k * 4 + 2 * v * k * 4,
                       4.0 * live * k)
    out["segment_scatter"] = {
        "max_abs_err": err, "tol": "rtol=atol=1e-5 vs fp64; bitwise "
        "equal across launches", "deterministic": True,
        # the launch on prepared segments (with its two zeroed outputs);
        # the wrapper adds the index preparation, which syncs the host
        "ms": timer(lambda: lda_estep.segment_scatter_prepared(
            segments, flat_cnts, pi_new, pi_old, v), 20),
        "wrapper_ms": timer(lambda: lda_estep.segment_scatter(
            flat_ids, flat_cnts, pi_new, pi_old, v), 20),
        "plain_ms": timer(lambda: lda_estep.segment_scatter_plain(
            flat_ids, flat_cnts, pi_new, pi_old, v), 5),
        "bound_ms": bms, "bound_by": by, "library_ms": timer(library, 20),
        "library_call": "2x zeros + index_add_"}
    emit({"phase": "kernels", "shape": {"B": b, "L": l, "K": k, "V": v,
                                        "live_slots": live,
                                        "distinct_ids": distinct},
          "kernels": out})
    return out


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
    check(all(launches[n] > 0 for n in PADDED_KERNELS), f"serve: {launches}")
    emit({"phase": "serve", "docs": n, "seconds": seconds,
          "docs_per_s": n / seconds, "launches": launches,
          "max_abs_err_vs_gather": errs, "iters": int(got.iters)})


def memo_invariant_gap(eng, train, topics, device):
    """⟨m_vk⟩ against Σ_d scatter(cnt·π_memo), rebuilt in fp64; fails
    outside rtol 1e-3 / atol 1e-2. Returns the largest gap."""
    import torch
    rebuilt = torch.zeros(eng.state.m_vk.shape, dtype=torch.float64,
                          device=device)
    for lo in range(0, eng.num_docs, 2048):
        ids = train.token_ids[lo:lo + 2048].reshape(-1).long()
        w = (train.counts[lo:lo + 2048, :, None].double()
             * eng.memo.pi[lo:lo + 2048].double())
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
        for rows in eng.epoch_batches():
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
    check(all(launches[n] > 0 for n in PADDED_KERNELS),
          f"train: a kernel of the path never launched: {launches}")
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
    return launches, eng


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
    for rows in eng.epoch_batches()[:max_batches]:
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
    warm = {"batches": len(checked),
            "max_abs_err": max(r["max_abs_err"] for r in checked),
            "max_abs_err_etheta": max(r["max_abs_err_etheta"]
                                      for r in checked),
            "sweep_gap": max(r["sweep_gap"] for r in checked),
            "tile_sweeps": [r["tile_sweeps"] for r in checked],
            "ms": timer(lambda: lda_estep.estep_fixed_point(*first), 10),
            "bound_ms": checked[0]["bound_ms"],
            "bound_by": checked[0]["bound_by"]}
    kernels["fixed_point"]["warm"] = warm
    emit({"phase": "kernels_warm", "fixed_point": warm})


def phase_profile(step, updates=4, phase="profile"):
    """Where one update's time goes: ``torch.profiler`` over ``updates``
    more updates (``step()`` runs one, after every check above), device
    time by operation and the device's idle share of the wall time."""
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
    emit({"phase": phase, "updates": updates, "wall_ms": wall_ms,
          "device_busy_ms": busy_ms,
          "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
          "top_device_ms": [{"op": k[:80], "ms": ms, "count": n}
                            for k, ms, n in ops[:12]]})


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
    sweep count, γ at 2e-3, Eθ at rtol 1e-4 / atol 1e-6. Returns the
    errors, the sweeps and the bound for this run's sweeps."""
    import torch
    from repro_torch.kernels import lda_estep

    ids, cnts, segs, eb, gamma0 = args[:5]
    b, k = gamma0.shape
    g, et, it = lda_estep.estep_fixed_point_csr(*args)
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
    bms, by = bound_ms(nbytes, ops)
    return {"max_abs_err": gerr, "max_abs_err_etheta": eterr,
            "tol": "γ rtol=atol=2e-3; Eθ rtol=1e-4 atol=1e-6; the same "
                   "batch-wide sweep count",
            "sweeps": sweeps, "live_tokens": live, "distinct_ids": distinct,
            "bound_ms": bms, "bound_by": by, "_etheta": et,
            "_etheta_plain": pet}


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
    out["fixed_point_csr"].update(
        ms=timer(lambda: lda_estep.estep_fixed_point_csr(*args), 10),
        plain_ms=timer(lambda: lda_estep.estep_fixed_point_csr_plain(*args),
                       2, 1),
        library_ms=None,
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

    # memo_delta_csr: K5 then K3 on the flat rows --------------------------
    pi_old = lda_estep.token_pi_csr(ids, cnts, segs, eb, pet)
    pi, s_new, s_old = lda_estep.memo_delta_csr(ids, cnts, segs, eb, et, v,
                                                old_pi=pi_old)
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
    emit({"phase": "kernels_csr",
          "shape": {"B": b, "T": t, "K": k, "V": v, "live_tokens": live,
                    "distinct_ids": distinct,
                    "longest_doc": int(cb.doc_lengths.max())},
          "memo_delta_csr": {"max_abs_err_vs_fp64": err,
                             "tol": "rtol=atol=1e-5 vs fp64"},
          "kernels": out})
    return out


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
    check(all(launches[n] > 0 for n in CSR_KERNELS), f"serve_csr: {launches}")
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
    check(all(launches[n] > 0 for n in CSR_KERNELS),
          f"train_csr: a kernel of the path never launched: {launches}")
    check(launches["fixed_point"] == launches["token_pi"] == 0,
          f"train_csr: the padded path ran: {launches}")
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
    return launches, eng


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
    res["ms"] = timer(lambda: lda_estep.estep_fixed_point_csr(*args), 10)
    kernels["fixed_point_csr"]["warm"] = res
    emit({"phase": "kernels_csr_warm", "fixed_point_csr": res})


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
            "deterministic": True, "shape": [bp, vp, kp],
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


def phase_attention(device, timer):
    """flash_mha (K9) at Qwen2.5-3B's attention widths, bf16, causal, S =
    4096, one sequence: its launches; K9 against its twin at about two bf16
    ulps; its time, its bound and scaled_dot_product_attention's on the same
    inputs. Then fp32 at the same shape, causal, against the twin, and fp32,
    not causal, S = 1000 (padded to 1024) against mha_ref on the unpadded
    inputs, both at 2e-5."""
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
    row = {"max_abs_err": err,
           "tol": f"bf16 rtol={BF16_RTOL} atol={BF16_ATOL} (SDPA: relative "
                  f"L2 {LIBRARY_REL_L2}); fp32 causal S={s} and not causal "
                  "S=1000 rtol=atol=2e-5",
           "shape": {"B": b, "S": s, "H": h, "KV": kvh, "hd": hd,
                     "dtype": "bfloat16", "causal": True},
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
    row["padded_fp32"] = {"S": n, "padded_to": 1024, "causal": False,
                          "max_abs_err_vs_mha_ref": pad_err,
                          "tol": "rtol=atol=2e-5"}
    emit({"phase": "attention", "kernels": {"flash_attention": row},
          "launches": launches,
          "derived": {"bound_ms_fp32_simt": ops_count / FP32_OPS_PER_S
                      * 1e3}})
    return {"flash_attention": row}, launches


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
    kernels = phase_kernels(device, spec, train, TOPICS, BATCH, cuda_ms)
    phase_serve(device, spec, test, TOPICS, BATCH, torch.cuda.synchronize)
    launches, eng = phase_train(device, spec, train, test, TOPICS, BATCH,
                                torch.cuda.synchronize)
    phase_fixed_point_warm(eng, kernels, cuda_ms)
    batches = iter(eng.epoch_batches())
    phase_profile(lambda: eng.run_minibatch(next(batches)))
    del eng, batches

    kernels.update(phase_kernels_csr(device, spec, train, TOPICS, BATCH,
                                     cuda_ms))
    phase_serve_csr(device, spec, test, TOPICS, BATCH, torch.cuda.synchronize)
    launches_csr, eng = phase_train_csr(device, spec, train, test, TOPICS,
                                        BATCH, torch.cuda.synchronize)
    phase_fixed_point_csr_warm(eng, kernels, cuda_ms)
    phase_profile(eng.stream_step, phase="profile_csr")
    del eng

    legacy, launches_legacy = phase_legacy(device, spec, train, TOPICS, BATCH,
                                           cuda_ms)
    kernels.update(legacy)
    attention, launches_attention = phase_attention(device, cuda_ms)
    kernels.update(attention)
    # each kernel's launches on the path that runs it
    launches.update(fixed_point_csr=launches_csr["fixed_point_csr"],
                    token_pi_csr=launches_csr["token_pi_csr"],
                    **{n: launches_legacy[n] for n in LEGACY_KERNELS},
                    flash_attention=launches_attention["flash_attention"])
    kernels["segment_scatter"]["launches_csr"] = \
        launches_csr["segment_scatter"]
    check(all(launches[name] > 0 for name in REPLACES),
          f"a kernel never launched on its path: {launches}")
    emit({"phase": "summary", "card": info["nvidia_smi"],
          "seconds": time.perf_counter() - t_start})
    emit({"kernels": [dict(name=name, route="cuda", source=SOURCES[name],
                           replaces=REPLACES[name], launches=launches[name],
                           **kernels[name]) for name in REPLACES]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
