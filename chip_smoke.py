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

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 non-tensor
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# operations per element of the in-kernel exp(E[ln θ]): two series digammas
# (8 divisions + 8 additions + log + 6 series terms each), a subtraction and
# an exp, counting a division, log or exp as one operation
ETHETA_OPS = 34

ARXIV_SCALE = 0.021      # 782,385 × 0.021 = 16,430 training documents
BATCH = 1024
TOPICS = 100
ESTEP_ITERS = 60
CSR_BUDGET = 131_072     # flat slots per CSR batch: 1024 documents fit
SOURCE = "src/repro_torch/kernels/csrc/lda_estep.cu"
REPLACES = {"fixed_point": "src/repro/kernels/lda_estep.py:99",
            "token_pi": "src/repro/kernels/lda_estep.py:208",
            "segment_scatter": "src/repro/kernels/lda_estep.py:227",
            "fixed_point_csr": "src/repro/kernels/lda_estep.py:433",
            "token_pi_csr": "src/repro/kernels/lda_estep.py:558"}
# the kernels each path launches
PADDED_KERNELS = ("fixed_point", "token_pi", "segment_scatter")
CSR_KERNELS = ("fixed_point_csr", "token_pi_csr", "segment_scatter")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


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


def bound_ms(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
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
    from repro_torch.kernels import build
    stale = build.library_path()
    if stale.exists():           # build from the checkout's source, always
        stale.unlink()
    t0 = time.perf_counter()
    build.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": build.BUILD_INFO.get("seconds"),
          "command": build.BUILD_INFO.get("command"),
          "ptxas": build.BUILD_INFO.get("ptxas")})


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    device = torch.device("cuda")
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
    # each kernel's launches on the path that runs it
    launches.update(fixed_point_csr=launches_csr["fixed_point_csr"],
                    token_pi_csr=launches_csr["token_pi_csr"])
    kernels["segment_scatter"]["launches_csr"] = \
        launches_csr["segment_scatter"]
    emit({"phase": "summary", "card": info["nvidia_smi"],
          "seconds": time.perf_counter() - t_start})
    emit({"kernels": [dict(name=name, route="cuda", source=SOURCE,
                           replaces=REPLACES[name], launches=launches[name],
                           **kernels[name]) for name in REPLACES]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
