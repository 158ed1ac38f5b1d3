#!/usr/bin/env python3
"""Drive the PyTorch port's paths (IVI, Algorithm 1) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:  python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero. The padded
path first:
  1. device  — nvidia-smi's name and power limit, torch's device name/count
  2. build   — nvcc builds the kernels from src/repro_torch/kernels/csrc;
               K1/K4's instance at K = 100, K2's and K5's instances, K6's
               and K7's tensor-core instances and their R pass must not
               spill registers (K6/K7's register counts printed), and ptxas
               must serialize no wgmma
  3. kernels — each kernel against its plain twin at the path's shapes
               (Arxiv: V = 141,927, K = 100, B = 1024), then timed; K1
               and K3 also give the same bits on two launches; K1 with its
               π finish (the path's launch) gives K1's bits without it and
               K2's π bit for bit, its grid holds every document at once,
               and one bf16-streamed launch agrees with its twin more
               closely than the fp32 stream does, and its finish's own
               time; K2 timed by device time beside its byte bound (at
               least PI_BOUND_SHARE of it), then K2 then
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
               K5 gated as K2; K5 then K3 driven as memo_delta_csr
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
then the facade, serving and checkpoints, the serving service, D-IVI,
and the lifted K caps:
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
 22. service — repro_torch.serve from phase 5's λ on both layouts, the
               held-out documents as requests (20 ms flush timeout): (a)
               a replayed burst of 32,768 requests: docs/s, conservation,
               each served batch's γ bit-equal to posterior_docs of its
               admitted documents, 1 launch a batch, host syncs a batch
               (2: the stream wait, the γ copy); (b) 16,384 Poisson
               arrivals at half of (a)'s docs/s; (c) ON/OFF bursts
               (0.1 s on, 0.1 s off) at (a)'s docs/s: latency
               percentiles, docs/s, partial flushes, the SLO report
               validated; (d, padded) (b)'s schedule with the
               OnlineLearner on a CUDA stream of its own, then drain(2):
               served versions advance, each batch's γ is its version's
               snapshot's bit for bit, an armed watchdog reading and no
               violation, swap stalls within 50 ms, 1 launch a served
               batch and 2 a learner update, the learner's thread joined
 23. divi    — D-IVI (paper §4), P workers simulated on the card through
               DIVIEngine on the 16,430 documents: Table 2's P = 1, 4, 16
               (B = 1,024 a worker, S = 1, two passes), Fig. 5's P = 4,
               S = 2, delay_prob = 0.5, and P = 4 at B = 1,000 (no
               multiple of K1's tile): 2 launches a sub-round (one grouped
               K1 with its π finish, one K3) at every P, 0 host syncs in
               a round, ms a round, docs/s, held-out LPP beside
               single-host S-IVI at an equal document count, init_frac
               exactly 0 after the cover; the grouped K1 bit for bit
               against one launch a worker and against its twin's loop
               over the workers (at 4,096 and 4,000 documents), its time
               at 16,384 documents, the summed correction against the loop
               over the workers; a mid-run save, load and resume through
               LDA(algo="divi") bit-equal to the run that never stopped
 23b. divi_mesh — D-IVI's mesh round (repro_torch.dist.divi) on the card:
               the corpus and λ₀ written once to an .npz, then 4 ranks of
               one gloo group on cuda:0 (collectives on host copies) run
               the (4, 1) and (2, 2) layouts and 1 NCCL rank (1, 1), each
               two passes at P = 4, B = 1,024, V = 141,952: λ and every
               worker's memo bit-equal to divi_round_emulated run here,
               λ within 5e-4 of the simulation (NCCL's bit-equal), 1 K1
               and 1 K3 a sub-round on every rank, each rank's argument
               bytes equal to the meta dry run's (its peak beside the
               rank's max_memory_allocated), ms a round; NCCL across 4
               ranks needs 4 cards ("nccl_world4" says when it did not
               run)
 24. kcap    — K1, K4, K2, K5, K3, K6, K7 and K8 at K = 300 and 1,000 against
               their twins on the first 256 documents (K8: 16) at the
               Arxiv V, timed beside their bounds (K6 and K7, on the
               tensor cores in two passes, below their twins and beside
               their split's floor); every fixed-point instance's spills;
               at K = 100 the parent commit's bits (sha256 of each
               kernel's outputs on seeded inputs; K1 at one group,
               group = B; K7's re-anchored)
then the pre-fusion baseline and attention:
 25. legacy  — the per-sweep E-step (K6 once per sweep, K7 once) and the
               one-hot memo delta (K8) on phase 3's documents, λ and γ₀:
               each kernel against its twin and timed (K6 and K7 on the
               tensor cores, bound_ms their bf16 x 3 floor there: at
               least 30% of that floor's rate, half their fp32 bound's
               and below their twins; K8 at
               most K2 + K3's device time a call, its peak memory at most
               π + 2·S + 0.5 GB, and again with one id in every document);
               the whole E-step against the same loop over the twins; the
               legacy correction against the fused one (K1–K3), here and
               at BENCH_estep's shape (B = 128, V = 4096, K = 128, L = 64)
 26. attention — flash_mha (K9) at Qwen2.5-3B's attention widths (16 query
               heads, 2 KV heads, hd = 128), B = 1, S = 4096, bf16, causal,
               against its twin, the same bits on two launches, timed beside
               scaled_dot_product_attention; the count of wgmma (HGMMA) and
               TMA load (UTMALDG) instructions in the built library's SASS;
               then fp32, not causal, S = 1000 against mha_ref; then
               (attention_band) K9's sliding window and logit softcap at
               the same widths, in bf16 and fp32, against its twin: W =
               4,096 at S = 8,192, W = 100 at S = 1,000 (padded to 1,024),
               W = 1 (v's rows exactly), the softcap of 50 alone and with
               the window; K9 at S = 32,768 with W = 4,096 against the
               same call without the window (at most half its time: the
               skipped tiles), each beside its bound over the kept pairs;
               at S = 8,192 the window, the softcap and both beside the
               twin and flex_attention (compiled, the band's block mask
               and softcap score_mod), the window also beside SDPA with a
               dense boolean band mask
and the tuner, UCI ingest, CVB0 and Minka's updates (hyper right after
train, the other three after attention, so every earlier phase runs as
it did; each path's launch counts set to 0 just before it and read just
after):
 27. hyper   — α₀ and β₀ by Minka's fixed point from phase 5's γ (α₀ +
               Σ cnt·π over the memo) and λ, in fp32 on the card, against a
               float64 run of the same update on the CPU (rtol HYPER_RTOL)
 28. tune    — repro_torch.tune on the card, the padded task (B = 1,024,
               L = 163) and the CSR one (T = 131,072, 1,024 documents):
               measured seconds (proxy_regime false), the card's device
               kind, every candidate's ms, gate verdict and bits on fresh
               inputs (the held-out documents), the default's and the
               winner's ms; the winner bit-equal to the default on the
               fresh inputs; the store, in a temporary directory, read
               back with one tune.cache hit each by LDA.fit and a CSR
               TopicInferencer
 29. uci     — phase 3's training corpus written with save_uci (gzip),
               parsed (docs/s), the sidecar's second open timed, one IVI
               epoch streamed from it through LDAEngine on each layout
               (docs/s; its launch counts set to 0 just before the epoch
               and read just after it: one K1 or K4 and one K3 an update),
               λ and ⟨m_vk⟩ bit-equal to the same epoch on the
               materialized file
 30. cvb0    — CVB0Engine, one epoch at B = 1,024 with 5 inner
               iterations: ms a mini-batch, 2 K3 launches a step, N_vk
               against Σ cnt·γ over the memo (rtol 1e-3 / atol 1e-2), the
               same bits on a second run, held-out LPP beside phase 5's
               IVI after its first epoch
and, last, the LM template's serving path (every LDA phase first):
 31. lm      — Qwen2.5-3B unreduced (36 layers, d_model 2,048, 16 query
               and 2 KV heads of 128, d_ff 11,008, vocab 151,936) from
               the port's seeded init, its bf16 copy made once; the
               serving checks every LM model below shares
               (lm_serve_checks): a prefill of B = 1, S = 4,096 through
               make_prefill_step launches K9 once an attention layer (36
               here), finite last logits, ms and tokens/s against the
               bound of each token's active weights, K9's share of device
               time, host syncs (one a MoE layer, so 0 here)
               (profile_lm_prefill: device and host time by operation);
               the whole prefill against the same prefill through the
               plain attention (relative L2 of the last logits within the
               model's LM_BF16_REL_L2); 16 prompt tokens decoded through
               make_serve_step against the prefill of them (the same
               bar), no K9 launch in decode (profile_lm_decode);
               launch/serve.py's generate at batch 4, prompt 16, 32 new
               tokens: the same tokens twice, ms and host syncs a decode
               step against the weight-read bound (6.17 GB here). Then
               layer 0's K9 output against its twin at the bf16 bars and
               the same bits on a second launch, and a prefill of S =
               32,768 (prefill_32k with its batch cut from 32 to 1): ms
               against its bound, K9's share, peak memory; and the
               long_500k variant (a window of 4,096 on all 36 layers) at
               S = 8,192: K9 36 times, the last logits against the plain
               route's at the model's bar, ms beside the same prefill
               without the window
 32. lm_moe  — DeepSeekMoE-16B unreduced (28 layers, d_model 2,048, 16
               heads of 128, 64 routed experts of 1,408 at top 6, 2
               shared, layer 0 dense at 10,944, vocab 102,400) from the
               layer-at-a-time bf16 builder (its peak over the weights at
               most twice its largest fp32 piece): the serving checks at
               S = 4,096 (K9 28 times, one host sync a MoE layer in
               prefill and in a decode step, the MoE FFN's share of
               device time, each layer's routing flips against the plain
               route and between decode and prefill, the read bound of
               the experts the decode steps chose); layer 1's FFN
               against fp32 (LM_MOE_FFN_REL_L2, top-k flip share). Then
               Qwen3-MoE-30B-A3B at full width, its depth cut from 48
               layers to 8: the same checks. After each, lm_fp32: the
               agreement checks in fp32 at 8 layers (LM_FP32_REL_L2)
 33. lm_recurrent — zamba2-1.2B unreduced (38 Mamba2 layers, the shared
               attention block on 6): the first shared block's K9 output
               against its twin at the bf16 bars and bit-equal twice; the
               serving checks at S = 4,096 (K9 6 times, no host sync);
               then xLSTM-1.3B at full width, its first 12 layers, its
               prefill cut to 256 tokens (the sLSTM's time loop): no K9
               launch. After each, lm_fp32 at 12 and 4 layers
 34. lm_gemma2 — gemma2-27B at full width (d_model 4,608, 32 query and
               16 KV heads of 128, d_ff 36,864, vocab 256,000, tied; a
               window of 4,096 on its local layers, a logit softcap of 50
               on all), its depth cut from 46 layers to the first 12 (6
               local, 6 global), from the bf16 builder: K9 on layer 0
               (window and softcap) and layer 1 (softcap) against its twin
               on the first 8 heads at S = 8,192; the serving checks at S
               = 8,192, its context length and twice its window (K9 12
               times a prefill); lm_fp32 at 4 layers
and the LM template's training path, after every serving phase:
 35. lm_train — Qwen2.5-3B unreduced from the port's seeded fp32 masters
               (3.086 B; 49.4 GB with gradients and AdamW's moments),
               bf16 compute, remat, AdamW on cosine_schedule, clip 1.0,
               S = 4,096 (train_4k's batch of 256 cut to 4, as 2
               microbatches of 2), 8 steps on one repeated batch: finite
               losses and grad norms, the last loss below the first, no
               K9 launch (training takes the plain chunked attention),
               the host syncs of a step as predicted (one a MoE layer a
               forward, twice under remat: 0 here); the median ms of the
               last 6 steps, tokens/s, peak memory, the model FLOPs'
               share of the dense bf16 peak. lm_train_fp32: at 4 layers
               in fp32, loss, ce and every gradient leaf on the card
               against the same port on the CPU (LM_FP32_REL_L2), and
               microbatches = 2 against 1 after one AdamW step (5e-3).
               Then DeepSeekMoE-16B, zamba2-1.2B (layers 2-5, the last
               applying the shared block) and xLSTM-1.3B at full width
               and 4 layers, 3 steps each (DeepSeekMoE's lb_loss in its
               loss); lm_train_iag: IAG over 8 shards at 4 layers, two
               passes, the aggregate against the memo's sum (1e-5)
and the LM template over a device mesh, after it:
 36. lm_mesh — repro_torch.sharding on a (2, 2) ("data", "model") mesh of
               4 gloo ranks time-slicing the one card (collectives on
               host copies), each rank building only its blocks, layer by
               layer: Qwen2.5-3B unreduced in bf16, a prefill at B = 2, S
               = 4,096 (K9 36 times on every rank, over its 8 query heads
               and its KV head) and 1 decode step at B = 4 after a
               1-token prompt (no K9), the ranks' rows of the last logits
               against the unsharded model here at its bf16 bar; the same
               at 4 layers in fp32 at 1e-3; DeepSeekMoE-16B's first 4
               layers (32 experts a model rank), the first MoE block
               against moe_block_emulated on the card at the bf16 bars,
               counts and drops exactly; the recurrent models, their
               blocks split by heads over model: zamba2-1.2B's first 6
               layers in bf16 (its bar) and fp32 (1e-3), K9 once a rank
               a prefill (the shared block on the rank's 16 heads), and
               xLSTM-1.3B's first 2 layers in fp32 at S = 256, the same
               prefill and decode step; each rank's argument and
               collective bytes (a decode step's state restore apart)
               equal to the meta dry run's (launch/dryrun.py),
               max_memory_allocated beside its peak (the recurrent
               models' within 1.5 × it + 1 GiB); then 1 NCCL rank at
               (1, 1), bit-equal to ctx=None. Then
               in the same ranks, training over the mesh (lm_mesh_train):
               (a) Qwen2.5-3B unreduced, bf16 over fp32 masters, remat,
               AdamW, clip 1.0, S = 4,096, B = 2, 2 steps; (b) the NCCL
               rank's (1, 1) step bit-equal to ctx=None, and the (2, 2)
               loss, grad norm and layer 0's and the last layer's
               gradients against its unsharded step; (c) 4 layers in fp32,
               every gradient and parameter against the unsharded step,
               microbatches 2 and seq_shard against 1, at 1e-3; (d)
               DeepSeekMoE-16B's first 4 layers, 2 steps at S = 1,024;
               every step's bytes by kind equal to the dry run's, no K9
               launch
Then the ``kernels`` summary line (K9's row with ``launches_lm``,
``launches_lm_moe``, ``launches_lm_recurrent``, ``launches_lm_gemma2``,
``launches_lm_long_500k``, ``launches_lm_mesh`` and the window's and
softcap's checks and times under ``band``)
and, last, the ``ok`` line.
It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the kernels' bounds: bytes and operations over the H100 SXM's published
# peaks (HBM3 bytes/s, fp32 outside the tensor cores, bf16 dense tensor
# cores), one copy of the formulas in the port's tuner model
from repro_torch.tune.model import (  # noqa: E402  (the checkout's src)
    BF16_OPS_PER_S, FP32_OPS_PER_S, HBM_BYTES_PER_S, attention_work,
    bound_ms, dense_bound, fixed_point_csr_work, fixed_point_work,
    onehot_work, pi_finish_work, scatter_work, sweep_tc_bound,
    token_pi_work)
# K6 and K7 at the legacy shape: at least this share of their tensor-core
# floor's rate, sweep_tc_bound (K6 reached 45% of it on an NVIDIA H100
# 80GB HBM3 at 700 W): ms <= 0.4527 / 0.30 = 1.509 ms
DENSE_FLOOR_SHARE = 0.30
# K2 and K5 at the path's shapes: at least this share of their byte bound,
# by device time. On an NVIDIA H100 80GB HBM3 at 700 W the runs of slots
# reached 0.49-0.51 of it and the first port's one-warp-a-slot kernels
# 0.34, so a fall back to that speed fails the run
PI_BOUND_SHARE = 0.42
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
# K9's sliding window and logit softcap at those widths: (name, S, window,
# softcap, scale). Every windowed case runs at S above its window (at S =
# 4,096 a window of 4,096 masks nothing); W = 100 at S = 1,000 pads to
# 1,024 in flash_mha; W = 1 keeps each row's own key alone, so the output
# is v's row bit for bit; the softcap cases run at scale 1, where the
# logits (standard deviation √hd = 11.3) reach gemma2's cap of 50
K9_BAND_CASES = (("w4096_s8192", 8192, 4096, None, None),
                 ("w100_s1000", 1000, 100, None, None),
                 ("w1_s1000", 1000, 1, None, None),
                 ("cap50_s8192", 8192, None, 50.0, 1.0),
                 ("w4096_cap50_s8192", 8192, 4096, 50.0, 1.0))
K9_BAND_WINDOW = 4096       # gemma2's local window, the long_500k variant's
# the window's tile skip, timed at prefill_32k's length against the same
# call without it: the window keeps 23.4% of the causal pairs there, and
# the windowed call may take at most this share of the causal one's time
K9_BAND_LONG_S = 32_768
K9_BAND_SKIP_SHARE = 0.5
# timed beside its twin and SDPA (the twin's fp32 scores: 4.3 GB)
K9_BAND_S = 8192
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


T_START = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        # when the phase ended, in seconds from the script's start
        obj = dict(obj, t_end_s=time.perf_counter() - T_START)
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


def profiled(fn, reps: int):
    """torch.profiler's device events over ``reps`` calls of ``fn`` after
    one warm-up. A session that recorded no device time at all is taken
    again, twice at most: the profiler once came back empty from a whole
    session in a run of this script on the H100 while the sessions before
    and after it recorded as usual."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if sum(e.self_device_time_total for e in events) > 0:
            break
    return events


def kernels_ms(fn, kernels, reps: int = 10):
    """Mean device time of one launch of each CUDA kernel whose name holds
    one of ``kernels`` (``fn`` launches each once), from one profiler
    session over ``reps`` calls after one warm-up: the kernels alone,
    where a wrapper's host work may outlast them and hold back
    back-to-back calls. The mean is over the launches the profiler
    recorded: it can miss the first ones while it starts up (with 5 ms
    kernels it kept 3 of 5). A session that recorded no launch of one of
    ``kernels`` is taken again, twice at most: in one run of this script
    on the H100 a session of ``kcap`` recorded device time but no launch
    of token_pi_kernel, which every earlier run had recorded."""
    for _ in range(3):
        events = profiled(fn, reps)
        if all(any(kernel in e.key and e.count > 0 for e in events)
               for kernel in kernels):
            break
    out = {}
    for kernel in kernels:
        mine = [e for e in events if kernel in e.key]
        total = sum(e.self_device_time_total for e in mine)
        launches = sum(e.count for e in mine)
        check(total > 0 and 0 < launches <= reps,
              f"kernel_ms: {launches} launches of {kernel} recorded")
        out[kernel] = total / 1e3 / launches
    return out


def kernel_ms(fn, kernel: str, reps: int = 10) -> float:
    """``kernels_ms`` of one kernel."""
    return kernels_ms(fn, (kernel,), reps)[kernel]


def device_ms(fn, reps: int = 10) -> float:
    """Mean device time of one call of ``fn``: every kernel and memset it
    launches (a wrapper's preparation included), by torch.profiler over
    ``reps`` calls after one warm-up. Unlike ``cuda_ms``, host time
    between the launches does not count."""
    total = sum(e.self_device_time_total for e in profiled(fn, reps))
    check(total > 0, "device_ms: no device time recorded")
    return total / 1e3 / reps


def paired_device_ms(fns, rounds: int = 3, reps: int = 10):
    """``device_ms`` of each of ``fns``, measured in turns (``rounds``
    profiler sessions each) and averaged, so that a change of the card's
    clocks between two sessions falls on each alike."""
    sums = [0.0] * len(fns)
    for _ in range(rounds):
        for i, fn in enumerate(fns):
            sums[i] += device_ms(fn, reps)
    return [x / rounds for x in sums]


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
    ptxas = build.BUILD_INFO["lda_estep"]["ptxas"]
    spills = fixed_point_spills(ptxas, -(-TOPICS // 32))
    if spills != [[0, 0]]:
        emit({"phase": "build", "ptxas": ptxas})
    check(spills == [[0, 0]],
          f"fixed_point_kernel spills at K = {TOPICS}: {spills}")
    # K6's and K7's tensor-core instances (one launch at K <= 64 and K <=
    # 128; the product passes above 128 topics) and the R pass's two
    # kernels: the six products' operands and accumulators fit the block's
    # 255 registers a thread, and ptxas serializes no wgmma
    dense = {name: kernel_spills(ptxas, fragment)
             for name, fragment in DENSE_INSTANCES.items()}
    check(all(x == [[0, 0]] for x in dense.values()),
          f"K6/K7 instances spill (or are missing): {dense}")
    serialized = [ln for ln in ptxas if "serialized" in ln]
    check(not serialized, f"ptxas serialized wgmma: {serialized}")
    registers = {name: kernel_registers(ptxas, fragment)
                 for name, fragment in DENSE_INSTANCES.items()}
    # K8's instances: none spills at K <= 128, the tiled one as this
    # source builds it (ONEHOT_SPILLS)
    onehot = {name: kernel_spills(ptxas, f"onehot_kernelILi{name[3]}ELb"
                                         f"{int(name.endswith('tiled'))}E")
              for name in ONEHOT_SPILLS}
    check(onehot == ONEHOT_SPILLS, f"onehot_kernel spills: {onehot}")
    # K2's and K5's instances (KPL = 1 ... 8 and the wide body, each
    # layout): none spills
    pi = kernel_spills(ptxas, "token_pi_kernel")
    check(len(pi) == 18 and all(x == [0, 0] for x in pi),
          f"token_pi_kernel instances spill (or are missing): {pi}")
    # K3's instances, KPL = 1 ... 8: KPL = 4 as K3_PARENT_SPILLS says,
    # every other at 0
    scatter = {f"kpl{kpl}": kernel_spills(
        ptxas, f"segment_scatter_kernelILi{kpl}E")
        for kpl in range(1, 9)}
    want = {name: K3_PARENT_SPILLS.get(name, [[0, 0]]) for name in scatter}
    check(scatter == want,
          f"segment_scatter_kernel spills (or missing instances): "
          f"{ {n: x for n, x in scatter.items() if x != want[n]} }")
    emit({"phase": "build", "seconds": seconds,
          "fixed_point_spill_bytes": spills,
          "dense_spill_bytes": dense, "dense_registers": registers,
          "onehot_spill_bytes": onehot, "token_pi_spill_bytes": pi,
          "segment_scatter_spill_bytes": scatter,
          "libraries": build.BUILD_INFO})


def fixed_point_spills(ptxas, kpl):
    """Spill stores and loads (bytes) of each fixed_point_kernel instance
    for ``kpl`` topics a lane (0: the wide kernel above 256 topics), from
    ptxas's report."""
    return kernel_spills(ptxas, "fixed_point_wide_kernel" if kpl == 0
                         else f"fixed_point_kernelILi{kpl}E")


def kernel_registers(ptxas, fragment):
    """Registers a thread of each kernel whose mangled name holds
    ``fragment``, from ptxas's report (its "Used N registers" line follows
    the kernel's properties)."""
    import re
    out, current = [], None
    for ln in ptxas:
        if "Function properties" in ln:
            current = ln
        m = re.search(r"Used (\d+) registers", ln)
        if m and current is not None and fragment in current:
            out.append(int(m.group(1)))
            current = None
    return out


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


def fixed_point_bound(ids, cnts, k, sweeps, tiles):
    """K1's bound for this run's sweeps: 4·K operations a live slot and
    Eθ's series a row each sweep of its tile (``tiles``: (first row, rows)
    per tile, ``lda_estep.fixed_point_tiles``), plus the tokens, the
    distinct Eφ rows and γ₀, γ, Eθ moved once. Returns (bound ms, bound by,
    bound ms without the π finish)."""
    import torch
    b, l = ids.shape
    tile_live = [int((cnts[lo:lo + n] != 0).sum()) for lo, n in tiles]
    distinct = int(torch.unique(ids[cnts != 0]).numel())
    nbytes, ops = fixed_point_work(b, l, k, distinct, tile_live,
                                   [n for _, n in tiles],
                                   sweeps.cpu().tolist())
    bms0, _ = bound_ms(nbytes, ops)
    fin_bytes, fin_ops = pi_finish_work(b * l, k, sum(tile_live))
    bms, by = bound_ms(nbytes + fin_bytes, ops + fin_ops)
    return bms, by, bms0


def check_fixed_point(args, label, block_b=128, group=None):
    """K1 against its plain twin on one set of inputs. γ is held at 2e-3
    and the tile sweeps within 1; Eθ at rtol 1e-4 / atol 1e-6 in every
    tile whose sweep count agrees with the twin's (a tile one sweep apart
    is held at γ's tolerance). A second launch must give the same bits
    (γ, Eθ and the tile sweeps). ``group``: the tiles cut within groups of
    that many rows (D-IVI's stacked workers), the twin looping over the
    groups. Returns the errors, the tile sweeps and the bound for this
    run's sweeps."""
    import torch
    from repro_torch.kernels import lda_estep

    ids, cnts, eb, gamma0 = args[:4]
    (b, k), l = gamma0.shape, ids.shape[1]
    kw = dict(block_b=block_b, group=group)
    g, et, it = lda_estep.estep_fixed_point(*args, **kw)
    again = lda_estep.estep_fixed_point(*args, **kw)
    check(all(torch.equal(x, y) for x, y in zip((g, et, it), again)),
          f"fixed_point ({label}): two launches differ")
    pg, pet, pit = lda_estep.estep_fixed_point_plain(*args, **kw)
    sweep_gap = int((it - pit).abs().max())
    check(sweep_gap <= 1, f"fixed_point ({label}): tile sweeps {it} vs {pit}")
    gerr = float((g - pg).abs().max())
    check(torch.allclose(g, pg, rtol=2e-3, atol=2e-3),
          f"fixed_point ({label}): γ off by {gerr}")
    tiles = lda_estep.fixed_point_tiles(b, block_b, group)
    same = (it == pit).repeat_interleave(
        torch.tensor([n for _, n in tiles], device=it.device))
    eterr = float((et - pet)[same].abs().max()) if bool(same.any()) else 0.0
    check(torch.allclose(et[same], pet[same], rtol=1e-4, atol=1e-6)
          and torch.allclose(et, pet, rtol=2e-3, atol=2e-3),
          f"fixed_point ({label}): Eθ off by {eterr}")
    bms, by, bms0 = fixed_point_bound(ids, cnts, k, it, tiles)
    return {"max_abs_err": gerr, "max_abs_err_etheta": eterr,
            "tol": "γ rtol=atol=2e-3; Eθ rtol=1e-4 atol=1e-6 in tiles whose "
                   "sweeps agree; tile sweeps within 1",
            "sweep_gap": sweep_gap, "tile_sweeps": it.cpu().tolist(),
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


def finish_times(row, pi_bytes):
    """The π finish's own device time (the fixed point's kernel with it
    less without it) beside the bound with it less without it (small
    where the sweeps' operations bound the kernel) and the time to write
    π's ``pi_bytes`` once."""
    return {"finish_ms": row["kernel_ms"] - row["kernel_ms_without_pi"],
            "finish_bound_ms": row["bound_ms"] - row["bound_ms_without_pi"],
            "finish_write_bound_ms": pi_bytes / HBM_BYTES_PER_S * 1e3}


def pi_times(run, plain, kernel, nbytes, ops, timer, reps=20):
    """K2's or K5's times on one batch: events over back-to-back calls
    (``ms``, the wrapper's host work included where it outlasts the
    kernel), the kernel's device time by the profiler (``kernel_ms``), its
    twin's, and its bound (π written once, the tokens, the distinct Eφ
    rows and Eθ read once; 4 operations a live topic)."""
    bms, by = bound_ms(nbytes, ops)
    kms = kernel_ms(run, kernel, reps)
    return {"ms": timer(run, reps), "kernel_ms": kms,
            "plain_ms": timer(plain, 5), "bound_ms": bms, "bound_by": by,
            "bound_share": bms / kms, "library_ms": None}


def gate_pi(row, name):
    check(row["bound_share"] >= PI_BOUND_SHARE,
          f"{name}: {row['kernel_ms']} ms of device time, "
          f"{row['bound_share']:.3f} of its {row['bound_ms']} ms bound "
          f"(at least {PI_BOUND_SHARE} required)")


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
    finish = finish_times(out["fixed_point"], b * l * k * 4)
    out["fixed_point"]["finish_ms"] = finish["finish_ms"]
    lib = build.load()
    grid = lib.lda_fixed_point_blocks(b, l, k, 128, b)
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
    out["token_pi"] = pi_times(
        lambda: lda_estep.token_pi(ids, cnts, eb, et),
        lambda: lda_estep.token_pi_plain(ids, cnts, eb, et), "token_pi_kernel",
        *token_pi_work(8, b * l, b, k, distinct, live), timer)
    out["token_pi"].update(max_abs_err=errs[False],
                           max_abs_err_bf16=errs[True],
                           tol="rtol=1e-5 atol=1e-6 fp32; 1 bf16 ulp with "
                               "quantize")
    gate_pi(out["token_pi"], "token_pi")

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

    bms, by = bound_ms(*scatter_work(live, v, k))
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
          # the π finish's device time beside its bounds (computed, so
          # kept out of the kernels line)
          "finish": finish,
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


def phase_profile(step, updates=4, phase="profile", regions=()):
    """Where one update's time goes: ``torch.profiler`` over ``updates``
    more updates (``step()`` runs one, after every check above), device
    time by operation, the device's idle share of the wall time, and the
    host's time by operation (its own CPU time). With ``regions``, the
    names of ``record_function`` ranges that ``step`` opens, also each
    region's device time (``region_device_ms``) and share of the busy
    time; returns them."""
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
    # kernels' device time as well, and would count it twice; a range's
    # device-side annotation is a span, not a kernel
    averages = prof.key_averages()
    ops = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in averages
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0 and e.key not in regions),
                 key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in ops)
    # where the host's time goes: operations by their own CPU time
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in averages
                   if e.self_cpu_time_total > 0), key=lambda r: -r[1])
    shares = {}
    if regions:
        shares = {r: {"device_ms": ms, "share": ms / busy_ms} for r, ms in
                  region_device_ms(prof.events(), regions).items()}
    emit({"phase": phase, "updates": updates, "wall_ms": wall_ms,
          "device_busy_ms": busy_ms,
          "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
          **({"regions": shares} if regions else {}),
          "top_device_ms": [{"op": k[:80], "ms": ms, "count": n}
                            for k, ms, n in ops[:12]],
          "top_host_ms": [{"op": k[:80], "ms": ms, "count": n}
                          for k, ms, n in host[:12]]})
    return shares


BACKWARD_NODE = "autograd::engine::evaluate_function"


def region_device_ms(events, regions):
    """Device ms of the kernels launched inside each region: by a host
    operation inside a ``record_function(region)`` range, or inside the
    backward of an autograd node that such an operation made (linked by
    its thread and sequence number; under remat the recompute runs the
    range again, and the nodes run in the backward are the first
    forward's)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in events if e.device_type != cuda]

    def under(e, marked):
        while e is not None:
            if marked(e):
                return True
            e = e.cpu_parent
        return False

    out = {}
    for region in regions:
        made = {(e.thread, e.sequence_nr) for e in host if e.sequence_nr >= 0
                and under(e, lambda x: x.name == region)}

        def marked(e):
            return e.name == region or (
                e.name.startswith(BACKWARD_NODE)
                and (e.fwd_thread, e.sequence_nr) in made)
        out[region] = sum(e.self_device_time_total for e in host
                          if under(e, marked)) / 1e3
    return out


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
    nbytes, ops = fixed_point_csr_work(live, b, k, distinct, sweeps)
    bms0, _ = bound_ms(nbytes, ops)
    # the π finish: the flat (T, K) π written, 4 operations a live topic
    fin_bytes, fin_ops = pi_finish_work(ids.numel(), k, live)
    bms, by = bound_ms(nbytes + fin_bytes, ops + fin_ops)
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
            "grid_blocks": lib.lda_fixed_point_blocks(b, rows, k, b, b),
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
    finish = finish_times(out["fixed_point_csr"], t * k * 4)
    out["fixed_point_csr"]["finish_ms"] = finish["finish_ms"]

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
    out["token_pi_csr"] = pi_times(
        lambda: lda_estep.token_pi_csr(ids, cnts, segs, eb, et),
        lambda: lda_estep.token_pi_csr_plain(ids, cnts, segs, eb, et),
        "csr_token_pi_kernel", *token_pi_work(12, t, b, k, distinct, live),
        timer)
    out["token_pi_csr"].update(max_abs_err=errs[False],
                               max_abs_err_bf16=errs[True],
                               tol="rtol=1e-5 atol=1e-6 fp32; 1 bf16 ulp "
                                   "with quantize")
    gate_pi(out["token_pi_csr"], "token_pi_csr")

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
          "finish": finish, "kernels": out})
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
    # K6 and K7 run on the tensor cores (bf16 x 3), so their bound is the
    # split's floor there, not the fp32 SIMT bound (which they beat; kept
    # in `derived`). Gated at 30% of that floor's rate (1.51 ms here), half
    # the fp32 bound's rate, and below their twins' two cuBLAS products
    for name, rows in (("sweep", bp), ("sstats", vp)):
        kd = out[name]
        kd["tol"] = "rtol=atol=2e-5 (fp32 twin, no TF32; products bf16 x 3)"
        fp32_bound = kd["bound_ms"]
        kd["bound_ms"], kd["bound_by"] = sweep_tc_bound(bp, vp, kp, rows)
        check(kd["ms"] * DENSE_FLOOR_SHARE <= kd["bound_ms"]
              and kd["ms"] <= 2 * fp32_bound and kd["ms"] < kd["plain_ms"],
              f"{name}: {kd['ms']} ms against {DENSE_FLOOR_SHARE} of its "
              f"tensor-core floor's rate ({kd['bound_ms']} ms), twice its "
              f"fp32 bound {2 * fp32_bound} and its twin's {kd['plain_ms']}")

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
    estep["bound_ms"] = (sweep_tc_bound(bp, vp, kp)[0] * sweeps
                         + sweep_tc_bound(bp, vp, kp, vp)[0])

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
    # no (nb, Vp, K) partial: π, S_new, S_old and the sort's scratch
    budget = b * l * k * 4 + 2 * v * k * 4 + 500_000_000
    check(peak <= budget, f"memo_delta_onehot: {peak} bytes above the "
                          f"baseline, more than π + 2·S + 0.5 GB = {budget}")
    # a frequent word: one id in every document (the block sums its
    # segment by B tiles), against the twin and timed
    ids_hot = ids.clone()
    ids_hot[:, 0] = int(ids[0, 0])
    ebt_hot = eb[ids_hot.long()].contiguous()
    hot = (ids_hot, cnts, ebt_hot, et, v)
    got_hot = lda_estep.memo_delta_onehot(*hot, old_pi=old_pi)
    want_hot = lda_estep.memo_delta_onehot_plain(*hot, old_pi)
    hot_err = max(float((x - y).abs().max())
                  for x, y in zip(got_hot, want_hot))
    check(torch.allclose(got_hot[0], want_hot[0], rtol=1e-5, atol=1e-6)
          and all(torch.allclose(x, y, rtol=1e-4, atol=1e-4)
                  for x, y in zip(got_hot[1:], want_hot[1:])),
          f"memo_delta_onehot (one id in every document): off its twin by "
          f"{hot_err}")
    del got_hot, want_hot
    nb = b // lda_estep.delta_effective_block_b(b, l, k)
    # device time a call, the preparation included (the host-clocked ms
    # below are mostly the wrappers' launch overhead at this size), K8
    # and K2 + K3 in turns: with K2's runs of slots they lie within ~5% of
    # each other on an H100
    k8_ms, k2_k3_ms = paired_device_ms((
        lambda: lda_estep.memo_delta_onehot(ids, cnts, ebt, et, v,
                                            old_pi=old_pi),
        lambda: lda_estep.memo_delta(ids, cnts, eb, et, v, old_pi=old_pi)))
    hot_ms, hot_k2_k3_ms = paired_device_ms((
        lambda: lda_estep.memo_delta_onehot(*hot, old_pi=old_pi),
        lambda: lda_estep.memo_delta(ids_hot, cnts, eb, et, v,
                                     old_pi=old_pi)))
    bms, by = bound_ms(*onehot_work(b * l, k, v, live, etheta_rows=b))
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
        "device_ms": k8_ms, "k2_k3_device_ms": k2_k3_ms,
        "kernel_ms": kernel_ms(lambda: lda_estep.memo_delta_onehot(
            ids, cnts, ebt, et, v, old_pi=old_pi), "onehot_kernel"),
        "one_id_in_every_document": {
            "max_abs_err": hot_err,
            "ms": timer(lambda: lda_estep.memo_delta_onehot(
                *hot, old_pi=old_pi), 5),
            "k2_k3_ms": timer(lambda: lda_estep.memo_delta(
                ids_hot, cnts, eb, et, v, old_pi=old_pi), 5),
            "device_ms": hot_ms, "k2_k3_device_ms": hot_k2_k3_ms},
        "bound_ms": bms, "bound_by": by, "library_ms": None}
    del hot, ids_hot, ebt_hot
    k8 = out["memo_delta_onehot"]
    check(k8["device_ms"] <= k8["k2_k3_device_ms"],
          f"memo_delta_onehot: {k8['device_ms']} device ms a call, slower "
          f"than K2 + K3's {k8['k2_k3_device_ms']}")
    # bounds and sizes derived from the shapes: this line only, never the
    # kernels line, which carries measured numbers and bound_ms alone.
    # K6's floor on the tensor cores (its bound_ms; K7's is the same, both
    # bound by operations) beside the fp32 SIMT bound of the kernels they
    # replaced
    derived = {
        "sweep_sstats_bound_ms_unpadded": dense_bound(b, v, k)[0],
        "sweep_bound_tc_ms": sweep_tc_bound(bp, vp, kp)[0],
        "sweep_bound_fp32_simt_ms": dense_bound(bp, vp, kp)[0],
        "floor_share": {n: out[n]["bound_ms"] / out[n]["ms"]
                        for n in ("sweep", "sstats")},
        "onehot_b_tiles": nb, "onehot_peak_budget_bytes": budget}
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
    # Q·Kᵀ and P·V over the (query, key) pairs computed
    nbytes, ops_count = attention_work(b, s, h, kvh, hd)
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
    del q, k, v, got, want
    row["band"] = attention_band(device, timer)
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


def band_library(s, device):
    """The library call that computes K9's band at length ``s``:
    ``torch.compile(flex_attention)`` (compiled in this process, no worker
    processes), its block masks (``"causal"``, ``"window"``: K9_BAND_WINDOW
    keys back, so that it skips the tiles outside the band as K9 does) and
    ``softcapped(cap)``, the score_mod ``cap·tanh(x / cap)`` on the scaled
    score, one function a cap: two compiles in all, with and without the
    cap. Used only to time the library beside K9; the port never calls
    it."""
    import functools
    import torch
    import torch._inductor.config
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    torch._inductor.config.compile_threads = 1

    def banded(keys):
        # the band's width a tensor, not a constant: one compiled kernel
        # serves both masks
        width = torch.tensor(keys, device=device)

        def mask_mod(b, h, q, k):
            return (q >= k) & (q - k < width)
        return mask_mod

    masks = {name: create_block_mask(banded(keys), None, None, s, s,
                                     device=device)
             for name, keys in (("causal", s), ("window", K9_BAND_WINDOW))}

    @functools.lru_cache(maxsize=None)
    def softcapped(cap):
        def score_mod(score, b, h, q, k):
            return cap * torch.tanh(score / cap)
        return score_mod

    return torch.compile(flex_attention, dynamic=False), masks, softcapped


def attention_band(device, timer):
    """K9's sliding window and logit softcap (K9_BAND_CASES) at Qwen2.5-3B's
    attention widths through flash_mha, one launch each, against the twin
    on the unpadded inputs: in bf16 at the bf16 bars and in fp32 at 2e-5,
    W = 1 equal to v. Then in bf16: K9 at S = 32,768 with a window of
    4,096 against the same call without it, in turns (at most
    K9_BAND_SKIP_SHARE of its time: the skipped tiles), each beside its
    bound (its kept pairs' operations); at S = 8,192 each band (the window,
    the softcap, both) beside the twin and the library's one call,
    flex_attention compiled with the band's block mask and softcap
    score_mod (band_library), and the window also beside
    scaled_dot_product_attention with a dense boolean band mask; each
    library output held to the twin."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    qa = QWEN_ATTENTION
    h, kvh, hd = qa["h"], qa["kv"], qa["hd"]
    gen = torch.Generator(device=device).manual_seed(2)

    def inputs(s, dtype):
        return [torch.randn((1, s, n, hd), generator=gen, device=device)
                .to(dtype) for n in (h, kvh, kvh)]

    def heads(x):
        return x[0].transpose(0, 1).contiguous()          # (heads, S, hd)

    checks = {}
    for dtype, tol in ((torch.bfloat16, (BF16_RTOL, BF16_ATOL)),
                       (torch.float32, (2e-5, 2e-5))):
        for name, s, window, cap, scale in K9_BAND_CASES:
            label = f"{name}_{str(dtype).split('.')[-1]}"
            band = dict(window=window, softcap=cap, scale=scale)
            q, k, v = inputs(s, dtype)
            fa.reset_launches()
            got = heads(ops.flash_mha(q, k, v, causal=True, **band))
            torch.cuda.synchronize()
            launched = fa.LAUNCHES["flash_attention"]
            check(launched == 1,
                  f"attention_band: {label}: flash_mha launched K9 "
                  f"{launched} times")
            want = fa.flash_attention_plain(heads(q), heads(k), heads(v),
                                            causal=True, **band)
            err = float((got.float() - want.float()).abs().max())
            check(torch.allclose(got.float(), want.float(), rtol=tol[0],
                                 atol=tol[1]),
                  f"attention_band: K9 {label} off its twin by {err}")
            entry = {"S": s, "padded_to": -(-s // 128) * 128,
                     "window": window, "softcap": cap, "scale": scale,
                     "max_abs_err": err,
                     "tol": f"rtol={tol[0]} atol={tol[1]}"}
            if window == 1:
                check(torch.equal(got, heads(v).repeat_interleave(
                    h // kvh, 0)), f"attention_band: K9 {label} is not v")
                entry["equals_v"] = True
            checks[label] = entry
            del q, k, v, got, want
    torch.cuda.empty_cache()

    def bound(s, window):
        nbytes, ops_count = attention_work(1, s, h, kvh, hd, window)
        bms, by = bound_ms(nbytes, ops_count, BF16_OPS_PER_S)
        return {"bound_ms": bms, "bound_by": by, "bound_ops": ops_count}

    # the tile skip at S = 32,768: causal, window, window, causal --------
    w, s = K9_BAND_WINDOW, K9_BAND_LONG_S
    qf, kf, vf = (heads(x) for x in inputs(s, torch.bfloat16))
    runs = {"causal": {}, "window": {"window": w}}
    ms = {name: [] for name in runs}
    for name in ("causal", "window", "window", "causal"):
        ms[name].append(timer(lambda: fa.flash_attention(
            qf, kf, vf, causal=True, **runs[name]), 5))
    timed = {f"{name}_s{s}": {"ms": sum(ms[name]) / 2, "ms_runs": ms[name],
                              "window": runs[name].get("window"),
                              **bound(s, runs[name].get("window"))}
             for name in runs}
    share = timed[f"window_s{s}"]["ms"] / timed[f"causal_s{s}"]["ms"]
    out = fa.flash_attention(qf, kf, vf, causal=True, window=w)
    check(bool(torch.isfinite(out.float()).all()),
          f"attention_band: K9 at S={s}, W={w}: values")
    check(share <= K9_BAND_SKIP_SHARE,
          f"attention_band: K9 at S={s} with W={w} took {share} of the "
          f"causal call's time, more than {K9_BAND_SKIP_SHARE}")
    timed[f"window_over_causal_s{s}"] = share
    timed[f"kept_pairs_share_s{s}"] = (timed[f"window_s{s}"]["bound_ops"]
                                       / timed[f"causal_s{s}"]["bound_ops"])
    del qf, kf, vf, out

    # S = 8,192: each band beside the twin and flex_attention -------------
    s = K9_BAND_S
    qf, kf, vf = (heads(x) for x in inputs(s, torch.bfloat16))
    q4, k4, v4 = (x.unsqueeze(0) for x in (qf, kf, vf))
    pos = torch.arange(s, device=device)
    dense = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < w)
    flex, flex_masks, softcapped = band_library(s, device)

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=dense,
                                              enable_gqa=True)

    for name, band in (("causal", {}), ("window", dict(window=w)),
                       ("softcap", dict(softcap=50.0, scale=1.0)),
                       ("window_softcap", dict(window=w, softcap=50.0,
                                               scale=1.0))):
        entry = {"ms": timer(lambda: fa.flash_attention(
                     qf, kf, vf, causal=True, **band), 10),
                 "plain_ms": timer(lambda: fa.flash_attention_plain(
                     qf, kf, vf, causal=True, **band), 3),
                 **band, **bound(s, band.get("window"))}
        if name != "causal":
            mask = flex_masks["window" if "window" in band else "causal"]
            cap = band.get("softcap")

            def library():
                return flex(q4, k4, v4, block_mask=mask, enable_gqa=True,
                            score_mod=softcapped(cap) if cap else None,
                            scale=band.get("scale"))

            want = fa.flash_attention_plain(qf, kf, vf, causal=True, **band)
            lib_rel = rel_l2(library()[0], want)
            del want
            check(lib_rel <= LIBRARY_REL_L2,
                  f"attention_band: flex_attention's {name} off the twin "
                  f"by {lib_rel}")
            entry.update(library_ms=timer(library, 10),
                         library_call="torch.compile(flex_attention)(block_"
                                      "mask=" + ("window" if "window" in band
                                                 else "causal")
                                      + (", score_mod=softcap" if cap else "")
                                      + ", enable_gqa)",
                         rel_l2_err_library_vs_twin=lib_rel)
        if name == "window":
            # the same band as a dense boolean mask: SDPA visits every tile
            want = fa.flash_attention_plain(qf, kf, vf, causal=True, **band)
            sdpa_rel = rel_l2(sdpa()[0], want)
            del want
            check(sdpa_rel <= LIBRARY_REL_L2,
                  f"attention_band: SDPA's band off the twin by {sdpa_rel}")
            entry.update(sdpa_dense_mask_ms=timer(sdpa, 10),
                         rel_l2_err_sdpa_vs_twin=sdpa_rel)
        timed[f"{name}_s{s}"] = entry
    del qf, kf, vf, q4, k4, v4, dense, flex_masks
    torch.cuda.empty_cache()
    emit({"phase": "attention_band",
          "shape": {"B": 1, "H": h, "KV": kvh, "hd": hd, "causal": True},
          "checks": checks, "timed": timed})
    return {"checks": checks, "timed": timed}


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
                                                   double_buffer=True,
                                                   on=False))
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
# the online serving service: admission, snapshots, the SLO loop and the
# background IVI learner
# ---------------------------------------------------------------------------

SERVICE_BURST = 32_768         # (a) replayed at t = 0
SERVICE_REQUESTS = 16_384      # (b), (c) and (d)
SERVICE_FLUSH_S = 0.020        # the launcher's flush timeout
SERVICE_LOAD = 0.5             # (b): Poisson at half of (a)'s docs/s
SERVICE_ON_OFF_S = 0.1         # (c): ON and OFF spans at (a)'s docs/s
SERVICE_SYNC_DOCS = 4 * BATCH  # the burst whose host syncs are counted
# (d)'s learner, on (b)'s schedule (padded): its window, memo width,
# mini-batch, cadence and the new documents a pass waits for
LEARNER = dict(capacity=16_384, max_unique=256, batch_size=BATCH,
               cadence_s=0.25, min_new_docs=1024)
SWAP_STALL_BOUND_MS = 50.0     # repro's bound on a publish's swap stall
LEARNER_JOIN_S = 120.0


def service_requests(docs, arrivals):
    """Requests over the held-out documents, cycled in the launcher's
    seeded order (``default_rng(0).choice``)."""
    import numpy as np
    from repro_torch.serve import requests_from_docs
    order = np.random.default_rng(0).choice(len(docs), size=len(arrivals))
    return requests_from_docs([docs[i] for i in order], arrivals)


def service_run(inf, reqs, learner=None):
    """One open-loop ``ServingService`` run over ``reqs`` (the learner,
    when given, started just before and stopped just after), the launch
    counts set to 0 just before and read just after. Returns the service,
    each served batch with its responses, the launches and the validated
    SLO report; fails unless every request was served."""
    from repro_torch.kernels import lda_estep
    from repro_torch.serve import (ServiceConfig, ServingService,
                                   validate_slo_report)
    svc = ServingService(inf, learner=learner, config=ServiceConfig(
        flush_timeout_s=SERVICE_FLUSH_S))
    served = []
    real = svc._serve_batch

    def record(batch):
        n0 = len(svc.responses)
        real(batch)
        served.append((batch, svc.responses[n0:]))

    svc._serve_batch = record
    lda_estep.reset_launches()
    if learner is not None:
        learner.start()
    try:
        svc.run(reqs)
    finally:
        if learner is not None:
            try:
                learner.stop(timeout=LEARNER_JOIN_S)
            except RuntimeError as e:
                fail(f"service: {e}")
    launches = dict(lda_estep.LAUNCHES)
    rep = validate_slo_report(svc.slo_report())
    check(rep["conservation_ok"] and rep["served"] == rep["offered"]
          == len(reqs) and rep["shed"] == rep["pending"] == 0,
          f"service: {rep['offered']} offered, {rep['served']} served, "
          f"{rep['shed']} shed, {rep['pending']} pending of {len(reqs)}")
    return svc, served, launches, rep


def service_line(svc, rep, served, rate=None):
    line = {"requests": rep["offered"], "batches": len(served),
            "docs_per_s": rep["throughput_docs_s"], "wall_s": rep["wall_s"],
            "latency_ms": rep["latency_ms"],
            "partial_flushes": svc.metrics.total("admit.partial_flushes"),
            "slo_report_valid": True}
    if rate is not None:
        line["offered_rate_docs_s"] = rate
    return line


def phase_service(device, spec, test, topics, lam):
    """``repro_torch.serve`` on the card from phase train's λ, padded
    (batch 1,024) and CSR (131,072-slot batches), the 2,100 held-out
    documents as requests: (a) a replayed burst of 32,768 requests
    (docs/s, conservation, each batch's γ bit-equal to ``posterior_docs``
    of its admitted documents, 1 launch a batch, host syncs a batch); (b)
    Poisson at half of (a)'s docs/s; (c) ON/OFF bursts at (a)'s docs/s;
    (d, padded) (b)'s schedule with the ``OnlineLearner`` training on a
    stream of its own beside the serving one, then ``drain(2)``: versions
    advance, each batch's γ its version's snapshot's bit for bit, an armed
    watchdog without violations, swap stalls within 50 ms, 2 launches a
    learner update and 1 a served batch, the learner's thread stopped."""
    import numpy as np
    import torch
    from repro_torch.data.stream import CorpusDocStream
    from repro_torch.lda import TopicInferencer
    from repro_torch.serve import (onoff_arrivals, poisson_arrivals,
                                   replay_arrivals)

    t_phase = time.perf_counter()
    cfg = train_config(spec, topics)
    docs = list(CorpusDocStream(test, spec.vocab_size).iter_from(0))
    out = {"phase": "service", "docs": len(docs),
           "flush_timeout_s": SERVICE_FLUSH_S}
    launches = {"fixed_point": 0, "fixed_point_csr": 0,
                "segment_scatter": 0}

    def make_inf(layout):
        return TopicInferencer(cfg, lam, batch_size=BATCH, layout=layout,
                               token_budget=CSR_BUDGET, device=device)

    for layout in ("padded", "csr"):
        name = "fixed_point_csr" if layout == "csr" else "fixed_point"
        inf = make_inf(layout)
        inf.posterior_docs(docs)                          # warm-up
        line = {}
        # (a) the burst: the highest rate the service sustains
        reqs = service_requests(docs, replay_arrivals(SERVICE_BURST))
        svc, served, counts, rep = service_run(inf, reqs)
        check(counts[name] == len(served) == sum(counts.values()),
              f"service (a, {layout}): not 1 launch a served batch over "
              f"{len(served)}: {counts}")
        launches[name] += counts[name]
        rate = rep["throughput_docs_s"]
        line["a_burst"] = service_line(svc, rep, served)
        # each batch's γ: posterior_docs of the batch's admitted documents
        # (the same packing, so the same bits)
        by_rid = {r.rid: r for r in reqs}
        for batch, responses in served:
            want = inf.posterior_docs([(by_rid[x.rid].ids, by_rid[x.rid].cnts)
                                       for x in responses])
            check(np.array_equal(np.stack([x.gamma for x in responses]),
                                 want),
                  f"service (a, {layout}): a served batch's γ is not "
                  "posterior_docs's bit for bit")
        line["a_burst"]["bit_equal_to_posterior_docs"] = True
        del svc, served, reqs, by_rid
        # the host syncs of a served batch, over a short burst
        small = service_requests(docs, replay_arrivals(SERVICE_SYNC_DOCS))
        box = []
        syncs = host_syncs(lambda: box.append(service_run(inf, small)))
        line["a_burst"]["host_syncs_per_batch"] = syncs / len(box[0][1])
        del box
        # (b) Poisson at half the burst's rate, (c) ON/OFF at its rate
        b_rate = SERVICE_LOAD * rate
        b_arrivals = poisson_arrivals(SERVICE_REQUESTS, b_rate, seed=0)
        for key, arrivals, offered in (
                ("b_poisson", b_arrivals, b_rate),
                ("c_onoff", onoff_arrivals(
                    SERVICE_REQUESTS, rate, on_s=SERVICE_ON_OFF_S,
                    off_s=SERVICE_ON_OFF_S, seed=0), rate)):
            svc, served, counts, rep = service_run(
                inf, service_requests(docs, arrivals))
            check(counts[name] == len(served) == sum(counts.values()),
                  f"service ({key}, {layout}): not 1 launch a served "
                  f"batch: {counts}")
            launches[name] += counts[name]
            line[key] = service_line(svc, rep, served, offered)
            del svc, served
        out[layout] = line
        if layout == "padded":
            out["padded"]["d_online"] = service_online(
                cfg, lam, make_inf, docs, b_arrivals, b_rate, launches)
        del inf
        torch.cuda.empty_cache()
    d = out["padded"]["d_online"]
    b = out["padded"]["b_poisson"]["latency_ms"]
    d["latency_ms_minus_b"] = {p: d["latency_ms"][p] - b[p]
                               for p in ("p50", "p95", "p99")}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out, launches


def service_online(cfg, lam, make_inf, docs, arrivals, rate, launches):
    """Phase service's (d): (b)'s schedule with the ``OnlineLearner`` on
    its own stream, then ``drain(2)``; see ``phase_service``."""
    import threading
    import numpy as np
    import torch
    from repro_torch.core.engines import LDAEngine
    from repro_torch.kernels import lda_estep
    from repro_torch.serve import OnlineLearner, SnapshotStore

    inf = make_inf("padded")
    eb0 = inf.exp_elog_beta
    store = SnapshotStore(inf)
    learner = OnlineLearner(cfg, store, lam0=lam, device=lam.device,
                            **LEARNER)
    # the learner's mini-batch updates, counted where the engine runs one
    updates = [0]
    lock = threading.Lock()
    real = LDAEngine._run_packed

    def counted(self, batch):
        with lock:
            updates[0] += 1
        return real(self, batch)

    LDAEngine._run_packed = counted
    try:
        svc, served, counts, rep = service_run(
            inf, service_requests(docs, arrivals), learner=learner)
        run_updates = updates[0]
        lda_estep.reset_launches()
        drained = learner.drain(2)
        drain = dict(lda_estep.LAUNCHES)
    finally:
        LDAEngine._run_packed = real
    check(learner._thread is None, "service (d): the learner's thread is "
                                   "still alive")
    versions = rep["model_versions"]
    check(len(versions) >= 2 and rep["every_response_versioned"],
          f"service (d): served versions {versions} did not advance")
    check(len(drained) == 2, f"service (d): drain published {drained}")
    check(counts["segment_scatter"] == run_updates
          and counts["fixed_point"] == len(served) + run_updates
          and sum(counts.values()) == len(served) + 2 * run_updates,
          f"service (d): not 1 launch a served batch ({len(served)}) and 2 "
          f"a learner update ({run_updates}): {counts}")
    drain_updates = updates[0] - run_updates
    check(drain["fixed_point"] == drain["segment_scatter"] == drain_updates
          and sum(drain.values()) == 2 * drain_updates,
          f"service (d): drain not 2 launches an update over "
          f"{drain_updates}: {drain}")
    for k in ("fixed_point", "segment_scatter"):
        launches[k] += counts[k] + drain[k]
    # each batch's γ against a fresh solve on its version's snapshot
    snaps = {s.version: s.exp_elog_beta for s in store.history}
    snaps[0] = eb0
    refs = {}
    for batch, responses in served:
        v = responses[0].model_version
        check({x.model_version for x in responses} == {v},
              "service (d): one batch, two versions")
        if v not in refs:
            refs[v] = make_inf("padded")
            if v:
                refs[v].swap_model(exp_elog_beta=snaps[v], version=v)
        _, gamma, n, got_v = refs[v].posterior_packed(batch)
        check(got_v == v and np.array_equal(
            np.stack([x.gamma for x in responses]),
            gamma[:n].cpu().numpy()),
              f"service (d): a batch served at version {v} is not that "
              "snapshot's γ bit for bit")
    wd = learner.watchdog
    check(learner.armed_observations >= 1 and not wd.violations,
          f"service (d): watchdog: {learner.armed_observations} armed "
          f"readings, {len(wd.violations)} violations")
    stalls = store.swap_stalls_ms()
    check(max(stalls) <= SWAP_STALL_BOUND_MS,
          f"service (d): a swap stalled {max(stalls)} ms")
    line = service_line(svc, rep, served, rate)
    line.update({
        "learner": dict(LEARNER),
        "versions_served": versions, "published": len(store.history),
        "learner_passes": learner.updates,
        "learner_updates_during_run": run_updates,
        "drain_updates": drain_updates,
        "docs_trained": learner.docs_trained,
        "dropped": learner.stream.dropped,
        "armed_readings": learner.armed_observations,
        "watchdog_violations": len(wd.violations),
        "swap_stall_ms": {"max": max(stalls), "median": median(stalls)},
        "launches_run": counts, "launches_drain": drain,
        "batches_bit_equal_to_their_snapshot": True,
        "learner_thread_stopped": True})
    del learner, store, refs, snaps, svc, served
    torch.cuda.empty_cache()
    return line


# ---------------------------------------------------------------------------
# the lifted K caps: K1/K4 above 256 topics, K3 over column chunks, K6-K8
# over K tiles
# ---------------------------------------------------------------------------

# Table 2's worker counts (B per worker, S = 1, no drops), Fig. 5's run
# (P = 4, S = 2, half the sub-rounds dropped) and a batch that is no
# multiple of K1's 128-row tile
DIVI_WORKERS = (1, 4, 16)
DIVI_PASSES = 2
DIVI_ODD_BATCH = 1000
# the save/resume round trip: the first 4,096 documents (the memo of all
# 16,430 is 1.07 GB on disk), four workers of 1,000, mid-pass at the save
DIVI_CKPT_DOCS = 4096


def divi_run(cfg, train, obs_held, lam0, dcfg, rounds, device, sync):
    """``rounds`` D-IVI rounds of a fresh ``DIVIEngine``: the first counts
    its host syncs (telemetry off; must be 0), the others are timed on the
    host clock between two syncs. Launches are counted from 0 over all of
    them and held to 2 a sub-round that any worker ran (0 for the others).
    Returns (the engine, its line)."""
    import numpy as np
    import torch
    from repro_torch.core.predictive import log_predictive
    from repro_torch.dist import DIVIEngine
    from repro_torch.kernels import lda_estep

    eng = DIVIEngine(cfg, dcfg, train, seed=0, device=device, lam0=lam0)
    delays = []
    ingest = eng._ingest_round

    def recorded():
        out = ingest()
        delays.append(out[3])
        return out

    eng._ingest_round = recorded
    lda_estep.reset_launches()
    syncs = host_syncs(eng.run_round)
    ms = []
    for _ in range(rounds - 1):
        sync()
        t0 = time.perf_counter()
        eng.run_round()
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(lda_estep.LAUNCHES)
    ran = sum(int((~d).any(axis=0).sum()) for d in delays)
    label = (f"divi P={dcfg.num_workers} B={dcfg.batch_size} "
             f"S={dcfg.staleness}")
    check_two_launches(label, launches, ran, "fixed_point")
    check(syncs == 0, f"{label}: {syncs} host syncs in a round")
    timed_docs = dcfg.batch_size * sum(int((~d).sum()) for d in delays[1:])
    lpp = float(log_predictive(cfg, eng.state.lam, *obs_held))
    check(np.isfinite(lpp) and bool(torch.isfinite(eng.state.lam).all()),
          f"{label}: non-finite LPP or λ")
    shard = eng.shard
    return eng, {
        "P": dcfg.num_workers, "B": dcfg.batch_size, "S": dcfg.staleness,
        "delay_prob": dcfg.delay_prob, "rounds": rounds,
        "shard_sizes": [min(eng.sharded.shard_sizes),
                        max(eng.sharded.shard_sizes)],
        "docs": eng.docs_seen, "subrounds_run": ran,
        "subrounds_dropped_whole": rounds * dcfg.staleness - ran,
        "launches": launches, "launches_per_subround": 2,
        "host_syncs_first_round": syncs,
        "median_ms_per_round": median(ms), "ms_per_round": ms,
        "docs_per_s": timed_docs / (sum(ms) / 1e3),
        "lpp": lpp, "init_frac": float(eng.state.init_frac),
        "memo_bytes": shard.pi.numel() * 4 + shard.visited.numel()}


def divi_subround(eng):
    """The next sub-round's inputs as the round builds them: the live
    workers' batches stacked (pulled from their shards), Eφ of the current
    λ, the memo rows' warm starts. Returns (ids, cnts, eb, γ₀, π_old,
    visited, B)."""
    import torch
    from repro_torch.core.estep import warm_start_gamma
    from repro_torch.core.math import exp_dirichlet_expectation
    ids, cnts, rows, delay = eng._ingest_round()
    n = int((~delay[:, 0]).sum())
    b, l = ids.shape[1:]
    dev = eng.device
    ids = torch.from_numpy(ids[:n].reshape(n * b, l)).to(dev)
    cnts = torch.from_numpy(cnts[:n].reshape(n * b, l)).to(dev)
    old_pi, visited = eng.shard.gather(
        torch.from_numpy(rows[:n].reshape(n * b)).to(dev))
    eb = exp_dirichlet_expectation(eng.state.lam, axis=0).contiguous()
    gamma0 = warm_start_gamma(eng.cfg, cnts, old_pi, visited).contiguous()
    return ids, cnts, eb, gamma0, old_pi.contiguous(), visited, b


def check_grouped(eng, label, timer, twin):
    """One sub-round of ``eng`` (its workers' next batches, warm starts
    from their memos): the grouped K1 (one launch, one group a worker) bit
    for bit against one launch a worker; with ``twin``, against its plain
    twin's loop over the workers at K1's bars (``check_fixed_point``);
    the summed correction (one K1, one K3) against the loop over the
    workers (one correction each, then their sum) within K3's bar, each
    term's S_new and S_old at rtol = atol = 1e-5 of their fp64 sums; π the
    same bits. Returns its line."""
    import torch
    from repro_torch.core.estep import BowBatch, EStepBackend, get_backend
    from repro_torch.kernels import build, lda_estep

    ids, cnts, eb, gamma0, old_pi, visited, b = divi_subround(eng)
    cfg = eng.cfg
    n, (rows, l), k = ids.shape[0] // b, ids.shape, eb.shape[1]
    args = (ids, cnts, eb, gamma0, cfg.alpha0, cfg.estep_tol,
            cfg.estep_max_iters)
    got = lda_estep.estep_fixed_point_pi(*args, group=b)
    tiles = -(-b // 128)
    for w in range(n):
        sl = slice(w * b, (w + 1) * b)
        alone = lda_estep.estep_fixed_point_pi(
            ids[sl], cnts[sl], eb, gamma0[sl].contiguous(), *args[4:])
        check(all(torch.equal(x, y) for x, y in
                  zip((got[0][sl], got[1][sl],
                       got[2][w * tiles:(w + 1) * tiles], got[3][sl]),
                      alone)),
              f"{label}: worker {w}'s rows of the grouped K1 are not its "
              "own launch's bits")
    out = {"docs": rows, "group": b, "workers": n,
           "bit_equal_to_one_launch_a_worker": True,
           "tile_sweeps": got[2].cpu().tolist()}
    if twin:
        res = check_fixed_point(args, label, group=b)
        res.pop("_etheta"), res.pop("_etheta_plain")
        out["twin"] = res
    bms, by, _ = fixed_point_bound(ids, cnts, k, got[2],
                                   lda_estep.fixed_point_tiles(rows, 128, b))
    lib = build.load()
    grid = lib.lda_fixed_point_blocks(rows, l, k, 128, b)
    out.update(
        ms=timer(lambda: lda_estep.estep_fixed_point_pi(*args, group=b), 5),
        kernel_ms=kernel_ms(
            lambda: lda_estep.estep_fixed_point_pi(*args, group=b),
            "fixed_point_kernel", reps=5),
        bound_ms=bms, bound_by=by, grid_blocks=grid,
        docs_per_grid_pass=grid * (8 // lib.lda_fixed_point_warps(l)),
        smem_bytes=lib.lda_fixed_point_smem_bytes(rows, k, 128, b))

    backend = get_backend("cuda")
    batch = BowBatch(ids, cnts)
    corr, words, res = backend.solve_correction_grouped(
        cfg, eb, batch, old_pi, visited, b)
    lcorr, lwords, lres = EStepBackend.solve_correction_grouped(
        backend, cfg, eb, batch, old_pi, visited, b)
    check(torch.equal(res.pi, lres.pi), f"{label}: grouped π is not the "
          "worker loop's")
    flat = ids.reshape(-1).long()
    w64 = cnts.reshape(-1, 1).double()
    s_new = torch.zeros((eb.shape[0], k), dtype=torch.float64,
                        device=eb.device).index_add_(
        0, flat, w64 * res.pi.reshape(-1, k).double())
    s_old = torch.zeros_like(s_new).index_add_(
        0, flat, w64 * old_pi.reshape(-1, k).double())
    scale = 1e-5 * (s_new.abs() + s_old.abs()) + 1e-5
    err = float((corr.double() - lcorr.double()).abs().max())
    ratio = float(((corr.double() - lcorr.double()).abs() / scale).max())
    check(ratio <= 2.0, f"{label}: summed correction off the worker loop's "
          f"by {err} ({ratio} of the bar)")
    check(float(words) == float(lwords), f"{label}: first-visit words "
          f"{float(words)} != {float(lwords)}")
    out["correction"] = {
        "max_abs_err_vs_worker_loop": err, "bar_ratio": ratio,
        "tol": "|grouped − loop| ≤ 2·(1e-5·(|S_new| + |S_old|) + 1e-5) "
               "(each of S_new, S_old within K3's rtol = atol = 1e-5 of "
               "fp64); π and the first-visit words equal",
        "ms": timer(lambda: backend.solve_correction_grouped(
            cfg, eb, batch, old_pi, visited, b), 5),
        "worker_loop_ms": timer(lambda: EStepBackend.solve_correction_grouped(
            backend, cfg, eb, batch, old_pi, visited, b), 5)}
    return out


def phase_divi(device, spec, train, test, topics, batch, sync, timer):
    """D-IVI (paper §4), P workers simulated on the card through
    ``DIVIEngine``: Table 2's P sweep (P = 1, 4, 16 at B per worker, S = 1,
    two passes), Fig. 5's P = 4, S = 2, delay_prob = 0.5 and P = 4 at
    B = 1,000; single-host S-IVI at an equal document count beside them;
    the grouped K1 and the summed correction against their per-worker
    twins; a mid-run save and resume through ``LDA(algo="divi")``."""
    import shutil
    import torch
    from repro_torch.core.engines import LDAEngine
    from repro_torch.core.predictive import split_heldout
    from repro_torch.core.types import Corpus, init_global_state
    from repro_torch.dist import DIVIConfig
    from repro_torch.lda import LDA

    cfg = train_config(spec, topics)
    gen = torch.Generator(device=device).manual_seed(0)
    lam0 = init_global_state(cfg, device=device, generator=gen).lam
    obs_held = split_heldout(test, seed=0)
    target = DIVI_PASSES * train.num_docs
    runs, grouped = [], {}
    for p in DIVI_WORKERS:
        dcfg = DIVIConfig(num_workers=p, batch_size=batch)
        rounds = max(2, round(target / (p * batch)))
        eng, line = divi_run(cfg, train, obs_held, lam0, dcfg, rounds,
                             device, sync)
        sizes = eng.sharded.shard_sizes
        check(float(eng.state.init_frac) == 0.0 and all(
            bool(eng.shard.visited[w, :n].all())
            for w, n in enumerate(sizes)),
              f"divi P={p}: init_frac {float(eng.state.init_frac)} after "
              "covering every document")
        runs.append(line)
        if p > 1:
            grouped[f"P{p}_B{batch}"] = check_grouped(
                eng, f"divi P={p}", timer, twin=p * batch <= 4096)
        del eng
        torch.cuda.empty_cache()
    for dcfg, rounds, grouped_check in (
            (DIVIConfig(num_workers=4, batch_size=batch, staleness=2,
                        delay_prob=0.5), runs[1]["rounds"], False),
            (DIVIConfig(num_workers=4, batch_size=DIVI_ODD_BATCH),
             max(2, round(target / (4 * DIVI_ODD_BATCH))), True)):
        eng, line = divi_run(cfg, train, obs_held, lam0, dcfg, rounds,
                             device, sync)
        runs.append(line)
        if grouped_check:
            grouped[f"P4_B{dcfg.batch_size}"] = check_grouped(
                eng, f"divi P=4 B={dcfg.batch_size}", timer, twin=True)
        del eng
        torch.cuda.empty_cache()

    # single-host S-IVI from the same λ₀ at an equal document count
    sivi = LDAEngine(cfg, train, algo="sivi", batch_size=batch, seed=0,
                     test_corpus=test, device=device, lam0=lam0)
    ms = []
    while sivi.docs_seen < target:
        ms += timed_epoch(sivi, sync)[0]
    sivi_line = {"docs": sivi.docs_seen, "updates": len(ms),
                 "median_ms_per_update": median(ms),
                 "docs_per_s": sivi.docs_seen / (sum(ms) / 1e3),
                 "lpp": sivi.evaluate()["lpp"]}
    for line in runs:
        line["lpp_minus_sivi"] = line["lpp"] - sivi_line["lpp"]
    del sivi

    # a mid-run save → load → resume through the facade, bit for bit
    sub = Corpus(train.token_ids[:DIVI_CKPT_DOCS].contiguous(),
                 train.counts[:DIVI_CKPT_DOCS].contiguous())
    dcfg = DIVIConfig(num_workers=4, batch_size=DIVI_ODD_BATCH, staleness=2,
                      delay_prob=0.5)
    try:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
        a = LDA(cfg, algo="divi", distributed=dcfg, seed=0,
                device=device).partial_fit(sub, steps=1)
        mid = [ing.cursor for ing in a.trainer.eng.ingest]
        sync()
        t0 = time.perf_counter()
        a.save(str(CKPT_DIR))
        save_ms = (time.perf_counter() - t0) * 1e3
        nbytes = dir_bytes(CKPT_DIR)
        a.partial_fit(steps=2)
        t0 = time.perf_counter()
        b = LDA.load(str(CKPT_DIR), device=device).resume(sub)
        sync()
        load_ms = (time.perf_counter() - t0) * 1e3
        b.partial_fit(steps=2)
        same = all(torch.equal(getattr(a.state, f), getattr(b.state, f))
                   for f in ("lam", "m_vk", "init_mass", "init_frac", "t"))
        check(same and a.docs_seen == b.docs_seen
              and torch.equal(a.trainer.eng.shard.pi, b.trainer.eng.shard.pi),
              "divi: the resumed run is not the uninterrupted one's bits")
        ckpt = {"docs": DIVI_CKPT_DOCS, "P": 4, "B": DIVI_ODD_BATCH, "S": 2,
                "delay_prob": 0.5, "cursors_at_save": mid,
                "save_ms": save_ms, "load_resume_ms": load_ms,
                "bytes": nbytes, "bit_equal": True}
        del a, b
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    out = {"phase": "divi", "runs": runs, "sivi": sivi_line,
           "grouped": grouped, "checkpoint": ckpt,
           "digests": "K1/K4/K3/K6-K8 at group = B: phase kcap"}
    emit(out)
    return out


# D-IVI over a mesh: ranks of one process group on the one card
DIVI_MESH_LAYOUTS = ((4, 1), (2, 2))    # (data, model), 4 gloo ranks
DIVI_MESH_VOCAB = 141_952   # repro's padded Arxiv V (launch/dryrun_lda.py:48)
DIVI_MESH_WORKERS = 4
DIVI_MESH_BAR = 5e-4        # repro's bar, its shard_map round against vmap
DIVI_MESH_SPAWN_S = 420.0   # a spawn's whole run: its ranks killed past it
DIVI_MESH_GLOO_S = 300.0    # a collective's timeout
DIVI_MESH_DIR = ROOT / "_smoke_mesh"
LM_MESH_DIR = ROOT / "_smoke_lm_mesh"    # the LM mesh spawns' stores


def divi_mesh_config(spec, topics):
    import dataclasses
    return dataclasses.replace(train_config(spec, topics),
                               vocab_size=DIVI_MESH_VOCAB)


def memo_digests(shard, first):
    """sha256 of each worker's memo rows (π, visited), by global worker."""
    import hashlib
    return {first + w: hashlib.sha256(
        shard.pi[w].cpu().numpy().tobytes()
        + shard.visited[w].cpu().numpy().tobytes()).hexdigest()
        for w in range(shard.pi.shape[0])}


def divi_mesh_rank(rank, world, layouts, rounds, batch):
    """One rank of the mesh runs: each layout's engine from the parent's
    corpus and λ₀, ``rounds`` rounds timed on the host clock between
    syncs (the round's host ingest, ``round_args``, and the whole round
    with it), its launches counted from 0 over them; the first round's
    arguments' bytes, peak memory, the gathered λ (rank 0 saves it) and
    its workers' memo digests. The CUDA device is the one card."""
    import numpy as np
    import torch
    from repro_torch.core.types import Corpus
    from repro_torch.data.synthetic import PAPER_CORPORA
    from repro_torch.dist import DIVIConfig, DIVIEngine
    from repro_torch.kernels import lda_estep
    from repro_torch.launch.dryrun_lda import tensor_bytes
    from repro_torch.launch.mesh import make_host_mesh

    device = torch.device("cuda", 0)
    with np.load(DIVI_MESH_DIR / "corpus.npz") as f:
        train = Corpus(torch.from_numpy(f["ids"]).to(device),
                       torch.from_numpy(f["cnts"]).to(device))
        lam0 = torch.from_numpy(f["lam0"]).to(device)
    cfg = divi_mesh_config(PAPER_CORPORA["arxiv"], TOPICS)
    dcfg = DIVIConfig(num_workers=DIVI_MESH_WORKERS, batch_size=batch)
    out = {}
    for d, m in layouts:
        mesh = make_host_mesh(d, m, device=device)
        eng = DIVIEngine(cfg, dcfg, train, seed=0, mesh=mesh, device=device,
                         lam0=lam0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lda_estep.reset_launches()
        ms, ingest_ms = [], []
        for r in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            args = eng.round_args()
            t1 = time.perf_counter()
            if r == 0:
                arg_bytes = tensor_bytes(args)
            eng.run_round(args)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            ingest_ms.append((t1 - t0) * 1e3)
        launches = dict(lda_estep.LAUNCHES)
        lam = eng.gather_lam()
        if rank == 0:
            np.save(DIVI_MESH_DIR / f"lam_{d}x{m}.npy", lam.cpu().numpy())
        rnd = eng._round
        out[f"{d}x{m}"] = {
            "workers": [eng.workers.start, eng.workers.stop],
            "rows": [eng.rows.start, eng.rows.stop],
            "backends": [rnd.data.backend, rnd.model.backend],
            "ms_per_round": ms, "ingest_ms": ingest_ms,
            "launches": launches,
            "argument_bytes": arg_bytes,
            "max_memory_allocated": torch.cuda.max_memory_allocated(device),
            "lam_finite": bool(torch.isfinite(lam).all()),
            "lam_sha256": __import__("hashlib").sha256(
                lam.cpu().numpy().tobytes()).hexdigest(),
            "memo": memo_digests(eng.shard, eng.workers.start),
            "received_bytes": [rnd.model.received_bytes,
                               rnd.data.received_bytes],
            "docs_seen": eng.docs_seen}
        del eng, lam
        torch.cuda.empty_cache()
    return out


def phase_divi_mesh(device, spec, train, topics, batch):
    """D-IVI's mesh round (`repro_torch.dist.divi`) on the one card: one
    spawn of 4 ranks over gloo (host copies) runs the (4, 1) and (2, 2)
    layouts, and one of 1 rank runs NCCL, each for two passes at P = 4,
    B = 1,024 a worker, V = 141,952. Each layout's λ and memos are held
    bit for bit against ``divi_round_emulated`` run here, and within 5e-4
    of the one-card simulation (NCCL's at one data rank: bit for bit); the
    dry run's argument bytes against each rank's live ones, its peak
    beside the rank's ``max_memory_allocated``; 2 launches a sub-round on
    every rank. Four processes time-slice one card here: their ms are no
    scaling result."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.core.types import init_global_state
    from repro_torch.dist import DIVIConfig, DIVIEngine
    from repro_torch.dist.divi import divi_round_emulated
    from repro_torch.launch.dryrun_lda import divi_rank_plan
    from repro_torch.launch.mesh import make_abstract_mesh, spawn_ranks

    cfg = divi_mesh_config(spec, topics)
    dcfg = DIVIConfig(num_workers=DIVI_MESH_WORKERS, batch_size=batch)
    rounds = max(2, round(DIVI_PASSES * train.num_docs
                          / (DIVI_MESH_WORKERS * batch)))
    gen = torch.Generator(device=device).manual_seed(0)
    lam0 = init_global_state(cfg, device=device, generator=gen).lam
    shutil.rmtree(DIVI_MESH_DIR, ignore_errors=True)
    DIVI_MESH_DIR.mkdir()
    try:
        np.savez(DIVI_MESH_DIR / "corpus.npz",
                 ids=train.token_ids.cpu().numpy(),
                 cnts=train.counts.cpu().numpy(), lam0=lam0.cpu().numpy())
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        gloo = spawn_ranks(divi_mesh_rank, 4, backend="gloo",
                           args=(DIVI_MESH_LAYOUTS, rounds, batch),
                           timeout_s=DIVI_MESH_SPAWN_S,
                           collective_timeout_s=DIVI_MESH_GLOO_S,
                           store_dir=str(DIVI_MESH_DIR))
        gloo_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        nccl = spawn_ranks(divi_mesh_rank, 1, backend="nccl",
                           args=(((1, 1),), rounds, batch),
                           timeout_s=DIVI_MESH_SPAWN_S,
                           collective_timeout_s=DIVI_MESH_GLOO_S,
                           store_dir=str(DIVI_MESH_DIR))
        nccl_s = time.perf_counter() - t0
        lams = {f"{d}x{m}": np.load(DIVI_MESH_DIR / f"lam_{d}x{m}.npy")
                for d, m in DIVI_MESH_LAYOUTS + ((1, 1),)}
    finally:
        shutil.rmtree(DIVI_MESH_DIR, ignore_errors=True)

    def twin(data):
        """The simulation (data None) or the emulated round here."""
        eng = DIVIEngine(cfg, dcfg, train, seed=0, device=device, lam0=lam0)
        for _ in range(rounds):
            if data is None:
                eng.run_round()
            else:
                divi_round_emulated(cfg, *eng.round_args(), data=data)
        return (eng.state.lam.cpu().numpy(),
                memo_digests(eng.shard, 0))

    sim_lam, sim_memo = twin(None)
    layouts = {}
    for (d, m), ranks, backend in (
            [((d, m), gloo, "gloo") for d, m in DIVI_MESH_LAYOUTS]
            + [((1, 1), nccl, "nccl")]):
        key = f"{d}x{m}"
        label = f"divi_mesh {key} {backend}"
        em_lam, em_memo = (sim_lam, sim_memo) if d == 1 else twin(d)
        lam = lams[key]
        rows = [r[key] for r in ranks]
        check(np.array_equal(lam, em_lam), f"{label}: λ is not the "
              "emulated round's bits")
        check(len({r["lam_sha256"] for r in rows}) == 1,
              f"{label}: the ranks gathered different λ")
        for r in rows:
            check(all(r["memo"][w] == em_memo[w] for w in r["memo"]),
                  f"{label}: a worker's memo is not the emulated round's")
            check(r["backends"] == [backend, backend],
                  f"{label}: collectives on {r['backends']}")
            check(r["launches"]["fixed_point"] == rounds
                  and r["launches"]["segment_scatter"] == rounds,
                  f"{label}: launches {r['launches']} over {rounds} "
                  "rounds (1 K1 and 1 K3 a sub-round)")
            check(r["lam_finite"], f"{label}: non-finite λ")
        err = float(np.abs(lam - sim_lam).max())
        check(err < DIVI_MESH_BAR, f"{label}: λ {err} off the simulation")
        if d == 1:
            check(err == 0.0, f"{label}: one data rank is not the "
                  "simulation's bits")
        plan = divi_rank_plan(cfg, dcfg,
                              make_abstract_mesh((d, m), ("data", "model")),
                              num_docs=train.num_docs,
                              max_unique=train.max_unique)
        for r in rows:
            check(r["argument_bytes"] == plan["argument_bytes"],
                  f"{label}: live argument bytes {r['argument_bytes']} != "
                  f"the dry run's {plan['argument_bytes']}")
        layouts[key] = {
            "backend": backend, "ranks": len(rows), "rounds": rounds,
            "median_ms_per_round": median(
                [median(r["ms_per_round"][1:]) for r in rows]),
            "ms_per_round_by_rank": [r["ms_per_round"] for r in rows],
            "median_ingest_ms": median(
                [median(r["ingest_ms"][1:]) for r in rows]),
            "launches_by_rank": [r["launches"]["fixed_point"]
                                 + r["launches"]["segment_scatter"]
                                 for r in rows],
            "launches_per_subround": 2,
            "max_abs_err_vs_simulation": err,
            "bit_equal_to_emulated": True,
            "argument_bytes": plan["argument_bytes"],
            "dryrun_peak_bytes": plan["peak_bytes"],
            "max_memory_allocated_by_rank": [r["max_memory_allocated"]
                                             for r in rows],
            "received_bytes_by_rank": [r["received_bytes"] for r in rows],
            "collective_bytes_dryrun": plan["collective_bytes"],
            "_launches": {n: sum(r["launches"][n] for r in rows)
                          for n in PADDED_KERNELS}}
    out = {"phase": "divi_mesh", "P": DIVI_MESH_WORKERS, "B": batch,
           "V": DIVI_MESH_VOCAB, "docs": train.num_docs,
           "layouts": {k: {f: v for f, v in row.items()
                           if not f.startswith("_")}
                       for k, row in layouts.items()},
           "spawn_s": {"gloo_4": gloo_s, "nccl_1": nccl_s},
           "tol": f"bit-equal to divi_round_emulated; max |Δλ| < "
                  f"{DIVI_MESH_BAR} vs the simulation (0 at one data rank)",
           "time_sliced": "4 processes on one card: no scaling result"}
    if torch.cuda.device_count() < 4:
        out["nccl_world4"] = "not run: 1 card"
    emit(out)
    return {k: row["_launches"] for k, row in layouts.items()}


# ---------------------------------------------------------------------------
# the tuner, UCI ingest, CVB0 and Minka's updates
# ---------------------------------------------------------------------------

TUNE_BUDGET = 6          # random candidates a task before refinement
TUNE_REPS = 5            # timed reps a candidate (the minimum is its ms)


def knob_fields(policy):
    """A policy's fields that differ from the default (the knobs it sets)."""
    import dataclasses
    from repro_torch.core.types import DEFAULT_KERNEL_POLICY
    return {f.name: getattr(policy, f.name)
            for f in dataclasses.fields(policy)
            if getattr(policy, f.name) != getattr(DEFAULT_KERNEL_POLICY,
                                                   f.name)}


def tune_fresh_inputs(shape, cfg, device, spec, test, lam, batch):
    """Fresh inputs for the winner's bit check, unseen by the tune: the
    held-out documents (padded: the first B rows, CSR: their first flat
    batch) against Eφ of phase 5's trained λ, the tuner's warm and cold
    rows (``search.warm_memo``), so tiles stop at different sweeps."""
    from repro_torch.core.math import exp_dirichlet_expectation
    from repro_torch.data.stream import CorpusDocStream
    from repro_torch.tune.search import warm_memo
    eb = exp_dirichlet_expectation(lam, axis=0).contiguous()
    if shape.task == "padded":
        ids = test.token_ids[:batch].contiguous()
        cnts = test.counts[:batch].contiguous()
        return (eb, ids, cnts) + warm_memo(shape, cfg, eb, ids, cnts)
    cb = first_csr_batch(CorpusDocStream(test, spec.vocab_size), batch)
    ids, cnts, segs = flat_tensors(cb, device)
    return (eb, ids, cnts, segs) + warm_memo(shape, cfg, eb, ids, cnts,
                                             segs)


def tune_task(task, device, spec, train, test, lam, topics, batch, store):
    """One task's tune on the card and its checks: every candidate's ms
    and its bits on fresh inputs beside the default's."""
    import dataclasses
    import torch
    from repro_torch.core.types import DEFAULT_KERNEL_POLICY, LDAConfig
    from repro_torch.tune import current_device_kind
    from repro_torch.tune import search as tsearch

    if task == "padded":
        shape = tsearch.TuneShape(task="padded", b_or_t=batch,
                                  v=spec.vocab_size, k=topics,
                                  w=train.max_unique)
    else:
        shape = tsearch.TuneShape(task="csr", b_or_t=CSR_BUDGET,
                                  v=spec.vocab_size, k=topics,
                                  num_docs=batch, layout="csr")
    t0 = time.perf_counter()
    res = tsearch.tune_and_store(store, shape, budget=TUNE_BUDGET, seed=0,
                                 refine_rounds=1, gate_candidates=4,
                                 iters=ESTEP_ITERS, device=device,
                                 reps=TUNE_REPS)
    seconds = time.perf_counter() - t0
    kind = "gpu:" + torch.cuda.get_device_name(device).replace(
        " ", "-").lower()
    check(res.objective == "measured_seconds" and not res.proxy_regime,
          f"tune {task}: objective {res.objective}, proxy {res.proxy_regime}")
    check(res.device_kind == kind == current_device_kind(device),
          f"tune {task}: device kind {res.device_kind} != {kind}")
    check(res.tuned_cost <= res.default_cost,
          f"tune {task}: the winner is slower than the default")
    # the winner on fresh inputs: the default's bits
    cfg = LDAConfig(num_topics=topics, vocab_size=spec.vocab_size,
                    estep_max_iters=ESTEP_ITERS, estep_backend="cuda")
    fresh = tsearch._gate_runner(shape, cfg, tune_fresh_inputs(
        shape, cfg, device, spec, test, lam, batch))
    want = fresh(DEFAULT_KERNEL_POLICY)
    ok, mode, err = tsearch.equality_check(fresh, want, res.policy)
    check(ok, f"tune {task}: the winner {res.policy} is not the default's "
              f"bits on fresh inputs ({mode}, {err})")
    return {"task": task, "shape": dataclasses.asdict(shape),
            "seconds": seconds, "objective": res.objective,
            "proxy_regime": res.proxy_regime,
            "device_kind": res.device_kind,
            "default_ms": res.default_cost * 1e3,
            "tuned_ms": res.tuned_cost * 1e3,
            "improvement": res.improvement,
            "winner": knob_fields(res.policy), "effective": res.effective,
            "equality": res.equality, "trials": res.trials,
            "candidates": [{"knobs": knob_fields(p), "ms": c * 1e3,
                            "fresh_bit_equal": tsearch.equality_check(
                                fresh, want, p)[0]}
                           for p, c in res.scored],
            "gated": [{"knobs": knob_fields(p), "ms": c * 1e3,
                       "passed": passed, "max_abs_err": e}
                      for p, c, passed, e in res.gated],
            "winner_fresh_bits": mode, "policy": res.policy}


def phase_tune(device, spec, train, test, topics, batch, lam):
    """The kernel-policy tuner on the card, both tasks at the Arxiv shape:
    measured objective, the winner bit-equal to the default on fresh
    inputs, every candidate's ms and gate verdict and its bits on the
    fresh inputs; then the store read back by LDA.fit and a
    TopicInferencer, one tune.cache hit each."""
    import tempfile
    import torch
    from repro_torch.core.types import LDAConfig
    from repro_torch.data.stream import CorpusDocStream
    from repro_torch.kernels import lda_estep
    from repro_torch.lda import LDA, TopicInferencer
    from repro_torch.obs import Telemetry
    from repro_torch.tune import PolicyStore

    rows = {}
    with tempfile.TemporaryDirectory(prefix="smoke_tune_") as tmp:
        store = PolicyStore(f"{tmp}/tune_store.json")
        lda_estep.reset_launches()
        for task in ("padded", "csr"):
            rows[task] = tune_task(task, device, spec, train, test, lam,
                                   topics, batch, store)
        torch.cuda.synchronize()
        launches = dict(lda_estep.LAUNCHES)
        check(all(launches[n] > 0 for n in ("fixed_point",
                                            "fixed_point_csr",
                                            "segment_scatter")),
              f"tune: a kernel of its path never launched: {launches}")
        check(len(store.entries()) == 2,
              f"tune: {len(store.entries())} entries stored")
        # the store read back, one hit each: LDA.fit at the padded
        # training shape, a CSR TopicInferencer at the CSR one
        cfg = LDAConfig(num_topics=topics, vocab_size=spec.vocab_size,
                        estep_max_iters=ESTEP_ITERS, estep_backend="cuda")
        tel = Telemetry()
        lda = LDA(cfg, algo="ivi", batch_size=batch, seed=0,
                  tune_store=store.path, telemetry=tel, device=device)
        lda.fit(train, epochs=1)
        fit_hits = (tel.metrics.value("tune.cache", result="hit"),
                    tel.metrics.value("tune.cache", result="miss"))
        check(fit_hits == (1, 0) and
              lda.cfg.kernel_policy == rows["padded"]["policy"],
              f"tune: LDA.fit read {fit_hits} (hit, miss), policy "
              f"{lda.cfg.kernel_policy}")
        tel = Telemetry()
        inf = TopicInferencer(cfg, lda.lam, batch_size=batch, layout="csr",
                              token_budget=CSR_BUDGET,
                              tune_store=store.path, telemetry=tel,
                              device=device)
        inf.posterior_docs(CorpusDocStream(test, spec.vocab_size))
        inf_hits = (tel.metrics.value("tune.cache", result="hit"),
                    tel.metrics.value("tune.cache", result="miss"))
        check(inf_hits == (1, 0) and
              inf.cfg.kernel_policy == rows["csr"]["policy"],
              f"tune: the inferencer read {inf_hits} (hit, miss)")
    for row in rows.values():
        row.pop("policy")
    out = {"phase": "tune", "tasks": rows, "launches": launches,
           "fit_hits_misses": fit_hits, "inferencer_hits_misses": inf_hits}
    emit(out)
    return out


def phase_uci(device, spec, train, test, topics, batch):
    """UCI ingest: phase data's training corpus written with save_uci
    (gzip), parsed, its sidecar reopened, and one IVI epoch streamed from
    it through LDAEngine on both layouts, λ bit-equal to the same epoch on
    the materialized file (the padded layout under the stream's batch
    schedule, the CSR one on the corpus viewed as a stream)."""
    import os
    import tempfile
    import torch
    from repro_torch.core.engines import LDAEngine
    from repro_torch.core.types import LDAConfig
    from repro_torch.data.stream import BatchPacker, CorpusDocStream
    from repro_torch.data.uci import UCIDocStream, load_uci, save_uci
    from repro_torch.kernels import lda_estep

    cfg = LDAConfig(num_topics=topics, vocab_size=spec.vocab_size,
                    estep_max_iters=ESTEP_ITERS, estep_backend="cuda")
    out = {"phase": "uci", "docs": train.num_docs}
    with tempfile.TemporaryDirectory(prefix="smoke_uci_") as tmp:
        path = os.path.join(tmp, "docword.txt.gz")
        t0 = time.perf_counter()
        save_uci(train, path)
        out["save_s"] = time.perf_counter() - t0
        out["file_bytes"] = os.path.getsize(path)
        t0 = time.perf_counter()
        stream = UCIDocStream(path)
        stats = (stream.num_words, stream.max_unique)   # the stats scan
        out["first_open_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = UCIDocStream(path)
        check((again.num_words, again.max_unique) == stats,
              "uci: the sidecar's stats differ from the scan's")
        out["sidecar_second_open_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        n = sum(1 for _ in stream.iter_from(0))
        parse_s = time.perf_counter() - t0
        check(n == train.num_docs, f"uci: parsed {n} documents")
        out["parse_docs_per_s"] = n / parse_s
        eager, _ = load_uci(path, device=device)
        check(stats == (float(eager.counts.sum()), eager.max_unique),
              "uci: the stream's stats differ from the materialized file's")
        launches = {}
        for layout in ("padded", "csr"):
            kw = dict(algo="ivi", batch_size=batch, seed=0, device=device,
                      layout=layout)
            if layout == "csr":
                kw["token_budget"] = CSR_BUDGET
            se = LDAEngine(cfg, UCIDocStream(path), **kw)
            torch.cuda.synchronize()
            # the streamed epoch alone (run_epoch's loop, its updates
            # counted): the counts are read before the reference runs
            lda_estep.reset_launches()
            t0 = time.perf_counter()
            updates = 0
            while se.stream_step():
                updates += 1
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            counts = dict(lda_estep.LAUNCHES)
            fp = "fixed_point" if layout == "padded" else "fixed_point_csr"
            check(updates > 0 and counts[fp] == updates
                  and counts["segment_scatter"] == updates
                  and sum(counts.values()) == 2 * updates,
                  f"uci {layout}: not one {fp} and one segment_scatter "
                  f"an update over {updates}: {counts}")
            launches[layout] = counts
            if layout == "csr":
                ce = LDAEngine(cfg, CorpusDocStream(eager, spec.vocab_size),
                               **kw)
                ce.run_epoch()
            else:
                ce = LDAEngine(cfg, eager, **kw)
                packer = BatchPacker(batch, max_width=stream.max_unique)
                sched = []
                for pos, (ids, cnts) in enumerate(stream.iter_from(0)):
                    b = packer.add(pos, ids, cnts)
                    if b is not None:
                        sched.append(b)
                for b in sched + packer.flush():
                    ce.run_minibatch(b.rows, width=b.width)
            check(torch.equal(se.state.lam, ce.state.lam)
                  and torch.equal(se.state.m_vk, ce.state.m_vk),
                  f"uci {layout}: λ from the stream differs from the "
                  "materialized file's")
            out[layout] = {"train_docs_per_s": se.num_docs / train_s,
                           "epoch_s": train_s, "updates": updates,
                           "launches": counts, "lam_bit_equal": True}
            del se, ce
    out["launches"] = launches
    emit(out)
    return out


def phase_cvb0(device, spec, train, test, topics, batch, ivi):
    """CVB0 on the card: one epoch at B = 1,024, 5 inner iterations; ms a
    mini-batch, 2 K3 launches a step, N_vk against Σ cnt·γ over the memo
    (the memo invariant's bar), the same bits on a second run, held-out
    LPP beside phase train's IVI after its first epoch."""
    import numpy as np
    import torch
    from repro_torch.core.cvb0 import CVB0Engine, scatter_counts
    from repro_torch.core.predictive import log_predictive, split_heldout
    from repro_torch.core.types import LDAConfig
    from repro_torch.kernels import lda_estep

    cfg = LDAConfig(num_topics=topics, vocab_size=spec.vocab_size)
    obs, held = split_heldout(test, seed=0)
    runs, step_ms = [], []
    for run in range(2):
        eng = CVB0Engine(cfg, train, batch_size=batch, seed=0,
                         inner_iters=5, device=device)
        if run == 0:
            lpp0 = float(log_predictive(cfg, eng.lam, obs, held))
            # run_epoch's draw and batches, each step timed on its own
            order = eng.rng.permutation(eng.corpus.num_docs)
            n = (len(order) // batch) * batch
            lda_estep.reset_launches()
            for rows in order[:n].reshape(-1, batch):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.run_minibatch(rows)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            launches = dict(lda_estep.LAUNCHES)
            steps = len(step_ms)
            check(launches["segment_scatter"] == 2 * steps
                  and sum(launches.values()) == 2 * steps,
                  f"cvb0: not 2 K3 launches a step over {steps}: {launches}")
        else:
            eng.run_epoch()
        runs.append(eng)
    a, b = runs
    check(torch.equal(a.state.n_vk, b.state.n_vk)
          and torch.equal(a.state.gamma, b.state.gamma),
          "cvb0: two runs differ")
    ids, cnts = a.corpus.token_ids, a.corpus.counts
    rebuilt = scatter_counts(ids, cnts, a.state.gamma, spec.vocab_size,
                             lda_estep.scatter_segments(
                                 ids.reshape(-1), cnts.reshape(-1),
                                 spec.vocab_size))
    gap = float((a.state.n_vk - rebuilt).abs().max())
    check(torch.allclose(a.state.n_vk, rebuilt, rtol=1e-3, atol=1e-2),
          f"cvb0: N_vk off Σ cnt·γ by {gap}")
    words = float(a.state.n_vk.sum())
    check(abs(words - float(train.num_words)) <= 1e-4 * words,
          f"cvb0: Σ N_vk = {words} against {float(train.num_words)} words")
    lpp = float(log_predictive(cfg, a.lam, obs, held))
    check(np.isfinite(lpp), f"cvb0: LPP {lpp0} -> {lpp}")
    out = {"phase": "cvb0", "batch": batch, "inner_iters": 5,
           "docs": a.docs_seen, "steps": steps,
           "median_ms_per_minibatch": float(np.median(step_ms)),
           "docs_per_s": a.docs_seen / (sum(step_ms) / 1e3),
           "launches": launches, "n_vk_gap": gap, "bits_equal_two_runs":
           True, "lpp_start": lpp0, "lpp": lpp,
           "ivi_lpp_epoch1": ivi["lpp"][0], "ivi_docs_epoch1": train.num_docs,
           "gamma_memo_bytes": a.state.gamma.numel() * 4}
    emit(out)
    del runs, a, b
    return out


# ---------------------------------------------------------------------------
# the LM template's serving path
# ---------------------------------------------------------------------------

LM_ARCH = "qwen2.5-3b"        # src/repro_torch/configs/qwen2_5_3b.py, unreduced
# its (layers, d_model, heads, KV heads, d_ff, vocab)
LM_WIDTH = (36, 2048, 16, 2, 11008, 151_936)
LM_SEED = 0
LM_PREFILL_S = 4096
LM_LONG_S = 32_768            # prefill_32k's length; its batch of 32 cut to 1
# the long_500k variant (force_local: a window of 4,096 on every layer):
# its prefill at twice the window, its 524,288 tokens cut to 8,192
LM_WINDOW_S = 8192
LM_SERVE = dict(batch=4, prompt=16, new_tokens=32)  # repro's launcher defaults
LM_MOE_ARCH = "deepseek-moe-16b"   # configs/deepseek_moe_16b.py, unreduced
# its (layers, d_model, heads, KV heads, experts, top k, shared experts,
# expert d_ff, dense d_ff, vocab)
LM_MOE_WIDTH = (28, 2048, 16, 16, 64, 6, 2, 1408, 10_944, 102_400)
LM_QWEN3_ARCH = "qwen3-moe-30b-a3b"  # configs/qwen3_moe_30b_a3b.py
# its depth cut from 48 layers to 8 (about 11 GB in bf16: the whole
# model's 61 GB leaves too thin a margin on an 80 GB card)
LM_QWEN3_LAYERS = 8
LM_ZAMBA_ARCH = "zamba2-1.2b"      # configs/zamba2_1_2b.py, unreduced
# its (layers, d_model, shared-block applications)
LM_ZAMBA_WIDTH = (38, 2048, 6)
LM_XLSTM_ARCH = "xlstm-1.3b"       # configs/xlstm_1_3b.py, unreduced
LM_XLSTM_WIDTH = (48, 2048)        # its (layers, d_model)
# xLSTM's prefill length, cut from 4,096 to one 256-token chunk: its 24
# sLSTM layers are a loop over time of ~27 launches a step each (a
# 512-token prefill read 3.54 s and ~336k launches on an NVIDIA H100 80GB
# HBM3 at 700 W, PR 26)
LM_XLSTM_S = 256
# ... and its depth in serving, cut from 48 layers to the first 12 (6
# mLSTM, 6 sLSTM, at full width) to keep the script inside its time limit
# with the mesh training after it: at 48 layers and 256 tokens the
# model's serving checks took 157 s of a 735 s script, at 24 ~80 s
# (NVIDIA H100 80GB HBM3 at 700 W), most of it the profiled sLSTM loops
LM_XLSTM_LAYERS = 12
LM_GEMMA2_ARCH = "gemma2-27b"      # configs/gemma2_27b.py, unreduced
# its (layers, d_model, heads, KV heads, head dim, d_ff, vocab, window,
# logit softcap)
LM_GEMMA2_WIDTH = (46, 4608, 32, 16, 128, 36_864, 256_000, 4096, 50.0)
# its prefill at its context length, 8,192 [arXiv:2408.00118], twice its
# local layers' window (at 4,096 the window would mask nothing)
LM_GEMMA2_S = 8192
# its depth in serving, cut from 46 layers to the first 12 (6 local and 6
# global, at full width) to keep the script inside its time limit with
# xLSTM's 12 layers and the flex_attention compiles of attention_band: at
# 46 the phase took 48-55 s of a 1,056-1,189 s script, at 24 26-29 s
# (NVIDIA H100 80GB HBM3 at 700 W)
LM_GEMMA2_LAYERS = 12
# K9 against its twin on layers 0 (local) and 1 (global): the first 8
# query heads and the 4 KV heads they read, so that the twin's fp32
# scores take 2.1 GB beside the 54.5 GB of weights
LM_GEMMA2_TWIN_HEADS = 8
# each model's bf16 agreement bar: the last logits of the whole prefill
# through K9 (fp32 scores) against the plain route's, and the serve
# step's at the last of 16 prompt tokens (fp32 caches) against the
# prefill's; relative L2. Two routes of one function round apart in bf16:
# a MoE router flips near-tied experts between them (Qwen3-MoE picks 8 of
# 128 and renormalises), and a recurrent block's chunked scan rounds its
# intra-chunk products to bf16 where the one-step recurrence keeps an fp32
# state, as in repro. On an NVIDIA H100 80GB HBM3 at 700 W (PERF §6):
# Qwen2.5-3B read 0.0180 and 0.0183 (PR 25); DeepSeekMoE-16B 0.0152 and
# 0.0199 (routing flips 9% of tokens a layer); Qwen3-MoE at 8 layers
# 0.0134 and 0.0609 (flips 10-20%); zamba2-1.2B 0.0264 and 0.0529;
# xLSTM-1.3B decode 0.0785 (repro's own bf16 decode is as far from its
# prefill, tests/test_torch_recurrent.py) (PR 26). Each bar is about twice
# its reading, 0.04 at least; the fp32 checks (LM_FP32_REL_L2, which read
# 1e-6 to 7e-5) hold the function itself. gemma2-27B at S = 8,192 read
# 0.0223 and 0.0281 at its 46 layers, 0.0175 and 0.0213 at 24
LM_BF16_REL_L2 = {"qwen2.5-3b": 4e-2, "deepseek-moe-16b": 4e-2,
                  "qwen3-moe-30b-a3b": 0.12, "zamba2-1.2b": 0.11,
                  "xlstm-1.3b": 0.16, "gemma2-27b": 0.06}
# the agreement checks again in fp32 (K9's fp32 mode, fp32 weights: the
# bf16 model's masters, the same seed) at a cut depth: rounding alone
# separates the routes there
LM_FP32_REL_L2 = 1e-3
LM_FP32_LAYERS = {"deepseek-moe-16b": 8, "qwen3-moe-30b-a3b": 8,
                  "zamba2-1.2b": 12, "xlstm-1.3b": 4,
                  # two (local, global) pairs
                  "gemma2-27b": 4}
# a MoE layer's bf16 FFN against the same function in fp32 from the same
# weights and input: bf16 rounding and the tokens whose top-k set flips.
# A different function (another expert order, a dropped token, another
# weight) is off by O(1); the bar is a tenth of that
LM_MOE_FFN_REL_L2 = 0.1
# the matrices a token multiplies (biases, norms and the depthwise convs
# are not products)
PRODUCT_KEYS = frozenset({"wq", "wk", "wv", "wo", "w_gate", "w_up",
                          "w_down", "router", "in_proj", "out_proj", "w_in",
                          "w_gates", "r"})
ROUTED_KEYS = ("w_gate", "w_up", "w_down")


def lm_weight_bytes(tree):
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def lm_numel(tree):
    from repro_torch.tree import tree_leaves
    return sum(t.numel() for t in tree_leaves(tree))


def rel_l2(got, want):
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def device_share(events, name):
    """Share of the device time in ``events`` spent in kernels whose name
    holds ``name``."""
    total = sum(e.self_device_time_total for e in events)
    mine = sum(e.self_device_time_total for e in events if name in e.key)
    check(total > 0, "device_share: no device time recorded")
    return mine / total, total / 1e3


def product_weights(cfg, node, key=None):
    """The weights one token multiplies in ``node`` (a layer's dict): the
    product matrices, a MoE layer's routed experts at k of E (each token
    reads k of them), its router and shared experts whole."""
    if isinstance(node, dict):
        if key == "moe":
            routed = sum(node[w].numel() for w in ROUTED_KEYS)
            return (node["router"].numel() + routed
                    * cfg.num_experts_per_tok // cfg.num_experts
                    + product_weights(cfg, node.get("shared", {})))
        return sum(product_weights(cfg, v, k) for k, v in node.items())
    return node.numel() if key in PRODUCT_KEYS else 0


def lm_token_weights(cfg, params):
    """``product_weights`` over the model: every layer, and zamba2's shared
    block once an application."""
    from repro_torch.configs.base import MAMBA2_SHARED
    return sum(product_weights(cfg, p) for p in params["layers"]) + \
        cfg.pattern.count(MAMBA2_SHARED) * product_weights(
            cfg, params.get("shared_attn", {}))


def lm_active_bound(cfg, params, b, s):
    """The least time of a prefill: each token's active weights
    (``lm_token_weights``: k routed experts, the shared experts and the
    router of a MoE layer) at 2 operations a weight, causal attention's
    Q·Kᵀ and P·V on every attention layer (over its band where the layer
    has a window), the last position's readout, at the bf16 tensor-core
    rate; beside every bf16 weight read once. The recurrent scans' own
    operations are not counted. Returns (ms, bound by, operations,
    bytes)."""
    from repro_torch.configs.base import (ATTN, ATTN_LOCAL, MAMBA2_SHARED,
                                          MOE, effective_window)
    works = [attention_work(b, s, cfg.num_heads, cfg.num_kv_heads,
                            cfg.resolved_head_dim,
                            effective_window(cfg, kind))
             for kind in cfg.pattern
             if kind in (ATTN, ATTN_LOCAL, MOE, MAMBA2_SHARED)]
    ops = 2.0 * lm_token_weights(cfg, params) * b * s \
        + sum(w[1] for w in works) + 2.0 * b * cfg.d_model * cfg.vocab_size
    nbytes = lm_weight_bytes(params) + sum(w[0] for w in works)
    return bound_ms(nbytes, ops, BF16_OPS_PER_S) + (ops, nbytes)


def lm_decode_bound(cfg, params, b, live_experts):
    """A decode step's least time: every weight read once but an untied
    input embedding (``b`` rows of it) and the routed experts (only the
    ``live_experts`` the step chose, summed over the MoE layers), beside
    2 operations a weight a token and the readout."""
    layers = params["layers"]
    routed = sum(p["moe"][w].numel() * p["moe"][w].element_size()
                 for p in layers if "moe" in p for w in ROUTED_KEYS)
    n_experts = sum("moe" in p for p in layers) * cfg.num_experts
    nbytes = lm_weight_bytes(params) - routed
    if n_experts:
        nbytes += live_experts * routed / n_experts
    if not cfg.tie_embeddings:
        embed = params["embed"]
        nbytes -= (embed.numel() - b * cfg.d_model) * embed.element_size()
    ops = 2.0 * b * (lm_token_weights(cfg, params)
                     + cfg.d_model * cfg.vocab_size)
    return bound_ms(nbytes, ops, BF16_OPS_PER_S)


def wrapped(module, name, make):
    """Context: ``module.name`` replaced by ``make(original)``."""
    import contextlib

    @contextlib.contextmanager
    def swap():
        orig = getattr(module, name)
        setattr(module, name, make(orig))
        try:
            yield
        finally:
            setattr(module, name, orig)
    return swap()


def moe_recorder(records, inputs=None):
    """A ``moe_ffn`` that also records each call's top-k expert sets
    (sorted, (N, k)) and, into ``inputs``, its input."""
    from repro_torch.models import moe as M

    def make(orig):
        def moe_ffn(cfg, p, x, ctx=None):
            y, aux = orig(cfg, p, x, ctx)
            _, _, top_i = M.route(cfg, p, x.reshape(-1, x.shape[-1]))
            records.append(top_i.sort(-1).values)
            if inputs is not None:
                inputs.append(x)
            return y, aux
        return moe_ffn
    return make


def annotated(region):
    """For ``wrapped``: the function inside a
    ``torch.profiler.record_function(region)`` range."""
    import torch

    def make(orig):
        def run(*args, **kwargs):
            with torch.profiler.record_function(region):
                return orig(*args, **kwargs)
        return run
    return make


def flip_shares(a, b):
    """Per MoE layer, the share of tokens whose top-k set differs."""
    return [float((x != y).any(-1).float().mean()) for x, y in zip(a, b)]


def region_device_share(fn, region):
    """Share of the device time of one call of ``fn`` spent in kernels
    launched inside ``torch.profiler.record_function(region)`` ranges
    (``region_device_ms``), from one profiler session after a warm-up;
    with the region's call count and both times in ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        # the range's own device-side annotation is a span, not a kernel
        total = sum(e.self_device_time_total for e in events
                    if e.device_type == cuda and e.name != region) / 1e3
        calls = sum(e.device_type != cuda and e.name == region
                    for e in events)
        inside = region_device_ms(events, [region])[region]
        if total > 0 and inside > 0:
            break
    check(total > 0 and 0 < inside <= total,
          f"region_device_share: {region} {inside} of {total} ms")
    return inside / total, calls, inside, total


def k9_counted(fn, *args):
    """``fn(*args)`` and the K9 launches it made."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    fa.reset_launches()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, fa.LAUNCHES["flash_attention"]


def k9_against_twin(cfg, p, h, positions, what, window=None,
                    twin_heads=None):
    """One attention's prefill inputs (``p`` its weights, ``h`` its normed
    input, batch 1), with the layer's ``window`` and the config's logit
    softcap: K9 on the rope'd, pre-scaled q at scale 1 is what
    ``flash_mha`` returns, the same bits on a second launch, and within
    the bf16 bars of its twin, the twin over the first ``twin_heads``
    query heads (all by default) and the KV heads they read."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import attention as A

    band = dict(window=window, softcap=cfg.attn_logit_softcap)
    with torch.inference_mode():
        q, k, v = A.prefill_qkv(cfg, p, h, positions)

        def heads(t):
            return t[0].transpose(0, 1).contiguous()     # (H, S, hd)

        qf, kf, vf = heads(q), heads(k), heads(v)
        got = fa.flash_attention(qf, kf, vf, causal=True, scale=1.0, **band)
        check(torch.equal(got, heads(ops.flash_mha(q, k, v, causal=True,
                                                      scale=1.0, **band))),
              f"{what}'s flash_mha output is not K9's")
        check(torch.equal(got, fa.flash_attention(qf, kf, vf, causal=True,
                                                  scale=1.0, **band)),
              f"{what}: two launches of K9 differ")
        n = twin_heads or qf.shape[0]
        nkv = n * kf.shape[0] // qf.shape[0]
        got = got[:n]
        want = fa.flash_attention_plain(qf[:n], kf[:nkv], vf[:nkv],
                                        causal=True, scale=1.0, **band)
    err = float((got.float() - want.float()).abs().max())
    check(torch.allclose(got.float(), want.float(), rtol=BF16_RTOL,
                         atol=BF16_ATOL),
          f"{what}'s K9 output off its twin by {err}")
    return {"heads": cfg.num_heads, "head_dim": cfg.resolved_head_dim,
            "twin_heads": n, "S": qf.shape[1], **band,
            "max_abs_err": err, "tol": f"rtol={BF16_RTOL} atol={BF16_ATOL}",
            "bit_equal_two_launches": True}


def lm_build(cfg, device):
    """The bf16 parameters by the layer-at-a-time builder, seeded: counts,
    bytes, seconds and the build's peak memory over the weights (at most
    twice the largest fp32 piece drawn at once)."""
    import torch
    from repro_torch.models import transformer as T
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = T.init_params(cfg, LM_SEED, device=device, cast=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = lm_weight_bytes(params)
    over = torch.cuda.max_memory_allocated() - base - weight_bytes
    # the largest array or layer drawn at once, in fp32
    piece = max(2 * lm_weight_bytes(p) for p in
                [*params["layers"], *(params[k] for k in params
                                      if k != "layers")])
    check(over <= 2 * piece,
          f"{cfg.name}: the bf16 build peaked {over} bytes over its "
          f"weights, more than twice its largest fp32 piece's {piece}")
    return params, {"params": lm_numel(params),
                    "weight_bytes_bf16": weight_bytes, "init_s": init_s,
                    "init_peak_over_weights": over,
                    "largest_piece_fp32_bytes": piece}


def lm_serve_checks(cfg, params, device, *, s, k9, name, moe=False):
    """One model's serving path on the card, from the port's entry points:
    a B = 1 prefill of ``s`` tokens launching K9 ``k9`` times (ms,
    tokens/s, its bound, K9's share of device time, host syncs: one a MoE
    layer; for a MoE model the MoE FFN's share and each layer's routing
    flips against the plain route), the last logits against the plain
    route where there is attention, decode against prefill on 16 tokens
    (relative L2 of the last logits within the model's LM_BF16_REL_L2; a
    MoE model's routing flips between the two reported per layer), and
    generate at launch/serve.py's defaults (deterministic, no K9 launch,
    ms and host syncs a step, against the weight-read bound of what the
    step read). Profile lines are named ``profile_{name}_*``."""
    import numpy as np
    import torch
    from repro_torch.configs.base import MOE
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import generate
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.training import make_prefill_step, make_serve_step

    n_moe = cfg.pattern.count(MOE)
    bar = LM_BF16_REL_L2[cfg.name]
    gen = torch.Generator(device=device).manual_seed(LM_SEED)

    def tokens(b, n):
        return torch.randint(0, cfg.vocab_size, (b, n), generator=gen,
                             device=device)

    prefill = make_prefill_step(cfg)
    plain_prefill = make_prefill_step(cfg, attention="plain")
    out = {"seconds": {}}
    t0 = time.perf_counter()

    def lap(section):
        nonlocal t0
        out["seconds"][section] = time.perf_counter() - t0
        t0 = time.perf_counter()

    # prefill, B = 1 ------------------------------------------------------
    batch = {"tokens": tokens(1, s)}
    prefill(params, batch)                               # warm-up
    logits, launched = k9_counted(prefill, params, batch)
    check(launched == k9,
          f"{name}: one prefill launched K9 {launched} times, not {k9}")
    check(logits.shape == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits.float()).all()),
          f"{name}: prefill logits {tuple(logits.shape)} or values")
    ms = cuda_ms(lambda: prefill(params, batch), 3, warmup=0)
    syncs = host_syncs(lambda: prefill(params, batch))
    check(syncs == n_moe,
          f"{name}: {syncs} host syncs a prefill, not one a MoE layer "
          f"({n_moe})")
    bms, by, ops, nbytes = lm_active_bound(cfg, params, 1, s)
    share, dev_ms = device_share(profiled(lambda: prefill(params, batch), 1),
                                 "flash") if k9 else (0.0, None)
    out["prefill"] = {"B": 1, "S": s, "k9_launches": launched, "ms": ms,
                      "tokens_per_s": s / ms * 1e3, "bound_ms": bms,
                      "bound_by": by, "bound_ops": ops,
                      "bound_bytes": nbytes, "share_of_bound": bms / ms,
                      "k9_device_share": share, "device_ms": dev_ms,
                      "host_syncs": syncs}
    if moe:
        with wrapped(M, "moe_ffn", annotated("moe_ffn")):
            mshare, calls, moe_ms, total_ms = region_device_share(
                lambda: prefill(params, batch), "moe_ffn")
        check(calls == n_moe, f"{name}: {calls} MoE FFN calls a prefill")
        out["prefill"].update(moe_device_share=mshare,
                              moe_device_ms=moe_ms,
                              profiled_device_ms=total_ms)
    phase_profile(lambda: prefill(params, batch), updates=1,
                  phase=f"profile_{name}_prefill")
    lap("prefill")

    # the whole prefill against the plain route --------------------------
    if k9:
        routes = {"flash": [], "plain": []}
        inputs = []
        with wrapped(M, "moe_ffn", moe_recorder(routes["flash"], inputs)):
            logits, _ = k9_counted(prefill, params, batch)
        with wrapped(M, "moe_ffn", moe_recorder(routes["plain"])):
            plain, launched = k9_counted(plain_prefill, params, batch)
        check(launched == 0,
              f"{name}: the plain route launched K9 {launched} times")
        err = rel_l2(logits, plain)
        out["prefill"].update(
            plain_ms=cuda_ms(lambda: plain_prefill(params, batch), 1,
                             warmup=0),
            rel_l2_vs_plain=err,
            max_abs_err_vs_plain=float((logits.float() - plain.float())
                                       .abs().max()),
            argmax_equal_plain=bool(torch.equal(logits.argmax(-1),
                                                plain.argmax(-1))),
            tol=f"relative L2 {bar}")
        if moe:
            flips = flip_shares(routes["flash"], routes["plain"])
            out["prefill"]["routing_flip_share_vs_plain"] = {
                "per_moe_layer": flips, "max": max(flips),
                "mean": sum(flips) / len(flips)}
            out["moe_ffn_layer1"] = moe_ffn_vs_fp32(
                cfg, params["layers"][1]["moe"],
                inputs[cfg.pattern[:1].count(MOE)], name)
        check(err <= bar,
              f"{name}: the K9 prefill off the plain route's by {err} "
              "relative L2")
        del plain, routes, inputs
        lap("plain")
    del batch, logits

    # decode against prefill on 16 tokens --------------------------------
    bsz, plen = LM_SERVE["batch"], LM_SERVE["prompt"]
    prompt = tokens(bsz, plen)
    serve = make_serve_step(cfg)
    routes = {"prefill": [], "decode": []}
    with wrapped(M, "moe_ffn", moe_recorder(routes["prefill"])):
        want = prefill(params, {"tokens": prompt})
    caches = T.init_caches(cfg, bsz, plen, dtype=torch.float32,
                           device=device)
    fa.reset_launches()
    with wrapped(M, "moe_ffn", moe_recorder(routes["decode"])):
        for t in range(plen):
            _, got, caches = serve(params, caches, prompt[:, t],
                                   torch.full((bsz,), t, dtype=torch.int32,
                                              device=device))
    torch.cuda.synchronize()
    check(fa.LAUNCHES["flash_attention"] == 0, f"{name}: decode launched K9")
    err = rel_l2(got, want)
    out["decode_vs_prefill"] = {
        "B": bsz, "prompt": plen, "rel_l2": err,
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "argmax_equal": bool(torch.equal(got.argmax(-1), want.argmax(-1))),
        "tol": f"relative L2 {bar}"}
    if moe:
        # step t's call at MoE layer l routes token (b, t): the prefill's
        # row b·plen + t of that layer
        dec = [torch.stack([routes["decode"][t * n_moe + l]
                            for t in range(plen)], 1).reshape(bsz * plen, -1)
               for l in range(n_moe)]
        flips = flip_shares(dec, routes["prefill"])
        out["decode_vs_prefill"]["routing_flip_share"] = {
            "per_moe_layer": flips, "max": max(flips),
            "mean": sum(flips) / len(flips)}
    del routes
    check(err <= bar,
          f"{name}: decode's logits off the prefill's by {err} relative L2")
    pos = torch.full((bsz,), plen - 1, dtype=torch.int32, device=device)
    step_syncs = host_syncs(lambda: serve(params, caches, prompt[:, -1],
                                          pos))
    check(step_syncs == n_moe,
          f"{name}: {step_syncs} host syncs a decode step, not {n_moe}")
    step_dev = device_ms(lambda: serve(params, caches, prompt[:, -1], pos),
                         reps=3)
    phase_profile(lambda: serve(params, caches, prompt[:, -1], pos),
                  updates=2, phase=f"profile_{name}_decode")
    del caches, want, got
    lap("decode")

    # serving: launch/serve.py's generate --------------------------------
    new = LM_SERVE["new_tokens"]
    rng = np.random.default_rng(LM_SEED)
    host_prompt = rng.integers(0, cfg.vocab_size, (bsz, plen))
    live = []

    def live_recorder(orig):
        def moe_ffn(cfg_, p, x, ctx=None):
            y, aux = orig(cfg_, p, x, ctx)
            live.append((aux["counts"] > 0).sum())
            return y, aux
        return moe_ffn

    with wrapped(M, "moe_ffn", live_recorder):
        first = generate(cfg, params, host_prompt, new, device=device)
    torch.cuda.synchronize()
    fa.reset_launches()
    t1 = time.perf_counter()
    second = generate(cfg, params, host_prompt, new, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launched = fa.LAUNCHES["flash_attention"]
    check(launched == 0, f"{name}: generate launched K9 {launched} times")
    check(torch.equal(first, second), f"{name}: two generate runs differ")
    check(second.shape == (bsz, new),
          f"{name}: generated {tuple(second.shape)}")
    steps = plen + new
    live_per_step = float(sum(int(n) for n in live)) / steps
    dec_bound, dec_by = lm_decode_bound(cfg, params, bsz, live_per_step)
    out["serve"] = {"B": bsz, "prompt": plen, "new_tokens": new,
                    "wall_s": wall, "ms_per_step": wall * 1e3 / steps,
                    "step_device_ms": step_dev,
                    "host_syncs_per_step": step_syncs,
                    "tokens_per_s": bsz * new / wall,
                    "tokens_per_s_incl_prompt": bsz * steps / wall,
                    "bound_ms_per_step": dec_bound, "bound_by": dec_by,
                    "k9_launches": launched, "deterministic": True,
                    "sample": second[0, :12].tolist()}
    if n_moe:
        out["serve"]["live_experts_per_moe_layer_step"] = \
            live_per_step / n_moe
    lap("serve")
    return out


def moe_ffn_vs_fp32(cfg, p, x, name):
    """A MoE layer's FFN on the card (bf16) against the same function in
    fp32 from the same weights and input: relative L2 of the outputs and
    the share of tokens whose top-k set differs."""
    import dataclasses
    import torch
    from repro_torch.models import moe as M
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = {k: ({kk: vv.float() for kk, vv in v.items()}
               if isinstance(v, dict) else v.float()) for k, v in p.items()}
    y, aux = M.moe_ffn(cfg, p, x)
    y32, _ = M.moe_ffn(cfg32, p32, x.float())
    flat = x.reshape(-1, x.shape[-1])
    top = M.route(cfg, p, flat)[2].sort(-1).values
    top32 = M.route(cfg32, p32, flat.float())[2].sort(-1).values
    err = rel_l2(y, y32)
    flip = flip_shares([top], [top32])[0]
    check(bool(torch.isfinite(y.float()).all()) and err <= LM_MOE_FFN_REL_L2,
          f"{name}: layer 1's bf16 MoE FFN off its fp32 function by {err}")
    del p32
    return {"tokens": flat.shape[0], "rel_l2_vs_fp32": err,
            "topk_flip_share": flip, "tol": f"relative L2 "
            f"{LM_MOE_FFN_REL_L2}", "dropped": float(aux["dropped"]),
            "counts_max": float(aux["counts"].max()),
            "counts_min": float(aux["counts"].min())}


def lm_fp32_agreement(cfg, device, s):
    """The agreement checks in fp32 at ``LM_FP32_LAYERS`` layers: fp32
    weights from the seed (the bf16 model's masters for those layers, the
    draws coming in the same order), the last logits of the K9 prefill
    (K9's fp32 mode) against the plain route's, and decode against
    prefill on 16 tokens, each within LM_FP32_REL_L2; a MoE model's
    routing flips reported. Emits an ``lm_fp32`` line."""
    import dataclasses
    import torch
    from repro_torch.configs.base import (ATTN, ATTN_LOCAL, MAMBA2_SHARED,
                                          MOE)
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.training import make_prefill_step, make_serve_step

    layers = LM_FP32_LAYERS[cfg.name]
    cfg = dataclasses.replace(cfg, dtype="float32", num_layers=layers,
                              layer_pattern=cfg.pattern[:layers])
    n_moe = cfg.pattern.count(MOE)
    params = T.init_params(cfg, LM_SEED, device=device)
    gen = torch.Generator(device=device).manual_seed(LM_SEED + 2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, s),
                                     generator=gen, device=device)}
    routes = {"flash": [], "plain": []}
    with wrapped(M, "moe_ffn", moe_recorder(routes["flash"])):
        logits, k9 = k9_counted(make_prefill_step(cfg), params, batch)
    with wrapped(M, "moe_ffn", moe_recorder(routes["plain"])):
        plain = make_prefill_step(cfg, attention="plain")(params, batch)
    want_k9 = sum(kind in (ATTN, ATTN_LOCAL, MOE, MAMBA2_SHARED)
                  for kind in cfg.pattern)
    check(k9 == want_k9, f"{cfg.name} fp32: K9 {k9} launches, not {want_k9}")
    out = {"layers": layers, "dtype": "float32", "S": s, "k9_launches": k9,
           "rel_l2_vs_plain": rel_l2(logits, plain),
           "tol": f"relative L2 {LM_FP32_REL_L2}"}
    if n_moe:
        out["routing_flips_vs_plain_max"] = max(
            flip_shares(routes["flash"], routes["plain"]))
    bsz, plen = LM_SERVE["batch"], LM_SERVE["prompt"]
    prompt = torch.randint(0, cfg.vocab_size, (bsz, plen), generator=gen,
                           device=device)
    want = make_prefill_step(cfg)(params, {"tokens": prompt})
    serve = make_serve_step(cfg)
    caches = T.init_caches(cfg, bsz, plen, dtype=torch.float32,
                           device=device)
    for t in range(plen):
        _, got, caches = serve(params, caches, prompt[:, t],
                               torch.full((bsz,), t, dtype=torch.int32,
                                          device=device))
    out["decode_rel_l2_vs_prefill"] = rel_l2(got, want)
    emit({"phase": "lm_fp32", "arch": cfg.name, **out})
    check(out["rel_l2_vs_plain"] <= LM_FP32_REL_L2
          and out["decode_rel_l2_vs_prefill"] <= LM_FP32_REL_L2,
          f"{cfg.name} fp32: {out}")
    del params, caches
    torch.cuda.empty_cache()
    return out


def phase_lm(device):
    """The LM template's serving path at Qwen2.5-3B's full width (36
    layers, d_model 2,048, 16 query and 2 KV heads of 128, d_ff 11,008,
    vocab 151,936, tied embeddings, QKV bias), weights from the port's
    seeded init, bf16 copy made once by cast_params: lm_serve_checks at S
    = 4,096 (K9 36 times a prefill, no host sync), layer 0's K9 output
    against its twin at the bf16 bars and the same bits twice, a
    32,768-token prefill (ms, K9's share of device time, peak memory),
    and the long_500k variant's prefill at S = 8,192 (a window of 4,096
    on all 36 layers): K9 once a layer, the last logits against the plain
    route's within the model's bar, ms beside the same prefill without
    the window."""
    import torch
    from repro_torch.configs import get_config, get_shape
    from repro_torch.configs.base import ATTN, effective_window, shape_variant
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import apply_norm, compute_dtype
    from repro_torch.training import make_prefill_step

    cfg = get_config(LM_ARCH)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.d_ff, cfg.vocab_size) == LM_WIDTH,
          f"lm: {LM_ARCH} is not at its full width: {cfg}")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    masters = T.init_params(cfg, LM_SEED, device=device)
    n_params = lm_numel(masters)
    params = T.cast_params(cfg, masters)
    del masters
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = lm_weight_bytes(params)
    out = {"phase": "lm", "arch": cfg.name, "params": n_params,
           "weight_bytes_bf16": weight_bytes, "init_s": init_s}
    out.update(lm_serve_checks(cfg, params, device, s=LM_PREFILL_S,
                               k9=cfg.num_layers, name="lm"))
    gen = torch.Generator(device=device).manual_seed(LM_SEED + 1)

    def tokens(s):
        return torch.randint(0, cfg.vocab_size, (1, s), generator=gen,
                             device=device)

    # layer 0's attention: K9 against its twin ---------------------------
    batch = {"tokens": tokens(LM_PREFILL_S)}
    with torch.inference_mode():
        x, positions = T._embed(cfg, params, batch, compute_dtype(cfg))
        layer = params["layers"][0]
        h = apply_norm(cfg, layer["norm1"], x)
    out["layer0_attention"] = k9_against_twin(cfg, layer["attn"], h,
                                              positions, "lm: layer 0")
    del x, h

    # prefill, B = 1, S = 32,768 -----------------------------------------
    prefill = make_prefill_step(cfg)
    batch = {"tokens": tokens(LM_LONG_S)}
    torch.cuda.reset_peak_memory_stats()
    logits, k9 = k9_counted(prefill, params, batch)
    peak = torch.cuda.max_memory_allocated()
    check(k9 == cfg.num_layers and bool(torch.isfinite(logits.float()).all()),
          f"lm: the 32k prefill launched K9 {k9} times, or its logits")
    ms = cuda_ms(lambda: prefill(params, batch), 2, warmup=0)
    bms, by, _, _ = lm_active_bound(cfg, params, 1, LM_LONG_S)
    share, dev_ms = device_share(profiled(lambda: prefill(params, batch), 1),
                                 "flash")
    out["prefill_32k"] = {"B": 1, "S": LM_LONG_S, "reduced": "batch 32 -> 1",
                          "k9_launches": k9, "ms": ms,
                          "tokens_per_s": LM_LONG_S / ms * 1e3,
                          "bound_ms": bms, "bound_by": by,
                          "k9_device_share": share, "device_ms": dev_ms,
                          "peak_bytes": peak,
                          "peak_bytes_over_weights": peak - weight_bytes}
    del batch, logits

    # the long_500k variant: a window of 4,096 on every layer, S = 8,192 --
    long_cfg, note = shape_variant(cfg, get_shape("long_500k"))
    window = effective_window(long_cfg, ATTN)
    check(window == K9_BAND_WINDOW and LM_WINDOW_S > window,
          f"lm: the long_500k variant's window is {window}")
    batch = {"tokens": tokens(LM_WINDOW_S)}
    prefill_long = make_prefill_step(long_cfg)
    prefill_long(params, batch)                          # warm-up
    logits, k9 = k9_counted(prefill_long, params, batch)
    plain, plain_k9 = k9_counted(make_prefill_step(long_cfg,
                                                   attention="plain"),
                                 params, batch)
    err = rel_l2(logits, plain)
    bar = LM_BF16_REL_L2[cfg.name]
    check(k9 == cfg.num_layers and plain_k9 == 0
          and bool(torch.isfinite(logits.float()).all()),
          f"lm: the long_500k prefill launched K9 {k9} times (plain "
          f"{plain_k9}), or its logits")
    check(err <= bar, f"lm: the long_500k prefill off the plain route's "
          f"by {err} relative L2")
    bms, by, _, _ = lm_active_bound(long_cfg, params, 1, LM_WINDOW_S)
    ms = cuda_ms(lambda: prefill_long(params, batch), 3, warmup=0)
    out["prefill_long_500k"] = {
        "variant": note, "window": window, "B": 1, "S": LM_WINDOW_S,
        "reduced": f"S 524288 -> {LM_WINDOW_S}", "k9_launches": k9,
        "ms": ms, "tokens_per_s": LM_WINDOW_S / ms * 1e3,
        "bound_ms": bms, "bound_by": by,
        "ms_without_window": cuda_ms(lambda: prefill(params, batch), 3),
        "rel_l2_vs_plain": err, "tol": f"relative L2 {bar}",
        "argmax_equal_plain": bool(torch.equal(logits.argmax(-1),
                                               plain.argmax(-1)))}
    del batch, logits, plain
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    emit(out)
    del params
    torch.cuda.empty_cache()
    return out


def phase_lm_moe(device):
    """DeepSeekMoE-16B unreduced (28 layers, d_model 2,048, 16 heads of
    128, 64 routed experts of 1,408 at top 6, 2 shared, layer 0 dense at
    10,944, vocab 102,400) from the bf16 builder: lm_serve_checks at S =
    4,096 (K9 28 times a prefill), the MoE FFN's share of device time,
    host syncs a prefill and a decode step (one a MoE layer), layer 1's
    FFN against fp32, routing flips against the plain route; then
    Qwen3-MoE-30B-A3B at full width with its depth cut to 8 layers (128
    experts at top 8, norm_topk_prob, qk-norm, 32 / 4 heads): the same
    checks. Each model is freed before the next is built, and its
    agreement checks run again in fp32 at a cut depth
    (lm_fp32_agreement)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config

    cfg = get_config(LM_MOE_ARCH)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.num_experts, cfg.num_experts_per_tok, cfg.num_shared_experts,
           cfg.moe_d_ff, cfg.dense_d_ff, cfg.vocab_size) == LM_MOE_WIDTH,
          f"lm_moe: {LM_MOE_ARCH} is not at its full width: {cfg}")
    qwen3 = get_config(LM_QWEN3_ARCH)
    qwen3 = dataclasses.replace(
        qwen3, num_layers=LM_QWEN3_LAYERS,
        layer_pattern=qwen3.pattern[:LM_QWEN3_LAYERS])
    runs = {}
    for cfg, reduced in ((cfg, None),
                         (qwen3, f"layers 48 -> {LM_QWEN3_LAYERS}")):
        params, built = lm_build(cfg, device)
        row = {"phase": "lm_moe", "arch": cfg.name, "reduced": reduced,
               **built}
        row.update(lm_serve_checks(cfg, params, device, s=LM_PREFILL_S,
                                   k9=cfg.num_layers, name=cfg.name,
                                   moe=True))
        row["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        emit(row)
        runs[cfg.name] = row
        del params
        torch.cuda.empty_cache()
        row["fp32"] = lm_fp32_agreement(cfg, device, LM_PREFILL_S)
    return runs


def phase_lm_recurrent(device):
    """zamba2-1.2B unreduced (38 Mamba2 layers, d_model 2,048, state 64,
    heads of 64; its shared attention block, 32 heads of 64, on layers 5,
    11, ..., 35) from the bf16 builder: the first shared block's K9 output
    against its twin at the bf16 bars, the same bits twice, and
    lm_serve_checks at S = 4,096 (a multiple of its 256-token chunk; K9 6
    times a prefill, once a shared block); then xLSTM-1.3B at full width
    (mLSTM and sLSTM layers alternating, 4 heads of 1,024 in the mLSTM),
    cut to its first LM_XLSTM_LAYERS layers and a prefill of LM_XLSTM_S
    tokens: no K9 launch, decode against prefill, generate. Each model's
    agreement checks run again in fp32 at a cut depth
    (lm_fp32_agreement)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MAMBA2_SHARED
    from repro_torch.models import recurrent as R
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import apply_norm, compute_dtype

    runs = {}
    cfg = get_config(LM_ZAMBA_ARCH)
    shared_at = [i for i, k in enumerate(cfg.pattern) if k == MAMBA2_SHARED]
    check((cfg.num_layers, cfg.d_model, len(shared_at)) == LM_ZAMBA_WIDTH,
          f"lm_recurrent: {LM_ZAMBA_ARCH} is not at its full width: {cfg}")
    params, built = lm_build(cfg, device)
    row = {"phase": "lm_recurrent", "arch": cfg.name, "reduced": None,
           "shared_block_layers": shared_at, **built}

    # the first shared block's attention: K9 against its twin ------------
    gen = torch.Generator(device=device).manual_seed(LM_SEED + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, LM_PREFILL_S),
                                     generator=gen, device=device)}
    shared = params["shared_attn"]
    first = shared_at[0]
    with torch.inference_mode():
        x, positions = T._embed(cfg, params, batch, compute_dtype(cfg))
        emb0 = x
        for i in range(first):
            x, _ = T.apply_layer(cfg, cfg.pattern[i], params["layers"][i], x,
                                 positions, emb0=emb0, shared=shared)
        layer = params["layers"][first]
        x = x + R.mamba2_train(cfg, layer["mamba"],
                               apply_norm(cfg, layer["norm"], x))
        h = T._shared_block(cfg, shared, x, emb0)
    row["shared_block_attention"] = {
        "layer": first, **k9_against_twin(cfg, shared["attn"], h, positions,
                                          "lm_recurrent: the shared block")}
    del batch, x, emb0, h
    row.update(lm_serve_checks(cfg, params, device, s=LM_PREFILL_S,
                               k9=len(shared_at), name=cfg.name))
    row["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    emit(row)
    runs[cfg.name] = row
    del params, shared
    torch.cuda.empty_cache()
    row["fp32"] = lm_fp32_agreement(cfg, device, LM_PREFILL_S)

    cfg = get_config(LM_XLSTM_ARCH)
    check((cfg.num_layers, cfg.d_model) == LM_XLSTM_WIDTH,
          f"lm_recurrent: {LM_XLSTM_ARCH} is not at its full width: {cfg}")
    cfg = lm_cut(cfg, slice(0, LM_XLSTM_LAYERS))
    params, built = lm_build(cfg, device)
    row = {"phase": "lm_recurrent", "arch": cfg.name,
           "reduced": f"prefill S 4096 -> {LM_XLSTM_S}, layers "
                      f"{LM_XLSTM_WIDTH[0]} -> {cfg.num_layers}", **built}
    row.update(lm_serve_checks(cfg, params, device, s=LM_XLSTM_S, k9=0,
                               name=cfg.name))
    row["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    emit(row)
    runs[cfg.name] = row
    del params
    torch.cuda.empty_cache()
    row["fp32"] = lm_fp32_agreement(cfg, device, LM_XLSTM_S)
    return runs


def phase_lm_gemma2(device):
    """gemma2-27B at full width (46 layers alternating local and global
    attention, d_model 4,608, 32 query and 16 KV heads of 128, d_ff
    36,864, vocab 256,000, tied; a window of 4,096 on the local layers, a
    logit softcap of 50.0 on all), its depth cut to the first
    LM_GEMMA2_LAYERS, from the layer-at-a-time bf16 builder (its peak over
    the weights at most twice its largest fp32 piece, the embedding): K9
    on layers 0 (window and softcap) and 1 (softcap) at S = 8,192 against
    its twin at the bf16 bars on the first LM_GEMMA2_TWIN_HEADS heads, the
    same bits twice; the serving checks at S = 8,192, its context length
    and twice its window (K9 once a layer a prefill, none in decode);
    lm_fp32 at 4 layers (two local, two global)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import effective_window
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import apply_norm, compute_dtype

    cfg = get_config(LM_GEMMA2_ARCH)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
           cfg.sliding_window, cfg.attn_logit_softcap) == LM_GEMMA2_WIDTH,
          f"lm_gemma2: {LM_GEMMA2_ARCH} is not at its full width: {cfg}")
    cfg = lm_cut(cfg, slice(0, LM_GEMMA2_LAYERS))
    params, built = lm_build(cfg, device)
    row = {"phase": "lm_gemma2", "arch": cfg.name,
           "reduced": f"layers {LM_GEMMA2_WIDTH[0]} -> {cfg.num_layers}",
           **built}

    # layers 0 (local) and 1 (global): K9 against its twin ---------------
    gen = torch.Generator(device=device).manual_seed(LM_SEED + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, LM_GEMMA2_S),
                                     generator=gen, device=device)}
    with torch.inference_mode():
        x, positions = T._embed(cfg, params, batch, compute_dtype(cfg))
        for i in (0, 1):
            kind, layer = cfg.pattern[i], params["layers"][i]
            h = apply_norm(cfg, layer["norm1"], x)
            row[f"layer{i}_attention"] = {"kind": kind, **k9_against_twin(
                cfg, layer["attn"], h, positions, f"lm_gemma2: layer {i}",
                window=effective_window(cfg, kind),
                twin_heads=LM_GEMMA2_TWIN_HEADS)}
            x, _ = T.apply_layer(cfg, kind, layer, x, positions)
    del batch, x, h
    torch.cuda.empty_cache()
    row.update(lm_serve_checks(cfg, params, device, s=LM_GEMMA2_S,
                               k9=cfg.num_layers, name=cfg.name))
    row["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    emit(row)
    del params
    torch.cuda.empty_cache()
    row["fp32"] = lm_fp32_agreement(cfg, device, LM_GEMMA2_S)
    return row


# ---------------------------------------------------------------------------
# the LM template's training path
# ---------------------------------------------------------------------------

# train_4k (configs/base.py): S = 4,096 at a global batch of 256, which
# does not fit one card at Qwen2.5-3B's width beside its fp32 masters,
# gradients and AdamW moments (4 x 12.3 GB): cut to 4, as 2 microbatches
LM_TRAIN_S = 4096
LM_TRAIN_BATCH = 4
LM_TRAIN_MICROBATCHES = 2
LM_TRAIN_STEPS = 8            # on one repeated batch; the last 6 timed
LM_TRAIN_LR = 3e-4            # repro's launcher default, cosine to 0
LM_TRAIN_CLIP = 1.0
# the other families at full width, cut depth: (layers of the pattern,
# batch, length), 3 steps each. zamba2's four are layers 2-5, so that the
# last applies the shared block; xLSTM's alternate mLSTM and sLSTM, its
# length the sLSTM's time loop's 256
LM_TRAIN_FAMILIES = {"deepseek-moe-16b": (slice(0, 4), 1, 1024),
                     "zamba2-1.2b": (slice(2, 6), 1, 4096),
                     "xlstm-1.3b": (slice(0, 4), 2, 256)}
LM_TRAIN_FAMILY_STEPS = 3
# fp32 on the card against the same port on the CPU, Qwen2.5-3B at full
# width and 4 layers: loss, ce and every gradient leaf (relative L2, the
# lm_fp32 bar); then microbatches=2 against 1: the gradients at the same
# bar, and the parameters after one AdamW step within repro's own bar
# (tests/test_optim_checkpoint.py:75-96), which holds little: AdamW's
# first step moves an element by at most its learning rate
LM_TRAIN_FP32 = dict(layers=4, batch=2, s=256)
LM_TRAIN_MICRO_TOL = 5e-3
# IAG over 8 shards, Qwen2.5-3B at 4 layers (the memo is 8 fp32 copies of
# the parameters): two passes, so the second subtracts each shard's
# memoized gradient; the aggregate against the memo's sum at repro's 1e-5
LM_TRAIN_IAG = dict(layers=4, shards=8, passes=2, batch=1, s=1024)
LM_TRAIN_IAG_TOL = 1e-5


def train_syncs_predicted(cfg, microbatches):
    """The host syncs of one train step: the MoE dispatch reads its
    segment sizes once a MoE layer a forward (models/moe.py), and under
    remat each layer's forward runs twice (the recompute); nothing else in
    the step reads the device."""
    from repro_torch.configs.base import MOE
    return cfg.pattern.count(MOE) * microbatches * (2 if cfg.remat else 1)


def lm_cut(cfg, layers):
    """``cfg`` with its pattern cut to ``layers`` (a slice)."""
    import dataclasses
    pattern = cfg.pattern[layers]
    return dataclasses.replace(cfg, num_layers=len(pattern),
                               layer_pattern=pattern)


def lm_train_batch(cfg, b, s, seed, device):
    """Seeded tokens and labels, (b, s) each."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    return {k: torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                             device=device) for k in ("tokens", "labels")}


def lm_train_run(cfg, params, opt, batch, steps, microbatches=1):
    """``steps`` train steps on one repeated batch through
    ``make_train_step`` (clip LM_TRAIN_CLIP): each step's loss, ce,
    grad_norm and host ms (between two synchronize calls); K9 launches
    over every step; the second step's host syncs, counted. Returns the
    state, the step function and the readings."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.training import TrainState, make_train_step
    step = make_train_step(cfg, opt, clip_norm=LM_TRAIN_CLIP,
                           microbatches=microbatches)
    state = TrainState(params, opt.init(params), 0)
    rows, syncs = [], None
    fa.reset_launches()
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 1:
            box = []
            syncs = host_syncs(lambda: box.append(step(state, batch)))
            state, metrics = box[0]
        else:
            state, metrics = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rows.append({"ms": ms, **{k: float(metrics[k]) for k in
                                  ("loss", "ce", "grad_norm", "lb_loss")}})
    k9 = fa.LAUNCHES["flash_attention"]
    losses = [r["loss"] for r in rows]
    want = train_syncs_predicted(cfg, microbatches)
    check(all(math.isfinite(r[k]) for r in rows
              for k in ("loss", "ce", "grad_norm", "lb_loss")),
          f"{cfg.name}: a loss or grad_norm is not finite: {rows}")
    check(losses[-1] < losses[0],
          f"{cfg.name}: the loss did not fall over {steps} steps: {losses}")
    check(k9 == 0, f"{cfg.name}: training launched K9 {k9} times")
    check(syncs == want,
          f"{cfg.name}: {syncs} host syncs a train step, predicted {want}")
    return state, step, {"steps": steps, "microbatches": microbatches,
                   "losses": losses, "ce": [r["ce"] for r in rows],
                   "grad_norms": [r["grad_norm"] for r in rows],
                   "lb_loss": [r["lb_loss"] for r in rows],
                   "step_ms": [r["ms"] for r in rows], "k9_launches": k9,
                   "host_syncs_per_step": syncs,
                   "host_syncs_predicted": want}


TRAIN_REGIONS = ("attention", "optimizer")


def lm_train_breakdown(cfg, state, step, batch):
    """Where a train step's time goes: one more step under torch.profiler
    (``profile_{cfg.name}_train``: device busy and idle, the top operations
    by device time), with each attention (``attention_train``: the
    projections and the plain chunked scan) and the optimizer (clip,
    update, apply) inside a ``record_function`` range; each region's
    device ms, its recompute and backward included, and its share of the
    step's device time. ``step``'s optimizer opens its own range
    (``annotated_optimizer``). Returns the state after the step and the
    regions."""
    from repro_torch.models import attention as A
    from repro_torch.training import steps as TS
    box = [state]
    with wrapped(A, "attention_train", annotated("attention")), \
            wrapped(TS, "clip_by_global_norm", annotated("optimizer")), \
            wrapped(TS, "apply_updates", annotated("optimizer")):
        regions = phase_profile(
            lambda: box.__setitem__(0, step(box[0], batch)[0]), updates=1,
            phase=f"profile_{cfg.name}_train", regions=TRAIN_REGIONS)
    return box[0], regions


def annotated_optimizer(opt):
    """``opt`` with its update inside a ``record_function("optimizer")``
    range."""
    from repro_torch.optim import Optimizer
    return Optimizer(opt.init, annotated("optimizer")(opt.update))


def train_flops(cfg, n_params, b, s):
    """A train step's model FLOPs: 6·N a token, and causal attention's
    Q·Kᵀ and P·V three times over (forward and backward) on every
    attention layer; the remat recompute not counted."""
    from repro_torch.configs.base import ATTN, ATTN_LOCAL, MAMBA2_SHARED, MOE
    _, a_ops = attention_work(b, s, cfg.num_heads, cfg.num_kv_heads,
                              cfg.resolved_head_dim)
    n_attn = sum(kind in (ATTN, ATTN_LOCAL, MOE, MAMBA2_SHARED)
                 for kind in cfg.pattern)
    return 6.0 * n_params * b * s + 3.0 * n_attn * a_ops


def lm_train_fp32(cfg, device):
    """Qwen2.5-3B at full width, LM_TRAIN_FP32's depth, in fp32: loss, ce
    and every gradient leaf on the card against the same port on the CPU
    (relative L2 within LM_FP32_REL_L2); then, on the card, the gradients
    accumulated over 2 microbatches against 1 on the same batch, leaf by
    leaf at the same bar, and one AdamW step with each, the parameters
    within LM_TRAIN_MICRO_TOL."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves, tree_map
    from repro_torch.training import (TrainState, loss_and_grads,
                                      make_train_step)
    run = LM_TRAIN_FP32
    cfg = dataclasses.replace(lm_cut(cfg, slice(0, run["layers"])),
                              dtype="float32")
    params = T.init_params(cfg, LM_SEED, device=device)
    batch = lm_train_batch(cfg, run["batch"], run["s"], LM_SEED + 3, device)
    t0 = time.perf_counter()
    metrics, grads = loss_and_grads(cfg, params, batch)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    cpu_metrics, cpu_grads = loss_and_grads(
        cfg, tree_map(lambda p: p.to(cpu), params),
        {k: v.to(cpu) for k, v in batch.items()})
    cpu_s = time.perf_counter() - t0
    errs = [rel_l2(g.cpu(), w) for g, w in zip(tree_leaves(grads),
                                                tree_leaves(cpu_grads))]
    out = {"phase": "lm_train_fp32", "arch": cfg.name,
           "layers": run["layers"], "dtype": "float32", "B": run["batch"],
           "S": run["s"], "loss": float(metrics["loss"]),
           "loss_cpu": float(cpu_metrics["loss"]),
           "loss_rel_err": abs(float(metrics["loss"])
                               - float(cpu_metrics["loss"]))
           / abs(float(cpu_metrics["loss"])),
           "ce_rel_err": abs(float(metrics["ce"]) - float(cpu_metrics["ce"]))
           / abs(float(cpu_metrics["ce"])),
           "grad_leaves": len(errs), "grad_rel_l2_max": max(errs),
           "grad_rel_l2_median": sorted(errs)[len(errs) // 2],
           "card_s": card_s, "cpu_s": cpu_s,
           "tol": f"relative L2 {LM_FP32_REL_L2}"}
    del cpu_grads
    check(out["loss_rel_err"] <= LM_FP32_REL_L2
          and out["ce_rel_err"] <= LM_FP32_REL_L2
          and out["grad_rel_l2_max"] <= LM_FP32_REL_L2,
          f"lm_train_fp32: the card's gradients off the CPU's: {out}")
    # microbatches=2 against 1 on the same batch: the accumulated .grad
    # buffers, divided by the count, against one backward's, leaf by leaf
    micro_metrics, micro_grads = loss_and_grads(cfg, params, batch,
                                                microbatches=2)
    errs = [rel_l2(g, w) for g, w in zip(tree_leaves(micro_grads),
                                         tree_leaves(grads), strict=True)]
    out.update(microbatches_2_vs_1_grad_rel_l2_max=max(errs),
               microbatches_2_vs_1_loss_rel_err=abs(
                   float(micro_metrics["loss"]) - float(metrics["loss"]))
               / abs(float(metrics["loss"])))
    del grads, micro_grads
    check(max(errs) <= LM_FP32_REL_L2
          and out["microbatches_2_vs_1_loss_rel_err"] <= LM_FP32_REL_L2,
          f"lm_train_fp32: microbatches=2 off 1: {out}")
    # then one AdamW step each from the same parameters: repro's bar, which
    # AdamW's first step (at most LM_TRAIN_LR an element) cannot exceed;
    # the gradients above are the check that holds
    got = []
    for mb in (1, 2):
        opt = adamw(LM_TRAIN_LR)
        p = tree_map(lambda t: t.clone(), params)
        state, _ = make_train_step(cfg, opt, clip_norm=LM_TRAIN_CLIP,
                                   microbatches=mb)(
            TrainState(p, opt.init(p), 0), batch)
        got.append(tree_leaves(state.params))
        del state, opt
    diff = max(float((a - b).abs().max()) for a, b in zip(*got))
    out.update(microbatches_2_vs_1_params_max_abs=diff,
               microbatches_params_tol=LM_TRAIN_MICRO_TOL)
    emit(out)
    check(diff <= LM_TRAIN_MICRO_TOL,
          f"lm_train_fp32: microbatches=2 off 1 by {diff}")
    del params, got
    torch.cuda.empty_cache()
    return out


def lm_train_iag(cfg, device):
    """IAG (the paper's mechanism on gradients) on Qwen2.5-3B at full width
    and LM_TRAIN_IAG's depth, bf16 with remat, through the launcher's IAG
    step: one batch a shard, two passes over the shards; every loss
    finite, every shard seen, and each leaf's aggregate the sum of its
    memo's rows within LM_TRAIN_IAG_TOL (relative L2)."""
    import torch
    from repro_torch.launch.train import make_iag_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import iag
    from repro_torch.tree import tree_leaves
    from repro_torch.training import TrainState
    run = LM_TRAIN_IAG
    cfg = lm_cut(cfg, slice(0, run["layers"]))
    params = T.init_params(cfg, LM_SEED, device=device)
    opt = iag(LM_TRAIN_LR, run["shards"])
    step = make_iag_step(cfg, opt)
    state = TrainState(params, opt.init(params), 0)
    batches = [lm_train_batch(cfg, run["batch"], run["s"], LM_SEED + 10 + i,
                              device) for i in range(run["shards"])]
    losses, times = [], []
    for i in range(run["shards"] * run["passes"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batches[i % run["shards"]],
                              i % run["shards"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    os_ = state.opt_state
    errs = [rel_l2(a, m.sum(0)) for a, m in zip(tree_leaves(os_["agg"]),
                                                 tree_leaves(os_["memo"]))]
    out = {"phase": "lm_train_iag", "arch": cfg.name,
           "layers": run["layers"], "shards": run["shards"],
           "steps": len(losses), "B": run["batch"], "S": run["s"],
           "losses": losses, "step_ms": times,
           "memo_bytes": sum(m.numel() * 4 for m in
                             tree_leaves(os_["memo"])),
           "seen": bool(os_["seen"].all()), "count": int(os_["count"]),
           "agg_vs_memo_sum_rel_l2_max": max(errs),
           "tol": f"relative L2 {LM_TRAIN_IAG_TOL}",
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    emit(out)
    check(all(math.isfinite(x) for x in losses) and out["seen"]
          and out["count"] == len(losses),
          f"lm_train_iag: {out}")
    check(max(errs) <= LM_TRAIN_IAG_TOL,
          f"lm_train_iag: the aggregate off the memo's sum by {max(errs)}")
    del params, state, os_
    torch.cuda.empty_cache()
    return out


def phase_lm_train(device):
    """The LM template's training path on the card, last. Qwen2.5-3B
    unreduced (3.086 B) from the port's seeded fp32 masters, bf16 compute,
    remat on, AdamW on cosine_schedule, clip 1.0, S = 4,096, a global
    batch of 4 as 2 microbatches, 8 steps on one repeated batch: every
    loss and grad_norm finite, the last loss below the first, K9 launched
    0 times, the host syncs of a step as train_syncs_predicted says; the
    median ms of the last 6 steps, tokens/s, peak memory and the model
    FLOPs' share of the dense bf16 peak. Then lm_train_fp32 and, at cut
    depth and full width, DeepSeekMoE-16B, zamba2-1.2B and xLSTM-1.3B (3
    steps each, bf16 with remat; DeepSeekMoE's lb_loss in its loss), and
    lm_train_iag."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MOE
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw, cosine_schedule

    qwen = get_config(LM_ARCH)
    check((qwen.num_layers, qwen.d_model, qwen.num_heads, qwen.num_kv_heads,
           qwen.d_ff, qwen.vocab_size) == LM_WIDTH and qwen.remat
          and qwen.dtype == "bfloat16",
          f"lm_train: {LM_ARCH} is not at its full width: {qwen}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(qwen, LM_SEED, device=device)
    n_params = lm_numel(params)
    batch = lm_train_batch(qwen, LM_TRAIN_BATCH, LM_TRAIN_S, LM_SEED + 4,
                           device)
    opt = annotated_optimizer(
        adamw(cosine_schedule(LM_TRAIN_LR, 1, LM_TRAIN_STEPS)))
    state, step, run = lm_train_run(qwen, params, opt, batch,
                                    LM_TRAIN_STEPS, LM_TRAIN_MICROBATCHES)
    peak = torch.cuda.max_memory_allocated()
    ms = median(run["step_ms"][2:])
    state, split = lm_train_breakdown(qwen, state, step, batch)
    del state, step, params, batch
    check(all(split[r]["share"] > 0 for r in TRAIN_REGIONS)
          and sum(split[r]["share"] for r in TRAIN_REGIONS) <= 1.0,
          f"lm_train: the profiled regions' shares do not add up: {split}")
    torch.cuda.empty_cache()
    tokens = LM_TRAIN_BATCH * LM_TRAIN_S
    flops = train_flops(qwen, n_params, LM_TRAIN_BATCH, LM_TRAIN_S)
    out = {"phase": "lm_train", "arch": qwen.name, "params": n_params,
           "reduced": f"train_4k batch 256 -> {LM_TRAIN_BATCH} "
                      f"({LM_TRAIN_MICROBATCHES} microbatches)",
           "dtype": qwen.dtype, "remat": qwen.remat, "B": LM_TRAIN_BATCH,
           "S": LM_TRAIN_S, **run, "median_ms_last6": ms,
           "tokens_per_s": tokens / ms * 1e3, "model_flops": flops,
           "model_flops_share_of_bf16_peak":
               flops / (ms / 1e3) / BF16_OPS_PER_S,
           "bound_ms": flops / BF16_OPS_PER_S * 1e3,
           "peak_bytes": peak, "split": split}
    emit(out)
    runs = {"qwen": out, "fp32": lm_train_fp32(qwen, device)}
    for arch, (layers, b, s) in LM_TRAIN_FAMILIES.items():
        cfg = lm_cut(get_config(arch), layers)
        torch.cuda.reset_peak_memory_stats()
        params = T.init_params(cfg, LM_SEED, device=device)
        n = lm_numel(params)
        opt = adamw(cosine_schedule(LM_TRAIN_LR, 1, LM_TRAIN_FAMILY_STEPS))
        batch = lm_train_batch(cfg, b, s, LM_SEED + 5, device)
        state, step, run = lm_train_run(cfg, params, opt, batch,
                                        LM_TRAIN_FAMILY_STEPS)
        row = {"phase": "lm_train", "arch": cfg.name, "params": n,
               "reduced": f"layers {get_config(arch).num_layers} -> "
                          f"{cfg.num_layers} ({layers.start}-"
                          f"{layers.stop - 1})",
               "pattern": list(cfg.pattern), "B": b, "S": s, **run,
               "peak_bytes": torch.cuda.max_memory_allocated()}
        n_moe = cfg.pattern.count(MOE)
        if n_moe:
            # the balance loss is finite and enters the loss
            gaps = [abs(l - (c + 0.01 * lb / n_moe))
                    for l, c, lb in zip(run["losses"], run["ce"],
                                        run["lb_loss"])]
            row["loss_minus_ce_plus_lb"] = max(gaps)
            check(all(lb > 0 for lb in run["lb_loss"])
                  and max(gaps) <= 1e-4 * max(run["losses"]),
                  f"{cfg.name}: lb_loss {run['lb_loss']} not in the loss")
            # the MoE dispatch's host syncs under remat: the idle share
            phase_profile(lambda: step(state, batch), updates=1,
                          phase=f"profile_{cfg.name}_train")
        emit(row)
        runs[arch] = row
        del state, step, params, batch
        torch.cuda.empty_cache()
    runs["iag"] = lm_train_iag(qwen, device)
    return runs


# ---------------------------------------------------------------------------
# the LM template over a device mesh
# ---------------------------------------------------------------------------

LM_MESH = (2, 2)               # (data, model): 4 gloo ranks on the one card
LM_MESH_PREFILL = (2, 4096)    # (B, S): one sequence a data rank
# (B, prompt tokens, decode steps): each step re-gathers every weight a
# rank holds over gloo (1.70 GB a rank at Qwen2.5-3B's width, ~5 s a step
# on an NVIDIA H100 80GB HBM3 at 700 W); the prompt cut from 16 tokens to
# 2 and then 1, the steps from 4 to 1, for the script's time once the
# mesh training runs in the same ranks
LM_MESH_DECODE = (4, 1, 1)
LM_MESH_FP32_LAYERS = 4
# DeepSeekMoE-16B's first 4 layers (one dense, three MoE), its prefill
LM_MESH_MOE_LAYERS = 4
LM_MESH_MOE_S = 1024
# the recurrent models over the mesh, their blocks split by heads:
# zamba2-1.2B's first 6 layers (layer 5 applies the shared block) in bf16
# and fp32, xLSTM-1.3B's first 2 (one mLSTM, one sLSTM) in fp32 with a
# prefill of LM_MESH_XLSTM_S (the sLSTM's loop over time a step a token)
LM_MESH_ZAMBA_LAYERS = 6
LM_MESH_XLSTM_LAYERS = 2
LM_MESH_XLSTM_S = 256
# a recurrent model's max_memory_allocated a rank against the dry run's
# peak at the same shapes: at most its peak × this + LM_MESH_MEM_PAD
# bytes (the caching allocator's blocks, the init's one whole array at a
# time); set before the first card run, with the prediction in PERF.md §6
LM_MESH_MEM_SLACK = 1.5
LM_MESH_MEM_PAD = 1 << 30
LM_MESH_SPAWN_S = 1000.0       # a spawn's whole run: its ranks killed past it
LM_MESH_GLOO_S = 300.0         # a collective's timeout


def lm_mesh_configs():
    """The phase's configurations: Qwen2.5-3B unreduced (bf16), its first
    LM_MESH_FP32_LAYERS layers in fp32, DeepSeekMoE-16B's first
    LM_MESH_MOE_LAYERS layers (bf16); zamba2-1.2B's first
    LM_MESH_ZAMBA_LAYERS (bf16 and fp32) and xLSTM-1.3B's first
    LM_MESH_XLSTM_LAYERS (fp32), at full width."""
    import dataclasses
    from repro_torch.configs import get_config
    qwen = get_config(LM_ARCH)
    fp32 = dataclasses.replace(lm_cut(qwen, slice(0, LM_MESH_FP32_LAYERS)),
                               dtype="float32")
    moe = lm_cut(get_config(LM_MOE_ARCH), slice(0, LM_MESH_MOE_LAYERS))
    zamba = lm_cut(get_config(LM_ZAMBA_ARCH),
                   slice(0, LM_MESH_ZAMBA_LAYERS))
    xlstm = dataclasses.replace(
        lm_cut(get_config(LM_XLSTM_ARCH), slice(0, LM_MESH_XLSTM_LAYERS)),
        dtype="float32")
    return {"qwen2.5-3b": qwen, "qwen2.5-3b_fp32": fp32,
            "deepseek-moe-16b": moe, "zamba2-1.2b": zamba,
            "zamba2-1.2b_fp32": dataclasses.replace(zamba, dtype="float32"),
            "xlstm-1.3b_fp32": xlstm}


#: the configurations the phase serves and holds against the unsharded
#: model (the NCCL rank serves the first alone)
LM_MESH_SERVED = ("qwen2.5-3b", "qwen2.5-3b_fp32", "zamba2-1.2b",
                  "zamba2-1.2b_fp32", "xlstm-1.3b_fp32")
LM_MESH_RECURRENT = LM_MESH_SERVED[2:]


def lm_mesh_bar(cfg):
    """A served configuration's relative-L2 bar against the unsharded
    model: LM_FP32_REL_L2 in fp32, else its model's bf16 bar."""
    import torch
    from repro_torch.models.layers import compute_dtype
    if compute_dtype(cfg) == torch.float32:
        return LM_FP32_REL_L2
    return LM_BF16_REL_L2[LM_ZAMBA_ARCH if cfg.name == LM_ZAMBA_ARCH
                          else LM_ARCH]


def lm_mesh_prefill(cfg):
    """The phase's prefill (B, S) for ``cfg``."""
    b, s = LM_MESH_PREFILL
    return b, LM_MESH_XLSTM_S if cfg.name == LM_XLSTM_ARCH else s


def lm_mesh_tokens(cfg, device):
    """The seeded global inputs: the prefill's (B, S) tokens and the
    decode's (B, prompt + steps), int32 as repro's inputs."""
    import torch
    gen = torch.Generator(device=device).manual_seed(LM_SEED + 3)
    b, s = lm_mesh_prefill(cfg)
    db, prompt, steps = LM_MESH_DECODE
    draw = dict(generator=gen, device=device, dtype=torch.int32)
    return (torch.randint(0, cfg.vocab_size, (b, s), **draw),
            torch.randint(0, cfg.vocab_size, (db, prompt + steps), **draw))


def lm_mesh_serve(cfg, params, device, ctx=None, decode=True):
    """A prefill of LM_MESH_PREFILL, then LM_MESH_DECODE's prompt decoded
    into fresh caches and its steps decoded after it, through the serving
    entry points (``ctx`` a mesh rank's, or None): the last logits of
    each (the rank's rows), K9's launches, the collectives' bytes of the
    prefill and of the last decode step, host ms of the prefill and of
    each decode step, argument bytes."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.cost import tree_bytes
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import compute_dtype
    from repro_torch.sharding import RankPlan
    from repro_torch.training import make_prefill_step, make_serve_step

    tokens, dec = lm_mesh_tokens(cfg, device)
    batch = {"tokens": tokens}
    prefill = make_prefill_step(cfg, ctx)
    out = {"param_bytes": tree_bytes(params)}
    rows = slice(None) if ctx is None else \
        RankPlan(cfg, ctx, tokens.shape[0]).rows
    out["input_bytes"] = tokens[rows].numel() * tokens.element_size()
    torch.cuda.synchronize()
    if ctx is not None:
        ctx.comm.reset()
    fa.reset_launches()
    t0 = time.perf_counter()
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    out["k9_prefill"] = fa.LAUNCHES["flash_attention"]
    if ctx is not None:
        out["received_prefill"] = dict(ctx.comm.received)
    out["prefill"] = logits.float().cpu()
    out["rows"] = [rows.start, rows.stop]
    if not decode:
        return out
    b, prompt, steps = LM_MESH_DECODE
    caches = T.init_caches(cfg, b, prompt + steps, compute_dtype(cfg),
                           device, ctx=ctx)
    out["cache_bytes"] = tree_bytes(list(caches))
    serve = make_serve_step(cfg, ctx)
    drows = slice(None) if ctx is None else RankPlan(cfg, ctx, b).rows
    got, ms = [], []
    fa.reset_launches()
    for t in range(prompt + steps):
        pos = torch.full((b,), t, dtype=torch.int32, device=device)
        if t == prompt + steps - 1 and ctx is not None:
            ctx.comm.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, lg, caches = serve(params, caches, dec[:, t], pos)
        torch.cuda.synchronize()
        if t >= prompt:
            ms.append((time.perf_counter() - t0) * 1e3)
            got.append(lg.float().cpu())
    out["k9_decode"] = fa.LAUNCHES["flash_attention"]
    out["decode_ms"] = ms
    out["decode"] = torch.stack(got)
    out["decode_rows"] = [drows.start, drows.stop]
    out["decode_input_bytes"] = 2 * dec[drows, 0].numel() * 4
    if ctx is not None:
        out["received_decode"] = dict(ctx.comm.received)
    return out


def lm_mesh_moe(cfg, params, device, ctx):
    """DeepSeekMoE-16B's cut prefill on a mesh rank: K9's launches, and the
    first MoE layer's block input (the rank's rows), output and
    statistics."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import moe as M
    from repro_torch.training import make_prefill_step

    gen = torch.Generator(device=device).manual_seed(LM_SEED + 4)
    tokens = torch.randint(0, cfg.vocab_size, (LM_MESH_PREFILL[0],
                                               LM_MESH_MOE_S),
                           generator=gen, device=device, dtype=torch.int32)
    seen = []

    def record(orig):
        def moe_ffn(cfg_, p, x, tp=None):
            y, aux = orig(cfg_, p, x, tp)
            if not seen:
                seen.append({"x": x.cpu(), "y": y.cpu(),
                             **{k: v.cpu() for k, v in aux.items()}})
            return y, aux
        return moe_ffn

    fa.reset_launches()
    with wrapped(M, "moe_ffn", record):
        logits = make_prefill_step(cfg, ctx)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    return {"k9_prefill": fa.LAUNCHES["flash_attention"],
            "finite": bool(torch.isfinite(logits.float()).all()),
            "tokens": tokens.cpu(), **seen[0]}


def lm_mesh_rank(rank, world, backend, ref_dir=None, names=None):
    """One rank of the phase's mesh on the one card: each configuration's
    blocks built layer by layer (``init_params(..., cast=True, ctx=)``),
    its serving runs, ``max_memory_allocated`` after each. On the NCCL
    rank at (1, 1), Qwen2.5-3B's prefill again with ctx=None. Then the
    training runs (``lm_mesh_train_rank``; on the NCCL rank
    ``lm_mesh_train_nccl``). ``names``: serve those configurations alone,
    and train none."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.sharding import make_ctx

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    d, m = (1, 1) if world == 1 else LM_MESH
    ctx = make_ctx(make_host_mesh(d, m, device=device))
    out = {"coords": dict(ctx.comm.coords),
           "backends": dict(ctx.comm.backends)}
    for name, cfg in lm_mesh_configs().items():
        if (world == 1 and name != "qwen2.5-3b") \
                or (names is not None and name not in names):
            continue
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = T.init_params(cfg, LM_SEED, device=device, cast=True,
                               ctx=ctx)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        if name == "deepseek-moe-16b":
            row = lm_mesh_moe(cfg, params, device, ctx)
        else:
            row = lm_mesh_serve(cfg, params, device, ctx)
        if world == 1:
            # (1, 1): the blocks are the whole model; ctx=None's bits
            single = lm_mesh_serve(cfg, params, device, None, decode=False)
            row["bit_equal_no_ctx"] = torch.equal(row["prefill"],
                                                  single["prefill"])
        row["init_s"] = init_s
        row["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
        # by value: tensors would leave as shared-memory handles that die
        # with the rank
        out[name] = {k: v.float().numpy() if isinstance(v, torch.Tensor)
                     else v for k, v in row.items()}
        del params
    if names is not None:
        return out
    # then training, the serving models freed
    torch.cuda.empty_cache()
    out["train"] = lm_mesh_train_nccl(ctx, device) if world == 1 \
        else lm_mesh_train_rank(ctx, device, ref_dir)
    return out


def lm_mesh_references(cfgs, names, device):
    """The unsharded serving runs of ``names``, on the card, before the
    ranks start."""
    import torch
    from repro_torch.models import transformer as T
    refs = {}
    for name in names:
        cfg = cfgs[name]
        params = T.init_params(cfg, LM_SEED, device=device, cast=True)
        refs[name] = lm_mesh_serve(cfg, params, device)
        del params
        torch.cuda.empty_cache()
    return refs


def lm_mesh_serve_report(cfgs, refs, gloo, names):
    """Each of ``names`` over the 4 gloo ranks (``lm_mesh_rank``'s rows)
    against its unsharded run: the assembled last logits of the prefill
    and the decode step within the configuration's bar, K9 once an
    attention layer and a shared-block application a rank a prefill and
    never in decode, each rank's argument and collective bytes equal to
    the meta dry run's, a recurrent model's ``max_memory_allocated``
    within LM_MESH_MEM_SLACK of the dry run's peak."""
    import torch
    from repro_torch.configs.base import ATTN, ATTN_LOCAL, MAMBA2_SHARED, MOE

    def assembled(name, key, rows_key):
        parts = {}
        for r in gloo:
            row = r[name]
            lo, hi = row[rows_key]
            got = torch.from_numpy(row[key])
            if (lo, hi) in parts:
                check(torch.equal(parts[(lo, hi)], got),
                      f"lm_mesh {name}: model ranks' {key} differ")
            parts[(lo, hi)] = got
        dim = 1 if key == "decode" else 0
        return torch.cat([parts[k] for k in sorted(parts)], dim=dim)

    out = {}
    for name in names:
        cfg, ref = cfgs[name], refs[name]
        bar = lm_mesh_bar(cfg)
        label = f"lm_mesh {name}"
        pre = rel_l2(assembled(name, "prefill", "rows"), ref["prefill"])
        dec = [rel_l2(a, b) for a, b in zip(
            assembled(name, "decode", "decode_rows"), ref["decode"])]
        dry = lm_mesh_dryrun(cfg, LM_MESH)
        ranks = [r[name] for r in gloo]
        # K9 once an attention layer, and once a shared-block application
        # on the rank's heads
        k9 = sum(k in (ATTN, ATTN_LOCAL, MOE, MAMBA2_SHARED)
                 for k in cfg.pattern)
        peak = max(dry[k]["argument_bytes"] + dry[k]["temp_bytes"]
                   for k in ("prefill", "decode"))
        for row in ranks:
            check(row["k9_prefill"] == k9,
                  f"{label}: {row['k9_prefill']} K9 launches a rank a "
                  f"prefill, not {k9}")
            if name in LM_MESH_RECURRENT:
                mem = row["max_memory_allocated"]
                check(mem <= LM_MESH_MEM_SLACK * peak + LM_MESH_MEM_PAD,
                      f"{label}: max_memory_allocated {mem} over "
                      f"{LM_MESH_MEM_SLACK} × the dry run's peak {peak} "
                      f"+ {LM_MESH_MEM_PAD}")
            check(row["k9_decode"] == 0, f"{label}: K9 in decode")
            live = row["param_bytes"] + row["input_bytes"]
            check(live == dry["prefill"]["argument_bytes"],
                  f"{label}: live prefill argument bytes {live} != the "
                  f"dry run's {dry['prefill']['argument_bytes']}")
            live = row["param_bytes"] + row["cache_bytes"] \
                + row["decode_input_bytes"]
            check(live == dry["decode"]["argument_bytes"],
                  f"{label}: live decode argument bytes {live} != the dry "
                  f"run's {dry['decode']['argument_bytes']}")
            for kind in ("prefill", "decode"):
                got = row[f"received_{kind}"]
                want = {k[len("coll_"):]: v for k, v in dry[kind].items()
                        if k.startswith("coll_")}
                check(got == want, f"{label}: live {kind} collective bytes "
                      f"{got} != the dry run's {want}")
        check(pre <= bar and max(dec) <= bar,
              f"{label}: rel L2 prefill {pre}, decode {dec} over {bar}")
        out[name] = {
            "layers": cfg.num_layers, "dtype": cfg.dtype,
            "prefill": dict(zip(("B", "S"), lm_mesh_prefill(cfg))),
            "decode": dict(zip(("B", "prompt", "steps"), LM_MESH_DECODE)),
            "rel_l2_prefill_vs_unsharded": pre,
            "rel_l2_decode_vs_unsharded": dec,
            "tol": f"relative L2 {bar}",
            "k9_launches_per_rank_prefill": [r["k9_prefill"] for r in ranks],
            "k9_launches_per_rank_decode": [r["k9_decode"] for r in ranks],
            "prefill_ms_by_rank": [r["prefill_ms"] for r in ranks],
            "decode_ms_by_rank": [r["decode_ms"] for r in ranks],
            "unsharded_prefill_ms": ref["prefill_ms"],
            "unsharded_decode_ms": ref["decode_ms"],
            "received_prefill_by_rank": [r["received_prefill"]
                                         for r in ranks],
            "received_decode_by_rank": [r["received_decode"]
                                        for r in ranks],
            "argument_bytes_prefill": dry["prefill"]["argument_bytes"],
            "argument_bytes_decode": dry["decode"]["argument_bytes"],
            "live_bytes_equal_dry_run": True,
            "max_memory_allocated_by_rank": [r["max_memory_allocated"]
                                             for r in ranks],
            "dryrun_peak_bytes": {
                k: dry[k]["argument_bytes"] + dry[k]["temp_bytes"]
                for k in ("prefill", "decode")},
            "max_memory_over_dryrun_peak": [r["max_memory_allocated"] / peak
                                            for r in ranks],
            "init_s_by_rank": [r["init_s"] for r in ranks]}
    return out


def lm_mesh_dryrun(cfg, mesh_shape, decode=True):
    """The meta dry run of one rank at the phase's shapes on an abstract
    (data, model) mesh: argument and collective bytes, peak."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.dryrun import rank_step
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.models.layers import compute_dtype
    from repro_torch.sharding import make_ctx

    ctx = make_ctx(make_abstract_mesh(mesh_shape, ("data", "model")))
    b, s = lm_mesh_prefill(cfg)
    out = {"prefill": rank_step(cfg, InputShape("lm_mesh", s, b, "prefill"),
                                ctx)}
    if decode:
        db, prompt, steps = LM_MESH_DECODE
        out["decode"] = rank_step(
            cfg, InputShape("lm_mesh", prompt + steps, db, "decode"), ctx,
            cache_dtype=compute_dtype(cfg))
    return out



# training over the (2, 2) mesh, in the same ranks after their serving:
# (a) Qwen2.5-3B unreduced, bf16 compute over fp32 masters, remat, AdamW,
# clip 1.0, train_4k's S = 4,096 with its global batch of 256 cut to 2
# (one sequence a data rank), LM_MESH_TRAIN_STEPS steps on one batch;
# (b) the NCCL rank's unsharded step at (1, 1) against ctx=None, bit for
# bit, and the (2, 2) ranks' loss, grad norm and layer 0's and the last
# layer's gradients against it within LM_MESH_TRAIN_BARS; (c) the first
# LM_MESH_FP32_LAYERS layers in fp32: every gradient and every parameter
# after the step against the unsharded port's on the card, microbatches 2
# against 1 and seq_shard against not, at LM_MESH_TRAIN_FP32_TOL; (d)
# DeepSeekMoE-16B's first LM_MESH_MOE_LAYERS layers at S = LM_MESH_MOE_S
LM_MESH_TRAIN = dict(batch=2, s=4096)
LM_MESH_TRAIN_STEPS = 2
LM_MESH_TRAIN_LR = 3e-4
# (2, 2) against (1, 1) in bf16: relative |Δ| of the first step's loss and
# grad norm, relative L2 of a layer's gradient (every leaf of layer 0 and
# of the last layer, put together); set before the first card run, with
# the prediction in PERF.md §6
LM_MESH_TRAIN_BARS = {"loss": 1e-2, "grad_norm": 5e-2, "grads": 0.15}
LM_MESH_TRAIN_FP32_TOL = 1e-3
# AdamW's first step moves an element by lr · g / (|g| + eps): where |g|
# is below this, its rounding decides the move (up to 2 lr apart), and
# the parameter after the step is held to that bound instead
LM_MESH_TRAIN_ILL_G = 1e-6
LM_MESH_TRAIN_GRAD_LAYERS = (0, -1)


def lm_mesh_train_batch(cfg, b, s, device):
    """The seeded global tokens and labels, int32 as repro's inputs."""
    import torch
    gen = torch.Generator(device=device).manual_seed(LM_SEED + 5)
    return {k: torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                             device=device, dtype=torch.int32)
            for k in ("tokens", "labels")}


def bits_digest(t):
    """Two integer digests of ``t``'s bits (the plain and a
    position-weighted sum of its 32-bit words), in chunks on the card:
    equal bits give equal digests."""
    import torch
    words = t.detach().contiguous().view(-1).view(torch.int32)
    plain = weighted = 0
    step = 1 << 24
    for i in range(0, words.numel(), step):
        w = words[i:i + step].long()
        pos = torch.arange(i, i + w.numel(), device=w.device) % 65521 + 1
        plain += int(w.sum())
        weighted += int((w * pos).sum())
    return plain, weighted


def lm_mesh_train_run(cfg, params, device, ctx, batch, steps,
                      microbatches=1, capture=None):
    """``steps`` AdamW steps (LM_MESH_TRAIN_LR, clip LM_TRAIN_CLIP) on one
    repeated batch through ``make_train_step(cfg, opt, ctx)``: each step's
    metrics, host ms and bytes brought in by kind; K9's launches over the
    steps; argument bytes; ``max_memory_allocated``. ``capture``: the
    first step's gradients (clipped, as the optimizer gets them) of the
    paths it selects, fp32 copies on the device. Returns (the state, the
    readings)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.cost import tree_bytes
    from repro_torch.optim import Optimizer, adamw
    from repro_torch.sharding import RankPlan
    from repro_torch.training import TrainState, make_train_step
    from repro_torch.tree import tree_paths

    base, grads = adamw(LM_MESH_TRAIN_LR), {}

    def update(g, state, p):
        if capture is not None and not grads:
            # copies: the update is written into these buffers
            grads.update({k: v.detach().float().clone()
                          for k, v in tree_paths(g) if capture(k)})
        return base.update(g, state, p)

    opt = Optimizer(base.init, update)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=device))
    rows = slice(None) if ctx is None else RankPlan(
        cfg, ctx, batch["tokens"].shape[0]).rows
    out = {"param_bytes": tree_bytes(params),
           "opt_bytes": tree_bytes(state.opt_state),
           "input_bytes": sum(v[rows].numel() * v.element_size()
                              for v in batch.values()),
           "steps": []}
    step = make_train_step(cfg, opt, ctx, clip_norm=LM_TRAIN_CLIP,
                           microbatches=microbatches)
    fa.reset_launches()
    for _ in range(steps):
        if ctx is not None:
            ctx.comm.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        row = {"ms": (time.perf_counter() - t0) * 1e3,
               **{k: v.float().cpu().numpy() for k, v in metrics.items()}}
        if ctx is not None:
            row["received"] = dict(ctx.comm.received)
        out["steps"].append(row)
    out["k9_launches"] = fa.LAUNCHES["flash_attention"]
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    out["grads"] = grads
    return state, out


def _layer_paths(cfg, layers):
    names = {f"layers/{i % cfg.num_layers}/" for i in layers}
    return lambda path: any(path.startswith(n) for n in names)


def lm_mesh_train_rank(ctx, device, ref_dir):
    """(a), (c) and (d) on one gloo rank of (2, 2); ``ref_dir`` holds the
    unsharded step of (c) (``save_reference``), of which the rank reads
    its blocks."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.sharding import make_ctx
    from repro_torch.tree import tree_paths

    cfgs = lm_mesh_configs()
    out, seconds, t0 = {}, {}, time.perf_counter()

    def mark(part):
        nonlocal t0
        seconds[part] = time.perf_counter() - t0
        t0 = time.perf_counter()

    # (a) Qwen2.5-3B unreduced
    cfg = cfgs["qwen2.5-3b"]
    b, s = LM_MESH_TRAIN["batch"], LM_MESH_TRAIN["s"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    params = T.init_params(cfg, LM_SEED, device=device, ctx=ctx)
    mark("a_init")
    state, row = lm_mesh_train_run(
        cfg, params, device, ctx, lm_mesh_train_batch(cfg, b, s, device),
        LM_MESH_TRAIN_STEPS,
        capture=_layer_paths(cfg, LM_MESH_TRAIN_GRAD_LAYERS))
    row["grads"] = numpy_tree(row["grads"])
    out["qwen2.5-3b"] = row
    del params, state
    mark("a_steps")
    # (c) its first layers in fp32: one step a layout from the same init
    cfg = cfgs["qwen2.5-3b_fp32"]
    batch = lm_mesh_train_batch(cfg, b, s, device)
    seq_ctx = make_ctx(ctx.mesh, seq_shard=True)
    fp32 = {}
    for name, c, mb in (("mb1", ctx, 1), ("mb2", ctx, 2),
                        ("seq", seq_ctx, 1)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        params = T.init_params(cfg, LM_SEED, device=device, ctx=c)
        state, row = lm_mesh_train_run(cfg, params, device, c, batch, 1,
                                       microbatches=mb,
                                       capture=lambda p: True)
        # on the host, so the next run's peak is its own
        row["grads"] = {k: v.cpu() for k, v in row["grads"].items()}
        row["params"] = {k: v.cpu() for k, v in tree_paths(state.params)}
        fp32[name] = row
        del params, state
        mark(f"c_{name}")
    # the layouts against mb1, on the rank's blocks: Σ (x − ref)², Σ ref²
    # a leaf (the parent adds the ranks' sums), leaf by leaf on the card
    for name in ("mb2", "seq"):
        fp32[name]["vs_mb1"] = {
            key: {p: param_sums(v, fp32["mb1"][key][p],
                                fp32["mb1"]["grads"][p] if key == "params"
                                else None, device)
                  for p, v in fp32[name][key].items()}
            for key in ("grads", "params")}
        del fp32[name]["grads"], fp32[name]["params"]
    # and mb1 against the unsharded step, on the rank's blocks of it
    mb1 = fp32["mb1"]
    got = {"grads": unclipped(mb1.pop("grads"),
                              mb1["steps"][0]["grad_norm"]),
           "params": mb1.pop("params")}
    want = load_reference_blocks(cfg, ctx, ref_dir, torch.device("cpu"))
    mb1["vs_unsharded"] = {
        key: {p: param_sums(v, want[key][p],
                            want["grads"][p] if key == "params" else None,
                            device)
              for p, v in got[key].items()}
        for key in ("grads", "params")}
    del got, want
    out["qwen2.5-3b_fp32"] = fp32
    mark("c_compare")
    # (d) DeepSeekMoE-16B's first layers
    cfg = cfgs["deepseek-moe-16b"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    params = T.init_params(cfg, LM_SEED, device=device, ctx=ctx)
    state, row = lm_mesh_train_run(
        cfg, params, device, ctx,
        lm_mesh_train_batch(cfg, b, LM_MESH_MOE_S, device),
        LM_MESH_TRAIN_STEPS)
    out["deepseek-moe-16b"] = row
    del params, state
    torch.cuda.empty_cache()
    mark("d")
    out["seconds"] = seconds
    return out


def lm_mesh_train_nccl(ctx, device):
    """(b) on the NCCL rank at (1, 1): Qwen2.5-3B's steps with ctx=None,
    then from the same init with the (1, 1) context: the metrics, the
    captured gradients and the parameters' bits after the steps."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves

    cfg = lm_mesh_configs()["qwen2.5-3b"]
    batch = lm_mesh_train_batch(cfg, LM_MESH_TRAIN["batch"],
                                LM_MESH_TRAIN["s"], device)
    runs = {}
    for name, c in (("no_ctx", None), ("mesh_1x1", ctx)):
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        params = T.init_params(cfg, LM_SEED, device=device, ctx=c)
        state, row = lm_mesh_train_run(
            cfg, params, device, c, batch, LM_MESH_TRAIN_STEPS,
            capture=_layer_paths(cfg, LM_MESH_TRAIN_GRAD_LAYERS))
        row["grads"] = numpy_tree(row["grads"])
        row["digests"] = [bits_digest(t) for t in tree_leaves(
            (state.params, state.opt_state["m"], state.opt_state["v"]))]
        row["seconds"] = time.perf_counter() - t0
        runs[name] = row
        del params, state
    torch.cuda.empty_cache()
    a, b = runs["no_ctx"], runs["mesh_1x1"]
    runs["bit_equal_no_ctx"] = bool(
        a["digests"] == b["digests"]
        and all(all((x[k] == y[k]).all() for k in x if k not in ("ms",
                                                                 "received"))
                for x, y in zip(a["steps"], b["steps"]))
        and all((a["grads"][k] == b["grads"][k]).all() for k in a["grads"]))
    del b["grads"]
    return runs


def lm_mesh_train_reference(cfg, device):
    """The unsharded port on the card for (c): one step's gradients and
    parameters after it, as numpy."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_paths
    params = T.init_params(cfg, LM_SEED, device=device)
    batch = lm_mesh_train_batch(cfg, LM_MESH_TRAIN["batch"],
                                LM_MESH_TRAIN["s"], device)
    state, row = lm_mesh_train_run(cfg, params, device, None, batch, 1,
                                   capture=lambda p: True)
    row["grads"] = numpy_tree(row["grads"])
    row["params"] = numpy_tree(dict(tree_paths(state.params)))
    del params, state
    torch.cuda.empty_cache()
    return row


def unclipped(grads, norm):
    """The gradients before ``clip_by_global_norm`` scaled them."""
    scale = min(1.0, LM_TRAIN_CLIP / (float(norm) + 1e-9))
    return {k: v / scale for k, v in grads.items()}


def param_layout(cfg, ctx):
    """{path: (Spec, full shape)} of ``cfg``'s parameters on ``ctx``."""
    from repro_torch.models.transformer import param_shapes
    from repro_torch.sharding.ctx import ctx_param_specs
    from repro_torch.tree import tree_map, tree_map_with_path
    shapes, specs, paths = param_shapes(cfg), [], []
    tree_map(lambda t, s: specs.append((s, tuple(t.shape))), shapes,
             ctx_param_specs(cfg, ctx))
    tree_map_with_path(lambda p, t: paths.append(p), shapes)
    return dict(zip(paths, specs))


def save_reference(ref, path):
    """The unsharded step's gradients (unclipped) and parameters, one
    .npy a leaf under ``path``, for the ranks to read their blocks of."""
    import numpy as np
    path.mkdir(parents=True, exist_ok=True)
    trees = {"grads": unclipped(ref["grads"], ref["steps"][0]["grad_norm"]),
             "params": ref["params"]}
    for key, tree in trees.items():
        for leaf, arr in tree.items():
            np.save(path / f"{key}@{leaf.replace('/', '@')}.npy", arr)


def load_reference_blocks(cfg, ctx, path, device):
    """This rank's blocks of ``save_reference``'s leaves, on ``device``."""
    import numpy as np
    import torch
    from pathlib import Path
    from repro_torch.sharding.rules import block_slices, mesh_shape
    shape = mesh_shape(ctx.mesh)
    out = {"grads": {}, "params": {}}
    for leaf, (spec, dims) in param_layout(cfg, ctx).items():
        cut = block_slices(shape, ctx.comm.coords, dims, spec)
        for key in out:
            arr = np.load(Path(path) / f"{key}@{leaf.replace('/', '@')}.npy",
                          mmap_mode="r")
            out[key][leaf] = torch.from_numpy(np.ascontiguousarray(
                arr[cut])).to(device)
    return out


def lm_mesh_assemble(cfg, ranks, key, select=None):
    """The full leaves of ``key`` (a {path: block} dict a rank) from the
    four ranks' blocks: {path: array}."""
    import numpy as np
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.sharding import make_ctx
    from repro_torch.sharding.rules import block_slices, mesh_shape
    ctx = make_ctx(make_abstract_mesh(LM_MESH, ("data", "model")))
    shape = mesh_shape(ctx.mesh)
    out = {}
    for path, (spec, dims) in param_layout(cfg, ctx).items():
        if path not in ranks[0][1][key] or (select and not select(path)):
            continue
        full = np.empty(dims, dtype=np.float32)
        for coords, row in ranks:
            full[block_slices(shape, coords, dims, spec)] = row[key][path]
        out[path] = full
    return out


def param_sums(got, want, grad=None, device=None):
    """(Σ (got − want)², Σ want², max |got − want|) over the elements of a
    leaf, in float64 on ``device`` (tensors, or numpy arrays); with
    ``grad`` (the step's gradient) the sums over the elements whose
    |gradient| is at least LM_MESH_TRAIN_ILL_G, the max over the rest (0
    if none)."""
    import torch
    got, want = (torch.as_tensor(x).to(device).double() for x in (got, want))
    d = got - want
    ok = torch.ones_like(d, dtype=torch.bool) if grad is None \
        else torch.as_tensor(grad).to(device).abs() >= LM_MESH_TRAIN_ILL_G
    big = d.abs().masked_fill(ok, 0.0)
    return (float((d.square() * ok).sum()), float((want.square() * ok).sum()),
            float(big.max()) if big.numel() else 0.0)


def numpy_tree(flat):
    """{path: tensor} as {path: numpy array} on the host."""
    return {k: v.cpu().numpy() for k, v in flat.items()}


def lm_mesh_train_dryrun(cfg, s, microbatches=1, seq_shard=False):
    """The meta dry run of one (2, 2) rank's train step at (B, S) =
    (LM_MESH_TRAIN's batch, s)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.dryrun import rank_step
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.sharding import make_ctx
    ctx = make_ctx(make_abstract_mesh(LM_MESH, ("data", "model")),
                   seq_shard=seq_shard)
    return rank_step(cfg, InputShape("lm_mesh_train", s,
                                     LM_MESH_TRAIN["batch"], "train"),
                     ctx, microbatches=microbatches)


def check_train_bytes(label, rows, dry):
    """Every rank's every step: bytes by kind and argument bytes equal the
    dry run's; K9 launched 0 times."""
    want = {k[len("coll_"):]: v for k, v in dry.items()
            if k.startswith("coll_")}
    for row in rows:
        for st in row["steps"]:
            check(st["received"] == want, f"{label}: live train-step bytes "
                  f"{st['received']} != the dry run's {want}")
        live = row["param_bytes"] + row["opt_bytes"] + row["input_bytes"]
        check(live == dry["argument_bytes"], f"{label}: live argument bytes "
              f"{live} != the dry run's {dry['argument_bytes']}")
        check(row["k9_launches"] == 0,
              f"{label}: {row['k9_launches']} K9 launches in training")


def lm_mesh_train_report(cfgs, gloo, nccl):
    """The parent's checks of (a)-(d), and their line's fields."""
    import numpy as np
    import torch
    out = {}
    coords = [r["coords"] for r in gloo]
    # (a) and (b): Qwen2.5-3B unreduced ------------------------------
    cfg, label = cfgs["qwen2.5-3b"], "lm_mesh_train qwen2.5-3b"
    rows = [r["train"]["qwen2.5-3b"] for r in gloo]
    dry = lm_mesh_train_dryrun(cfg, LM_MESH_TRAIN["s"])
    check_train_bytes(label, rows, dry)
    for row in rows:
        losses = [float(st["loss"]) for st in row["steps"]]
        check(all(math.isfinite(x) for x in losses) and losses[-1]
              < losses[0], f"{label}: losses {losses}")
        for k in ("loss", "grad_norm"):
            vals = {np.asarray(st[k]).tobytes() for st in row["steps"][:1]}
            check(vals == {np.asarray(rows[0]["steps"][0][k]).tobytes()},
                  f"{label}: the ranks' {k} differ")
    check(bool(nccl["bit_equal_no_ctx"]), f"{label}: the (1, 1) NCCL train "
          "step is not ctx=None's bits")
    single = nccl["no_ctx"]
    s0, m0 = single["steps"][0], rows[0]["steps"][0]
    d_loss = abs(float(m0["loss"]) - float(s0["loss"])) / float(s0["loss"])
    d_norm = abs(float(m0["grad_norm"]) - float(s0["grad_norm"])) \
        / float(s0["grad_norm"])
    got = lm_mesh_assemble(cfg, [(c, {"g": unclipped(
        r["grads"], r["steps"][0]["grad_norm"])}) for c, r in
        zip(coords, rows)], "g")
    want = unclipped(single["grads"], s0["grad_norm"])
    grads = {}
    for layer in LM_MESH_TRAIN_GRAD_LAYERS:
        pre = f"layers/{layer % cfg.num_layers}/"
        keys = sorted(k for k in want if k.startswith(pre))
        grads[pre[:-1]] = rel_l2(*(torch.from_numpy(np.concatenate(
            [t[k].ravel() for k in keys])) for t in (got, want)))
    bars = LM_MESH_TRAIN_BARS
    check(d_loss <= bars["loss"] and d_norm <= bars["grad_norm"]
          and max(grads.values()) <= bars["grads"],
          f"{label}: (2, 2) against (1, 1): loss {d_loss}, grad norm "
          f"{d_norm}, gradients {grads} over {bars}")
    out["qwen2.5-3b"] = {
        "layers": cfg.num_layers, "dtype": cfg.dtype, "remat": cfg.remat,
        "B": LM_MESH_TRAIN["batch"], "S": LM_MESH_TRAIN["s"],
        "steps": LM_MESH_TRAIN_STEPS, "lr": LM_MESH_TRAIN_LR,
        "clip": LM_TRAIN_CLIP,
        "losses_by_rank": [[float(st["loss"]) for st in r["steps"]]
                           for r in rows],
        "grad_norms": [float(st["grad_norm"]) for st in rows[0]["steps"]],
        "step_ms_by_rank": [[st["ms"] for st in r["steps"]] for r in rows],
        "received_per_step": rows[0]["steps"][0]["received"],
        "received_equal_dry_run": True,
        "argument_bytes": dry["argument_bytes"],
        "max_memory_allocated_by_rank": [r["max_memory_allocated"]
                                         for r in rows],
        "dryrun_peak_bytes": dry["argument_bytes"] + dry["temp_bytes"],
        "dryrun_dot_flops": dry["dot_flops"],
        "k9_launches_per_step": 0,
        "vs_1x1": {"loss_rel": d_loss, "grad_norm_rel": d_norm,
                   "grads_rel_l2": grads, "bars": bars},
        "nccl_1x1": {"bit_equal_no_ctx": True,
                     "losses": [float(st["loss"]) for st in
                                single["steps"]],
                     "step_ms": [st["ms"] for st in single["steps"]],
                     "step_ms_1x1": [st["ms"] for st in
                                     nccl["mesh_1x1"]["steps"]],
                     "max_memory_allocated": single["max_memory_allocated"]}}
    # (c) fp32 at LM_MESH_FP32_LAYERS layers -----------------------------
    cfg, label = cfgs["qwen2.5-3b_fp32"], "lm_mesh_train qwen2.5-3b_fp32"
    tol = LM_MESH_TRAIN_FP32_TOL
    fp = [r["train"]["qwen2.5-3b_fp32"] for r in gloo]
    row = {}
    for name, mb, seq in (("mb1", 1, False), ("mb2", 2, False),
                          ("seq", 1, True)):
        check_train_bytes(f"{label} {name}", [f[name] for f in fp],
                          lm_mesh_train_dryrun(cfg, LM_MESH_TRAIN["s"], mb,
                                               seq))
    # each leaf's relative L2 from the ranks' sums (a replicated block
    # counts in both sums alike), the ill-posed elements' largest move
    for name, against in (("mb1", "vs_unsharded"), ("mb2", "vs_mb1"),
                          ("seq", "vs_mb1")):
        for key in ("grads", "params"):
            errs = {}
            for p in fp[0][name][against][key]:
                num = sum(f[name][against][key][p][0] for f in fp)
                den = sum(f[name][against][key][p][1] for f in fp)
                errs[p] = math.sqrt(num / max(den, 1e-30))
                big = max(f[name][against][key][p][2] for f in fp)
                check(big <= 2 * LM_MESH_TRAIN_LR * (1 + 1e-3),
                      f"{label}: {name} {against}, {p}: an ill-posed "
                      f"element moved {big}")
            w = max(errs.items(), key=lambda kv: kv[1])
            check(w[1] <= tol, f"{label}: {name} {against}, {key}: {w}")
            row[f"{name}_{against}_worst_rel_l2_{key}"] = w
    row.update(layers=cfg.num_layers, tol=f"relative L2 {tol} a leaf",
               step_ms_by_rank={n: [f[n]["steps"][0]["ms"] for f in fp]
                                for n in ("mb1", "mb2", "seq")},
               received_per_step={n: fp[0][n]["steps"][0]["received"]
                                  for n in ("mb1", "mb2", "seq")},
               max_memory_allocated_by_rank={
                   n: [f[n]["max_memory_allocated"] for f in fp]
                   for n in ("mb1", "mb2", "seq")},
               received_equal_dry_run=True)
    out["qwen2.5-3b_fp32"] = row
    # (d) DeepSeekMoE-16B ---------------------------------------------
    cfg, label = cfgs["deepseek-moe-16b"], "lm_mesh_train deepseek-moe-16b"
    rows = [r["train"]["deepseek-moe-16b"] for r in gloo]
    dry = lm_mesh_train_dryrun(cfg, LM_MESH_MOE_S)
    check_train_bytes(label, rows, dry)
    for row in rows:
        losses = [float(st["loss"]) for st in row["steps"]]
        check(all(math.isfinite(x) for x in losses) and losses[-1]
              < losses[0], f"{label}: losses {losses}")
        for st, st0 in zip(row["steps"], rows[0]["steps"]):
            for k in ("counts", "dropped", "loss"):
                check(np.array_equal(st[k], st0[k]),
                      f"{label}: the ranks' {k} differ")
    out["deepseek-moe-16b"] = {
        "layers": cfg.num_layers, "B": LM_MESH_TRAIN["batch"],
        "S": LM_MESH_MOE_S,
        "losses": [float(st["loss"]) for st in rows[0]["steps"]],
        "lb_loss": [float(st["lb_loss"]) for st in rows[0]["steps"]],
        "dropped": [float(st["dropped"]) for st in rows[0]["steps"]],
        "counts_and_dropped_equal_on_every_rank": True,
        "step_ms_by_rank": [[st["ms"] for st in r["steps"]] for r in rows],
        "received_per_step": rows[0]["steps"][0]["received"],
        "received_equal_dry_run": True,
        "max_memory_allocated_by_rank": [r["max_memory_allocated"]
                                         for r in rows],
        "dryrun_peak_bytes": dry["argument_bytes"] + dry["temp_bytes"],
        "k9_launches_per_step": 0}
    out["rank_seconds"] = {"gloo_rank0": gloo[0]["train"]["seconds"],
                           "nccl": {k: nccl[k]["seconds"]
                                    for k in ("no_ctx", "mesh_1x1")}}
    return out


def phase_lm_mesh(device, info):
    """The LM template over a (2, 2) ("data", "model") mesh on the one
    card (`repro_torch.sharding`): one spawn of 4 gloo ranks time-slicing
    it (collectives on host copies in bf16, which gloo takes), then one
    NCCL rank at (1, 1). Qwen2.5-3B unreduced in bf16: a prefill at B =
    2, S = 4,096 (one sequence a data rank) launching K9 once a layer on
    every rank, and 1 decode step at B = 4 after a 1-token prompt, each
    rank's rows of the last logits against the unsharded model's here at
    the model's bf16 bar; the same at 4 layers in fp32 at 1e-3;
    DeepSeekMoE-16B's first 4 layers (32 experts a model rank): the first
    MoE block's output against ``moe_block_emulated`` on the card, its
    counts and drops exactly; the NCCL rank bit-equal to ctx=None. The
    recurrent models with their blocks split by heads: zamba2-1.2B's
    first 6 layers in bf16 (its bar) and fp32 (1e-3), K9 once a rank a
    prefill (the shared block on the rank's 16 of 32 heads); xLSTM-1.3B's
    first 2 layers in fp32 at S = 256; the same prefill and decode step.
    Each rank's argument and collective bytes
    against the meta dry run's, its ``max_memory_allocated`` beside the
    dry run's peak (the recurrent models' held to LM_MESH_MEM_SLACK of
    it). Four processes time-slice one card here: their ms are no scaling
    result."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models import transformer as T
    from repro_torch.models.moe import moe_block_emulated

    cfgs = lm_mesh_configs()
    qwen = cfgs["qwen2.5-3b"]
    check((qwen.num_layers, qwen.d_model, qwen.num_heads, qwen.num_kv_heads,
           qwen.d_ff, qwen.vocab_size) == LM_WIDTH,
          f"lm_mesh: {LM_ARCH} is not at its full width")
    # the unsharded references, here, before the ranks start ----------
    refs = lm_mesh_references(cfgs, LM_MESH_SERVED, device)
    store = LM_MESH_DIR
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir()
    try:
        # and the unsharded fp32 train step of (c), for the ranks to read
        save_reference(lm_mesh_train_reference(cfgs["qwen2.5-3b_fp32"],
                                               device), store / "ref32")
        t0 = time.perf_counter()
        gloo = spawn_ranks(lm_mesh_rank, 4, backend="gloo",
                           args=("gloo", str(store / "ref32")),
                           timeout_s=LM_MESH_SPAWN_S,
                           collective_timeout_s=LM_MESH_GLOO_S,
                           store_dir=str(store))
        gloo_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        nccl = spawn_ranks(lm_mesh_rank, 1, backend="nccl", args=("nccl",),
                           timeout_s=LM_MESH_SPAWN_S,
                           collective_timeout_s=LM_MESH_GLOO_S,
                           store_dir=str(store))[0]
        nccl_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(store, ignore_errors=True)

    out = {"phase": "lm_mesh", "card": info["nvidia_smi"],
           "layout": {"data": LM_MESH[0], "model": LM_MESH[1]},
           "ranks": "4 gloo processes time-slicing one card (collectives on "
                    "host copies, carried in each tensor's dtype: bf16), "
                    "then 1 NCCL rank at (1, 1)",
           "time_sliced": "4 processes time-slicing one card over gloo: no "
                          "scaling result",
           "spawn_s": {"gloo_4": gloo_s, "nccl_1": nccl_s}}
    for r in gloo:
        check(r["backends"] == {"data": "gloo", "model": "gloo"},
              f"lm_mesh: collectives on {r['backends']}")
    check(sorted((r["coords"]["data"], r["coords"]["model"]) for r in gloo)
          == [(0, 0), (0, 1), (1, 0), (1, 1)], "lm_mesh: rank positions")

    out.update(lm_mesh_serve_report(cfgs, refs, gloo, LM_MESH_SERVED))

    # DeepSeekMoE: the first MoE block against its one-process twin -----
    name, cfg = "deepseek-moe-16b", cfgs["deepseek-moe-16b"]
    label = f"lm_mesh {name}"
    ranks = [r[name] for r in gloo]
    for row in ranks:
        check(row["k9_prefill"] == cfg.num_layers and row["finite"],
              f"{label}: K9 {row['k9_prefill']} launches a rank, or logits")
    params = T.init_params(cfg, LM_SEED, device=device, cast=True)
    first = cfg.pattern.index("moe")
    xs = {}
    for r in gloo:
        xs[r["coords"]["data"]] = r[name]["x"]
    x = torch.from_numpy(np.concatenate([xs[d] for d in sorted(xs)])).to(
        device, torch.bfloat16)
    y, aux = moe_block_emulated(cfg, params["layers"][first]["moe"], x,
                                data=LM_MESH[0], model=LM_MESH[1])
    rows = x.shape[0] // LM_MESH[0]
    errs, bit_equal = [], True
    for r in gloo:
        row, d = r[name], r["coords"]["data"]
        want = y[d * rows:(d + 1) * rows].float().cpu()
        got = torch.from_numpy(row["y"])
        errs.append(float((got - want).abs().max()))
        bit_equal &= torch.equal(got, want)
        check(torch.allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL),
              f"{label}: rank {r['coords']} MoE block off its twin by "
              f"{errs[-1]}")
        for k in ("counts", "dropped"):
            check(torch.equal(torch.from_numpy(row[k]), aux[k].float().cpu()),
                  f"{label}: {k} {row[k]} != the twin's {aux[k]}")
    del params, x, y
    torch.cuda.empty_cache()
    out[name] = {"layers": cfg.num_layers, "S": LM_MESH_MOE_S,
                 "B": LM_MESH_PREFILL[0],
                 "experts_per_model_rank": cfg.num_experts // LM_MESH[1],
                 "moe_layer_checked": first,
                 "max_abs_err_vs_twin_by_rank": errs,
                 "bit_equal_to_twin": bit_equal,
                 "counts_and_dropped_equal": True,
                 "dropped": float(aux["dropped"]),
                 "tol": f"rtol={BF16_RTOL} atol={BF16_ATOL}",
                 "k9_launches_per_rank_prefill": [r["k9_prefill"]
                                                  for r in ranks],
                 "max_memory_allocated_by_rank": [r["max_memory_allocated"]
                                                  for r in ranks]}

    # NCCL at (1, 1) ---------------------------------------------------
    row = nccl["qwen2.5-3b"]
    check(nccl["backends"] == {}, f"lm_mesh nccl: {nccl['backends']}")
    check(bool(row["bit_equal_no_ctx"]), "lm_mesh nccl (1, 1): the prefill is "
          "not ctx=None's bits")
    check(row["k9_prefill"] == qwen.num_layers,
          f"lm_mesh nccl: {row['k9_prefill']} K9 launches")
    out["nccl_1x1"] = {"bit_equal_no_ctx": True,
                       "k9_launches_prefill": row["k9_prefill"],
                       "prefill_ms": row["prefill_ms"],
                       "decode_ms": row["decode_ms"],
                       "max_memory_allocated": row["max_memory_allocated"]}
    emit(out)
    # training over the mesh --------------------------------------------
    train = lm_mesh_train_report(cfgs, gloo, nccl["train"])
    emit({"phase": "lm_mesh_train", "card": info["nvidia_smi"],
          "layout": {"data": LM_MESH[0], "model": LM_MESH[1]},
          "ranks": out["ranks"], "time_sliced": out["time_sliced"], **train})
    fa.reset_launches()
    return {"per_rank_prefill": out["qwen2.5-3b"][
        "k9_launches_per_rank_prefill"],
            "per_rank_decode": out["qwen2.5-3b"][
        "k9_launches_per_rank_decode"],
            "per_rank_prefill_zamba2": out["zamba2-1.2b"][
        "k9_launches_per_rank_prefill"]}


HYPER_RTOL = 1e-4   # the fp32 update on the card against float64 on the CPU


def phase_hyper(eng, train, topics):
    """Minka's α₀ and β₀ from phase train's γ (α₀ + Σ cnt·π over the memo)
    and λ, on the card in fp32 against a float64 run of the same update on
    the CPU."""
    import numpy as np
    import torch
    from repro_torch.core.hyper import update_alpha0, update_beta0

    cfg = eng.cfg
    gammas = []
    for lo in range(0, eng.num_docs, 2048):
        rows = np.arange(lo, min(lo + 2048, eng.num_docs))
        pi, _ = eng.memo.gather(rows)
        cnts = train.counts[lo:lo + len(rows)]
        gammas.append(cfg.alpha0 + torch.einsum("bl,blk->bk", cnts, pi))
    gamma = torch.cat(gammas)
    lam = eng.state.lam
    t0 = time.perf_counter()
    alpha = update_alpha0(cfg.alpha0, gamma)
    beta = update_beta0(cfg.beta0, lam)
    seconds = time.perf_counter() - t0
    alpha64 = update_alpha0(cfg.alpha0, gamma.double().cpu())
    beta64 = update_beta0(cfg.beta0, lam.double().cpu())
    errs = (abs(alpha - alpha64) / alpha64, abs(beta - beta64) / beta64)
    check(max(errs) <= HYPER_RTOL,
          f"hyper: α₀ {alpha} vs {alpha64}, β₀ {beta} vs {beta64}")
    out = {"phase": "hyper", "alpha0": alpha, "alpha0_fp64_cpu": alpha64,
           "beta0": beta, "beta0_fp64_cpu": beta64,
           "rel_err": list(errs), "rtol": HYPER_RTOL,
           "gamma_rows": int(gamma.shape[0]), "seconds": seconds}
    emit(out)
    return out


KCAP_TOPICS = (300, 1000)
KCAP_BATCH = 256          # the first 256 Arxiv-shaped documents, V = 141,927
# K8's twin keeps (B / B-tile, V, K) partials twice: at K = 1,000 its
# B-tile is 2, so 16 documents make 8 partials (4.5 GB; the kernel keeps
# none)
KCAP_ONEHOT_BATCH = 16
# sha256 of each kernel's outputs at K = 100 on ``digest_inputs``, as the
# parent commit 1391254 built them (chip run, NVIDIA H100 80GB HBM3): the
# instances at K <= 256 (K1/K4) and K <= 128 (K8) keep their bits. K6's
# ("sweep") is its tensor-core design's build (re-anchored at 92e741b),
# which K7's transposed instance beside it leaves unchanged. K7's
# ("sstats") is re-anchored to its tensor-core build: its bf16 x 3 products
# sum in another order than the SIMT kernel's fp32 FMAs by design, within
# 2e-5 of the fp32 twin. K8's one-pass redesign keeps the parent's bits.
PARENT_DIGESTS = {
    "fixed_point":
        "6a74054a1150a2687342dae805774ec7a4924a701332e6326c908aaebfb99588",
    "fixed_point_csr":
        "e4d2329444c64fd971b56cf1141cb6676dc6c8b4364fe44f5cd2acff3dc17ba9",
    "segment_scatter":
        "7156093ddcca0aeee14af409f594c74ce9982b9c72755bea9b4a42e1ba1bf410",
    "sweep":
        "ce2bab201ccd08efd57b033ae080109ee29dec214425fda183cb573f1ac094e4",
    "sstats":
        "201bdb1097c4518cec953518f4a2921fc68f0077f057df31cf7d42e0e3dd718c",
    "memo_delta_onehot":
        "e734394fe429b74b2df3ce086cf8576699ace3b9b52b3d72424567c206a64e4b",
}
# ptxas's spill bytes (stores, loads) of the fixed point's register
# instances as this source builds them (chip run, NVIDIA H100 80GB HBM3):
# KPL = 6-8 (K = 161-256) spill, as they did before the stop test's groups
# (8/16, 16/52 and 36/100 bytes then; the groups' 32-bit tile index left
# fewer), with their bits kept; every other instance, and the wide kernel
# above 256 topics, must not spill
PARENT_SPILLS = {"kpl6": [[4, 8]], "kpl7": [[4, 20]], "kpl8": [[24, 96]]}
# K3's instances as this source builds them (chip run, NVIDIA H100 80GB
# HBM3): KPL = 4 (97 to 128 topics, K = 100 among them) spills 4/4 bytes
# at its 4 blocks an SM (64 registers a thread), with its bits kept; every
# other instance must not spill
K3_PARENT_SPILLS = {"kpl4": [[4, 4]]}
# K6's and K7's tensor-core instances (dense_tc_kernel<KC, kT, kR>: KC
# chunks of 64 topics in registers, kT K7's transposed roles, kR the
# product pass above 128 topics) and the R pass's kernels, by the
# fragment of their mangled names
DENSE_INSTANCES = {
    "sweep_kc1": "dense_tc_kernelILi1ELb0ELb0E",
    "sweep_kc2": "dense_tc_kernelILi2ELb0ELb0E",
    "sweep_product": "dense_tc_kernelILi2ELb0ELb1E",
    "sstats_kc1": "dense_tc_kernelILi1ELb1ELb0E",
    "sstats_kc2": "dense_tc_kernelILi2ELb1ELb0E",
    "sstats_product": "dense_tc_kernelILi2ELb1ELb1E",
    "r_pass": "r_pass_kernel",
    "et_image": "et_image_kernel"}
# ... and of K8's instances (KPL topics a lane; "tiled": 128-topic tiles
# above 128 topics), as this source builds them (chip run, NVIDIA H100
# 80GB HBM3): only the tiled one spills
ONEHOT_SPILLS = {"kpl1": [[0, 0]], "kpl2": [[0, 0]], "kpl3": [[0, 0]],
                 "kpl4": [[0, 0]], "kpl4_tiled": [[32, 48]]}


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
    """K1, K4, K2, K5, K3, K6, K7 and K8 at K = 300 and 1,000 against their
    twins on the first Arxiv-shaped documents (V = 141,927), timed beside
    their bounds; every fixed-point instance's spills (0 required); at K =
    100 the parent's bits."""
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

        # K2 and K5 on the same documents (the flat stream of K4 above) ----
        distinct = int(torch.unique(ids[cnts != 0]).numel())
        pis = {}
        for name, run, plain, kernel, nbytes in (
                ("token_pi", lambda: lda_estep.token_pi(ids, cnts, eb, et),
                 lambda: lda_estep.token_pi_plain(ids, cnts, eb, et),
                 "token_pi_kernel", 8),
                ("token_pi_csr", lambda: lda_estep.token_pi_csr(
                    flat_ids, flat_cnts, segs, eb, et4),
                 lambda: lda_estep.token_pi_csr_plain(
                     flat_ids, flat_cnts, segs, eb, et4),
                 "csr_token_pi_kernel", 12)):
            perr = float((run() - plain()).abs().max())
            check(torch.allclose(run(), plain(), rtol=1e-5, atol=1e-6),
                  f"{name} K={k}: off its twin by {perr}")
            pis[name] = pi_times(run, plain, kernel,
                                 *token_pi_work(nbytes, b * l, b, k, distinct,
                                                live), timer, 10)
            pis[name].update(max_abs_err=perr, tol="rtol=1e-5 atol=1e-6")

        # K3 on the two fixed points' π ------------------------------------
        pi_new = lda_estep.token_pi(ids, cnts, eb, et).reshape(-1, k)
        pi_old = lda_estep.token_pi(ids, cnts, eb, et4).reshape(-1, k)
        err = check_segment_scatter(flat_ids, flat_cnts, pi_new, pi_old, v,
                                    f"K={k}")
        segments = lda_estep.scatter_segments(flat_ids, flat_cnts, v)
        bms, by = bound_ms(*scatter_work(live, v, k))
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
            del got, again, want
            # on the tensor cores (the R pass, then the products by
            # 128-topic chunks): the split's floor there, and below the
            # twin (its two fp32 cuBLAS products) in this run
            bms, by = sweep_tc_bound(bp, vp, kp,
                                     vp if name == "sstats" else bp)
            kms, pms = timer(lambda: kern(*dargs), 5), timer(
                lambda: plain(*dargs), 5)
            check(kms < pms, f"{name} K={k}: {kms} ms, not below its "
                             f"twin's {pms}")
            dense[name] = {"max_abs_err": derr,
                           "tol": "rtol=atol=2e-5 (fp32 twin, no TF32; "
                                  "products bf16 x 3)",
                           "ms": kms, "plain_ms": pms, "bound_ms": bms,
                           "bound_by": by, "floor_share": bms / kms,
                           "fp32_bound_ms": dense_bound(bp, vp, kp)[0],
                           # a call's three kernels, by the profiler
                           "kernel_ms": kernels_ms(
                               lambda: kern(*dargs),
                               ("et_image_kernel", "r_pass_kernel",
                                "dense_tc_kernel"), 5)}
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
        bms, by = bound_ms(*onehot_work(n8 * l, k, v, live8))
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
        rows[k] = {"fixed_point": k1, "fixed_point_csr": k4, **pis,
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
    phase_hyper(eng, train, TOPICS)
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
    _, launches_service = phase_service(device, spec, test, TOPICS,
                                        lam_train)
    divi = phase_divi(device, spec, train, test, TOPICS, BATCH, sync, cuda_ms)
    launches_divi_mesh = phase_divi_mesh(device, spec, train, TOPICS, BATCH)
    phase_kcap(device, spec, train, cuda_ms)

    legacy, launches_legacy = phase_legacy(device, spec, train, TOPICS, BATCH,
                                           cuda_ms)
    kernels.update(legacy)
    attention, launches_attention = phase_attention(device, cuda_ms)
    kernels.update(attention)
    # this slice's paths last, so every earlier phase runs as it did
    tune = phase_tune(device, spec, train, test, TOPICS, BATCH, lam_train)
    del lam_train
    uci = phase_uci(device, spec, train, test, TOPICS, BATCH)
    cvb0 = phase_cvb0(device, spec, train, test, TOPICS, BATCH, ivi)
    # the LM template's serving path, last: its 18.5 GB of weights (fp32
    # masters, then the bf16 copy) come after every LDA phase
    del spec, train, test, ivi, ivi_csr
    lm = phase_lm(device)
    # the MoE and recurrent blocks after it, each model freed before the
    # next is built
    lm_moe = phase_lm_moe(device)
    lm_recurrent = phase_lm_recurrent(device)
    # gemma2-27B at full width (12 of its 46 layers, 15.9 GB of bf16
    # weights), freed before the training path
    lm_gemma2 = phase_lm_gemma2(device)
    # the training path after every serving phase (its 49 GB of masters,
    # gradients and moments come once the serving models are freed)
    phase_lm_train(device)
    # the LM over a (2, 2) mesh, last: its ranks start once every model
    # of the earlier phases is freed
    lm_mesh = phase_lm_mesh(device, info)
    # each kernel's launches on the path that runs it: K2 and K5 on
    # memo_delta / memo_delta_csr (the training paths run them fused)
    launches.update(fixed_point_csr=launches_csr["fixed_point_csr"],
                    token_pi=memo_delta_launches["token_pi"],
                    token_pi_csr=memo_delta_csr_launches["token_pi_csr"],
                    **{n: launches_legacy[n] for n in LEGACY_KERNELS},
                    flash_attention=launches_attention["flash_attention"])
    kernels["segment_scatter"]["launches_csr"] = \
        launches_csr["segment_scatter"]
    # the D-IVI runs: one grouped K1 and one K3 a sub-round; K1 at
    # 16 workers' 16,384 documents in one launch
    for name in PADDED_KERNELS:
        kernels[name]["launches_divi"] = sum(r["launches"][name]
                                             for r in divi["runs"])
        # the mesh round: every rank's launches, by layout and backend
        kernels[name]["launches_divi_mesh"] = {
            key: row[name] for key, row in launches_divi_mesh.items()}
    # the serving service: 1 launch a served batch, and the learner's K1
    # and K3 an update
    for name, count in launches_service.items():
        kernels[name]["launches_service"] = count
    # the tuner, UCI ingest and CVB0: their paths' launches (UCI: each
    # layout's streamed epoch alone), and the tune of the fixed points'
    # rows
    for name in ("fixed_point", "fixed_point_csr", "segment_scatter"):
        kernels[name]["launches_tune"] = tune["launches"][name]
    kernels["fixed_point"]["launches_uci"] = \
        uci["launches"]["padded"]["fixed_point"]
    kernels["fixed_point_csr"]["launches_uci"] = \
        uci["launches"]["csr"]["fixed_point_csr"]
    kernels["segment_scatter"]["launches_uci"] = {
        layout: uci["launches"][layout]["segment_scatter"]
        for layout in ("padded", "csr")}
    kernels["segment_scatter"]["launches_cvb0"] = \
        cvb0["launches"]["segment_scatter"]
    # K9 on the LM path: one launch a layer in one Qwen2.5-3B prefill
    kernels["flash_attention"]["launches_lm"] = lm["prefill"]["k9_launches"]
    # and on the MoE models' prefills (once a layer) and zamba2's (once a
    # shared block)
    kernels["flash_attention"]["launches_lm_moe"] = {
        arch: row["prefill"]["k9_launches"] for arch, row in lm_moe.items()}
    kernels["flash_attention"]["launches_lm_recurrent"] = {
        arch: row["prefill"]["k9_launches"]
        for arch, row in lm_recurrent.items()}
    # with gemma2's window and softcap: once a layer in its prefill, and
    # once a layer in the Qwen2.5-3B long_500k variant's windowed prefill
    kernels["flash_attention"]["launches_lm_gemma2"] = \
        lm_gemma2["prefill"]["k9_launches"]
    kernels["flash_attention"]["launches_lm_long_500k"] = \
        lm["prefill_long_500k"]["k9_launches"]
    # and on every rank of the (2, 2) mesh: once a layer a prefill
    kernels["flash_attention"]["launches_lm_mesh"] = lm_mesh
    for name, task in (("fixed_point", "padded"),
                       ("fixed_point_csr", "csr")):
        row = tune["tasks"][task]
        kernels[name]["tune"] = {f: row[f] for f in (
            "default_ms", "tuned_ms", "winner")}
    kernels["fixed_point"]["divi_grouped"] = {
        key: {f: g[f] for f in ("docs", "group", "ms", "kernel_ms",
                                "bound_ms", "bound_by")}
        for key, g in divi["grouped"].items()}
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
