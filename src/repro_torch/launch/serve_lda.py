"""LDA serving launcher of the port: a thin client of the
``repro_torch.serve`` service.

Drives the ``ServingService`` with scheduled request traffic: admission
control forms batches over the serving width ladder or CSR token budget,
partial batches flush on timeout, every response records the model
version that served it, and the latency report comes from the service's
SLO accounting (``repro.serve.slo/v1``, the schema ``repro`` writes).

Traffic shapes (``--traffic``): ``replay`` (``--requests × --batch``
single-document requests, all at t = 0, or spaced at ``--rate``),
``poisson`` and ``onoff`` (the seeded open-stream generators).
``--online`` runs the background incremental learner on the served
documents, on a CUDA stream of its own, and publishes λ through the atomic
snapshot swap. ``--ckpt`` reads either package's checkpoint.

The run is on ``--device`` (default ``cuda``; ``cpu`` runs the kernels'
plain twins). ``--ragged`` and ``--no-double-buffer`` are deprecated
no-ops, as in ``repro``: the service always consumes ragged requests
through the admission packer. ``--dryrun`` runs the serving batch at the
Arxiv shape on ``meta`` tensors (``run_serve_dryrun``) and prints its
bytes, with no card and no model.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve_lda --corpus small \\
      --requests 64 --batch 32 --backend cuda
  PYTHONPATH=src python -m repro_torch.launch.serve_lda --corpus tiny \\
      --topics 8 --device cpu --traffic poisson --rate 200 --requests 4 \\
      --batch 8 --online
  PYTHONPATH=src python -m repro_torch.launch.serve_lda --device cpu \\
      --corpus tiny --ckpt run1
  # Arxiv-scale serving dry run (shapes and bytes, no weights, no card):
  PYTHONPATH=src python -m repro_torch.launch.serve_lda --dryrun
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

# Arxiv (Table 1): V = 141,927 padded to 141,952, K = 100 padded to 128
ARXIV = dict(vocab=141_952, topics=128)
ARXIV_WIDTHS = (32, 64, 128)            # serving bucket widths at L = 128


def run_serve_dryrun(batch: int = 256, widths=ARXIV_WIDTHS,
                     backend: str = "cuda") -> dict:
    """The serving batch (``TopicInferencer``'s γ-only solve on Eφ) at the
    Arxiv shape for each bucket width, on ``meta`` tensors: no weights
    are made. Per width its argument and peak bytes and launches (one a
    batch on the ``cuda`` backend), as ``repro``'s serving lowering
    reports its memory."""
    import traceback

    import torch

    from repro_torch.core.estep import BowBatch, get_backend
    from repro_torch.core.types import LDAConfig
    from repro_torch.kernels import lda_estep
    from repro_torch.launch.dryrun_lda import LiveBytes, tensor_bytes

    v, k = ARXIV["vocab"], ARXIV["topics"]
    cfg = LDAConfig(num_topics=k, vocab_size=v, estep_max_iters=50,
                    estep_backend=backend, estep_stream_dtype="bfloat16")
    out = {"arch": "lda-serve-arxiv", "mode": "serve", "backend": backend,
           "shape": f"b{batch}", "widths": list(widths), "device": "meta"}
    t0 = time.time()
    try:
        meta = torch.device("meta")
        eb = torch.empty((v, k), device=meta)
        per_width = {}
        for w in widths:
            ids = torch.empty((batch, w), dtype=torch.int32, device=meta)
            cnts = torch.empty((batch, w), device=meta)
            lda_estep.reset_launches()
            mode = LiveBytes()
            with mode:
                get_backend(backend).solve_gamma(cfg, eb, BowBatch(ids, cnts))
            per_width[w] = {
                "temp_gb": mode.peak / 1e9,
                "argument_gb": tensor_bytes((eb, ids, cnts)) / 1e9,
                "launches": sum(lda_estep.LAUNCHES.values())}
        out["compile_s"] = round(time.time() - t0, 1)
        out["memory"] = per_width
        out["jit_cache_entries"] = len(widths)
        out["ok"] = True
    except Exception as e:  # noqa: BLE001  (the result records it)
        out["ok"] = False
        out["error"] = f"{type(e).__name__}: {e}"
        out["traceback"] = traceback.format_exc()[-1500:]
    return out


def print_serve_dryrun(res: dict, label: str = "arxiv") -> None:
    """``repro``'s summary line of the serving dry run (``dryrun_lda``
    labels it ``single-host``)."""
    if res["ok"]:
        worst = max(m["temp_gb"] for m in res["memory"].values())
        print(f"[OK ] lda-serve {label}  compile={res['compile_s']}s "
              f"widths={res['widths']} max_temp={worst:.2f}GB "
              f"jit_entries={res['jit_cache_entries']}")
    else:
        print(f"[FAIL] lda-serve: {res['error'][:200]}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=None,
                    help="LDA checkpoint of either package (manifest dir or "
                         "legacy .npz); omit to train a quick model on "
                         "--corpus")
    ap.add_argument("--corpus", default="small")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--topics", type=int, default=50)
    ap.add_argument("--estep-iters", type=int, default=50)
    ap.add_argument("--backend", default=None,
                    choices=[None, "gather", "dense", "cuda", "csr"],
                    help="serving E-step backend (default: the config's)")
    ap.add_argument("--batch", type=int, default=32,
                    help="request batch size")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--layout", default=None, choices=[None, "padded", "csr"],
                    help="serving batch layout: padded width buckets or the "
                         "flat CSR token stream; default: the estimator's "
                         "training layout")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="with --layout csr: flat slots per batch")
    ap.add_argument("--ragged", action="store_true",
                    help="DEPRECATED no-op: the service always serves "
                         "ragged requests through the admission packer")
    ap.add_argument("--no-double-buffer", action="store_true",
                    help="DEPRECATED no-op: batching policy lives in the "
                         "service loop")
    ap.add_argument("--traffic", default="replay",
                    choices=["replay", "poisson", "onoff"],
                    help="arrival schedule: replay (--requests×--batch "
                         "docs, burst or --rate-spaced), poisson, or "
                         "bursty ON-OFF")
    ap.add_argument("--rate", type=float, default=None,
                    help="arrival rate, docs/s (replay: None = all at t=0; "
                         "poisson/onoff default 200)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request latency budget; admission sheds "
                         "requests that already blew it (default: none)")
    ap.add_argument("--flush-timeout-ms", type=float, default=20.0,
                    help="partial-batch flush timeout")
    ap.add_argument("--slo-p95-ms", type=float, default=None,
                    help="p95 latency SLO target for the report")
    ap.add_argument("--online", action="store_true",
                    help="train the background incremental learner on "
                         "served documents and publish λ through atomic "
                         "snapshot swaps")
    ap.add_argument("--cadence-s", type=float, default=0.25,
                    help="with --online: background update period")
    ap.add_argument("--warm-epochs", type=int, default=1,
                    help="quick-train epochs when no --ckpt is given")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dryrun", action="store_true",
                    help="Arxiv-scale serving dry run on meta tensors: "
                         "bytes and launches, no weights, no card")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain twins")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record a span trace of the serving run and write "
                         "it as JSONL here")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the serving metrics-registry snapshot here")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.dryrun:
        res = run_serve_dryrun(batch=args.batch,
                               backend=args.backend or "cuda")
        print_serve_dryrun(res)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(res) + "\n")
        if not res["ok"]:
            raise SystemExit(1)
        return

    from repro_torch.core.types import resolve_device
    from repro_torch.data.stream import CorpusDocStream
    from repro_torch.data.synthetic import PAPER_CORPORA, make_corpus
    from repro_torch.lda import LDA
    from repro_torch.obs import Telemetry
    from repro_torch.serve import (OnlineLearner, ServiceConfig,
                                   ServingService, SnapshotStore,
                                   onoff_arrivals, poisson_arrivals,
                                   replay_arrivals, requests_from_docs)

    device = resolve_device(args.device)
    # the service keeps its own metrics registry (the latency accounting);
    # the full bundle, with a span recorder, only when a flag asks for it
    tel = Telemetry() if (args.trace or args.metrics_json) else None

    spec = PAPER_CORPORA[args.corpus]
    test = make_corpus(spec, split="test", seed=args.seed, scale=args.scale,
                       device=device)
    if args.ckpt:
        lda = LDA.load(args.ckpt, device=device)
        print(f"topics from {args.ckpt}: V={lda.cfg.vocab_size} "
              f"K={lda.cfg.num_topics}")
    else:
        train = make_corpus(spec, split="train", seed=args.seed,
                            scale=args.scale, device=device)
        lda = LDA(num_topics=args.topics, vocab_size=spec.vocab_size,
                  estep_max_iters=args.estep_iters, algo="ivi",
                  seed=args.seed, device=device)
        lda.fit(train, epochs=args.warm_epochs)
        print(f"quick-trained ivi on {args.corpus}: "
              f"{args.warm_epochs} epoch(s), docs_seen={lda.docs_seen}")

    if args.ragged or args.no_double_buffer:
        print("note: --ragged/--no-double-buffer are deprecated no-ops: "
              "the service always serves ragged requests through the "
              "admission packer")

    inf = lda.inferencer(backend=args.backend, batch_size=args.batch,
                         layout=args.layout, token_budget=args.token_budget,
                         telemetry=tel)
    ragged_docs = list(CorpusDocStream(test).iter_from(0))

    # warm-up: serve the whole test corpus once, so the service run
    # measures steady-state latency (the kernels loaded, buffers cached)
    if args.requests:
        inf.posterior_docs(ragged_docs)

    n = args.requests * args.batch        # legacy volume: N requests × B
    rng = np.random.default_rng(args.seed)
    doc_order = [ragged_docs[i] for i in
                 rng.choice(len(ragged_docs), size=max(n, 1))]
    if args.traffic == "poisson":
        arrivals = poisson_arrivals(n, args.rate or 200.0, seed=args.seed)
    elif args.traffic == "onoff":
        r = args.rate or 200.0
        arrivals = onoff_arrivals(n, r, on_s=max(8.0 / r, 1e-3),
                                  off_s=max(8.0 / r, 1e-3), seed=args.seed)
    else:
        arrivals = replay_arrivals(n, args.rate)
    deadline = (args.deadline_ms / 1e3 if args.deadline_ms is not None
                else float("inf"))
    requests = requests_from_docs(doc_order, arrivals, deadline_s=deadline)

    slo = {"p95": args.slo_p95_ms} if args.slo_p95_ms else None
    svc = ServingService(inf, config=ServiceConfig(
        flush_timeout_s=args.flush_timeout_ms / 1e3,
        slo_ms=slo), telemetry=tel)
    learner = None
    if args.online:
        store = SnapshotStore(inf, metrics=svc.metrics)
        learner = OnlineLearner(lda.cfg, store, lam0=lda.lam,
                                cadence_s=args.cadence_s, seed=args.seed,
                                device=device)
        svc.learner = learner
        learner.start()
    t0 = time.perf_counter()
    try:
        svc.run(requests)
    finally:
        if learner is not None:
            learner.stop()
    if learner is not None:
        learner.drain()
    wall = time.perf_counter() - t0

    rep = svc.slo_report()
    pct = rep["latency_ms"]
    mode = f"{inf.layout}/service/{args.traffic}"
    if rep["served"]:
        print(f"served {rep['served']}/{rep['offered']} docs "
              f"({rep['shed']} shed) backend={inf.cfg.estep_backend} "
              f"device={device} [{mode}]: "
              f"{rep['throughput_docs_s']:.1f} docs/s (wall {wall:.2f}s)")
        print(f"latency ms: p50={pct['p50']:.1f} p95={pct['p95']:.1f} "
              f"p99={pct['p99']:.1f} max={pct['max']:.1f}")
        print(f"model versions served: {rep['model_versions']}"
              + (f" ({learner.updates} online updates)" if learner else ""))
        pad = inf.padding_stats()
        print(f"padding: frac={pad['pad_frac']:.3f} "
              f"wasted={pad['wasted_token_bytes'] / 1e3:.1f}kB staged "
              f"({pad['padded_slots'] - pad['live_slots']} of "
              f"{pad['padded_slots']} slots dead)")
    else:
        print("served 0 requests: skipping the latency report")
    for name, s in rep["slo"].items():
        print(f"SLO {name}: target {s['target_ms']:.0f}ms observed "
              f"{s['observed_ms']:.1f}ms -> "
              f"{'ATTAINED' if s['attained'] else 'MISSED'}")
    cache = inf.cache_info()
    print(f"batch shapes: {cache['jit_entries']} widths "
          f"{cache['compiled_widths']} "
          f"(batches per width: {cache['batches_per_width']})")
    if args.trace:
        n_rec = tel.trace.dump_jsonl(args.trace)
        print(f"trace: wrote {n_rec} records to {args.trace}")
    if args.metrics_json:
        tel.metrics.dump_json(args.metrics_json)
        print(f"metrics: wrote {args.metrics_json}")
    if args.out:
        rec = {"mode": "serve", "backend": inf.cfg.estep_backend,
               "serve_mode": mode, "traffic": args.traffic,
               "batch": args.batch, "requests": args.requests,
               "device": str(device),
               "docs_per_s": rep["throughput_docs_s"],
               "latency_ms": pct,
               "slo_report": rep,
               "jit_widths": cache["compiled_widths"],
               "batches_per_width": cache["batches_per_width"],
               "layout": inf.layout,
               "online": bool(learner),
               "padding": inf.padding_stats(), "ok": True}
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
