"""Training launcher of the port: MVI / SVI / IVI / S-IVI on a synthetic
paper-shaped corpus, with periodic held-out LPP, through the
`repro_torch.lda.LDA` facade.

It prints the memo store's footprint, the length buckets' padding
(``--bucketed``) and, with any telemetry flag (``--trace``,
``--metrics-json``, ``--watchdog``), the telemetry summary. ``--ckpt``
writes a manifest checkpoint of the full incremental state at the end
(``repro``'s format), and ``--resume`` continues such a run, the port's or
``repro``'s, bit-equal to one that never stopped (its algo, store and
batching come from the checkpoint).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train lda --corpus small
  PYTHONPATH=src python -m repro_torch.launch.train lda --corpus tiny \\
      --topics 8 --backend gather --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train lda --corpus tiny \\
      --topics 8 --algo mvi --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train lda --corpus tiny \\
      --topics 8 --algo svi --bucketed --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train lda --corpus tiny \\
      --topics 8 --memo-store chunked --chunk-docs 64 --device cpu \\
      --epochs 1 --ckpt run1
  PYTHONPATH=src python -m repro_torch.launch.train lda --corpus tiny \\
      --topics 8 --device cpu --epochs 1 --resume run1 --ckpt run1
  PYTHONPATH=src python -m repro_torch.launch.train lda --corpus tiny \\
      --topics 8 --algo sivi --memo-store gamma --watchdog warn \\
      --trace run.jsonl --device cpu
"""
from __future__ import annotations

import argparse
import time


def main_lda(args) -> None:
    from repro_torch.core.types import LDAConfig, resolve_device
    from repro_torch.data.synthetic import PAPER_CORPORA, make_corpus
    from repro_torch.lda import LDA

    tel = _build_telemetry(args)
    device = resolve_device(args.device)
    spec = PAPER_CORPORA[args.corpus]
    train = make_corpus(spec, split="train", seed=args.seed,
                        scale=args.scale, device=device)
    test = make_corpus(spec, split="test", seed=args.seed, scale=args.scale,
                       device=device)
    print(f"corpus={args.corpus} docs={train.num_docs} "
          f"words={float(train.num_words):.0f} K={args.topics} "
          f"device={device}")
    if args.resume:
        lda = LDA.load(args.resume, telemetry=tel, device=device).resume(
            train, test_corpus=test)
        print(f"resumed {args.resume}: algo={lda.algo} "
              f"docs_seen={lda.docs_seen}")
    else:
        cfg = LDAConfig(num_topics=args.topics, vocab_size=spec.vocab_size,
                        estep_max_iters=args.estep_iters,
                        estep_backend=args.backend)
        lda = LDA(cfg, algo=args.algo, batch_size=args.batch,
                  seed=args.seed, memo_store=args.memo_store,
                  chunk_docs=args.chunk_docs,
                  bucket_by_length=args.bucketed, telemetry=tel,
                  device=device)
        # bind the corpus without stepping, so the memo is reportable
        lda.partial_fit(train, steps=0, test_corpus=test)
    eng = lda.trainer.eng
    if eng.memo is not None:
        print(f"memo_store={eng.memo.kind} "
              f"footprint={eng.memo.footprint_bytes() / 1e6:.2f}MB")
    stats = eng.bucket_stats
    if stats is not None:
        per = " ".join(f"w{b['width']}:{b['docs']}d/{b['pad_frac']:.0%}"
                       for b in stats["per_bucket"])
        print(f"bucket_padding_stats slot_ratio={stats['slot_ratio']:.3f} "
              f"[{per}]")
    t0 = time.perf_counter()
    for epoch in range(1, args.epochs + 1):
        lda.fit(epochs=1)
        if epoch % args.eval_every == 0 or epoch == args.epochs:
            lpp = lda.evaluate()["lpp"]
            print(f"epoch={epoch} docs_seen={lda.docs_seen} lpp={lpp:.4f} "
                  f"wall={time.perf_counter() - t0:.2f}s")
    if args.bound:
        print("final exact bound:", lda.bound())
    if tel is not None:
        _report_telemetry(tel, args)
    if args.ckpt:
        print("saved", lda.save(args.ckpt))


def _build_telemetry(args):
    """The run's ``repro_torch.obs`` bundle from the CLI flags (None when no
    telemetry flag is set: the no-op path)."""
    if not (args.trace or args.metrics_json or args.watchdog != "off"):
        return None
    from repro_torch.obs import ElboWatchdog, Telemetry
    if args.watchdog != "off":
        return Telemetry(watchdog=ElboWatchdog(
            policy=args.watchdog, check_every=args.watchdog_every))
    return Telemetry()


def _report_telemetry(tel, args) -> None:
    """End-of-run telemetry summary and the --trace/--metrics-json dumps."""
    m, wd = tel.metrics, tel.watchdog
    tokens = m.total("train.tokens")
    wall = sum(r["dur_us"] for r in tel.trace.records
               if r["type"] == "span" and r["name"] == "train/update") / 1e6
    rate = f"{tokens / wall:,.0f} tok/s" if wall > 0 else "n/a"
    st = wd.status()
    wd_line = ("off" if not st["enabled"] else
               f"{st['policy']} checks={st['checks']} "
               f"violations={st['violations']} "
               f"{'OK' if st['ok'] else 'VIOLATED'}")
    print(f"telemetry: tokens={tokens:,.0f} update_time={wall:.2f}s "
          f"({rate}) spans={tel.trace.num_records} watchdog={wd_line}")
    if args.trace:
        n = tel.trace.dump_jsonl(args.trace)
        print(f"trace: wrote {n} records to {args.trace}")
    if args.metrics_json:
        m.dump_json(args.metrics_json)
        print(f"metrics: wrote {args.metrics_json}")


def main() -> None:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="mode", required=True)
    lda = sub.add_parser("lda")
    lda.add_argument("--algo", default="ivi",
                     choices=["mvi", "svi", "ivi", "sivi"])
    lda.add_argument("--corpus", default="small")
    lda.add_argument("--scale", type=float, default=1.0)
    lda.add_argument("--topics", type=int, default=50)
    lda.add_argument("--batch", type=int, default=32)
    lda.add_argument("--epochs", type=int, default=5)
    lda.add_argument("--estep-iters", type=int, default=60)
    lda.add_argument("--backend", default="cuda",
                     choices=["cuda", "gather", "dense"])
    lda.add_argument("--memo-store", default="dense",
                     choices=["dense", "chunked", "gamma"],
                     help="π-memo representation for ivi/sivi (gamma: sivi "
                          "only)")
    lda.add_argument("--chunk-docs", type=int, default=8192,
                     help="documents per host-store chunk")
    lda.add_argument("--bucketed", action="store_true",
                     help="length-bucketed epoch batching (svi/ivi/sivi)")
    lda.add_argument("--eval-every", type=int, default=1)
    lda.add_argument("--bound", action="store_true")
    lda.add_argument("--seed", type=int, default=0)
    lda.add_argument("--trace", default=None, metavar="PATH",
                     help="record a span trace and write it as JSONL here")
    lda.add_argument("--metrics-json", default=None, metavar="PATH",
                     help="write the run's metrics-registry snapshot here")
    lda.add_argument("--watchdog", default="off",
                     choices=["off", "warn", "raise"],
                     help="ELBO-monotonicity watchdog policy on the "
                          "incremental path (armed once init mass retires)")
    lda.add_argument("--watchdog-every", type=int, default=0,
                     help="check the memoized bound every N updates "
                          "(O(corpus) each; 0 = only at evaluations)")
    lda.add_argument("--device", default="cuda",
                     help="torch device; 'cpu' runs the kernels' plain "
                          "versions")
    lda.add_argument("--ckpt", default=None, metavar="DIR",
                     help="write a manifest checkpoint of the full "
                          "incremental state here at the end")
    lda.add_argument("--resume", default=None, metavar="DIR",
                     help="continue the run checkpointed in DIR (the "
                          "port's or repro's); algo, store and batching "
                          "come from the checkpoint")
    args = ap.parse_args()
    main_lda(args)


if __name__ == "__main__":
    main()
