"""Training launcher of the port, ``repro.launch.train``'s two modes.

``lm`` trains an arch of the LM template (``repro``'s flags and printout:
``--arch --reduced --steps --batch --seq --lr --optimizer {adamw,iag}
--iag-shards --log-every --seed --ckpt``, and ``--device``) on batches
drawn from ``np.random.default_rng(seed)`` in ``repro``'s order, so both
packages see the same tokens, labels and vision embeddings. AdamW runs
``make_train_step`` on a cosine schedule; IAG steps by the aggregate of
the shards' memoized gradients, one shard a step, with no clipping, as
``repro``'s launcher does. ``--ckpt`` writes the parameters in ``repro``'s
stacked-stage layout to one npz (`repro_torch.checkpoint.io`), which
``repro``'s ``restore_checkpoint`` reads.

``lda``: MVI / SVI / IVI / S-IVI, or D-IVI with
P simulated workers (``--algo divi --workers --staleness --delay-prob
--rounds``), on a synthetic paper-shaped corpus, with periodic held-out
LPP, through the `repro_torch.lda.LDA` facade.

It prints the memo store's footprint, the length buckets' padding
(``--bucketed``) and, with any telemetry flag (``--trace``,
``--metrics-json``, ``--watchdog``), the telemetry summary. ``--ckpt``
writes a manifest checkpoint of the full incremental state at the end
(``repro``'s format), and ``--resume`` continues such a run, the port's or
``repro``'s, bit-equal to one that never stopped (its algo, store and
batching come from the checkpoint). ``--stream`` trains from a lazily read
UCI docword file through a ``DocStream`` (``--docword`` an existing one;
without it the synthetic corpus is written in UCI format once and
streamed back), single-host or sharded over D-IVI's workers;
``--tune-store`` resolves a tuned kernel policy (`repro_torch.tune`).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train lm --arch qwen2.5-3b \\
      --reduced --steps 20 --log-every 5 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train lm --arch xlstm-1.3b \\
      --reduced --optimizer iag --iag-shards 4 --steps 8 --device cpu
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
  PYTHONPATH=src python -m repro_torch.launch.train lda --corpus tiny \\
      --topics 8 --algo divi --workers 4 --batch 16 --rounds 10 \\
      --eval-every 5 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train lda --corpus tiny \\
      --topics 8 --stream --docword docword.txt.gz --tune-store t.json \\
      --device cpu
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np


def main_lda(args) -> None:
    from repro_torch.core.types import LDAConfig, resolve_device
    from repro_torch.data.synthetic import PAPER_CORPORA, make_corpus
    from repro_torch.data.uci import UCIDocStream, save_uci
    from repro_torch.dist import DIVIConfig
    from repro_torch.lda import LDA

    tel = _build_telemetry(args)
    device = resolve_device(args.device)
    spec = PAPER_CORPORA[args.corpus]
    test = make_corpus(spec, split="test", seed=args.seed, scale=args.scale,
                       device=device)
    if args.stream:
        # ragged streaming ingest from a lazily read UCI docword file: no
        # (D, L) padded corpus resident; D-IVI shards the stream into its
        # workers' views. Only full-batch mvi needs a materialized corpus.
        if args.algo == "mvi":
            raise SystemExit("--stream needs a mini-batch engine; mvi is "
                             "full-batch coordinate ascent")
        docword = args.docword
        if docword is None:
            mat = make_corpus(spec, split="train", seed=args.seed,
                              scale=args.scale, device="cpu")
            docword = os.path.join(tempfile.mkdtemp(prefix="lda_stream_"),
                                   "docword.txt.gz")
            save_uci(mat, docword)
        train = UCIDocStream(docword)
        print(f"stream={docword} docs={train.num_docs} "
              f"words={train.num_words:.0f} K={args.topics} "
              f"device={device}")
    elif args.docword:
        raise SystemExit("--docword goes with --stream")
    else:
        train = make_corpus(spec, split="train", seed=args.seed,
                            scale=args.scale, device=device)
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
        if args.algo == "divi":
            lda = LDA(cfg, algo="divi",
                      distributed=DIVIConfig(num_workers=args.workers,
                                             batch_size=args.batch,
                                             staleness=args.staleness,
                                             delay_prob=args.delay_prob),
                      seed=args.seed, telemetry=tel, device=device,
                      tune_store=args.tune_store)
        else:
            lda = LDA(cfg, algo=args.algo, batch_size=args.batch,
                      seed=args.seed, memo_store=args.memo_store,
                      chunk_docs=args.chunk_docs,
                      bucket_by_length=args.bucketed, telemetry=tel,
                      device=device, tune_store=args.tune_store)
        # bind the corpus without stepping, so the memo is reportable
        lda.partial_fit(train, steps=0, test_corpus=test)
    if lda.cfg.kernel_policy is not None:
        # a tuned (or checkpointed) policy is part of the run's identity
        print(f"kernel_policy={lda.cfg.kernel_policy}")
    eng = lda.trainer.eng
    if lda.distributed is not None:
        shard = eng.shard
        print(f"workers={lda.distributed.num_workers} "
              f"shards={eng.sharded.shard_sizes} memo_footprint="
              f"{(shard.pi.numel() * 4 + shard.visited.numel()) / 1e6:.2f}MB")
        lda.fit(rounds=args.rounds, eval_every=args.eval_every,
                verbose=True)
        _finish(lda, tel, args)
        return
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
    if args.stream:
        st = eng.stream_padding_stats()
        per = " ".join(f"w{b['width']}:{b['docs']}d/{b['pad_frac']:.0%}"
                       for b in st["per_width"])
        print(f"stream_padding_stats pad_frac={st['pad_frac']:.3f} [{per}]")
    _finish(lda, tel, args)


def _finish(lda, tel, args) -> None:
    """The end of a run: the bound, the telemetry summary, the checkpoint."""
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
               if r["type"] == "span"
               and r["name"] in ("train/update", "divi/round")) / 1e6
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


def lm_batch(cfg, rng, batch: int, seq: int, device):
    """One training batch drawn as ``repro``'s launcher draws it: tokens,
    then labels (covering a VLM's patch prefix), then the vision
    embeddings, each from ``rng``."""
    import torch
    shape = ((batch, seq, cfg.num_codebooks) if cfg.modality == "audio"
             else (batch, seq))
    out = {"tokens": rng.integers(0, cfg.vocab_size, shape)}
    lab_len = seq + (cfg.num_patches if cfg.modality == "vision" else 0)
    lab_shape = ((batch, lab_len, cfg.num_codebooks)
                 if cfg.modality == "audio" else (batch, lab_len))
    out["labels"] = rng.integers(0, cfg.vocab_size, lab_shape)
    if cfg.modality == "vision":
        out["vision_embeds"] = rng.normal(
            0, 1, (batch, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def make_iag_step(cfg, opt):
    """``repro``'s IAG step: the gradients, the optimizer's update for
    ``shard``, applied; no clipping. ``step(state, batch, shard) →
    (state, metrics)``."""
    from repro_torch.optim import apply_updates
    from repro_torch.training import TrainState, loss_and_grads

    def step(state, batch, shard):
        metrics, grads = loss_and_grads(cfg, state.params, batch)
        updates, opt_state = opt.update(grads, state.opt_state, state.params,
                                        shard=shard)
        return TrainState(apply_updates(state.params, updates), opt_state,
                          state.step + 1), metrics
    return step


def main_lm(args) -> None:
    from repro_torch.configs import get_config
    from repro_torch.core.types import resolve_device
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw, cosine_schedule, iag
    from repro_torch.tree import tree_leaves
    from repro_torch.training import TrainState, make_train_step

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(seq_len_hint=args.seq)
    rng = np.random.default_rng(args.seed)
    params = T.init_params(cfg, args.seed, device=device)
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={cfg.name} params={n / 1e6:.2f}M")
    if args.optimizer == "iag":
        opt = iag(args.lr, num_shards=args.iag_shards)
        step = make_iag_step(cfg, opt)
    else:
        opt = adamw(cosine_schedule(args.lr, 10, args.steps))
        step = make_train_step(cfg, opt)
    state = TrainState(params, opt.init(params), 0)
    t0 = time.perf_counter()
    for s in range(args.steps):
        batch = lm_batch(cfg, rng, args.batch, args.seq, device)
        if args.optimizer == "iag":
            state, metrics = step(state, batch, s % args.iag_shards)
        else:
            state, metrics = step(state, batch)
        if (s + 1) % args.log_every == 0:
            dt = time.perf_counter() - t0
            print(f"step={s + 1} loss={float(metrics['loss']):.4f} "
                  f"ce={float(metrics['ce']):.4f} "
                  f"steps_per_s={(s + 1) / dt:.2f}")
    if args.ckpt:
        from repro_torch.checkpoint import save_checkpoint
        from repro_torch.convert import lm_params_to_repro
        save_checkpoint(args.ckpt, lm_params_to_repro(state.params, cfg),
                        step=args.steps)
        print("saved", args.ckpt)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="mode", required=True)
    lda = sub.add_parser("lda")
    lda.add_argument("--algo", default="ivi",
                     choices=["mvi", "svi", "ivi", "sivi", "divi"])
    lda.add_argument("--corpus", default="small")
    lda.add_argument("--scale", type=float, default=1.0)
    lda.add_argument("--topics", type=int, default=50)
    lda.add_argument("--batch", type=int, default=32)
    lda.add_argument("--epochs", type=int, default=5)
    lda.add_argument("--rounds", type=int, default=50,
                     help="global rounds of --algo divi")
    lda.add_argument("--workers", type=int, default=4,
                     help="D-IVI workers, simulated on the one device")
    lda.add_argument("--staleness", type=int, default=1,
                     help="D-IVI sub-rounds a round (parameter lag)")
    lda.add_argument("--delay-prob", type=float, default=0.0,
                     help="probability a D-IVI worker drops a sub-round")
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
    lda.add_argument("--stream", action="store_true",
                     help="ragged streaming ingest through a UCI DocStream "
                          "(no padded corpus resident)")
    lda.add_argument("--docword", default=None,
                     help="existing UCI docword(.gz) file to stream "
                          "(with --stream; default: the synthetic corpus "
                          "written out in UCI format)")
    lda.add_argument("--tune-store", default=None, metavar="PATH",
                     help="repro_torch.tune policy store of tuned kernel "
                          "policies, resolved at this run's shape")
    lm = sub.add_parser("lm")
    lm.add_argument("--arch", required=True)
    lm.add_argument("--reduced", action="store_true")
    lm.add_argument("--steps", type=int, default=100)
    lm.add_argument("--batch", type=int, default=4)
    lm.add_argument("--seq", type=int, default=128)
    lm.add_argument("--lr", type=float, default=3e-4)
    lm.add_argument("--optimizer", default="adamw", choices=["adamw", "iag"])
    lm.add_argument("--iag-shards", type=int, default=8)
    lm.add_argument("--log-every", type=int, default=10)
    lm.add_argument("--seed", type=int, default=0)
    lm.add_argument("--ckpt", default=None,
                    help="write the parameters here at the end: one npz in "
                         "repro's stacked-stage layout")
    lm.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    if args.mode == "lda":
        main_lda(args)
    else:
        main_lm(args)


if __name__ == "__main__":
    main()
