"""Training launcher of the port: IVI / S-IVI on a synthetic paper-shaped
corpus, with periodic held-out LPP.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train lda --corpus small
  PYTHONPATH=src python -m repro_torch.launch.train lda --corpus tiny \\
      --topics 8 --backend gather --device cpu
"""
from __future__ import annotations

import argparse
import time


def main_lda(args) -> None:
    from repro_torch.core.engines import LDAEngine
    from repro_torch.core.types import LDAConfig, resolve_device
    from repro_torch.data.synthetic import PAPER_CORPORA, make_corpus

    device = resolve_device(args.device)
    spec = PAPER_CORPORA[args.corpus]
    train = make_corpus(spec, split="train", seed=args.seed,
                        scale=args.scale, device=device)
    test = make_corpus(spec, split="test", seed=args.seed, scale=args.scale,
                       device=device)
    print(f"corpus={args.corpus} docs={train.num_docs} "
          f"words={float(train.num_words):.0f} K={args.topics} "
          f"device={device}")
    cfg = LDAConfig(num_topics=args.topics, vocab_size=spec.vocab_size,
                    estep_max_iters=args.estep_iters,
                    estep_backend=args.backend)
    eng = LDAEngine(cfg, train, algo=args.algo, batch_size=args.batch,
                    seed=args.seed, test_corpus=test, device=device)
    print(f"memo_store={eng.memo.kind} "
          f"footprint={eng.memo.footprint_bytes() / 1e6:.2f}MB")
    t0 = time.perf_counter()
    for epoch in range(1, args.epochs + 1):
        eng.run_epoch()
        if epoch % args.eval_every == 0 or epoch == args.epochs:
            lpp = eng.evaluate()["lpp"]
            print(f"epoch={epoch} docs_seen={eng.docs_seen} lpp={lpp:.4f} "
                  f"wall={time.perf_counter() - t0:.2f}s")
    if args.bound:
        print("final exact bound:", eng.full_bound())


def main() -> None:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="mode", required=True)
    lda = sub.add_parser("lda")
    lda.add_argument("--algo", default="ivi", choices=["ivi", "sivi"])
    lda.add_argument("--corpus", default="small")
    lda.add_argument("--scale", type=float, default=1.0)
    lda.add_argument("--topics", type=int, default=50)
    lda.add_argument("--batch", type=int, default=32)
    lda.add_argument("--epochs", type=int, default=5)
    lda.add_argument("--estep-iters", type=int, default=60)
    lda.add_argument("--backend", default="cuda",
                     choices=["cuda", "gather", "dense"])
    lda.add_argument("--eval-every", type=int, default=1)
    lda.add_argument("--bound", action="store_true")
    lda.add_argument("--seed", type=int, default=0)
    lda.add_argument("--device", default="cuda",
                     help="torch device; 'cpu' runs the kernels' plain "
                          "versions")
    args = ap.parse_args()
    main_lda(args)


if __name__ == "__main__":
    main()
