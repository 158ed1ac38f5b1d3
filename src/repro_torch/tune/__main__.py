"""CLI of the kernel-policy tuner.

::

    # search one shape on the card and store the winner
    python -m repro_torch.tune tune --store tune_store.json \
        --task padded --batch 1024 --vocab 141927 --topics 100 \
        --width 163 --budget 16 --iters 60 --device cuda

    # CSR: --batch is the token budget T, --docs the documents a batch
    python -m repro_torch.tune tune --store tune_store.json --task csr \
        --batch 131072 --docs 1024 --vocab 141927 --topics 100

    # on the CPU the objective is the bound model (proxy_regime)
    python -m repro_torch.tune tune --store t.json --batch 8 --vocab 256 \
        --topics 8 --width 8 --device cpu

    # inspect / clear
    python -m repro_torch.tune show --store tune_store.json
    python -m repro_torch.tune clear --store tune_store.json [--prefix cuda/]
"""
from __future__ import annotations

import argparse
import json
import sys

from .store import PolicyStore


def _cmd_tune(args) -> int:
    from .search import TuneShape, tune_and_store

    shape = TuneShape(task=args.task, b_or_t=args.batch, v=args.vocab,
                      k=args.topics, w=args.width, num_docs=args.docs,
                      backend="cuda", layout=args.task)
    store = PolicyStore(args.store)
    res = tune_and_store(store, shape, budget=args.budget, seed=args.seed,
                         iters=args.iters,
                         device=args.device, verbose=args.verbose)
    kind = "measured" if not res.proxy_regime else "modeled (proxy_regime)"
    print(f"tuned {shape.task} B_or_T={shape.b_or_t} V={shape.v} "
          f"K={shape.k} W={shape.w} on {res.device_kind}")
    print(f"  objective : {kind}")
    print(f"  default   : {res.default_cost:.3e} s")
    print(f"  tuned     : {res.tuned_cost:.3e} s "
          f"({res.improvement:.2f}x, {res.trials} trials)")
    print(f"  equality  : {res.equality['mode']} "
          f"(max|err| {res.equality['max_abs_err']:.1e}) at probe "
          f"{res.equality['probe_shape']}")
    print(f"  effective : {res.effective}")
    print(f"  policy    : {res.policy}")
    print(f"  -> {args.store} [{shape.key(res.device_kind).path()}]")
    return 0


def _cmd_show(args) -> int:
    store = PolicyStore(args.store)
    entries = store.entries()
    if not entries:
        print(f"{args.store}: no tuned entries")
        return 0
    if args.json:
        json.dump(entries, sys.stdout, indent=2, sort_keys=True)
        print()
        return 0
    print(f"{args.store}: {len(entries)} tuned entr"
          f"{'y' if len(entries) == 1 else 'ies'}")
    for path, rec in sorted(entries.items()):
        obj = rec.get("objective", {})
        imp = obj.get("improvement")
        tag = " [proxy_regime]" if obj.get("proxy_regime") else ""
        imp_s = f" {imp:.2f}x" if isinstance(imp, (int, float)) else ""
        print(f"  {path}{imp_s}{tag}")
        if args.verbose:
            print(f"    policy={rec.get('policy')}")
            print(f"    effective={rec.get('effective')}")
            print(f"    equality={rec.get('equality')}")
    return 0


def _cmd_clear(args) -> int:
    removed = PolicyStore(args.store).clear(args.prefix)
    what = f"prefix {args.prefix!r}" if args.prefix else "all entries"
    print(f"{args.store}: removed {removed} ({what})")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tune",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("tune", help="search one shape, cache the winner")
    t.add_argument("--store", required=True, help="policy store JSON path")
    t.add_argument("--task", choices=["padded", "csr"], default="padded")
    t.add_argument("--batch", type=int, required=True,
                   help="batch size (padded) / token budget T (csr)")
    t.add_argument("--vocab", type=int, required=True)
    t.add_argument("--topics", type=int, required=True)
    t.add_argument("--width", type=int, default=None,
                   help="padded token width W (omit for a W* entry)")
    t.add_argument("--docs", type=int, default=None,
                   help="csr doc rows per batch")
    t.add_argument("--budget", type=int, default=16,
                   help="random candidates before refinement")
    t.add_argument("--iters", type=int, default=20,
                   help="fixed-point sweeps of the gate's and the timed "
                        "runs (and of the model)")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--device", default="cuda",
                   help="the device tuned for: 'cuda' times the kernels "
                        "(and raises without a card), 'cpu' prices the "
                        "bound model (proxy_regime)")
    t.add_argument("--verbose", action="store_true")
    t.set_defaults(fn=_cmd_tune)

    s = sub.add_parser("show", help="list tuned entries")
    s.add_argument("--store", required=True)
    s.add_argument("--json", action="store_true")
    s.add_argument("--verbose", action="store_true")
    s.set_defaults(fn=_cmd_show)

    c = sub.add_parser("clear", help="drop tuned entries")
    c.add_argument("--store", required=True)
    c.add_argument("--prefix", default=None,
                   help="only entries whose key path starts with this")
    c.set_defaults(fn=_cmd_clear)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
