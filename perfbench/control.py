"""The readings the correctness limits are set from: the compared numbers
of sound runs of the program over many seeds, and of the control (the
program's own lower-precision path: Eφ and the counts streamed through the
fixed point in bfloat16) over a few, at the cell's own size, in one
process, and with ``--faults`` of the program with a fault planted
(``perfbench/faults.py``). The benchmark's runs never run it.

    python3 perfbench/control.py --workload <cell> --program-seeds 1 2 ... \
        --control-seeds 7 8 9

Each seed runs the cell's set-up and, for a served cell, as many requests
as its check compares, then the check; one JSON line a seed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def readings(root, cell_name, seeds, control, device="cuda", fault=None):
    """Yield one dict of the compared numbers a seed; with ``fault`` the
    program runs with that fault planted (``perfbench/faults.py``)."""
    import torch
    from perfbench.faults import Patches, plant
    from perfbench.harness.bench import Bench
    from perfbench.harness.runner import Phases
    bench = Bench(root)
    cell = bench.cell(cell_name)
    dev = torch.device(device)
    for seed in seeds:
        drv = bench.driver(cell.traffic).make(cell, seed, dev, control)
        with Patches() as patches:
            if fault:
                plant(patches.setattr, drv.kind, fault)
            drv.setup(Phases(dev.type == "cuda"))
            if drv.kind == "infer":
                for _ in range(int(cell.traffic["check_requests"])):
                    drv.keep(*drv._serve()[::2])
        drv.release()
        out = {"cell": cell_name, "seed": seed, "control": control,
               "fault": fault, **drv.check()}
        del drv
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        yield out


def main(argv):
    p = argparse.ArgumentParser(prog="perfbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[])
    a = p.parse_args(argv)
    runs = [(a.program_seeds, False, None), (a.control_seeds, True, None)]
    runs += [(a.fault_seeds, False, f) for f in a.faults]
    for seeds, control, fault in runs:
        for r in readings(ROOT, a.workload, seeds, control, fault=fault):
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
