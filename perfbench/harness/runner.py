"""One run of one cell: set-up, a measured (or traced) window, the check
against the plain reference, and the result line.

The order is fixed: the program's state is built and filled (set-up, timed
from the process's first line), the window runs, the device's peak memory
is read, the program's state is freed, and only then does the reference
run, on the device, so it never sets the peak. The last line of standard
output is one JSON object; the numbers compared, each beside its limit,
close standard error and the line itself (``checks``).
"""
from __future__ import annotations

import json
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterable, List, Optional, TextIO

#: Top-level module names that may not be loaded in a run: JAX and the JAX
#: package the port was made from. Names are compared whole, so the port
#: (``repro_torch``) is not among them.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The loaded modules whose top-level name is forbidden."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


class Phases:
    """Seconds of each named set-up phase, synchronised at its end."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.seconds: Dict[str, float] = {}

    @contextmanager
    def __call__(self, name: str):
        import torch
        t = time.perf_counter()
        yield
        if self.cuda:
            torch.cuda.synchronize()
        self.seconds[name] = self.seconds.get(name, 0.0) \
            + time.perf_counter() - t


def device_info(device, count: int) -> Dict[str, object]:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def run(root: Path, cell_name: str, seed: int, seconds: float, trace: bool,
        *, t0: float, device: Optional[str] = None,
        out: TextIO = sys.stdout, err: TextIO = sys.stderr) -> int:
    """Run the cell once; print the result line. Returns the exit code.

    ``device`` None means the card, which must be there; tests pass
    ``"cpu"`` to drive the same run on the program's plain twins."""
    import torch
    from perfbench.harness.bench import Bench

    bench = Bench(root)
    spec = next((w for w in bench.spec["workloads"]
                 if w["name"] == cell_name), None)
    if spec is None:
        print(f"perfbench: no cell {cell_name!r}", file=err)
        return 2
    chips = int(spec["chips"])
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            have = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
            print(f"perfbench: the cell needs {chips} CUDA device(s), "
                  f"this machine has {have}", file=err)
            return 3
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    cuda = dev.type == "cuda"
    cell = bench.cell(cell_name)
    phases = Phases(cuda)
    phases.seconds["import"] = time.perf_counter() - t0
    if cuda:
        with phases("extension"):
            from repro_torch.kernels import build
            build.load("lda_estep")
    drv = bench.driver(cell.traffic).make(cell, seed, dev, False)
    drv.setup(phases)
    setup_s = time.perf_counter() - t0
    print("perfbench: setup " + " ".join(
        f"{k}={v:.3f}s" for k, v in phases.seconds.items())
        + f" setup_s={setup_s:.3f}", file=err)
    if cuda:
        print(f"perfbench: card {power_limit()}", file=err)

    rec: Dict[str, object] = {"kind": drv.kind, "setup_s": setup_s,
                              "cell": cell_name}
    rec.update(drv.traced() if trace else drv.window(seconds))
    info = device_info(dev, chips)
    drv.release()
    t_check = time.perf_counter()
    checks = drv.check()
    if trace:
        rec.update(drv.work())
        seg = rec["segment"]
        info["busy_s"] = seg.busy_s
        info["window_s"] = seg.window_s
    print(f"perfbench: reference {time.perf_counter() - t_check:.3f}s",
          file=err)
    for line in drv.notes():
        print("perfbench: " + line, file=err)

    metrics = bench.read_metrics(cell.per_layer if trace
                                 else cell.end_to_end, rec)
    correct = all(checks[k] <= cell.limits[k] for k in cell.limits)
    result: Dict[str, object] = {
        "correct": correct, "attempted": rec["attempted"],
        "failed": rec["failed"], "metrics": metrics, "device": info}
    if trace:
        result["breakdown"] = {"device_ops": seg.top_device_ops(),
                               "idle_gaps": seg.idle_gaps()}
    result["checks"] = {k: {"value": checks[k], "limit": cell.limits[k]}
                        for k in cell.limits}

    bad = forbidden_modules(sys.modules)
    if bad:
        print("perfbench: forbidden modules loaded: " + ", ".join(bad),
              file=err)
        return 4
    for k in cell.limits:
        print(f"check {k} = {checks[k]!r} (limit {cell.limits[k]!r})",
              file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0


def main(argv: List[str], *, root: Path, t0: float) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="perfbench/run.py",
        description="Run one benchmark cell once and print its result.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    return run(root, a.workload, a.seed, a.seconds, bool(a.trace), t0=t0)
