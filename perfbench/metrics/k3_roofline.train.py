"""k3_roofline.train: K3's summed bounds (perfbench/reference/work.py) over
K3's device time in the profiler's trace, in %."""
from perfbench.harness.readout import is_k3, roofline


def read(rec):
    return roofline(rec, "train", "k3", is_k3)
