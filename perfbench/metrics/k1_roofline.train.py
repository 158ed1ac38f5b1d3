"""k1_roofline.train: K1's summed bounds (perfbench/reference/work.py, each
tile's sweeps the reference's) over K1's device time in the profiler's
trace, in %."""
from perfbench.harness.readout import is_k1, roofline


def read(rec):
    return roofline(rec, "train", "k1", is_k1)
