"""idle_share.train: 1 − the union of the device ops' intervals over the
traced window's wall time, in %."""
from perfbench.harness.readout import idle_share


def read(rec):
    return idle_share(rec, "train")
