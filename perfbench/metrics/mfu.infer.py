"""mfu.infer: the traced work's counted operations over the traced
window's wall seconds at the H100's 67 TFLOP/s fp32 peak, in %."""
from perfbench.harness.readout import mfu


def read(rec):
    return mfu(rec, "infer")
