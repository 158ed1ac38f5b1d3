"""glue_ms_per_update.train: device ms an update of every device op other
than K1 and K3 (Eφ, the memo's gather and update, the global step, copies
and fills), from the profiler's trace of the traced updates."""
from perfbench.harness.readout import is_k1, is_k3, traced


def read(rec):
    if not traced(rec, "train"):
        return None
    s = rec["segment"].device_seconds(lambda n: not (is_k1(n) or is_k3(n)))
    return 1e3 * s / rec["trace_updates"]
