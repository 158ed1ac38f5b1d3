"""engine_idle_ms_per_update.train: device idle ms an update while the
host's innermost program range is the engine's ``train/batch`` (the row
index's copy, the batch's gather and width slice) or ``train/update``
(outside the memo's and the solve's spans)."""
from perfbench.harness.spans import layer_idle_s


def read(rec):
    s = layer_idle_s(rec, "train", ("train/batch", "train/update"))
    return None if s is None else 1e3 * s / rec["trace_updates"]
