"""memo_idle_ms_per_update.train: device idle ms an update while the
host's innermost program range is the memo's ``train/memo_gather`` or
``train/memo_update``."""
from perfbench.harness.spans import layer_idle_s


def read(rec):
    s = layer_idle_s(rec, "train", ("train/memo_gather",
                                    "train/memo_update"))
    return None if s is None else 1e3 * s / rec["trace_updates"]
