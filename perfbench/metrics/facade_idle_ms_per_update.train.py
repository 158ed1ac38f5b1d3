"""facade_idle_ms_per_update.train: device idle ms an update while the
host's innermost program range is the facade's ``train/step`` (outside the
engine's spans), from the profiler's trace of the traced updates."""
from perfbench.harness.spans import layer_idle_s


def read(rec):
    s = layer_idle_s(rec, "train", ("train/step",))
    return None if s is None else 1e3 * s / rec["trace_updates"]
