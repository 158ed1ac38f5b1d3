"""solve_idle_ms_per_update.train: device idle ms an update while the
host's innermost program range is ``train/solve`` (the E-step ops: Eφ,
K1, K3 and the global step's glue, as the host dispatches them)."""
from perfbench.harness.spans import layer_idle_s


def read(rec):
    s = layer_idle_s(rec, "train", ("train/solve",))
    return None if s is None else 1e3 * s / rec["trace_updates"]
