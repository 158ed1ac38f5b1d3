"""memo_host_idle_ms_per_update.train: device idle ms an update while the
host's innermost program range is the chunked memo store's own host work,
``train/memo_assemble`` (the rows gathered from the host chunks into the
staging buffer) or ``train/memo_scatter`` (the rows written back into the
chunks). None where the program opens neither range."""
from perfbench.harness.spans import layer_idle_s

NAMES = ("train/memo_assemble", "train/memo_scatter")


def read(rec):
    seg = rec.get("segment")
    if seg is None or not any(n in NAMES for n, _, _ in seg.host):
        return None
    s = layer_idle_s(rec, "train", NAMES)
    return None if s is None else 1e3 * s / rec["trace_updates"]
