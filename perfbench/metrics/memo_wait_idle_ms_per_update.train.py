"""memo_wait_idle_ms_per_update.train: device idle ms an update while the
host's innermost program range is one of the chunked memo store's copies,
``train/memo_copy_in`` (the rows to the device and their widening) or
``train/memo_copy_out`` (the rounding and the waited copy back). None
where the program opens neither range."""
from perfbench.harness.spans import layer_idle_s

NAMES = ("train/memo_copy_in", "train/memo_copy_out")


def read(rec):
    seg = rec.get("segment")
    if seg is None or not any(n in NAMES for n, _, _ in seg.host):
        return None
    s = layer_idle_s(rec, "train", NAMES)
    return None if s is None else 1e3 * s / rec["trace_updates"]
