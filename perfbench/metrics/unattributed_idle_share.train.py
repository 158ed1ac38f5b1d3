"""unattributed_idle_share.train: the share of the traced window's device
idle time that no program range (``train/...``, ``serve/...``) covers, in
%: the benchmark's own update loop, and idle time the spans miss."""
from perfbench.harness.spans import unattributed_share


def read(rec):
    return unattributed_share(rec, "train")
