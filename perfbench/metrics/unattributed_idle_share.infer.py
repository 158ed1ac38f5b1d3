"""unattributed_idle_share.infer: the share of the traced window's device
idle time that no program range (``train/...``, ``serve/...``) covers, in
%: the client's own request slicing, and idle time the spans miss."""
from perfbench.harness.spans import unattributed_share


def read(rec):
    return unattributed_share(rec, "infer")
