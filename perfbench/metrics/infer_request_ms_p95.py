"""infer_request_ms_p95: the 95th percentile of every request's latency in
the window, from the call to its γ on the host (host clock)."""
import numpy as np


def read(rec):
    w = rec.get("window")
    if rec.get("kind") != "infer" or not w or not w["latencies_s"]:
        return None
    return 1e3 * float(np.percentile(w["latencies_s"], 95))
