"""dispatch_idle_ms_per_request.infer: device idle ms a request while the
host's innermost program range is the inferencer's ``serve/solve`` (the
launch), ``serve/gather`` (γ to the host and its placement) or
``serve/request`` (outside the other spans)."""
from perfbench.harness.spans import layer_idle_s


def read(rec):
    s = layer_idle_s(rec, "infer", ("serve/solve", "serve/gather",
                                    "serve/request"))
    return None if s is None else 1e3 * s / rec["trace_requests"]
