"""stage_idle_ms_per_request.infer: device idle ms a request while the
host's innermost program range is the inferencer's ``serve/bucket`` (the
request's host copy and bucketing, each batch's row cut) or
``serve/stage`` (padding and the copies to the device)."""
from perfbench.harness.spans import layer_idle_s


def read(rec):
    s = layer_idle_s(rec, "infer", ("serve/bucket", "serve/stage"))
    return None if s is None else 1e3 * s / rec["trace_requests"]
