"""pad_frac.infer: the inferencer's own counter (padding_stats): the share
of the token slots dispatched in the traced requests that were padding,
in %."""


def read(rec):
    p = rec.get("padding")
    if rec.get("kind") != "infer" or not p or not p["padded_slots"]:
        return None
    return 100.0 * (1.0 - p["live_slots"] / p["padded_slots"])
