"""infer_docs_per_s: the documents of every request completed in the
window over the window's seconds (host clock)."""


def read(rec):
    w = rec.get("window")
    if rec.get("kind") != "infer" or not w:
        return None
    return w["docs"] / w["seconds"]
