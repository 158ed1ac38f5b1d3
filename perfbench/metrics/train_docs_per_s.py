"""train_docs_per_s: the documents of every IVI update completed in the
window over the window's seconds (host clock, ended by a synchronize)."""


def read(rec):
    w = rec.get("window")
    if rec.get("kind") != "train" or not w:
        return None
    return w["docs"] / w["seconds"]
