"""host_syncs_per_update.train: synchronizing CUDA operations an update,
counted by torch's sync debug mode over the traced run's sync segment."""


def read(rec):
    s = rec.get("syncs")
    if rec.get("kind") != "train" or not s or not s["updates"]:
        return None
    return s["count"] / s["updates"]
