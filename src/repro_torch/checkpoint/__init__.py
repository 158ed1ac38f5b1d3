"""Checkpoints in ``repro``'s formats: single-file npz trees (`io`) and
versioned directories (`manifest`)."""
from repro_torch.checkpoint.io import restore_checkpoint, save_checkpoint
from repro_torch.checkpoint.manifest import (MANIFEST_VERSION,
                                             is_manifest_checkpoint,
                                             load_manifest, save_manifest)

__all__ = ["MANIFEST_VERSION", "is_manifest_checkpoint", "load_manifest",
           "restore_checkpoint", "save_checkpoint", "save_manifest"]
