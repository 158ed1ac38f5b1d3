"""Versioned directory checkpoints (`manifest`), in ``repro``'s format."""
from repro_torch.checkpoint.manifest import (MANIFEST_VERSION,
                                             is_manifest_checkpoint,
                                             load_manifest, save_manifest)

__all__ = ["MANIFEST_VERSION", "is_manifest_checkpoint", "load_manifest",
           "save_manifest"]
