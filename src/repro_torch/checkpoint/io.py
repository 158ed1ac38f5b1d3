"""Single-file npz checkpoints in ``repro.checkpoint.io``'s format.

A tree of dicts, lists, tuples and named tuples over arrays (torch
tensors or numpy arrays) is flattened by path and written to one ``.npz``:
each leaf under the ``/``-joined path of its dict keys, sequence indices
and ``.field`` names, as ``repro`` keys a pytree's leaves, plus an
optional ``__step__``. A file written by either package restores in the
other, bit for bit.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.tree import tree_map_with_path, tree_paths

STEP_KEY = "__step__"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("save_checkpoint: numpy has no bfloat16; store "
                            "bf16 tensors with checkpoint.manifest")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in tree_paths(tree)}


def save_checkpoint(path: str, tree: Any, step: Optional[int] = None) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(tree)
    if step is not None:
        flat[STEP_KEY] = np.asarray(step)
    np.savez(path, **flat)
    return path


def restore_checkpoint(path: str, like: Any = None, device=None) -> Any:
    """Restore into the structure of ``like`` (torch tensors on ``device``,
    default CPU, where ``like`` holds tensors; numpy arrays elsewhere), or,
    with no ``like``, the file's ``{path: array}`` dict (``__step__``
    included when present)."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        flat = {k: data[k] for k in data.files}
    if like is None:
        return flat

    def load(key, node):
        arr = flat[key]
        if arr.shape != tuple(node.shape):
            raise ValueError(f"restore_checkpoint: {key} has shape "
                             f"{arr.shape}, expected {tuple(node.shape)}")
        if isinstance(node, torch.Tensor):
            return torch.from_numpy(arr).to(device or "cpu")
        return arr

    return tree_map_with_path(load, like)
