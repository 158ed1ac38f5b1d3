"""Versioned directory checkpoints: a JSON manifest and named npz groups,
in ``repro.checkpoint.manifest``'s format, so each package reads the
other's files.

A manifest checkpoint is a directory:

    <path>/
      manifest.json        version, free-form meta, per-group dtype tags
      <group>.npz          one npz per named array group

``manifest.json`` is written last and atomically, and removed first when a
checkpoint is written again in place: a directory without it is an
interrupted save, never a mix of two generations.

numpy has no bfloat16 without ``ml_dtypes``, which the port does not use.
A ``torch.bfloat16`` tensor is therefore stored as its 16-bit patterns
(``uint16``) under the tag ``"bfloat16"``, as ``repro`` stores its
``ml_dtypes`` bf16 arrays, and a ``"bfloat16"`` tag reads back as a
``torch.bfloat16`` CPU tensor with the same bits. Other tags ``repro``
may write (fp8 types) are refused on load.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

MANIFEST_VERSION = 1
MANIFEST_NAME = "manifest.json"

Array = Union[np.ndarray, torch.Tensor]


def _encode(arr: Array) -> Tuple[np.ndarray, str]:
    if isinstance(arr, torch.Tensor):
        if arr.dtype == torch.bfloat16:
            bits = arr.detach().cpu().contiguous().view(torch.int16)
            return bits.numpy().view(np.uint16), "bfloat16"
        return arr.detach().cpu().numpy(), ""
    return np.asarray(arr), ""


def _decode(arr: np.ndarray, tag: str) -> Array:
    if not tag:
        return arr
    if tag != "bfloat16" or arr.dtype.itemsize != 2:
        raise ValueError(f"unsupported dtype tag {tag!r} for a "
                         f"{arr.dtype} array (this package reads bfloat16 "
                         "only)")
    bits = np.ascontiguousarray(arr).view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16)


def is_manifest_checkpoint(path: str) -> bool:
    return os.path.isfile(os.path.join(path, MANIFEST_NAME))


def save_manifest(path: str, meta: Dict[str, Any],
                  arrays: Dict[str, Dict[str, Array]]) -> str:
    """Write ``meta`` and named array groups under directory ``path``.

    ``arrays`` maps group name → {key: numpy array or tensor}; each group
    becomes one ``<group>.npz``. Returns ``path``.
    """
    os.makedirs(path, exist_ok=True)
    manifest_path = os.path.join(path, MANIFEST_NAME)
    if os.path.exists(manifest_path):
        os.remove(manifest_path)
    dtype_tags: Dict[str, Dict[str, str]] = {}
    for group, kv in arrays.items():
        encoded, tags = {}, {}
        for key, arr in kv.items():
            encoded[key], tag = _encode(arr)
            if tag:
                tags[key] = tag
        np.savez(os.path.join(path, f"{group}.npz"), **encoded)
        dtype_tags[group] = tags
    doc = {"manifest_version": MANIFEST_VERSION,
           "groups": sorted(arrays),
           "dtype_tags": dtype_tags,
           "meta": meta}
    tmp = manifest_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, manifest_path)
    return path


def load_manifest(path: str) -> Tuple[Dict[str, Any],
                                      Dict[str, Dict[str, Array]]]:
    """Read back (meta, arrays) written by ``save_manifest`` (or by
    ``repro``'s)."""
    with open(os.path.join(path, MANIFEST_NAME)) as f:
        doc = json.load(f)
    version = doc.get("manifest_version")
    if version != MANIFEST_VERSION:
        raise ValueError(f"unsupported manifest version {version!r} "
                         f"(this build reads version {MANIFEST_VERSION})")
    arrays: Dict[str, Dict[str, Array]] = {}
    for group in doc["groups"]:
        tags = doc["dtype_tags"].get(group, {})
        with np.load(os.path.join(path, f"{group}.npz")) as data:
            arrays[group] = {k: _decode(data[k], tags.get(k, ""))
                             for k in data.files}
    return doc["meta"], arrays
