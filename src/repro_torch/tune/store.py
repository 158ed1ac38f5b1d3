"""Versioned on-disk store of tuned kernel policies: ``repro.tune.store``'s
format, written and read by the port.

One JSON file holds every tuned record, keyed on the full problem identity
``(backend, layout, B_or_T, V, K, W, device_kind)``::

    {
      "format": "repro.tune",
      "version": 1,
      "entries": {
        "cuda/padded/B1024/V141927/K100/W163/gpu:nvidia-h100-80gb-hbm3": {
          "key": {...},            # the key fields, for validation
          "policy": {...},         # KernelPolicy fields
          "objective": {...},      # default vs tuned cost + proxy_regime
          "effective": {...},      # the launch that actually runs
          "equality": {...},       # how bit-equality was established
        }
      }
    }

The format, version and key paths are ``repro``'s, so one file can hold
both packages' entries: the port's backend is ``cuda`` and ``repro``'s
``pallas`` (or ``csr``), so neither package is ever served the other's
policy. ``put`` and ``clear`` rewrite the raw entries table, keeping every
entry they cannot decode, as ``repro``'s do. Writes are atomic (a tmp file
and ``os.replace`` in the same directory: concurrent writers race
entry-wise, never byte-wise), and a store problem is never a training
problem: a corrupted, stale-version or foreign-format file is ignored with
a ``TuneStoreWarning`` and the engines run the built-in defaults.

``device_kind`` is part of the key and revalidated from the stored
record, so a policy tuned on one device is never served on another.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import warnings
from typing import Dict, Optional

from repro_torch.core.types import KernelPolicy, resolve_device

STORE_FORMAT = "repro.tune"
STORE_VERSION = 1

_POLICY_FIELDS = {f.name for f in dataclasses.fields(KernelPolicy)}


class TuneStoreWarning(UserWarning):
    """A policy store was unreadable/invalid and is being ignored."""


@dataclasses.dataclass(frozen=True)
class PolicyKey:
    """The full problem identity a tuned policy is valid for.

    ``w`` is the padded batch width (``None`` for width-free entries: the
    CSR flat-token path, or a padded entry meant to serve any width).
    ``b_or_t`` is the batch size on the padded path and the token budget T
    on the CSR path.
    """

    backend: str
    layout: str
    b_or_t: int
    v: int
    k: int
    w: Optional[int]
    device_kind: str

    def path(self) -> str:
        w = "W*" if self.w is None else f"W{self.w}"
        return (f"{self.backend}/{self.layout}/B{self.b_or_t}/V{self.v}/"
                f"K{self.k}/{w}/{self.device_kind}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def current_device_kind(device=None) -> str:
    """A stable id of the device policies are tuned for.

    ``cpu:cpu`` on the CPU; on a card ``gpu:`` and its name lower-cased,
    spaces as ``-`` (``gpu:nvidia-h100-80gb-hbm3``, the string JAX gives on
    the same card), of that device, not of device 0. ``device`` defaults
    to the card, as every entry point of the port does.
    """
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu:cpu"
    if dev.type != "cuda":
        raise ValueError(f"no device kind for {dev}")
    import torch
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    name = torch.cuda.get_device_name(index)
    return f"gpu:{name}".replace(" ", "-").lower()


def policy_to_dict(policy: KernelPolicy) -> dict:
    return dataclasses.asdict(policy)


def policy_from_dict(d: dict) -> KernelPolicy:
    """Decode a stored policy dict; raises ``ValueError`` on junk."""
    if not isinstance(d, dict):
        raise ValueError(f"policy record must be a dict, got {type(d)}")
    unknown = set(d) - _POLICY_FIELDS
    if unknown:
        raise ValueError(f"unknown policy fields: {sorted(unknown)}")
    pol = KernelPolicy(**d)
    for f in ("block_b", "double_buffer_depth"):
        val = getattr(pol, f)
        if not isinstance(val, int) or val <= 0:
            raise ValueError(f"policy field {f} must be a positive int, "
                             f"got {val!r}")
    if pol.wire_dtype not in (None, "float32", "bfloat16"):
        raise ValueError(f"wire_dtype must be None|float32|bfloat16, "
                         f"got {pol.wire_dtype!r}")
    return pol


class PolicyStore:
    """Read/write access to one policy-store JSON file.

    Reads never raise on a bad file: they warn and behave as empty. Writes
    are read-modify-write with an atomic same-directory tmp+rename, so a
    reader never observes a torn file and concurrent writers at worst lose
    the race entry-wise, not byte-wise.
    """

    def __init__(self, path):
        self.path = os.fspath(path)

    # -- reading ---------------------------------------------------------
    def _read_entries(self) -> Dict[str, dict]:
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return {}
        except (json.JSONDecodeError, OSError, UnicodeDecodeError) as e:
            warnings.warn(
                f"ignoring unreadable tune store {self.path!r}: {e}",
                TuneStoreWarning, stacklevel=3)
            return {}
        if not isinstance(doc, dict) or doc.get("format") != STORE_FORMAT:
            warnings.warn(
                f"ignoring tune store {self.path!r}: not a "
                f"{STORE_FORMAT} file", TuneStoreWarning, stacklevel=3)
            return {}
        if doc.get("version") != STORE_VERSION:
            warnings.warn(
                f"ignoring tune store {self.path!r}: version "
                f"{doc.get('version')!r} != {STORE_VERSION} (stale store: "
                f"re-run `python -m repro_torch.tune tune`)",
                TuneStoreWarning, stacklevel=3)
            return {}
        entries = doc.get("entries")
        if not isinstance(entries, dict):
            warnings.warn(
                f"ignoring tune store {self.path!r}: no entries table",
                TuneStoreWarning, stacklevel=3)
            return {}
        return entries

    def entries(self) -> Dict[str, dict]:
        """Every stored record, keyed by its key path string."""
        return self._read_entries()

    def get(self, key: PolicyKey) -> Optional[dict]:
        """The raw record for ``key``, or None (miss OR invalid entry)."""
        rec = self._read_entries().get(key.path())
        if rec is None:
            return None
        stored_key = rec.get("key", {})
        # revalidate the identity fields from the record body: a renamed or
        # tampered entry must not smuggle a foreign-device policy in
        for field in ("backend", "layout", "device_kind"):
            if stored_key.get(field) != getattr(key, field):
                warnings.warn(
                    f"ignoring tune entry {key.path()!r}: stored "
                    f"{field}={stored_key.get(field)!r} does not match "
                    f"requested {getattr(key, field)!r}",
                    TuneStoreWarning, stacklevel=3)
                return None
        try:
            policy_from_dict(rec.get("policy", {}))
        except ValueError as e:
            warnings.warn(
                f"ignoring tune entry {key.path()!r}: bad policy ({e})",
                TuneStoreWarning, stacklevel=3)
            return None
        return rec

    def get_policy(self, key: PolicyKey) -> Optional[KernelPolicy]:
        rec = self.get(key)
        if rec is None:
            return None
        return policy_from_dict(rec["policy"])

    # -- writing ---------------------------------------------------------
    def _write_doc(self, entries: Dict[str, dict]) -> None:
        doc = {"format": STORE_FORMAT, "version": STORE_VERSION,
               "entries": entries}
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".tune-", suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=2, sort_keys=True)
                f.write("\n")
            os.replace(tmp, self.path)  # atomic on POSIX: never torn
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def put(self, key: PolicyKey, policy: KernelPolicy, *,
            objective: Optional[dict] = None,
            effective: Optional[dict] = None,
            equality: Optional[dict] = None) -> dict:
        """Insert/overwrite the record for ``key``; returns the record. The
        other entries, this package's or ``repro``'s, are kept as read."""
        policy_from_dict(policy_to_dict(policy))   # round-trip sanity
        rec = {"key": key.to_dict(), "policy": policy_to_dict(policy)}
        if objective is not None:
            rec["objective"] = objective
        if effective is not None:
            rec["effective"] = effective
        if equality is not None:
            rec["equality"] = equality
        entries = self._read_entries()
        entries[key.path()] = rec
        self._write_doc(entries)
        return rec

    def clear(self, prefix: Optional[str] = None) -> int:
        """Drop entries whose key path starts with ``prefix`` (all when
        None); returns how many were removed."""
        entries = self._read_entries()
        if prefix is None:
            removed = len(entries)
            kept: Dict[str, dict] = {}
        else:
            kept = {p: r for p, r in entries.items()
                    if not p.startswith(prefix)}
            removed = len(entries) - len(kept)
        self._write_doc(kept)
        return removed


def as_store(store) -> Optional[PolicyStore]:
    """Coerce a user-facing ``tune_store=`` argument.

    ``None`` stays None (no store: the built-in defaults, bit-identical to
    the launches before the tuner); a path becomes a :class:`PolicyStore`;
    a store passes through.
    """
    if store is None:
        return None
    if isinstance(store, PolicyStore):
        return store
    if isinstance(store, (str, os.PathLike)):
        return PolicyStore(store)
    raise TypeError("tune_store must be None, a path, or a repro_torch."
                    f"tune.PolicyStore, got {type(store).__name__}")
