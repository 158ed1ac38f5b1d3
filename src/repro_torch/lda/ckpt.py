"""Durable LDA checkpoints: ``repro.lda.ckpt``'s schema, written and read
by the port.

A saved ``LDA`` is one manifest directory (`repro_torch.checkpoint`):

    meta.constructor   everything needed to rebuild the facade: the
                       LDAConfig fields, algo, the DIVIConfig (null), batch
                       size, seed, memo store, bucketing, layout, budget;
    meta.trainer       the Trainer's meta: rng bit-generator state,
                       docs_seen, history, the pending epoch's widths, the
                       stream cursor and the packer's open documents;
    state.npz          λ, ⟨m_vk⟩, init_mass, init_frac, t;
    memo.npz           the memo store's state in its wire dtype (bf16
                       chunks and snapshots tagged "bfloat16");
    pending.npz / mvi.npz / stream.npz
                       the epoch remainder, the MVI γ buffer, the stream's
                       open documents and emitted batches.

The checkpoint speaks ``repro``'s vocabulary, so each package resumes the
other's files: the port's ``cuda`` backend is written as ``pallas`` (and
read back as ``cuda``), and a kernel policy is written with all nine of
``repro``'s ``KernelPolicy`` fields, the port's ``block_b`` and
``repro``'s defaults for the rest. On load only ``block_b`` applies: the
other eight are TPU tile sizes (and the serving queue depth, 2 in the
port), so a policy whose other fields differ from ``repro``'s defaults
loads with its ``block_b`` alone.

``load_lda_checkpoint`` also takes the legacy flat ``.npz`` of a bare
``GlobalState`` (``repro``'s old ``train.py`` wrote them): it carries no
memo, rng or epoch remainder, so the estimator is serve-only
(``DeprecationWarning``): ``transform``/``top_words``/``score`` work,
``resume`` and ``fit`` refuse.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional

import numpy as np

from repro_torch.checkpoint.manifest import (is_manifest_checkpoint,
                                             load_manifest, save_manifest)
from repro_torch.convert import state_from_numpy
from repro_torch.core.types import KernelPolicy, LDAConfig
from repro_torch.dist.protocol import DIVIConfig

SCHEMA_FORMAT = "repro.lda"
SCHEMA_VERSION = 1

# the port's backend names in repro's vocabulary, and back
_BACKEND_TO_REPRO = {"cuda": "pallas"}
_BACKEND_FROM_REPRO = {v: k for k, v in _BACKEND_TO_REPRO.items()}

#: ``repro``'s ``KernelPolicy`` fields and defaults (repro/core/types.py).
REPRO_KERNEL_POLICY = {"block_b": 128, "block_v": 512, "delta_block_b": 32,
                       "delta_block_v": None, "pi_block_l": 512,
                       "scatter_block_t": 128, "block_t": 512,
                       "wire_dtype": None, "double_buffer_depth": 2}


def _cfg_to_repro(cfg: LDAConfig) -> dict:
    out = dataclasses.asdict(cfg)
    out["estep_backend"] = _BACKEND_TO_REPRO.get(cfg.estep_backend,
                                                 cfg.estep_backend)
    if cfg.kernel_policy is not None:
        out["kernel_policy"] = dict(REPRO_KERNEL_POLICY,
                                    block_b=cfg.kernel_policy.block_b)
    return out


def _cfg_from_repro(fields: dict) -> LDAConfig:
    fields = dict(fields)
    fields["estep_backend"] = _BACKEND_FROM_REPRO.get(
        fields["estep_backend"], fields["estep_backend"])
    pol = fields.get("kernel_policy")
    if pol is not None:
        fields["kernel_policy"] = KernelPolicy(
            block_b=int(pol.get("block_b", KernelPolicy.block_b)))
    return LDAConfig(**fields)


def save_lda_checkpoint(path: str, lda) -> str:
    """Write the facade and its Trainer's full durable state at ``path``."""
    trainer = lda._require_trainer()
    trainer_meta, arrays = trainer.capture()
    meta = {
        "format": SCHEMA_FORMAT,
        "schema_version": SCHEMA_VERSION,
        "constructor": {
            "cfg": _cfg_to_repro(lda.cfg),
            "algo": lda.algo,
            "distributed": None,
            "batch_size": lda.batch_size,
            "seed": lda.seed,
            "memo_store": lda.memo_store,
            "chunk_docs": lda.chunk_docs,
            "bucket_by_length": lda.bucket_by_length,
            "layout": lda.layout,
            "token_budget": lda.token_budget,
        },
        "trainer": trainer_meta,
    }
    return save_manifest(path, meta, arrays)


def load_lda_checkpoint(path: str, *, device=None):
    """A manifest checkpoint (the port's or ``repro``'s), or a legacy
    bare-λ ``.npz``, as an ``LDA`` on ``device``."""
    from repro_torch.lda.api import LDA

    if not is_manifest_checkpoint(path):
        return _load_legacy(path, device)
    meta, arrays = load_manifest(path)
    if meta.get("format") != SCHEMA_FORMAT:
        raise ValueError(f"{path!r} is a manifest checkpoint but not an LDA "
                         f"one (format={meta.get('format')!r})")
    if meta.get("schema_version") != SCHEMA_VERSION:
        raise ValueError(f"unsupported LDA checkpoint schema "
                         f"{meta.get('schema_version')!r}")
    ctor = meta["constructor"]
    dist = (DIVIConfig(**ctor["distributed"])
            if ctor["distributed"] is not None else None)
    lda = LDA(_cfg_from_repro(ctor["cfg"]), algo=ctor["algo"],
              distributed=dist, batch_size=ctor["batch_size"],
              seed=ctor["seed"], memo_store=ctor["memo_store"],
              chunk_docs=ctor["chunk_docs"],
              bucket_by_length=ctor["bucket_by_length"],
              layout=ctor.get("layout", "padded"),
              token_budget=ctor.get("token_budget"), device=device)
    lda._state_view = state_from_numpy(arrays["state"], lda.device)
    lda._pending_restore = (meta["trainer"], arrays)
    return lda


def _load_legacy(path: str, device: Optional[object]):
    """A legacy flat npz of a ``GlobalState`` → a serve-only LDA."""
    from repro_torch.lda.api import LDA

    npz = path if path.endswith(".npz") else path + ".npz"
    if not os.path.isfile(npz):
        raise FileNotFoundError(
            f"{path!r} is neither a manifest checkpoint directory nor a "
            "legacy .npz state file")
    warnings.warn(
        f"{path!r} is a legacy bare-λ checkpoint (it holds the global "
        "state only). It carries none of the incremental state (no memo, "
        "no rng, no epoch remainder), so training CANNOT resume from it; "
        "the estimator is serve-only. Re-save through LDA.save() for a "
        "resumable manifest checkpoint.", DeprecationWarning, stacklevel=3)
    with np.load(npz) as data:
        # repro's flat npz keys the GlobalState leaves ".lam", ".m_vk", ...
        flat = {k.lstrip("."): np.asarray(v) for k, v in data.items()}
    if "lam" not in flat:
        raise ValueError(f"{npz!r} holds no 'lam' leaf: not an LDA state "
                         f"checkpoint (keys: {sorted(flat)})")
    lam = flat["lam"].astype(np.float32)
    v, k = lam.shape
    # the missing leaves default to the state after a first pass (the init
    # mass retired)
    st = {"lam": lam,
          "m_vk": flat.get("m_vk", np.zeros_like(lam)),
          "init_mass": flat.get("init_mass", np.zeros_like(lam)),
          "init_frac": flat.get("init_frac", np.zeros(())),
          "t": flat.get("t", np.zeros((), np.int32))}
    lda = LDA(num_topics=k, vocab_size=v, device=device)
    lda._state_view = state_from_numpy(st, lda.device)
    lda._serve_only = True
    return lda
