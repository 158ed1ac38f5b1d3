"""repro_torch.tune — tuned kernel policies for the CUDA E-step kernels.

The port's counterpart of ``repro.tune``. The policy space
(``KernelPolicy``, in `repro_torch.core.types`, so a tuned policy rides
on ``LDAConfig``):

* the padded fixed point's stopping tile ``block_b`` (the one knob the
  search moves);
* the serving ``double_buffer_depth`` and ``repro``'s memo
  ``wire_dtype``, which a stored policy carries (the port's memo store,
  not the policy, sets its wire).

Winners live in ``repro``'s versioned on-disk store format
(``PolicyStore``), keyed on ``(backend, layout, B_or_T, V, K, W,
device_kind)`` with the port's backend ``cuda``; engines and serving
resolve them through a ``PolicyResolver`` (telemetry: ``tune.cache``
hit/miss counters, ``tune/lookup`` spans). With no store every launch is
the one the kernels chose before the tuner, bit for bit.

The search (``repro_torch.tune.search``) is imported lazily: it pulls in
the kernels. CLI: ``python -m repro_torch.tune`` (tune / show / clear).
"""
from __future__ import annotations

from repro_torch.core.types import DEFAULT_KERNEL_POLICY, KernelPolicy

from .resolve import PolicyResolver
from .store import (
    STORE_FORMAT,
    STORE_VERSION,
    PolicyKey,
    PolicyStore,
    TuneStoreWarning,
    as_store,
    current_device_kind,
    policy_from_dict,
    policy_to_dict,
)

__all__ = [
    "KernelPolicy", "DEFAULT_KERNEL_POLICY",
    "PolicyKey", "PolicyStore", "PolicyResolver", "TuneStoreWarning",
    "STORE_FORMAT", "STORE_VERSION",
    "as_store", "current_device_kind",
    "policy_from_dict", "policy_to_dict",
]
