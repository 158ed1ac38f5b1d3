"""Store → :class:`KernelPolicy` resolution for the engines and serving.

The port's copy of ``repro.tune.resolve``. A :class:`PolicyResolver`
wraps a :class:`~repro_torch.tune.store.PolicyStore` with:

* an in-memory memo (serving resolves one policy per batch width: the
  file is read once per distinct shape, not per batch);
* telemetry: every resolution runs under a ``tune/lookup`` span and bumps
  the ``tune.cache`` counter with ``result="hit"|"miss"``, so a traced run
  shows which policies came from the store and which defaulted;
* a width-wildcard fallback: an exact ``(…, W, …)`` key is tried first,
  then the ``W*`` entry (written by width-free tunes), so one tuned record
  can serve every padded width of the same (B, V, K).

A resolver with no store resolves everything to ``None`` (counted as
misses): callers then leave ``cfg.kernel_policy`` unset, which launches
exactly what the kernels chose before the tuner.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.core.types import KernelPolicy

from .store import PolicyKey, PolicyStore, as_store, current_device_kind


class PolicyResolver:
    """``device_kind`` names the device the policies are for; without it
    the kind of ``device`` (the card by default)."""

    def __init__(self, store=None, telemetry=None,
                 device_kind: Optional[str] = None, device=None):
        from repro_torch.obs import NULL_TELEMETRY, as_telemetry

        self.store: Optional[PolicyStore] = as_store(store)
        self.telemetry = (NULL_TELEMETRY if telemetry is None
                          else as_telemetry(telemetry))
        self.device_kind = device_kind or current_device_kind(device)
        self._memo: Dict[Tuple, Optional[KernelPolicy]] = {}

    def key(self, *, backend: str, layout: str, b_or_t: int, v: int,
            k: int, w: Optional[int] = None) -> PolicyKey:
        return PolicyKey(backend=backend, layout=layout, b_or_t=b_or_t,
                         v=v, k=k, w=w, device_kind=self.device_kind)

    def resolve(self, *, backend: str, layout: str, b_or_t: int, v: int,
                k: int, w: Optional[int] = None) -> Optional[KernelPolicy]:
        """The tuned policy for this shape, or None (→ defaults)."""
        memo_key = (backend, layout, b_or_t, v, k, w)
        if memo_key in self._memo:
            return self._memo[memo_key]
        key = self.key(backend=backend, layout=layout, b_or_t=b_or_t,
                       v=v, k=k, w=w)
        tel = self.telemetry
        tok = (tel.trace.begin("tune/lookup", key=key.path())
               if tel.enabled else None)
        policy = None
        if self.store is not None:
            policy = self.store.get_policy(key)
            if policy is None and w is not None:
                # width-wildcard fallback: a width-free tune of the same
                # (backend, layout, B, V, K) serves every padded width
                wild = self.key(backend=backend, layout=layout,
                                b_or_t=b_or_t, v=v, k=k, w=None)
                policy = self.store.get_policy(wild)
        if tel.enabled:
            tel.metrics.inc("tune.cache",
                            result="hit" if policy is not None else "miss")
            tel.trace.end(tok)
        self._memo[memo_key] = policy
        return policy
