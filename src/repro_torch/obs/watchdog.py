"""ELBO-monotonicity watchdog: watch the paper's headline invariant (the
port's copy of ``repro.obs.watchdog``).

IVI's selling point (§3 / Alg. 1) is that every incremental update —
with NO learning rate — monotonically increases the exact memoized ELBO
once every document has been visited. That is a production invariant, not
just a unit-test property: a bound decrease at runtime means a broken
memo (the eq. 4 subtract-old side lost sync), a quantization drift, or a
numerically degenerate E-step. ``ElboWatchdog`` records the per-update
memoized-bound sequence and flags any decrease beyond tolerance:

* ``observe(bound, step=, armed=)`` appends one reading. ``armed`` is
  whether the guarantee is in force — the engines pass
  ``init_frac == 0`` (the random-init mass fully retired, i.e. the first
  full pass is done; before that the bound may legitimately move down as
  random mass is swapped for real statistics). A violation is only ever
  raised between two **armed** readings.
* tolerance: the bound is a sum of ~|bound|-magnitude fp32 terms, so the
  comparison allows ``max(tol, rel_tol · |prev|)`` of rounding slack —
  the same slack the monotonicity property tests use.
* policy: ``"warn"`` emits an ``ElboMonotonicityWarning`` (and keeps
  counting); ``"raise"`` raises ``BoundMonotonicityError``. Either way
  the violation is recorded in ``violations`` and counted in the bundled
  metrics registry (``watchdog.violations``) when one is attached.
* cost: each check reads the **full memoized corpus bound** — an
  O(corpus) chunk read-through, deliberate and exact. ``check_every``
  prices it: the engines evaluate the bound every N-th update (N=1 for
  the paper-faithful per-update record; larger N for production cadence;
  0 = only when a bound is computed anyway, e.g. ``evaluate()``).

SVI has no such guarantee (it needs convergence monitoring instead —
the same ``observe`` stream without arming gives exactly that), so the
engines arm the watchdog on the IVI path only.

``NULL_WATCHDOG`` is the disabled instance the null telemetry carries.
"""
from __future__ import annotations

import math
import warnings
from typing import List, Optional


class BoundMonotonicityError(RuntimeError):
    """An armed IVI update decreased the memoized ELBO beyond tolerance."""


class ElboMonotonicityWarning(UserWarning):
    """Warn-policy counterpart of ``BoundMonotonicityError``."""


class NullElboWatchdog:
    """The disabled watchdog: never checks, never records."""

    enabled = False

    def should_check(self, step: int) -> bool:
        return False

    def observe(self, bound: float, *, step: Optional[int] = None,
                armed: bool = True) -> bool:
        return False

    def status(self) -> dict:
        return {"enabled": False}


NULL_WATCHDOG = NullElboWatchdog()

_POLICIES = ("warn", "raise")


class ElboWatchdog:
    """Monotonicity watchdog over an observed bound sequence (see module
    docstring)."""

    enabled = True

    def __init__(self, *, policy: str = "warn", tol: float = 5e-3,
                 rel_tol: float = 2e-6, check_every: int = 1,
                 metrics=None):
        if policy not in _POLICIES:
            raise ValueError(f"policy must be one of {_POLICIES}, "
                             f"got {policy!r}")
        if check_every < 0:
            raise ValueError("check_every must be >= 0")
        self.policy = policy
        self.tol = tol
        self.rel_tol = rel_tol
        self.check_every = check_every
        self.metrics = metrics
        self.history: List[dict] = []      # every observe() reading
        self.violations: List[dict] = []
        self._prev: Optional[float] = None
        self._prev_armed = False

    def should_check(self, step: int) -> bool:
        """Whether the engines should pay for a bound read at ``step``
        (a 1-based update counter)."""
        return self.check_every > 0 and step % self.check_every == 0

    def observe(self, bound: float, *, step: Optional[int] = None,
                armed: bool = True) -> bool:
        """Record one bound reading; returns True iff it violated.

        ``armed=False`` readings are recorded (they are the convergence
        trace for the non-guaranteed engines) but never enforced.
        """
        bound = float(bound)
        delta = None if self._prev is None else bound - self._prev
        reading = {"step": step, "bound": bound, "delta": delta,
                   "armed": bool(armed)}
        self.history.append(reading)
        violated = False
        if (armed and self._prev_armed and delta is not None
                and not math.isnan(bound)):
            slack = max(self.tol, self.rel_tol * abs(self._prev))
            if delta < -slack:
                violated = True
                self.violations.append(reading)
                if self.metrics is not None:
                    self.metrics.inc("watchdog.violations")
                msg = (f"IVI memoized ELBO decreased: {self._prev:.6f} -> "
                       f"{bound:.6f} (delta={delta:.3e}, slack={slack:.3e}"
                       f"{'' if step is None else f', update {step}'}) — "
                       "the eq. 4 monotonicity guarantee is broken "
                       "(memo out of sync, wire-dtype drift, or a "
                       "degenerate E-step)")
                if self.policy == "raise":
                    self._prev, self._prev_armed = bound, bool(armed)
                    raise BoundMonotonicityError(msg)
                warnings.warn(msg, ElboMonotonicityWarning, stacklevel=2)
        self._prev, self._prev_armed = bound, bool(armed)
        return violated

    # -- introspection ---------------------------------------------------
    @property
    def last_bound(self) -> Optional[float]:
        return self._prev

    def bound_tail(self, n: int = 5) -> List[float]:
        """The last ``n`` observed bounds (oldest first)."""
        return [r["bound"] for r in self.history[-n:]]

    def status(self) -> dict:
        armed_deltas = [r["delta"] for r in self.history
                        if r["armed"] and r["delta"] is not None]
        return {
            "enabled": True,
            "policy": self.policy,
            "checks": len(self.history),
            "armed_checks": sum(1 for r in self.history if r["armed"]),
            "violations": len(self.violations),
            "last_bound": self._prev,
            "min_armed_delta": (min(armed_deltas) if armed_deltas
                                else None),
            "ok": not self.violations,
        }
