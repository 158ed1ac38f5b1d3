"""repro_torch.obs — structured run telemetry for the IVI/LDA engines.

The port's copy of ``repro.obs`` (Python, numpy and torch's profiler
hooks; nothing here imports ``repro``). One ``Telemetry`` bundle carries
the three observers every instrumented layer shares:

* ``trace`` — a :class:`~repro_torch.obs.trace.SpanRecorder` (nested spans
  + instant events, JSONL export, Chrome-trace conversion);
* ``metrics`` — a :class:`~repro_torch.obs.metrics.MetricsRegistry`
  (labelled counters / gauges / histograms);
* ``watchdog`` — an :class:`~repro_torch.obs.watchdog.ElboWatchdog`
  (the paper's monotone-memoized-ELBO invariant, enforced at runtime
  on the IVI path).

The disabled state is the **null-object** ``NULL_TELEMETRY`` singleton:
all three components are module-level null objects whose methods are
no-ops, and ``enabled`` is False so hot paths pay exactly one attribute
check + branch (``if tel.enabled: ...``) and allocate nothing. With
telemetry off an engine update launches, syncs and allocates exactly what
it does without the hooks, so its bits are unchanged.

Spans have a second reader: a ``torch.profiler`` (`obs/trace.py`). The
layers open their spans when ``tel.spans_on`` holds, telemetry on or a
profiler recording (one flag read where a layer is entered); with
telemetry off the spans reach the profiler's trace alone.

``as_telemetry`` is the facade-level coercion::

    as_telemetry(None)       -> NULL_TELEMETRY       (default: off)
    as_telemetry(False)      -> NULL_TELEMETRY
    as_telemetry(True)       -> Telemetry(...)        full live bundle
    as_telemetry(bundle)     -> bundle                (pass-through)

so ``telemetry=True`` turns everything on with defaults while power users
hand in a pre-configured bundle (e.g. a ``raise``-policy watchdog, or a
``device_sync=True`` recorder whose spans wait for the card).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .metrics import NULL_METRICS, MetricsRegistry, NullMetrics
from .roofline import spans_by_name
from .trace import (
    NULL_TRACE,
    NullSpanRecorder,
    SpanRecorder,
    chrome_trace_from_jsonl,
    load_jsonl,
    profiling,
    to_chrome_trace,
    validate_jsonl,
    validate_records,
)
from .watchdog import (
    NULL_WATCHDOG,
    BoundMonotonicityError,
    ElboMonotonicityWarning,
    ElboWatchdog,
    NullElboWatchdog,
)

__all__ = [
    "Telemetry", "NULL_TELEMETRY", "as_telemetry",
    "SpanRecorder", "NullSpanRecorder", "NULL_TRACE",
    "load_jsonl", "validate_records", "validate_jsonl",
    "to_chrome_trace", "chrome_trace_from_jsonl",
    "MetricsRegistry", "NullMetrics", "NULL_METRICS",
    "ElboWatchdog", "NullElboWatchdog", "NULL_WATCHDOG",
    "BoundMonotonicityError", "ElboMonotonicityWarning",
    "spans_by_name",
]


@dataclass
class Telemetry:
    """The bundle an instrumented layer receives (see module docstring).

    ``enabled`` is the hot-path gate: instrumentation must branch on it
    once and do nothing when False. The live constructor wires the
    watchdog's violation counter into the bundled registry when both are
    live and the watchdog wasn't given its own.
    """

    trace: object = field(default_factory=SpanRecorder)
    metrics: object = field(default_factory=MetricsRegistry)
    # check_every=0: the default watchdog only observes bounds that are
    # computed anyway (evaluate()) — a per-update check is an O(corpus)
    # memoized-bound read, which the caller must opt into explicitly
    # (ElboWatchdog(check_every=1), the paper-faithful cadence)
    watchdog: object = field(
        default_factory=lambda: ElboWatchdog(check_every=0))
    enabled: bool = True

    def __post_init__(self):
        wd = self.watchdog
        if (getattr(wd, "enabled", False)
                and getattr(wd, "metrics", None) is None
                and getattr(self.metrics, "enabled", False)):
            wd.metrics = self.metrics

    @property
    def spans_on(self) -> bool:
        """Whether instrumented code opens its spans: telemetry on, or a
        torch profiler recording (the spans then reach its trace alone)."""
        return self.enabled or profiling()

    def summary(self) -> dict:
        """A JSON-able roll-up: metrics snapshot + watchdog status +
        trace size — what ``examples/quickstart.py`` prints."""
        return {
            "metrics": self.metrics.snapshot(),
            "watchdog": self.watchdog.status(),
            "trace_records": getattr(self.trace, "num_records", 0),
        }


NULL_TELEMETRY = Telemetry(trace=NULL_TRACE, metrics=NULL_METRICS,
                           watchdog=NULL_WATCHDOG, enabled=False)


def as_telemetry(t) -> Telemetry:
    """Coerce a user-facing ``telemetry=`` argument to a bundle."""
    if t is None or t is False:
        return NULL_TELEMETRY
    if t is True:
        return Telemetry()
    if isinstance(t, Telemetry):
        return t
    raise TypeError(
        "telemetry must be None/False (off), True (defaults), or a "
        f"repro_torch.obs.Telemetry bundle, got {type(t).__name__}")
