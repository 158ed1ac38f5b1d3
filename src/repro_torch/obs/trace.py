"""Span/event tracing: a low-overhead structured run recorder.

``SpanRecorder`` captures nested wall-clock spans and point events from
any thread of the process (the training host loop, or any other driver)
into an in-memory buffer of plain dicts:

* **spans** — ``begin(name, **attrs)`` / ``end(token)`` around a phase of
  work, or the ``with recorder.span(name):`` context-manager sugar.
  Nesting is tracked per thread (``depth``), so a trace viewer can
  reconstruct the call tree without parent ids.
* **device sync points** — CUDA launches return before the card is done,
  so a span that closes right after a launch has measured *dispatch*, not
  compute. ``end(token, sync=t)`` calls ``torch.cuda.synchronize(t.device)``
  before taking the end timestamp **iff** the recorder was built with
  ``device_sync=True`` and ``t`` is a CUDA tensor (a CPU tensor needs no
  sync); the default leaves the pipeline asynchronous.
* **events** — ``event(name, **attrs)``: zero-duration markers.

Export is JSONL (one record per line, ``dump_jsonl``; schema below) plus
a converter to the Chrome trace-event format, loadable in
``chrome://tracing`` / Perfetto (``to_chrome_trace`` /
``chrome_trace_from_jsonl``).

JSONL schema (``TRACE_SCHEMA``, guarded by ``validate_records``):

    {"type": "meta", "schema": "repro.obs.trace", "version": 1,
     "unix_time": <float>, "device_sync": <bool>}          # first line
    {"type": "span", "name": str, "ts_us": float, "dur_us": float,
     "tid": int, "depth": int, "attrs": {...}}
    {"type": "event", "name": str, "ts_us": float, "tid": int,
     "attrs": {...}}

Timestamps are microseconds relative to the recorder's construction
(``perf_counter_ns`` based — monotonic, immune to wall-clock steps). That
clock is the recorder's own: the JSONL is an operator's record of where
the host's time went, not a timeline shared with the card.

**The profiler's clock.** While a ``torch.profiler`` is recording
(``profiling()``), every span also opens a ``record_function`` range of
the same name, entered in ``begin`` and exited in ``end`` (the range rides
in the token). The profiler's trace, not the JSONL, is the timeline on
which the spans sit beside the device's operations: its host events of
the spans' names carry them (category ``cpu_op``), nested as the spans
nest. The instrumented layers open their spans when
``Telemetry.spans_on`` holds (telemetry on, or a profiler recording), and
touch counters, gauges and the watchdog only when telemetry is on, so a
profiler-only run launches, syncs and allocates on the device exactly
what an untraced run does.

The module-level ``NULL_TRACE`` is the disabled recorder: it records
nothing, ``span()`` returns one shared context-manager singleton, and
with no profiler recording ``begin`` returns None and nothing is
allocated — the single-branch null object the instrumented hot paths
check against. Under a profiler its ``begin``/``end`` enter and exit the
range alone.

The schema name is ``repro``'s, so a trace from either package validates
with either validator.

CLI: ``python -m repro_torch.obs.trace --validate run.jsonl [--chrome
out.json]`` validates a trace file against the schema (and optionally
writes the Chrome conversion), exiting non-zero on a malformed file.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

TRACE_SCHEMA = "repro.obs.trace"
TRACE_SCHEMA_VERSION = 1

# (name, attrs, depth, start_ns, the profiler range or None) — what
# ``begin`` hands to ``end``
SpanToken = Tuple[str, dict, int, int, object]


def profiling() -> bool:
    """Whether a torch profiler is recording in this process (one read of
    the flag the profiler sets on entry and clears on exit)."""
    return _autograd_profiler._is_profiler_enabled


def _range_enter(name: str):
    """A ``record_function`` range named ``name``, entered, while a
    profiler records, else None. ``_RecordFunctionFast`` enters it from
    C++; the ``torch.ops.profiler._record_function_enter_new``/``_exit``
    pair goes through the dispatcher at an order of magnitude more a range
    (PERF.md), which the traced window would count as idle time."""
    if not profiling():
        return None
    rf = _RecordFunctionFast(name)
    rf.__enter__()
    return rf


def _range_exit(rf) -> None:
    if rf is not None:
        rf.__exit__(None, None, None)


class _NullSpan:
    """Shared no-op context manager (one instance for the whole process)."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


class NullSpanRecorder:
    """The disabled recorder: it records nothing.

    ``span()`` hands back the process-wide ``NULL_SPAN`` singleton. With no
    profiler recording ``begin()`` returns ``None``, so the
    instrumentation pattern ``tok = tel.trace.begin(...) if tel.spans_on
    else None`` allocates nothing at all on the disabled path; under a
    profiler ``begin`` returns the entered range and ``end`` exits it.
    """

    enabled = False
    device_sync = False

    def span(self, name: str, **attrs) -> _NullSpan:
        return NULL_SPAN

    def begin(self, name: str, **attrs):
        return _range_enter(name)

    def end(self, token, sync=None) -> None:
        _range_exit(token)

    def event(self, name: str, **attrs) -> None:
        pass

    @property
    def num_records(self) -> int:
        return 0

    @property
    def records(self) -> List[dict]:
        return []


NULL_TRACE = NullSpanRecorder()


class _Span:
    """Context-manager wrapper over a live recorder's begin/end pair."""

    __slots__ = ("_rec", "_token", "_sync")

    def __init__(self, rec: "SpanRecorder", token: SpanToken):
        self._rec = rec
        self._token = token
        self._sync = None

    def sync_on(self, arr):
        """Mark ``arr`` as this span's device sync point (see module
        docstring); returns ``arr`` so the call can wrap an expression."""
        self._sync = arr
        return arr

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, *exc) -> bool:
        self._rec.end(self._token, sync=self._sync)
        return False


class SpanRecorder:
    """In-memory span/event recorder (see module docstring).

    Thread safety: records append to one list (atomic under the GIL);
    per-thread nesting depth lives in a ``threading.local``; thread ids
    are mapped to dense small ints under a lock on first sight.
    """

    enabled = True

    def __init__(self, *, device_sync: bool = False):
        self.device_sync = device_sync
        self._t0 = time.perf_counter_ns()
        self._unix0 = time.time()
        self._records: List[dict] = []
        self._tls = threading.local()
        self._tids: Dict[int, int] = {}
        self._lock = threading.Lock()

    # -- recording -------------------------------------------------------
    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def begin(self, name: str, **attrs) -> SpanToken:
        """Open a span (and its profiler range while a profiler records);
        pass the returned token to ``end``."""
        depth = getattr(self._tls, "depth", 0)
        self._tls.depth = depth + 1
        return (name, attrs, depth, time.perf_counter_ns(),
                _range_enter(name))

    def end(self, token: SpanToken, sync=None) -> None:
        """Close a span. With ``device_sync`` and a CUDA tensor ``sync``,
        waits for that tensor's device before timestamping (a CPU tensor
        needs no wait)."""
        if (sync is not None and self.device_sync
                and sync.device.type == "cuda"):
            import torch

            torch.cuda.synchronize(sync.device)
        t1 = time.perf_counter_ns()
        name, attrs, depth, t0, rf = token
        _range_exit(rf)
        self._tls.depth = depth
        self._records.append({
            "type": "span", "name": name,
            "ts_us": (t0 - self._t0) / 1e3,
            "dur_us": (t1 - t0) / 1e3,
            "tid": self._tid(), "depth": depth, "attrs": attrs,
        })

    def span(self, name: str, **attrs) -> _Span:
        """``with recorder.span("phase"): ...`` sugar over begin/end."""
        return _Span(self, self.begin(name, **attrs))

    def event(self, name: str, **attrs) -> None:
        """A zero-duration point marker."""
        self._records.append({
            "type": "event", "name": name,
            "ts_us": (time.perf_counter_ns() - self._t0) / 1e3,
            "tid": self._tid(), "attrs": attrs,
        })

    # -- introspection / export ------------------------------------------
    @property
    def num_records(self) -> int:
        return len(self._records)

    @property
    def records(self) -> List[dict]:
        return self._records

    def meta(self) -> dict:
        return {"type": "meta", "schema": TRACE_SCHEMA,
                "version": TRACE_SCHEMA_VERSION,
                "unix_time": self._unix0, "device_sync": self.device_sync}

    def dump_jsonl(self, path: str) -> int:
        """Write the meta header + every record as JSONL; returns the
        record count (excluding the header)."""
        records = list(self._records)      # snapshot: threads may append
        with open(path, "w") as f:
            f.write(json.dumps(self.meta()) + "\n")
            for r in records:
                f.write(json.dumps(r) + "\n")
        return len(records)


# ---------------------------------------------------------------------------
# JSONL load / schema validation
# ---------------------------------------------------------------------------

def load_jsonl(path: str) -> Tuple[dict, List[dict]]:
    """Read a trace file → (meta header, records)."""
    with open(path) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    if not lines or lines[0].get("type") != "meta":
        raise ValueError(f"{path!r}: first line is not a trace meta header")
    return lines[0], lines[1:]


_SPAN_KEYS = {"type": str, "name": str, "ts_us": (int, float),
              "dur_us": (int, float), "tid": int, "depth": int,
              "attrs": dict}
_EVENT_KEYS = {"type": str, "name": str, "ts_us": (int, float), "tid": int,
               "attrs": dict}


def validate_records(meta: dict, records: Iterable[dict]) -> int:
    """Schema-check a loaded trace; returns the record count or raises
    ``ValueError`` naming the first offending record."""
    if meta.get("schema") != TRACE_SCHEMA:
        raise ValueError(f"unknown trace schema {meta.get('schema')!r}")
    if meta.get("version") != TRACE_SCHEMA_VERSION:
        raise ValueError(f"unsupported trace schema version "
                         f"{meta.get('version')!r}")
    n = 0
    for i, r in enumerate(records):
        kind = r.get("type")
        keys = {"span": _SPAN_KEYS, "event": _EVENT_KEYS}.get(kind)
        if keys is None:
            raise ValueError(f"record {i}: unknown type {kind!r}")
        for key, typ in keys.items():
            if key not in r:
                raise ValueError(f"record {i} ({kind}): missing {key!r}")
            if not isinstance(r[key], typ):
                raise ValueError(
                    f"record {i} ({kind}): {key}={r[key]!r} is not "
                    f"{typ}")
        if kind == "span" and r["dur_us"] < 0:
            raise ValueError(f"record {i}: negative span duration")
        n += 1
    return n


def validate_jsonl(path: str) -> int:
    """Load + schema-check a trace file; returns the record count."""
    meta, records = load_jsonl(path)
    return validate_records(meta, records)


# ---------------------------------------------------------------------------
# Chrome trace-event conversion (chrome://tracing / Perfetto)
# ---------------------------------------------------------------------------

def to_chrome_trace(records: Iterable[dict],
                    meta: Optional[dict] = None) -> dict:
    """Records → the Chrome trace-event JSON object.

    Spans become complete ("X") events, point events become instants
    ("i"); timestamps are already microseconds, the unit Chrome expects.
    One trace record maps to exactly one ``traceEvents`` entry, so the
    JSONL → Chrome conversion round-trips count-exactly (the CI check).
    """
    events = []
    for r in records:
        if r["type"] == "span":
            events.append({"name": r["name"], "ph": "X", "ts": r["ts_us"],
                           "dur": r["dur_us"], "pid": 0, "tid": r["tid"],
                           "args": dict(r["attrs"], depth=r["depth"])})
        elif r["type"] == "event":
            events.append({"name": r["name"], "ph": "i", "s": "t",
                           "ts": r["ts_us"], "pid": 0, "tid": r["tid"],
                           "args": r["attrs"]})
        else:
            raise ValueError(f"unknown record type {r['type']!r}")
    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    if meta is not None:
        out["otherData"] = {k: meta[k] for k in ("schema", "version",
                                                 "unix_time", "device_sync")
                            if k in meta}
    return out


def chrome_trace_from_jsonl(src: str, dst: str) -> int:
    """Convert a trace JSONL file to a Chrome trace JSON file; returns
    the event count (== the JSONL record count)."""
    meta, records = load_jsonl(src)
    validate_records(meta, records)
    chrome = to_chrome_trace(records, meta)
    with open(dst, "w") as f:
        json.dump(chrome, f)
    return len(chrome["traceEvents"])


def _main() -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="validate a repro_torch.obs trace JSONL file "
                    "(and optionally convert it to Chrome trace format)")
    ap.add_argument("--validate", required=True, metavar="TRACE_JSONL")
    ap.add_argument("--chrome", default=None, metavar="OUT_JSON",
                    help="also write the chrome://tracing conversion here")
    args = ap.parse_args()
    try:
        n = validate_jsonl(args.validate)
    except (ValueError, OSError) as e:
        print(f"[FAIL] {args.validate}: {e}")
        return 1
    print(f"[OK ] {args.validate}: {n} records, schema "
          f"{TRACE_SCHEMA} v{TRACE_SCHEMA_VERSION}")
    if args.chrome:
        m = chrome_trace_from_jsonl(args.validate, args.chrome)
        if m != n:
            print(f"[FAIL] chrome conversion dropped records "
                  f"({m} events != {n} records)")
            return 1
        print(f"[OK ] {args.chrome}: {m} trace events "
              f"(count-exact round-trip)")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
