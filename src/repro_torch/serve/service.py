"""The serving loop: an open request stream under latency SLOs.

The port's counterpart of ``repro.serve.service``. ``ServingService``
drives one serving replica end to end:

    requests ──► admission control ──► BatchPacker batches ──► E-step
                  (shed / file / flush)   (`repro_torch.serve.admission`)
                                                 │
                          OnlineLearner ◄── served documents
                          (background passes, publishes λ through
                           an atomic snapshot swap: `online.py`)

The loop is open-loop real time: requests carry scheduled arrival times
(`repro_torch.serve.traffic`), the service sleeps until the next arrival
or the next admission-flush horizon, whichever is earlier, and a
response's latency is completion − scheduled arrival, queueing included.
Each batch runs through ``TopicInferencer.posterior_packed`` (one launch
on the card) on the caller's current stream, the serving stream; the
service then waits for that stream, its one host sync for the batch's
completion time, and copies γ[:n] to the host once. The latency histogram
measures device completion, not dispatch.

Every OK response records the ``model_version`` of the snapshot that
served it; under an ``OnlineLearner`` the version advances mid-stream
while in-flight batches complete on the snapshot they started with.

``slo_report`` summarises a run against the config's SLO targets in a
schema-versioned record, ``repro.serve.slo/v1``: the same data format as
``repro``'s, so each package's ``validate_slo_report`` accepts the other's
report.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.obs import MetricsRegistry, as_telemetry
from repro_torch.serve.admission import AdmissionController, Request, Response

SLO_SCHEMA = "repro.serve.slo/v1"


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Serving-loop policy knobs.

    ``slo_ms`` maps percentile names (``"p50"``/``"p95"``/``"p99"``) to
    latency targets in ms; targets are reported against (SLO attainment in
    ``slo_report``), never enforced in the loop.
    """

    flush_timeout_s: float = 0.05
    shed_margin_s: float = 0.0
    deadline_headroom_s: float = 0.0
    slo_ms: Optional[Dict[str, float]] = None


class ServingService:
    """One serving replica over an open request stream (see module doc).

    Args:
      inferencer: the snapshot-aware ``TopicInferencer`` to serve with;
        batch formation copies its ``packer_kwargs()``, so served batches
        are bit-equal to ``posterior_docs`` on the same admitted sequence.
      config: a ``ServiceConfig``.
      learner: optional ``repro_torch.serve.online.OnlineLearner``: every
        served document is fed to it (a host-side append; training and
        publication run on the learner's own cadence, thread and stream).
      telemetry: `repro_torch.obs` bundle. The service always keeps a
        metrics registry (latency accounting is the product here): the
        bundle's when enabled, a private one otherwise.
      clock/sleep: injectable time sources (tests).
    """

    def __init__(self, inferencer, *, config: Optional[ServiceConfig] = None,
                 learner=None, telemetry=None,
                 clock: Callable[[], float] = time.perf_counter,
                 sleep: Callable[[float], None] = time.sleep):
        self.inf = inferencer
        self.config = config or ServiceConfig()
        self.learner = learner
        self.tel = as_telemetry(telemetry)
        self.metrics = (self.tel.metrics if self.tel.enabled
                        else MetricsRegistry())
        self._clock, self._sleep = clock, sleep
        self.admission = AdmissionController(
            inferencer.packer_kwargs(),
            flush_timeout_s=self.config.flush_timeout_s,
            shed_margin_s=self.config.shed_margin_s,
            deadline_headroom_s=self.config.deadline_headroom_s,
            metrics=self.metrics)
        self.responses: List[Response] = []
        self._t0: Optional[float] = None
        self._last_done = 0.0

    # -- the loop --------------------------------------------------------
    def _now(self) -> float:
        return self._clock() - self._t0

    def run(self, requests: Sequence[Request]) -> List[Response]:
        """Serve a scheduled request stream to completion.

        ``requests`` must be sorted by ``arrival_s`` (the traffic
        generators emit them sorted). The call blocks for the schedule's
        real duration; at stream end every open bucket is flushed and
        served. Returns the responses in completion order; they accumulate
        on ``self.responses`` across runs.
        """
        if self._t0 is None:
            self._t0 = self._clock()
        out_start = len(self.responses)
        for req in requests:
            # sleep toward the arrival, waking for due partial flushes
            while True:
                now = self._now()
                if now >= req.arrival_s:
                    break
                due = self.admission.next_due(now)
                if due is not None and due < req.arrival_s:
                    if due > now:
                        self._sleep(due - now)
                    self._poll_flushes()
                else:
                    self._sleep(req.arrival_s - now)
            now = self._now()
            admitted, batch = self.admission.offer(req, now)
            if not admitted:
                self.responses.append(Response(
                    rid=req.rid, status="shed", gamma=None,
                    model_version=None, arrival_s=req.arrival_s,
                    done_s=now))
                self.metrics.inc("serve.shed")
            if batch is not None:
                self._serve_batch(batch)
            self._poll_flushes()
        for batch in self.admission.close(self._now()):
            self._serve_batch(batch)
        return self.responses[out_start:]

    def _poll_flushes(self) -> None:
        for batch in self.admission.poll(self._now()):
            self._serve_batch(batch)

    def _serve_batch(self, batch) -> None:
        tel = self.tel
        reqs = self.admission.take(batch.rows, self._now())
        sp = tel.trace.begin("serve/request_batch",
                             docs=len(reqs)) if tel.enabled else None
        _, gamma, n, version = self.inf.posterior_packed(batch)
        if gamma.is_cuda:
            # the serving stream's completion: the batch's one wait
            torch.cuda.current_stream(gamma.device).synchronize()
        if sp is not None:
            tel.trace.end(sp)
        done = self._now()
        self._last_done = max(self._last_done, done)
        g = gamma[:n].cpu().numpy()
        for i, req in enumerate(reqs):
            self.responses.append(Response(
                rid=req.rid, status="ok", gamma=g[i],
                model_version=version, arrival_s=req.arrival_s,
                done_s=done))
            self.metrics.observe("serve.latency_ms",
                                 (done - req.arrival_s) * 1e3)
        self.metrics.inc("serve.batches")
        self.metrics.inc("serve.docs", len(reqs))
        if self.learner is not None:
            self.learner.observe([(r.ids, r.cnts) for r in reqs])

    # -- reporting -------------------------------------------------------
    def slo_report(self) -> dict:
        """The run summary: counts, latency percentiles, throughput,
        model-version coverage, SLO attainment (``repro.serve.slo/v1``)."""
        ok = [r for r in self.responses if r.ok]
        shed = [r for r in self.responses if r.status == "shed"]
        pct = self.metrics.percentiles("serve.latency_ms",
                                       ps=(50, 95, 99))
        lat = self.metrics.histogram_values("serve.latency_ms")
        wall = max(self._last_done, 1e-9)
        versions = sorted({r.model_version for r in ok})
        report = {
            "schema": SLO_SCHEMA,
            "offered": self.admission.offered,
            "served": len(ok),
            "shed": len(shed),
            "pending": self.admission.pending,
            "conservation_ok": (self.admission.offered
                                == len(ok) + len(shed)
                                + self.admission.pending),
            "latency_ms": {"p50": pct["p50"], "p95": pct["p95"],
                           "p99": pct["p99"],
                           "max": max(lat) if lat else float("nan")},
            "throughput_docs_s": len(ok) / wall,
            "wall_s": wall,
            "model_versions": versions,
            "every_response_versioned": all(
                r.model_version is not None for r in ok),
            "slo": {},
        }
        if self.config.slo_ms:
            for name, target in sorted(self.config.slo_ms.items()):
                got = report["latency_ms"].get(name, float("nan"))
                report["slo"][name] = {
                    "target_ms": float(target), "observed_ms": got,
                    "attained": bool(got <= target) if not math.isnan(got)
                    else False,
                }
        return report


def validate_slo_report(report: dict) -> dict:
    """Schema gate for ``slo_report`` output: raises ``ValueError`` on any
    shape violation, returns the report."""
    if not isinstance(report, dict):
        raise ValueError("SLO report must be a dict")
    if report.get("schema") != SLO_SCHEMA:
        raise ValueError(f"unknown SLO report schema "
                         f"{report.get('schema')!r} (want {SLO_SCHEMA})")
    for key, typ in (("offered", int), ("served", int), ("shed", int),
                     ("pending", int), ("conservation_ok", bool),
                     ("latency_ms", dict), ("throughput_docs_s", float),
                     ("wall_s", float), ("model_versions", list),
                     ("every_response_versioned", bool), ("slo", dict)):
        if key not in report:
            raise ValueError(f"SLO report missing {key!r}")
        if not isinstance(report[key], typ):
            raise ValueError(f"SLO report field {key!r} must be "
                             f"{typ.__name__}, got "
                             f"{type(report[key]).__name__}")
    for p in ("p50", "p95", "p99", "max"):
        if p not in report["latency_ms"]:
            raise ValueError(f"latency_ms missing {p!r}")
        v = report["latency_ms"][p]
        if not isinstance(v, float) or (not math.isnan(v) and v < 0):
            raise ValueError(f"latency_ms[{p!r}] must be a non-negative "
                             f"float or NaN, got {v!r}")
    if not report["conservation_ok"]:
        raise ValueError(
            f"request conservation violated: offered={report['offered']} "
            f"!= served={report['served']} + shed={report['shed']} + "
            f"pending={report['pending']}")
    for name, slo in report["slo"].items():
        for k in ("target_ms", "observed_ms", "attained"):
            if k not in slo:
                raise ValueError(f"slo[{name!r}] missing {k!r}")
    return report
