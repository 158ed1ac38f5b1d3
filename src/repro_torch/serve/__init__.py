"""repro_torch.serve — the online serving service on the card.

The port's counterpart of ``repro.serve``: an open request stream served
under latency SLOs while the paper's incremental update trains on the
served traffic in the background.

* `repro_torch.serve.traffic` — seeded Poisson / bursty ON-OFF / replay
  arrival schedules;
* `repro_torch.serve.admission` — deadline- and size-aware batch
  formation over the ``BatchPacker`` (shedding, timeout-based partial
  flush);
* `repro_torch.serve.service` — the real-time serving loop and SLO
  reporting (the ``repro.serve.slo/v1`` schema, shared with ``repro``);
* `repro_torch.serve.snapshot` — atomic versioned λ publication with a
  measured swap-stall window;
* `repro_torch.serve.online` — the background IVI learner feeding it, on
  a CUDA stream of its own.

``docs/serving.md`` describes the design; ``python -m
repro_torch.launch.serve_lda`` drives it.
"""
from repro_torch.serve.admission import AdmissionController, Request, Response
from repro_torch.serve.online import OnlineLearner
from repro_torch.serve.service import (
    SLO_SCHEMA,
    ServiceConfig,
    ServingService,
    validate_slo_report,
)
from repro_torch.serve.snapshot import ModelSnapshot, SnapshotStore
from repro_torch.serve.traffic import (
    onoff_arrivals,
    poisson_arrivals,
    replay_arrivals,
    requests_from_docs,
)

__all__ = [
    "Request", "Response", "AdmissionController",
    "ServiceConfig", "ServingService", "SLO_SCHEMA", "validate_slo_report",
    "ModelSnapshot", "SnapshotStore", "OnlineLearner",
    "poisson_arrivals", "onoff_arrivals", "replay_arrivals",
    "requests_from_docs",
]
