"""Admission control: deadline- and size-aware batch formation.

The port's counterpart of ``repro.serve.admission``, host code over the
port's ``BatchPacker``. The serving loop cannot hand single documents to
the card (the E-step's throughput comes from batching), and an open
request stream never arrives ``batch_size`` at a time. The admission
controller is the policy in between:

* **size-aware formation**: admitted requests file into a
  ``repro_torch.data.stream.BatchPacker`` built from the serving
  inferencer's own ``packer_kwargs()``: the same width ladder or CSR
  token budget the offline path uses, so a batch formed here is the batch
  ``posterior_docs`` would have packed from the same document sequence,
  bit for bit. A bucket that reaches ``batch_size`` emits at once;
* **deadline-aware shedding**: a request whose remaining budget is
  already inside ``shed_margin_s`` at offer time is refused outright;
* **timeout-based partial flush**: ``poll(now)`` emits every open bucket
  once the oldest pending request has waited ``flush_timeout_s``, or once
  any pending deadline is within ``deadline_headroom_s``.

Every method takes an explicit ``now`` (seconds on the caller's clock):
the controller owns no clock, which keeps its edge cases deterministic to
test. The service layer (`repro_torch.serve.service`) drives it in real
time.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.data.stream import BatchPacker


@dataclasses.dataclass
class Request:
    """One inference request: a ragged document with an arrival time and
    an absolute deadline (both in seconds on the schedule clock)."""

    rid: int
    ids: np.ndarray                 # (n,) int32 unique token ids
    cnts: np.ndarray                # (n,) float32 counts
    arrival_s: float = 0.0
    deadline_s: float = math.inf


@dataclasses.dataclass
class Response:
    """The service's answer to one request.

    ``status`` is ``"ok"`` (γ on the host, ``model_version`` names the
    snapshot that served it) or ``"shed"`` (refused at admission; γ and
    version are None). ``latency_s`` is completion − scheduled arrival:
    open-loop latency, queueing included.
    """

    rid: int
    status: str
    gamma: Optional[np.ndarray]
    model_version: Optional[int]
    arrival_s: float
    done_s: float

    @property
    def latency_s(self) -> float:
        return self.done_s - self.arrival_s

    @property
    def ok(self) -> bool:
        return self.status == "ok"


class AdmissionController:
    """Deadline- and size-aware batch formation (see module docstring).

    Args:
      packer_kwargs: ``TopicInferencer.packer_kwargs()``: batch size,
        vocabulary, layout and token budget of the serving path. The ladder
        is open-ended (``max_width=None``), as serving's own packer.
      flush_timeout_s: the longest the oldest pending request may wait
        before every open bucket flushes.
      shed_margin_s: refuse a request whose ``deadline_s − now`` is at most
        this margin at offer time (0 = shed only the already expired).
      deadline_headroom_s: flush open buckets early when any pending
        deadline is within this headroom.
      metrics: optional ``MetricsRegistry`` (``admit.*`` counters and the
        queue-wait histogram).
    """

    def __init__(self, packer_kwargs: Dict[str, object], *,
                 flush_timeout_s: float = 0.05,
                 shed_margin_s: float = 0.0,
                 deadline_headroom_s: float = 0.0,
                 metrics=None):
        if flush_timeout_s < 0:
            raise ValueError("flush_timeout_s must be >= 0")
        self.packer = BatchPacker(packer_kwargs["batch_size"],
                                  vocab_size=packer_kwargs.get("vocab_size"),
                                  layout=packer_kwargs.get("layout", "padded"),
                                  token_budget=packer_kwargs.get(
                                      "token_budget"),
                                  metrics=metrics)
        self.flush_timeout_s = flush_timeout_s
        self.shed_margin_s = shed_margin_s
        self.deadline_headroom_s = deadline_headroom_s
        self.metrics = metrics
        self._pos = 0                                   # packer positions
        # pos → (request, admit time); insertion order = admit order
        self._pending: Dict[int, Tuple[Request, float]] = {}
        self.shed: List[Request] = []
        self.offered = 0

    # -- intake ----------------------------------------------------------
    def offer(self, req: Request, now: float):
        """Admit or shed one request at time ``now``.

        Returns ``(admitted, batch)``: ``admitted`` False means the request
        was shed (recorded in ``self.shed``); ``batch`` is the
        ``PackedBatch``/``CSRBatch`` this admission completed, or None.
        """
        self.offered += 1
        if req.deadline_s - now <= self.shed_margin_s:
            self.shed.append(req)
            if self.metrics is not None:
                self.metrics.inc("admit.shed")
            return False, None
        pos = self._pos
        self._pos += 1
        self._pending[pos] = (req, now)
        if self.metrics is not None:
            self.metrics.inc("admit.admitted")
        batch = self.packer.add(pos, req.ids, req.cnts)
        return True, batch

    def take(self, rows: np.ndarray, now: float) -> List[Request]:
        """Pop the requests of an emitted batch, in row order: the service
        maps γ rows back to requests through this."""
        out = []
        for pos in np.asarray(rows, np.int64):
            req, admit_t = self._pending.pop(int(pos))
            if self.metrics is not None:
                self.metrics.observe("admit.queue_wait_ms",
                                     (now - admit_t) * 1e3)
            out.append(req)
        return out

    # -- flush policy ----------------------------------------------------
    def _oldest_admit(self) -> Optional[float]:
        for _, (_, t) in self._pending.items():
            return t
        return None

    def _min_deadline(self) -> float:
        return min((r.deadline_s for r, _ in self._pending.values()),
                   default=math.inf)

    def poll(self, now: float) -> List:
        """Emit every open bucket if a flush trigger is due at ``now``; an
        empty window (nothing pending) never flushes."""
        if not self._pending:
            return []
        oldest = self._oldest_admit()
        due = (now - oldest >= self.flush_timeout_s
               or self._min_deadline() - now <= self.deadline_headroom_s)
        if not due:
            return []
        batches = self.packer.flush()
        if batches and self.metrics is not None:
            self.metrics.inc("admit.partial_flushes", len(batches))
        return batches

    def next_due(self, now: float) -> Optional[float]:
        """The earliest future time a flush trigger fires (None when nothing
        is pending): the service's sleep horizon."""
        if not self._pending:
            return None
        t = self._oldest_admit() + self.flush_timeout_s
        dl = self._min_deadline()
        if dl < math.inf:
            t = min(t, dl - self.deadline_headroom_s)
        return max(t, now)

    def close(self, now: float) -> List:
        """Final flush: emit everything still open (stream end)."""
        del now
        return self.packer.flush()

    # -- introspection ---------------------------------------------------
    @property
    def pending(self) -> int:
        return len(self._pending)
