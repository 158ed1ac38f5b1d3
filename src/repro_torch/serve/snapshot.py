"""Versioned model snapshots: the publish side of online serving.

The port's counterpart of ``repro.serve.snapshot``. ``TopicInferencer``
holds its topics as one atomic ``(version, Eφ)`` tuple
(`repro_torch.lda.infer.TopicInferencer.swap_model`); this module is the
publisher the online learner drives:

* ``ModelSnapshot`` is the immutable record of one publication (version,
  its Eφ, how many documents trained it, when it went live);
* ``SnapshotStore`` does the expensive part of a swap, λ → exp(E[ln φ]) on
  the device, before the swap window opens, then publishes to every
  attached inferencer with one ``swap_model`` call each and measures the
  swap stall (the time a concurrent request could contend on): the
  ``serve.swap_stall_ms`` histogram.

**Streams.** The publisher computes Eφ on its own current stream (the
online learner's stream of its own) and waits for that stream before the
swap window opens, as ``repro`` waits with ``block_until_ready``: a
serving batch on another stream that reads the new snapshot reads a
finished tensor. The serving side keeps the snapshot's memory alive for
its in-flight kernel (``record_stream`` in ``TopicInferencer``).

The store is thread-safe: one learner publishing while any number of
serving threads read is the designed case; publishers serialise on the
store lock.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional

import torch

from repro_torch.core.math import exp_dirichlet_expectation
from repro_torch.core.types import resolve_device


@dataclasses.dataclass(frozen=True)
class ModelSnapshot:
    """One published model version (immutable)."""

    version: int
    exp_elog_beta: torch.Tensor     # (V, K) on the device, finished
    docs_trained: int               # documents the publisher had consumed
    published_s: float              # store-clock time publish() returned
    swap_stall_s: float             # measured swap window (module doc)


class SnapshotStore:
    """Atomic λ publication to attached inferencers (see module docstring).

    Args:
      inferencer: a ``TopicInferencer`` to publish to (more through
        ``attach``, e.g. one per serving replica; every attached
        inferencer receives the same version number).
      metrics: optional ``MetricsRegistry``: each publish observes
        ``serve.swap_stall_ms`` and bumps ``serve.publishes``.
      clock: injectable monotonic clock (tests).
      device: where Eφ is computed; the first inferencer's device, else
        the card unless the caller names another.
    """

    def __init__(self, inferencer=None, *, metrics=None,
                 clock: Callable[[], float] = time.perf_counter,
                 device=None):
        self._infs = [inferencer] if inferencer is not None else []
        self.metrics = metrics
        self._clock = clock
        self._lock = threading.Lock()
        self.history: List[ModelSnapshot] = []
        if device is None and inferencer is not None:
            device = inferencer.device
        self.device = resolve_device(device)

    def attach(self, inferencer) -> None:
        """Add a serving replica; it picks up the next publish (its current
        snapshot is whatever it was constructed with)."""
        with self._lock:
            self._infs.append(inferencer)

    @property
    def current(self) -> Optional[ModelSnapshot]:
        return self.history[-1] if self.history else None

    def publish(self, lam, *, docs_trained: int = 0) -> ModelSnapshot:
        """Compute Eφ from λ and swap it into every attached inferencer.

        Eφ is computed on this thread's current stream, which is then
        synchronized, before the swap window opens: a serving thread never
        reads an unfinished snapshot, and the measured ``swap_stall_s``
        covers only the ``swap_model`` assignments.
        """
        lam = torch.as_tensor(lam, dtype=torch.float32).to(self.device)
        eb = exp_dirichlet_expectation(lam, axis=0).contiguous()
        if eb.is_cuda:
            torch.cuda.current_stream(eb.device).synchronize()
        with self._lock:
            if not self._infs:
                raise ValueError("no inferencer attached: publish() has "
                                 "nowhere to swap the snapshot into")
            t0 = self._clock()
            version = None
            for inf in self._infs:
                v = inf.swap_model(exp_elog_beta=eb)
                version = v if version is None else version
            stall = self._clock() - t0
            snap = ModelSnapshot(version=version, exp_elog_beta=eb,
                                 docs_trained=int(docs_trained),
                                 published_s=self._clock(),
                                 swap_stall_s=stall)
            self.history.append(snap)
        if self.metrics is not None:
            self.metrics.inc("serve.publishes")
            self.metrics.observe("serve.swap_stall_ms", stall * 1e3)
        return snap

    def swap_stalls_ms(self) -> List[float]:
        """The measured swap window of every publish, in ms."""
        return [s.swap_stall_s * 1e3 for s in self.history]
