"""Online learning from served traffic.

The port's counterpart of ``repro.serve.online``. IVI is the natural
online learner: no learning rate to schedule, and a monotone memoized
bound to watch. ``OnlineLearner`` runs it against the documents a
``ServingService`` is serving:

* served documents append to a ``repro_torch.data.stream.QueueDocStream``
  (capacity-bounded; stable positions keep the π-memo bookkeeping exact
  across revisits of a growing window);
* on a background cadence the learner runs one full training pass over
  everything appended so far (``Trainer.run_pass``, the IVI unit whose
  bound guarantee holds) and publishes the new λ through a
  ``SnapshotStore``: an atomic versioned swap, so inference never blocks
  on training;
* the ELBO watchdog guards monotonicity across swaps. The memoized bound
  is comparable only between two passes over the same document set, and
  only after the init mass has retired, so a reading is armed exactly
  when ``init_frac == 0`` and no document arrived since the previous
  reading. Unarmed readings are still recorded.

**Streams.** On the card every update (the bind, ``run_pass``,
``full_bound`` and ``publish``) runs on a CUDA stream of the learner's
own, made once with the learner: the background thread, ``drain`` from
the main thread and a forced update all train there and never on the
serving stream. The learner's stream first waits for the stream that
made the learner, so a ``lam0`` still being computed there is finished
before the warm start reads it.

The learner binds its estimator lazily at the first update with traffic:
a stream engine reads ``num_words`` once at bind to retire the init mass,
so binding before any document exists would divide by zero. Warm start:
pass the serving λ as ``lam0`` and the learner starts from the served
model through ``LDA.warm_start`` instead of a random init.
"""
from __future__ import annotations

import contextlib
import threading
from typing import List, Optional

import torch

from repro_torch.core.types import LDAConfig, resolve_device
from repro_torch.data.stream import QueueDocStream
from repro_torch.obs import ElboWatchdog
from repro_torch.serve.snapshot import SnapshotStore


class OnlineLearner:
    """Background training passes and atomic λ publication (see module
    doc).

    Args:
      cfg: the model config (must match the serving inferencer's (V, K)).
      store: the ``SnapshotStore`` to publish through.
      lam0: optional warm-start λ (the serving model); None = random init.
      capacity: online window size; documents beyond it are dropped
        (counted on ``stream.dropped``).
      max_unique: per-document unique-token cap (the memo width).
      batch_size: training mini-batch size.
      cadence_s: background-thread update period.
      min_new_docs: do not start a pass until this many new documents
        arrived since the last one (the first bind waits for it too).
      watchdog: an ``ElboWatchdog`` (default: a fresh ``warn`` one).
      seed: engine seed.
      device: where the learner trains; the card unless the caller names
        another device.
    """

    def __init__(self, cfg: LDAConfig, store: SnapshotStore, *,
                 lam0=None, capacity: int = 4096, max_unique: int = 256,
                 batch_size: int = 64, cadence_s: float = 0.25,
                 min_new_docs: int = 8,
                 watchdog: Optional[ElboWatchdog] = None, seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.store = store
        self.device = resolve_device(device)
        self.stream = QueueDocStream(cfg.vocab_size, capacity=capacity,
                                     max_unique=max_unique)
        self.watchdog = watchdog or ElboWatchdog(policy="warn")
        self.cadence_s = cadence_s
        self.min_new_docs = max(int(min_new_docs), 1)
        self._lam0 = lam0
        self._batch_size = batch_size
        self._seed = seed
        self._lda = None
        self._docs_at_last_update = 0
        self._docs_at_prev_bound: Optional[int] = None
        self.updates = 0
        self.armed_observations = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._update_lock = threading.Lock()   # one update at a time
        self._cuda_stream: Optional[torch.cuda.Stream] = None
        if self.device.type == "cuda":
            self._cuda_stream = torch.cuda.Stream(self.device)
            self._cuda_stream.wait_stream(
                torch.cuda.current_stream(self.device))

    # -- intake (called from the serving loop) ---------------------------
    def observe(self, docs) -> int:
        """Append served documents to the online window; returns how many
        were kept (the rest were dropped at capacity). A host-side append
        per document: no device work, no training."""
        kept = 0
        for doc in docs:
            if self.stream.append(doc) is not None:
                kept += 1
        return kept

    # -- training --------------------------------------------------------
    def _on_stream(self):
        """The learner's CUDA stream as the current one (a no-op off the
        card)."""
        if self._cuda_stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._cuda_stream)

    def _bind(self) -> None:
        from repro_torch.lda import LDA
        lda = LDA(self.cfg, algo="ivi", batch_size=self._batch_size,
                  seed=self._seed, device=self.device)
        lda.fit(self.stream, epochs=0)           # bind without training
        if self._lam0 is not None:
            lda.warm_start(self._lam0)
        self._lda = lda

    @property
    def docs_trained(self) -> int:
        return 0 if self._lda is None else self._lda.docs_seen

    @property
    def model(self):
        """The live estimator (None before the first update)."""
        return self._lda

    def update_once(self, *, force: bool = False) -> Optional[int]:
        """One training pass over the current window, then a publish.

        Skips (returns None) while fewer than ``min_new_docs`` documents
        arrived since the last pass, unless ``force``, which runs a pass
        whenever any document exists (the drain path: repeated forced
        passes over a quiet window are the armed-watchdog steady state).
        Returns the published model version.
        """
        appended = self.stream.appended
        new = appended - self._docs_at_last_update
        if appended == 0 or self.stream.num_words <= 0:
            return None
        if not force and new < self.min_new_docs:
            return None
        with self._update_lock, self._on_stream():
            if self._lda is None:
                self._bind()
            self._docs_at_last_update = appended
            tr = self._lda.trainer
            tr.run_pass()
            self.updates += 1
            bound = tr.full_bound()
            eng = tr.eng
            # armed iff the objective is comparable to the previous reading:
            # the same document set before and after the pass, init mass
            # retired
            armed = (eng._watchdog_armed()
                     and self._docs_at_prev_bound == appended
                     and self.stream.appended == appended)
            self.armed_observations += int(armed)
            self.watchdog.observe(bound, step=self.updates, armed=armed)
            self._docs_at_prev_bound = appended
            snap = self.store.publish(self._lda.lam,
                                      docs_trained=self._lda.docs_seen)
        return snap.version

    def drain(self, passes: int = 2) -> List[int]:
        """Synchronous steady-state passes over the final window (no new
        traffic): the armed-watchdog monotonicity readings. Returns the
        published versions."""
        out = []
        for _ in range(passes):
            v = self.update_once(force=True)
            if v is not None:
                out.append(v)
        return out

    # -- background cadence ----------------------------------------------
    def start(self) -> "OnlineLearner":
        """Run ``update_once`` on the background cadence until ``stop``."""
        if self._thread is not None:
            raise ValueError("learner already started")
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.cadence_s):
                self.update_once()

        self._thread = threading.Thread(target=loop, name="online-learner",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = None) -> None:
        """Stop the background thread and join it (idempotent). With a
        ``timeout``, raise if the thread is still alive after it."""
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError(f"the online learner's thread did not stop "
                               f"within {timeout} s")
        self._thread = None

    def __enter__(self) -> "OnlineLearner":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
