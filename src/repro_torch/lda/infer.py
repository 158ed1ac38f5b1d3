"""Serving-side inference: topic posteriors for unseen documents.

The port's counterpart of ``repro.lda.infer``. Serving runs the
per-document E-step against frozen topics and needs γ alone, so each
batch is one launch on the card: the fixed point without its π finish
(K1 on the padded layout, K4 on the flat one) and no scatter, where
``repro``'s jit drops the unused outputs (``EStepBackend.solve_gamma``).

* Documents go into length buckets under the one width policy of the
  token pipeline (`repro_torch.data.stream.bucket_rows`: the ladder rung
  covering the last live slot), each bucket padded to one fixed
  ``batch_size``, so a request's work scales with its own length.
* ``posterior_docs`` takes ragged documents (a ``DocStream`` or any
  iterable) through a ``BatchPacker``. Double-buffered by default: a
  producer thread packs batch t+1 into pinned host buffers and copies it
  to the card on a side stream, then records an event; the consumer makes
  the compute stream wait on that event, marks the staged tensors as used
  there (``record_stream``) and dispatches. A pinned buffer is refilled
  only after its copy's event has completed, and γ comes to the host once,
  after the last dispatch, so the dispatch loop never waits for the card.
  The synchronous path (``double_buffer=False``) packs, copies, runs and
  waits one batch at a time, on the same inputs: the same bits.
* The topics are one versioned snapshot, the tuple ``(version, Eφ)``:
  ``swap_model`` publishes new topics with one assignment and every batch
  reads the tuple once, so a batch in flight completes on the snapshot it
  started with.

``TopicInferencer`` is the reusable handle (λ → Eφ once); ``topic_posterior``
is the one-shot form ``LDA.transform`` wraps.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.estep import BowBatch, CSRTokenBatch, get_backend
from repro_torch.core.math import exp_dirichlet_expectation, safe_normalize
from repro_torch.core.types import Corpus, LDAConfig, resolve_device
from repro_torch.data.stream import (BatchPacker, CSRBatch, PackedBatch,
                                     TOKEN_SLOT_BYTES, as_ragged_doc,
                                     bucket_rows)
from repro_torch.obs import as_telemetry

# ``repro``'s default staging-queue depth (one batch in flight, one staged)
BUFFER_DEPTH = 2

# one staged request batch: (request positions, device ids, device counts,
# bucket width (padded) or device segments (csr), live rows, the event
# after its copy or None)
_Staged = Tuple[np.ndarray, torch.Tensor, torch.Tensor, object, int,
                Optional[torch.cuda.Event]]

# one dispatched result: (request positions, device γ, live rows, the
# model version whose snapshot solved the batch)
_Result = Tuple[np.ndarray, torch.Tensor, int, int]


class _Pinned:
    """One slot of the producer's ring of pinned staging buffers: grown to
    fit, never shrunk, and refilled only after the copy that last read it
    has completed."""

    def __init__(self):
        self.bufs: Dict[str, torch.Tensor] = {}
        self.copied: Optional[torch.cuda.Event] = None

    def view(self, name: str, arr: np.ndarray) -> torch.Tensor:
        buf = self.bufs.get(name)
        if buf is None or buf.numel() < arr.size:
            buf = torch.empty(arr.size, dtype=torch.from_numpy(arr).dtype,
                              pin_memory=True)
            self.bufs[name] = buf
        out = buf[:arr.size].view(arr.shape)
        out.copy_(torch.from_numpy(arr))
        return out


class TopicInferencer:
    """Frozen-topics E-step server (see module docstring).

    Args:
      cfg: training config; ``backend`` overrides ``cfg.estep_backend``
        for serving (train with ``gather``, serve with ``cuda``).
      lam: (V, K) topic-word parameter (tensor or array).
      batch_size: the fixed request batch; short batches are padded with
        empty documents (they sit at the prior γ = α₀ and are dropped).
      layout: ``"padded"`` (width buckets) or ``"csr"`` (flat token
        batches of ``token_budget`` slots, default
        ``min(64·batch_size, 8192)``, ``repro``'s).
      telemetry: a `repro_torch.obs` bundle (None/False = off): spans
        ``serve/stage`` and ``serve/solve`` (never synced), counters of
        documents and batches per width, the queue depth.
      tune_store: not ported (ROADMAP §1 item 8); passing one raises. An
        explicit ``cfg.kernel_policy`` is honoured.
      device: where the E-step runs; the card unless the caller names
        another device.
    """

    def __init__(self, cfg: LDAConfig, lam, *, backend: Optional[str] = None,
                 batch_size: int = 256, layout: str = "padded",
                 token_budget: Optional[int] = None, telemetry=None,
                 tune_store=None, device=None):
        if tune_store is not None:
            raise NotImplementedError(
                "tune_store: the policy tuner is not ported to repro_torch "
                "yet (ROADMAP §1 item 8, tune/); pass cfg.kernel_policy")
        if backend is not None and backend != cfg.estep_backend:
            cfg = dataclasses.replace(cfg, estep_backend=backend)
        if layout not in ("padded", "csr"):
            raise ValueError(f"unknown layout {layout!r} "
                             "(expected 'padded' or 'csr')")
        get_backend(cfg.estep_backend)            # refuse an unknown one now
        self.cfg = cfg
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.layout = layout
        if layout == "csr" and token_budget is None:
            token_budget = min(batch_size * 64, 8192)
        self.token_budget = token_budget if layout == "csr" else None
        self.tel = as_telemetry(telemetry)
        self._model: Tuple[int, torch.Tensor] = (0, self._exp_elog_beta(lam))
        self._swap_lock = threading.Lock()
        self._compiled_widths: Dict[int, int] = {}   # width → batches run
        self._live_slots = 0
        self._padded_slots = 0

    def _exp_elog_beta(self, lam) -> torch.Tensor:
        lam = torch.as_tensor(lam, dtype=torch.float32).to(self.device)
        return exp_dirichlet_expectation(lam, axis=0).contiguous()

    # -- model snapshot ---------------------------------------------------
    @property
    def exp_elog_beta(self) -> torch.Tensor:
        """The current snapshot's Eφ (V, K)."""
        return self._model[1]

    @property
    def model_version(self) -> int:
        """Counter of published snapshots (0 = the constructor's)."""
        return self._model[0]

    def swap_model(self, lam=None, *, exp_elog_beta=None,
                   version: Optional[int] = None) -> int:
        """Publish new topics atomically; returns the new version.

        Eφ is computed outside the lock, on the caller's thread; the
        critical section is one tuple assignment. A batch dispatched
        before the swap completes on the old snapshot and reports its
        version. ``version`` overrides the counter (it must advance).
        """
        if (lam is None) == (exp_elog_beta is None):
            raise ValueError("pass exactly one of lam / exp_elog_beta")
        eb = (self._exp_elog_beta(lam) if lam is not None else
              torch.as_tensor(exp_elog_beta, dtype=torch.float32)
              .to(self.device).contiguous())
        if eb.shape != self._model[1].shape:
            raise ValueError(
                f"snapshot shape {tuple(eb.shape)} != serving "
                f"{tuple(self._model[1].shape)}: a swap cannot change the "
                "(V, K) geometry")
        with self._swap_lock:
            cur = self._model[0]
            v = cur + 1 if version is None else int(version)
            if v <= cur:
                raise ValueError(f"version must advance: {v} <= {cur}")
            self._model = (v, eb)
        if self.tel.enabled:
            self.tel.metrics.inc("serve.model_swaps")
            self.tel.metrics.set_gauge("serve.model_version", v)
        return v

    # -- padded-corpus requests -------------------------------------------
    def posterior(self, corpus: Corpus) -> np.ndarray:
        """γ (D, K) for every document, bucketed and batch-padded. Empty
        documents come back at the prior γ = α₀."""
        if self.layout == "csr":
            from repro_torch.data.stream import CorpusDocStream
            return self.posterior_docs(CorpusDocStream(corpus))
        ids_all = corpus.token_ids.cpu().numpy()
        cnts_all = corpus.counts.cpu().numpy()
        results: List[_Result] = []
        for rows_all, width in bucket_rows(cnts_all):
            for lo in range(0, len(rows_all), self.batch_size):
                rows = rows_all[lo:lo + self.batch_size]
                batch = PackedBatch(rows, ids_all[rows, :width],
                                    cnts_all[rows, :width], width)
                results.append(self._dispatch(self._stage(batch)))
        return self._gather(results, corpus.num_docs)

    def transform(self, corpus: Corpus) -> np.ndarray:
        """θ̄ (D, K): the normalised topic posterior."""
        return _normalize(self.posterior(corpus))

    # -- ragged requests --------------------------------------------------
    def posterior_docs(self, docs, *,
                       double_buffer: bool = True) -> np.ndarray:
        """γ (N, K) for ragged request documents, in request order.

        ``docs``: a ``DocStream`` or any iterable of documents (token
        arrays with repeats, or unique ``(ids, counts)`` pairs). See the
        module docstring for ``double_buffer``; both paths give the same
        bits.
        """
        results = self._solve_docs(docs, double_buffer=double_buffer)
        return self._gather(results, sum(n for _, _, n, _ in results))

    def _solve_docs(self, docs, *, double_buffer: bool) -> List[_Result]:
        """Every batch of ``docs`` dispatched, γ left on the device."""
        if not double_buffer:
            results = []
            for batch in self._packed(docs):
                res = self._dispatch(self._stage(batch))
                res[1].cpu()                  # the synchronous reference
                results.append(res)
            return results
        pinned = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if pinned else None
        ring = [_Pinned() for _ in range(BUFFER_DEPTH + 1)] if pinned \
            else None
        q: "queue.Queue" = queue.Queue(maxsize=BUFFER_DEPTH)
        abort = threading.Event()
        err: List[BaseException] = []

        def put(item) -> bool:
            # gives up once the consumer aborts, so an error on its side
            # never leaves this thread blocked on a full queue
            while not abort.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                if side is not None:
                    torch.cuda.set_device(side.device)   # this thread's
                for i, batch in enumerate(self._packed(docs)):
                    slot = ring[i % len(ring)] if ring else None
                    if not put(self._stage(batch, side, slot)):
                        return
            except BaseException as e:  # noqa: BLE001, re-raised below
                err.append(e)
            finally:
                put(None)

        t = threading.Thread(target=produce, name="serve-packer",
                             daemon=True)
        results: List[_Result] = []
        t.start()
        try:
            while True:
                staged = q.get()
                if staged is None:
                    break
                if self.tel.enabled:
                    self.tel.metrics.observe("serve.queue_depth", q.qsize())
                results.append(self._dispatch(staged))
        finally:
            abort.set()
            t.join()
        if err:
            raise err[0]
        return results

    def _packed(self, docs) -> Iterator:
        """The request documents packed as this inferencer packs them."""
        it = (docs.iter_from(0) if hasattr(docs, "iter_from")
              else (as_ragged_doc(d) for d in docs))
        packer = BatchPacker(
            **self.packer_kwargs(),
            metrics=self.tel.metrics if self.tel.enabled else None)
        for pos, (ids, cnts) in enumerate(it):
            batch = packer.add(pos, ids, cnts)
            if batch is not None:
                yield batch
        yield from packer.flush()

    def _stage(self, batch, side: Optional[torch.cuda.Stream] = None,
               slot: Optional[_Pinned] = None) -> _Staged:
        """Pad a packed batch to ``batch_size`` rows (padded layout) and put
        it on the device: through ``slot``'s pinned buffers on the ``side``
        stream, ending in an event, when given (the double buffer), else
        with blocking copies."""
        tel = self.tel
        n = len(batch.rows)
        csr = isinstance(batch, CSRBatch)
        width = batch.token_budget if csr else batch.width
        sp = tel.trace.begin("serve/stage", width=width, docs=n) \
            if tel.enabled else None
        if csr:
            host = {"ids": batch.token_ids, "cnts": batch.counts,
                    "segs": batch.segments}
            self._note_padding(batch.live_tokens, batch.token_budget)
        else:
            ids = np.zeros((self.batch_size, width), np.int32)
            cnts = np.zeros((self.batch_size, width), np.float32)
            ids[:n] = batch.token_ids
            cnts[:n] = batch.counts
            host = {"ids": ids, "cnts": cnts}
            self._note_padding(int((cnts > 0).sum()), cnts.size)
        event = None
        if slot is not None:
            if slot.copied is not None:
                slot.copied.synchronize()    # its last copy has landed
            with torch.cuda.stream(side):
                dev = {k: slot.view(k, np.ascontiguousarray(a))
                       .to(self.device, non_blocking=True)
                       for k, a in host.items()}
                event = torch.cuda.Event()
                event.record(side)
            slot.copied = event
        else:
            dev = {k: torch.from_numpy(np.ascontiguousarray(a))
                   .to(self.device) for k, a in host.items()}
        if sp is not None:
            tel.trace.end(sp)
        aux = dev["segs"] if csr else width
        return batch.rows, dev["ids"], dev["cnts"], aux, n, event

    def _dispatch(self, staged: _Staged) -> _Result:
        """One batch's γ on the current stream: one read of the snapshot
        tuple, then the backend's γ-only solve."""
        tel = self.tel
        rows, ids, cnts, aux, n, event = staged
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in (ids, cnts) + ((aux,) if self.layout == "csr" else ()):
                t.record_stream(stream)
        version, eb = self._model
        backend = get_backend(self.cfg.estep_backend)
        width = self.token_budget if self.layout == "csr" else aux
        sp = tel.trace.begin("serve/solve", width=width, docs=n) \
            if tel.enabled else None
        if self.layout == "csr":
            gamma = backend.solve_tokens_gamma(
                self.cfg, eb, CSRTokenBatch(ids, cnts, aux),
                num_docs=self.batch_size)
        else:
            gamma = backend.solve_gamma(self.cfg, eb, BowBatch(ids, cnts))
        if sp is not None:
            tel.trace.end(sp)
        self._note_width(width, n)
        return rows, gamma, n, version

    def _gather(self, results: List[_Result], total: int) -> np.ndarray:
        """Every result's γ to the host in one copy, placed by request
        position."""
        out = np.zeros((total, self.cfg.num_topics), np.float32)
        if not results:
            return out
        gamma = torch.cat([g[:n] for _, g, n, _ in results]).cpu().numpy()
        out[np.concatenate([rows for rows, _, _, _ in results])] = gamma
        return out

    def posterior_packed(self, batch) -> _Result:
        """γ for one pre-packed batch (a ``PackedBatch``/``CSRBatch`` from a
        packer built from ``packer_kwargs``): ``(rows, γ on the device, n,
        model version)``, staged and solved as ``posterior_docs`` does, so
        the same bits."""
        return self._dispatch(self._stage(batch))

    def packer_kwargs(self) -> Dict[str, object]:
        """The ``BatchPacker`` arguments this inferencer packs with."""
        return dict(batch_size=self.batch_size,
                    vocab_size=self.cfg.vocab_size, layout=self.layout,
                    token_budget=self.token_budget)

    def transform_docs(self, docs, *,
                       double_buffer: bool = True) -> np.ndarray:
        """θ̄ (N, K) for ragged request documents."""
        return _normalize(self.posterior_docs(docs,
                                              double_buffer=double_buffer))

    # -- bookkeeping ------------------------------------------------------
    def _note_width(self, width: int, docs: int) -> None:
        first = width not in self._compiled_widths
        self._compiled_widths[width] = self._compiled_widths.get(width, 0) + 1
        if self.tel.enabled:
            m = self.tel.metrics
            m.inc("serve.jit_cache_misses" if first
                  else "serve.jit_cache_hits", width=width)
            m.inc("serve.docs", docs)
            m.inc("serve.batches", width=width)

    def _note_padding(self, live: int, padded: int) -> None:
        self._live_slots += int(live)
        self._padded_slots += int(padded)

    def padding_stats(self) -> Dict[str, object]:
        """Live against staged token slots so far, and the host→device
        bytes the padding cost (``TOKEN_SLOT_BYTES`` a slot)."""
        wasted = self._padded_slots - self._live_slots
        return {"live_slots": self._live_slots,
                "padded_slots": self._padded_slots,
                "pad_frac": 1.0 - self._live_slots
                    / max(self._padded_slots, 1),
                "wasted_token_bytes": wasted * TOKEN_SLOT_BYTES}

    def cache_info(self) -> Dict[str, object]:
        """Batches served per width, and the widths seen. The port has no
        jit: ``jit_entries`` counts the distinct batch shapes launched, the
        number of compiled executables ``repro`` holds for them."""
        return {"batches_per_width": dict(self._compiled_widths),
                "compiled_widths": sorted(self._compiled_widths),
                "jit_entries": len(self._compiled_widths)}


def _normalize(gamma: np.ndarray) -> np.ndarray:
    return safe_normalize(torch.from_numpy(gamma), axis=-1).numpy()


def topic_posterior(cfg: LDAConfig, lam, corpus: Corpus, *,
                    backend: Optional[str] = None, batch_size: int = 256,
                    device=None) -> Tuple[np.ndarray, np.ndarray]:
    """One-shot (γ, θ̄) for ``corpus`` under frozen topics ``lam``."""
    inf = TopicInferencer(cfg, lam, backend=backend, batch_size=batch_size,
                          device=device)
    gamma = inf.posterior(corpus)
    return gamma, _normalize(gamma)
