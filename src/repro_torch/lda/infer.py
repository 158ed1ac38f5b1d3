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
* ``posterior`` packs a padded request on the device: one copy in of its
  ids and counts, with an all-zero row after the last document that every
  batch's padding indexes; each row's last live slot and the live-slot
  count come back in one small read (the request's first wait), the host
  cuts the batches from them by ``bucket_rows``' rule and sends their row
  indices in one copy, and every batch is gathered by row index and
  solved without a host wait; γ is placed by one gather and comes back in
  one copy (the second wait). The same rows at the same widths as host
  padding, so the same bits. The copies are plain ones from the request's
  own tensors: CUDA's own staging of pageable memory moves a host request
  faster than a fill of pinned buffers would.
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
  ``swap_model`` publishes new topics with one assignment, after the
  stream that computed them has finished, and every batch reads the tuple
  once, so a batch in flight completes on the snapshot it started with.
  The batch marks the snapshot's Eφ as used on its stream
  (``record_stream``), so a swap from a publisher's stream cannot free
  that memory under a running kernel.

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
from repro_torch.data.stream import (BatchPacker, CSRBatch,
                                     TOKEN_SLOT_BYTES, as_ragged_doc,
                                     bucket_last)
from repro_torch.obs import as_telemetry

# one staged request batch: (request positions (a device index in a padded
# ``posterior``), device ids, device counts, bucket width (padded) or
# device segments (csr), live rows, the event after its copy or None)
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
        ``serve/request`` around a ``posterior``/``posterior_docs`` call,
        ``serve/bucket`` (padded ``posterior``: the live-slot read and the
        cut), ``serve/stage`` (the copy in and each batch's gather, or a
        packed batch's padding and copies), ``serve/solve`` and
        ``serve/gather`` (placement, γ to the host) (never synced; under a
        profiler they open with telemetry off too), counters of documents
        and batches per width, the queue depth, ``serve.host_waits``
        (padded ``posterior``: 2 a request).
      tune_store: a `repro_torch.tune` policy store (path or
        ``PolicyStore``). Padded serving resolves a policy per bucket
        width, the first time a width is dispatched (each width is its own
        launch shape); CSR serving resolves its one shape here. The
        policy's ``double_buffer_depth`` sizes ``posterior_docs``'s staging
        queue. An explicit ``cfg.kernel_policy`` always wins; no store (or a
        miss) launches what the kernels choose.
      device: where the E-step runs; the card unless the caller names
        another device.
    """

    def __init__(self, cfg: LDAConfig, lam, *, backend: Optional[str] = None,
                 batch_size: int = 256, layout: str = "padded",
                 token_budget: Optional[int] = None, telemetry=None,
                 tune_store=None, device=None):
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
        self._pinned_local = threading.local()   # posterior_packed's rings
        self._compiled_widths: Dict[int, int] = {}   # width → batches run
        self._live_slots = 0
        self._padded_slots = 0
        # tuned policies: per-width cfgs for padded serving, one lookup
        # here for csr
        self._resolver = None
        self._cfg_by_width: Dict[int, LDAConfig] = {}
        self._width_lock = threading.Lock()
        if (tune_store is not None and cfg.kernel_policy is None
                and cfg.estep_backend == "cuda"):
            from repro_torch.tune.resolve import PolicyResolver
            self._resolver = PolicyResolver(tune_store, telemetry=self.tel,
                                            device=self.device)
            if layout == "csr":
                pol = self._resolver.resolve(
                    backend="cuda", layout="csr", b_or_t=self.token_budget,
                    v=cfg.vocab_size, k=cfg.num_topics, w=None)
                if pol is not None:
                    self.cfg = dataclasses.replace(cfg, kernel_policy=pol)

    def _cfg_for_width(self, width: int) -> LDAConfig:
        """The serving cfg of one bucket width: with that width's tuned
        policy when the store has one (padded layout; csr resolved its one
        shape at construction). Each width is looked up once (one
        ``tune.cache`` count), under a lock: batches may come from several
        threads."""
        if self._resolver is None or self.layout == "csr":
            return self.cfg
        with self._width_lock:
            cfg = self._cfg_by_width.get(width)
            if cfg is None:
                pol = self._resolver.resolve(
                    backend="cuda", layout="padded", b_or_t=self.batch_size,
                    v=self.cfg.vocab_size, k=self.cfg.num_topics, w=width)
                cfg = (self.cfg if pol is None
                       else dataclasses.replace(self.cfg, kernel_policy=pol))
                self._cfg_by_width[width] = cfg
        return cfg

    def _buffer_depth(self) -> int:
        """``posterior_docs``'s staging-queue size: the active policy's
        ``double_buffer_depth`` (tuned or explicit), else ``repro``'s 2
        (one batch in flight, one staged)."""
        pol = self.cfg.kernel_policy
        return pol.double_buffer_depth if pol is not None else 2

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

        Eφ is computed outside the lock, on the caller's thread and
        current stream, which is synchronized before the swap: a batch on
        another stream that reads the new snapshot reads a finished
        tensor. ``exp_elog_beta`` must be finished already (as
        ``SnapshotStore.publish`` hands it in). The critical section is one
        tuple assignment. A batch dispatched before the swap completes on
        the old snapshot and reports its version. ``version`` overrides the
        counter (it must advance).
        """
        if (lam is None) == (exp_elog_beta is None):
            raise ValueError("pass exactly one of lam / exp_elog_beta")
        if lam is not None:
            eb = self._exp_elog_beta(lam)
            if eb.is_cuda:
                torch.cuda.current_stream(eb.device).synchronize()
        else:
            eb = (torch.as_tensor(exp_elog_beta, dtype=torch.float32)
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
        trace = self.tel.trace
        on = self.tel.spans_on
        req = trace.begin("serve/request", docs=corpus.num_docs) \
            if on else None
        if self.layout == "csr":
            from repro_torch.data.stream import CorpusDocStream
            gamma = self._posterior_docs(CorpusDocStream(corpus), True, on)
        else:
            gamma = self._posterior_padded(corpus, on)
        if req is not None:
            trace.end(req)
        return gamma

    def _posterior_padded(self, corpus: Corpus, on: bool) -> np.ndarray:
        """A padded request packed on the device (module docstring)."""
        trace = self.tel.trace
        d, l = corpus.token_ids.shape
        bs = self.batch_size
        sp = trace.begin("serve/stage", docs=d) if on else None
        ids = torch.empty((d + 1, l), dtype=torch.int32, device=self.device)
        cnts = torch.empty((d + 1, l), dtype=torch.float32,
                           device=self.device)
        for dev, src in ((ids, corpus.token_ids), (cnts, corpus.counts)):
            dev[:d].copy_(src, non_blocking=True)
            dev[d].zero_()             # the row every batch's padding reads
        if sp is not None:
            trace.end(sp)
        sp = trace.begin("serve/bucket") if on else None
        live = cnts > 0
        marks = torch.where(live, torch.arange(1, l + 1, device=self.device),
                            0).amax(1)
        marks[d] = live.sum()          # the zero row's slot: the live count
        marks = self._wait_host(marks)
        cuts = [(rows[lo:lo + bs], width)
                for rows, width in bucket_last(marks[:d], l)
                for lo in range(0, len(rows), bs)]
        # each batch's rows (padding: the zero row d), then each document's
        # row in the batches' γ stacked
        nb = len(cuts) * bs
        index = np.full(nb + d, d, np.int64)
        for i, (rows, _) in enumerate(cuts):
            index[i * bs:i * bs + len(rows)] = rows
        stacked = np.flatnonzero(index[:nb] < d)
        index[nb + index[stacked]] = stacked
        self._note_padding(marks[d], bs * sum(w for _, w in cuts))
        index = torch.from_numpy(index).to(self.device, non_blocking=True)
        if sp is not None:
            trace.end(sp)
        results = []
        for i, (rows, width) in enumerate(cuts):
            n = len(rows)
            sp = trace.begin("serve/stage", width=width, docs=n) if on \
                else None
            pos = index[i * bs:(i + 1) * bs]
            staged = (pos, ids[:, :width].index_select(0, pos),
                      cnts[:, :width].index_select(0, pos), width, n, None)
            if sp is not None:
                trace.end(sp)
            results.append(self._dispatch(staged, on))
        sp = trace.begin("serve/gather") if on else None
        out = torch.cat([g for _, g, _, _ in results]).index_select(
            0, index[nb:]) if results else \
            torch.empty((0, self.cfg.num_topics), device=self.device)
        gamma = self._wait_host(out)
        if sp is not None:
            trace.end(sp)
        return gamma

    def _wait_host(self, t: torch.Tensor) -> np.ndarray:
        """``t`` in a new host array: one of a padded request's two waits
        on the device."""
        if self.tel.enabled:
            self.tel.metrics.inc("serve.host_waits")
        return t.cpu().numpy()

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
        trace = self.tel.trace
        on = self.tel.spans_on
        req = trace.begin("serve/request") if on else None
        gamma = self._posterior_docs(docs, double_buffer, on)
        if req is not None:
            trace.end(req)
        return gamma

    def _posterior_docs(self, docs, double_buffer: bool,
                        on: bool) -> np.ndarray:
        results = self._solve_docs(docs, double_buffer=double_buffer, on=on)
        return self._gather(results, sum(n for _, _, n, _ in results), on)

    def _solve_docs(self, docs, *, double_buffer: bool,
                    on: bool) -> List[_Result]:
        """Every batch of ``docs`` dispatched, γ left on the device."""
        if not double_buffer:
            results = []
            for batch in self._packed(docs):
                res = self._dispatch(self._stage(batch, on), on)
                res[1].cpu()                  # the synchronous reference
                results.append(res)
            return results
        pinned = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if pinned else None
        depth = self._buffer_depth()
        ring = [_Pinned() for _ in range(depth + 1)] if pinned else None
        q: "queue.Queue" = queue.Queue(maxsize=depth)
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
                    if not put(self._stage(batch, on, side, slot)):
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
                results.append(self._dispatch(staged, on))
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

    def _stage(self, batch, on: bool,
               side: Optional[torch.cuda.Stream] = None,
               slot: Optional[_Pinned] = None) -> _Staged:
        """Pad a packed batch to ``batch_size`` rows (padded layout) and put
        it on the device: through ``slot``'s pinned buffers on the ``side``
        stream, ending in an event, when given (the double buffer), else
        with blocking copies. A ``serve/stage`` span when ``on``."""
        trace = self.tel.trace
        n = len(batch.rows)
        csr = isinstance(batch, CSRBatch)
        width = batch.token_budget if csr else batch.width
        sp = trace.begin("serve/stage", width=width, docs=n) if on else None
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
            if slot.copied is not None and not slot.copied.query():
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
            trace.end(sp)
        aux = dev["segs"] if csr else width
        return batch.rows, dev["ids"], dev["cnts"], aux, n, event

    def _dispatch(self, staged: _Staged, on: bool) -> _Result:
        """One batch's γ on the current stream: one read of the snapshot
        tuple, then the backend's γ-only solve (a ``serve/solve`` span when
        ``on``). The snapshot may come from another stream (a
        publisher's): it is marked as used on this one, so its memory
        outlives the batch's kernel even if a swap drops the last reference
        to it meanwhile."""
        trace = self.tel.trace
        rows, ids, cnts, aux, n, event = staged
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        if event is not None:
            stream.wait_event(event)
            for t in (ids, cnts) + ((aux,) if self.layout == "csr" else ()):
                t.record_stream(stream)
        version, eb = self._model
        if stream is not None:
            eb.record_stream(stream)
        backend = get_backend(self.cfg.estep_backend)
        width = self.token_budget if self.layout == "csr" else aux
        sp = trace.begin("serve/solve", width=width, docs=n) if on else None
        if self.layout == "csr":
            gamma = backend.solve_tokens_gamma(
                self.cfg, eb, CSRTokenBatch(ids, cnts, aux),
                num_docs=self.batch_size)
        else:
            gamma = backend.solve_gamma(self._cfg_for_width(width), eb,
                                        BowBatch(ids, cnts))
        if sp is not None:
            trace.end(sp)
        self._note_width(width, n)
        return rows, gamma, n, version

    def _gather(self, results: List[_Result], total: int,
                on: bool) -> np.ndarray:
        """Every result's γ to the host in one copy, placed by request
        position (a ``serve/gather`` span when ``on``)."""
        trace = self.tel.trace
        sp = trace.begin("serve/gather") if on else None
        out = np.zeros((total, self.cfg.num_topics), np.float32)
        if results:
            gamma = torch.cat([g[:n] for _, g, n, _ in results])
            gamma = gamma.cpu().numpy()
            out[np.concatenate([rows for rows, _, _, _ in results])] = gamma
        if sp is not None:
            trace.end(sp)
        return out

    def posterior_packed(self, batch) -> _Result:
        """γ for one pre-packed batch (a ``PackedBatch``/``CSRBatch`` from a
        packer built from ``packer_kwargs``): ``(rows, γ on the device, n,
        model version)``, staged and solved as ``posterior_docs`` does, so
        the same bits. On the card the batch is staged through pinned
        buffers of this thread's own ring, copied without a host sync on
        the current stream, so the serving loop's only waits are its own."""
        on = self.tel.spans_on
        if self.device.type != "cuda":
            return self._dispatch(self._stage(batch, on), on)
        local = self._pinned_local
        if not hasattr(local, "ring"):
            local.ring = [_Pinned() for _ in range(self._buffer_depth() + 1)]
            local.next = 0
        slot = local.ring[local.next % len(local.ring)]
        local.next += 1
        return self._dispatch(self._stage(
            batch, on, torch.cuda.current_stream(self.device), slot), on)

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
