"""The Trainer contract: one training interface over the engines.

The port's counterpart of ``repro.lda.trainer``. The facade
(`repro_torch.lda.api.LDA`) drives a ``Trainer`` and never an engine:

* ``run_pass()``: one full unit of cover, an epoch (D-IVI: a round);
* ``run_step()``: the smallest resumable unit, one mini-batch (a round);
* ``capture()`` / ``restore()``: the trainer's full durable state as
  (json-able meta, named array groups) for `repro_torch.checkpoint`.

An incremental run's state is not λ alone: it is (λ, ⟨m_vk⟩, the init
mass, init_frac, t), the π memo in its wire dtype, the host rng stream and
the unvisited remainder of the current epoch (for a stream, the cursor,
the packer's open documents and the emitted batches). ``capture`` writes
all of it under ``repro``'s keys and meta, so save → load → resume is
bit-equal to a run that never stopped, and each package resumes the
other's checkpoints. ``DIVITrainer``'s state adds the worker memo shards,
every worker's ingest cursor and the shard assignment.

On a mesh (``DIVITrainer(..., mesh=)``) ``evaluate``, ``full_bound`` and
``capture`` are collectives that every rank calls: they gather λ, the
bound's per-worker terms and the memos, and reduce in the simulation's
order, so every rank gets the one-device run's numbers for the same state.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.bound import _memoized_doc_terms, _topics_term
from repro_torch.core.engines import History, LDAEngine
from repro_torch.core.math import dirichlet_expectation
from repro_torch.core.memo import bits_as_bf16
from repro_torch.core.predictive import log_predictive, split_heldout
from repro_torch.core.types import Corpus, GlobalState, LDAConfig
from repro_torch.data.stream import CSRBatch, PackedBatch, iter_padded_chunks
from repro_torch.dist.engine import DIVIEngine
from repro_torch.dist.protocol import DIVIConfig

_STATE_FIELDS = ("lam", "m_vk", "init_mass", "init_frac", "t")


def _capture_state(state: GlobalState) -> Dict[str, np.ndarray]:
    return {f: getattr(state, f).to("cpu", copy=True).numpy()
            for f in _STATE_FIELDS}


def _restore_state(arrays: Dict[str, np.ndarray], state: GlobalState,
                   rows: slice = slice(None)) -> None:
    """Copy a checkpoint's state leaves into the live ones, in place (on
    their device and in their dtype); the (V, K) leaves' ``rows`` only
    (a mesh rank's)."""
    for f in _STATE_FIELDS:
        live = getattr(state, f)
        arr = np.asarray(arrays[f])
        if arr.ndim == 2:
            arr = arr[rows]
        if arr.shape != tuple(live.shape):
            raise ValueError(
                f"state leaf {f!r}: checkpoint shape {arr.shape} != live "
                f"{tuple(live.shape)}: the checkpoint belongs to a "
                "different corpus/config")
        live.copy_(torch.from_numpy(np.array(arr)).to(live.dtype))


class Trainer:
    """Abstract training contract (see module docstring)."""

    kind: str = "abstract"
    algo: str
    history: History

    @property
    def state(self) -> GlobalState:
        raise NotImplementedError

    @property
    def lam(self) -> torch.Tensor:
        return self.state.lam

    @property
    def docs_seen(self) -> int:
        raise NotImplementedError

    def run_pass(self) -> None:
        """One full unit of cover: an epoch."""
        raise NotImplementedError

    def run_step(self) -> None:
        """The smallest resumable unit: one mini-batch."""
        raise NotImplementedError

    def evaluate(self) -> Dict[str, float]:
        raise NotImplementedError

    def set_test_corpus(self, corpus: Corpus, *, seed: int = 0) -> None:
        """(Re)bind the held-out split ``evaluate`` scores."""
        raise NotImplementedError

    def full_bound(self) -> float:
        raise NotImplementedError

    def capture(self) -> Tuple[Dict[str, Any], Dict[str, Dict[str, Any]]]:
        """Snapshot all durable state: (json-able meta, array groups)."""
        raise NotImplementedError

    def restore(self, meta: Dict[str, Any],
                arrays: Dict[str, Dict[str, Any]]) -> None:
        raise NotImplementedError


class SingleHostTrainer(Trainer):
    """``LDAEngine`` behind the Trainer contract, with a resumable epoch.

    Materialized corpus: each epoch's batch sequence is drawn up front (the
    sequence, and the rng draws, ``run_epoch`` uses, via
    ``LDAEngine.epoch_batches``) and stepped through, so a mid-epoch
    checkpoint holds the unvisited remainder. Stream: documents are pulled
    and packed per mini-batch, and a mid-epoch checkpoint holds the epoch
    cursor, the packer's open documents and the flushed batches not yet
    processed. Either way the resumed run finishes the epoch with the same
    batches.
    """

    kind = "single"

    def __init__(self, cfg: LDAConfig, corpus, *, algo: str,
                 batch_size: int = 64, seed: int = 0,
                 test_corpus: Optional[Corpus] = None,
                 memo_store: str = "dense", chunk_docs: int = 8192,
                 bucket_by_length: bool = False, layout: str = "padded",
                 token_budget: Optional[int] = None, telemetry=None,
                 device=None, tune_store=None):
        self.eng = LDAEngine(cfg, corpus, algo=algo, batch_size=batch_size,
                             seed=seed, test_corpus=test_corpus,
                             device=device, memo_store=memo_store,
                             chunk_docs=chunk_docs,
                             bucket_by_length=bucket_by_length,
                             layout=layout, token_budget=token_budget,
                             telemetry=telemetry, tune_store=tune_store)
        self.cfg = self.eng.cfg     # with the store's policy, if it had one
        self.algo = algo
        self._streamed = self.eng.stream is not None
        self._pending: List[Tuple[np.ndarray, Optional[int]]] = []

    @property
    def state(self) -> GlobalState:
        return self.eng.state

    @property
    def docs_seen(self) -> int:
        return self.eng.docs_seen

    @property
    def history(self) -> History:
        return self.eng.history

    @property
    def pending_batches(self) -> int:
        """Batches of the current epoch not yet visited (0 at an epoch
        boundary). Stream: the flushed batches not yet processed only;
        ``stream_cursor`` is the mid-epoch indicator there."""
        if self._streamed:
            return len(self.eng._stream_emitted)
        return len(self._pending)

    @property
    def stream_cursor(self) -> int:
        """Documents pulled from the stream this epoch (stream only)."""
        return self.eng._stream_cursor if self._streamed else 0

    def run_step(self) -> None:
        if self.algo == "mvi":
            raise ValueError("mvi is full-batch coordinate ascent: it has "
                             "no mini-batch step; use run_pass()")
        if self._streamed:
            if not self.eng.stream_step():
                self.eng.stream_step()   # at an epoch boundary: next pass
            return
        if not self._pending:
            self._pending = list(self.eng.epoch_batches())
        rows, width = self._pending.pop(0)
        self.eng.run_minibatch(rows, width=width)

    def run_pass(self) -> None:
        if self._streamed:
            while self.eng.stream_step():
                pass
            return
        if self.algo == "mvi":
            self.eng.run_epoch()
            return
        if not self._pending:
            self._pending = list(self.eng.epoch_batches())
        while self._pending:
            self.run_step()

    def evaluate(self) -> Dict[str, float]:
        return self.eng.evaluate()

    def set_test_corpus(self, corpus: Corpus, *, seed: int = 0) -> None:
        self.eng._obs, self.eng._held = split_heldout(
            corpus.to(self.eng.device), seed=seed)

    def full_bound(self) -> float:
        return self.eng.full_bound()

    # -- durable state ----------------------------------------------------
    def capture(self):
        eng = self.eng
        meta: Dict[str, Any] = {
            "kind": self.kind,
            "algo": self.algo,
            "docs_seen": eng.docs_seen,
            "rng": eng.rng.bit_generator.state,
            "history": dataclasses.asdict(eng.history),
            "wall_elapsed": time.perf_counter() - eng._t0,
            "pending_widths": [None if w is None else int(w)
                               for _, w in self._pending],
            "streamed": self._streamed,
        }
        arrays: Dict[str, Dict[str, Any]] = {
            "state": _capture_state(eng.state),
            "pending": {f"batch_{i:05d}": np.asarray(rows, np.int64)
                        for i, (rows, _) in enumerate(self._pending)},
        }
        if self._streamed:
            pend = eng._packer.pending_docs()
            meta["stream_cursor"] = int(eng._stream_cursor)
            meta["stream_layout"] = eng.layout
            meta["stream_pending_pos"] = [int(p) for p, _, _ in pend]
            # per-batch shape key: the padded width, or the CSR token budget
            meta["stream_emitted_widths"] = [
                int(b.token_budget if eng.layout == "csr" else b.width)
                for b in eng._stream_emitted]
            grp: Dict[str, np.ndarray] = {}
            for i, (_pos, ids, cnts) in enumerate(pend):
                grp[f"pend_{i:05d}_ids"] = np.asarray(ids, np.int32)
                grp[f"pend_{i:05d}_cnts"] = np.asarray(cnts, np.float32)
            for i, b in enumerate(eng._stream_emitted):
                grp[f"emit_{i:05d}_rows"] = np.asarray(b.rows, np.int64)
                grp[f"emit_{i:05d}_ids"] = np.asarray(b.token_ids)
                grp[f"emit_{i:05d}_cnts"] = np.asarray(b.counts)
                if eng.layout == "csr":
                    grp[f"emit_{i:05d}_segs"] = np.asarray(b.segments)
                    grp[f"emit_{i:05d}_offs"] = np.asarray(b.offsets)
            arrays["stream"] = grp
        if eng.memo is not None:
            meta["memo_kind"] = eng.memo.kind
            prefix = eng.memo.bf16_prefix
            # bf16 patterns as bf16 tensors: the manifest tags them
            # "bfloat16", as repro's bf16 arrays are tagged
            arrays["memo"] = {
                k: bits_as_bf16(v) if prefix and k.startswith(prefix) else v
                for k, v in eng.memo.state_dict().items()}
        if eng._gamma_buf is not None:
            arrays["mvi"] = {"gamma_buf":
                             eng._gamma_buf.to("cpu", copy=True).numpy()}
        return meta, arrays

    def restore(self, meta, arrays) -> None:
        if meta["algo"] != self.algo:
            raise ValueError(f"checkpoint algo {meta['algo']!r} != "
                             f"trainer algo {self.algo!r}")
        if bool(meta.get("streamed", False)) != self._streamed:
            kind = "stream-fed" if meta.get("streamed") else "materialized"
            raise ValueError(
                f"checkpoint belongs to a {kind} run: resume it with a "
                "matching data source (DocStream vs padded Corpus); the "
                "epoch bookkeeping of the two ingest paths differs")
        eng = self.eng
        _restore_state(arrays["state"], eng.state)
        if eng.memo is not None:
            if meta.get("memo_kind") != eng.memo.kind:
                raise ValueError(
                    f"checkpoint memo store {meta.get('memo_kind')!r} != "
                    f"configured {eng.memo.kind!r}: the memo is part of "
                    "the algorithm state and is not converted on load")
            eng.memo = eng.memo.load_state_dict(arrays["memo"])
        if eng._gamma_buf is not None:
            buf = np.asarray(arrays["mvi"]["gamma_buf"], np.float32)
            if buf.shape != tuple(eng._gamma_buf.shape):
                raise ValueError(f"mvi γ buffer: checkpoint shape "
                                 f"{buf.shape} != live "
                                 f"{tuple(eng._gamma_buf.shape)}")
            eng._gamma_buf.copy_(torch.from_numpy(buf))
        eng.rng.bit_generator.state = meta["rng"]
        eng.docs_seen = int(meta["docs_seen"])
        eng.history = History(**meta["history"])
        eng._t0 = time.perf_counter() - float(meta["wall_elapsed"])
        self._pending = [
            (np.asarray(arrays["pending"][f"batch_{i:05d}"], np.int64),
             None if w is None else int(w))
            for i, w in enumerate(meta["pending_widths"])]
        if self._streamed:
            self._restore_stream(meta, arrays.get("stream", {}))

    def _restore_stream(self, meta, grp) -> None:
        eng = self.eng
        ck_layout = meta.get("stream_layout", "padded")
        if ck_layout != eng.layout:
            raise ValueError(
                f"checkpoint packs the stream in {ck_layout!r} layout != "
                f"configured {eng.layout!r}: the two layouts emit "
                "different batches, so a mid-epoch resume cannot switch")
        packer = eng._make_packer()
        packer.load_pending([
            (pos, grp[f"pend_{i:05d}_ids"], grp[f"pend_{i:05d}_cnts"])
            for i, pos in enumerate(meta["stream_pending_pos"])])
        eng._packer = packer
        eng._stream_cursor = int(meta["stream_cursor"])
        eng._stream_iter = None          # re-seated at the cursor lazily
        widths = meta["stream_emitted_widths"]
        if eng.layout == "csr":
            eng._stream_emitted = [
                CSRBatch(grp[f"emit_{i:05d}_rows"], grp[f"emit_{i:05d}_ids"],
                         grp[f"emit_{i:05d}_cnts"], grp[f"emit_{i:05d}_segs"],
                         grp[f"emit_{i:05d}_offs"], int(w))
                for i, w in enumerate(widths)]
        else:
            eng._stream_emitted = [
                PackedBatch(grp[f"emit_{i:05d}_rows"],
                            grp[f"emit_{i:05d}_ids"],
                            grp[f"emit_{i:05d}_cnts"], int(w))
                for i, w in enumerate(widths)]


class DIVITrainer(Trainer):
    """``DIVIEngine`` behind the Trainer contract.

    One pass is one global round (``staleness`` sub-rounds of P concurrent
    worker batches), and so is a step. ``data`` is anything the engine
    takes: a padded ``Corpus``, any ``DocStream``, or a pre-built
    ``ShardedDocStream``. The durable state adds the worker memo shards
    and every worker's ingest (its cursor, pass count and the packer's
    open documents) to the global leaves, under ``repro``'s keys, so a save
    mid-pass resumes bit-equal and each package resumes the other's.
    ``restore`` refuses a checkpoint whose shard assignment (worker count,
    partitioner, seed, corpus size) is not the live engine's.

    With a ``mesh`` the trainer is one rank's: ``evaluate``, ``full_bound``
    and ``capture`` are collectives (every rank calls them and gets the
    whole run's values); ``restore`` takes a whole checkpoint (any layout
    of the same worker count wrote it, or the one-device run) and keeps
    the rank's rows of λ and its workers' memos and cursors, placed on the
    device the live engine already uses.
    """

    kind = "divi"

    def __init__(self, cfg: LDAConfig, dcfg: DIVIConfig, data, *,
                 seed: int = 0, test_corpus: Optional[Corpus] = None,
                 mesh=None, data_axes=None, telemetry=None, device=None,
                 tune_store=None):
        if tune_store is not None and cfg.kernel_policy is None \
                and cfg.estep_backend == "cuda":
            # the workers all run the same per-worker batch shape: one
            # lookup covers them (the width is the stream's max_unique,
            # the padded packer's width)
            from repro_torch.tune.resolve import PolicyResolver
            pol = PolicyResolver(tune_store, telemetry=telemetry,
                                 device=device).resolve(
                backend="cuda", layout="padded", b_or_t=dcfg.batch_size,
                v=cfg.vocab_size, k=cfg.num_topics,
                w=getattr(data, "max_unique", None))
            if pol is not None:
                cfg = dataclasses.replace(cfg, kernel_policy=pol)
        self.cfg, self.dcfg = cfg, dcfg
        self.algo = "sivi"          # D-IVI is the eq. 5 protocol distributed
        self.eng = DIVIEngine(cfg, dcfg, data, seed=seed, mesh=mesh,
                              data_axes=data_axes, telemetry=telemetry,
                              device=device)
        self.history = History()
        self._t0 = time.perf_counter()
        if test_corpus is not None:
            self.set_test_corpus(test_corpus, seed=seed)
        else:
            self._obs = self._held = None

    @property
    def state(self) -> GlobalState:
        return self.eng.state

    @property
    def docs_seen(self) -> int:
        return self.eng.docs_seen

    def run_step(self) -> None:
        self.eng.run_round()

    run_pass = run_step

    def evaluate(self) -> Dict[str, float]:
        """Held-out LPP with a test corpus, else the memoized corpus bound
        (``full_bound``). On a mesh a collective."""
        out: Dict[str, float] = {}
        if self._obs is not None:
            out["lpp"] = float(log_predictive(self.cfg, self.eng.gather_lam(),
                                              self._obs, self._held))
            self.history.lpp.append(out["lpp"])
        else:
            out["elbo"] = self.full_bound()
            self.history.elbo.append(out["elbo"])
        self.history.docs_seen.append(self.docs_seen)
        self.history.wall.append(time.perf_counter() - self._t0)
        return out

    def set_test_corpus(self, corpus: Corpus, *, seed: int = 0) -> None:
        self._obs, self._held = split_heldout(corpus.to(self.eng.device),
                                              seed=seed)

    def full_bound(self) -> float:
        """The memoized corpus ELBO over the worker memos, shard by shard:
        each worker's documents are read back through its shard view in
        chunks (`data.stream.iter_padded_chunks`) beside its memo rows, and
        the topics term enters once. Every document lies in one shard, so
        the bound covers the whole corpus. On a mesh a collective: each
        rank takes its workers' terms, and the sum runs over every worker's
        in the simulation's order."""
        eng = self.eng
        lam = eng.gather_lam()
        elog_beta = dirichlet_expectation(lam, axis=0)
        terms = []
        for w, ing in enumerate(eng.ingest):
            for start, ids, cnts in iter_padded_chunks(ing.stream, 512,
                                                       eng.max_unique):
                pi = eng.shard.pi[w, start:start + ids.shape[0]]
                ids_t = torch.from_numpy(ids).to(lam.device)
                cnts_t = torch.from_numpy(cnts).to(lam.device)
                gamma = self.cfg.alpha0 + torch.einsum("blk,bl->bk", pi,
                                                       cnts_t)
                terms.append(float(_memoized_doc_terms(
                    self.cfg, ids_t, cnts_t, gamma, pi, elog_beta)))
        terms = [t for part in eng.gather_workers(terms) for t in part]
        total = 0.0
        for t in terms:
            total += t
        return total + float(_topics_term(self.cfg, lam))

    def capture(self):
        """The whole run's state; on a mesh a collective (every rank gets
        it: λ from every model coordinate, every worker's memo and
        ingest)."""
        eng = self.eng
        captured = [c for part in eng.gather_workers(
            [ing.capture() for ing in eng.ingest]) for c in part]
        ingest_meta, ingest_arrays = [], {}
        for w, (m, arrs) in enumerate(captured):
            ingest_meta.append(m)
            for k, v in arrs.items():
                ingest_arrays[f"w{w:03d}_{k}"] = v
        meta: Dict[str, Any] = {
            "kind": self.kind,
            "algo": "divi",
            "docs_seen": eng.docs_seen,
            "rng": eng.rng.bit_generator.state,
            "history": dataclasses.asdict(self.history),
            "wall_elapsed": time.perf_counter() - self._t0,
            # the shard assignment this state belongs to: restore refuses
            # any other
            "sharding": eng.sharded.signature(),
            "ingest": ingest_meta,
        }
        state = GlobalState(**{
            f: (eng.gather_rows(getattr(eng.state, f))
                if f in ("lam", "m_vk", "init_mass")
                else getattr(eng.state, f)) for f in _STATE_FIELDS})
        pi, visited = eng.gather_memo()
        arrays = {
            "state": _capture_state(state),
            "memo": {"pi": pi.to("cpu", copy=True).numpy(),
                     "visited": visited.to("cpu", copy=True).numpy()},
            "ingest": ingest_arrays,
        }
        return meta, arrays

    def restore(self, meta, arrays) -> None:
        if meta["algo"] != "divi":
            raise ValueError(f"checkpoint algo {meta['algo']!r} is not a "
                             "D-IVI checkpoint")
        eng = self.eng
        if "sharding" not in meta:
            raise ValueError(
                "D-IVI checkpoint predates streaming shards (no shard "
                "assignment recorded): it cannot be resumed by this "
                "version; retrain or restore with the version that wrote it")
        eng.sharded.check_signature(meta["sharding"])
        memo = arrays["memo"]
        pi = np.asarray(memo["pi"])
        whole = (self.dcfg.num_workers,) + tuple(eng.shard.pi.shape[1:])
        if pi.shape != whole:
            raise ValueError(f"worker memo: checkpoint shape {pi.shape} != "
                             f"live {whole}: the checkpoint belongs to a "
                             "different corpus/config")
        mine = slice(eng.workers.start, eng.workers.stop)
        for w, ing in zip(eng.workers, eng.ingest):
            prefix = f"w{w:03d}_"
            ing.restore(meta["ingest"][w],
                        {k[len(prefix):]: v
                         for k, v in arrays.get("ingest", {}).items()
                         if k.startswith(prefix)})
        _restore_state(arrays["state"], eng.state, eng.rows)
        eng.shard.pi.copy_(torch.from_numpy(
            np.array(pi[mine], dtype=np.float32)))
        eng.shard.visited.copy_(torch.from_numpy(
            np.array(np.asarray(memo["visited"])[mine], dtype=bool)))
        eng.rng.bit_generator.state = meta["rng"]
        eng.docs_seen = int(meta["docs_seen"])
        self.history = History(**meta["history"])
        self._t0 = time.perf_counter() - float(meta["wall_elapsed"])


def make_trainer(cfg: LDAConfig, corpus, *, algo: str,
                 distributed: Optional[DIVIConfig] = None,
                 batch_size: int = 64, seed: int = 0,
                 test_corpus: Optional[Corpus] = None,
                 memo_store: str = "dense", chunk_docs: int = 8192,
                 bucket_by_length: bool = False, layout: str = "padded",
                 token_budget: Optional[int] = None, mesh=None,
                 data_axes=None, telemetry=None, device=None,
                 tune_store=None) -> Trainer:
    """Bind a corpus (or ``DocStream``) to its Trainer: ``DIVITrainer``
    with ``distributed`` (any data source: D-IVI shards a stream into
    worker views, a padded ``Corpus`` is wrapped on the way in), else
    ``SingleHostTrainer``. ``tune_store`` is a `repro_torch.tune` policy
    store consulted once for a tuned kernel policy (``cuda`` backend; an
    explicit ``cfg.kernel_policy`` wins)."""
    if distributed is not None:
        if layout != "padded":
            raise ValueError("distributed training packs padded worker "
                             "batches; layout='csr' is single-host only")
        return DIVITrainer(cfg, distributed, corpus, seed=seed,
                           test_corpus=test_corpus, mesh=mesh,
                           data_axes=data_axes, telemetry=telemetry,
                           device=device, tune_store=tune_store)
    return SingleHostTrainer(cfg, corpus, algo=algo, batch_size=batch_size,
                             seed=seed, test_corpus=test_corpus,
                             memo_store=memo_store, chunk_docs=chunk_docs,
                             bucket_by_length=bucket_by_length,
                             layout=layout, token_budget=token_budget,
                             telemetry=telemetry, device=device,
                             tune_store=tune_store)
