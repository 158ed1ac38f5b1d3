"""``LDA``: one estimator facade for train / resume / serve.

The port's counterpart of ``repro.lda.api``, with the same constructor,
verbs and refusals:

    lda = LDA(num_topics=100, vocab_size=141_927, algo="ivi",
              backend="cuda", batch_size=1024)
    lda.fit(train, epochs=2, test_corpus=test, eval_every=1)    # train
    lda.save("ckpt/run1")
    lda = LDA.load("ckpt/run1").resume(train)                   # resume
    lda.partial_fit(steps=2)        # bit-equal to never having stopped
    theta = lda.transform(unseen)                               # serve

Training goes through a ``Trainer`` (`repro_torch.lda.trainer`) over
``LDAEngine``, or over ``DIVIEngine`` for D-IVI (``algo="divi"`` or
``distributed=DIVIConfig(...)``: P workers simulated on one device, a
round a step, ``fit(rounds=)``), so a facade run is bit-equal to driving
the engine with the same seed and λ₀. Serving goes through
`repro_torch.lda.infer`; checkpoints are ``repro``'s manifests
(`repro_torch.lda.ckpt`), so each package resumes the other's.

The facade runs on ``device`` (the card unless the caller names another).
λ₀ is drawn from a ``torch.Generator``, which cannot reproduce
``repro``'s ``jax.random`` draw: to start both packages from one point,
load a ``repro`` checkpoint or hand λ₀ to ``warm_start`` (single-host
engines). ``tune_store`` resolves a tuned kernel policy for the bound
training shape (`repro_torch.tune`), as ``repro``'s facade does.

D-IVI over a mesh: ``LDA(algo="divi", mesh=make_host_mesh(D, M))`` in
every process of the group (`repro_torch.launch.mesh`; one process a
mesh position, as ``torchrun`` starts them) trains the mesh round
(`repro_torch.dist.divi`). The estimator is then one rank's, and every
call that needs the full topics is a collective that every rank makes:
``fit``/``partial_fit``, ``bound``, ``evaluate``, ``score``,
``transform``/``posterior``, ``inferencer``, ``top_words``, ``save`` and
``gather_lam`` (``lam`` itself refuses, as λ is sharded). ``save`` writes
the one-device run's checkpoint from rank 0; ``LDA.load(path).resume(
corpus, mesh=...)`` continues it on any layout with the same worker
count.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.engines import History
from repro_torch.core.metrics import top_words as _top_words
from repro_torch.core.predictive import log_predictive, split_heldout
from repro_torch.core.types import (Corpus, GlobalState, LDAConfig,
                                    resolve_device)
from repro_torch.dist.protocol import DIVIConfig
from repro_torch.launch.mesh import check_mesh
from repro_torch.lda.infer import TopicInferencer
from repro_torch.lda.trainer import Trainer, make_trainer
from repro_torch.obs import as_telemetry

_ALGOS = ("mvi", "svi", "ivi", "sivi", "divi")


def _check_mesh(mesh, data_axes, distributed) -> None:
    """A mesh is D-IVI's, a live ``DeviceMesh``; data axes need one."""
    if mesh is None:
        if data_axes is not None:
            raise ValueError("data_axes names axes of a mesh: pass mesh=")
        return
    if distributed is None:
        raise ValueError(
            "mesh= lays out D-IVI's workers and topics over processes: "
            "single-host training runs on one device (use algo='divi' or "
            "distributed=DIVIConfig(...))")
    check_mesh(mesh)


class LDA:
    """Latent Dirichlet Allocation estimator (see module docstring).

    Args:
      cfg: an ``LDAConfig``, or its fields as keyword arguments.
      algo: ``"mvi" | "svi" | "ivi" | "sivi" | "divi"``; ``"divi"`` is
        S-IVI under the distributed protocol (``algo="sivi",
        distributed=DIVIConfig()``).
      distributed: a ``DIVIConfig`` to train with D-IVI's P workers,
        simulated on ``device``.
      backend: E-step backend override (``gather | dense | cuda | csr``).
      memo_store / chunk_docs: the π memo of the incremental engines
        (``dense | chunked | gamma``).
      bucket_by_length: length-bucketed epoch batching.
      layout / token_budget: ``"padded"`` batches, or ``"csr"`` flat token
        batches of ``token_budget`` slots (a padded ``Corpus`` is then
        streamed).
      mesh / data_axes: D-IVI's mesh round: a ``DeviceMesh``
        (`repro_torch.launch.mesh.make_host_mesh`) and the axes that shard
        the workers (default: every axis but ``model``); distributed
        training only.
      telemetry: `repro_torch.obs` (None/False off, True defaults, or a
        ``Telemetry``), threaded through the trainer, the engine, the
        packer and the inferencers this estimator makes.
      tune_store: a `repro_torch.tune` policy store (path or
        ``PolicyStore``): the trainer looks up the policy for its shape
        once when a corpus is bound (``cuda`` backend), and the facade
        copies what it found onto ``cfg``, so checkpoints carry it; the
        inferencers this estimator makes resolve their own shapes from it.
        An explicit ``cfg.kernel_policy`` always wins.
      device: where training and serving run; the card unless named.
    """

    def __init__(self, cfg: Optional[LDAConfig] = None, *,
                 algo: str = "ivi",
                 distributed: Optional[DIVIConfig] = None,
                 batch_size: int = 64, seed: int = 0,
                 memo_store: str = "dense", chunk_docs: int = 8192,
                 bucket_by_length: bool = False,
                 backend: Optional[str] = None, layout: str = "padded",
                 token_budget: Optional[int] = None,
                 mesh=None, data_axes=None, telemetry=None,
                 tune_store=None, device=None, **cfg_kwargs):
        if cfg is None:
            cfg = LDAConfig(**cfg_kwargs)
        elif cfg_kwargs:
            raise TypeError("pass either a full LDAConfig or LDAConfig "
                            f"fields as kwargs, not both: {sorted(cfg_kwargs)}")
        if backend is not None and backend != cfg.estep_backend:
            cfg = dataclasses.replace(cfg, estep_backend=backend)
        if algo not in _ALGOS:
            raise ValueError(f"unknown algo {algo!r} (have {_ALGOS})")
        if layout not in ("padded", "csr"):
            raise ValueError(f"unknown layout {layout!r} "
                             "(expected 'padded' or 'csr')")
        if layout == "csr" and bucket_by_length:
            raise ValueError("bucket_by_length is the padded layout's "
                             "padding mitigation; layout='csr' has no "
                             "width buckets to begin with")
        if algo == "divi" and distributed is None:
            distributed = DIVIConfig()
        if distributed is not None and algo not in ("sivi", "divi"):
            raise ValueError(
                f"distributed training runs the S-IVI update (eq. 5): "
                f"algo={algo!r} is incompatible; use algo='sivi' or 'divi'")
        _check_mesh(mesh, data_axes, distributed)
        self.cfg = cfg
        self.algo = algo
        self.distributed = distributed
        self.batch_size = batch_size
        self.seed = seed
        self.memo_store = memo_store
        self.chunk_docs = chunk_docs
        self.bucket_by_length = bucket_by_length
        self.layout = layout
        self.token_budget = token_budget if layout == "csr" else None
        self.telemetry = as_telemetry(telemetry)
        self.tune_store = tune_store
        self._mesh, self._data_axes = mesh, data_axes
        self._cfg_pre_tune = None     # cfg before the store's policy, if any
        self.device = resolve_device(device)
        self.trainer: Optional[Trainer] = None
        self._corpus = None           # the coerced Corpus | DocStream
        self._corpus_raw = None       # the object the caller passed
        # set by LDA.load(): a state view to serve from before resume(), and
        # the trainer payload resume() restores; a legacy bare-λ load sets
        # _serve_only (nothing to resume, training refused)
        self._state_view: Optional[GlobalState] = None
        self._pending_restore = None
        self._serve_only = False

    # ------------------------------------------------------------------
    # lifecycle: fit / partial_fit / warm_start / resume
    # ------------------------------------------------------------------

    def _coerce_data(self, data):
        """A padded ``Corpus`` (streamed under ``layout='csr'``), a
        ``DocStream``, a pre-dealt ``ShardedDocStream`` (D-IVI), or any
        iterable of documents (wrapped as a stream)."""
        if data is None:
            return data
        from repro_torch.data.stream import (CorpusDocStream, ListDocStream,
                                             ShardedDocStream, is_doc_stream)
        if isinstance(data, Corpus):
            if self.layout == "csr":
                return CorpusDocStream(data, vocab_size=self.cfg.vocab_size)
            return data
        if isinstance(data, ShardedDocStream):
            # already dealt into worker views: the distributed engine takes
            # it as it is (it is no DocStream itself: it has no cursor)
            if self.distributed is None:
                raise ValueError(
                    "a ShardedDocStream is the distributed ingest form; "
                    "single-host training takes the base DocStream (pass "
                    "sharded.base, or set distributed=DIVIConfig(...))")
            if data.vocab_size > self.cfg.vocab_size:
                raise ValueError(
                    f"stream vocab_size {data.vocab_size} exceeds the "
                    f"model's {self.cfg.vocab_size}")
            return data
        if is_doc_stream(data):
            if data.vocab_size > self.cfg.vocab_size:
                raise ValueError(
                    f"stream vocab_size {data.vocab_size} exceeds the "
                    f"model's {self.cfg.vocab_size}")
            return data
        return ListDocStream(data, vocab_size=self.cfg.vocab_size)

    def _bind(self, corpus, test_corpus: Optional[Corpus] = None) -> Trainer:
        raw = corpus
        if raw is not None and raw is self._corpus_raw:
            corpus = self._corpus
        else:
            corpus = self._coerce_data(corpus)
        if self._pending_restore is not None:
            raise ValueError(
                "this estimator holds an unrestored checkpoint: call "
                "resume(corpus) to continue the checkpointed run (fit/"
                "partial_fit on it would silently retrain from scratch)")
        if self._serve_only:
            raise ValueError(
                "this estimator was loaded from a legacy bare-λ checkpoint "
                "and is serve-only (transform/score/top_words); training "
                "it would discard the loaded topics: build a fresh "
                "LDA(...) instead")
        if self.trainer is not None:
            if corpus is not None and corpus is not self._corpus:
                raise ValueError(
                    "this estimator is already bound to a corpus; build a "
                    "new LDA(...) to train on different data")
            if test_corpus is not None:
                self.trainer.set_test_corpus(test_corpus, seed=self.seed)
            return self.trainer
        if corpus is None:
            raise ValueError("first fit/partial_fit call must pass a corpus")
        self.trainer = make_trainer(
            self.cfg, corpus, algo=self.algo, distributed=self.distributed,
            batch_size=self.batch_size, seed=self.seed,
            test_corpus=test_corpus, memo_store=self.memo_store,
            chunk_docs=self.chunk_docs,
            bucket_by_length=self.bucket_by_length, layout=self.layout,
            token_budget=self.token_budget, mesh=self._mesh,
            data_axes=self._data_axes, telemetry=self.telemetry,
            device=self.device, tune_store=self.tune_store)
        pol = self.trainer.cfg.kernel_policy
        if pol != self.cfg.kernel_policy:
            # the trainer's store lookup found a policy for the bound
            # shape: it rides on ``self.cfg``, which checkpoints write
            self._cfg_pre_tune = self.cfg
            self.cfg = dataclasses.replace(self.cfg, kernel_policy=pol)
        self._corpus = corpus
        self._corpus_raw = raw
        return self.trainer

    def fit(self, corpus=None, *, epochs: int = 1,
            rounds: Optional[int] = None,
            test_corpus: Optional[Corpus] = None, eval_every: int = 0,
            verbose: bool = False) -> "LDA":
        """Train ``epochs`` full passes (single host) or ``rounds`` global
        rounds (D-IVI; ``epochs`` when unset); repeated calls continue on
        the bound corpus. ``corpus``: a padded ``Corpus``, a ``DocStream``
        (one pass over it per epoch) or an iterable of documents."""
        tr = self._bind(corpus, test_corpus)
        if rounds is not None and self.distributed is None:
            raise ValueError("rounds= applies to distributed training; "
                             "single-host engines take epochs=")
        n = (rounds if rounds is not None else epochs) \
            if self.distributed is not None else epochs
        unit = "round" if self.distributed is not None else "epoch"
        for i in range(n):
            tr.run_pass()
            if eval_every and (i + 1) % eval_every == 0:
                ev = tr.evaluate()
                if verbose:
                    metrics = " ".join(f"{k}={v:.4f}"
                                       for k, v in sorted(ev.items()))
                    print(f"{unit}={i + 1} docs={tr.docs_seen} {metrics}")
        return self

    def partial_fit(self, corpus=None, *, steps: int = 1,
                    test_corpus: Optional[Corpus] = None) -> "LDA":
        """Run ``steps`` smallest resumable units (mini-batches; D-IVI:
        rounds), each in a ``train/step`` span while spans are on."""
        tr = self._bind(corpus, test_corpus)
        trace = self.telemetry.trace
        for _ in range(steps):
            sp = trace.begin("train/step") if self.telemetry.spans_on \
                else None
            tr.run_step()
            if sp is not None:
                trace.end(sp)
        return self

    def warm_start(self, lam) -> "LDA":
        """Seed an untrained bound trainer's topics from λ₀.

        λ₀ plays the random initialisation's role, booked as
        ``init_global_state`` books it: λ = λ₀, ``init_mass = λ₀ − β₀`` at
        ``init_frac = 1`` with an empty accumulator (⟨m_vk⟩ = 0, t = 0).
        Each document's share of that mass retires on its first visit, so
        after one full pass λ = β₀ + ⟨m_vk⟩ and the memoized bound is
        monotone from then on. Bind a corpus first without training:
        ``lda.partial_fit(corpus, steps=0)``.
        """
        tr = self._require_trainer()
        if tr.kind != "single":
            raise ValueError("warm_start drives the single-host incremental "
                             "engines; seed a distributed run by "
                             "checkpointing instead")
        if int(tr.state.t) != 0 or tr.docs_seen:
            raise ValueError(
                "warm_start needs an untrained estimator: this one has "
                f"already run {tr.docs_seen} docs (t={int(tr.state.t)}); "
                "its memo/accumulator bookkeeping would no longer match "
                "the swapped λ")
        st = tr.state
        lam0 = torch.as_tensor(lam, dtype=torch.float32).to(st.lam.device)
        if lam0.shape != st.lam.shape:
            raise ValueError(f"λ shape {tuple(lam0.shape)} != model "
                             f"{tuple(st.lam.shape)}")
        st.lam.copy_(lam0)
        st.m_vk.zero_()
        st.init_mass.copy_(st.lam - self.cfg.beta0)
        st.init_frac.fill_(1.0)
        st.t.zero_()
        return self

    def resume(self, corpus, *, test_corpus: Optional[Corpus] = None,
               mesh=None, data_axes=None) -> "LDA":
        """Rebind the corpus (or ``DocStream``) and restore the
        checkpointed trainer state: the run continues bit-equal to one
        that never stopped. The corpus is data, not state: it is not in
        the checkpoint and must be passed again. ``mesh``/``data_axes``
        resume a D-IVI checkpoint as the mesh round, on any layout of its
        worker count (every rank calls this)."""
        if mesh is not None or data_axes is not None:
            _check_mesh(mesh, data_axes, self.distributed)
            self._mesh, self._data_axes = mesh, data_axes
        if self._pending_restore is None:
            raise ValueError(
                "nothing to resume: this estimator was not produced by "
                "LDA.load(), or resume() already ran (legacy bare-λ "
                "checkpoints restore λ only and cannot resume: retrain or "
                "re-save through LDA.save)")
        meta, arrays = self._pending_restore
        self._pending_restore = None         # consumed before _bind's guard
        try:
            tr = self._bind(corpus, test_corpus)
            tr.restore(meta, arrays)
        except Exception:
            self._pending_restore = (meta, arrays)
            self.trainer = self._corpus = self._corpus_raw = None
            raise
        self._state_view = None
        return self

    # ------------------------------------------------------------------
    # serve: transform / posterior / score
    # ------------------------------------------------------------------

    def inferencer(self, *, backend: Optional[str] = None,
                   batch_size: int = 256, layout: Optional[str] = None,
                   token_budget: Optional[int] = None, telemetry=None,
                   tune_store=None) -> TopicInferencer:
        """A reusable serving handle over the current topics (Eφ computed
        once), in the training layout unless ``layout`` is given, resolving
        its own shapes from ``tune_store`` (the estimator's by default)."""
        layout = self.layout if layout is None else layout
        if token_budget is None and layout == self.layout:
            token_budget = self.token_budget
        # a training-shape policy from the store must not ride into
        # serving's shapes: the inferencer gets the cfg before the store's
        # policy and looks its own up (an explicit policy still wins)
        cfg = self.cfg if self._cfg_pre_tune is None else self._cfg_pre_tune
        return TopicInferencer(
            cfg, self.gather_lam(), backend=backend, batch_size=batch_size,
            layout=layout, token_budget=token_budget,
            telemetry=self.telemetry if telemetry is None else telemetry,
            tune_store=self.tune_store if tune_store is None else tune_store,
            device=self.device)

    def transform(self, corpus: Corpus, *, backend: Optional[str] = None,
                  batch_size: int = 256) -> np.ndarray:
        """θ̄ (D, K): the normalised topic posterior of documents."""
        return self.inferencer(backend=backend,
                               batch_size=batch_size).transform(corpus)

    def posterior(self, corpus: Corpus, *, backend: Optional[str] = None,
                  batch_size: int = 256) -> np.ndarray:
        """γ (D, K): the Dirichlet posterior parameters."""
        return self.inferencer(backend=backend,
                               batch_size=batch_size).posterior(corpus)

    def posterior_docs(self, docs, *, backend: Optional[str] = None,
                       batch_size: int = 256,
                       double_buffer: bool = True) -> np.ndarray:
        """γ (N, K) for ragged request documents (a ``DocStream`` or an
        iterable of documents), double-buffered by default."""
        return self.inferencer(backend=backend,
                               batch_size=batch_size).posterior_docs(
                                   docs, double_buffer=double_buffer)

    def score(self, corpus: Corpus, *, seed: Optional[int] = None) -> float:
        """Held-out per-word log predictive probability (the paper's §6
        metric): θ fitted on half of each document's words, the other half
        scored."""
        obs, held = split_heldout(corpus.to(self.device),
                                  seed=self.seed if seed is None else seed)
        return float(log_predictive(self.cfg, self.gather_lam(), obs, held))

    def perplexity(self, corpus: Corpus, *,
                   seed: Optional[int] = None) -> float:
        """exp(−lpp) on held-out halves. Lower is better."""
        return float(np.exp(-self.score(corpus, seed=seed)))

    def top_words(self, k: int = 10) -> np.ndarray:
        """(K, k) token ids of each topic's most probable words."""
        return _top_words(self.gather_lam(), k)

    def coherence(self, corpus: Corpus, *, k: int = 10) -> float:
        """Mean NPMI coherence of each topic's top ``k`` words under
        ``corpus``'s co-occurrences."""
        from repro_torch.core.metrics import npmi_coherence
        return npmi_coherence(self.gather_lam(), corpus, k=k)

    def effective_topics(self) -> float:
        """exp(entropy) of corpus-level topic usage."""
        from repro_torch.core.metrics import effective_topics
        return effective_topics(self.gather_lam())

    def bound(self) -> float:
        """The exact corpus ELBO (for IVI the memoized bound, the objective
        it increases monotonically); it feeds the telemetry watchdog as
        ``evaluate()`` does. On a mesh a collective."""
        tr = self._require_trainer()
        b = tr.full_bound()
        eng = tr.eng
        # D-IVI averages the guarantee away: its readings are never armed
        if (tr.kind == "single" and eng.tel.enabled
                and eng.tel.watchdog.enabled
                and eng.algo in ("ivi", "sivi")):
            eng.tel.watchdog.observe(b, step=eng._updates,
                                     armed=eng._watchdog_armed())
        return b

    def evaluate(self) -> Dict[str, float]:
        """One History row: held-out LPP with a test corpus, else the
        corpus bound."""
        return self._require_trainer().evaluate()

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------

    def save(self, path: str) -> str:
        """Write a manifest checkpoint of the full state. On a mesh a
        collective: rank 0 writes the one-device run's checkpoint, the
        others wait for it."""
        from repro_torch.lda.ckpt import save_lda_checkpoint
        return save_lda_checkpoint(path, self)

    @classmethod
    def load(cls, path: str, *, telemetry=None, device=None) -> "LDA":
        """Load a checkpoint (the port's or ``repro``'s). Serving works at
        once; call ``resume(corpus)`` before training on. Telemetry is
        process state, never saved: pass it here."""
        from repro_torch.lda.ckpt import load_lda_checkpoint
        lda = load_lda_checkpoint(path, device=device)
        lda.telemetry = as_telemetry(telemetry)
        return lda

    # ------------------------------------------------------------------
    # views
    # ------------------------------------------------------------------

    def _require_trainer(self) -> Trainer:
        if self.trainer is None:
            raise ValueError("not fitted: call fit()/partial_fit() first"
                             + (" or resume(corpus)"
                                if self._pending_restore else ""))
        return self.trainer

    @property
    def state(self) -> GlobalState:
        if self.trainer is not None:
            return self.trainer.state
        if self._state_view is not None:
            return self._state_view
        raise ValueError("not fitted and no checkpoint state loaded")

    @property
    def lam(self) -> torch.Tensor:
        """λ (V, K); on a mesh it is sharded and this refuses: call
        ``gather_lam()`` on every rank."""
        if self.trainer is not None and self.trainer.kind == "divi":
            return self.trainer.eng.lam
        return self.state.lam

    def gather_lam(self) -> torch.Tensor:
        """The full λ (V, K): ``lam``, or on a mesh a collective that every
        rank calls."""
        if self.trainer is not None and self.trainer.kind == "divi":
            return self.trainer.eng.gather_lam()
        return self.state.lam

    @property
    def docs_seen(self) -> int:
        return self._require_trainer().docs_seen

    @property
    def history(self) -> History:
        return self._require_trainer().history
