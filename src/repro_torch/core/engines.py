"""Single-host inference engines for LDA: MVI, SVI, IVI, S-IVI.

All four consume the E-step through the ``EStepBackend`` contract and the
incremental engines reach their π memo through ``MemoStore``; they differ
only in how the global topic-word parameter λ is updated, the contrast the
paper draws:

* **MVI** (batch, Blei et al. 2003): λ = β₀ + Σ_d s_d after a full pass,
  each document's E-step warm-started from its previous visit.
* **SVI** (Hoffman et al. 2013, eq. 3): λ ← (1−ρ_t)λ + ρ_t(β₀ + (D/|B|)·s_B).
* **IVI** (the paper, eq. 4 / Alg. 1): memoize per-document π; maintain the
  exact accumulator ⟨m_vk⟩ by subtract-old/add-new; λ = β₀ + ⟨m_vk⟩. No
  learning rate; monotone in the memoized ELBO once every document has
  been visited.
* **S-IVI** (eq. 5): the IVI correction inside a Robbins–Monro average:
  λ ← (1−ρ_t)λ + ρ_t(β₀ + ⟨m_vk⟩⁺).

The random-initialisation mass is carried explicitly (``init_mass``) and
each document's pro-rata share retires on its first visit, so after one
full pass ⟨m_vk⟩ == Σ_d s_d exactly.

``LDAEngine`` trains on a materialized padded ``Corpus`` (optionally in
length buckets) or on a ``DocStream`` (`repro_torch.data.stream`), packed
per mini-batch in the padded layout at a ladder width or in the flat CSR
layout (``incremental_update_csr``, ``svi_step_csr``), with the dense,
bf16-chunked or γ-only memo store and optional telemetry
(`repro_torch.obs`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.bound import (elbo_collapsed, elbo_collapsed_stream,
                                    elbo_memoized_store, elbo_memoized_stream)
from repro_torch.core.estep import (BowBatch, CSRTokenBatch, estep,
                                    estep_gather, get_backend)
from repro_torch.core.math import exp_dirichlet_expectation
from repro_torch.core.memo import MemoStore, make_memo_store
from repro_torch.core.metrics import effective_topics
from repro_torch.core.predictive import log_predictive, split_heldout
from repro_torch.core.types import (Corpus, GlobalState, LDAConfig, Memo,
                                    init_global_state, resolve_device)
from repro_torch.data.bow import bucket_corpus, bucket_padding_stats
from repro_torch.data.stream import BatchPacker, CSRBatch, is_doc_stream
from repro_torch.obs import as_telemetry


# ---------------------------------------------------------------------------
# MVI — batch coordinate ascent
# ---------------------------------------------------------------------------

def mvi_scan(cfg: LDAConfig, eb: torch.Tensor, ids_b: torch.Tensor,
             cnts_b: torch.Tensor, doc_idx_b: torch.Tensor,
             gamma_buf: torch.Tensor, sstats: torch.Tensor):
    """The E-step over stacked batches, accumulating Σ_d s_d.

    ids_b/cnts_b/doc_idx_b: (num_batches, B, ...). γ persists across epochs
    in ``gamma_buf`` (D+1, K), updated in place: each document's E-step
    resumes from α₀ + Σ_l cnt·π of its previous visit (batch coordinate
    ascent, and the warm start the incremental engines use), so full-batch
    IVI and MVI follow one trajectory. Row D is the sentinel slot the tail
    batch's padding reads and writes: every such write is α₀ + Σ 0·π = α₀,
    so which duplicate lands last does not matter. Returns (sstats,
    gamma_buf).
    """
    for ids, cnts, idx in zip(ids_b, cnts_b, doc_idx_b):
        res = estep(cfg, eb, ids, cnts, gamma_buf[idx])
        gamma_buf[idx] = cfg.alpha0 + torch.einsum("blk,bl->bk", res.pi,
                                                   cnts)
        sstats = sstats + res.sstats
    return sstats, gamma_buf


# ---------------------------------------------------------------------------
# SVI — stochastic natural gradient (eq. 3)
# ---------------------------------------------------------------------------

def _svi_global_update(cfg: LDAConfig, state: GlobalState,
                       sstats: torch.Tensor, scale) -> GlobalState:
    """λ ← (1−ρ_t)λ + ρ_t(β₀ + scale·s_B), in place; bumps ``t``."""
    lam_hat = cfg.beta0 + scale * sstats
    rho = cfg.rho(state.t + 1)
    state.lam.copy_((1.0 - rho) * state.lam + rho * lam_hat)
    state.t.add_(1)
    return state


def svi_step(cfg: LDAConfig, state: GlobalState, ids: torch.Tensor,
             cnts: torch.Tensor, num_docs_total: float):
    """Eq. 3 on a padded (B, W) batch, the state updated in place (``repro``
    donates it). Returns (state, fixed-point sweeps)."""
    eb = exp_dirichlet_expectation(state.lam, axis=0)
    res = estep(cfg, eb, ids, cnts)
    state = _svi_global_update(cfg, state, res.sstats,
                               num_docs_total / ids.shape[0])
    return state, res.iters


def svi_step_csr(cfg: LDAConfig, state: GlobalState, ids: torch.Tensor,
                 cnts: torch.Tensor, segs: torch.Tensor, batch_docs: int,
                 num_docs_total: float, *, num_docs: int):
    """Eq. 3 on a flat CSR token batch, in place.

    ``num_docs`` is the segment capacity (the engine pads it to
    ``batch_size``); ``batch_docs`` is the live-document count the
    natural-gradient scale divides by. Phantom documents own no tokens, so
    they add nothing to the sstats, but they do count in the fixed point's
    batch-wide mean, as in ``repro``. Returns (state, sweeps).
    """
    eb = exp_dirichlet_expectation(state.lam, axis=0)
    res = get_backend(cfg.estep_backend).solve_tokens(
        cfg, eb, CSRTokenBatch(ids, cnts, segs), num_docs=num_docs)
    state = _svi_global_update(cfg, state, res.sstats,
                               num_docs_total / batch_docs)
    return state, res.iters


# ---------------------------------------------------------------------------
# IVI / S-IVI — incremental updates (eqs. 4 & 5)
# ---------------------------------------------------------------------------

def memo_correction(cfg: LDAConfig, eb: torch.Tensor, ids: torch.Tensor,
                    cnts: torch.Tensor, old_pi: torch.Tensor,
                    visited_rows: torch.Tensor, pi_dtype: str = "float32"):
    """E-step + subtract-old/add-new core shared by IVI and S-IVI.

    Returns (correction (V, K), first-visit word count, EStepResult).
    """
    return get_backend(cfg.estep_backend).solve_correction(
        cfg, eb, BowBatch(ids, cnts), old_pi, visited_rows, pi_dtype)


def retire_init_frac(init_frac: torch.Tensor, words_first: torch.Tensor,
                     num_words_total: torch.Tensor) -> torch.Tensor:
    """Retire the first-visit words' pro-rata share of the random-init mass.

    Snaps the fp32 subtraction residue to an exact zero once every document
    has been visited, so λ = β₀ + ⟨m_vk⟩ holds exactly afterwards (eq. 4).
    """
    frac = torch.clamp(init_frac - words_first / num_words_total, min=0.0)
    return torch.where(frac < 1e-6, 0.0, frac)


def sivi_global_update(cfg: LDAConfig, state: GlobalState,
                       corr: torch.Tensor, frac: torch.Tensor):
    """Eq. 5 global step: λ ← (1−ρ_t)λ + ρ_t(β₀ + ⟨m_vk⟩⁺ + frac·init_mass).

    Returns (λ, ⟨m_vk⟩⁺); the caller bumps ``t``.
    """
    m_vk = state.m_vk + corr
    lam_hat = cfg.beta0 + m_vk + frac * state.init_mass
    rho = cfg.rho(state.t + 1)
    lam = (1.0 - rho) * state.lam + rho * lam_hat
    return lam, m_vk


def _apply_correction(cfg: LDAConfig, averaged: bool, state: GlobalState,
                      corr: torch.Tensor, words_first: torch.Tensor,
                      num_words_total: torch.Tensor) -> GlobalState:
    """THE eq. 4 / eq. 5 global step, in place: ``repro`` donates the state
    to its update (engines.py:196), so the pre-update state is consumed
    either way."""
    frac = retire_init_frac(state.init_frac, words_first, num_words_total)
    if averaged:
        lam, m_vk = sivi_global_update(cfg, state, corr, frac)
        state.m_vk.copy_(m_vk)
        state.lam.copy_(lam)
    else:
        state.m_vk.add_(corr)
        state.lam.copy_(cfg.beta0 + state.m_vk + frac * state.init_mass)
    state.init_frac.copy_(frac)
    state.t.add_(1)
    return state


def incremental_update(cfg: LDAConfig, averaged: bool, state: GlobalState,
                       ids: torch.Tensor, cnts: torch.Tensor,
                       old_pi: torch.Tensor, visited: torch.Tensor,
                       num_words_total: torch.Tensor,
                       pi_dtype: str = "float32"):
    """One IVI (``averaged=False``, eq. 4) or S-IVI (eq. 5) global update on
    a padded (B, W) batch, the state updated in place.

    Takes the gathered (π_old, visited) rows from a ``MemoStore`` and
    returns what the caller writes back: (state, EStepResult (π_new (B, W,
    K) rounded through ``pi_dtype``, the sweeps), Eφ). Eφ, the one the
    E-step ran against, is what a γ-only store snapshots.
    """
    eb = exp_dirichlet_expectation(state.lam, axis=0)
    corr, words_first, res = memo_correction(cfg, eb, ids, cnts, old_pi,
                                             visited, pi_dtype)
    state = _apply_correction(cfg, averaged, state, corr, words_first,
                              num_words_total)
    return state, res, eb


def _csr_gather_flat(old_pi: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """Doc-aligned memo rows (B, W, K) → token-aligned (T, K) through the
    host-built flat index; padding tokens carry the sentinel index B·W,
    which lands on an appended zero row."""
    b, w, k = old_pi.shape
    flat = torch.cat([old_pi.reshape(b * w, k),
                      torch.zeros((1, k), dtype=old_pi.dtype,
                                  device=old_pi.device)])
    return flat[ix]


def _csr_scatter_flat(pi: torch.Tensor, ix: torch.Tensor, b: int,
                      w: int) -> torch.Tensor:
    """Inverse of ``_csr_gather_flat``: token-aligned π back onto the
    (B, W, K) memo wire. Padding tokens all target the sentinel row, which
    is dropped; memo slots no token maps to stay zero."""
    k = pi.shape[-1]
    buf = torch.zeros((b * w + 1, k), dtype=pi.dtype, device=pi.device)
    buf[ix] = pi
    return buf[: b * w].reshape(b, w, k)


def incremental_update_csr(cfg: LDAConfig, averaged: bool,
                           state: GlobalState, ids: torch.Tensor,
                           cnts: torch.Tensor, segs: torch.Tensor,
                           ix: torch.Tensor, old_pi: torch.Tensor,
                           visited: torch.Tensor,
                           num_words_total: torch.Tensor,
                           pi_dtype: str = "float32"):
    """``incremental_update`` on a flat CSR token batch, in place.

    The same eq. 4 / eq. 5 algebra and quantize-then-rescatter memo wire;
    only the (B, L) token axes are replaced by one (T,) stream plus the
    flat index ``ix`` that maps each token slot onto its (doc, position)
    memo cell. The memo stays doc-aligned (B, W, K): old π rows are
    gathered through ``ix`` on the way in and the result's π is scattered
    back through it on the way out. Returns (state, EStepResult with π
    (B, W, K), Eφ).
    """
    b, w, _ = old_pi.shape
    eb = exp_dirichlet_expectation(state.lam, axis=0)
    corr, words_first, res = get_backend(
        cfg.estep_backend).solve_correction_tokens(
            cfg, eb, CSRTokenBatch(ids, cnts, segs),
            _csr_gather_flat(old_pi, ix), visited, pi_dtype)
    state = _apply_correction(cfg, averaged, state, corr, words_first,
                              num_words_total)
    return state, res._replace(pi=_csr_scatter_flat(res.pi, ix, b, w)), eb


def _raw_memo_step(cfg: LDAConfig, averaged: bool, state: GlobalState,
                   memo: Memo, ids: torch.Tensor, cnts: torch.Tensor,
                   doc_idx: torch.Tensor, num_words_total: torch.Tensor):
    """One eq. 4 / eq. 5 update on a raw ``Memo``: the same core as the
    engines, the memo rows ``doc_idx`` gathered and written back in place.
    Returns (state, memo)."""
    state, res, _ = incremental_update(
        cfg, averaged, state, ids, cnts, memo.pi[doc_idx],
        memo.visited[doc_idx], num_words_total)
    memo.pi[doc_idx] = res.pi
    memo.visited[doc_idx] = True
    return state, memo


def ivi_step(cfg: LDAConfig, state: GlobalState, memo: Memo,
             ids: torch.Tensor, cnts: torch.Tensor, doc_idx: torch.Tensor,
             num_words_total: torch.Tensor):
    """Algorithm 1: partial E-step, then the exact incremental M-step
    (eq. 4), on a raw memo, in place."""
    return _raw_memo_step(cfg, False, state, memo, ids, cnts, doc_idx,
                          num_words_total)


def sivi_step(cfg: LDAConfig, state: GlobalState, memo: Memo,
              ids: torch.Tensor, cnts: torch.Tensor, doc_idx: torch.Tensor,
              num_words_total: torch.Tensor):
    """Eq. 5: the incremental estimate inside a Robbins–Monro average, on a
    raw memo, in place."""
    return _raw_memo_step(cfg, True, state, memo, ids, cnts, doc_idx,
                          num_words_total)


# ---------------------------------------------------------------------------
# Host-side loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class History:
    docs_seen: List[int] = dataclasses.field(default_factory=list)
    elbo: List[float] = dataclasses.field(default_factory=list)
    lpp: List[float] = dataclasses.field(default_factory=list)
    wall: List[float] = dataclasses.field(default_factory=list)


class LDAEngine:
    """The host-side loop: shuffling, mini-batching, evaluation, timing.

    ``algo`` is ``mvi``, ``svi``, ``ivi`` or ``sivi``. ``corpus`` is a
    materialized padded ``Corpus`` or a ``DocStream``
    (`repro_torch.data.stream`): ragged documents pulled and packed per
    mini-batch, so no (D, L) corpus is resident. One pass over a stream is
    one epoch, in stream order; packing is bit-transparent, so a
    padded-layout stream run reproduces the materialized run under the same
    batch schedule. ``layout="csr"`` (a stream only) packs each mini-batch
    as one flat stream of ``token_budget`` slots; the default budget is
    ``repro``'s, ``min(64·batch_size, 8192)``. MVI (full batch) and the
    γ-only store (π reconstructed from resident corpus rows) need the
    materialized corpus.

    ``memo_store`` selects the π memo of the incremental engines: ``dense``
    (device fp32), ``chunked`` (bf16 host chunks of ``chunk_docs``
    documents) or ``gamma`` (γ-only reconstruction: S-IVI only, eq. 4's
    exactness needs the true π). ``bucket_by_length=True`` batches each
    epoch inside length buckets (`repro_torch.data.bow.bucket_corpus`), so
    E-step work and memo traffic scale with each bucket's own width;
    ``bucket_stats`` then holds the per-bucket pad fractions. ``telemetry``
    is ``repro_torch.obs.as_telemetry``'s argument: off (None) by default,
    and then the update does exactly what it does without the hooks.
    ``tune_store`` is a `repro_torch.tune` policy store (path or
    ``PolicyStore``) looked up once here, on the ``cuda`` backend, for a
    tuned ``KernelPolicy`` at this engine's shape; an explicit
    ``cfg.kernel_policy`` always wins, and no store or a miss leaves the
    policy None (the kernels' own launches).

    The materialized batch order draws from ``np.random.default_rng(seed)``
    exactly as ``repro`` does, so the same seed visits the same batches; λ₀
    is ``lam0`` when given (how parity tests start both packages from one
    point), else a Gamma(100, 0.01) draw from a ``torch.Generator`` seeded
    with ``seed``. ``last_iters`` holds the latest mini-batch update's
    fixed-point sweeps (a device tensor).
    """

    def __init__(self, cfg: LDAConfig, corpus, *, algo: str,
                 batch_size: int = 64, seed: int = 0,
                 test_corpus: Optional[Corpus] = None, device=None,
                 lam0=None, memo_store: str = "dense",
                 chunk_docs: int = 8192, bucket_by_length: bool = False,
                 layout: str = "padded", token_budget: Optional[int] = None,
                 telemetry=None, tune_store=None):
        if algo not in ("mvi", "svi", "ivi", "sivi"):
            raise ValueError(f"unknown algo {algo!r} "
                             "(have mvi | svi | ivi | sivi)")
        if layout not in ("padded", "csr"):
            raise ValueError(f"unknown layout {layout!r} "
                             "(expected 'padded' or 'csr')")
        self.device = resolve_device(device)
        self.cfg, self.algo = cfg, algo
        self.batch_size = batch_size
        self.layout = layout
        if layout == "csr" and token_budget is None:
            # repro's default: a full batch of median-length documents, capped
            # where the TPU kernel keeps the token stream resident in VMEM;
            # kept for parity, a caller on the card passes its own budget
            token_budget = min(batch_size * 64, 8192)
        self.token_budget = token_budget if layout == "csr" else None
        self.tel = as_telemetry(telemetry)
        self._updates = 0            # global updates, counted with telemetry
        self._doc_tokens = None      # per-doc token totals (telemetry only)
        self.rng = np.random.default_rng(seed)
        gen = None
        if lam0 is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = init_global_state(cfg, device=self.device,
                                       generator=gen, lam0=lam0)
        self.memo: Optional[MemoStore] = None
        self._gamma_buf: Optional[torch.Tensor] = None
        self._buckets = None
        self.bucket_stats: Optional[dict] = None
        self.corpus: Optional[Corpus] = None
        self.stream = None
        if isinstance(corpus, Corpus):
            if layout == "csr":
                raise ValueError(
                    "layout='csr' is the flat-token stream path: feed a "
                    "DocStream (data.stream.CorpusDocStream(corpus)) instead "
                    "of a padded Corpus")
            self.corpus = corpus.to(self.device)
            if int(self.corpus.token_ids.max()) >= cfg.vocab_size:
                raise ValueError(f"corpus token ids reach past vocab_size="
                                 f"{cfg.vocab_size}")
            host_counts = self.corpus.counts.cpu().numpy()
            num_words = float(host_counts.sum())
            if self.tel.enabled:
                # per-doc token totals, once, so the token counter is a
                # host-side fancy-index and sum
                self._doc_tokens = host_counts.sum(axis=1)
        elif is_doc_stream(corpus):
            if algo == "mvi":
                raise ValueError(
                    "mvi is full-batch coordinate ascent: it scans the "
                    "materialized corpus every epoch; use "
                    "data.stream.materialize(stream) or a mini-batch algo")
            if memo_store == "gamma":
                raise ValueError(
                    "the γ-only store reconstructs π from resident corpus "
                    "rows: materialize the stream or pick dense/chunked")
            self.stream = corpus
            num_words = float(corpus.num_words)
            self._packer = self._make_packer()
            self._stream_cursor = 0          # docs pulled this epoch
            self._stream_iter = None
            self._stream_emitted: List = []  # flushed, not yet processed
        else:
            raise TypeError(f"corpus must be a Corpus or DocStream, got "
                            f"{type(corpus).__name__}")
        self.num_docs = corpus.num_docs
        self.num_words_total = torch.tensor(num_words, dtype=torch.float32,
                                            device=self.device)
        if (tune_store is not None and cfg.kernel_policy is None
                and cfg.estep_backend == "cuda"):
            # the store's policy for this shape, looked up once: the key
            # is fully known here
            from repro_torch.tune.resolve import PolicyResolver
            pol = PolicyResolver(tune_store, telemetry=self.tel,
                                 device=self.device).resolve(
                backend="cuda", layout=layout,
                b_or_t=(self.token_budget if layout == "csr"
                        else batch_size),
                v=cfg.vocab_size, k=cfg.num_topics,
                w=None if layout == "csr" else corpus.max_unique)
            if pol is not None:
                cfg = dataclasses.replace(cfg, kernel_policy=pol)
                self.cfg = cfg
        if algo in ("ivi", "sivi"):
            if memo_store == "gamma" and algo == "ivi":
                raise ValueError(
                    "the γ-only store reconstructs π approximately: it "
                    "breaks IVI's exact eq. 4 accumulator; use it with "
                    "sivi, or pick dense/chunked for ivi")
            self.memo = make_memo_store(
                memo_store, cfg, self.num_docs, corpus.max_unique,
                corpus=self.corpus, chunk_docs=chunk_docs, device=self.device,
                telemetry=self.tel)
        elif algo == "mvi":
            # per-document warm starts carried across epochs (see mvi_scan);
            # row D is the sentinel slot of the tail batch's padding
            self._gamma_buf = torch.full(
                (self.num_docs + 1, cfg.num_topics), cfg.alpha0 + 1.0,
                dtype=torch.float32, device=self.device)
            ids, cnts = self.corpus.token_ids, self.corpus.counts
            self._mvi_ids = torch.cat([ids, ids.new_zeros((1, ids.shape[1]))])
            self._mvi_cnts = torch.cat([cnts,
                                        cnts.new_zeros((1, cnts.shape[1]))])
        if bucket_by_length and self.stream is None:
            if algo == "mvi":
                raise ValueError("bucket_by_length applies to the "
                                 "mini-batch engines (svi/ivi/sivi)")
            self._buckets = bucket_corpus(self.corpus)
            self.bucket_stats = bucket_padding_stats(self.corpus,
                                                     self._buckets)
        self.docs_seen = 0
        self.last_iters: Optional[torch.Tensor] = None
        self.history = History()
        self._t0 = time.perf_counter()
        if test_corpus is not None:
            self._obs, self._held = split_heldout(
                test_corpus.to(self.device), seed=seed)
        else:
            self._obs = self._held = None

    def _make_packer(self) -> BatchPacker:
        """A fresh ``BatchPacker`` in this engine's layout, the ladder capped
        at the stream's ``max_unique``, every id checked against the
        vocabulary, and its counters in the telemetry's registry."""
        return BatchPacker(self.batch_size, max_width=self.stream.max_unique,
                           vocab_size=self.cfg.vocab_size, layout=self.layout,
                           token_budget=self.token_budget,
                           metrics=self.tel.metrics if self.tel.enabled
                           else None)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- batching ----------------------------------------------------------
    def _epoch_order(self) -> List[np.ndarray]:
        """A full cover: every document exactly once, the ``D % batch_size``
        tail as a final smaller batch (the draws of ``repro``'s
        ``_epoch_order``)."""
        d = self.num_docs
        order = self.rng.permutation(d)
        b = self.batch_size
        if d <= b:
            return [order]
        n = (d // b) * b
        batches = list(order[:n].reshape(-1, b))
        if d % b:
            batches.append(order[n:])
        return batches

    def _bucketed_epoch_order(self) -> List[Tuple[np.ndarray, int]]:
        """Per-bucket batches (rows, width), bucket visit order shuffled."""
        out: List[Tuple[np.ndarray, int]] = []
        for rows_all, width in zip(self._buckets.doc_idx,
                                   self._buckets.widths):
            order = rows_all[self.rng.permutation(len(rows_all))]
            for lo in range(0, len(order), self.batch_size):
                out.append((order[lo:lo + self.batch_size], width))
        self.rng.shuffle(out)
        return out

    def epoch_batches(self) -> List[Tuple[np.ndarray, Optional[int]]]:
        """Draw one epoch's mini-batches: (rows, width or None) pairs, the
        sequence (and the rng draws) ``run_epoch`` processes."""
        if self.algo == "mvi":
            raise ValueError("mvi is full-batch: use run_epoch")
        if self.stream is not None:
            raise ValueError("stream ingest has no materialized epoch "
                             "order: drive it with stream_step/run_epoch")
        if self._buckets is not None:
            return self._bucketed_epoch_order()
        return [(rows, None) for rows in self._epoch_order()]

    # -- steps -------------------------------------------------------------
    def run_epoch(self) -> None:
        if self.stream is not None:
            while self.stream_step():
                pass
            return
        if self.algo == "mvi":
            self._run_mvi_epoch()
            return
        for rows, width in self.epoch_batches():
            self.run_minibatch(rows, width=width)

    def _run_mvi_epoch(self) -> None:
        d = self.num_docs
        b = min(self.batch_size, d)
        batches = self._epoch_order()
        idx = np.full((len(batches), b), d, np.int64)     # sentinel = row D
        for r, rows in enumerate(batches):
            idx[r, : len(rows)] = rows
        idx = self._to_device(idx)
        eb = exp_dirichlet_expectation(self.state.lam, axis=0)
        sstats, self._gamma_buf = mvi_scan(
            self.cfg, eb, self._mvi_ids[idx], self._mvi_cnts[idx], idx,
            self._gamma_buf, torch.zeros_like(self.state.lam))
        self.state.lam.copy_(self.cfg.beta0 + sstats)
        self.state.t.add_(1)
        self.docs_seen += d

    def run_minibatch(self, rows: Optional[np.ndarray] = None,
                      width: Optional[int] = None) -> None:
        """One global update on the corpus rows ``rows`` (a random batch
        when None), sliced to their first ``width`` columns when given."""
        if self.corpus is None:
            raise ValueError("run_minibatch needs a materialized Corpus; a "
                             "stream engine steps with stream_step")
        if rows is None:
            rows = self.rng.choice(self.num_docs, size=self.batch_size,
                                   replace=False)
        trace = self.tel.trace
        on = self.tel.spans_on
        sp = trace.begin("train/batch", docs=len(rows)) if on else None
        idx = torch.as_tensor(np.asarray(rows), dtype=torch.int64,
                              device=self.device)
        ids, cnts = self.corpus.token_ids[idx], self.corpus.counts[idx]
        if width is not None and width < self.corpus.max_unique:
            ids = ids[:, :width].contiguous()
            cnts = cnts[:, :width].contiguous()
        if sp is not None:
            trace.end(sp)
        self._update_batch(rows, ids, cnts)

    def _update_batch(self, rows: np.ndarray, ids: torch.Tensor,
                      cnts: torch.Tensor) -> None:
        """One global update on a padded (B', W) batch: the shared core of
        the materialized (``run_minibatch``) and stream (``stream_step``)
        paths; W is the width the batch was packed or sliced to.

        Spans open when ``tel.spans_on`` holds (read once here); every
        other telemetry touch is gated on ``tel.enabled``: with telemetry
        off the update launches, syncs and allocates nothing more than
        without the hooks, profiler or not.
        """
        tel = self.tel
        trace = tel.trace
        on = tel.spans_on
        width = ids.shape[1]
        sp = trace.begin("train/update", algo=self.algo, width=width,
                         docs=len(rows)) if on else None
        if self.algo == "svi":
            self.state, self.last_iters = svi_step(
                self.cfg, self.state, ids, cnts, float(self.num_docs))
        elif self.algo in ("ivi", "sivi"):
            g = trace.begin("train/memo_gather", width=width) if on else None
            old_pi, visited = self.memo.gather(rows, width=width)
            if g is not None:
                trace.end(g)
            s = trace.begin("train/solve", width=width) if on else None
            self.state, res, eb = incremental_update(
                self.cfg, self.algo == "sivi", self.state, ids, cnts, old_pi,
                visited, self.num_words_total, self.memo.pi_wire_dtype)
            self.last_iters = res.iters
            if s is not None:
                trace.end(s, sync=self.state.lam)
            u = trace.begin("train/memo_update", width=width) if on else None
            self.memo = self.memo.update(rows, res.pi, exp_elog_beta=eb)
            if u is not None:
                trace.end(u)
        else:
            raise ValueError(f"{self.algo} has no mini-batch update: "
                             "use run_epoch")
        self.docs_seen += len(rows)
        if sp is not None:
            trace.end(sp, sync=self.state.lam)
        if tel.enabled:
            tokens = (float(self._doc_tokens[rows].sum())
                      if self._doc_tokens is not None
                      else float(cnts.cpu().numpy().sum()))
            self._record_update(len(rows), width, tokens)

    def _record_update(self, docs: int, width: int, tokens: float) -> None:
        """Write an update's counters, the memo gauge and, at the
        watchdog's cadence, a bound check (telemetry on)."""
        tel = self.tel
        self._updates += 1
        m = tel.metrics
        m.inc("train.docs", docs)
        m.inc("train.batches", width=width)
        m.inc("train.tokens", tokens)
        if self.memo is not None:
            m.set_gauge("train.memo_resident_bytes",
                        self.memo.footprint_bytes())
        wd = tel.watchdog
        if (self.algo in ("ivi", "sivi") and wd.enabled
                and wd.should_check(self._updates)):
            # O(corpus) memoized-bound read, priced by check_every
            wd.observe(self.full_bound(), step=self._updates,
                       armed=self._watchdog_armed())

    def _watchdog_armed(self) -> bool:
        """Whether the monotone-ELBO guarantee is in force: IVI (eq. 4;
        S-IVI's averaging forfeits it) after the random-init mass has fully
        retired, i.e. the first complete pass is done."""
        return self.algo == "ivi" and float(self.state.init_frac) == 0.0

    # -- stream ingest -----------------------------------------------------
    def stream_step(self) -> bool:
        """Pull and pack until ONE mini-batch emits, then process it.

        Returns True when a batch was processed; False exactly at an epoch
        boundary (the stream is exhausted and every flushed batch has been
        processed; the cursor rewinds, so the next call starts a new pass).
        Every document is processed exactly once per epoch: the packer's
        partial batches flush at exhaustion, the streaming analogue of the
        ``D % batch_size`` epoch-tail batch.
        """
        if self.stream is None:
            raise ValueError("stream_step needs stream ingest")
        if self._stream_emitted:
            self._run_packed(self._stream_emitted.pop(0))
            return True
        if self._stream_iter is None:
            self._stream_iter = self.stream.iter_from(self._stream_cursor)
        for ids, cnts in self._stream_iter:
            pos = self._stream_cursor
            self._stream_cursor += 1
            batch = self._packer.add(pos, ids, cnts)
            if batch is not None:
                self._run_packed(batch)
                return True
        self._stream_emitted = self._packer.flush()
        if self._stream_emitted:
            self._run_packed(self._stream_emitted.pop(0))
            return True
        self._stream_cursor = 0              # epoch boundary: rewind
        self._stream_iter = None
        return False

    def _run_packed(self, batch) -> None:
        if isinstance(batch, CSRBatch):
            self._update_batch_csr(batch)
        else:
            self._update_batch(batch.rows, self._to_device(batch.token_ids),
                               self._to_device(batch.counts))

    def _csr_flat_index(self, batch: CSRBatch, width: int) -> np.ndarray:
        """The token-slot → memo-cell map: ``ix[t] = seg_t·W + position in
        its document`` for live tokens, sentinel ``B·W`` for padding slots.
        Built on the host from the batch's offsets."""
        segs = batch.segments.astype(np.int64)
        ix = segs * width + (np.arange(batch.token_budget, dtype=np.int64)
                             - batch.offsets[segs])
        ix[batch.live_tokens:] = self.batch_size * width
        return ix

    def _update_batch_csr(self, batch: CSRBatch) -> None:
        """One global update on a flat CSR batch. The memo is read and
        written at W, the ladder rung covering the batch's longest document.
        The document axis is padded to ``batch_size`` (by re-reading row 0
        for the memo): phantom documents own no tokens, so their memo rows
        are never touched and their visited flags add nothing to the
        first-visit count, but they do count in the fixed point's
        batch-wide mean, as in ``repro``."""
        tel = self.tel
        trace = tel.trace
        on = tel.spans_on
        rows = batch.rows
        b_real, b_pad = len(rows), self.batch_size
        width = self._packer.width_for(
            int(batch.doc_lengths.max()) if b_real else 1)
        sp = trace.begin("train/update", algo=self.algo, width=width,
                         docs=b_real) if on else None
        ids = self._to_device(batch.token_ids)
        cnts = self._to_device(batch.counts)
        segs = self._to_device(batch.segments)
        if self.algo == "svi":
            self.state, self.last_iters = svi_step_csr(
                self.cfg, self.state, ids, cnts, segs, b_real,
                float(self.num_docs), num_docs=b_pad)
        else:
            rows_pad = np.concatenate([rows,
                                       np.zeros(b_pad - b_real, np.int64)])
            g = trace.begin("train/memo_gather", width=width) if on else None
            old_pi, visited = self.memo.gather(rows_pad, width=width)
            if g is not None:
                trace.end(g)
            ix = self._to_device(self._csr_flat_index(batch, width))
            s = trace.begin("train/solve", width=width) if on else None
            self.state, res, eb = incremental_update_csr(
                self.cfg, self.algo == "sivi", self.state, ids, cnts, segs,
                ix, old_pi, visited, self.num_words_total,
                self.memo.pi_wire_dtype)
            self.last_iters = res.iters
            if s is not None:
                trace.end(s, sync=self.state.lam)
            u = trace.begin("train/memo_update", width=width) if on else None
            self.memo = self.memo.update(rows, res.pi[:b_real],
                                         exp_elog_beta=eb)
            if u is not None:
                trace.end(u)
        self.docs_seen += b_real
        if sp is not None:
            trace.end(sp, sync=self.state.lam)
        if tel.enabled:
            self._record_update(b_real, width, float(batch.counts.sum()))

    def stream_padding_stats(self) -> dict:
        """Pad-waste accounting of everything packed so far (stream mode)."""
        return self._packer.padding_stats()

    # -- evaluation --------------------------------------------------------
    def evaluate(self) -> Dict[str, float]:
        """Held-out LPP with a test corpus, else the corpus bound (the
        memoized ELBO for the incremental engines), fed to the watchdog
        and with the effective-topics gauge when telemetry is on."""
        out: Dict[str, float] = {}
        if self._obs is not None:
            out["lpp"] = float(log_predictive(self.cfg, self.state.lam,
                                              self._obs, self._held))
            self.history.lpp.append(out["lpp"])
        else:
            out["elbo"] = self.full_bound()
            self.history.elbo.append(out["elbo"])
            if (self.tel.enabled and self.tel.watchdog.enabled
                    and self.algo in ("ivi", "sivi")):
                # a bound computed anyway: feed it to the watchdog even at
                # check_every=0 (the free cadence)
                self.tel.watchdog.observe(out["elbo"], step=self._updates,
                                          armed=self._watchdog_armed())
        if self.tel.enabled:
            self.tel.metrics.set_gauge("train.effective_topics",
                                       effective_topics(self.state.lam))
        self.history.docs_seen.append(self.docs_seen)
        self.history.wall.append(time.perf_counter() - self._t0)
        return out

    def full_bound(self) -> float:
        """The exact corpus ELBO.

        For the incremental engines the memoized bound, the quantity IVI
        monotonically increases, read through the memo store chunk by chunk
        (with stream ingest the stream is re-read chunk by chunk too). For
        MVI/SVI the collapsed bound at freshly fitted γ: on a materialized
        corpus one ``estep_gather`` over all D documents whatever
        ``cfg.estep_backend`` (a full-corpus E-step; call it at evaluation
        points only), on a stream chunk by chunk.
        """
        cfg, lam = self.cfg, self.state.lam
        if self.stream is not None:
            if self.memo is not None:
                return float(elbo_memoized_stream(cfg, self.stream,
                                                  self.memo, lam))
            return float(elbo_collapsed_stream(cfg, self.stream, lam))
        if self.memo is not None:
            return float(elbo_memoized_store(cfg, self.corpus, self.memo,
                                             lam))
        eb = exp_dirichlet_expectation(lam, axis=0)
        res = estep_gather(cfg, eb, self.corpus.token_ids, self.corpus.counts)
        return float(elbo_collapsed(cfg, self.corpus, res.gamma, lam))
