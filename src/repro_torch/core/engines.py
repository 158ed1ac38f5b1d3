"""Single-host incremental engines for LDA: IVI and S-IVI.

* **IVI** (the paper, eq. 4 / Alg. 1): memoize per-document π; maintain the
  exact accumulator ⟨m_vk⟩ by subtract-old/add-new; λ = β₀ + ⟨m_vk⟩. No
  learning rate; monotone in the memoized ELBO once every document has
  been visited.
* **S-IVI** (eq. 5): the IVI correction inside a Robbins–Monro average:
  λ ← (1−ρ_t)λ + ρ_t(β₀ + ⟨m_vk⟩⁺).

Both consume the E-step through the ``EStepBackend`` contract and the memo
through ``MemoStore``. The random-initialisation mass is carried explicitly
(``init_mass``) and each document's pro-rata share retires on its first
visit, so after one full pass ⟨m_vk⟩ == Σ_d s_d exactly.

``LDAEngine`` trains on a materialized padded ``Corpus`` or on a
``DocStream`` (`repro_torch.data.stream`), packed per mini-batch in the
padded layout at a ladder width or in the flat CSR layout
(``incremental_update_csr``). MVI and SVI (``svi_step_csr`` with them), the
corpus-side length buckets and telemetry are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.bound import elbo_memoized_store, elbo_memoized_stream
from repro_torch.core.estep import BowBatch, CSRTokenBatch, get_backend
from repro_torch.core.math import exp_dirichlet_expectation
from repro_torch.core.memo import MemoStore, make_memo_store
from repro_torch.core.predictive import log_predictive, split_heldout
from repro_torch.core.types import (Corpus, GlobalState, LDAConfig,
                                    init_global_state, resolve_device)
from repro_torch.data.stream import BatchPacker, CSRBatch, is_doc_stream


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
    returns the new π for the caller to write back. Returns
    (state, π_new (B, W, K), fixed-point sweeps).
    """
    eb = exp_dirichlet_expectation(state.lam, axis=0)
    corr, words_first, res = memo_correction(cfg, eb, ids, cnts, old_pi,
                                             visited, pi_dtype)
    state = _apply_correction(cfg, averaged, state, corr, words_first,
                              num_words_total)
    return state, res.pi, res.iters


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
    gathered through ``ix`` on the way in and the new π scattered back
    through it on the way out. Returns (state, π_new (B, W, K), sweeps).
    """
    b, w, _ = old_pi.shape
    eb = exp_dirichlet_expectation(state.lam, axis=0)
    corr, words_first, res = get_backend(
        cfg.estep_backend).solve_correction_tokens(
            cfg, eb, CSRTokenBatch(ids, cnts, segs),
            _csr_gather_flat(old_pi, ix), visited, pi_dtype)
    state = _apply_correction(cfg, averaged, state, corr, words_first,
                              num_words_total)
    return state, _csr_scatter_flat(res.pi, ix, b, w), res.iters


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

    Runs IVI or S-IVI with the dense memo. ``corpus`` is a materialized
    padded ``Corpus`` or a ``DocStream`` (`repro_torch.data.stream`): ragged
    documents pulled and packed per mini-batch, so no (D, L) corpus is
    resident. One pass over a stream is one epoch, in stream order; packing
    is bit-transparent, so a padded-layout stream run reproduces the
    materialized run under the same batch schedule. ``layout="csr"`` (a
    stream only) packs each mini-batch as one flat stream of
    ``token_budget`` slots and runs ``incremental_update_csr``; the default
    budget is ``repro``'s, ``min(64·batch_size, 8192)``.

    The materialized batch order draws from ``np.random.default_rng(seed)``
    exactly as ``repro`` does, so the same seed visits the same batches; λ₀
    is ``lam0`` when given (how parity tests start both packages from one
    point), else a Gamma(100, 0.01) draw from a ``torch.Generator`` seeded
    with ``seed``. ``last_iters`` holds the latest update's fixed-point
    sweeps (a device tensor).
    """

    def __init__(self, cfg: LDAConfig, corpus, *, algo: str,
                 batch_size: int = 64, seed: int = 0,
                 test_corpus: Optional[Corpus] = None, device=None,
                 lam0=None, layout: str = "padded",
                 token_budget: Optional[int] = None):
        if algo in ("mvi", "svi"):
            raise NotImplementedError(
                f"algo {algo!r} is not ported yet (ROADMAP.md, queue 2)")
        if algo not in ("ivi", "sivi"):
            raise ValueError(f"unknown algo {algo!r} (have ivi | sivi)")
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
        self.rng = np.random.default_rng(seed)
        gen = None
        if lam0 is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = init_global_state(cfg, device=self.device,
                                       generator=gen, lam0=lam0)
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
            num_words = float(self.corpus.counts.cpu().numpy().sum())
        elif is_doc_stream(corpus):
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
        self.memo: MemoStore = make_memo_store(
            "dense", cfg, self.num_docs, corpus.max_unique,
            device=self.device)
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
        at the stream's ``max_unique`` and every id checked against the
        vocabulary."""
        return BatchPacker(self.batch_size, max_width=self.stream.max_unique,
                           vocab_size=self.cfg.vocab_size, layout=self.layout,
                           token_budget=self.token_budget)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- batching ----------------------------------------------------------
    def epoch_batches(self) -> List[np.ndarray]:
        """Draw one epoch's mini-batches of document rows: a full cover,
        every document exactly once, the ``D % batch_size`` tail as a final
        smaller batch (the draws of ``repro``'s ``_epoch_order``)."""
        if self.stream is not None:
            raise ValueError("stream ingest has no materialized epoch "
                             "order: drive it with stream_step/run_epoch")
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

    # -- steps -------------------------------------------------------------
    def run_epoch(self) -> None:
        if self.stream is not None:
            while self.stream_step():
                pass
            return
        for rows in self.epoch_batches():
            self.run_minibatch(rows)

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
        idx = torch.as_tensor(np.asarray(rows), dtype=torch.int64,
                              device=self.device)
        ids, cnts = self.corpus.token_ids[idx], self.corpus.counts[idx]
        if width is not None and width < self.corpus.max_unique:
            ids = ids[:, :width].contiguous()
            cnts = cnts[:, :width].contiguous()
        self._update_batch(rows, ids, cnts)

    def _update_batch(self, rows: np.ndarray, ids: torch.Tensor,
                      cnts: torch.Tensor) -> None:
        """One global update on a padded (B', W) batch: the shared core of
        the materialized (``run_minibatch``) and stream (``stream_step``)
        paths; W is the width the batch was packed or sliced to."""
        old_pi, visited = self.memo.gather(rows, width=ids.shape[1])
        self.state, new_pi, self.last_iters = incremental_update(
            self.cfg, self.algo == "sivi", self.state, ids, cnts, old_pi,
            visited, self.num_words_total, self.memo.pi_wire_dtype)
        self.memo = self.memo.update(rows, new_pi)
        self.docs_seen += len(rows)

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
        The document axis is padded to ``batch_size`` by re-reading row 0:
        phantom documents own no tokens, so their memo rows are never
        touched and their visited flags add nothing to the first-visit
        count, but they do count in the fixed point's batch-wide mean, as
        in ``repro``."""
        rows = batch.rows
        b_real, b_pad = len(rows), self.batch_size
        width = self._packer.width_for(
            int(batch.doc_lengths.max()) if b_real else 1)
        rows_pad = np.concatenate([rows, np.zeros(b_pad - b_real, np.int64)])
        old_pi, visited = self.memo.gather(rows_pad, width=width)
        self.state, new_pi, self.last_iters = incremental_update_csr(
            self.cfg, self.algo == "sivi", self.state,
            self._to_device(batch.token_ids), self._to_device(batch.counts),
            self._to_device(batch.segments),
            self._to_device(self._csr_flat_index(batch, width)), old_pi,
            visited, self.num_words_total, self.memo.pi_wire_dtype)
        self.memo = self.memo.update(rows, new_pi[:b_real])
        self.docs_seen += b_real

    def stream_padding_stats(self) -> dict:
        """Pad-waste accounting of everything packed so far (stream mode)."""
        return self._packer.padding_stats()

    # -- evaluation --------------------------------------------------------
    def evaluate(self) -> Dict[str, float]:
        """Held-out LPP with a test corpus, else the memoized ELBO."""
        out: Dict[str, float] = {}
        if self._obs is not None:
            out["lpp"] = float(log_predictive(self.cfg, self.state.lam,
                                              self._obs, self._held))
            self.history.lpp.append(out["lpp"])
        else:
            out["elbo"] = self.full_bound()
            self.history.elbo.append(out["elbo"])
        self.history.docs_seen.append(self.docs_seen)
        self.history.wall.append(time.perf_counter() - self._t0)
        return out

    def full_bound(self) -> float:
        """The exact memoized corpus ELBO, the quantity IVI monotonically
        increases, read through the memo store chunk by chunk (with stream
        ingest, the stream is re-read chunk by chunk too)."""
        if self.stream is not None:
            return float(elbo_memoized_stream(self.cfg, self.stream,
                                              self.memo, self.state.lam))
        return float(elbo_memoized_store(self.cfg, self.corpus, self.memo,
                                         self.state.lam))
