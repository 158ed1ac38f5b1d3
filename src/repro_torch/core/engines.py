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
visit, so after one full pass ⟨m_vk⟩ == Σ_d s_d exactly. MVI and SVI, the
stream, bucketed and CSR layouts, and telemetry are not ported yet
(ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.bound import elbo_memoized_store
from repro_torch.core.estep import BowBatch, get_backend
from repro_torch.core.math import exp_dirichlet_expectation
from repro_torch.core.memo import MemoStore, make_memo_store
from repro_torch.core.predictive import log_predictive, split_heldout
from repro_torch.core.types import (Corpus, GlobalState, LDAConfig,
                                    init_global_state, resolve_device)


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


def _incremental_core(cfg: LDAConfig, averaged: bool, state: GlobalState,
                      ids: torch.Tensor, cnts: torch.Tensor,
                      old_pi: torch.Tensor, visited: torch.Tensor,
                      num_words_total: torch.Tensor, pi_dtype: str):
    """THE eq. 4 / eq. 5 update; every incremental entry point wraps it.

    The state is updated in place: ``repro`` donates it to this update
    (engines.py:196), so the pre-update state is consumed either way.
    """
    eb = exp_dirichlet_expectation(state.lam, axis=0)
    corr, words_first, res = memo_correction(cfg, eb, ids, cnts, old_pi,
                                             visited, pi_dtype)
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
    return state, res


def incremental_update(cfg: LDAConfig, averaged: bool, state: GlobalState,
                       ids: torch.Tensor, cnts: torch.Tensor,
                       old_pi: torch.Tensor, visited: torch.Tensor,
                       num_words_total: torch.Tensor,
                       pi_dtype: str = "float32"):
    """One IVI (``averaged=False``, eq. 4) or S-IVI (eq. 5) global update.

    Takes the gathered (π_old, visited) rows from a ``MemoStore`` and
    returns the new π for the caller to write back. Returns
    (state, π_new (B, L, K)).
    """
    state, res = _incremental_core(cfg, averaged, state, ids, cnts, old_pi,
                                   visited, num_words_total, pi_dtype)
    return state, res.pi


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

    Runs IVI or S-IVI over a materialized padded ``Corpus`` with the dense
    memo. The batch order draws from ``np.random.default_rng(seed)`` exactly
    as ``repro`` does, so the same seed visits the same batches; λ₀ is
    ``lam0`` when given (how parity tests start both packages from one
    point), else a Gamma(100, 0.01) draw from a ``torch.Generator`` seeded
    with ``seed``.
    """

    def __init__(self, cfg: LDAConfig, corpus: Corpus, *, algo: str,
                 batch_size: int = 64, seed: int = 0,
                 test_corpus: Optional[Corpus] = None, device=None,
                 lam0=None):
        if algo in ("mvi", "svi"):
            raise NotImplementedError(
                f"algo {algo!r} is not ported yet (ROADMAP.md, queue 1)")
        if algo not in ("ivi", "sivi"):
            raise ValueError(f"unknown algo {algo!r} (have ivi | sivi)")
        if not isinstance(corpus, Corpus):
            raise TypeError(f"corpus must be a padded Corpus, got "
                            f"{type(corpus).__name__} (stream ingest is not "
                            "ported yet, ROADMAP.md)")
        self.device = resolve_device(device)
        self.cfg, self.algo = cfg, algo
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        gen = None
        if lam0 is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = init_global_state(cfg, device=self.device,
                                       generator=gen, lam0=lam0)
        self.corpus = corpus.to(self.device)
        if int(self.corpus.token_ids.max()) >= cfg.vocab_size:
            raise ValueError(f"corpus token ids reach past vocab_size="
                             f"{cfg.vocab_size}")
        self.num_docs = self.corpus.num_docs
        num_words = float(self.corpus.counts.cpu().numpy().sum())
        self.num_words_total = torch.tensor(num_words, dtype=torch.float32,
                                            device=self.device)
        self.memo: MemoStore = make_memo_store(
            "dense", cfg, self.num_docs, self.corpus.max_unique,
            device=self.device)
        self.docs_seen = 0
        self.history = History()
        self._t0 = time.perf_counter()
        if test_corpus is not None:
            self._obs, self._held = split_heldout(
                test_corpus.to(self.device), seed=seed)
        else:
            self._obs = self._held = None

    # -- batching ----------------------------------------------------------
    def epoch_batches(self) -> List[np.ndarray]:
        """Draw one epoch's mini-batches of document rows: a full cover,
        every document exactly once, the ``D % batch_size`` tail as a final
        smaller batch (the draws of ``repro``'s ``_epoch_order``)."""
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
        for rows in self.epoch_batches():
            self.run_minibatch(rows)

    def run_minibatch(self, rows: Optional[np.ndarray] = None) -> None:
        """One global update on the padded (B, L) rows ``rows`` (a random
        batch when None)."""
        if rows is None:
            rows = self.rng.choice(self.num_docs, size=self.batch_size,
                                   replace=False)
        idx = torch.as_tensor(np.asarray(rows), dtype=torch.int64,
                              device=self.device)
        ids, cnts = self.corpus.token_ids[idx], self.corpus.counts[idx]
        old_pi, visited = self.memo.gather(rows)
        self.state, new_pi = incremental_update(
            self.cfg, self.algo == "sivi", self.state, ids, cnts, old_pi,
            visited, self.num_words_total, self.memo.pi_wire_dtype)
        self.memo = self.memo.update(rows, new_pi)
        self.docs_seen += len(rows)

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
        increases, read through the memo store chunk by chunk."""
        return float(elbo_memoized_store(self.cfg, self.corpus, self.memo,
                                         self.state.lam))
