"""CVB0: collapsed variational Bayes (zero-order) for LDA, on the card.

The port's counterpart of ``repro.core.cvb0``. Teh et al. (2006) and
Asuncion et al. (2009): the paper's §5 names collapsed variational
inference "the de facto standard for corpora of moderate size", so it
ships as a further baseline. CVB0 keeps per-token responsibilities γ and
updates them against *collapsed* count statistics (document-topic N_dk,
topic-word N_vk, topic N_k) with self-exclusion:

    γ_dvk ∝ (α₀ + N̂_dk^{−dv}) · (β₀ + N̂_vk^{−dv}) / (V·β₀ + N̂_k^{−dv})

on the padded unique-token layout with count-weighted tokens (the standard
CVB0-with-counts approximation). Batch-incremental like IVI: visiting a
mini-batch replaces its documents' contribution to N_vk, the same
subtract-old/add-new bookkeeping.

Both scatters of Σ cnt·γ into (V, K) go through K3 (the segment scatter of
`repro_torch.kernels.lda_estep`): one index preparation a batch, then one
launch for the old contribution and one for the new, 2 launches a step.
K3 sums each id's rows in a fixed order, where ``index_add_``'s float
atomics do not, so CVB0 gives the same bits twice on the card. On the CPU
K3's plain twin runs. The step updates the state in place (the γ memo is
1.07 GB at ``chip_smoke.py``'s Arxiv scale; ``repro`` donates it).

``jax.random.gamma`` cannot be reproduced in torch, so ``init_cvb0`` takes
an injected γ₀ (how the parity tests start both packages from one point)
or draws one from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.types import Corpus, LDAConfig, resolve_device
from repro_torch.kernels import lda_estep


@dataclasses.dataclass
class CVB0State:
    gamma: torch.Tensor        # (D, L, K) responsibilities (the memo)
    n_vk: torch.Tensor         # (V, K) topic-word expected counts
    visited: torch.Tensor      # (D,) bool


def _segments(ids: torch.Tensor, cnts: torch.Tensor, v: int):
    """K3's index preparation of a batch's rows on the card, made once and
    shared by its launches (None on the CPU: the twin prepares its own)."""
    if not ids.is_cuda:
        return None
    return lda_estep.scatter_segments(ids.reshape(-1), cnts.reshape(-1), v)


def scatter_counts(ids: torch.Tensor, cnts: torch.Tensor, g: torch.Tensor,
                   v: int, segments=None) -> torch.Tensor:
    """Σ cnt·γ at the token ids, (V, K): K3 on ``segments`` (``_segments``
    of the same rows) on the card, its plain twin on the CPU."""
    k = g.shape[-1]
    flat_c, flat_g = cnts.reshape(-1), g.reshape(-1, k)
    if segments is None:
        return lda_estep.segment_scatter(ids.reshape(-1), flat_c, flat_g,
                                         None, v)[0]
    return lda_estep.segment_scatter_prepared(segments, flat_c, flat_g,
                                              None, v)[0]


def init_cvb0(cfg: LDAConfig, corpus: Corpus, *, gamma0=None,
              generator: Optional[torch.Generator] = None) -> CVB0State:
    """γ from ``gamma0`` ((D, L, K), injected), else Gamma(1) + 0.1 drawn
    from ``generator`` (``repro``'s distribution), normalised per slot and
    zero on padding; N_vk = Σ cnt·γ (one K3 launch on the card)."""
    ids, cnts = corpus.token_ids, corpus.counts
    d, l = ids.shape
    dev = ids.device
    if gamma0 is None:
        if generator is None:
            raise ValueError("init_cvb0 needs gamma0 or a torch.Generator")
        g = torch.empty((d, l, cfg.num_topics), dtype=torch.float32,
                        device=dev).exponential_(generator=generator) + 0.1
    else:
        g = torch.as_tensor(gamma0, dtype=torch.float32).to(dev).clone()
        if g.shape != (d, l, cfg.num_topics):
            raise ValueError(f"gamma0 has shape {tuple(g.shape)}, expected "
                             f"{(d, l, cfg.num_topics)}")
    g = g / g.sum(-1, keepdim=True)
    g = torch.where(cnts[:, :, None] > 0, g, 0.0)
    n_vk = scatter_counts(ids, cnts, g, cfg.vocab_size,
                          _segments(ids, cnts, cfg.vocab_size))
    return CVB0State(gamma=g, n_vk=n_vk,
                     visited=torch.ones((d,), dtype=torch.bool, device=dev))


def cvb0_step(cfg: LDAConfig, state: CVB0State, ids: torch.Tensor,
              cnts: torch.Tensor, doc_idx: torch.Tensor,
              inner_iters: int = 5) -> CVB0State:
    """Visit a mini-batch: refresh its responsibilities against collapsed
    counts, then replace its contribution in N_vk (subtract-old/add-new).
    Updates ``state`` in place and returns it."""
    v = cfg.vocab_size
    segments = _segments(ids, cnts, v)
    old_g = state.gamma[doc_idx]                         # (B, L, K)
    n_vk_ext = state.n_vk - scatter_counts(ids, cnts, old_g, v, segments)
    n_k_ext = n_vk_ext.sum(0)                            # (K,)
    n_vk_tok = n_vk_ext[ids.long()]                      # (B, L, K)
    den = v * cfg.beta0 + n_k_ext
    live = cnts[:, :, None] > 0
    g = old_g
    for _ in range(inner_iters):
        # document-topic counts with self-exclusion per token slot
        n_dk = torch.einsum("blk,bl->bk", g, cnts)       # (B, K)
        n_dk_excl = n_dk[:, None, :] - cnts[:, :, None] * g
        g_new = (cfg.alpha0 + n_dk_excl) * (cfg.beta0 + n_vk_tok) / den
        g_new = g_new / (g_new.sum(-1, keepdim=True) + 1e-30)
        g = torch.where(live, g_new, 0.0)
    state.n_vk = n_vk_ext + scatter_counts(ids, cnts, g, v, segments)
    state.gamma[doc_idx] = g
    state.visited[doc_idx] = True
    return state


class CVB0Engine:
    """The host-side loop, as ``LDAEngine``'s (CVB0's own state).

    The batch order draws from ``np.random.default_rng(seed)`` exactly as
    ``repro``'s engine does. γ₀ is ``gamma0`` when given, else drawn from
    a ``torch.Generator`` seeded with ``seed`` on ``device`` (the card
    unless named).
    """

    def __init__(self, cfg: LDAConfig, corpus: Corpus, *,
                 batch_size: int = 64, seed: int = 0, inner_iters: int = 5,
                 device=None, gamma0=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.corpus = corpus.to(self.device)
        self.batch_size = batch_size
        self.inner_iters = inner_iters
        self.rng = np.random.default_rng(seed)
        gen = None
        if gamma0 is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = init_cvb0(cfg, self.corpus, gamma0=gamma0,
                               generator=gen)
        self.docs_seen = 0

    @property
    def lam(self) -> torch.Tensor:
        """The topic-word Dirichlet parameter the collapsed counts imply."""
        return self.cfg.beta0 + self.state.n_vk

    def run_minibatch(self, rows: Optional[np.ndarray] = None) -> None:
        if rows is None:
            rows = self.rng.choice(self.corpus.num_docs,
                                   size=self.batch_size, replace=False)
        idx = torch.as_tensor(np.asarray(rows), dtype=torch.int64,
                              device=self.device)
        self.state = cvb0_step(self.cfg, self.state,
                               self.corpus.token_ids[idx],
                               self.corpus.counts[idx], idx,
                               self.inner_iters)
        self.docs_seen += len(rows)

    def run_epoch(self) -> None:
        d = self.corpus.num_docs
        order = self.rng.permutation(d)
        n = (d // self.batch_size) * self.batch_size
        for rows in order[:n].reshape(-1, self.batch_size):
            self.run_minibatch(rows)
