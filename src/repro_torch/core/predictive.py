"""Held-out per-word predictive probability (the paper's §6 metric).

For each test document, fit the topic proportions on the first half of its
words with the learned topics frozen, then score the second half under the
predictive distribution p(w) = Σ_k θ̄_k φ̄_wk. Higher is better.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.estep import estep_gather
from repro_torch.core.math import exp_dirichlet_expectation, safe_normalize
from repro_torch.core.types import Corpus, LDAConfig


def split_heldout(corpus: Corpus, seed: int = 0) -> Tuple[Corpus, Corpus]:
    """Split each document's counts in half (observed / held-out).

    Done on the host with numpy, draw for draw as ``repro`` does: for each
    unique token, half the occurrences (rounded alternately) go to the
    observed part. Slots whose count splits to zero stay with count 0.
    """
    rng = np.random.default_rng(seed)
    cnt = corpus.counts.cpu().numpy()
    obs = np.floor(cnt / 2.0)
    rem = cnt - 2 * obs
    coin = rng.integers(0, 2, size=cnt.shape).astype(cnt.dtype)
    obs = obs + rem * coin
    held = cnt - obs
    device = corpus.counts.device
    ids = corpus.token_ids
    return (Corpus(ids, torch.from_numpy(obs.astype(np.float32)).to(device)),
            Corpus(ids, torch.from_numpy(held.astype(np.float32)).to(device)))


def log_predictive(cfg: LDAConfig, lam: torch.Tensor, observed: Corpus,
                   heldout: Corpus) -> torch.Tensor:
    """Average per-word log predictive probability on held-out halves."""
    exp_elog_beta = exp_dirichlet_expectation(lam, axis=0)   # (V, K)
    res = estep_gather(cfg, exp_elog_beta, observed.token_ids,
                       observed.counts)
    theta_bar = safe_normalize(res.gamma, axis=-1)           # (D, K)
    phi_bar = lam / lam.sum(dim=0, keepdim=True)             # (V, K)
    probs = torch.einsum("dk,dlk->dl", theta_bar,
                         phi_bar[heldout.token_ids.long()])
    logp = torch.where(heldout.counts > 0, torch.log(probs + 1e-30), 0.0)
    total = (heldout.counts * logp).sum()
    return total / torch.clamp(heldout.counts.sum(), min=1.0)
