"""Topic-model quality metrics beyond held-out likelihood.

* ``top_words`` — per-topic most probable token ids;
* ``npmi_coherence`` — average normalized pointwise mutual information of
  each topic's top-k word pairs under the corpus co-occurrence statistics
  (the standard automatic coherence proxy);
* ``effective_topics`` — exp(entropy) of corpus-level topic usage: detects
  topic death.

All three read λ on the host (a (V, K) tensor on any device, or an array)
and compute in numpy, as ``repro.core.metrics`` does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import Corpus


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def top_words(lam, k: int = 10) -> np.ndarray:
    """(K, k) token ids of each topic's top-k words."""
    lam = _host(lam)
    phi = lam / lam.sum(0, keepdims=True)                  # (V, K)
    return np.argsort(-phi, axis=0)[:k].T                  # (K, k)


def _doc_presence(corpus: Corpus, vocab_size: int) -> np.ndarray:
    """(D, V) binary token-presence matrix (host side)."""
    d = corpus.num_docs
    out = np.zeros((d, vocab_size), bool)
    ids = _host(corpus.token_ids)
    cnt = _host(corpus.counts)
    rows = np.repeat(np.arange(d), ids.shape[1])
    mask = cnt.reshape(-1) > 0
    out[rows[mask], ids.reshape(-1)[mask]] = True
    return out


def npmi_coherence(lam, corpus: Corpus, k: int = 10,
                   eps: float = 1e-12) -> float:
    """Mean NPMI over all topics' top-k word pairs.

    One ``(D, K·k)`` presence slice and one matmul give every pair's
    co-document fraction at once: ``sub.T @ sub`` over a 0/1 float64
    matrix is an exact integer count (D < 2⁵³).
    """
    v = lam.shape[0]
    tops = top_words(lam, k)                               # (K, k)
    pres = _doc_presence(corpus, v)
    d = pres.shape[0]
    p_w = pres.mean(0)                                     # (V,)
    num_topics, kk = tops.shape
    sub = pres[:, tops.reshape(-1)].astype(np.float64)     # (D, K·k)
    co = (sub.T @ sub) / d                                 # (K·k, K·k)
    # per-topic k×k co-occurrence blocks down the diagonal
    blocks = co.reshape(num_topics, kk, num_topics, kk)[
        np.arange(num_topics), :, np.arange(num_topics), :]  # (K, k, k)
    iu, ju = np.triu_indices(kk, 1)
    p_ij = blocks[:, iu, ju]                               # (K, pairs)
    p_top = p_w[tops]                                      # (K, k)
    pmi = np.log(p_ij / (p_top[:, iu] * p_top[:, ju] + eps) + eps)
    with np.errstate(divide="ignore", invalid="ignore"):
        npmi = np.where(p_ij < eps, -1.0, pmi / -np.log(p_ij + eps))
    return float(npmi.mean(axis=1).mean())


def effective_topics(lam) -> float:
    """exp(H[topic usage]) from the topic-word mass."""
    mass = _host(lam.sum(0))                               # (K,)
    p = mass / mass.sum()
    h = -(p * np.log(p + 1e-12)).sum()
    return float(np.exp(h))
