"""Variational lower bound (ELBO) for LDA.

* ``elbo_memoized`` — the exact bound at the current (γ, memoized π, λ):
  the objective IVI provably increases monotonically (§3).
* ``elbo_collapsed`` — the bound with π analytically maximised given (γ, λ);
  cheaper, for monitoring.
* ``elbo_memoized_stream`` / ``elbo_collapsed_stream`` — the two bounds
  when the corpus is a ``DocStream``, read chunk by chunk.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.estep import estep_gather
from repro_torch.core.math import (dirichlet_elbo_term, dirichlet_expectation,
                                   exp_dirichlet_expectation)
from repro_torch.core.types import Corpus, LDAConfig
from repro_torch.data.stream import iter_padded_chunks

_EPS = 1e-30


def _topics_term(cfg: LDAConfig, lam: torch.Tensor) -> torch.Tensor:
    elog_beta = dirichlet_expectation(lam, axis=0)         # (V, K)
    return dirichlet_elbo_term(lam, cfg.beta0, elog_beta, axis=0)


def _memoized_doc_terms(cfg: LDAConfig, token_ids: torch.Tensor,
                        counts: torch.Tensor, gamma: torch.Tensor,
                        pi: torch.Tensor,
                        elog_beta: torch.Tensor) -> torch.Tensor:
    """Per-document ELBO terms at memoized π: words + θ-Dirichlet pieces."""
    elog_theta = dirichlet_expectation(gamma)              # (B, K)
    eb = elog_beta[token_ids.long()]                       # (B, L, K)
    # Σ_d Σ_l cnt Σ_k π (E[lnθ] + E[lnφ] − ln π)
    inner = pi * (elog_theta[:, None, :] + eb - torch.log(pi + _EPS))
    words = (counts[:, :, None] * inner).sum()
    return words + dirichlet_elbo_term(gamma, cfg.alpha0, elog_theta, axis=-1)


def elbo_memoized(cfg: LDAConfig, corpus: Corpus, gamma: torch.Tensor,
                  pi: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Exact ELBO at (γ, π, λ); π token-aligned (D, L, K), zero at padding."""
    doc_terms = _memoized_doc_terms(cfg, corpus.token_ids, corpus.counts,
                                    gamma, pi,
                                    dirichlet_expectation(lam, axis=0))
    return doc_terms + _topics_term(cfg, lam)


def elbo_memoized_docs(cfg: LDAConfig, corpus: Corpus, store,
                       elog_beta: torch.Tensor, *,
                       batch_docs: int = 512) -> torch.Tensor:
    """Document terms of the memoized ELBO, read through a ``MemoStore``.

    Never materialises the (D, L, K) memo at once: each store chunk is
    gathered, its γ reconstructed from the memo (γ = α₀ + Σ_l cnt·π,
    Alg. 1 line 6), and its word/θ terms accumulated. The topics term is
    not included.
    """
    total = torch.zeros((), dtype=torch.float32, device=elog_beta.device)
    for idx, pi, _vis in store.iter_chunks(batch_docs):
        rows = torch.as_tensor(idx, device=corpus.token_ids.device)
        ids, cnts = corpus.token_ids[rows], corpus.counts[rows]
        gamma = cfg.alpha0 + torch.einsum("blk,bl->bk", pi, cnts)
        total = total + _memoized_doc_terms(cfg, ids, cnts, gamma, pi,
                                            elog_beta)
    return total


def elbo_memoized_store(cfg: LDAConfig, corpus: Corpus, store,
                        lam: torch.Tensor, *,
                        batch_docs: int = 512) -> torch.Tensor:
    """The memoized ELBO read through a ``MemoStore``, chunk by chunk:
    ``elbo_memoized_docs`` plus the topics term."""
    docs = elbo_memoized_docs(cfg, corpus, store,
                              dirichlet_expectation(lam, axis=0),
                              batch_docs=batch_docs)
    return docs + _topics_term(cfg, lam)


def _collapsed_doc_terms(cfg: LDAConfig, token_ids: torch.Tensor,
                         counts: torch.Tensor, gamma: torch.Tensor,
                         elog_beta: torch.Tensor) -> torch.Tensor:
    """Per-document collapsed-π terms: words + θ-Dirichlet pieces."""
    elog_theta = dirichlet_expectation(gamma)              # (B, K)
    eb = elog_beta[token_ids.long()]                       # (B, L, K)
    lse = torch.logsumexp(elog_theta[:, None, :] + eb, dim=-1)  # (B, L)
    words = (counts * lse).sum()
    return words + dirichlet_elbo_term(gamma, cfg.alpha0, elog_theta, axis=-1)


def elbo_collapsed(cfg: LDAConfig, corpus: Corpus, gamma: torch.Tensor,
                   lam: torch.Tensor) -> torch.Tensor:
    """ELBO with π at its optimum given (γ, λ)."""
    elog_beta = dirichlet_expectation(lam, axis=0)         # (V, K)
    docs = _collapsed_doc_terms(cfg, corpus.token_ids, corpus.counts,
                                gamma, elog_beta)
    return docs + _topics_term(cfg, lam)


def elbo_memoized_stream(cfg: LDAConfig, stream, store, lam: torch.Tensor,
                         *, batch_docs: int = 512) -> torch.Tensor:
    """The memoized ELBO when the corpus is a ``DocStream``.

    The streaming analogue of ``elbo_memoized_store``: documents are pulled
    and padded ``batch_docs`` at a time (``iter_padded_chunks``, the
    document order ``MemoStore.iter_chunks`` walks), the matching memo rows gathered, and each chunk's word/θ terms
    accumulated on ``lam``'s device; the topics term enters once.
    """
    elog_beta = dirichlet_expectation(lam, axis=0)
    total = torch.zeros((), dtype=torch.float32, device=lam.device)
    for start, ids, cnts in iter_padded_chunks(stream, batch_docs,
                                               stream.max_unique):
        pi, _vis = store.gather(np.arange(start, start + ids.shape[0]))
        ids_t = torch.from_numpy(ids).to(lam.device)
        cnts_t = torch.from_numpy(cnts).to(lam.device)
        gamma = cfg.alpha0 + torch.einsum("blk,bl->bk", pi, cnts_t)
        total = total + _memoized_doc_terms(cfg, ids_t, cnts_t, gamma, pi,
                                            elog_beta)
    return total + _topics_term(cfg, lam)


def elbo_collapsed_stream(cfg: LDAConfig, stream, lam: torch.Tensor, *,
                          batch_docs: int = 512) -> torch.Tensor:
    """Collapsed corpus bound over a ``DocStream`` (the MVI/SVI monitoring
    path): a fresh token-gather E-step per chunk, doc terms accumulated on
    ``lam``'s device, the topics term once; never a full-corpus (D, L, K)
    intermediate."""
    elog_beta = dirichlet_expectation(lam, axis=0)
    eb = exp_dirichlet_expectation(lam, axis=0)
    total = torch.zeros((), dtype=torch.float32, device=lam.device)
    for _start, ids, cnts in iter_padded_chunks(stream, batch_docs,
                                                stream.max_unique):
        ids_t = torch.from_numpy(ids).to(lam.device)
        cnts_t = torch.from_numpy(cnts).to(lam.device)
        res = estep_gather(cfg, eb, ids_t, cnts_t)
        total = total + _collapsed_doc_terms(cfg, ids_t, cnts_t, res.gamma,
                                             elog_beta)
    return total + _topics_term(cfg, lam)
