"""Synthetic corpora from the LDA generative model (paper eq. 1), made on
the device.

Each topic φ_k ~ Dirichlet(β) over the V words, each document's θ_d ~
Dirichlet(α) over the topics, each token's topic z ~ θ_d and its word
w ~ φ_z; the document is kept as its unique words (ascending) and their
counts, padded with id 0 and count 0 to the widest document, as the
program's padded ``Corpus`` holds it. Dirichlet draws with a small
concentration are made in log space (Gamma(a) = Gamma(a + 1)·U^(1/a)), so
float32 keeps the small weights.

Document lengths are Poisson(mean length), at least ``min_len``. The
corpus of a configuration is drawn from its own ``corpus_seed``; a run's
seed only relabels its words (``relabeled``), so every seed runs the same
computation up to the names of words and topics, with the same work.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Split:
    ids: torch.Tensor          # (D, L) int32, ascending, 0 on padding
    counts: torch.Tensor       # (D, L) float32, 0 on padding
    lengths: torch.Tensor      # (D,) tokens a document
    theta: torch.Tensor        # (D, K) document-topic proportions

    @property
    def width(self) -> int:
        return self.ids.shape[1]


def log_dirichlet(shape, conc: float, gen: torch.Generator) -> torch.Tensor:
    """log of Dirichlet(conc) draws along the last axis, in float32."""
    dev = gen.device
    g = torch._standard_gamma(
        torch.full(shape, 1.0 + conc, dtype=torch.float32, device=dev),
        generator=gen)
    u = torch.rand(shape, generator=gen, device=dev).clamp_min(1e-38)
    logx = torch.log(g.clamp_min(1e-38)) + torch.log(u) / conc
    return logx - torch.logsumexp(logx, dim=-1, keepdim=True)


def topics(v: int, k: int, beta: float, gen: torch.Generator) -> torch.Tensor:
    """φ (K, V), each row a Dirichlet(β) draw."""
    return torch.exp(log_dirichlet((k, v), beta, gen))


def lengths(n: int, mean_len: float, min_len: int,
            gen: torch.Generator) -> torch.Tensor:
    """Poisson(``mean_len``) lengths, at least ``min_len``, int64."""
    return torch.poisson(torch.full((n,), float(mean_len), device=gen.device),
                         generator=gen).long().clamp_min(min_len)


def make_split(phi: torch.Tensor, n: int, mean_len: float, min_len: int,
               alpha: float, gen: torch.Generator) -> Split:
    """``n`` documents drawn from the topics ``phi``."""
    dev = gen.device
    k, v = phi.shape
    lens = lengths(n, mean_len, min_len, gen)
    theta = torch.exp(log_dirichlet((n, k), alpha, gen))
    width = int(lens.max())
    z = torch.multinomial(theta, width, replacement=True, generator=gen)
    live = torch.arange(width, device=dev)[None, :] < lens[:, None]
    doc = torch.arange(n, device=dev)[:, None].expand(n, width)[live]
    z = z[live]
    # words: the tokens of each topic drawn by inverse CDF, topic by topic
    order = torch.argsort(z, stable=True)
    per_topic = torch.bincount(z, minlength=k).tolist()
    cdf = torch.cumsum(phi.double(), dim=1)
    cdf /= cdf[:, -1:].clone()
    words = torch.empty_like(z)
    lo = 0
    for t, cnt in enumerate(per_topic):
        if cnt:
            u = torch.rand(cnt, generator=gen, device=dev,
                           dtype=torch.float64)
            words[order[lo:lo + cnt]] = torch.searchsorted(
                cdf[t], u, right=True).clamp_max(v - 1)
        lo += cnt
    del order, z
    # bag of words: unique (document, word) pairs, ascending within a row
    key, cnt = torch.unique(doc * v + words, sorted=True, return_counts=True)
    del words, doc
    row = key // v
    per_doc = torch.bincount(row, minlength=n)
    first = torch.cumsum(per_doc, 0) - per_doc
    col = torch.arange(key.numel(), device=dev) - first[row]
    width = int(per_doc.max())
    ids = torch.zeros((n, width), dtype=torch.int32, device=dev)
    counts = torch.zeros((n, width), dtype=torch.float32, device=dev)
    ids[row, col] = (key % v).int()
    counts[row, col] = cnt.float()
    return Split(ids, counts, lens, theta)


def relabeled(ids: torch.Tensor, counts: torch.Tensor,
              new_id: torch.Tensor):
    """The same documents with word w renamed ``new_id[w]``, each row's
    unique ids ascending again, padding (id 0, count 0) after them."""
    live = counts > 0
    key = torch.where(live, new_id[ids.long()], new_id.numel())
    key, order = key.sort(dim=1)
    counts = counts.gather(1, order)
    return torch.where(counts > 0, key, 0).int(), counts


def topic_tokens(theta: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Expected tokens a topic over a split: Σ_d len_d θ_d, (K,)."""
    return (lens.double()[:, None] * theta.double()).sum(0).float()
