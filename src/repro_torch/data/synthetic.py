"""Synthetic corpora sampled from the LDA generative model (paper eq. 1),
with the summary statistics of the paper's Table 1.

``make_corpus`` gives the same corpus as ``repro.data.make_corpus`` bit for
bit. It draws each topic's words the way ``Generator.choice(V, size, p)``
does (normalised CDF, ``random(size)``, ``searchsorted(side="right")``),
which consumes the same random stream, but builds each topic's CDF once
instead of on every call: at the Arxiv vocabulary (V = 141,927) the
per-call cumulative sum is what made generation slow.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict

import numpy as np

from repro_torch.core.types import Corpus
from repro_torch.data.bow import corpus_from_docs


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    name: str
    num_train: int
    num_test: int
    mean_len: int
    vocab_size: int
    num_topics: int = 100       # ground-truth topics used to generate
    alpha: float = 0.1          # generative doc-topic concentration
    beta: float = 0.01          # generative topic-word concentration (sparse)


# Table 1 of the paper, plus CPU-sized variants used by tests.
PAPER_CORPORA: Dict[str, SyntheticSpec] = {
    "ap": SyntheticSpec("ap", 1246, 1000, 198, 10473),
    "newsgroup": SyntheticSpec("newsgroup", 13888, 5000, 249, 27059),
    "wikipedia": SyntheticSpec("wikipedia", 39565, 10000, 260, 42419),
    "arxiv": SyntheticSpec("arxiv", 782385, 100000, 116, 141927),
    "customer_review": SyntheticSpec("customer_review", 452944, 100000, 151,
                                     120043),
    "nyt": SyntheticSpec("nyt", 290000, 10000, 232, 102660),
    "tiny": SyntheticSpec("tiny", 96, 32, 40, 250, num_topics=8),
    "small": SyntheticSpec("small", 512, 128, 80, 1200, num_topics=20),
    "medium": SyntheticSpec("medium", 2048, 256, 120, 4000, num_topics=50),
}


def make_corpus(spec: SyntheticSpec, *, split: str = "train",
                seed: int = 0, scale: float = 1.0, device=None) -> Corpus:
    """Sample a corpus from the LDA generative model.

    ``scale`` < 1 shrinks document counts (not lengths or vocabulary) so
    the paper's large corpora keep their shape at a smaller size.
    """
    if split not in ("train", "test"):
        raise ValueError(f"split must be 'train' or 'test', got {split!r}")
    rng = np.random.default_rng(seed + (1_000_003 if split == "test" else 0))
    n_docs = max(int((spec.num_train if split == "train" else spec.num_test)
                     * scale), 8)
    # ground-truth topics, shared across splits via a fixed topic seed
    # (zlib.crc32: Python's str hash is salted per process)
    topic_rng = np.random.default_rng(zlib.crc32(spec.name.encode()))
    phi = topic_rng.dirichlet([spec.beta] * spec.vocab_size, spec.num_topics)
    cdfs: Dict[int, np.ndarray] = {}
    docs = []
    lengths = np.maximum(rng.poisson(spec.mean_len, n_docs), 4)
    for n in lengths:
        theta = rng.dirichlet([spec.alpha] * spec.num_topics)
        z = rng.choice(spec.num_topics, size=n, p=theta)
        doc = np.empty(n, np.int64)
        for k, cnt in zip(*np.unique(z, return_counts=True)):
            cdf = cdfs.get(k)
            if cdf is None:
                cdf = phi[k].cumsum()
                cdf /= cdf[-1]
                cdfs[k] = cdf
            doc[z == k] = cdf.searchsorted(rng.random(cnt), side="right")
        docs.append(doc)
    return corpus_from_docs(docs, spec.vocab_size, device=device)
