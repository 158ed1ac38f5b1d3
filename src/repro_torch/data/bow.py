"""Bag-of-words utilities: ragged documents → padded unique-token layout."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.types import Corpus, resolve_device


def corpus_from_docs(docs: Sequence[np.ndarray], vocab_size: int,
                     max_unique: int | None = None, *,
                     device=None) -> Corpus:
    """Build a padded Corpus from ragged arrays of token ids (with repeats).

    The layout is built on the host with numpy, exactly as ``repro`` builds
    it, and then moved to ``device``.
    """
    device = resolve_device(device)
    uniq: List[Tuple[np.ndarray, np.ndarray]] = []
    for doc in docs:
        ids, cnts = np.unique(np.asarray(doc, dtype=np.int64),
                              return_counts=True)
        uniq.append((ids, cnts))
    width = max((len(i) for i, _ in uniq), default=1)
    if max_unique is not None:
        width = min(width, max_unique)
    width = max(width, 1)
    d = len(uniq)
    out_ids = np.zeros((d, width), np.int32)
    out_cnt = np.zeros((d, width), np.float32)
    for r, (ids, cnts) in enumerate(uniq):
        if len(ids) > width:  # keep the most frequent tokens
            top = np.argsort(-cnts)[:width]
            ids, cnts = ids[top], cnts[top]
        out_ids[r, : len(ids)] = ids
        out_cnt[r, : len(ids)] = cnts
    if out_ids.max(initial=0) >= vocab_size or out_ids.min(initial=0) < 0:
        raise ValueError(f"token ids outside [0, {vocab_size})")
    return Corpus(torch.from_numpy(out_ids).to(device),
                  torch.from_numpy(out_cnt).to(device))
