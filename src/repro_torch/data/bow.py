"""Bag-of-words utilities: ragged documents → padded unique-token layout,
plus the length-bucketed view that shrinks per-batch padding."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.types import Corpus, resolve_device
from repro_torch.data.stream import (TOKEN_SLOT_BYTES, WIDTH_BOUNDARIES,
                                     bucket_rows)


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


@dataclasses.dataclass(frozen=True)
class LengthBuckets:
    """Length-bucketed corpus view: document indices grouped by the padded
    width that covers their unique-token count.

    The corpus tensors stay in the canonical (D, L) layout; a bucket only
    records *which rows* belong to it and *how many leading columns* of
    those rows are live, so a batch drawn from bucket *b* can be sliced to
    ``(B, widths[b])``: E-step work and memo gather/update traffic then
    scale with the bucket's own padding, not the corpus-wide maximum L.
    """

    doc_idx: List[np.ndarray]     # per bucket: original corpus row indices
    widths: List[int]             # per bucket: live column count (≤ L)

    @property
    def num_buckets(self) -> int:
        return len(self.widths)


def bucket_corpus(corpus: Corpus,
                  boundaries: Optional[Sequence[int]] = None
                  ) -> LengthBuckets:
    """Group documents into ladder-width buckets.

    A ``LengthBuckets`` view over `repro_torch.data.stream.bucket_rows`
    (keyed on the last live column, which is the unique-token count in the
    canonical leading-column layout). Buckets with no documents are
    dropped; the final bucket width is the corpus max L, so every document
    lands somewhere; empty documents join the narrowest bucket.
    """
    if boundaries is None:
        boundaries = WIDTH_BOUNDARIES
    buckets = bucket_rows(corpus.counts.cpu().numpy(), boundaries)
    return LengthBuckets(doc_idx=[rows for rows, _ in buckets],
                         widths=[w for _, w in buckets])


def bucket_padding_stats(corpus: Corpus, buckets: LengthBuckets) -> dict:
    """Padding-waste accounting: slots touched per epoch, flat vs bucketed,
    plus the pad fraction inside each bucket (live slots vs padded slots)."""
    d, l = corpus.num_docs, corpus.max_unique
    cnts = corpus.counts.cpu().numpy()
    flat = d * l
    per_bucket = []
    bucketed = 0
    live_total = 0
    for rows, w in zip(buckets.doc_idx, buckets.widths):
        slots = len(rows) * w
        live = int((cnts[rows, :w] > 0).sum())
        bucketed += slots
        live_total += live
        per_bucket.append({"width": int(w), "docs": len(rows),
                           "pad_frac": 1.0 - live / max(slots, 1),
                           "wasted_token_bytes":
                               (slots - live) * TOKEN_SLOT_BYTES})
    return {"flat_slots": flat, "bucketed_slots": bucketed,
            "slot_ratio": bucketed / max(flat, 1),
            "wasted_token_bytes":
                (bucketed - live_total) * TOKEN_SLOT_BYTES,
            "per_bucket": per_bucket}


def pad_corpus(corpus: Corpus, num_docs: int) -> Corpus:
    """Pad with empty documents so ``num_docs`` divides the batch grid."""
    d = corpus.num_docs
    if d >= num_docs:
        return corpus
    pad = num_docs - d
    ids = torch.cat([corpus.token_ids,
                     corpus.token_ids.new_zeros((pad, corpus.max_unique))])
    cnt = torch.cat([corpus.counts,
                     corpus.counts.new_zeros((pad, corpus.max_unique))])
    return Corpus(ids, cnt)
