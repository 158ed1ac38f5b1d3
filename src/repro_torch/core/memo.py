"""Per-document memo stores: the π memo behind one contract.

IVI's defining cost (Alg. 1 / eq. 4) is the per-document memo of
token-aligned responsibilities π. Engines reach it only through
``MemoStore``:

    gather(doc_idx, width=None) -> (π_old (B, width, K) fp32, visited (B,))
    update(doc_idx, π_new)      -> store

``DenseMemoStore`` holds it on the device in fp32 ``(D, L, K)``: exact, and
the store the single-host IVI path runs on. The bf16 host-chunked and
γ-only stores of ``repro`` are not ported yet (ROADMAP.md).

``gather`` takes an optional ``width`` (≤ L) and returns the first
``width`` memo columns; ``update`` takes π at any width ≤ L and zero-pads
it to L. Stream-fed batches are packed at a ladder width
(`repro_torch.data.stream`), so the E-step and the memo traffic shrink to
that width.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import LDAConfig, resolve_device


class MemoStore:
    """One memo contract for every engine (see module docstring)."""

    kind: str = "abstract"
    # wire dtype of the stored π: engines round π through it BEFORE the
    # add-new side of the correction so ⟨m_vk⟩ adds exactly what the store
    # will later subtract
    pi_wire_dtype: str = "float32"
    num_docs: int
    max_unique: int
    num_topics: int

    def gather(self, doc_idx, width: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Return (π_old (B, width, K) fp32, visited (B,) bool); ``width``
        defaults to L."""
        raise NotImplementedError

    def update(self, doc_idx, pi: torch.Tensor) -> "MemoStore":
        """Write a batch's new π (B, width ≤ L, K), zero-padded to L, and
        mark it visited.

        The return value is the handle valid after the call; callers that
        need a before/after comparison copy out (``gather``) first.
        """
        raise NotImplementedError

    def footprint_bytes(self) -> int:
        raise NotImplementedError

    def state_dict(self) -> Dict[str, np.ndarray]:
        """The store's full durable state as flat {key: host array}, in the
        store's own storage dtype."""
        raise NotImplementedError

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> "MemoStore":
        """Restore from ``state_dict`` output. Returns the live handle."""
        raise NotImplementedError

    def iter_chunks(self, batch_docs: int = 512
                    ) -> Iterator[Tuple[np.ndarray, torch.Tensor,
                                        torch.Tensor]]:
        """Yield (doc_idx, π, visited) over the corpus — the read-through
        path of the memoized ELBO."""
        for lo in range(0, self.num_docs, batch_docs):
            idx = np.arange(lo, min(lo + batch_docs, self.num_docs))
            pi, vis = self.gather(idx)
            yield idx, pi, vis


class DenseMemoStore(MemoStore):
    """Device-resident fp32 memo, the exact store."""

    kind = "dense"

    def __init__(self, pi: torch.Tensor, visited: torch.Tensor):
        self.pi = pi                   # (D, L, K) float32
        self.visited = visited         # (D,) bool

    @property
    def num_docs(self) -> int:
        return self.pi.shape[0]

    @property
    def max_unique(self) -> int:
        return self.pi.shape[1]

    @property
    def num_topics(self) -> int:
        return self.pi.shape[2]

    def _index(self, doc_idx) -> torch.Tensor:
        return torch.as_tensor(np.asarray(doc_idx), dtype=torch.int64,
                               device=self.pi.device)

    def gather(self, doc_idx, width: Optional[int] = None):
        idx = self._index(doc_idx)
        pi = self.pi[idx] if width is None or width == self.max_unique \
            else self.pi[idx, :width]
        return pi, self.visited[idx]

    def update(self, doc_idx, pi) -> "DenseMemoStore":
        # in place: repro donates the memo buffers to this scatter
        # (memo.py:153), so the old handle is consumed either way
        idx = self._index(doc_idx)
        w = pi.shape[1]
        self.pi[idx, :w] = pi
        if w < self.max_unique:
            self.pi[idx, w:] = 0.0
        self.visited[idx] = True
        return self

    def footprint_bytes(self) -> int:
        return self.pi.numel() * 4 + self.visited.numel()

    def state_dict(self) -> Dict[str, np.ndarray]:
        # copies, never views: on the CPU .cpu() would alias the live memo
        return {"pi": self.pi.to("cpu", copy=True).numpy(),
                "visited": self.visited.to("cpu", copy=True).numpy()}

    def load_state_dict(self, state) -> "DenseMemoStore":
        pi = np.asarray(state["pi"])
        if pi.shape != tuple(self.pi.shape):
            raise ValueError(f"memo: checkpoint shape {pi.shape} != store "
                             f"{tuple(self.pi.shape)} — the checkpoint "
                             "belongs to a different corpus/config")
        self.pi.copy_(torch.from_numpy(np.array(pi, dtype=np.float32)))
        self.visited.copy_(torch.from_numpy(
            np.array(state["visited"], dtype=bool)))
        return self


def make_memo_store(kind: str, cfg: LDAConfig, num_docs: int,
                    max_unique: int, *, device=None) -> MemoStore:
    """A zeroed store with nothing visited."""
    if kind == "dense":
        device = resolve_device(device)
        return DenseMemoStore(
            pi=torch.zeros((num_docs, max_unique, cfg.num_topics),
                           dtype=torch.float32, device=device),
            visited=torch.zeros((num_docs,), dtype=torch.bool,
                                device=device))
    if kind in ("chunked", "gamma"):
        raise NotImplementedError(
            f"memo store {kind!r} is not ported yet (ROADMAP.md, queue 1)")
    raise ValueError(f"unknown memo store kind: {kind!r} "
                     "(have dense; chunked | gamma are not ported yet)")
