"""Flash attention (K9) behind a checked wrapper.

``flash_attention`` replaces ``repro.kernels.flash_attention.
_flash_kernel``: online-softmax attention over (BH, S, hd), causal or not,
fp32 math on fp32 or bf16 inputs, output in q's dtype. The kernel is CUDA
C++ (``csrc/flash_attention.cu``, its own library, built and loaded by
`repro_torch.kernels.build`); ``flash_attention_plain`` is its plain
PyTorch twin. The wrapper takes the twin only for CPU tensors; for CUDA
tensors it launches the kernel or raises. Each launch adds one to
``LAUNCHES["flash_attention"]``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.lda_estep import _on_cpu, _stream
from repro_torch.kernels.ref import NEG_INF

#: Launches of the kernel since the last ``reset_launches()``.
LAUNCHES: Dict[str, int] = {"flash_attention": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale: Optional[float] = None,
                          kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain twin of K9: scores, masks and softmax in fp32 over the whole
    (S, S) matrix, the product with fp32 values, cast to q's dtype. Keys
    and values may have BH / rep heads (query head bh reads bh // rep)."""
    bh, s, hd = q.shape
    rep = bh // k.shape[0]
    if scale is None:
        scale = hd ** -0.5
    kv_len = s if kv_len is None else kv_len
    kf = k.to(torch.float32).repeat_interleave(rep, dim=0)
    vf = v.to(torch.float32).repeat_interleave(rep, dim=0)
    scores = torch.einsum("bqd,bkd->bqk", q.to(torch.float32) * scale, kf)
    rows = torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(s, device=q.device)[None, :]
    keep = cols < kv_len
    if causal:
        keep = keep & (rows >= cols)
    w = torch.softmax(torch.where(keep, scores, NEG_INF), dim=-1)
    return torch.einsum("bqk,bkd->bqd", w, vf).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """q (BH, S, hd), k and v (BH / rep, S, hd) → (BH, S, hd) in q's dtype
    (K9).

    S must divide by ``min(block_q, S)`` and ``min(block_k, S)``
    (``repro``'s grid rule; the kernel picks its own tiles). Keys at or past
    ``kv_len`` (default S) are masked whether or not the call is causal, so
    a caller that pads S gets attention over the true length. Query head
    ``bh`` reads key/value head ``bh // rep``: grouped-query attention
    without a repeated copy. On the card hd is at most 256.
    """
    bh, s, hd = q.shape
    if k.shape != v.shape or k.ndim != 3 or k.shape[1:] != (s, hd):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if k.shape[0] < 1 or bh % k.shape[0]:
        raise ValueError(f"flash_attention: {bh} query heads do not divide "
                         f"into {k.shape[0]} key/value heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: float32 or bfloat16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    bq, bk = min(block_q, s), min(block_k, s)
    if bq < 1 or bk < 1 or s % bq or s % bk:
        raise ValueError(f"flash_attention: S={s} must divide by the blocks "
                         f"({block_q}, {block_k}); pad upstream")
    kv_len = s if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= s:
        raise ValueError(f"flash_attention: kv_len={kv_len} outside [1, {s}]")
    if scale is None:
        scale = hd ** -0.5
    if _on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     kv_len=kv_len)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    lib = build.load("flash_attention")
    if hd > lib.attn_max_head_dim():
        raise ValueError(f"flash_attention: hd={hd} exceeds the kernel's "
                         f"{lib.attn_max_head_dim()}")
    out = torch.empty_like(q)
    rc = lib.attn_flash(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), bh, bh // k.shape[0], s, hd, kv_len,
                        float(scale), int(bool(causal)), _DTYPES[q.dtype],
                        _stream(q))
    build.check(rc, "attn_flash", library="flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
