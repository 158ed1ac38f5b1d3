"""Flash attention (K9) behind a checked wrapper.

``flash_attention`` replaces ``repro.kernels.flash_attention.
_flash_kernel``: online-softmax attention over (BH, S, hd), causal or not,
on fp32 or bf16 inputs, output in q's dtype. It also computes the two
functions of ``repro``'s chunked LM attention (``repro.models.attention.
attention_train``) that the TPU kernel lacks: a sliding window (a causal
row keeps the ``window`` keys up to its own; the kernel skips the key
tiles outside every row's window) and an attention-logit softcap
(``cap·tanh(x / cap)`` on the scaled scores, before the masks and the
softmax). The kernel is CUDA C++
(``csrc/flash_attention.cu``, its own library, built and loaded by
`repro_torch.kernels.build`): bf16 on the tensor cores (``wgmma``, with K
and V tiles fed by TMA; P enters P·V as a bf16 high part plus a bf16 low
part, so its products keep about 16 bits), fp32 in fp32 SIMT math.
``flash_attention_plain`` is its plain PyTorch twin. The wrapper takes the
twin only for CPU tensors; for CUDA tensors it launches the kernel or
raises; for ``meta`` tensors (the dry run, `repro_torch.launch.dryrun`)
it takes a shape-only path that allocates the output and counts the
launch, and never builds the kernel. Each launch adds one to
``LAUNCHES["flash_attention"]`` and its operations to
``FLOPS["flash_attention"]`` (``attention_flops``: 4·hd a kept (query,
key) pair, Q·Kᵀ and P·V, a multiply-add counting two; only the pairs the
masks keep, so a windowed call counts its band), which an operation
counter cannot see in a ``ctypes`` launch.

K9 has no backward (nor has ``repro``'s kernel): called through
``ctypes``, its output would carry no ``grad_fn``, and a training step
routed through it would get zero gradients for the projections before
it. So the wrapper raises, on either device, when autograd is recording
and q, k or v requires grad (``refuse_autograd``); training takes the
plain chunked scan. ``flash_attention_plain`` stays differentiable.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.lda_estep import _device_kind, _stream
from repro_torch.kernels.ref import NEG_INF

#: Launches of the kernel since the last ``reset_launches()``.
LAUNCHES: Dict[str, int] = {"flash_attention": 0}
#: Their operations since the last ``reset_launches()``.
FLOPS: Dict[str, float] = {"flash_attention": 0.0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        FLOPS[name] = 0.0


def _tri(n: int) -> int:
    """1 + 2 + ... + n (0 for n <= 0)."""
    return n * (n + 1) // 2 if n > 0 else 0


def kept_pairs(s: int, kv_len: int, causal: bool,
               window: Optional[int] = None) -> int:
    """The (query, key) pairs of one head that K9's masks keep, over all
    ``s`` rows: key j < ``kv_len``; causal: j <= i; a window: i − j <
    ``window``. Row i < kv_len keeps min(i + 1, window) keys; a row past
    kv_len (padding) min(kv_len, kv_len + window − 1 − i), at least 0."""
    if not causal:
        return s * kv_len
    if window is None or window >= s:
        return _tri(kv_len) + (s - kv_len) * kv_len
    a, n, w1 = min(window, kv_len), s - kv_len, window - 1
    below = _tri(a) + (kv_len - a) * window
    # rows kv_len + d, d < n: min(kv_len, w1 − d) keys where positive
    past = (_tri(w1) - _tri(w1 - n)) - (_tri(w1 - kv_len)
                                         - _tri(w1 - kv_len - n))
    return below + past


def attention_flops(bh: int, s: int, hd: int, kv_len: int,
                    causal: bool, window: Optional[int] = None) -> float:
    """K9's operations on a call: 4·hd a (query, key) pair it keeps
    (``kept_pairs``)."""
    return 4.0 * hd * bh * kept_pairs(s, kv_len, causal, window)


def recording(*tensors: torch.Tensor) -> bool:
    """Whether autograd records through any of ``tensors``: grad mode on
    (not under ``no_grad`` or ``inference_mode``) and one requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def refuse_autograd(what: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd is recording through any of ``tensors``: K9 has
    no backward, and it neither detaches nor falls back."""
    if recording(*tensors):
        raise RuntimeError(
            f"{what}: the flash-attention kernel (K9) has no backward, so "
            "it cannot enter an autograd graph; training takes the plain "
            "chunked attention (attention='plain'), and a prefill runs "
            "under torch.inference_mode")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale: Optional[float] = None,
                          kv_len: Optional[int] = None,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """Plain twin of K9: scores, softcap, masks and softmax in fp32 over
    the whole (S, S) matrix, the product with fp32 values, cast to q's
    dtype. The scaled scores x become ``softcap·tanh(x / softcap)``, then
    the masks drop keys at or past ``kv_len``, after the query (causal)
    and ``window`` or more before it. A row that keeps no key (a padded
    row ``window`` or more past ``kv_len``) is zeros. Keys and values may
    have BH / rep heads (query head bh reads bh // rep)."""
    bh, s, hd = q.shape
    rep = bh // k.shape[0]
    if scale is None:
        scale = hd ** -0.5
    kv_len = s if kv_len is None else kv_len
    kf = k.to(torch.float32).repeat_interleave(rep, dim=0)
    vf = v.to(torch.float32).repeat_interleave(rep, dim=0)
    scores = torch.einsum("bqd,bkd->bqk", q.to(torch.float32) * scale, kf)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    rows = torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(s, device=q.device)[None, :]
    keep = cols < kv_len
    if causal:
        keep = keep & (rows >= cols)
    if window is not None:
        keep = keep & (rows - cols < window)
    w = torch.softmax(torch.where(keep, scores, NEG_INF), dim=-1)
    if window is not None:
        w = w * keep.any(-1, keepdim=True)
    return torch.einsum("bqk,bkd->bqd", w, vf).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128,
                    kv_len: Optional[int] = None,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q (BH, S, hd), k and v (BH / rep, S, hd) → (BH, S, hd) in q's dtype
    (K9).

    S must divide by ``min(block_q, S)`` and ``min(block_k, S)``
    (``repro``'s grid rule; the kernel picks its own tiles). Keys at or past
    ``kv_len`` (default S) are masked whether or not the call is causal, so
    a caller that pads S gets attention over the true length. Query head
    ``bh`` reads key/value head ``bh // rep``: grouped-query attention
    without a repeated copy. ``window`` (an int ≥ 1, causal only) keeps
    for query i the keys j with i − j < window; ``softcap`` (> 0) caps
    the scaled scores at ``softcap·tanh(x / softcap)`` before the masks
    (``flash_attention_plain`` states the function). On the card hd is at
    most 256. The bf16 kernel's tensor maps need 16-byte aligned bases and
    row pitches: a bf16 hd that is no multiple of 8 is zero-padded here to
    the next one (and the output sliced back), and an input whose base is
    not aligned is copied.
    """
    refuse_autograd("flash_attention", q, k, v)
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
    if window is not None and (isinstance(window, bool) or not isinstance(
            window, int) or window < 1):
        raise ValueError(f"flash_attention: window={window!r}; expected an "
                         "int >= 1 or None")
    if window is not None and not causal:
        raise ValueError("flash_attention: a window needs causal=True")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap={softcap!r}; expected a "
                         "number > 0 or None")
    if scale is None:
        scale = hd ** -0.5
    kind = _device_kind(q, k, v, meta=True)
    if kind == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     kv_len=kv_len, window=window,
                                     softcap=softcap)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    flops = attention_flops(bh, s, hd, kv_len, bool(causal), window)
    if kind == "meta":          # shape only: the launch counted, not made
        LAUNCHES["flash_attention"] += 1
        FLOPS["flash_attention"] += flops
        return torch.empty_like(q)
    lib = build.load("flash_attention")
    if hd > lib.attn_max_head_dim():
        raise ValueError(f"flash_attention: hd={hd} exceeds the kernel's "
                         f"{lib.attn_max_head_dim()}")
    width = hd
    if q.dtype == torch.bfloat16:
        width = -(-hd // 8) * 8
        q, k, v = (F.pad(t, (0, width - hd)) if width != hd
                   else t.clone() if t.data_ptr() % 16 else t
                   for t in (q, k, v))
    out = torch.empty_like(q)
    rc = lib.attn_flash(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), bh, bh // k.shape[0], s, width,
                        kv_len, float(scale), int(bool(causal)),
                        min(window or 0, s), float(softcap or 0.0),
                        _DTYPES[q.dtype], _stream(q))
    build.check(rc, "attn_flash", library="flash_attention")
    LAUNCHES["flash_attention"] += 1
    FLOPS["flash_attention"] += flops
    return out if width == hd else out[..., :hd].contiguous()
