"""The E-step kernels of the IVI update, each behind a checked wrapper.

* ``estep_fixed_point`` (K1) — the whole γ fixed point of a mini-batch,
  with the TPU kernel's per-tile stopping rule; replaces
  ``repro.kernels.lda_estep._fixed_point_kernel``. ``estep_fixed_point_pi``
  is the same launch ending with a finish that writes K2's π (the IVI
  update's path).
* ``token_pi`` (K2) — token-aligned π, optionally rounded through bf16;
  replaces ``_token_pi_kernel``.
* ``segment_scatter`` (K3) — the deterministic segment sum of cnt·π into
  (V, K); replaces ``_segment_scatter_kernel``.
* ``memo_delta`` — K2 then K3, the counterpart of ``repro``'s
  ``memo_delta``.
* ``estep_fixed_point_csr`` (K4) — the γ fixed point over a flat CSR token
  stream in any token order, stopped batch-wide; replaces
  ``_csr_fixed_point_kernel``. ``estep_fixed_point_csr_pi`` ends with K5's
  π.
* ``token_pi_csr`` (K5) — flat π (T, K); replaces ``_csr_token_pi_kernel``.
* ``memo_delta_csr`` — K5 then K3 on the flat rows, the counterpart of
  ``repro``'s ``memo_delta_csr``.

K1 and K4 stream Eφ in fp32 or, with ``stream_dtype="bfloat16"``,
rounded through bf16 (``repro``'s ``estep_stream_dtype``): the wrapper
passes the sweeps a rounded fp32 copy of Eφ, and on the padded layout of
the counts too (the flat layout keeps its counts fp32), and π is always
formed from the fp32 Eφ and counts.

The pre-fusion baseline (``ops.estep_cuda_sweeps`` and the retired
scatter), kept to measure the fused kernels against:

* ``estep_sweep`` (K6) — one dense fixed-point sweep over a count matrix
  C (B, V); replaces ``_sweep_kernel``.
* ``sstats`` (K7) — S = Eφ ⊙ (Rᵀ·Eθ) from C; replaces ``_sstats_kernel``.
* ``memo_delta_onehot`` (K8) — π and the new/old masses through per-B-tile
  (nb, V, K) partials; replaces ``_memo_delta_onehot_kernel``.

Each kernel is CUDA C++ (``csrc/lda_estep.cu``, built and loaded by
`repro_torch.kernels.build`) and has a plain PyTorch twin here computing
the same function. A wrapper takes the twin only for CPU tensors; for CUDA
tensors it launches the kernel or raises. Each launch adds one to
``LAUNCHES[name]``, so a run can show which kernels its path went through.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build, ref

_EPS = 1e-30  # fp32-safe (1e-100 underflows to 0)

#: The types K1 and K4 stream Eφ in (``LDAConfig.estep_stream_dtype``).
STREAM_DTYPES = ("float32", "bfloat16")

#: Launches of each kernel since the last ``reset_launches()``.
LAUNCHES: Dict[str, int] = {"fixed_point": 0, "token_pi": 0,
                            "segment_scatter": 0, "fixed_point_csr": 0,
                            "token_pi_csr": 0, "sweep": 0, "sstats": 0,
                            "memo_delta_onehot": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# argument checks shared by the wrappers
# ---------------------------------------------------------------------------

def _expect(name: str, t: torch.Tensor, dtype: torch.dtype,
            shape: Tuple[int, ...]) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors (plain twin), False for CUDA ones (kernel)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("tensors on several devices: "
                         f"{sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device.type == "cpu"


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_fixed_point_smem(lib, name: str, b: int, k: int,
                            block_b: int) -> None:
    """Raise when K1/K4's block would need more shared memory than the card
    gives a block: the fixed point's one limit on K (above 256 topics each
    warp holds its document's Eθ and accumulator there, 2·8·K floats a
    block; K ≤ 3,631 at B = 1,024 on an H100)."""
    need = lib.lda_fixed_point_smem_bytes(b, k, block_b)
    have = lib.lda_max_smem_bytes()
    if have < 0:
        build.check(-have, "lda_max_smem_bytes")
    if need > have:
        raise ValueError(f"{name}: K={k} at B={b} needs {need} bytes of "
                         f"shared memory a block; the card allows {have}")


def check_stream_dtype(stream_dtype: str) -> None:
    """Raise for a type the fixed point does not stream, as ``repro``'s
    ``_stream_cast`` does."""
    if stream_dtype not in STREAM_DTYPES:
        raise ValueError(f"unknown estep_stream_dtype: {stream_dtype}")


def stream_round(x: torch.Tensor, stream_dtype: str) -> torch.Tensor:
    """``x`` as the fixed point reads it when streamed in ``stream_dtype``:
    rounded through bf16 for "bfloat16", as it is for "float32"."""
    check_stream_dtype(stream_dtype)
    if stream_dtype == "float32":
        return x
    return x.to(torch.bfloat16).to(torch.float32)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# K1: the γ fixed point
# ---------------------------------------------------------------------------

def _digamma(x: torch.Tensor) -> torch.Tensor:
    """ψ(x) for x > 0 by the TPU kernel's series (not torch's digamma):
    eight recurrence steps, then the asymptotic expansion."""
    shift = torch.zeros_like(x)
    for _ in range(8):
        shift = shift + 1.0 / x
        x = x + 1.0
    inv = 1.0 / x
    inv2 = inv * inv
    series = torch.log(x) - 0.5 * inv - inv2 * (
        1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 / 252.0))
    return series - shift


def _exp_elog_theta(g: torch.Tensor) -> torch.Tensor:
    s = g.sum(-1, keepdim=True)
    return torch.exp(_digamma(g.clamp_min(1e-10)) - _digamma(s))


def estep_fixed_point_plain(token_ids: torch.Tensor, counts: torch.Tensor,
                            eb: torch.Tensor, gamma0: torch.Tensor,
                            alpha0: float, tol: float, max_iters: int, *,
                            block_b: int = 128,
                            stream_dtype: str = "float32"):
    """Plain twin of K1: the same sweeps, tile by tile, in torch, on Eφ and
    the counts as ``stream_dtype`` streams them."""
    b, k = gamma0.shape
    ebt = stream_round(eb, stream_dtype)[token_ids.long()]   # (B, L, K)
    counts = stream_round(counts, stream_dtype)
    sweeps_cap = max(int(max_iters), 1)
    gammas, sweeps = [], []
    for lo in range(0, b, block_b):
        hi = min(lo + block_b, b)
        g, e, c = gamma0[lo:hi], ebt[lo:hi], counts[lo:hi]
        n = 0
        while n < sweeps_cap:
            et = _exp_elog_theta(g)
            p = torch.einsum("bk,blk->bl", et, e) + _EPS
            g_new = alpha0 + et * torch.einsum("bl,blk->bk", c / p, e)
            delta = (g_new - g).abs().sum() / ((hi - lo) * k)
            g, n = g_new, n + 1
            if bool(delta <= tol):
                break
        gammas.append(g)
        sweeps.append(n)
    gamma = torch.cat(gammas) if gammas else gamma0.clone()
    return (gamma, _exp_elog_theta(gamma),
            torch.tensor(sweeps, dtype=torch.int32, device=gamma0.device))


def estep_fixed_point_pi_plain(token_ids: torch.Tensor, counts: torch.Tensor,
                               eb: torch.Tensor, gamma0: torch.Tensor,
                               alpha0: float, tol: float, max_iters: int, *,
                               block_b: int = 128,
                               stream_dtype: str = "float32",
                               quantize: bool = False):
    """Plain twin of K1 with its finish: ``estep_fixed_point_plain``, then
    ``token_pi_plain`` on its Eθ with the fp32 Eφ and counts."""
    gamma, et, sweeps = estep_fixed_point_plain(
        token_ids, counts, eb, gamma0, alpha0, tol, max_iters,
        block_b=block_b, stream_dtype=stream_dtype)
    return gamma, et, sweeps, token_pi_plain(token_ids, counts, eb, et,
                                             quantize=quantize)


def estep_fixed_point(token_ids: torch.Tensor, counts: torch.Tensor,
                      eb: torch.Tensor, gamma0: torch.Tensor, alpha0: float,
                      tol: float, max_iters: int, *, block_b: int = 128,
                      stream_dtype: str = "float32"):
    """The whole γ fixed point of a padded BOW batch (K1).

    Shapes: token_ids int32 / counts float32 (B, L), eb = Eφ (V, K),
    gamma0 (B, K) → (γ (B, K), Eθ (B, K), sweeps per B-tile (nb,) int32).
    Each tile of ``block_b`` documents sweeps until its mean |Δγ| over its
    real rows and topics is ≤ ``tol``, at most ``max(max_iters, 1)``
    times; Eθ is recomputed from the final γ. With ``stream_dtype=
    "bfloat16"`` the sweeps read Eφ and the counts rounded through bf16,
    as ``repro`` streams its dense C and Eφ. On the card this
    is one cooperative launch over a co-resident grid (several warps per
    document); a grid that cannot be launched that way raises. The token
    ids of a row must be unique (``corpus_from_docs`` makes them so) and
    padding slots carry count 0, which makes this the TPU kernel's
    dense-count function.
    """
    return _fixed_point(token_ids, counts, eb, gamma0, alpha0, tol,
                        max_iters, block_b, stream_dtype, None)[:3]


def estep_fixed_point_pi(token_ids: torch.Tensor, counts: torch.Tensor,
                         eb: torch.Tensor, gamma0: torch.Tensor,
                         alpha0: float, tol: float, max_iters: int, *,
                         block_b: int = 128, stream_dtype: str = "float32",
                         quantize: bool = False):
    """K1 ending with K2's π: (γ, Eθ, sweeps, π (B, L, K)) in one launch.

    γ, Eθ and the sweeps are ``estep_fixed_point``'s, bit for bit; π is
    ``token_pi(token_ids, counts, eb, Eθ, quantize=quantize)``'s, bit for
    bit, formed from the fp32 Eφ whatever ``stream_dtype`` streams.
    """
    return _fixed_point(token_ids, counts, eb, gamma0, alpha0, tol,
                        max_iters, block_b, stream_dtype, bool(quantize))


def _fixed_point(token_ids, counts, eb, gamma0, alpha0, tol, max_iters,
                 block_b, stream_dtype, quantize):
    """K1, with the finish unless ``quantize`` is None. Returns (γ, Eθ,
    sweeps, π or None)."""
    b, l = token_ids.shape
    v, k = eb.shape
    _expect("token_ids", token_ids, torch.int32, (b, l))
    _expect("counts", counts, torch.float32, (b, l))
    _expect("eb", eb, torch.float32, (v, k))
    _expect("gamma0", gamma0, torch.float32, (b, k))
    check_stream_dtype(stream_dtype)
    if block_b < 1:
        raise ValueError(f"block_b must be >= 1, got {block_b}")
    with_pi = quantize is not None
    if _on_cpu(token_ids, counts, eb, gamma0):
        args = (token_ids, counts, eb, gamma0, alpha0, tol, max_iters)
        if with_pi:
            return estep_fixed_point_pi_plain(
                *args, block_b=block_b, stream_dtype=stream_dtype,
                quantize=quantize)
        return (*estep_fixed_point_plain(*args, block_b=block_b,
                                         stream_dtype=stream_dtype), None)
    lib = build.load()
    nb = -(-b // block_b)
    gamma = torch.empty_like(gamma0)
    et = torch.empty_like(gamma0)
    iters = torch.empty(nb, dtype=torch.int32, device=gamma0.device)
    pi = (torch.empty((b, l, k), dtype=torch.float32, device=eb.device)
          if with_pi else None)
    if b == 0:
        return gamma, et, iters, pi
    _check_fixed_point_smem(lib, "estep_fixed_point", b, k, block_b)
    delta = torch.empty(2 * b, dtype=torch.float32, device=gamma0.device)
    # the sweeps' inputs as the stream rounds them (one cast each per call)
    sweep_counts = stream_round(counts, stream_dtype)
    sweep_eb = stream_round(eb, stream_dtype)
    rc = lib.lda_fixed_point(
        token_ids.data_ptr(), counts.data_ptr(), eb.data_ptr(),
        sweep_counts.data_ptr(), sweep_eb.data_ptr(), gamma0.data_ptr(),
        gamma.data_ptr(), et.data_ptr(), delta.data_ptr(), iters.data_ptr(),
        _ptr(pi), b, l, k, float(alpha0), float(tol),
        max(int(max_iters), 1), block_b, int(bool(quantize)),
        _stream(gamma0))
    build.check(rc, "lda_fixed_point")
    LAUNCHES["fixed_point"] += 1
    return gamma, et, iters, pi


# ---------------------------------------------------------------------------
# K2: token-aligned π
# ---------------------------------------------------------------------------

def _pi_of_tokens(ebt: torch.Tensor, counts: torch.Tensor,
                  etheta: torch.Tensor, quantize: bool) -> torch.Tensor:
    """π from the gathered Eφ rows ebt (B, L, K): the arithmetic of K2's
    twin and K8's, so the two agree bit for bit."""
    et = etheta[:, None, :]
    p = (et * ebt).sum(-1) + _EPS
    pi = et * ebt / p[:, :, None]
    pi = torch.where(counts[:, :, None] > 0, pi, 0.0)
    if quantize:
        pi = pi.to(torch.bfloat16).to(torch.float32)
    return pi


def token_pi_plain(token_ids: torch.Tensor, counts: torch.Tensor,
                   eb: torch.Tensor, etheta: torch.Tensor, *,
                   quantize: bool = False) -> torch.Tensor:
    """Plain twin of K2."""
    return _pi_of_tokens(eb[token_ids.long()], counts, etheta, quantize)


def token_pi(token_ids: torch.Tensor, counts: torch.Tensor, eb: torch.Tensor,
             etheta: torch.Tensor, *, quantize: bool = False) -> torch.Tensor:
    """π = Eθ⊙Eφ[id] / (Σ_k Eθ⊙Eφ[id] + 1e-30) per token slot (K2).

    Shapes: token_ids int32 / counts float32 (B, L), eb (V, K), etheta
    (B, K) → π (B, L, K) float32, zero where the count is 0. With
    ``quantize`` π is rounded through bf16 (the memo wire) before it is
    written, so the scatter sums exactly what the memo will hold.
    """
    b, l = token_ids.shape
    v, k = eb.shape
    _expect("token_ids", token_ids, torch.int32, (b, l))
    _expect("counts", counts, torch.float32, (b, l))
    _expect("eb", eb, torch.float32, (v, k))
    _expect("etheta", etheta, torch.float32, (b, k))
    if _on_cpu(token_ids, counts, eb, etheta):
        return token_pi_plain(token_ids, counts, eb, etheta,
                              quantize=quantize)
    lib = build.load()
    pi = torch.empty((b, l, k), dtype=torch.float32, device=eb.device)
    if b * l == 0:
        return pi
    rc = lib.lda_token_pi(token_ids.data_ptr(), counts.data_ptr(),
                          eb.data_ptr(), etheta.data_ptr(), pi.data_ptr(),
                          b * l, l, k, int(bool(quantize)), _stream(eb))
    build.check(rc, "lda_token_pi")
    LAUNCHES["token_pi"] += 1
    return pi


# ---------------------------------------------------------------------------
# K3: segment scatter
# ---------------------------------------------------------------------------

def scatter_segments(token_ids: torch.Tensor, counts: torch.Tensor,
                     vocab_size: int):
    """K3's index preparation (replaces the TPU's ``iota == ids`` selector),
    with fixed sizes only, so it never waits for the device: every row is
    keyed by its id, or by ``vocab_size`` where its count is 0; one stable
    sort of all N keys gives the row order, and a sorted search cuts it at
    every id.

    Returns (order (N,) int64 row indices in sorted order, seg_off (V + 1,)
    int64): id v's rows are ``order[seg_off[v]:seg_off[v + 1]]``, in row
    order, empty for an id that no live row carries. Ids outside [0, V)
    fall outside every range.
    """
    key = torch.where(counts != 0, token_ids, vocab_size)
    keys, order = torch.sort(key, stable=True)
    seg_off = torch.searchsorted(
        keys, torch.arange(vocab_size + 1, dtype=keys.dtype,
                           device=keys.device))
    return order, seg_off


def scatter_segments_plain(token_ids: torch.Tensor, counts: torch.Tensor):
    """The plain twin's index preparation: drop rows with count 0, sort the
    rest stably by id, and cut them into one segment per distinct id.

    Returns (order (N',) int64 row indices in sorted order, seg_ids (U,)
    int64, seg_len (U,) int64, seg_off (U + 1,) int64).
    """
    live = torch.nonzero(counts != 0).squeeze(1)
    ids_sorted, perm = torch.sort(token_ids[live], stable=True)
    order = live[perm]
    seg_ids, seg_len = torch.unique_consecutive(ids_sorted,
                                                return_counts=True)
    seg_off = torch.zeros(seg_len.numel() + 1, dtype=torch.int64,
                          device=counts.device)
    seg_off[1:] = torch.cumsum(seg_len, 0)
    return order, seg_ids.long(), seg_len, seg_off


def segment_scatter_plain(token_ids: torch.Tensor, counts: torch.Tensor,
                          pi_new: torch.Tensor,
                          pi_old: Optional[torch.Tensor], vocab_size: int):
    """Plain twin of K3: segment sums over the same sorted rows."""
    order, seg_ids, seg_len, _ = scatter_segments_plain(token_ids, counts)
    k = pi_new.shape[1]
    seg_of_row = torch.repeat_interleave(
        torch.arange(seg_ids.numel(), device=counts.device), seg_len)
    w = counts[order, None]

    def one(pi):
        sums = torch.zeros((seg_ids.numel(), k), dtype=torch.float32,
                           device=pi.device)
        sums.index_add_(0, seg_of_row, w * pi[order])
        out = torch.zeros((vocab_size, k), dtype=torch.float32,
                          device=pi.device)
        out[seg_ids] = sums
        return out

    return one(pi_new), (None if pi_old is None else one(pi_old))


def segment_scatter(token_ids: torch.Tensor, counts: torch.Tensor,
                    pi_new: torch.Tensor, pi_old: Optional[torch.Tensor],
                    vocab_size: int):
    """S_new = Σ cnt·π_new and S_old = Σ cnt·π_old at the token ids (K3).

    Shapes: flat token rows, token_ids int32 / counts float32 (N,), π rows
    (N, K) → (S_new (V, K), S_old (V, K) or None). The sum over each id's
    rows runs in a fixed (stably sorted) order, so two calls on the same
    inputs give the same bits. On CUDA tensors it never syncs the host.
    """
    (n,) = token_ids.shape
    k = pi_new.shape[1]
    _expect("token_ids", token_ids, torch.int32, (n,))
    _expect("counts", counts, torch.float32, (n,))
    _expect("pi_new", pi_new, torch.float32, (n, k))
    tensors = [token_ids, counts, pi_new]
    if pi_old is not None:
        _expect("pi_old", pi_old, torch.float32, (n, k))
        tensors.append(pi_old)
    if _on_cpu(*tensors):
        return segment_scatter_plain(token_ids, counts, pi_new, pi_old,
                                     vocab_size)
    return segment_scatter_prepared(
        scatter_segments(token_ids, counts, vocab_size), counts, pi_new,
        pi_old, vocab_size)


def segment_scatter_prepared(segments, counts: torch.Tensor,
                             pi_new: torch.Tensor,
                             pi_old: Optional[torch.Tensor], vocab_size: int):
    """K3 on CUDA tensors, given ``scatter_segments(token_ids, counts,
    vocab_size)``: the kernel launch alone, which writes every output row.
    ``segment_scatter`` checks the arguments and calls this."""
    if pi_new.device.type != "cuda":
        raise ValueError(f"segment_scatter_prepared: CUDA tensors only, got "
                         f"{pi_new.device}")
    order, seg_off = segments
    k = pi_new.shape[1]
    _expect("seg_off", seg_off, torch.int64, (vocab_size + 1,))
    lib = build.load()
    s_new = torch.empty((vocab_size, k), dtype=torch.float32,
                        device=pi_new.device)
    s_old = None if pi_old is None else torch.empty_like(s_new)
    rc = lib.lda_segment_scatter(
        order.data_ptr(), seg_off.data_ptr(), vocab_size, counts.data_ptr(),
        pi_new.data_ptr(), None if pi_old is None else pi_old.data_ptr(),
        s_new.data_ptr(), None if s_old is None else s_old.data_ptr(), k,
        _stream(pi_new))
    build.check(rc, "lda_segment_scatter")
    LAUNCHES["segment_scatter"] += 1
    return s_new, s_old


# ---------------------------------------------------------------------------
# the memo correction pair
# ---------------------------------------------------------------------------

def memo_delta(token_ids: torch.Tensor, counts: torch.Tensor,
               eb: torch.Tensor, etheta: torch.Tensor, vocab_size: int,
               old_pi: Optional[torch.Tensor] = None, *,
               quantize: bool = False):
    """Token-aligned π plus segment-summed new/old masses: K2 then K3.

    Shapes: token_ids/counts (B, L), eb (V, K), etheta (B, K), old_pi
    (B, L, K). Returns (π (B, L, K), S_new (V, K)[, S_old (V, K)]), so the
    IVI correction is ``S_new − S_old`` and the batch sufficient
    statistics are ``S_new``.
    """
    k = etheta.shape[1]
    pi = token_pi(token_ids, counts, eb, etheta, quantize=quantize)
    s_new, s_old = segment_scatter(
        token_ids.reshape(-1), counts.reshape(-1), pi.reshape(-1, k),
        None if old_pi is None else old_pi.reshape(-1, k), vocab_size)
    if old_pi is None:
        return pi, s_new
    return pi, s_new, s_old


# ---------------------------------------------------------------------------
# K4: the γ fixed point over a flat CSR token stream
# ---------------------------------------------------------------------------

def _live_end(counts: torch.Tensor) -> torch.Tensor:
    """One past the last live slot (count != 0) of a flat stream, 0 when
    none is live, as an int64 device scalar (no host sync)."""
    pos = torch.arange(1, counts.numel() + 1, dtype=torch.int64,
                       device=counts.device)
    return torch.where(counts != 0, pos, 0).amax() if counts.numel() \
        else torch.zeros((), dtype=torch.int64, device=counts.device)


def check_csr_order(counts: torch.Tensor, segments: torch.Tensor,
                    num_docs: int) -> None:
    """Raise unless the flat stream has the CSR packer's layout: the
    segments are non-decreasing over the slots up to the last live token
    (count != 0), and every live token's segment lies in [0, num_docs). So
    each document's tokens form one contiguous range. The CSR packer emits
    this (documents in order, padding with segment 0 after the last live
    token), and so does ``CSRBackend.flatten`` (each row's padding stays in
    its row). K4 does not need it: it sorts the stream by segment."""
    end = int(_live_end(counts))
    segs = segments[:end].long()
    if bool((segs[1:] < segs[:-1]).any()):
        raise ValueError("CSR stream: live tokens are not grouped by segment "
                         "in non-decreasing order")
    live = segs[counts[:end] != 0]
    if bool(((live < 0) | (live >= num_docs)).any()):
        raise ValueError(f"CSR stream: a live token's segment lies outside "
                         f"[0, {num_docs})")


def csr_doc_ranges(counts: torch.Tensor, segments: torch.Tensor,
                   num_docs: int):
    """K4's walk of a flat stream in any token order, found on the device
    with no host sync: every slot is keyed by its segment where its count
    is not 0, else by ``num_docs``; one stable sort of the T keys gives
    ``order``, and a sorted search cuts it into each document's range
    ``order[offsets[d]:offsets[d + 1]]``: its live tokens, in stream order
    (on the packer's layout the live part of ``order`` is the identity).
    Count-0 slots, and live tokens whose segment lies outside [0,
    num_docs), fall outside every range (the keys are clamped to [-1,
    num_docs], so below 2^15 documents they sort as int16: fewer radix
    passes than int32).

    Returns (order (T,) int64, offsets (num_docs + 1,) int64).
    """
    key = torch.where(counts != 0, segments.clamp(-1, num_docs), num_docs)
    if num_docs < 2 ** 15:
        key = key.to(torch.int16)
    keys, order = torch.sort(key, stable=True)
    offsets = torch.searchsorted(
        keys, torch.arange(num_docs + 1, dtype=keys.dtype,
                           device=keys.device))
    return order, offsets


def _in_range(counts: torch.Tensor, segments: torch.Tensor, num_docs: int):
    """K4's view of a flat stream: the counts with every token whose
    segment lies outside [0, num_docs) set to 0 (it belongs to no
    document, as in ``repro``'s ``iota == segments`` selector), and the
    segments clamped into range, as int64."""
    inside = (segments >= 0) & (segments < num_docs)
    return (torch.where(inside, counts, 0.0),
            segments.long().clamp(0, max(num_docs - 1, 0)))


def estep_fixed_point_csr_plain(token_ids: torch.Tensor, counts: torch.Tensor,
                                segments: torch.Tensor, eb: torch.Tensor,
                                gamma0: torch.Tensor, alpha0: float,
                                tol: float, max_iters: int, *,
                                stream_dtype: str = "float32"):
    """Plain twin of K4: the same sweeps and batch-wide stop, in torch, on
    Eφ as ``stream_dtype`` streams it (the counts stay fp32). The segment
    sums (``index_add_``) take the tokens in any order; a token whose
    segment lies outside [0, B) adds nothing."""
    b, k = gamma0.shape
    ebt = stream_round(eb, stream_dtype)[token_ids.long()]   # (T, K)
    counts, segs = _in_range(counts, segments, b)
    g, n = gamma0, 0
    while n < max(int(max_iters), 1):
        et = _exp_elog_theta(g)
        p = (et[segs] * ebt).sum(-1) + _EPS
        acc = torch.zeros_like(g).index_add_(0, segs,
                                             (counts / p)[:, None] * ebt)
        g_new = alpha0 + et * acc
        delta = (g_new - g).abs().sum() / (b * k)
        g, n = g_new, n + 1
        if bool(delta <= tol):
            break
    return (g, _exp_elog_theta(g),
            torch.tensor([n], dtype=torch.int32, device=gamma0.device))


def estep_fixed_point_csr_pi_plain(token_ids: torch.Tensor,
                                   counts: torch.Tensor,
                                   segments: torch.Tensor, eb: torch.Tensor,
                                   gamma0: torch.Tensor, alpha0: float,
                                   tol: float, max_iters: int, *,
                                   stream_dtype: str = "float32",
                                   quantize: bool = False):
    """Plain twin of K4 with its finish: ``estep_fixed_point_csr_plain``,
    then ``token_pi_csr_plain`` on its Eθ with the fp32 Eφ (zero rows for
    tokens whose segment lies outside [0, B))."""
    gamma, et, sweeps = estep_fixed_point_csr_plain(
        token_ids, counts, segments, eb, gamma0, alpha0, tol, max_iters,
        stream_dtype=stream_dtype)
    counts, segs = _in_range(counts, segments, gamma0.shape[0])
    return gamma, et, sweeps, token_pi_csr_plain(
        token_ids, counts, segs.to(torch.int32), eb, et, quantize=quantize)


def estep_fixed_point_csr(token_ids: torch.Tensor, counts: torch.Tensor,
                          segments: torch.Tensor, eb: torch.Tensor,
                          gamma0: torch.Tensor, alpha0: float, tol: float,
                          max_iters: int, *, stream_dtype: str = "float32"):
    """The whole γ fixed point of a flat CSR batch (K4).

    Shapes: token_ids int32 / counts float32 / segments int32 (T,), eb = Eφ
    (V, K), gamma0 (B, K) → (γ (B, K), Eθ (B, K), sweeps (1,) int32). The
    batch sweeps until the mean |Δγ| over all B rows (rows that own no
    token included) and K topics is ≤ ``tol``, at most ``max(max_iters,
    1)`` times, then Eθ is recomputed from the final γ: ``repro``'s
    batch-wide rule. The tokens may come in any order, as in ``repro``.
    With ``stream_dtype="bfloat16"`` the sweeps read Eφ rounded through
    bf16 (the counts stay fp32, as ``repro``'s CSR path keeps them). On the
    card this is K1's cooperative launch over each document's range of the
    stream sorted by segment (``csr_doc_ranges``; the ids and counts
    gathered in that order once a call), with the whole batch as one
    stopping tile and ``ceil(T / B)`` setting the warps per document.
    """
    return _fixed_point_csr(token_ids, counts, segments, eb, gamma0, alpha0,
                            tol, max_iters, stream_dtype, None)[:3]


def estep_fixed_point_csr_pi(token_ids: torch.Tensor, counts: torch.Tensor,
                             segments: torch.Tensor, eb: torch.Tensor,
                             gamma0: torch.Tensor, alpha0: float, tol: float,
                             max_iters: int, *, stream_dtype: str = "float32",
                             quantize: bool = False):
    """K4 ending with K5's π: (γ, Eθ, sweeps, π (T, K)) in one launch.

    γ, Eθ and the sweeps are ``estep_fixed_point_csr``'s, bit for bit; π is
    ``token_pi_csr(..., Eθ, quantize=quantize)``'s, bit for bit, from the
    fp32 Eφ, with zero rows for count-0 slots and for live tokens whose
    segment lies outside [0, B).
    """
    return _fixed_point_csr(token_ids, counts, segments, eb, gamma0, alpha0,
                            tol, max_iters, stream_dtype, bool(quantize))


def _fixed_point_csr(token_ids, counts, segments, eb, gamma0, alpha0, tol,
                     max_iters, stream_dtype, quantize):
    """K4, with the finish unless ``quantize`` is None. Returns (γ, Eθ,
    sweeps, π or None)."""
    (t,) = token_ids.shape
    v, k = eb.shape
    b = gamma0.shape[0]
    _expect("token_ids", token_ids, torch.int32, (t,))
    _expect("counts", counts, torch.float32, (t,))
    _expect("segments", segments, torch.int32, (t,))
    _expect("eb", eb, torch.float32, (v, k))
    _expect("gamma0", gamma0, torch.float32, (b, k))
    check_stream_dtype(stream_dtype)
    with_pi = quantize is not None
    if _on_cpu(token_ids, counts, segments, eb, gamma0):
        args = (token_ids, counts, segments, eb, gamma0, alpha0, tol,
                max_iters)
        if with_pi:
            return estep_fixed_point_csr_pi_plain(
                *args, stream_dtype=stream_dtype, quantize=quantize)
        return (*estep_fixed_point_csr_plain(*args,
                                             stream_dtype=stream_dtype), None)
    lib = build.load()
    gamma = torch.empty_like(gamma0)
    et = torch.empty_like(gamma0)
    iters = torch.zeros(1, dtype=torch.int32, device=gamma0.device)
    pi = (torch.empty((t, k), dtype=torch.float32, device=eb.device)
          if with_pi else None)
    if b == 0:
        if pi is not None:
            pi.zero_()
        return gamma, et, iters, pi
    if t >= 2 ** 31:
        raise ValueError(f"estep_fixed_point_csr: {t} slots exceed the "
                         "kernel's 2^31")
    _check_fixed_point_smem(lib, "estep_fixed_point_csr", b, k, b)
    order, offsets = csr_doc_ranges(counts, segments, b)
    # the sweeps read each document's tokens as one contiguous run
    ids_sorted, cnts_sorted = token_ids[order], counts[order]
    delta = torch.empty(2 * b, dtype=torch.float32, device=gamma0.device)
    sweep_eb = stream_round(eb, stream_dtype)
    rc = lib.lda_fixed_point_csr(
        ids_sorted.data_ptr(), cnts_sorted.data_ptr(), offsets.data_ptr(),
        order.data_ptr(), eb.data_ptr(), sweep_eb.data_ptr(),
        gamma0.data_ptr(), gamma.data_ptr(), et.data_ptr(), delta.data_ptr(),
        iters.data_ptr(), _ptr(pi), b, t, k, float(alpha0), float(tol),
        max(int(max_iters), 1), int(bool(quantize)), _stream(gamma0))
    build.check(rc, "lda_fixed_point_csr")
    LAUNCHES["fixed_point_csr"] += 1
    return gamma, et, iters, pi


# ---------------------------------------------------------------------------
# K5: flat-token π
# ---------------------------------------------------------------------------

def token_pi_csr_plain(token_ids: torch.Tensor, counts: torch.Tensor,
                       segments: torch.Tensor, eb: torch.Tensor,
                       etheta: torch.Tensor, *,
                       quantize: bool = False) -> torch.Tensor:
    """Plain twin of K5."""
    ebt = eb[token_ids.long()]                         # (T, K)
    et = etheta[segments.long()]                       # (T, K)
    p = (et * ebt).sum(-1) + _EPS
    pi = torch.where(counts[:, None] > 0, et * ebt / p[:, None], 0.0)
    if quantize:
        pi = pi.to(torch.bfloat16).to(torch.float32)
    return pi


def token_pi_csr(token_ids: torch.Tensor, counts: torch.Tensor,
                 segments: torch.Tensor, eb: torch.Tensor,
                 etheta: torch.Tensor, *,
                 quantize: bool = False) -> torch.Tensor:
    """π = Eθ[seg]⊙Eφ[id] / (Σ_k Eθ[seg]⊙Eφ[id] + 1e-30) per flat token slot
    (K5).

    Shapes: token_ids int32 / counts float32 / segments int32 (T,), eb
    (V, K), etheta (B, K) → π (T, K) float32, zero where the count is 0,
    rounded through bf16 with ``quantize``.
    """
    (t,) = token_ids.shape
    v, k = eb.shape
    _expect("token_ids", token_ids, torch.int32, (t,))
    _expect("counts", counts, torch.float32, (t,))
    _expect("segments", segments, torch.int32, (t,))
    _expect("eb", eb, torch.float32, (v, k))
    _expect("etheta", etheta, torch.float32, (etheta.shape[0], k))
    if _on_cpu(token_ids, counts, segments, eb, etheta):
        return token_pi_csr_plain(token_ids, counts, segments, eb, etheta,
                                  quantize=quantize)
    lib = build.load()
    pi = torch.empty((t, k), dtype=torch.float32, device=eb.device)
    if t == 0:
        return pi
    rc = lib.lda_token_pi_csr(token_ids.data_ptr(), counts.data_ptr(),
                              segments.data_ptr(), eb.data_ptr(),
                              etheta.data_ptr(), pi.data_ptr(), t, k,
                              int(bool(quantize)), _stream(eb))
    build.check(rc, "lda_token_pi_csr")
    LAUNCHES["token_pi_csr"] += 1
    return pi


def memo_delta_csr(token_ids: torch.Tensor, counts: torch.Tensor,
                   segments: torch.Tensor, eb: torch.Tensor,
                   etheta: torch.Tensor, vocab_size: int,
                   old_pi: Optional[torch.Tensor] = None, *,
                   quantize: bool = False):
    """Flat π plus segment-summed new/old masses: K5 then K3.

    Shapes: token_ids/counts/segments (T,), eb (V, K), etheta (B, K),
    old_pi (T, K) in the same flat layout. Returns (π (T, K), S_new (V, K)
    [, S_old (V, K)]).
    """
    pi = token_pi_csr(token_ids, counts, segments, eb, etheta,
                      quantize=quantize)
    s_new, s_old = segment_scatter(token_ids, counts, pi, old_pi, vocab_size)
    if old_pi is None:
        return pi, s_new
    return pi, s_new, s_old


# ---------------------------------------------------------------------------
# K6 and K7: the dense per-sweep E-step (pre-fusion baseline)
# ---------------------------------------------------------------------------

def _check_dense(name: str, c: torch.Tensor, etheta: torch.Tensor,
                 eb: torch.Tensor, block_b: int, block_v: int):
    """Shapes of K6/K7's inputs and ``repro``'s grid rule: B and V divide by
    ``min(block, size)``. The blocks only check the grid here; the CUDA
    kernels pick their own tiles."""
    b, v = c.shape
    k = etheta.shape[1]
    _expect("c", c, torch.float32, (b, v))
    _expect("etheta", etheta, torch.float32, (b, k))
    _expect("eb", eb, torch.float32, (v, k))
    bb, bv = min(block_b, b), min(block_v, v)
    if bb < 1 or bv < 1 or b % bb or v % bv:
        raise ValueError(f"{name}: B={b}, V={v} must be padded to the grid "
                         f"(block_b={block_b}, block_v={block_v})")
    return b, v, k


def estep_sweep_plain(c: torch.Tensor, etheta: torch.Tensor,
                      eb: torch.Tensor, alpha0: float) -> torch.Tensor:
    """Plain twin of K6: the dense oracle."""
    return ref.estep_sweep_ref(c, etheta, eb, alpha0)


def estep_sweep(c: torch.Tensor, etheta: torch.Tensor, eb: torch.Tensor,
                alpha0: float, *, block_b: int = 128,
                block_v: int = 512) -> torch.Tensor:
    """One fixed-point sweep γ' = α₀ + Eθ ⊙ ((C ⊘ (Eθ·Eφᵀ + ε))·Eφ) (K6).

    Shapes: c (B, V), etheta (B, K), eb (V, K) float32 → (B, K). B and V
    must already be padded to the block grid (see ``ops.pad_inputs``). On
    the card any K runs: above 128 topics the grid gains an axis over tiles
    of 128, each block forming the whole denominator before its own tile's
    columns.
    """
    b, v, k = _check_dense("estep_sweep", c, etheta, eb, block_b, block_v)
    if _on_cpu(c, etheta, eb):
        return estep_sweep_plain(c, etheta, eb, alpha0)
    lib = build.load()
    out = torch.empty((b, k), dtype=torch.float32, device=c.device)
    if b == 0:
        return out
    splits = lib.lda_sweep_splits(b, v)
    part = torch.empty((splits, b, k), dtype=torch.float32, device=c.device)
    # one ticket per (64-row tile (the kernel's kSweepBM), K tile)
    tickets = torch.zeros(-(-b // 64) * lib.lda_dense_k_tiles(k),
                          dtype=torch.int32, device=c.device)
    rc = lib.lda_sweep(c.data_ptr(), etheta.data_ptr(), eb.data_ptr(),
                       out.data_ptr(), part.data_ptr(), tickets.data_ptr(),
                       b, v, k, float(alpha0), splits, _stream(c))
    build.check(rc, "lda_sweep")
    LAUNCHES["sweep"] += 1
    return out


def sstats_plain(c: torch.Tensor, etheta: torch.Tensor,
                 eb: torch.Tensor) -> torch.Tensor:
    """Plain twin of K7: the dense oracle."""
    return ref.sstats_ref(c, etheta, eb)


def sstats(c: torch.Tensor, etheta: torch.Tensor, eb: torch.Tensor, *,
           block_b: int = 128, block_v: int = 512) -> torch.Tensor:
    """Expected topic-word counts S = Eφ ⊙ (Rᵀ·Eθ), R = C ⊘ (Eθ·Eφᵀ + ε)
    (K7). Shapes and grid as ``estep_sweep``; returns (V, K)."""
    b, v, k = _check_dense("sstats", c, etheta, eb, block_b, block_v)
    if _on_cpu(c, etheta, eb):
        return sstats_plain(c, etheta, eb)
    lib = build.load()
    out = torch.empty((v, k), dtype=torch.float32, device=c.device)
    rc = lib.lda_sstats(c.data_ptr(), etheta.data_ptr(), eb.data_ptr(),
                        out.data_ptr(), b, v, k, _stream(c))
    build.check(rc, "lda_sstats")
    LAUNCHES["sstats"] += 1
    return out


# ---------------------------------------------------------------------------
# K8: the one-hot memo delta (the retired scatter, kept as a baseline)
# ---------------------------------------------------------------------------

# The TPU kernel's VMEM budget for one grid step (``repro``'s
# ``_DELTA_VMEM_BUDGET``): the B-tile, and with it the number of partials,
# follows from it, so the card keeps the baseline's partial count.
_DELTA_VMEM_BUDGET = 8 * 1024 * 1024


def delta_effective_block_b(b: int, l: int, k: int, *, block_b: int = 32,
                            block_v: int = 128, has_old: bool = True) -> int:
    """The B-tile ``memo_delta_onehot`` runs: ``block_b`` (capped at B),
    halved until the TPU step ((3 or 4) (bB, L, K) cubes plus the
    (block_v, bB·L) one-hot, fp32) fits the budget, keeping B divisible."""
    block_b = min(block_b, b)
    ncubes = 4 if has_old else 3

    def _step_bytes(bb):
        return (ncubes * bb * l * k + block_v * bb * l) * 4

    while block_b > 1 and _step_bytes(block_b) > _DELTA_VMEM_BUDGET:
        nxt = block_b // 2
        block_b = nxt if b % nxt == 0 else 1   # keep the grid exact
    return block_b


def memo_delta_onehot_plain(token_ids: torch.Tensor, counts: torch.Tensor,
                            eb_tok: torch.Tensor, etheta: torch.Tensor,
                            vocab_size: int,
                            old_pi: Optional[torch.Tensor] = None, *,
                            quantize: bool = False, block_b: int = 32,
                            block_v: int = 128):
    """Plain twin of K8: π as K2's twin forms it, then one (Vp, K) partial
    per B-tile (``index_add_`` of cnt·π), summed over the tiles."""
    b, l = token_ids.shape
    k = etheta.shape[1]
    bb = delta_effective_block_b(b, l, k, block_b=block_b, block_v=block_v,
                                 has_old=old_pi is not None)
    vp = -(-vocab_size // block_v) * block_v
    pi = _pi_of_tokens(eb_tok, counts, etheta, quantize)
    inside = (token_ids >= 0) & (token_ids < vp)
    idx = torch.where(inside, token_ids, 0).long()

    def partials(p):
        w = torch.where(inside[:, :, None], counts[:, :, None] * p, 0.0)
        part = torch.zeros((b // bb, vp, k), dtype=torch.float32,
                           device=p.device)
        for i in range(b // bb):
            rows = slice(i * bb, (i + 1) * bb)
            part[i].index_add_(0, idx[rows].reshape(-1),
                               w[rows].reshape(-1, k))
        return part.sum(0)[:vocab_size]

    if old_pi is None:
        return pi, partials(pi)
    return pi, partials(pi), partials(old_pi)


def memo_delta_onehot(token_ids: torch.Tensor, counts: torch.Tensor,
                      eb_tok: torch.Tensor, etheta: torch.Tensor,
                      vocab_size: int, old_pi: Optional[torch.Tensor] = None,
                      *, quantize: bool = False, block_b: int = 32,
                      block_v: int = 128):
    """The retired memo delta, kept as the benchmark baseline (K8).

    Same contract as ``memo_delta`` with the gathered cube as input:
    token_ids int32 / counts float32 (B, L), eb_tok = Eφ[ids] (B, L, K),
    etheta (B, K), old_pi (B, L, K) → (π (B, L, K), S_new (V, K)[, S_old]).
    The masses pass through nb = B / ``delta_effective_block_b(...)``
    per-B-tile (nb, Vp, K) partials (Vp = V padded to ``block_v``), each
    written once and summed over nb: the transient the segment-sum pair
    (K2 + K3) removes. B must divide by the effective B-tile. On the card
    the V tile is 128 (``block_v`` sets the B-tile and the padding only);
    above 128 topics the grid gains an axis over tiles of 128 topics.
    """
    b, l = token_ids.shape
    k = etheta.shape[1]
    _expect("token_ids", token_ids, torch.int32, (b, l))
    _expect("counts", counts, torch.float32, (b, l))
    _expect("eb_tok", eb_tok, torch.float32, (b, l, k))
    _expect("etheta", etheta, torch.float32, (b, k))
    tensors = [token_ids, counts, eb_tok, etheta]
    if old_pi is not None:
        _expect("old_pi", old_pi, torch.float32, (b, l, k))
        tensors.append(old_pi)
    bb = delta_effective_block_b(b, l, k, block_b=block_b, block_v=block_v,
                                 has_old=old_pi is not None)
    if b % bb:
        raise ValueError(f"memo_delta_onehot: B={b} does not divide by the "
                         f"B-tile {bb}")
    if _on_cpu(*tensors):
        return memo_delta_onehot_plain(token_ids, counts, eb_tok, etheta,
                                       vocab_size, old_pi, quantize=quantize,
                                       block_b=block_b, block_v=block_v)
    lib = build.load()
    nb = b // bb
    if nb > 65535 or bb * l >= 2 ** 31:
        raise ValueError(f"memo_delta_onehot: {nb} B-tiles of {bb * l} slots "
                         "exceed the kernel's grid")
    tile_v = lib.lda_onehot_block_v()
    vp = -(-vocab_size // tile_v) * tile_v
    dev = eb_tok.device
    pi = torch.empty((b, l, k), dtype=torch.float32, device=dev)
    s_new = torch.empty((vocab_size, k), dtype=torch.float32, device=dev)
    part_new = torch.empty((nb, vp, k), dtype=torch.float32, device=dev)
    s_old = part_old = None
    if old_pi is not None:
        s_old = torch.empty_like(s_new)
        part_old = torch.empty_like(part_new)
    rc = lib.lda_memo_delta_onehot(
        token_ids.data_ptr(), counts.data_ptr(), eb_tok.data_ptr(),
        None if old_pi is None else old_pi.data_ptr(), etheta.data_ptr(),
        pi.data_ptr(), part_new.data_ptr(),
        None if part_old is None else part_old.data_ptr(), s_new.data_ptr(),
        None if s_old is None else s_old.data_ptr(), b, l, k, vocab_size, bb,
        vp, int(bool(quantize)), _stream(eb_tok))
    build.check(rc, "lda_memo_delta_onehot")
    LAUNCHES["memo_delta_onehot"] += 1
    if old_pi is None:
        return pi, s_new
    return pi, s_new, s_old
