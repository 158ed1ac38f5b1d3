"""Recurrent blocks: Mamba2 (SSD), xLSTM mLSTM / sLSTM
(``repro.models.recurrent``).

One chunked scalar-decay linear recurrence serves Mamba2 and the mLSTM:

    S_t = a_t · S_{t−1} + i_t · k_t ⊗ v_t          (state (N, P) per head)
    y_t = q_t · S_t  [ / normaliser for the mLSTM ]

Mamba2 is the unstabilised case (a = exp(Δ·A), Δ folded into v); the
mLSTM's exponential input gate carries the xLSTM stabiliser m with the
state. A full sequence runs chunk-parallel (``chunked_scan``: the (L, L)
intra-chunk products, then a loop over the chunks), a decode step is the
O(1) recurrence (``recurrence_step``). The decay and stabiliser arithmetic
is fp32 exactly where ``repro`` casts to fp32; the products run in the
activations' dtype where ``repro``'s do.

The sLSTM has a true hidden-to-hidden recurrence (block-diagonal R), so a
full sequence is a loop over time, as ``repro``'s ``lax.scan`` is. In
training it runs under ``repro``'s custom VJP (``_SLSTMSeq``); every other
block is differentiated by autograd, as ``repro``'s are by ``jax.grad``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import recording
from repro_torch.models.layers import Params, rounded, truncated_normal

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# chunked scalar-decay linear recurrence (shared core)
# ---------------------------------------------------------------------------

class RecurrentState(NamedTuple):
    c: torch.Tensor        # (B, H, N, P) (stabilised for mLSTM)
    n: torch.Tensor        # (B, H, N) normaliser (zeros when unused)
    m: torch.Tensor        # (B, H) stabiliser (zeros when unused)


def init_state(b: int, h: int, n: int, p: int, dtype=torch.float32,
               device=None) -> RecurrentState:
    return RecurrentState(torch.zeros((b, h, n, p), dtype=dtype,
                                      device=device),
                          torch.zeros((b, h, n), dtype=dtype, device=device),
                          torch.zeros((b, h), dtype=dtype, device=device))


def chunked_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_a: torch.Tensor, log_i: Optional[torch.Tensor],
                 state: RecurrentState, chunk: int, stabilize: bool
                 ) -> Tuple[torch.Tensor, RecurrentState]:
    """Chunk-parallel linear recurrence.

    q, k: (B, T, H, N); v: (B, T, H, P); log_a, log_i: (B, T, H).
    Returns y (B, T, H, P) and the final state. T must divide by
    ``chunk``; otherwise it raises.
    """
    b, t, h, n = q.shape
    p = v.shape[-1]
    L = min(chunk, t)
    if t % L:
        raise ValueError(f"chunked_scan: T = {t} is no multiple of the "
                         f"chunk {L}")
    nc = t // L

    def to_chunks(x):                          # (B, T, H, ...) →
        x = x.reshape((b, nc, L, h) + x.shape[3:])
        return x.movedim(3, 2).movedim(1, 0)   # (nc, B, H, L, ...)

    qc, kc, vc, lac = (to_chunks(x) for x in (q, k, v, log_a))
    lic = to_chunks(log_i) if log_i is not None else torch.zeros_like(lac)

    idx = torch.arange(L, device=q.device)
    causal = idx[:, None] >= idx[None, :]      # j ≥ i
    c, nvec, m = state
    ys = []
    for ci in range(nc):
        qi, ki, vi = qc[ci], kc[ci], vc[ci]    # (B, H, L, N/P)
        laf, lif = lac[ci].float(), lic[ci].float()      # (B, H, L)
        f = torch.cumsum(laf, dim=-1)          # F_j
        # decay from step i to j (i ≤ j): F_j − F_i + li_i
        g = f[..., :, None] - f[..., None, :] + lif[..., None, :]
        g = torch.where(causal, g, NEG_INF)    # (B, H, L, L)
        binit = f + m[..., None]               # init-state decay (B, H, L)
        if stabilize:
            mj = torch.maximum(g.amax(-1), binit)
        else:
            mj = torch.zeros_like(binit)
        w = torch.exp(g - mj[..., None])
        scores = torch.einsum("bhjn,bhin->bhji", qi, ki)
        ws = torch.where(causal, w * scores.float(), 0.0)
        num = torch.einsum("bhji,bhip->bhjp", ws.to(vi.dtype), vi)
        einit = torch.exp(binit - mj)          # (B, H, L)
        num = num + einit[..., None].to(vi.dtype) * torch.einsum(
            "bhjn,bhnp->bhjp", qi, c.to(qi.dtype))
        if stabilize:
            den = ws.sum(-1) + einit * torch.einsum(
                "bhjn,bhn->bhj", qi, nvec.to(qi.dtype)).float()
            den = torch.maximum(den.abs(), torch.exp(-mj)) + 1e-6
            y = num / den[..., None].to(num.dtype)
        else:
            y = num
        ys.append(y)
        # ---- state update -------------------------------------------------
        ftot = f[..., -1]                      # F_L (B, H)
        gstate = ftot[..., None] - f + lif     # F_L − F_i + li_i (B, H, L)
        bstate = ftot + m                      # F_L + m_prev (B, H)
        if stabilize:
            mnew = torch.maximum(gstate.amax(-1), bstate)
        else:
            mnew = torch.zeros_like(bstate)
        wst = torch.exp(gstate - mnew[..., None])
        est = torch.exp(bstate - mnew)
        c = (est[..., None, None] * c.float()
             + torch.einsum("bhl,bhln,bhlp->bhnp", wst, ki.float(),
                            vi.float()))
        nvec = (est[..., None] * nvec
                + torch.einsum("bhl,bhln->bhn", wst, ki.float()))
        m = mnew
    y = torch.stack(ys, 1)                     # (B, nc, H, L, P)
    y = y.movedim(2, 3).reshape(b, t, h, p)
    return y, RecurrentState(c, nvec, m)


def recurrence_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_a: torch.Tensor, log_i: Optional[torch.Tensor],
                    state: RecurrentState, stabilize: bool
                    ) -> Tuple[torch.Tensor, RecurrentState]:
    """Single-token decode step. q, k: (B, H, N); v: (B, H, P); gates
    (B, H)."""
    laf = log_a.float()
    lif = (log_i if log_i is not None else torch.zeros_like(log_a)).float()
    if stabilize:
        mnew = torch.maximum(laf + state.m, lif)
    else:
        mnew = torch.zeros_like(laf)
    fz = torch.exp(laf + state.m - mnew)       # (B, H)
    iz = torch.exp(lif - mnew)
    c = (fz[..., None, None] * state.c
         + iz[..., None, None] * torch.einsum("bhn,bhp->bhnp", k.float(),
                                              v.float()))
    nvec = fz[..., None] * state.n + iz[..., None] * k.float()
    num = torch.einsum("bhn,bhnp->bhp", q.float(), c)
    if stabilize:
        den = torch.einsum("bhn,bhn->bh", q.float(), nvec)
        den = torch.maximum(den.abs(), torch.exp(-mnew)) + 1e-6
        y = num / den[..., None]
    else:
        y = num
    return y.to(v.dtype), RecurrentState(c, nvec, mnew)


# ---------------------------------------------------------------------------
# causal depthwise conv1d (+ decode ring state)
# ---------------------------------------------------------------------------

def conv1d_train(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """x: (B, T, C); w: (K, C) depthwise causal; returns (B, T, C)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    t = x.shape[1]
    out = xp[:, 0:t] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + t] * w[i]
    return out + b


def conv1d_step(x: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, C); conv_state: (B, K−1, C) of previous inputs (oldest
    first). Computes in the activation dtype; the returned state keeps
    the cache dtype."""
    full = torch.cat([conv_state.to(x.dtype), x[:, None]], dim=1)
    y = torch.einsum("bkc,kc->bc", full, w) + b
    return y, full[:, 1:].to(conv_state.dtype)


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def mamba2_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_head_dim
    return d_in, nheads, cfg.ssm_state


def mamba2_init(cfg: ModelConfig, *, generator, device) -> Params:
    d = cfg.d_model
    d_in, nh, ns = mamba2_dims(cfg)
    conv_c = d_in + 2 * ns
    draw = dict(generator=generator, device=device)
    in_proj = truncated_normal((d, 2 * d_in + 2 * ns + nh), d ** -0.5,
                               **draw)
    conv_w = truncated_normal((cfg.ssm_conv, conv_c), 0.2, **draw)
    u = torch.rand((nh,), generator=generator, device=device)
    lo, hi = torch.log(torch.tensor(0.001)), torch.log(torch.tensor(0.1))
    dt0 = torch.exp(u * (hi - lo).item() + lo.item())
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_c,), device=device),
        "dt_bias": torch.log(torch.expm1(dt0)),
        "a_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                        device=device)),
        "d_skip": torch.ones((nh,), device=device),
        "norm_scale": torch.ones((d_in,), device=device),
        "out_proj": truncated_normal((d_in, d), d_in ** -0.5, **draw),
    }


class Mamba2Cache(NamedTuple):
    conv: torch.Tensor       # (B, K−1, d_in + 2N)
    ssm: RecurrentState


def mamba2_init_cache(cfg: ModelConfig, batch: int,
                      device=None) -> Mamba2Cache:
    """fp32, as ``repro`` makes it whatever the attention caches' dtype."""
    d_in, nh, ns = mamba2_dims(cfg)
    return Mamba2Cache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, d_in + 2 * ns),
                         device=device),
        ssm=init_state(batch, nh, ns, cfg.ssm_head_dim, device=device))


def _mamba2_pre(cfg: ModelConfig, zxbcdt: torch.Tensor):
    """Split in_proj output; returns (z, xbc, dt)."""
    d_in, nh, ns = mamba2_dims(cfg)
    return torch.split(zxbcdt, [d_in, d_in + 2 * ns, nh], dim=-1)


def _mamba2_core(cfg: ModelConfig, p: Params, xbc: torch.Tensor,
                 dt: torch.Tensor):
    """Common post-conv math: split conv output and build SSD operands."""
    d_in, nh, ns = mamba2_dims(cfg)
    xs, bmat, cmat = torch.split(xbc, [d_in, ns, ns], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])                 # (..., nh)
    a = -torch.exp(p["a_log"])                                 # (nh,)
    return xs, bmat, cmat, dt, dt * a


def mamba2_train(cfg: ModelConfig, p: Params, x: torch.Tensor
                 ) -> torch.Tensor:
    """x: (B, T, D) → (B, T, D)."""
    b, t, d = x.shape
    d_in, nh, ns = mamba2_dims(cfg)
    hd = cfg.ssm_head_dim
    dt_ = x.dtype
    z, xbc, dt = _mamba2_pre(cfg, x @ p["in_proj"].to(dt_))
    xbc = F.silu(conv1d_train(xbc, p["conv_w"].to(dt_), p["conv_b"].to(dt_)))
    xs, bmat, cmat, dtf, log_a = _mamba2_core(cfg, p, xbc, dt)
    xh = xs.reshape(b, t, nh, hd)
    v = xh * dtf[..., None].to(dt_)                           # fold Δ into v
    k = bmat[:, :, None, :].expand(b, t, nh, ns)
    q = cmat[:, :, None, :].expand(b, t, nh, ns)
    y, _ = chunked_scan(q, k, v, log_a, None,
                        init_state(b, nh, ns, hd, device=x.device),
                        cfg.chunk_size, stabilize=False)
    y = y + p["d_skip"].to(dt_)[:, None] * xh
    y = _gated_rmsnorm(y.reshape(b, t, d_in), z, p["norm_scale"])
    return y @ p["out_proj"].to(dt_)


def mamba2_step(cfg: ModelConfig, p: Params, x: torch.Tensor,
                cache: Mamba2Cache) -> Tuple[torch.Tensor, Mamba2Cache]:
    """x: (B, 1, D) single-token decode."""
    b = x.shape[0]
    d_in, nh, ns = mamba2_dims(cfg)
    hd = cfg.ssm_head_dim
    dt_ = x.dtype
    z, xbc, dt = _mamba2_pre(cfg, x[:, 0] @ p["in_proj"].to(dt_))
    xbc, conv = conv1d_step(xbc, cache.conv, p["conv_w"].to(dt_),
                            p["conv_b"].to(dt_))
    xbc = F.silu(xbc)
    xs, bmat, cmat, dtf, log_a = _mamba2_core(cfg, p, xbc, dt)
    xh = xs.reshape(b, nh, hd)
    v = xh * dtf[..., None].to(dt_)
    k = bmat[:, None, :].expand(b, nh, ns)
    q = cmat[:, None, :].expand(b, nh, ns)
    y, ssm = recurrence_step(q, k, v, log_a, None, cache.ssm,
                             stabilize=False)
    y = y + p["d_skip"].to(dt_)[:, None] * xh
    y = _gated_rmsnorm(y.reshape(b, 1, d_in), z[:, None], p["norm_scale"])
    return y @ p["out_proj"].to(dt_), Mamba2Cache(conv, ssm)


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    g = y * F.silu(z)
    gf = g.float()
    out = gf * torch.rsqrt((gf ** 2).mean(-1, keepdim=True) + eps)
    return (out * scale).to(y.dtype)


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM)
# ---------------------------------------------------------------------------

def mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_in = 2 * cfg.d_model            # proj_factor = 2
    heads = cfg.num_heads
    return d_in, heads, d_in // heads


def mlstm_init(cfg: ModelConfig, *, generator, device) -> Params:
    d = cfg.d_model
    d_in, h, hd = mlstm_dims(cfg)
    draw = dict(generator=generator, device=device)
    return {
        "w_up": truncated_normal((d, 2 * d_in), d ** -0.5, **draw),
        "conv_w": truncated_normal((4, d_in), 0.2, **draw),
        "conv_b": torch.zeros((d_in,), device=device),
        "wq": truncated_normal((d_in, d_in), d_in ** -0.5, **draw),
        "wk": truncated_normal((d_in, d_in), d_in ** -0.5, **draw),
        "w_gates": truncated_normal((d_in, 2 * h), d_in ** -0.5, **draw),
        "b_gates": torch.cat([torch.zeros((h,), device=device),   # input
                              torch.linspace(3.0, 6.0, h,         # forget
                                             device=device)]),
        "skip": torch.ones((d_in,), device=device),
        "norm_scale": torch.ones((d_in,), device=device),
        "w_down": truncated_normal((d_in, d), d_in ** -0.5, **draw),
    }


class MLSTMCache(NamedTuple):
    conv: torch.Tensor        # (B, 3, d_in)
    cell: RecurrentState


def mlstm_init_cache(cfg: ModelConfig, batch: int,
                     device=None) -> MLSTMCache:
    d_in, h, hd = mlstm_dims(cfg)
    return MLSTMCache(conv=torch.zeros((batch, 3, d_in), device=device),
                      cell=init_state(batch, h, hd, hd, device=device))


def _mlstm_qkvg(cfg: ModelConfig, p: Params, xi: torch.Tensor,
                xc: torch.Tensor):
    """xi: pre-conv branch, xc: post-conv. Returns q, k, v, log_f,
    log_i."""
    d_in, h, hd = mlstm_dims(cfg)
    shp = xi.shape[:-1]
    scale = rounded(hd ** -0.5, xc.dtype)
    q = (xc @ p["wq"].to(xc.dtype)).reshape(shp + (h, hd)) * scale
    k = (xc @ p["wk"].to(xc.dtype)).reshape(shp + (h, hd)) * scale
    v = xi.reshape(shp + (h, hd))
    gates = xi @ p["w_gates"].to(xi.dtype) + p["b_gates"].to(xi.dtype)
    log_i, f_raw = torch.chunk(gates.float(), 2, dim=-1)
    return q, k, v, F.logsigmoid(f_raw), log_i


def mlstm_train(cfg: ModelConfig, p: Params, x: torch.Tensor
                ) -> torch.Tensor:
    b, t, d = x.shape
    d_in, h, hd = mlstm_dims(cfg)
    dt_ = x.dtype
    xi, zg = torch.chunk(x @ p["w_up"].to(dt_), 2, dim=-1)
    xc = F.silu(conv1d_train(xi, p["conv_w"].to(dt_), p["conv_b"].to(dt_)))
    q, k, v, log_f, log_i = _mlstm_qkvg(cfg, p, xi, xc)
    y, _ = chunked_scan(q, k, v, log_f, log_i,
                        init_state(b, h, hd, hd, device=x.device),
                        cfg.chunk_size, stabilize=True)
    y = _headwise_rmsnorm(y, p["norm_scale"]).reshape(b, t, d_in)
    y = y + p["skip"].to(dt_) * xc
    y = y * F.silu(zg)
    return y @ p["w_down"].to(dt_)


def mlstm_step(cfg: ModelConfig, p: Params, x: torch.Tensor,
               cache: MLSTMCache) -> Tuple[torch.Tensor, MLSTMCache]:
    b = x.shape[0]
    d_in, h, hd = mlstm_dims(cfg)
    dt_ = x.dtype
    xi, zg = torch.chunk(x[:, 0] @ p["w_up"].to(dt_), 2, dim=-1)
    xc, conv = conv1d_step(xi, cache.conv, p["conv_w"].to(dt_),
                           p["conv_b"].to(dt_))
    xc = F.silu(xc)
    q, k, v, log_f, log_i = _mlstm_qkvg(cfg, p, xi, xc)
    y, cell = recurrence_step(q, k, v, log_f, log_i, cache.cell,
                              stabilize=True)
    y = _headwise_rmsnorm(y[:, None], p["norm_scale"])[:, 0]
    y = y.reshape(b, d_in) + p["skip"].to(dt_) * xc
    y = y * F.silu(zg)
    return (y @ p["w_down"].to(dt_))[:, None], MLSTMCache(conv, cell)


def _headwise_rmsnorm(y: torch.Tensor, scale: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """y: (..., H, hd) — RMS per head, then flatten and scale."""
    yf = y.float()
    yn = yf * torch.rsqrt((yf ** 2).mean(-1, keepdim=True) + eps)
    flat = yn.reshape(y.shape[:-2] + (-1,))
    return (flat * scale).to(y.dtype)


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM): an honest loop over time
# ---------------------------------------------------------------------------

def _slstm_gates(r, wxb, xc, h, state, heads):
    """One step: the new (c, n, m, h), and the step's (z, iz, fz, o,
    log_f) that the backward reads. All fp32; r: (4, H, hd, hd)."""
    b, d = h.shape
    hd = d // heads
    c, n, m = state
    # the four gates' recurrent products in one (repro: one einsum each)
    rz, ri, rf, ro = torch.einsum("bhj,ghjk->gbhk", h.reshape(b, heads, hd),
                                  r).reshape(4, b, d)
    zr, ir, fr, orr = torch.chunk(wxb, 4, dim=-1)
    z = torch.tanh(zr + rz)
    log_i = ir + xc + ri
    log_f = F.logsigmoid(fr + xc + rf)
    o = torch.sigmoid(orr + ro)
    m_new = torch.maximum(log_f + m, log_i)
    iz = torch.exp(log_i - m_new)
    fz = torch.exp(log_f + m - m_new)
    c_new = fz * c + iz * z
    n_new = fz * n + iz
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, m_new, h_new), (z, iz, fz, o, log_f)


def _slstm_loop(heads, r, wxb, xc):
    """The loop over time from the zero state: hs (B, T, D), and each
    step's (h, c, n, z, iz, fz, o, log_f)."""
    b, t, d4 = wxb.shape
    z0 = wxb.new_zeros((b, d4 // 4))
    c, n, m, h = z0, z0, z0, z0
    steps = []
    for step in range(t):
        (c, n, m, h), gates = _slstm_gates(r, wxb[:, step], xc[:, step], h,
                                           (c, n, m), heads)
        steps.append((h, c, n) + gates)
    return torch.stack([x[0] for x in steps], 1), steps


class _SLSTMSeq(torch.autograd.Function):
    """``repro``'s custom VJP of the sLSTM sequence
    (``repro.models.recurrent._slstm_seq_fwd`` / ``_slstm_seq_bwd``).

    The forward is the loop over time, saving each step's h, c, n and gate
    activations. The backward runs the loop in reverse carrying only
    (gc, gn, gh_rec) and emits each step's gate deltas; dR is then one
    time-batched product a gate. The stabiliser m is a constant in the
    backward, as in ``repro``: h = o·c/n does not depend on m while the
    clamp on n is inactive, and where it is active plain autograd of the
    loop would carry a cotangent through m that ``repro``'s rule drops."""

    @staticmethod
    def forward(ctx, heads, r, wxb, xc):
        hs, steps = _slstm_loop(heads, r, wxb, xc)
        ctx.heads = heads
        ctx.save_for_backward(r, *(torch.stack(x) for x in zip(*steps)))
        return hs

    @staticmethod
    def backward(ctx, ghs):
        r, h_seq, c_seq, n_seq, z, iz, fz, o, log_f = ctx.saved_tensors
        heads = ctx.heads
        t, b, d = h_seq.shape
        hd = d // heads
        sig_f = torch.exp(log_f)

        def shift(x):   # (t − 1); step 0 sees the zero initial state
            return torch.cat([x.new_zeros((1, b, d)), x[:-1]])

        h_prev, c_prev, n_prev = shift(h_seq), shift(c_seq), shift(n_seq)
        gh_out = ghs.to(h_seq.dtype).movedim(1, 0)          # (T, B, D)
        gc = gn = gh_rec = h_seq.new_zeros((b, d))
        deltas = []
        for s in reversed(range(t)):
            gh = gh_out[s] + gh_rec
            nt, ct, ot = n_seq[s], c_seq[s], o[s]
            nhat = torch.clamp(nt, min=1e-6)
            do = gh * ct / nhat
            dc = gc + gh * ot / nhat
            dn = gn - torch.where(nt >= 1e-6, gh * ot * ct / (nhat * nhat),
                                  0.0)
            dz = dc * iz[s]
            dlog_i = (dc * z[s] + dn) * iz[s]
            dlog_f = (dc * c_prev[s] + dn * n_prev[s]) * fz[s]
            gc = dc * fz[s]
            gn = dn * fz[s]
            d_z = dz * (1.0 - z[s] * z[s])
            d_i = dlog_i
            d_f = dlog_f * (1.0 - sig_f[s])
            d_o = do * ot * (1.0 - ot)
            # the recurrent cotangent: δ_g · R_gᵀ a head, summed over gates
            delta = torch.stack([d_z, d_i, d_f, d_o]).reshape(4, b, heads, hd)
            gh_rec = torch.einsum("gbhk,ghjk->gbhj", delta, r).reshape(
                4, b, d).sum(0)
            deltas.append(delta)
        deltas.reverse()
        delta = torch.stack(deltas, 1)                     # (4, T, B, H, hd)
        # one time-batched weight product a gate
        d_r = torch.einsum("tbhj,gtbhk->ghjk", h_prev.reshape(t, b, heads, hd),
                           delta)
        d_z, d_i, d_f, d_o = delta.reshape(4, t, b, d)
        d_wxb = torch.cat([d_z, d_i, d_f, d_o], -1).movedim(0, 1)
        d_xc = (d_i + d_f).movedim(0, 1)
        return None, d_r, d_wxb, d_xc


def slstm_seq(heads: int, r: torch.Tensor, wxb: torch.Tensor,
              xc: torch.Tensor) -> torch.Tensor:
    """hs (B, T, D) from pre-activations wxb (B, T, 4D) and the conv branch
    xc (B, T, D), from the zero state. All fp32; r: (4, H, hd, hd).
    Differentiable by ``repro``'s custom VJP (``_SLSTMSeq``) where autograd
    is recording; the bare loop elsewhere. On ``meta`` (the dry run) the
    shape alone, with the loop's recurrent products as one time-batched
    product of the same operations."""
    if wxb.is_meta:
        b, t, d4 = wxb.shape
        torch.einsum("bthj,ghjk->gbthk",
                     wxb.new_empty((b, t, heads, d4 // 4 // heads)), r)
        return wxb.new_empty((b, t, d4 // 4))
    if recording(r, wxb, xc):
        return _SLSTMSeq.apply(heads, r, wxb, xc)
    return _slstm_loop(heads, r, wxb, xc)[0]


def slstm_init(cfg: ModelConfig, *, generator, device) -> Params:
    d = cfg.d_model
    h = cfg.num_heads
    hd = d // h
    f_up = int(d * 4 / 3)
    draw = dict(generator=generator, device=device)
    return {
        "conv_w": truncated_normal((4, d), 0.2, **draw),
        "conv_b": torch.zeros((d,), device=device),
        "w_in": truncated_normal((d, 4 * d), d ** -0.5, **draw),  # z,i,f,o
        "r": truncated_normal((4, h, hd, hd), hd ** -0.5, **draw),
        "b": torch.cat([torch.zeros((2 * d,), device=device),
                        torch.repeat_interleave(
                            torch.linspace(3.0, 6.0, h, device=device), hd),
                        torch.zeros((d,), device=device)]),
        "norm_scale": torch.ones((d,), device=device),
        "w_up": truncated_normal((d, f_up), d ** -0.5, **draw),
        "w_down": truncated_normal((f_up, d), f_up ** -0.5, **draw),
    }


class SLSTMCache(NamedTuple):
    conv: torch.Tensor     # (B, 3, D)
    c: torch.Tensor        # (B, D)
    n: torch.Tensor        # (B, D)
    h: torch.Tensor        # (B, D)
    m: torch.Tensor        # (B, D)


def slstm_init_cache(cfg: ModelConfig, batch: int,
                     device=None) -> SLSTMCache:
    d = cfg.d_model
    z = torch.zeros((batch, d), device=device)
    return SLSTMCache(conv=torch.zeros((batch, 3, d), device=device),
                      c=z, n=z.clone(), h=z.clone(), m=z.clone())


def _slstm_out(cfg: ModelConfig, p: Params, hs: torch.Tensor,
               dt_) -> torch.Tensor:
    """hs (B, T, D) in ``dt_`` → the block's output: headwise norm, the
    gelu (tanh) up projection, the down projection."""
    b, t, _ = hs.shape
    y = _headwise_rmsnorm(hs.reshape(b, t, cfg.num_heads, -1),
                          p["norm_scale"])
    y = F.gelu(y @ p["w_up"].to(dt_), approximate="tanh")
    return y @ p["w_down"].to(dt_)


def slstm_train(cfg: ModelConfig, p: Params, x: torch.Tensor
                ) -> torch.Tensor:
    dt_ = x.dtype
    xc = F.silu(conv1d_train(x, p["conv_w"].to(dt_), p["conv_b"].to(dt_)))
    wxb = x @ p["w_in"].to(dt_) + p["b"].to(dt_)
    hs = slstm_seq(cfg.num_heads, p["r"].float(), wxb.float(), xc.float())
    return _slstm_out(cfg, p, hs.to(dt_), dt_)


def slstm_step(cfg: ModelConfig, p: Params, x: torch.Tensor,
               cache: SLSTMCache) -> Tuple[torch.Tensor, SLSTMCache]:
    dt_ = x.dtype
    xt = x[:, 0]
    xc, conv = conv1d_step(xt, cache.conv, p["conv_w"].to(dt_),
                           p["conv_b"].to(dt_))
    xc = F.silu(xc)
    wxb = xt @ p["w_in"].to(dt_) + p["b"].to(dt_)
    (c, n, m, hid), _ = _slstm_gates(p["r"].float(), wxb.float(),
                                     xc.float(), cache.h,
                                     (cache.c, cache.n, cache.m),
                                     cfg.num_heads)
    y = _slstm_out(cfg, p, hid.to(dt_)[:, None], dt_)
    return y, SLSTMCache(conv, c, n, hid, m)
