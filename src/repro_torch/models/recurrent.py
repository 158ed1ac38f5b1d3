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

Over a mesh each block takes a model rank's ``LayerPlan`` (``tp``) and
computes the rank's heads (``Share``); the caller sums its output over
``model``. A decode step updates the rank's heads of the replicated
recurrent state and restores the whole state with one all-gather.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import recording
from repro_torch.models.layers import (Params, Runs, rounded, take_runs,
                                       truncated_normal)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# a rank's share of a block's heads
# ---------------------------------------------------------------------------

class Share:
    """The heads of a recurrent block that one rank computes, and the
    leaves' columns they read.

    ``tp``: None (one card: every head) or a model rank's ``LayerPlan``,
    whose ``split`` puts the block's ``heads`` over M model ranks:
    * H divisible by M: the rank computes H / M heads;
    * M divisible by H (``group``, fewer heads than ranks): H groups of
      g = M / H ranks, one a head; with ``group="values"`` a group's ranks
      split the head's value columns (the mLSTM), with ``"repeat"`` each
      repeats the head (the sLSTM, whose recurrence a split would cross at
      every step). What the ranks of a group hold alike, each passes on
      its g-th of (``block``), so a gather brings in each head once;
    * else it raises with both numbers.
    ``rows``: a decode step, whose products gather their rows rather than
    the weights' columns (``LayerPlan.project``)."""

    def __init__(self, cfg: ModelConfig, tp, p: Params, key: str,
                 heads: int, width: int, group: Optional[str] = None,
                 rows: bool = False):
        self.tp, self.p, self.rows = tp, p, rows
        self.spec = None if tp is None else tp.spec[key]
        split = tp is not None and tp.split
        self.ranks, self.rank = ((tp.plan.m_size, tp.plan.m) if split
                                 else (1, 0))
        m = self.ranks
        if heads % m == 0:
            self.group, self.hl = 1, heads // m
            self.h0, self.j = self.rank * self.hl, 0
        elif group is not None and m % heads == 0 \
                and width % (m // heads) == 0:
            self.group, self.hl = m // heads, 1
            self.h0, self.j = self.rank // self.group, self.rank % self.group
        else:
            raise ValueError(f"{cfg.name}: {key}'s {heads} heads of width "
                             f"{width} do not split over a model axis of {m}")
        self.values = group == "values"
        self.width = width
        # the columns of the rank's values: its heads', or its block of
        # its head's under a split group
        vl = width // self.group if self.values else width
        self.vl = self.hl * vl
        v0 = self.h0 * width + (self.j * vl if self.values else 0)
        self.vcols = (v0, v0 + self.vl)

    @property
    def split(self) -> bool:
        return self.ranks > 1

    def heads(self) -> Tuple[int, int]:
        return self.h0, self.h0 + self.hl

    def cols(self) -> Tuple[int, int]:
        """The channels of the rank's heads."""
        return self.h0 * self.width, (self.h0 + self.hl) * self.width

    def part(self, n: int) -> Tuple[int, int]:
        """The rank's share of ``n`` independent columns (an FFN's): its
        block where the rules shard them, the same cut where they do
        not."""
        return self.rank * n // self.ranks, (self.rank + 1) * n // self.ranks

    def w(self, name: str, dim: int, runs: Runs) -> torch.Tensor:
        """The entries ``runs`` of leaf ``name`` along ``dim``."""
        if self.tp is None:
            return take_runs(self.p[name], dim, runs)
        return self.tp.take(self.p[name], self.spec[name], dim, runs)

    def proj(self, x: torch.Tensor, name: str, runs: Runs) -> torch.Tensor:
        """``x @ W[:, runs]`` for the (K, N) leaf ``name``."""
        if self.tp is None:
            return x @ take_runs(self.p[name], 1, runs).to(x.dtype)
        return self.tp.project(x, self.p[name], self.spec[name], runs,
                               self.rows)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the model ranks of a statistic each computed on its
        part (a norm's sum of squares), inside the block: the backward
        sums the ranks' cotangents too, every rank's part having used
        it."""
        if not self.split:
            return x
        comm, model = self.tp.plan.comm, self.tp.plan.model
        return comm.sum_grad(comm.all_reduce(x, model), (model,),
                             ordered=False)

    def group_mean(self, ms: torch.Tensor) -> torch.Tensor:
        """The mean over a value-split group of each rank's mean ``ms``
        (..., 1, 1) of its columns of its head: the rank's partial in its
        head's slot, zeros elsewhere, summed over ``model``."""
        if self.group == 1:
            return ms
        heads = self.ranks // self.group
        slots = F.pad(ms[..., 0], (self.h0, heads - self.h0 - 1))
        return self.psum(slots)[..., self.h0:self.h0 + 1, None] / self.group

    def block(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The rank's g-th along ``dim`` of what its group's ranks hold
        alike (all of it when each rank has heads of its own)."""
        if self.group == 1:
            return x
        n = x.shape[dim] // self.group
        return x.narrow(dim, self.j * n, n)

    def _assemble(self, parts: torch.Tensor, dim: int,
                  vdim: Optional[int]) -> torch.Tensor:
        """(M, *S) of the ranks' parts, coordinate order → the whole along
        ``dim`` (S[dim] = the rank's heads); a group's blocks along
        ``vdim`` joined (a split group's values, or ``block``'s parts),
        else the group's first rank's part kept."""
        a, g = self.ranks // self.group, self.group
        parts = parts.reshape((a, g) + parts.shape[1:])
        if vdim is not None and g > 1:
            y = parts.movedim(1, 1 + vdim).flatten(1 + vdim, 2 + vdim)
        else:
            y = parts[:, 0]
        return y.movedim(0, dim).flatten(dim, dim + 1)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole of a tensor of which the rank holds its heads' channels
        along ``dim``, for the block's column-parallel remainder: each rank
        passes on its ``block``; the backward sums the ranks' cotangents of
        it (each a part of the remainder's). A repeating group's ranks
        each take their block's cotangent back through their copy of the
        head: the sum over the group is the head's, the backward being
        linear in it."""
        if not self.split:
            return x
        comm, model = self.tp.plan.comm, (self.tp.plan.model,)
        parts = comm.all_gather(self.block(x, dim)[None], 0, model,
                                grad_sum=model)
        return self._assemble(parts, dim, dim)

    def restore(self, x: torch.Tensor, dim: int,
                vdim: Optional[int] = None) -> torch.Tensor:
        """A decode step's new recurrent state, replicated over ``model``
        as the rules place it, from the rank's part of it: its heads along
        ``dim``, under a group its block along ``vdim`` (its value columns,
        or ``block``'s part of what the group holds alike; else the group's
        first rank's part is kept). One all-gather, counted as
        ``state_restore``."""
        if not self.split:
            return x
        comm = self.tp.plan.comm
        parts = comm.all_gather(x[None], 0, (self.tp.plan.model,),
                                kind="state_restore")
        return self._assemble(parts, dim, vdim)


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
                b: torch.Tensor, runs: Optional[Runs] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, C); conv_state: (B, K−1, C) of previous inputs (oldest
    first). Computes in the activation dtype; the returned state keeps
    the cache dtype. ``runs``: the channels (of C) the output is computed
    for, ``w`` and ``b`` theirs; the state keeps every channel."""
    full = torch.cat([conv_state.to(x.dtype), x[:, None]], dim=1)
    win = full if runs is None else take_runs(full, 2, runs)
    y = torch.einsum("bkc,kc->bc", win, w) + b
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


def _mamba2_share(cfg: ModelConfig, p: Params, tp, rows: bool):
    """The rank's share of a Mamba2 block: its heads (B and C, one group,
    are read by every head), the in_proj columns of its z, x and dt, the
    conv channels of its x and of B and C."""
    d_in, nh, ns = mamba2_dims(cfg)
    sh = Share(cfg, tp, p, "mamba", nh, cfg.ssm_head_dim, rows=rows)
    c0, c1 = sh.cols()
    h0, h1 = sh.heads()
    dt0 = 2 * d_in + 2 * ns
    z, x, bc, dt = ((c0, c1), (d_in + c0, d_in + c1),
                    (2 * d_in, dt0), (dt0 + h0, dt0 + h1))
    return sh, (z, x, bc, dt), [(c0, c1), (d_in, d_in + 2 * ns)]


def _mamba2_core(cfg: ModelConfig, sh: Share, xbc: torch.Tensor,
                 dt: torch.Tensor):
    """Common post-conv math: split the rank's conv output and build its
    heads' SSD operands."""
    ns = cfg.ssm_state
    xs, bmat, cmat = torch.split(xbc, [sh.vl, ns, ns], dim=-1)
    heads = [sh.heads()]
    dt = F.softplus(dt.float() + sh.w("dt_bias", 0, heads))    # (..., nh)
    a = -torch.exp(sh.w("a_log", 0, heads))                    # (nh,)
    return xs, bmat, cmat, dt, dt * a


def _mamba2_out(cfg: ModelConfig, sh: Share, y: torch.Tensor,
                xh: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The skip, the gated RMS norm over the whole d_in and the rank's
    rows of out_proj: the rank's partial of the block's output."""
    dt_ = xh.dtype
    y = y + sh.w("d_skip", 0, [sh.heads()]).to(dt_)[:, None] * xh
    y = _gated_rmsnorm(y.flatten(-2), z, sh.w("norm_scale", 0, [sh.cols()]),
                       sh)
    return y @ sh.w("out_proj", 0, [sh.cols()]).to(dt_)


def mamba2_train(cfg: ModelConfig, p: Params, x: torch.Tensor, tp=None
                 ) -> torch.Tensor:
    """x: (B, T, D) → (B, T, D). ``tp``: a model rank's ``LayerPlan``; the
    output is then the rank's partial sum."""
    b, t, _ = x.shape
    ns = cfg.ssm_state
    hd = cfg.ssm_head_dim
    dt_ = x.dtype
    sh, (z, xr, bc, dt), conv = _mamba2_share(cfg, p, tp, rows=False)
    z, xbc, dt = torch.split(sh.proj(x, "in_proj", [z, xr, bc, dt]),
                             [sh.vl, sh.vl + 2 * ns, sh.hl], dim=-1)
    xbc = F.silu(conv1d_train(xbc, sh.w("conv_w", 1, conv).to(dt_),
                              sh.w("conv_b", 0, conv).to(dt_)))
    xs, bmat, cmat, dtf, log_a = _mamba2_core(cfg, sh, xbc, dt)
    nh = sh.hl
    xh = xs.reshape(b, t, nh, hd)
    v = xh * dtf[..., None].to(dt_)                           # fold Δ into v
    k = bmat[:, :, None, :].expand(b, t, nh, ns)
    q = cmat[:, :, None, :].expand(b, t, nh, ns)
    y, _ = chunked_scan(q, k, v, log_a, None,
                        init_state(b, nh, ns, hd, device=x.device),
                        cfg.chunk_size, stabilize=False)
    return _mamba2_out(cfg, sh, y, xh, z)


def mamba2_step(cfg: ModelConfig, p: Params, x: torch.Tensor,
                cache: Mamba2Cache, tp=None
                ) -> Tuple[torch.Tensor, Mamba2Cache]:
    """x: (B, 1, D) single-token decode. ``tp``: a model rank's; the cache
    is then replicated over ``model``: the rank steps its heads' state and
    restores the whole."""
    b = x.shape[0]
    d_in, _, ns = mamba2_dims(cfg)
    hd = cfg.ssm_head_dim
    dt_ = x.dtype
    sh, (z, _, _, dt), conv = _mamba2_share(cfg, p, tp, rows=True)
    # every conv channel's input: the state keeps them all
    z, xbc, dt = torch.split(
        sh.proj(x[:, 0], "in_proj", [z, (d_in, 2 * d_in + 2 * ns), dt]),
        [sh.vl, d_in + 2 * ns, sh.hl], dim=-1)
    xbc, conv = conv1d_step(xbc, cache.conv, sh.w("conv_w", 1, conv).to(dt_),
                            sh.w("conv_b", 0, conv).to(dt_), conv)
    xbc = F.silu(xbc)
    xs, bmat, cmat, dtf, log_a = _mamba2_core(cfg, sh, xbc, dt)
    nh = sh.hl
    xh = xs.reshape(b, nh, hd)
    v = xh * dtf[..., None].to(dt_)
    k = bmat[:, None, :].expand(b, nh, ns)
    q = cmat[:, None, :].expand(b, nh, ns)
    state = RecurrentState(*(take_runs(s, 1, [sh.heads()])
                             for s in cache.ssm))
    y, ssm = recurrence_step(q, k, v, log_a, None, state, stabilize=False)
    ssm = RecurrentState(*(sh.restore(s, 1) for s in ssm))
    return _mamba2_out(cfg, sh, y[:, None], xh[:, None], z[:, None]), \
        Mamba2Cache(conv, ssm)


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   sh: Optional[Share] = None,
                   eps: float = 1e-6) -> torch.Tensor:
    """RMS over the whole d_in: a rank's channels' mean averaged over the
    model ranks (``sh``)."""
    g = y * F.silu(z)
    gf = g.float()
    ms = (gf ** 2).mean(-1, keepdim=True)
    if sh is not None and sh.split:
        ms = sh.psum(ms) / sh.ranks
    out = gf * torch.rsqrt(ms + eps)
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


def _mlstm_share(cfg: ModelConfig, p: Params, tp, rows: bool) -> Share:
    """The rank's share of an mLSTM block: q and k of its heads, which
    read the whole conv output; v, the skip, zg and w_down's rows on its
    value channels (its block of d_in); the gates whole."""
    _, h, hd = mlstm_dims(cfg)
    return Share(cfg, tp, p, "cell", h, hd, group="values", rows=rows)


def _mlstm_up(cfg: ModelConfig, sh: Share, x: torch.Tensor):
    """xi whole (the conv and q, k read every channel) and the rank's zg."""
    d_in = mlstm_dims(cfg)[0]
    v0, v1 = sh.vcols
    return torch.split(sh.proj(x, "w_up", [(0, d_in), (d_in + v0,
                                                       d_in + v1)]),
                       [d_in, sh.vl], dim=-1)


def _mlstm_qkvg(cfg: ModelConfig, sh: Share, xi: torch.Tensor,
                xc: torch.Tensor):
    """xi: pre-conv branch, xc: post-conv, both whole. Returns the rank's
    q, k, v, log_f, log_i."""
    d_in, _, hd = mlstm_dims(cfg)
    shp = xi.shape[:-1]
    hl = sh.hl
    scale = rounded(hd ** -0.5, xc.dtype)
    q = sh.proj(xc, "wq", [sh.cols()]).reshape(shp + (hl, hd)) * scale
    k = sh.proj(xc, "wk", [sh.cols()]).reshape(shp + (hl, hd)) * scale
    v = take_runs(xi, xi.ndim - 1, [sh.vcols]).reshape(shp + (hl, -1))
    gates = xi @ sh.w("w_gates", 0, [(0, d_in)]).to(xi.dtype) \
        + sh.p["b_gates"].to(xi.dtype)
    log_i, f_raw = (take_runs(g, g.ndim - 1, [sh.heads()])
                    for g in torch.chunk(gates.float(), 2, dim=-1))
    return q, k, v, F.logsigmoid(f_raw), log_i


def _mlstm_out(sh: Share, y: torch.Tensor, xc: torch.Tensor,
               zg: torch.Tensor) -> torch.Tensor:
    """The head-wise norm, the skip, the output gate and the rank's rows of
    w_down: the rank's partial of the block's output."""
    dt_ = xc.dtype
    vc = [sh.vcols]
    y = _headwise_rmsnorm(y, sh.w("norm_scale", 0, vc), sh)
    y = y + sh.w("skip", 0, vc).to(dt_) * take_runs(xc, xc.ndim - 1, vc)
    y = y * F.silu(zg)
    return y @ sh.w("w_down", 0, vc).to(dt_)


def mlstm_train(cfg: ModelConfig, p: Params, x: torch.Tensor, tp=None
                ) -> torch.Tensor:
    """``tp``: a model rank's ``LayerPlan``; the output is then the rank's
    partial sum."""
    b = x.shape[0]
    d_in, _, hd = mlstm_dims(cfg)
    dt_ = x.dtype
    sh = _mlstm_share(cfg, p, tp, rows=False)
    xi, zg = _mlstm_up(cfg, sh, x)
    whole = [(0, d_in)]
    xc = F.silu(conv1d_train(xi, sh.w("conv_w", 1, whole).to(dt_),
                             sh.w("conv_b", 0, whole).to(dt_)))
    q, k, v, log_f, log_i = _mlstm_qkvg(cfg, sh, xi, xc)
    y, _ = chunked_scan(q, k, v, log_f, log_i,
                        init_state(b, sh.hl, hd, v.shape[-1],
                                   device=x.device),
                        cfg.chunk_size, stabilize=True)
    return _mlstm_out(sh, y, xc, zg)


def mlstm_step(cfg: ModelConfig, p: Params, x: torch.Tensor,
               cache: MLSTMCache, tp=None
               ) -> Tuple[torch.Tensor, MLSTMCache]:
    """``tp``: a model rank's; the rank steps its heads' (value columns')
    cell and restores the whole replicated cell."""
    d_in = mlstm_dims(cfg)[0]
    dt_ = x.dtype
    sh = _mlstm_share(cfg, p, tp, rows=True)
    xi, zg = _mlstm_up(cfg, sh, x[:, 0])
    whole = [(0, d_in)]
    xc, conv = conv1d_step(xi, cache.conv, sh.w("conv_w", 1, whole).to(dt_),
                           sh.w("conv_b", 0, whole).to(dt_))
    xc = F.silu(xc)
    q, k, v, log_f, log_i = _mlstm_qkvg(cfg, sh, xi, xc)
    heads = [sh.heads()]
    vl = v.shape[-1]
    c, n, m = (take_runs(s, 1, heads) for s in cache.cell)
    c = take_runs(c, 3, [(sh.j * vl, (sh.j + 1) * vl)])
    y, cell = recurrence_step(q, k, v, log_f, log_i, RecurrentState(c, n, m),
                              stabilize=True)
    cell = RecurrentState(sh.restore(cell.c, 1, vdim=3),
                          sh.restore(sh.block(cell.n, 2), 1, vdim=2),
                          sh.restore(cell.m, 1))
    return _mlstm_out(sh, y[:, None], xc[:, None], zg[:, None]), \
        MLSTMCache(conv, cell)


def _headwise_rmsnorm(y: torch.Tensor, scale: torch.Tensor,
                      sh: Optional[Share] = None,
                      eps: float = 1e-6) -> torch.Tensor:
    """y: (..., H, hd) — RMS per head, then flatten and scale. Under a
    value-split group (``sh``) a head's mean is its ranks' means'."""
    yf = y.float()
    ms = (yf ** 2).mean(-1, keepdim=True)
    if sh is not None:
        ms = sh.group_mean(ms)
    yn = yf * torch.rsqrt(ms + eps)
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


def slstm_ffn(cfg: ModelConfig) -> int:
    """The sLSTM's FFN width."""
    return int(cfg.d_model * 4 / 3)


def slstm_init(cfg: ModelConfig, *, generator, device) -> Params:
    d = cfg.d_model
    h = cfg.num_heads
    hd = d // h
    f_up = slstm_ffn(cfg)
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


def _slstm_share(cfg: ModelConfig, p: Params, tp, rows: bool):
    """The rank's share of an sLSTM block: its heads' recurrence (with
    fewer heads than ranks, a group's ranks repeat their head's), on its
    heads' channels of the conv and of each gate's w_in columns; then the
    FFN's columns, on hs gathered whole."""
    d, h = cfg.d_model, cfg.num_heads
    sh = Share(cfg, tp, p, "cell", h, d // h, group="repeat", rows=rows)
    ch = sh.cols()
    return sh, ch, [(g * d + ch[0], g * d + ch[1]) for g in range(4)]


def _slstm_in(sh: Share, x: torch.Tensor, gates: Runs) -> torch.Tensor:
    """The rank's heads' pre-activations [z | i | f | o] of x."""
    return sh.proj(x, "w_in", gates) + sh.w("b", 0, gates).to(x.dtype)


def _slstm_r(sh: Share) -> torch.Tensor:
    """The rank's heads' recurrent weights (4, hl, hd, hd), fp32."""
    return sh.w("r", 1, [sh.heads()]).float()


def _slstm_out(cfg: ModelConfig, sh: Share, hs: torch.Tensor,
               dt_) -> torch.Tensor:
    """hs (B, T, D) in ``dt_`` → the rank's partial of the block's output:
    headwise norm, the rank's columns of the gelu (tanh) up projection, the
    down projection's rows."""
    b, t, d = hs.shape
    y = _headwise_rmsnorm(hs.reshape(b, t, cfg.num_heads, -1),
                          sh.w("norm_scale", 0, [(0, d)]))
    cols = [sh.part(slstm_ffn(cfg))]
    y = F.gelu(y @ sh.w("w_up", 1, cols).to(dt_), approximate="tanh")
    return y @ sh.w("w_down", 0, cols).to(dt_)


def slstm_train(cfg: ModelConfig, p: Params, x: torch.Tensor, tp=None
                ) -> torch.Tensor:
    """``tp``: a model rank's ``LayerPlan``; the output is then the rank's
    partial sum."""
    dt_ = x.dtype
    sh, ch, gates = _slstm_share(cfg, p, tp, rows=False)
    xc = F.silu(conv1d_train(take_runs(x, 2, [ch]),
                             sh.w("conv_w", 1, [ch]).to(dt_),
                             sh.w("conv_b", 0, [ch]).to(dt_)))
    wxb = _slstm_in(sh, x, gates)
    hs = slstm_seq(sh.hl, _slstm_r(sh), wxb.float(), xc.float())
    return _slstm_out(cfg, sh, sh.gather(hs.to(dt_), 2), dt_)


def slstm_step(cfg: ModelConfig, p: Params, x: torch.Tensor,
               cache: SLSTMCache, tp=None
               ) -> Tuple[torch.Tensor, SLSTMCache]:
    """``tp``: a model rank's; the rank steps its heads' state and restores
    the whole replicated state."""
    dt_ = x.dtype
    sh, ch, gates = _slstm_share(cfg, p, tp, rows=True)
    xt = x[:, 0]
    xc, conv = conv1d_step(xt, cache.conv, sh.w("conv_w", 1, [ch]).to(dt_),
                           sh.w("conv_b", 0, [ch]).to(dt_), [ch])
    xc = F.silu(xc)
    wxb = _slstm_in(sh, xt, gates)
    c, n, m, h = (take_runs(s, 1, [ch])
                  for s in (cache.c, cache.n, cache.m, cache.h))
    (c, n, m, hid), _ = _slstm_gates(_slstm_r(sh), wxb.float(), xc.float(),
                                     h, (c, n, m), sh.hl)
    c, n, m, hid = (sh.restore(sh.block(s, 1), 1, vdim=1)
                    for s in (c, n, m, hid))
    y = _slstm_out(cfg, sh, hid.to(dt_)[:, None], dt_)
    return y, SLSTMCache(conv, c, n, hid, m)
