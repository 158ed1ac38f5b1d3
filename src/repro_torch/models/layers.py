"""Shared building blocks: norms, MLPs, embeddings, rotary/sinusoidal
positions (``repro.models.layers``).

Parameters are plain dicts of tensors, as in ``repro``. Every function
computes what its ``repro`` counterpart computes, in the same dtypes: the
norms in fp32, cast back to the input's dtype; weights cast to the
activations' dtype at each use (a no-op on a copy already in that dtype,
`repro_torch.models.transformer.cast_params`).
"""
from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig

Params = dict


def truncated_normal(shape, std: float, *, generator: torch.Generator,
                     device, dtype=torch.float32) -> torch.Tensor:
    """N(0, std²) cut at ±2σ, ``repro``'s ``truncated_normal``: the same
    distribution, drawn from a ``torch.Generator`` (not ``jax.random``'s
    draws). On ``meta`` (no generator there) the shape alone."""
    t = torch.empty(shape, dtype=dtype, device=device)
    if t.is_meta:
        return t
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=generator)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    """``cfg.dtype`` ("bfloat16", "float32") as a torch dtype."""
    return getattr(torch, cfg.dtype)


def checkpointed(fn):
    """``fn`` under ``torch.utils.checkpoint``: its activations are dropped
    after the forward and recomputed in the backward, as under ``repro``'s
    ``jax.checkpoint``. Nothing in the models draws random numbers, so no
    RNG state is kept."""
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False)


def rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: the constant JAX multiplies by when
    an array of that dtype meets a Python float (a weakly typed scalar takes
    the array's dtype). Multiplying a bf16 tensor by it rounds once, as
    ``repro`` does."""
    return float(torch.tensor(value, dtype=dtype))


Runs = Sequence[Tuple[int, int]]


def merge_runs(runs: Runs) -> List[Tuple[int, int]]:
    """``runs`` ((start, stop) pairs in order) with touching runs joined."""
    out: List[Tuple[int, int]] = []
    for a, b in runs:
        if out and out[-1][1] == a:
            out[-1] = (out[-1][0], b)
        else:
            out.append((int(a), int(b)))
    return out


def take_runs(t: torch.Tensor, dim: int, runs: Runs) -> torch.Tensor:
    """The entries ``runs`` of ``t`` along ``dim``, in order: ``t`` itself
    where they cover it, a view where they are one run, else one copy."""
    runs = merge_runs(runs)
    dim = dim % t.ndim
    if runs == [(0, t.shape[dim])]:
        return t
    parts = [t.narrow(dim, a, b - a) for a, b in runs]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(cfg: ModelConfig, d: int, device) -> Params:
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((d,), device=device),
                "bias": torch.zeros((d,), device=device)}
    return {"scale": torch.zeros((d,), device=device)
            if cfg.norm == "rmsnorm_gemma"
            else torch.ones((d,), device=device)}


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"] + p["bias"]
    else:
        y = xf * torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + eps)
        w = (1.0 + p["scale"]) if cfg.norm == "rmsnorm_gemma" \
            else p["scale"]
        y = y * w
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def _act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh") if cfg.act == "gelu" else F.silu(x)


def mlp_init(cfg: ModelConfig, d: int, f: int, *, generator, device,
             gated: bool = True) -> Params:
    draw = dict(generator=generator, device=device)
    p = {"w_up": truncated_normal((d, f), d ** -0.5, **draw),
         "w_down": truncated_normal((f, d), f ** -0.5, **draw)}
    if gated:
        p["w_gate"] = truncated_normal((d, f), d ** -0.5, **draw)
    return p


def apply_mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = x @ p["w_up"].to(dt)
    if "w_gate" in p:
        h = _act(cfg, x @ p["w_gate"].to(dt)) * h
    else:
        h = _act(cfg, h)
    return h @ p["w_down"].to(dt)


# ---------------------------------------------------------------------------
# positions
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., T, H, hd); positions: (T,) or (B, T).
    cos and sin are cast to x's dtype before the rotation, as in
    ``repro``."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq     # (..., T, half)
    if ang.ndim == 2:                                        # (T, half)
        ang = ang[None, :, None, :]                          # (1, T, 1, half)
    else:                                                    # (B, T, half)
        ang = ang[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    c, s = torch.cos(ang).to(x.dtype), torch.sin(ang).to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(T,) → (T, d) fixed sinusoidal table (musicgen), fp32."""
    half = d // 2
    freq = torch.exp(-math.log(10_000.0)
                     * torch.arange(half, device=positions.device) / half)
    ang = positions[:, None].to(torch.float32) * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)
