"""Port parity, the recurrent blocks (``repro.models.recurrent``): the
chunked scan and the one-step recurrence (stabilised and not, from a
carried state), the causal conv and its decode state, the Mamba2, mLSTM
and sLSTM blocks' full-sequence and decode paths, the port's chunked scan
against its own step loop, zamba2's shared attention block at
``reduced(num_layers=6)`` (its layer 5 is ``MAMBA2_SHARED``; two layers
hold none), and in bf16 the gap between decode and prefill, which is
``repro``'s own.

Inputs come from numpy seeds and ``repro``'s params; fp32 on the CPU. The
scan, the step and the conv are held at 1e-5 (``UNIT_TOL``), the blocks
at ``repro``'s attention bar 1e-4 (``ATTN_TOL``,
``tests/test_model_units.py``) and the 6-layer model at its logit bar
2e-4; the bf16 gap within a quarter of ``repro``'s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import recurrent as JR
from repro.models import transformer as JT
from repro_torch import configs as t_configs
from repro_torch.configs import base as t_base
from repro_torch.convert import lm_params_from_repro
from repro_torch.models import recurrent as TR
from repro_torch.models import transformer as TT

UNIT_TOL, ATTN_TOL, LOGIT_TOL = 1e-5, 1e-4, 2e-4
CPU = torch.device("cpu")
B, T, H, N, P = 2, 24, 3, 8, 6


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return _t(tree)


def _scan_inputs(rng, stabilize, carried, t=T):
    q = rng.normal(0, 0.5, (B, t, H, N)).astype(np.float32)
    k = rng.normal(0, 0.5, (B, t, H, N)).astype(np.float32)
    v = rng.normal(0, 1, (B, t, H, P)).astype(np.float32)
    log_a = -rng.uniform(0.01, 0.5, (B, t, H)).astype(np.float32)
    log_i = (rng.normal(0, 1, (B, t, H)).astype(np.float32)
             if stabilize else None)
    if carried:
        state = (rng.normal(0, 1, (B, H, N, P)).astype(np.float32),
                 (rng.uniform(0, 1, (B, H, N)) if stabilize
                  else np.zeros((B, H, N))).astype(np.float32),
                 (rng.normal(0, 1, (B, H)) if stabilize
                  else np.zeros((B, H))).astype(np.float32))
    else:
        state = tuple(np.asarray(x) for x in JR.init_state(B, H, N, P))
    return q, k, v, log_a, log_i, state


def _both(args):
    j = tuple(None if a is None else (tuple(jnp.asarray(x) for x in a)
                                      if isinstance(a, tuple)
                                      else jnp.asarray(a)) for a in args)
    t = tuple(None if a is None else (tuple(_t(x) for x in a)
                                      if isinstance(a, tuple) else _t(a))
              for a in args)
    return j, t


@pytest.mark.parametrize("stabilize", [False, True])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("chunk", [8, 24])
def test_chunked_scan_matches_repro(stabilize, carried, chunk, rng):
    q, k, v, la, li, st = _scan_inputs(rng, stabilize, carried)
    (jq, jk, jv, jla, jli, jst), (tq, tk, tv, tla, tli, tst) = \
        _both((q, k, v, la, li, st))
    want_y, want_s = JR.chunked_scan(jq, jk, jv, jla, jli,
                                     JR.RecurrentState(*jst), chunk,
                                     stabilize)
    got_y, got_s = TR.chunked_scan(tq, tk, tv, tla, tli,
                                   TR.RecurrentState(*tst), chunk, stabilize)
    _close(got_y, want_y, UNIT_TOL)
    assert isinstance(got_s, TR.RecurrentState)
    for g, w in zip(got_s, want_s):
        _close(g, w, UNIT_TOL)


def test_chunked_scan_raises_off_the_chunk_grid(rng):
    q, k, v, la, li, st = _scan_inputs(rng, True, False, t=20)
    _, (tq, tk, tv, tla, tli, tst) = _both((q, k, v, la, li, st))
    with pytest.raises(ValueError, match="no multiple of the chunk 8"):
        TR.chunked_scan(tq, tk, tv, tla, tli, TR.RecurrentState(*tst), 8,
                        True)


@pytest.mark.parametrize("stabilize", [False, True])
def test_recurrence_step_matches_repro(stabilize, rng):
    q, k, v, la, li, st = _scan_inputs(rng, stabilize, True, t=1)
    args = (q[:, 0], k[:, 0], v[:, 0], la[:, 0],
            None if li is None else li[:, 0], st)
    (jq, jk, jv, jla, jli, jst), (tq, tk, tv, tla, tli, tst) = _both(args)
    want_y, want_s = JR.recurrence_step(jq, jk, jv, jla, jli,
                                        JR.RecurrentState(*jst), stabilize)
    got_y, got_s = TR.recurrence_step(tq, tk, tv, tla, tli,
                                      TR.RecurrentState(*tst), stabilize)
    _close(got_y, want_y, UNIT_TOL)
    for g, w in zip(got_s, want_s):
        _close(g, w, UNIT_TOL)


@pytest.mark.parametrize("stabilize", [False, True])
def test_chunked_scan_equals_its_step_loop(stabilize, rng):
    """The port's chunk-parallel scan against its own O(1) recurrence run
    token by token from the same carried state."""
    q, k, v, la, li, st = _scan_inputs(rng, stabilize, True)
    _, (tq, tk, tv, tla, tli, tst) = _both((q, k, v, la, li, st))
    got_y, got_s = TR.chunked_scan(tq, tk, tv, tla, tli,
                                   TR.RecurrentState(*tst), 8, stabilize)
    state, ys = TR.RecurrentState(*tst), []
    for t in range(T):
        y, state = TR.recurrence_step(
            tq[:, t], tk[:, t], tv[:, t], tla[:, t],
            None if tli is None else tli[:, t], state, stabilize)
        ys.append(y)
    _close(got_y, torch.stack(ys, 1), UNIT_TOL)
    # the stabiliser m is a scale, not a value: compare c and n unscaled
    if stabilize:
        for g, w in ((got_s.c, state.c), (got_s.n, state.n)):
            shape = (B, H) + (1,) * (g.ndim - 2)
            _close(g * torch.exp(got_s.m).reshape(shape),
                   w * torch.exp(state.m).reshape(shape), 1e-4)
    else:
        for g, w in zip(got_s, state):
            _close(g, w, UNIT_TOL)


def test_conv1d_train_and_step_match_repro(rng):
    x = rng.normal(0, 1, (B, 9, 5)).astype(np.float32)
    w = rng.normal(0, 1, (4, 5)).astype(np.float32)
    b = rng.normal(0, 1, (5,)).astype(np.float32)
    _close(TR.conv1d_train(_t(x), _t(w), _t(b)),
           JR.conv1d_train(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)),
           UNIT_TOL)
    state = rng.normal(0, 1, (B, 3, 5)).astype(np.float32)
    want_y, want_s = JR.conv1d_step(jnp.asarray(x[:, 0]), jnp.asarray(state),
                                    jnp.asarray(w), jnp.asarray(b))
    got_y, got_s = TR.conv1d_step(_t(x[:, 0]), _t(state), _t(w), _t(b))
    _close(got_y, want_y, UNIT_TOL)
    _close(got_s, want_s, UNIT_TOL)
    # computes in the activations' dtype, keeps the state in its own
    y16, s32 = TR.conv1d_step(_t(x[:, 0]).bfloat16(), _t(state),
                              _t(w).bfloat16(), _t(b).bfloat16())
    assert y16.dtype == torch.bfloat16 and s32.dtype == torch.float32


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

BLOCKS = {  # kind → (arch, init, train, step, init_cache)
    "mamba2": ("zamba2-1.2b", "mamba2_init", "mamba2_train", "mamba2_step",
               "mamba2_init_cache"),
    "mlstm": ("xlstm-1.3b", "mlstm_init", "mlstm_train", "mlstm_step",
              "mlstm_init_cache"),
    "slstm": ("xlstm-1.3b", "slstm_init", "slstm_train", "slstm_step",
              "slstm_init_cache"),
}


def _block(kind, seed=0):
    arch, init, train, step, cache = BLOCKS[kind]
    cj = j_configs.ARCHS[arch].reduced(seq_len_hint=32)
    ct = t_configs.ARCHS[arch].reduced(seq_len_hint=32)
    p = jax.tree.map(np.asarray, getattr(JR, init)(cj, jax.random.key(seed)))
    return cj, ct, p


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_train_matches_repro(kind, rng):
    cj, ct, p = _block(kind)
    x = rng.normal(0, 1, (B, 32, ct.d_model)).astype(np.float32)
    want = getattr(JR, BLOCKS[kind][2])(cj, p, jnp.asarray(x))
    got = getattr(TR, BLOCKS[kind][2])(ct, _torch_tree(p), _t(x))
    assert got.shape == want.shape
    _close(got, want, ATTN_TOL)


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_step_matches_repro_and_its_train(kind, rng):
    """Eight decode steps from the block's fresh cache: each against
    ``repro``'s step, and together against the full-sequence path; the
    cache comes back a new named tuple of the same type."""
    arch, _, train, step, init_cache = BLOCKS[kind]
    cj, ct, p = _block(kind, seed=1)
    pt = _torch_tree(p)
    x = rng.normal(0, 1, (B, 8, ct.d_model)).astype(np.float32)
    cache_j = getattr(JR, init_cache)(cj, B)
    cache_t = getattr(TR, init_cache)(ct, B, CPU)
    kind_t = type(cache_t)
    ys = []
    for t in range(8):
        yj, cache_j = getattr(JR, step)(cj, p, jnp.asarray(x[:, t:t + 1]),
                                        cache_j)
        yt, cache_t = getattr(TR, step)(ct, pt, _t(x[:, t:t + 1]), cache_t)
        assert type(cache_t) is kind_t and yt.shape == (B, 1, ct.d_model)
        _close(yt, yj, ATTN_TOL)
        for g, w in zip(jax.tree.leaves(cache_t), jax.tree.leaves(cache_j)):
            assert g.dtype == torch.float32
            _close(g, w, ATTN_TOL)
        ys.append(yt)
    if kind == "mamba2":      # the chunked scan needs T on its chunk grid
        ct = dataclasses.replace(ct, chunk_size=8)
    full = getattr(TR, train)(ct, pt, _t(x))
    _close(torch.cat(ys, 1), full, ATTN_TOL)


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_init_shapes_match_repro(kind):
    cj, ct, p = _block(kind)
    got = getattr(TR, BLOCKS[kind][1])(
        ct, generator=torch.Generator().manual_seed(0), device=CPU)
    assert jax.tree.map(lambda t: tuple(t.shape), got) == \
        jax.tree.map(lambda a: a.shape, p)
    fixed = {"conv_b", "a_log", "d_skip", "norm_scale", "b_gates", "skip",
             "b"}
    for name in fixed & set(p):        # repro's deterministic leaves
        _close(got[name], p[name], UNIT_TOL)


def test_mamba2_dt_bias_draws_repro_distribution():
    """dt = softplus(dt_bias) lies in [0.001, 0.1], log-uniform, as
    ``repro`` draws it."""
    _, ct, _ = _block("mamba2")
    ct = dataclasses.replace(ct, d_model=4096)
    p = TR.mamba2_init(ct, generator=torch.Generator().manual_seed(0),
                       device=CPU)
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert float(dt.min()) >= 0.001 * (1 - 1e-4)
    assert float(dt.max()) <= 0.1 * (1 + 1e-4)
    assert abs(float(torch.log(dt).mean()) - np.log(0.01)) < 0.3


# ---------------------------------------------------------------------------
# zamba2's shared attention block
# ---------------------------------------------------------------------------

def _zamba(layers=6):
    cj = j_configs.ARCHS["zamba2-1.2b"].reduced(num_layers=layers,
                                                seq_len_hint=16)
    ct = t_configs.ARCHS["zamba2-1.2b"].reduced(num_layers=layers,
                                                seq_len_hint=16)
    jp = JT.init_params(cj, jax.random.key(0))
    return cj, ct, jp, lm_params_from_repro(jax.tree.map(np.asarray, jp),
                                            ct, device=CPU)


def test_zamba2_six_layers_hold_the_shared_block(rng):
    """Layer 5 is ``MAMBA2_SHARED``: the forward against ``repro``'s, both
    prefill routes of the shared attention (K9's CPU twin and the plain
    scan) the same function, and the shared block's weights change the
    output (two layers hold no shared block at all)."""
    assert t_base.MAMBA2_SHARED not in t_configs.ARCHS[
        "zamba2-1.2b"].reduced().pattern
    cj, ct, jp, tp = _zamba()
    assert ct.pattern[5] == t_base.MAMBA2_SHARED
    assert ct.pattern.count(t_base.MAMBA2_SHARED) == 1
    tokens = rng.integers(0, ct.vocab_size, (B, 16))
    want, _ = JT.forward(cj, jp, {"tokens": jnp.asarray(tokens)})
    got, _ = TT.forward(ct, tp, {"tokens": _t(tokens)})
    _close(got, want, LOGIT_TOL)
    flash, _ = TT.forward(ct, tp, {"tokens": _t(tokens)}, attention="flash")
    _close(flash, got, LOGIT_TOL)
    tp2 = dict(tp, shared_attn=dict(tp["shared_attn"],
                                    in_proj=tp["shared_attn"]["in_proj"] * 2))
    other, _ = TT.forward(ct, tp2, {"tokens": _t(tokens)})
    assert float((other - got).abs().max()) > 1e-3


def test_zamba2_shared_block_decode_caches(rng):
    """The shared layer's cache is the pair (``Mamba2Cache``, the shared
    block's full ``KVCache``); 16 decode steps against ``repro``'s."""
    cj, ct, jp, tp = _zamba()
    caches = TT.init_caches(ct, B, 16, dtype=torch.float32, device=CPU)
    mcache, kv = caches[5]
    assert isinstance(mcache, TR.Mamba2Cache)
    assert kv.k.shape[1] == 16 and kv.k.dtype == torch.float32
    assert all(isinstance(c, TR.Mamba2Cache) for c in caches[:5])
    caches_j = JT.init_caches(cj, B, 16, dtype=jnp.float32)
    dec = jax.jit(lambda p, c, t, q: JT.decode_step(cj, p, c, t, q))
    tokens = rng.integers(0, ct.vocab_size, (B, 16))
    for t in range(16):
        pos = np.full((B,), t, np.int32)
        lj, caches_j = dec(jp, caches_j, jnp.asarray(tokens[:, t]),
                           jnp.asarray(pos))
        lt, caches = TT.decode_step(ct, tp, caches, _t(tokens[:, t]),
                                    _t(pos))
        _close(lt, lj, LOGIT_TOL)
    assert sorted(caches[5][1].slot_pos[0].tolist()) == list(range(16))


@pytest.mark.parametrize("arch,layers", [("xlstm-1.3b", 4),
                                         ("zamba2-1.2b", 6)])
def test_bf16_decode_strays_from_prefill_as_repros_does(arch, layers, rng):
    """In bf16 a recurrent model's decode strays from its prefill: the
    chunked scan rounds its intra-chunk products to bf16 where the
    one-step recurrence keeps an fp32 state. ``repro`` strays as far, so
    the card's bf16 bars for these models (``chip_smoke.py``
    ``LM_BF16_REL_L2``) measure ``repro``'s function, not a fault of the
    port: the port's gap within a quarter of ``repro``'s on the same
    weights and tokens."""
    kw = dict(num_layers=layers, seq_len_hint=64)
    cj = dataclasses.replace(j_configs.ARCHS[arch].reduced(**kw),
                             dtype="bfloat16")
    ct = dataclasses.replace(t_configs.ARCHS[arch].reduced(**kw),
                             dtype="bfloat16")
    jp = JT.init_params(cj, jax.random.key(0))
    tp = TT.cast_params(ct, lm_params_from_repro(
        jax.tree.map(np.asarray, jp), ct, device=CPU))
    n = 16
    tokens = rng.integers(0, ct.vocab_size, (4, n))
    full_j, _ = JT.forward(cj, jp, {"tokens": jnp.asarray(tokens)})
    caches_j = JT.init_caches(cj, 4, n, dtype=jnp.float32)
    dec = jax.jit(lambda p, c, t, q: JT.decode_step(cj, p, c, t, q))
    full_t, _ = TT.forward(ct, tp, {"tokens": _t(tokens)})
    caches_t = TT.init_caches(ct, 4, n, dtype=torch.float32, device=CPU)
    for t in range(n):
        pos = np.full((4,), t, np.int32)
        lj, caches_j = dec(jp, caches_j, jnp.asarray(tokens[:, t]),
                           jnp.asarray(pos))
        lt, caches_t = TT.decode_step(ct, tp, caches_t, _t(tokens[:, t]),
                                      _t(pos))

    def gap(dec_logits, full_logits):
        d = np.asarray(dec_logits, np.float32)
        f = np.asarray(full_logits, np.float32)[:, -1]
        return float(np.linalg.norm(d - f) / np.linalg.norm(f))

    want = gap(lj, full_j)
    got = gap(lt.float(), full_t.float())
    assert want > 1e-3                       # bf16 strays at all
    assert abs(got - want) <= 0.25 * want, (got, want)


# ---------------------------------------------------------------------------
# the sLSTM's custom VJP (training)
# ---------------------------------------------------------------------------

def _slstm_inputs(rng, clamp, heads=2, hd=4, b=2, t=12, dtype=np.float32):
    """r (4, H, hd, hd), wxb (B, T, 4D), xc (B, T, D). With ``clamp`` half
    the units get an input gate e^-14.5 of their forget gate, so their
    normaliser n starts under 1e-6 (the clamp in h = o·c/max(n, 1e-6) is
    active) while c/1e-6 is O(1)."""
    d = heads * hd
    r = rng.normal(0, 0.5, (4, heads, hd, hd)).astype(dtype)
    wxb = rng.normal(0, 1, (b, t, 4 * d)).astype(dtype)
    xc = rng.normal(0, 0.3, (b, t, d)).astype(dtype)
    if clamp:
        wxb[..., d: d + d // 2] = -14.5          # the input gate's units
        wxb[..., 2 * d: 2 * d + d // 2] = 5.0    # their forget gate near 1
    return r, wxb, xc


def _slstm_grads(fn, r, wxb, xc, cot):
    leaves = [_t(x).requires_grad_(True) for x in (r, wxb, xc)]
    hs = fn(*leaves)
    return [g.numpy() for g in torch.autograd.grad(hs, leaves, _t(cot))]


@pytest.mark.parametrize("clamp", [False, True])
def test_slstm_backward_matches_repro_custom_vjp(clamp):
    """``slstm_seq``'s backward against ``jax.vjp`` of ``repro``'s custom
    VJP on one cotangent, the clamp on n inactive and active."""
    heads = 2
    rng = np.random.default_rng(5)
    r, wxb, xc = _slstm_inputs(rng, clamp, heads=heads)
    _, steps = TR._slstm_loop(heads, _t(r), _t(wxb), _t(xc))
    assert (min(float(n.min()) for _, _, n, *_ in steps) < 1e-6) == clamp
    cot = rng.normal(0, 1, xc.shape).astype(np.float32)
    hs, vjp = jax.vjp(lambda *a: JR.slstm_seq(heads, *a), jnp.asarray(r),
                      jnp.asarray(wxb), jnp.asarray(xc))
    want = vjp(jnp.asarray(cot))
    got = _slstm_grads(lambda *a: TR.slstm_seq(heads, *a), r, wxb, xc, cot)
    for g, w in zip(got, want):
        w = np.asarray(w)
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= UNIT_TOL, err
    # the forward is the serving loop's, bit for bit
    with torch.no_grad():
        plain = TR.slstm_seq(heads, _t(r), _t(wxb), _t(xc))
    got_hs = TR.slstm_seq(heads, _t(r).requires_grad_(True), _t(wxb), _t(xc))
    assert torch.equal(got_hs.detach(), plain)
    _close(plain, hs, UNIT_TOL)


def test_slstm_rule_drops_the_stabilisers_cotangent_where_n_is_clamped():
    """Where the clamp on n is active, plain autograd through the loop
    carries a cotangent through the stabiliser m that ``repro``'s rule
    drops, so the two differ (by ~2e-3 relative here, a hundred times the
    agreement bar); where it is not, they agree (h = o·c/n does not depend
    on m)."""
    heads = 2
    rng = np.random.default_rng(6)
    for clamp, differ in ((False, False), (True, True)):
        r, wxb, xc = _slstm_inputs(rng, clamp, heads=heads)
        cot = rng.normal(0, 1, xc.shape).astype(np.float32)
        rule = _slstm_grads(lambda *a: TR.slstm_seq(heads, *a), r, wxb, xc,
                            cot)
        plain = _slstm_grads(lambda *a: TR._slstm_loop(heads, *a)[0], r,
                             wxb, xc, cot)
        err = max(np.linalg.norm(a - b) / np.linalg.norm(b)
                  for a, b in zip(rule, plain))
        assert (err > 100 * UNIT_TOL) if differ else (err <= UNIT_TOL), \
            (clamp, err)


def test_slstm_backward_gradcheck_float64():
    """``torch.autograd.gradcheck`` in float64 on a tiny case with the
    clamp inactive, where the rule is the exact derivative."""
    rng = np.random.default_rng(7)
    r, wxb, xc = _slstm_inputs(rng, False, heads=1, hd=2, b=1, t=4,
                               dtype=np.float64)
    leaves = [_t(x).requires_grad_(True) for x in (r, wxb, xc)]
    assert torch.autograd.gradcheck(lambda *a: TR.slstm_seq(1, *a), leaves)
