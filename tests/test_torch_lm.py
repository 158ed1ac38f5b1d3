"""Port parity, the LM template's serving path: the configs, the layers,
attention (both prefill routes and the decode ring buffer), the
transformer's forward (with the MoE layers' summed aux), prefill and
decode on all ten archs (zamba2 at 6 layers, so that its layer 5 holds
the shared attention block), ``generate``, the serving CLI, npz
checkpoints (parameters and every kind of cache) and the mesh refusals, held
against ``repro`` on the same numpy inputs: reduced configs in fp32 on the
CPU, at ``repro``'s own bars (``tests/test_model_units.py``: 1e-4 for
attention; ``tests/test_decode_consistency.py``: 2e-4 for logits). The
layer units (norms, MLPs, rope, softcap, sinusoidal) are held at 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.checkpoint import io as j_io
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.training import make_prefill_step as j_make_prefill_step
from repro.training import make_serve_step as j_make_serve_step
from repro_torch import configs as t_configs
from repro_torch.checkpoint import io as t_io
from repro_torch.configs import base as t_base
from repro_torch.convert import (lm_caches_from_repro, lm_caches_to_repro,
                                 lm_params_from_repro, lm_params_to_repro)
from repro_torch.launch import serve as t_serve
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.training import (make_prefill_step, make_serve_step,
                                  make_train_step)

COVERED = ["qwen2.5-3b", "yi-9b", "gemma2-27b", "command-r-35b",
           "internvl2-1b", "musicgen-medium", "deepseek-moe-16b",
           "qwen3-moe-30b-a3b", "zamba2-1.2b", "xlstm-1.3b"]
MOE_ARCHS = ["deepseek-moe-16b", "qwen3-moe-30b-a3b"]
RECURRENT_ARCHS = ["zamba2-1.2b", "xlstm-1.3b"]
# zamba2's reduced depth: layer 5 is its first MAMBA2_SHARED
LAYERS = {"zamba2-1.2b": 6}
B, S, STEPS = 2, 16, 16
UNIT_TOL, ATTN_TOL, LOGIT_TOL = 1e-5, 1e-4, 2e-4
CPU = torch.device("cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return _t(tree)


def _reduced(arch):
    kw = dict(seq_len_hint=S, num_layers=LAYERS.get(arch, 2))
    return j_configs.ARCHS[arch].reduced(**kw), \
        t_configs.ARCHS[arch].reduced(**kw)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(j_configs.ARCHS))
def test_configs_field_for_field(arch):
    jc, tc = j_configs.ARCHS[arch], t_configs.ARCHS[arch]
    assert type(tc).__name__ == "ModelConfig"
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.pattern == jc.pattern
    assert tc.resolved_head_dim == jc.resolved_head_dim
    for kw in ({}, {"seq_len_hint": 16}, {"num_layers": 3, "d_model": 128,
                                          "seq_len_hint": 64}):
        assert dataclasses.asdict(tc.reduced(**kw)) == \
            dataclasses.asdict(jc.reduced(**kw)), kw
    for name, shape in j_configs.INPUT_SHAPES.items():
        assert dataclasses.asdict(t_configs.get_shape(name)) == \
            dataclasses.asdict(shape)
        jv, jnote = j_configs.base.shape_variant(jc, shape)
        tv, tnote = t_base.shape_variant(tc, t_configs.get_shape(name))
        assert dataclasses.asdict(tv) == dataclasses.asdict(jv)
        assert tnote == jnote
        for kind in set(jv.pattern):
            assert t_base.effective_window(tv, kind) == \
                j_configs.base.effective_window(jv, kind)
    assert t_configs.get_config(arch) is tc
    with pytest.raises(KeyError):
        t_configs.get_config(arch + "-nope")


def test_config_registry_and_kinds():
    assert sorted(t_configs.ARCHS) == sorted(j_configs.ARCHS)
    assert list(t_configs.ARCHS) == list(j_configs.ARCHS)
    for kind in ("ATTN", "ATTN_LOCAL", "ATTN_PARALLEL", "MOE", "MAMBA2",
                 "MAMBA2_SHARED", "MLSTM", "SLSTM"):
        assert getattr(t_base, kind) == getattr(j_configs.base, kind)
    with pytest.raises(KeyError):
        t_configs.get_shape("nope")


# ---------------------------------------------------------------------------
# pattern segmentation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(j_configs.ARCHS))
def test_segment_pattern_matches_repro(arch):
    cfg = j_configs.ARCHS[arch]
    for pattern in (cfg.pattern, cfg.reduced().pattern,
                    cfg.reduced(num_layers=5).pattern, cfg.pattern[1:]):
        assert TT.segment_pattern(pattern) == JT.segment_pattern(pattern)
    assert TT.stage_layout(t_configs.ARCHS[arch]) == JT.stage_layout(cfg)


def test_segment_pattern_on_random_patterns():
    rng = np.random.default_rng(0)
    kinds = ("attn", "attn_local", "moe", "mamba2")
    for _ in range(200):
        pattern = tuple(rng.choice(kinds[:rng.integers(1, 5)],
                                   size=rng.integers(1, 30)))
        for max_cycle in (1, 3, 8):
            assert TT.segment_pattern(pattern, max_cycle) == \
                JT.segment_pattern(pattern, max_cycle)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _unit_cfg(**kw):
    base = dict(name="t", family="dense", num_layers=1, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=97,
                attn_chunk=8, dtype="float32")
    base.update(kw)
    return (j_configs.base.ModelConfig(**base),
            t_base.ModelConfig(**base))


@pytest.mark.parametrize("positions", ["T", "BT"])
def test_rope_matches_repro(positions, rng):
    x = rng.normal(0, 1, (3, 12, 4, 32)).astype(np.float32)
    pos = (np.arange(12) * 7 if positions == "T"
           else rng.integers(0, 40_000, (3, 12)))
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), 1_000_000.0)
    got = TL.rope(_t(x), _t(pos), 1_000_000.0)
    _close(got, want, UNIT_TOL)


def test_rope_casts_cos_and_sin_to_x_dtype(rng):
    x = _t(rng.normal(0, 1, (1, 8, 2, 16)).astype(np.float32))
    got = TL.rope(x.to(torch.bfloat16), torch.arange(8), 10_000.0)
    assert got.dtype == torch.bfloat16
    half = 8
    freq = 10_000.0 ** (-torch.arange(half, dtype=torch.float32) / half)
    ang = torch.arange(8, dtype=torch.float32)[None, :, None, None] * freq
    c, s = ang.cos().bfloat16(), ang.sin().bfloat16()
    xb = x.bfloat16()
    want = torch.cat([xb[..., :half] * c - xb[..., half:] * s,
                      xb[..., half:] * c + xb[..., :half] * s], dim=-1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("norm", ["rmsnorm", "rmsnorm_gemma", "layernorm"])
def test_norms_match_repro(norm, rng):
    jc, tc = _unit_cfg(norm=norm)
    x = rng.normal(1, 2, (2, 5, 64)).astype(np.float32)
    p = {"scale": rng.normal(0, 1, (64,)).astype(np.float32)}
    if norm == "layernorm":
        p["bias"] = rng.normal(0, 1, (64,)).astype(np.float32)
    want = JL.apply_norm(jc, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = TL.apply_norm(tc, _torch_tree(p), _t(x))
    _close(got, want, UNIT_TOL)
    init = TL.norm_init(tc, 64, CPU)
    for k, v in JL.norm_init(jc, 64).items():
        assert torch.equal(init[k], _t(v))
    assert set(init) == set(JL.norm_init(jc, 64))


@pytest.mark.parametrize("gated,act", [(True, "silu"), (True, "gelu"),
                                       (False, "gelu"), (False, "silu")])
def test_mlp_matches_repro(gated, act, rng):
    jc, tc = _unit_cfg(act=act, mlp_gated=gated)
    p = _np_tree(JL.mlp_init(jc, jax.random.key(1), 64, 128, gated=gated))
    x = rng.normal(0, 1, (2, 5, 64)).astype(np.float32)
    want = JL.apply_mlp(jc, p, jnp.asarray(x))
    got = TL.apply_mlp(tc, _torch_tree(p), _t(x))
    _close(got, want, UNIT_TOL)
    mine = TL.mlp_init(tc, 64, 128, gated=gated,
                       generator=torch.Generator().manual_seed(0),
                       device=CPU)
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: v.shape for k, v in p.items()}


def test_softcap_and_sinusoidal_match_repro(rng):
    x = rng.normal(0, 40, (3, 7)).astype(np.float32)
    for cap in (None, 30.0, 50.0):
        _close(TL.softcap(_t(x), cap), JL.softcap(jnp.asarray(x), cap),
               UNIT_TOL)
    pos = np.arange(0, 300, 7)
    _close(TL.sinusoidal(_t(pos), 48), JL.sinusoidal(jnp.asarray(pos), 48),
           UNIT_TOL)


def test_truncated_normal_is_seeded_and_cut_at_two_sigma():
    draw = dict(std=0.5, device=CPU)
    a = TL.truncated_normal((4096,), generator=torch.Generator()
                            .manual_seed(3), **draw)
    b = TL.truncated_normal((4096,), generator=torch.Generator()
                            .manual_seed(3), **draw)
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert float(a.abs().max()) <= 1.0
    assert abs(float(a.std()) - 0.5 * 0.8796) < 0.02   # σ of N cut at ±2σ


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attn_params(jc, seed=0):
    p = _np_tree(JA.attn_init(jc, jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    for k in ("bq", "bk", "bv"):       # repro inits the biases at 0
        if k in p:
            p[k] = rng.normal(0, 0.5, p[k].shape).astype(np.float32)
    return p


@pytest.mark.parametrize("window,s", [(None, 16), (None, 24), (5, 16),
                                      (5, 24)])
def test_attention_train_matches_repro(window, s, rng):
    jc, tc = _unit_cfg(qkv_bias=True)
    p = _attn_params(jc)
    x = rng.normal(0, 1, (2, s, 64)).astype(np.float32)
    want = JA.attention_train(jc, p, jnp.asarray(x), window=window)
    got = TA.attention_train(tc, _torch_tree(p), _t(x), window=window)
    _close(got, want, ATTN_TOL)


def test_attention_train_padding_path(rng):
    """S = 19, not divisible by the 8-row query chunk (the VLM prefix)."""
    jc, tc = _unit_cfg(attn_chunk=8)
    p = _attn_params(jc)
    x = rng.normal(0, 1, (2, 19, 64)).astype(np.float32)
    want = JA.attention_train(jc, p, jnp.asarray(x))
    got = TA.attention_train(tc, _torch_tree(p), _t(x))
    _close(got, want, ATTN_TOL)


def test_attention_softcap_and_qknorm(rng):
    jc, tc = _unit_cfg(attn_logit_softcap=30.0, qk_norm=True,
                       query_scale=0.2)
    p = _attn_params(jc)
    p["q_norm"] = rng.normal(1, 0.2, (16,)).astype(np.float32)
    p["k_norm"] = rng.normal(1, 0.2, (16,)).astype(np.float32)
    x = rng.normal(0, 1, (2, 16, 64)).astype(np.float32)
    for window in (None, 6):
        want = JA.attention_train(jc, p, jnp.asarray(x), window=window)
        got = TA.attention_train(tc, _torch_tree(p), _t(x), window=window)
        _close(got, want, ATTN_TOL)


K9_ROUTE_CASES = [(16, 8, None, None), (19, 8, None, None),
                  (130, 64, None, None), (200, 512, None, None),
                  # the window and the softcap, S above the window
                  (130, 64, 6, 30.0), (130, 8, 100, None),
                  (200, 512, 64, 50.0), (200, 64, 100, 50.0),
                  (130, 64, None, 30.0)]


@pytest.mark.parametrize(
    "s,chunk,window,cap", K9_ROUTE_CASES,
    ids=[f"{s}-{c}" + (f"-w{w}" if w else "") + (f"-cap{a:g}" if a else "")
         for s, c, w, a in K9_ROUTE_CASES])
def test_k9_route_matches_chunked_path(s, chunk, window, cap, rng):
    """The K9 route (``flash_mha``: its plain twin on the CPU, on S padded
    to its block grid) against the chunked scan and ``repro``'s, with and
    without a sliding window and a logit softcap (a query scale of 4
    spreads the logits over the caps' bend, a standard deviation above
    10)."""
    band = {} if cap is None else dict(attn_logit_softcap=cap,
                                       query_scale=4.0)
    jc, tc = _unit_cfg(attn_chunk=chunk, qkv_bias=True, **band)
    p = _attn_params(jc, seed=s)
    x = rng.normal(0, 1, (2, s, 64)).astype(np.float32)
    flash = TA.attention_train(tc, _torch_tree(p), _t(x), window=window,
                               attention="flash")
    plain = TA.attention_train(tc, _torch_tree(p), _t(x), window=window,
                               attention="plain")
    _close(flash, plain, ATTN_TOL)
    _close(flash, JA.attention_train(jc, p, jnp.asarray(x), window=window),
           ATTN_TOL)


def test_attention_route_decision():
    """K9 on CUDA by default, the plain scan on the CPU or by name. K9
    computes the window and the logit softcap, so gemma2's layers and the
    long-context variant's take it on CUDA too. The decision needs no
    card: it reads the device, not a tensor."""
    cuda = torch.device("cuda")
    qwen = t_configs.ARCHS["qwen2.5-3b"]
    gemma = t_configs.ARCHS["gemma2-27b"]
    assert TA.attention_route(cuda) == "flash"
    assert TA.attention_route(CPU) == "plain"
    assert TA.attention_route(CPU, "flash") == "flash"
    assert TA.attention_route(cuda, "plain") == "plain"
    # gemma2: the softcap on every layer, the window on its local ones;
    # force_local (the long_500k variant) windows every layer. The route
    # reads neither: the windowed and softcapped layers take K9 on CUDA
    assert gemma.attn_logit_softcap == 50.0
    for kind in (t_base.ATTN, t_base.ATTN_LOCAL):
        window = t_base.effective_window(gemma, kind)
        assert window == (4096 if kind == t_base.ATTN_LOCAL else None)
    long_qwen, _ = t_base.shape_variant(qwen, t_configs.get_shape(
        "long_500k"))
    assert t_base.effective_window(long_qwen, t_base.ATTN) == 4096
    with pytest.raises(ValueError):
        TA.attention_route(cuda, "sdpa")


def test_windowed_prefill_takes_the_k9_route(rng):
    """The same route inside a whole prefill, S = 16 above the window of
    8: gemma2's reduced config (softcap 50 on both layers, the window on
    its local one) and the ``force_local`` Qwen forward (the window on
    every layer) on the K9 route (its twin on the CPU) against
    ``repro``'s prefill and forward of the same params."""
    a = _arch("gemma2-27b")
    assert a.cfg_t.sliding_window == 8 < S
    want = jax.jit(j_make_prefill_step(a.cfg_j))(a.jp, a.batch_j())
    got = make_prefill_step(a.cfg_t, attention="flash")(a.tp, a.batch_t())
    _close(got, want, LOGIT_TOL)
    qwen_j, qwen_t = _reduced("qwen2.5-3b")
    long_j = dataclasses.replace(qwen_j, force_local=True, sliding_window=8)
    long_t = dataclasses.replace(qwen_t, force_local=True, sliding_window=8)
    jp = JT.init_params(long_j, jax.random.key(1))
    tp = lm_params_from_repro(_np_tree(jp), long_t, device=CPU)
    tokens = rng.integers(0, long_t.vocab_size, (B, S))
    want, _ = jax.jit(lambda p, b: JT.forward(long_j, p, b))(
        jp, {"tokens": jnp.asarray(tokens)})
    got, _ = TT.forward(long_t, tp, {"tokens": _t(tokens)},
                        attention="flash")
    _close(got, want, LOGIT_TOL)
    plain, _ = TT.forward(long_t, tp, {"tokens": _t(tokens)},
                          attention="plain")
    _close(got, plain, LOGIT_TOL)


def test_attention_decode_ring_buffer_evicts_gemma2_window(rng):
    """gemma2 with an 8-slot window over 32 positions: the local layers'
    caches hold 8 slots and evict; every step's logits against ``repro``'s
    decode and against the windowed prefill of the same tokens."""
    cfg_j = dataclasses.replace(j_configs.ARCHS["gemma2-27b"].reduced(
        seq_len_hint=32), dtype="float32", sliding_window=8)
    cfg_t = dataclasses.replace(t_configs.ARCHS["gemma2-27b"].reduced(
        seq_len_hint=32), dtype="float32", sliding_window=8)
    jp = JT.init_params(cfg_j, jax.random.key(0))
    tp = lm_params_from_repro(_np_tree(jp), cfg_t, device=CPU)
    n = 32
    tokens = rng.integers(0, cfg_t.vocab_size, (B, n))
    caches_j = JT.init_caches(cfg_j, B, n, dtype=jnp.float32)
    caches_t = TT.init_caches(cfg_t, B, n, dtype=torch.float32, device=CPU)
    assert [c.k.shape[1] for c in caches_t] == [8, n]   # local, global
    dec = jax.jit(lambda p, c, t, q: JT.decode_step(cfg_j, p, c, t, q))
    got, want = [], []
    for t in range(n):
        lg, caches_j = dec(jp, caches_j, jnp.asarray(tokens[:, t]),
                           jnp.full((B,), t, jnp.int32))
        want.append(np.asarray(lg))
        lt, caches_t = TT.decode_step(cfg_t, tp, caches_t,
                                      _t(tokens[:, t]),
                                      torch.full((B,), t, dtype=torch.int32))
        got.append(lt.numpy())
    _close(np.stack(got, 1), np.stack(want, 1), LOGIT_TOL)
    full, _ = TT.forward(cfg_t, tp, {"tokens": _t(tokens)})
    _close(np.stack(got, 1), full, LOGIT_TOL)
    # the local layer's ring holds the last 8 positions
    assert sorted(caches_t[0].slot_pos[0].tolist()) == list(range(n - 8, n))


# ---------------------------------------------------------------------------
# the ten archs on repro's params
# ---------------------------------------------------------------------------

class _Arch:
    """One arch's reduced configs, ``repro``'s params and jitted steps, the
    port's params through ``lm_params_from_repro`` and one input batch."""

    def __init__(self, arch):
        self.cfg_j, self.cfg_t = _reduced(arch)
        self.jp = JT.init_params(self.cfg_j, jax.random.key(0))
        self.tp = lm_params_from_repro(_np_tree(self.jp), self.cfg_t,
                                       device=CPU)
        rng = np.random.default_rng(len(arch))
        shape = ((B, S, self.cfg_t.num_codebooks)
                 if self.cfg_t.modality == "audio" else (B, S))
        self.tokens = rng.integers(0, self.cfg_t.vocab_size, shape)
        self.batch = {"tokens": self.tokens}
        if self.cfg_t.modality == "vision":
            self.batch["vision_embeds"] = rng.normal(
                0, 1, (B, self.cfg_t.num_patches, self.cfg_t.d_model)
            ).astype(np.float32)
        self.serve_j = jax.jit(j_make_serve_step(self.cfg_j))

    def batch_j(self):
        return {k: jnp.asarray(v) for k, v in self.batch.items()}

    def batch_t(self):
        return {k: _t(v) for k, v in self.batch.items()}


_ARCHS = {}


def _arch(name) -> _Arch:
    if name not in _ARCHS:
        _ARCHS[name] = _Arch(name)
    return _ARCHS[name]


@pytest.mark.parametrize("arch", COVERED)
def test_forward_matches_repro(arch):
    a = _arch(arch)
    want, _ = jax.jit(lambda p, b: JT.forward(a.cfg_j, p, b))(a.jp,
                                                             a.batch_j())
    got, aux = TT.forward(a.cfg_t, a.tp, a.batch_t())
    assert got.shape == want.shape
    _close(got, want, LOGIT_TOL)
    assert set(aux) == {"lb_loss", "counts", "dropped"}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_sums_moe_aux_as_repro(arch):
    """The aux statistics summed over the MoE layers, as ``repro``'s
    ``_acc_aux`` sums them: the expert counts exactly, the load-balance
    loss at 2e-4, nothing dropped on one card."""
    a = _arch(arch)
    _, want = jax.jit(lambda p, b: JT.forward(a.cfg_j, p, b))(a.jp,
                                                             a.batch_j())
    _, got = TT.forward(a.cfg_t, a.tp, a.batch_t())
    n_moe = a.cfg_t.pattern.count(t_base.MOE)
    assert np.array_equal(got["counts"].numpy(), np.asarray(want["counts"]))
    assert float(got["counts"].sum()) == \
        n_moe * B * S * a.cfg_t.num_experts_per_tok
    _close(got["lb_loss"], want["lb_loss"], LOGIT_TOL)
    assert float(got["dropped"]) == float(want["dropped"]) == 0.0


@pytest.mark.parametrize("arch", COVERED)
def test_prefill_step_matches_repro(arch):
    a = _arch(arch)
    want = jax.jit(j_make_prefill_step(a.cfg_j))(a.jp, a.batch_j())
    got = make_prefill_step(a.cfg_t)(a.tp, a.batch_t())
    assert got.shape == want.shape
    _close(got, want, LOGIT_TOL)
    flash = make_prefill_step(a.cfg_t, attention="flash")(a.tp, a.batch_t())
    _close(flash, want, LOGIT_TOL)


@pytest.mark.parametrize("arch", COVERED)
def test_decode_steps_match_repro(arch):
    """16 teacher-forced steps through the serve step: each step's logits
    at 2e-4 of ``repro``'s, its greedy tokens equal."""
    a = _arch(arch)
    caches_j = JT.init_caches(a.cfg_j, B, STEPS, dtype=jnp.float32)
    caches_t = TT.init_caches(a.cfg_t, B, STEPS, dtype=torch.float32,
                              device=CPU)
    serve = make_serve_step(a.cfg_t)
    for t in range(STEPS):
        pos = np.full((B,), t, np.int32)
        tok_j, lg_j, caches_j = a.serve_j(a.jp, caches_j,
                                          jnp.asarray(a.tokens[:, t]),
                                          jnp.asarray(pos))
        tok_t, lg_t, caches_t = serve(a.tp, caches_t, _t(a.tokens[:, t]),
                                      _t(pos))
        _close(lg_t, lg_j, LOGIT_TOL)
        assert np.array_equal(tok_t.numpy(), np.asarray(tok_j)), t
        assert tok_t.dtype == torch.int32


@pytest.mark.parametrize("arch", COVERED)
def test_generate_matches_repro_serve_loop(arch):
    """``generate`` against ``repro``'s launcher loop over its jitted serve
    step (``launch/serve.py``), on the same params and prompt: the same
    tokens."""
    a = _arch(arch)
    new = 8
    cache_len = S + new
    caches = JT.init_caches(a.cfg_j, B, cache_len, dtype=jnp.float32)
    prompt = jnp.asarray(a.tokens)
    for t in range(S):
        cur, _, caches = a.serve_j(a.jp, caches, prompt[:, t],
                                   jnp.full((B,), t, jnp.int32))
    want = []
    for t in range(S, cache_len):
        cur, _, caches = a.serve_j(a.jp, caches, cur,
                                   jnp.full((B,), t, jnp.int32))
        want.append(np.asarray(cur))
    got = t_serve.generate(a.cfg_t, a.tp, a.tokens, new, device="cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.stack(want, 1))


@pytest.mark.parametrize("arch", COVERED)
def test_port_init_runs_in_repro(arch):
    """The port's own init through ``lm_params_to_repro``: ``repro``'s
    forward on it against the port's, and the round trip bit for bit."""
    a = _arch(arch)
    tp = TT.init_params(a.cfg_t, 1, device=CPU)
    jp = lm_params_to_repro(tp, a.cfg_t)
    assert jax.tree.structure(jp) == jax.tree.structure(_np_tree(a.jp))
    for x, y in zip(jax.tree.leaves(jp), jax.tree.leaves(a.jp)):
        assert x.shape == y.shape and x.dtype == y.dtype
    back = lm_params_from_repro(jp, a.cfg_t, device=CPU)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(tp)):
        assert torch.equal(x, y)
    want, _ = JT.forward(a.cfg_j, jp, a.batch_j())
    got, _ = TT.forward(a.cfg_t, tp, a.batch_t())
    _close(got, want, LOGIT_TOL)


def test_cast_params_keeps_norms_and_the_function(rng):
    """The bf16 copy made once computes ``repro``'s per-use casts: the same
    logits bit for bit from the fp32 masters and from the copy, with the
    norms' parameters left in fp32."""
    cfg = dataclasses.replace(t_configs.ARCHS["gemma2-27b"].reduced(
        seq_len_hint=S), dtype="bfloat16")
    params = TT.init_params(cfg, 0, device=CPU)
    for p in params["layers"]:
        for name in ("norm1", "norm2", "norm1_post", "norm2_post"):
            p[name]["scale"] = torch.from_numpy(
                rng.normal(0, 0.3, p[name]["scale"].shape)
                .astype(np.float32))
    copy = TT.cast_params(cfg, params)
    assert copy["embed"].dtype == torch.bfloat16
    assert copy["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert copy["layers"][0]["norm1"]["scale"].dtype == torch.float32
    assert copy["final_norm"]["scale"] is params["final_norm"]["scale"]
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    want, _ = TT.forward(cfg, params, {"tokens": tokens})
    got, _ = TT.forward(cfg, copy, {"tokens": tokens})
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_npz_checkpoint_from_repro_restores_bit_for_bit(tmp_path):
    a = _arch("gemma2-27b")
    path = str(tmp_path / "ckpt.npz")
    j_io.save_checkpoint(path, a.jp, step=7)
    flat = t_io.restore_checkpoint(path)
    want = j_io._flatten(a.jp)
    assert set(flat) == set(want) | {"__step__"}
    assert int(flat["__step__"]) == 7
    for key, arr in want.items():
        assert flat[key].dtype == arr.dtype
        assert np.array_equal(flat[key].view(np.uint8), arr.view(np.uint8))
    from_flat = lm_params_from_repro(flat, a.cfg_t, device=CPU)
    for x, y in zip(jax.tree.leaves(from_flat), jax.tree.leaves(a.tp)):
        assert torch.equal(x, y)
    # into a port tree of the same structure: tensors, and repro's cache
    like = jax.tree.map(lambda x: torch.zeros(x.shape), _np_tree(a.jp))
    got = t_io.restore_checkpoint(path, like)
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(a.jp)):
        assert torch.equal(x, _t(y))


def test_npz_checkpoint_from_port_restores_in_repro(tmp_path):
    a = _arch("command-r-35b")
    tp = TT.init_params(a.cfg_t, 2, device=CPU)
    path = str(tmp_path / "port.npz")
    t_io.save_checkpoint(path, lm_params_to_repro(tp, a.cfg_t), step=3)
    got = j_io.restore_checkpoint(path, a.jp)
    back = lm_params_from_repro(_np_tree(got), a.cfg_t, device=CPU)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(tp)):
        assert torch.equal(x, y)
    assert int(np.load(path)["__step__"]) == 3
    # the port's own tree (a list of layers) round-trips in the port
    path2 = str(tmp_path / "layers.npz")
    t_io.save_checkpoint(path2, tp)
    again = t_io.restore_checkpoint(path2, tp)
    for x, y in zip(jax.tree.leaves(again), jax.tree.leaves(tp)):
        assert torch.equal(x, y)


def test_npz_checkpoint_named_tuples_both_ways(tmp_path):
    """Named-tuple leaves (the KV caches) keep ``repro``'s ``.field``
    paths, each package restoring the other's file bit for bit."""
    a = _arch("qwen2.5-3b")
    caches_j = jax.tree.map(
        lambda x: x + 3, JT.init_caches(a.cfg_j, B, 4, dtype=jnp.float32))
    path = str(tmp_path / "repro_caches.npz")
    j_io.save_checkpoint(path, caches_j)

    def zeros(x):
        return torch.zeros(x.shape, dtype=_t(x).dtype)

    like = tuple(tuple(TA.KVCache(*(zeros(x) for x in c)) for c in stage)
                 for stage in caches_j)
    got = t_io.restore_checkpoint(path, like)
    assert isinstance(got[0][0], TA.KVCache)
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(caches_j)):
        assert x.dtype == zeros(y).dtype and torch.equal(x, _t(y))
    path2 = str(tmp_path / "port_caches.npz")
    t_io.save_checkpoint(path2, got)
    back = j_io.restore_checkpoint(path2, caches_j)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(caches_j)):
        assert np.array_equal(x, np.asarray(y))


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_npz_recurrent_caches_both_ways(arch, tmp_path):
    """A decode stopped after 8 tokens in one package and saved to npz
    (``Mamba2Cache``, ``MLSTMCache``, ``SLSTMCache``, ``RecurrentState``
    and zamba2's (``Mamba2Cache``, ``KVCache``) pair, by ``.field``
    paths) goes on in the other: the next 8 steps' logits at 2e-4 of the
    run that never stopped, each way."""
    a = _arch(arch)
    half = STEPS // 2

    def pos(t):
        return np.full((B,), t, np.int32)

    def run_port(caches, steps):
        out = []
        for t in steps:
            lg, caches = TT.decode_step(a.cfg_t, a.tp, caches,
                                        _t(a.tokens[:, t]), _t(pos(t)))
            out.append(lg.numpy())
        return out, caches

    def run_repro(caches, steps):
        out = []
        for t in steps:
            _, lg, caches = a.serve_j(a.jp, caches,
                                      jnp.asarray(a.tokens[:, t]),
                                      jnp.asarray(pos(t)))
            out.append(np.asarray(lg))
        return out, caches

    fresh_j = JT.init_caches(a.cfg_j, B, STEPS, dtype=jnp.float32)
    fresh_t = TT.init_caches(a.cfg_t, B, STEPS, dtype=torch.float32,
                             device=CPU)
    kinds = {type(c).__name__ for c in jax.tree.leaves(
        fresh_t, is_leaf=lambda x: hasattr(x, "_fields"))}
    assert kinds & {"Mamba2Cache", "MLSTMCache", "SLSTMCache"}
    # the port stops, repro goes on
    _, caches_t = run_port(fresh_t, range(half))
    path = str(tmp_path / "port.npz")
    t_io.save_checkpoint(path, lm_caches_to_repro(caches_t, a.cfg_t))
    got, _ = run_repro(j_io.restore_checkpoint(path, fresh_j),
                       range(half, STEPS))
    want, _ = run_port(caches_t, range(half, STEPS))
    _close(np.stack(got), np.stack(want), LOGIT_TOL)
    # repro stops, the port goes on
    _, caches_j = run_repro(fresh_j, range(half))
    path = str(tmp_path / "repro.npz")
    j_io.save_checkpoint(path, caches_j)
    like = lm_caches_to_repro(fresh_t, a.cfg_t)
    restored = lm_caches_from_repro(t_io.restore_checkpoint(path, like),
                                    a.cfg_t, device=CPU)
    assert jax.tree.structure(restored) == jax.tree.structure(fresh_t)
    got, _ = run_port(restored, range(half, STEPS))
    want, _ = run_repro(caches_j, range(half, STEPS))
    _close(np.stack(got), np.stack(want), LOGIT_TOL)


# ---------------------------------------------------------------------------
# refusals and entry points
# ---------------------------------------------------------------------------

def test_mesh_and_training_raise_naming_their_item():
    """Serving and training run over a ``MeshCtx`` (ROADMAP §1 items 10.4
    and 10.5; the sharded model against ``repro``'s is
    ``tests/test_torch_lm_mesh.py``, its training
    ``tests/test_torch_train_mesh.py``): on a (1, 1) mesh the forward,
    the prefill, decode, ``loss_fn`` and a train step compute ctx=None's
    bits, with the ``seq_shard`` lever on too (every axis of size 1).
    Anything but a ``MeshCtx`` is refused."""
    import copy
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.optim import adamw
    from repro_torch.sharding import make_ctx
    from repro_torch.training import TrainState, shard_train_state
    _, cfg = _reduced("qwen2.5-3b")
    params = TT.init_params(cfg, 0, device=CPU)
    batch = {"tokens": torch.arange(B * S).reshape(B, S) % cfg.vocab_size}
    train = dict(batch, labels=(batch["tokens"] * 7 + 3) % cfg.vocab_size)
    opt = adamw(3e-4)
    for seq_shard in (False, True):
        ctx = make_ctx(make_abstract_mesh((1, 1), ("data", "model")),
                       seq_shard=seq_shard)
        with torch.inference_mode():
            assert torch.equal(TT.forward(cfg, params, batch, ctx)[0],
                               TT.forward(cfg, params, batch)[0])
            assert torch.equal(make_prefill_step(cfg, ctx)(params, batch),
                               make_prefill_step(cfg)(params, batch))
            c1 = TT.init_caches(cfg, B, S, torch.float32, device=CPU)
            c2 = TT.init_caches(cfg, B, S, torch.float32, device=CPU,
                                ctx=ctx)
            pos = torch.zeros((B,), dtype=torch.int32)
            assert torch.equal(
                make_serve_step(cfg)(params, c1, batch["tokens"][:, 0],
                                     pos)[1],
                make_serve_step(cfg, ctx)(params, c2, batch["tokens"][:, 0],
                                          pos)[1])
        assert torch.equal(TT.loss_fn(cfg, params, train, ctx)[0],
                           TT.loss_fn(cfg, params, train)[0])

        def fresh():
            p = copy.deepcopy(params)
            return TrainState(p, opt.init(p),
                              torch.zeros((), dtype=torch.int32))
        a, ma = make_train_step(cfg, opt)(fresh(), train)
        b, mb = make_train_step(cfg, opt, ctx)(
            shard_train_state(cfg, fresh(), ctx), train)
        assert all(torch.equal(ma[k], mb[k]) for k in ma)
        assert all(torch.equal(x, y) for x, y in
                   zip(jax.tree.leaves(a.params), jax.tree.leaves(b.params)))
    with pytest.raises(TypeError, match="MeshCtx"):
        TT.forward(cfg, params, batch, object())
    with pytest.raises(TypeError, match="MeshCtx"):
        make_train_step(cfg, opt, object())


def test_entry_points_run_on_cuda_unless_told():
    _, cfg = _reduced("qwen2.5-3b")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points default to it")
    for call in (lambda: TT.init_params(cfg, 0),
                 lambda: TT.init_caches(cfg, B, S),
                 lambda: t_serve.generate(cfg, {}, np.zeros((B, S)), 1),
                 lambda: t_serve.main(["--arch", "qwen2.5-3b"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_serve_cli_prints_repro_lines(capsys):
    """The launcher's flags and printout: ``--reduced`` is on whatever the
    command line says, as in ``repro``."""
    t_serve.main(["--arch", "musicgen-medium", "--device", "cpu",
                  "--batch", "2", "--prompt-len", "4", "--new-tokens", "5"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=musicgen-medium-smoke decoded 5×2 "
                             "tokens (")
    assert out[0].endswith(" tok/s incl. prefill)")
    assert out[1].startswith("sample: [[")
    sample = eval(out[1][len("sample: "):])
    assert len(sample) == 5 and all(len(s) == 4 for s in sample)


@pytest.mark.parametrize("arch", MOE_ARCHS + RECURRENT_ARCHS)
def test_serve_cli_runs_moe_and_recurrent_archs(arch, capsys):
    t_serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                  "--prompt-len", "4", "--new-tokens", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"arch={arch}-smoke decoded 3×2 tokens (")
    sample = eval(out[1][len("sample: "):])
    assert len(sample) == 3
