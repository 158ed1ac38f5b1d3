"""Port parity, attention: the flash-attention kernel's plain twin (K9) and
the grouped-query wrapper ``flash_mha``, held against ``repro``'s Pallas
kernel (interpret mode), its ``flash_mha`` and its oracle ``mha_ref`` on
the same numpy inputs, at ``repro``'s own bars (``tests/
test_extensions.py``): 2e-5 in fp32, 3e-2 in bf16. K9's sliding window and
logit softcap, which ``repro``'s kernel lacks, are held against the
function that ``repro``'s chunked LM attention computes
(``repro.models.attention.attention_train``) at its bar, 1e-4
(``tests/test_model_units.py``).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models import attention as JA
from repro_torch.configs import base as t_base
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.flash_attention import (attention_flops,
                                                 flash_attention,
                                                 flash_attention_plain,
                                                 kept_pairs)
from repro_torch.models import attention as TA

# (BH, S, hd, block_q, block_k, causal): tests/test_extensions.py's FA_SHAPES
FA_SHAPES = [
    (2, 256, 64, 128, 128, True),
    (2, 256, 64, 64, 128, False),
    (4, 512, 128, 128, 64, True),
    (1, 128, 32, 128, 128, True),
    (3, 384, 64, 128, 128, True),
]


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("bh,s,hd,bq,bk,causal", FA_SHAPES)
def test_flash_twin_matches_pallas_kernel(bh, s, hd, bq, bk, causal):
    q, k, v = _normal(bh * s + hd, *[(bh, s, hd)] * 3)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, block_q=bq, block_k=bk, interpret=True)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal, block_q=bq,
                          block_k=bk)
    _close(got, want, 2e-5)


def test_flash_twin_bf16():
    q, k, v = _normal(1, *[(2, 256, 64)] * 3)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = j_flash(jq, jk, jv, causal=True, interpret=True)
    tq, tk, tv = (_t(x).to(torch.bfloat16) for x in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), 3e-2)
    _close(got.float(), ref.mha_ref(tq, tk, tv, causal=True).float(), 3e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_mha_oracle_matches_repro(causal):
    q, k, v = _normal(2, *[(3, 40, 16)] * 3)
    want = j_ref.mha_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal)
    _close(ref.mha_ref(_t(q), _t(k), _t(v), causal=causal), want, 2e-5)


def test_flash_twin_reads_grouped_kv_heads():
    """k and v with BH / rep heads: query head bh reads head bh // rep, the
    same as repeating them."""
    q, k, v = _normal(3, (8, 128, 32), (2, 128, 32), (2, 128, 32))
    got = flash_attention(_t(q), _t(k), _t(v), causal=False)
    want = ref.mha_ref(_t(q), _t(k).repeat_interleave(4, 0),
                       _t(v).repeat_interleave(4, 0), causal=False)
    _close(got, want, 2e-5)


def test_flash_wrapper_checks_its_arguments():
    q, k, v = _normal(4, *[(2, 200, 16)] * 3)
    with pytest.raises(ValueError, match="divide by the blocks"):
        flash_attention(_t(q), _t(k), _t(v))
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention(_t(q), _t(k), _t(v), block_q=200, block_k=200,
                        kv_len=201)
    with pytest.raises(ValueError, match="key/value heads"):
        flash_attention(_t(q), _t(k[:1]).repeat(3, 1, 1),
                        _t(v[:1]).repeat(3, 1, 1), block_q=200, block_k=200)
    with pytest.raises(TypeError, match="one dtype"):
        flash_attention(_t(q), _t(k).double(), _t(v), block_q=200,
                        block_k=200)


def _gqa(seed, s, b=2, h=8, kv=2, hd=32):
    return _normal(seed, (b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))


def _mha_ref_gqa(q, k, v, causal):
    """``repro``'s oracle on the unpadded inputs, KV heads repeated."""
    b, s, h, hd = q.shape
    rep = h // k.shape[2]

    def flat(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, s, hd)

    out = j_ref.mha_ref(flat(q), flat(np.repeat(k, rep, 2)),
                        flat(np.repeat(v, rep, 2)), causal=causal)
    return np.asarray(out).reshape(b, h, s, hd).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("s,causal", [(70, True), (70, False), (200, True)])
def test_flash_mha_matches_repro(s, causal):
    """GQA and padding where ``repro``'s ``flash_mha`` is right: S < 128
    (one block, no padding) and a causal S = 200 (padded to 256; the padded
    keys lie above every real row's diagonal)."""
    q, k, v = _gqa(s + causal, s)
    want = j_ops.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal)
    got = ops.flash_mha(_t(q), _t(k), _t(v), causal=causal)
    assert got.shape == q.shape
    _close(got, want, 2e-5)
    _close(got, _mha_ref_gqa(q, k, v, causal), 2e-5)


def test_flash_mha_masks_padded_keys_when_not_causal():
    """Non-causal S = 200 pads to 256. ``repro``'s ``flash_mha`` pads q, k, v
    with zeros and does not mask the padded keys, so they join its softmax
    with score 0 and its output is off ``mha_ref`` (a reference-side fault,
    ROADMAP.md §3). The port passes the true length to the kernel and
    matches the oracle on the unpadded inputs."""
    q, k, v = _gqa(11, 200, h=2, kv=2)
    got = ops.flash_mha(_t(q), _t(k), _t(v), causal=False)
    _close(got, _mha_ref_gqa(q, k, v, causal=False), 2e-5)
    faulty = np.asarray(j_ops.flash_mha(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=False))
    assert np.abs(faulty - _mha_ref_gqa(q, k, v, causal=False)).max() > 1e-2


@pytest.mark.parametrize("s,window,cap", [(130, 6, 30.0), (200, 64, 50.0),
                                          (256, 100, None), (200, None, 50.0),
                                          (96, 1, 30.0)])
def test_banded_twin_matches_repro_attention(s, window, cap):
    """The twin with a window and a softcap (flash_attention on CPU
    tensors) on the rope'd, pre-scaled q, k, v of a GQA layer, projected
    by wo, against ``repro``'s chunked ``attention_train`` of the same
    layer at 1e-4. The query scale puts the logits near the cap, so the
    cap bends them."""
    base = dict(name="t", family="dense", num_layers=1, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=97,
                attn_chunk=64, dtype="float32", attn_logit_softcap=cap,
                query_scale=2.0)
    jc, tc = j_configs.base.ModelConfig(**base), t_base.ModelConfig(**base)
    p = {k: np.array(v) for k, v in JA.attn_init(
        jc, jax.random.key(s)).items()}
    x = np.random.default_rng(s).normal(0, 1, (2, s, 64)).astype(np.float32)
    want = JA.attention_train(jc, p, jnp.asarray(x), window=window)
    tp = {k: _t(v) for k, v in p.items()}
    q, k, v = TA.prefill_qkv(tc, tp, _t(x), torch.arange(s))
    b, _, h, hd = q.shape

    def flat(t):
        return t.permute(0, 2, 1, 3).reshape(-1, s, hd)

    blk = 128 if s >= 128 else s
    pad = -s % blk
    qf, kf, vf = (torch.nn.functional.pad(flat(t), (0, 0, 0, pad))
                  for t in (q, k, v))
    out = flash_attention(qf, kf, vf, causal=True, scale=1.0, block_q=blk,
                          block_k=blk, kv_len=s, window=window, softcap=cap)
    out = out[:, :s].reshape(b, h, s, hd).permute(0, 2, 1, 3)
    got = torch.einsum("bthk,hkd->btd", out, tp["wo"])
    _close(got, want, 1e-4)
    uncapped = flash_attention(qf, kf, vf, causal=True, scale=1.0,
                               block_q=blk, block_k=blk, kv_len=s,
                               window=window)[:, :s]
    bend = float((uncapped.reshape(b, h, s, hd).permute(0, 2, 1, 3)
                  - out).abs().max())
    if window == 1:           # a row keeps its own key: v's row, capped or not
        assert torch.equal(out, v.repeat_interleave(h // v.shape[2], 2))
    elif cap is not None:     # the cap is not a no-op at these logits
        assert bend > 1e-2


@pytest.mark.parametrize("s,kv_len,window", [
    (256, 256, 1), (256, 256, 100), (256, 200, 100), (256, 200, 1),
    (300, 300, 4096), (128, 100, 40), (1024, 1000, 100), (64, 10, 30),
    (200, 130, None), (200, 130, 200)])
def test_attention_flops_counts_the_kept_mask(s, kv_len, window):
    """K9's operation count (and the dry run's) against a brute-force count
    of the entries its masks keep, causal, padded rows included."""
    rows, cols = np.arange(s)[:, None], np.arange(s)[None, :]
    keep = (cols < kv_len) & (rows >= cols)
    if window is not None:
        keep &= rows - cols < window
    assert kept_pairs(s, kv_len, True, window) == int(keep.sum())
    assert attention_flops(3, s, 64, kv_len, True, window) == \
        4.0 * 64 * 3 * int(keep.sum())
    assert attention_flops(3, s, 64, kv_len, False) == 4.0 * 64 * 3 * s * \
        kv_len


def test_flash_wrapper_checks_its_band():
    """A window needs causal attention and is an int >= 1; a softcap is
    > 0; the twin computes a row with no kept key as zeros."""
    q, k, v = (_t(x) for x in _normal(6, *[(2, 128, 16)] * 3))
    with pytest.raises(ValueError, match="needs causal"):
        flash_attention(q, k, v, causal=False, window=8)
    for bad in (0, -3, 2.5, True):
        with pytest.raises(ValueError, match="window"):
            flash_attention(q, k, v, window=bad)
    for bad in (0.0, -50.0):
        with pytest.raises(ValueError, match="softcap"):
            flash_attention(q, k, v, softcap=bad)
    # kv_len 100, window 8: rows 107 and up keep no key
    out = flash_attention(q, k, v, kv_len=100, window=8)
    assert torch.equal(out[:, 107:], torch.zeros_like(out[:, 107:]))
    assert bool((out[:, :107].abs().sum(-1) > 0).all())


def test_flash_attention_plain_masks_keys_past_kv_len():
    q, k, v = _normal(5, *[(2, 64, 16)] * 3)
    got = flash_attention_plain(_t(q), _t(k), _t(v), causal=False, kv_len=50)
    # every query sees the first 50 keys only
    want = ref.mha_ref(_t(q), _t(k[:, :50]), _t(v[:, :50]), causal=False)
    _close(got, want, 2e-5)


# K9's card tests (tests/test_torch_gpu.py): (S, hd, rep, kv_len), BH = 4·rep
CARD_SHAPES = [(256, 128, 4, None), (70, 64, 1, None), (256, 256, 2, 200),
               (128, 40, 1, 100)]
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-3   # the card tests' bf16 bar


def _kernel_key_tile(hd):
    """Keys per tile of K9's bf16 body for head width hd, read from the
    kernel's source (its template widths 64, 128, 256 and ``Cfg::BK``), so
    that the emulation follows the kernel's tiling."""
    src = build.ATTENTION_SOURCE.read_text()
    cut, small, large = map(int, re.search(
        r"BK = D <= (\d+) \? (\d+) : (\d+);", src).groups())
    width = next(d for d in (64, 128, 256) if hd <= d)
    return small if width <= cut else large


def _tensor_core_arithmetic(q, k, v, causal, kv_len, split, window=None,
                            softcap=None, scale=None):
    """K9's bf16 body in plain torch: per 128-row query tile, the key
    tiles from the first that holds a key of some row's window (the
    kernel's skip rule; tile 0 without a window) to the causal limit; fp32
    scores of the bf16 inputs, softcapped as the kernel does it (cap·log2e
    ·tanh(s·(scale / cap))), masked, the online softmax in log2 units, P
    from fp32 exponentials entering P·V as bf16 — as P_hi + P_lo (P_lo =
    bf16(P − P_hi)) with ``split``, as one bf16 P without — the products
    and the row sum in fp32, the output rounded to bf16; a row that kept
    no key is zeros. This checks the design's numerics on the CPU; K9
    itself is held to the same bar by the card tests
    (tests/test_torch_gpu.py)."""
    bh, s, hd = q.shape
    rep = bh // k.shape[0]
    bk, bq = _kernel_key_tile(hd), 128
    log2e = 1.4426950408889634
    scale = hd ** -0.5 if scale is None else scale
    f32 = np.float32
    qf = q.float()
    kf = k.float().repeat_interleave(rep, 0)
    vf = v.float().repeat_interleave(rep, 0)
    out = torch.zeros((bh, s, hd))
    for q0 in range(0, s, bq):
        rows = torch.arange(q0, min(q0 + bq, s))[:, None]
        n = rows.shape[0]
        m = torch.full((bh, n, 1), -1e30)
        l = torch.zeros((bh, n, 1))
        o = torch.zeros((bh, n, hd))
        kv_end = min(kv_len, q0 + bq) if causal else kv_len
        t_first = max(0, q0 - window + 1) // bk if window else 0
        for k0 in range(t_first * bk, kv_end, bk):
            cols = torch.arange(k0, min(k0 + bk, s))[None, :]
            keep = cols < kv_len
            if causal:
                keep = keep & (rows >= cols)
            if window:
                keep = keep & (rows - cols < window)
            sc = torch.einsum("bqd,bkd->bqk", qf[:, q0:q0 + n],
                              kf[:, k0:k0 + bk])
            if softcap:
                sc = float(f32(softcap) * f32(log2e)) * torch.tanh(
                    sc * float(f32(scale) / f32(softcap)))
            else:
                sc = sc * float(f32(scale) * f32(log2e))
            sc = torch.where(keep, sc, -1e30)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            corr, p = torch.exp2(m - m_new), torch.exp2(sc - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            hi = p.to(torch.bfloat16).float()
            pv = hi @ vf[:, k0:k0 + bk]
            if split:
                pv = pv + (p - hi).to(torch.bfloat16).float() @ \
                    vf[:, k0:k0 + bk]
            o, m = o * corr + pv, m_new
        inv = torch.where(m > -1e30, 1.0 / l.clamp_min(1e-30), 0.0)
        out[:, q0:q0 + n] = o * inv
    return out.to(torch.bfloat16)


def _card_inputs(s, hd, rep, seed):
    rng = np.random.default_rng(seed)
    bh = 4 * rep
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (n, s, hd))
                                .astype(np.float32)).to(torch.bfloat16)
               for n in (bh, bh // rep, bh // rep))
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,hd,rep,kv_len", CARD_SHAPES)
def test_split_p_arithmetic_meets_the_card_bar(s, hd, rep, kv_len, causal):
    """P·V as two bf16 products (P_hi + P_lo, fp32 sums) stays within the
    card tests' bf16 bar of the fp32-math twin at every card test shape."""
    q, k, v = _card_inputs(s, hd, rep, s + hd)
    kv_len = s if kv_len is None else kv_len
    got = _tensor_core_arithmetic(q, k, v, causal, kv_len, split=True)
    want = flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len)
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_RTOL,
                               atol=BF16_ATOL)


@pytest.mark.parametrize("softcap", [None, 50.0])
@pytest.mark.parametrize("window", [1, 100, "S"])
@pytest.mark.parametrize("s,hd,rep,kv_len", CARD_SHAPES)
def test_banded_arithmetic_meets_the_card_bar(s, hd, rep, kv_len, window,
                                              softcap):
    """The bf16 body with a window (W = 1 and 100, under one key tile, and
    W = S, which masks nothing) and the softcap, over the key tiles the
    kernel visits, within the card bar of the twin. The softcap cases run
    at scale 1, so the logits (standard deviation √hd) reach the cap. At
    W = 1 a row keeps its diagonal key alone (P = 1 = 1 + 0 through the
    split) and its output is v's row, bit for bit."""
    q, k, v = _card_inputs(s, hd, rep, s + hd + 1)
    kv_len = s if kv_len is None else kv_len
    window = s if window == "S" else window
    scale = 1.0 if softcap else None
    got = _tensor_core_arithmetic(q, k, v, True, kv_len, split=True,
                                  window=window, softcap=softcap,
                                  scale=scale)
    want = flash_attention_plain(q, k, v, causal=True, kv_len=kv_len,
                                 window=window, softcap=softcap, scale=scale)
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_RTOL,
                               atol=BF16_ATOL)
    if window == 1:
        rows = min(kv_len, s)
        assert torch.equal(got[:, :rows],
                           v.repeat_interleave(rep, 0)[:, :rows])
        assert torch.equal(want[:, :rows],
                           v.repeat_interleave(rep, 0)[:, :rows])


@pytest.mark.parametrize("s,hd,rep,kv_len", CARD_SHAPES)
def test_single_bf16_p_misses_the_card_bar(s, hd, rep, kv_len):
    """One bf16 P (what a plain bf16 P·V would do) misses the same bar at
    the causal card shapes: the reason K9 splits P."""
    q, k, v = _card_inputs(s, hd, rep, s + hd)
    kv_len = s if kv_len is None else kv_len
    got = _tensor_core_arithmetic(q, k, v, True, kv_len, split=False)
    want = flash_attention_plain(q, k, v, causal=True, kv_len=kv_len)
    assert not torch.allclose(got.float(), want.float(), rtol=BF16_RTOL,
                              atol=BF16_ATOL)
