"""Port parity, attention: the flash-attention kernel's plain twin (K9) and
the grouped-query wrapper ``flash_mha``, held against ``repro``'s Pallas
kernel (interpret mode), its ``flash_mha`` and its oracle ``mha_ref`` on
the same numpy inputs, at ``repro``'s own bars (``tests/
test_extensions.py``): 2e-5 in fp32, 3e-2 in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)

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


def test_flash_attention_plain_masks_keys_past_kv_len():
    q, k, v = _normal(5, *[(2, 64, 16)] * 3)
    got = flash_attention_plain(_t(q), _t(k), _t(v), causal=False, kv_len=50)
    # every query sees the first 50 keys only
    want = ref.mha_ref(_t(q), _t(k[:, :50]), _t(v[:, :50]), causal=False)
    _close(got, want, 2e-5)
