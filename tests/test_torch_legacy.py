"""Port parity, the pre-fusion baseline: the plain twins of the dense sweep
(K6), the dense sstats (K7) and the one-hot memo delta (K8), and the
per-sweep E-step ``estep_cuda_sweeps``, held against ``repro``'s Pallas
kernels (interpret mode) and ``estep_pallas_sweeps`` on the same numpy
inputs.

Tolerances are ``repro``'s own for these kernels: rtol/atol 2e-5 for a
sweep and for sstats (``tests/test_kernels.py``), π 1e-5 / 1e-6 and the
masses 1e-4 for the one-hot delta (one bf16 ulp, 2^-7 relative, for π
rounded through bf16). The per-sweep E-step computes the same
loop with another digamma (torch's against ``jax.scipy``'s), so γ and π
agree to 1e-4 and sstats to 1e-3, and the stopping rule must give the same
sweep count.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.math import exp_dirichlet_expectation as j_eb
from repro.core.types import LDAConfig as JConfig
from repro.data import PAPER_CORPORA, make_corpus
from repro.kernels import lda_estep as j_kernels
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.core.types import LDAConfig
from repro_torch.kernels import lda_estep, ops, ref

BF16_ULP = 2.0 ** -7

# (B, V, K, block_b, block_v): tests/test_kernels.py's SHAPES
SHAPES = [
    (8, 64, 16, 8, 32),
    (16, 256, 32, 8, 64),
    (128, 512, 128, 128, 512),
    (32, 768, 100, 16, 128),
    (64, 1024, 128, 32, 256),
    (8, 512, 64, 8, 512),      # single V tile
    (128, 128, 128, 64, 64),
]


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _dense(seed, b, v, k):
    rng = np.random.default_rng(seed)
    return (rng.poisson(0.3, (b, v)).astype(np.float32),
            rng.gamma(1.0, 1.0, (b, k)).astype(np.float32),
            rng.gamma(1.0, 1.0, (v, k)).astype(np.float32))


@pytest.mark.parametrize("b,v,k,bb,bv", SHAPES)
def test_sweep_twin_matches_pallas_kernel(b, v, k, bb, bv):
    c, et, eb = _dense(b + v + k, b, v, k)
    want = j_kernels.estep_sweep(jnp.asarray(c), jnp.asarray(et),
                                 jnp.asarray(eb), 0.5, block_b=bb,
                                 block_v=bv, interpret=True)
    got = lda_estep.estep_sweep(_t(c), _t(et), _t(eb), 0.5, block_b=bb,
                                block_v=bv)
    _close(got, want, 2e-5, 2e-5)


@pytest.mark.parametrize("b,v,k,bb,bv", SHAPES)
def test_sstats_twin_matches_pallas_kernel(b, v, k, bb, bv):
    c, et, eb = _dense(b * v + k, b, v, k)
    want = j_kernels.sstats(jnp.asarray(c), jnp.asarray(et), jnp.asarray(eb),
                            block_b=bb, block_v=bv, interpret=True)
    got = lda_estep.sstats(_t(c), _t(et), _t(eb), block_b=bb, block_v=bv)
    _close(got, want, 2e-5, 2e-5)


def test_dense_oracles_match_repro():
    c, et, eb = _dense(5, 12, 90, 7)
    _close(ref.estep_sweep_ref(_t(c), _t(et), _t(eb), 0.3),
           j_ref.estep_sweep_ref(jnp.asarray(c), jnp.asarray(et),
                                 jnp.asarray(eb), 0.3), 1e-6, 1e-6)
    _close(ref.sstats_ref(_t(c), _t(et), _t(eb)),
           j_ref.sstats_ref(jnp.asarray(c), jnp.asarray(et),
                            jnp.asarray(eb)), 1e-6, 1e-6)


def test_dense_wrappers_check_the_grid():
    c, et, eb = _dense(6, 12, 90, 7)
    with pytest.raises(ValueError, match="padded to the grid"):
        lda_estep.estep_sweep(_t(c), _t(et), _t(eb), 0.5, block_b=8)
    with pytest.raises(ValueError, match="padded to the grid"):
        lda_estep.sstats(_t(c), _t(et), _t(eb), block_v=64)
    with pytest.raises(ValueError, match="expected shape"):
        lda_estep.sstats(_t(c), _t(et[:, :5]), _t(eb))


def test_pad_inputs_matches_repro():
    rng = np.random.default_rng(8)
    c = rng.poisson(0.4, (20, 300)).astype(np.float32)
    eb = rng.gamma(1.0, 1.0, (300, 100)).astype(np.float32)
    jc, jeb, jshape = j_ops.pad_inputs(jnp.asarray(c), jnp.asarray(eb), 16,
                                       128)
    tc, teb, tshape = ops.pad_inputs(_t(c), _t(eb), 16, 128)
    assert tshape == jshape == (20, 300, 100)
    assert tc.shape == (32, 384) and teb.shape == (384, 128)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(teb.numpy(), np.asarray(jeb))
    assert bool((teb[300:, :100] == 1.0).all())     # padded words: Eφ = 1
    assert bool((teb[:, 100:] == 0.0).all())        # padded topics: Eφ = 0


def _tiny_batch(k, docs=16, seed=0):
    spec = PAPER_CORPORA["tiny"]
    corpus = make_corpus(spec, split="train", seed=seed)
    rng = np.random.default_rng(seed)
    lam = rng.gamma(100.0, 0.01, (spec.vocab_size, k)).astype(np.float32)
    eb = np.asarray(j_eb(jnp.asarray(lam), axis=0))
    return (np.asarray(corpus.token_ids[:docs]),
            np.asarray(corpus.counts[:docs]), eb, spec.vocab_size)


@pytest.mark.parametrize("k,warm", [(8, False), (8, True), (100, False)])
def test_estep_cuda_sweeps_matches_pallas_sweeps(k, warm):
    """The whole per-sweep E-step on ``tiny`` against ``repro``'s, the same
    λ and γ₀. K = 100 pads to 128 topics: the stopping rule divides the
    summed |Δγ| by 128, as ``repro``'s loop does, and the sweep counts agree
    only if the port copies that divisor."""
    ids, cnts, eb, vocab = _tiny_batch(k)
    kw = dict(num_topics=k, vocab_size=vocab, estep_max_iters=100)
    jcfg, tcfg = JConfig(**kw), LDAConfig(**kw)
    gamma0 = None
    if warm:   # γ after 5 sweeps from cold: the loop resumes from there
        gamma0 = np.asarray(j_ops.estep_pallas_sweeps(
            JConfig(**dict(kw, estep_max_iters=5)), jnp.asarray(eb),
            jnp.asarray(ids), jnp.asarray(cnts)).gamma)
    want = j_ops.estep_pallas_sweeps(
        jcfg, jnp.asarray(eb), jnp.asarray(ids), jnp.asarray(cnts),
        None if gamma0 is None else jnp.asarray(gamma0))
    before = ops.HOST_SYNCS["estep_cuda_sweeps"]
    got = ops.estep_cuda_sweeps(tcfg, _t(eb), _t(ids), _t(cnts),
                                None if gamma0 is None else _t(gamma0))
    assert int(got.iters) == int(want.iters) < 100
    # one host read of the stopping rule per sweep (none at the cap)
    assert ops.HOST_SYNCS["estep_cuda_sweeps"] - before == int(got.iters)
    _close(got.gamma, want.gamma, 1e-4, 1e-4)
    _close(got.pi, want.pi, 1e-4, 1e-4)
    _close(got.sstats, want.sstats, 1e-3, 1e-3)


def test_estep_sweeps_stops_at_the_cap():
    ids, cnts, eb, vocab = _tiny_batch(8)
    kw = dict(num_topics=8, vocab_size=vocab, estep_max_iters=3)
    want = j_ops.estep_pallas_sweeps(JConfig(**kw), jnp.asarray(eb),
                                     jnp.asarray(ids), jnp.asarray(cnts))
    got = ops.estep_cuda_sweeps(LDAConfig(**kw), _t(eb), _t(ids), _t(cnts))
    assert int(got.iters) == int(want.iters) == 3
    _close(got.gamma, want.gamma, 1e-4, 1e-4)


def _onehot_inputs(seed, b, l, v, k):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, v, (b, l)).astype(np.int32),
            rng.poisson(1.0, (b, l)).astype(np.float32),
            rng.gamma(1.0, 1.0, (b, l, k)).astype(np.float32),
            rng.gamma(1.0, 1.0, (b, k)).astype(np.float32),
            rng.random((b, l, k)).astype(np.float32))


@pytest.mark.parametrize("b,l,block_b", [
    (64, 32, 16),    # nb = 4: the multi-partial reduction path
    (32, 512, 32),   # the VMEM guard halves block_b (32 → 4 at L=512)
])
@pytest.mark.parametrize("quantize", [False, True])
def test_memo_delta_onehot_twin_matches_pallas_kernel(b, l, block_b,
                                                      quantize):
    v, k = 700, 128
    ids, cnts, ebt, et, opi = _onehot_inputs(b + l, b, l, v, k)
    assert b // lda_estep.delta_effective_block_b(
        b, l, k, block_b=block_b) >= 2          # the shapes must fan out
    want = j_kernels.memo_delta_onehot(
        jnp.asarray(ids), jnp.asarray(cnts), jnp.asarray(ebt),
        jnp.asarray(et), v, old_pi=jnp.asarray(opi), quantize=quantize,
        block_b=block_b, interpret=True)
    got = lda_estep.memo_delta_onehot(_t(ids), _t(cnts), _t(ebt), _t(et), v,
                                      old_pi=_t(opi), quantize=quantize,
                                      block_b=block_b)
    assert len(got) == 3
    # π rounded through bf16 may land one bf16 ulp apart where the fp32
    # values straddle a rounding boundary (tests/test_torch_estep.py)
    rtol = BF16_ULP if quantize else 1e-5
    _close(got[0], want[0], rtol, 1e-6)
    _close(got[1], want[1], max(rtol, 1e-4), 1e-4)
    _close(got[2], want[2], 1e-4, 1e-4)


def test_memo_delta_onehot_pi_equals_segment_pair_bitwise():
    """K8's twin and the segment-sum pair (K2 + K3 twins) form π with the
    same arithmetic: bit for bit with ``quantize``, masses to 1e-4."""
    b, l, v, k = 16, 48, 500, 64
    ids, cnts, _, et, opi = _onehot_inputs(9, b, l, v, k)
    eb = np.random.default_rng(10).gamma(1.0, 1.0, (v, k)).astype(np.float32)
    seg = lda_estep.memo_delta(_t(ids), _t(cnts), _t(eb), _t(et), v,
                               old_pi=_t(opi), quantize=True)
    one = lda_estep.memo_delta_onehot(_t(ids), _t(cnts), _t(eb[ids]), _t(et),
                                      v, old_pi=_t(opi), quantize=True)
    assert torch.equal(seg[0], one[0])
    _close(one[1], seg[1], 1e-4, 1e-4)
    _close(one[2], seg[2], 1e-4, 1e-4)


def test_memo_delta_onehot_without_old_pi():
    b, l, v, k = 8, 20, 90, 16
    ids, cnts, ebt, et, _ = _onehot_inputs(12, b, l, v, k)
    want = j_kernels.memo_delta_onehot(
        jnp.asarray(ids), jnp.asarray(cnts), jnp.asarray(ebt),
        jnp.asarray(et), v, interpret=True)
    got = lda_estep.memo_delta_onehot(_t(ids), _t(cnts), _t(ebt), _t(et), v)
    assert len(got) == len(want) == 2
    _close(got[0], want[0], 1e-5, 1e-6)
    _close(got[1], want[1], 1e-4, 1e-4)


def test_delta_effective_block_b_matches_repro():
    for b in (1, 4, 12, 32, 96, 128, 1024):
        for l in (8, 40, 64, 128, 163, 512, 1024, 8192):
            for k in (16, 100, 128):
                for has_old in (False, True):
                    assert lda_estep.delta_effective_block_b(
                        b, l, k, has_old=has_old) == \
                        j_kernels.delta_effective_block_b(
                            b, l, k, has_old=has_old), (b, l, k, has_old)
    # the Arxiv shape of the card run: 64 partials of B = 1024
    assert lda_estep.delta_effective_block_b(1024, 163, 100) == 16
    assert lda_estep.delta_effective_block_b(8, 16, 4, block_b=4,
                                             block_v=256) == 4


def test_memo_delta_onehot_refuses_a_ragged_b_tile():
    """B = 40 keeps the default B-tile of 32 (the step fits), which does not
    divide B: ``repro`` asserts, the port raises."""
    ids, cnts, ebt, et, _ = _onehot_inputs(13, 40, 8, 50, 16)
    assert lda_estep.delta_effective_block_b(40, 8, 16, has_old=False) == 32
    with pytest.raises(ValueError, match="does not divide"):
        lda_estep.memo_delta_onehot(_t(ids), _t(cnts), _t(ebt), _t(et), 50)
    with pytest.raises(ValueError, match="expected shape"):
        lda_estep.memo_delta_onehot(_t(ids), _t(cnts), _t(ebt[:, :, :4]),
                                    _t(et), 50)
