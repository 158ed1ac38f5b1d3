"""Port parity, E-step: the gather and dense backends, the three kernels'
plain twins and the CUDA backend's correction, held against ``repro`` (its
Pallas kernels in interpret mode) on the same numpy inputs.

Tolerances are ``tests/test_estep_backend.py``'s where a backend is held
against another (γ 2e-3, π 2e-3 / 1e-4, sstats 1e-2 / 2e-3, correction
2e-3): the fixed points stop at a mean |Δγ| of ``estep_tol``, so γ agrees
to about that and not to fp32 rounding. A kernel's plain twin held against
its Pallas kernel does the same arithmetic, so π and the scatter are held at
1e-5; bf16-rounded π may land one bf16 ulp apart (2^-7 relative) where the
fp32 values straddle a rounding boundary.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.estep import BowBatch as JBatch
from repro.core.estep import densify as j_densify
from repro.core.estep import get_backend as j_get_backend
from repro.core.math import exp_dirichlet_expectation as j_eb
from repro.core.types import LDAConfig as JConfig
from repro.data.bow import corpus_from_docs as j_corpus_from_docs
from repro.kernels import lda_estep as j_kernels
from repro.kernels import ops as j_ops
from repro_torch.core.estep import BowBatch, get_backend
from repro_torch.core.types import LDAConfig
from repro_torch.kernels import lda_estep, ops

CPU = "cpu"
BF16_ULP = 2.0 ** -7


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


def _inputs(seed, b=12, vocab=200, k=7, mean_len=25):
    """A ragged batch plus Eφ, as numpy arrays both packages take."""
    rng = np.random.default_rng(seed)
    docs = [rng.integers(0, vocab, size=max(2, int(rng.poisson(mean_len))))
            for _ in range(b)]
    corpus = j_corpus_from_docs(docs, vocab)
    lam = rng.gamma(100.0, 0.01, (vocab, k)).astype(np.float32)
    eb = np.asarray(j_eb(jnp.asarray(lam), axis=0))
    return (np.asarray(corpus.token_ids), np.asarray(corpus.counts), eb,
            vocab, k)


def _configs(vocab, k, **kw):
    return (JConfig(num_topics=k, vocab_size=vocab, estep_max_iters=50, **kw),
            LDAConfig(num_topics=k, vocab_size=vocab, estep_max_iters=50,
                      **kw))


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("backend", ["gather", "dense"])
@pytest.mark.parametrize("seed", [0, 3])
def test_backend_solve_matches_repro(backend, seed):
    ids, cnts, eb, vocab, k = _inputs(seed)
    jcfg, tcfg = _configs(vocab, k)
    want = j_get_backend(backend).solve(
        jcfg, jnp.asarray(eb), JBatch(jnp.asarray(ids), jnp.asarray(cnts)))
    got = get_backend(backend).solve(tcfg, _t(eb), BowBatch(_t(ids), _t(cnts)))
    _close(got.gamma, want.gamma, 2e-3, 2e-3)
    _close(got.pi, want.pi, 2e-3, 1e-4)
    _close(got.sstats, want.sstats, 1e-2, 2e-3)
    assert abs(int(got.iters) - int(want.iters)) <= 1


@pytest.mark.parametrize("backend,reference", [
    ("gather", "gather"), ("dense", "dense"), ("cuda", "pallas")])
def test_backend_correction_matches_repro(backend, reference):
    ids, cnts, eb, vocab, k = _inputs(1)
    jcfg, tcfg = _configs(vocab, k)
    rng = np.random.default_rng(1)
    base = np.asarray(j_get_backend("gather").solve(
        jcfg, jnp.asarray(eb), JBatch(jnp.asarray(ids), jnp.asarray(cnts))).pi)
    visited = rng.random(ids.shape[0]) < 0.5
    old_pi = np.where(visited[:, None, None], base, 0.0).astype(np.float32)
    want = j_get_backend(reference).solve_correction(
        jcfg, jnp.asarray(eb), JBatch(jnp.asarray(ids), jnp.asarray(cnts)),
        jnp.asarray(old_pi), jnp.asarray(visited))
    got = get_backend(backend).solve_correction(
        tcfg, _t(eb), BowBatch(_t(ids), _t(cnts)), _t(old_pi), _t(visited))
    _close(got[0], want[0], 2e-3, 2e-3)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-6)
    _close(got[2].pi, want[2].pi, 2e-3, 1e-4)
    _close(got[2].gamma, want[2].gamma, 2e-3, 2e-3)
    _close(got[2].sstats, want[2].sstats, 1e-2, 2e-3)


def test_fixed_point_twin_matches_pallas_kernel():
    """K1's plain twin against the Pallas fixed point: B = 300 is three
    stopping tiles of 128, the last ragged (44 rows). γ and Eθ at 2e-3 and
    the per-tile sweep counts equal or at most 1 apart (a tile's mean |Δγ|
    summed in another order can cross ``tol`` one sweep earlier or later).
    """
    ids, cnts, eb, vocab, k = _inputs(7, b=300, vocab=160, k=12, mean_len=20)
    alpha0, tol, max_iters = 0.5, 1e-2, 60
    # tile 0 starts at its own fixed point and stops after one sweep; the
    # other tiles start fresh and stop on their own later sweeps
    gamma0 = np.full((300, k), alpha0 + 1.0, np.float32)
    gamma0[:128] = lda_estep.estep_fixed_point(
        _t(ids[:128]), _t(cnts[:128]), _t(eb), _t(gamma0[:128]), alpha0,
        tol / 100, 1000)[0].numpy()
    c = j_densify(jnp.asarray(ids), jnp.asarray(cnts), vocab)
    cpad, ebpad, _ = j_ops.pad_inputs(c, jnp.asarray(eb), 128, 512)
    gpad = jnp.pad(jnp.asarray(gamma0),
                   ((0, cpad.shape[0] - 300), (0, ebpad.shape[1] - k)),
                   constant_values=alpha0)
    jg, jet, jit = j_kernels.estep_fixed_point(
        cpad, ebpad, gpad, alpha0, tol, max_iters, k_real=k, b_real=300,
        block_b=128, block_v=512, interpret=True)
    g, et, iters = lda_estep.estep_fixed_point(
        _t(ids), _t(cnts), _t(eb), _t(gamma0), alpha0, tol, max_iters,
        block_b=128)
    _close(g, np.asarray(jg)[:300, :k], 2e-3, 2e-3)
    _close(et, np.asarray(jet)[:300, :k], 2e-3, 2e-3)
    want_iters = np.asarray(jit)[:, 0]
    assert iters.shape == (3,)
    assert np.abs(iters.numpy() - want_iters).max() <= 1, (iters, want_iters)
    assert want_iters[0] < want_iters[1] < max_iters   # the tiles differ


@pytest.mark.parametrize("k", [9, 101, 400])
@pytest.mark.parametrize("with_old", [False, True])
@pytest.mark.parametrize("quantize", [False, True])
def test_memo_delta_twins_match_pallas_kernels(with_old, quantize, k):
    """K2 (token π) and K3 (segment scatter) twins against ``memo_delta``,
    at K below one warp, at K % 4 != 0 (K2's scalar span tail) and above
    256 topics (K2's wide body)."""
    ids, cnts, eb, vocab, k = _inputs(11, b=24, vocab=150, k=k)
    rng = np.random.default_rng(11)
    et = rng.gamma(1.0, 1.0, (24, k)).astype(np.float32)
    old_pi = rng.random(ids.shape + (k,)).astype(np.float32)
    jout = j_kernels.memo_delta(
        jnp.asarray(ids), jnp.asarray(cnts), jnp.asarray(eb)[ids],
        jnp.asarray(et), vocab,
        old_pi=jnp.asarray(old_pi) if with_old else None, quantize=quantize,
        interpret=True)
    tout = lda_estep.memo_delta(_t(ids), _t(cnts), _t(eb), _t(et), vocab,
                                old_pi=_t(old_pi) if with_old else None,
                                quantize=quantize)
    assert len(tout) == len(jout) == (3 if with_old else 2)
    rtol = BF16_ULP if quantize else 1e-5
    _close(tout[0], jout[0], rtol, 1e-6)
    for got, want in zip(tout[1:], jout[1:]):
        _close(got, want, rtol, 1e-5)
    if quantize:
        pi = tout[0]
        assert torch.equal(pi, pi.to(torch.bfloat16).to(torch.float32))
    assert not bool((tout[0][_t(cnts) == 0] != 0).any())


def test_segment_scatter_twin_sums_in_float64():
    """K3's twin against an fp64 sum on rows with repeated ids."""
    rng = np.random.default_rng(2)
    n, k, vocab = 400, 5, 30
    ids = rng.integers(0, vocab, n).astype(np.int32)
    cnts = rng.integers(0, 4, n).astype(np.float32)
    pi_new = rng.random((n, k)).astype(np.float32)
    pi_old = rng.random((n, k)).astype(np.float32)
    s_new, s_old = lda_estep.segment_scatter(_t(ids), _t(cnts), _t(pi_new),
                                             _t(pi_old), vocab)
    for got, pi in ((s_new, pi_new), (s_old, pi_old)):
        want = np.zeros((vocab, k))
        np.add.at(want, ids, cnts[:, None].astype(np.float64) * pi)
        _close(got, want, 1e-5, 1e-5)


@pytest.mark.parametrize("case", ["padded", "all_dead", "last_id"])
def test_scatter_segments_match_plain_preparation(case):
    """K3's fixed-size preparation (one stable sort of every row's key, a
    sorted search per id) against the twin's (``nonzero``, stable sort,
    ``unique_consecutive``): for every id the same rows in the same order,
    and an empty range for every id no live row carries. ``padded``: rows
    of a padded batch (each row's tail has count 0, one row is padding
    only); ``all_dead``: every count 0; ``last_id``: id V − 1 carried by
    several rows."""
    ids, cnts, _, vocab, _ = _inputs(12, b=10, vocab=60, mean_len=15)
    ids, cnts = _t(ids), _t(cnts)
    if case == "padded":
        cnts[3] = 0.0
    elif case == "all_dead":
        cnts.zero_()
    else:
        ids[::2, 0] = vocab - 1
        cnts[::2, 0] = 2.0
    flat_ids, flat_cnts = ids.reshape(-1), cnts.reshape(-1)
    order, seg_off = lda_estep.scatter_segments(flat_ids, flat_cnts, vocab)
    assert order.shape == flat_ids.shape and seg_off.shape == (vocab + 1,)
    assert order.dtype == seg_off.dtype == torch.int64
    p_order, seg_ids, _, p_off = lda_estep.scatter_segments_plain(flat_ids,
                                                                  flat_cnts)
    want = {int(v): p_order[p_off[i]:p_off[i + 1]]
            for i, v in enumerate(seg_ids)}
    for v in range(vocab):
        got = order[seg_off[v]:seg_off[v + 1]]
        if v in want:
            assert torch.equal(got, want[v]), v
        else:
            assert got.numel() == 0, v
    assert int(seg_off[-1]) == int((flat_cnts != 0).sum())
    if case == "last_id":
        assert vocab - 1 in want and want[vocab - 1].numel() >= 5
    if case == "all_dead":
        assert not want and int(seg_off.max()) == 0


def test_memo_correction_cuda_matches_pallas():
    """``memo_correction_cuda`` (plain twins on CPU tensors) against
    ``repro.kernels.ops.memo_correction_pallas``."""
    ids, cnts, eb, vocab, k = _inputs(4, b=20)
    jcfg, tcfg = _configs(vocab, k)
    rng = np.random.default_rng(4)
    visited = rng.random(ids.shape[0]) < 0.5
    old_pi = (rng.random(ids.shape + (k,)) * visited[:, None, None]
              * (cnts > 0)[:, :, None]).astype(np.float32)
    old_pi /= np.maximum(old_pi.sum(-1, keepdims=True), 1e-30)
    wc, ww, wres = j_ops.memo_correction_pallas(
        jcfg, jnp.asarray(eb), jnp.asarray(ids), jnp.asarray(cnts),
        jnp.asarray(old_pi), jnp.asarray(visited))
    gc, gw, gres = ops.memo_correction_cuda(
        tcfg, _t(eb), _t(ids), _t(cnts), _t(old_pi), _t(visited))
    _close(gc, wc, 2e-3, 2e-3)
    np.testing.assert_allclose(float(gw), float(ww), rtol=1e-6)
    _close(gres.gamma, wres.gamma, 2e-3, 2e-3)
    _close(gres.pi, wres.pi, 2e-3, 1e-4)
    _close(gres.sstats, wres.sstats, 1e-2, 2e-3)
    assert int(gres.iters) == int(wres.iters)


def _count_257_inputs(seed):
    """``_inputs``'s documents with a count of 257 in row 0, which bf16
    rounds to 256, and Eφ from peaked topics, so the fixed point stops
    well before its cap."""
    ids, cnts, _, vocab, k = _inputs(seed, b=20)
    cnts = cnts.copy()
    cnts[0, 0] = 257.0
    rng = np.random.default_rng(seed)
    lam = (rng.gamma(0.3, 2.0, (vocab, k)) + 0.05).astype(np.float32)
    eb = np.asarray(j_eb(jnp.asarray(lam), axis=0))
    return ids, cnts, eb, vocab, k


def _old_pi(ids, cnts, k, seed):
    rng = np.random.default_rng(seed)
    visited = rng.random(ids.shape[0]) < 0.5
    old_pi = (rng.random(ids.shape + (k,)) * visited[:, None, None]
              * (cnts > 0)[:, :, None]).astype(np.float32)
    old_pi /= np.maximum(old_pi.sum(-1, keepdims=True), 1e-30)
    return old_pi, visited


@pytest.mark.parametrize("entry", ["estep", "correction"])
def test_bf16_stream_matches_repro(entry):
    """``estep_stream_dtype="bfloat16"``: ``estep_cuda`` and
    ``memo_correction_cuda`` (plain twins on CPU tensors) against
    ``repro``'s ``estep_pallas`` / ``memo_correction_pallas`` under the
    same config (Eφ and the dense counts streamed as bf16, fp32
    arithmetic, π from the fp32 Eφ): γ, π and the correction at 2e-3 and
    the same sweep count, γ also at 2e-4. Row 0 carries a count of 257,
    which bf16 rounds to 256: the fp32 stream's γ of that row lies well
    outside the bar, and its γ fails the 2e-3 comparison with ``repro``
    that the bf16 stream passes."""
    ids, cnts, eb, vocab, k = _count_257_inputs(5)
    jcfg, tcfg = _configs(vocab, k, estep_stream_dtype="bfloat16")
    f32cfg = _configs(vocab, k)[1]
    jargs = (jnp.asarray(eb), jnp.asarray(ids), jnp.asarray(cnts))
    targs = (_t(eb), _t(ids), _t(cnts))
    if entry == "estep":
        want = j_ops.estep_pallas(jcfg, *jargs)
        got = ops.estep_cuda(tcfg, *targs)
        fp32 = ops.estep_cuda(f32cfg, *targs)
    else:
        old_pi, visited = _old_pi(ids, cnts, k, 5)
        wc, _, want = j_ops.memo_correction_pallas(
            jcfg, *jargs, jnp.asarray(old_pi), jnp.asarray(visited))
        gc, _, got = ops.memo_correction_cuda(tcfg, *targs, _t(old_pi),
                                              _t(visited))
        _close(gc, wc, 2e-3, 2e-3)
        fp32 = ops.memo_correction_cuda(f32cfg, *targs, _t(old_pi),
                                        _t(visited))[2]
    _close(got.gamma, want.gamma, 2e-3, 2e-3)
    _close(got.pi, want.pi, 2e-3, 1e-4)
    _close(got.sstats, want.sstats, 1e-2, 2e-3)
    assert int(got.iters) == int(want.iters) < tcfg.estep_max_iters
    assert float((fp32.gamma[0] - got.gamma[0]).abs().max()) > 0.5
    _close(got.gamma, want.gamma, 2e-4, 2e-4)
    assert not np.allclose(fp32.gamma, want.gamma, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("stream_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantize", [False, True])
def test_fused_fixed_point_pi_is_token_pi(stream_dtype, quantize):
    """K1 with its π finish (``estep_fixed_point_pi``): γ, Eθ and the tile
    sweeps are ``estep_fixed_point``'s, and π is ``token_pi_plain``'s on
    that Eθ with the fp32 Eφ and counts, exactly (two stopping tiles)."""
    ids, cnts, eb, vocab, k = _count_257_inputs(6)
    ids, cnts = np.tile(ids, (8, 1)), np.tile(cnts, (8, 1))     # B = 160
    gamma0 = torch.full((ids.shape[0], k), 1.5)
    args = (_t(ids), _t(cnts), _t(eb), gamma0, 0.5, 1e-4, 50)
    g, et, it, pi = lda_estep.estep_fixed_point_pi(
        *args, stream_dtype=stream_dtype, quantize=quantize)
    alone = lda_estep.estep_fixed_point(*args, stream_dtype=stream_dtype)
    assert it.shape == (2,)
    for x, y in zip((g, et, it), alone):
        assert torch.equal(x, y)
    assert torch.equal(pi, lda_estep.token_pi_plain(
        _t(ids), _t(cnts), _t(eb), et, quantize=quantize))
    with pytest.raises(ValueError, match="unknown estep_stream_dtype"):
        lda_estep.estep_fixed_point_pi(*args, stream_dtype="float16")


def test_cuda_backend_refuses_what_it_does_not_implement():
    ids, cnts, eb, vocab, k = _inputs(0)
    tcfg = LDAConfig(num_topics=k, vocab_size=vocab,
                     estep_stream_dtype="float16")
    with pytest.raises(ValueError, match="unknown estep_stream_dtype"):
        get_backend("cuda").solve(tcfg, _t(eb), BowBatch(_t(ids), _t(cnts)))
    old_pi = torch.zeros(ids.shape + (k,))
    visited = torch.zeros(ids.shape[0], dtype=torch.bool)
    with pytest.raises(ValueError, match="pi_dtype"):
        ops.memo_correction_cuda(LDAConfig(num_topics=k, vocab_size=vocab),
                                 _t(eb), _t(ids), _t(cnts), old_pi, visited,
                                 pi_dtype="float16")
    with pytest.raises(TypeError):
        lda_estep.token_pi(_t(ids).long(), _t(cnts), _t(eb),
                           torch.ones(ids.shape[0], k))
    # K3's bare launch has no plain twin: on CPU tensors it refuses
    flat_ids, flat_cnts = _t(ids).reshape(-1), _t(cnts).reshape(-1)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        lda_estep.segment_scatter_prepared(
            lda_estep.scatter_segments(flat_ids, flat_cnts, vocab),
            flat_cnts, torch.ones(flat_ids.numel(), k), None, vocab)
