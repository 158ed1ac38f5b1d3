"""Port parity, the CSR slice: the flat-token kernels' plain twins (K4 fixed
point, K5 token π) and ``memo_delta_csr`` against ``repro``'s Pallas CSR
kernels in interpret mode, the flat-token E-step contract, the ``csr``
backend against ``gather``, and the CSR stream engine against ``repro``'s
and against the port's own padded engine.

Tolerances, as in ``tests/test_torch_estep.py``: a fixed point stops at a
mean |Δγ| of ``estep_tol``, so γ is held at 2e-3 (the bar of ``repro``'s
backend tests); both CSR fixed points stop batch-wide, so their sweep
counts are held equal. A twin held against its Pallas kernel does the same
arithmetic in another order: π at 1e-6 (one bf16 ulp when rounded through
bf16), Eθ at 1e-5. λ across whole epochs is held at rtol/atol 1e-3, as
``tests/test_torch_engine.py`` holds the padded path.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LDAConfig as JConfig
from repro.core import LDAEngine as JEngine
from repro.core.math import exp_dirichlet_expectation as j_eb
from repro.core.types import init_global_state as j_init_global_state
from repro.data import PAPER_CORPORA as J_CORPORA
from repro.data import make_corpus as j_make_corpus
from repro.data import stream as j_stream
from repro.kernels import lda_estep as j_kernels
from repro.kernels import ops as j_ops
from repro_torch.convert import state_from_numpy
from repro_torch.core.bound import elbo_memoized_store
from repro_torch.core.engines import LDAEngine
from repro_torch.core.estep import (BowBatch, CSRBackend, CSRTokenBatch,
                                    estep_csr_ref, get_backend)
from repro_torch.core.types import LDAConfig
from repro_torch.data.bow import corpus_from_docs
from repro_torch.data.stream import BatchPacker, CorpusDocStream, materialize
from repro_torch.data.synthetic import PAPER_CORPORA, make_corpus
from repro_torch.kernels import lda_estep, ops

j_estep = importlib.import_module("repro.core.estep")

CPU = "cpu"
BF16_ULP = 2.0 ** -7
STATE_FIELDS = ("lam", "m_vk", "init_mass", "init_frac", "t")


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _flat_batch(seed, n_docs=17, vocab=300, k=6, budget=512, max_len=40):
    """One CSR batch packed from ragged documents (empty and single-token
    documents included, tail padding), plus Eφ: numpy arrays both packages
    take."""
    rng = np.random.default_rng(seed)
    packer = BatchPacker(n_docs, layout="csr", token_budget=budget)
    lengths = rng.integers(2, max_len, n_docs)
    lengths[[2, 9]] = 0
    lengths[[4, 11]] = 1
    batch = None
    for pos, n in enumerate(lengths):
        ids = np.sort(rng.choice(vocab, size=int(n), replace=False))
        cnts = (rng.poisson(1.0, int(n)) + 1).astype(np.float32)
        batch = packer.add(pos, ids.astype(np.int32), cnts)
    assert batch is not None and batch.live_tokens < budget
    # peaked topics, so a fixed point stops well before its cap
    lam = (rng.gamma(0.3, 2.0, (vocab, k)) + 0.05).astype(np.float32)
    eb = np.asarray(j_eb(jnp.asarray(lam), axis=0))
    return batch, eb


def _configs(vocab, k, **kw):
    kw.setdefault("estep_max_iters", 50)
    return (JConfig(num_topics=k, vocab_size=vocab, **kw),
            LDAConfig(num_topics=k, vocab_size=vocab, **kw))


# ---------------------------------------------------------------------------
# K4: the CSR fixed point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start", ["cold", "warm", "phantom"])
def test_csr_fixed_point_twin_matches_pallas_kernel(start):
    """K4's twin against ``repro``'s CSR fixed point: γ at 2e-3, Eθ at 1e-5
    and the same batch-wide sweep count. ``warm`` starts from γ after a
    few sweeps; ``phantom`` pads the document axis to 24 with fresh rows
    that own no token, which count in the batch-wide mean (each adds
    |α₀ − (α₀ + 1)| = 1 per topic to the first sweep's sum)."""
    batch, eb = _flat_batch(3)
    k, vocab = eb.shape[1], eb.shape[0]
    jcfg, _ = _configs(vocab, k, estep_tol=1e-3)
    b = batch.num_docs if start != "phantom" else 24
    gamma0 = np.full((b, k), jcfg.alpha0 + 1.0, np.float32)
    args = (_t(batch.token_ids), _t(batch.counts), _t(batch.segments),
            _t(eb))
    if start == "warm":
        gamma0 = lda_estep.estep_fixed_point_csr(
            *args, _t(gamma0), jcfg.alpha0, 0.0, 4)[0].numpy()
    jg, jet, _, jit = j_ops._run_fixed_point_csr(
        jcfg, jnp.asarray(eb), jnp.asarray(batch.token_ids),
        jnp.asarray(batch.counts), jnp.asarray(batch.segments), b,
        jnp.asarray(gamma0), 512)
    g, et, iters = lda_estep.estep_fixed_point_csr(
        *args, _t(gamma0), jcfg.alpha0, jcfg.estep_tol,
        jcfg.estep_max_iters)
    assert iters.shape == (1,) and iters.dtype == torch.int32
    assert int(iters[0]) == int(jit) < jcfg.estep_max_iters
    _close(g, jg, 2e-3, 2e-3)
    _close(et, jet, 1e-5, 1e-5)
    if start == "phantom":     # rows that own no token end at α₀
        assert torch.all(g[batch.num_docs:] == jcfg.alpha0)


def _warp_sum(v):
    """The card's butterfly over the last axis of 32 lanes (xor 16, 8, 4,
    2, 1); every lane ends with the same bits, lane 0's are returned."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ o]
    return v[..., 0]


def _lane_sums(x):
    """Lane l's running sum of x[l], x[l + 32], ... in that order, over the
    last axis (zero-padded to a multiple of 32), then the butterfly."""
    pad = (-x.shape[-1]) % 32
    x = torch.nn.functional.pad(x, (0, pad)).unflatten(-1, (-1, 32))
    s = torch.zeros(x.shape[:-2] + (32,))
    for j in range(x.shape[-2]):
        s = s + x[..., j, :]
    return _warp_sum(s)


def _k4_order(ids, cnts, segs, eb, gamma0, alpha0, tol, max_iters):
    """The card's K4 order of summation, in fp32 torch: W warps per
    document from ceil(T / B), warp p summing the live slots at positions
    p, p + W, ... of its document's range of ``csr_doc_ranges``'s order
    (stream order); the W partial vectors
    added in warp order; each row's |Δγ| summed lane by lane; the batch
    mean from 128-row chunk sums (lanes strided over the chunk, one
    butterfly) added in chunk order. Returns (γ, sweeps, W)."""
    b, k = gamma0.shape
    t = ids.numel()
    rows_per_doc = -(-t // b)
    w = 1
    while w < 8 and w * 48 < rows_per_doc:
        w *= 2
    order, offsets = lda_estep.csr_doc_ranges(cnts, segs, b)
    owner = segs.long()
    live = cnts != 0
    rank = torch.empty(t, dtype=torch.int64)     # each slot's place in order
    rank[order] = torch.arange(t)
    warp = (rank - offsets[owner.clamp(0, b - 1)]) % w
    ebt = eb[ids.long()]
    g, n = gamma0, 0
    while n < max(int(max_iters), 1):
        et = lda_estep._exp_elog_theta(g)
        ratio = cnts / ((et[owner] * ebt).sum(-1) + 1e-30)
        part = torch.zeros(w * b, k).index_add_(
            0, (warp * b + owner)[live], (ratio[:, None] * ebt)[live])
        acc = part[:b]
        for p in range(1, w):
            acc = acc + part[p * b:(p + 1) * b]
        g_new = alpha0 + et * acc
        slots = _lane_sums((g_new - g).abs())
        total = torch.zeros(())
        for c in range(0, b, 128):
            total = total + _lane_sums(slots[c:c + 128])
        g, n = g_new, n + 1
        if bool(total / torch.tensor(float(b * k)) <= torch.tensor(tol)):
            break
    return g, n, w


@pytest.mark.parametrize("start,budget,n_docs,max_len,want_w", [
    ("cold", 512, 17, 40, 1), ("phantom", 512, 17, 40, 1),
    ("cold", 2048, 17, 40, 4), ("phantom", 2048, 17, 40, 2),
    ("cold", 4096, 300, 12, 1), ("shuffled", 2048, 17, 40, 4)])
def test_k4_order_matches_pallas_kernel(start, budget, n_docs, max_len,
                                        want_w):
    """The card's K4 order of summation (``_k4_order``) against ``repro``'s
    CSR fixed point: γ at 2e-3 and the same batch-wide sweep count, with
    W = 1, 2 and 4 warps per document, phantom rows (7 more documents that
    own no token), at 300 documents a mean taken over three 128-row
    chunks, and on a stream shuffled slot by slot (both sides fed the same
    shuffled stream)."""
    batch, eb = _flat_batch(3, n_docs=n_docs, budget=budget, max_len=max_len)
    k, vocab = eb.shape[1], eb.shape[0]
    jcfg, _ = _configs(vocab, k, estep_tol=1e-3)
    b = batch.num_docs + (7 if start == "phantom" else 0)
    gamma0 = np.full((b, k), jcfg.alpha0 + 1.0, np.float32)
    flat = (batch.token_ids, batch.counts, batch.segments)
    if start == "shuffled":
        perm = np.random.default_rng(3).permutation(budget)
        flat = tuple(a[perm] for a in flat)
    jg, _, _, jit = j_ops._run_fixed_point_csr(
        jcfg, jnp.asarray(eb), *map(jnp.asarray, flat), b,
        jnp.asarray(gamma0), 512)
    g, sweeps, w = _k4_order(
        *map(_t, flat), _t(eb), _t(gamma0), jcfg.alpha0, jcfg.estep_tol,
        jcfg.estep_max_iters)
    assert w == want_w
    assert sweeps == int(jit) < jcfg.estep_max_iters
    _close(g, jg, 2e-3, 2e-3)


def test_csr_fixed_point_caps_sweeps():
    batch, eb = _flat_batch(4)
    gamma0 = torch.full((batch.num_docs, eb.shape[1]), 1.5)
    args = (_t(batch.token_ids), _t(batch.counts), _t(batch.segments),
            _t(eb), gamma0, 0.5, 0.0)
    assert int(lda_estep.estep_fixed_point_csr(*args, 7)[2][0]) == 7
    assert int(lda_estep.estep_fixed_point_csr(*args, 0)[2][0]) == 1


def test_csr_order_check_raises_on_shuffled_stream():
    """The twin's precondition: it holds on every packer and ``flatten``
    output and fails on a shuffled stream."""
    batch, eb = _flat_batch(5)
    counts, segs = _t(batch.counts), _t(batch.segments)
    lda_estep.check_csr_order(counts, segs, batch.num_docs)
    ids = torch.from_numpy(batch.token_ids).reshape(8, 64)
    cnts = counts.reshape(8, 64)
    flat = CSRBackend.flatten(BowBatch(ids, cnts))
    lda_estep.check_csr_order(flat.counts, flat.segments, 8)
    perm = torch.from_numpy(np.random.default_rng(0).permutation(len(segs)))
    gamma0 = torch.full((batch.num_docs, eb.shape[1]), 1.5)
    with pytest.raises(ValueError, match="grouped by segment"):
        lda_estep.check_csr_order(counts[perm], segs[perm], batch.num_docs)
    grouped = lda_estep.estep_fixed_point_csr(
        _t(batch.token_ids), counts, segs, _t(eb), gamma0, 0.5, 1e-3, 10)
    shuffled = lda_estep.estep_fixed_point_csr(
        _t(batch.token_ids)[perm], counts[perm], segs[perm], _t(eb),
        gamma0, 0.5, 1e-3, 10)
    _close(shuffled[0], grouped[0], 1e-5, 1e-5)
    with pytest.raises(ValueError, match="outside"):
        lda_estep.check_csr_order(counts, segs, batch.num_docs - 1)


def test_csr_doc_offsets_cut_each_documents_range():
    """K4's document ranges (``csr_doc_ranges``): on the packer's layout
    (tail padding, three phantom rows) the offsets are the packer's and the
    live part of the order is the identity; on ``flatten``'s (padding
    inside each row, empty rows in the middle and at the end) each range
    holds its row's live slots in stream order, and every count-0 slot
    follows the last range, in stream order."""
    batch, _ = _flat_batch(6)
    order, got = lda_estep.csr_doc_ranges(_t(batch.counts),
                                          _t(batch.segments), 20)
    want = np.concatenate([batch.offsets,
                           np.full(20 - batch.num_docs, batch.live_tokens)])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(order.numpy(),
                                  np.arange(len(batch.counts)))

    cnts = torch.zeros(5, 4)
    cnts[0, :2] = 1.0
    cnts[2, :3] = 2.0                      # rows 1, 3 and 4 are empty
    flat = CSRBackend.flatten(BowBatch(torch.zeros(5, 4, dtype=torch.int32),
                                       cnts))
    order, got = lda_estep.csr_doc_ranges(flat.counts, flat.segments, 5)
    np.testing.assert_array_equal(got.numpy(), [0, 2, 2, 5, 5, 5])
    np.testing.assert_array_equal(
        order.numpy(), [0, 1, 8, 9, 10, 2, 3, 4, 5, 6, 7, *range(11, 20)])


def test_csr_doc_ranges_leave_out_of_range_segments_uncovered():
    """A live token whose segment lies outside [0, B) is in no document's
    range: a negative segment sorts before the first range, one at or
    past B (70,000 included, which int16 keys could not hold unclamped)
    after the last, with the count-0 slots."""
    cnts = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0, 1.0])
    segs = torch.tensor([1, -3, 0, 70_000, 0, 1], dtype=torch.int32)
    order, offsets = lda_estep.csr_doc_ranges(cnts, segs, 2)
    np.testing.assert_array_equal(offsets.numpy(), [1, 2, 4])
    np.testing.assert_array_equal(order.numpy(), [1, 4, 0, 5, 2, 3])


# ---------------------------------------------------------------------------
# K5 and memo_delta_csr
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [6, 101, 400])
@pytest.mark.parametrize("with_old", [False, True])
@pytest.mark.parametrize("quantize", [False, True])
def test_memo_delta_csr_twins_match_pallas_kernels(with_old, quantize, k):
    """K5 (flat π) and K3 against ``repro``'s ``memo_delta_csr``: π at
    1e-6 (bf16: one ulp), S_new / S_old at 2e-3; at K below one warp, at
    K % 4 != 0 (K5's scalar span tail) and above 256 topics (K5's wide
    body)."""
    batch, eb = _flat_batch(7, k=k)
    k, vocab = eb.shape[1], eb.shape[0]
    rng = np.random.default_rng(7)
    et = rng.gamma(1.0, 1.0, (batch.num_docs, k)).astype(np.float32)
    old_pi = (rng.random((len(batch.token_ids), k)) *
              (batch.counts > 0)[:, None]).astype(np.float32)
    jout = j_kernels.memo_delta_csr(
        jnp.asarray(batch.token_ids), jnp.asarray(batch.counts),
        jnp.asarray(batch.segments), jnp.asarray(eb)[batch.token_ids],
        jnp.asarray(et), vocab,
        old_pi=jnp.asarray(old_pi) if with_old else None, quantize=quantize,
        interpret=True)
    tout = lda_estep.memo_delta_csr(
        _t(batch.token_ids), _t(batch.counts), _t(batch.segments), _t(eb),
        _t(et), vocab, old_pi=_t(old_pi) if with_old else None,
        quantize=quantize)
    assert len(tout) == len(jout) == (3 if with_old else 2)
    if quantize:
        _close(tout[0], jout[0], BF16_ULP, 1e-38)
        assert torch.equal(tout[0], tout[0].to(torch.bfloat16).float())
    else:
        _close(tout[0], jout[0], 0.0, 1e-6)
    for got, want in zip(tout[1:], jout[1:]):
        _close(got, want, 2e-3, 2e-3)
    assert not bool((tout[0][_t(batch.counts) == 0] != 0).any())


def test_memo_correction_cuda_csr_matches_pallas():
    """``memo_correction_cuda_csr`` (plain twins on CPU tensors) against
    ``repro.kernels.ops.memo_correction_pallas_csr``, with phantom rows."""
    batch, eb = _flat_batch(8)
    k, vocab = eb.shape[1], eb.shape[0]
    jcfg, tcfg = _configs(vocab, k)
    rng = np.random.default_rng(8)
    b = batch.num_docs + 3
    visited = rng.random(b) < 0.5
    seg_visited = visited[batch.segments] & (batch.counts > 0)
    old_pi = rng.random((len(batch.token_ids), k)) * seg_visited[:, None]
    old_pi = (old_pi / np.maximum(old_pi.sum(-1, keepdims=True), 1e-30)
              ).astype(np.float32)
    args = (batch.token_ids, batch.counts, batch.segments, old_pi, visited)
    wc, ww, wres = j_ops.memo_correction_pallas_csr(
        jcfg, jnp.asarray(eb), *map(jnp.asarray, args))
    gc, gw, gres = ops.memo_correction_cuda_csr(tcfg, _t(eb),
                                                *map(_t, args))
    _close(gc, wc, 2e-3, 2e-3)
    assert float(gw) == float(ww)
    _close(gres.gamma, wres.gamma, 2e-3, 2e-3)
    _close(gres.pi, wres.pi, 2e-3, 1e-4)
    assert int(gres.iters) == int(wres.iters)
    with pytest.raises(ValueError, match="pi_dtype"):
        ops.memo_correction_cuda_csr(tcfg, _t(eb), *map(_t, args),
                                     pi_dtype="float16")


def _shuffled(batch, seed):
    """The batch's flat stream permuted slot by slot: live tokens no longer
    grouped by segment, padding interleaved."""
    perm = np.random.default_rng(seed).permutation(len(batch.token_ids))
    return tuple(a[perm] for a in (batch.token_ids, batch.counts,
                                   batch.segments))


def _correction_inputs(batch, k, seed, b):
    rng = np.random.default_rng(seed)
    visited = rng.random(b) < 0.5
    seg_visited = visited[batch.segments] & (batch.counts > 0)
    old_pi = rng.random((len(batch.token_ids), k)) * seg_visited[:, None]
    old_pi = (old_pi / np.maximum(old_pi.sum(-1, keepdims=True), 1e-30)
              ).astype(np.float32)
    return old_pi, visited


def test_shuffled_stream_correction_matches_repro():
    """``memo_correction_cuda_csr`` on a stream shuffled slot by slot
    (``old_pi`` permuted with it), with phantom rows, against ``repro``'s
    ``memo_correction_pallas_csr`` on the same shuffled stream: the
    correction, γ and π at the bars of the grouped test, the same sweeps;
    and γ equal to the grouped stream's within 1e-5."""
    batch, eb = _flat_batch(12)
    k, vocab = eb.shape[1], eb.shape[0]
    jcfg, tcfg = _configs(vocab, k)
    b = batch.num_docs + 3
    old_pi, visited = _correction_inputs(batch, k, 12, b)
    perm = np.random.default_rng(12).permutation(len(batch.token_ids))
    args = (batch.token_ids[perm], batch.counts[perm], batch.segments[perm],
            old_pi[perm], visited)
    wc, ww, wres = j_ops.memo_correction_pallas_csr(
        jcfg, jnp.asarray(eb), *map(jnp.asarray, args))
    gc, gw, gres = ops.memo_correction_cuda_csr(tcfg, _t(eb),
                                                *map(_t, args))
    _close(gc, wc, 2e-3, 2e-3)
    assert float(gw) == float(ww)
    _close(gres.gamma, wres.gamma, 2e-3, 2e-3)
    _close(gres.pi, wres.pi, 2e-3, 1e-4)
    assert int(gres.iters) == int(wres.iters) < tcfg.estep_max_iters
    grouped = ops.memo_correction_cuda_csr(
        tcfg, _t(eb), _t(batch.token_ids), _t(batch.counts),
        _t(batch.segments), _t(old_pi), _t(visited))
    _close(gres.gamma, grouped[2].gamma, 1e-5, 1e-5)
    _close(gres.pi, grouped[2].pi[_t(perm)], 1e-5, 1e-6)


@pytest.mark.parametrize("entry", ["estep", "correction"])
def test_csr_bf16_stream_matches_repro(entry):
    """``estep_stream_dtype="bfloat16"`` on the flat layout:
    ``estep_cuda_csr`` / ``memo_correction_cuda_csr`` against ``repro``'s
    ``estep_pallas_csr`` / ``memo_correction_pallas_csr`` under the same
    config: only Eφ streams as bf16 (one token's count of 257 stays 257),
    fp32 arithmetic, π from the fp32 Eφ. γ, π and the correction at 2e-3,
    γ also at 2e-4, the same sweeps; the fp32 stream's γ fails the 2e-3
    comparison with ``repro`` that the bf16 stream passes."""
    batch, eb = _flat_batch(13)
    counts = batch.counts.copy()
    counts[0] = 257.0
    k, vocab = eb.shape[1], eb.shape[0]
    jcfg, tcfg = _configs(vocab, k, estep_stream_dtype="bfloat16")
    f32cfg = _configs(vocab, k)[1]
    b = batch.num_docs
    flat = (batch.token_ids, counts, batch.segments)
    jargs = (jnp.asarray(eb), *map(jnp.asarray, flat))
    targs = (_t(eb), *map(_t, flat))
    if entry == "estep":
        want = j_ops.estep_pallas_csr(jcfg, *jargs, num_docs=b)
        got = ops.estep_cuda_csr(tcfg, *targs, num_docs=b)
        fp32 = ops.estep_cuda_csr(f32cfg, *targs, num_docs=b)
    else:
        old_pi, visited = _correction_inputs(batch, k, 13, b)
        wc, _, want = j_ops.memo_correction_pallas_csr(
            jcfg, *jargs, jnp.asarray(old_pi), jnp.asarray(visited))
        gc, _, got = ops.memo_correction_cuda_csr(
            tcfg, *targs, _t(old_pi), _t(visited))
        _close(gc, wc, 2e-3, 2e-3)
        fp32 = ops.memo_correction_cuda_csr(f32cfg, *targs, _t(old_pi),
                                            _t(visited))[2]
    _close(got.gamma, want.gamma, 2e-3, 2e-3)
    _close(got.pi, want.pi, 2e-3, 1e-4)
    _close(got.sstats, want.sstats, 1e-2, 2e-3)
    assert int(got.iters) == int(want.iters) < tcfg.estep_max_iters
    assert float((fp32.gamma - got.gamma).abs().max()) > 2e-3
    _close(got.gamma, want.gamma, 2e-4, 2e-4)
    assert not np.allclose(fp32.gamma, want.gamma, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("stream_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantize", [False, True])
def test_fused_csr_fixed_point_pi_is_token_pi_csr(stream_dtype, quantize):
    """K4 with its π finish (``estep_fixed_point_csr_pi``) on a shuffled
    stream with phantom rows: γ, Eθ and the sweeps are
    ``estep_fixed_point_csr``'s, and π is ``token_pi_csr_plain``'s on that
    Eθ with the fp32 Eφ, exactly."""
    batch, eb = _flat_batch(14)
    flat = tuple(map(_t, _shuffled(batch, 14)))
    gamma0 = torch.full((batch.num_docs + 4, eb.shape[1]), 1.5)
    args = (*flat, _t(eb), gamma0, 0.5, 1e-3, 50)
    g, et, it, pi = lda_estep.estep_fixed_point_csr_pi(
        *args, stream_dtype=stream_dtype, quantize=quantize)
    alone = lda_estep.estep_fixed_point_csr(*args, stream_dtype=stream_dtype)
    for x, y in zip((g, et, it), alone):
        assert torch.equal(x, y)
    assert torch.equal(pi, lda_estep.token_pi_csr_plain(
        *flat, _t(eb), et, quantize=quantize))
    with pytest.raises(ValueError, match="unknown estep_stream_dtype"):
        lda_estep.estep_fixed_point_csr(*args, stream_dtype="float16")


@pytest.mark.parametrize("quantize", [False, True])
def test_fused_csr_fixed_point_drops_out_of_range_segments(quantize):
    """Live tokens whose segment is -1 or B (a shuffled stream, phantom
    rows) belong to no document, on the CPU as on the card and in
    ``repro``'s selector: γ, Eθ and the sweeps of
    ``estep_fixed_point_csr_pi`` equal those of the same stream with those
    tokens' counts set to 0, and their π rows are zero, the other rows
    equal."""
    batch, eb = _flat_batch(15)
    ids, cnts, segs = map(_t, _shuffled(batch, 15))
    b = batch.num_docs + 2
    live = torch.nonzero(cnts != 0).squeeze(1)
    outside = live[:6]
    segs = segs.clone()
    segs[outside[:3]] = -1
    segs[outside[3:]] = b
    dropped = cnts.clone()
    dropped[outside] = 0.0
    gamma0 = torch.full((b, eb.shape[1]), 1.5)
    tail = (_t(eb), gamma0, 0.5, 1e-3, 50)
    g, et, it, pi = lda_estep.estep_fixed_point_csr_pi(
        ids, cnts, segs, *tail, quantize=quantize)
    wg, wet, wit, wpi = lda_estep.estep_fixed_point_csr_pi(
        ids, dropped, segs.clamp(0, b - 1), *tail, quantize=quantize)
    for x, y in zip((g, et, it, pi), (wg, wet, wit, wpi)):
        assert torch.equal(x, y)
    assert not bool(pi[outside].any())
    assert int(it[0]) < 50


# ---------------------------------------------------------------------------
# the flat-token contract and the csr backend
# ---------------------------------------------------------------------------

def _padded_inputs(seed, b=12, vocab=200, k=7, mean_len=25):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(0, vocab, size=max(2, int(rng.poisson(mean_len))))
            for _ in range(b)]
    corpus = corpus_from_docs(docs, vocab, device=CPU)
    lam = rng.gamma(100.0, 0.01, (vocab, k)).astype(np.float32)
    eb = np.asarray(j_eb(jnp.asarray(lam), axis=0))
    return corpus.token_ids, corpus.counts, _t(eb), vocab, k


@pytest.mark.parametrize("seed", [0, 3])
def test_csr_backend_equals_gather_backend(seed):
    """On padded batches the ``csr`` backend (K4 → K5 → K3 twins) equals
    ``gather``: both stop batch-wide, so the same iteration count; γ, π and
    the correction at 2e-3."""
    ids, cnts, eb, vocab, k = _padded_inputs(seed)
    _, tcfg = _configs(vocab, k)
    batch = BowBatch(ids, cnts)
    got = get_backend("csr").solve(tcfg, eb, batch)
    want = get_backend("gather").solve(tcfg, eb, batch)
    assert int(got.iters) == int(want.iters)
    _close(got.gamma, want.gamma, 2e-3, 2e-3)
    _close(got.pi, want.pi, 2e-3, 1e-4)
    _close(got.sstats, want.sstats, 1e-2, 2e-3)

    rng = np.random.default_rng(seed)
    visited = _t(rng.random(ids.shape[0]) < 0.5)
    old_pi = torch.where(visited[:, None, None], want.pi, 0.0)
    gc, gw, gres = get_backend("csr").solve_correction(
        tcfg, eb, batch, old_pi, visited, "bfloat16")
    wc, ww, wres = get_backend("gather").solve_correction(
        tcfg, eb, batch, old_pi, visited, "bfloat16")
    assert int(gres.iters) == int(wres.iters)
    _close(gc, wc, 2e-3, 2e-3)
    assert float(gw) == float(ww)
    _close(gres.gamma, wres.gamma, 2e-3, 2e-3)
    assert gres.pi.shape == ids.shape + (k,)


def test_estep_csr_ref_matches_repro():
    batch, eb = _flat_batch(9)
    k, vocab = eb.shape[1], eb.shape[0]
    jcfg, tcfg = _configs(vocab, k)
    b = batch.num_docs + 2
    want = j_estep.estep_csr_ref(
        jcfg, jnp.asarray(eb), jnp.asarray(batch.token_ids),
        jnp.asarray(batch.counts), jnp.asarray(batch.segments), num_docs=b)
    got = estep_csr_ref(tcfg, _t(eb), _t(batch.token_ids), _t(batch.counts),
                        _t(batch.segments), b)
    assert int(got.iters) == int(want.iters)
    _close(got.gamma, want.gamma, 2e-3, 2e-3)
    _close(got.pi, want.pi, 2e-3, 1e-4)
    _close(got.sstats, want.sstats, 1e-2, 2e-3)


def test_flat_contract_cuda_equals_default():
    """``solve_tokens`` on the ``cuda`` backend (K4 twin) equals the default
    ``estep_csr_ref`` sweep for sweep."""
    batch, eb = _flat_batch(10)
    k, vocab = eb.shape[1], eb.shape[0]
    _, tcfg = _configs(vocab, k)
    tok = CSRTokenBatch(_t(batch.token_ids), _t(batch.counts),
                        _t(batch.segments))
    got = get_backend("cuda").solve_tokens(tcfg, _t(eb), tok, 20)
    want = get_backend("gather").solve_tokens(tcfg, _t(eb), tok, 20)
    assert int(got.iters) == int(want.iters)
    _close(got.gamma, want.gamma, 2e-3, 2e-3)
    _close(got.pi, want.pi, 2e-3, 1e-4)


# ---------------------------------------------------------------------------
# the slice: the CSR stream engine
# ---------------------------------------------------------------------------

def _tiny_pair(backend, jbackend, algo, layout="csr", seed=0):
    """The same tiny-corpus stream run in both packages, from one λ₀."""
    spec = PAPER_CORPORA["tiny"]
    jcfg, tcfg = _configs(spec.vocab_size, 8)
    jcfg = dataclasses.replace(jcfg, estep_backend=jbackend)
    tcfg = dataclasses.replace(tcfg, estep_backend=backend)
    jstream = j_stream.CorpusDocStream(j_make_corpus(J_CORPORA["tiny"],
                                                     seed=0),
                                       spec.vocab_size)
    tstream = CorpusDocStream(make_corpus(spec, seed=0, device=CPU),
                              spec.vocab_size)
    jeng = JEngine(jcfg, jstream, algo=algo, batch_size=16, seed=seed,
                   layout=layout)
    teng = LDAEngine(tcfg, tstream, algo=algo, batch_size=16, seed=seed,
                     layout=layout, device=CPU)
    lam0 = {f: np.asarray(getattr(j_init_global_state(
        jcfg, jax.random.key(seed)), f)) for f in STATE_FIELDS}
    teng.state = state_from_numpy(lam0, CPU)
    return jeng, teng


@pytest.mark.parametrize("algo,backend,jbackend,epochs", [
    ("ivi", "gather", "gather", 2),
    ("sivi", "gather", "gather", 2),
    # the CUDA backend runs its kernels' plain twins on CPU tensors; the
    # Pallas reference runs in interpret mode, so one epoch keeps it short
    ("ivi", "cuda", "pallas", 1),
])
def test_csr_stream_trajectory_tracks_repro(algo, backend, jbackend, epochs):
    jeng, teng = _tiny_pair(backend, jbackend, algo)
    assert teng.token_budget == jeng.token_budget == 1024
    for _ in range(epochs):
        jeng.run_epoch()
        teng.run_epoch()
        assert teng.docs_seen == jeng.docs_seen
        _close(teng.state.lam, jeng.state.lam, 1e-3, 1e-3)
        np.testing.assert_array_equal(teng.memo.visited.numpy(),
                                      np.asarray(jeng.memo.visited))
    assert float(teng.state.init_frac) == float(jeng.state.init_frac) == 0.0
    assert int(teng.state.t) == int(jeng.state.t)
    assert teng.stream_padding_stats() == jeng.stream_padding_stats()


def _schedule(stream, batch_size, **kw):
    packer = BatchPacker(batch_size, max_width=stream.max_unique, **kw)
    out = [b for pos, (i, c) in enumerate(stream.iter_from(0))
           if (b := packer.add(pos, i, c)) is not None]
    return out + packer.flush(), packer


@pytest.mark.parametrize("algo,backend", [("ivi", "gather"),
                                          ("sivi", "cuda")])
def test_csr_stream_matches_padded_schedule(algo, backend):
    """A CSR stream engine equals a materialized padded engine that replays
    the same batch schedule at each batch's width (the two layouts emit
    different batches, so the padded engine follows the CSR schedule)."""
    spec = PAPER_CORPORA["tiny"]
    train = make_corpus(spec, seed=0, device=CPU)
    _, cfg = _configs(spec.vocab_size, 4, estep_max_iters=20,
                      estep_backend=backend)
    stream = CorpusDocStream(train, spec.vocab_size)
    se = LDAEngine(cfg, stream, algo=algo, batch_size=16, seed=0,
                   layout="csr", token_budget=128, device=CPU)
    ce = LDAEngine(cfg, train, algo=algo, batch_size=16, seed=0, device=CPU)
    sched, pk = _schedule(stream, 16, layout="csr", token_budget=128)
    assert len(sched) > train.num_docs // 16     # the budget closes batches
    for _ in range(2):
        se.run_epoch()
        for cb in sched:
            ce.run_minibatch(cb.rows, width=pk.width_for(
                int(cb.doc_lengths.max()) if cb.num_docs else 1))
    assert se.docs_seen == ce.docs_seen == 2 * train.num_docs
    _close(se.state.lam, ce.state.lam, 2e-3, 2e-3)
    _close(se.state.m_vk, ce.state.m_vk, 2e-3, 2e-3)
    assert float(se.state.init_frac) == float(ce.state.init_frac) == 0.0


@pytest.mark.parametrize("algo", ["ivi", "sivi"])
def test_padded_stream_run_bit_equals_materialized_run(algo):
    """Packing is bit-transparent: a padded-layout stream run equals the
    materialized run under the same batch schedule, bit for bit."""
    spec = PAPER_CORPORA["tiny"]
    train = make_corpus(spec, seed=0, device=CPU)
    _, cfg = _configs(spec.vocab_size, 4, estep_max_iters=20)
    stream = CorpusDocStream(train, spec.vocab_size)
    se = LDAEngine(cfg, stream, algo=algo, batch_size=16, seed=0,
                   device=CPU)
    ce = LDAEngine(cfg, train, algo=algo, batch_size=16, seed=0, device=CPU)
    sched, _ = _schedule(stream, 16)
    assert len({b.width for b in sched}) > 1      # several ladder widths
    for _ in range(2):
        se.run_epoch()
        for b in sched:
            ce.run_minibatch(b.rows, width=b.width)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(se.state, f), getattr(ce.state, f)), f
    assert torch.equal(se.memo.pi, ce.memo.pi)
    assert se.full_bound() == ce.full_bound()


def test_csr_ivi_bound_monotone_and_full_bound_matches_store():
    """IVI on the CSR path: the memoized ELBO does not fall over any update
    of epoch 2 (``tests/test_monotone.py``'s fp32 slack), and the stream
    engine's ``full_bound`` equals ``elbo_memoized_store`` on the
    materialized corpus."""
    rng = np.random.default_rng(1)
    docs = [rng.integers(0, 120, size=int(rng.integers(1, 40)))
            for _ in range(40)]
    corpus = corpus_from_docs(docs, 120, device=CPU)
    cfg = LDAConfig(num_topics=5, vocab_size=120, estep_max_iters=100,
                    estep_tol=1e-6, estep_backend="cuda")
    stream = CorpusDocStream(corpus, 120)
    eng = LDAEngine(cfg, stream, algo="ivi", batch_size=8, seed=1,
                    layout="csr", token_budget=160, device=CPU)
    eng.run_epoch()
    assert float(eng.state.init_frac) == 0.0
    prev = eng.full_bound()
    while eng.stream_step():
        cur = eng.full_bound()
        assert cur >= prev - max(5e-3, 2e-6 * abs(prev)), (prev, cur)
        prev = cur
    want = float(elbo_memoized_store(cfg, materialize(stream, device=CPU),
                                     eng.memo, eng.state.lam))
    np.testing.assert_allclose(eng.full_bound(), want, rtol=1e-6)
    np.testing.assert_allclose(eng.state.lam.numpy(),
                               cfg.beta0 + eng.state.m_vk.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_stream_engine_refusals():
    spec = PAPER_CORPORA["tiny"]
    train = make_corpus(spec, seed=0, device=CPU)
    cfg = LDAConfig(num_topics=3, vocab_size=spec.vocab_size)
    stream = CorpusDocStream(train, spec.vocab_size)
    with pytest.raises(ValueError, match="DocStream"):
        LDAEngine(cfg, train, algo="ivi", layout="csr", device=CPU)
    with pytest.raises(ValueError, match="layout"):
        LDAEngine(cfg, stream, algo="ivi", layout="ragged", device=CPU)
    # repro's stream refusals: full-batch MVI, and the γ-only store that
    # reconstructs π from resident corpus rows
    with pytest.raises(ValueError, match="full-batch"):
        LDAEngine(cfg, stream, algo="mvi", layout="csr", device=CPU)
    with pytest.raises(ValueError, match="resident corpus"):
        LDAEngine(cfg, stream, algo="sivi", layout="csr",
                  memo_store="gamma", device=CPU)
    with pytest.raises(TypeError, match="DocStream"):
        LDAEngine(cfg, [[1, 2]], algo="ivi", device=CPU)
    eng = LDAEngine(cfg, stream, algo="ivi", layout="csr", device=CPU)
    assert eng.token_budget == 4096               # min(64 · 64, 8192)
    with pytest.raises(ValueError, match="stream"):
        eng.epoch_batches()
    with pytest.raises(ValueError, match="Corpus"):
        eng.run_minibatch()
    small = LDAConfig(num_topics=3, vocab_size=10)
    with pytest.raises(ValueError, match="vocabulary"):
        LDAEngine(small, stream, algo="ivi", device=CPU).stream_step()
