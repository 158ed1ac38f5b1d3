"""Card-only tests: each CUDA kernel against its plain twin, K1–K3 at the
main path's shapes (the Arxiv vocabulary V = 141,927, K = 100, B = 1024, L
about 163), K4 at the path's shape flattened and on small flat CSR
batches, K5 on a small flat CSR batch, K2/K5 and K1/K4's π finish bit
for bit against them at K from 9 to 1,000, their bf16 stream against the twins, K4 on a shuffled
stream, K6–K9 (the pre-fusion baseline and flash attention) at small
sizes; K1, K4, K3 and K6–K8 above their old K caps (K = 300 and 1,000),
the K = 100 instances' bits against the parent commit's, one facade
save → load → resume, and the padded ``posterior`` packed on the card
against its host-staged twin. Whether a card is present is
decided inside the ``cuda`` fixture, so every worker collects the same
tests; without a card they skip.

Run on the card:  python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.math import exp_dirichlet_expectation
from repro_torch.kernels import lda_estep

pytestmark = pytest.mark.gpu

V, K, B, L = 141_927, 100, 1024, 163


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def path_inputs(cuda):
    """A batch shaped like the Arxiv path: unique ids per row, about 100
    live slots per row, counts 1–4, Eφ from a Gamma(100, 0.01) λ."""
    rng = np.random.default_rng(0)
    ids = np.zeros((B, L), np.int32)
    cnts = np.zeros((B, L), np.float32)
    for r in range(B):
        n = int(np.clip(rng.poisson(100), 4, L))
        ids[r, :n] = rng.choice(V, size=n, replace=False)
        cnts[r, :n] = rng.integers(1, 5, size=n)
    lam = torch.from_numpy(rng.gamma(100.0, 0.01, (V, K)).astype(np.float32))
    eb = exp_dirichlet_expectation(lam.to(cuda), axis=0).contiguous()
    return (torch.from_numpy(ids).to(cuda), torch.from_numpy(cnts).to(cuda),
            eb)


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_fixed_point_kernel_matches_twin(path_inputs, start):
    """Cold: every tile runs to the cap (these topics are near-uniform, so
    the mean |Δγ| falls slowly: about 0.031 after 10 sweeps, 0.025 after
    30). Warm: the even tiles start from γ after 30 sweeps and the odd
    ones cold, with the tolerance between the two, so the tiles stop at
    different sweep counts (1 and about 20)."""
    ids, cnts, eb = path_inputs
    gamma0 = torch.full((B, K), 1.5, device=eb.device)
    tol = 1e-4
    if start == "warm":
        near = lda_estep.estep_fixed_point_plain(
            ids, cnts, eb, gamma0, 0.5, 0.0, 30)[0]
        even = (torch.arange(B, device=eb.device) // 128) % 2 == 0
        gamma0 = torch.where(even[:, None], near, gamma0).contiguous()
        tol = 0.028
    args = (ids, cnts, eb, gamma0, 0.5, tol, 60)
    g, et, it = lda_estep.estep_fixed_point(*args)
    pg, pet, pit = lda_estep.estep_fixed_point_plain(*args)
    torch.cuda.synchronize()
    assert int((it - pit).abs().max()) <= 1
    torch.testing.assert_close(g, pg, rtol=2e-3, atol=2e-3)
    # Eθ tight in the tiles that ran the same sweeps as the twin
    same = (it == pit).repeat_interleave(128)[:B]
    torch.testing.assert_close(et[same], pet[same], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(et, pet, rtol=2e-3, atol=2e-3)
    if start == "warm":
        assert len(set(it.tolist())) >= 2, it


def test_fixed_point_kernel_is_deterministic(path_inputs):
    """Two launches of K1 on the same inputs give the same bits: γ, Eθ and
    the tile sweeps (each document's warps sum in a fixed order, every block
    takes the tiles' stop decisions from the same slots in the same order).
    Warm starts on the even tiles make the tiles stop at different sweeps."""
    ids, cnts, eb = path_inputs
    cold = torch.full((B, K), 1.5, device=eb.device)
    near = lda_estep.estep_fixed_point_plain(ids, cnts, eb, cold, 0.5, 0.0,
                                             30)[0]
    even = (torch.arange(B, device=eb.device) // 128) % 2 == 0
    gamma0 = torch.where(even[:, None], near, cold).contiguous()
    args = (ids, cnts, eb, gamma0, 0.5, 0.028, 60)
    first = lda_estep.estep_fixed_point(*args)
    second = lda_estep.estep_fixed_point(*args)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)
    assert len(set(first[2].tolist())) >= 2, first[2]


def test_fixed_point_kernel_loops_over_the_grid(path_inputs):
    """K1 at B = 4,100 (no multiple of 128: a last tile of 4 rows), more
    documents than the co-resident grid holds at once, so each block walks
    several: the same bars as at B = 1,024."""
    from repro_torch.kernels import build
    ids, cnts, eb = path_inputs
    b = 4100
    rows = torch.arange(b, device=eb.device) % B
    big_ids, big_cnts = ids[rows].contiguous(), cnts[rows].contiguous()
    blocks = build.load().lda_fixed_point_blocks(b, L, K, 128, b)
    assert 0 < blocks * 2 < b   # 4 warps per document at L = 163, 8 a block
    gamma0 = (1.0 + torch.rand((b, K), device=eb.device,
                               generator=torch.Generator(eb.device)
                               .manual_seed(7))).contiguous()
    args = (big_ids, big_cnts, eb, gamma0, 0.5, 0.03, 25)
    g, et, it = lda_estep.estep_fixed_point(*args)
    pg, pet, pit = lda_estep.estep_fixed_point_plain(*args)
    torch.cuda.synchronize()
    assert it.shape == (33,)
    assert int((it - pit).abs().max()) <= 1
    torch.testing.assert_close(g, pg, rtol=2e-3, atol=2e-3)
    same = (it == pit).repeat_interleave(128)[:b]
    torch.testing.assert_close(et[same], pet[same], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(et, pet, rtol=2e-3, atol=2e-3)


def test_fixed_point_kernel_between_batch_sizes(path_inputs):
    """K1 at B = 1,024, then a smaller last batch (one tile), then B =
    1,024 again, as an epoch's batches come: each launch sizes its grid
    and shared memory for its own B, and the third gives the first's
    bits."""
    ids, cnts, eb = path_inputs
    gamma0 = torch.full((B, K), 1.5, device=eb.device)
    args = (ids, cnts, eb, gamma0, 0.5, 1e-3, 60)
    first = lda_estep.estep_fixed_point(*args)
    small = (ids[:46].contiguous(), cnts[:46].contiguous(), eb,
             gamma0[:46].contiguous(), 0.5, 1e-3, 60)
    g, et, it = lda_estep.estep_fixed_point(*small)
    pg, pet, pit = lda_estep.estep_fixed_point_plain(*small)
    third = lda_estep.estep_fixed_point(*args)
    torch.cuda.synchronize()
    assert int((it - pit).abs().max()) <= 1
    torch.testing.assert_close(g, pg, rtol=2e-3, atol=2e-3)
    for x, y in zip(first, third):
        assert torch.equal(x, y)


@pytest.mark.parametrize("quantize", [False, True])
def test_token_pi_kernel_matches_twin(path_inputs, quantize):
    ids, cnts, eb = path_inputs
    et = torch.rand((B, K), generator=torch.Generator(eb.device).manual_seed(1),
                    device=eb.device) + 0.01
    got = lda_estep.token_pi(ids, cnts, eb, et, quantize=quantize)
    want = lda_estep.token_pi_plain(ids, cnts, eb, et, quantize=quantize)
    if quantize:   # one bf16 ulp where the fp32 values straddle a rounding
        torch.testing.assert_close(got, want, rtol=2.0 ** -7, atol=1e-38)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("batch", ["path", "skewed", "all_dead"])
def test_segment_scatter_kernel_is_deterministic_and_exact(path_inputs,
                                                           batch):
    """K3 gives the same bits on two launches and stays within rtol = atol
    = 1e-5 of an fp64 ``index_add_``: on the path's rows; with one id in
    every one of the 1,024 documents (a 1,024-row segment, split over a
    block's warps); and with every count 0 (every output row zero)."""
    ids, cnts, eb = path_inputs
    if batch == "skewed":
        ids = ids.clone()
        ids[:, 1:][ids[:, 1:] == 7] = 8     # id 7 once in every row
        ids[:, 0] = 7
        cnts = cnts.clone()
        cnts[:, 0] = 3.0
    elif batch == "all_dead":
        cnts = torch.zeros_like(cnts)
    gen = torch.Generator(eb.device).manual_seed(2)
    pi_new = torch.rand((B * L, K), generator=gen, device=eb.device)
    pi_old = torch.rand((B * L, K), generator=gen, device=eb.device)
    flat_ids, flat_cnts = ids.reshape(-1), cnts.reshape(-1)
    if batch == "skewed":
        assert int(((flat_ids == 7) & (flat_cnts != 0)).sum()) == B
    a = lda_estep.segment_scatter(flat_ids, flat_cnts, pi_new, pi_old, V)
    b = lda_estep.segment_scatter(flat_ids, flat_cnts, pi_new, pi_old, V)
    for x, y, pi in zip(a, b, (pi_new, pi_old)):
        assert torch.equal(x, y)
        want = torch.zeros((V, K), dtype=torch.float64, device=eb.device)
        want.index_add_(0, flat_ids.long(),
                        flat_cnts[:, None].double() * pi.double())
        torch.testing.assert_close(x.double(), want, rtol=1e-5, atol=1e-5)
        if batch == "all_dead":
            assert not bool(x.any())


def test_segment_scatter_makes_no_host_sync(path_inputs):
    """K3's wrapper on CUDA tensors (the fixed-size preparation and the
    launch) raises nothing under ``set_sync_debug_mode("error")``."""
    ids, cnts, eb = path_inputs
    pi = torch.rand((B * L, K), generator=torch.Generator(eb.device)
                    .manual_seed(3), device=eb.device)
    flat_ids, flat_cnts = ids.reshape(-1), cnts.reshape(-1)
    lda_estep.segment_scatter(flat_ids, flat_cnts, pi, pi, V)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s_new, s_old = lda_estep.segment_scatter(flat_ids, flat_cnts, pi, pi,
                                                 V)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(s_new, s_old)


def _csr_card_batch(cuda, seed, n_docs, max_len, budget, v=2000, k=24):
    """One flat CSR batch on the card: ``n_docs`` ragged documents of up to
    ``max_len`` unique tokens (two of them empty, two of a single token)
    in a ``budget``-slot stream with tail padding, and Eφ from peaked
    topics, so the batch stops before the cap."""
    from repro_torch.data.stream import BatchPacker
    rng = np.random.default_rng(seed)
    packer = BatchPacker(n_docs, layout="csr", token_budget=budget)
    lengths = rng.integers(2, max_len + 1, n_docs)
    lengths[[3, n_docs * 17 // 40]] = 0
    lengths[[5, n_docs * 30 // 40]] = 1
    for pos, m in enumerate(lengths):
        ids = np.sort(rng.choice(v, size=int(m), replace=False))
        batch = packer.add(pos, ids.astype(np.int32),
                           rng.integers(1, 4, int(m)).astype(np.float32))
    assert batch is not None and batch.num_docs == n_docs
    lam = torch.from_numpy((rng.gamma(0.3, 2.0, (v, k)) + 0.05)
                           .astype(np.float32))
    eb = exp_dirichlet_expectation(lam.to(cuda), axis=0).contiguous()
    flat = [torch.from_numpy(a).to(cuda)
            for a in (batch.token_ids, batch.counts, batch.segments)]
    return flat, eb, batch.num_docs


@pytest.fixture(scope="module")
def csr_inputs(cuda):
    """A small flat CSR batch on the card: 40 ragged documents (empty and
    single-token ones included) in a 2,048-slot stream with tail padding,
    K = 24, Eφ from peaked topics so the batch stops before the cap."""
    return _csr_card_batch(cuda, 3, 40, 89, 2048)


@pytest.mark.parametrize("phantom", [0, 9])
def test_csr_fixed_point_kernel_matches_twin(csr_inputs, phantom):
    """K4 against its twin: the same batch-wide sweep count, γ at 2e-3 and
    Eθ at rtol 1e-4 / atol 1e-6; ``phantom`` rows own no token and start
    fresh, so they count in the first sweep's mean."""
    (ids, cnts, segs), eb, b = csr_inputs
    gamma0 = torch.full((b + phantom, eb.shape[1]), 1.5, device=eb.device)
    args = (ids, cnts, segs, eb, gamma0, 0.5, 1e-3, 60)
    g, et, it = lda_estep.estep_fixed_point_csr(*args)
    pg, pet, pit = lda_estep.estep_fixed_point_csr_plain(*args)
    torch.cuda.synchronize()
    assert int(it[0]) == int(pit[0]) < 60
    torch.testing.assert_close(g, pg, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(et, pet, rtol=1e-4, atol=1e-6)


def _check_csr_kernel(args):
    """K4 against its twin (the same batch-wide sweep count, below the cap;
    γ at 2e-3, Eθ at rtol 1e-4 / atol 1e-6) and the same bits on a second
    launch."""
    g, et, it = lda_estep.estep_fixed_point_csr(*args)
    again = lda_estep.estep_fixed_point_csr(*args)
    pg, pet, pit = lda_estep.estep_fixed_point_csr_plain(*args)
    torch.cuda.synchronize()
    for x, y in zip((g, et, it), again):
        assert torch.equal(x, y)
    assert int(it[0]) == int(pit[0]) < args[-1]
    torch.testing.assert_close(g, pg, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(et, pet, rtol=1e-4, atol=1e-6)


def _flat_rows(ids, cnts, budget):
    """The live slots of padded rows as one flat CSR stream of ``budget``
    slots: documents in row order, tail padding (segment 0, count 0)."""
    live = cnts != 0
    rows = torch.arange(ids.shape[0], dtype=torch.int32, device=ids.device)
    flat = (ids[live], cnts[live], rows[:, None].expand_as(ids)[live])
    pad = budget - flat[0].numel()
    assert pad >= 0
    return [torch.cat([x, torch.zeros(pad, dtype=x.dtype, device=x.device)])
            for x in flat]


def test_csr_fixed_point_kernel_is_deterministic(path_inputs):
    """K4 on the path's shape (1,024 documents in a 131,072-slot stream:
    W = 4 warps per document), with γ₀ drawn per row and topic so the batch
    stops before the cap: the same bits on two launches, and the twin's
    sweeps, γ and Eθ."""
    from repro_torch.kernels import build
    ids, cnts, eb = path_inputs
    flat = _flat_rows(ids, cnts, 131_072)
    assert build.load().lda_fixed_point_warps(131_072 // B) == 4
    gamma0 = (1.0 + torch.rand((B, K), device=eb.device,
                               generator=torch.Generator(eb.device)
                               .manual_seed(8))).contiguous()
    _check_csr_kernel((*flat, eb, gamma0, 0.5, 0.03, 25))


def test_csr_fixed_point_kernel_loops_over_the_grid(path_inputs):
    """K4 at B = 4,100 documents (T = 128 slots a document, W = 4), more
    than the co-resident grid holds at once, so each block walks several:
    the same bits on two launches, and the twin's sweeps, γ and Eθ."""
    from repro_torch.kernels import build
    ids, cnts, eb = path_inputs
    b = 4100
    rows = torch.arange(b, device=eb.device) % B
    flat = _flat_rows(ids[rows], cnts[rows], 128 * b)
    blocks = build.load().lda_fixed_point_blocks(b, 128, K, b, b)
    assert 0 < blocks * 2 < b   # 4 warps per document, 2 a block
    gamma0 = (1.0 + torch.rand((b, K), device=eb.device,
                               generator=torch.Generator(eb.device)
                               .manual_seed(7))).contiguous()
    _check_csr_kernel((*flat, eb, gamma0, 0.5, 0.03, 25))


@pytest.mark.parametrize("phantom", [0, 9])
@pytest.mark.parametrize("n_docs,max_len,budget,warps", [
    (64, 16, 1024, 1),       # T / B = 16
    (16, 480, 8192, 8)])     # T / B = 512
def test_csr_fixed_point_kernel_warps_per_doc(cuda, n_docs, max_len, budget,
                                              warps, phantom):
    """K4 with 1 and 8 warps per document (W from ceil(T / B)), with and
    without phantom rows that own no token, against its twin (the long
    documents stop after about 70 sweeps, the short ones after about 27)."""
    from repro_torch.kernels import build
    (ids, cnts, segs), eb, b = _csr_card_batch(cuda, n_docs, n_docs, max_len,
                                               budget, v=3000)
    b += phantom
    assert build.load().lda_fixed_point_warps(-(-budget // b)) == warps
    gamma0 = torch.full((b, eb.shape[1]), 1.5, device=eb.device)
    _check_csr_kernel((ids, cnts, segs, eb, gamma0, 0.5, 1e-3, 100))


@pytest.mark.parametrize("quantize", [False, True])
def test_csr_token_pi_kernel_matches_twin(csr_inputs, quantize):
    (ids, cnts, segs), eb, b = csr_inputs
    et = torch.rand((b, eb.shape[1]),
                    generator=torch.Generator(eb.device).manual_seed(4),
                    device=eb.device) + 0.01
    got = lda_estep.token_pi_csr(ids, cnts, segs, eb, et, quantize=quantize)
    want = lda_estep.token_pi_csr_plain(ids, cnts, segs, eb, et,
                                        quantize=quantize)
    if quantize:   # one bf16 ulp where the fp32 values straddle a rounding
        torch.testing.assert_close(got, want, rtol=2.0 ** -7, atol=1e-38)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


PI_TOPICS = [9, 100, 101, 256, 257, 1000]


def _pi_inputs(cuda, k, b=70, l=37, v=3000):
    """``b`` documents of ``l`` slots (no multiple of K2's 8-slot runs, so
    runs cross documents), unique ids a row, a random live length (some
    rows empty), counts 1–4, Eφ from a Gamma(100, 0.01) λ, and a positive
    Eθ."""
    rng = np.random.default_rng(k)
    ids = np.zeros((b, l), np.int32)
    cnts = np.zeros((b, l), np.float32)
    for r in range(b):
        n = int(rng.integers(0, l + 1))
        ids[r, :n] = rng.choice(v, size=n, replace=False)
        cnts[r, :n] = rng.integers(1, 5, size=n)
    lam = torch.from_numpy(rng.gamma(100.0, 0.01, (v, k)).astype(np.float32))
    eb = exp_dirichlet_expectation(lam.to(cuda), axis=0).contiguous()
    et = torch.from_numpy(rng.gamma(1.0, 1.0, (b, k)).astype(np.float32))
    return (torch.from_numpy(ids).to(cuda), torch.from_numpy(cnts).to(cuda),
            eb, et.to(cuda))


def _pi_close(got, want, quantize):
    if quantize:   # one bf16 ulp where the fp32 values straddle a rounding
        torch.testing.assert_close(got, want, rtol=2.0 ** -7, atol=1e-38)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("layout", ["padded", "csr"])
@pytest.mark.parametrize("k", PI_TOPICS)
def test_token_pi_kernels_and_finish_across_topics(cuda, k, layout,
                                                   quantize):
    """K2 / K5 (a warp a run of 8 slots, 16-byte span stores) against their
    twins below one warp of topics, at the instances' edges (K % 4 != 0:
    scalar span tails; 257: the wide bodies) and at 1,000; K1's / K4's π
    finish bit for bit against them; a batch whose counts are all 0 gives
    zero rows from both. Flat: the stream shuffled slot by slot (a run
    holds many segments), and 24 live slots given segment -1 or B: K4's
    finish gives them zero rows, as K5 on the stream with their counts 0."""
    ids, cnts, eb, et = _pi_inputs(cuda, k)
    b, l = ids.shape
    g0 = torch.full((b, k), 1.5, device=cuda)
    for c in (cnts, torch.zeros_like(cnts)):
        if layout == "padded":
            got = lda_estep.token_pi(ids, c, eb, et, quantize=quantize)
            _pi_close(got, lda_estep.token_pi_plain(ids, c, eb, et,
                                                    quantize=quantize),
                      quantize)
            args = (ids, c, eb, g0, 0.5, 1e-4, 60)
            g, e, it, pi = lda_estep.estep_fixed_point_pi(*args,
                                                          quantize=quantize)
            alone = lda_estep.estep_fixed_point(*args)
            want = lda_estep.token_pi(ids, c, eb, e, quantize=quantize)
        else:
            perm = torch.randperm(b * l, device=cuda,
                                  generator=torch.Generator(cuda)
                                  .manual_seed(k))
            segs = torch.arange(b, dtype=torch.int32,
                                device=cuda).repeat_interleave(l)
            flat = [x.reshape(-1)[perm].contiguous() for x in (ids, c, segs)]
            got = lda_estep.token_pi_csr(*flat, eb, et, quantize=quantize)
            _pi_close(got, lda_estep.token_pi_csr_plain(
                *flat, eb, et, quantize=quantize), quantize)
            live = torch.nonzero(flat[1] > 0).squeeze(1)[:24]
            outside = flat[2].clone()
            outside[live[:12]] = -1
            outside[live[12:]] = b
            dropped = flat[1].clone()
            dropped[live] = 0.0
            args = (flat[0], flat[1], outside, eb, g0, 0.5, 1e-4, 60)
            g, e, it, pi = lda_estep.estep_fixed_point_csr_pi(
                *args, quantize=quantize)
            alone = lda_estep.estep_fixed_point_csr(*args)
            want = lda_estep.token_pi_csr(flat[0], dropped, flat[2], eb, e,
                                          quantize=quantize)
            assert not bool(pi[live].any())
        torch.cuda.synchronize()
        for x, y in zip((g, e, it), alone):
            assert torch.equal(x, y)
        assert torch.equal(pi, want)
        if not bool(c.any()):
            assert not bool(got.any()) and not bool(pi.any())


def _seeded_gamma0(b, device, seed):
    """γ₀ drawn per row and topic, so the path's batch stops before 25
    sweeps at tol 0.03."""
    return (1.0 + torch.rand((b, K), device=device,
                             generator=torch.Generator(device)
                             .manual_seed(seed))).contiguous()


@pytest.mark.parametrize("quantize", [False, True])
def test_fused_pi_bit_equals_k2(path_inputs, quantize):
    """K1 with its π finish at the path's shape: γ, Eθ and the tile sweeps
    bit-equal to K1 without it, and π bit-equal to K2 on K1's Eθ."""
    ids, cnts, eb = path_inputs
    args = (ids, cnts, eb, _seeded_gamma0(B, eb.device, 9), 0.5, 0.03, 25)
    g, et, it, pi = lda_estep.estep_fixed_point_pi(*args, quantize=quantize)
    alone = lda_estep.estep_fixed_point(*args)
    want = lda_estep.token_pi(ids, cnts, eb, et, quantize=quantize)
    torch.cuda.synchronize()
    for x, y in zip((g, et, it), alone):
        assert torch.equal(x, y)
    assert torch.equal(pi, want)
    assert int(it.max()) < 25


@pytest.mark.parametrize("quantize", [False, True])
def test_fused_csr_pi_bit_equals_k5(path_inputs, quantize):
    """K4 with its π finish on the path's flat stream (1,024 documents in
    131,072 slots) with 9 phantom rows: γ, Eθ and the sweeps bit-equal to
    K4 without it, and π bit-equal to K5 on K4's Eθ (zero rows for the
    tail padding)."""
    ids, cnts, eb = path_inputs
    flat = _flat_rows(ids, cnts, 131_072)
    args = (*flat, eb, _seeded_gamma0(B + 9, eb.device, 10), 0.5, 0.03, 25)
    g, et, it, pi = lda_estep.estep_fixed_point_csr_pi(*args,
                                                       quantize=quantize)
    alone = lda_estep.estep_fixed_point_csr(*args)
    want = lda_estep.token_pi_csr(*flat, eb, et, quantize=quantize)
    torch.cuda.synchronize()
    for x, y in zip((g, et, it), alone):
        assert torch.equal(x, y)
    assert torch.equal(pi, want)
    assert int(it[0]) < 25


@pytest.mark.parametrize("layout", ["padded", "csr"])
def test_bf16_fixed_point_kernels_match_twins(path_inputs, layout):
    """K1 and K4 streaming Eφ (and, padded, the counts) rounded through
    bf16 against their twins in the same mode: γ at 2e-3 and Eθ at 2e-3;
    K4's batch-wide sweeps equal, K1's tile sweeps within 1 (a tile's mean
    |Δγ| summed in another order can cross tol one sweep apart). In the
    tiles whose sweeps agree γ is held at 2e-4, a bar that the fp32
    stream's γ fails. The fused π equals K2/K5 on the fp32 Eφ bit for
    bit."""
    ids, cnts, eb = path_inputs
    block = 128
    if layout == "padded":
        cnts = cnts.clone()
        cnts[0, 0] = 257.0          # bf16 rounds it to 256
        args = (ids, cnts, eb, _seeded_gamma0(B, eb.device, 11), 0.5, 0.03,
                25)
        g, et, it, pi = lda_estep.estep_fixed_point_pi(
            *args, stream_dtype="bfloat16")
        pg, pet, pit = lda_estep.estep_fixed_point_plain(
            *args, stream_dtype="bfloat16")
        g32 = lda_estep.estep_fixed_point(*args)[0]
        want_pi = lda_estep.token_pi(ids, cnts, eb, et)
        torch.cuda.synchronize()
        assert int((it - pit).abs().max()) <= 1
    else:
        flat = _flat_rows(ids, cnts, 131_072)
        args = (*flat, eb, _seeded_gamma0(B, eb.device, 11), 0.5, 0.03, 25)
        g, et, it, pi = lda_estep.estep_fixed_point_csr_pi(
            *args, stream_dtype="bfloat16")
        pg, pet, pit = lda_estep.estep_fixed_point_csr_plain(
            *args, stream_dtype="bfloat16")
        g32 = lda_estep.estep_fixed_point_csr(*args)[0]
        want_pi = lda_estep.token_pi_csr(*flat, eb, et)
        torch.cuda.synchronize()
        assert int(it[0]) == int(pit[0]) < 25
        block = B
    torch.testing.assert_close(g, pg, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(et, pet, rtol=2e-3, atol=2e-3)
    same = (it == pit).repeat_interleave(block)[:B]
    assert bool(same.any())
    torch.testing.assert_close(g[same], pg[same], rtol=2e-4, atol=2e-4)
    assert not torch.allclose(g32[same], pg[same], rtol=2e-4, atol=2e-4)
    assert torch.equal(pi, want_pi)


def test_csr_fixed_point_kernel_on_shuffled_stream(path_inputs):
    """K4 on the path's flat stream shuffled slot by slot (live tokens no
    longer grouped by segment, padding interleaved): the twin's sweeps, γ
    at 2e-3 and Eθ at rtol 1e-4 / atol 1e-6, the grouped stream's γ at
    2e-3; the fused π bit-equal to K5 on the shuffled stream; and the
    wrapper (sort, sorted search, launch) raises nothing under
    ``set_sync_debug_mode("error")``."""
    ids, cnts, eb = path_inputs
    flat = _flat_rows(ids, cnts, 131_072)
    perm = torch.randperm(131_072, generator=torch.Generator(eb.device)
                          .manual_seed(12), device=eb.device)
    shuffled = [x[perm].contiguous() for x in flat]
    gamma0 = _seeded_gamma0(B, eb.device, 12)
    args = (*shuffled, eb, gamma0, 0.5, 0.03, 25)
    lda_estep.estep_fixed_point_csr_pi(*args)               # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g, et, it, pi = lda_estep.estep_fixed_point_csr_pi(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    pg, pet, pit = lda_estep.estep_fixed_point_csr_plain(*args)
    grouped = lda_estep.estep_fixed_point_csr(*flat, eb, gamma0, 0.5, 0.03,
                                              25)
    want_pi = lda_estep.token_pi_csr(*shuffled, eb, et)
    torch.cuda.synchronize()
    assert int(it[0]) == int(pit[0]) < 25
    torch.testing.assert_close(g, pg, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(et, pet, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(g, grouped[0], rtol=2e-3, atol=2e-3)
    assert torch.equal(pi, want_pi)


def test_csr_fixed_point_kernel_drops_out_of_range_segments(path_inputs):
    """K4 with its π finish on the path's flat stream where 64 live tokens
    carry segment -1 and 64 carry B: as its twin, they belong to no
    document. The twin's sweeps, γ at 2e-3, and the same launch on the
    stream with those counts set to 0 bit for bit; their π rows are zero
    and π equals K5's on that stream."""
    ids, cnts, eb = path_inputs
    flat_ids, flat_cnts, segs = _flat_rows(ids, cnts, 131_072)
    outside = torch.nonzero(flat_cnts != 0).squeeze(1)[::700][:128]
    segs = segs.clone()
    segs[outside[:64]] = -1
    segs[outside[64:]] = B
    dropped = flat_cnts.clone()
    dropped[outside] = 0.0
    kept = segs.clamp(0, B - 1)
    tail = (eb, _seeded_gamma0(B, eb.device, 13), 0.5, 0.03, 25)
    g, et, it, pi = lda_estep.estep_fixed_point_csr_pi(
        flat_ids, flat_cnts, segs, *tail)
    pg, _, pit = lda_estep.estep_fixed_point_csr_plain(
        flat_ids, flat_cnts, segs, *tail)
    want = lda_estep.estep_fixed_point_csr_pi(flat_ids, dropped, kept, *tail)
    want_pi = lda_estep.token_pi_csr(flat_ids, dropped, kept, eb, et)
    torch.cuda.synchronize()
    assert outside.numel() == 128
    assert int(it[0]) == int(pit[0]) < 25
    torch.testing.assert_close(g, pg, rtol=2e-3, atol=2e-3)
    for x, y in zip((g, et, it, pi), want):
        assert torch.equal(x, y)
    assert not bool(pi[outside].any())
    assert torch.equal(pi, want_pi)


def test_csr_backend_matches_gather_on_card(cuda):
    """The ``csr`` backend (K4 → K5 → K3 on a flattened padded batch, each
    row's padding inside its range) against ``gather`` on the card: both
    stop batch-wide, so the same iteration count; γ and the correction at
    2e-3."""
    from repro_torch.core.estep import BowBatch, get_backend
    from repro_torch.core.types import LDAConfig
    from repro_torch.data.bow import corpus_from_docs
    rng = np.random.default_rng(5)
    v, k = 3000, 24
    docs = [rng.integers(0, v, size=int(rng.integers(1, 80)))
            for _ in range(40)]
    corpus = corpus_from_docs(docs, v, device=cuda)
    lam = torch.from_numpy((rng.gamma(0.3, 2.0, (v, k)) + 0.05)
                           .astype(np.float32)).to(cuda)
    eb = exp_dirichlet_expectation(lam, axis=0).contiguous()
    cfg = LDAConfig(num_topics=k, vocab_size=v, estep_max_iters=60,
                    estep_tol=1e-3)
    batch = BowBatch(corpus.token_ids, corpus.counts)
    want = get_backend("gather").solve(cfg, eb, batch)
    visited = torch.arange(40, device=cuda) % 2 == 0
    old_pi = torch.where(visited[:, None, None], want.pi, 0.0).contiguous()
    got = get_backend("csr").solve_correction(cfg, eb, batch, old_pi,
                                              visited)
    ref = get_backend("gather").solve_correction(cfg, eb, batch, old_pi,
                                                 visited)
    assert int(got[2].iters) == int(ref[2].iters) < 60
    torch.testing.assert_close(got[2].gamma, ref[2].gamma, rtol=2e-3,
                               atol=2e-3)
    torch.testing.assert_close(got[0], ref[0], rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# K6–K9
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fp32_matmul(cuda):
    """The dense twins' products in full fp32 (no TF32), as the kernels."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


def _dense_inputs(cuda, b, v, k, seed):
    gen = torch.Generator(cuda).manual_seed(seed)
    c = torch.poisson(torch.full((b, v), 0.3, device=cuda), generator=gen)
    et = torch.rand((b, k), generator=gen, device=cuda) + 0.05
    eb = torch.rand((v, k), generator=gen, device=cuda) + 0.05
    return c, et, eb


@pytest.mark.parametrize("b,v,k", [(256, 3000, 100), (100, 517, 128),
                                   (64, 96, 7), (64, 600, 300),
                                   (32, 300, 1000),
                                   # K6's tensor-core tiling (128 rows, 64
                                   # columns, 64 or 128 topics) at its edges
                                   (1, 50, 1), (200, 1000, 128),
                                   (130, 777, 64), (129, 333, 65),
                                   (100, 517, 129),
                                   # K7's (128 rows of V, 64 of B) at its
                                   # edges
                                   (1, 1, 100), (63, 127, 128),
                                   (65, 128, 64), (200, 129, 128),
                                   (64, 1111, 100),
                                   # above 128 topics: R, then the topics
                                   # in chunks of 128
                                   (65, 129, 256), (200, 257, 257),
                                   (63, 1111, 300), (130, 1111, 1000)])
def test_sweep_and_sstats_kernels_match_twins(cuda, fp32_matmul, b, v, k):
    """K6 and K7 against the dense oracles at 2e-5 (tests/test_kernels.py's
    bar), ragged B and V tiles included, and the same bits on a second
    launch (K6 sums its V splits in a fixed order, K7 its B tiles in
    order). Both run on the tensor cores at every K: one launch up to 128
    topics, R's pass and the chunked products above."""
    c, et, eb = _dense_inputs(cuda, b, v, k, b + v)
    for kern, plain, args in (
            (lda_estep.estep_sweep, lda_estep.estep_sweep_plain,
             (c, et, eb, 0.5)),
            (lda_estep.sstats, lda_estep.sstats_plain, (c, et, eb))):
        got = kern(*args, block_b=b, block_v=v)
        again = kern(*args, block_b=b, block_v=v)
        want = plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_estep_cuda_sweeps_matches_twin_path(cuda, fp32_matmul):
    """The per-sweep E-step through K6/K7 against the same loop over the
    twins, on the card: the same sweep count, γ at 1e-4."""
    from repro_torch.core.types import LDAConfig
    from repro_torch.kernels import ops
    rng = np.random.default_rng(6)
    v, k, b, l = 2000, 24, 200, 60
    ids = torch.from_numpy(np.stack([rng.choice(v, l, replace=False)
                                     for _ in range(b)]).astype(np.int32))
    cnts = torch.from_numpy(rng.integers(0, 4, (b, l)).astype(np.float32))
    lam = torch.from_numpy((rng.gamma(0.3, 2.0, (v, k)) + 0.05)
                           .astype(np.float32))
    eb = exp_dirichlet_expectation(lam.to(cuda), axis=0).contiguous()
    cfg = LDAConfig(num_topics=k, vocab_size=v, estep_max_iters=100,
                    estep_tol=1e-3)
    got = ops.estep_cuda_sweeps(cfg, eb, ids.to(cuda), cnts.to(cuda))
    want = ops.estep_sweeps(cfg, eb, ids.to(cuda), cnts.to(cuda), None,
                            block_b=128, block_v=512,
                            sweep=lda_estep.estep_sweep_plain,
                            sstats=lda_estep.sstats_plain)
    assert int(got.iters) == int(want.iters) < 100
    torch.testing.assert_close(got.gamma, want.gamma, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.sstats, want.sstats, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("k", [100, 128, 20])
def test_memo_delta_onehot_kernel_matches_twin_and_k2(cuda, k):
    """K8 against its twin (π 1e-5 / 1e-6, masses 1e-4) over nb = 2
    B-tiles, and with ``quantize`` its π equal to K2's bit for bit."""
    rng = np.random.default_rng(k)
    b, l, v = 64, 40, 700
    ids = torch.from_numpy(rng.integers(0, v, (b, l)).astype(np.int32)
                           ).to(cuda)
    cnts = torch.from_numpy(rng.poisson(1.0, (b, l)).astype(np.float32)
                            ).to(cuda)
    eb = torch.from_numpy(rng.gamma(1.0, 1.0, (v, k)).astype(np.float32)
                          ).to(cuda)
    et = torch.from_numpy(rng.gamma(1.0, 1.0, (b, k)).astype(np.float32)
                          ).to(cuda)
    old = torch.from_numpy(rng.random((b, l, k)).astype(np.float32)).to(cuda)
    ebt = eb[ids.long()].contiguous()
    assert b // lda_estep.delta_effective_block_b(b, l, k) == 2
    got = lda_estep.memo_delta_onehot(ids, cnts, ebt, et, v, old_pi=old)
    want = lda_estep.memo_delta_onehot_plain(ids, cnts, ebt, et, v, old)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    for x, y in zip(got[1:], want[1:]):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4)
    one = lda_estep.memo_delta_onehot(ids, cnts, ebt, et, v, old_pi=old,
                                      quantize=True)
    seg = lda_estep.memo_delta(ids, cnts, eb, et, v, old_pi=old,
                               quantize=True)
    assert torch.equal(one[0], seg[0])
    for x, y in zip(one[1:], seg[1:]):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k", [100, 300])
def test_memo_delta_onehot_allocates_no_partials_and_takes_skew(cuda, k):
    """K8 in one pass: at B = 256 (16 B-tiles of its twin at K = 100) its
    peak memory above the inputs is π, S_new, S_old and the sort's
    scratch, below one (nb, Vp, K) partial; with one id in every document
    (a segment the block sums by B tiles) it matches its twin and the same
    bits come from two launches."""
    rng = np.random.default_rng(k + 1)
    b, l, v = 256, 48, 3000
    ids = torch.from_numpy(rng.integers(0, v, (b, l)).astype(np.int32)
                           ).to(cuda)
    ids[:, 0] = 11
    cnts = torch.from_numpy((rng.poisson(1.0, (b, l)) + (np.arange(l) < 4))
                            .astype(np.float32)).to(cuda)
    eb = torch.from_numpy(rng.gamma(1.0, 1.0, (v, k)).astype(np.float32)
                          ).to(cuda)
    et = torch.from_numpy(rng.gamma(1.0, 1.0, (b, k)).astype(np.float32)
                          ).to(cuda)
    old = torch.from_numpy(rng.random((b, l, k)).astype(np.float32)).to(cuda)
    ebt = eb[ids.long()].contiguous()
    nb = b // lda_estep.delta_effective_block_b(b, l, k)
    vp = -(-v // 128) * 128
    assert nb > 1
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = lda_estep.memo_delta_onehot(ids, cnts, ebt, et, v, old_pi=old)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    outputs = (b * l * k + 2 * v * k) * 4
    assert peak < outputs + nb * vp * k * 4
    # the sort's keys, order and scratch, the sorted search's cuts
    assert peak < outputs + b * l * 64 + (v + 1) * 16 + (1 << 20)
    again = lda_estep.memo_delta_onehot(ids, cnts, ebt, et, v, old_pi=old)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    want = lda_estep.memo_delta_onehot_plain(ids, cnts, ebt, et, v, old)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    for x, y in zip(got[1:], want[1:]):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (False, None, None),
    (True, 1, None),         # each row its diagonal key alone
    (True, 40, None),        # a window under one key tile
    (True, None, 30.0),      # the softcap alone, at scale 1
    (True, 100, 50.0),       # both
])
@pytest.mark.parametrize("s,hd,rep,kv_len", [
    (256, 128, 4, None),     # Qwen2.5-3B's head width, GQA 4
    (70, 64, 1, None),       # one ragged 64-row tile past the first
    (256, 256, 2, 200),      # the widest head; padded keys masked
    (128, 40, 1, 100),       # a head width that is no multiple of 32
    (96, 36, 2, 90),         # no multiple of 8: bf16 pads it to 40
])
def test_flash_attention_kernel_matches_twin(cuda, dtype, causal, window,
                                             softcap, s, hd, rep, kv_len):
    """K9 against its twin: 2e-5 in fp32; in bf16, where both round one
    fp32 result once, about two bf16 ulps (rtol 2^-7, atol 1e-3). With a
    window (padded rows past kv_len keep no key there: zeros in both) and
    a softcap (at scale 1, so the logits reach the cap)."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(cuda).manual_seed(s + hd)
    bh = 4 * rep
    q = torch.randn((bh, s, hd), generator=gen, device=cuda).to(dtype)
    k = torch.randn((bh // rep, s, hd), generator=gen, device=cuda).to(dtype)
    v = torch.randn((bh // rep, s, hd), generator=gen, device=cuda).to(dtype)
    band = dict(window=window, softcap=softcap,
                scale=1.0 if softcap else None)
    got = fa.flash_attention(q, k, v, causal=causal, block_q=s, block_k=s,
                             kv_len=kv_len, **band)
    want = fa.flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len,
                                    **band)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    rtol, atol = (2e-5, 2e-5) if dtype == torch.float32 else (2.0 ** -7, 1e-3)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("hd", [128, 36])
def test_flash_attention_bf16_kernel_on_unaligned_inputs(cuda, hd):
    """K9 bf16 on contiguous q, k, v whose bases are not 16-byte aligned
    (views one element into a larger buffer): the wrapper copies them for
    the tensor maps (and pads hd = 36 to 40); the bf16 bar as above."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(cuda).manual_seed(hd)

    def unaligned(*shape):
        n = shape[0] * shape[1] * shape[2]
        buf = torch.randn(n + 1, generator=gen, device=cuda)
        t = buf.to(torch.bfloat16)[1:].view(shape)
        assert t.is_contiguous() and t.data_ptr() % 16
        return t

    q, k, v = unaligned(8, 128, hd), unaligned(2, 128, hd), \
        unaligned(2, 128, hd)
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=1e-3)


def _qwen_heads(cuda, dtype=torch.bfloat16, s=4096):
    """Qwen2.5-3B's attention widths (16 query heads, 2 KV heads, hd = 128)
    for one sequence of S tokens, heads flattened."""
    gen = torch.Generator(cuda).manual_seed(0)
    q = torch.randn((16, s, 128), generator=gen, device=cuda).to(dtype)
    k = torch.randn((2, s, 128), generator=gen, device=cuda).to(dtype)
    v = torch.randn((2, s, 128), generator=gen, device=cuda).to(dtype)
    return q, k, v


@pytest.mark.parametrize("s", [1024, 1000])
def test_flash_attention_bf16_window_one_returns_v(cuda, s):
    """K9 in bf16 at W = 1 through flash_mha (S = 1,000 padded to 1,024):
    each row keeps its diagonal key alone, P = 1 enters P·V as 1 + 0, and
    the output is v's row bit for bit, softcapped or not."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    gen = torch.Generator(cuda).manual_seed(s)
    q, k, v = (torch.randn((1, s, n, 128), generator=gen, device=cuda)
               .to(torch.bfloat16) for n in (16, 2, 2))
    fa.reset_launches()
    for cap in (None, 50.0):
        got = ops.flash_mha(q, k, v, causal=True, window=1, softcap=cap)
        torch.cuda.synchronize()
        assert torch.equal(got, v.repeat_interleave(8, dim=2))
    assert fa.LAUNCHES["flash_attention"] == 2


def test_flash_attention_bf16_kernel_is_deterministic(cuda):
    """Two launches of K9's bf16 body give the same bits (no atomics)."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _qwen_heads(cuda, s=1024)
    a = fa.flash_attention(q, k, v, causal=True)
    b = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_flash_attention_bf16_kernel_at_qwen_length(cuda):
    """K9 bf16, causal, S = 4,096 at Qwen2.5-3B's widths (GQA 16 / 2),
    against its twin at the bf16 bar (rtol 2^-7, atol 1e-3)."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _qwen_heads(cuda)
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=1e-3)


# ---------------------------------------------------------------------------
# the host-chunked memo store and SVI on the card
# ---------------------------------------------------------------------------

def test_chunked_store_round_trip_through_pinned_memory(cuda):
    """The bf16 host store with a CUDA wire: both staging buffers are
    pinned, two gathers in a row (the second waits for the first's copy)
    and an update round-trip bf16-exact π bit for bit, the chunks hold what
    a CPU-wire store holds after the same writes, and nothing of the memo
    stays on the card."""
    from repro_torch.core.memo import make_memo_store
    from repro_torch.core.types import LDAConfig
    cfg = LDAConfig(num_topics=K)
    d, l = 300, 24
    before = torch.cuda.memory_allocated()
    card = make_memo_store("chunked", cfg, d, l, chunk_docs=64, device=cuda)
    host = make_memo_store("chunked", cfg, d, l, chunk_docs=64, device="cpu")
    assert torch.cuda.memory_allocated() == before
    rng = np.random.default_rng(2)
    for rows, w in ((rng.choice(d, 100, replace=False), l),
                    (rng.choice(d, 70, replace=False), l - 9)):
        pi = torch.from_numpy(rng.random((len(rows), w, K)).astype(
            np.float32)).to(torch.bfloat16).float()
        card.update(rows, pi.to(cuda))
        host.update(rows, pi)
        got, vis = card.gather(rows, width=w)
        again, _ = card.gather(rows[::-1].copy(), width=w)
        torch.cuda.synchronize()
        assert got.device.type == "cuda" and got.dtype == torch.float32
        assert torch.equal(got.cpu(), pi) and bool(vis.all())
        assert torch.equal(again.cpu(), pi.flip(0))
    assert card._stage["in"].is_pinned() and card._stage["out"].is_pinned()
    for key, arr in host.state_dict().items():
        np.testing.assert_array_equal(card.state_dict()[key], arr)


@pytest.mark.parametrize("layout", ["padded", "csr"])
def test_svi_step_matches_plain_path(path_inputs, layout):
    """One SVI step (eq. 3) at the Arxiv widths on 128 documents (one K1
    tile, so both paths stop batch-wide), through the kernels (K1 then K3,
    or K4 then K3) against the plain path (``gather``'s E-step, or the plain
    flat reference), at the sstats bar of chip_smoke's serve phase."""
    from repro_torch.core.engines import svi_step, svi_step_csr
    from repro_torch.core.estep import BowBatch, CSRBackend
    from repro_torch.core.types import LDAConfig, init_global_state
    ids, cnts, _ = path_inputs
    ids, cnts = ids[:128].contiguous(), cnts[:128].contiguous()
    gen = torch.Generator(device=ids.device).manual_seed(3)
    lam0 = init_global_state(LDAConfig(num_topics=K, vocab_size=V),
                             device=ids.device, generator=gen).lam
    out = {}
    for backend in ("cuda", "gather"):
        cfg = LDAConfig(num_topics=K, vocab_size=V, estep_max_iters=60,
                        estep_backend=backend)
        state = init_global_state(cfg, device=ids.device, lam0=lam0)
        lda_estep.reset_launches()
        if layout == "padded":
            state, _ = svi_step(cfg, state, ids, cnts, 128.0)
        else:
            tok = CSRBackend.flatten(BowBatch(ids, cnts))
            state, _ = svi_step_csr(cfg, state, *tok, 128, 128.0,
                                    num_docs=128)
        torch.cuda.synchronize()
        out[backend] = (state, dict(lda_estep.LAUNCHES))
    (got, launches), (want, plain) = out["cuda"], out["gather"]
    fp = "fixed_point" if layout == "padded" else "fixed_point_csr"
    assert launches[fp] == launches["segment_scatter"] == 1
    assert sum(launches.values()) == 2 and sum(plain.values()) == 0
    assert int(got.t) == int(want.t) == 1
    torch.testing.assert_close(got.lam, want.lam, rtol=1e-2, atol=2e-3)


# ---------------------------------------------------------------------------
# above the old K caps (K1/K4/K3: 256, K6-K8: 128); K = 100 unchanged
# ---------------------------------------------------------------------------

def _wide_inputs(cuda, k, b=160, l=64, v=5000, seed=0):
    """``b`` documents (two K1 tiles) of up to ``l`` unique ids, Eφ from a
    Gamma(100, 0.01) λ over ``k`` topics."""
    rng = np.random.default_rng(seed + k)
    ids = np.zeros((b, l), np.int32)
    cnts = np.zeros((b, l), np.float32)
    for r in range(b):
        n = int(rng.integers(4, l + 1))
        ids[r, :n] = rng.choice(v, size=n, replace=False)
        cnts[r, :n] = rng.integers(1, 5, size=n)
    lam = torch.from_numpy(rng.gamma(100.0, 0.01, (v, k)).astype(np.float32))
    eb = exp_dirichlet_expectation(lam.to(cuda), axis=0).contiguous()
    return torch.from_numpy(ids).to(cuda), torch.from_numpy(cnts).to(cuda), eb


@pytest.mark.parametrize("k", [300, 1000])
def test_fixed_points_and_scatter_above_256_topics(cuda, k):
    """K1 and K4 (the wide kernel) against their twins: tile sweeps within
    1 (K4: equal), γ at 2e-3, Eθ at 1e-4 / 1e-6 where the sweeps agree;
    their π bit-equal to K2's / K5's; the same bits on two launches. K3
    over 256-column chunks against an fp64 sum at 1e-5, deterministic."""
    ids, cnts, eb = _wide_inputs(cuda, k)
    b, l = ids.shape
    g0 = torch.full((b, k), 1.5, device=cuda)
    args = (ids, cnts, eb, g0, 0.5, 1e-4, 60)
    g, et, it, pi = lda_estep.estep_fixed_point_pi(*args)
    again = lda_estep.estep_fixed_point_pi(*args)
    assert all(torch.equal(x, y) for x, y in zip((g, et, it, pi), again))
    pg, pet, pit = lda_estep.estep_fixed_point_plain(*args)
    assert int((it - pit).abs().max()) <= 1
    torch.testing.assert_close(g, pg, rtol=2e-3, atol=2e-3)
    same = (it == pit).repeat_interleave(128)[:b]
    torch.testing.assert_close(et[same], pet[same], rtol=1e-4, atol=1e-6)
    assert torch.equal(pi, lda_estep.token_pi(ids, cnts, eb, et))

    flat = (ids.reshape(-1), cnts.reshape(-1),
            torch.arange(b, dtype=torch.int32,
                         device=cuda).repeat_interleave(l))
    cargs = (*flat, eb, g0, 0.5, 1e-4, 60)
    g4, et4, it4, pi4 = lda_estep.estep_fixed_point_csr_pi(*cargs)
    assert all(torch.equal(x, y) for x, y in zip(
        (g4, et4, it4), lda_estep.estep_fixed_point_csr(*cargs)))
    pg4, pet4, pit4 = lda_estep.estep_fixed_point_csr_plain(*cargs)
    assert int(it4[0]) == int(pit4[0])
    torch.testing.assert_close(g4, pg4, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(et4, pet4, rtol=1e-4, atol=1e-6)
    assert torch.equal(pi4, lda_estep.token_pi_csr(*flat, eb, et4))

    v = eb.shape[0]
    pi_new, pi_old = pi.reshape(-1, k), pi4
    s1 = lda_estep.segment_scatter(flat[0], flat[1], pi_new, pi_old, v)
    s2 = lda_estep.segment_scatter(flat[0], flat[1], pi_new, pi_old, v)
    assert all(torch.equal(x, y) for x, y in zip(s1, s2))
    for got, p in zip(s1, (pi_new, pi_old)):
        want = torch.zeros((v, k), dtype=torch.float64, device=cuda)
        want.index_add_(0, flat[0].long(), flat[1][:, None].double()
                        * p.double())
        torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [300, 1000])
def test_memo_delta_onehot_above_128_topics(cuda, k):
    """K8 over tiles of 128 topics: its twin's bars (π 1e-5 / 1e-6, masses
    1e-4), and with ``quantize`` π equal to K2's bit for bit."""
    rng = np.random.default_rng(k)
    b, l, v = 16, 40, 700
    ids = torch.from_numpy(rng.integers(0, v, (b, l)).astype(np.int32)
                           ).to(cuda)
    cnts = torch.from_numpy(rng.poisson(1.0, (b, l)).astype(np.float32)
                            ).to(cuda)
    eb = torch.from_numpy(rng.gamma(1.0, 1.0, (v, k)).astype(np.float32)
                          ).to(cuda)
    et = torch.from_numpy(rng.gamma(1.0, 1.0, (b, k)).astype(np.float32)
                          ).to(cuda)
    old = torch.from_numpy(rng.random((b, l, k)).astype(np.float32)).to(cuda)
    ebt = eb[ids.long()].contiguous()
    got = lda_estep.memo_delta_onehot(ids, cnts, ebt, et, v, old_pi=old)
    want = lda_estep.memo_delta_onehot_plain(ids, cnts, ebt, et, v, old)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    for x, y in zip(got[1:], want[1:]):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4)
    one = lda_estep.memo_delta_onehot(ids, cnts, ebt, et, v, old_pi=old,
                                      quantize=True)
    seg = lda_estep.memo_delta(ids, cnts, eb, et, v, old_pi=old,
                               quantize=True)
    assert torch.equal(one[0], seg[0])
    for x, y in zip(one[1:], seg[1:]):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4)


def test_k100_instances_keep_the_parent_bits(cuda):
    """K1, K4, K3, K6, K7 and K8 at K = 100 on chip_smoke's seeded digest
    inputs give the outputs the parent commit's kernels gave (their sha256
    recorded in chip_smoke.py from a run of the parent's build; K6's from
    its tensor-core design's, which sums in another order by design)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    assert chip_smoke.kernel_digests(cuda) == chip_smoke.PARENT_DIGESTS


def test_segment_sum_docs_is_order_fixed_on_card(cuda):
    """The flat warm start's segment sum gives the same bits on every call
    (no float atomics) with no host sync, within fp32 rounding of the fp64
    sum."""
    from repro_torch.core.estep import segment_sum_docs
    gen = torch.Generator(cuda).manual_seed(0)
    segs = torch.randint(0, 64, (50_000,), generator=gen, device=cuda)
    vals = torch.rand((50_000, 100), generator=gen, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = segment_sum_docs(vals, segs, 64)      # no host sync
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for _ in range(3):
        assert torch.equal(a, segment_sum_docs(vals, segs, 64))
    want = torch.zeros((64, 100), dtype=torch.float64, device=cuda)
    want.index_add_(0, segs, vals.double())
    torch.testing.assert_close(a.double(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("layout,store", [("padded", "dense"),
                                          ("padded", "chunked"),
                                          ("csr", "dense")])
def test_facade_save_load_resume_on_card(cuda, tmp_path, layout, store):
    """``LDA`` on the cuda backend: a mid-epoch save, load and resume is
    bit-equal to the run that never stopped."""
    import os
    from repro_torch.core.types import LDAConfig
    from repro_torch.data.synthetic import PAPER_CORPORA, make_corpus
    from repro_torch.lda import LDA
    spec = PAPER_CORPORA["tiny"]
    train = make_corpus(spec, seed=0, device=cuda)
    cfg = LDAConfig(num_topics=8, vocab_size=spec.vocab_size,
                    estep_backend="cuda", estep_max_iters=30)
    path = os.path.join(tmp_path, "ck")
    a = LDA(cfg, algo="ivi", batch_size=16, memo_store=store, chunk_docs=32,
            layout=layout, token_budget=512, device=cuda).partial_fit(
                train, steps=3)
    a.save(path)
    a.partial_fit(steps=5)
    b = LDA.load(path, device=cuda).resume(train).partial_fit(steps=5)
    for f in ("lam", "m_vk", "init_mass", "init_frac", "t"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f


@pytest.mark.parametrize("layout", ["padded", "csr"])
def test_inferencer_double_buffer_on_card(cuda, layout):
    """``posterior_docs`` on the card: one launch a batch (the fixed point
    without its finish), the double-buffered bits equal to the synchronous
    ones, and γ at the gather backend's 2e-3 (batches of one 128-row
    tile, so K1's per-tile stop is the whole batch's)."""
    from repro_torch.core.types import LDAConfig
    from repro_torch.data.stream import CorpusDocStream
    from repro_torch.data.synthetic import PAPER_CORPORA, make_corpus
    from repro_torch.lda import TopicInferencer
    spec = PAPER_CORPORA["tiny"]
    test = make_corpus(spec, split="test", seed=0, device=cuda)
    lam = torch.from_numpy(np.random.default_rng(0).gamma(
        2.0, 0.5, (spec.vocab_size, 8)).astype(np.float32))
    cfg = LDAConfig(num_topics=8, vocab_size=spec.vocab_size,
                    estep_backend="cuda", estep_max_iters=50)
    inf = TopicInferencer(cfg, lam, batch_size=8, layout=layout,
                          token_budget=256, device=cuda)
    lda_estep.reset_launches()
    got = inf.posterior_docs(CorpusDocStream(test))
    batches = sum(inf.cache_info()["batches_per_width"].values())
    name = "fixed_point_csr" if layout == "csr" else "fixed_point"
    assert lda_estep.LAUNCHES[name] == sum(lda_estep.LAUNCHES.values()) \
        == batches
    assert np.array_equal(got, inf.posterior_docs(CorpusDocStream(test),
                                                  double_buffer=False))
    ref = TopicInferencer(cfg, lam, batch_size=8, layout=layout,
                          token_budget=256, backend="gather", device=cuda)
    np.testing.assert_allclose(got, ref.posterior_docs(CorpusDocStream(test)),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("where", ["host", "card"])
def test_padded_posterior_on_card_bit_equal_to_host_staged(cuda, where):
    """The padded ``posterior`` on the card, its request in host memory
    (copied in from there) or already on the card, against the host-staged
    algorithm it replaced (``bucket_rows``, numpy-padded 256-row batches
    through K1, placement by request position): γ bit for bit on two
    requests in a row, the first request's array unchanged by the second,
    the padding bookkeeping equal, two host waits a request."""
    from repro_torch.core.estep import BowBatch, get_backend
    from repro_torch.core.types import Corpus, LDAConfig
    from repro_torch.data.stream import bucket_rows
    from repro_torch.lda import TopicInferencer
    from repro_torch.obs import Telemetry
    v, k, bs = 5000, 100, 256
    rng = np.random.default_rng(7)
    lam = torch.from_numpy(rng.gamma(100.0, 0.01, (v, k)).astype(np.float32))
    cfg = LDAConfig(num_topics=k, vocab_size=v, estep_backend="cuda")
    tel = Telemetry()
    inf = TopicInferencer(cfg, lam, batch_size=bs, telemetry=tel,
                          device=cuda)

    def request(d, seed):
        r = np.random.default_rng(seed)
        ids = np.zeros((d, L), np.int32)
        cnts = np.zeros((d, L), np.float32)
        for i in range(d):
            n = int(np.clip(r.poisson(90), 0, L)) if i % 50 else 0
            ids[i, :n] = r.choice(v, size=n, replace=False)
            cnts[i, :n] = r.integers(1, 5, size=n)
            cnts[i, :n:7] = 0                  # zero-count holes
        c = Corpus(torch.from_numpy(ids), torch.from_numpy(cnts))
        return c if where == "host" else c.to(cuda)

    def host_staged(c):
        ids_all, cnts_all = c.token_ids.cpu().numpy(), c.counts.cpu().numpy()
        out = np.zeros((c.num_docs, k), np.float32)
        live = padded = 0
        for rows_all, w in bucket_rows(cnts_all):
            for lo in range(0, len(rows_all), bs):
                rows = rows_all[lo:lo + bs]
                ids = np.zeros((bs, w), np.int32)
                cnts = np.zeros((bs, w), np.float32)
                ids[:len(rows)] = ids_all[rows, :w]
                cnts[:len(rows)] = cnts_all[rows, :w]
                live += int((cnts > 0).sum())
                padded += cnts.size
                g = get_backend("cuda").solve_gamma(
                    cfg, inf.exp_elog_beta,
                    BowBatch(torch.from_numpy(ids).to(cuda),
                             torch.from_numpy(cnts).to(cuda)))
                out[rows] = g[:len(rows)].cpu().numpy()
        return out, live, padded

    first, second = request(1500, 1), request(700, 2)
    got = inf.posterior(first)
    kept = got.copy()
    got2 = inf.posterior(second)
    want, live, padded = host_staged(first)
    want2, live2, padded2 = host_staged(second)
    assert np.array_equal(got, want) and np.array_equal(got2, want2)
    assert np.array_equal(got, kept)
    stats = inf.padding_stats()
    assert (stats["live_slots"], stats["padded_slots"]) == (
        live + live2, padded + padded2)
    assert tel.metrics.total("serve.host_waits") == 4


def test_fixed_point_refuses_past_shared_memory(cuda):
    """Above the card's shared memory a block (about 3,600 topics at this
    B) the wrappers raise, naming both byte counts."""
    k = 4000
    ids = torch.zeros((2, 4), dtype=torch.int32, device=cuda)
    cnts = torch.ones((2, 4), device=cuda)
    eb = torch.full((8, k), 1.0 / 8, device=cuda)
    g0 = torch.full((2, k), 1.5, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        lda_estep.estep_fixed_point(ids, cnts, eb, g0, 0.5, 1e-4, 5)
    segs = torch.tensor([0, 0, 1, 1, 0, 0, 1, 1], dtype=torch.int32,
                        device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        lda_estep.estep_fixed_point_csr(ids.reshape(-1), cnts.reshape(-1),
                                        segs, eb, g0, 0.5, 1e-4, 5)


@pytest.mark.parametrize("group", [1024, 1000, 12])
def test_grouped_fixed_point_equals_one_launch_a_group(path_inputs, group):
    """K1 with its stop tiles cut within groups (D-IVI stacks its live
    workers' batches into one launch, one group a worker): each group's γ,
    Eθ, tile sweeps and π bit-equal to that group launched alone (a
    document's bits depend on its own rows and its tile's stop only), and
    the whole against the twin's loop over the groups at K1's bars. The
    even groups start warm and the odd ones cold, so the groups stop at
    different sweeps; at B = 1,000 and 12 a 128-row tile would straddle
    two groups."""
    ids, cnts, eb = path_inputs
    n = 4
    rows = torch.arange(n * group, device=eb.device) % B
    gids, gcnts = ids[rows].contiguous(), cnts[rows].contiguous()
    cold = torch.full((n * group, K), 1.5, device=eb.device)
    near = lda_estep.estep_fixed_point_plain(gids, gcnts, eb, cold, 0.5, 0.0,
                                             30, group=group)[0]
    even = (torch.arange(n * group, device=eb.device) // group) % 2 == 0
    gamma0 = torch.where(even[:, None], near, cold).contiguous()
    args = (gids, gcnts, eb, gamma0, 0.5, 0.028, 60)
    got = lda_estep.estep_fixed_point_pi(*args, group=group)
    tiles = -(-group // 128)
    assert got[2].shape == (n * tiles,)
    for w in range(n):
        sl = slice(w * group, (w + 1) * group)
        alone = lda_estep.estep_fixed_point_pi(
            gids[sl], gcnts[sl], eb, gamma0[sl].contiguous(), *args[4:])
        for x, y in zip((got[0][sl], got[1][sl], got[3][sl]),
                        (alone[0], alone[1], alone[3])):
            assert torch.equal(x, y)
        assert torch.equal(got[2][w * tiles:(w + 1) * tiles], alone[2])
    pg, pet, pit, ppi = lda_estep.estep_fixed_point_pi_plain(*args,
                                                             group=group)
    torch.cuda.synchronize()
    assert int((got[2] - pit).abs().max()) <= 1
    torch.testing.assert_close(got[0], pg, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(got[3], ppi, rtol=2e-3, atol=1e-4)
    assert len(set(got[2].tolist())) >= 2, got[2]


def test_divi_round_on_card_matches_gather(cuda):
    """D-IVI on the card (P = 4, B = 12, S = 2, each worker dropping a
    sub-round with probability 0.5; seed 8 drops every worker of one
    sub-round) against the same engine on the gather backend, which runs
    the workers one at a time (at B = 12 each worker is one tile, so the
    stop rules agree): λ within 1e-3 after four rounds, two launches a
    sub-round that any worker ran and none otherwise, and two runs with
    the same bits."""
    from repro_torch.core.types import LDAConfig
    from repro_torch.data.synthetic import PAPER_CORPORA, make_corpus
    from repro_torch.dist import DIVIConfig, DIVIEngine
    spec = PAPER_CORPORA["tiny"]
    train = make_corpus(spec, seed=0, device=cuda)
    dcfg = DIVIConfig(num_workers=4, batch_size=12, staleness=2,
                      delay_prob=0.5)
    lam0 = np.random.default_rng(3).gamma(100.0, 0.01, (spec.vocab_size, 8))
    engines = {}
    for name, backend in (("cuda", "cuda"), ("again", "cuda"),
                          ("gather", "gather")):
        cfg = LDAConfig(num_topics=8, vocab_size=spec.vocab_size,
                        estep_backend=backend, estep_max_iters=40)
        eng = DIVIEngine(cfg, dcfg, train, seed=8, device=cuda, lam0=lam0)
        lda_estep.reset_launches()
        for _ in range(4):
            eng.run_round()
        engines[name] = (eng, dict(lda_estep.LAUNCHES))
    eng, launches = engines["cuda"]
    # the engine's coins: the only draws of its rng
    rng = np.random.default_rng(8)
    delay = [rng.random((4, 2)) < 0.5 for _ in range(4)]
    ran = sum(int((~d).any(axis=0).sum()) for d in delay)
    assert eng.docs_seen == 12 * sum(int((~d).sum()) for d in delay)
    assert 0 < ran < 8
    assert launches["fixed_point"] == launches["segment_scatter"] == ran
    assert sum(launches.values()) == 2 * ran
    assert torch.equal(eng.state.lam, engines["again"][0].state.lam)
    torch.testing.assert_close(eng.state.lam, engines["gather"][0].state.lam,
                               rtol=1e-3, atol=1e-3)


def _tiny_service_setup(cuda, layout="padded", k=8):
    from repro_torch.core.types import LDAConfig
    from repro_torch.data.stream import CorpusDocStream
    from repro_torch.data.synthetic import PAPER_CORPORA, make_corpus
    from repro_torch.lda import TopicInferencer
    spec = PAPER_CORPORA["tiny"]
    test = make_corpus(spec, split="test", seed=0, device=cuda)
    lam = torch.from_numpy(np.random.default_rng(0).gamma(
        2.0, 0.5, (spec.vocab_size, k)).astype(np.float32)).to(cuda)
    cfg = LDAConfig(num_topics=k, vocab_size=spec.vocab_size,
                    estep_backend="cuda", estep_max_iters=50)
    inf = TopicInferencer(cfg, lam, batch_size=16, layout=layout,
                          token_budget=512, device=cuda)
    return cfg, lam, inf, list(CorpusDocStream(test).iter_from(0))


@pytest.mark.parametrize("layout", ["padded", "csr"])
def test_service_serves_posterior_docs_bits_on_card(cuda, layout):
    """A replayed burst through ``ServingService`` on the card: one launch
    a served batch, every response's γ bit-equal to ``posterior_docs`` on
    the same admitted sequence, conservation."""
    from repro_torch.serve import (ServiceConfig, ServingService,
                                   replay_arrivals, requests_from_docs,
                                   validate_slo_report)
    _, _, inf, docs = _tiny_service_setup(cuda, layout)
    offline = inf.posterior_docs(docs)
    svc = ServingService(inf, config=ServiceConfig(flush_timeout_s=10.0))
    lda_estep.reset_launches()
    responses = svc.run(requests_from_docs(docs,
                                           replay_arrivals(len(docs))))
    batches = svc.metrics.total("serve.batches")
    name = "fixed_point_csr" if layout == "csr" else "fixed_point"
    assert lda_estep.LAUNCHES[name] == sum(lda_estep.LAUNCHES.values()) \
        == batches
    assert len(responses) == len(docs) and all(r.ok for r in responses)
    for r in responses:
        assert np.array_equal(r.gamma, offline[r.rid]), r.rid
    rep = validate_slo_report(svc.slo_report())
    assert rep["conservation_ok"] and rep["served"] == len(docs)


def test_swap_from_publisher_stream_under_traffic_on_card(path_inputs):
    """A publisher thread on a stream of its own swaps λ in (``swap_model``
    drops each old snapshot's last reference) and scribbles NaN into fresh
    blocks of Eφ's size on its stream, while batches at the path's shape
    are dispatched back to back on the serving stream with no wait. Each
    batch's γ must be the γ of the snapshot its version names: a swap that
    published an unfinished Eφ, or a snapshot freed under a running K1
    (no ``record_stream``), gives another γ or NaN."""
    import threading
    from repro_torch.core.types import LDAConfig
    from repro_torch.data.stream import PackedBatch
    from repro_torch.lda import TopicInferencer
    ids, cnts, _ = path_inputs
    cuda = ids.device
    rng = np.random.default_rng(1)
    lams = [torch.from_numpy(rng.gamma(100.0, 0.01, (V, K))
                             .astype(np.float32)).to(cuda)
            for _ in range(2)]
    cfg = LDAConfig(num_topics=K, vocab_size=V, estep_backend="cuda",
                    estep_max_iters=20)
    batch = PackedBatch(np.arange(B), ids.cpu().numpy(), cnts.cpu().numpy(),
                        L)
    want = [TopicInferencer(cfg, x, batch_size=B, device=cuda)
            .posterior_packed(batch)[1] for x in lams]
    inf = TopicInferencer(cfg, lams[0], batch_size=B, device=cuda)
    torch.cuda.synchronize()
    stop = threading.Event()
    swaps = []

    def publisher():
        side = torch.cuda.Stream(cuda)
        with torch.cuda.stream(side):
            n = 0
            while not stop.is_set() and n < 400:
                n += 1
                swaps.append(inf.swap_model(lam=lams[n % 2]))
                junk = [torch.full((V, K), float("nan"), device=cuda)
                        for _ in range(2)]
                del junk

    t = threading.Thread(target=publisher)
    t.start()
    served = []
    try:
        for _ in range(60):
            _, gamma, _, version = inf.posterior_packed(batch)
            served.append((version, gamma))
    finally:
        stop.set()
        t.join(timeout=120)
    assert not t.is_alive()
    torch.cuda.synchronize()
    versions = [v for v, _ in served]
    assert versions == sorted(versions) and len(set(versions)) >= 2
    for version, gamma in served:
        assert torch.equal(gamma, want[version % 2]), version


def test_online_learner_trains_on_its_own_stream_on_card(cuda, monkeypatch):
    """``OnlineLearner`` on the card: ``start``/``stop`` with no hang, a
    published version, 2 launches an update, and every launch of the
    learner's thread (and of ``drain`` on the main thread) on the
    learner's stream, never on the serving stream."""
    import threading
    import time
    from repro_torch.serve import OnlineLearner, SnapshotStore
    cfg, lam, inf, docs = _tiny_service_setup(cuda)
    store = SnapshotStore(inf)
    learner = OnlineLearner(cfg, store, lam0=lam, capacity=256,
                            max_unique=64, batch_size=16, cadence_s=0.01,
                            min_new_docs=16)
    seen = []
    real = lda_estep._stream

    def spy(x):
        s = real(x)
        seen.append((threading.current_thread().name, s))
        return s

    monkeypatch.setattr(lda_estep, "_stream", spy)
    serving = torch.cuda.current_stream(cuda).cuda_stream
    mine = learner._cuda_stream.cuda_stream
    assert mine != serving
    learner.observe(docs[:64])
    lda_estep.reset_launches()
    learner.start()
    t0 = time.perf_counter()
    while inf.model_version == 0 and time.perf_counter() - t0 < 120:
        time.sleep(0.01)
    learner.stop(timeout=120)
    assert inf.model_version >= 1
    assert learner.drain(2) == [inf.model_version - 1, inf.model_version]
    assert learner.armed_observations >= 1
    assert not learner.watchdog.violations
    assert lda_estep.LAUNCHES["fixed_point"] == \
        lda_estep.LAUNCHES["segment_scatter"] > 0
    assert sum(lda_estep.LAUNCHES.values()) == \
        2 * lda_estep.LAUNCHES["segment_scatter"]
    assert seen and all(s == mine for _, s in seen)
    assert {name for name, _ in seen} >= {"online-learner", "MainThread"}


# ---------------------------------------------------------------------------
# the tuner (repro_torch.tune), CVB0's scatters
# ---------------------------------------------------------------------------

def test_tune_measured_on_the_card(cuda, tmp_path):
    """A small tune on the card: measured seconds, the card's device kind,
    and a winner with the default's bits on fresh inputs."""
    from repro_torch.core.types import DEFAULT_KERNEL_POLICY
    from repro_torch.tune import PolicyStore
    from repro_torch.tune import search as tsearch
    shape = tsearch.TuneShape(task="padded", b_or_t=256, v=8192, k=K, w=64)
    res = tsearch.tune_and_store(PolicyStore(tmp_path / "t.json"), shape,
                                 budget=4, seed=0, refine_rounds=1,
                                 gate_candidates=2, iters=30, device=cuda)
    assert res.objective == "measured_seconds" and not res.proxy_regime
    assert res.device_kind.startswith("gpu:")
    assert res.tuned_cost <= res.default_cost
    # the record names the launch the library sizes for the shape
    from repro_torch.kernels import build
    lib = build.load()
    assert res.effective["fp_warps"] == lib.lda_fixed_point_warps(64)
    assert res.effective["fp_blocks"] == lib.lda_fixed_point_blocks(
        256, 64, K, res.policy.block_b, 256)
    cfg, inputs = tsearch._probe_inputs(shape, tsearch.probe_shape(shape),
                                        777, 30, cuda)
    fresh = tsearch._gate_runner(shape, cfg, inputs)
    ok, _, _ = tsearch.equality_check(fresh, fresh(DEFAULT_KERNEL_POLICY),
                                      res.policy)
    assert ok, res.policy


def test_cvb0_scatters_against_twin(cuda):
    """CVB0 on the card: 2 K3 launches a step, N_vk and γ within 1e-4 of
    the same steps on the CPU twin, the same bits on a second run."""
    from repro_torch.core.cvb0 import CVB0Engine
    from repro_torch.core.types import LDAConfig
    from repro_torch.data.synthetic import PAPER_CORPORA, make_corpus
    spec = PAPER_CORPORA["tiny"]
    train = make_corpus(spec, seed=0, device="cpu")
    cfg = LDAConfig(num_topics=8, vocab_size=spec.vocab_size)
    d, l = train.token_ids.shape
    g0 = np.random.default_rng(0).gamma(1.0, 1.0, (d, l, 8)) + 0.1
    runs = []
    for device in (cuda, cuda, "cpu"):
        eng = CVB0Engine(cfg, train, batch_size=16, seed=0, device=device,
                         gamma0=g0)
        lda_estep.reset_launches()
        for _ in range(4):
            eng.run_minibatch()
        if device == cuda:
            torch.cuda.synchronize()
            assert lda_estep.LAUNCHES["segment_scatter"] == 8
        runs.append((eng.state.n_vk.cpu(), eng.state.gamma.cpu()))
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    for a, b in zip(runs[0], runs[2]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the LM template's serving path: K9 inside a prefill
# ---------------------------------------------------------------------------

# relative L2 of the last position's logits, K9 against the plain route
# and decode against prefill, at 2 layers: on an NVIDIA H100 80GB HBM3 at
# 700 W they read 0.0100 and 0.0087 (36 layers, chip_smoke.py: 0.0180 and
# 0.0183); the bars are about twice that
LM_PREFILL_REL_L2 = 2e-2
LM_DECODE_REL_L2 = 2e-2


def _lm_two_layers(cuda):
    """Qwen2.5-3B's layer widths (d_model 2,048, 16 query and 2 KV heads
    of 128, QKV bias, d_ff 11,008) at 2 layers and a 4,096-word
    vocabulary, bf16 weights from the port's seeded init."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=2,
                              vocab_size=4096)
    return cfg, T.cast_params(cfg, T.init_params(cfg, 0, device=cuda))


def _rel_l2(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


def test_lm_prefill_launches_k9_once_a_layer(cuda):
    """A 2-layer bf16 prefill (B = 2, S = 640: five 128-row tiles) through
    K9 launches it twice and agrees with the plain route's last logits;
    the plain route launches K9 never."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.training import make_prefill_step
    cfg, params = _lm_two_layers(cuda)
    gen = torch.Generator(cuda).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 640),
                                     generator=gen, device=cuda)}
    fa.reset_launches()
    got = make_prefill_step(cfg)(params, batch)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == cfg.num_layers
    fa.reset_launches()
    want = make_prefill_step(cfg, attention="plain")(params, batch)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 0
    assert got.shape == (2, cfg.vocab_size) and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    assert _rel_l2(got, want) <= LM_PREFILL_REL_L2


def test_gemma2_prefill_launches_k9_once_a_layer(cuda):
    """Reduced gemma2 (fp32, 4 layers: local, global, local, global; the
    window cut to 256, the 50.0 softcap on every layer) at S = 512, above
    the window: one K9 launch a layer (K9's fp32 body with the window and
    the cap) and the last logits within 1e-3 relative L2 of the plain
    route, which launches K9 never."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as T
    from repro_torch.training import make_prefill_step
    cfg = get_config("gemma2-27b").reduced(seq_len_hint=512, num_layers=4)
    assert cfg.sliding_window == 256 and cfg.attn_logit_softcap == 50.0
    params = T.init_params(cfg, 0, device=cuda)
    gen = torch.Generator(cuda).manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 512),
                                     generator=gen, device=cuda)}
    fa.reset_launches()
    got = make_prefill_step(cfg)(params, batch)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == cfg.num_layers
    fa.reset_launches()
    want = make_prefill_step(cfg, attention="plain")(params, batch)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 0
    assert bool(torch.isfinite(got).all())
    assert _rel_l2(got, want) <= 1e-3


def test_lm_k9_layer_output_matches_twin(cuda):
    """Layer 0's attention inside that prefill: K9 on the rope'd,
    pre-scaled q at scale 1 against its twin at the bf16 bar, the same
    bits on a second launch."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import apply_norm, compute_dtype
    cfg, params = _lm_two_layers(cuda)
    gen = torch.Generator(cuda).manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 1000),
                                     generator=gen, device=cuda)}
    x, pos = T._embed(cfg, params, batch, compute_dtype(cfg))
    layer = params["layers"][0]
    q, k, v = A.prefill_qkv(cfg, layer["attn"],
                            apply_norm(cfg, layer["norm1"], x), pos)
    qf, kf, vf = (t[0].transpose(0, 1).contiguous() for t in (q, k, v))
    # S = 1,000 padded to the 128-row grid, as flash_mha pads it
    pad = [torch.nn.functional.pad(t, (0, 0, 0, 24)) for t in (qf, kf, vf)]
    got = fa.flash_attention(*pad, causal=True, scale=1.0, kv_len=1000)
    again = fa.flash_attention(*pad, causal=True, scale=1.0, kv_len=1000)
    want = fa.flash_attention_plain(qf, kf, vf, causal=True, scale=1.0)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got[:, :1000].float(), want.float(),
                               rtol=2.0 ** -7, atol=1e-3)


def test_lm_decode_agrees_with_prefill_and_skips_k9(cuda):
    """The serve step over 16 prompt tokens (fp32 caches) against the K9
    prefill of the same tokens at the last position; generate twice: the
    same tokens, no K9 launch."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T
    from repro_torch.training import make_prefill_step, make_serve_step
    cfg, params = _lm_two_layers(cuda)
    gen = torch.Generator(cuda).manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (4, 16), generator=gen,
                           device=cuda)
    want = make_prefill_step(cfg)(params, {"tokens": prompt})
    serve = make_serve_step(cfg)
    caches = T.init_caches(cfg, 4, 16, dtype=torch.float32, device=cuda)
    fa.reset_launches()
    for t in range(16):
        _, got, caches = serve(params, caches, prompt[:, t],
                               torch.full((4,), t, dtype=torch.int32,
                                          device=cuda))
    first = generate(cfg, params, prompt, 8, device=cuda)
    second = generate(cfg, params, prompt, 8, device=cuda)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 0
    assert _rel_l2(got, want) <= LM_DECODE_REL_L2
    assert torch.equal(first, second) and first.shape == (4, 8)


# ---------------------------------------------------------------------------
# the MoE and recurrent blocks: K9 in a DeepSeekMoE layer and in zamba2's
# shared attention block
# ---------------------------------------------------------------------------

def _lm_full_width(cuda, arch, layers):
    """``arch``'s full layer widths at ``layers`` layers (the first of its
    pattern) and a 4,096-word vocabulary, bf16 weights from the port's
    layer-at-a-time builder."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, num_layers=layers,
                              layer_pattern=cfg.pattern[:layers],
                              vocab_size=4096)
    return cfg, T.init_params(cfg, 0, device=cuda, cast=True)


# a MoE layer's bf16 routes flip experts between the K9 and the plain
# route (near-tied router probabilities rounded apart): at 2 layers the
# DeepSeekMoE prefill read 0.0225 on an NVIDIA H100 80GB HBM3 at 700 W,
# where Qwen2.5-3B's dense layers read 0.0100. So the MoE bar is the whole
# model's (chip_smoke.py), and the fp32 comparison holds the function
LM_MOE_REL_L2 = 4e-2
LM_FP32_REL_L2 = 1e-3


def test_moe_prefill_launches_k9_once_a_layer(cuda):
    """DeepSeekMoE-16B's widths at 2 layers (layer 0 dense at 10,944,
    layer 1 MoE: 64 experts of 1,408 at top 6, 2 shared): a bf16 prefill
    (B = 2, S = 640) launches K9 once a layer and agrees with the plain
    route's last logits at the MoE bar."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.training import make_prefill_step
    cfg, params = _lm_full_width(cuda, "deepseek-moe-16b", 2)
    assert cfg.pattern == ("attn", "moe")
    gen = torch.Generator(cuda).manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 640),
                                     generator=gen, device=cuda)}
    fa.reset_launches()
    got = make_prefill_step(cfg)(params, batch)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == cfg.num_layers
    fa.reset_launches()
    want = make_prefill_step(cfg, attention="plain")(params, batch)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 0
    assert got.shape == (2, cfg.vocab_size) and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    assert _rel_l2(got, want) <= LM_MOE_REL_L2


def test_moe_prefill_fp32_matches_plain_route(cuda):
    """The same 2 layers in fp32 (K9's fp32 mode, fp32 weights): the K9
    prefill against the plain route within 1e-3, rounding alone between
    them."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as T
    from repro_torch.training import make_prefill_step
    cfg = get_config("deepseek-moe-16b")
    cfg = dataclasses.replace(cfg, num_layers=2, dtype="float32",
                              layer_pattern=cfg.pattern[:2],
                              vocab_size=4096)
    params = T.init_params(cfg, 0, device=cuda)
    gen = torch.Generator(cuda).manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 640),
                                     generator=gen, device=cuda)}
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        fa.reset_launches()
        got = make_prefill_step(cfg)(params, batch)
        torch.cuda.synchronize()
        assert fa.LAUNCHES["flash_attention"] == cfg.num_layers
        want = make_prefill_step(cfg, attention="plain")(params, batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert got.dtype == torch.float32
    assert _rel_l2(got, want) <= LM_FP32_REL_L2


def test_zamba2_shared_block_k9_matches_twin(cuda):
    """zamba2-1.2B's widths at 6 layers (layer 5 holds the shared block,
    32 heads of 64): a prefill launches K9 once, and the shared block's
    K9 output against its twin at the bf16 bar, the same bits twice."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as A
    from repro_torch.models import recurrent as R
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import apply_norm, compute_dtype
    from repro_torch.training import make_prefill_step
    cfg, params = _lm_full_width(cuda, "zamba2-1.2b", 6)
    assert cfg.pattern[5] == "mamba2_shared"
    gen = torch.Generator(cuda).manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 1024),
                                     generator=gen, device=cuda)}
    fa.reset_launches()
    logits = make_prefill_step(cfg)(params, batch)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 1
    assert bool(torch.isfinite(logits.float()).all())
    shared = params["shared_attn"]
    with torch.inference_mode():
        x, pos = T._embed(cfg, params, batch, compute_dtype(cfg))
        emb0 = x
        for i in range(5):
            x, _ = T.apply_layer(cfg, cfg.pattern[i], params["layers"][i], x,
                                 pos, emb0=emb0, shared=shared)
        layer = params["layers"][5]
        x = x + R.mamba2_train(cfg, layer["mamba"],
                               apply_norm(cfg, layer["norm"], x))
        h = T._shared_block(cfg, shared, x, emb0)
        q, k, v = A.prefill_qkv(cfg, shared["attn"], h, pos)
        qf, kf, vf = (t[0].transpose(0, 1).contiguous() for t in (q, k, v))
        got = fa.flash_attention(qf, kf, vf, causal=True, scale=1.0)
        again = fa.flash_attention(qf, kf, vf, causal=True, scale=1.0)
        want = fa.flash_attention_plain(qf, kf, vf, causal=True, scale=1.0)
    torch.cuda.synchronize()
    assert got.shape == (32, 1024, 64)
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=1e-3)


def test_moe_decode_deterministic_and_skips_k9(cuda):
    """The 2-layer DeepSeekMoE model's serve step over 16 prompt tokens
    against its K9 prefill, and generate twice: the same tokens (each
    token's routed rows are added in one order, no atomics), no K9
    launch."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T
    from repro_torch.training import make_prefill_step, make_serve_step
    cfg, params = _lm_full_width(cuda, "deepseek-moe-16b", 2)
    gen = torch.Generator(cuda).manual_seed(6)
    prompt = torch.randint(0, cfg.vocab_size, (4, 16), generator=gen,
                           device=cuda)
    want = make_prefill_step(cfg)(params, {"tokens": prompt})
    serve = make_serve_step(cfg)
    caches = T.init_caches(cfg, 4, 16, dtype=torch.float32, device=cuda)
    fa.reset_launches()
    for t in range(16):
        _, got, caches = serve(params, caches, prompt[:, t],
                               torch.full((4,), t, dtype=torch.int32,
                                          device=cuda))
    first = generate(cfg, params, prompt, 8, device=cuda)
    second = generate(cfg, params, prompt, 8, device=cuda)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 0
    assert _rel_l2(got, want) <= LM_DECODE_REL_L2
    assert torch.equal(first, second) and first.shape == (4, 8)


def test_lm_train_step_at_qwen_width_skips_k9(cuda):
    """One training step at Qwen2.5-3B's widths (d_model 2,048, 16 / 2
    heads of 128, d_ff 11,008, the full 151,936 vocabulary) cut to 2
    layers: bf16 compute over the fp32 masters, remat on, AdamW, clip 1.0,
    S = 1,024 as 2 microbatches of 1. The loss and the gradient norm are
    finite, every parameter moves and stays finite, and K9 is never
    launched (training takes the plain chunked attention)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.tree import tree_leaves
    from repro_torch.training import TrainState, make_train_step
    cfg = get_config("qwen2.5-3b")
    cfg = dataclasses.replace(cfg, num_layers=2,
                              layer_pattern=cfg.pattern[:2])
    assert cfg.remat and cfg.dtype == "bfloat16"
    params = T.init_params(cfg, 0, device=cuda)
    before = [p.clone() for p in tree_leaves(params)]
    opt = adamw(cosine_schedule(3e-4, 0, 10))
    step = make_train_step(cfg, opt, clip_norm=1.0, microbatches=2)
    gen = torch.Generator(cuda).manual_seed(7)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 1024), generator=gen,
                              device=cuda) for k in ("tokens", "labels")}
    fa.reset_launches()
    state, metrics = step(TrainState(params, opt.init(params), 0), batch)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 0
    assert all(bool(torch.isfinite(metrics[k])) for k in ("loss", "ce",
                                                           "grad_norm"))
    after = tree_leaves(state.params)
    assert all(p.dtype == torch.float32 and bool(torch.isfinite(p).all())
               for p in after)
    assert all(not torch.equal(a, b) for a, b in zip(after, before))


def test_k9_refuses_autograd_on_cuda(cuda):
    """K9 has no backward: a grad-requiring call raises on the card as on
    the CPU, without launching; under inference_mode it launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    gen = torch.Generator(cuda).manual_seed(8)
    q, k, v = (torch.randn((1, 256, 4, 64), generator=gen, device=cuda,
                           dtype=torch.bfloat16) for _ in range(3))
    fa.reset_launches()
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_mha(q.requires_grad_(True), k, v, causal=True)
    flat = q.detach().permute(0, 2, 1, 3).reshape(4, 256, 64).contiguous()
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(flat.requires_grad_(True), flat.detach(),
                           flat.detach(), causal=True)
    assert fa.LAUNCHES["flash_attention"] == 0
    with torch.inference_mode():
        out = ops.flash_mha(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 1 and out.grad_fn is None


# ---------------------------------------------------------------------------
# K9 on a mesh rank's heads: the local query heads and the KV heads they
# read (sharding/rules.py's placements, models/attention.py::head_slice)
# ---------------------------------------------------------------------------

def _rank_heads(arch, model, m):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.models.attention import head_slice
    from repro_torch.sharding import RankPlan, make_ctx
    cfg = get_config(arch)
    ctx = make_ctx(make_abstract_mesh((1, model), ("data", "model")),
                   coords={"data": 0, "model": m})
    plan = RankPlan(cfg, ctx, 1)
    return cfg, plan, head_slice(cfg, plan.specs["layers"][0]["attn"], plan)


@pytest.mark.parametrize("arch,model,rep", [
    ("qwen2.5-3b", 2, 8),          # 8 query heads, its 1 KV head
    ("qwen2.5-3b", 16, 1),         # 1 query head, KV head m // 8 picked
    ("deepseek-moe-16b", 2, 1),    # MHA: 8 and 8
])
def test_k9_on_a_mesh_ranks_local_heads(cuda, arch, model, rep):
    """Each model rank's K9 launch over its query heads and the KV heads
    they read gives the whole launch's output for those heads bit for
    bit (a head's attention reads no other head), and its twin's at the
    bf16 bars; the GQA rule bh // rep reaches the right KV head."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models.attention import select_kv
    cfg, _, _ = _rank_heads(arch, model, 0)
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(cuda).manual_seed(9)
    s = 512
    q = torch.randn((1, s, h, hd), generator=gen, device=cuda,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((1, s, kv, hd), generator=gen, device=cuda,
                        dtype=torch.bfloat16) for _ in range(2))
    with torch.inference_mode():
        whole = ops.flash_mha(q, k, v, causal=True)
        hl = h // model
        for m in range(model):
            _, plan, heads = _rank_heads(arch, model, m)
            assert heads.reduce
            qm = q[:, :, m * hl:(m + 1) * hl]
            if plan.model_sharded(plan.specs["layers"][0]["attn"]["wk"], 1):
                kl = kv // model
                km, vm = (t[:, :, m * kl:(m + 1) * kl] for t in (k, v))
            else:
                km, vm = select_kv(k, heads.kv), select_kv(v, heads.kv)
            assert qm.shape[2] // km.shape[2] == rep
            fa.reset_launches()
            got = ops.flash_mha(qm, km, vm, causal=True)
            torch.cuda.synchronize()
            assert fa.LAUNCHES["flash_attention"] == 1
            assert torch.equal(got, whole[:, :, m * hl:(m + 1) * hl])
            flat = [t[0].transpose(0, 1).contiguous() for t in (qm, km, vm)]
            want = fa.flash_attention_plain(*flat, causal=True)
            torch.testing.assert_close(got[0].transpose(0, 1).float(),
                                       want.float(), rtol=2.0 ** -7,
                                       atol=1e-3)


def test_k9_meta_path_allocates_on_meta_only(cuda, monkeypatch):
    """The dry run's K9: on meta tensors the wrapper allocates the output
    on meta, counts the launch and its operations, and touches neither
    the kernel library nor the card's memory."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    monkeypatch.setattr(build, "load", lambda *a, **k: pytest.fail(
        "the meta path built the kernel"))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    q = torch.empty((16, 4096, 128), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 4096, 128), dtype=torch.bfloat16, device="meta")
    fa.reset_launches()
    with torch.inference_mode():
        out = fa.flash_attention(q, k, k, causal=True)
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    assert fa.LAUNCHES["flash_attention"] == 1
    assert fa.FLOPS["flash_attention"] == 4.0 * 128 * 16 * 4096 * 4097 / 2
    assert torch.cuda.memory_allocated() == before


# ---------------------------------------------------------------------------
# LM training over a mesh on the card: the autograd collectives on CUDA
# tensors (sharding/comm.py), a rank of a spawned group on cuda:0
# ---------------------------------------------------------------------------

def _train_mesh_cfg():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen2.5-3b").reduced(
        seq_len_hint=64, num_layers=2), dtype="float32")


def _train_mesh_rank(rank, world, shape):
    """One rank on cuda:0: its blocks' gradients (``loss_and_grads``) of
    the reduced model in fp32, and on a (1, 1) mesh one AdamW step
    against ctx=None's, bit for bit."""
    import copy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.sharding import make_ctx
    from repro_torch.training import (TrainState, loss_and_grads,
                                      make_train_step, shard_train_state)
    from repro_torch.tree import tree_leaves, tree_paths
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = _train_mesh_cfg()
    ctx = make_ctx(make_host_mesh(*shape, device=dev))
    gen = torch.Generator(dev).manual_seed(3)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 64), generator=gen,
                              device=dev) for k in ("tokens", "labels")}
    params = T.init_params(cfg, 0, device=dev, ctx=ctx)
    _, grads = loss_and_grads(cfg, params, batch, 1, ctx)
    out = {"coords": dict(ctx.comm.coords),
           "received": dict(ctx.comm.received),
           "grads": {p: g.cpu().numpy() for p, g in tree_paths(grads)}}
    if world == 1:
        opt = adamw(3e-4)
        full = T.init_params(cfg, 0, device=dev)

        def fresh():
            p = copy.deepcopy(full)
            return TrainState(p, opt.init(p), 0)
        a, ma = make_train_step(cfg, opt)(fresh(), batch)
        b, mb = make_train_step(cfg, opt, ctx)(
            shard_train_state(cfg, fresh(), ctx), batch)
        out["bit_equal"] = all(torch.equal(ma[k], mb[k]) for k in ma) and \
            all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params),
                                                  tree_leaves(b.params)))
    return out


def test_train_step_at_one_nccl_rank_equals_no_ctx(cuda):
    """One NCCL rank on the card at (1, 1): the sharded train step is
    ctx=None's bits, and its collectives (all of size 1) move nothing."""
    from repro_torch.launch.mesh import spawn_ranks
    (r,) = spawn_ranks(_train_mesh_rank, 1, backend="nccl",
                       args=((1, 1),), timeout_s=240.0)
    assert r["bit_equal"]
    assert sum(r["received"].values()) == 0


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_autograd_collectives_on_cuda_tensors(cuda, shape):
    """Two gloo ranks on cuda:0 (host copies of CUDA tensors): the
    gradients of their blocks, put together, are the unsharded model's
    on the card within 1e-5 relative L2 a leaf (fp32); the data axis
    reduce-scatters the FSDP gradients, the model axis sums the
    tensor-parallel inputs' cotangents."""
    from repro_torch.launch.mesh import make_abstract_mesh, spawn_ranks
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import param_shapes
    from repro_torch.sharding import make_ctx
    from repro_torch.sharding.ctx import ctx_param_specs
    from repro_torch.sharding.rules import unshard_tree
    from repro_torch.training import loss_and_grads
    from repro_torch.tree import tree_map_with_path, tree_paths
    ranks = spawn_ranks(_train_mesh_rank, 2, args=(shape,), timeout_s=240.0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _train_mesh_cfg()
    gen = torch.Generator(cuda).manual_seed(3)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 64), generator=gen,
                              device=cuda) for k in ("tokens", "labels")}
    _, want = loss_and_grads(cfg, T.init_params(cfg, 0, device=cuda), batch)
    actx = make_ctx(make_abstract_mesh(shape, ("data", "model")))
    blocks = [tree_map_with_path(
        lambda p, _, r=r: torch.from_numpy(r["grads"][p]), param_shapes(cfg))
        for r in ranks]
    got = dict(tree_paths(unshard_tree(actx.mesh, blocks,
                                       ctx_param_specs(cfg, actx))))
    for path, w in tree_paths(want):
        w = w.cpu()
        assert float((got[path] - w).norm() / w.norm()) < 1e-5, path
    kind = "reduce_scatter" if shape[0] > 1 else "all_reduce"
    assert all(r["received"][kind] > 0 for r in ranks)
