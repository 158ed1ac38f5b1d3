"""Card-only tests: each CUDA kernel against its plain twin, K1–K3 at the
main path's shapes (the Arxiv vocabulary V = 141,927, K = 100, B = 1024, L
about 163), K4 at the path's shape flattened and on small flat CSR
batches, K5 on a small flat CSR batch, K1/K4's π finish bit for bit
against K2/K5, their bf16 stream against the twins, K4 on a shuffled
stream, K6–K9 (the pre-fusion baseline and flash attention) at small
sizes; K1, K4, K3 and K6–K8 above their old K caps (K = 300 and 1,000),
the K = 100 instances' bits against the parent commit's, and one facade
save → load → resume. Whether a card is present is
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
    blocks = build.load().lda_fixed_point_blocks(b, L, K, 128)
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
    blocks = build.load().lda_fixed_point_blocks(b, 128, K, b)
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
                                   (32, 300, 1000)])
def test_sweep_and_sstats_kernels_match_twins(cuda, fp32_matmul, b, v, k):
    """K6 and K7 against the dense oracles at 2e-5 (tests/test_kernels.py's
    bar), ragged B and V tiles included, and the same bits on a second
    launch (K6 sums its V splits in a fixed order)."""
    c, et, eb = _dense_inputs(cuda, b, v, k, b + v)
    got = lda_estep.estep_sweep(c, et, eb, 0.5, block_b=b, block_v=v)
    again = lda_estep.estep_sweep(c, et, eb, 0.5, block_b=b, block_v=v)
    want = lda_estep.estep_sweep_plain(c, et, eb, 0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    got = lda_estep.sstats(c, et, eb, block_b=b, block_v=v)
    want = lda_estep.sstats_plain(c, et, eb)
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
    partials, and with ``quantize`` its π equal to K2's bit for bit."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,hd,rep,kv_len", [
    (256, 128, 4, None),     # Qwen2.5-3B's head width, GQA 4
    (70, 64, 1, None),       # one ragged 64-row tile past the first
    (256, 256, 2, 200),      # the widest head; padded keys masked
    (128, 40, 1, 100),       # a head width that is no multiple of 32
    (96, 36, 2, 90),         # no multiple of 8: bf16 pads it to 40
])
def test_flash_attention_kernel_matches_twin(cuda, dtype, causal, s, hd, rep,
                                             kv_len):
    """K9 against its twin: 2e-5 in fp32; in bf16, where both round one
    fp32 result once, about two bf16 ulps (rtol 2^-7, atol 1e-3)."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(cuda).manual_seed(s + hd)
    bh = 4 * rep
    q = torch.randn((bh, s, hd), generator=gen, device=cuda).to(dtype)
    k = torch.randn((bh // rep, s, hd), generator=gen, device=cuda).to(dtype)
    v = torch.randn((bh // rep, s, hd), generator=gen, device=cuda).to(dtype)
    got = fa.flash_attention(q, k, v, causal=causal, block_q=s, block_k=s,
                             kv_len=kv_len)
    want = fa.flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len)
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
    recorded in chip_smoke.py from a run of the parent's build)."""
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
