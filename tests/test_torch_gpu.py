"""Card-only tests: each CUDA kernel against its plain twin, K1–K3 at the
main path's shapes (the Arxiv vocabulary V = 141,927, K = 100, B = 1024, L
about 163), K4 and K5 on a small flat CSR batch, K6–K9 (the pre-fusion
baseline and flash attention) at small sizes. Whether a card is present is
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


def test_segment_scatter_kernel_is_deterministic_and_exact(path_inputs):
    ids, cnts, eb = path_inputs
    gen = torch.Generator(eb.device).manual_seed(2)
    pi_new = torch.rand((B * L, K), generator=gen, device=eb.device)
    pi_old = torch.rand((B * L, K), generator=gen, device=eb.device)
    flat_ids, flat_cnts = ids.reshape(-1), cnts.reshape(-1)
    a = lda_estep.segment_scatter(flat_ids, flat_cnts, pi_new, pi_old, V)
    b = lda_estep.segment_scatter(flat_ids, flat_cnts, pi_new, pi_old, V)
    for x, y, pi in zip(a, b, (pi_new, pi_old)):
        assert torch.equal(x, y)
        want = torch.zeros((V, K), dtype=torch.float64, device=eb.device)
        want.index_add_(0, flat_ids.long(),
                        flat_cnts[:, None].double() * pi.double())
        torch.testing.assert_close(x.double(), want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def csr_inputs(cuda):
    """A small flat CSR batch on the card: 40 ragged documents (empty and
    single-token ones included) in a 2,048-slot stream with tail padding,
    K = 24, Eφ from peaked topics so the batch stops before the cap."""
    from repro_torch.data.stream import BatchPacker
    rng = np.random.default_rng(3)
    v, k, n = 2000, 24, 40
    packer = BatchPacker(n, layout="csr", token_budget=2048)
    lengths = rng.integers(2, 90, n)
    lengths[[3, 17]] = 0
    lengths[[5, 30]] = 1
    for pos, m in enumerate(lengths):
        ids = np.sort(rng.choice(v, size=int(m), replace=False))
        batch = packer.add(pos, ids.astype(np.int32),
                           rng.integers(1, 4, int(m)).astype(np.float32))
    lam = torch.from_numpy((rng.gamma(0.3, 2.0, (v, k)) + 0.05)
                           .astype(np.float32))
    eb = exp_dirichlet_expectation(lam.to(cuda), axis=0).contiguous()
    flat = [torch.from_numpy(a).to(cuda)
            for a in (batch.token_ids, batch.counts, batch.segments)]
    return flat, eb, batch.num_docs


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
                                   (64, 96, 7)])
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
