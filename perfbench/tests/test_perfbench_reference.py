"""The plain reference against the program's CPU path at a tiny size.

Only this test reads the program beside the reference: the reference
itself imports nothing of it."""
from __future__ import annotations

import numpy as np
import torch

from perfbench.harness import corpus
from perfbench.reference import lda as ref
from perfbench.reference import work as wk


def _corpus(seed=3, n=40, v=200, k=5, mean_len=20):
    gen = torch.Generator().manual_seed(seed)
    phi = corpus.topics(v, k, 0.05, gen)
    s = corpus.make_split(phi, n, mean_len, 4, 0.1, gen)
    lam0 = torch._standard_gamma(torch.full((v, k), 100.0),
                                 generator=gen) * 0.01
    return s, lam0, phi


def test_ivi_updates_match_the_program():
    from repro_torch.core.types import Corpus
    from repro_torch.lda.api import LDA
    s, lam0, _ = _corpus()
    v, k, b = lam0.shape[0], lam0.shape[1], 16
    lda = LDA(num_topics=k, vocab_size=v, algo="ivi", backend="cuda",
              batch_size=b, seed=9, device="cpu")
    lda.partial_fit(Corpus(s.ids, s.counts), steps=0)
    lda.warm_start(lam0)
    c = ref.EStepCfg(0.5, 1e-4, 100, 128)
    total = float(s.counts.double().sum())
    rng = np.random.default_rng(9)
    order = np.concatenate([rng.permutation(40), rng.permutation(40)])
    bounds = [0, 16, 32, 40, 56, 72, 80]
    st = ref.IVIState(lam0.clone(), torch.zeros_like(lam0), lam0 - 0.05,
                      1.0)
    memo = torch.zeros(s.ids.shape + (k,))
    seen = torch.zeros(40, dtype=torch.bool)
    for lo, hi in zip(bounds, bounds[1:]):
        rows = torch.as_tensor(order[lo:hi])
        lam_before = lda.lam.clone()
        lda.partial_fit(steps=1)
        out = ref.ivi_update(st, s.ids[rows], s.counts[rows], memo[rows],
                             seen[rows], total, 0.05, c)
        pi_prog, vis = lda.trainer.eng.memo.gather(rows.numpy())
        assert bool(vis.all())
        # both sides chain their own λ over six updates: fp32 rounding of
        # two trajectories (1e-5 read at most)
        assert torch.allclose(pi_prog, out.pi, atol=5e-5)
        assert torch.allclose(lda.lam, out.state.lam, rtol=1e-5, atol=1e-5)
        dl_p, dl_r = lda.lam - lam_before, out.state.lam - st.lam
        assert float((dl_p - dl_r).norm() / dl_r.norm()) < 1e-5
        memo[rows], seen[rows] = out.pi, True
        st = out.state
    assert st.init_frac == 0.0


def test_gamma_only_matches_the_inferencer():
    from repro_torch.core.types import Corpus, LDAConfig
    from repro_torch.lda.infer import TopicInferencer
    from perfbench.traffic.infer_requests import request_batches
    s, _, phi = _corpus(seed=4, n=50)
    lam = 0.05 + (phi * 300.0).T.contiguous()
    cfg = LDAConfig(num_topics=5, vocab_size=200, estep_backend="cuda")
    got = TopicInferencer(cfg, lam, batch_size=8, device="cpu").posterior(
        Corpus(s.ids, s.counts))
    eb = ref.exp_elog(lam, 0)
    c = ref.EStepCfg(0.5, 1e-4, 100, 128)
    want = np.zeros_like(got)
    ids, cnts = s.ids.numpy(), s.counts.numpy()
    for rows, w in request_batches(cnts, 8):
        bi = np.zeros((8, w), np.int32)
        bc = np.zeros((8, w), np.float32)
        bi[:len(rows)], bc[:len(rows)] = ids[rows, :w], cnts[rows, :w]
        g, _ = ref.gamma_only(torch.from_numpy(bi), torch.from_numpy(bc),
                              eb, c)
        want[rows] = g[:len(rows)].numpy()
    assert np.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_work_formulas_are_the_programs():
    """The frozen copy gives the port's numbers on the same shapes."""
    from repro_torch.obs.roofline import HW
    from repro_torch.tune import model
    for key in ("hbm_bw", "peak_flops_fp32"):
        assert wk.HW[key] == HW[key]
    args = (1024, 160, 100, 30000, [9000] * 8, [128] * 8, [7] * 8)
    assert wk.fixed_point_work(*args) == model.fixed_point_work(*args)
    assert wk.pi_finish_work(163840, 100, 72000) == \
        model.pi_finish_work(163840, 100, 72000)
    assert wk.scatter_work(72000, 141927, 100) == \
        model.scatter_work(72000, 141927, 100)
    t, by = wk.bound_s(wk.scatter_work(72000, 141927, 100))
    ms, by2 = model.bound_ms(*model.scatter_work(72000, 141927, 100))
    assert abs(t * 1e3 - ms) < 1e-12 and by == by2


def test_a_tied_tile_is_held_to_the_nearer_stop():
    """A tile whose stopping test lies within TIE of the tolerance may stop
    a sweep later under another summation order: the reference then holds
    it to that stop; an untied tile keeps its own."""
    s, _, phi = _corpus(seed=4, n=16)
    lam = 0.05 + (phi * 300.0).T.contiguous()
    eb = ref.exp_elog(lam, 0)
    e, cn = eb[s.ids.long()], s.counts
    g, deltas, gs = torch.full((16, 5), 1.5), [], []
    for _ in range(12):
        g, d = ref._sweep(g, e, cn, 0.5)
        deltas.append(d)
        gs.append(g)
    k = 6
    one_more = gs[k + 1]               # what a program one sweep on holds
    tied = ref.EStepCfg(0.5, deltas[k], 100, 128)
    g_own, sweeps = ref.gamma_only(s.ids, cn, eb, tied)
    assert sweeps == [k + 1]
    assert float(ref.doc_gaps(one_more, g_own).max()) > 1e-6
    g_held, _ = ref.gamma_only(s.ids, cn, eb, tied, one_more)
    assert torch.equal(g_held, one_more)
    untied = ref.EStepCfg(0.5, (deltas[k] * deltas[k - 1]) ** 0.5, 100, 128)
    g_kept, sweeps = ref.gamma_only(s.ids, cn, eb, untied, one_more)
    assert sweeps == [k + 1] and torch.equal(g_kept, gs[k])
