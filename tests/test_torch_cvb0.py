"""`repro_torch.core.cvb0` and `repro_torch.core.hyper` against `repro`.

CVB0 from the same injected γ₀ (drawn with numpy: ``jax.random.gamma``
cannot be reproduced in torch) over the same batches: ``cvb0_step``'s γ
and N_vk within 1e-4 of ``repro``'s, an engine epoch in ``repro``'s rng
order, ``repro``'s own properties (LPP improves, counts conserved,
competitive with IVI), and the step's two scatters through K3's wrapper
(its plain twin here). Minka's α₀/β₀ updates within 1e-5 relative of
``repro``'s on the same γ and λ.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CVB0Engine as JEngine
from repro.core import LDAConfig as JConfig
from repro.core import update_alpha0 as j_update_alpha0
from repro.core import update_beta0 as j_update_beta0
from repro.core.cvb0 import CVB0State as JState
from repro.core.cvb0 import cvb0_step as j_cvb0_step
from repro.core.estep import scatter_sstats as j_scatter_sstats
from repro.data import PAPER_CORPORA as J_CORPORA
from repro.data import make_corpus as j_make_corpus
from repro_torch.core.cvb0 import CVB0Engine, cvb0_step, init_cvb0
from repro_torch.core.engines import LDAEngine
from repro_torch.core.hyper import minka_update, update_alpha0, update_beta0
from repro_torch.core.predictive import log_predictive, split_heldout
from repro_torch.core.types import LDAConfig
from repro_torch.data.synthetic import PAPER_CORPORA, make_corpus
from repro_torch.kernels import lda_estep

CPU = "cpu"
SPEC = PAPER_CORPORA["tiny"]
K = 8


@pytest.fixture(scope="module")
def corpora():
    return (make_corpus(SPEC, split="train", seed=0, device=CPU),
            make_corpus(SPEC, split="test", seed=0, device=CPU),
            j_make_corpus(J_CORPORA["tiny"], split="train", seed=0))


def _cfgs():
    kw = dict(num_topics=K, vocab_size=SPEC.vocab_size)
    return JConfig(**kw), LDAConfig(**kw)


def _gamma0(train, seed=0):
    d, l = train.token_ids.shape
    return np.random.default_rng(seed).gamma(1.0, 1.0, (d, l, K)) \
        .astype(np.float32) + np.float32(0.1)


def _j_state(jcfg, jtrain, g0):
    """``repro``'s init_cvb0 on an injected γ₀."""
    g = jnp.asarray(g0)
    g = g / g.sum(-1, keepdims=True)
    g = jnp.where(jtrain.counts[:, :, None] > 0, g, 0.0)
    n_vk = j_scatter_sstats(jtrain.token_ids, jtrain.counts[:, :, None] * g,
                            jcfg.vocab_size)
    return JState(gamma=g, n_vk=n_vk,
                  visited=jnp.ones((jtrain.num_docs,), bool))


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def test_init_matches_repro(corpora):
    train, _, jtrain = corpora
    jcfg, cfg = _cfgs()
    g0 = _gamma0(train)
    st = init_cvb0(cfg, train, gamma0=g0)
    js = _j_state(jcfg, jtrain, g0)
    _close(st.gamma, js.gamma, 1e-6)
    _close(st.n_vk, js.n_vk)
    with pytest.raises(ValueError, match="gamma0 or a torch.Generator"):
        init_cvb0(cfg, train)
    with pytest.raises(ValueError, match="shape"):
        init_cvb0(cfg, train, gamma0=g0[:, :, :2])


def test_cvb0_step_matches_repro(corpora):
    """Three steps over the same batches from the same γ₀: γ (the whole
    memo) and N_vk within 1e-4."""
    train, _, jtrain = corpora
    jcfg, cfg = _cfgs()
    g0 = _gamma0(train, seed=1)
    st = init_cvb0(cfg, train, gamma0=g0)
    js = _j_state(jcfg, jtrain, g0)
    rng = np.random.default_rng(5)
    for _ in range(3):
        rows = rng.choice(train.num_docs, size=16, replace=False)
        idx = torch.as_tensor(rows)
        st = cvb0_step(cfg, st, train.token_ids[idx], train.counts[idx],
                       idx, inner_iters=5)
        jidx = jnp.asarray(rows)
        js = j_cvb0_step(jcfg, js, jtrain.token_ids[jidx],
                         jtrain.counts[jidx], jidx, 5)
    _close(st.gamma, js.gamma)
    _close(st.n_vk, js.n_vk)
    np.testing.assert_array_equal(st.visited.numpy(), np.asarray(js.visited))


def test_cvb0_engine_epoch_matches_repro(corpora):
    """One epoch of each engine in ``repro``'s rng order (the same
    permutation of the same seed) from the same γ₀."""
    train, _, jtrain = corpora
    jcfg, cfg = _cfgs()
    g0 = _gamma0(train, seed=2)
    eng = CVB0Engine(cfg, train, batch_size=16, seed=4, device=CPU,
                     gamma0=g0)
    jeng = JEngine(jcfg, jtrain, batch_size=16, seed=4)
    jeng.state = _j_state(jcfg, jtrain, g0)
    eng.run_epoch()
    jeng.run_epoch()
    assert eng.docs_seen == jeng.docs_seen
    _close(eng.state.gamma, jeng.state.gamma)
    _close(eng.state.n_vk, jeng.state.n_vk)
    _close(eng.lam, jeng.lam)


def test_cvb0_scatters_through_k3_twice_a_step(corpora, monkeypatch):
    """Both scatters of a step go through K3's wrapper (its twin on the
    CPU): 2 a step, one more at init; the same bits on a second run."""
    train, _, _ = corpora
    _, cfg = _cfgs()
    calls = []
    real = lda_estep.segment_scatter

    def counted(*a, **kw):
        calls.append(a[2].shape)
        return real(*a, **kw)

    monkeypatch.setattr(lda_estep, "segment_scatter", counted)
    g0 = _gamma0(train, seed=3)
    runs = []
    for _ in range(2):
        calls.clear()
        eng = CVB0Engine(cfg, train, batch_size=16, seed=0, device=CPU,
                         gamma0=g0)
        assert len(calls) == 1
        for _ in range(3):
            eng.run_minibatch()
        assert len(calls) == 1 + 2 * 3
        runs.append((eng.state.n_vk.clone(), eng.state.gamma.clone()))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_cvb0_improves_lpp(corpora):
    train, test, _ = corpora
    _, cfg = _cfgs()
    obs, held = split_heldout(test)
    eng = CVB0Engine(cfg, train, batch_size=16, seed=0, device=CPU)
    first = float(log_predictive(cfg, eng.lam, obs, held))
    for _ in range(5):
        eng.run_epoch()
    last = float(log_predictive(cfg, eng.lam, obs, held))
    assert last > first + 0.3


def test_cvb0_count_conservation(corpora):
    """Σ_vk N_vk equals the corpus word count at all times, and N_vk is
    Σ cnt·γ over the memo."""
    train, _, _ = corpora
    _, cfg = _cfgs()
    eng = CVB0Engine(cfg, train, batch_size=16, seed=0, device=CPU)
    total = float(train.num_words)
    for _ in range(6):
        eng.run_minibatch()
        np.testing.assert_allclose(float(eng.state.n_vk.sum()), total,
                                   rtol=1e-4)
    want = lda_estep.segment_scatter_plain(
        train.token_ids.reshape(-1), train.counts.reshape(-1),
        eng.state.gamma.reshape(-1, K), None, SPEC.vocab_size)[0]
    np.testing.assert_allclose(eng.state.n_vk.numpy(), want.numpy(),
                               rtol=1e-3, atol=1e-2)


def test_cvb0_competitive_with_ivi(corpora):
    train, test, _ = corpora
    _, cfg = _cfgs()
    obs, held = split_heldout(test)
    cvb = CVB0Engine(cfg, train, batch_size=16, seed=0, device=CPU)
    ivi = LDAEngine(cfg, train, algo="ivi", batch_size=16, seed=0,
                    device=CPU)
    for _ in range(6):
        cvb.run_epoch()
        ivi.run_epoch()
    l_cvb = float(log_predictive(cfg, cvb.lam, obs, held))
    l_ivi = float(log_predictive(cfg, ivi.state.lam, obs, held))
    assert abs(l_cvb - l_ivi) < 0.4, (l_cvb, l_ivi)


# ---------------------------------------------------------------------------
# Minka's α₀ / β₀
# ---------------------------------------------------------------------------

def test_minka_recovers_concentration():
    rng = np.random.default_rng(0)
    true_a, k, n = 0.7, 10, 4000
    theta = rng.dirichlet([true_a] * k, size=n)
    counts = np.stack([rng.multinomial(50, t) for t in theta])
    post = (true_a + counts).astype(np.float32)
    a_hat = update_alpha0(0.1, torch.from_numpy(post), iters=50)
    assert abs(a_hat - true_a) < 0.25, a_hat
    want = j_update_alpha0(0.1, jnp.asarray(post), iters=50)
    assert a_hat == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("iters", [1, 5, 20])
def test_update_alpha0_matches_repro(iters):
    rng = np.random.default_rng(iters)
    gammas = (0.5 + rng.gamma(2.0, 3.0, (300, 12))).astype(np.float32)
    got = update_alpha0(0.5, torch.from_numpy(gammas), iters)
    want = j_update_alpha0(0.5, jnp.asarray(gammas), iters)
    assert got == pytest.approx(want, rel=1e-5)


def test_update_beta0_matches_repro(corpora):
    train, _, _ = corpora
    _, cfg = _cfgs()
    eng = LDAEngine(cfg, train, algo="ivi", batch_size=16, seed=0,
                    device=CPU)
    eng.run_epoch()
    lam = eng.state.lam
    b = update_beta0(cfg.beta0, lam)
    assert 0 < b < 10
    assert b == pytest.approx(j_update_beta0(cfg.beta0,
                                             jnp.asarray(lam.numpy())),
                              rel=1e-5)


def test_minka_floor_and_float64():
    """The floor holds, and a float64 run (the card's check's reference)
    agrees with the float32 one."""
    post = torch.full((4, 3), 1e-3)
    assert float(minka_update(1.0, post, iters=30)) >= 1e-4
    rng = np.random.default_rng(1)
    g = torch.from_numpy((0.5 + rng.gamma(2.0, 1.0, (64, 5)))
                         .astype(np.float32))
    a32 = float(minka_update(0.3, g, 5))
    a64 = float(minka_update(0.3, g.double(), 5))
    assert minka_update(0.3, g.double(), 5).dtype == torch.float64
    assert a32 == pytest.approx(a64, rel=1e-5)
