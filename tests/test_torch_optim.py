"""Port parity, the optimizers (``repro.optim``): AdamW with and without
weight decay, SGD, IAG over several and repeated shards, the cosine
schedule, global-norm clipping and ``apply_updates``, held against
``repro``'s on the same gradients and states over three updates at 1e-6
relative; and a quadratic minimised by each, as ``repro``'s
``test_optimizers_minimize_quadratic`` asks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as J
from repro_torch import optim as O
from repro_torch.tree import tree_leaves

RTOL = 1e-6
SHAPES = {"a": (3, 5), "b": [(7,), (2, 2, 4)]}


def _grads(rng, scale=1.0):
    """A tree of float32 numpy arrays in the port's structure (dicts and
    lists)."""
    tree = {"a": rng.normal(0, scale, SHAPES["a"]).astype(np.float32),
            "b": [rng.normal(0, scale, s).astype(np.float32)
                  for s in SHAPES["b"]]}
    return tree


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _close(got, want, rtol=RTOL, atol=1e-9):
    got_leaves = [t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
                  for t in tree_leaves(got)]
    want_leaves = jax.tree.leaves(_np(want))
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


OPTIMIZERS = {
    "adamw": (lambda: J.adamw(1e-2), lambda: O.adamw(1e-2)),
    "adamw_wd": (lambda: J.adamw(3e-3, weight_decay=0.1),
                 lambda: O.adamw(3e-3, weight_decay=0.1)),
    "adamw_cosine": (lambda: J.adamw(J.cosine_schedule(1e-2, 2, 5)),
                     lambda: O.adamw(O.cosine_schedule(1e-2, 2, 5))),
    "sgd": (lambda: J.sgd(5e-2), lambda: O.sgd(5e-2)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_updates_match_repro_over_three_steps(name):
    make_j, make_t = OPTIMIZERS[name]
    rng = np.random.default_rng(0)
    params_np = _grads(rng)
    jopt, topt = make_j(), make_t()
    jp = jax.tree.map(jnp.asarray, params_np)
    tp = _torch(params_np)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        g = _grads(rng)
        jupd, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tupd, ts = topt.update(_torch(g), ts, tp)
        _close(tupd, jupd)
        jp = J.apply_updates(jp, jupd)
        tp = O.apply_updates(tp, tupd)
        _close(tp, jp)
    for key in js:
        if key == "count":
            assert int(ts[key]) == int(js[key]) == 3
        else:
            _close(ts[key], js[key])


@pytest.mark.parametrize("shards,order", [(3, [0, 1, 2, 0, 2, 1]),
                                          (4, [1, 1, 3, 0, 3])])
def test_iag_matches_repro(shards, order):
    """Several shards, and a shard repeated: the memo row is replaced, the
    aggregate subtracts the old gradient and adds the new, the step
    divides by the shards seen."""
    rng = np.random.default_rng(1)
    params_np = _grads(rng)
    jopt, topt = J.iag(0.1, shards), O.iag(0.1, shards)
    jp = jax.tree.map(jnp.asarray, params_np)
    tp = _torch(params_np)
    js, ts = jopt.init(jp), topt.init(tp)
    for s in order:
        g = _grads(rng)
        jupd, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp,
                               shard=jnp.asarray(s))
        tupd, ts = topt.update(_torch(g), ts, tp, shard=s)
        _close(tupd, jupd)
        jp = J.apply_updates(jp, jupd)
        tp = O.apply_updates(tp, tupd)
    _close(tp, jp)
    _close(ts["memo"], js["memo"])
    _close(ts["agg"], js["agg"])
    np.testing.assert_array_equal(ts["seen"].numpy(), np.asarray(js["seen"]))
    for agg, memo in zip(tree_leaves(ts["agg"]), tree_leaves(ts["memo"])):
        np.testing.assert_allclose(agg.numpy(), memo.sum(0).numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("max_norm,scale", [(1.0, 10.0), (100.0, 0.1)])
def test_clip_by_global_norm_matches_repro(max_norm, scale):
    """Clipped (the norm above the bound) and untouched (below it)."""
    g = _grads(np.random.default_rng(2), scale)
    jc, jn = J.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    tc, tn = O.clip_by_global_norm(_torch(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
    _close(tc, jc)
    total = float(torch.sqrt(sum(torch.sum(x ** 2)
                                 for x in tree_leaves(tc))))
    assert total == pytest.approx(min(float(tn), max_norm), rel=1e-5)


def test_cosine_schedule_matches_repro():
    jlr, tlr = J.cosine_schedule(1e-3, 10, 100), O.cosine_schedule(1e-3, 10,
                                                                  100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(float(tlr(step)), float(jlr(step)),
                                   rtol=RTOL, atol=1e-12)
        got = tlr(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == float(tlr(step))
    assert float(tlr(0)) == 0.0
    assert float(tlr(100)) < 1e-5


def test_apply_updates_in_place_and_in_dtype():
    rng = np.random.default_rng(3)
    p, u = _grads(rng), _grads(rng)
    tp = _torch(p)
    before = [t for t in tree_leaves(tp)]
    out = O.apply_updates(tp, _torch(u))
    assert all(a is b for a, b in zip(tree_leaves(out), before))
    _close(out, J.apply_updates(jax.tree.map(jnp.asarray, p),
                                jax.tree.map(jnp.asarray, u)), rtol=0,
           atol=0)


def test_update_writes_into_the_gradients_and_the_state():
    """The documented in-place contract: the updates land in the gradients'
    buffers and the moments in the state's."""
    opt = O.adamw(1e-2)
    p = _torch(_grads(np.random.default_rng(4)))
    state = opt.init(p)
    m_before = tree_leaves(state["m"])
    g = _torch(_grads(np.random.default_rng(5)))
    g_before = tree_leaves(g)
    upd, new = opt.update(g, state, p)
    assert all(a is b for a, b in zip(tree_leaves(upd), g_before))
    assert all(a is b for a, b in zip(tree_leaves(new["m"]), m_before))
    assert new["count"].dtype == torch.int32 and int(new["count"]) == 1


@pytest.mark.parametrize("make", [lambda: O.adamw(0.1), lambda: O.sgd(0.05),
                                  lambda: O.adamw(0.1, weight_decay=1e-3)])
def test_optimizers_minimize_quadratic(make):
    opt = make()
    theta = torch.zeros((4,))
    state = opt.init(theta)
    for _ in range(200):
        g = 2.0 * (theta - 3.0)
        upd, state = opt.update(g, state, theta)
        theta = O.apply_updates(theta, upd)
    assert float(torch.sum((theta - 3.0) ** 2)) < 1e-2


def test_iag_minimizes_the_average_loss():
    """IAG = full-gradient descent once every shard is memoized: it finds
    the mean of the shards' targets, and the aggregate is the memo's
    sum."""
    data = torch.arange(1.0, 5.0)
    opt = O.iag(0.3, 4)
    theta = torch.zeros(())
    state = opt.init(theta)
    for step in range(80):
        s = step % 4
        upd, state = opt.update(theta - data[s], state, theta, shard=s)
        theta = O.apply_updates(theta, upd)
    assert abs(float(theta) - float(data.mean())) < 1e-2
    np.testing.assert_allclose(float(state["agg"]),
                               float(state["memo"].sum()), rtol=1e-5,
                               atol=1e-6)
