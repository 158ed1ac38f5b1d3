"""Port parity, the MoE FFN (``repro.models.moe``): ``moe_ffn`` and its
aux statistics against ``repro``'s on both MoE archs' reduced configs, the
capacity and the dropped count of a rank of a mesh, the router's ties,
the routed sum's order and determinism, and the bf16 parameter builder.

Inputs come from numpy seeds and ``repro``'s params (``moe_init``); fp32 on
the CPU. The output and ``lb_loss`` are held at ``repro``'s logit bar,
2e-4 (``tests/test_decode_consistency.py``); ``counts`` and ``dropped``
exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import moe as JM
from repro_torch import configs as t_configs
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT

MOE_ARCHS = ["deepseek-moe-16b", "qwen3-moe-30b-a3b"]
TOL = 2e-4
CPU = torch.device("cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return _t(tree)


def _moe(arch, seed=0, **changes):
    """(repro's cfg, the port's cfg, repro's moe params as numpy, the
    port's as tensors) at the arch's reduced widths."""
    cj = dataclasses.replace(j_configs.ARCHS[arch].reduced(), **changes)
    ct = dataclasses.replace(t_configs.ARCHS[arch].reduced(), **changes)
    pj = jax.tree.map(np.asarray, JM.moe_init(cj, jax.random.key(seed)))
    return cj, ct, pj, _torch_tree(pj)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("shape", [(2, 16), (3, 7), (1, 1)])
def test_moe_ffn_matches_repro(arch, shape, rng):
    cj, ct, pj, pt = _moe(arch)
    x = rng.normal(0, 1, shape + (ct.d_model,)).astype(np.float32)
    want_y, want_aux = JM.moe_ffn(cj, pj, jnp.asarray(x), None)
    got_y, got_aux = TM.moe_ffn(ct, pt, _t(x))
    assert got_y.shape == want_y.shape and got_y.dtype == torch.float32
    _close(got_y, want_y)
    assert set(got_aux) == set(want_aux)
    assert np.array_equal(got_aux["counts"].numpy(),
                          np.asarray(want_aux["counts"]))
    _close(got_aux["lb_loss"], want_aux["lb_loss"])
    assert float(got_aux["dropped"]) == float(want_aux["dropped"]) == 0.0


@pytest.mark.parametrize("rank", [0, 1])
def test_moe_ffn_local_rank_of_a_mesh_drops_as_repro(rank, rng):
    """A rank of two with a capacity below its rows: the partial output,
    the counts and the dropped count against ``repro``'s
    ``moe_ffn_local`` (the formula one card runs with nothing dropped)."""
    cj, ct, pj, pt = _moe("qwen3-moe-30b-a3b", seed=1,
                          moe_capacity_factor=0.25)
    el = ct.num_experts // 2
    pj = {k: v if k == "router" else v[rank * el:(rank + 1) * el]
          for k, v in pj.items()}
    x = rng.normal(0, 1, (40, ct.d_model)).astype(np.float32)
    want_y, want_aux = JM.moe_ffn_local(cj, pj, jnp.asarray(x),
                                        jnp.asarray(rank, jnp.int32), 2)
    got_y, got_aux = TM.moe_ffn_local(ct, _torch_tree(pj), _t(x), rank, 2)
    _close(got_y, want_y)
    assert float(got_aux["dropped"]) == float(want_aux["dropped"]) > 0
    assert np.array_equal(got_aux["counts"].numpy(),
                          np.asarray(want_aux["counts"]))


def test_capacity_matches_repro():
    for arch in MOE_ARCHS:
        for factor in (0.25, 1.0, 1.25):
            cj = dataclasses.replace(j_configs.ARCHS[arch],
                                     moe_capacity_factor=factor)
            ct = dataclasses.replace(t_configs.ARCHS[arch],
                                     moe_capacity_factor=factor)
            for n in (1, 2, 3, 7, 64, 4096):
                for m in (1, 2, 4):
                    assert TM._capacity(ct, n, m) == JM._capacity(cj, n, m)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_ties_go_to_the_lower_index(arch, rng):
    """Experts 1 and 3 with the same router column, and 0 and 2 with
    another: every token's probabilities tie in pairs. ``jax.lax.top_k``
    keeps the lower index; so must the port, and the outputs agree."""
    cj, ct, pj, pt = _moe(arch, seed=2)
    router = pj["router"].copy()
    router[:, 3] = router[:, 1]
    router[:, 2] = router[:, 0]
    pj = dict(pj, router=router)
    pt = dict(pt, router=_t(router))
    x = rng.normal(0, 1, (24, ct.d_model)).astype(np.float32)
    probs = jax.nn.softmax((jnp.asarray(x) @ router).astype(jnp.float32), -1)
    _, want_i = jax.lax.top_k(probs, ct.num_experts_per_tok)
    _, _, got_i = TM.route(ct, pt, _t(x))
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    # each token's top 2 is a tied pair, the lower index first
    assert (got_i[:, 1] - got_i[:, 0] == 2).all()
    want_y, want_aux = JM.moe_ffn_local(cj, pj, jnp.asarray(x),
                                        jnp.asarray(0, jnp.int32), 1)
    got_y, got_aux = TM.moe_ffn_local(ct, pt, _t(x))
    _close(got_y, want_y)
    assert np.array_equal(got_aux["counts"].numpy(),
                          np.asarray(want_aux["counts"]))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_routed_sum_in_ascending_expert_order_and_deterministic(arch, rng):
    """bf16, top 3 of 4: each token's k routed rows are added in ascending
    expert order, as ``repro``'s scatter-add over the stably sorted rows
    adds them, and the same bits come on two runs. The expert rows are
    ``expert_ffn`` on each expert's sorted rows, as the layer runs it; the
    sum in the router's order gives other bits."""
    _, ct, _, pt = _moe(arch, seed=3)
    ct = dataclasses.replace(ct, dtype="bfloat16", num_shared_experts=0,
                             num_experts_per_tok=3)
    pt = TT._cast_tree(pt, torch.bfloat16)
    pt.pop("shared", None)
    x = _t(rng.normal(0, 1, (33, ct.d_model)).astype(np.float32)).bfloat16()
    y1, _ = TM.moe_ffn_local(ct, pt, x)
    y2, _ = TM.moe_ffn_local(ct, pt, x)
    assert torch.equal(y1, y2)
    _, top_p, top_i = TM.route(ct, pt, x)
    rows = {}                     # (token, expert) → its weighted output
    for g in range(ct.num_experts):
        tok, slot = torch.nonzero(top_i == g, as_tuple=True)  # ascending
        if len(tok):
            out = TM.expert_ffn(pt, g, x[tok]) \
                * top_p[tok, slot].bfloat16()[:, None]
            rows.update({(int(t), g): out[i] for i, t in enumerate(tok)})

    def summed(order):
        y = torch.zeros_like(x)
        for t in range(x.shape[0]):
            for g in order(top_i[t].tolist()):
                y[t] = y[t] + rows[(t, g)]
        return y

    assert torch.equal(y1, summed(sorted))
    assert not torch.equal(y1, summed(list))       # the router's order


def test_moe_mesh_raises_naming_its_item():
    """The MoE block serves and trains over a mesh (ROADMAP §1 items 10.4
    and 10.5): on a rank's plan of a (1, 1) mesh it is ctx=None's block
    bit for bit, and ``moe_block_emulated`` at (1, 1) too; under autograd
    its gradients are ctx=None's bits, and so are ``loss_fn``'s on a MoE
    pattern (the sharded block against ``repro``'s is
    ``tests/test_torch_train_mesh.py``)."""
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.sharding import RankPlan, make_ctx
    from repro_torch.sharding.ctx import LayerPlan
    _, ct, _, pt = _moe("deepseek-moe-16b")
    x = torch.randn(2, 8, ct.d_model, generator=torch.Generator()
                    .manual_seed(0))
    ctx = make_ctx(make_abstract_mesh((1, 1), ("data", "model")))
    cfg = dataclasses.replace(ct, num_layers=2, layer_pattern=("moe",) * 2)
    plan = RankPlan(cfg, ctx, 2)
    y0, aux0 = TM.moe_ffn(ct, pt, x)
    for y, aux in (TM.moe_ffn(ct, pt, x,
                              LayerPlan(plan, plan.specs["layers"][0])),
                   TM.moe_block_emulated(ct, pt, x, data=1, model=1)):
        assert torch.equal(y, y0)
        assert all(torch.equal(aux[k], aux0[k]) for k in aux0)
    def grads(tp):
        p = {k: (v.detach().requires_grad_(True) if torch.is_tensor(v)
                 else v) for k, v in pt.items()}
        xx = x.clone().requires_grad_(True)
        y, aux = TM.moe_ffn(ct, p, xx, tp)
        (y.square().sum() + aux["lb_loss"]).backward()
        return [xx.grad] + [p[k].grad for k in ("router", "w_gate", "w_up",
                                                "w_down")]
    for g0, g1 in zip(grads(None),
                      grads(LayerPlan(plan, plan.specs["layers"][0])),
                      strict=True):
        assert torch.equal(g0, g1)
    params = TT.init_params(cfg, 0, device=CPU)
    toks = torch.arange(2 * 8).reshape(2, 8) % cfg.vocab_size
    train = {"tokens": toks, "labels": (toks * 5 + 1) % cfg.vocab_size}
    assert torch.equal(TT.loss_fn(cfg, params, train, ctx)[0],
                       TT.loss_fn(cfg, params, train)[0])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_init_shapes_match_repro(arch):
    cj, ct, pj, _ = _moe(arch)
    got = TM.moe_init(ct, generator=torch.Generator().manual_seed(0),
                      device=CPU)
    shapes = jax.tree.map(lambda a: a.shape, pj)
    assert jax.tree.map(lambda t: tuple(t.shape), got) == shapes
    # truncated at 2σ, σ = d^-1/2 for the router and the up projections
    assert float(got["router"].abs().max()) <= 2 * ct.d_model ** -0.5


@pytest.mark.parametrize("arch", sorted(t_configs.ARCHS))
def test_bf16_builder_bit_equal_to_cast_params(arch):
    """``init_params(..., cast=True)`` casts each array as it is drawn:
    the same generator and order of draws, so bit for bit
    ``cast_params(init_params(...))``, with the norms and the recurrent
    blocks' fp32 leaves left in fp32."""
    cfg = dataclasses.replace(
        t_configs.ARCHS[arch].reduced(num_layers=6, seq_len_hint=16),
        dtype="bfloat16")
    want = TT.cast_params(cfg, TT.init_params(cfg, 5, device=CPU))
    got = TT.init_params(cfg, 5, device=CPU, cast=True)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
        keys = {getattr(k, "key", None) for k in path}
        fp32 = bool(keys & TT.KEEP_FP32)
        assert a.dtype == (torch.float32 if fp32 else torch.bfloat16), path
