"""Port parity, the LM template over a device mesh (`repro_torch.sharding`,
``MeshCtx`` through ``forward``, the prefill and the serve steps): four
gloo ranks spawned on the CPU at (data, model) = (2, 2), one spawn shared
by the tests, each rank with its blocks of ``repro``'s parameters
(``lm_params_from_repro(..., mesh=, coords=)``) and its caches
(``init_caches(..., ctx=)``).

The reference is ``repro``'s own sharded model: ``T.forward``,
``make_prefill_step`` and ``make_serve_step`` with a ``MeshCtx`` on a
4-device JAX CPU mesh, jitted over parameters, caches and inputs placed by
``repro``'s rules. ``repro``'s mesh helper builds a mesh of explicit axes
under JAX 0.9, on which its forward stops in the embedding gather, so the
reference builds its mesh with ``AxisType.Auto`` axes; it runs in a
subprocess whose device count is forced before JAX is imported (the test
process's is not, ``tests/conftest.py``). Reduced configs in fp32, B = 4,
S = 32, held at the LM tests' 2e-4:

* qwen2.5-3b (2 KV heads over model = 2: the cache's heads over
  ``model``), and the same with one KV head (the heads replicated, the
  cache length W over ``model``; at B = 1 W also over ``data``);
* qwen3-moe-30b-a3b at capacity factor 1.0, where the per-rank capacity
  drops tokens that one device would keep: ``repro``'s sharded function
  is not its one-device one, and the ranks must give the sharded one,
  with ``counts`` and ``dropped`` exactly;
* zamba2-1.2b at 6 layers (its shared block at layer 5) and xlstm-1.3b,
  whose recurrent blocks and shared block compute the rank's heads
  (`repro_torch.models.recurrent.Share`) and sum over ``model``; and
  xlstm-1.3b with one head, fewer heads than model ranks: the two model
  ranks split the mLSTM's value columns and repeat the sLSTM's head
  (``repro``'s rules shard its ``r`` on hd).

The children import this module, so JAX is imported inside the fixture
that needs it, never at the top.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn_ranks

B, S, STEPS, CACHE = 4, 32, 4, 32
TOL = 2e-4
# name: (arch, layers, config overrides)
CASES = {"qwen2.5-3b": ("qwen2.5-3b", 2, {}),
         "qwen2.5-3b-kv1": ("qwen2.5-3b", 2, {"num_kv_heads": 1}),
         "qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b", 2,
                               {"moe_capacity_factor": 1.0}),
         "zamba2-1.2b": ("zamba2-1.2b", 6, {}),
         "xlstm-1.3b": ("xlstm-1.3b", 2, {}),
         "xlstm-1.3b-h1": ("xlstm-1.3b", 2, {"num_heads": 1})}
# the decode batches of each case: B = 1 is replicated over the data axes
DECODE = {name: (B, 1) if name == "qwen2.5-3b-kv1" else (B,)
          for name in CASES}
SPAWN_S, GLOO_S = 240.0, 60.0
SRC = Path(__file__).resolve().parents[1] / "src"

REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.checkpoint import io as j_io
    from repro.models import transformer as T
    from repro.models.moe import MeshCtx
    from repro.sharding import cache_specs, param_specs
    from repro.training import make_prefill_step, make_serve_step

    out_dir = sys.argv[1]
    spec = json.loads(sys.argv[2])
    B, S, STEPS, CACHE = spec["shape"]
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    ctx = MeshCtx(mesh, ("data",), "model")

    def put(tree, specs):
        return jax.tree.map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), tree,
            specs, is_leaf=lambda x: isinstance(x, P))

    for name, (arch, layers, kw) in spec["cases"].items():
        cfg = dataclasses.replace(configs.ARCHS[arch].reduced(
            seq_len_hint=S, num_layers=layers), **kw)
        params = T.init_params(cfg, jax.random.key(0))
        j_io.save_checkpoint(os.path.join(out_dir, name + "_params.npz"),
                             params)
        tokens = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)
        ps = put(params, param_specs(mesh, params))
        tok = jax.device_put(tokens, NamedSharding(mesh, P("data", None)))
        logits, aux = jax.jit(lambda p, b: T.forward(cfg, p, b, ctx))(
            ps, {"tokens": tok})
        res = {"tokens": tokens, "logits": np.asarray(logits),
               "prefill": np.asarray(jax.jit(make_prefill_step(cfg, ctx))(
                   ps, {"tokens": tok}))}
        res.update({"aux_" + k: np.asarray(v) for k, v in aux.items()})
        for b in spec["decode"][name]:
            caches = T.init_caches(cfg, b, CACHE, jnp.float32)
            caches = put(caches, cache_specs(mesh, cfg, caches))
            serve = jax.jit(make_serve_step(cfg, ctx))
            steps = []
            for t in range(STEPS):
                _, lg, caches = serve(ps, caches,
                                      jnp.asarray(tokens[:b, t]),
                                      jnp.full((b,), t, jnp.int32))
                steps.append(np.asarray(lg))
            res["decode_b%d" % b] = np.stack(steps)
        np.savez(os.path.join(out_dir, name + "_out.npz"), **res)
""")


def _cfg(name):
    from repro_torch import configs
    arch, layers, kw = CASES[name]
    return dataclasses.replace(configs.ARCHS[arch].reduced(
        seq_len_hint=S, num_layers=layers), **kw)


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------

def _rank(rank, world, ref_dir):
    """Every case on this rank of the (2, 2) mesh: its rows of the
    forward's logits, the prefill's and each decode step's, the MoE
    statistics, where its batch rows lie and the bytes its collectives
    brought in."""
    torch.set_num_threads(1)
    from repro_torch.convert import lm_params_from_repro
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.sharding import RankPlan, make_ctx
    from repro_torch.training import make_prefill_step, make_serve_step

    ctx = make_ctx(make_host_mesh(2, 2, device="cpu"))
    out = {"coords": dict(ctx.comm.coords), "backends": ctx.comm.backends}
    for name in CASES:
        cfg = _cfg(name)
        with np.load(os.path.join(ref_dir, name + "_params.npz")) as f:
            params = lm_params_from_repro(dict(f), cfg, device="cpu",
                                          mesh=ctx.mesh,
                                          coords=ctx.comm.coords)
        with np.load(os.path.join(ref_dir, name + "_out.npz")) as f:
            tokens = torch.from_numpy(f["tokens"]).long()
        ctx.comm.reset()
        plan = RankPlan(cfg, ctx, B)
        with torch.inference_mode():
            logits, aux = T.forward(cfg, params, {"tokens": tokens}, ctx)
            received = dict(ctx.comm.received)
            prefill = make_prefill_step(cfg, ctx)(params,
                                                  {"tokens": tokens})
            res = {"logits": logits.numpy(), "prefill": prefill.numpy(),
                   "rows": (plan.rows.start, plan.rows.stop),
                   "received": received,
                   "param_bytes": sum(t.numel() * t.element_size()
                                      for t in _leaves(params))}
            res.update({"aux_" + k: v.numpy() for k, v in aux.items()})
            serve = make_serve_step(cfg, ctx)
            for b in DECODE[name]:
                caches = T.init_caches(cfg, b, CACHE, torch.float32,
                                       device="cpu", ctx=ctx)
                steps, nexts = [], []
                for t in range(STEPS):
                    nxt, lg, caches = serve(params, caches, tokens[:b, t],
                                            torch.full((b,), t,
                                                       dtype=torch.int32))
                    steps.append(lg.numpy())
                    nexts.append(nxt.numpy())
                res[f"decode_b{b}"] = np.stack(steps)
                res[f"next_b{b}"] = np.stack(nexts)
                res[f"rows_b{b}"] = (RankPlan(cfg, ctx, b).rows.start,
                                     RankPlan(cfg, ctx, b).rows.stop)
        out[name] = res
    return out


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """``repro``'s sharded outputs, and the parameters it drew."""
    import json
    out = tmp_path_factory.mktemp("lm_mesh_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(SRC) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    spec = {"shape": [B, S, STEPS, CACHE], "cases": CASES,
            "decode": DECODE}
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(out),
                           json.dumps(spec)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return out


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    store = tmp_path_factory.mktemp("lm_mesh_store")
    return spawn_ranks(_rank, 4, args=(str(reference),), timeout_s=SPAWN_S,
                       collective_timeout_s=GLOO_S, store_dir=str(store))


def _want(reference, name):
    with np.load(reference / (name + "_out.npz")) as f:
        return dict(f)


def _assembled(ranks, name, key, rows_key="rows"):
    """The global array from the ranks' row blocks (each model rank's the
    same), in data-rank order."""
    parts = {}
    for r in ranks:
        lo, hi = r[name][rows_key]
        got = r[name][key]
        if (lo, hi) in parts:
            np.testing.assert_array_equal(parts[(lo, hi)], got)
        parts[(lo, hi)] = got
    axis = 1 if key.startswith("decode") else 0
    if len(parts) == 1:
        return next(iter(parts.values()))
    return np.concatenate([parts[k] for k in sorted(parts)], axis=axis)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_ranks_hold_their_mesh_positions(ranks):
    coords = sorted((r["coords"]["data"], r["coords"]["model"])
                    for r in ranks)
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(r["backends"] == {"data": "gloo", "model": "gloo"}
               for r in ranks)


@pytest.mark.parametrize("name", list(CASES))
def test_forward_and_prefill_match_repro_sharded(ranks, reference, name):
    want = _want(reference, name)
    _close(_assembled(ranks, name, "logits"), want["logits"])
    _close(_assembled(ranks, name, "prefill"), want["prefill"])
    for r in ranks:
        got = r[name]
        _close(got["aux_lb_loss"], want["aux_lb_loss"])
        # the MoE statistics exactly (small integers summed in order)
        np.testing.assert_array_equal(got["aux_counts"], want["aux_counts"])
        np.testing.assert_array_equal(got["aux_dropped"],
                                      want["aux_dropped"])


@pytest.mark.parametrize("name", list(CASES))
def test_decode_steps_match_repro_sharded(ranks, reference, name):
    want = _want(reference, name)
    for b in DECODE[name]:
        got = _assembled(ranks, name, f"decode_b{b}", f"rows_b{b}")
        _close(got, want[f"decode_b{b}"])
        # the serve step's next tokens are the global batch's, on every
        # rank
        nexts = {r[name][f"next_b{b}"].tobytes() for r in ranks}
        assert len(nexts) == 1
        np.testing.assert_array_equal(
            ranks[0][name][f"next_b{b}"],
            want[f"decode_b{b}"].argmax(-1).astype(np.int32))


def test_moe_sharded_function_is_not_the_one_device_one(ranks, reference):
    """At capacity factor 1.0 the per-rank capacity drops tokens: the
    ranks give repro's sharded function, which the port's ctx=None run
    (one device, no drops) does not."""
    from repro_torch.convert import lm_params_from_repro
    from repro_torch.models import transformer as T
    name = "qwen3-moe-30b-a3b"
    cfg = _cfg(name)
    want = _want(reference, name)
    assert float(want["aux_dropped"]) > 0
    with np.load(reference / (name + "_params.npz")) as f:
        params = lm_params_from_repro(dict(f), cfg, device="cpu")
    with torch.inference_mode():
        single, aux = T.forward(cfg, params,
                                {"tokens": torch.from_numpy(want["tokens"])
                                 .long()})
    assert float(aux["dropped"]) == 0.0
    assert np.abs(single.numpy() - want["logits"]).max() > 100 * TOL
    _close(_assembled(ranks, name, "logits"), want["logits"])


def test_recurrent_blocks_run_whole_and_layouts_move_bytes(ranks):
    """Every rank's collectives brought bytes in: every case, the
    recurrent ones included, sums its blocks' partials over ``model`` (no
    block runs whole), and the forward restores no recurrent state."""
    for r in ranks:
        for name in CASES:
            got = r[name]["received"]
            assert got["all_gather"] > 0 and got["all_reduce"] > 0, name
            assert got["state_restore"] == 0, name


@pytest.mark.parametrize("name", list(CASES))
def test_one_by_one_mesh_is_bit_equal_to_no_ctx(reference, name):
    """A (1, 1) mesh computes ctx=None's bits: every axis of size 1, no
    collective, the same products."""
    from repro_torch.convert import lm_params_from_repro
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.models import transformer as T
    from repro_torch.sharding import make_ctx
    from repro_torch.training import make_prefill_step, make_serve_step
    cfg = _cfg(name)
    want = _want(reference, name)
    tokens = torch.from_numpy(want["tokens"]).long()
    ctx = make_ctx(make_abstract_mesh((1, 1), ("data", "model")))
    with np.load(reference / (name + "_params.npz")) as f:
        flat = dict(f)
    params = lm_params_from_repro(flat, cfg, device="cpu")
    blocks = lm_params_from_repro(flat, cfg, device="cpu", mesh=ctx.mesh,
                                  coords=ctx.comm.coords)
    with torch.inference_mode():
        a, aux_a = T.forward(cfg, params, {"tokens": tokens})
        b, aux_b = T.forward(cfg, blocks, {"tokens": tokens}, ctx)
        assert torch.equal(a, b)
        assert all(torch.equal(aux_a[k], aux_b[k]) for k in aux_a)
        assert torch.equal(make_prefill_step(cfg)(params, {"tokens": tokens}),
                           make_prefill_step(cfg, ctx)(blocks,
                                                       {"tokens": tokens}))
        c1 = T.init_caches(cfg, B, CACHE, torch.float32, device="cpu")
        c2 = T.init_caches(cfg, B, CACHE, torch.float32, device="cpu",
                           ctx=ctx)
        s1, s2 = make_serve_step(cfg), make_serve_step(cfg, ctx)
        for t in range(STEPS):
            pos = torch.full((B,), t, dtype=torch.int32)
            _, l1, c1 = s1(params, c1, tokens[:, t], pos)
            _, l2, c2 = s2(blocks, c2, tokens[:, t], pos)
            assert torch.equal(l1, l2)
