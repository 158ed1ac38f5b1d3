"""Port parity, the placement rules (`repro_torch.sharding.rules`) against
``repro.sharding.rules``, and the blocks of a tree at a mesh position.

For all ten architectures, on ``repro``'s two production meshes ((16, 16)
and (2, 16, 16), as ``repro.launch.mesh.make_abstract_mesh`` builds them,
no devices) and under both profiles, the port's ``param_specs`` of the
port's tree equal ``repro``'s of ``jax.eval_shape(T.init_params)`` leaf by
leaf: each port layer against its stage's cycle position, ``repro``'s
stacked lead entry dropped. The same for ``cache_specs`` (every arch, at
the decode shapes: B = 128 and B = 1, whose cache length takes the data
axes) and ``batch_specs``. Every local block has the shape its spec
gives, and ``shard_tree`` / ``unshard_tree`` round-trip bit for bit.
``lm_params_from_repro(..., mesh=, profile=)`` cuts each position's blocks
under the profile's specs.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as j_configs
from repro.launch.mesh import make_abstract_mesh as j_abstract_mesh
from repro.models import transformer as JT
from repro.sharding import rules as JR
from repro_torch import configs as t_configs
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.models import transformer as TT
from repro_torch.sharding import (Spec, batch_specs, cache_specs,
                                  mesh_coords, param_specs, shard_tree,
                                  unshard_tree)
from repro_torch.tree import tree_paths

ARCHS = sorted(j_configs.ARCHS)
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
PROFILES = ("tp_fsdp", "fsdp_only")


def _meshes(kind):
    shape, axes = MESHES[kind]
    return j_abstract_mesh(shape, axes), make_abstract_mesh(shape, axes)


def _entries(spec):
    return tuple(spec)


def _repro_by_layer(specs, cfg, lead: int):
    """``repro``'s stage specs as {(layer, leaf path): entries}, the lead
    entry of a stacked leaf dropped."""
    out = {}
    layer = 0
    for si, (cycle, reps) in enumerate(TT.stage_layout(cfg)):
        for r in range(reps):
            for pos in range(len(cycle)):
                flat, _ = jax.tree_util.tree_flatten_with_path(
                    specs["stages"][si][pos],
                    is_leaf=lambda x: isinstance(x, P))
                for path, spec in flat:
                    key = "/".join(_key(k) for k in path)
                    out[(layer, key)] = _entries(spec)[lead:]
                layer += 1
    return out


def _key(k):
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            v = getattr(k, attr)
            return ("." + v) if attr == "name" else str(v)
    return str(k)


def _port_by_layer(specs):
    out = {}
    for i, layer in enumerate(specs["layers"]):
        for path, spec in _spec_paths(layer):
            out[(i, path)] = tuple(spec)
    return out


def _spec_paths(tree, prefix=()):
    if isinstance(tree, Spec):
        yield "/".join(prefix), tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_paths(tree[k], prefix + (str(k),))
    elif hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _spec_paths(getattr(tree, f), prefix + ("." + f,))
    else:
        for i, v in enumerate(tree):
            yield from _spec_paths(v, prefix + (str(i),))


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_repro(arch, mesh, profile):
    jcfg, tcfg = j_configs.ARCHS[arch], t_configs.ARCHS[arch]
    jmesh, tmesh = _meshes(mesh)
    shapes = jax.eval_shape(lambda: JT.init_params(jcfg,
                                                   jax.random.key(0)))
    want = JR.param_specs(jmesh, shapes, profile=profile)
    got = param_specs(tmesh, TT.param_shapes(tcfg), profile=profile)
    assert _port_by_layer(got) == _repro_by_layer(want, jcfg, 1)
    for top in ("embed", "lm_head", "heads", "final_norm", "shared_attn"):
        if top not in want:
            assert top not in got
            continue
        flat, _ = jax.tree_util.tree_flatten_with_path(
            want[top], is_leaf=lambda x: isinstance(x, P))
        assert {"/".join(_key(k) for k in p): _entries(s)
                for p, s in flat} == \
            {p: tuple(s) for p, s in _spec_paths(got[top])}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_match_repro(arch, mesh):
    jcfg, tcfg = j_configs.ARCHS[arch], t_configs.ARCHS[arch]
    jmesh, tmesh = _meshes(mesh)
    for shape_name in ("decode_32k", "long_500k"):
        jshape = j_configs.INPUT_SHAPES[shape_name]
        jv, _ = j_configs.base.shape_variant(jcfg, jshape)
        tv, _ = t_configs.base.shape_variant(
            tcfg, t_configs.get_shape(shape_name))
        b, w = jshape.global_batch, jshape.seq_len
        jc = jax.eval_shape(lambda: JT.init_caches(jv, b, w))
        tc = TT.init_caches(tv, b, w, device="meta")
        want = JR.cache_specs(jmesh, jv, jc)
        got = cache_specs(tmesh, tv, tc)
        assert _port_by_layer({"layers": got}) == \
            _repro_by_layer({"stages": want}, jv, 1), shape_name
    for shape_name, jshape in j_configs.INPUT_SHAPES.items():
        tshape = t_configs.get_shape(shape_name)
        for train in (False, True):
            want = JR.batch_specs(jmesh, jcfg, jshape, train)
            got = batch_specs(tmesh, tcfg, tshape, train)
            assert {k: _entries(v) for k, v in want.items()} == \
                {k: tuple(v) for k, v in got.items()}, (shape_name, train)


@pytest.mark.parametrize("arch", ARCHS)
def test_local_blocks_have_their_specs_shapes(arch):
    """Every leaf's block at three positions of the production mesh
    (full shapes, on ``meta``) has the shape its spec gives: each dim
    over the product of its axes' sizes, which the rules keep exact."""
    mesh = make_abstract_mesh((16, 16), ("data", "model"))
    sizes = mesh.shape

    def local_shape(dims, spec):
        return tuple(n // int(np.prod([sizes[a] for a in (
            (e,) if isinstance(e, str) else (e or ()))]))
            for n, e in zip(dims, spec))

    full = TT.param_shapes(t_configs.ARCHS[arch])
    specs = param_specs(mesh, full)
    for at in (0, 17, 255):
        blocks = shard_tree(mesh, full, specs, mesh_coords(mesh, at))
        for (path, b), (_, f), (_, s) in zip(tree_paths(blocks),
                                             tree_paths(full),
                                             _spec_items(specs, full)):
            assert tuple(b.shape) == local_shape(f.shape, s), path


def _spec_items(specs, like):
    paths = [p for p, _ in tree_paths(like)]
    flat = []

    def walk(s, t):
        if isinstance(t, torch.Tensor):
            flat.append(s)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(s[k], t[k])
        else:
            for a, b in zip(s, t):
                walk(a, b)
    walk(specs, like)
    return list(zip(paths, flat))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-moe-16b",
                                  "zamba2-1.2b", "xlstm-1.3b",
                                  "musicgen-medium"])
def test_shard_and_unshard_round_trip_bit_for_bit(arch):
    cfg = t_configs.ARCHS[arch].reduced(
        num_layers=6 if arch == "zamba2-1.2b" else 2)
    params = TT.init_params(cfg, 3, device="cpu")
    for shape, axes in (((2, 2), ("data", "model")),
                        ((2, 2, 2), ("pod", "data", "model")),
                        ((1, 4), ("data", "model"))):
        mesh = make_abstract_mesh(shape, axes)
        for profile in PROFILES:
            specs = param_specs(mesh, params, profile)
            blocks = [shard_tree(mesh, params, specs, mesh_coords(mesh, r))
                      for r in range(mesh.size)]
            back = unshard_tree(mesh, blocks, specs)
            for (p, a), (_, b) in zip(tree_paths(params), tree_paths(back)):
                assert torch.equal(a, b), (shape, profile, p)
        caches = TT.init_caches(cfg, 4, 16, torch.float32, device="cpu")
        for leaf in [t for _, t in tree_paths(caches)]:
            leaf.copy_(torch.randn(leaf.shape))
        cspecs = cache_specs(mesh, cfg, caches)
        blocks = [shard_tree(mesh, caches, cspecs, mesh_coords(mesh, r))
                  for r in range(mesh.size)]
        back = unshard_tree(mesh, blocks, cspecs)
        for (p, a), (_, b) in zip(tree_paths(caches), tree_paths(back)):
            assert torch.equal(a, b), (shape, p)
    # numpy leaves too
    arr = {"embed": np.arange(24, dtype=np.float32).reshape(4, 6)}
    mesh = make_abstract_mesh((2, 2), ("data", "model"))
    spec = {"embed": Spec("model", ("data",))}
    blocks = [shard_tree(mesh, arr, spec, mesh_coords(mesh, r))
              for r in range(4)]
    assert blocks[1]["embed"].shape == (2, 3)
    np.testing.assert_array_equal(unshard_tree(mesh, blocks, spec)["embed"],
                                  arr["embed"])


def test_mesh_coords_are_row_major():
    mesh = make_abstract_mesh((2, 3, 4), ("pod", "data", "model"))
    assert mesh_coords(mesh, 0) == {"pod": 0, "data": 0, "model": 0}
    assert mesh_coords(mesh, 5) == {"pod": 0, "data": 1, "model": 1}
    assert mesh_coords(mesh, 23) == {"pod": 1, "data": 2, "model": 3}


@pytest.mark.parametrize("profile", PROFILES)
def test_params_from_repro_take_the_profile(profile):
    """Each position's blocks of ``repro``'s parameters, cut by
    ``lm_params_from_repro(..., mesh=, profile=)``, equal ``shard_tree``
    of the whole tree under ``param_specs(..., profile)``, leaf by
    leaf."""
    from repro_torch.convert import lm_params_from_repro, lm_params_to_repro
    mesh = make_abstract_mesh((2, 2), ("data", "model"))
    for arch in ("qwen2.5-3b", "zamba2-1.2b", "xlstm-1.3b"):
        cfg = t_configs.ARCHS[arch].reduced(
            num_layers=6 if arch == "zamba2-1.2b" else 2)
        theirs = lm_params_to_repro(TT.init_params(cfg, 5, device="cpu"),
                                    cfg)
        whole = lm_params_from_repro(theirs, cfg, device="cpu")
        specs = param_specs(mesh, whole, profile)
        for r in range(mesh.size):
            at = mesh_coords(mesh, r)
            want = shard_tree(mesh, whole, specs, at)
            got = lm_params_from_repro(theirs, cfg, device="cpu", mesh=mesh,
                                       coords=at, profile=profile)
            for (p, a), (q, b) in zip(tree_paths(want), tree_paths(got),
                                      strict=True):
                assert p == q and torch.equal(a, b), (arch, r, p)
    # the two profiles cut the model axis differently
    assert param_specs(mesh, whole, "fsdp_only") != \
        param_specs(mesh, whole, "tp_fsdp")
