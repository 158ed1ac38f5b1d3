"""Placement rules: parameter paths → ``Spec`` on (pod, data, model)
(``repro.sharding.rules``).

Strategy, as ``repro``'s:
* ``model`` axis — tensor/expert parallel: attention heads, FFN hidden,
  expert dim, vocab dim of embeddings/heads.
* ``fsdp`` = the data axes (("pod", "data") or ("data",)) — fully-sharded
  parameters on the *other* matrix dim; a rank gathers a layer's leaves
  over them when the layer runs (`repro_torch.sharding.ctx.RankPlan`).
* every axis is applied **only when the dim is divisible** by the mesh axis
  size — archs with 2/4/8 KV heads simply replicate those dims over
  ``model``.

The port's parameter tree holds one dict a layer under ``"layers"`` (no
stacked ``reps`` axis), so every leaf's spec starts at its first dim.
``shard_tree`` cuts the block of each leaf that a mesh position holds;
``unshard_tree`` puts the blocks of every position back together.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch.mesh import mesh_layout
from repro_torch.tree import is_namedtuple


class Spec(tuple):
    """One entry a tensor dimension: ``None`` (whole), an axis name, or a
    tuple of axis names (the dimension split over their product, the
    first axis major). A tuple of one name is that name, as in
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "Spec(" + ", ".join(map(repr, self)) + ")"


def entry_axes(entry) -> Tuple[str, ...]:
    """A spec entry's axes as a tuple (``()`` for ``None``)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an ``AbstractMesh``."""
    names, sizes = mesh_layout(mesh)
    return dict(zip(names, sizes))


def fsdp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh_layout(mesh)[0] if a != "model")


def _axis_size(shape: Mapping[str, int], axes) -> int:
    return math.prod(shape[a] for a in entry_axes(axes))


class _Mesh:
    """The rules' view of a mesh: its axis sizes, and whether the model
    axis is vetoed (``repro``'s ``_NoModel``, the fsdp_only profile)."""

    def __init__(self, mesh, use_model: bool = True):
        self.shape = mesh_shape(mesh)
        self.axis_names = tuple(self.shape)
        self.no_model = not use_model


def _fit(mesh: _Mesh, dim: int, axes) -> Optional[Any]:
    """Return ``axes`` if dim divides evenly over them, else None."""
    if mesh.no_model and "model" in entry_axes(axes):
        return None
    return axes if axes and dim % _axis_size(mesh.shape, axes) == 0 \
        else None


def _leaf_spec(mesh: _Mesh, path: Tuple[str, ...], shape: Tuple[int, ...],
               lead: int = 0) -> Spec:
    """Spec for one parameter; ``lead`` = number of leading dims kept
    whole (0 in the port's one-dict-a-layer tree)."""
    fs = tuple(a for a in mesh.axis_names if a != "model")
    name = path[-1]
    parents = set(path)
    core = shape[lead:]
    nd = len(core)

    def spec(*axes):
        return Spec(*([None] * lead), *axes)

    if name == "embed":
        if nd == 3:   # audio (C, V, D)
            return spec(None, _fit(mesh, core[1], "model"),
                        _fit(mesh, core[2], fs))
        return spec(_fit(mesh, core[0], "model"), _fit(mesh, core[1], fs))
    if name == "lm_head":
        return spec(_fit(mesh, core[0], fs), _fit(mesh, core[1], "model"))
    if name == "heads":   # audio (C, D, V)
        return spec(None, _fit(mesh, core[1], fs),
                    _fit(mesh, core[2], "model"))
    if name in ("wq", "wk", "wv"):
        if nd == 3:                      # attention (D, H, hd)
            return spec(_fit(mesh, core[0], fs),
                        _fit(mesh, core[1], "model"), None)
        return spec(None, _fit(mesh, core[1], "model"))   # mLSTM (di, di)
    if name == "wo":                     # (H, hd, D)
        return spec(_fit(mesh, core[0], "model"), None,
                    _fit(mesh, core[2], fs))
    if name in ("bq", "bk", "bv"):       # (H, hd)
        return spec(_fit(mesh, core[0], "model"), None)
    if "moe" in parents and name == "router":
        return spec(_fit(mesh, core[0], fs), None)
    if "moe" in parents and name in ("w_gate", "w_up", "w_down") \
            and nd == 3:                 # experts (E, D|F, F|D)
        return spec(_fit(mesh, core[0], "model"), _fit(mesh, core[1], fs),
                    None)
    if name in ("w_gate", "w_up", "w_in"):   # (D, F)
        return spec(_fit(mesh, core[0], fs), _fit(mesh, core[1], "model"))
    if name == "w_down":                 # (F, D)
        return spec(_fit(mesh, core[0], "model"), _fit(mesh, core[1], fs))
    if name == "in_proj":                # (D|2D, X)
        return spec(_fit(mesh, core[0], fs), _fit(mesh, core[1], "model"))
    if name == "out_proj":               # (d_in, D)
        return spec(_fit(mesh, core[0], "model"), _fit(mesh, core[1], fs))
    if name == "conv_w":                 # (K, C)
        return spec(None, _fit(mesh, core[1], "model"))
    if name in ("conv_b", "norm_scale", "skip"):
        return spec(_fit(mesh, core[0], "model"))
    if name == "w_gates":                # mLSTM (d_in, 2H)
        return spec(_fit(mesh, core[0], "model"), None)
    if name in ("dt_bias", "a_log", "d_skip"):
        return spec(_fit(mesh, core[0], "model"))
    if name == "r":                      # sLSTM (4, H, hd, hd)
        return spec(None, _fit(mesh, core[1], "model"), None,
                    _fit(mesh, core[3], "model")
                    if not _fit(mesh, core[1], "model") else None)
    # norms, biases, small vectors: replicated
    return spec(*([None] * nd))


def _walk(mesh: _Mesh, tree, path: Tuple[str, ...]) -> Any:
    if isinstance(tree, Mapping):
        return {k: _walk(mesh, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_walk(mesh, v, path + (str(i),))
                          for i, v in enumerate(tree))
    strpath = tuple(p for p in path if not p.isdigit())
    return _leaf_spec(mesh, strpath, tuple(tree.shape))


def param_specs(mesh, params_shapes, profile: str = "tp_fsdp") -> Any:
    """A ``Spec`` tree matching ``params_shapes`` (the port's parameter
    tree, or any tree that mirrors it; leaves need only ``.shape``).

    ``profile``: "tp_fsdp" (default) shards over model and the data axes;
    "fsdp_only" drops tensor parallelism (the model axis carries data)."""
    if profile not in ("tp_fsdp", "fsdp_only"):
        raise ValueError(f"profile={profile!r}; expected 'tp_fsdp' or "
                         "'fsdp_only'")
    return _walk(_Mesh(mesh, profile != "fsdp_only"), params_shapes, ())


def batch_specs(mesh, cfg: ModelConfig, shape: InputShape,
                train: bool) -> Dict[str, Spec]:
    """Input placements: batch over the data axes when divisible."""
    m = _Mesh(mesh)
    fs = fsdp_axes(mesh)
    bdim = _fit(m, shape.global_batch, fs)
    if train or shape.kind == "prefill":
        specs = {"tokens": Spec(bdim, None) if cfg.modality != "audio"
                 else Spec(bdim, None, None)}
        if cfg.modality == "vision":
            specs["vision_embeds"] = Spec(bdim, None, None)
        if train:
            specs["labels"] = (Spec(bdim, None) if cfg.modality != "audio"
                               else Spec(bdim, None, None))
        return specs
    # decode: tokens (B,) (+ (B, C) audio), pos (B,)
    return {"tokens": Spec(bdim) if cfg.modality != "audio"
            else Spec(bdim, None), "pos": Spec(bdim)}


def cache_specs(mesh, cfg: ModelConfig, caches) -> Any:
    """Place the decode caches (one a layer, as ``init_caches`` makes
    them; no stacked ``reps`` axis, so the batch is dim 0).

    * the batch dim over the data axes;
    * KV-cache tensors (B, W, kv, hd): KV heads over ``model`` when
      divisible, otherwise the cache length W over ``model``;
    * batch not divisible (B = 1, long context): W takes the data axes too.
    """
    from repro_torch.models.attention import KVCache

    m = _Mesh(mesh)
    fs = fsdp_axes(mesh)

    def default_leaf(x):
        shp = tuple(x.shape)
        if len(shp) < 1:
            return Spec()
        baxis = _fit(m, shp[0], fs)
        rest = [None] * (len(shp) - 1)
        if baxis is None and len(shp) >= 2 and _fit(m, shp[1], fs):
            rest[0] = fs
        return Spec(baxis, *rest)

    def kv_cache(c):
        b, w, kv, hd = c.k.shape
        baxis = _fit(m, b, fs)
        waxes = []
        if baxis is None and _fit(m, w, fs):
            waxes.append(fs)
        if not _fit(m, kv, "model"):
            waxes.append("model")
        kvaxis = "model" if _fit(m, kv, "model") else None
        wspec = tuple(a for ws in waxes for a in entry_axes(ws)) or None
        if wspec is not None and w % _axis_size(m.shape, wspec) != 0:
            wspec = None
        kspec = Spec(baxis, wspec, kvaxis, None)
        return KVCache(k=kspec, v=kspec, slot_pos=Spec(baxis, wspec))

    def walk(node):
        if isinstance(node, KVCache):
            return kv_cache(node)
        if is_namedtuple(node):
            return type(node)(*(walk(v) for v in node))
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        return default_leaf(node)

    return walk(caches)


# ---------------------------------------------------------------------------
# blocks of a tree at a mesh position
# ---------------------------------------------------------------------------

def mesh_coords(mesh, rank: int) -> Dict[str, int]:
    """The coordinates of ``rank`` (row-major over the axes, the first
    major: the rank order of ``init_device_mesh``)."""
    shape = mesh_shape(mesh)
    coords = {}
    for axis in reversed(tuple(shape)):
        rank, coords[axis] = divmod(rank, shape[axis])
    return {a: coords[a] for a in shape}


def _coords(mesh, coords: Mapping[str, int]) -> Dict[str, int]:
    shape = mesh_shape(mesh)
    out = {a: int(coords[a]) for a in shape}
    for a, c in out.items():
        if not 0 <= c < shape[a]:
            raise ValueError(f"coordinate {a}={c} outside the mesh {shape}")
    return out


def block_slices(shape: Mapping[str, int], coords: Mapping[str, int],
                 dims: Sequence[int], spec: Spec) -> Tuple[slice, ...]:
    """The slices of a leaf of shape ``dims`` that position ``coords``
    holds under ``spec``."""
    if len(spec) != len(dims):
        raise ValueError(f"spec {spec} for a leaf of shape {tuple(dims)}")
    out = []
    for n, entry in zip(dims, spec):
        axes = entry_axes(entry)
        size = math.prod(shape[a] for a in axes)
        if n % size:
            raise ValueError(f"dim {n} does not divide over {axes} ({size})")
        idx = 0
        for a in axes:
            idx = idx * shape[a] + coords[a]
        step = n // size
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def _map_leaves(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree``'s leaves; the recursion follows
    ``tree`` (a ``Spec`` is a tuple, so it is never walked into)."""
    if isinstance(tree, Mapping):
        return {k: _map_leaves(fn, v, specs[k]) for k, v in tree.items()}
    if is_namedtuple(tree):
        return type(tree)(*(_map_leaves(fn, v, s)
                            for v, s in zip(tree, specs)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def _copy(block):
    if isinstance(block, torch.Tensor):
        return block.clone(memory_format=torch.contiguous_format)
    return np.array(block)


def shard_tree(mesh, tree, specs, coords) -> Any:
    """The block of each leaf of ``tree`` (tensors or numpy arrays, full
    shapes) that the mesh position ``coords`` ({axis name: index}) holds
    under ``specs`` (``param_specs``, ``cache_specs``, ``batch_specs``):
    copies, so the full leaves can be freed."""
    shape, at = mesh_shape(mesh), _coords(mesh, coords)
    return _map_leaves(
        lambda x, s: _copy(x[block_slices(shape, at, x.shape, s)]),
        tree, specs)


def unshard_tree(mesh, blocks: Sequence[Any], specs) -> Any:
    """``shard_tree``'s inverse: the full leaves from every position's
    blocks, ``blocks[r]`` the tree of rank ``r`` (``mesh_coords``'
    order). A leaf replicated over an axis is taken from that axis's
    first position."""
    shape = mesh_shape(mesh)
    n = math.prod(shape.values())
    if len(blocks) != n:
        raise ValueError(f"{len(blocks)} blocks for a mesh of {n}")
    coords = [mesh_coords(mesh, r) for r in range(n)]

    def full(spec, *leaves):
        first = leaves[0]
        dims = [d * _axis_size(shape, e) for d, e in zip(first.shape, spec)]
        if isinstance(first, torch.Tensor):
            out = first.new_empty(dims)
        else:
            out = np.empty(dims, dtype=first.dtype)
        for at, leaf in zip(coords, leaves):
            out[block_slices(shape, at, dims, spec)] = leaf
        return out

    def walk(specs_node, *nodes):
        first = nodes[0]
        if isinstance(first, Mapping):
            return {k: walk(specs_node[k], *(nd[k] for nd in nodes))
                    for k in first}
        if is_namedtuple(first):
            return type(first)(*(walk(s, *(nd[i] for nd in nodes))
                                 for i, s in enumerate(specs_node)))
        if isinstance(first, (tuple, list)):
            return type(first)(walk(s, *(nd[i] for nd in nodes))
                               for i, s in enumerate(specs_node))
        return full(specs_node, *nodes)

    return walk(specs, *blocks)
