"""Numpy → port state: read the arrays a ``repro`` run writes.

``state_from_numpy`` takes the keys ``repro`` captures for a checkpoint
(``lam``, ``m_vk``, ``init_mass``, ``init_frac``, ``t``; see
``repro/lda/trainer.py``) and ``memo_from_numpy`` the ``{"pi", "visited"}``
that ``repro``'s ``DenseMemoStore.state_dict()`` returns, so a state built
by either package can continue in the port. ``lda_from_repro_checkpoint``
loads a whole ``repro`` facade checkpoint (a manifest directory).

``lm_params_from_repro`` takes ``repro``'s LM parameters (its pytree as
numpy, or the flat dict an npz checkpoint of it holds,
`repro_torch.checkpoint.io`) to the port's layout, each stage's stacked
layers unstacked into one dict a layer; ``lm_params_to_repro`` is its
inverse, so ``repro`` can run on the port's own init. ``lm_caches_to_repro``
and ``lm_caches_from_repro`` do the same for the decode caches (KV ring
buffers, the recurrent blocks' named tuples, zamba2's pairs), so a decode
can stop in one package and go on in the other. ``lm_train_state_from_repro``
and ``lm_train_state_to_repro`` carry a whole training state across: the
parameters, the optimizer's state (AdamW's ``m``/``v``, SGD's ``mu``,
IAG's ``memo``/``agg``/``seen`` with the memo's leading shard axis, and
``count``) and the step, so a run can start in one package from the
other's state.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.checkpoint.io import STEP_KEY
from repro_torch.configs.base import ModelConfig
from repro_torch.core.memo import DenseMemoStore
from repro_torch.core.types import GlobalState, resolve_device
from repro_torch.models.transformer import stage_layout
from repro_torch.training.steps import TrainState, shard_train_state
from repro_torch.tree import tree_map

STATE_FIELDS = ("lam", "m_vk", "init_mass", "init_frac", "t")


def state_from_numpy(arrays: Mapping[str, np.ndarray],
                     device=None) -> GlobalState:
    """Build a ``GlobalState`` from numpy arrays (float32 leaves, int32 t)."""
    missing = [f for f in STATE_FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"state arrays lack {missing}")
    device = resolve_device(device)

    def leaf(name, dtype):
        return torch.from_numpy(np.array(arrays[name], dtype=dtype)).to(device)

    state = GlobalState(lam=leaf("lam", np.float32),
                        m_vk=leaf("m_vk", np.float32),
                        init_mass=leaf("init_mass", np.float32),
                        init_frac=leaf("init_frac", np.float32),
                        t=leaf("t", np.int32))
    shape = tuple(state.lam.shape)
    for name in ("m_vk", "init_mass"):
        if tuple(getattr(state, name).shape) != shape:
            raise ValueError(f"{name} has shape "
                             f"{tuple(getattr(state, name).shape)}, "
                             f"lam has {shape}")
    if state.init_frac.ndim != 0 or state.t.ndim != 0:
        raise ValueError("init_frac and t must be scalars")
    return state


def memo_from_numpy(arrays: Mapping[str, np.ndarray],
                    device=None) -> DenseMemoStore:
    """Build a ``DenseMemoStore`` from ``{"pi": (D, L, K), "visited": (D,)}``."""
    device = resolve_device(device)
    pi = np.array(arrays["pi"], dtype=np.float32)
    visited = np.array(arrays["visited"], dtype=bool)
    if pi.ndim != 3 or visited.shape != pi.shape[:1]:
        raise ValueError(f"memo arrays: pi {pi.shape}, visited "
                         f"{visited.shape}")
    return DenseMemoStore(pi=torch.from_numpy(pi).to(device),
                          visited=torch.from_numpy(visited).to(device))


def lda_from_repro_checkpoint(path: str, device=None):
    """A ``repro`` ``LDA.save`` directory as the port's ``LDA``: serving
    works at once, ``resume(corpus)`` continues the run (the port's
    ``load_lda_checkpoint``; the two packages share the format)."""
    from repro_torch.lda.ckpt import load_lda_checkpoint
    return load_lda_checkpoint(path, device=device)


# ---------------------------------------------------------------------------
# the LM template's parameters
# ---------------------------------------------------------------------------

LM_TOP_ARRAYS = ("embed", "lm_head", "heads")
# the top-level dicts: the final norm, zamba2's shared attention block
LM_TOP_TREES = ("final_norm", "shared_attn")


def _stack(group):
    """Trees of one structure → one tree of their leaves stacked."""
    first = group[0]
    if isinstance(first, Mapping):
        return {k: _stack([g[k] for g in group]) for k in first}
    if isinstance(first, tuple):
        parts = [_stack([g[i] for g in group]) for i in range(len(first))]
        return type(first)(*parts) if hasattr(first, "_fields") \
            else tuple(parts)
    return np.stack(group)


def _to_stages(layers, cfg: ModelConfig) -> tuple:
    """One tree a layer → ``repro``'s stages: a tuple a stage of a tuple a
    cycle position, each layer of the position stacked on a leading
    ``reps`` axis."""
    stages, start = [], 0
    for cycle, reps in stage_layout(cfg):
        n = len(cycle)
        stages.append(tuple(
            _stack([layers[start + r * n + pos] for r in range(reps)])
            for pos in range(n)))
        start += n * reps
    return tuple(stages)


def _from_stages(stages, cfg: ModelConfig, leaf) -> list:
    """``_to_stages``' inverse: ``leaf`` of each layer's slice."""
    layers = []
    for si, (cycle, reps) in enumerate(stage_layout(cfg)):
        stage = _child(stages, si)
        for r in range(reps):
            for pos in range(len(cycle)):
                layers.append(tree_map(lambda a: leaf(np.asarray(a)[r]),
                                        _child(stage, pos)))
    return layers


def _child(node, i: int):
    """Entry ``i`` of a sequence, or of a dict keyed by ``str(i)`` (a tree
    rebuilt from checkpoint paths)."""
    return node[str(i)] if isinstance(node, Mapping) else node[i]


def _nested(flat: Mapping[str, Any]) -> dict:
    """``{"a/b/0": x}`` → ``{"a": {"b": {"0": x}}}``; ``__step__`` dropped."""
    root: dict = {}
    for key, arr in flat.items():
        if key == STEP_KEY:
            continue
        *parents, name = key.split("/")
        node = root
        for part in parents:
            node = node.setdefault(part, {})
        node[name] = arr
    return root


def lm_params_from_repro(params_np: Mapping[str, Any], cfg: ModelConfig,
                         device=None, *, mesh=None, coords=None,
                         profile: str = "tp_fsdp") -> dict:
    """``repro``'s params (pytree leaves as numpy or any array numpy reads,
    or the flat ``{path: array}`` of its npz checkpoint) as the port's: the
    same arrays and dtypes on ``device``, ``params["layers"][i]`` for
    ``cfg.pattern[i]`` (an MoE layer's expert stacks keep their (E, D, F)
    shape), zamba2's shared block under ``"shared_attn"``.

    With a ``mesh`` (and the position ``coords``, as
    `repro_torch.sharding.shard_tree` takes them) the rank's blocks under
    ``param_specs(mesh, ..., profile)`` (the ``MeshCtx``'s profile,
    "tp_fsdp" or "fsdp_only"): each leaf is cut on the host, and only its
    block reaches ``device``."""
    device = resolve_device(device)
    tree = params_np if "stages" in params_np else _nested(params_np)
    out = {k: np.asarray(tree[k]) for k in LM_TOP_ARRAYS if k in tree}
    for k in LM_TOP_TREES:
        if k in tree:
            out[k] = tree_map(np.asarray, tree[k])
    out["layers"] = _from_stages(tree["stages"], cfg, lambda a: a)
    if mesh is not None:
        from repro_torch.sharding.rules import param_specs, shard_tree
        out = shard_tree(mesh, out, param_specs(mesh, out, profile), coords)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), out)


def lm_params_to_repro(params: Mapping[str, Any], cfg: ModelConfig) -> dict:
    """The port's LM params as ``repro``'s pytree of numpy arrays: each
    stage's layers stacked on a leading ``reps`` axis, stages and cycle
    positions as tuples."""

    def arr(t):
        return t.detach().cpu().numpy()

    out = {k: arr(params[k]) for k in LM_TOP_ARRAYS if k in params}
    for k in LM_TOP_TREES:
        if k in params:
            out[k] = tree_map(arr, params[k])
    out["stages"] = _to_stages([tree_map(arr, p)
                                for p in params["layers"]], cfg)
    return out


def lm_caches_to_repro(caches, cfg: ModelConfig) -> tuple:
    """The port's decode caches (one a layer, as ``init_caches`` and
    ``decode_step`` give them) as ``repro``'s ``init_caches`` layout of
    numpy arrays: stages of cycle positions, each stacked on ``reps``."""
    return _to_stages([tree_map(lambda t: t.detach().cpu().numpy(), c)
                       for c in caches], cfg)


def lm_caches_from_repro(caches_np, cfg: ModelConfig, device=None) -> list:
    """``repro``'s decode caches (its stage layout, numpy leaves) as the
    port's, one a layer on ``device``, named tuples kept."""
    device = resolve_device(device)
    return _from_stages(caches_np, cfg,
                        lambda a: torch.from_numpy(np.array(a)).to(device))


# ---------------------------------------------------------------------------
# the LM template's training state
# ---------------------------------------------------------------------------

# the optimizer-state entries shaped as the parameters (repro.optim)
LM_OPT_TREES = ("m", "v", "mu", "agg")


def _reps_first(tree: Mapping[str, Any]) -> dict:
    """An IAG memo in ``repro``'s layout has the shard axis first
    everywhere, so its stage leaves are (shards, reps, ...): put ``reps``
    first, where ``_from_stages`` slices it."""
    out = dict(tree)
    out["stages"] = tree_map(lambda a: np.moveaxis(np.asarray(a), 1, 0),
                              tree["stages"])
    return out


def lm_train_state_from_repro(state, cfg: ModelConfig, device=None, *,
                              ctx=None):
    """``repro``'s ``TrainState`` (any object with ``params``,
    ``opt_state`` and ``step``; leaves numpy or anything numpy reads) as
    the port's ``TrainState`` on ``device``: the parameters and every
    parameter-shaped optimizer tree in the port's layout (one dict a
    layer), IAG's memo with its shard axis leading each leaf, the scalars
    and ``seen`` as tensors.

    With a ``MeshCtx`` the rank's blocks of it
    (`repro_torch.training.shard_train_state`): the state is put together
    on the host, cut, and only the blocks reach ``device``."""
    device = resolve_device(device)
    if ctx is not None:
        full = lm_train_state_from_repro(state, cfg, torch.device("cpu"))
        blocks = shard_train_state(cfg, full, ctx)
        return TrainState(*(tree_map(lambda t: t.to(device), part)
                            for part in (blocks.params, blocks.opt_state,
                                         blocks.step)))

    def leaf(a):
        return torch.from_numpy(np.array(a)).to(device)

    opt = {}
    for key, val in state.opt_state.items():
        if key in LM_OPT_TREES:
            opt[key] = lm_params_from_repro(val, cfg, device)
        elif key == "memo":
            opt[key] = lm_params_from_repro(_reps_first(val),
                                            cfg, device)
        else:
            opt[key] = leaf(val)
    return TrainState(lm_params_from_repro(state.params, cfg, device), opt,
                      leaf(state.step))


def lm_train_state_to_repro(state, cfg: ModelConfig):
    """``lm_train_state_from_repro``'s inverse: a ``TrainState`` of numpy
    trees in ``repro``'s layout (stacked stages, IAG's memo with the shard
    axis first), which ``repro.training.TrainState(*...)`` takes field for
    field."""

    def arr(t):
        return t.detach().cpu().numpy()

    opt = {}
    for key, val in state.opt_state.items():
        if key in LM_OPT_TREES:
            opt[key] = lm_params_to_repro(val, cfg)
        elif key == "memo":
            memo = lm_params_to_repro(val, cfg)
            memo["stages"] = tree_map(lambda a: np.moveaxis(a, 0, 1),
                                       memo["stages"])
            opt[key] = memo
        else:
            opt[key] = arr(val)
    return TrainState(lm_params_to_repro(state.params, cfg), opt,
                      arr(torch.as_tensor(state.step)))
