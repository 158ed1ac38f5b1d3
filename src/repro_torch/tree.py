"""Trees of containers over tensors or arrays: the port's parameter,
optimizer-state and cache trees, and ``repro``'s pytrees as numpy.

Containers are mappings, lists, tuples and named tuples; everything else
is a leaf. Leaves and paths come in ``jax.tree_util``'s order (mappings by
sorted key, sequences by index, named tuples by field), and a path joins
dict keys, indices and ``.field`` names by ``/``, as ``repro``'s
checkpoints key a pytree's leaves.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Mapping, Tuple


def is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _walk(tree: Any, prefix: Tuple[str, ...]
          ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (str(k),))
    elif is_namedtuple(tree):
        for f in tree._fields:
            yield from _walk(getattr(tree, f), prefix + ("." + f,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (str(i),))
    else:
        yield prefix, tree


def tree_paths(tree: Any) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs."""
    return [("/".join(p), leaf) for p, leaf in _walk(tree, ())]


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in _walk(tree, ())]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``,
    the structure kept (a mapping becomes a dict)."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if is_namedtuple(tree) else type(tree)(out)
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                       prefix: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over the leaves, the structure kept."""
    if isinstance(tree, Mapping):
        return {k: tree_map_with_path(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, f),
                                               prefix + ("." + f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(prefix), tree)
