"""The parameter tree of the port (nested dicts, lists and tuples of
tensors) in ``jax.tree.flatten``'s leaf order: a dict's values by sorted
key, a list's or tuple's (a NamedTuple's fields too) in order, None
holding no leaf. A checkpoint's ``leaf_{i}`` of either package is then
the same tensor. ``leaf_type`` makes a tuple type (a partition spec) a
leaf; ``tree_paths`` gives each leaf's key path as the reference's
key-path names (dict keys, ``[i]`` for a list or tuple item, ``.name``
for a NamedTuple's field)."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Tuple


def tree_leaves(tree: Any, leaf_type: Optional[type] = None) -> List[Any]:
    return [x for _, x in _iter(tree, (), leaf_type)]


def tree_paths(tree: Any, leaf_type: Optional[type] = None
               ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) of every leaf, in ``tree_leaves``' order."""
    return list(_iter(tree, (), leaf_type))


def _iter(tree, path, leaf_type) -> Iterator[Any]:
    if leaf_type is not None and isinstance(tree, leaf_type):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _iter(tree[k], path + (str(k),), leaf_type)
    elif isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", None)     # a NamedTuple
        for i, v in enumerate(tree):
            key = f".{names[i]}" if names else f"[{i}]"
            yield from _iter(v, path + (key,), leaf_type)
    elif tree is not None:
        yield path, tree


def tree_unflatten(like: Any, leaves, leaf_type: Optional[type] = None
                   ) -> Any:
    """``like``'s structure (its dicts keep their key order) holding
    ``leaves`` in the order ``tree_leaves`` gives."""
    it = iter(leaves)
    out = _rebuild(like, it, leaf_type)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _rebuild(like, it, leaf_type=None):
    if leaf_type is not None and isinstance(like, leaf_type):
        pass
    elif isinstance(like, dict):
        done = {k: _rebuild(like[k], it, leaf_type) for k in sorted(like)}
        return {k: done[k] for k in like}
    elif isinstance(like, (list, tuple)):
        vals = [_rebuild(v, it, leaf_type) for v in like]
        if isinstance(like, list):
            return vals
        return type(like)(*vals) if hasattr(like, "_fields") \
            else type(like)(vals)
    elif like is None:
        return None
    try:
        return next(it)
    except StopIteration:
        raise ValueError("fewer leaves than the tree holds") from None


def tree_map(fn: Callable, tree: Any) -> Any:
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])
