"""The parameter tree of the port (nested dicts, lists and tuples of
tensors) in ``jax.tree.flatten``'s leaf order: a dict's values by sorted
key, a list's or tuple's (a NamedTuple's fields too) in order, None
holding no leaf. A checkpoint's ``leaf_{i}`` of either package is then
the same tensor."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List


def tree_leaves(tree: Any) -> List[Any]:
    return list(_iter(tree))


def _iter(tree) -> Iterator[Any]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _iter(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _iter(v)
    elif tree is not None:
        yield tree


def tree_unflatten(like: Any, leaves) -> Any:
    """``like``'s structure (its dicts keep their key order) holding
    ``leaves`` in the order ``tree_leaves`` gives."""
    it = iter(leaves)
    out = _rebuild(like, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _rebuild(like, it):
    if isinstance(like, dict):
        done = {k: _rebuild(like[k], it) for k in sorted(like)}
        return {k: done[k] for k in like}
    if isinstance(like, (list, tuple)):
        vals = [_rebuild(v, it) for v in like]
        if isinstance(like, list):
            return vals
        return type(like)(*vals) if hasattr(like, "_fields") \
            else type(like)(vals)
    if like is None:
        return None
    try:
        return next(it)
    except StopIteration:
        raise ValueError("fewer leaves than the tree holds") from None


def tree_map(fn: Callable, tree: Any) -> Any:
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])
