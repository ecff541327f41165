"""Nested containers of tensors ("trees"): the port's stand-in for JAX's
pytrees.  A tree is a dict, a list, a tuple or a NamedTuple of trees, or a
leaf (anything else: a tensor, an array, a number).  As in JAX, a dict's
children go in the order of its sorted keys, so the two packages visit
the leaves of one tree in the same order (sums over leaves, such as the
global norm, then add in the same order)."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); returns a tree of that
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def flatten_with_path(tree, path: Tuple[str, ...] = ()
                      ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in order; a path names dict keys, NamedTuple
    fields and list indices."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten_with_path(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for k, v in zip(tree._fields, tree):
            yield from flatten_with_path(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten_with_path(v, path + (str(i),))
    else:
        yield path, tree


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(tree, new_leaves) -> Any:
    """A tree of ``tree``'s structure holding ``new_leaves`` in order."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree has")
    return out
