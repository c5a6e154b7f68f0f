"""Trees of tensors in ``jax.tree``'s order.

A tree is nested dicts, tuples, lists and NamedTuples with tensors (or
other non-container values) at the leaves.  The leaves go in
``jax.tree``'s order (dict keys sorted, sequences and NamedTuples in
order), so a sum over them adds in the reference's order and a
checkpoint's leaf keys are the reference's.
"""
from __future__ import annotations

from typing import Any, List, Tuple


def _children(node):
    """(key, child) pairs of a container in ``jax.tree`` order, keys as
    the reference's checkpoint spells them; None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [("." + f, v) for f, v in zip(node._fields, node)]
    if isinstance(node, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def leaves_with_keys(tree, prefix: Tuple[str, ...] = ()
                     ) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in order; a key is the path joined by ``/``."""
    kids = _children(tree)
    if kids is None:
        return [("/".join(prefix), tree)]
    return [kv for k, v in kids for kv in leaves_with_keys(v, prefix + (k,))]


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_keys(tree)]


def unflatten(tree, new_leaves) -> Any:
    """A tree of ``tree``'s structure (its dicts in their own key order)
    holding ``new_leaves``, given in :func:`leaves` order."""
    return _build(tree, iter(new_leaves))


def _build(node, it):
    # a module-level recursion: a nested one would be a reference cycle
    # (the function and its own closure cell) holding ``it``, and with it
    # every new leaf, until the cyclic garbage collector ran
    if isinstance(node, dict):
        out = {k: _build(node[k], it) for k in sorted(node)}
        return {k: out[k] for k in node}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*[_build(v, it) for v in node])
    if isinstance(node, (tuple, list)):
        return type(node)([_build(v, it) for v in node])
    return next(it)


def map(fn, tree, *rest):  # noqa: A001 - jax.tree.map's name
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    cols = [leaves(t) for t in (tree,) + rest]
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])
