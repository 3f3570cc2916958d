"""Nested dicts, lists and tuples of tensors (the port's parameter,
optimizer-state and checkpoint trees; the JAX package's pytrees).

Leaves come in a fixed order: dict keys sorted, as ``jax.tree`` orders
them, then list and tuple items in order. A leaf's path string spells
its keys the way ``jax.tree_util.keystr`` does (``['layers'][0]['attn']``
...), so a checkpoint's keys read alike in both packages.
"""

from __future__ import annotations

from typing import Any, Callable


def _children(tree) -> list[tuple[str, Any]] | None:
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", t) for i, t in enumerate(tree)]
    return None


def leaves_with_path(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """[(path string, leaf)] in leaf order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [item for key, t in kids
            for item in leaves_with_path(t, prefix + key)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten(like, new_leaves) -> Any:
    """A tree shaped like ``like`` holding ``new_leaves`` in leaf order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(like)


def map_leaves(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``
    (same structure), leaf by leaf."""
    return unflatten(tree, [fn(*xs) for xs in zip(
        leaves(tree), *(leaves(r) for r in rest))])
