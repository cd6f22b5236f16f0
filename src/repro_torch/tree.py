"""Nested-dict parameter trees, flattened in JAX's leaf order.

The reference's trees are dicts of arrays, and ``jax.tree.flatten``
orders a dict's keys by sort order at every level. The port flattens
the same way, so leaf ``i`` here is leaf ``i`` there: the codec's
per-leaf random bits and the wire accounting line up across packages.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch


def flatten(tree) -> Tuple[List[torch.Tensor], object]:
    """(leaves in sorted-key order, structure) of a nested dict."""
    if not isinstance(tree, dict):
        return [tree], None
    leaves, spec = [], {}
    for key in sorted(tree):
        sub, spec[key] = flatten(tree[key])
        leaves += sub
    return leaves, spec


def unflatten(spec, leaves):
    """Inverse of :func:`flatten`."""
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        return {k: build(v) for k, v in s.items()}

    return build(spec)


def leaves(tree) -> List[torch.Tensor]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), as ``jax.tree.map``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)
