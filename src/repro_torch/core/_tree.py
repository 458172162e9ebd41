"""Pytree helpers shared by the port: ``torch.utils._pytree`` in JAX order.

``torch.utils._pytree`` flattens a dict in insertion order; JAX flattens
it in sorted-key order.  Every raveled vector, materialized matrix and
warm-start fingerprint of this package must line up with the JAX
package's, and ``torch.func`` checks that primals and tangents share one
tree structure — so every tree that enters a helper here is first
rebuilt with its dict keys sorted (``canonical``).  Trees coming out of
these helpers are therefore always canonical.
"""
from __future__ import annotations

import functools
from typing import Callable, Tuple

import torch
from torch.utils import _pytree as pytree


def canonical(tree):
    """Rebuild ``tree`` with every dict's keys in sorted order."""
    if isinstance(tree, dict):
        return {k: canonical(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        vals = [canonical(t) for t in tree]
        if hasattr(tree, "_fields"):           # namedtuple
            return type(tree)(*vals)
        return type(tree)(vals)
    return tree


def tree_flatten(tree):
    """Leaves in JAX order plus the (canonical) tree spec."""
    return pytree.tree_flatten(canonical(tree))


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in JAX order."""
    return tree_flatten(tree)[0]


def tree_unflatten(leaves, spec):
    """Inverse of :func:`tree_flatten`."""
    return pytree.tree_unflatten(list(leaves), spec)


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of ``tree`` (and of same-shaped ``rest``)."""
    leaves, spec = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError("tree_map: trees have different structures")
    return tree_unflatten([fn(*xs) for xs in zip(leaves, *others)], spec)


def _leaf(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _common_dtype(leaves) -> torch.dtype:
    return functools.reduce(torch.promote_types,
                            [leaf.dtype for leaf in leaves])


def ravel_pytree(tree) -> Tuple[torch.Tensor, Callable]:
    """Flatten a pytree of tensors to one vector, as ``jax.flatten_util``.

    Leaves are concatenated in JAX order at their common promoted dtype;
    ``unravel`` splits a flat vector back and casts each piece to its
    leaf's dtype.
    """
    leaves, spec = tree_flatten(tree)
    leaves = [_leaf(x) for x in leaves]
    if not leaves:
        return torch.zeros(0), lambda flat: tree_unflatten([], spec)
    shapes = [leaf.shape for leaf in leaves]
    dtypes = [leaf.dtype for leaf in leaves]
    sizes = [leaf.numel() for leaf in leaves]
    dtype = _common_dtype(leaves)
    flat = torch.cat([leaf.reshape(-1).to(dtype) for leaf in leaves])

    def unravel(vec):
        parts = torch.split(vec, sizes)
        return tree_unflatten([p.reshape(s).to(dt) for p, s, dt
                               in zip(parts, shapes, dtypes)], spec)

    return flat, unravel


def ravel_batched(tree) -> Tuple[torch.Tensor, Callable]:
    """``ravel_pytree`` over a leading batch axis: leaves ``(B, ...)``.

    Returns the ``(B, d)`` matrix and the inverse ``(B, d) -> tree``.
    """
    leaves, spec = tree_flatten(tree)
    leaves = [_leaf(x) for x in leaves]
    B = leaves[0].shape[0]
    shapes = [leaf.shape[1:] for leaf in leaves]
    dtypes = [leaf.dtype for leaf in leaves]
    sizes = [leaf[0].numel() for leaf in leaves]
    dtype = _common_dtype(leaves)
    flat = torch.cat([leaf.reshape(B, -1).to(dtype) for leaf in leaves],
                     dim=1)

    def unravel(mat):
        parts = torch.split(mat, sizes, dim=1)
        return tree_unflatten(
            [p.reshape((mat.shape[0],) + tuple(s)).to(dt)
             for p, s, dt in zip(parts, shapes, dtypes)], spec)

    return flat, unravel
