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


def _has_dtensor(*trees) -> bool:
    """Whether a leaf of ``trees`` is a ``DTensor`` (a sharded run).
    ``torch.distributed.tensor`` is imported here, not at module load."""
    from torch.distributed.tensor import DTensor
    return any(isinstance(leaf, DTensor) for tree in trees
               for leaf in tree_leaves(tree))


def is_batched(*trees) -> bool:
    """Whether a tensor leaf of ``trees`` carries a ``torch.func.vmap``
    batch axis, at any depth of functorch wrapping (a ``torch.func.grad``
    inside a ``vmap`` wraps the batched tensor once more).  The loops that
    read the host once an iteration test this to run a batch as one loop
    through their ``torch.autograd.Function``'s ``vmap`` rule."""
    from torch._C import _functorch
    for tree in trees:
        for leaf in tree_leaves(tree):
            t = leaf
            while isinstance(t, torch.Tensor) and \
                    _functorch.is_functorch_wrapped_tensor(t):
                if _functorch.is_batchedtensor(t):
                    return True
                t = _functorch.get_unwrapped(t)
    return False


class Flat:
    """Pytrees as one flat list of their tensors and back: the inputs and
    outputs of a ``torch.autograd.Function``, whose ``vmap`` rule must see
    every batched tensor.  Non-tensor leaves stay here."""

    def __init__(self, *trees):
        self.parts = [tree_flatten(tree) for tree in trees]
        self.counts = [sum(isinstance(leaf, torch.Tensor) for leaf in leaves)
                       for leaves, _ in self.parts]
        self.tensors = [leaf for leaves, _ in self.parts for leaf in leaves
                        if isinstance(leaf, torch.Tensor)]

    def _fill(self, values, rest) -> list:
        it = iter(values)
        return [tree_unflatten([next(it) if isinstance(leaf, torch.Tensor)
                                else rest(leaf) for leaf in leaves], spec)
                for leaves, spec in self.parts]

    def trees(self, tensors) -> list:
        """The trees with ``tensors`` in place of their tensor leaves."""
        return self._fill(tensors, lambda leaf: leaf)

    def dims(self, dims) -> list:
        """``torch.func.vmap`` ``in_dims`` of the trees: ``dims`` at the
        tensor leaves, ``None`` at the others."""
        return self._fill(dims, lambda leaf: None)


def batch_first(tensors, in_dims):
    """The tensors of a ``vmap`` rule with their batch axes moved to 0,
    and the dims (0 or None) that say which carry one."""
    return ([t if d is None else t.movedim(d, 0)
             for t, d in zip(tensors, in_dims)],
            [None if d is None else 0 for d in in_dims])
