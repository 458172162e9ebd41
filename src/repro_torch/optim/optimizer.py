"""Optimizers whose state is a tree shaped like the parameters.

Counterpart of ``repro/optim/optimizer.py``: AdamW, Lion, SGD with
momentum, gradient clipping and schedule support, with the reference's
arithmetic (float32 moments, bias correction by ``b ** step`` in float32,
weight decay on the parameter in float32, the update cast to the
parameter's type before it is added).  The state mirrors the parameter
tree (the port's dict with ``blocks`` a list of per-layer dicts), so a
sharding of the parameters applies to it leaf for leaf.

Difference of form from the reference: the state is updated **in place**,
like the reference's step under a donating ``jit``.  ``update`` writes the
new moments into the moment tensors it is given and adds one to
``state.step`` in place (and returns that same state), ``apply_updates``
adds the updates into the parameters, and ``clip_by_global_norm`` scales
the gradients it is given.  A caller who needs the old values clones them
first.  At ``qwen1.5-4b``'s width a functional update would hold the old
and the new float32 moments at once (31.6 GB more), which the card does
not have.  Each update runs as ``torch._foreach_*`` operations over
consecutive groups of leaves (``GROUP_ELEMENTS``), one launch a group and
operation in place of one a leaf.

On a mesh the leaves are DTensors.  A gradient, its parameter and the
parameter's moments share placements (the train step places each
gradient as its parameter), and every update is elementwise, so the
``torch._foreach_*`` operations run on each rank's own shards
(``to_local``); the updates come back as DTensors placed as the
parameters.  ``global_norm`` is the norm of the whole tree: each rank's
sum of squares of its shards, summed over the mesh dims that split the
leaf (a Partial sum, all-reduced), so every rank gets the same global
norm.  The moments are made with ``zeros_like``, so they take their
parameters' placements; the step stays a plain 0-d tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

from repro_torch._dtensor import is_split, like, local


class OptState(NamedTuple):
    step: torch.Tensor   # 0-d int32, on the parameters' device
    mu: Any              # first moment (or momentum)
    nu: Any              # second moment (None for lion / sgd)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable   # (grads, state, params) -> (updates, state)


def _tree_zeros(params, dtype=None):
    return pytree.tree_map(
        lambda p: torch.zeros_like(p, dtype=dtype or p.dtype,
                                   memory_format=torch.contiguous_format),
        params)


def _step_zero(params) -> torch.Tensor:
    device = pytree.tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=device)


def _lr_fn(lr):
    return lr if callable(lr) else (lambda step: lr)


# elements of a group of leaves updated by one ``torch._foreach_*`` call:
# bounds the float32 temporaries of an update (a larger leaf goes alone)
GROUP_ELEMENTS = 1 << 27


def _groups(*trees):
    """The leaves of trees shaped alike, zipped, in consecutive groups of
    at most ``GROUP_ELEMENTS`` elements: a tuple of lists, one a tree.
    A DTensor leaf comes as its rank's shard."""
    group, size = [], 0
    for row in zip(*([local(x) for x in pytree.tree_leaves(t)]
                     for t in trees)):
        n = row[0].numel()
        if group and size + n > GROUP_ELEMENTS:
            yield tuple(map(list, zip(*group)))
            group, size = [], 0
        group.append(row)
        size += n
    if group:
        yield tuple(map(list, zip(*group)))


def global_norm(tree) -> torch.Tensor:
    """√(Σ over leaves of Σ l²), each leaf reduced in float32.  On DTensor
    leaves a plain tensor, the same on every rank (see the module
    docstring)."""
    leaves = pytree.tree_leaves(tree)
    if not any(is_split(x) for x in leaves):
        # every leaf whole on every rank: the plain formula, bit for bit
        norms = torch._foreach_norm([local(x) for x in leaves], 2,
                                    dtype=torch.float32)
        return torch.linalg.vector_norm(torch.stack(norms))
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    # the leaves' local sums of squares, summed per set of splitting dims
    by_split = {}
    for x in leaves:
        split = tuple(isinstance(p, Shard) for p in x.placements) \
            if is_split(x) else None
        sq = torch.linalg.vector_norm(local(x), dtype=torch.float32) ** 2
        by_split[split] = by_split.get(split, 0.0) + sq
    mesh = next(x.device_mesh for x in leaves if is_split(x))
    total = 0.0
    for split, sq in by_split.items():
        if split is not None and any(split):
            sq = DTensor.from_local(sq, mesh, [
                Partial() if s else Replicate() for s in split],
                run_check=False).full_tensor()
        total = total + sq
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` in place by min(1, max_norm / ‖grads‖) (the product
    taken in float32 and cast back, as the reference); returns
    ``(grads, norm)``."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for (g,) in _groups(grads):
        gf = [x.to(torch.float32) for x in g]
        torch._foreach_mul_(gf, scale)
        narrow = [(x, y) for x, y in zip(g, gf) if x is not y]
        if narrow:
            torch._foreach_copy_(*map(list, zip(*narrow)))
    return grads, norm


def _advance(state: OptState) -> torch.Tensor:
    """Add one to ``state.step`` in place; returns it (a replicated
    DTensor step as its local value)."""
    state.step.add_(1)
    return local(state.step)


def _cast(xs, dtype):
    return [x.to(dtype) for x in xs]


def adamw(lr: Callable | float, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          state_dtype=torch.float32) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return OptState(step=_step_zero(params),
                        mu=_tree_zeros(params, state_dtype),
                        nu=_tree_zeros(params, state_dtype))

    @torch.no_grad()
    def update(grads, state, params):
        step = _advance(state)
        lr_t = lr_fn(step)
        stepf = step.to(state_dtype)
        bc1 = 1 - b1 ** stepf
        bc2 = 1 - b2 ** stepf
        updates = []
        for g, m, v, p in _groups(grads, state.mu, state.nu, params):
            gf = _cast(g, state_dtype)
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, torch._foreach_mul(gf, 1 - b1))
            torch._foreach_mul_(v, b2)
            torch._foreach_add_(v, torch._foreach_mul(
                torch._foreach_mul(gf, gf), 1 - b2))
            del gf
            den = torch._foreach_div(v, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            u = torch._foreach_div(m, bc1)
            torch._foreach_div_(u, den)
            del den
            torch._foreach_add_(u, torch._foreach_mul(
                _cast(p, state_dtype), weight_decay))
            torch._foreach_mul_(u, -lr_t)
            updates += [x.to(q.dtype) for x, q in zip(u, p)]
        return _like_params(updates, params), state

    return Optimizer(init=init, update=update)


def lion(lr: Callable | float, b1: float = 0.9, b2: float = 0.99,
         weight_decay: float = 0.1, state_dtype=torch.float32) -> Optimizer:
    """Lion: sign-momentum, one moment (half of Adam's state)."""
    lr_fn = _lr_fn(lr)

    def init(params):
        return OptState(step=_step_zero(params),
                        mu=_tree_zeros(params, state_dtype), nu=None)

    @torch.no_grad()
    def update(grads, state, params):
        lr_t = lr_fn(_advance(state))
        updates = []
        for g, m, p in _groups(grads, state.mu, params):
            gf = _cast(g, state_dtype)
            u = torch._foreach_add(torch._foreach_mul(m, b1),
                                   torch._foreach_mul(gf, 1 - b1))
            torch._foreach_sign_(u)
            torch._foreach_add_(u, torch._foreach_mul(
                _cast(p, state_dtype), weight_decay))
            torch._foreach_mul_(m, b2)
            torch._foreach_add_(m, torch._foreach_mul(gf, 1 - b2))
            torch._foreach_mul_(u, -lr_t)
            updates += [x.to(q.dtype) for x, q in zip(u, p)]
        return _like_params(updates, params), state

    return Optimizer(init=init, update=update)


def sgd(lr: Callable | float, momentum: float = 0.9,
        nesterov: bool = False) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return OptState(step=_step_zero(params),
                        mu=_tree_zeros(params, torch.float32), nu=None)

    @torch.no_grad()
    def update(grads, state, params):
        lr_t = lr_fn(_advance(state))
        updates = []
        for g, m, p in _groups(grads, state.mu, params):
            gf = _cast(g, torch.float32)
            torch._foreach_mul_(m, momentum)
            torch._foreach_add_(m, gf)
            u = torch._foreach_add(gf, torch._foreach_mul(m, momentum)) \
                if nesterov else m
            u = torch._foreach_mul(u, -lr_t)
            updates += [x.to(q.dtype) for x, q in zip(u, p)]
        return _like_params(updates, params), state

    return Optimizer(init=init, update=update)


def _like_params(updates, params):
    """The per-leaf updates (each rank's shards) as a tree like
    ``params``, DTensors placed as the parameters."""
    leaves = pytree.tree_leaves(params)
    return pytree.tree_unflatten([like(u, p) for u, p in zip(updates,
                                                             leaves)],
                                 pytree.tree_structure(params))


@torch.no_grad()
def apply_updates(params, updates):
    """Add ``updates`` into ``params`` in place; returns ``params``."""
    for p, u in _groups(params, updates):
        torch._foreach_add_(p, [x.to(y.dtype) for x, y in zip(u, p)])
    return params


OPTIMIZERS = {"adamw": adamw, "lion": lion, "sgd": sgd}
