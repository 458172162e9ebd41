"""DTensor helpers of the model stack and the train step.

A model's parameters may be ``torch.distributed.tensor.DTensor``s placed
by ``distributed.sharding.params_specs`` (training on a mesh); the layers
then run on DTensors and DTensor's sharding rules pick each operation's
collectives.  What these rules need from the model code:

  * every tensor of an operation is a DTensor: a tensor the model makes
    from nothing (positions, rotary tables, causal masks, zero states) is
    the same on every rank, so ``replicated_like`` wraps it as a
    replicated DTensor on the mesh of the activation it meets (no copy,
    no collective).  Implicit replication (``torch.distributed.tensor.
    experimental.implicit_replication``) would do the same, but its switch
    is thread-local, and autograd runs a CUDA backward (and every
    rematerialised block) on its own device thread;
  * a few operations have no rule for a sharded operand: ``whole(x,
    dims)`` gathers the named tensor dims first (see the callers);
  * ``constrain(x, sharding)`` is ``jax.lax.with_sharding_constraint``:
    a DTensor redistributed to the placements of a ``NamedSharding``, a
    plain tensor (the same on every rank) sliced by them, each rank
    keeping its own shard (``shard``: no collective).

Every helper returns a plain tensor unchanged when no DTensor is involved,
so the single-device path is the code it was.
"""
from __future__ import annotations

import torch


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def is_split(x) -> bool:
    """A DTensor split over some mesh dim (a ``Shard`` placement)."""
    if not is_dtensor(x):
        return False
    from torch.distributed.tensor import Shard
    return any(isinstance(p, Shard) for p in x.placements)


def replicated_like(t: torch.Tensor, ref) -> torch.Tensor:
    """``t`` — computed alike on every rank — as a DTensor replicated over
    ``ref``'s mesh when ``ref`` is a DTensor; else ``t``."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def whole(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """``x`` with the tensor dims ``dims`` unsharded (gathered over every
    mesh dim that splits them; a Partial sum stays Partial); a plain
    tensor, or a DTensor that does not split them, unchanged."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    dims = {d % x.ndim for d in dims}
    want = [Replicate() if isinstance(p, Shard) and p.dim % x.ndim in dims
            else p for p in x.placements]
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def split_last(x: torch.Tensor, lead: int, *rest: int) -> torch.Tensor:
    """``x`` with its last dim unflattened into ``(lead, *rest)`` (one of
    ``rest`` may be -1).  DTensor cannot unflatten a dim split over mesh
    dims whose size does not divide ``lead`` (20 heads on a model axis of
    16): on a DTensor such a last dim is gathered first, in the forward and
    in the backward (``merge_last``'s gradient) alike."""
    if not is_dtensor(x):
        return x.reshape(*x.shape[:-1], lead, *rest)
    return _SplitLast.apply(x, (lead,) + rest)


def merge_last(x: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``x`` with its last ``n`` dims flattened into one.  On a DTensor the
    inner ``n - 1`` dims are gathered first (a flattened dim can only be
    split on its outer part), and the gradient is unflattened by
    ``split_last``."""
    if not is_dtensor(x):
        return x.reshape(*x.shape[:-n], -1)
    return _MergeLast.apply(x, n)


def _splittable(x, lead: int):
    """``x`` with its last dim gathered unless its split divides
    ``lead``."""
    from torch.distributed.tensor import Shard
    parts = 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim % x.ndim == x.ndim - 1:
            parts *= x.device_mesh.size(i)
    return whole(x, -1) if lead % parts else x


class _SplitLast(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, sizes):
        ctx.n = len(sizes)
        x = _splittable(x, sizes[0])
        return x.reshape(*x.shape[:-1], *sizes)

    @staticmethod
    def backward(ctx, grad):
        return merge_last(grad, ctx.n), None


class _MergeLast(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, n):
        ctx.sizes = tuple(x.shape[-n:])
        x = whole(x, *range(x.ndim - n + 1, x.ndim))
        return x.reshape(*x.shape[:-n], -1)

    @staticmethod
    def backward(ctx, grad):
        return split_last(grad, *ctx.sizes), None


def gathered_over_batch(tree, h):
    """The DTensor leaves of ``tree`` (a block's parameters) gathered over
    every mesh dim that splits the activations ``h`` on their batch dim
    (ZeRO-3 / FSDP: the data-axis split of the weights is all-gathered at
    their use, and its gradient comes back as a reduce-scatter); the
    model-axis (tensor-parallel) split stays.  ``tree`` unchanged when
    ``h`` is plain."""
    if not is_dtensor(h):
        return tree
    from torch.distributed.tensor import Replicate, Shard
    batch = [isinstance(p, Shard) and p.dim == 0 for p in h.placements]

    def leaf(p):
        if not is_dtensor(p):
            return p
        want = [Replicate() if b else q for b, q in zip(batch, p.placements)]
        if want == list(p.placements):
            return p
        return p.redistribute(p.device_mesh, want)

    from torch.utils import _pytree as pytree
    return pytree.tree_map(leaf, tree)


def reduced(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's partial sums reduced (``Replicate`` on those mesh dims:
    an all-reduce), with the gradient of Megatron's "g" operator: each
    rank's summand takes the whole gradient as it comes (``Replicate``
    stays ``Replicate``, where DTensor's own backward of the redistribution
    hands a partial gradient back); a plain tensor unchanged."""
    if not is_dtensor(x):
        return x
    return _Reduced.apply(x)


class _Reduced(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        return x.redistribute(x.device_mesh, _no_partial(x.placements))

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(grad.device_mesh,
                                 _no_partial(grad.placements))


def _no_partial(places):
    from torch.distributed.tensor import Partial, Replicate
    return [Replicate() if isinstance(p, Partial) else p for p in places]


def constrain(x: torch.Tensor, sharding) -> torch.Tensor:
    """``x`` placed by ``sharding`` (a ``distributed.spec.NamedSharding``,
    or None: ``x`` unchanged)."""
    if sharding is None:
        return x
    if not hasattr(sharding, "placements"):
        raise TypeError(f"a sharding option takes a distributed.spec."
                        f"NamedSharding; got {sharding!r}")
    places = effective(sharding.mesh, sharding.placements(x.ndim), x.shape)
    if is_dtensor(x):
        if tuple(x.placements) == places:
            return x
        return x.redistribute(sharding.mesh, places)
    return shard(x, sharding.mesh, places)


def local(x):
    """The rank's shard of a DTensor (``to_local``); a plain tensor
    unchanged."""
    return x.to_local() if is_dtensor(x) else x


def full(x):
    """The whole value of a DTensor on every rank (``full_tensor``: a
    collective every rank must call); a plain tensor unchanged."""
    return x.full_tensor() if is_dtensor(x) else x


def like(t: torch.Tensor, ref) -> torch.Tensor:
    """A rank's shard ``t`` as a DTensor placed as ``ref`` is (same mesh,
    placements, global shape); ``t`` itself when ``ref`` is plain."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, ref.device_mesh, ref.placements,
                              run_check=False, shape=ref.shape,
                              stride=ref.stride())


def shard_extent(shape, mesh, places):
    """(local shape, global offset) of this rank's shard of a tensor of
    ``shape`` placed by ``places`` on ``mesh``.  Computed outside any
    ``FakeTensorMode`` (DTensor reads the offsets from small tensors)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    with unset_fake_temporarily():
        return compute_local_shape_and_global_offset(tuple(shape), mesh,
                                                     places)


def local_slice(value: torch.Tensor, mesh, places) -> torch.Tensor:
    """This rank's shard of ``value`` (the whole value, held alike by every
    rank) under ``places`` on ``mesh``: a view, no collective."""
    shape, offset = shard_extent(tuple(value.shape), mesh, places)
    out = value
    for dim, (n, start) in enumerate(zip(shape, offset)):
        if n != value.shape[dim]:
            out = out.narrow(dim, start, n)
    return out


def effective(mesh, places, shape) -> tuple:
    """``places`` with every split that splits nothing made ``Replicate``:
    a split over a mesh dim of one rank, and a split of a dim of one
    element (DTensor's view rules take a split singleton for a dim to
    squeeze: a microbatch of one sequence).  On a mesh of one rank every
    placement is then ``Replicate``, and DTensor runs each operation as
    the plain path does, on the whole tensors."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Replicate() if isinstance(p, Shard) and (
        mesh.size(i) == 1 or shape[p.dim] == 1) else p
        for i, p in enumerate(places))


def shard(value: torch.Tensor, mesh, places) -> torch.Tensor:
    """``value`` (held alike by every rank) as a DTensor on ``mesh`` placed
    by ``places`` (``effective``): each rank keeps its own slice (a
    contiguous copy), no collective."""
    from torch.distributed.tensor import DTensor
    places = effective(mesh, places, value.shape)
    return DTensor.from_local(
        local_slice(value, mesh, places).contiguous(), mesh, places,
        run_check=False, shape=value.shape, stride=value.stride())
