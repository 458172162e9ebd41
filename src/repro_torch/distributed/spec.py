"""Partition specs and meshes of the PyTorch port.

The JAX package names a tensor's placement with ``jax.sharding.
PartitionSpec`` on a ``jax.sharding.Mesh``.  The port keeps the same
vocabulary on ``torch.distributed``:

  * ``PartitionSpec`` (alias ``P``) — a small immutable value: one entry
    per tensor dim, each a mesh-axis name, a tuple of names (the dim split
    over several axes, the first one major), or ``None`` (not split).
    User code and the parity tests read the same specs in both packages.
  * the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose
    ``mesh_dim_names`` are the axis names; ``AbstractMesh`` is a
    shape-only stand-in (no ranks, no process group) for building specs on
    any host, as the reference's ``sharding.abstract_mesh`` is.
  * ``placements(mesh, spec, ndim)`` turns a spec into DTensor placements:
    ``Shard(i)`` on the mesh dims that split tensor dim ``i``,
    ``Replicate()`` on the others;
  * ``NamedSharding(mesh, spec)`` binds a spec to a mesh, as
    ``jax.sharding.NamedSharding`` does: what the models' and the train
    step's sharding options (``act_sharding``, ``sp_sharding``,
    ``microbatch_sharding``, ``grad_sharding``) take.

This module has no counterpart file in the JAX package, which imports
``P`` and ``NamedSharding`` from ``jax.sharding``.
"""
from __future__ import annotations

from typing import Tuple


class PartitionSpec:
    """Per tensor dim: a mesh-axis name, a tuple of names, or ``None``.

    Iterates, indexes and compares like the tuple of its entries, as
    ``jax.sharding.PartitionSpec`` (a tuple subclass) does.  It is not a
    tuple, so ``torch.utils._pytree`` keeps it whole as a leaf of a spec
    tree.
    """

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        norm = []
        for e in entries:
            if isinstance(e, list):
                e = tuple(e)
            if isinstance(e, tuple) and len(e) == 1:
                e = e[0]            # as JAX: ("data",) reads "data"
            if e is not None and not isinstance(e, (str, tuple)):
                raise TypeError(f"a PartitionSpec entry is a mesh-axis name, "
                                f"a tuple of names or None; got {e!r}")
            norm.append(e)
        self._entries = tuple(norm)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self):
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other):
        if isinstance(other, PartitionSpec):
            return self._entries == other._entries
        if isinstance(other, tuple):
            return self._entries == other
        return NotImplemented

    def __hash__(self):
        return hash(("PartitionSpec", self._entries))

    def __repr__(self):
        return "PartitionSpec" + repr(self._entries).replace(",)", ")")


P = PartitionSpec


def axes_of(entry) -> Tuple[str, ...]:
    """The mesh-axis names of one spec entry, in order."""
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        out: Tuple[str, ...] = ()
        for e in entry:
            out += axes_of(e)
        return out
    return (entry,)


class AbstractMesh:
    """A shape-only mesh: axis names and sizes, no ranks.

    Answers what spec construction asks of a ``DeviceMesh``:
    ``mesh_dim_names``, ``shape`` and ``size()``.
    """

    def __init__(self, axis_sizes, axis_names):
        axis_sizes, axis_names = tuple(axis_sizes), tuple(axis_names)
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{len(axis_sizes)} sizes for "
                             f"{len(axis_names)} axis names")
        self.shape = tuple(int(s) for s in axis_sizes)
        self.mesh_dim_names = axis_names

    def size(self, mesh_dim=None) -> int:
        """The number of positions on the mesh (or along one dim)."""
        if mesh_dim is not None:
            return self.shape[dim_index(self, mesh_dim)]
        out = 1
        for s in self.shape:
            out *= s
        return out

    def __repr__(self):
        inner = ", ".join(f"{n}={s}" for n, s in zip(self.mesh_dim_names,
                                                     self.shape))
        return f"AbstractMesh({inner})"


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names (``mesh_dim_names``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if not names:
        raise ValueError(f"{mesh!r} has no axis names; build it with "
                         "mesh_dim_names")
    return tuple(names)


def dim_index(mesh, name) -> int:
    """The mesh dim named ``name`` (an int passes through)."""
    if isinstance(name, int):
        return name
    names = axis_names(mesh)
    if name not in names:
        raise ValueError(f"mesh axis {name!r} is not one of {names}")
    return names.index(name)


def axis_size(mesh, name) -> int:
    """The extent of one named axis: JAX's ``mesh.shape[name]``."""
    return int(tuple(mesh.shape)[dim_index(mesh, name)])


def placements(mesh, spec, ndim: int) -> tuple:
    """DTensor placements of a tensor of rank ``ndim`` placed by ``spec``:
    per mesh dim, ``Shard(i)`` when the spec splits tensor dim ``i`` over
    it, else ``Replicate()``.  A dim split over several axes lists them in
    mesh-dim order, the order in which DTensor shards."""
    from torch.distributed.tensor import Replicate, Shard
    spec = P() if spec is None else spec
    if len(spec) > ndim:
        raise ValueError(f"{spec!r} names {len(spec)} dims of a tensor of "
                         f"rank {ndim}")
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        idx = [dim_index(mesh, n) for n in axes_of(entry)]
        if idx != sorted(idx):
            raise ValueError(f"{spec!r}: the axes splitting dim {i} must "
                             f"come in the mesh's order {names}")
        for k in idx:
            if out[k] != Replicate():
                raise ValueError(f"{spec!r} uses mesh axis {names[k]!r} "
                                 "twice")
            out[k] = Shard(i)
    return tuple(out)


class NamedSharding:
    """A ``PartitionSpec`` bound to a mesh (``jax.sharding.NamedSharding``):
    ``placements(ndim)`` gives the DTensor placements of a tensor of rank
    ``ndim`` placed by it."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = P() if spec is None else spec

    def placements(self, ndim: int) -> tuple:
        return placements(self.mesh, self.spec, ndim)

    def __eq__(self, other):
        return isinstance(other, NamedSharding) and \
            self.mesh is other.mesh and self.spec == other.spec

    def __hash__(self):
        return hash((id(self.mesh), self.spec))

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"
