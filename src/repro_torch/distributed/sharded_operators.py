"""Mesh-aware sharded operators: distributed linear solves behind one seam.

Counterpart of ``repro.distributed.sharded_operators`` on
``torch.distributed``.  Placement is a property of the operator, as
symmetry and batching are:

  * ``ShardedOperator`` — wraps any ``LinearOperator`` (or a per-shard
    *factory* of one) with a ``DeviceMesh`` and in/out ``PartitionSpec``
    trees.  ``matvec``/``rmatvec`` run per shard; ``diagonal()`` /
    ``materialize()`` return per-shard pieces; the dot-product/norm
    reductions CG needs go through a pluggable reduction hook.
  * ``SolveSharding`` — the placement bundle the implicit-diff layer
    threads through ``ImplicitDiffSpec.sharding``: mesh + spec of the
    solution ``x`` (+ optional per-theta specs), so the
    ``JacobianOperator`` inherits the primal solution's placement and a
    gradient of a decorated solver runs ONE sharded backward solve.
  * ``sharded_solve_cg`` / ``sharded_solve_normal_cg`` /
    ``sharded_solve_dense_gmres`` — the registry's ``"sharded_cg"`` /
    ``"sharded_normal_cg"`` / ``"sharded_dense_gmres"``: the WHOLE masked
    solve loop is the port's ``solve_cg`` / ``solve_normal_cg`` /
    ``solve_dense_gmres`` on the local shards (per-instance masks
    intact), with cross-rank communication confined to the reduction
    hook.

From one controller to SPMD
---------------------------
JAX runs one process over global arrays and ``shard_map`` bodies; here
every rank runs the same program on its own shard.  ``ShardedOperator.
shard_map(body, in_specs, out_specs)`` is the counterpart of ``shard_map``:
it takes each argument's local shard, runs ``body`` on the locals, and
puts the results back under ``out_specs``.  Arguments cross in two forms:

  * ``torch.distributed.tensor.DTensor`` — the SPMD form: ``to_local()``
    (after a ``redistribute`` when its placement differs from the spec),
    and the results come back as ``DTensor.from_local(...,
    run_check=False)``.  Nothing is gathered.
  * a plain tensor — a global value that every rank holds alike (JAX's
    un-placed array): each rank slices its shard, and the results are
    assembled into global tensors again (an all-gather over each
    splitting axis of more than one rank; none on a mesh of one).

The reduction hook is ``psum_reduction(axis_names)``: a SUM
``all_reduce`` over those mesh axes, the only communication the sharded
solvers make; under pure batch sharding it reduces over no axis at all.
The mesh inside ``body`` is in scope for the hook, as JAX's axis names
are inside ``shard_map``.

Under ``torch.func.vmap`` (plain tensors; DTensors do not run under
``torch.func``) the collectives and host-read loops cannot take vmap's
batched tensors, so a batching rule takes the batch apart
(``_VmapLoop``): a batch of right-hand sides against one batch-sharded
operator folds into the operator's batch and runs as ONE solve; anything
else (a batch of operators, a ``shard_map`` body) runs one slice at a
time.

Shard-locality contract
-----------------------
The body sees *local shards*, so the base operator's matvec must be
**shard-local**: applied to the local shard of ``v`` it yields the local
shard of ``A v``.  That holds for batch sharding (``batch_ndim == 1``,
the leading batch axis split: the operator is block-diagonal over
instances) and for instance-dim sharding of operators that are
block-diagonal along the split dim (diagonal/elementwise systems).
Anything the matvec *closes over* is replicated into every shard; tensors
that must be split alongside the domain (the Jacobian's primal point,
batched theta) are passed as ``operands`` with ``operand_specs`` and
reach the operator through a per-shard factory.

Example::

    mesh = make_solve_mesh()                      # 1-D mesh over the ranks
    sh = SolveSharding(mesh, P("data", None), batch_ndim=1,
                       theta_specs=(P("data"),))
    spec = ImplicitDiffSpec(optimality_fun=F, solve="cg", sharding=sh)
    solver = implicit_diff(spec)(my_solver)
    torch.autograd.grad(loss(solver(None, theta)), theta)  # ONE sharded solve
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from repro_torch.core import linear_solve as ls
from repro_torch.core import operators as ops
from repro_torch.core._tree import (Flat, _has_dtensor, batch_first,
                                    is_batched, tree_flatten, tree_map,
                                    tree_unflatten)
from repro_torch.core.operators import LinearOperator
from repro_torch.distributed.spec import (P, PartitionSpec, axes_of,
                                          axis_size, dim_index, placements)


# ---------------------------------------------------------------------------
# spec utilities
# ---------------------------------------------------------------------------

def spec_tree(spec, tree):
    """Broadcast a single ``PartitionSpec`` over ``tree`` (a matching tree
    of specs passes through)."""
    if isinstance(spec, PartitionSpec):
        return tree_map(lambda _: spec, tree)
    return spec


def _spec_leaves(specs):
    if isinstance(specs, PartitionSpec):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    if isinstance(specs, (tuple, list)):
        return [s for e in specs for s in _spec_leaves(e)]
    return []


def instance_axes(specs, batch_ndim: int) -> Tuple[str, ...]:
    """Mesh axes that shard *instance* dims (spec positions ≥ batch_ndim) —
    the axes a distributed dot product must sum over."""
    found: list = []
    for leaf in _spec_leaves(specs):
        for entry in tuple(leaf)[batch_ndim:]:
            for name in axes_of(entry):
                if name not in found:
                    found.append(name)
    return tuple(found)


def batch_axes(specs, batch_ndim: int) -> Tuple[str, ...]:
    """Mesh axes that shard the leading batch dim (spec position 0 when
    ``batch_ndim == 1``)."""
    if batch_ndim == 0:
        return ()
    found: list = []
    for leaf in _spec_leaves(specs):
        entries = tuple(leaf)
        if entries:
            for name in axes_of(entries[0]):
                if name not in found:
                    found.append(name)
    return tuple(found)


# the meshes of the shard_map bodies running now, per thread
_SCOPE = threading.local()


def _mesh_in_scope():
    stack = getattr(_SCOPE, "meshes", None)
    if not stack:
        raise RuntimeError("a mesh-axis reduction runs inside a "
                           "ShardedOperator's shard_map body only")
    return stack[-1]


def _all_reduce_sum(x: torch.Tensor, mesh, axis_names) -> torch.Tensor:
    out = x.clone().contiguous()
    for name in axis_names:
        dist.all_reduce(out, op=dist.ReduceOp.SUM,
                        group=mesh.get_group(dim_index(mesh, name)))
    return out


def psum_reduction(axis_names: Tuple[str, ...]) -> Callable:
    """The default reduction hook: a SUM ``all_reduce`` over the
    instance-sharding axes of the mesh in scope (identity when nothing
    cross-rank is needed, e.g. pure batch sharding).  Plug a custom hook
    for hierarchical/approximate reductions.
    """
    if not axis_names:
        return lambda x: x
    names = tuple(axis_names)
    return lambda x: _all_reduce_sum(x, _mesh_in_scope(), names)


# ---------------------------------------------------------------------------
# shard_map: local shards in, placed results out
# ---------------------------------------------------------------------------

def _zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree`` against its spec tree (a single
    ``PartitionSpec`` covers a whole subtree; ``None`` leaves stay)."""
    if tree is None:
        return None
    if isinstance(specs, PartitionSpec):
        if isinstance(tree, dict):
            return {k: _zip_map(fn, tree[k], specs) for k in sorted(tree)}
        if isinstance(tree, (tuple, list)):
            vals = [_zip_map(fn, t, specs) for t in tree]
            return type(tree)(*vals) if hasattr(tree, "_fields") \
                else type(tree)(vals)
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: _zip_map(fn, tree[k], specs[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        if len(tree) != len(specs):
            raise ValueError(f"a spec tree of {len(specs)} entries for a "
                             f"tree of {len(tree)}")
        vals = [_zip_map(fn, t, s) for t, s in zip(tree, specs)]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    raise ValueError(f"no PartitionSpec for the leaf {type(tree).__name__}")


def _local_slice(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's shard of a global tensor every rank holds alike."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("this rank is not on the mesh")
    for i, entry in enumerate(spec):
        names = axes_of(entry)
        if not names:
            continue
        index, count = 0, 1
        for name in names:
            k = dim_index(mesh, name)
            index = index * axis_size(mesh, k) + coord[k]
            count *= axis_size(mesh, k)
        if t.shape[i] % count:
            raise ValueError(f"dim {i} of size {t.shape[i]} does not split "
                             f"into {count} shards ({spec!r})")
        chunk = t.shape[i] // count
        t = t.narrow(i, index * chunk, chunk)
    return t


def _gather(t: torch.Tensor, mesh, places) -> torch.Tensor:
    """The global tensor from every rank's shard (innermost axis first)."""
    for k in reversed(range(len(places))):
        n = axis_size(mesh, k)
        if isinstance(places[k], Shard) and n > 1:
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t.contiguous(), group=mesh.get_group(k))
            t = torch.cat(parts, dim=places[k].dim)
    return t


def _to_local(mesh, t, spec):
    if isinstance(t, DTensor):
        want = placements(mesh, spec, t.ndim)
        if tuple(t.placements) != want:
            t = t.redistribute(mesh, want)
        return t.to_local()
    if isinstance(t, torch.Tensor):
        return _local_slice(t, mesh, spec)
    return t


def _from_local(mesh, t, spec, as_dtensor: bool):
    if not isinstance(t, torch.Tensor):
        return t
    places = placements(mesh, spec, t.ndim)
    if as_dtensor:
        return DTensor.from_local(t, mesh, places, run_check=False)
    return _gather(t, mesh, places)


def _shard_map(mesh, body: Callable, in_specs: tuple, out_specs,
               args: tuple):
    """Run ``body`` on the local shards of ``args`` (one spec tree each)
    and place its results by ``out_specs`` (see the module docstring).
    Under ``torch.func.vmap`` the batch runs one slice at a time
    (``_VmapLoop``): the collectives cannot take vmap's batched tensors."""
    if is_batched(args):
        return _ShardMapJob(mesh, body, in_specs, out_specs, args).batched()
    as_dtensor = _has_dtensor(args)
    local = [_zip_map(lambda t, s: _to_local(mesh, t, s), a, s)
             for a, s in zip(args, in_specs)]
    stack = _SCOPE.__dict__.setdefault("meshes", [])
    stack.append(mesh)
    try:
        out = body(*local)
    finally:
        stack.pop()
    return _zip_map(lambda t, s: _from_local(mesh, t, s, as_dtensor), out,
                    out_specs)


# ---------------------------------------------------------------------------
# the sharded operator
# ---------------------------------------------------------------------------

def _overrides(op: LinearOperator, name: str) -> bool:
    """Whether ``op`` brings its own ``name`` instead of the matrix-free
    base default.  ``FunctionOperator.rmatvec`` only counts when an
    explicit rmatvec closure was supplied."""
    if name == "rmatvec" and isinstance(op, ops.FunctionOperator):
        return op._rmatvec is not None
    return getattr(type(op), name) is not getattr(LinearOperator, name)


class _LocalShardView(LinearOperator):
    """A plain-captured operator re-examined at the LOCAL shard.

    Inside the shard_map body the base operator still carries its GLOBAL
    structural ``example``, so its matrix-free defaults — ``rmatvec`` via
    ``torch.func.vjp``, probing ``diagonal``/``materialize`` — would run at
    global shapes against local shards.  This view delegates genuinely
    overridden methods and re-anchors the defaults on the local example.
    Square systems (domain structure == codomain structure).
    """

    def __init__(self, op: LinearOperator, example_local):
        super().__init__(example_local, batch_ndim=op.batch_ndim,
                         symmetric=op.symmetric,
                         positive_definite=op.positive_definite)
        self._op = op

    def matvec(self, v):
        """The base operator's matvec on the local shard."""
        return self._op.matvec(v)

    def rmatvec(self, v):
        """The base operator's rmatvec, or the VJP default at local shapes."""
        if self._op.symmetric or _overrides(self._op, "rmatvec"):
            return self._op.rmatvec(v)
        return super().rmatvec(v)

    def diagonal(self):
        """The base operator's diagonal, or probing at local shapes."""
        if _overrides(self._op, "diagonal"):
            return self._op.diagonal()
        return super().diagonal()

    def materialize(self):
        """The base operator's dense form, or probing at local shapes."""
        if _overrides(self._op, "materialize"):
            return self._op.materialize()
        return super().materialize()


class ShardedOperator(LinearOperator):
    """A ``LinearOperator`` placed on a mesh.

    ``op`` is either a plain operator (its matvec must be shard-local with
    replicated captures — see the module docstring) or a *factory*
    ``factory(*operands_local) -> LinearOperator`` building the per-shard
    operator from sharded operands (the Jacobian case: the primal point and
    batched theta shard alongside the domain).  ``in_specs``/``out_specs``
    are ``PartitionSpec`` trees over the domain/codomain (square systems
    default ``out_specs = in_specs``); a single spec broadcasts over the
    tree.  ``reduce`` overrides the sum-over-instance-axes reduction hook
    the sharded solvers use for their dot products.

    Flags (``symmetric``/``positive_definite``/``batch_ndim``) and the
    structural ``example`` are read off the (template) base operator, so
    routing, validation and preconditioner derivation see through the
    placement wrapper unchanged.
    """

    is_sharded = True

    def __init__(self, op, mesh, in_specs, *, out_specs=None,
                 operands: tuple = (), operand_specs: tuple = (),
                 reduce: Optional[Callable] = None):
        if isinstance(op, LinearOperator):
            if operands:
                raise ValueError("operands require a factory; a plain "
                                 "LinearOperator captures its tensors "
                                 "(replicated into every shard)")
            template = op
        elif callable(op):
            template = op(*operands)
            if not isinstance(template, LinearOperator):
                raise TypeError("factory must build a LinearOperator; got "
                                f"{type(template)!r}")
        else:
            raise TypeError(f"cannot shard {type(op)!r}; expected a "
                            "LinearOperator or a factory callable")
        if len(operands) != len(operand_specs):
            raise ValueError(f"{len(operands)} operands but "
                             f"{len(operand_specs)} operand_specs")
        super().__init__(template.example, batch_ndim=template.batch_ndim,
                         symmetric=template.symmetric,
                         positive_definite=template.positive_definite)
        self.mesh = mesh
        self.in_specs = spec_tree(in_specs, template.example)
        self.out_specs = self.in_specs if out_specs is None \
            else spec_tree(out_specs, template.example)
        self._psum_axes = instance_axes(self.in_specs, self.batch_ndim)
        self._batch_axes = batch_axes(self.in_specs, self.batch_ndim)
        self._plain = isinstance(op, LinearOperator)
        if self._plain:
            op, operands, operand_specs = self._lift_plain(op)
            self._plain = not operands      # a DenseOperator lifted to a
            # factory over local matrices is already local-examined
        self._factory = op
        self.operands = tuple(operands)
        self.operand_specs = tuple(
            spec_tree(s, o) for s, o in zip(operand_specs, self.operands))
        self._reduce_arg = reduce
        self.reduce = reduce if reduce is not None \
            else psum_reduction(self._psum_axes)

    def _lift_plain(self, op: LinearOperator):
        """Turn a plain operator into (factory, operands, operand_specs).

        A batch-sharded ``DenseOperator`` carries its ``(B, d, d)`` stack as
        a sharded operand (each rank holds its batch slice of matrices);
        everything else is captured by closure — replicated into every
        shard, so its matvec must be shard-local (see module docstring).
        """
        if isinstance(op, ops.DenseOperator) and self.batch_ndim == 1 \
                and not self.instance_sharded and self._batch_axes:
            baxis = self._batch_axes[0] if len(self._batch_axes) == 1 \
                else self._batch_axes
            sym, pd = op.symmetric, op.positive_definite

            def dense_factory(A_local):
                return ops.DenseOperator(A_local, symmetric=sym,
                                         positive_definite=pd)

            return dense_factory, (op.A,), (P(baxis, None, None),)
        return (lambda: op), (), ()

    # -- shard-level access ----------------------------------------------
    @property
    def instance_sharded(self) -> bool:
        """Whether instance dims (not just the batch) are split across
        ranks — i.e. whether dot products need cross-rank reduction."""
        return bool(self._psum_axes)

    def local_operator(self, *operands_local,
                       example_local=None) -> LinearOperator:
        """The per-shard base operator (called INSIDE the shard_map body).

        Factory-built operators are already anchored on local operands; a
        plain-captured operator is re-examined at ``example_local`` (the
        local shard) so the matrix-free base defaults run at shard shapes
        — see ``_LocalShardView``.
        """
        local = self._factory(*operands_local)
        if self._plain and example_local is not None:
            if isinstance(local, ops.TransposedOperator):
                # re-anchor the UNDERLYING operator, then transpose: the
                # transposed matvec is the base rmatvec, which must run at
                # local shapes too
                return _LocalShardView(local.op,
                                       example_local).transpose()
            return _LocalShardView(local, example_local)
        return local

    def shard_map(self, body: Callable, extra_in_specs: tuple,
                  out_specs) -> Callable:
        """``body(*operands_local, *extra_local)`` on this operator's mesh,
        with the operands prepended (see the module docstring)."""
        in_specs = (*self.operand_specs, *extra_in_specs)
        return lambda *extra: _shard_map(self.mesh, body, in_specs,
                                         out_specs, (*self.operands, *extra))

    # -- LinearOperator protocol -----------------------------------------
    def matvec(self, v):
        """``A v``, each shard's product of its local operator."""
        def body(*args):
            *ops_l, v_l = args
            return self.local_operator(*ops_l,
                                       example_local=v_l).matvec(v_l)

        return self.shard_map(body, (self.in_specs,), self.out_specs)(v)

    def rmatvec(self, v):
        """``Aᵀ v``, each shard's adjoint product."""
        if self.symmetric:
            return self.matvec(v)

        def body(*args):
            *ops_l, v_l = args
            return self.local_operator(*ops_l,
                                       example_local=v_l).rmatvec(v_l)

        return self.shard_map(body, (self.out_specs,), self.in_specs)(v)

    def transpose(self) -> LinearOperator:
        """``Aᵀ`` on the same mesh, in and out specs swapped."""
        if self.symmetric:
            return self
        out = ShardedOperator(
            lambda *o: self._factory(*o).transpose(), self.mesh,
            self.out_specs, out_specs=self.in_specs,
            operands=self.operands, operand_specs=self.operand_specs,
            reduce=self._reduce_arg)
        out._plain = self._plain    # plain-capture local re-examining
        # survives transposition (the wrapper factory is ours)
        return out

    def diagonal(self):
        """diag(A), assembled from per-shard diagonals (each rank probes
        only its local block)."""
        def body(*args):
            *ops_l, ex_l = args
            return self.local_operator(*ops_l,
                                       example_local=ex_l).diagonal()

        return self.shard_map(body, (self.in_specs,),
                              self.in_specs)(self.example)

    def materialize(self) -> torch.Tensor:
        """Per-shard dense pieces.  Batch sharding assembles the global
        ``(B, d, d)`` stack (each rank holds its batch slice); instance
        sharding returns the local diagonal blocks stacked along a leading
        shard axis ``(n_shards, d_local, d_local)`` — there is no global
        dense form without a gather of the whole operator.
        """
        if not self.instance_sharded:
            bspec = self._batch_axes[0] if len(self._batch_axes) == 1 \
                else (self._batch_axes or None)
            out = P(bspec, None, None) if self.batch_ndim else P(None, None)

            def body(*args):
                *ops_l, ex_l = args
                return self.local_operator(
                    *ops_l, example_local=ex_l).materialize()

            return self.shard_map(body, (self.in_specs,),
                                  out)(self.example)

        out = P(self._psum_axes if len(self._psum_axes) > 1
                else self._psum_axes[0], None, None)

        def body(*args):
            *ops_l, ex_l = args
            return self.local_operator(
                *ops_l, example_local=ex_l).materialize()[None]

        return self.shard_map(body, (self.in_specs,), out)(self.example)


# ---------------------------------------------------------------------------
# the placement bundle the diff layer threads through ImplicitDiffSpec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SolveSharding:
    """Mesh placement for an implicit system (``ImplicitDiffSpec.sharding``).

    ``spec`` is the PartitionSpec (tree) of the solution ``x`` — the specs
    the backward/tangent solve inherits from the primal solution.
    ``theta_specs`` aligns with the solver's *differentiable* theta
    arguments (``None`` → replicated; per-entry ``None`` → that argument
    replicated).  ``batch_ndim = 1`` declares a leading batch axis on every
    ``x`` leaf (independent instances → per-instance convergence masks in
    the sharded solvers).  ``reduce`` overrides the reduction hook.
    """
    mesh: Any
    spec: Any
    theta_specs: Optional[Tuple[Any, ...]] = None
    batch_ndim: int = 0
    reduce: Optional[Callable] = None

    def x_specs(self, x):
        """The spec tree of a solution-shaped tree."""
        return spec_tree(self.spec, x)

    def theta_spec(self, i: int, arg):
        """The spec tree of differentiable theta argument ``i``."""
        specs = self.theta_specs
        entry = None if specs is None or i >= len(specs) else specs[i]
        return spec_tree(P() if entry is None else entry, arg)

    def wrap(self, factory: Callable, operands: tuple) -> ShardedOperator:
        """Place a per-shard operator factory on the mesh.  ``operands``
        are ``(x_like, *theta)``: the first operand shards like the
        solution, the rest per ``theta_specs``."""
        operand_specs = (self.x_specs(operands[0]),) + tuple(
            self.theta_spec(i, a) for i, a in enumerate(operands[1:]))
        return ShardedOperator(factory, self.mesh, self.x_specs(
            operands[0]), operands=operands, operand_specs=operand_specs,
            reduce=self.reduce)

    def constrain(self, tree):
        """Pin ``tree`` to this placement: ``redistribute`` for DTensors,
        ``distribute_tensor`` (rank 0's value, scattered) for plain
        tensors."""
        def place(t, s):
            if not isinstance(t, torch.Tensor):
                return t
            want = placements(self.mesh, s, t.ndim)
            if isinstance(t, DTensor):
                return t if tuple(t.placements) == want \
                    else t.redistribute(self.mesh, want)
            return distribute_tensor(t, self.mesh, want)

        return _zip_map(place, tree, self.x_specs(tree))

    def _specs(self, x_star, theta_args):
        return self.x_specs(x_star), tuple(
            self.theta_spec(i, a) for i, a in enumerate(theta_args))

    def theta_vjp(self, vjp: Callable, x_star, theta_args: tuple, u):
        """``vjp(x, theta, u) -> uᵀ ∂₂F`` per θ argument, on the local
        shards.  A θ leaf that an axis splitting ``x`` does not split gets
        the sum of its per-shard products over that axis (the partial
        ``uᵀ ∂₂F`` of each shard's instances or components)."""
        xs, ths = self._specs(x_star, theta_args)
        x_axes = instance_axes(xs, 0)

        def total(g, s):
            split = axes_of(tuple(s))
            names = [n for n in x_axes if n not in split
                     and axis_size(self.mesh, n) > 1]
            return _all_reduce_sum(g, self.mesh, names) if names else g

        def body(x_l, th_l, u_l):
            return _zip_map(total, tuple(vjp(x_l, th_l, u_l)), ths)

        return _shard_map(self.mesh, body, (xs, ths, xs), ths,
                          (x_star, tuple(theta_args), u))

    def theta_jvp(self, jvp: Callable, x_star, theta_args: tuple,
                  tangents: tuple):
        """``jvp(x, theta, tangents) -> ∂₂F θ̇`` on the local shards,
        placed like ``x``."""
        xs, ths = self._specs(x_star, theta_args)
        return _shard_map(self.mesh, jvp, (xs, ths, ths), xs,
                          (x_star, tuple(theta_args), tuple(tangents)))


# ---------------------------------------------------------------------------
# torch.func.vmap of a shard_map or a sharded solve
# ---------------------------------------------------------------------------

class _VmapLoop(torch.autograd.Function):
    """A job (``_ShardMapJob`` / ``_SolveJob``) on its flat tensors, whose
    ``vmap`` rule runs the batch as one job when the job can fold the
    mapped axis into its own batch (``fold``), else one job per slice.
    Each job is applied again, so that nested vmaps batch in turn.
    Forward only: a sharded solve is not differentiated again."""

    @staticmethod
    def forward(job, *tensors):
        return job.run(tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, job, *tensors):
        tensors, dims = batch_first(tensors, in_dims[1:])
        folded = job.fold(tensors, dims, info.batch_size)
        if folded is not None:
            out = folded
        else:
            slices = [_VmapLoop.apply(job, *(t if d is None else t[i]
                                             for t, d in zip(tensors, dims)))
                      for i in range(info.batch_size)]
            out = tuple(torch.stack(o) for o in zip(*slices))
        return out, (0,) * len(out)


class _ShardMapJob:
    """``_shard_map(mesh, body, in_specs, out_specs, args)`` as a job of
    ``_VmapLoop`` (no fold: ``body`` is any per-shard function)."""

    def __init__(self, mesh, body, in_specs, out_specs, args):
        self.mesh, self.body = mesh, body
        self.in_specs, self.out_specs = in_specs, out_specs
        self.args = Flat(*args)
        self.out = None

    def run(self, tensors) -> tuple:
        out = _shard_map(self.mesh, self.body, self.in_specs,
                         self.out_specs, tuple(self.args.trees(tensors)))
        leaves, self.out = tree_flatten(out)
        return tuple(leaves)

    def fold(self, tensors, dims, size):
        return None

    def batched(self):
        out = _VmapLoop.apply(self, *self.args.tensors)
        return tree_unflatten(list(out), self.out)


def _fold_rows(t, n_slices: int, n_inst: int, mapped: bool):
    """``(n_inst · n_slices, ...)`` rows, instance-major: a mapped tensor
    ``(n_slices, n_inst, ...)`` moves its instance axis first; a shared
    one ``(n_inst, ...)`` is repeated per slice."""
    if mapped:
        t = t.movedim(0, 1)
    else:
        t = t.unsqueeze(1).expand((n_inst, n_slices) + tuple(t.shape[1:]))
    return t.reshape((n_inst * n_slices,) + tuple(t.shape[2:]))


class _SolveJob:
    """A sharded registry solve (``_sharded_call``) as a job of
    ``_VmapLoop``: its tensors are the operator's operands', then the
    right-hand side's and the warm start's.  Its fold: a batch of
    right-hand sides (and warm starts) against one operator whose operands
    all carry the mesh's batch axis first becomes ONE solve of ``B·V``
    instances, each instance's ``V`` right-hand sides side by side, so
    that every rank keeps its own instances."""

    def __init__(self, inner, name, op, b, init, kw):
        self.inner, self.name, self.op, self.kw = inner, name, op, kw
        self.flat = Flat(op.operands, b, init)
        self.n_op = self.flat.counts[0]
        self.info = None

    def run(self, tensors) -> tuple:
        operands, b, init = self.flat.trees(tensors)
        op = self.op
        if self.n_op:
            op = ShardedOperator(op._factory, op.mesh, op.in_specs,
                                 out_specs=op.out_specs,
                                 operands=tuple(operands),
                                 operand_specs=op.operand_specs,
                                 reduce=op._reduce_arg)
        out = _sharded_call(self.inner, self.name, op, b, init=init,
                            **self.kw)
        x, info = out if self.kw["return_info"] else (out, None)
        leaves, self.x = tree_flatten(x)
        if info is None:
            return tuple(leaves)
        self.info = [f for f, v in zip(info._fields, info) if v is not None]
        return tuple(leaves) + tuple(getattr(info, f) for f in self.info)

    def unpack(self, out):
        """``_sharded_call``'s result from the job's flat outputs."""
        n = self.flat.counts[1]
        x = tree_unflatten(list(out[:n]), self.x)
        if not self.kw["return_info"]:
            return x
        return x, ls.SolveInfo(**dict(zip(self.info, out[n:])))

    def fold(self, tensors, dims, size):
        op, n = self.op, self.n_op
        leads = []
        _zip_map(lambda t, s: leads.append(s[0] if len(s) else None)
                 if isinstance(t, torch.Tensor) else None, op.operands,
                 op.operand_specs)
        if not n or op.batch_ndim != 1 or not op._batch_axes or \
                any(d is not None for d in dims[:n]) or \
                any(set(axes_of(lead)) != set(op._batch_axes)
                    for lead in leads):
            return None
        n_inst = tree_flatten(op.example)[0][0].shape[0]
        folded = [_fold_rows(t, size, n_inst, d is not None)
                  for t, d in zip(tensors, [None] * n + list(dims[n:]))]
        out = _VmapLoop.apply(self, *folded)
        return tuple(o.reshape((n_inst, size) + tuple(o.shape[1:]))
                     .movedim(1, 0) for o in out)


# ---------------------------------------------------------------------------
# sharded registry solvers: the whole masked loop on the local shards
# ---------------------------------------------------------------------------

def _require_sharded(name: str, matvec) -> ShardedOperator:
    if not isinstance(matvec, ShardedOperator):
        raise ValueError(
            f"solver {name!r} runs per shard and needs a mesh + "
            f"PartitionSpecs; wrap the operator in a ShardedOperator "
            f"(got {type(matvec).__name__})")
    return matvec


def _info_specs(op: ShardedOperator):
    """SolveInfo leaves are per-instance scalars: sharded along the batch
    axes under batch sharding, replicated (post-reduction) otherwise."""
    if op.batch_ndim and op._batch_axes:
        axes = op._batch_axes[0] if len(op._batch_axes) == 1 \
            else op._batch_axes
        leaf = P(axes)
    else:
        leaf = P()
    return ls.SolveInfo(iterations=leaf, residual=leaf, converged=leaf)


def _sharded_call(inner: Callable, name: str, matvec, b, *, init=None,
                  return_info: bool = False, batch_ndim: int = 0,
                  with_reduce: bool = True, **kw):
    """Run ``inner(local_op, b_local, ...)`` on the local shards (under
    ``torch.func.vmap`` through ``_SolveJob``)."""
    op = _require_sharded(name, matvec)
    if is_batched(op.operands, b, init):
        job = _SolveJob(inner, name, op, b, init,
                        dict(kw, return_info=return_info,
                             batch_ndim=batch_ndim, with_reduce=with_reduce))
        return job.unpack(_VmapLoop.apply(job, *job.flat.tensors))
    if batch_ndim not in (0, op.batch_ndim):
        raise ValueError(f"batch_ndim={batch_ndim} does not match the "
                         f"sharded operator's batch_ndim={op.batch_ndim}")
    kw = dict(kw, batch_ndim=op.batch_ndim, return_info=return_info)
    if with_reduce:
        kw["reduce"] = op.reduce
    n_op = len(op.operands)
    has_init = init is not None

    def body(*args):
        ops_l = args[:n_op]
        b_l = args[n_op]
        init_l = args[n_op + 1] if has_init else None
        # square system: the codomain rhs shard doubles as the local
        # domain example for the plain-capture path's defaults
        local = op.local_operator(*ops_l, example_local=b_l)
        return inner(local, b_l, init=init_l, **kw)

    # the right-hand side lives in the CODOMAIN (out_specs); the warm start
    # and the solution in the domain (in_specs)
    extra_in = (op.out_specs,) + ((op.in_specs,) if has_init else ())
    out_specs = (op.in_specs, _info_specs(op)) if return_info \
        else op.in_specs
    args = (b, init) if has_init else (b,)
    return op.shard_map(body, extra_in, out_specs)(*args)


def sharded_solve_cg(matvec, b, **kw):
    """Distributed CG: matvec per shard, dot products through the
    operator's reduction hook, per-instance masks intact."""
    return _sharded_call(ls.solve_cg, "sharded_cg", matvec, b, **kw)


def sharded_solve_normal_cg(matvec, b, **kw):
    """Distributed CG on the normal equations (general square A; the local
    operator answers ``rmatvec`` per shard)."""
    return _sharded_call(ls.solve_normal_cg, "sharded_normal_cg", matvec, b,
                         **kw)


def sharded_solve_dense_gmres(matvec, b, **kw):
    """Distributed dense GMRES: each rank materializes + solves its local
    batch slice.  Batch sharding only — a dense instance-sharded system has
    no local (d, d) form."""
    op = _require_sharded("sharded_dense_gmres", matvec)
    if op.instance_sharded:
        raise ValueError(
            "sharded_dense_gmres materializes per-shard dense systems, "
            "which needs the instance dims unsharded (batch sharding only);"
            " use sharded_cg/sharded_normal_cg for instance-dim sharding")
    return _sharded_call(ls.solve_dense_gmres, "sharded_dense_gmres",
                         matvec, b, with_reduce=False, **kw)
