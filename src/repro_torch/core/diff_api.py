"""One mode-polymorphic implicit-differentiation API (PyTorch).

Counterpart of ``repro.core.diff_api``: the optimality-condition *spec* is
decoupled from the differentiation *mechanism*.

  * ``ImplicitDiffSpec`` — the declarative spec: an optimality mapping
    ``F(x, *theta)`` (root form) or fixed-point mapping ``T(x, *theta)``,
    plus the linear-solve routing (``solve`` / ``precond`` / ``ridge`` /
    ``tol`` / ``maxiter``), ``has_aux`` and ``nondiff_argnums``.
  * ``implicit_diff(spec)(solver)`` — one wrapper serving both autodiff
    modes.
  * ``root_vjp`` / ``root_jvp`` — the products with the implicit Jacobian
    (paper §2.1), shared by every mode.

How one wrapper serves both modes
---------------------------------
The wrapped solver runs inside ONE ``torch.autograd.Function`` whose
forward calls the solver under ``no_grad`` — its iterations are never
differentiated — and whose derivatives come from the implicit function
theorem on ``A dx = B θ̇`` with ``A = -∂₁F(x*, θ)``, ``B = ∂₂F(x*, θ)``:

  * ``backward`` is ``root_vjp``: solve ``Aᵀ u = v`` through the solver
    registry, then ``θ̄ = uᵀB`` by one ``torch.func.vjp``;
  * ``jvp`` is ``root_jvp``: ``Bθ̇`` by one ``torch.func.jvp``, then solve
    ``A dx = Bθ̇``.

So ``torch.autograd.grad`` / ``backward`` / ``torch.func.grad`` /
``jacrev`` and ``torch.func.jvp`` / ``jacfwd`` all work on the same
wrapped function.  ``A`` is one ``JacobianOperator`` per call (matvec a
JVP, rmatvec a VJP), certified symmetric when the routed solver is
symmetric-only, or whatever the spec's ``system_operator`` factory
builds.  Forward mode goes through ``torch.func.jvp`` (the operator's
matvec is itself a ``torch.func.jvp``, which the one-level
``torch.autograd.forward_ad`` cannot nest).  ``backward`` picks the
treatment of the linear system in both directions: the converged solve
(``"exact"``) or a fixed-budget polynomial (``"one_step"``,
``"neumann_k"``, ``"jacobian_free"``; ``linear_solve.approx_inverse_apply``).

Batching: the registry solvers read the host once an iteration, so they
cannot run on ``torch.func.vmap``'s batched tensors.  Both the wrapper's
Function and the linear solve of ``root_vjp`` / ``root_jvp`` (its own
``torch.autograd.Function``, ``_SystemSolve``) therefore carry a ``vmap``
rule: under ``torch.func.vmap`` the forward runs the solver once on the
batch (``run()``'s loop masks each instance at its own convergence), and
the backward or tangent system of the whole batch is ONE registry solve
on a batch-aware operator (``batch_ndim=1``) built as a
``torch.func.vmap`` of the per-instance JVP / VJP.  ``vmap`` of
``grad``, of ``jvp``, ``jacrev`` (one operator, many right-hand sides)
and ``jacfwd`` each run one solve; a ``vmap`` of a ``vmap`` folds both
axes into that one solve.  Each rule applies its Function again on the
batch, so a derivative level below the ``vmap`` still reaches the rules.

Second derivatives: ``_SystemSolve`` is differentiable to any order with
the semantics of ``lax.custom_linear_solve`` (its ``backward`` solves the
flipped direction, its ``jvp`` the same one, each a ``_SystemSolve``
again), and the rules of the wrapper's Function are differentiable at
the next level, so ``grad(grad)``, ``torch.func.hessian``
(``jacfwd(grad)``), ``grad`` of ``jvp`` and ``jacfwd(jacfwd)`` give the
JAX package's values, ``vmap`` of each one solve per level.  At an outer
level x*'s own derivative is exact (``_Call.outer``: no approximate
``backward``, no ``ridge``).  A Function's ``jvp`` rule runs with forward
mode off, which would drop an outer ``jvp``'s tangent of its work; the
rules strip their own level's tangent and turn forward mode back on
(``_primal``).

Mode selection (``mode=``): ``"auto"`` (both), ``"vjp"`` (reverse only;
forward mode raises), ``"jvp"`` (forward only).  ``"auto"`` gives all
four second-order combinations.  A single-mode wrapper, and ``root_vjp``
/ ``root_jvp`` called directly, differentiate their routed routine as it
stands, as the JAX package's ``custom_vjp`` / ``custom_jvp`` do: forward
mode always; reverse mode through ``lu``, ``pallas_cg`` and the
approximate polynomials, never through the loops (``cg``, ``gmres``,
``normal_cg``, ``bicgstab``: JAX's ``while_loop``s).  So with a loop
``"vjp"`` gives only ``jacfwd(grad)`` and ``"jvp"`` only
``jacfwd(jacfwd)``; with ``lu`` ``"vjp"`` adds ``grad(grad)`` and
``"jvp"`` gives all four.  ``"jvp"``'s own reverse mode transposes its
tangent solve, which JAX does for ``lu``, ``one_step`` and
``jacobian_free`` only (``_TRANSPOSABLE``).  One difference: the port's
``pallas_cg`` op has a forward rule and JAX's Pallas op none, so the
port gives the forward cells through it that JAX refuses.

Mesh placement (``sharding``, a ``repro_torch.distributed.
sharded_operators.SolveSharding``): ``A`` becomes a ``ShardedOperator``
whose operands are x* and θ, placed by the solution's and θ's specs; the
classic solver names upgrade to the ``sharded_*`` solvers, and the θ
products (``uᵀB``, ``Bθ̇``) run on the local shards too.  Tensors cross
as ``DTensor``s (nothing gathered) or as plain tensors every rank holds
alike (global values).  Forward mode takes plain tensors: ``torch.func.
jvp`` does not trace DTensors.  Under ``torch.func.vmap`` (plain
tensors) the solves of a system with a batch axis (``batch_ndim=1``) fold
the ``vmap`` batch into it: ONE sharded solve a level, the operators
batched or shared (``_System._folded``); any other sharded solve batches
itself (one solve where the operator is shared, one per slice
otherwise).  A derivative of a sharded solve (second order, or
``root_vjp`` / ``root_jvp`` differentiated) takes plain tensors: its
rules' products run on the global values, unplaced (``torch.func``
traces no collective), its solves on the mesh.

Conventions: the wrapped solver has signature ``solver(init, *theta)`` and
returns ``x*`` (or ``(x*, aux)`` with ``has_aux=True``).  ``F``/``T`` take
``(x, *theta)`` and return a pytree with the structure of ``x``.  ``init``
and ``aux`` get no derivative; tensor leaves of the differentiable θ
arguments are the inputs the derivatives flow to.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import warnings
from typing import Any, Callable, Optional, Tuple, Union

import torch
import torch.func
from torch.distributed.tensor import DTensor

from repro_torch.core import linear_solve as ls
from repro_torch.core import operators as ops
from repro_torch.core._tree import (Flat, batch_first, canonical,
                                    tree_flatten, tree_leaves, tree_map,
                                    tree_unflatten)
from repro_torch.distributed.spec import P
from repro_torch.observability import events as obs_events


# ---------------------------------------------------------------------------
# one-shot deprecation plumbing (shared with implicit_diff)
# ---------------------------------------------------------------------------

_WARNED: set = set()


def warn_once(key: str, message: str, *, stacklevel: int = 3) -> None:
    """Emit ``DeprecationWarning`` exactly once per ``key`` per process."""
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(message, DeprecationWarning, stacklevel=stacklevel)


def reset_deprecation_warnings() -> None:
    """Forget which one-shot deprecation warnings fired (test hook)."""
    _WARNED.clear()


# ---------------------------------------------------------------------------
# the spec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ImplicitDiffSpec:
    """Declarative spec of an implicitly-differentiated solver.

    At most one of ``optimality_fun`` (root form: F(x*, θ) = 0) or
    ``fixed_point_fun`` (x* = T(x*, θ); the residual T(x) − x is derived)
    is set.  A spec with neither is *routing-only*: a bundle of
    backward-solve settings (``solve_bilevel(diff_spec=...)``, the DEQ
    layer, the solve service's ``spec=``), not wrappable by itself.

    ``solve`` is a registry name, ``"auto"``, or a callable
    ``fn(matvec, b, *, tol, maxiter, ridge)``; ``tol`` / ``maxiter`` /
    ``ridge`` / ``precond`` are forwarded to it for both the tangent and
    the cotangent system.  ``has_aux=True``: the solver returns
    ``(x_star, aux)`` and ``aux`` gets no derivative.  ``nondiff_argnums``
    index the solver's ``*theta`` (0 = first after ``init``) for static
    non-tensor values passed through untouched.

    ``backward`` selects how the linear system is treated in both
    directions: ``"exact"`` (default) iterates the routed solver to
    convergence; ``"one_step"`` spends one preconditioned application;
    ``"neumann_k"`` truncates the Neumann series at exactly
    ``backward_iters`` terms; ``"jacobian_free"`` treats ``A ≈ I``.
    ``error_estimate`` controls whether info-returning entry points
    (``root_vjp(..., return_info=True)``,
    ``IterativeSolver.estimate_hypergrad_error``) spend one extra matvec
    on the relative residual.

    ``system_operator`` overrides how ``A`` is *built*: a factory
    ``(x_star, theta_args, *, symmetric) -> LinearOperator`` returning
    the full ``A = -∂₁F(x*, θ)`` including the negation; ``symmetric`` is
    ``True`` when the routed solver is symmetric-only, else ``None``.
    ``B = ∂₂F`` stays exact (the stochastic layer's sampled Hessian is
    the use).  Mutually exclusive with ``sharding``.

    ``sharding`` (a ``repro_torch.distributed.sharded_operators.
    SolveSharding``) places the implicit system on a mesh: the
    ``JacobianOperator`` inherits the primal solution's mesh and
    PartitionSpecs, the classic solver names upgrade to their distributed
    variants (``cg`` → ``sharded_cg``, …), and both modes' linear solves
    run on the local shards, with nothing gathered when the tensors are
    DTensors.
    """
    optimality_fun: Optional[Callable] = None
    fixed_point_fun: Optional[Callable] = None
    solve: Union[str, Callable] = "normal_cg"
    tol: float = 1e-6
    maxiter: int = 1000
    ridge: float = 0.0
    precond: Any = None
    has_aux: bool = False
    nondiff_argnums: Tuple[int, ...] = ()
    sharding: Any = None
    backward: str = "exact"
    backward_iters: int = 8
    error_estimate: bool = True
    system_operator: Optional[Callable] = None

    def __post_init__(self):
        if self.system_operator is not None and self.sharding is not None:
            raise ValueError(
                "system_operator and sharding are mutually exclusive: a "
                "factory-built system has no mesh placement contract")
        if self.optimality_fun is not None and \
                self.fixed_point_fun is not None:
            raise ValueError("provide at most one of optimality_fun / "
                             "fixed_point_fun, not both")
        nd = tuple(sorted(set(int(i) for i in self.nondiff_argnums)))
        if any(i < 0 for i in nd):
            raise ValueError("nondiff_argnums are 0-based indices into the "
                             f"theta arguments; got {self.nondiff_argnums}")
        object.__setattr__(self, "nondiff_argnums", nd)
        ls.check_backward(self.backward, self.backward_iters)

    @property
    def residual_fun(self) -> Callable:
        """The root residual F(x, *theta) this spec differentiates through."""
        if self.optimality_fun is not None:
            return self.optimality_fun
        if self.fixed_point_fun is not None:
            T = self.fixed_point_fun

            def residual(x, *theta):
                return tree_map(lambda a, b: a - b, T(x, *theta), x)

            return residual
        raise ValueError(
            "routing-only ImplicitDiffSpec: set optimality_fun or "
            "fixed_point_fun before wrapping a solver with it")

    @property
    def is_routing_only(self) -> bool:
        """True when no optimality/fixed-point mapping is declared."""
        return self.optimality_fun is None and self.fixed_point_fun is None

    def replace(self, **changes) -> "ImplicitDiffSpec":
        """A copy of the spec with ``changes`` applied (per-call overrides)."""
        return dataclasses.replace(self, **changes)

    def routing_kwargs(self) -> dict:
        """The backward-solve routing as ``route_solve`` keyword arguments."""
        return dict(tol=self.tol, maxiter=self.maxiter, ridge=self.ridge,
                    precond=self.precond)

    def backward_kwargs(self) -> dict:
        """The approximate-backward selection as keyword arguments."""
        return dict(backward=self.backward,
                    backward_iters=self.backward_iters)


# ---------------------------------------------------------------------------
# the implicit linear system (paper §2.1)
# ---------------------------------------------------------------------------

def _implicit_system_operator(F: Callable, x_star, theta_args: tuple,
                              solve, sharding=None, system_operator=None,
                              batch_ndim: int = 0) -> ops.LinearOperator:
    """``A = -∂₁F(x*, θ)`` as a ``JacobianOperator``, certified symmetric
    when the routed solver is symmetric-only (``cg``/``pallas_cg``/
    ``sharded_cg``); or the operator the ``system_operator`` factory
    builds.  With ``sharding`` set, the operator is placed on the mesh:
    x* and every θ argument become its operands (specs from the solution /
    ``theta_specs``), so its matvec is a per-shard JVP and the registry
    dispatches the distributed solvers."""
    certified = solve != "auto" and ls.solver_is_symmetric(solve)
    sym = True if certified else None
    if system_operator is None:
        if sharding is None:
            return ops.JacobianOperator(lambda x: F(x, *theta_args), x_star,
                                        negate=True, symmetric=sym,
                                        batch_ndim=batch_ndim)

        def jacobian_factory(x_local, *theta_local):
            return ops.JacobianOperator(
                lambda x: F(x, *theta_local), x_local, negate=True,
                symmetric=sym, batch_ndim=sharding.batch_ndim)

        return sharding.wrap(jacobian_factory, (x_star, *theta_args))
    if sharding is not None:
        raise ValueError("system_operator and sharding are mutually "
                         "exclusive")
    A = system_operator(x_star, theta_args, symmetric=sym)
    if not isinstance(A, ops.LinearOperator):
        raise TypeError("system_operator factory must return a "
                        f"LinearOperator; got {type(A)!r}")
    if certified and A.symmetric is False:
        raise ValueError(
            f"routed solver {solve!r} is symmetric-only but the "
            "system_operator factory declared symmetric=False")
    return A


def _check_approx_routing(precond, sharding):
    """Reject routing combos the approximate backward modes can't honor."""
    if sharding is not None and isinstance(precond, str):
        raise ValueError(
            "approximate backward modes with a sharded system do not "
            "support named preconditioners (deriving the global diagonal "
            "outside the shards would capture replicated state); pass a "
            "callable M⁻¹ or precond=None")


def _backward_apply(A, rhs, *, solve, tol, maxiter, ridge, precond,
                    backward, backward_iters, batch_ndim: int,
                    error_estimate: bool, return_info: bool,
                    direction: str = "vjp"):
    """Apply the selected backward treatment of ``A`` to ``rhs``.

    ``backward="exact"`` routes the registry solver to convergence; the
    approximate modes spend their fixed matvec budget through
    ``approx_inverse_apply``.  With ``return_info=True`` both return
    ``(u, SolveInfo)`` and, when ``error_estimate``, fill
    ``hypergrad_error_estimate`` with ``‖rhs − A u‖/‖rhs‖`` at one extra
    matvec (recomputed for exact solves too: normal_cg reports the normal
    equations' residual).  With observability on, emits the
    ``backward_start``/``backward_done`` pair (``direction`` is "vjp" or
    "jvp").
    """
    observing = obs_events.observing()
    tags = {"direction": direction, "backward": backward,
            "matvec_budget": (-1 if backward == "exact" else
                              ls.approx_matvec_count(backward,
                                                     backward_iters)),
            "solver": solve if isinstance(solve, str) else "custom"}
    # custom exact-solve callables own their diagnostics (route_solve
    # rejects return_info for them): they get start/done without values
    can_force = backward != "exact" or not callable(solve)
    want_info = return_info
    if observing:
        return_info = return_info or can_force
    if backward != "exact":
        out = ls.approx_inverse_apply(
            A, rhs, backward=backward, backward_iters=backward_iters,
            ridge=ridge, precond=precond, batch_ndim=batch_ndim, tol=tol,
            error_estimate=error_estimate, return_info=return_info)
    elif not return_info:
        out = ls.route_solve(solve, A, rhs, tol=tol, maxiter=maxiter,
                             ridge=ridge, precond=precond)
    else:
        u, info = ls.route_solve(solve, A, rhs, tol=tol, maxiter=maxiter,
                                 ridge=ridge, precond=precond,
                                 return_info=True)
        if error_estimate:
            mv = ls._damped(A, ridge)
            rn = ls._tree_l2(ls._tree_sub(rhs, mv(u)), batch_ndim)
            est = rn / torch.clamp_min(ls._tree_l2(rhs, batch_ndim), 1e-30)
            info = info._replace(hypergrad_error_estimate=est)
        out = (u, info)
    if not observing:
        return out
    if return_info:
        u, info = out
        extra = ({"hypergrad_error_estimate": info.hypergrad_error_estimate}
                 if info.hypergrad_error_estimate is not None else {})
        obs_events.emit_pair("backward_start", "backward_done", tags,
                             iterations=info.iterations,
                             residual=info.residual,
                             converged=info.converged, **extra)
        return (u, info) if want_info else u
    obs_events.emit_pair("backward_start", "backward_done", tags)
    return out


# The JAX package's solve routines, differentiated as they stand (a
# "direct" system): in reverse mode ``lu`` (``jnp.linalg.solve``),
# ``pallas_cg`` (a ``jax.custom_vjp`` op) and the fixed-budget polynomials
# have a derivative; every other registry solver is a ``while_loop``,
# which has none.  A ``mode="jvp"`` wrapper's reverse mode transposes its
# tangent solve, which JAX can do for ``lu`` (a ``custom_linear_solve``
# inside) and the loop-free polynomials: not for the custom_vjp op, nor
# for ``neumann_k``'s ``fori_loop``.
_REVERSIBLE = frozenset({"lu", "pallas_cg", "one_step", "neumann_k",
                         "jacobian_free"})
_TRANSPOSABLE = frozenset({"lu", "one_step", "jacobian_free"})


def _routine(solve, backward, operator: Callable, rhs, precond) -> str:
    """What a solve runs: the approximate mode's polynomial, or the
    registry solver ``route_solve`` picks (``"auto"`` resolved on
    ``operator()``, a mesh-placed operator's upgrade applied; ``"custom"``
    for a callable)."""
    if backward != "exact":
        return backward
    if callable(solve):
        return "custom"
    if solve == "auto" or solve in ls._SHARDED_UPGRADE:
        A = operator()
        if solve == "auto":
            example = rhs if A.batch_ndim == 0 else \
                tree_map(lambda t: t[0], rhs)
            solve = ls._resolve_auto(A, example, precond)
        if getattr(A, "is_sharded", False):
            solve = ls._SHARDED_UPGRADE.get(solve, solve)
    return solve


def _tracked(tensors, in_rule: bool) -> bool:
    """Whether a derivative level will differentiate work done on
    ``tensors``: a ``torch.func`` level outside the running derivative
    rule (any level, when ``in_rule`` is False), or plain autograd
    recording a graph."""
    tensors = [t for t in tensors if isinstance(t, torch.Tensor)]
    level = torch._C._functorch.maybe_current_level()
    levels = _diff_levels(tensors)
    if level is not None and levels:
        return not in_rule or min(levels) < level
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _placement(sharding, trees, in_rule: bool):
    """``sharding``, or ``None`` where a product on plain tensors (every
    rank's global values) is differentiated (``_tracked``): the product
    then runs unplaced, since ``torch.func`` traces no collective.
    DTensors stay on the mesh."""
    if sharding is None:
        return None
    leaves = [t for tree in trees for t in tree_leaves(tree)]
    if any(isinstance(t, DTensor) for t in leaves):
        return sharding
    return None if _tracked(leaves, in_rule) else sharding


def _check_plain(tensors):
    if any(isinstance(t, DTensor) for t in tensors):
        raise NotImplementedError(_SHARDED_SECOND_ORDER)


class _System:
    """One implicit linear system of ``root_vjp`` / ``root_jvp``: how A is
    built (``F`` at ``x*``, θ) and treated, and the trees ``(x*, θ, rhs)``
    whose tensors cross ``_SystemSolve``.  ``transpose`` solves
    ``Aᵀ u = rhs`` (the cotangent system).

    ``derivative`` says how the solve is differentiated in turn (see
    ``_SystemSolve``): ``"linear_solve"`` as ``lax.custom_linear_solve``
    (both directions, the same treatment of A: the wrapper's ``"auto"``
    mode) or ``"direct"`` as the JAX package's solve routine itself is
    differentiated (``root_vjp`` / ``root_jvp`` called directly and the
    single-mode wrappers): forward mode always, reverse mode where the
    routine has a reverse derivative (``_REVERSIBLE``).  ``source`` names
    what built the system, for the error a derivative that is not
    available raises."""

    def __init__(self, F, x_star, theta_args, rhs, *, transpose, solve,
                 tol, maxiter, ridge, precond, backward, backward_iters,
                 error_estimate, return_info, system_operator, direction,
                 sharding=None, derivative="direct", source="root_vjp"):
        self.F, self.transpose, self.solve = F, transpose, solve
        self.system_operator, self.direction = system_operator, direction
        self.sharding = sharding
        self.derivative, self.source = derivative, source
        # a mesh-placed system carries its batch axis on every leaf
        self.batch_ndim = 0 if sharding is None else sharding.batch_ndim
        self.kw = dict(solve=solve, tol=tol, maxiter=maxiter, ridge=ridge,
                       precond=precond, backward=backward,
                       backward_iters=backward_iters,
                       error_estimate=error_estimate)
        self.return_info = return_info
        self.flat = Flat(x_star, tuple(theta_args), rhs)
        self.operands = Flat(x_star, tuple(theta_args))
        self.info_fields = None
        # a batch of systems (``batched``): the instance count and which
        # operand tensors carry the instance axis (0) or are shared (None)
        self.batch, self.base = None, self

    def operator(self, x_star, theta) -> ops.LinearOperator:
        """The matrix of the system (A, or Aᵀ) at one instance, or of the
        batch as one ``_BatchedSystem``."""
        if self.batch is not None:
            B, dims = self.batch
            x_dims, th_dims = self.operands.dims(dims)
            example = tree_map(lambda t, d: t if d is not None else
                               t.expand((B,) + tuple(t.shape)),
                               x_star, x_dims)
            return _BatchedSystem(self.base, (x_star, theta),
                                  (x_dims, th_dims), example)
        A = _implicit_system_operator(self.F, x_star, theta, self.solve,
                                      self.sharding, self.system_operator)
        return A.T if self.transpose else A

    def matrix(self, x_star, theta) -> ops.LinearOperator:
        """The matrix whose products the rules differentiate: ``operator``,
        or for a mesh-placed system the same matrix on every rank's global
        values (plain tensors), unplaced, since ``torch.func`` traces no
        collective.  Its solves stay on the mesh (``again``)."""
        if self.sharding is None:
            return self.operator(x_star, theta)
        A = _implicit_system_operator(self.F, x_star, theta, self.solve,
                                      batch_ndim=self.batch_ndim)
        return A.T if self.transpose else A

    def routine(self, operands, rhs) -> str:
        """The routine a solve of this system runs (see ``_routine``)."""
        return _routine(self.kw["solve"], self.kw["backward"],
                        lambda: self.operator(*self.operands.trees(operands)),
                        rhs, self.kw["precond"])

    def batched(self, tensors, dims, size: int):
        """This system over a ``vmap`` rule's batch (``tensors`` with their
        batch axes first, ``dims`` 0 or None): ONE system on
        ``_BatchedSystem``.  A system that is already a batch (a ``vmap``
        of a ``vmap``) folds the new axis into its instance axis, so that
        the registry still sees one solve; ``unbatch`` splits the
        solve's outputs again.  A mesh-placed system folds the batch into
        its own instance axis instead (``_folded``).  Returns ``(system,
        unbatch)``."""
        if self.sharding is not None:
            return self._folded(tensors, dims, size)
        n_op = len(self.operands.tensors)
        if self.batch is None:
            folded = [t if d is not None or i < n_op else
                      t.expand((size,) + tuple(t.shape))
                      for i, (t, d) in enumerate(zip(tensors, dims))]
            op_dims, count = list(dims[:n_op]), size
            unbatch = tuple
        else:
            inner, inner_dims = self.batch
            folded, op_dims = [], []
            for i, (t, d) in enumerate(zip(tensors, dims)):
                d_in = inner_dims[i] if i < n_op else 0
                if d is None and d_in is None:
                    folded.append(t)
                    op_dims.append(None)
                    continue
                if d is None:
                    t = t.expand((size,) + tuple(t.shape))
                elif d_in is None:
                    t = t.unsqueeze(1).expand(
                        (size, inner) + tuple(t.shape[1:]))
                folded.append(t.reshape((size * inner,) + tuple(t.shape[2:])))
                op_dims.append(0 if i < n_op else None)
            op_dims, count = op_dims[:n_op], size * inner

            def unbatch(out):
                return tuple(o.reshape((size, inner) + tuple(o.shape[1:]))
                             for o in out)

        root = self if self.batch is None else self.base
        system = copy.copy(root)
        system.base = root
        system.batch = (count, tuple(op_dims))
        system.batch_ndim = 1
        x_star, theta, rhs = self.flat.trees(folded)
        system.flat = Flat(x_star, theta, rhs)
        system.operands = Flat(x_star, theta)
        return system, unbatch

    def _folded(self, tensors, dims, size: int):
        """A mesh-placed system (``batch_ndim=1``) over a ``vmap`` rule's
        batch of ``size``: ONE mesh-placed system whose instance axis holds
        each instance's ``size`` slices side by side (instance-major, so
        that every rank keeps its own instances): x* and the right-hand
        side fold.  A θ tensor shared by the batch stays as it is; any
        other keeps the batch as a new leading axis, unsplit, its own dims
        placed as before.  The residual of the folded system maps the
        original one over the slices, so that each solve of a ``vmap``
        level stays one registry solve, a ``vmap`` of a ``vmap`` folding
        again.  θ crosses as its tensors (one spec each)."""
        n_x, n_th = self.flat.counts[0], self.flat.counts[1]
        theta_trees = self.flat.trees(self.flat.tensors)[1]
        specs = _per_tensor_sharding(self.sharding,
                                     Flat(*theta_trees)).theta_specs
        th_dims = tuple(dims[n_x:n_x + n_th])
        th_specs = tuple(s if d is None else P(None, *s)
                         for s, d in zip(specs, th_dims))
        folded = list(tensors)
        for i, (t, d) in enumerate(zip(tensors, dims)):
            if n_x <= i < n_x + n_th:
                continue
            if d is None:
                t = t.expand((size,) + tuple(t.shape))
            folded[i] = t.movedim(0, 1).reshape(
                (t.shape[1] * size,) + tuple(t.shape[2:]))
        base, F = self.operands, self.F

        def F_folded(x, *theta):
            xs = tree_flatten(x)[0]
            n = xs[0].shape[0] // size

            def one(*a):
                x_i, theta_i = base.trees(list(a))
                return F(x_i, *theta_i)

            out = torch.func.vmap(
                one, in_dims=(1,) * len(xs) + th_dims, out_dims=1)(
                *[t.reshape((n, size) + tuple(t.shape[1:])) for t in xs],
                *theta)
            return tree_map(lambda o: o.reshape((n * size,) +
                                                tuple(o.shape[2:])), out)

        system = copy.copy(self)
        system.F = F_folded
        system.sharding = dataclasses.replace(self.sharding,
                                              theta_specs=th_specs)
        x_star, _, rhs = self.flat.trees(folded)
        theta = tuple(folded[n_x:n_x + n_th])
        system.flat = Flat(x_star, theta, rhs)
        system.operands = Flat(x_star, theta)

        def unbatch(out):
            return tuple(o.reshape((o.shape[0] // size, size) +
                                   tuple(o.shape[1:])).movedim(1, 0)
                         for o in out)

        return system, unbatch

    def apply(self, M, rhs, batch_ndim: int) -> tuple:
        """Solve with ``M``; the flat outputs: u's leaves, then the tensor
        fields of the ``SolveInfo`` when it was asked for."""
        out = _backward_apply(M, rhs, batch_ndim=batch_ndim,
                              return_info=self.return_info,
                              direction=self.direction, **self.kw)
        u, info = out if self.return_info else (out, None)
        flat = tree_flatten(u)[0]
        if info is not None:
            self.info_fields = [f for f, v in zip(info._fields, info)
                                if v is not None]
            flat += [getattr(info, f) for f in self.info_fields]
        return tuple(flat)

    def unpack(self, flat):
        """``(u, SolveInfo | None)`` from ``apply``'s flat outputs."""
        u = self.rhs_tree(flat)
        if not self.return_info:
            return u, None
        n = self.flat.counts[2]
        return u, ls.SolveInfo(**dict(zip(self.info_fields, flat[n:])))

    def rhs_tree(self, tensors):
        """A right-hand-side-shaped tree (u, a tangent) from its first
        tensors."""
        n = self.flat.counts[2]
        return tree_unflatten(list(tensors[:n]), self.flat.parts[2][1])

    def again(self, operands, rhs, transpose: bool):
        """``M⁻¹ rhs`` with this system's matrix at ``operands`` (x*'s and
        θ's tensors), in direction ``transpose``: the inner solve of a
        derivative, itself a ``_SystemSolve`` so that every order
        composes."""
        system = copy.copy(self)
        x_star, theta = self.operands.trees(operands)
        system.transpose, system.return_info = transpose, False
        if self.batch is not None:          # its instances' direction too
            system.base = copy.copy(self.base)
            system.base.transpose = transpose
        system.direction = "vjp" if transpose else "jvp"
        system.flat = Flat(x_star, theta, rhs)
        out = _SystemSolve.apply(system, *system.flat.tensors)
        return system.unpack(out)[0]

    def _of_operands(self, fn: Callable, tensors):
        """``fn(x*, θ, *rest)`` as a function of the floating-point tensors
        among ``tensors`` (x*'s and θ's, then any others): ``(that
        function, those tensors, their slots)``."""
        n = len(self.operands.tensors)
        slots = [i for i, t in enumerate(tensors) if _is_diff_leaf(t)]

        def of(*diff):
            full = list(tensors)
            for i, t in zip(slots, diff):
                full[i] = t
            return canonical(fn(*self.operands.trees(full[:n]), *full[n:]))

        return of, [tensors[i] for i in slots], slots

    def product_jvp(self, operands, u, dots):
        """``Ṁ u``: the tangent of ``M(x*, θ) u`` along ``dots`` (one
        ``torch.func.jvp``; a ``None`` tangent is zero)."""
        of, primals, slots = self._of_operands(
            lambda x, th: self.matrix(x, th).matvec(u), operands)
        return torch.func.jvp(of, tuple(primals),
                              _tangents(operands, dots, slots))[1]

    def product_vjp(self, operands, u, w) -> list:
        """``−∂⟨w, M(x*, θ) u⟩ / ∂(x*, θ)`` per operand tensor (one
        ``torch.func.vjp``; ``None`` for a tensor that is not
        floating-point)."""
        of, primals, slots = self._of_operands(
            lambda x, th: self.matrix(x, th).matvec(u), operands)
        _, vjp_fun = torch.func.vjp(of, *primals)
        grads = [None] * len(operands)
        for i, g in zip(slots, vjp_fun(canonical(w))):
            grads[i] = -g
        return grads

    def _polynomial(self, operands, rhs):
        """The fixed-budget polynomial ``P(M(x*, θ)) rhs`` of an
        approximate mode as a function of the floating-point tensors among
        ``operands`` and ``rhs``: ``(that function, those tensors, their
        slots)``."""
        kw = {k: self.kw[k] for k in ("ridge", "precond", "backward",
                                      "backward_iters", "tol")}
        return self._of_operands(
            lambda x, th, *r: ls.approx_inverse_apply(
                self.matrix(x, th), self.rhs_tree(r),
                batch_ndim=self.batch_ndim, **kw),
            list(operands) + list(rhs))

    def polynomial_jvp(self, operands, rhs, dots, rhs_dots):
        """The tangent of an approximate mode's polynomial, differentiated
        as it stands (as the JAX package differentiates its
        ``approx_inverse_apply``)."""
        of, primals, slots = self._polynomial(operands, rhs)
        return torch.func.jvp(of, tuple(primals), _tangents(
            list(operands) + list(rhs), list(dots) + list(rhs_dots),
            slots))[1]

    def polynomial_vjp(self, operands, rhs, w) -> list:
        """The cotangents of the polynomial's operand and right-hand-side
        tensors for ``w``, in reverse mode as it stands (``None`` for a
        tensor that is not floating-point)."""
        of, primals, slots = self._polynomial(operands, rhs)
        _, vjp_fun = torch.func.vjp(of, *primals)
        grads = [None] * (len(operands) + len(rhs))
        for i, g in zip(slots, vjp_fun(canonical(w))):
            grads[i] = g
        return grads


def _tangents(tensors, dots, slots) -> tuple:
    """The tangents of ``tensors[slots]``: ``dots``'s, zero for ``None``."""
    return tuple(torch.zeros_like(tensors[i]) if dots[i] is None else dots[i]
                 for i in slots)


def _primal(t):
    """``t`` without the forward-mode tangent of the level whose ``jvp``
    rule is running.  torch runs a Function's ``jvp`` rule with forward
    mode off, so the rule's work would silently carry no tangent of an
    OUTER ``torch.func.jvp`` (``jacfwd(jacfwd(f))``); with this level's
    tangent stripped, a rule may turn forward mode back on
    (``_forward_mode``) and its result carries the outer tangents."""
    return t if t is None else torch._unpack_dual(t, 0)[0]


@contextlib.contextmanager
def _forward_mode():
    """Forward-mode AD on inside a ``jvp`` rule (see ``_primal``)."""
    enabled = torch._C._is_fwd_grad_enabled()
    torch._C._set_fwd_grad_enabled(True)
    try:
        yield
    finally:
        torch._C._set_fwd_grad_enabled(enabled)


class _BatchedSystem(ops.LinearOperator):
    """A batch of implicit systems as one batch-aware operator
    (``batch_ndim=1``), for ``_SystemSolve``'s ``vmap`` rule.

    Each product is a ``torch.func.vmap`` of the per-instance one over the
    instances whose x* or θ carry the batch axis (``dims``).  When none
    does (a ``jacrev``: one operator, many right-hand sides) the one
    operator is shared: it is built once, materialized once and expanded
    as a view.  ``materialize`` / ``diagonal`` run with the instances
    outermost, the probing basis inside, so that batched data enters its
    products once and is never copied per basis vector.
    """

    def __init__(self, system: _System, args, dims, example):
        self.system, self.args, self.dims = system, args, dims
        self.shared = all(d is None for d in tree_leaves(dims))
        first = [tree_map(lambda t, d: t if d is None else t[0], a, ds)
                 for a, ds in zip(args, dims)]
        self.M0 = system.operator(*first)
        super().__init__(example, batch_ndim=1, symmetric=self.M0.symmetric,
                         positive_definite=self.M0.positive_definite)
        self.B = tree_leaves(example)[0].shape[0]

    def _each(self, fn, *batched):
        """``fn(M_i, *args_i)`` for every instance, stacked on axis 0."""
        if self.shared:
            return torch.func.vmap(lambda *a: fn(self.M0, *a))(*batched)
        op = self.system.operator
        return torch.func.vmap(
            lambda x, th, *a: fn(op(x, th), *a),
            in_dims=tuple(self.dims) + (0,) * len(batched))(*self.args,
                                                            *batched)

    def matvec(self, v):
        """Each instance's product with its slice of ``v``."""
        return self._each(lambda M, vi: M.matvec(vi), v)

    def rmatvec(self, v):
        """Each instance's adjoint product with its slice of ``v``."""
        return self._each(lambda M, vi: M.rmatvec(vi), v)

    def materialize(self) -> torch.Tensor:
        """``(B, d, d)``: instances outermost (see the class docstring)."""
        if self.shared:
            A = self.M0.materialize()
            return A.expand((self.B,) + tuple(A.shape))
        return self._each(lambda M: M.materialize())

    def diagonal(self):
        """Each instance's diagonal, stacked on axis 0."""
        if self.shared:
            return tree_map(lambda dg: dg.expand((self.B,) + tuple(dg.shape)),
                            self.M0.diagonal())
        return self._each(lambda M: M.diagonal())


_SHARDED_SECOND_ORDER = (
    "a derivative of a mesh-placed implicit solve (a second derivative "
    "through a sharded implicit_diff, root_vjp or root_jvp) takes plain "
    "tensors, every rank's global values: torch.func does not trace "
    "DTensors")


class _SystemSolve(torch.autograd.Function):
    """The solve of one ``_System`` as a Function, differentiable to any
    order with the semantics of ``lax.custom_linear_solve``.  For
    ``u = M⁻¹ r`` with ``M = M(x*, θ)`` (A or Aᵀ):

      * ``backward``, given ``ū``: ``w = M⁻ᵀ ū`` (the flipped direction),
        ``r̄ = w`` and ``(x̄*, θ̄) = −∂⟨w, M u⟩/∂(x*, θ)`` by one
        ``torch.func.vjp`` of the matvec;
      * ``jvp``: ``u̇ = M⁻¹(ṙ − Ṁ u)``, ``Ṁ u`` by one ``torch.func.jvp``.

    Each inner solve is a ``_SystemSolve`` again (``_System.again``), with
    the system's routing: the registry solver, or under an approximate
    ``backward`` the same polynomial.  A ``"direct"`` system (``_System``)
    is differentiated as its routine is in the JAX package: the rules
    above for ``lu`` and ``pallas_cg`` (whose JAX op solves the flipped
    system in its reverse rule too), the polynomial itself for the
    approximate modes, and no ``backward`` for the loops.  A mesh-placed
    system's rules take plain tensors: their products run on the global
    values (``_System.matrix``), their solves on the mesh.  The solve's
    iterations are never recorded — under ``torch.func.grad``, which keeps
    the backward's graph, they would hold every iteration's
    intermediates.  The ``vmap`` rule runs a whole batch of systems as ONE
    registry solve (``_BatchedSystem``, or a folded mesh-placed system)."""

    @staticmethod
    def forward(system, *tensors):
        x_star, theta, rhs = system.flat.trees(tensors)
        out = system.apply(system.operator(x_star, theta), rhs,
                           system.batch_ndim)
        # "jacobian_free" returns its right-hand side, which a Function
        # may not hand back as it came in
        return tuple(o.clone() if any(o is t for t in tensors) else o
                     for o in out)

    @staticmethod
    def setup_context(ctx, inputs, output):
        system = ctx.system = inputs[0]
        n_op, n_u = len(system.operands.tensors), system.flat.counts[2]
        ctx.mark_non_differentiable(*output[n_u:])
        operands, rhs = inputs[1:1 + n_op], inputs[1 + n_op:]
        ctx.save_for_backward(*operands, *rhs, *output[:n_u])
        ctx.save_for_forward(*operands, *rhs, *output[:n_u])

    @staticmethod
    def backward(ctx, *grads):
        system = ctx.system
        n_op, n_u = len(system.operands.tensors), system.flat.counts[2]
        saved = ctx.saved_tensors
        _check_plain(saved)
        operands, rhs = saved[:n_op], saved[n_op:n_op + n_u]
        u = system.rhs_tree(saved[n_op + n_u:])
        u_bar = system.rhs_tree(grads[:n_u])
        if system.derivative == "direct":
            routine = system.routine(operands, u_bar)
            if routine not in _REVERSIBLE:
                raise RuntimeError(
                    f"reverse mode through the linear solve of "
                    f"{system.source} is not available: its routine "
                    f"{routine!r} is a loop with no reverse derivative, as "
                    "in the JAX package (lu, pallas_cg and the approximate "
                    "backward modes have one); forward mode is, and a "
                    "mode='auto' wrapper serves both")
            if system.kw["backward"] != "exact":
                return (None, *system.polynomial_vjp(operands, rhs, u_bar))
        w = system.again(operands, u_bar, not system.transpose)
        return (None, *system.product_vjp(operands, u, w),
                *tree_flatten(w)[0])

    @staticmethod
    def jvp(ctx, _system_dot, *dots):
        system = ctx.system
        n_op, n_u = len(system.operands.tensors), system.flat.counts[2]
        _check_plain(ctx.saved_tensors)
        saved = [_primal(t) for t in ctx.saved_tensors]
        dots = [_primal(d) for d in dots]
        operands, rhs = saved[:n_op], saved[n_op:n_op + n_u]
        u = system.rhs_tree(saved[n_op + n_u:])
        with _forward_mode():
            if system.derivative == "direct" and \
                    system.kw["backward"] != "exact":
                du = system.polynomial_jvp(operands, rhs, dots[:n_op],
                                           dots[n_op:])
            else:
                r_dot = system.rhs_tree([
                    torch.zeros_like(r) if d is None else d
                    for r, d in zip(rhs, dots[n_op:])])
                if any(d is not None for d in dots[:n_op]):
                    r_dot = tree_map(torch.sub, r_dot, system.product_jvp(
                        operands, u, dots[:n_op]))
                du = system.again(operands, r_dot, system.transpose)
        n_info = len(system.info_fields) if system.return_info else 0
        return tuple(tree_flatten(du)[0]) + (None,) * n_info

    @staticmethod
    def vmap(info, in_dims, system, *tensors):
        if system.sharding is not None and system.batch_ndim != 1:
            # no instance axis to fold into: the sharded solvers batch
            # themselves, one solve where the operator is shared, one per
            # slice otherwise (``distributed.sharded_operators._SolveJob``)
            out = torch.func.vmap(
                lambda *ts: _SystemSolve.forward(system, *ts),
                in_dims=in_dims[1:], randomness=info.randomness)(*tensors)
            return out, (0,) * len(out)
        tensors, dims = batch_first(tensors, in_dims[1:])
        batch, unbatch = system.batched(tensors, dims, info.batch_size)
        # applied again, not solved here: a derivative level below this
        # vmap (jacfwd(jacfwd)) then differentiates it through the rules
        out = unbatch(_SystemSolve.apply(batch, *batch.flat.tensors))
        return out, (0,) * len(out)


def _solve_system(F, x_star, theta_args, rhs, **kw):
    """``(u, SolveInfo | None)`` of the implicit system (see ``_System``)."""
    system = _System(F, x_star, theta_args, rhs, **kw)
    return system.unpack(_SystemSolve.apply(system, *system.flat.tensors))


def _is_diff_leaf(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and \
        (leaf.is_floating_point() or leaf.is_complex())


def _of_diff_leaves(F: Callable, x_star, theta_args: tuple):
    """``F(x*, θ)`` as a function of θ's floating-point tensor leaves:
    ``(F_of, those leaves, their slots, θ's leaves, θ's tree spec)``."""
    leaves, spec = tree_flatten(tuple(theta_args))
    slots = [i for i, leaf in enumerate(leaves) if _is_diff_leaf(leaf)]

    def F_of(*diff):
        full = list(leaves)
        for i, t in zip(slots, diff):
            full[i] = t
        return canonical(F(x_star, *tree_unflatten(full, spec)))

    return F_of, [leaves[i] for i in slots], slots, leaves, spec


def _theta_vjp(F: Callable, x_star, theta_args: tuple, u,
               sharding=None, in_rule: bool = False) -> tuple:
    """``uᵀ ∂₂F`` per θ argument: one ``torch.func.vjp`` in θ's
    floating-point tensor leaves; any other leaf gets ``None``.  With
    ``sharding``, on the local shards (``SolveSharding.theta_vjp``),
    unless it is differentiated on plain tensors (``_placement``)."""
    sharding = _placement(sharding, (x_star, theta_args, u), in_rule)
    if sharding is not None:
        return tuple(sharding.theta_vjp(
            lambda x, th, v: _theta_vjp(F, x, th, v), x_star,
            tuple(theta_args), u))
    F_of, primals, slots, leaves, spec = _of_diff_leaves(F, x_star,
                                                         theta_args)
    _, vjp_fun = torch.func.vjp(F_of, *primals)
    grads = [None] * len(leaves)
    for i, g in zip(slots, vjp_fun(canonical(u))):
        grads[i] = g
    return tuple(tree_unflatten(grads, spec))


def _theta_jvp(F: Callable, x_star, theta_args: tuple, tangents: tuple,
               sharding=None):
    """``∂₂F θ̇``: one ``torch.func.jvp`` in θ; with ``sharding``, on the
    local shards (``SolveSharding.theta_jvp``), unless it is
    differentiated on plain tensors (``_placement``)."""
    sharding = _placement(sharding, (x_star, theta_args, tangents), False)
    if sharding is not None:
        return sharding.theta_jvp(
            lambda x, th, t: _theta_jvp(F, x, th, t), x_star,
            tuple(theta_args), tuple(tangents))
    return torch.func.jvp(lambda *targs: canonical(F(x_star, *targs)),
                          tuple(theta_args), tuple(tangents))[1]


def root_vjp(F: Callable, x_star, theta_args: tuple, cotangent,
             solve="normal_cg", tol: float = 1e-6, maxiter: int = 1000,
             ridge: float = 0.0, precond=None, sharding=None,
             backward: str = "exact", backward_iters: int = 8,
             error_estimate: bool = False, return_info: bool = False,
             system_operator=None):
    """VJP through the implicitly-defined root: returns vᵀ ∂x*(θ) per θ arg.

    Solve Aᵀ u = v  (A = -∂₁F),  then  vᵀJ = uᵀB  (B = ∂₂F): one linear
    solve serves all theta arguments.  ``backward`` swaps the converged
    solve for a fixed-budget approximation (see ``approx_inverse_apply``).
    ``return_info=True`` returns ``(grads, SolveInfo)``; with
    ``error_estimate=True`` it carries ``hypergrad_error_estimate =
    ‖v − Aᵀu‖/‖v‖``.  Under ``torch.func.vmap`` the batch is ONE solve.
    ``sharding`` places the system on a mesh (the ``sharded_*`` solvers).
    """
    if backward != "exact":
        _check_approx_routing(precond, sharding)
    x_star = canonical(x_star)
    u, info = _solve_system(
        F, x_star, theta_args, canonical(cotangent), transpose=True,
        solve=solve, tol=tol, maxiter=maxiter, ridge=ridge, precond=precond,
        backward=backward, backward_iters=backward_iters,
        error_estimate=error_estimate, return_info=return_info,
        system_operator=system_operator, direction="vjp", sharding=sharding,
        source="root_vjp")
    return ls._maybe_info(_theta_vjp(F, x_star, theta_args, u, sharding),
                          info, return_info)


def root_jvp(F: Callable, x_star, theta_args: tuple, tangents: tuple,
             solve="normal_cg", tol: float = 1e-6, maxiter: int = 1000,
             ridge: float = 0.0, precond=None, sharding=None,
             backward: str = "exact", backward_iters: int = 8,
             error_estimate: bool = False, return_info: bool = False,
             system_operator=None):
    """JVP through the implicitly-defined root: J · v.

    Solve A (Jv) = B v  with  Bv = ∂₂F · v  computed by one JVP of F in θ.
    ``backward`` / ``backward_iters`` / ``error_estimate`` /
    ``return_info`` / ``sharding`` mirror ``root_vjp`` on the tangent
    system.
    """
    if backward != "exact":
        _check_approx_routing(precond, sharding)
    x_star = canonical(x_star)
    Bv = _theta_jvp(F, x_star, theta_args, tangents, sharding)
    u, info = _solve_system(
        F, x_star, theta_args, Bv, transpose=False, solve=solve, tol=tol,
        maxiter=maxiter, ridge=ridge, precond=precond, backward=backward,
        backward_iters=backward_iters, error_estimate=error_estimate,
        return_info=return_info, system_operator=system_operator,
        direction="jvp", sharding=sharding, source="root_jvp")
    return ls._maybe_info(u, info, return_info)


# ---------------------------------------------------------------------------
# the wrapper: one autograd.Function for both modes
# ---------------------------------------------------------------------------

def _check_solver_arity(spec: ImplicitDiffSpec, n_theta: int):
    if spec.nondiff_argnums and spec.nondiff_argnums[-1] >= n_theta:
        raise ValueError(
            f"nondiff_argnums {spec.nondiff_argnums} out of range for a "
            f"solver called with {n_theta} theta argument(s)")


def _diff_levels(tensors) -> set:
    """The ``torch.func`` differentiation levels (``grad`` / ``vjp`` /
    ``jvp``; not ``vmap``) at which any of ``tensors`` is wrapped."""
    from torch._C import _functorch
    from torch._functorch import pyfunctorch
    kinds = {i.level(): i.key().name
             for i in pyfunctorch.retrieve_all_functorch_interpreters()}
    levels = set()
    for t in tensors:
        while isinstance(t, torch.Tensor) and \
                _functorch.is_functorch_wrapped_tensor(t):
            level = _functorch.maybe_get_level(t)
            if kinds.get(level) in ("Grad", "Jvp"):
                levels.add(level)
            t = _functorch.get_unwrapped(t)
    return levels


class _Call:
    """One call of a wrapped solver.  Its tensors — ``init``'s, then those
    of the θ arguments outside ``nondiff_argnums`` — are the Function's
    inputs, so that a ``vmap`` rule sees every batch axis; the
    floating-point ones among θ's are what the derivatives flow to.
    Everything else (nondiff arguments, non-tensor leaves) and what the
    forward produced (x*'s and aux's structure and static leaves) stays
    here."""

    def __init__(self, spec: ImplicitDiffSpec, solver: Callable, mode: str,
                 init, theta: tuple):
        self.spec, self.solver, self.mode, self.theta = \
            spec, solver, mode, theta
        self.init = Flat(init)
        self.args = Flat(*(arg for i, arg in enumerate(theta)
                           if i not in spec.nondiff_argnums))
        self.n_init = len(self.init.tensors)
        self.tensors = self.init.tensors + self.args.tensors
        self.x = self.aux = None
        # the placement of the system on θ's tensors, the residual's
        # arguments (``residual()``): one spec per tensor
        self.sharding = None if spec.sharding is None else \
            _per_tensor_sharding(spec.sharding, self.args)
        # the innermost torch.func differentiation level θ is tracked at
        # (None outside torch.func), and whether a plain-autograd backward
        # has already built a graph (``create_graph=True``): see ``outer``
        levels = _diff_levels(self.args.tensors)
        self.innermost = max(levels) if levels else None
        self.graph_built = False
        # the solver runtime's loops (``IterativeSolver.run``): a
        # stochastic solver's iterate is no root of F, so its outer
        # derivative is the loop's own (``unrolled``); any other loop, like
        # the JAX package's while_loop, has no reverse derivative of its
        # own (``loop``; see ``outer``)
        owner = getattr(solver, "__self__", None)
        self.unrolled = bool(getattr(owner, "is_stochastic", False))
        self.loop = type(owner).__name__ if hasattr(owner, "_masked_loop") \
            and not self.unrolled else None
        # a batch of calls (``batched``): per enclosing vmap level,
        # outermost first, the in_dims of ``tensors`` and the randomness
        self.levels = ()

    def batched(self, dims, randomness) -> "_Call":
        """This call over one more ``vmap`` level (its ``vmap`` rule):
        ``dims`` (0 or None) say which tensors carry the new leading
        axis."""
        call = copy.copy(self)
        call.levels = ((tuple(dims), randomness),) + self.levels
        return call

    def run_solver(self, tensors) -> tuple:
        """The wrapped solver on the call's tensors, under a
        ``torch.func.vmap`` per level of a batch: x*'s tensors, then
        aux's."""
        def one(*ts):
            init, theta = self.rebuild(ts)
            out = self.solver(init, *theta)
            self.x = Flat(out[0] if self.spec.has_aux else out)
            self.aux = Flat(out[1] if self.spec.has_aux else None)
            return tuple(self.x.tensors + self.aux.tensors)

        for dims, randomness in reversed(self.levels):
            one = torch.func.vmap(one, in_dims=dims, randomness=randomness)
        return one(*tensors)

    def per_instance(self, fn, theta, x, extra, *, extra_like_theta: bool,
                     sum_shared: bool) -> tuple:
        """``fn(θ's tensors, x*'s, extra)`` of one instance, mapped over
        a batch's levels: ``extra`` carries the batch axes of θ (tangents)
        or of x* (cotangents); with ``sum_shared`` an output (a θ
        cotangent) is summed over each level at which its θ tensor is
        shared."""
        if not self.levels:
            return fn(theta, x, extra)
        n_th, n_x = len(theta), len(x)

        def one(*a):
            return fn(a[:n_th], a[n_th:n_th + n_x], a[n_th + n_x:])

        for dims, randomness in reversed(self.levels):
            th_dims = dims[self.n_init:]
            one = torch.func.vmap(
                one, in_dims=th_dims + (0,) * n_x + (
                    th_dims if extra_like_theta else (0,) * len(extra)),
                randomness=randomness)
        out = one(*theta, *x, *extra)
        if not sum_shared:
            return out
        slots = [i for i, t in enumerate(theta) if _is_diff_leaf(t)]
        summed = []
        for i, g in zip(slots, out):
            for k in reversed(range(len(self.levels))):
                if self.levels[k][0][self.n_init + i] is None:
                    g = g.sum(k)
            summed.append(g)
        return tuple(summed)

    def outer(self) -> bool:
        """Whether the running derivative rule is an outer one: x*(θ)'s
        derivative taken to differentiate a derivative of it (the outer
        ``torch.func`` level of ``hessian``, or the second
        ``torch.autograd.grad`` after one with ``create_graph=True``).
        The JAX package's custom rule serves only the innermost level; at
        the outer ones JAX differentiates the wrapped solver itself.  The
        port gives x*'s exact derivative there: implicitly (the spec's
        routed solver, whatever the approximate ``backward`` or ``ridge``),
        equal to the solver's own to the tolerances, or for a stochastic
        solver by differentiating its loop (``unrolled_jvp`` /
        ``unrolled_vjp``).  Such a rule is open to every mode, in reverse
        mode through no loop of the solver runtime (``loop``); whether the
        cell has a value is then up to the inner level's solve, whose
        routine a single-mode wrapper differentiates as it stands
        (``_SystemSolve``)."""
        level = torch._C._functorch.maybe_current_level()
        if level is not None and self.innermost is not None:
            return level < self.innermost
        return self.graph_built

    def _x_of(self, init_tensors, theta_tensors):
        """x*'s tensors as a function of θ's floating-point ones, by
        running the wrapped solver again: ``(that function, those
        tensors, their slots)``."""
        slots = [i for i, t in enumerate(theta_tensors) if _is_diff_leaf(t)]

        def x_of(*diff):
            full = list(theta_tensors)
            for i, t in zip(slots, diff):
                full[i] = t
            out = self.run_solver(list(init_tensors) + full)
            return out[:len(self.x.tensors)]

        return x_of, [theta_tensors[i] for i in slots], slots

    def unrolled_jvp(self, init_tensors, theta_tensors, theta_dot):
        """x*'s tangent as the wrapped solver's own (see ``outer``)."""
        x_of, primals, slots = self._x_of(init_tensors, theta_tensors)
        return torch.func.jvp(x_of, tuple(primals),
                              _tangents(theta_tensors, theta_dot, slots))[1]

    def unrolled_vjp(self, init_tensors, theta_tensors, ct) -> tuple:
        """θ's cotangents through the wrapped solver's own computation
        (see ``outer``); ``None`` for a tensor that is not
        floating-point."""
        x_of, primals, slots = self._x_of(init_tensors, theta_tensors)
        _, vjp_fun = torch.func.vjp(x_of, *primals)
        grads = [None] * len(theta_tensors)
        for i, g in zip(slots, vjp_fun(tuple(ct))):
            grads[i] = g
        return tuple(grads)

    def rebuild(self, tensors):
        """``(init, theta)`` with the Function's inputs put back."""
        return (self.init.trees(tensors[:self.n_init])[0],
                self.theta_with(tensors[self.n_init:]))

    def theta_with(self, theta_tensors) -> tuple:
        """The θ arguments with their tensor leaves replaced."""
        args = iter(self.args.trees(theta_tensors))
        return tuple(arg if i in self.spec.nondiff_argnums else next(args)
                     for i, arg in enumerate(self.theta))

    def residual(self) -> Callable:
        """F(x, *theta_tensors): the residual with θ rebuilt from tensors."""
        residual = self.spec.residual_fun
        return lambda x, *tensors: residual(x, *self.theta_with(tensors))


def _per_tensor_sharding(sharding, args: Flat):
    """``sharding`` with ``theta_specs`` laid out per tensor of ``args``
    (the differentiable θ arguments, flattened as ``Flat`` does)."""
    specs = []
    for i, (leaves, tree_spec) in enumerate(args.parts):
        arg = tree_unflatten(leaves, tree_spec)
        spec_leaves = tree_leaves(sharding.theta_spec(i, arg))
        specs += [s for leaf, s in zip(leaves, spec_leaves)
                  if isinstance(leaf, torch.Tensor)]
    return dataclasses.replace(sharding, theta_specs=tuple(specs))


def _leaves_jvp(F: Callable, x_star, leaves: tuple, dots: tuple):
    """``∂₂F θ̇`` in θ's floating-point tensor leaves (a ``None`` tangent
    is zero)."""
    F_of, primals, slots, _, _ = _of_diff_leaves(F, x_star, leaves)
    return torch.func.jvp(F_of, tuple(primals), tuple(
        torch.zeros_like(leaves[i]) if dots[i] is None else dots[i]
        for i in slots))[1]


class _ImplicitFunction(torch.autograd.Function):
    """x*(θ) with the implicit-function-theorem derivative in both modes;
    the outputs are x*'s leaves, then aux's tensor leaves."""

    @staticmethod
    def forward(call: _Call, *tensors):
        return tuple(t.detach() for t in call.run_solver(tensors))

    @staticmethod
    def setup_context(ctx, inputs, output):
        call = inputs[0]
        ctx.call = call
        ctx.n_x = len(call.x.tensors)
        theta_tensors = inputs[1 + call.n_init:]
        ctx.n_theta = len(theta_tensors)
        ctx.mark_non_differentiable(*output[ctx.n_x:])
        saved = (*theta_tensors, *output[:ctx.n_x],
                 *inputs[1:1 + call.n_init])
        ctx.save_for_backward(*saved)
        ctx.save_for_forward(*saved)

    @staticmethod
    def vmap(info, in_dims, call, *tensors):
        # the batch as one call (the solver under torch.func.vmap; run()'s
        # loop takes it through its own vmap rule), applied again so that
        # a derivative level below this vmap reaches the rules
        tensors, dims = batch_first(tensors, in_dims[1:])
        batch = call.batched(dims, info.randomness)
        out = _ImplicitFunction.apply(batch, *tensors)
        call.x, call.aux = batch.x, batch.aux
        return out, (0,) * len(out)

    @staticmethod
    def _split(ctx, strip: bool = False):
        """θ's tensors, x*, and init's tensors, as saved; ``strip`` drops
        the running ``jvp`` rule's own tangents (``_primal``)."""
        saved = [_primal(t) if strip else t for t in ctx.saved_tensors]
        n = ctx.n_theta + ctx.n_x
        return tuple(saved[:ctx.n_theta]), saved[ctx.n_theta:n], saved[n:]

    @staticmethod
    def _system_kw(call: _Call, outer: bool) -> dict:
        """``_solve_system``'s routing for a rule of ``call``: the spec's;
        at an outer level (``_Call.outer``) x*'s exact derivative, so no
        approximate ``backward`` and no ``ridge`` (the JAX package
        differentiates the wrapped solver there).  The solve is
        differentiated in turn as ``custom_linear_solve`` under
        ``mode="auto"``, as the JAX package's solve routine otherwise."""
        spec = call.spec
        return dict(solve=spec.solve,
                    backward="exact" if outer else spec.backward,
                    backward_iters=spec.backward_iters, error_estimate=False,
                    return_info=False, system_operator=spec.system_operator,
                    sharding=call.sharding,
                    derivative=("linear_solve" if call.mode == "auto"
                                else "direct"),
                    source=f"a solver wrapped with mode={call.mode!r}",
                    **dict(spec.routing_kwargs(),
                           ridge=0.0 if outer else spec.ridge))

    @staticmethod
    def _check_transposable(call: _Call, F, x_star, theta, ct):
        """A ``mode="jvp"`` wrapper's reverse mode transposes its tangent
        solve, as the JAX package does where the routine allows it
        (``_TRANSPOSABLE``)."""
        spec = call.spec
        routine = _routine(spec.solve, spec.backward,
                           lambda: _implicit_system_operator(
                               F, x_star, theta, spec.solve, call.sharding,
                               spec.system_operator), ct, spec.precond)
        if routine not in _TRANSPOSABLE:
            raise RuntimeError(
                "this solver was wrapped with mode='jvp' (forward mode "
                f"only); reverse mode is not available with its routine "
                f"{routine!r}, whose tangent solve the JAX package cannot "
                "transpose either (lu, one_step and jacobian_free it can) "
                "— wrap with mode='auto' or 'vjp'")

    @staticmethod
    def _check_outer_reverse(call: _Call):
        if call.loop is not None:
            raise RuntimeError(
                f"reverse mode through a derivative of {call.loop}.run() "
                "differentiates its loop, which has no reverse derivative "
                "(nor has the JAX package's while_loop); forward mode over "
                "reverse (torch.func.hessian, jacfwd(grad)) is available")

    @staticmethod
    def backward(ctx, *grads):
        call = ctx.call
        outer = call.outer()
        leaves, x_star, init = _ImplicitFunction._split(ctx)
        if outer:
            _check_plain(ctx.saved_tensors)
            _ImplicitFunction._check_outer_reverse(call)
            if call.unrolled:
                return (None,) * (1 + call.n_init) + call.unrolled_vjp(
                    init, leaves, grads[:ctx.n_x])
        elif torch._C._functorch.maybe_current_level() is None and \
                torch.is_grad_enabled():
            call.graph_built = True

        kw = _ImplicitFunction._system_kw(call, outer)

        def one(theta, xs, ct):
            x_star, F = call.x.trees(xs)[0], call.residual()
            ct = call.x.trees(ct)[0]
            if call.mode == "jvp" and not outer:
                _ImplicitFunction._check_transposable(call, F, x_star, theta,
                                                      ct)
            u, _ = _solve_system(F, x_star, theta, ct, transpose=True,
                                 direction="vjp", **kw)
            return tuple(g for g in _theta_vjp(F, x_star, theta, u,
                                               call.sharding, in_rule=True)
                         if g is not None)

        # integer θ tensors get None, as _theta_vjp gives any such leaf
        diff = iter(call.per_instance(one, leaves, x_star, grads[:ctx.n_x],
                                      extra_like_theta=False,
                                      sum_shared=True))
        return (None,) * (1 + call.n_init) + tuple(
            next(diff) if _is_diff_leaf(t) else None for t in leaves)

    @staticmethod
    def jvp(ctx, _call_dot, *dots):
        call = ctx.call
        outer = call.outer()
        if call.mode == "vjp" and not outer:
            raise RuntimeError("this solver was wrapped with mode='vjp' "
                               "(reverse mode only); forward mode is not "
                               "available — wrap with mode='auto' or 'jvp'")
        leaves, x_star, init = _ImplicitFunction._split(ctx, strip=True)
        theta_dot = tuple(_primal(d) for d in dots[call.n_init:])
        F = call.residual()
        kw = _ImplicitFunction._system_kw(call, outer)
        with _forward_mode():
            if outer:
                _check_plain(ctx.saved_tensors)
            if outer and call.unrolled:
                return tuple(call.unrolled_jvp(init, leaves, theta_dot)) + \
                    (None,) * len(call.aux.tensors)

            def one(theta, xs, theta_dot):
                x_star = call.x.trees(xs)[0]
                sharding = _placement(call.sharding, (x_star, theta),
                                      in_rule=True)
                if sharding is None:
                    Bv = _leaves_jvp(F, x_star, theta, theta_dot)
                else:
                    Bv = sharding.theta_jvp(
                        lambda x, th, t: _leaves_jvp(F, x, th, t), x_star,
                        theta, theta_dot)
                dx, _ = _solve_system(F, x_star, theta, Bv, transpose=False,
                                      direction="jvp", **kw)
                return tuple(tree_flatten(dx)[0])

            dx = call.per_instance(one, leaves, x_star, tuple(
                torch.zeros_like(t) if d is None else d
                for t, d in zip(leaves, theta_dot)), extra_like_theta=True,
                sum_shared=False)
        return tuple(dx) + (None,) * len(call.aux.tensors)


MODES = ("auto", "vjp", "jvp")


def implicit_diff(spec: Union[ImplicitDiffSpec, Callable, None] = None, *,
                  mode: str = "auto", **spec_kwargs) -> Callable:
    """Attach implicit differentiation to a solver, per an ``ImplicitDiffSpec``.

    ``implicit_diff(spec)(solver)`` returns a function with the solver's
    signature ``(init, *theta)`` whose derivatives in the differentiable
    ``theta`` arguments come from the implicit function theorem on the
    spec's optimality mapping — never from differentiating through the
    solver's iterations.  ``torch.func.vmap`` of the function, of its
    gradient or of its JVP runs the linear solve of the whole batch as one
    registry solve.

    ``spec`` may be an ``ImplicitDiffSpec``, a bare callable (treated as
    ``optimality_fun``), or ``None`` with the spec's fields given as
    keyword arguments; keyword arguments on top of a spec/callable are
    per-call overrides::

        spec = ImplicitDiffSpec(optimality_fun=F, solve="cg")
        solver = implicit_diff(spec)(my_solver)     # grad and jvp
    """
    if isinstance(spec, ImplicitDiffSpec):
        spec = spec.replace(**spec_kwargs) if spec_kwargs else spec
    elif callable(spec):
        spec = ImplicitDiffSpec(optimality_fun=spec, **spec_kwargs)
    elif spec is None:
        spec = ImplicitDiffSpec(**spec_kwargs)
    else:
        raise TypeError("spec must be an ImplicitDiffSpec, a callable "
                        f"optimality_fun, or None; got {type(spec)!r}")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if spec.is_routing_only:
        raise ValueError("routing-only ImplicitDiffSpec: set optimality_fun "
                         "or fixed_point_fun to wrap a solver")
    if spec.backward != "exact":
        _check_approx_routing(spec.precond, spec.sharding)

    def wrapper(solver: Callable) -> Callable:
        @functools.wraps(solver)
        def fun(init, *theta):
            _check_solver_arity(spec, len(theta))
            call = _Call(spec, solver, mode, init, theta)
            out = _ImplicitFunction.apply(call, *call.tensors)
            n_x = len(call.x.tensors)
            x_star = call.x.trees(out[:n_x])[0]
            if spec.has_aux:
                return x_star, call.aux.trees(out[n_x:])[0]
            return x_star

        fun.spec = spec
        fun.mode = mode
        return fun

    return wrapper
