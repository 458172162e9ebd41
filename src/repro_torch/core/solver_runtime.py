"""Unified state-based solver runtime with automatic implicit differentiation.

Counterpart of ``repro.core.solver_runtime`` (PyTorch): *any* solver plus
*any* optimality mapping F yields implicit derivatives.

  * ``IterativeSolver`` protocol — ``init_state(params, *theta) -> state``,
    ``update(params, state, *theta) -> (params, state)``, plus a declared
    optimality mapping (``optimality_fun`` for root form,
    ``fixed_point_fun`` for fixed-point form, both drawn from
    ``repro_torch.core.optimality``).
  * a shared ``run()`` driver.  The JAX package's ``lax.while_loop`` is a
    Python loop: it stops when ``iter_num ≥ maxiter`` or when
    ``error > tol`` is no longer True — a NaN error stops it and is
    reported unconverged, as in the reference.  Reading ``error`` costs one
    host synchronisation per iteration.  Under ``torch.func.vmap`` the
    batch runs as ONE masked loop (``_RunLoop``'s ``vmap`` rule): each
    step is a ``torch.func.vmap`` of ``update``, each instance freezes at
    its own convergence, and the loop reads "any instance still running"
    once per iteration; ``OptInfo`` is then per instance.
  * ``OptInfo`` diagnostics mirroring ``SolveInfo``: iteration count, final
    error, and the NaN-aware ``converged = error <= tol``.
  * automatic implicit differentiation: ``run()`` self-wraps with the
    port's ``diff_api.implicit_diff`` on the solver's optimality mapping
    (``has_aux=True``: ``OptInfo`` gets no derivative), so
    ``torch.autograd.grad`` / ``torch.func.grad`` / ``jacrev`` and
    ``torch.func.jvp`` / ``jacfwd`` work through ``run()``, and under
    ``torch.func.vmap`` the backward solve of the batch is one solve.  The forward loop runs under ``no_grad`` inside
    that wrapper; the ``torch.func.grad`` calls in ``update`` ignore an
    outer ``no_grad``, as wanted.  The backward/tangent solve goes through
    the linear-solve registry (``solve``, ``precond``, ``ridge``,
    ``linsolve_tol``, ``linsolve_maxiter``), and ``backward`` /
    ``backward_iters`` select the approximate backward modes.

Solvers: ``GradientDescent``, ``ProximalGradient`` (FISTA momentum on by
default), ``ProjectedGradient``, ``MirrorDescent``,
``BlockCoordinateDescent``, ``Newton``, ``LBFGS``, ``FixedPointIteration``,
``AndersonAcceleration``.  Gradients inside ``update`` are
``torch.func.grad``, so objectives return scalar tensors.  The deprecated
functional factories live in ``repro_torch.core.solvers``.

Mesh placement (``sharding=``, a ``SolveSharding``): the implicit
backward/tangent solve runs sharded (the ``JacobianOperator`` inherits the
placement; classic solver names upgrade to their sharded variants).  When
θ arrives as DTensors, the iterate is pinned to the solution's specs
before the loop, which then runs on DTensors; with plain tensors (global
values) the forward loop runs on them as given.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Union

import torch
import torch.func

from repro_torch.core import diff_api, optimality
from repro_torch.core import linear_solve as ls
from repro_torch.core._tree import (Flat, _has_dtensor, batch_first,
                                    is_batched, ravel_pytree, tree_flatten,
                                    tree_leaves, tree_map)
# tree math shared with the linear-solve engine
from repro_torch.core.linear_solve import _tree_l2, _tree_sub
from repro_torch.core.operators import _ravel1
from repro_torch.core.optimality import _grad
from repro_torch.observability import events as obs_events


# ---------------------------------------------------------------------------
# pytree helpers
# ---------------------------------------------------------------------------

def _tree_axpy(x, g, alpha):
    """x + alpha * g, leaf-wise."""
    return tree_map(lambda xi, gi: xi + alpha * gi, x, g)


def _inf_like(params) -> torch.Tensor:
    """An +inf error scalar with the dtype ``_tree_l2(params)`` will have."""
    l2 = _tree_l2(params)
    return torch.full((), math.inf, dtype=l2.dtype, device=l2.device)


def _where0(cond, old, new):
    """Per-instance ``where(cond, new, old)`` over trees batched on axis 0."""
    return tree_map(lambda o, n: torch.where(
        cond.reshape(cond.shape + (1,) * (n.ndim - 1)), n, o), old, new)


# ---------------------------------------------------------------------------
# raveled-iterate cache (LBFGS / Anderson)
#
# The iterate is raveled ONCE in init_state; update() carries the flat
# vector in the state and only needs the unravel closure, cached on the
# solver instance keyed by tree structure + leaf shapes and dtypes, so one
# instance reused across problems of different structures rebuilds it.
# ---------------------------------------------------------------------------

def _structure_key(params):
    leaves, spec = tree_flatten(params)
    return (str(spec), tuple((tuple(leaf.shape), leaf.dtype)
                             for leaf in leaves))


def _ravel_iterate(solver, params) -> torch.Tensor:
    """Ravel the iterate (init_state only) and cache the unravel closure."""
    x0, unravel = ravel_pytree(params)
    solver._unravel_key = _structure_key(params)
    solver._unravel = unravel
    return x0


def _unravel_for(solver, params) -> Callable:
    """The cached unravel closure for ``params``'s structure."""
    if getattr(solver, "_unravel_key", None) != _structure_key(params):
        _, unravel = ravel_pytree(params)
        solver._unravel_key = _structure_key(params)
        solver._unravel = unravel
    return solver._unravel


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------

class OptInfo(NamedTuple):
    """Solve diagnostics, mirroring ``linear_solve.SolveInfo``.

    ``converged`` is ``error <= tol``, which is False for a NaN error — a
    diverged run is never reported as converged.
    """
    iterations: torch.Tensor   # update() steps spent
    error: torch.Tensor        # solver-specific final error
    converged: torch.Tensor    # error <= tol (NaN-aware False)
    # relative residual of the implicit backward system at the returned
    # cotangent — filled by drivers that ask for it (solve_bilevel with an
    # approximate backward mode); None otherwise
    hypergrad_error_estimate: Any = None


# ---------------------------------------------------------------------------
# the protocol + shared run() driver
# ---------------------------------------------------------------------------

def _kw(default):
    return dataclasses.field(default=default, kw_only=True)


@dataclasses.dataclass(eq=False)
class IterativeSolver:
    """State-based iterative solver protocol with a shared driver.

    Subclasses implement
      * ``init_state(params, *theta) -> state`` — a NamedTuple whose first
        two fields are ``iter_num`` (a Python int) and ``error`` (a scalar
        tensor, ``inf`` initially);
      * ``update(params, state, *theta) -> (params, state)`` — one step;
      * the optimality mapping: either override ``optimality_fun`` (root
        form, eq. 4/6) or provide ``fixed_point_fun`` (eq. 3: the residual
        ``T(x) - x`` is derived automatically) — as a method or, for
        wrapper solvers, a dataclass field holding the user's ``T``.

    ``run(init_params, *theta) -> (params, OptInfo)`` drives the solve and,
    when ``implicit_diff=True`` (default), attaches implicit derivatives
    by self-wrapping with ``diff_api.implicit_diff`` on the declared
    optimality mapping (see ``diff_spec()``).  The backward/tangent linear
    solve goes through the registry: ``solve`` names the registry solver
    (``"auto"`` dispatches on the implicit system's structure, or pass a
    callable) and ``precond`` / ``ridge`` / ``linsolve_tol`` /
    ``linsolve_maxiter`` are forwarded.  ``backward`` (``"exact"`` |
    ``"one_step"`` | ``"neumann_k"`` | ``"jacobian_free"``) treats the
    implicit system in both directions, ``backward_iters`` is the
    ``neumann_k`` depth and ``error_estimate`` opts info-returning entry
    points into the one-extra-matvec relative residual.

    ``mode`` selects the differentiation wrapping (overridable per call via
    ``run(..., mode=...)``): ``"auto"`` (reverse and forward mode on the
    same ``run()``), ``"jvp"`` (forward only), ``"vjp"`` (reverse only).

    ``sharding`` (a ``distributed.sharded_operators.SolveSharding``)
    places the implicit backward/tangent solve on a mesh, and pins a
    DTensor run's iterate to the solution's specs.
    """
    maxiter: int = _kw(1000)
    tol: float = _kw(1e-8)
    implicit_diff: bool = _kw(True)
    mode: str = _kw("auto")
    solve: Union[str, Callable] = _kw("normal_cg")
    linsolve_tol: float = _kw(1e-6)
    linsolve_maxiter: int = _kw(1000)
    ridge: float = _kw(0.0)
    precond: Any = _kw(None)
    backward: str = _kw("exact")
    backward_iters: int = _kw(8)
    error_estimate: bool = _kw(True)
    sharding: Any = _kw(None)

    def __post_init__(self):
        ls.check_backward(self.backward, self.backward_iters)

    # -- protocol ----------------------------------------------------------
    def init_state(self, params, *theta):
        """Build the initial iteration state for ``params`` and θ."""
        raise NotImplementedError

    def update(self, params, state, *theta):
        """One iteration: ``(params, state) → (params, state)``."""
        raise NotImplementedError

    def optimality_fun(self, params, *theta):
        """Root residual F(x, θ); default derives it from the fixed point."""
        T = self.fixed_point_fun   # property/method, or a field holding T
        return _tree_sub(T(params, *theta), params)

    def fixed_point_fun(self, params, *theta):
        # plain method (not a property) so wrapper solvers may shadow it
        # with a dataclass field holding the user's T
        """The solver's fixed-point mapping ``T(x, θ)``, when it declares one."""
        raise NotImplementedError(
            f"{type(self).__name__} declares neither optimality_fun nor "
            "fixed_point_fun")

    # -- shared driver -----------------------------------------------------
    def _continuing(self, state) -> bool:
        """'Still iterating': one host read of ``error``.  A NaN error
        compares False against tol, so a NaN run stops immediately and is
        reported unconverged."""
        return state.iter_num < self.maxiter and bool(state.error > self.tol)

    def _iterate(self, init_params, *theta):
        """The raw loop: no implicit diff attached.  A batch axis
        (``torch.func.vmap``) runs through ``_RunLoop``'s masked loop."""
        if is_batched(init_params, theta):
            flat = Flat(init_params, theta)
            out = _RunLoop.apply((self, flat), *flat.tensors)
            params = Flat(init_params).trees(out[:-3])[0]
            return params, OptInfo(*out[-3:])
        params = init_params
        if self.sharding is not None and _has_dtensor(params, theta):
            # pin the iterate to its placement before the loop (the loop
            # body keeps it)
            params = self.sharding.constrain(params)
        state = self.init_state(params, *theta)
        while self._continuing(state):
            params, state = self.update(params, state, *theta)
        error = state.error
        info = OptInfo(iterations=torch.tensor(state.iter_num,
                                               device=error.device),
                       error=error, converged=error <= self.tol)
        obs_events.emit("converged", {"solver": type(self).__name__},
                        iterations=info.iterations, error=info.error,
                        converged=info.converged)
        return params, info

    def _masked_loop(self, params, theta, theta_dims, B: int):
        """ONE loop for a batch of instances (``_RunLoop``'s vmap rule).

        ``params``' leaves carry the batch on axis 0; ``theta``'s tensor
        leaves on axis 0 or not at all (``theta_dims``).  Each step is a
        ``torch.func.vmap`` of ``update``; instances that were done at
        the step's entry keep their params and state, so each ends where
        its solo run ends.  The state's non-tensor fields (``iter_num``,
        FISTA's ``t``) are the same for every instance still running.
        """
        last = {}       # the last state's Flat: its non-tensor fields

        def tensors_of(state):
            last["flat"] = Flat(state)
            return last["flat"].tensors

        def state_of(tensors):
            return last["flat"].trees(tensors)[0]

        def step(p, st, th):
            new_p, new_state = self.update(p, state_of(st), *th)
            return new_p, tensors_of(new_state)

        st = torch.func.vmap(
            lambda p, th: tensors_of(self.init_state(p, *th)),
            in_dims=(0, theta_dims))(params, theta)
        iters = torch.zeros(B, dtype=torch.int64,
                            device=tree_leaves(params)[0].device)

        def continuing():
            return (iters < self.maxiter) & (state_of(st).error > self.tol)

        running = continuing()
        while bool(running.any()):
            new_p, new_st = torch.func.vmap(
                step, in_dims=(0, 0, theta_dims))(params, st, theta)
            params = _where0(running, params, new_p)
            st = _where0(running, st, new_st)
            iters = iters + running.to(torch.int64)
            running = continuing()
        error = state_of(st).error
        info = OptInfo(iterations=iters, error=error,
                       converged=error <= self.tol)
        obs_events.emit("converged", {"solver": type(self).__name__},
                        iterations=info.iterations, error=info.error,
                        converged=info.converged)
        return params, info

    def diff_spec(self) -> diff_api.ImplicitDiffSpec:
        """The solver's ``ImplicitDiffSpec``: its declared optimality
        mapping plus its configured backward-solve routing.  ``run()``
        self-wraps with this; drivers (``bilevel``, the DEQ layer) may
        override routing fields per call via ``spec.replace(...)``."""
        return diff_api.ImplicitDiffSpec(
            optimality_fun=self.optimality_fun, solve=self.solve,
            tol=self.linsolve_tol, maxiter=self.linsolve_maxiter,
            ridge=self.ridge, precond=self.precond, has_aux=True,
            sharding=self.sharding, backward=self.backward,
            backward_iters=self.backward_iters,
            error_estimate=self.error_estimate)

    def run(self, init_params, *theta, mode: Optional[str] = None):
        """Solve from ``init_params``; returns ``(params, OptInfo)``.

        Differentiable in every ``theta`` argument (its floating-point
        tensor leaves) via implicit differentiation of the declared
        optimality mapping; ``init_params`` and ``OptInfo`` get no
        derivative.  With the default ``mode="auto"`` the same ``run``
        supports reverse (``torch.autograd.grad``, ``torch.func.grad`` /
        ``jacrev``) and forward (``torch.func.jvp`` / ``jacfwd``)
        differentiation; ``mode`` (keyword) overrides the instance setting
        per call.  ``torch.func.vmap`` over ``run`` (or either mode's
        derivative) runs the forward as one masked loop and the backward
        or tangent solve as one batched solve.
        """
        if not self.implicit_diff:
            return self._iterate(init_params, *theta)
        deco = diff_api.implicit_diff(
            self.diff_spec(), mode=self.mode if mode is None else mode)
        return deco(self._iterate)(init_params, *theta)

    def l2_optimality_error(self, params, *theta):
        """‖F(x, θ)‖ — a solver-independent certificate of optimality."""
        return _tree_l2(self.optimality_fun(params, *theta))

    def estimate_hypergrad_error(self, params, *theta, cotangent=None):
        """Relative residual ``‖v − Aᵀu‖/‖v‖`` of the cotangent system at
        the (possibly approximate) backward solution ``u``.

        The honesty check of the approximate ``backward`` modes: replays
        the configured backward treatment on the cotangent ``v`` (an
        all-ones tree shaped like ``params`` by default) and spends one
        extra matvec on the implicit system's residual.
        """
        if cotangent is None:
            cotangent = tree_map(torch.ones_like, params)
        spec = self.diff_spec()
        _, info = diff_api.root_vjp(
            spec.residual_fun, params, theta, cotangent, solve=spec.solve,
            sharding=spec.sharding, error_estimate=True, return_info=True,
            system_operator=spec.system_operator,
            **spec.routing_kwargs(), **spec.backward_kwargs())
        return info.hypergrad_error_estimate


class _RunLoop(torch.autograd.Function):
    """``run()``'s loop on a batch axis.  Inputs: the tensors of
    ``(init_params, theta)``; outputs: the params' tensors, then
    ``OptInfo``'s three fields.  Its ``vmap`` rule runs the batch as one
    masked loop (``IterativeSolver._masked_loop``)."""

    @staticmethod
    def forward(job, *tensors):
        solver, flat = job
        params, theta = flat.trees(tensors)
        params, info = solver._iterate(params, *theta)
        return tuple(Flat(params).tensors) + tuple(info[:3])

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(*output)

    @staticmethod
    def vmap(info, in_dims, job, *tensors):
        solver, flat = job
        tensors, dims = batch_first(tensors, in_dims[1:])
        params, theta = flat.trees(tensors)
        params_dims, theta_dims = flat.dims(dims)
        params = tree_map(lambda l, d: l if d == 0 else
                          l.expand((info.batch_size,) + tuple(l.shape)),
                          params, params_dims)
        params, opt = solver._masked_loop(params, theta, theta_dims,
                                          info.batch_size)
        out = tuple(Flat(params).tensors) + tuple(opt[:3])
        return out, (0,) * len(out)


class _Backtrack(torch.autograd.Function):
    """The Armijo halving of ``GradientDescent``'s line search on a batch
    axis: its ``vmap`` rule halves each instance's step until its own test
    passes, reading "any instance still halving" once per halving.
    Inputs: the tensors of ``(params, g, v, gnorm2, theta)``; output: η."""

    @staticmethod
    def forward(job, *tensors):
        solver, flat = job
        return torch.as_tensor(solver._backtrack(*flat.trees(tensors)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def vmap(info, in_dims, job, *tensors):
        solver, flat = job
        tensors, dims = batch_first(tensors, in_dims[1:])
        args = flat.trees(tensors)
        v = args[2]
        eta = torch.full((info.batch_size,), solver.stepsize,
                         dtype=v.dtype, device=v.device)
        shrink = torch.func.vmap(solver._needs_shrink,
                                 in_dims=(0, *flat.dims(dims)))
        halving = shrink(eta, *args)
        while bool(halving.any()):
            eta = torch.where(halving, 0.5 * eta, eta)
            halving = halving & shrink(eta, *args)
        return eta, 0


# ---------------------------------------------------------------------------
# Gradient descent (fixed step or backtracking line search)
# ---------------------------------------------------------------------------

class GradientDescentState(NamedTuple):
    """Iteration state of ``GradientDescent``."""
    iter_num: int
    error: torch.Tensor


@dataclasses.dataclass(eq=False)
class GradientDescent(IterativeSolver):
    """min f(x, θ) by x ← x − η∇f; optimality = stationarity (eq. 4).

    ``error`` is ``‖Δx‖`` for the fixed-step variant and ``‖∇f‖`` with
    backtracking (halve η until the Armijo test passes, one objective
    evaluation and one host read per halving; on a batch axis the halving
    is masked per instance, ``_Backtrack``).
    """
    fun: Callable = None
    stepsize: float = 1e-2
    linesearch: bool = False

    def optimality_fun(self, params, *theta):
        """The optimality mapping ``F(x, θ)`` that ``run()`` differentiates through."""
        return _grad(self.fun)(params, *theta)

    def init_state(self, params, *theta):
        """See ``IterativeSolver.init_state``."""
        return GradientDescentState(0, _inf_like(params))

    def update(self, params, state, *theta):
        """See ``IterativeSolver.update``."""
        if not self.linesearch:
            g = _grad(self.fun)(params, *theta)
            new_params = _tree_axpy(params, g, -self.stepsize)
            error = _tree_l2(_tree_sub(new_params, params))
            return new_params, GradientDescentState(state.iter_num + 1, error)

        g, v = torch.func.grad_and_value(self.fun, argnums=0)(params, *theta)
        gnorm2 = sum(ls._real(ls._tree_dot(gi, gi)) for gi in tree_leaves(g))
        if is_batched(params, g, v, theta):
            flat = Flat(params, g, v, gnorm2, theta)
            eta = _Backtrack.apply((self, flat), *flat.tensors)
        else:
            eta = self._backtrack(params, g, v, gnorm2, theta)
        new_params = _tree_axpy(params, g, -eta)
        return new_params, GradientDescentState(state.iter_num + 1,
                                                torch.sqrt(gnorm2))

    def _needs_shrink(self, eta, params, g, v, gnorm2, theta):
        """The Armijo test fails at step ``eta`` (and ``eta > 1e-12``)."""
        x_try = _tree_axpy(params, g, -eta)
        return (eta > 1e-12) & (self.fun(x_try, *theta)
                                > v - 0.5 * eta * gnorm2)

    def _backtrack(self, params, g, v, gnorm2, theta) -> float:
        """Halve η from ``stepsize`` until the Armijo test passes."""
        eta = self.stepsize
        while bool(self._needs_shrink(eta, params, g, v, gnorm2, theta)):
            eta = 0.5 * eta
        return eta


# ---------------------------------------------------------------------------
# Proximal gradient / FISTA (and projected gradient as a special case)
# ---------------------------------------------------------------------------

class ProximalGradientState(NamedTuple):
    """Iteration state of ``ProximalGradient``."""
    iter_num: int
    error: torch.Tensor
    z: Any                     # momentum iterate (= params when accel off)
    t: float                   # FISTA momentum scalar


@dataclasses.dataclass(eq=False)
class ProximalGradient(IterativeSolver):
    """min f(x, θf) + g(x, θg); run signature ``run(init, (θf, θg))``.

    FISTA momentum is on by default (``accel=False`` gives plain ISTA).
    Optimality mapping: the prox-grad fixed point (paper eq. 7).
    """
    fun: Callable = None
    prox: Callable = None      # prox(y, theta_g, scaling) -> pytree
    stepsize: float = 1e-2
    accel: bool = True

    @property
    def fixed_point_fun(self):
        """The fixed-point mapping ``T(x, θ)`` (residual ``T(x) − x``)."""
        return optimality.proximal_gradient_fp(self.fun, self.prox,
                                               self.stepsize)

    def _pg_step(self, x, theta):
        theta_f, theta_g = theta
        y = _tree_axpy(x, _grad(self.fun)(x, theta_f), -self.stepsize)
        return self.prox(y, theta_g, self.stepsize)

    def init_state(self, params, theta):
        """See ``IterativeSolver.init_state``."""
        return ProximalGradientState(0, _inf_like(params), z=params, t=1.0)

    def update(self, params, state, theta):
        """See ``IterativeSolver.update``."""
        if not self.accel:
            new_params = self._pg_step(params, theta)
            error = _tree_l2(_tree_sub(new_params, params))
            return new_params, ProximalGradientState(
                state.iter_num + 1, error, z=new_params, t=state.t)
        new_params = self._pg_step(state.z, theta)
        t_new = 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * state.t * state.t))
        mom = (state.t - 1.0) / t_new
        z_new = tree_map(lambda a, b: a + mom * (a - b), new_params, params)
        error = _tree_l2(_tree_sub(new_params, params))
        return new_params, ProximalGradientState(state.iter_num + 1, error,
                                                 z=z_new, t=t_new)


def ProjectedGradient(fun: Callable, proj: Callable, **kw) -> ProximalGradient:
    """Projected gradient = proximal gradient with an indicator prox
    (paper eq. 9); run signature ``run(init, (θf, θproj))``."""
    def prox(y, theta_proj, scaling):
        del scaling
        return proj(y, theta_proj)

    return ProximalGradient(fun, prox, **kw)


# ---------------------------------------------------------------------------
# Mirror descent (KL geometry default)
# ---------------------------------------------------------------------------

class MirrorDescentState(NamedTuple):
    """Iteration state of ``MirrorDescent``."""
    iter_num: int
    error: torch.Tensor


@dataclasses.dataclass(eq=False)
class MirrorDescent(IterativeSolver):
    """Mirror descent with Bregman projection; ``run(init, (θf, θproj))``.

    Optimality mapping: the mirror-descent fixed point (paper eq. 13);
    the η decay schedule only affects the forward iteration.
    """
    fun: Callable = None
    proj_bregman: Callable = None          # proj(y, theta_proj) in dual space
    phi_grad: Callable = optimality.kl_phi_grad
    stepsize: float = 1.0
    sqrt_decay_after: int = 100

    @property
    def fixed_point_fun(self):
        """The fixed-point mapping ``T(x, θ)`` (residual ``T(x) − x``)."""
        return optimality.mirror_descent_fp(self.fun, self.proj_bregman,
                                            self.phi_grad, self.stepsize)

    def init_state(self, params, theta):
        """See ``IterativeSolver.init_state``."""
        return MirrorDescentState(0, _inf_like(params))

    def update(self, params, state, theta):
        """See ``IterativeSolver.update``."""
        theta_f, theta_proj = theta
        k = state.iter_num
        eta = self.stepsize * (1.0 if k < self.sqrt_decay_after else
                               math.sqrt(self.sqrt_decay_after / max(k, 1)))
        y = _tree_axpy(self.phi_grad(params),
                       _grad(self.fun)(params, theta_f), -eta)
        new_params = self.proj_bregman(y, theta_proj)
        error = _tree_l2(_tree_sub(new_params, params))
        return new_params, MirrorDescentState(state.iter_num + 1, error)


# ---------------------------------------------------------------------------
# Block coordinate descent (cyclic over rows)
# ---------------------------------------------------------------------------

class BlockCDState(NamedTuple):
    """Iteration state of ``BlockCoordinateDescent``."""
    iter_num: int
    error: torch.Tensor


@dataclasses.dataclass(eq=False)
class BlockCoordinateDescent(IterativeSolver):
    """Cyclic block CD; x has shape (m, k), blocks are rows;
    ``run(init, (θf, θg))``.  One update = one Gauss-Seidel sweep; the
    optimality mapping is the (Jacobi) row-wise prox fixed point — both
    share the same fixed points (paper eq. 15)."""
    fun: Callable = None
    block_prox: Callable = None        # block_prox(row, theta_g, stepsize)
    stepsize: float = 1.0

    def fixed_point_fun(self, x, theta):
        """The fixed-point mapping ``T(x, θ)`` (residual ``T(x) − x``)."""
        theta_f, theta_g = theta
        y = x - self.stepsize * _grad(self.fun)(x, theta_f)
        return torch.func.vmap(
            lambda row: self.block_prox(row, theta_g, self.stepsize))(y)

    def init_state(self, params, theta):
        """See ``IterativeSolver.init_state``."""
        return BlockCDState(0, _inf_like(params))

    def update(self, params, state, theta):
        """See ``IterativeSolver.update``."""
        theta_f, theta_g = theta
        grad = _grad(self.fun)
        x = params
        for i in range(params.shape[0]):
            g = grad(x, theta_f)            # full grad; row i slice used
            row = self.block_prox(x[i] - self.stepsize * g[i], theta_g,
                                  self.stepsize)
            x = torch.cat([x[:i], row[None], x[i + 1:]])
        error = _tree_l2(x - params)
        return x, BlockCDState(state.iter_num + 1, error)


# ---------------------------------------------------------------------------
# Newton's method (optimization)
# ---------------------------------------------------------------------------

class NewtonState(NamedTuple):
    """Iteration state of ``Newton``."""
    iter_num: int
    error: torch.Tensor


@dataclasses.dataclass(eq=False)
class Newton(IterativeSolver):
    """Damped Newton on a flat-tensor iterate; optimality = stationarity.

    ``error`` is ‖∇f‖ at the pre-step iterate (the loop exits one step
    after the gradient passes tol, like the reference)."""
    fun: Callable = None
    stepsize: float = 1.0

    def optimality_fun(self, params, *theta):
        """The optimality mapping ``F(x, θ)`` that ``run()`` differentiates through."""
        return _grad(self.fun)(params, *theta)

    def init_state(self, params, *theta):
        """See ``IterativeSolver.init_state``."""
        return NewtonState(0, _inf_like(params))

    def update(self, params, state, *theta):
        """See ``IterativeSolver.update``."""
        g = _grad(self.fun)(params, *theta)
        H = torch.func.hessian(self.fun, argnums=0)(params, *theta)
        new_params = params - self.stepsize * torch.linalg.solve(H, g)
        return new_params, NewtonState(state.iter_num + 1, _tree_l2(g))


# ---------------------------------------------------------------------------
# L-BFGS (two-loop recursion, fixed step)
# ---------------------------------------------------------------------------

class LbfgsState(NamedTuple):
    """Iteration state of ``LBFGS``."""
    iter_num: int
    error: torch.Tensor
    x_flat: torch.Tensor       # (d,) the raveled iterate
    S: torch.Tensor            # (history, d) step differences
    Y: torch.Tensor            # (history, d) gradient differences
    rho: torch.Tensor          # (history,)


@dataclasses.dataclass(eq=False)
class LBFGS(IterativeSolver):
    """L-BFGS with fixed step on the raveled iterate; optimality =
    stationarity.  ``error`` is ‖∇f‖ at the post-step iterate.

    The iterate is raveled once in ``init_state``: ``state.x_flat`` is the
    canonical iterate and ``update``'s ``params`` supplies structure only
    (re-enter via ``init_state`` to override the iterate mid-run).
    """
    fun: Callable = None
    history: int = 10
    stepsize: float = 1.0

    def optimality_fun(self, params, *theta):
        """The optimality mapping ``F(x, θ)`` that ``run()`` differentiates through."""
        return _grad(self.fun)(params, *theta)

    def init_state(self, params, *theta):
        """See ``IterativeSolver.init_state``."""
        x0 = _ravel_iterate(self, params)
        d, m = x0.shape[0], self.history
        zeros = dict(dtype=x0.dtype, device=x0.device)
        return LbfgsState(0, _inf_like(params), x_flat=x0,
                          S=torch.zeros((m, d), **zeros),
                          Y=torch.zeros((m, d), **zeros),
                          rho=torch.zeros((m,), **zeros))

    def update(self, params, state, *theta):
        """See ``IterativeSolver.update``."""
        x, unravel = state.x_flat, _unravel_for(self, params)
        grad = torch.func.grad(lambda v: self.fun(unravel(v), *theta))
        S, Y, rho, k = state.S, state.Y, state.rho, state.iter_num
        m = self.history
        n = min(k, m)

        def two_loop(q):
            alphas = [None] * m
            for i in range(n):
                j = (k - 1 - i) % m
                a = rho[j] * torch.dot(S[j], q)
                q = q - a * Y[j]
                alphas[j] = a
            j_last = (k - 1) % m
            ys = torch.dot(S[j_last], Y[j_last])
            yy = torch.dot(Y[j_last], Y[j_last])
            gamma = torch.where((yy > 0) & (k > 0), ys / yy,
                                torch.ones_like(yy))
            r = gamma * q
            for i in range(n):
                j = (k - n + i) % m
                b = rho[j] * torch.dot(Y[j], r)
                r = r + (alphas[j] - b) * S[j]
            return r

        g = grad(x)
        x_new = x - self.stepsize * two_loop(g)
        g_new = grad(x_new)
        s, y = x_new - x, g_new - g
        sy = torch.dot(s, y)
        slot = k % m
        ok = sy > 1e-10
        S, Y, rho = S.clone(), Y.clone(), rho.clone()
        S[slot] = torch.where(ok, s, S[slot])
        Y[slot] = torch.where(ok, y, Y[slot])
        rho[slot] = torch.where(ok, 1.0 / torch.where(ok, sy, 1.0), rho[slot])
        new_state = LbfgsState(k + 1, torch.linalg.vector_norm(g_new),
                               x_flat=x_new, S=S, Y=Y, rho=rho)
        return unravel(x_new), new_state


# ---------------------------------------------------------------------------
# Fixed-point iteration + Anderson acceleration
# ---------------------------------------------------------------------------

class FixedPointState(NamedTuple):
    """Iteration state of ``FixedPointIteration``."""
    iter_num: int
    error: torch.Tensor


@dataclasses.dataclass(eq=False)
class FixedPointIteration(IterativeSolver):
    """x ← T(x, θ) until ‖T(x) − x‖ ≤ tol; implicit diff via eq. (3)."""
    fixed_point_fun: Callable = None     # T(x, *theta)

    def init_state(self, params, *theta):
        """See ``IterativeSolver.init_state``."""
        return FixedPointState(0, _inf_like(params))

    def update(self, params, state, *theta):
        """See ``IterativeSolver.update``."""
        new_params = self.fixed_point_fun(params, *theta)
        error = _tree_l2(_tree_sub(new_params, params))
        return new_params, FixedPointState(state.iter_num + 1, error)


class AndersonState(NamedTuple):
    """Iteration state of ``AndersonAcceleration``."""
    iter_num: int
    error: torch.Tensor
    x_flat: torch.Tensor       # (d,) the raveled iterate
    X: torch.Tensor            # (history, d) iterate history (raveled)
    F: torch.Tensor            # (history, d) residual history g(x) = T(x) − x


@dataclasses.dataclass(eq=False)
class AndersonAcceleration(IterativeSolver):
    """Type-II Anderson acceleration of x = T(x, θ) on the raveled iterate.

    ``aa_ridge`` regularizes the least-squares mixing system (distinct from
    the inherited ``ridge``, which damps the *backward* linear solve).
    ``error`` is the residual ‖T(x) − x‖ at the pre-mixing iterate.  As for
    ``LBFGS``, ``state.x_flat`` is the canonical iterate.
    """
    fixed_point_fun: Callable = None     # T(x, *theta)
    history: int = 5
    aa_ridge: float = 1e-8
    beta: float = 1.0

    def init_state(self, params, *theta):
        """See ``IterativeSolver.init_state``."""
        x0 = _ravel_iterate(self, params)
        d, m = x0.shape[0], self.history
        zeros = dict(dtype=x0.dtype, device=x0.device)
        return AndersonState(0, _inf_like(params), x_flat=x0,
                             X=torch.zeros((m, d), **zeros),
                             F=torch.zeros((m, d), **zeros))

    def update(self, params, state, *theta):
        """See ``IterativeSolver.update``."""
        x, unravel = state.x_flat, _unravel_for(self, params)
        m = self.history
        k = state.iter_num
        gx = _ravel1(self.fixed_point_fun(unravel(x), *theta)) - x
        slot = k % m
        X, Fh = state.X.clone(), state.F.clone()
        X[slot] = x
        Fh[slot] = gx
        n = min(k + 1, m)
        # solve min_alpha ||alpha^T Fh||, sum alpha = 1 via normal equations
        eye = torch.eye(m, dtype=x.dtype, device=x.device)
        G = Fh @ Fh.T + self.aa_ridge * eye
        mask = (torch.arange(m, device=x.device) < n).to(x.dtype)
        G = G * mask[:, None] * mask[None, :] + \
            torch.diag(1.0 - mask)  # inactive rows → identity
        alpha = torch.linalg.solve(G, mask) * mask
        alpha = alpha / alpha.sum()
        x_new = alpha @ (X + self.beta * Fh)
        error = torch.linalg.vector_norm(gx)
        return unravel(x_new), AndersonState(k + 1, error, x_flat=x_new,
                                             X=X, F=Fh)
