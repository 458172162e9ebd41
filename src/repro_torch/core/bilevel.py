"""Bi-level optimization driver built on implicit differentiation (PyTorch).

Counterpart of ``repro.core.bilevel``:

    min_θ  L_outer(x*(θ), θ)   s.t.   x*(θ) = argmin_x  L_inner(x, θ)

The hypergradient ∇θ L_outer flows through x*(θ) via implicit
differentiation of the inner optimality condition — one extra linear solve
instead of backpropagation through the inner run.  The preferred inner
solver is a ``solver_runtime.IterativeSolver``: it declares its optimality
mapping, self-wraps with ``implicit_diff`` and reports ``OptInfo``
(``BilevelSolution.inner_info``).  Bare callables with an explicit
``inner_objective`` / ``fixed_point`` work via ``make_implicit_inner``.

Differences from the JAX driver:
  * ``jax.value_and_grad`` becomes ``torch.autograd.grad`` on the
    floating-point tensor leaves of θ; θ may be any pytree, e.g.
    ``(θ, None)`` — leaves that are not such tensors pass through every
    outer step unchanged;
  * ``jit=`` has no counterpart (PyTorch runs eagerly) and is not taken.

``backward`` / ``backward_iters`` select an approximate hypergradient;
with an ``IterativeSolver`` running such a mode, or a stochastic inner
solver in any mode, each step's ``inner_info.hypergrad_error_estimate``
reports the relative residual of the cotangent system at the outer loss's
cotangent.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import torch
import torch.func

from repro_torch.core import diff_api, optimality
from repro_torch.core._tree import tree_flatten, tree_unflatten
from repro_torch.core.diff_api import ImplicitDiffSpec
from repro_torch.core.solver_runtime import IterativeSolver, OptInfo
from repro_torch.observability import events as obs_events
from repro_torch.observability import metrics as obs_metrics


@dataclasses.dataclass
class BilevelSolution:
    """Result of ``solve_bilevel``: final θ, inner solution and traces."""
    theta: Any
    x_star: Any
    outer_values: Any      # (steps,) trace of outer loss
    hypergrad_norms: Any   # (steps,)
    inner_info: Optional[OptInfo] = None   # last inner-solve diagnostics


def _make_inner_runner(inner_solver, inner_objective, fixed_point, solve,
                       tol, maxiter, ridge, precond, backward=None,
                       backward_iters=None, diff_spec=None,
                       mode=None) -> Callable:
    """``fn(init, *theta) -> (x_star, OptInfo | None)``, implicit-diff'd.

    ``None`` loose routing arguments mean "not specified": an
    ``IterativeSolver`` keeps its own configured backward-solve routing for
    them; the bare-callable path falls back to cg / 1e-6 / 1000 / 0.0.
    ``diff_spec`` replaces the loose routing arguments WHOLESALE; a
    routing-only spec keeps the solver's declared mapping, a spec carrying
    a mapping supersedes it.  ``mode`` selects the differentiation wrapping
    (``None`` keeps the solver's own, ``"auto"`` for bare callables).
    An ``IterativeSolver``'s runner carries the configured solver as
    ``runner.solver`` (``solve_bilevel`` replays its backward treatment).
    """
    loose = dict(solve=solve, tol=tol, maxiter=maxiter, ridge=ridge,
                 precond=precond, backward=backward,
                 backward_iters=backward_iters)
    if diff_spec is not None:
        if any(v is not None for v in loose.values()):
            raise ValueError("pass the backward-solve routing either via "
                             "diff_spec or via the loose solve/tol/maxiter/"
                             "ridge/precond/backward arguments, not both")
        if not diff_spec.is_routing_only and (
                inner_objective is not None or fixed_point is not None):
            raise ValueError("diff_spec already carries the optimality "
                             "mapping; drop inner_objective/fixed_point")

    if isinstance(inner_solver, IterativeSolver):
        if inner_objective is not None or fixed_point is not None:
            raise ValueError(
                "an IterativeSolver declares its own optimality mapping; "
                "drop inner_objective/fixed_point")
        if diff_spec is not None:
            overrides = dict(solve=diff_spec.solve, linsolve_tol=diff_spec.tol,
                             linsolve_maxiter=diff_spec.maxiter,
                             ridge=diff_spec.ridge, precond=diff_spec.precond,
                             backward=diff_spec.backward,
                             backward_iters=diff_spec.backward_iters,
                             error_estimate=diff_spec.error_estimate)
        else:
            overrides = {k: v for k, v in [("solve", solve),
                                           ("linsolve_tol", tol),
                                           ("linsolve_maxiter", maxiter),
                                           ("ridge", ridge),
                                           ("precond", precond),
                                           ("backward", backward),
                                           ("backward_iters", backward_iters)]
                         if v is not None}
        if mode is not None:
            overrides["mode"] = mode
        solver = dataclasses.replace(inner_solver, implicit_diff=True,
                                     **overrides)
        if diff_spec is not None and not diff_spec.is_routing_only:
            # the spec's mapping supersedes the solver's declared one: wrap
            # the raw iteration with it (the paper's decoupling promise)
            deco = diff_api.implicit_diff(diff_spec.replace(has_aux=True),
                                          mode=solver.mode)
            return lambda init, *theta: deco(solver._iterate)(init, *theta)

        def runner(init, *theta):
            return solver.run(init, *theta)

        runner.solver = solver
        return runner

    mode = "auto" if mode is None else mode
    if diff_spec is not None:
        if diff_spec.is_routing_only:
            # graft the mapping from the loose arguments onto the spec
            if (inner_objective is None) == (fixed_point is None):
                raise ValueError(
                    "a bare-callable inner solver needs an optimality "
                    "mapping: set optimality_fun/fixed_point_fun on the "
                    "spec, or pass exactly one of inner_objective/"
                    "fixed_point alongside the routing-only spec")
            if inner_objective is not None:
                diff_spec = diff_spec.replace(
                    optimality_fun=optimality.stationary(inner_objective))
            else:
                diff_spec = diff_spec.replace(fixed_point_fun=fixed_point)
        wrapped = diff_api.implicit_diff(diff_spec, mode=mode)(inner_solver)
        return lambda init, *theta: (wrapped(init, *theta), None)
    if (inner_objective is None) == (fixed_point is None):
        raise ValueError("provide exactly one of inner_objective/fixed_point")
    routing = dict(solve="cg" if solve is None else solve,
                   tol=1e-6 if tol is None else tol,
                   maxiter=1000 if maxiter is None else maxiter,
                   ridge=0.0 if ridge is None else ridge, precond=precond,
                   backward="exact" if backward is None else backward,
                   backward_iters=8 if backward_iters is None
                   else backward_iters)
    if inner_objective is not None:
        spec = ImplicitDiffSpec(
            optimality_fun=optimality.stationary(inner_objective), **routing)
    else:
        spec = ImplicitDiffSpec(fixed_point_fun=fixed_point, **routing)
    wrapped = diff_api.implicit_diff(spec, mode=mode)(inner_solver)
    return lambda init, *theta: (wrapped(init, *theta), None)


def make_implicit_inner(inner_solver: Union[Callable, IterativeSolver],
                        inner_objective: Optional[Callable] = None,
                        fixed_point: Optional[Callable] = None,
                        solve: Optional[str] = None,
                        tol: Optional[float] = None,
                        maxiter: Optional[int] = None,
                        ridge: Optional[float] = None,
                        precond=None,
                        backward: Optional[str] = None,
                        backward_iters: Optional[int] = None,
                        diff_spec: Optional[ImplicitDiffSpec] = None,
                        mode: Optional[str] = None) -> Callable:
    """Return ``fn(init, *theta) -> x_star`` with implicit derivatives.

    An ``IterativeSolver`` already knows its optimality mapping AND its
    backward-solve routing; only the routing arguments passed explicitly
    override it.  For a bare callable ``inner_solver(init, *theta) -> x*``,
    provide exactly one of ``inner_objective`` (stationarity condition
    used) or an explicit ``fixed_point`` mapping T(x, *theta); unspecified
    routing arguments default to cg / 1e-6 / 1000 / 0.0.
    ``backward`` / ``backward_iters`` swap the converged backward solve
    for an approximate mode.  ``diff_spec``
    bundles the same configuration as one ``ImplicitDiffSpec``; ``mode``
    picks the differentiation wrapping (the default serves
    ``torch.autograd.grad`` and ``torch.func.jvp``).
    """
    runner = _make_inner_runner(inner_solver, inner_objective, fixed_point,
                                solve, tol, maxiter, ridge, precond,
                                backward=backward,
                                backward_iters=backward_iters,
                                diff_spec=diff_spec, mode=mode)
    return lambda init, *theta: runner(init, *theta)[0]


def _is_param(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.is_floating_point()


def _detached(tree):
    leaves, spec = tree_flatten(tree)
    return tree_unflatten([leaf.detach() if isinstance(leaf, torch.Tensor)
                           else leaf for leaf in leaves], spec)


def solve_bilevel(outer_loss: Callable,
                  inner_solver: Union[Callable, IterativeSolver], theta0,
                  x_init, *, inner_objective: Optional[Callable] = None,
                  fixed_point: Optional[Callable] = None,
                  outer_steps: int = 100, outer_lr: float = 1e-2,
                  momentum: float = 0.9, solve: Optional[str] = None,
                  inner_tol: Optional[float] = None,
                  linsolve_maxiter: Optional[int] = None,
                  ridge: Optional[float] = None, precond=None,
                  backward: Optional[str] = None,
                  backward_iters: Optional[int] = None,
                  diff_spec: Optional[ImplicitDiffSpec] = None,
                  mode: Optional[str] = None,
                  warm_start: bool = True) -> BilevelSolution:
    """Gradient descent (with momentum) on the outer problem.

    ``outer_loss(x_star, theta) -> scalar tensor``; ``inner_solver`` is an
    ``IterativeSolver`` (preferred: its ``run()`` carries implicit
    derivatives and ``OptInfo``) or a bare callable
    ``inner_solver(x_init, theta) -> x_star`` plus ``inner_objective`` /
    ``fixed_point``.  ``solve`` / ``inner_tol`` / ``linsolve_maxiter`` /
    ``ridge`` / ``precond`` route the backward linear solve; left ``None``
    an ``IterativeSolver`` keeps its own configuration while the callable
    path uses cg / 1e-6 / 1000 / 0.0.  ``diff_spec`` passes the same
    configuration as one ``ImplicitDiffSpec`` (a WHOLESALE routing
    override; a spec carrying a mapping supersedes the solver's declared
    one).  Each outer step takes ``torch.autograd.grad`` of the outer loss
    with respect to θ's floating-point tensor leaves; every other leaf of
    the θ pytree passes through unchanged.  ``warm_start`` reuses the
    previous inner solution as init.  ``backward`` / ``backward_iters``
    select an approximate hypergradient; with an ``IterativeSolver`` in
    such a mode, or a stochastic one (``is_stochastic``: it solves against
    a sampled operator) in any mode, and ``error_estimate=True``, its
    default, each step's
    ``inner_info.hypergrad_error_estimate`` is the relative residual of
    the cotangent system at the outer loss's cotangent, one more
    backward application and matvec a step.  Each step adds one to the global
    ``repro_bilevel_steps_total`` counter and emits a ``bilevel_step``
    event (observe-gated).
    """
    implicit_solver = _make_inner_runner(
        inner_solver, inner_objective, fixed_point, solve, inner_tol,
        linsolve_maxiter, ridge, precond, backward=backward,
        backward_iters=backward_iters, diff_spec=diff_spec, mode=mode)

    def outer_value_and_grad(theta, x_init):
        leaves, spec = tree_flatten(theta)
        slots = [i for i, leaf in enumerate(leaves) if _is_param(leaf)]
        params = [leaves[i].detach().requires_grad_() for i in slots]
        for i, p in zip(slots, params):
            leaves[i] = p
        theta_t = tree_unflatten(leaves, spec)
        with torch.enable_grad():
            x_star, info = implicit_solver(x_init, theta_t)
            val = outer_loss(x_star, theta_t)
            grads = torch.autograd.grad(val, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        return val.detach(), slots, grads, _detached(x_star), info

    # approximate backward modes AND stochastic inner solvers both give a
    # hypergradient whose backward system differs from the exact
    # full-batch one (a StochasticSolver solves against a sampled operator
    # even under backward="exact"); either way the estimate re-measures
    # the cotangent residual against the full-batch operator
    est_solver = getattr(implicit_solver, "solver", None)
    estimate = est_solver is not None and est_solver.error_estimate and (
        est_solver.backward != "exact"
        or getattr(est_solver, "is_stochastic", False))

    def estimate_fn(x_star, theta):
        ct = torch.func.grad(outer_loss, argnums=0)(x_star, theta)
        return est_solver.estimate_hypergrad_error(x_star, theta,
                                                   cotangent=ct)

    theta = theta0
    vel = None
    xs = x_init
    vals, gnorms = [], []
    x_star, info = x_init, None   # survive outer_steps=0
    for _ in range(outer_steps):
        val, slots, g, x_star, info = outer_value_and_grad(theta, xs)
        if estimate and info is not None:
            info = info._replace(
                hypergrad_error_estimate=estimate_fn(x_star, theta))
        vel = g if vel is None else [momentum * v + gi
                                     for v, gi in zip(vel, g)]
        leaves, spec = tree_flatten(theta)
        for i, v in zip(slots, vel):
            leaves[i] = leaves[i].detach() - outer_lr * v
        theta = tree_unflatten(leaves, spec)
        if warm_start:
            xs = x_star
        vals.append(float(val))
        gnorms.append(float(torch.sqrt(sum(
            (gi * gi).sum() for gi in g)) if g else 0.0))
        # host-side telemetry: always count outer steps in the global
        # registry (cheap, host-only); the per-step event is observe-gated
        obs_metrics.global_registry().counter(
            "repro_bilevel_steps_total",
            help="outer optimization steps taken by solve_bilevel").inc()
        obs_events.emit("bilevel_step",
                        {"solver": type(inner_solver).__name__},
                        outer_value=vals[-1], hypergrad_norm=gnorms[-1],
                        inner_iterations=(None if info is None
                                          else info.iterations))
    return BilevelSolution(theta=theta, x_star=x_star,
                           outer_values=torch.tensor(vals,
                                                     dtype=torch.float64),
                           hypergrad_norms=torch.tensor(gnorms,
                                                        dtype=torch.float64),
                           inner_info=info)


# ---------------------------------------------------------------------------
# Unrolled baseline (the paper's comparison axis)
# ---------------------------------------------------------------------------

def make_unrolled_inner(step_fn: Callable, num_steps: int) -> Callable:
    """Differentiate-through-the-solver baseline: backprop through
    ``num_steps`` applications of ``step_fn(x, theta) -> x``.  Memory grows
    O(num_steps); used to reproduce the paper's Fig. 3/4 comparisons."""

    def solver(x_init, theta):
        x = x_init
        for _ in range(num_steps):
            x = step_fn(x, theta)
        return x

    return solver
