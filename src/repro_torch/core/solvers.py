"""Inner solvers — DEPRECATED functional shims (PyTorch).

Counterpart of ``repro.core.solvers``.  The solver layer lives in
``repro_torch.core.solver_runtime`` as state-based ``IterativeSolver``
classes with a shared ``run()`` driver, ``OptInfo`` diagnostics and
automatic implicit differentiation.  These factories keep the older
signatures working: each builds the matching runtime solver with
``implicit_diff=False``, returns the bare ``x*`` and warns once per
process (``diff_api.warn_once``).  New code constructs the classes::

    from repro_torch.core import GradientDescent
    solver = GradientDescent(f, stepsize=1e-2, maxiter=1000, tol=1e-8)
    x_star, info = solver.run(x0, theta)     # gradients flow through x_star

Migration map:
  fixed_point_iteration     -> FixedPointIteration
  anderson_acceleration     -> AndersonAcceleration
  gradient_descent          -> GradientDescent
  proximal_gradient         -> ProximalGradient
  projected_gradient        -> ProjectedGradient
  mirror_descent            -> MirrorDescent
  block_coordinate_descent  -> BlockCoordinateDescent
  newton                    -> Newton
  lbfgs                     -> LBFGS
"""
from __future__ import annotations

from typing import Callable

from repro_torch.core import optimality
from repro_torch.core.diff_api import warn_once
from repro_torch.core.solver_runtime import (AndersonAcceleration,
                                             BlockCoordinateDescent,
                                             FixedPointIteration,
                                             GradientDescent, LBFGS,
                                             MirrorDescent, Newton,
                                             ProjectedGradient,
                                             ProximalGradient)

__all__ = [
    "fixed_point_iteration", "anderson_acceleration", "gradient_descent",
    "proximal_gradient", "projected_gradient", "mirror_descent",
    "block_coordinate_descent", "newton", "lbfgs",
]


def _deprecated(old: str, new: str):
    # one-shot per factory name: a loop calling a legacy factory every step
    # warns once, not per call (tests reset via reset_deprecation_warnings)
    warn_once(
        f"solvers.{old}",
        f"repro_torch.core.solvers.{old} is deprecated; use "
        f"repro_torch.core.solver_runtime.{new} (state-based runtime with "
        "automatic implicit differentiation) instead",
        stacklevel=4)


def fixed_point_iteration(T: Callable, init, *theta, maxiter: int = 1000,
                          tol: float = 1e-8):
    """Iterate x ← T(x, θ) until ‖T(x) − x‖ ≤ tol."""
    _deprecated("fixed_point_iteration", "FixedPointIteration")
    solver = FixedPointIteration(T, maxiter=maxiter, tol=tol,
                                 implicit_diff=False)
    return solver.run(init, *theta)[0]


def anderson_acceleration(T: Callable, init, *theta, history: int = 5,
                          maxiter: int = 200, tol: float = 1e-8,
                          ridge: float = 1e-8, beta: float = 1.0):
    """Anderson-accelerated fixed-point solve (type-II AA)."""
    _deprecated("anderson_acceleration", "AndersonAcceleration")
    solver = AndersonAcceleration(T, history=history, aa_ridge=ridge,
                                  beta=beta, maxiter=maxiter, tol=tol,
                                  implicit_diff=False)
    return solver.run(init, *theta)[0]


def gradient_descent(f: Callable, init, *theta, stepsize: float = 1e-2,
                     maxiter: int = 1000, tol: float = 1e-8,
                     linesearch: bool = False):
    """Minimize f(x, θ) by (optionally backtracking) gradient descent."""
    _deprecated("gradient_descent", "GradientDescent")
    solver = GradientDescent(f, stepsize=stepsize, linesearch=linesearch,
                             maxiter=maxiter, tol=tol, implicit_diff=False)
    return solver.run(init, *theta)[0]


def proximal_gradient(f: Callable, prox: Callable, init, theta,
                      stepsize: float = 1e-2, maxiter: int = 1000,
                      tol: float = 1e-8, accel: bool = True):
    """Minimize f(x, θf) + g(x, θg) with θ = (θf, θg); FISTA by default."""
    _deprecated("proximal_gradient", "ProximalGradient")
    solver = ProximalGradient(f, prox, stepsize=stepsize, accel=accel,
                              maxiter=maxiter, tol=tol, implicit_diff=False)
    return solver.run(init, theta)[0]


def projected_gradient(f: Callable, proj: Callable, init, theta,
                       stepsize: float = 1e-2, maxiter: int = 1000,
                       tol: float = 1e-8, accel: bool = True):
    """Minimize f(x, θf) over C(θproj) with θ = (θf, θproj)."""
    _deprecated("projected_gradient", "ProjectedGradient")
    solver = ProjectedGradient(f, proj, stepsize=stepsize, accel=accel,
                               maxiter=maxiter, tol=tol, implicit_diff=False)
    return solver.run(init, theta)[0]


def mirror_descent(f: Callable, proj_kl: Callable, init, theta,
                   phi_grad: Callable = optimality.kl_phi_grad,
                   stepsize: float = 1.0, maxiter: int = 1000,
                   tol: float = 1e-8, sqrt_decay_after: int = 100):
    """Mirror descent with a Bregman projection; θ = (θf, θproj)."""
    _deprecated("mirror_descent", "MirrorDescent")
    solver = MirrorDescent(f, proj_kl, phi_grad=phi_grad, stepsize=stepsize,
                           sqrt_decay_after=sqrt_decay_after,
                           maxiter=maxiter, tol=tol, implicit_diff=False)
    return solver.run(init, theta)[0]


def block_coordinate_descent(f: Callable, block_prox: Callable, init, theta,
                             stepsize: float = 1.0, maxiter: int = 500,
                             tol: float = 1e-8):
    """x has shape (m, k); blocks are rows.  One sweep = one pass over rows."""
    _deprecated("block_coordinate_descent", "BlockCoordinateDescent")
    solver = BlockCoordinateDescent(f, block_prox, stepsize=stepsize,
                                    maxiter=maxiter, tol=tol,
                                    implicit_diff=False)
    return solver.run(init, theta)[0]


def newton(f: Callable, init, *theta, maxiter: int = 50, tol: float = 1e-10,
           stepsize: float = 1.0):
    """Damped Newton on a flat iterate."""
    _deprecated("newton", "Newton")
    solver = Newton(f, stepsize=stepsize, maxiter=maxiter, tol=tol,
                    implicit_diff=False)
    return solver.run(init, *theta)[0]


def lbfgs(f: Callable, init, *theta, maxiter: int = 200, tol: float = 1e-8,
          history: int = 10, stepsize: float = 1.0):
    """L-BFGS with fixed step (see ``solver_runtime.LBFGS``)."""
    _deprecated("lbfgs", "LBFGS")
    solver = LBFGS(f, history=history, stepsize=stepsize, maxiter=maxiter,
                   tol=tol, implicit_diff=False)
    return solver.run(init, *theta)[0]
