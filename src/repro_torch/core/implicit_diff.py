"""Decorator-form implicit differentiation — thin shims over ``diff_api``.

Counterpart of ``repro.core.implicit_diff``:

  * ``@custom_root(F)``        — shim over ``implicit_diff(optimality_fun=F)``
  * ``@custom_fixed_point(T)`` — shim over ``implicit_diff(fixed_point_fun=T)``
  * ``root_vjp`` / ``root_jvp``— re-exported products

The decorated functions support reverse mode (``torch.autograd.grad``,
``torch.func.grad``) and forward mode (``torch.func.jvp``) without
re-wrapping, and take the approximate backward modes (``backward=`` /
``backward_iters=``).  ``custom_root_jvp`` / ``custom_fixed_point_jvp``
are DEPRECATED forward-only shims: they emit a one-shot
``DeprecationWarning`` and reject ``backward=`` / ``backward_iters=``.

Conventions: the decorated solver has signature ``solver(init, *theta)``
and returns ``x*``; ``F(x, *theta)`` returns a pytree shaped like ``x``.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.core.diff_api import (ImplicitDiffSpec, implicit_diff,
                                       root_jvp, root_vjp, warn_once)

__all__ = ["custom_root", "custom_fixed_point", "custom_root_jvp",
           "custom_fixed_point_jvp", "root_vjp", "root_jvp",
           "ImplicitDiffSpec", "implicit_diff"]


def _spec(F=None, T=None, solve="normal_cg", tol=1e-6, maxiter=1000,
          ridge=0.0, has_aux=False, precond=None, backward="exact",
          backward_iters=8) -> ImplicitDiffSpec:
    return ImplicitDiffSpec(optimality_fun=F, fixed_point_fun=T, solve=solve,
                            tol=tol, maxiter=maxiter, ridge=ridge,
                            precond=precond, has_aux=has_aux,
                            backward=backward, backward_iters=backward_iters)


def custom_root(F: Callable, solve="normal_cg", tol: float = 1e-6,
                maxiter: int = 1000, ridge: float = 0.0,
                has_aux: bool = False, precond=None,
                backward: str = "exact", backward_iters: int = 8):
    """Decorator: attach implicit differentiation to ``solver(init, *theta)``.

    The returned function is differentiable in every ``theta`` argument in
    both autodiff modes; ``init`` gets no derivative.  ``has_aux=True``
    means the solver returns ``(x_star, aux)``.  ``precond`` (e.g.
    ``"jacobi"``) is forwarded to the registry solver named by ``solve``.
    ``torch.func.vmap`` of the decorated solver's gradient runs ONE
    batched backward solve.  ``backward`` selects an approximate treatment
    of the backward system (``"one_step"`` / ``"neumann_k"`` /
    ``"jacobian_free"``, ``backward_iters`` the Neumann depth).

    Example (paper Fig. 1)::

        @custom_root(F)            # F(x, theta) = ∇₁f(x, theta)
        def ridge_solver(init_x, theta): ...
    """
    return implicit_diff(_spec(F=F, solve=solve, tol=tol, maxiter=maxiter,
                               ridge=ridge, has_aux=has_aux, precond=precond,
                               backward=backward,
                               backward_iters=backward_iters))


def custom_fixed_point(T: Callable, solve="normal_cg", tol: float = 1e-6,
                       maxiter: int = 1000, ridge: float = 0.0,
                       has_aux: bool = False, precond=None,
                       backward: str = "exact", backward_iters: int = 8):
    """Decorator for solvers of fixed points x* = T(x*, θ) (residual
    F(x, θ) = T(x, θ) − x); both autodiff modes, like ``custom_root``,
    the approximate ``backward`` modes included (for a contractive ``T``,
    ``"neumann_k"`` is the phantom-gradient approximation)."""
    return implicit_diff(_spec(T=T, solve=solve, tol=tol, maxiter=maxiter,
                               ridge=ridge, has_aux=has_aux, precond=precond,
                               backward=backward,
                               backward_iters=backward_iters))


def _reject_backward(name: str, backward, backward_iters):
    """The deprecated shims do not accept approximate-backward requests."""
    if backward is not None or backward_iters is not None:
        raise TypeError(
            f"{name} is a deprecated forward-only shim and does not accept "
            "backward=/backward_iters=; use custom_root / custom_fixed_point "
            "/ implicit_diff for approximate backward modes")


def custom_root_jvp(F: Callable, solve="normal_cg", tol: float = 1e-6,
                    maxiter: int = 1000, ridge: float = 0.0, precond=None,
                    has_aux: bool = False, backward=None,
                    backward_iters=None):
    """DEPRECATED: ``custom_root`` supports forward mode directly.

    A forward-only shim (``mode="jvp"``); passing ``backward=`` /
    ``backward_iters=`` raises ``TypeError``.
    """
    _reject_backward("custom_root_jvp", backward, backward_iters)
    warn_once("custom_root_jvp",
              "repro_torch.core.implicit_diff.custom_root_jvp is deprecated; "
              "custom_root / implicit_diff support forward mode "
              "(torch.func.jvp) directly")
    return implicit_diff(_spec(F=F, solve=solve, tol=tol, maxiter=maxiter,
                               ridge=ridge, has_aux=has_aux,
                               precond=precond), mode="jvp")


def custom_fixed_point_jvp(T: Callable, solve="normal_cg", tol: float = 1e-6,
                           maxiter: int = 1000, ridge: float = 0.0,
                           precond=None, has_aux: bool = False,
                           backward=None, backward_iters=None):
    """DEPRECATED: see ``custom_root_jvp``; use ``custom_fixed_point``.

    Passing ``backward=`` / ``backward_iters=`` raises ``TypeError``.
    """
    _reject_backward("custom_fixed_point_jvp", backward, backward_iters)
    warn_once("custom_fixed_point_jvp",
              "repro_torch.core.implicit_diff.custom_fixed_point_jvp is "
              "deprecated; custom_fixed_point / implicit_diff support "
              "forward mode (torch.func.jvp) directly")
    return implicit_diff(_spec(T=T, solve=solve, tol=tol, maxiter=maxiter,
                               ridge=ridge, has_aux=has_aux,
                               precond=precond), mode="jvp")
