"""Decorator-form implicit differentiation — thin shims over ``diff_api``.

Counterpart of ``repro.core.implicit_diff``:

  * ``@custom_root(F)``        — shim over ``implicit_diff(optimality_fun=F)``
  * ``@custom_fixed_point(T)`` — shim over ``implicit_diff(fixed_point_fun=T)``
  * ``root_vjp`` / ``root_jvp``— re-exported products

The decorated functions support reverse mode (``torch.autograd.grad``,
``torch.func.grad``) and forward mode (``torch.func.jvp``) without
re-wrapping.  ``custom_root_jvp`` / ``custom_fixed_point_jvp`` are
DEPRECATED forward-only shims: they emit a one-shot
``DeprecationWarning`` and reject ``backward=``.

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
          ridge=0.0, has_aux=False, precond=None,
          backward="exact") -> ImplicitDiffSpec:
    return ImplicitDiffSpec(optimality_fun=F, fixed_point_fun=T, solve=solve,
                            tol=tol, maxiter=maxiter, ridge=ridge,
                            precond=precond, has_aux=has_aux,
                            backward=backward)


def custom_root(F: Callable, solve="normal_cg", tol: float = 1e-6,
                maxiter: int = 1000, ridge: float = 0.0,
                has_aux: bool = False, precond=None,
                backward: str = "exact"):
    """Decorator: attach implicit differentiation to ``solver(init, *theta)``.

    The returned function is differentiable in every ``theta`` argument in
    both autodiff modes; ``init`` gets no derivative.  ``has_aux=True``
    means the solver returns ``(x_star, aux)``.  ``precond`` (e.g.
    ``"jacobi"``) is forwarded to the registry solver named by ``solve``.

    Example (paper Fig. 1)::

        @custom_root(F)            # F(x, theta) = ∇₁f(x, theta)
        def ridge_solver(init_x, theta): ...
    """
    return implicit_diff(_spec(F=F, solve=solve, tol=tol, maxiter=maxiter,
                               ridge=ridge, has_aux=has_aux, precond=precond,
                               backward=backward))


def custom_fixed_point(T: Callable, solve="normal_cg", tol: float = 1e-6,
                       maxiter: int = 1000, ridge: float = 0.0,
                       has_aux: bool = False, precond=None,
                       backward: str = "exact"):
    """Decorator for solvers of fixed points x* = T(x*, θ) (residual
    F(x, θ) = T(x, θ) − x); both autodiff modes, like ``custom_root``."""
    return implicit_diff(_spec(T=T, solve=solve, tol=tol, maxiter=maxiter,
                               ridge=ridge, has_aux=has_aux, precond=precond,
                               backward=backward))


def _reject_backward(name: str, backward):
    """The deprecated shims do not accept backward-mode requests."""
    if backward is not None:
        raise TypeError(
            f"{name} is a deprecated forward-only shim and does not accept "
            "backward=; use custom_root / custom_fixed_point / implicit_diff")


def custom_root_jvp(F: Callable, solve="normal_cg", tol: float = 1e-6,
                    maxiter: int = 1000, ridge: float = 0.0, precond=None,
                    has_aux: bool = False, backward=None):
    """DEPRECATED: ``custom_root`` supports forward mode directly.

    A forward-only shim (``mode="jvp"``); passing ``backward=`` raises
    ``TypeError``.
    """
    _reject_backward("custom_root_jvp", backward)
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
                           backward=None):
    """DEPRECATED: see ``custom_root_jvp``; use ``custom_fixed_point``."""
    _reject_backward("custom_fixed_point_jvp", backward)
    warn_once("custom_fixed_point_jvp",
              "repro_torch.core.implicit_diff.custom_fixed_point_jvp is "
              "deprecated; custom_fixed_point / implicit_diff support "
              "forward mode (torch.func.jvp) directly")
    return implicit_diff(_spec(T=T, solve=solve, tol=tol, maxiter=maxiter,
                               ridge=ridge, has_aux=has_aux,
                               precond=precond), mode="jvp")
