"""DEQ-style implicit (fixed-point) layers with implicit-diff backward.

Counterpart of ``repro.core.implicit_layer``.  A deep-equilibrium block
solves z* = f(z*, x; w) in the forward pass and backpropagates through the
equilibrium with the paper's machinery, so memory is O(1) in solver depth.

The forward solve is an ``AndersonAcceleration`` or ``FixedPointIteration``
``run()`` (``torch.func.vmap`` over a batch of layer inputs runs one
masked loop), and implicit differentiation is automatic: the solver
declares the fixed-point mapping and routes its backward linear solve
through the registry — Neumann (the default), or an exact solver such as
``normal_cg``.  Routing can also come as one routing-only
``ImplicitDiffSpec`` (``diff_spec``), and ``mode`` selects the
differentiation wrapping (the default serves ``torch.autograd.grad`` and
``torch.func.jvp``).  The backward system I − ∂z f is a
``JacobianOperator`` of the declared fixed point.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.diff_api import ImplicitDiffSpec
from repro_torch.core.solver_runtime import (AndersonAcceleration,
                                             FixedPointIteration)


def make_deq_solver(cell: Callable, *, fwd_solver: str = "anderson",
                    fwd_iters: int = 30, fwd_tol: float = 1e-5,
                    bwd_solve: str = "neumann", bwd_iters: int = 12,
                    ridge: float = 0.0, precond=None,
                    backward: str = "exact", backward_iters: int = 8,
                    diff_spec: Optional[ImplicitDiffSpec] = None,
                    mode: Optional[str] = None):
    """Build the runtime solver for z* = cell(z*, x, w).

    Returns an ``IterativeSolver`` whose ``run(z0, x, w)`` yields
    ``(z_star, OptInfo)`` with derivatives flowing to ``x`` and ``w`` in
    both autodiff modes.  ``diff_spec`` (routing-only) replaces the loose
    ``bwd_solve`` / ``bwd_iters`` / ``ridge`` / ``precond`` / ``backward``
    / ``backward_iters`` arguments wholesale; the cell's fixed point is
    always the optimality mapping.  ``backward="neumann_k"`` with small
    ``backward_iters`` is the truncated-backprop DEQ approximation at a
    fixed O(k) matvec budget — unlike ``bwd_solve="neumann"``, which runs
    a tolerance-checked convergence loop.
    """
    if diff_spec is not None:
        if not diff_spec.is_routing_only:
            raise ValueError(
                "the DEQ layer's optimality mapping is the cell's fixed "
                "point; pass a routing-only ImplicitDiffSpec (no "
                "optimality_fun/fixed_point_fun)")
        kw = dict(maxiter=fwd_iters, tol=fwd_tol, solve=diff_spec.solve,
                  linsolve_tol=diff_spec.tol,
                  linsolve_maxiter=diff_spec.maxiter, ridge=diff_spec.ridge,
                  precond=diff_spec.precond, backward=diff_spec.backward,
                  backward_iters=diff_spec.backward_iters)
    else:
        kw = dict(maxiter=fwd_iters, tol=fwd_tol, solve=bwd_solve,
                  linsolve_maxiter=bwd_iters, ridge=ridge, precond=precond,
                  backward=backward, backward_iters=backward_iters)
    if mode is not None:
        kw["mode"] = mode
    if fwd_solver == "anderson":
        return AndersonAcceleration(cell, **kw)
    if fwd_solver == "iteration":
        return FixedPointIteration(cell, **kw)
    raise ValueError(f"unknown fwd_solver {fwd_solver!r}; "
                     "expected 'anderson' or 'iteration'")


def deq_fixed_point(cell: Callable, z_init, x, w, *,
                    fwd_solver: str = "anderson", fwd_iters: int = 30,
                    fwd_tol: float = 1e-5, bwd_solve: str = "neumann",
                    bwd_iters: int = 12, backward: str = "exact",
                    backward_iters: int = 8,
                    diff_spec: Optional[ImplicitDiffSpec] = None,
                    mode: Optional[str] = None, return_info: bool = False):
    """Solve z* = cell(z*, x, w) and register implicit derivatives wrt x, w.

    Returns z* (and the solve's ``OptInfo`` when ``return_info=True``).
    Derivatives flow to the floating-point tensors of ``x`` (previous
    activations) and ``w`` (the block's weights) in both autodiff modes;
    ``z_init`` gets none.  The other arguments go to ``make_deq_solver``.
    """
    solver = make_deq_solver(cell, fwd_solver=fwd_solver,
                             fwd_iters=fwd_iters, fwd_tol=fwd_tol,
                             bwd_solve=bwd_solve, bwd_iters=bwd_iters,
                             backward=backward,
                             backward_iters=backward_iters,
                             diff_spec=diff_spec, mode=mode)
    z_star, info = solver.run(z_init, x, w)
    return (z_star, info) if return_info else z_star


def make_deq_block(cell: Callable, **kw) -> Callable:
    """Return ``block(x, w) -> z*`` with z initialized at zero like x."""

    def block(x, w):
        return deq_fixed_point(cell, torch.zeros_like(x), x, w, **kw)

    return block
