"""Matrix-free linear solvers: the batched solve engine behind implicit diff.

Counterpart of ``repro.core.linear_solve`` in eager PyTorch.  Solvers take
an operator — a ``LinearOperator`` or a bare ``matvec: pytree -> pytree``
closure — and a pytree right-hand side, and return a pytree solution.  The
JAX package runs each loop as one ``lax.while_loop``; here it is a Python
loop over tensors with the same per-instance convergence masks: converged
instances freeze (``where(done, old, new)``) while stragglers iterate, and
the loop ends when the whole batch is done — one loop for the batch, never
N sequential solves.  The loop test reads one boolean from the device per
iteration.

Registry (``SolverSpec``; see ``available_solvers()``):

  * ``cg``          — conjugate gradient (A symmetric PSD; preconditioned)
  * ``normal_cg``   — CG on the normal equations AᵀA x = Aᵀ b (general A)
  * ``bicgstab``    — BiCGSTAB (general square A)
  * ``gmres``       — restarted GMRES (general square A; left-preconditioned)
  * ``dense_gmres`` — batched GMRES on materialized per-instance operators
                      (the nonsymmetric dense small-system regime, d ≤ 512)
  * ``lu``          — dense direct solve (materializes A)
  * ``neumann``     — truncated Neumann series for I - M with ||M|| < 1
  * ``pallas_cg``   — the batched-CG kernel for the dense SPD regime
                      (d ≤ 512): on CUDA tensors the hand-written Hopper
                      kernel of ``repro_torch.kernels.batched_cg``; the
                      name is kept so routing matches the JAX package

The approximate backward modes (``one_step``, ``neumann_k``,
``jacobian_free``) apply a fixed polynomial in A through
``approx_inverse_apply``.  The ``sharded_*`` solvers are not ported yet
(ROADMAP queue A.11).

Batching: ``solve(matvec, b, batch_axes=0, ...)`` with a ``matvec`` that
maps batched pytrees to batched pytrees, or a batch-aware operator
(``batch_ndim == 1``) through ``route_solve``.  The loops read the host,
so they do not run under ``torch.func.vmap`` themselves: the
implicit-diff layer's ``vmap`` rule hands them such a batch-aware
operator instead.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.func

from repro_torch.core import operators
from repro_torch.core._tree import canonical, tree_leaves, tree_map
from repro_torch.core.operators import (LinearOperator, RavelView, _ravel1,
                                        jacobi_preconditioner, ravel_view)
from repro_torch.observability import events as obs_events


# ---------------------------------------------------------------------------
# batch-aware pytree helpers
#
# ``batch_ndim`` is the number of leading batch axes on every leaf (0 or 1).
# Reductions run over the instance axes only, so per-instance scalars
# (step sizes, residual norms, done flags) have the batch shape.
# ---------------------------------------------------------------------------

def _bc(s, leaf, batch_ndim: int):
    """Broadcast a per-instance scalar against an instance-shaped leaf."""
    if batch_ndim == 0 or not isinstance(s, torch.Tensor):
        return s
    return s.reshape(tuple(s.shape) + (1,) * (leaf.ndim - batch_ndim))


def _tree_dot(a, b, batch_ndim: int = 0):
    out = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        prod = x.conj() * y if x.is_complex() else x * y
        axes = tuple(range(batch_ndim, x.ndim))
        out = out + (prod.sum(dim=axes) if axes else prod)
    return out


def _tree_add(a, b, alpha=1.0, batch_ndim: int = 0):
    return tree_map(lambda x, y: x + _bc(alpha, x, batch_ndim) * y, a, b)


def _tree_sub(a, b):
    return tree_map(lambda x, y: x - y, a, b)


def _tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def _real(x):
    return x.real if x.is_complex() else x


def _tree_l2(a, batch_ndim: int = 0):
    return torch.sqrt(torch.clamp_min(_real(_tree_dot(a, a, batch_ndim)),
                                      0.0))


def _tree_freeze(done, old, new, batch_ndim: int = 0):
    """Hold converged instances: where(done, old, new) leaf-wise."""
    return tree_map(lambda o, n: torch.where(_bc(done, o, batch_ndim), o, n),
                    old, new)


def _where(cond, a, b):
    return torch.where(cond, torch.as_tensor(a, dtype=b.dtype,
                                             device=b.device), b)


def _damped(matvec: Callable, ridge: float) -> Callable:
    if not ridge:
        return matvec
    if isinstance(matvec, LinearOperator):
        return operators.RidgeShifted(matvec, ridge)   # keeps flags/structure
    return lambda v: _tree_add(matvec(v), v, ridge)


def make_rmatvec(matvec: Callable, example_x):
    """Build x ↦ Aᵀx from x ↦ Ax.  ``LinearOperator``s answer directly;
    bare closures are transposed through ``torch.func.vjp`` (the VJP of a
    linear map is its transpose)."""
    if isinstance(matvec, LinearOperator):
        return matvec.rmatvec
    zeros = _tree_zeros_like(canonical(example_x))

    def rmatvec(y):
        _, vjp_fun = torch.func.vjp(lambda u: canonical(matvec(u)), zeros)
        (out,) = vjp_fun(canonical(y))
        return out

    return rmatvec


def _as_probe_operator(matvec, example, batch_ndim: int) -> LinearOperator:
    """Coerce to an operator with matching batchedness, so the basis-vector
    probing lives in ONE place (the ``LinearOperator`` defaults)."""
    if isinstance(matvec, LinearOperator) and matvec.batch_ndim == batch_ndim:
        return matvec
    return operators.FunctionOperator(matvec, example, batch_ndim=batch_ndim)


def materialize_matrix(matvec: Callable, example_x) -> torch.Tensor:
    """Densify a matvec to its (d, d) matrix (diagnostics / direct solve).

    A ``LinearOperator`` materializes itself (O(1) for dense/structured
    operators); bare closures are probed with basis vectors.
    """
    return _as_probe_operator(matvec, example_x, 0).materialize()


def materialize_batched(matvec: Callable, b, batch_ndim: int = 0,
                        view: Optional[RavelView] = None):
    """Densify a (possibly batched) operator to (B, d, d) plus the flat view.

    A ``LinearOperator`` with matching batchedness materializes itself —
    O(1) for ``DenseOperator``/``RidgeShifted`` stacks; bare closures are
    probed with basis vectors broadcast across the batch.
    """
    if view is None:
        view = ravel_view(matvec, b, batch_ndim)
    B, d = view.b.shape
    A = _as_probe_operator(matvec, b, batch_ndim).materialize()
    A = A if batch_ndim else A[None]
    return A.expand(B, d, d), view


# ---------------------------------------------------------------------------
# preconditioning hooks
# ---------------------------------------------------------------------------

def diagonal_of_matvec(matvec: Callable, b, batch_ndim: int = 0):
    """diag(A) with the same (possibly batched) structure as ``b``."""
    return _as_probe_operator(matvec, b, batch_ndim).diagonal()


def _resolve_precond(precond, matvec, b, batch_ndim: int, diag=None,
                     materialized=None):
    """None | callable | "jacobi" | "block_jacobi" -> callable M⁻¹ (or None).

    ``diag``/``materialized`` short-circuit the operator probing when the
    caller already holds the diagonal or the dense matrix (the
    dense-regime solvers materialize anyway).  ``"block_jacobi"`` needs a
    ``LinearOperator`` (the domain's pytree leaves — or a
    ``BlockDiagonal``'s blocks — define the blocks).
    """
    if precond is None or callable(precond):
        return precond
    if precond == "jacobi":
        if diag is None:
            diag = diagonal_of_matvec(matvec, b, batch_ndim)
        return jacobi_preconditioner(diag)
    if precond == "block_jacobi":
        if not isinstance(matvec, LinearOperator):
            raise ValueError("precond='block_jacobi' derives blocks from "
                             "operator structure; pass a LinearOperator "
                             "(or use 'jacobi' / a callable M⁻¹)")
        return operators.block_jacobi_preconditioner(
            matvec, materialized=materialized)
    raise ValueError(f"unknown preconditioner {precond!r}; expected None, "
                     "a callable M⁻¹, 'jacobi', or 'block_jacobi'")


# ---------------------------------------------------------------------------
# solve diagnostics
# ---------------------------------------------------------------------------

class SolveInfo(NamedTuple):
    """Per-instance diagnostics (batch-shaped under ``batch_axes``).

    ``iterations`` counts the solver's outer steps: matvec iterations for
    cg/normal_cg/bicgstab, *restart cycles* (each up to ``restart``
    Arnoldi steps) for gmres/dense_gmres, series terms for neumann, the
    matvec budget for the approximate backward modes, 0 for direct
    solves, -1 when untracked (pallas_cg).
    """
    iterations: torch.Tensor    # outer steps actually spent per instance
    residual: torch.Tensor      # final ||b - A x|| per instance
    converged: torch.Tensor     # residual <= tol * ||b|| per instance
    # relative residual ||rhs - A u|| / ||rhs|| of the implicit system at the
    # returned (co)tangent, when requested (error_estimate=True)
    hypergrad_error_estimate: Optional[torch.Tensor] = None


def _maybe_info(x, info: Optional[SolveInfo], return_info: bool):
    return (x, info) if return_info else x


def _squeeze_info(info: SolveInfo) -> SolveInfo:
    """Collapse the internal B=1 batch axis for unbatched calls."""
    return SolveInfo(*(None if leaf is None
                       else torch.as_tensor(leaf).reshape(-1)[0]
                       for leaf in info))


# ---------------------------------------------------------------------------
# Conjugate gradient (preconditioned, masked)
# ---------------------------------------------------------------------------

def solve_cg(matvec: Callable, b, *, init=None, tol: float = 1e-6,
             maxiter: int = 1000, ridge: float = 0.0, precond=None,
             return_info: bool = False, batch_ndim: int = 0):
    """(Preconditioned) conjugate gradient for symmetric PSD operators.

    ``ridge`` adds λI damping; ``precond`` is ``None``, a callable
    v ↦ M⁻¹v, or ``"jacobi"``.  Converged instances freeze inside the one
    loop for the batch.
    """
    nb = batch_ndim
    b = canonical(b)
    matvec = _damped(matvec, ridge)
    M = _resolve_precond(precond, matvec, b, nb)
    x = _tree_zeros_like(b) if init is None else canonical(init)
    r = _tree_sub(b, matvec(x))
    z = M(r) if M is not None else r
    p = z
    rz = _tree_dot(r, z, nb)
    rr = _real(_tree_dot(r, r, nb))
    b_norm = _tree_l2(b, nb)
    atol2 = torch.clamp_min(tol * b_norm, 1e-30) ** 2
    done = rr <= atol2
    it = torch.zeros_like(b_norm, dtype=torch.int32)
    iter_events = obs_events.observing_iterations()

    k = 0
    while k < maxiter and not bool(torch.all(done)):
        ap = matvec(p)
        denom = _tree_dot(p, ap, nb)
        alpha = _where(denom == 0, 0.0, rz / _where(denom == 0, 1.0, denom))
        x1 = _tree_add(x, p, alpha, nb)
        r1 = _tree_add(r, ap, -alpha, nb)
        rr1 = _real(_tree_dot(r1, r1, nb))
        z1 = M(r1) if M is not None else r1
        rz1 = _tree_dot(r1, z1, nb)
        beta = rz1 / _where(rz == 0, 1.0, rz)
        beta = _where(rz == 0, 0.0, beta)
        p1 = _tree_add(z1, p, beta, nb)
        # freeze instances that were already done at loop entry
        x = _tree_freeze(done, x, x1, nb)
        r = _tree_freeze(done, r, r1, nb)
        p = _tree_freeze(done, p, p1, nb)
        rz = torch.where(done, rz, rz1)
        rr = torch.where(done, rr, rr1)
        it = it + (~done).to(torch.int32)
        done = done | (rr <= atol2)
        k += 1
        if iter_events:
            obs_events.emit("iteration", {"solver": "cg"}, step=k,
                            residual_sq=rr)
    info = SolveInfo(iterations=it, residual=torch.sqrt(rr),
                     converged=rr <= atol2)
    return _maybe_info(x, info, return_info)


def solve_normal_cg(matvec: Callable, b, *, init=None, rmatvec=None,
                    tol: float = 1e-6, maxiter: int = 1000,
                    ridge: float = 0.0, precond=None,
                    return_info: bool = False, batch_ndim: int = 0):
    """Solve A x = b via CG on AᵀA x = Aᵀ b.  Works for any square A."""
    example = _tree_zeros_like(canonical(b)) if init is None else init
    if rmatvec is None:
        rmatvec = make_rmatvec(matvec, example)

    def normal_mv(v):
        return rmatvec(matvec(v))

    return solve_cg(normal_mv, rmatvec(b), init=init, tol=tol,
                    maxiter=maxiter, ridge=ridge, precond=precond,
                    return_info=return_info, batch_ndim=batch_ndim)


# ---------------------------------------------------------------------------
# BiCGSTAB (masked)
# ---------------------------------------------------------------------------

def solve_bicgstab(matvec: Callable, b, *, init=None, tol: float = 1e-6,
                   maxiter: int = 1000, ridge: float = 0.0, precond=None,
                   return_info: bool = False, batch_ndim: int = 0):
    """BiCGSTAB (van der Vorst, 1992) for general square operators.

    ``precond`` applies as a left preconditioner (wraps the operator); the
    loop iterates on the preconditioned residual, but ``SolveInfo`` always
    reports the TRUE residual ||b - A x||.  Per-instance done/breakdown
    masks inside one loop for the batch.
    """
    nb = batch_ndim
    b = canonical(b)
    matvec = _damped(matvec, ridge)
    matvec0, b0 = matvec, b
    M = _resolve_precond(precond, matvec, b, nb)
    if M is not None:
        inner = matvec
        matvec = lambda v: M(inner(v))
        b = M(b)
    x = _tree_zeros_like(b) if init is None else canonical(init)
    r = _tree_sub(b, matvec(x))
    rhat = p = r
    b_norm = _tree_l2(b, nb)
    atol = torch.clamp_min(tol * b_norm, 1e-30)
    rnorm = _tree_l2(r, nb)
    done = rnorm <= atol
    rho = _tree_dot(rhat, r, nb)
    it = torch.zeros_like(b_norm, dtype=torch.int32)

    k = 0
    while k < maxiter and not bool(torch.all(done)):
        v = matvec(p)
        denom = _tree_dot(rhat, v, nb)
        breakdown = denom == 0
        alpha = _where(breakdown, 0.0, rho / _where(breakdown, 1.0, denom))
        h = _tree_add(x, p, alpha, nb)
        s = _tree_add(r, v, -alpha, nb)
        t = matvec(s)
        tt = _tree_dot(t, t, nb)
        omega = _where(tt == 0, 0.0,
                       _tree_dot(t, s, nb) / _where(tt == 0, 1.0, tt))
        x1 = _tree_add(h, s, omega, nb)
        r1 = _tree_add(s, t, -omega, nb)
        rho1 = _tree_dot(rhat, r1, nb)
        beta = (rho1 / _where(rho == 0, 1.0, rho)) * \
            (alpha / _where(omega == 0, 1.0, omega))
        p1 = _tree_add(r1, _tree_add(p, v, -omega, nb), beta, nb)
        rn1 = _tree_l2(r1, nb)
        breakdown = breakdown | (rho == 0)
        # freeze instances that were already done at loop entry
        x = _tree_freeze(done, x, x1, nb)
        r = _tree_freeze(done, r, r1, nb)
        p = _tree_freeze(done, p, p1, nb)
        rho = torch.where(done, rho, rho1)
        rnorm = torch.where(done, rnorm, rn1)
        it = it + (~done).to(torch.int32)
        done = done | (rnorm <= atol) | breakdown
        k += 1
    if not return_info:
        return x
    rn, cutoff = rnorm, atol
    if M is not None:   # report the true residual, not M(b - A x)
        rn = _tree_l2(_tree_sub(b0, matvec0(x)), nb)
        cutoff = torch.clamp_min(tol * _tree_l2(b0, nb), 1e-30)
    return x, SolveInfo(iterations=it, residual=rn, converged=rn <= cutoff)


# ---------------------------------------------------------------------------
# GMRES (restarted; flat (B, d) core, masked restarts)
# ---------------------------------------------------------------------------

def _flat_init(init, b_flat, batch_ndim: int):
    """Flatten an init pytree to the (B, d) layout (zeros when None)."""
    if init is None:
        return torch.zeros_like(b_flat)
    if batch_ndim == 0:
        return _ravel1(init)[None]
    return ravel_view(lambda t: t, init, 1).b


def _gmres_flat(mv: Callable, b_flat, x0, *, tol: float, restart: int,
                maxiter: int):
    """Shared restarted-GMRES core on the flat (B, d) layout.

    Runs batched Arnoldi cycles in one masked loop; returns
    ``(x, rn, it, atol)`` with per-instance residuals/iteration counts.
    ``maxiter`` is the total matvec budget; the cycle cap is
    ``ceil(maxiter / restart)``.  The per-instance least-squares problem
    ``min ||beta e1 - H y||`` is solved through the SVD-based pseudoinverse
    with the same cutoff as ``jnp.linalg.lstsq(rcond=None)``.
    """
    B, d = b_flat.shape
    m = min(restart, d)
    max_cycles = max(1, -(-maxiter // m))       # ceil: total matvec budget
    norm = torch.linalg.vector_norm

    b_norm = norm(b_flat, dim=-1)                                # (B,)
    atol = torch.clamp_min(tol * b_norm, 1e-30)

    def arnoldi_cycle(x):
        r = b_flat - mv(x)                                       # (B, d)
        beta = norm(r, dim=-1)                                   # (B,)
        safe_beta = _where(beta == 0, 1.0, beta)
        V = b_flat.new_zeros((B, m + 1, d))
        V[:, 0] = r / safe_beta[:, None]
        H = b_flat.new_zeros((B, m + 1, m))
        for j in range(m):
            w = mv(V[:, j])                                      # (B, d)
            # modified Gram-Schmidt against the basis built so far
            for i in range(j + 1):
                hij = torch.sum(V[:, i].conj() * w, dim=-1)
                w = w - hij[:, None] * V[:, i]
                H[:, i, j] = hij
            hn = norm(w, dim=-1)
            H[:, j + 1, j] = hn
            V[:, j + 1] = w / _where(hn == 0, 1.0, hn)[:, None]
        e1 = b_flat.new_zeros((B, m + 1))
        e1[:, 0] = beta
        y = torch.einsum("bmk,bk->bm", torch.linalg.pinv(H), e1)
        return x + torch.einsum("bmd,bm->bd", V[:, :m], y)

    rn = norm(b_flat - mv(x0), dim=-1)
    done = rn <= atol
    it = torch.zeros((B,), dtype=torch.int32, device=b_flat.device)
    x = x0
    k = 0
    while k < max_cycles and not bool(torch.all(done)):
        x1 = arnoldi_cycle(x)
        rn1 = norm(b_flat - mv(x1), dim=-1)
        x = torch.where(done[:, None], x, x1)                    # freeze
        rn = torch.where(done, rn, rn1)
        it = it + (~done).to(torch.int32)
        done = done | (rn <= atol)
        k += 1
    return x, rn, it, atol


def solve_gmres(matvec: Callable, b, *, init=None, tol: float = 1e-6,
                restart: int = 20, maxiter: int = 1000, ridge: float = 0.0,
                precond=None, return_info: bool = False, batch_ndim: int = 0):
    """Restarted GMRES.  Flattens instances to run batched Arnoldi cycles.

    ``maxiter`` is the total matvec budget, like the other iterative
    solvers; the cycle cap is ``ceil(maxiter / restart)``.  ``precond``
    applies as a left preconditioner; ``SolveInfo`` always reports the
    TRUE residual.  Converged instances skip further cycles.
    """
    b = canonical(b)
    matvec = _damped(matvec, ridge)
    matvec0, b0 = matvec, b
    M = _resolve_precond(precond, matvec, b, batch_ndim)
    if M is not None:
        inner = matvec
        matvec = lambda v: M(inner(v))
        b = M(b)

    view = ravel_view(matvec, b, batch_ndim)
    x0 = _flat_init(init, view.b, batch_ndim)
    x, rn, it, atol = _gmres_flat(view.mv, view.b, x0, tol=tol,
                                  restart=restart, maxiter=maxiter)
    x_tree = view.to_tree(x)
    if not return_info:
        return x_tree
    cutoff = atol
    if M is not None:   # report the true residual, not M(b - A x)
        rn = _tree_l2(_tree_sub(b0, matvec0(x_tree)), batch_ndim)
        cutoff = torch.clamp_min(tol * _tree_l2(b0, batch_ndim), 1e-30)
    info = SolveInfo(iterations=it, residual=rn, converged=rn <= cutoff)
    if batch_ndim == 0:
        info = _squeeze_info(info)
    return x_tree, info


def solve_dense_gmres(matvec: Callable, b, *, init=None, tol: float = 1e-6,
                      restart: int = 20, maxiter: int = 1000,
                      ridge: float = 0.0, precond=None,
                      return_info: bool = False, batch_ndim: int = 0):
    """Batched preconditioned GMRES for the nonsymmetric *dense* regime.

    Materializes the per-instance operators once (d ≤ ``MAX_DENSE_DIM``)
    and runs the shared restarted-Arnoldi core with each matvec as one
    batched (B, d, d) × (B, d) contraction.  ``"jacobi"`` reads the
    diagonal off the materialized operator; a callable ``precond`` applies
    as a left preconditioner.  ``SolveInfo`` reports the TRUE residual.
    """
    matvec = _damped(matvec, ridge)
    view = ravel_view(matvec, b, batch_ndim)
    d = view.b.shape[-1]
    if d > MAX_DENSE_DIM:   # guard BEFORE the d-matvec dense materialization
        raise ValueError(
            f"dense_gmres materializes dense systems; d={d} exceeds "
            f"MAX_DENSE_DIM={MAX_DENSE_DIM} — use a matrix-free solver")
    A, _ = materialize_batched(matvec, b, batch_ndim, view=view)

    def dense_mv(vf):                                   # (B, d) -> (B, d)
        return torch.einsum("bij,bj->bi", A, vf)

    M_tree = _resolve_precond(
        precond, matvec, b, batch_ndim,
        diag=view.to_tree(torch.diagonal(A, dim1=-2, dim2=-1)),
        materialized=A if view.batched else A[0])
    if M_tree is None:
        M_flat = None
    elif view.batched:
        M_flat = lambda vf: ravel_view(lambda t: t, M_tree(view.to_tree(vf)),
                                       1).b
    else:
        M_flat = lambda vf: _ravel1(M_tree(view.to_tree(vf)))[None]

    mv = dense_mv if M_flat is None else (lambda vf: M_flat(dense_mv(vf)))
    b_flat = view.b if M_flat is None else M_flat(view.b)
    x0 = _flat_init(init, view.b, batch_ndim)
    x, rn, it, atol = _gmres_flat(mv, b_flat, x0, tol=tol, restart=restart,
                                  maxiter=maxiter)
    x_tree = view.to_tree(x)
    if not return_info:
        return x_tree
    if M_flat is not None:   # report the true residual, not M(b - A x)
        rn = torch.linalg.vector_norm(view.b - dense_mv(x), dim=-1)
        atol = torch.clamp_min(
            tol * torch.linalg.vector_norm(view.b, dim=-1), 1e-30)
    info = SolveInfo(iterations=it, residual=rn, converged=rn <= atol)
    if batch_ndim == 0:
        info = _squeeze_info(info)
    return x_tree, info


# ---------------------------------------------------------------------------
# Direct and Neumann
# ---------------------------------------------------------------------------

def solve_lu(matvec: Callable, b, *, init=None, tol: float = 1e-6,
             ridge: float = 0.0, return_info: bool = False,
             batch_ndim: int = 0, **_):
    """Materialize A and solve densely (``torch.linalg.solve``)."""
    del init
    matvec = _damped(matvec, ridge)
    A, view = materialize_batched(matvec, b, batch_ndim)
    x = torch.linalg.solve(A, view.b[..., None])[..., 0]
    if return_info:
        rn = torch.linalg.vector_norm(
            view.b - torch.einsum("bij,bj->bi", A, x), dim=-1)
        atol = torch.clamp_min(
            tol * torch.linalg.vector_norm(view.b, dim=-1), 1e-30)
        it = torch.zeros_like(rn, dtype=torch.int32)
        # rn <= atol is False for NaN residuals (singular A) — reported
        info = SolveInfo(iterations=it, residual=rn, converged=rn <= atol)
        if batch_ndim == 0:
            info = _squeeze_info(info)
        return view.to_tree(x), info
    return view.to_tree(x)


def solve_neumann(matvec: Callable, b, *, init=None, maxiter: int = 10,
                  tol: float = 0.0, ridge: float = 0.0,
                  return_info: bool = False, batch_ndim: int = 0, **_):
    """Approximate (I - M)⁻¹ b ≈ Σ_{k<K} Mᵏ b where matvec(v) = v - M v.

    Interprets ``matvec`` as A = I - M and truncates the Neumann series
    ("Jacobian-free" / phantom-gradient style).  ``ridge`` damps A like the
    other solvers.  Instances whose series term drops below tolerance
    freeze while stragglers keep summing, and the loop ends once the whole
    batch is done.  The local default ``tol=0`` keeps the fixed-K
    truncation; ``solve()`` forwards its tol.
    """
    del init
    nb = batch_ndim
    b = canonical(b)
    matvec = _damped(matvec, ridge)
    atol = torch.clamp_min(tol * _tree_l2(b, nb), 1e-30)
    it = torch.zeros_like(atol, dtype=torch.int32)
    done = _tree_l2(b, nb) <= atol   # b = first series term
    acc = term = b
    k = 0
    while k < maxiter and not bool(torch.all(done)):
        term1 = _tree_sub(term, matvec(term))            # M v = v - A v
        acc = _tree_freeze(done, acc, _tree_add(acc, term1), nb)
        term = _tree_freeze(done, term, term1, nb)
        it = it + (~done).to(torch.int32)
        done = done | (_tree_l2(term, nb) <= atol)
        k += 1
    if not return_info:
        return acc
    rn = _tree_l2(_tree_sub(b, matvec(acc)), nb)
    # rn <= atol is False for NaN/diverged series — reported honestly
    return acc, SolveInfo(iterations=it, residual=rn, converged=rn <= atol)


# ---------------------------------------------------------------------------
# approximate backward application (fixed matvec budget, no convergence loop)
# ---------------------------------------------------------------------------

BACKWARD_MODES = ("exact", "one_step", "neumann_k", "jacobian_free")


def check_backward(backward: str, backward_iters: int = 8) -> None:
    """Validate a backward mode and its Neumann depth (ValueError)."""
    if backward not in BACKWARD_MODES:
        raise ValueError(f"unknown backward mode {backward!r}; expected "
                         f"one of {BACKWARD_MODES}")
    if backward == "neumann_k" and int(backward_iters) < 1:
        raise ValueError("backward='neumann_k' needs backward_iters >= 1;"
                         f" got {backward_iters}")


def approx_matvec_count(backward: str, backward_iters: int = 8) -> int:
    """Operator applications an approximate backward mode spends.

    ``jacobian_free`` → 0, ``one_step`` → 1, ``neumann_k`` → k.  The error
    estimate, when requested, costs one extra matvec on top of this.
    """
    if backward == "jacobian_free":
        return 0
    if backward == "one_step":
        return 1
    if backward == "neumann_k":
        return int(backward_iters)
    raise ValueError(f"unknown approximate backward mode {backward!r}; "
                     f"expected one of {BACKWARD_MODES[1:]}")


def approx_inverse_apply(matvec: Callable, b, *, backward: str,
                         backward_iters: int = 8, ridge: float = 0.0,
                         precond=None, batch_ndim: int = 0, tol: float = 1e-6,
                         error_estimate: bool = True,
                         return_info: bool = False):
    """Apply an O(k)-matvec polynomial approximation of ``A⁻¹`` to ``b``.

    The cheap-backward counterpart of ``route_solve``: a *fixed* matvec
    budget instead of a solver iterated to convergence.

    - ``"jacobian_free"``: ``u = b`` (0 matvecs, ``A ≈ I``; ``precond`` is
      ignored by construction).
    - ``"one_step"``: one preconditioned Richardson step from
      ``u₀ = M⁻¹b``, ``u = u₀ + M⁻¹(b − A u₀)`` (1 matvec); without a
      preconditioner ``u = 2b − A b``.
    - ``"neumann_k"``: exactly ``k = backward_iters`` preconditioned
      Richardson steps ``u ← u + M⁻¹(b − A u)`` from ``u₀ = M⁻¹b`` (k
      matvecs); without a preconditioner the truncated Neumann series
      ``Σ_{j≤k} (I − A)ʲ b``, which converges iff ``‖I − A‖ < 1`` (true
      for contractive fixed points ``A = I − ∂T``; stationarity systems
      ``A = −H`` need ``precond="jacobi"`` on diagonally dominant ``H``).

    ``ridge`` damps ``A`` as in the iterative solvers.  With
    ``return_info=True`` returns ``(u, SolveInfo)``: ``iterations`` is the
    matvec budget spent and, when ``error_estimate=True``,
    ``hypergrad_error_estimate`` is the relative residual
    ``‖b − A u‖ / ‖b‖`` (one extra matvec).
    """
    if backward == "exact" or backward not in BACKWARD_MODES:
        raise ValueError(f"approx_inverse_apply handles {BACKWARD_MODES[1:]}; "
                         f"got backward={backward!r} (route 'exact' through "
                         "route_solve)")
    nb = batch_ndim
    b = canonical(b)
    mv = _damped(matvec, ridge)
    if backward == "jacobian_free":
        u = b
    elif backward == "one_step":
        M = _resolve_precond(precond, mv, b, nb)
        if M is None:
            u = _tree_sub(tree_map(lambda x: 2.0 * x, b), mv(b))
        else:
            u0 = M(b)
            u = _tree_add(u0, M(_tree_sub(b, mv(u0))), batch_ndim=nb)
    else:  # neumann_k
        k = int(backward_iters)
        if k < 1:
            raise ValueError("backward='neumann_k' needs backward_iters >= 1")
        M = _resolve_precond(precond, mv, b, nb)
        step = (lambda r: r) if M is None else M
        u = b if M is None else M(b)
        for _ in range(k):
            u = _tree_add(u, step(_tree_sub(b, mv(u))), batch_ndim=nb)

    if not return_info:
        return u
    bn = _tree_l2(b, nb)
    spent = torch.full(bn.shape, approx_matvec_count(backward, backward_iters),
                       dtype=torch.int32, device=bn.device)
    if error_estimate:
        rn = _tree_l2(_tree_sub(b, mv(u)), nb)
        info = SolveInfo(iterations=spent, residual=rn,
                         converged=rn <= torch.clamp_min(tol * bn, 1e-30),
                         hypergrad_error_estimate=rn / torch.clamp_min(bn,
                                                                       1e-30))
    else:
        info = SolveInfo(iterations=spent,
                         residual=torch.full_like(bn, math.nan),
                         converged=torch.zeros(bn.shape, dtype=torch.bool,
                                               device=bn.device))
    if obs_events.observing():
        tags = _solve_event_tags(f"approx_{backward}", matvec, b,
                                 {"batch_ndim": nb})
        extra = ({"hypergrad_error_estimate": info.hypergrad_error_estimate}
                 if info.hypergrad_error_estimate is not None else {})
        obs_events.emit("solve", tags, iterations=info.iterations,
                        residual=info.residual, converged=info.converged,
                        **extra)
    return u, info


# ---------------------------------------------------------------------------
# batched-CG kernel (dense small-system regime)
# ---------------------------------------------------------------------------

MAX_DENSE_DIM = 512


def solve_pallas_cg(matvec: Callable, b, *, init=None, tol: float = 1e-6,
                    maxiter: int = 1000, ridge: float = 0.0, precond=None,
                    return_info: bool = False, batch_ndim: int = 0):
    """Materialize per-instance operators and run the batched-CG kernel.

    Dense small-system regime (d ≤ ``MAX_DENSE_DIM``): the whole batch of
    (d × d) systems is one launch of the hand-written kernel on CUDA
    tensors (``ref.py`` on CPU tensors), with per-instance convergence.
    The kernel's layout is ``"auto"``: it resolves through the tuning
    cache (``analysis.autotune.choose_layout``) per ``(backend, B, d,
    dtype)``, the kernel's own rule when the regime was never measured —
    so the solve service's buckets and every backward solve routed here
    take tuned layouts with no caller changes.  Always starts from zero
    and takes no preconditioner; ``iterations`` is reported as -1 (the
    kernel does not return its counts).
    """
    if init is not None:
        raise ValueError("pallas_cg always starts from zero; warm starts "
                         "are not supported — use method='cg' instead")
    if precond is not None:
        raise ValueError("pallas_cg does not support preconditioning")
    from repro_torch.kernels.batched_cg.ops import batched_cg  # lazy: cycle

    matvec = _damped(matvec, ridge)
    view = ravel_view(matvec, b, batch_ndim)
    d = view.b.shape[-1]
    if d > MAX_DENSE_DIM:   # guard BEFORE the d-matvec dense materialization
        raise ValueError(
            f"pallas_cg materializes dense systems; d={d} exceeds "
            f"MAX_DENSE_DIM={MAX_DENSE_DIM} — use a matrix-free solver")
    A, _ = materialize_batched(matvec, b, batch_ndim, view=view)
    x = batched_cg(A, view.b, tol=tol, maxiter=maxiter, device=A.device,
                   layout="auto")
    if return_info:
        r = view.b - torch.einsum("bij,bj->bi", A, x)
        rn = torch.linalg.vector_norm(r, dim=-1)
        atol = torch.clamp_min(
            tol * torch.linalg.vector_norm(view.b, dim=-1), 1e-30)
        info = SolveInfo(iterations=torch.full_like(rn, -1,
                                                    dtype=torch.int32),
                         residual=rn, converged=rn <= atol)
        if batch_ndim == 0:
            info = _squeeze_info(info)
        return view.to_tree(x), info
    return view.to_tree(x)


# ---------------------------------------------------------------------------
# SolverSpec registry and the uniform entry point
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SolverSpec:
    """A registered linear solver and its dispatch-relevant properties."""
    name: str
    fn: Callable
    symmetric_only: bool = False     # requires A symmetric (PSD)
    matrix_free: bool = True         # False: materializes A densely
    supports_precond: bool = False
    description: str = ""


_REGISTRY: dict = {}


def _solve_event_tags(name, matvec, b, kw) -> dict:
    """Static tags for a solve event: solver, B, d, dtype."""
    nb = kw.get("batch_ndim")
    if nb is None and isinstance(matvec, LinearOperator):
        nb = matvec.batch_ndim
    nb = int(nb or 0)
    leaves = tree_leaves(b)
    B, total, dtype = 1, 0, ""
    for leaf in leaves:
        total += int(leaf.numel()) if isinstance(leaf, torch.Tensor) else 1
    if leaves:
        first = leaves[0]
        dtype = str(getattr(first, "dtype", "")).replace("torch.", "")
        if nb >= 1 and getattr(first, "ndim", 0) >= 1:
            B = int(first.shape[0])
    return {"solver": str(name), "B": B, "d": total // max(B, 1),
            "dtype": dtype}


def _observed(name: str, fn: Callable) -> Callable:
    """Wrap a registry solver with solve telemetry.

    With observability off (the default) the wrapper costs one boolean
    check and calls the solver as asked.  With ``observe(enabled=True)``
    it forces ``return_info=True`` on the solver and emits the
    ``solve_start``/``solve`` event pair carrying the per-instance
    diagnostics, returning exactly what the caller asked for.
    """
    @functools.wraps(fn)
    def wrapper(matvec, b, **kw):
        if not obs_events.observing():
            return fn(matvec, b, **kw)
        tags = _solve_event_tags(name, matvec, b, kw)
        want_info = bool(kw.pop("return_info", False))
        try:
            x, info = fn(matvec, b, return_info=True, **kw)
        except TypeError:
            # a custom-registered solver outside the return_info contract:
            # announce the solve, run it uninstrumented rather than fail
            obs_events.emit("solve_start", tags)
            if want_info:
                return fn(matvec, b, return_info=True, **kw)
            return fn(matvec, b, **kw)
        extra = {}
        if getattr(info, "hypergrad_error_estimate", None) is not None:
            extra["hypergrad_error_estimate"] = info.hypergrad_error_estimate
        obs_events.emit_pair("solve_start", "solve", tags,
                             iterations=info.iterations,
                             residual=info.residual,
                             converged=info.converged, **extra)
        return (x, info) if want_info else x

    wrapper.__wrapped__ = fn
    return wrapper


def register_solver(name: str, fn: Callable, **attrs) -> SolverSpec:
    """Register (or override) a solver under ``name`` in the registry."""
    spec = SolverSpec(name=name, fn=_observed(name, fn), **attrs)
    _REGISTRY[name] = spec
    return spec


def get_spec(name: str) -> SolverSpec:
    """Look up a registered ``SolverSpec`` by name (ValueError if absent)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown linear solver {name!r}; "
                         f"available: {available_solvers()}") from None


def available_solvers():
    """Sorted names of every solver currently in the registry."""
    return sorted(_REGISTRY)


def get_solver(name_or_fn):
    """Resolve a registry name (or pass through a callable) to a solver fn,
    as registered (the telemetry seam unwrapped)."""
    if callable(name_or_fn):
        return name_or_fn
    fn = get_spec(name_or_fn).fn
    return getattr(fn, "__wrapped__", fn)


def solver_is_symmetric(name_or_fn) -> bool:
    """True when the routed solver asserts a symmetric operator (``cg``,
    ``pallas_cg``); the implicit-diff layer then builds its
    ``JacobianOperator`` with ``symmetric=True``.  Custom callables report
    False (general A)."""
    if callable(name_or_fn):
        return False
    return get_spec(name_or_fn).symmetric_only


def _check_operator_routing(spec: SolverSpec, A) -> None:
    """Symmetric-only solvers never receive an operator that declares
    itself nonsymmetric; the error names both sides of the mismatch."""
    if (isinstance(A, LinearOperator) and spec.symmetric_only
            and A.symmetric is False):
        raise ValueError(
            f"requested solver {spec.name!r} is symmetric-only, but the "
            f"operator {A!r} declares symmetric={A.symmetric} "
            f"(positive_definite={A.positive_definite}) — route a general "
            "solver (gmres/bicgstab/normal_cg/dense_gmres) instead, or fix "
            "the operator's declared flags if it really is symmetric")


def _resolve_auto(A, example, precond=None, init=None) -> str:
    """Pick a registry solver from operator structure + system size.

    The dense small-system regime (d ≤ ``MAX_DENSE_DIM``) auto-materializes:
    SPD operators take the ``pallas_cg`` kernel (``dense_gmres`` when a
    preconditioner or a warm start is requested), everything else
    ``dense_gmres``.  Above the crossover the solve stays matrix-free:
    ``cg`` for declared-SPD operators, ``normal_cg`` otherwise.
    ``example`` is one instance-shaped right-hand side.
    """
    spd = A.positive_definite if isinstance(A, LinearOperator) else False
    d = _ravel1(example).shape[0]
    if d <= MAX_DENSE_DIM:
        plain = precond is None and init is None
        return "pallas_cg" if spd and plain else "dense_gmres"
    return "cg" if spd else "normal_cg"


def route_solve(solve, matvec, b, *, tol: float = 1e-6, maxiter: int = 1000,
                ridge: float = 0.0, precond=None, init=None,
                return_info: bool = False):
    """Route one solve to a registry solver or a callable.

    The single dispatch point of the differentiation layer for both the
    tangent (``A dx = b``) and cotangent (``Aᵀ u = v``) systems — ``solve``
    is a registry name, ``"auto"``, or a bare callable ``fn(matvec, b, tol,
    maxiter, ridge)``.  A ``LinearOperator``'s symmetry flag is validated
    against the routed solver, ``"auto"`` dispatches on its structure, and
    ``"jacobi"`` derives from ``operator.diagonal()``.  A batch-aware
    operator (``batch_ndim == 1``) routes the whole batch as ONE masked
    solve.  ``init`` warm-starts the routed solver; ``return_info`` also
    returns the per-instance ``SolveInfo``.
    """
    requested = solve if isinstance(solve, str) else getattr(
        solve, "__name__", "custom")
    if solve == "auto":
        example = b
        if isinstance(matvec, LinearOperator) and matvec.batch_ndim == 1:
            example = tree_map(lambda l: l[0], b)
        solve = _resolve_auto(matvec, example, precond, init)
    if obs_events.observing():
        routed = solve if isinstance(solve, str) else getattr(
            solve, "__name__", "custom")
        obs_events.emit("dispatch",
                        dict(_solve_event_tags(routed, matvec, b, {}),
                             requested=requested))
    if callable(solve):
        if precond is not None:
            raise ValueError("precond requires a registry solver name; "
                             "bake it into the custom solve callable instead")
        if init is not None or return_info:
            raise ValueError("init/return_info require a registry solver "
                             "name; custom solve callables own their "
                             "initialization and diagnostics")
        return solve(matvec, b, tol=tol, maxiter=maxiter, ridge=ridge)
    spec = get_spec(solve)
    _check_operator_routing(spec, matvec)
    if precond is not None and not spec.supports_precond:
        raise ValueError(f"solver {spec.name!r} does not support "
                         "preconditioning; see SolverSpec.supports_precond")
    kwargs = dict(tol=tol, maxiter=maxiter, ridge=ridge)
    if precond is not None:
        kwargs["precond"] = precond
    if init is not None:
        kwargs["init"] = init
    if return_info:
        kwargs["return_info"] = True
    if isinstance(matvec, LinearOperator) and matvec.batch_ndim == 1:
        kwargs["batch_ndim"] = 1
    return spec.fn(matvec, b, **kwargs)


register_solver("cg", solve_cg, symmetric_only=True, supports_precond=True,
                description="conjugate gradient (A symmetric PSD)")
register_solver("normal_cg", solve_normal_cg, supports_precond=True,
                description="CG on the normal equations (general A)")
register_solver("bicgstab", solve_bicgstab, supports_precond=True,
                description="BiCGSTAB (general square A)")
register_solver("gmres", solve_gmres, supports_precond=True,
                description="restarted GMRES (general square A)")
register_solver("dense_gmres", solve_dense_gmres, supports_precond=True,
                matrix_free=False,
                description="batched dense GMRES (materializes A; "
                            "nonsymmetric, d<=512)")
register_solver("lu", solve_lu, matrix_free=False,
                description="dense direct solve (materializes A)")
register_solver("neumann", solve_neumann,
                description="truncated Neumann series for I - M")
register_solver("pallas_cg", solve_pallas_cg, symmetric_only=True,
                matrix_free=False,
                description="batched-CG kernel (Hopper CUDA on the card; "
                            "dense, d<=512)")


def solve(matvec: Callable, b, *, method="cg", batch_axes: Optional[int] = None,
          precond=None, tol: float = 1e-6, maxiter: int = 1000,
          ridge: float = 0.0, init=None, return_info: bool = False,
          **solver_kwargs):
    """Uniform entry point of the batched linear-solve engine.

    Args:
      matvec: a ``LinearOperator`` or a matvec closure.  With
        ``batch_axes`` set it maps *batched* pytrees to batched pytrees (the
        block-diagonal operator over all instances).  A batch-aware
        operator (``batch_ndim == 1``) implies ``batch_axes=0``.
      b: right-hand side pytree (batched along ``batch_axes`` if set).
      method: registry name, ``"auto"``, or a solver callable
        ``fn(matvec, b, **kw)`` (callables cannot take ``batch_axes``).
      batch_axes: ``None`` for a single system, or the int axis along
        which independent systems stack; the batch is solved by ONE masked
        loop.
      precond: ``None``, a callable v ↦ M⁻¹v, ``"jacobi"`` (diagonal), or
        ``"block_jacobi"`` (``LinearOperator`` only; blocks from the
        domain's pytree leaves or a ``BlockDiagonal``'s blocks).
      tol / maxiter / ridge / init: the usual solver controls.
      return_info: also return a ``SolveInfo``.
    """
    if isinstance(matvec, LinearOperator) and not callable(method):
        if batch_axes is None and matvec.batch_ndim == 1:
            batch_axes = 0
        expected = 0 if batch_axes is None else 1
        if matvec.batch_ndim != expected or batch_axes not in (None, 0):
            raise ValueError(
                f"operator batch_ndim={matvec.batch_ndim} is incompatible "
                f"with batch_axes={batch_axes}; batch-aware operators carry "
                "their batch on axis 0")
    if method == "auto":
        example = b
        if batch_axes is not None:
            example = tree_map(
                lambda l: l.select(int(batch_axes), 0), b)
        method = _resolve_auto(matvec, example, precond, init)
    if callable(method):
        if batch_axes is not None:
            raise ValueError("batch_axes requires a registry solver name; "
                             "custom callables must handle batching")
        if precond is not None or return_info:
            raise ValueError("precond/return_info require a registry solver "
                             "name; pass them to the callable directly")
        return method(matvec, b, tol=tol, maxiter=maxiter, ridge=ridge,
                      init=init, **solver_kwargs)

    spec = get_spec(method)
    _check_operator_routing(spec, matvec)
    if precond is not None and not spec.supports_precond:
        raise ValueError(f"solver {spec.name!r} does not support "
                         "preconditioning; see SolverSpec.supports_precond")
    if batch_axes is None:
        return spec.fn(matvec, b, init=init, tol=tol, maxiter=maxiter,
                       ridge=ridge, precond=precond,
                       return_info=return_info, **solver_kwargs)

    axis = int(batch_axes)
    if axis != 0:
        move_in = functools.partial(tree_map,
                                    lambda l: torch.movedim(l, axis, 0))
        move_out = functools.partial(tree_map,
                                     lambda l: torch.movedim(l, 0, axis))
        inner_mv = matvec
        matvec = lambda v: move_in(inner_mv(move_out(v)))
        b = move_in(b)
        init = move_in(init) if init is not None else None

    out = spec.fn(matvec, b, init=init, tol=tol, maxiter=maxiter,
                  ridge=ridge, precond=precond, return_info=return_info,
                  batch_ndim=1, **solver_kwargs)
    if axis == 0:
        return out
    if return_info:
        x, info = out
        return move_out(x), info
    return move_out(out)
