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

So ``torch.autograd.grad`` / ``backward`` / ``torch.func.grad`` and
``torch.func.jvp`` all work on the same wrapped function.  ``A`` is one
``JacobianOperator`` per call (matvec a JVP, rmatvec a VJP), certified
symmetric when the routed solver is symmetric-only.  Forward mode goes
through ``torch.func.jvp`` (the operator's matvec is itself a
``torch.func.jvp``, which the one-level ``torch.autograd.forward_ad``
cannot nest).

Mode selection (``mode=``): ``"auto"`` (both), ``"vjp"`` (reverse only;
forward mode raises), ``"jvp"`` (forward only; reverse mode raises).

Not ported yet (ROADMAP queue A.4): a ``vmap`` rule (so that
``torch.func.vmap`` of a gradient runs one batched backward solve), the
approximate backward modes (``backward != "exact"`` raises
``NotImplementedError``; ``backward_iters`` / ``error_estimate`` come with
them), ``system_operator`` and mesh placement (``sharding``).

Conventions: the wrapped solver has signature ``solver(init, *theta)`` and
returns ``x*`` (or ``(x*, aux)`` with ``has_aux=True``).  ``F``/``T`` take
``(x, *theta)`` and return a pytree with the structure of ``x``.  ``init``
and ``aux`` get no derivative; tensor leaves of the differentiable θ
arguments are the inputs the derivatives flow to.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Any, Callable, Optional, Tuple, Union

import torch
import torch.func

from repro_torch.core import linear_solve as ls
from repro_torch.core import operators as ops
from repro_torch.core._tree import (canonical, tree_flatten, tree_map,
                                    tree_unflatten)
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
    backward-solve settings (the solve service takes one via ``spec=``),
    not wrappable by itself.

    ``solve`` is a registry name, ``"auto"``, or a callable
    ``fn(matvec, b, *, tol, maxiter, ridge)``; ``tol`` / ``maxiter`` /
    ``ridge`` / ``precond`` are forwarded to it for both the tangent and
    the cotangent system.  ``has_aux=True``: the solver returns
    ``(x_star, aux)`` and ``aux`` gets no derivative.  ``nondiff_argnums``
    index the solver's ``*theta`` (0 = first after ``init``) for static
    non-tensor values passed through untouched.

    ``backward`` must be ``"exact"``: the approximate modes
    (``"one_step"``, ``"neumann_k"``, ``"jacobian_free"``) are not ported
    yet and raise ``NotImplementedError``.
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
    backward: str = "exact"

    def __post_init__(self):
        if self.optimality_fun is not None and \
                self.fixed_point_fun is not None:
            raise ValueError("provide at most one of optimality_fun / "
                             "fixed_point_fun, not both")
        nd = tuple(sorted(set(int(i) for i in self.nondiff_argnums)))
        if any(i < 0 for i in nd):
            raise ValueError("nondiff_argnums are 0-based indices into the "
                             f"theta arguments; got {self.nondiff_argnums}")
        object.__setattr__(self, "nondiff_argnums", nd)
        ls._require_exact_backward(self.backward)

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


# ---------------------------------------------------------------------------
# products with the implicit Jacobian (paper §2.1)
# ---------------------------------------------------------------------------

def _implicit_system_operator(F: Callable, x_star, theta_args: tuple,
                              solve) -> ops.LinearOperator:
    """``A = -∂₁F(x*, θ)`` as a ``JacobianOperator``, certified symmetric
    when the routed solver is symmetric-only (``cg``/``pallas_cg``)."""
    certified = solve != "auto" and ls.solver_is_symmetric(solve)
    return ops.JacobianOperator(lambda x: F(x, *theta_args), x_star,
                                negate=True,
                                symmetric=True if certified else None)


def _backward_apply(A, rhs, *, solve, tol, maxiter, ridge, precond,
                    error_estimate: bool, return_info: bool,
                    direction: str = "vjp"):
    """Solve ``A u = rhs`` through the registry (exact backward).

    With ``return_info=True`` returns ``(u, SolveInfo)``; ``error_estimate``
    adds the relative residual ``‖rhs − A u‖/‖rhs‖`` at one extra matvec.
    With observability on, emits the ``backward_start``/``backward_done``
    pair (``direction`` is "vjp" or "jvp").
    """
    observing = obs_events.observing()
    want_info = return_info
    if observing and not callable(solve):
        return_info = True
    if not return_info:
        out = ls.route_solve(solve, A, rhs, tol=tol, maxiter=maxiter,
                             ridge=ridge, precond=precond)
    else:
        u, info = ls.route_solve(solve, A, rhs, tol=tol, maxiter=maxiter,
                                 ridge=ridge, precond=precond,
                                 return_info=True)
        if error_estimate:
            mv = ls._damped(A, ridge)
            rn = ls._tree_l2(ls._tree_sub(rhs, mv(u)), 0)
            est = rn / torch.clamp_min(ls._tree_l2(rhs, 0), 1e-30)
            info = info._replace(hypergrad_error_estimate=est)
        out = (u, info)
    if not observing:
        return out
    tags = {"direction": direction, "backward": "exact", "matvec_budget": -1,
            "solver": solve if isinstance(solve, str) else "custom"}
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


def root_vjp(F: Callable, x_star, theta_args: tuple, cotangent,
             solve="normal_cg", tol: float = 1e-6, maxiter: int = 1000,
             ridge: float = 0.0, precond=None, backward: str = "exact",
             error_estimate: bool = False, return_info: bool = False):
    """VJP through the implicitly-defined root: returns vᵀ ∂x*(θ) per θ arg.

    Solve Aᵀ u = v  (A = -∂₁F),  then  vᵀJ = uᵀB  (B = ∂₂F): one linear
    solve serves all theta arguments.  ``theta_args`` are pytrees of
    tensors.  ``return_info=True`` returns ``(grads, SolveInfo)``.
    """
    ls._require_exact_backward(backward)
    x_star = canonical(x_star)
    A = _implicit_system_operator(F, x_star, theta_args, solve)
    out = _backward_apply(A.T, canonical(cotangent), solve=solve, tol=tol,
                          maxiter=maxiter, ridge=ridge, precond=precond,
                          error_estimate=error_estimate,
                          return_info=return_info, direction="vjp")
    u, info = out if return_info else (out, None)

    # uᵀ B = uᵀ ∂₂F : one more VJP, wrt the theta args
    _, vjp_theta = torch.func.vjp(
        lambda *targs: canonical(F(x_star, *targs)), *theta_args)
    return ls._maybe_info(vjp_theta(u), info, return_info)


def root_jvp(F: Callable, x_star, theta_args: tuple, tangents: tuple,
             solve="normal_cg", tol: float = 1e-6, maxiter: int = 1000,
             ridge: float = 0.0, precond=None, backward: str = "exact",
             error_estimate: bool = False, return_info: bool = False):
    """JVP through the implicitly-defined root: J · v.

    Solve A (Jv) = B v  with  Bv = ∂₂F · v  computed by one JVP of F in θ.
    """
    ls._require_exact_backward(backward)
    x_star = canonical(x_star)
    _, Bv = torch.func.jvp(lambda *targs: canonical(F(x_star, *targs)),
                           tuple(theta_args), tuple(tangents))
    A = _implicit_system_operator(F, x_star, theta_args, solve)
    return _backward_apply(A, Bv, solve=solve, tol=tol, maxiter=maxiter,
                           ridge=ridge, precond=precond,
                           error_estimate=error_estimate,
                           return_info=return_info, direction="jvp")


# ---------------------------------------------------------------------------
# the wrapper: one autograd.Function for both modes
# ---------------------------------------------------------------------------

def _is_diff_leaf(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and \
        (leaf.is_floating_point() or leaf.is_complex())


def _check_solver_arity(spec: ImplicitDiffSpec, n_theta: int):
    if spec.nondiff_argnums and spec.nondiff_argnums[-1] >= n_theta:
        raise ValueError(
            f"nondiff_argnums {spec.nondiff_argnums} out of range for a "
            f"solver called with {n_theta} theta argument(s)")


class _Call:
    """One call of a wrapped solver: the θ arguments split into the
    floating-point tensor leaves the derivatives flow to and everything
    else (nondiff arguments, non-tensor and integer leaves), plus what the
    forward produced (the x* tree spec, the aux)."""

    def __init__(self, spec: ImplicitDiffSpec, solver: Callable, mode: str,
                 init, theta: tuple):
        self.spec, self.solver, self.mode, self.init = spec, solver, mode, init
        self.theta = theta
        self.slots = []          # per theta arg: (leaves, treespec) or None
        diff_leaves = []
        for i, arg in enumerate(theta):
            if i in spec.nondiff_argnums:
                self.slots.append(None)
                continue
            leaves, treespec = tree_flatten(arg)
            self.slots.append((leaves, treespec))
            diff_leaves += [leaf for leaf in leaves if _is_diff_leaf(leaf)]
        self.diff_leaves = diff_leaves
        self.x_spec = None
        self.aux = None

    def theta_with(self, diff_leaves) -> tuple:
        """The θ arguments with their differentiable leaves replaced."""
        it = iter(diff_leaves)
        out = []
        for arg, slot in zip(self.theta, self.slots):
            if slot is None:
                out.append(arg)
                continue
            leaves, treespec = slot
            out.append(tree_unflatten(
                [next(it) if _is_diff_leaf(leaf) else leaf
                 for leaf in leaves], treespec))
        return tuple(out)

    def residual_of_leaves(self) -> Callable:
        """F(x, *diff_leaves): the residual with θ rebuilt from leaves."""
        residual = self.spec.residual_fun
        return lambda x, *leaves: residual(x, *self.theta_with(leaves))


class _ImplicitFunction(torch.autograd.Function):
    """x*(θ) with the implicit-function-theorem derivative in both modes."""

    @staticmethod
    def forward(call: _Call, *diff_leaves):
        out = call.solver(call.init, *call.theta_with(diff_leaves))
        x_star = out[0] if call.spec.has_aux else out
        call.aux = out[1] if call.spec.has_aux else None
        x_leaves, call.x_spec = tree_flatten(x_star)
        return tuple(leaf.detach() for leaf in x_leaves)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.call = inputs[0]
        ctx.n_theta = len(inputs) - 1
        ctx.save_for_backward(*inputs[1:], *output)
        ctx.save_for_forward(*inputs[1:], *output)

    @staticmethod
    def _split(ctx):
        saved = ctx.saved_tensors
        leaves = tuple(saved[:ctx.n_theta])
        x_star = tree_unflatten(list(saved[ctx.n_theta:]), ctx.call.x_spec)
        return leaves, x_star

    @staticmethod
    def backward(ctx, *x_bar):
        call = ctx.call
        if call.mode == "jvp":
            raise RuntimeError("this solver was wrapped with mode='jvp' "
                               "(forward mode only); reverse mode is not "
                               "available — wrap with mode='auto' or 'vjp'")
        leaves, x_star = _ImplicitFunction._split(ctx)
        ct = tree_unflatten(list(x_bar), call.x_spec)
        grads = root_vjp(call.residual_of_leaves(), x_star, leaves, ct,
                         solve=call.spec.solve,
                         **call.spec.routing_kwargs())
        return (None,) + tuple(grads)

    @staticmethod
    def jvp(ctx, _call_dot, *theta_dot):
        call = ctx.call
        if call.mode == "vjp":
            raise RuntimeError("this solver was wrapped with mode='vjp' "
                               "(reverse mode only); forward mode is not "
                               "available — wrap with mode='auto' or 'jvp'")
        leaves, x_star = _ImplicitFunction._split(ctx)
        tangents = tuple(torch.zeros_like(leaf) if t is None else t
                         for leaf, t in zip(leaves, theta_dot))
        dx = root_jvp(call.residual_of_leaves(), x_star, leaves, tangents,
                      solve=call.spec.solve, **call.spec.routing_kwargs())
        return tuple(tree_flatten(dx)[0])


MODES = ("auto", "vjp", "jvp")


def implicit_diff(spec: Union[ImplicitDiffSpec, Callable, None] = None, *,
                  mode: str = "auto", **spec_kwargs) -> Callable:
    """Attach implicit differentiation to a solver, per an ``ImplicitDiffSpec``.

    ``implicit_diff(spec)(solver)`` returns a function with the solver's
    signature ``(init, *theta)`` whose derivatives in the differentiable
    ``theta`` arguments come from the implicit function theorem on the
    spec's optimality mapping — never from differentiating through the
    solver's iterations.

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

    def wrapper(solver: Callable) -> Callable:
        @functools.wraps(solver)
        def fun(init, *theta):
            _check_solver_arity(spec, len(theta))
            call = _Call(spec, solver, mode, init, theta)
            x_leaves = _ImplicitFunction.apply(call, *call.diff_leaves)
            x_star = tree_unflatten(list(x_leaves), call.x_spec)
            return (x_star, call.aux) if spec.has_aux else x_star

        fun.spec = spec
        fun.mode = mode
        return fun

    return wrapper
