"""Stochastic inner solvers on the ``IterativeSolver`` seam (PyTorch).

Counterpart of ``repro.stochastic.solvers``.  The deterministic runtime
iterates an optimality mapping ``F(x, θ)`` full-batch; this module
declares optimality **in expectation** over a data distribution,

    F(x, θ) = E_b[ ∇₁ fun(x, b, θ) ] = 0,

with ``fun(params, batch, *theta)`` a minibatch objective whose
uniform-minibatch expectation equals the full-batch objective (use
per-example *means*, not sums — the contract every instance below relies
on).  Objectives return scalar tensors (gradients are ``torch.func.grad``).

Pieces:

  * :class:`StochasticSolver` — the protocol: ``init_state(params,
    *theta)``, ``update(params, state, batch, *theta)`` (one minibatch
    step), and ``optimality_fun`` = the full-batch gradient.  What the
    deterministic ``IterativeSolver`` provides (``run()`` self-wrapping
    with implicit diff, ``diff_spec()``, registry-routed backward solves,
    the approximate backward modes, the ``vmap`` rule of the backward
    solve) is inherited.
  * :func:`run_stochastic` — the shared loop: a Python loop over a
    ``(steps, B)`` index plan that the sampler computes on the host and
    that is copied to the data's device ONCE, before the loop.  The loop
    body then does no host work and reads nothing back, so it is
    restart-safe and ``torch.func.vmap`` over θ batches the whole inner
    loop.  Polyak / EMA iterate averaging makes the returned point — the
    one implicit diff linearizes at — the *averaged* iterate, and a final
    full-batch residual is the honest convergence diagnostic in
    ``OptInfo``.
  * :class:`SGD` / :class:`MomentumSGD` / :class:`Adam` — the instances.

Implicit differentiation at the averaged iterate defaults to a *sampled*
system: ``diff_spec()`` carries a ``system_operator`` factory building a
:class:`repro_torch.core.SampledJacobianOperator` whose matvec averages
Hessian-vector products over ``backward_batches`` resampled minibatches
(``backward_data="sampled"``; ``"full"`` restores the exact full-batch
operator).  The backward *treatment* defaults to ``neumann_k`` — running
CG to 1e-12 on a noisy sampled operator is false precision; spend a
fixed matvec budget instead and read the honesty check off
``estimate_hypergrad_error`` (measured against the **full-batch**
residual, so sampling error is visible too).

As in the port's other solver states, ``iter_num`` is a host ``int``:
a stepsize schedule receives the 0-based step as a Python int (the JAX
package passes an int array), so its arithmetic is the host's float64
whatever the iterate's dtype, and every instance of a ``vmap`` batch is at
the same step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch.core import diff_api
from repro_torch.core import operators as ops
from repro_torch.core._tree import tree_leaves, tree_map
from repro_torch.core.linear_solve import _tree_l2, _tree_sub
from repro_torch.core.optimality import _grad
from repro_torch.core.solver_runtime import (IterativeSolver, OptInfo,
                                             _inf_like, _kw, _tree_axpy)
from repro_torch.observability import events as obs_events
from repro_torch.stochastic.sampler import MinibatchSampler


AVERAGING_MODES = ("polyak", "ema", "last")
BACKWARD_DATA_MODES = ("sampled", "full")


# ---------------------------------------------------------------------------
# the shared loop
# ---------------------------------------------------------------------------

def _update_average(solver: "StochasticSolver", avg, params, iter_num: int):
    """One averaging step; ``iter_num`` counts completed updates (≥ 1)."""
    if solver.averaging == "last":
        return params
    if solver.averaging == "ema":
        d = solver.ema_decay
        return tree_map(lambda a, p: d * a + (1.0 - d) * p, avg, params)
    if solver.averaging == "polyak":
        # tail averaging: reset until ``average_from`` updates have burned
        # in, then the running mean over the remaining m = k - from steps
        if iter_num <= solver.average_from:
            return params
        m = iter_num - solver.average_from
        return tree_map(lambda a, p: a + (p - a) / m, avg, params)
    raise ValueError(f"unknown averaging mode {solver.averaging!r}; "
                     f"expected one of {AVERAGING_MODES}")


def run_stochastic(solver: "StochasticSolver", init_params, *theta,
                   steps: Optional[int] = None, start_step: int = 0,
                   init_state=None, init_average=None):
    """Drive ``solver`` for a step budget; return ``(x̄, OptInfo)``.

    The minibatch index plan ``(steps, B)`` is computed on the host by
    the solver's sampler — a pure function of ``(seed, step)`` — and
    copied to the data's device once; each step gathers its batch there.
    Consequences:

      * **restart safety** — ``start_step=k`` with the step-``k``
        ``init_state``/``init_average`` replays the exact tail of a
        longer run, bit for bit;
      * **vmap safety** — the loop reads nothing back from the device, so
        ``torch.func.vmap`` over θ runs the batch through one loop.

    The returned iterate is the Polyak/EMA average (per
    ``solver.averaging``) — the point implicit differentiation linearizes
    at — and ``OptInfo.error`` is the **full-batch** optimality residual
    at that point (per-step ``state.error`` is only the cheap
    minibatch-gradient proxy).
    """
    sampler = solver.sampler
    if sampler is None:
        raise ValueError(f"{type(solver).__name__} needs a MinibatchSampler "
                         "(sampler=...) to run")
    if steps is None:
        steps = solver.num_steps()
    device = tree_leaves(sampler.data)[0].device
    plan = torch.as_tensor(sampler.batch_indices(start_step, steps),
                           device=device)
    params = init_params
    state = solver.init_state(init_params, *theta) if init_state is None \
        else init_state
    avg = init_params if init_average is None else init_average
    for idx in plan:
        params, state = solver.update(params, state, sampler.gather(idx),
                                      *theta)
        avg = _update_average(solver, avg, params, state.iter_num)
    error = solver.l2_optimality_error(avg, *theta)
    info = OptInfo(iterations=torch.as_tensor(state.iter_num,
                                              device=error.device),
                   error=error, converged=error <= solver.tol)
    # emitted after the loop, never inside it: the loop body stays free
    # of host work (a no-op unless observability is enabled)
    obs_events.emit("converged", {"solver": type(solver).__name__,
                                  "averaging": str(solver.averaging)},
                    iterations=info.iterations, error=info.error,
                    converged=info.converged)
    return avg, info


# ---------------------------------------------------------------------------
# the protocol
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class StochasticSolver(IterativeSolver):
    """Minibatch solver protocol: optimality declared in expectation.

    ``fun(params, batch, *theta)`` is the minibatch objective; it MUST be
    a per-example mean so that its expectation over uniform minibatches
    equals the full-batch objective — then the full-batch gradient
    ``optimality_fun`` is exactly the expectation residual the implicit
    function theorem is applied to.  ``sampler`` supplies deterministic
    ``(seed, step)``-keyed minibatches (and the dataset itself, for the
    full-batch residual/operator).

    Budget: ``steps`` (exact update count) or ``epochs`` (×
    ``sampler.num_batches``); defaults to one epoch.  ``averaging``
    selects the returned/differentiated iterate: ``"polyak"`` (running
    mean from update ``average_from``+1 on), ``"ema"`` (decay
    ``ema_decay``), or ``"last"``.

    Backward: ``backward_data="sampled"`` (default) builds the implicit
    system from a ``SampledJacobianOperator`` over ``backward_batches``
    minibatches of the sampler's backward stream; ``"full"`` uses the
    exact full-batch Jacobian.  The treatment defaults to
    ``backward="neumann_k"`` with ``precond="jacobi"``; ``solve`` defaults
    to ``"cg"``: each per-batch residual is a gradient mapping, so the
    (sampled or full) system is symmetric.

    Subclasses implement ``init_state(params, *theta)`` and
    ``update(params, state, batch, *theta) -> (params, state)`` — note
    the extra ``batch`` argument relative to the deterministic protocol.
    """
    fun: Callable = None
    sampler: MinibatchSampler = None
    steps: Optional[int] = _kw(None)
    epochs: Optional[int] = _kw(None)
    averaging: str = _kw("polyak")
    ema_decay: float = _kw(0.99)
    average_from: int = _kw(0)
    backward_data: str = _kw("sampled")
    backward_batches: int = _kw(4)
    # neumann_k NEEDS the Jacobi preconditioner here: the implicit system
    # is a stationarity declaration (A = −H), where unpreconditioned
    # Richardson diverges — M⁻¹ = diag(A)⁻¹ flips the sign back and
    # contracts for reasonably-conditioned Hessians.  diag(A) costs d
    # probing matvecs of the sampled operator, derived once per backward.
    solve: Union[str, Callable] = _kw("cg")
    backward: str = _kw("neumann_k")
    precond: Any = _kw("jacobi")

    # solve_bilevel detects stochastic solvers through this marker
    is_stochastic = True

    # -- protocol ----------------------------------------------------------
    def minibatch_grad(self, params, batch, *theta):
        """∇₁ fun at one minibatch — the stochastic residual sample."""
        return _grad(self.fun)(params, batch, *theta)

    def optimality_fun(self, params, *theta):
        """The expectation residual: the full-batch gradient over
        ``sampler.data`` (what implicit diff linearizes)."""
        return _grad(self.fun)(params, self.sampler.data, *theta)

    def update(self, params, state, batch, *theta):
        """One minibatch step: ``(params, state, batch) → (params, state)``."""
        raise NotImplementedError

    # -- budget ------------------------------------------------------------
    def num_steps(self) -> int:
        """Resolve the update budget (``steps`` wins; default one epoch)."""
        if self.steps is not None:
            return int(self.steps)
        if self.epochs is not None:
            return int(self.epochs) * self.sampler.num_batches
        return self.sampler.num_batches

    # -- the loop ----------------------------------------------------------
    def _iterate(self, init_params, *theta):
        """The raw stochastic loop (no implicit diff attached)."""
        return run_stochastic(self, init_params, *theta)

    # -- implicit diff at the averaged iterate -----------------------------
    def _system_operator(self, x_star, theta_args, *, symmetric=None):
        """``ImplicitDiffSpec.system_operator`` factory: the sampled
        implicit system ``A = -∂₁F`` as a ``SampledJacobianOperator``
        averaging Hessian-vector products over ``backward_batches``
        minibatches from the sampler's backward stream.  Symmetry is
        certified structurally: each per-batch residual is a gradient
        mapping, so every sample (hence the mean) is a Hessian."""
        del symmetric  # structural certification is strictly stronger
        batches = self.sampler.backward_batches(self.backward_batches)

        def residual(x, batch):
            return _grad(self.fun)(x, batch, *theta_args)

        return ops.SampledJacobianOperator(residual, x_star, batches,
                                           negate=True, symmetric=True)

    def diff_spec(self) -> diff_api.ImplicitDiffSpec:
        """The inherited spec, plus the sampled system operator when
        ``backward_data="sampled"``."""
        if self.backward_data not in BACKWARD_DATA_MODES:
            raise ValueError(
                f"unknown backward_data {self.backward_data!r}; expected "
                f"one of {BACKWARD_DATA_MODES}")
        spec = super().diff_spec()
        if self.backward_data == "sampled":
            spec = spec.replace(system_operator=self._system_operator)
        return spec

    def estimate_hypergrad_error(self, params, *theta, cotangent=None):
        """Relative residual of the cotangent system — measured against
        the **full-batch** operator.

        Replays the configured backward treatment (sampled operator,
        approximate mode) to get ``u``, then spends one full-batch
        Hessian-vector product on ``‖v − Aᵀ_full u‖/‖v‖`` — so the
        estimate accounts for BOTH the truncation error of the
        approximate backward AND the minibatch sampling error of the
        operator, unlike the base class which measures against the same
        (possibly sampled) operator it solved with.
        """
        if cotangent is None:
            cotangent = tree_map(torch.ones_like, params)
        spec = self.diff_spec()
        A = diff_api._implicit_system_operator(
            spec.residual_fun, params, theta, spec.solve,
            system_operator=spec.system_operator)
        precond = spec.precond
        if isinstance(precond, str):
            damped = ops.RidgeShifted(A, spec.ridge) if spec.ridge else A
            make = (ops.jacobi_preconditioner_from if precond == "jacobi"
                    else ops.block_jacobi_preconditioner)
            precond = make(damped)
        u = diff_api._backward_apply(
            A.T, cotangent, solve=spec.solve, tol=spec.tol,
            maxiter=spec.maxiter, ridge=spec.ridge, precond=precond,
            backward=spec.backward, backward_iters=spec.backward_iters,
            batch_ndim=0, error_estimate=False, return_info=False)
        A_full = ops.JacobianOperator(
            lambda x: self.optimality_fun(x, *theta), params, negate=True,
            symmetric=True)
        residual = _tree_sub(cotangent, A_full.rmatvec(u))
        return _tree_l2(residual) / torch.clamp_min(_tree_l2(cotangent),
                                                    1e-30)


# ---------------------------------------------------------------------------
# instances
# ---------------------------------------------------------------------------

def _resolve_stepsize(stepsize, iter_num):
    """A constant or an ``fn(step) -> η`` schedule (step = 0-based)."""
    return stepsize(iter_num) if callable(stepsize) else stepsize


class SGDState(NamedTuple):
    """Iteration state of ``SGD``; ``error`` is the minibatch-gradient
    norm (cheap proxy — ``run_stochastic`` reports the full-batch
    residual)."""
    iter_num: int
    error: torch.Tensor


@dataclasses.dataclass(eq=False)
class SGD(StochasticSolver):
    """Plain SGD: ``x ← x − η(k) · ∇fun(x, batch, θ)``.

    ``stepsize`` is a constant or a schedule ``fn(step) -> η`` (e.g.
    ``lambda k: eta0 / (1 + gamma * k)`` — with Polyak averaging the
    classic variance-killing combination on strongly-convex problems).
    """
    stepsize: Union[float, Callable] = 1e-2

    def init_state(self, params, *theta):
        """See ``IterativeSolver.init_state``."""
        return SGDState(0, _inf_like(params))

    def update(self, params, state, batch, *theta):
        """See ``StochasticSolver.update``."""
        g = self.minibatch_grad(params, batch, *theta)
        eta = _resolve_stepsize(self.stepsize, state.iter_num)
        new_params = _tree_axpy(params, g, -eta)
        return new_params, SGDState(state.iter_num + 1, _tree_l2(g))


class MomentumSGDState(NamedTuple):
    """Iteration state of ``MomentumSGD`` (Polyak heavy-ball velocity)."""
    iter_num: int
    error: torch.Tensor
    velocity: Any


@dataclasses.dataclass(eq=False)
class MomentumSGD(StochasticSolver):
    """Heavy-ball SGD: ``v ← μv + g``; ``x ← x − η(k) · v``."""
    stepsize: Union[float, Callable] = 1e-2
    momentum: float = 0.9

    def init_state(self, params, *theta):
        """See ``IterativeSolver.init_state``."""
        zeros = tree_map(torch.zeros_like, params)
        return MomentumSGDState(0, _inf_like(params), zeros)

    def update(self, params, state, batch, *theta):
        """See ``StochasticSolver.update``."""
        g = self.minibatch_grad(params, batch, *theta)
        v = _tree_axpy(g, state.velocity, self.momentum)
        eta = _resolve_stepsize(self.stepsize, state.iter_num)
        new_params = _tree_axpy(params, v, -eta)
        return new_params, MomentumSGDState(state.iter_num + 1,
                                            _tree_l2(g), v)


class AdamState(NamedTuple):
    """Iteration state of ``Adam`` (first/second moment trees)."""
    iter_num: int
    error: torch.Tensor
    m: Any
    v: Any


@dataclasses.dataclass(eq=False)
class Adam(StochasticSolver):
    """Adam with bias correction (Kingma & Ba) on the minibatch gradient.

    Adam's fixed points are exactly the stationary points of the expected
    objective, so the expectation-form optimality contract — and implicit
    differentiation at the averaged iterate — is unchanged; only the path
    there differs from SGD.
    """
    stepsize: Union[float, Callable] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init_state(self, params, *theta):
        """See ``IterativeSolver.init_state``."""
        zeros = tree_map(torch.zeros_like, params)
        return AdamState(0, _inf_like(params), zeros, zeros)

    def update(self, params, state, batch, *theta):
        """See ``StochasticSolver.update``."""
        g = self.minibatch_grad(params, batch, *theta)
        t = state.iter_num + 1
        m = tree_map(lambda mi, gi: self.b1 * mi + (1.0 - self.b1) * gi,
                     state.m, g)
        v = tree_map(lambda vi, gi: self.b2 * vi + (1.0 - self.b2) * gi * gi,
                     state.v, g)
        c1 = 1.0 - self.b1 ** float(t)
        c2 = 1.0 - self.b2 ** float(t)
        eta = _resolve_stepsize(self.stepsize, state.iter_num)
        new_params = tree_map(
            lambda p, mi, vi: p - eta * (mi / c1) /
            (torch.sqrt(vi / c2) + self.eps), params, m, v)
        return new_params, AdamState(t, _tree_l2(g), m, v)
