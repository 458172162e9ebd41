"""The port's solver runtime against the JAX package's, solver by solver.

Each of the nine solvers runs on the problems of
``tests/test_solver_runtime.py`` (same step sizes, ``maxiter`` and
``tol``), with inputs made by numpy from a seed and fed to both packages
in float64.  Forward: x* within 1e-10 and ``OptInfo.iterations`` exactly
equal.  Derivatives through ``run()``: ``torch.autograd.grad`` against
``jax.grad`` and ``torch.func.jvp`` against ``jax.jvp`` within 1e-8 (the
backward solve at ``linsolve_tol=1e-12`` in both packages, so that the two
normal-CG runs agree far below that).  Also: ``converged`` is False on NaN
and at ``maxiter``; the backward solve goes through the registry name it
was given; the loop runs under ``no_grad``; mesh placement (not ported)
raises ``NotImplementedError``.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.func

from repro.core import diff_api as jdiff
from repro.core import projections as jproj
from repro.core import prox as jprox
from repro.core import solver_runtime as jrt
from repro.core import solvers as jsolvers
from repro_torch.core import diff_api as tdiff
from repro_torch.core import linear_solve as tls
from repro_torch.core import projections as tproj
from repro_torch.core import prox as tprox
from repro_torch.core import solver_runtime as trt
from repro_torch.core import solvers as tsolvers

XTOL = 1e-10
GTOL = 1e-8

JAX = types.SimpleNamespace(rt=jrt, proj=jproj, prox=jprox, arr=jnp.asarray)
TORCH = types.SimpleNamespace(rt=trt, proj=tproj, prox=tprox,
                              arr=torch.from_numpy)


def _data(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in shapes]


def _orthogonal(seed, d, scale):
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((d, d)))
    return scale * q


def _ridge(ns, Xn, yn):
    X, y = ns.arr(Xn), ns.arr(yn)
    return lambda x, t: 0.5 * ((X @ x - y) ** 2).sum() + \
        0.5 * t * (x ** 2).sum()


def _lip(Xn, extra=0.0):
    return float(np.linalg.eigvalsh(Xn.T @ Xn).max()) + extra


# Each case: (build(ns, **solver_kw) -> solver, init, theta, pack) where
# pack(t) is the tuple of run() arguments after init.
def _gd(ns, **kw):
    Xn, yn = _data(0, (20, 5), (20,))
    return ns.rt.GradientDescent(_ridge(ns, Xn, yn), stepsize=1.0 / _lip(
        Xn, 2.0), maxiter=5000, tol=1e-13, **kw)


def _gd_linesearch(ns, **kw):
    # tol 1e-7, not the reference test's 1e-10: below ~1e-8 the Armijo test
    # compares f(x_try) with f(x) - 0.5·η·‖∇f‖² where the second term is
    # under f's rounding, so the halving decisions (and the path to
    # maxiter) depend on the summation order of each package; the 1e-10 run
    # is test_gd_linesearch_at_reference_tol_matches_jax
    Q = ns.arr(np.diag([1.0, 50.0]))
    return ns.rt.GradientDescent(lambda x, t: 0.5 * x @ Q @ x - t @ x,
                                 stepsize=1.0, linesearch=True, maxiter=2000,
                                 tol=1e-7, **kw)


def _newton(ns, **kw):
    Xn, yn = _data(0, (20, 5), (20,))
    return ns.rt.Newton(_ridge(ns, Xn, yn), maxiter=30, tol=1e-12, **kw)


def _lbfgs(ns, **kw):
    Xn, yn = _data(0, (20, 5), (20,))
    return ns.rt.LBFGS(_ridge(ns, Xn, yn), maxiter=400, tol=1e-12,
                       stepsize=0.02, **kw)


def _proximal_gradient(ns, **kw):
    Xn, yn = _data(1, (20, 5), (20,))
    X, y = ns.arr(Xn), ns.arr(yn)
    return ns.rt.ProximalGradient(
        lambda x, tf: 0.5 * ((X @ x - y) ** 2).sum(),
        lambda v, lam, s: ns.prox.prox_lasso(v, lam, s),
        stepsize=1.0 / _lip(Xn), maxiter=20000, tol=1e-14, **kw)


def _projected_gradient(ns, **kw):
    return ns.rt.ProjectedGradient(
        lambda x, t: 0.5 * ((x - t) ** 2).sum(),
        lambda v, tp: ns.proj.projection_simplex(v), stepsize=0.5,
        maxiter=5000, tol=1e-14, **kw)


def _mirror_descent(ns, **kw):
    return ns.rt.MirrorDescent(
        lambda x, t: 0.5 * ((x - t) ** 2).sum(),
        lambda v, tp: ns.proj.projection_simplex_kl(v), stepsize=0.9,
        maxiter=5000, tol=1e-13, **kw)


def _bcd(ns, **kw):
    (Xn,) = _data(2, (12, 4))
    X, y = ns.arr(Xn), ns.arr(np.ones(12))
    return ns.rt.BlockCoordinateDescent(
        lambda x, tf: 0.5 * ((X @ x.ravel() - y) ** 2).sum(),
        lambda v, lam, s: ns.prox.prox_lasso(v, lam, s),
        stepsize=1.0 / _lip(Xn), maxiter=5000, tol=1e-14, **kw)


def _affine_map(ns):
    M = ns.arr(_orthogonal(3, 4, 0.5))
    return lambda x, t: M @ x + t


def _fixed_point(ns, **kw):
    return ns.rt.FixedPointIteration(_affine_map(ns), maxiter=500, tol=1e-13,
                                     **kw)


def _anderson(ns, **kw):
    return ns.rt.AndersonAcceleration(_affine_map(ns), maxiter=100,
                                      tol=1e-13, **kw)


_ONE = (lambda t: (t,))
CASES = {
    "gradient_descent": (_gd, np.zeros(5), np.array(1.0), _ONE),
    "gd_linesearch": (_gd_linesearch, np.ones(2), np.array([1.0, 2.0]),
                      _ONE),
    "newton": (_newton, np.zeros(5), np.array(1.0), _ONE),
    "lbfgs": (_lbfgs, np.zeros(5), np.array(1.0), _ONE),
    "proximal_gradient": (_proximal_gradient, np.zeros(5), np.array(0.5),
                          lambda t: ((None, t),)),
    "projected_gradient": (_projected_gradient, np.ones(3) / 3,
                           np.array([0.2, 0.8, 0.4]), lambda t: ((t, None),)),
    "mirror_descent": (_mirror_descent, np.ones(3) / 3,
                       np.array([0.2, 0.8, 0.4]), lambda t: ((t, None),)),
    "block_coordinate_descent": (_bcd, np.zeros((2, 2)), np.array(0.1),
                                 lambda t: ((None, t),)),
    "fixed_point_iteration": (_fixed_point, np.zeros(4), np.ones(4), _ONE),
    "anderson_acceleration": (_anderson, np.zeros(4), np.ones(4), _ONE),
}


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax(name):
    build, init, theta, pack = CASES[name]
    xj, ij = build(JAX).run(jnp.asarray(init), *pack(jnp.asarray(theta)))
    xt, it = build(TORCH).run(torch.from_numpy(init),
                              *pack(torch.from_numpy(theta)))
    np.testing.assert_allclose(_np(xt), np.asarray(xj), atol=XTOL, rtol=0)
    assert int(it.iterations) == int(ij.iterations)
    assert bool(it.converged) == bool(ij.converged)
    assert it.error.dtype == torch.float64


@pytest.mark.parametrize("name", list(CASES))
def test_grad_and_jvp_match_jax(name):
    build, init, theta, pack = CASES[name]
    sj = build(JAX, linsolve_tol=1e-12)
    st = build(TORCH, linsolve_tol=1e-12)
    i_j, i_t = jnp.asarray(init), torch.from_numpy(init)

    def loss_j(t):
        return jnp.sum(sj.run(i_j, *pack(t))[0] ** 2)

    def loss_t(t):
        return (st.run(i_t, *pack(t))[0] ** 2).sum()

    gj = jax.grad(loss_j)(jnp.asarray(theta))
    t = torch.from_numpy(theta).requires_grad_()
    (gt,) = torch.autograd.grad(loss_t(t), t)
    np.testing.assert_allclose(_np(gt), np.asarray(gj), atol=GTOL, rtol=0)

    direction = np.linspace(0.5, 1.5, theta.size).reshape(theta.shape)
    _, tj = jax.jvp(lambda t: sj.run(i_j, *pack(t))[0],
                    (jnp.asarray(theta),), (jnp.asarray(direction),))
    _, tt = torch.func.jvp(lambda t: st.run(i_t, *pack(t))[0],
                           (torch.from_numpy(theta),),
                           (torch.from_numpy(direction),))
    np.testing.assert_allclose(_np(tt), np.asarray(tj), atol=GTOL, rtol=0)


def test_gd_linesearch_at_reference_tol_matches_jax():
    """At the reference test's tol 1e-10 the Armijo halvings fall under f's
    rounding (see ``_gd_linesearch``): both packages stall near 1e-8 and
    run to ``maxiter`` unconverged, on paths that split, so x* agrees with
    JAX and with the closed form Q⁻¹θ = (1, 0.04) only to the stall's
    ‖∇f‖ / λ_min(Q) ≈ 1e-8, not to 1e-10."""
    init, theta = np.ones(2), np.array([1.0, 2.0])
    runs = []
    for ns in (JAX, TORCH):
        Q = ns.arr(np.diag([1.0, 50.0]))
        solver = ns.rt.GradientDescent(lambda x, t: 0.5 * x @ Q @ x - t @ x,
                                       stepsize=1.0, linesearch=True,
                                       maxiter=2000, tol=1e-10,
                                       implicit_diff=False)
        runs.append(solver.run(ns.arr(init), ns.arr(theta)))
    (xj, ij), (xt, it) = runs
    assert int(it.iterations) == int(ij.iterations) == 2000
    assert not bool(it.converged) and not bool(ij.converged)
    assert 1e-10 < float(it.error) < 1e-8
    np.testing.assert_allclose(_np(xt), np.asarray(xj), atol=1e-8, rtol=0)
    np.testing.assert_allclose(_np(xt), [1.0, 0.04], atol=1e-8, rtol=0)


def test_loop_runs_under_no_grad_and_func_grad_ignores_it():
    build, init, theta, pack = CASES["gradient_descent"]
    solver = build(TORCH)
    x_free, _ = solver.run(torch.from_numpy(init),
                           *pack(torch.from_numpy(theta)))
    with torch.no_grad():
        x_ng, info = solver.run(torch.from_numpy(init),
                                *pack(torch.from_numpy(theta)))
    assert bool(info.converged)
    assert torch.equal(x_ng, x_free)
    assert not x_ng.requires_grad


def test_lbfgs_instance_reused_across_structures():
    def f(tree, t):
        return sum(0.5 * ((leaf - t) ** 2).sum() for leaf in tree.values())

    solver = trt.LBFGS(f, maxiter=200, tol=1e-12, stepsize=0.5)
    t64 = lambda v: torch.tensor(v, dtype=torch.float64)
    xa, _ = solver.run({"a": torch.zeros(3, dtype=torch.float64)}, t64(2.0))
    xb, _ = solver.run({"u": torch.zeros(2, 2, dtype=torch.float64),
                        "v": torch.zeros(5, dtype=torch.float64)}, t64(3.0))
    xa2, _ = solver.run({"a": torch.zeros(3, dtype=torch.float64)}, t64(4.0))
    np.testing.assert_allclose(_np(xa["a"]), 2.0, atol=1e-8)
    np.testing.assert_allclose(_np(xb["u"]), 3.0, atol=1e-8)
    np.testing.assert_allclose(_np(xb["v"]), 3.0, atol=1e-8)
    np.testing.assert_allclose(_np(xa2["a"]), 4.0, atol=1e-8)


class TestOptInfo:
    """``converged`` is ``error <= tol``: False on NaN and at maxiter."""

    def test_converged_within_budget_matches_jax(self):
        Mn = _orthogonal(4, 4, 0.3)
        Mj, Mt = jnp.asarray(Mn), torch.from_numpy(Mn)
        _, ij = jrt.FixedPointIteration(lambda x: Mj @ x + 1.0, maxiter=500,
                                        tol=1e-12, implicit_diff=False
                                        ).run(jnp.zeros(4))
        _, it = trt.FixedPointIteration(lambda x: Mt @ x + 1.0, maxiter=500,
                                        tol=1e-12, implicit_diff=False
                                        ).run(torch.zeros(4,
                                                          dtype=torch.float64))
        assert bool(it.converged) and 0 < int(it.iterations) < 500
        assert int(it.iterations) == int(ij.iterations)
        assert float(it.error) <= 1e-12

    def test_maxiter_exhaustion_reports_unconverged(self):
        Mt = torch.from_numpy(_orthogonal(5, 4, 0.99))
        _, info = trt.FixedPointIteration(lambda x: Mt @ x + 1.0, maxiter=3,
                                          tol=1e-12, implicit_diff=False
                                          ).run(torch.zeros(
                                              4, dtype=torch.float64))
        assert not bool(info.converged)
        assert int(info.iterations) == 3

    def test_nan_iteration_is_never_converged(self):
        solver = trt.FixedPointIteration(lambda x: x * float("nan"),
                                         maxiter=100, tol=1e-8,
                                         implicit_diff=False)
        _, info = solver.run(torch.ones(3, dtype=torch.float64))
        assert not bool(info.converged)
        assert torch.isnan(info.error)
        assert int(info.iterations) == 1   # stopped immediately

    def test_divergent_gd_reports_unconverged(self):
        Xn, yn = _data(6, (10, 3), (10,))
        solver = trt.GradientDescent(_ridge(TORCH, Xn, yn), stepsize=10.0,
                                     maxiter=500, tol=1e-10,
                                     implicit_diff=False)
        _, info = solver.run(torch.zeros(3, dtype=torch.float64),
                             torch.tensor(1.0, dtype=torch.float64))
        assert not bool(info.converged)


def test_backward_solve_goes_through_the_named_registry_solver():
    seen = []

    def spy_cg(matvec, b, **kw):
        seen.append(kw)
        return tls.solve_cg(matvec, b, **kw)

    tls.register_solver("spy_cg", spy_cg, symmetric_only=True,
                        supports_precond=True)
    try:
        Xn, yn = _data(7, (12, 3), (12,))
        solver = trt.GradientDescent(
            _ridge(TORCH, Xn, yn), stepsize=1.0 / _lip(Xn, 2.0),
            maxiter=2000, tol=1e-12, solve="spy_cg", precond="jacobi",
            ridge=1e-10, linsolve_tol=1e-9, linsolve_maxiter=77)
        t = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
        x, _ = solver.run(torch.zeros(3, dtype=torch.float64), t)
        (g,) = torch.autograd.grad((x ** 2).sum(), t)
        assert torch.isfinite(g)
        assert len(seen) == 1
        assert seen[0]["precond"] == "jacobi"
        assert seen[0]["ridge"] == 1e-10
        assert seen[0]["tol"] == 1e-9
        assert seen[0]["maxiter"] == 77
    finally:
        tls._REGISTRY.pop("spy_cg", None)


def test_unported_parts_raise():
    """What A.4 and A.11 brought now runs: mesh placement (``sharding``
    reaches the solver's spec; ``tests/test_torch_sharded_operators.py``
    runs it), the approximate backward fields (validated as in the
    reference), ``estimate_hypergrad_error`` and a batch axis over
    ``run()``."""
    f = lambda x, t: 0.5 * ((x - t) ** 2).sum()
    placement = object()
    assert trt.GradientDescent(f, sharding=placement).diff_spec() \
        .sharding is placement
    with pytest.raises(ValueError, match="backward_iters"):
        trt.GradientDescent(f, backward="neumann_k", backward_iters=0)
    approx = trt.GradientDescent(f, backward="one_step")
    assert approx.diff_spec().backward_kwargs() == {
        "backward": "one_step", "backward_iters": 8}
    solver = trt.GradientDescent(f, stepsize=0.5, maxiter=100, tol=1e-10,
                                 solve="cg")
    x = torch.ones(2, dtype=torch.float64)
    # A = -I: the exact backward is exact, its residual ~0
    assert float(solver.estimate_hypergrad_error(x, x)) < 1e-12
    thetas = torch.tensor([[1.0, 2.0], [0.5, 0.25], [3.0, -1.0]],
                          dtype=torch.float64)
    xs = torch.func.vmap(
        lambda t: solver.run(torch.zeros(2, dtype=torch.float64), t)[0]
    )(thetas)
    np.testing.assert_allclose(_np(xs), _np(thetas), atol=1e-9)


def test_l2_optimality_error_matches_jax():
    build, init, theta, pack = CASES["projected_gradient"]
    x = np.array([0.1, 0.6, 0.3])
    ej = build(JAX).l2_optimality_error(jnp.asarray(x),
                                        *pack(jnp.asarray(theta)))
    et = build(TORCH).l2_optimality_error(torch.from_numpy(x),
                                          *pack(torch.from_numpy(theta)))
    np.testing.assert_allclose(float(et), float(ej), atol=1e-14)


def test_legacy_shims_match_classes_and_warn_once():
    Qn = np.diag([1.0, 4.0, 9.0])
    theta = np.array([1.0, 2.0, 3.0])
    Qt = torch.from_numpy(Qn)
    f = lambda x, t: 0.5 * x @ Qt @ x - t @ x
    tdiff.reset_deprecation_warnings()
    with pytest.deprecated_call():
        x_shim = tsolvers.gradient_descent(f, torch.zeros(3, dtype=torch.float64),
                                           torch.from_numpy(theta),
                                           stepsize=0.1, maxiter=5000,
                                           tol=1e-12)
    x_cls, _ = trt.GradientDescent(f, stepsize=0.1, maxiter=5000, tol=1e-12,
                                   implicit_diff=False).run(
        torch.zeros(3, dtype=torch.float64), torch.from_numpy(theta))
    assert torch.equal(x_shim, x_cls)
    Qj = jnp.asarray(Qn)
    jdiff.reset_deprecation_warnings()
    with pytest.deprecated_call():
        x_j = jsolvers.gradient_descent(
            lambda x, t: 0.5 * x @ Qj @ x - t @ x, jnp.zeros(3),
            jnp.asarray(theta), stepsize=0.1, maxiter=5000, tol=1e-12)
    np.testing.assert_allclose(_np(x_shim), np.asarray(x_j), atol=XTOL)
