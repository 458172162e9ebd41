"""The port's implicit-diff API against the JAX package and the closed form.

Ridge stationarity ``F(x, θ) = Xᵀ(Xx − y) + θx`` with the closed form
x*(θ) = (XᵀX + θI)⁻¹Xᵀy and ∂x*/∂θ = −(XᵀX + θI)⁻¹x*.  ``root_vjp`` /
``root_jvp`` against JAX's; ``custom_root`` gradients
(``torch.autograd.grad``) and forward-mode JVPs (``torch.func.jvp``)
against ``jax.grad`` / ``jax.jvp`` and the closed form, for
``solve`` ∈ {cg, pallas_cg, normal_cg}.  Tolerance 1e-8 (float64 with the
solver tolerance at 1e-12).
"""
import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.func

from repro.core import diff_api as jdiff
from repro_torch.core import diff_api as tdiff

# the ``implicit_diff`` function shadows the submodule in both ``core``
# namespaces, so the shim modules are fetched by their full names
jimp = importlib.import_module("repro.core.implicit_diff")
timp = importlib.import_module("repro_torch.core.implicit_diff")

ATOL = 1e-8
SOLVE_TOL = 1e-12
N, D = 12, 5


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((N, D)), rng.standard_normal(N),
            rng.standard_normal(D))


def _F(X, y):
    return lambda x, theta: X.T @ (X @ x - y) + theta * x


def _closed_form(X, y, theta):
    A = X.T @ X + theta * np.eye(D)
    x = np.linalg.solve(A, X.T @ y)
    return x, -np.linalg.solve(A, x)          # x*, dx*/dθ


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)


@pytest.mark.parametrize("solve", ["cg", "normal_cg", "pallas_cg", "lu"])
def test_root_vjp_and_root_jvp_match_jax(data, solve):
    Xn, yn, v = data
    theta = 0.8
    x_star, dx = _closed_form(Xn, yn, theta)
    Fj = _F(jnp.asarray(Xn), jnp.asarray(yn))
    Ft = _F(torch.from_numpy(Xn), torch.from_numpy(yn))
    kw = dict(solve=solve, tol=SOLVE_TOL)
    (gj,) = jdiff.root_vjp(Fj, jnp.asarray(x_star), (jnp.asarray(theta),),
                           jnp.asarray(v), **kw)
    (gt,) = tdiff.root_vjp(Ft, torch.from_numpy(x_star),
                           (torch.tensor(theta, dtype=torch.float64),),
                           torch.from_numpy(v), **kw)
    np.testing.assert_allclose(_np(gt), np.asarray(gj), atol=ATOL)
    np.testing.assert_allclose(_np(gt), v @ dx, atol=ATOL)
    jj = jdiff.root_jvp(Fj, jnp.asarray(x_star), (jnp.asarray(theta),),
                        (jnp.asarray(1.0),), **kw)
    jt = tdiff.root_jvp(Ft, torch.from_numpy(x_star),
                        (torch.tensor(theta, dtype=torch.float64),),
                        (torch.tensor(1.0, dtype=torch.float64),), **kw)
    np.testing.assert_allclose(_np(jt), np.asarray(jj), atol=ATOL)
    np.testing.assert_allclose(_np(jt), dx, atol=ATOL)


def test_root_vjp_return_info(data):
    Xn, yn, v = data
    x_star, _ = _closed_form(Xn, yn, 0.5)
    Ft = _F(torch.from_numpy(Xn), torch.from_numpy(yn))
    _, info = tdiff.root_vjp(Ft, torch.from_numpy(x_star),
                             (torch.tensor(0.5, dtype=torch.float64),),
                             torch.from_numpy(v), solve="cg", tol=SOLVE_TOL,
                             return_info=True, error_estimate=True)
    assert bool(info.converged)
    assert float(info.hypergrad_error_estimate) < 1e-10


def _ridge_solvers(Xn, yn, solve, **kw):
    """The same ridge solver wrapped by each package's custom_root."""
    Xj, yj = jnp.asarray(Xn), jnp.asarray(yn)
    Xt, yt = torch.from_numpy(Xn), torch.from_numpy(yn)

    @jimp.custom_root(_F(Xj, yj), solve=solve, tol=SOLVE_TOL, **kw)
    def jsolver(init, theta):
        return jnp.linalg.solve(Xj.T @ Xj + theta * jnp.eye(D), Xj.T @ yj)

    @timp.custom_root(_F(Xt, yt), solve=solve, tol=SOLVE_TOL, **kw)
    def tsolver(init, theta):
        return torch.linalg.solve(Xt.T @ Xt + theta * torch.eye(
            D, dtype=torch.float64), Xt.T @ yt)

    return jsolver, tsolver


@pytest.mark.parametrize("solve", ["cg", "pallas_cg", "normal_cg"])
def test_custom_root_grad_and_jvp(data, solve):
    Xn, yn, v = data
    theta = 1.3
    _, dx = _closed_form(Xn, yn, theta)
    jsolver, tsolver = _ridge_solvers(Xn, yn, solve)
    g_j = jax.grad(lambda t: jnp.asarray(v) @ jsolver(None, t))(theta)
    th = torch.tensor(theta, dtype=torch.float64, requires_grad=True)
    (g_t,) = torch.autograd.grad(torch.from_numpy(v) @ tsolver(None, th), th)
    np.testing.assert_allclose(float(g_t), float(g_j), atol=ATOL)
    np.testing.assert_allclose(float(g_t), v @ dx, atol=ATOL)
    _, jv_j = jax.jvp(lambda t: jsolver(None, t), (theta,), (1.0,))
    _, jv_t = torch.func.jvp(lambda t: tsolver(None, t),
                             (th.detach(),),
                             (torch.tensor(1.0, dtype=torch.float64),))
    np.testing.assert_allclose(_np(jv_t), np.asarray(jv_j), atol=ATOL)
    np.testing.assert_allclose(_np(jv_t), dx, atol=ATOL)
    # torch.func.grad goes through the same backward
    g_f = torch.func.grad(lambda t: torch.from_numpy(v) @ tsolver(None, t))(
        th.detach())
    np.testing.assert_allclose(float(g_f), v @ dx, atol=ATOL)


def test_has_aux_and_nondiff_argnums(data):
    Xn, yn, v = data
    Xt, yt = torch.from_numpy(Xn), torch.from_numpy(yn)

    def F(x, theta, scale):
        return scale(Xt.T @ (Xt @ x - yt)) + theta * x

    @tdiff.implicit_diff(optimality_fun=F, solve="cg", tol=SOLVE_TOL,
                         has_aux=True, nondiff_argnums=(1,))
    def solver(init, theta, scale):
        x = torch.linalg.solve(scale(Xt.T @ Xt) + theta * torch.eye(
            D, dtype=torch.float64), scale(Xt.T @ yt))
        return x, {"steps": torch.tensor(7), "note": "closed form"}

    def half(t):
        return 0.5 * t

    th = torch.tensor(0.9, dtype=torch.float64, requires_grad=True)
    x, aux = solver(None, th, half)
    assert int(aux["steps"]) == 7 and aux["note"] == "closed form"
    (g,) = torch.autograd.grad(torch.from_numpy(v) @ x, th)
    A = 0.5 * Xn.T @ Xn + 0.9 * np.eye(D)
    xs = np.linalg.solve(A, 0.5 * Xn.T @ yn)
    np.testing.assert_allclose(float(g), -v @ np.linalg.solve(A, xs),
                               atol=ATOL)
    with pytest.raises(ValueError, match="out of range"):
        tdiff.implicit_diff(optimality_fun=F, nondiff_argnums=(3,))(
            solver)(None, th, half)


def test_pytree_theta_matches_jax(data):
    """Dict-valued θ: gradients per leaf against jax.grad."""
    Xn, yn, v = data

    def F(lib):
        X, y = lib.asarray(Xn) if lib is jnp else torch.from_numpy(Xn), \
            lib.asarray(yn) if lib is jnp else torch.from_numpy(yn)
        return lambda x, th: X.T @ (X @ x - th["shift"] * y) + th["lam"] * x

    def inner(lib, th):
        X, y = (jnp.asarray(Xn), jnp.asarray(yn)) if lib is jnp else \
            (torch.from_numpy(Xn), torch.from_numpy(yn))
        eye = jnp.eye(D) if lib is jnp else torch.eye(D, dtype=torch.float64)
        return lib.linalg.solve(X.T @ X + th["lam"] * eye,
                                th["shift"] * (X.T @ y))

    js = jimp.custom_root(F(jnp), solve="cg", tol=SOLVE_TOL)(
        lambda init, th: inner(jnp, th))
    ts = timp.custom_root(F(torch), solve="cg", tol=SOLVE_TOL)(
        lambda init, th: inner(torch, th))
    thj = {"lam": 0.6, "shift": 1.5}
    gj = jax.grad(lambda th: jnp.asarray(v) @ js(None, th))(thj)
    tht = {k: torch.tensor(val, dtype=torch.float64, requires_grad=True)
           for k, val in thj.items()}
    gl, gs = torch.autograd.grad(torch.from_numpy(v) @ ts(None, tht),
                                 (tht["lam"], tht["shift"]))
    np.testing.assert_allclose(float(gl), float(gj["lam"]), atol=ATOL)
    np.testing.assert_allclose(float(gs), float(gj["shift"]), atol=ATOL)


def test_single_mode_wrappers_refuse_the_other_mode(data):
    Xn, yn, _ = data
    Xt, yt = torch.from_numpy(Xn), torch.from_numpy(yn)
    F = _F(Xt, yt)

    def solver(init, theta):
        return torch.linalg.solve(Xt.T @ Xt + theta * torch.eye(
            D, dtype=torch.float64), Xt.T @ yt)

    th = torch.tensor(0.7, dtype=torch.float64)
    rev = tdiff.implicit_diff(F, mode="vjp", solve="cg")(solver)
    with pytest.raises(RuntimeError, match="forward mode"):
        torch.func.jvp(lambda t: rev(None, t), (th,), (torch.ones_like(th),))
    reset = tdiff.reset_deprecation_warnings
    reset()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fwd = timp.custom_root_jvp(F, solve="cg")(solver)
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    _, jv = torch.func.jvp(lambda t: fwd(None, t), (th,),
                           (torch.ones_like(th),))
    assert torch.isfinite(jv).all()
    thg = th.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="reverse mode"):
        torch.autograd.grad(fwd(None, thg).sum(), thg)
    with pytest.raises(TypeError, match="deprecated"):
        timp.custom_root_jvp(F, backward="one_step")


def test_custom_fixed_point_matches_jax():
    """x* = T(x*, θ) with T(x, θ) = 0.5 x + θ a (contraction)."""
    a = np.arange(1.0, 5.0)

    def T(lib):
        av = jnp.asarray(a) if lib is jnp else torch.from_numpy(a)
        return lambda x, theta: 0.5 * x + theta * av

    js = jimp.custom_fixed_point(T(jnp), solve="normal_cg", tol=SOLVE_TOL)(
        lambda init, theta: 2.0 * theta * jnp.asarray(a))
    ts = timp.custom_fixed_point(T(torch), solve="normal_cg", tol=SOLVE_TOL)(
        lambda init, theta: 2.0 * theta * torch.from_numpy(a))
    gj = jax.grad(lambda t: js(None, t).sum())(0.3)
    th = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    (gt,) = torch.autograd.grad(ts(None, th).sum(), th)
    np.testing.assert_allclose(float(gt), float(gj), atol=ATOL)
    np.testing.assert_allclose(float(gt), 2.0 * a.sum(), atol=ATOL)


def test_approximate_backward_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdiff.ImplicitDiffSpec(optimality_fun=lambda x, t: x,
                               backward="one_step")
    with pytest.raises(ValueError, match="unknown backward"):
        tdiff.ImplicitDiffSpec(backward="nope")
    spec = tdiff.ImplicitDiffSpec(solve="cg", tol=1e-9)
    assert spec.is_routing_only
    assert spec.routing_kwargs() == jdiff.ImplicitDiffSpec(
        solve="cg", tol=1e-9).routing_kwargs()


def test_init_gets_no_derivative(data):
    """``init`` is outside the autograd graph (JAX gives it a zero
    cotangent): a gradient with respect to it is ``None``."""
    Xn, yn, v = data
    _, tsolver = _ridge_solvers(Xn, yn, "cg")
    init = torch.zeros(D, dtype=torch.float64, requires_grad=True)
    th = torch.tensor(0.4, dtype=torch.float64, requires_grad=True)
    x = tsolver(init, th)
    g_init, g_th = torch.autograd.grad(torch.from_numpy(v) @ x, (init, th),
                                       allow_unused=True)
    assert g_init is None and g_th is not None
