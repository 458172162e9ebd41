"""The port's implicit-diff API against the JAX package and the closed form.

Ridge stationarity ``F(x, θ) = Xᵀ(Xx − y) + θx`` with the closed form
x*(θ) = (XᵀX + θI)⁻¹Xᵀy and ∂x*/∂θ = −(XᵀX + θI)⁻¹x*.  ``root_vjp`` /
``root_jvp`` against JAX's; ``custom_root`` gradients
(``torch.autograd.grad``) and forward-mode JVPs (``torch.func.jvp``)
against ``jax.grad`` / ``jax.jvp`` and the closed form, for
``solve`` ∈ {cg, pallas_cg, normal_cg}.  Tolerance 1e-8 (float64 with the
solver tolerance at 1e-12).

Batching (the port of ``TestVmapCounting``): ``torch.func.vmap`` of
``torch.func.grad`` runs exactly ONE backward solve and ``vmap`` of
``torch.func.jvp`` ONE tangent solve, counted by a registered counting
solver, where a loop runs B; values agree with the loop to 1e-12.
``jacrev`` / ``jacfwd`` agree; parts 1 and 3 of ``examples/quickstart.py``
in torch; ``torch.func.vmap`` over ``run()`` for GD (fixed step and
backtracking), LBFGS and Anderson with per-instance iterations equal to
``jax.vmap(run)``'s and x* within 1e-10.
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
    """The approximate modes are ported now: the spec validates a mode as
    the JAX package's does, and keeps its depth."""
    spec = tdiff.ImplicitDiffSpec(optimality_fun=lambda x, t: x,
                                  backward="one_step")
    assert spec.backward_kwargs() == {"backward": "one_step",
                                      "backward_iters": 8}
    with pytest.raises(ValueError, match="unknown backward"):
        tdiff.ImplicitDiffSpec(backward="nope")
    with pytest.raises(ValueError, match="backward_iters"):
        tdiff.ImplicitDiffSpec(backward="neumann_k", backward_iters=0)
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



# ---------------------------------------------------------------------------
# batching: one registry solve for a batch of derivatives
# ---------------------------------------------------------------------------

@pytest.fixture
def counting_solver():
    """A registered CG that counts its calls (with their batch_ndim)."""
    from repro_torch.core import linear_solve as tls
    calls = []

    def counting_cg(matvec, b, **kw):
        calls.append(kw.get("batch_ndim", 0))
        return tls.solve_cg(matvec, b, **kw)

    tls.register_solver("counting_cg_api", counting_cg, symmetric_only=True,
                        supports_precond=True)
    yield calls
    tls._REGISTRY.pop("counting_cg_api", None)


def _counting_ridge(data):
    Xn, yn, _ = data
    _, tsolver = _ridge_solvers(Xn, yn, "cg")
    return timp.custom_root(tsolver.spec.optimality_fun,
                            solve="counting_cg_api", tol=SOLVE_TOL)(
        tsolver.__wrapped__)


THETAS = [0.5, 1.0, 2.0, 4.0]


def test_vmap_grad_executes_one_batched_solve(data, counting_solver):
    solver = _counting_ridge(data)
    loss = lambda t: (solver(None, t) ** 2).sum()
    thetas = torch.tensor(THETAS, dtype=torch.float64)
    g_vmap = torch.func.vmap(torch.func.grad(loss))(thetas)
    assert counting_solver == [1], \
        f"expected ONE batched backward solve, ran {counting_solver}"
    counting_solver.clear()
    g_loop = torch.stack([torch.func.grad(loss)(t) for t in thetas])
    assert counting_solver == [0] * len(THETAS)
    np.testing.assert_allclose(_np(g_vmap), _np(g_loop), rtol=1e-12)
    Xn, yn, _ = data
    for t, g in zip(THETAS, _np(g_vmap)):
        x, dx = _closed_form(Xn, yn, t)
        np.testing.assert_allclose(g, 2 * x @ dx, atol=ATOL)


def test_vmap_jvp_executes_one_batched_solve(data, counting_solver):
    solver = _counting_ridge(data)
    one = torch.tensor(1.0, dtype=torch.float64)
    deriv = lambda t: torch.func.jvp(lambda tt: solver(None, tt), (t,),
                                     (one,))[1]
    thetas = torch.tensor(THETAS, dtype=torch.float64)
    jv_vmap = torch.func.vmap(deriv)(thetas)
    assert counting_solver == [1], \
        f"expected ONE batched tangent solve, ran {counting_solver}"
    counting_solver.clear()
    jv_loop = torch.stack([deriv(t) for t in thetas])
    assert counting_solver == [0] * len(THETAS)
    np.testing.assert_allclose(_np(jv_vmap), _np(jv_loop), rtol=1e-12)
    # and the same batch through the JAX package
    Xn, yn, _ = data
    jsolver, _ = _ridge_solvers(Xn, yn, "cg")
    jv_jax = jax.vmap(lambda t: jax.jvp(lambda tt: jsolver(None, tt), (t,),
                                        (1.0,))[1])(jnp.asarray(THETAS))
    np.testing.assert_allclose(_np(jv_vmap), np.asarray(jv_jax), atol=ATOL)


@pytest.mark.parametrize("solve", ["cg", "pallas_cg", "normal_cg"])
def test_jacrev_and_jacfwd_agree(data, solve):
    """jacrev batches the cotangent (one operator, many right-hand
    sides), jacfwd the tangent: each one solve, equal to the JAX
    package's and to each other."""
    Xn, yn, _ = data
    jsolver, tsolver = _ridge_solvers(Xn, yn, solve)
    thn = np.array([0.3, 1.7])

    def tf(th):
        return tsolver(None, th[0]) * th[1]

    def jf(th):
        return jsolver(None, th[0]) * th[1]

    th = torch.from_numpy(thn)
    Jr = torch.func.jacrev(tf)(th)
    Jf = torch.func.jacfwd(tf)(th)
    np.testing.assert_allclose(_np(Jr), _np(Jf), atol=1e-10)
    np.testing.assert_allclose(_np(Jr), np.asarray(jax.jacrev(jf)(
        jnp.asarray(thn))), atol=ATOL)


def test_quickstart_parts_1_and_3_in_torch():
    """``examples/quickstart.py`` parts 1 and 3 with the port: the Fig. 1
    decorator's Jacobian against the closed form, and one wrapper (and
    ``run()``) giving equal ``jacrev`` / ``jacfwd``."""
    rng = np.random.default_rng(0)
    Xn, yn = rng.standard_normal((50, 8)), rng.standard_normal(50)
    X, y = torch.from_numpy(Xn), torch.from_numpy(yn)

    def f(x, theta):
        residual = X @ x - y
        return ((residual ** 2).sum() + theta * (x ** 2).sum()) / 2

    F = torch.func.grad(f, argnums=0)

    @timp.custom_root(F)
    def ridge_solver(init_x, theta):
        return torch.linalg.solve(X.T @ X + theta * torch.eye(
            8, dtype=torch.float64), X.T @ y)

    def closed_form_jacobian(theta):
        A = Xn.T @ Xn + theta * np.eye(8)
        return -np.linalg.solve(A, np.linalg.solve(A, Xn.T @ yn))

    ten = torch.tensor(10.0, dtype=torch.float64)
    J = torch.func.jacrev(ridge_solver, argnums=1)(None, ten)
    assert float(np.abs(_np(J) - closed_form_jacobian(10.0)).max()) < 1e-8

    spec = tdiff.ImplicitDiffSpec(optimality_fun=F, solve="cg", tol=1e-12)
    wrapped = tdiff.implicit_diff(spec)(
        lambda init, t: torch.linalg.solve(
            X.T @ X + t * torch.eye(8, dtype=torch.float64), X.T @ y))
    J_rev = torch.func.jacrev(wrapped, argnums=1)(None, ten)
    J_fwd = torch.func.jacfwd(wrapped, argnums=1)(None, ten)
    assert float((J_rev - J_fwd).abs().max()) < 1e-8

    from repro_torch.core import GradientDescent
    L = float(np.linalg.eigvalsh(Xn.T @ Xn).max()) + 100.0
    solver = GradientDescent(f, stepsize=1.0 / L, maxiter=5000, tol=1e-12,
                             solve="cg")
    x0 = torch.zeros(8, dtype=torch.float64)
    J_rt = torch.func.jacrev(lambda t: solver.run(x0, t)[0])(ten)
    J_fwd_rt = torch.func.jacfwd(lambda t: solver.run(x0, t)[0])(ten)
    assert float(np.abs(_np(J_rt) - closed_form_jacobian(10.0)).max()) < 1e-6
    assert float((J_fwd_rt - J_rt).abs().max()) < 1e-6
    # part 2's batch: one masked loop, per-instance iterations
    thetas = torch.tensor([1.0, 10.0, 100.0], dtype=torch.float64)
    its, conv = torch.func.vmap(
        lambda t: tuple(solver.run(x0, t)[1][0::2]))(thetas)
    assert bool(conv.all()) and len(set(its.tolist())) == 3


def _runtime_case(name, lib):
    """Solvers of tests/test_solver_runtime.py's kinds on a ridge /
    quadratic / contraction problem, built by ``lib``'s runtime."""
    from repro.core import solver_runtime as jrt
    from repro_torch.core import solver_runtime as trt
    rt, arr = (jrt, jnp.asarray) if lib == "jax" else (trt, torch.from_numpy)
    rng = np.random.default_rng(21)
    Xn, yn = rng.standard_normal((20, 5)), rng.standard_normal(20)
    X, y = arr(Xn), arr(yn)
    ridge = lambda x, t: 0.5 * ((X @ x - y) ** 2).sum() + \
        0.5 * t * (x ** 2).sum()
    L = float(np.linalg.eigvalsh(Xn.T @ Xn).max()) + 4.0
    if name == "gd":
        return rt.GradientDescent(ridge, stepsize=1.0 / L, maxiter=5000,
                                  tol=1e-11, solve="cg", linsolve_tol=1e-12)
    if name == "gd_linesearch":
        Q = arr(np.diag([1.0, 50.0]))
        return rt.GradientDescent(lambda x, t: 0.5 * x @ Q @ x - t @ x,
                                  stepsize=1.0, linesearch=True,
                                  maxiter=2000, tol=1e-7, solve="cg",
                                  linsolve_tol=1e-12)
    if name == "lbfgs":
        return rt.LBFGS(ridge, maxiter=400, tol=1e-11, stepsize=1.0,
                        solve="cg", linsolve_tol=1e-12)
    q, _ = np.linalg.qr(rng.standard_normal((4, 4)))
    M = arr(0.5 * q)
    return rt.AndersonAcceleration(lambda x, t: M @ x + t, maxiter=100,
                                   tol=1e-12, linsolve_tol=1e-12)


RUNTIME_BATCHES = {
    "gd": (np.zeros(5), np.array([0.05, 0.5, 2.0, 4.0])),
    "gd_linesearch": (np.ones(2), np.array([[1.0, 2.0], [0.5, -1.0],
                                            [3.0, 0.2]])),
    "lbfgs": (np.zeros(5), np.array([0.05, 0.5, 2.0, 4.0])),
    "anderson": (np.zeros(4), np.array([[1.0, 1.0, 1.0, 1.0],
                                        [0.1, -2.0, 0.5, 3.0],
                                        [1e-3, 0.0, 0.0, 0.0]])),
}


@pytest.mark.parametrize("name", list(RUNTIME_BATCHES))
def test_vmap_over_run_matches_jax_vmap(name):
    """``torch.func.vmap`` over ``run()``: one masked loop whose
    per-instance iterations equal ``jax.vmap(run)``'s (and a loop of solo
    runs'), x* within 1e-10, and ``vmap(grad)`` through ``run()`` against
    ``jax.vmap(jax.grad)`` within 1e-8 — one backward solve."""
    x0n, thetas = RUNTIME_BATCHES[name]
    js, ts = _runtime_case(name, "jax"), _runtime_case(name, "torch")
    xj, ij = jax.vmap(lambda t: js.run(jnp.asarray(x0n), t))(
        jnp.asarray(thetas))
    x0 = torch.from_numpy(x0n)
    xt, (it, et, ct) = torch.func.vmap(
        lambda t: (lambda x, info: (x, tuple(info[:3])))(*ts.run(x0, t)))(
        torch.from_numpy(thetas))
    np.testing.assert_array_equal(_np(it), np.asarray(ij.iterations))
    np.testing.assert_array_equal(_np(ct), np.asarray(ij.converged))
    np.testing.assert_allclose(_np(xt), np.asarray(xj), atol=1e-10)
    solo = [int(ts.run(x0, t)[1].iterations)
            for t in torch.from_numpy(thetas)]
    assert _np(it).tolist() == solo
    assert len(set(solo)) > 1          # the instances stop apart

    gj = jax.vmap(jax.grad(lambda t: jnp.sum(
        js.run(jnp.asarray(x0n), t)[0] ** 2)))(jnp.asarray(thetas))
    gt = torch.func.vmap(torch.func.grad(lambda t: (
        ts.run(x0, t)[0] ** 2).sum()))(torch.from_numpy(thetas))
    np.testing.assert_allclose(_np(gt), np.asarray(gj), atol=ATOL)


def test_second_derivative_through_the_solve_raises(data):
    """Once a documented raise, now parity: the implicit linear solve is
    differentiated again, with ``lax.custom_linear_solve``'s semantics, so
    ``grad(grad)`` equals ``jax.grad(jax.grad)`` and the closed form
    d²(Σx*²)/dθ² = 2(x'·x' + x*·x''), x'' = −2A⁻¹x'; first derivatives
    are unaffected."""
    Xn, yn, _ = data
    jsolver, tsolver = _ridge_solvers(Xn, yn, "cg")
    loss = lambda t: (tsolver(None, t) ** 2).sum()
    th = torch.tensor(0.7, dtype=torch.float64)
    x, dx = _closed_form(Xn, yn, 0.7)
    np.testing.assert_allclose(float(torch.func.grad(loss)(th)), 2 * x @ dx,
                               atol=ATOL)
    A = Xn.T @ Xn + 0.7 * np.eye(D)
    ddx = -2 * np.linalg.solve(A, dx)
    want = jax.grad(jax.grad(lambda t: jnp.sum(jsolver(None, t) ** 2)))(0.7)
    got = float(torch.func.grad(torch.func.grad(loss))(th))
    np.testing.assert_allclose(got, float(want), atol=ATOL)
    np.testing.assert_allclose(got, 2 * (dx @ dx + x @ ddx), atol=ATOL)


def test_vmap_output_takes_optinfo_tensor_fields():
    """Documented difference (ROADMAP C): ``torch.func.vmap`` outputs are
    tensors, so the ``None`` field of an ``OptInfo`` cannot be returned
    from the mapped function (JAX treats ``None`` as an empty subtree);
    its tensor fields can."""
    from repro_torch.core import GradientDescent
    solver = GradientDescent(lambda x, t: 0.5 * ((x - t) ** 2).sum(),
                             stepsize=0.5, maxiter=100, tol=1e-10)
    x0 = torch.zeros(2, dtype=torch.float64)
    thetas = torch.tensor([[1.0, 2.0], [3.0, 4.0]], dtype=torch.float64)
    with pytest.raises(ValueError, match="must only return Tensors"):
        torch.func.vmap(lambda t: solver.run(x0, t)[1])(thetas)
    its, _, conv = torch.func.vmap(
        lambda t: tuple(solver.run(x0, t)[1][:3]))(thetas)
    assert bool(conv.all()) and its.shape == (2,)
