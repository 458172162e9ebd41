"""The port's bilevel driver against the JAX package's.

* ``solve_bilevel`` on the ridge problem of
  ``tests/test_solvers_bilevel.py::test_ridge_hyperparam_converges_to_oracle``
  (per-coordinate ridge, closed-form inner solver, stationarity condition):
  the outer-value trace and the final θ agree within 1e-8.
* ``make_unrolled_inner`` against the implicit hypergradient, as
  ``test_hypergrad_matches_unrolled_on_strongly_convex`` does (rtol 1e-4),
  and the implicit one against JAX's within 1e-8.
* The paper's §4.1 multiclass-SVM slice at ``benchmarks/svm_hyperopt.py``'s
  own size (m=80, p=40, k=5, θ = e⁶): ``ProjectedGradient`` whose ``proj``
  is the kernel op, driven by one ``solve_bilevel`` step on θ = (λ, None),
  against JAX's with ``projection_simplex_batched(·, 1.0, True)`` (the
  Pallas kernel in interpret mode).  The projection computes in float32
  inside a float64 loop, so the two runs stop on float32-rounded steps:
  iteration counts agree within 1 and the hypergradient within 1e-4
  relative (not the float64 1e-8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.func

from repro.core import ProjectedGradient as JaxPG
from repro.core import bilevel as jbilevel
from repro.kernels.simplex_proj.ops import projection_simplex_batched as jproj
from repro_torch.core import ProjectedGradient
from repro_torch.core import bilevel
from repro_torch.kernels.simplex_proj import ops as simplex_ops


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def test_solve_bilevel_ridge_matches_jax():
    rng = np.random.default_rng(0)
    Xtr, Xval = rng.standard_normal((40, 6)), rng.standard_normal((40, 6))
    w_true = np.array([1.0, -2.0, 0.0, 0.0, 3.0, 0.0])
    ytr = Xtr @ w_true + 0.1 * rng.standard_normal(40)
    yval = Xval @ w_true

    def problem(lib, arr):
        Xt, yt, Xv, yv = map(arr, (Xtr, ytr, Xval, yval))

        def inner_obj(x, lam):
            return 0.5 * ((Xt @ x - yt) ** 2).sum() + \
                0.5 * (lib.exp(lam) * x ** 2).sum()

        def inner_solver(init, lam):
            return lib.linalg.solve(Xt.T @ Xt + lib.diag(lib.exp(lam)),
                                    Xt.T @ yt)

        def outer_loss(x, lam):
            return 0.5 * ((Xv @ x - yv) ** 2).mean()

        return inner_obj, inner_solver, outer_loss

    obj_j, solver_j, outer_j = problem(jnp, jnp.asarray)
    obj_t, solver_t, outer_t = problem(torch, _t)
    sj = jbilevel.solve_bilevel(outer_j, solver_j, jnp.zeros(6), jnp.zeros(6),
                                inner_objective=obj_j, outer_steps=60,
                                outer_lr=0.3)
    st = bilevel.solve_bilevel(outer_t, solver_t, _t(np.zeros(6)),
                               _t(np.zeros(6)), inner_objective=obj_t,
                               outer_steps=60, outer_lr=0.3)
    np.testing.assert_allclose(st.outer_values.numpy(),
                               np.asarray(sj.outer_values), atol=1e-8, rtol=0)
    np.testing.assert_allclose(st.theta.numpy(), np.asarray(sj.theta),
                               atol=1e-8, rtol=0)
    np.testing.assert_allclose(st.hypergrad_norms.numpy(),
                               np.asarray(sj.hypergrad_norms), atol=1e-8,
                               rtol=0)
    assert st.outer_values[-1] < st.outer_values[0] * 0.5
    assert st.inner_info is None


def test_implicit_hypergrad_matches_unrolled_and_jax():
    rng = np.random.default_rng(1)
    Xn, yn = rng.standard_normal((20, 4)), rng.standard_normal(20)
    L = float(np.linalg.eigvalsh(Xn.T @ Xn).max()) + 2.0
    X, y = _t(Xn), _t(yn)

    def inner_obj(x, lam):
        return 0.5 * ((X @ x - y) ** 2).sum() + \
            0.5 * torch.exp(lam) * (x ** 2).sum()

    def inner_solver(init, lam):
        return torch.linalg.solve(X.T @ X + torch.exp(lam) * torch.eye(
            4, dtype=torch.float64), X.T @ y)

    implicit = bilevel.make_implicit_inner(inner_solver,
                                           inner_objective=inner_obj,
                                           tol=1e-12)
    lam = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    (g_imp,) = torch.autograd.grad(
        (implicit(torch.zeros(4, dtype=torch.float64), lam) ** 2).sum(), lam)
    grad_obj = torch.func.grad(inner_obj)
    unrolled = bilevel.make_unrolled_inner(
        lambda x, lam: x - (1.0 / L) * grad_obj(x, lam), 3000)
    (g_unr,) = torch.autograd.grad(
        (unrolled(torch.zeros(4, dtype=torch.float64), lam) ** 2).sum(), lam)
    np.testing.assert_allclose(float(g_imp), float(g_unr), rtol=1e-4)

    Xj, yj = jnp.asarray(Xn), jnp.asarray(yn)
    implicit_j = jbilevel.make_implicit_inner(
        lambda init, lam: jnp.linalg.solve(
            Xj.T @ Xj + jnp.exp(lam) * jnp.eye(4), Xj.T @ yj),
        inner_objective=lambda x, lam: 0.5 * jnp.sum((Xj @ x - yj) ** 2)
        + 0.5 * jnp.exp(lam) * jnp.sum(x ** 2), tol=1e-12)
    g_jax = jax.grad(lambda lam: jnp.sum(implicit_j(jnp.zeros(4), lam) ** 2))(
        0.3)
    np.testing.assert_allclose(float(g_imp), float(g_jax), atol=1e-8, rtol=0)


def _svm_data(m=80, p=40, k=5, m_val=40, seed=0):
    """``benchmarks/svm_hyperopt.py::make_problem``'s recipe in numpy."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, p)) * 2
    yt = rng.integers(0, k, m)
    Xt = centers[yt] + rng.standard_normal((m, p))
    yv = rng.integers(0, k, m_val)
    Xv = centers[yv] + rng.standard_normal((m_val, p))
    return Xt, np.eye(k)[yt], Xv, np.eye(k)[yv]


def _svm(lib, arr, data):
    """Inner dual objective f(x, λ), θ = e^λ, and the validation loss."""
    Xt, Yt, Xv, Yv = map(arr, data)

    def W(x, lam):
        return Xt.T @ (Yt - x) / lib.exp(lam)

    def f(x, lam):
        return 0.5 * lib.exp(lam) * (W(x, lam) ** 2).sum() + (x * Yt).sum()

    def outer_loss(x, theta):
        return 0.5 * ((Xv @ W(x, theta[0]) - Yv) ** 2).sum()

    return f, outer_loss


def test_svm_slice_on_the_kernel_op_matches_jax():
    data = _svm_data()
    m, k = data[1].shape
    lam0 = 6.0
    L = float(np.linalg.eigvalsh(data[0] @ data[0].T).max())
    kw = dict(stepsize=float(np.exp(lam0)) / L, maxiter=2000, tol=1e-5,
              solve="normal_cg", linsolve_tol=1e-8, linsolve_maxiter=800)

    f_j, outer_j = _svm(jnp, jnp.asarray, data)
    pg_j = JaxPG(f_j, lambda y, tp: jproj(y, 1.0, True), **kw)
    sol_j = jbilevel.solve_bilevel(outer_j, pg_j, (jnp.asarray(lam0), None),
                                   jnp.full((m, k), 1.0 / k), outer_steps=1,
                                   outer_lr=1.0)

    f_t, outer_t = _svm(torch, _t, data)
    pg_t = ProjectedGradient(
        f_t, lambda y, tp: simplex_ops.projection_simplex_batched(y), **kw)
    sol_t = bilevel.solve_bilevel(outer_t, pg_t, (_t(lam0), None),
                                  _t(np.full((m, k), 1.0 / k)),
                                  outer_steps=1, outer_lr=1.0)

    assert sol_t.theta[1] is None
    g_j = lam0 - float(sol_j.theta[0])
    g_t = lam0 - float(sol_t.theta[0])
    assert abs(g_t - g_j) <= 1e-4 * abs(g_j)
    it_j, it_t = (int(sol_j.inner_info.iterations),
                  int(sol_t.inner_info.iterations))
    assert abs(it_t - it_j) <= 1
    assert bool(sol_t.inner_info.converged)
    np.testing.assert_allclose(float(sol_t.outer_values[0]),
                               float(sol_j.outer_values[0]), rtol=1e-6)
