"""Second derivatives through the implicit solve: the port against the JAX
package, float64 on the CPU.

Ridge stationarity ``F(x, θ) = Xᵀ(Xx − y) + θx`` (N = 20, D = 6, seed 0)
with the loss L(θ) = Σx*², whose closed form is d²L/dθ² = 2(x'·x' + x*·x'')
with x' = −A⁻¹x* and x'' = −2A⁻¹x' (A = XᵀX + θI).  The four second-order
combinations ``grad(grad)``, ``jacfwd(grad)``, ``grad(jvp)`` and
``jacfwd(jacfwd)`` go through both packages' ``implicit_diff`` in each
``mode``: where JAX gives a value the port gives it to 1e-8, where JAX
raises the port raises.  A single-mode wrapper differentiates its routed
routine as it stands, so its cells depend on the routine (``lu``,
``pallas_cg`` and the approximate modes have a reverse derivative, the
loops none); ``ridge`` damps the inner solve only.  Then the approximate
backward modes on a contractive fixed point, θ a vector (``hessian`` of a
nonlinear F), the batch (``vmap`` of ``hessian`` as one solve per level),
``root_vjp`` / ``root_jvp`` differentiated directly, plain
``torch.autograd`` double backward, and the callers: the DEQ layer,
``make_implicit_inner``, the solver runtime and the stochastic solvers.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.func

from repro.core import bilevel as jbilevel
from repro.core import diff_api as jdiff
from repro.core import implicit_layer as jlayer
from repro.core import solver_runtime as jrt
from repro_torch.core import bilevel as tbilevel
from repro_torch.core import diff_api as tdiff
from repro_torch.core import implicit_layer as tlayer
from repro_torch.core import solver_runtime as trt
from repro_torch.observability import events as tevents

ATOL = 1e-8
SOLVE_TOL = 1e-12
N, D = 20, 6
THETA = 0.7
F64 = torch.float64
COMBOS = ("grad(grad)", "jacfwd(grad)", "grad(jvp)", "jacfwd(jacfwd)")
# the cells in which each package gives a value (the others raise)
ALLOWED = {"auto": set(COMBOS), "vjp": {"jacfwd(grad)"},
           "jvp": {"jacfwd(jacfwd)"}}

_rng = np.random.default_rng(0)
XN, YN = _rng.standard_normal((N, D)), _rng.standard_normal(N)


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _closed_second(theta):
    A = XN.T @ XN + theta * np.eye(D)
    x = np.linalg.solve(A, XN.T @ YN)
    x1 = -np.linalg.solve(A, x)
    x2 = -2 * np.linalg.solve(A, x1)
    return 2 * (x1 @ x1 + x @ x2)


def _combos(lib, f):
    """The four second-order combinations of a scalar function of θ."""
    if lib == "jax":        # jitted: eager JAX dispatches op by op
        g = jax.grad(f)
        return {k: jax.jit(v) for k, v in {
            "grad(grad)": jax.grad(g), "jacfwd(grad)": jax.jacfwd(g),
            "grad(jvp)": jax.grad(
                lambda s: jax.jvp(f, (s,), (jnp.ones_like(s),))[1]),
            "jacfwd(jacfwd)": jax.jacfwd(jax.jacfwd(f))}.items()}
    g = torch.func.grad(f)
    return {"grad(grad)": torch.func.grad(g),
            "jacfwd(grad)": torch.func.jacfwd(g),
            "grad(jvp)": torch.func.grad(
                lambda s: torch.func.jvp(f, (s,), (torch.ones_like(s),))[1]),
            "jacfwd(jacfwd)": torch.func.jacfwd(torch.func.jacfwd(f))}


def _ridge_loss(lib, mode="auto", **kw):
    """Σx*² of the ridge solution through ``implicit_diff`` in ``lib``."""
    if lib == "jax":
        X, y = jnp.asarray(XN), jnp.asarray(YN)

        def solver(init, t):
            return jnp.linalg.solve(X.T @ X + t * jnp.eye(D), X.T @ y)

        wrapped = jdiff.implicit_diff(
            optimality_fun=lambda x, t: X.T @ (X @ x - y) + t * x,
            tol=SOLVE_TOL, mode=mode, **kw)(solver)
        return lambda t: jnp.sum(wrapped(None, t) ** 2)
    X, y = _t(XN), _t(YN)

    def solver(init, t):
        return torch.linalg.solve(X.T @ X + t * torch.eye(D, dtype=F64),
                                  X.T @ y)

    wrapped = tdiff.implicit_diff(
        optimality_fun=lambda x, t: X.T @ (X @ x - y) + t * x,
        tol=SOLVE_TOL, mode=mode, **kw)(solver)
    return lambda t: (wrapped(None, t) ** 2).sum()


@functools.lru_cache(maxsize=None)
def _jax_cell(make, mode, kw, combo, theta=THETA):
    """JAX's value of one cell, or ``None`` where JAX raises."""
    f = make("jax", mode, **dict(kw))
    try:
        return float(_combos("jax", f)[combo](jnp.asarray(theta)))
    except Exception:                                   # noqa: BLE001
        return None


def _check_cell(make, mode, kw, combo, theta=THETA):
    """The port's cell against JAX's: the same value, or both raise (the
    port naming the mode)."""
    want = _jax_cell(make, mode, tuple(sorted(kw.items())), combo, theta)
    f = _combos("torch", make("torch", mode, **kw))[combo]
    if want is None:
        with pytest.raises(RuntimeError, match=f"mode={mode!r}"):
            f(torch.tensor(theta, dtype=F64))
        return None
    got = float(f(torch.tensor(theta, dtype=F64)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    return got


def _closed_second_ridge(theta, ridge):
    """The cells' value with a damped inner solve: JAX's outer level
    differentiates the wrapped solver (exact x*), its inner level solves
    with −∂₁F + ridge·I = H − ridge·I (H = XᵀX + θI), whose tangent is H's,
    as ``custom_linear_solve`` differentiates it."""
    A = XN.T @ XN + theta * np.eye(D)
    Ar = A - ridge * np.eye(D)
    x = np.linalg.solve(A, XN.T @ YN)
    x1 = -np.linalg.solve(A, x)
    # dL/dθ = −2x·(A_r⁻¹ x): differentiate it in θ once more
    u = np.linalg.solve(Ar, x)
    return -2 * (x1 @ u + x @ np.linalg.solve(Ar, x1 - u))


# ---------------------------------------------------------------------------
# the mode × combination matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("combo", COMBOS)
@pytest.mark.parametrize("mode", ["auto", "vjp", "jvp"])
def test_mode_matrix_matches_jax(mode, combo):
    """The reference's matrix with ``solve="cg"``: ``"auto"`` gives all four
    cells, ``"vjp"`` only ``jacfwd(grad)``, ``"jvp"`` only
    ``jacfwd(jacfwd)``; each value is also the closed form."""
    got = _check_cell(_ridge_loss, mode, {"solve": "cg"}, combo)
    assert (got is not None) == (combo in ALLOWED[mode])
    if got is not None:
        np.testing.assert_allclose(got, _closed_second(THETA), atol=ATOL)


@pytest.mark.parametrize("solve", ["normal_cg", "pallas_cg", "gmres", "lu"])
def test_auto_mode_gives_every_combination(solve):
    """Under ``"auto"`` every routed solver gives all four cells (the JAX
    side's ``pallas_cg`` runs its plain reference off the TPU)."""
    for combo in COMBOS:
        got = _check_cell(_ridge_loss, "auto", {"solve": solve}, combo)
        np.testing.assert_allclose(got, _closed_second(THETA), atol=ATOL)


# the cells of a ridge of 1e-2 in JAX: cg, lu and gmres solve A + ridge·I
# in the inner level; normal_cg its normal equations' damped form
RIDGE_CELL = {"cg": 0.0025758726966537, "lu": 0.0025758726966537,
              "gmres": 0.0025758726966537, "normal_cg": 0.0025735263968258}


@pytest.mark.parametrize("solve", sorted(RIDGE_CELL))
def test_ridge_damps_the_inner_solve_only(solve):
    """Regression: x*'s outer derivative once took the spec's ridge too
    and every cell differed from JAX's by 4e-4 relative, silently.  The
    outer level is exact now; the inner solve keeps the ridge."""
    kw = {"solve": solve, "ridge": 1e-2}
    got = [_check_cell(_ridge_loss, "auto", kw, c) for c in COMBOS]
    np.testing.assert_allclose(got, RIDGE_CELL[solve], atol=1e-15,
                               rtol=1e-12)
    if solve != "normal_cg":
        np.testing.assert_allclose(got, _closed_second_ridge(THETA, 1e-2),
                                   rtol=1e-10)


def _ridge_tree_loss(lib, mode="auto", **kw):
    """``_ridge_loss`` with x* a pytree ``{"a": x[:2], "b": x[2:]}``."""
    m = jnp if lib == "jax" else torch
    X, y = (jnp.asarray(XN), jnp.asarray(YN)) if lib == "jax" else \
        (_t(XN), _t(YN))
    eye = jnp.eye(D) if lib == "jax" else torch.eye(D, dtype=F64)
    cat = jnp.concatenate if lib == "jax" else torch.cat

    def F(x, t):
        v = cat([x["a"], x["b"]])
        r = X.T @ (X @ v - y) + t * v
        return {"a": r[:2], "b": r[2:]}

    def solver(init, t):
        v = m.linalg.solve(X.T @ X + t * eye, X.T @ y)
        return {"a": v[:2], "b": v[2:]}

    diff = jdiff if lib == "jax" else tdiff
    wrapped = diff.implicit_diff(optimality_fun=F, tol=SOLVE_TOL, mode=mode,
                                 **kw)(solver)
    return lambda t: sum(m.sum(v ** 2) for v in wrapped(None, t).values())


def test_ridge_through_a_pytree_x_matches_jax():
    """The same repair with x* a pytree and a ridge of 1e-3 (the packages
    once differed by 3.8e-7 at a scale of 3.9e-2)."""
    kw = {"solve": "cg", "ridge": 1e-3}
    got = [_check_cell(_ridge_tree_loss, "auto", kw, c) for c in COMBOS]
    np.testing.assert_allclose(got, _closed_second_ridge(THETA, 1e-3),
                               rtol=1e-10)


@pytest.mark.parametrize("mode", ["auto", "jvp"])
def test_jacfwd_jacfwd_is_the_closed_form_not_two_thirds(mode):
    """Regression: forward over forward once gave 2/3 of the value without
    raising (the tangent of the solve's operator was lost)."""
    want = _closed_second(THETA)
    assert abs(want - 0.0025736910898724) < 1e-15
    loss = _ridge_loss("torch", mode, solve="cg")
    got = float(torch.func.jacfwd(torch.func.jacfwd(loss))(
        torch.tensor(THETA, dtype=F64)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    assert abs(got - 2 / 3 * want) > 1e-4


# ---------------------------------------------------------------------------
# the approximate backward modes
# ---------------------------------------------------------------------------

_q, _ = np.linalg.qr(_rng.standard_normal((D, D)))
MN = _q @ np.diag(np.linspace(-0.5, 0.5, D)) @ _q.T     # ‖M‖ = ½, symmetric
CN = _rng.standard_normal(D)


def _fixed_point_loss(lib, mode="auto", **kw):
    """Σx*² of the contractive fixed point x = θMx + c (‖θM‖ ≤ 0.35 at
    θ = 0.7), where the Neumann series of A = I − θM converges."""
    if lib == "jax":
        M, c = jnp.asarray(MN), jnp.asarray(CN)
        wrapped = jdiff.implicit_diff(
            fixed_point_fun=lambda x, t: t * (M @ x) + c, tol=SOLVE_TOL,
            mode=mode, **kw)(
            lambda init, t: jnp.linalg.solve(jnp.eye(D) - t * M, c))
        return lambda t: jnp.sum(wrapped(None, t) ** 2)
    M, c = _t(MN), _t(CN)
    wrapped = tdiff.implicit_diff(
        fixed_point_fun=lambda x, t: t * (M @ x) + c, tol=SOLVE_TOL,
        mode=mode, **kw)(
        lambda init, t: torch.linalg.solve(torch.eye(D, dtype=F64) - t * M,
                                           c))
    return lambda t: (wrapped(None, t) ** 2).sum()


@pytest.mark.parametrize("backward", ["one_step", "neumann_k",
                                      "jacobian_free"])
def test_approximate_backward_matches_jax(backward):
    """The same polynomial on the flipped direction under ``"auto"``
    (``grad(grad)`` equals ``jacfwd(grad)``), and the polynomial
    differentiated as it stands in ``"vjp"``'s ``jacfwd(grad)`` and
    ``"jvp"``'s ``jacfwd(jacfwd)``: each JAX's value, not the exact one."""
    kw = {"solve": "cg", "backward": backward, "backward_iters": 3}
    auto = [_check_cell(_fixed_point_loss, "auto", kw, c)
            for c in ("grad(grad)", "jacfwd(grad)")]
    np.testing.assert_allclose(auto, auto[0], atol=ATOL)
    vjp = _check_cell(_fixed_point_loss, "vjp", kw, "jacfwd(grad)")
    jvp = _check_cell(_fixed_point_loss, "jvp", kw, "jacfwd(jacfwd)")
    exact = _check_cell(_fixed_point_loss, "auto", {"solve": "cg"},
                        "grad(grad)")
    if backward != "jacobian_free":
        assert abs(auto[0] - exact) > 1e-6 and abs(vjp - auto[0]) > 1e-8
    np.testing.assert_allclose(jvp, vjp, atol=ATOL)


# A single-mode wrapper differentiates its routed routine as it stands, as
# the JAX package's custom_vjp / non-transposable custom_jvp do: the cases
# where the routine gives JAX more cells than the mode alone
ROUTINE_CASES = {
    **{f"ridge-{s}": (_ridge_loss, {"solve": s})
       for s in ("lu", "pallas_cg")},
    **{f"{b}-{s}": (_fixed_point_loss,
                    {"solve": s, "backward": b, "backward_iters": 3})
       for b in ("one_step", "neumann_k", "jacobian_free")
       for s in ("cg", "lu", "pallas_cg")}}
# where the port's pallas_cg op, which has a forward rule, gives a value
# (the closed form) and JAX's Pallas op, reverse-only, raises
PALLAS_FORWARD = {"vjp": "jacfwd(grad)", "jvp": "jacfwd(jacfwd)"}


@pytest.mark.parametrize("mode", ["vjp", "jvp"])
@pytest.mark.parametrize("case", sorted(ROUTINE_CASES))
def test_single_mode_cells_follow_the_routed_routine(case, mode):
    """Each cell of a ``mode="vjp"`` / ``"jvp"`` wrapper as JAX's: its
    value to 1e-8 where JAX gives one, a raise naming the mode where JAX
    raises; ``pallas_cg``'s forward cells are the closed form beside
    JAX's raise."""
    make, kw = ROUTINE_CASES[case]
    got = {}
    for combo in COMBOS:
        if case == "ridge-pallas_cg" and combo == PALLAS_FORWARD[mode]:
            assert _jax_cell(make, mode, tuple(sorted(kw.items())),
                             combo) is None
            got[combo] = float(_combos("torch", make("torch", mode, **kw))[
                combo](torch.tensor(THETA, dtype=F64)))
            np.testing.assert_allclose(got[combo], _closed_second(THETA),
                                       atol=ATOL)
            continue
        got[combo] = _check_cell(make, mode, kw, combo)
    assert ALLOWED[mode] <= {c for c, v in got.items() if v is not None}
    if make is _ridge_loss:
        for v in got.values():
            if v is not None:
                np.testing.assert_allclose(v, _closed_second(THETA),
                                           atol=ATOL)



# ---------------------------------------------------------------------------
# vector θ and batches
# ---------------------------------------------------------------------------

def _newton_loss(lib):
    """A nonlinear root F(x, θ) = XᵀXx − θ₁Xᵀy + θ₀x + θ₂x³ (∂₁₁F ≠ 0),
    solved by 12 Newton steps; the loss Σx*² + θ₂Σx*."""
    if lib == "jax":
        X, y, m = jnp.asarray(XN), jnp.asarray(YN), jnp
        eye, solve = jnp.eye(D), jnp.linalg.solve
    else:
        X, y, m = _t(XN), _t(YN), torch
        eye, solve = torch.eye(D, dtype=F64), torch.linalg.solve

    def F(x, t):
        return X.T @ X @ x - t[1] * (X.T @ y) + t[0] * x + t[2] * x ** 3

    def newton(x, t):
        J = X.T @ X + t[0] * eye + 3 * t[2] * (x ** 2)[:, None] * eye
        return x - solve(J, F(x, t))

    def solver(init, t):
        if lib == "jax":        # one traced step: JAX compiles the loop once
            return jax.lax.fori_loop(0, 12, lambda _, x: newton(x, t),
                                     jnp.zeros(D))
        x = torch.zeros(D, dtype=F64)
        for _ in range(12):
            x = newton(x, t)
        return x

    diff = jdiff if lib == "jax" else tdiff
    wrapped = diff.implicit_diff(optimality_fun=F, solve="gmres",
                                 tol=SOLVE_TOL)(solver)
    return lambda t: (wrapped(None, t) ** 2).sum() + t[2] * \
        wrapped(None, t).sum()


def test_hessian_in_a_vector_theta_matches_jax():
    """``torch.func.hessian`` (and ``jacfwd(jacfwd)``) in θ ∈ R³ against
    ``jax.hessian``, through a root that is nonlinear in x."""
    theta = np.array([0.7, 1.3, 0.05])
    hj = np.asarray(jax.jit(jax.hessian(_newton_loss("jax")))(
        jnp.asarray(theta)))
    loss = _newton_loss("torch")
    for hess in (torch.func.hessian(loss),
                 torch.func.jacfwd(torch.func.jacfwd(loss))):
        np.testing.assert_allclose(_np(hess(_t(theta))), hj, atol=ATOL)
    np.testing.assert_allclose(hj, hj.T, atol=ATOL)


THETAS = np.array([0.5, 0.7, 1.0, 2.0])


def _dispatches(fn, *args):
    """``fn(*args)`` and the number of registry solves it dispatched."""
    tevents.clear_recorded()
    with tevents.observe(record=True):
        out = fn(*args)
        n = sum(e.kind == "dispatch" for e in tevents.recorded())
    tevents.clear_recorded()
    return out, n


@pytest.mark.parametrize("name", ["hessian", "jacfwd(jacfwd)",
                                  "grad(grad)"])
def test_vmap_of_a_second_derivative_is_one_solve_per_level(name):
    """``vmap`` over four θ runs as many registry solves as one instance
    does (each solve one batch), with ``jax.vmap(jax.hessian)``'s values."""
    make = {"hessian": torch.func.hessian,
            "jacfwd(jacfwd)": lambda f: torch.func.jacfwd(
                torch.func.jacfwd(f)),
            "grad(grad)": lambda f: torch.func.grad(torch.func.grad(f))}[name]
    second = make(_ridge_loss("torch", solve="cg"))
    one, n_one = _dispatches(second, torch.tensor(THETA, dtype=F64))
    batch, n_batch = _dispatches(torch.func.vmap(second), _t(THETAS))
    assert n_one == n_batch == 3
    want = jax.jit(jax.vmap(jax.hessian(_ridge_loss("jax", solve="cg"))))(
        jnp.asarray(THETAS))
    np.testing.assert_allclose(_np(batch), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(float(one), _closed_second(THETA), atol=ATOL)


KN = 0.5 * (lambda r: r - r.T)(_rng.standard_normal((D, D)))   # skew


def _skew_loss(lib):
    """A nonsymmetric system, F = Xᵀ(Xx − y) + θx + Kx with K skew, solved
    by ``gmres``; the loss Σx*² + x*·X₀ (the solve's direction matters)."""
    if lib == "jax":
        X, y, K, m, diff = (jnp.asarray(XN), jnp.asarray(YN),
                            jnp.asarray(KN), jnp, jdiff)
        eye = jnp.eye(D)
    else:
        X, y, K, m, diff = _t(XN), _t(YN), _t(KN), torch, tdiff
        eye = torch.eye(D, dtype=F64)
    wrapped = diff.implicit_diff(
        optimality_fun=lambda x, t: X.T @ (X @ x - y) + t * x + K @ x,
        solve="gmres", tol=SOLVE_TOL)(
        lambda init, t: m.linalg.solve(X.T @ X + t * eye + K, X.T @ y))
    return lambda t: m.sum(wrapped(None, t) ** 2) + m.sum(
        wrapped(None, t) * X[0])


@functools.lru_cache(maxsize=None)
def _jax_vmap_skew_hessian():
    return np.asarray(jax.jit(jax.vmap(jax.hessian(_skew_loss("jax"))))(
        jnp.asarray(THETAS)))


@pytest.mark.parametrize("combo", COMBOS)
def test_vmap_of_a_nonsymmetric_second_derivative_matches_jax(combo):
    """``vmap`` of each combination on a nonsymmetric system (each inner
    solve in its own direction, A or Aᵀ) against ``jax.vmap(jax.hessian)``
    and the unbatched port."""
    want = _jax_vmap_skew_hessian()
    second = _combos("torch", _skew_loss("torch"))[combo]
    got = torch.func.vmap(second)(_t(THETAS))
    np.testing.assert_allclose(_np(got), want, atol=ATOL)
    one = [float(second(torch.tensor(t, dtype=F64))) for t in THETAS]
    np.testing.assert_allclose(one, want, atol=ATOL)


# ---------------------------------------------------------------------------
# root_vjp / root_jvp differentiated directly, plain autograd
# ---------------------------------------------------------------------------

V = _rng.standard_normal(D)


def _root_product(lib, which, **kw):
    """θ ↦ a scalar of ``root_vjp`` / ``root_jvp`` at a fixed x*, routed
    by ``kw`` (``solve="cg"`` by default)."""
    kw = dict({"solve": "cg", "tol": SOLVE_TOL}, **kw)
    A = XN.T @ XN + THETA * np.eye(D)
    xs = np.linalg.solve(A, XN.T @ YN)
    if lib == "jax":
        X, y, x, v, diff = (jnp.asarray(XN), jnp.asarray(YN),
                            jnp.asarray(xs), jnp.asarray(V), jdiff)
        one = jnp.asarray(1.0)
    else:
        X, y, x, v, diff = _t(XN), _t(YN), _t(xs), _t(V), tdiff
        one = torch.tensor(1.0, dtype=F64)

    def F(z, t):
        return X.T @ (X @ z - y) + t * z

    if which == "root_vjp":
        return lambda t: diff.root_vjp(F, x, (t,), v, **kw)[0].sum()
    return lambda t: (diff.root_jvp(F, x, (t,), (one,), **kw) * v).sum()


@pytest.mark.parametrize("transform", ["grad", "jvp"])
@pytest.mark.parametrize("which", ["root_vjp", "root_jvp"])
def test_root_products_differentiate_as_in_jax(which, transform):
    """Called directly, the products' solve is differentiated as the JAX
    package's solve loop is: forward mode gives the value, reverse mode
    raises (JAX's while_loop), naming the product."""
    fj, ft = _root_product("jax", which), _root_product("torch", which)
    theta = torch.tensor(THETA, dtype=F64)
    if transform == "grad":
        with pytest.raises(ValueError, match="Reverse-mode"):
            jax.jit(jax.grad(fj))(jnp.asarray(THETA))
        with pytest.raises(RuntimeError, match=which):
            torch.func.grad(ft)(theta)
        return
    want = jax.jit(lambda t: jax.jvp(fj, (t,), (jnp.ones_like(t),))[1])(
        jnp.asarray(THETA))
    got = torch.func.jvp(ft, (theta,), (torch.ones_like(theta),))[1]
    np.testing.assert_allclose(float(got), float(want), atol=ATOL)


ROOT_ROUTES = {"lu": {"solve": "lu"}, "pallas_cg": {"solve": "pallas_cg"},
               "one_step": {"backward": "one_step"}}
# JAX's torch.func.grad of either product: vᵀ∂(A⁻¹∂₂F)/∂θ, the same for
# both since A is symmetric
ROOT_GRAD = {"lu": -0.0019557570902178, "pallas_cg": -0.0019557570902178,
             "one_step": 0.0736569500709236}


@pytest.mark.parametrize("route", sorted(ROOT_ROUTES))
@pytest.mark.parametrize("which", ["root_vjp", "root_jvp"])
def test_root_products_reverse_where_the_routine_allows(which, route):
    """``grad`` of a product routed to ``lu``, ``pallas_cg`` or
    ``one_step`` differentiates the routine in reverse as JAX does; with
    ``pallas_cg`` the port's forward mode gives a value too, where JAX's
    reverse-only Pallas op raises."""
    kw = ROOT_ROUTES[route]
    fj, ft = _root_product("jax", which, **kw), _root_product("torch", which,
                                                             **kw)
    theta = torch.tensor(THETA, dtype=F64)
    want = float(jax.jit(jax.grad(fj))(jnp.asarray(THETA)))
    np.testing.assert_allclose(want, ROOT_GRAD[route], atol=1e-15,
                               rtol=1e-12)
    got = float(torch.func.grad(ft)(theta))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    fwd = float(torch.func.jvp(ft, (theta,), (torch.ones_like(theta),))[1])
    np.testing.assert_allclose(fwd, want, atol=ATOL, rtol=ATOL)
    if route == "pallas_cg":
        with pytest.raises(Exception):
            jax.jit(lambda t: jax.jvp(fj, (t,), (jnp.ones_like(t),))[1])(
                jnp.asarray(THETA))


@pytest.mark.parametrize("backward", ["exact", "one_step"])
def test_plain_autograd_double_backward_matches_jax(backward):
    """``torch.autograd.grad(create_graph=True)`` then ``grad`` again: the
    second call differentiates x* exactly, as ``jax.grad(jax.grad)``."""
    kw = {"solve": "cg"} if backward == "exact" else \
        {"solve": "cg", "backward": backward, "backward_iters": 3}
    loss = _fixed_point_loss("torch", **kw)
    theta = torch.tensor(THETA, dtype=F64, requires_grad=True)
    (g,) = torch.autograd.grad(loss(theta), theta, create_graph=True)
    (h,) = torch.autograd.grad(g, theta)
    want = _jax_cell(_fixed_point_loss, "auto", tuple(sorted(kw.items())),
                     "grad(grad)")
    np.testing.assert_allclose(float(h), want, atol=ATOL, rtol=ATOL)


# ---------------------------------------------------------------------------
# the callers
# ---------------------------------------------------------------------------

DQ, DQFF = 8, 16


def _deq_loss(lib):
    """Σz*² of a DEQ cell at d = 8 (the implicit-layer tests' cell), with
    an exact backward solver."""
    if lib == "jax":
        tanh, norm, m, layer = jnp.tanh, jnp.linalg.norm, jnp, jlayer
    else:
        tanh, norm, m, layer = (torch.tanh, torch.linalg.vector_norm, torch,
                                tlayer)

    def cell(z, x, w):
        out = x + 0.5 * tanh(z @ w["w1"]) @ w["w2"]
        return out / (1.0 + 0.1 * norm(out))

    z0 = jnp.zeros(DQ) if lib == "jax" else torch.zeros(DQ, dtype=F64)
    return lambda x, w: m.sum(layer.deq_fixed_point(
        cell, z0, x, w, fwd_iters=200, fwd_tol=1e-13, bwd_solve="gmres",
        bwd_iters=200) ** 2)


def test_deq_hvp_matches_jax():
    """A Hessian-vector product of the DEQ loss in the weights
    (``jvp`` of ``grad``) against ``jax.jvp(jax.grad)``."""
    rng = np.random.default_rng(1)
    w = {"w1": 0.9 / np.sqrt(DQ) * rng.standard_normal((DQ, DQFF)),
         "w2": 0.9 / np.sqrt(DQFF) * rng.standard_normal((DQFF, DQ))}
    dw = {k: rng.standard_normal(v.shape) for k, v in w.items()}
    x = rng.standard_normal(DQ)
    jl, tl = _deq_loss("jax"), _deq_loss("torch")
    jw = jax.tree_util.tree_map(jnp.asarray, w)
    _, hj = jax.jit(lambda w_, dw_: jax.jvp(
        jax.grad(lambda w2: jl(jnp.asarray(x), w2)), (w_,), (dw_,)))(
        jw, jax.tree_util.tree_map(jnp.asarray, dw))
    tw = {k: _t(v) for k, v in w.items()}
    _, ht = torch.func.jvp(torch.func.grad(lambda w_: tl(_t(x), w_)), (tw,),
                           ({k: _t(v) for k, v in dw.items()},))
    for k in w:
        np.testing.assert_allclose(_np(ht[k]), np.asarray(hj[k]),
                                   atol=ATOL, rtol=1e-6)


def _inner_loss(lib):
    """An outer loss of ``make_implicit_inner``'s ridge solution, θ =
    (log λ, shift) ∈ R²."""
    if lib == "jax":
        X, y, m, bl = jnp.asarray(XN), jnp.asarray(YN), jnp, jbilevel
        eye = jnp.eye(D)
    else:
        X, y, m, bl = _t(XN), _t(YN), torch, tbilevel
        eye = torch.eye(D, dtype=F64)

    def inner(x, t):
        return 0.5 * m.sum((X @ x - y - t[1]) ** 2) + \
            0.5 * m.exp(t[0]) * m.sum(x ** 2)

    def solver(init, t):
        return m.linalg.solve(X.T @ X + m.exp(t[0]) * eye,
                              X.T @ (y + t[1]))

    fn = bl.make_implicit_inner(solver, inner_objective=inner, solve="cg",
                                tol=SOLVE_TOL)
    return lambda t: m.sum((X @ fn(None, t) - y) ** 2)


def test_hessian_through_make_implicit_inner_matches_jax():
    theta = np.array([np.log(0.7), 0.3])
    hj = jax.jit(jax.hessian(_inner_loss("jax")))(jnp.asarray(theta))
    ht = torch.func.hessian(_inner_loss("torch"))(_t(theta))
    np.testing.assert_allclose(_np(ht), np.asarray(hj), atol=ATOL,
                               rtol=1e-9)


def _gd(lib):
    rt, m = (jrt, jnp) if lib == "jax" else (trt, torch)
    X, y = (jnp.asarray(XN), jnp.asarray(YN)) if lib == "jax" else \
        (_t(XN), _t(YN))

    def f(x, t):
        return 0.5 * m.sum((X @ x - y) ** 2) + 0.5 * t * m.sum(x ** 2)

    L = float(np.linalg.eigvalsh(XN.T @ XN).max()) + 2.0
    gd = rt.GradientDescent(f, stepsize=1.0 / L, maxiter=20000, tol=1e-13,
                            solve="cg", linsolve_tol=SOLVE_TOL)
    x0 = jnp.zeros(D) if lib == "jax" else torch.zeros(D, dtype=F64)
    return lambda t: m.sum(gd.run(x0, t)[0] ** 2)


def test_solver_runtime_second_order_as_jax():
    """Through ``run()``: forward over reverse (``hessian``) equals JAX's;
    reverse over reverse raises in both, the port naming the loop (JAX's
    while_loop has no reverse derivative)."""
    fj, ft = _gd("jax"), _gd("torch")
    theta = torch.tensor(THETA, dtype=F64)
    want = float(jax.jit(jax.hessian(fj))(jnp.asarray(THETA)))
    np.testing.assert_allclose(float(torch.func.hessian(ft)(theta)), want,
                               atol=ATOL, rtol=1e-7)
    np.testing.assert_allclose(want, _closed_second(THETA), rtol=1e-6)
    with pytest.raises(ValueError, match="Reverse-mode"):
        jax.jit(jax.grad(jax.grad(fj)))(jnp.asarray(THETA))
    with pytest.raises(RuntimeError, match="GradientDescent.run"):
        torch.func.grad(torch.func.grad(ft))(theta)


def _sgd_loss(lib, backward_data):
    """Σw̄² of SGD's averaged iterate (the stochastic tests' ridge)."""
    from repro import stochastic as jsto
    from repro_torch import stochastic as tsto
    rng = np.random.default_rng(0)
    X = rng.standard_normal((256, 8)) / np.sqrt(8)
    y = X @ rng.standard_normal(8) + 0.1 * rng.standard_normal(256)
    m = jnp if lib == "jax" else torch

    def fun(w, batch, lam):
        Xb, yb = batch
        return 0.5 * m.mean((Xb @ w - yb) ** 2) + 0.5 * lam * m.sum(w ** 2)

    if lib == "jax":
        sampler = jsto.MinibatchSampler(
            data=(jnp.asarray(X), jnp.asarray(y)), batch_size=16, seed=0)
        sgd, w0 = jsto.SGD, jnp.zeros(8)
    else:
        sampler = tsto.MinibatchSampler(data=(X, y), batch_size=16, seed=0,
                                        device="cpu")
        sgd, w0 = tsto.SGD, torch.zeros(8, dtype=F64)
    sol = sgd(fun, sampler=sampler, stepsize=lambda k: 0.5 / (1 + 0.02 * k),
              epochs=3, average_from=16, backward_data=backward_data,
              backward="exact")
    return lambda t: m.sum(sol.run(w0, t)[0] ** 2)


def test_stochastic_second_order_matches_jax():
    """SGD's averaged iterate is no root of F: at the outer level both
    packages differentiate its loop, at the inner one the sampled implicit
    system (``SampledJacobianOperator``); all four cells equal JAX's."""
    fj, ft = _sgd_loss("jax", "sampled"), _sgd_loss("torch", "sampled")
    cj, ct = _combos("jax", fj), _combos("torch", ft)
    for combo in COMBOS:
        want = float(cj[combo](jnp.asarray(0.1)))
        got = float(ct[combo](torch.tensor(0.1, dtype=F64)))
        np.testing.assert_allclose(got, want, rtol=ATOL)
