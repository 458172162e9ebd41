"""The port's solve registry against the JAX package's.

``route_solve`` for ``cg``, ``normal_cg``, ``dense_gmres``, ``lu`` and
``pallas_cg`` on the same float64 systems: x to 1e-10, per-instance
``iterations`` equal (-1 for ``pallas_cg``) and ``converged`` equal;
``_resolve_auto`` choices equal; the symmetric-only refusal; ``solve``
with ``batch_axes``.  ``bicgstab``, ``gmres`` and ``neumann`` on batches
whose instances converge at different iterations (masked), with and
without ``jacobi`` / ``block_jacobi``: the same checks, plus the
residual; ``materialize_matrix`` on a closure and on an operator.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import linear_solve as jls
from repro.core import operators as jops
from repro_torch.core import linear_solve as tls
from repro_torch.core import operators as tops

TOL = 1e-10


def _spd(rng, B, d):
    M = rng.standard_normal((B, d, d))
    return np.einsum("bij,bkj->bik", M, M) / d + np.eye(d)


def _general(rng, B, d):
    return rng.standard_normal((B, d, d)) / np.sqrt(d) + 2.0 * np.eye(d)


def _np(a):
    return np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a)


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "single"])
@pytest.mark.parametrize("solver", ["cg", "normal_cg", "dense_gmres", "lu",
                                    "pallas_cg"])
def test_route_solve_matches_jax(solver, batched):
    rng = np.random.default_rng(3)
    B, d = 5, 12
    symmetric = solver in ("cg", "pallas_cg")
    A = _spd(rng, B, d) if symmetric else _general(rng, B, d)
    b = rng.standard_normal((B, d))
    if not batched:
        A, b = A[0], b[0]
    flags = dict(symmetric=True, positive_definite=True) if symmetric \
        else dict(symmetric=False)
    opj = jops.DenseOperator(jnp.asarray(A), **flags)
    opt = tops.DenseOperator(torch.from_numpy(A), **flags)
    xj, ij = jls.route_solve(solver, opj, jnp.asarray(b), tol=TOL,
                             maxiter=500, return_info=True)
    xt, it = tls.route_solve(solver, opt, torch.from_numpy(b), tol=TOL,
                             maxiter=500, return_info=True)
    np.testing.assert_allclose(_np(xt), np.asarray(xj), atol=1e-10)
    np.testing.assert_array_equal(_np(it.iterations), np.asarray(ij.iterations))
    np.testing.assert_array_equal(_np(it.converged), np.asarray(ij.converged))
    if solver == "pallas_cg":
        assert (_np(it.iterations) == -1).all()


def test_tree_system_through_jacobian_operator():
    """A dict-valued system (JAX ravel order) routed through both."""
    rng = np.random.default_rng(4)
    Ww, Wb = rng.standard_normal((3, 3)), rng.standard_normal((2, 2))
    Ww, Wb = Ww @ Ww.T + 3 * np.eye(3), Wb @ Wb.T + 2 * np.eye(2)
    x0 = {"w": np.zeros(3), "b": np.zeros(2)}
    rhs = {"w": rng.standard_normal(3), "b": rng.standard_normal(2)}

    def F(lib, Ww, Wb):
        return lambda t: {"w": Ww @ t["w"] + 0.1 * t["b"].sum(),
                          "b": Wb @ t["b"] + 0.1 * t["w"][:2]}

    Aj = jops.JacobianOperator(F(jnp, jnp.asarray(Ww), jnp.asarray(Wb)),
                               {k: jnp.asarray(v) for k, v in x0.items()})
    At = tops.JacobianOperator(F(torch, torch.from_numpy(Ww),
                                 torch.from_numpy(Wb)),
                               {k: torch.from_numpy(v) for k, v in x0.items()})
    for solver in ("normal_cg", "dense_gmres", "lu"):
        xj, ij = jls.route_solve(solver, Aj, {k: jnp.asarray(v) for k, v
                                              in rhs.items()},
                                 tol=TOL, return_info=True)
        xt, it = tls.route_solve(solver, At, {k: torch.from_numpy(v) for k, v
                                              in rhs.items()},
                                 tol=TOL, return_info=True)
        for k in rhs:
            np.testing.assert_allclose(_np(xt[k]), np.asarray(xj[k]),
                                       atol=1e-10)
        assert int(it.iterations) == int(ij.iterations)


@pytest.mark.parametrize("precond", [None, "jacobi"])
def test_cg_preconditioned_iterations_match(precond):
    rng = np.random.default_rng(5)
    A = _spd(rng, 4, 20) * np.logspace(0, 2, 20)[None, :, None] ** 0.5
    A = (A + np.swapaxes(A, 1, 2)) / 2 + 20 * np.eye(20)
    b = rng.standard_normal((4, 20))
    opj = jops.DenseOperator(jnp.asarray(A), positive_definite=True)
    opt = tops.DenseOperator(torch.from_numpy(A), positive_definite=True)
    _, ij = jls.route_solve("cg", opj, jnp.asarray(b), tol=TOL,
                            precond=precond, return_info=True)
    _, it = tls.route_solve("cg", opt, torch.from_numpy(b), tol=TOL,
                            precond=precond, return_info=True)
    np.testing.assert_array_equal(_np(it.iterations), np.asarray(ij.iterations))


def test_resolve_auto_choices_equal():
    for spd, d, precond, init in itertools.product(
            (True, False), (4, 512, 513), (None, "jacobi"), (None, True)):
        ex = np.zeros(d)
        opj = jops.DenseOperator(jnp.eye(2), positive_definite=spd)
        opt = tops.DenseOperator(torch.eye(2, dtype=torch.float64),
                                 positive_definite=spd)
        want = jls._resolve_auto(opj, jnp.asarray(ex), precond, init)
        got = tls._resolve_auto(opt, torch.from_numpy(ex), precond, init)
        assert got == want, (spd, d, precond, init)
    # bare closures carry no flags: never SPD
    assert tls._resolve_auto(lambda v: v, torch.zeros(8)) == \
        jls._resolve_auto(lambda v: v, jnp.zeros(8)) == "dense_gmres"


@pytest.mark.parametrize("solver", ["cg", "pallas_cg"])
def test_symmetric_only_refusal(solver):
    A = np.triu(np.ones((4, 4))) + 3 * np.eye(4)
    with pytest.raises(ValueError, match="symmetric-only"):
        tls.route_solve(solver, tops.DenseOperator(torch.from_numpy(A),
                                                   symmetric=False),
                        torch.ones(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="symmetric-only"):
        jls.route_solve(solver, jops.DenseOperator(jnp.asarray(A),
                                                   symmetric=False),
                        jnp.ones(4))
    assert tls.get_spec(solver).symmetric_only
    assert tls.solver_is_symmetric(solver) == jls.solver_is_symmetric(solver)


def test_registry_errors():
    with pytest.raises(ValueError, match="unknown linear solver"):
        tls.get_spec("no_such_solver")
    with pytest.raises(ValueError, match="preconditioning"):
        tls.route_solve("lu", tops.DenseOperator(torch.eye(3)),
                        torch.ones(3), precond="jacobi")
    with pytest.raises(ValueError, match="warm starts"):
        tls.route_solve("pallas_cg", tops.DenseOperator(
            torch.eye(3), positive_definite=True), torch.ones(3),
            init=torch.zeros(3))
    # block_jacobi derives its blocks from operator structure: a bare
    # closure has none (the JAX package's error)
    for pkg, eye, ones in ((tls, torch.eye(3), torch.ones(3)),
                           (jls, jnp.eye(3), jnp.ones(3))):
        with pytest.raises(ValueError, match="LinearOperator"):
            pkg.route_solve("cg", lambda v, e=eye: e @ v, ones,
                            precond="block_jacobi")
    assert set(tls.BACKWARD_MODES) == set(jls.BACKWARD_MODES)


@pytest.mark.parametrize("axis", [0, 1])
def test_solve_batch_axes_matches_jax(axis):
    rng = np.random.default_rng(6)
    B, d = 3, 6
    A = _spd(rng, B, d)
    b = rng.standard_normal((B, d))
    b_ax = np.moveaxis(b, 0, axis)

    def mv(lib, A):
        def f(v):
            vb = lib.moveaxis(v, axis, 0) if lib is jnp else \
                torch.movedim(v, axis, 0)
            out = lib.einsum("bij,bj->bi", A, vb)
            return lib.moveaxis(out, 0, axis) if lib is jnp else \
                torch.movedim(out, 0, axis)
        return f

    xj, ij = jls.solve(mv(jnp, jnp.asarray(A)), jnp.asarray(b_ax),
                       method="cg", batch_axes=axis, tol=TOL,
                       return_info=True)
    xt, it = tls.solve(mv(torch, torch.from_numpy(A)), torch.from_numpy(b_ax),
                       method="cg", batch_axes=axis, tol=TOL,
                       return_info=True)
    np.testing.assert_allclose(_np(xt), np.asarray(xj), atol=1e-10)
    np.testing.assert_array_equal(_np(it.iterations), np.asarray(ij.iterations))


def test_solve_auto_and_operator_batch_inference():
    rng = np.random.default_rng(7)
    A = _spd(rng, 4, 10)
    b = rng.standard_normal((4, 10))
    op = tops.DenseOperator(torch.from_numpy(A), positive_definite=True)
    x = tls.solve(op, torch.from_numpy(b), method="auto", tol=TOL)
    np.testing.assert_allclose(_np(x), np.linalg.solve(A, b[..., None])[..., 0],
                               atol=1e-9)
    with pytest.raises(ValueError, match="incompatible"):
        tls.solve(op, torch.from_numpy(b), batch_axes=1)


def _mixed(rng, B, d, nonsym=True):
    """B systems whose conditioning differs per instance, so each instance
    stops at its own iteration and the masks matter; two dict leaves
    (sizes 3 and d - 3) make two blocks for ``block_jacobi``."""
    A = rng.standard_normal((B, d, d)) / np.sqrt(d)
    if not nonsym:
        A = (A + np.swapaxes(A, 1, 2)) / 2
    shift = np.linspace(1.5, 6.0, B)[:, None, None]
    return A * np.linspace(0.4, 1.2, B)[:, None, None] + shift * np.eye(d)


@pytest.mark.parametrize("precond", [None, "jacobi", "block_jacobi"])
@pytest.mark.parametrize("batched", [True, False], ids=["batched", "single"])
@pytest.mark.parametrize("solver", ["bicgstab", "gmres"])
def test_general_solvers_match_jax(solver, batched, precond):
    rng = np.random.default_rng(11)
    B, d = 5, 10
    A = _mixed(rng, B, d)
    b = rng.standard_normal((B, d))
    ex = {"lo": np.zeros((B, 3)), "hi": np.zeros((B, d - 3))}
    rhs = {"lo": b[:, :3], "hi": b[:, 3:]}
    if not batched:
        A, ex, rhs = A[0], {k: v[0] for k, v in ex.items()}, \
            {k: v[0] for k, v in rhs.items()}
    opj = jops.DenseOperator(jnp.asarray(A), {k: jnp.asarray(v)
                                              for k, v in ex.items()})
    opt = tops.DenseOperator(torch.from_numpy(A), {k: torch.from_numpy(v)
                                                   for k, v in ex.items()})
    kw = dict(tol=TOL, maxiter=400, precond=precond, return_info=True)
    if solver == "gmres":
        kw["maxiter"] = 60          # 3 restart cycles of 20
    xj, ij = jls.route_solve(solver, opj, {k: jnp.asarray(v) for k, v
                                           in rhs.items()}, **kw)
    xt, it = tls.route_solve(solver, opt, {k: torch.from_numpy(v) for k, v
                                           in rhs.items()}, **kw)
    for k in rhs:
        np.testing.assert_allclose(_np(xt[k]), np.asarray(xj[k]), atol=TOL)
    np.testing.assert_array_equal(_np(it.iterations), np.asarray(ij.iterations))
    np.testing.assert_array_equal(_np(it.converged), np.asarray(ij.converged))
    np.testing.assert_allclose(_np(it.residual), np.asarray(ij.residual),
                               atol=1e-10)
    if batched and precond is None and solver == "bicgstab":
        # the conditioning spread really makes the instances stop apart
        assert len(set(_np(it.iterations).tolist())) > 1


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "single"])
def test_neumann_matches_jax(batched):
    rng = np.random.default_rng(12)
    B, d = 4, 8
    M = rng.standard_normal((B, d, d))
    M /= np.linalg.norm(M, 2, axis=(1, 2))[:, None, None]
    A = np.eye(d) - np.array([0.2, 0.5, 0.7, 0.9])[:, None, None] * M
    b = rng.standard_normal((B, d))
    if not batched:
        A, b = A[2], b[2]
    opj = jops.DenseOperator(jnp.asarray(A))
    opt = tops.DenseOperator(torch.from_numpy(A))
    for kw in (dict(tol=TOL, maxiter=500), dict(tol=0.0, maxiter=7),
               dict(tol=1e-6, maxiter=500, ridge=0.1)):
        xj, ij = jls.route_solve("neumann", opj, jnp.asarray(b),
                                 return_info=True, **kw)
        xt, it = tls.route_solve("neumann", opt, torch.from_numpy(b),
                                 return_info=True, **kw)
        np.testing.assert_allclose(_np(xt), np.asarray(xj), atol=TOL)
        np.testing.assert_array_equal(_np(it.iterations),
                                      np.asarray(ij.iterations))
        np.testing.assert_array_equal(_np(it.converged),
                                      np.asarray(ij.converged))
    # the local default is the fixed-K truncation (tol 0, 10 terms)
    xt = tls.solve_neumann(opt, torch.from_numpy(b),
                           batch_ndim=int(batched))
    xj = jls.solve_neumann(opj, jnp.asarray(b), batch_ndim=int(batched))
    np.testing.assert_allclose(_np(xt), np.asarray(xj), atol=TOL)


def test_new_registry_entries_match_jax():
    for name in ("bicgstab", "gmres", "neumann", "sharded_cg",
                 "sharded_normal_cg", "sharded_dense_gmres"):
        t, j = tls.get_spec(name), jls.get_spec(name)
        assert (t.symmetric_only, t.matrix_free, t.supports_precond,
                t.description) == (j.symmetric_only, j.matrix_free,
                                   j.supports_precond, j.description)
    assert set(jls.available_solvers()) == set(tls.available_solvers())


def test_materialize_matrix_matches_jax():
    rng = np.random.default_rng(13)
    A = rng.standard_normal((5, 5))
    At = torch.from_numpy(A)
    got = tls.materialize_matrix(lambda v: At @ v,
                                 torch.zeros(5, dtype=torch.float64))
    want = jls.materialize_matrix(lambda v: jnp.asarray(A) @ v, jnp.zeros(5))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-12)
    np.testing.assert_allclose(_np(got), A, atol=1e-12)
    op = tops.DenseOperator(At)
    assert tls.materialize_matrix(op, torch.zeros(5)) is op.A
