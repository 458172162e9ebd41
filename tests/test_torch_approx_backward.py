"""The approximate backward modes of the port against the JAX package.

The single-device cases of ``tests/test_approx_backward.py``: the raw
polynomial apply (hand formulas, preconditioned Richardson, monotone error
estimates, matvec accounting, info fields), spec validation, the wrapped
decorators in both autodiff directions, one batched pass under
``torch.func.vmap``, the deprecated shims' rejection, the runtime's
``estimate_hypergrad_error``, ``solve_bilevel``'s per-step estimate, the
DEQ layer's ``neumann_k``, and the solve service's approximate buckets,
cache isolation and rejections.  Each input is made by numpy from a seed
and fed to both packages in float64; values agree to 1e-10 (polynomials,
solutions) and 1e-8 (gradients, estimates).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.func

from repro.core import bilevel as jbilevel
from repro.core import diff_api as jdiff
from repro.core import linear_solve as jls
from repro.core import solver_runtime as jrt
from repro.core.implicit_layer import deq_fixed_point as jdeq
from repro.runtime.solve_service import SolveService as JService
from repro_torch.core import bilevel as tbilevel
from repro_torch.core import diff_api as tdiff
from repro_torch.core import linear_solve as tls
from repro_torch.core import solver_runtime as trt
from repro_torch.core.implicit_layer import deq_fixed_point as tdeq
from repro_torch.runtime.solve_service import SolveService

jimp = importlib.import_module("repro.core.implicit_diff")
timp = importlib.import_module("repro_torch.core.implicit_diff")

TOL = 1e-10
GTOL = 1e-8
MODES = [("exact", 1), ("one_step", 1), ("jacobian_free", 1),
         ("neumann_k", 2), ("neumann_k", 6)]


def _spd(seed, d, rho):
    """``A = I − ρS`` with ``‖S‖₂ = 1``: eigenvalues in [1−ρ, 1+ρ]."""
    S = np.random.default_rng(seed).standard_normal((d, d))
    S = (S + S.T) / 2.0
    return np.eye(d) - rho * S / np.linalg.norm(S, 2)


def _vec(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape)


def _neumann_ref(A, v, k):
    u = v
    for _ in range(k):
        u = u + (v - A @ u)
    return u


def _poly(mode, k, A, v):
    if mode == "exact":
        return np.linalg.solve(A, v)
    if mode == "jacobian_free":
        return v
    if mode == "one_step":
        return 2.0 * v - A @ v
    return _neumann_ref(A, v, k)


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _close_est(got, want):
    """Error estimates: relative 1e-8, or both at float64 rounding."""
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-8,
                               atol=1e-14)


@pytest.fixture
def spd6():
    return _spd(0, 6, 0.3), _vec(1, 6)


class TestApproxInverseApply:
    """The raw polynomial apply against hand formulas and the JAX one."""

    @pytest.mark.parametrize("mode,k", MODES[1:] + [("neumann_k", 60)])
    @pytest.mark.parametrize("precond", [None, "jacobi"])
    def test_matches_jax(self, spd6, mode, k, precond):
        A, b = spd6
        kw = dict(backward=mode, backward_iters=k, precond=precond,
                  return_info=True)
        At = _t(A)
        uj, ij = jls.approx_inverse_apply(
            jls.operators.DenseOperator(jnp.asarray(A)), jnp.asarray(b), **kw)
        ut, it = tls.approx_inverse_apply(
            tls.operators.DenseOperator(At), _t(b), **kw)
        np.testing.assert_allclose(_np(ut), np.asarray(uj), atol=TOL)
        assert int(it.iterations) == int(ij.iterations) == \
            tls.approx_matvec_count(mode, k)
        _close_est(it.hypergrad_error_estimate, ij.hypergrad_error_estimate)
        assert bool(it.converged) == bool(ij.converged)
        if precond is None:
            np.testing.assert_allclose(_np(ut), _poly(mode, k, A, b),
                                       rtol=1e-10)

    def test_neumann_k1_equals_one_step_and_large_k_is_exact(self, spd6):
        A, b = spd6
        mv = lambda v: _t(A) @ v
        u1 = tls.approx_inverse_apply(mv, _t(b), backward="one_step")
        uk = tls.approx_inverse_apply(mv, _t(b), backward="neumann_k",
                                      backward_iters=1)
        np.testing.assert_allclose(_np(u1), _np(uk), rtol=1e-12)
        u60 = tls.approx_inverse_apply(mv, _t(b), backward="neumann_k",
                                       backward_iters=60)
        np.testing.assert_allclose(_np(u60), np.linalg.solve(A, b),
                                   atol=1e-8)

    def test_preconditioned_neumann_fixes_negated_operator(self):
        # A = −H (stationarity declaration): plain Neumann diverges,
        # jacobi-preconditioned Richardson restores convergence
        H, b = _spd(0, 6, 0.3), _vec(1, 6)
        mv = lambda v: -(_t(H) @ v)
        _, plain = tls.approx_inverse_apply(
            mv, _t(b), backward="neumann_k", backward_iters=10,
            return_info=True)
        u, prec = tls.approx_inverse_apply(
            mv, _t(b), backward="neumann_k", backward_iters=10,
            precond="jacobi", return_info=True)
        assert float(plain.hypergrad_error_estimate) > 1.0
        assert float(prec.hypergrad_error_estimate) < 5e-2
        np.testing.assert_allclose(_np(u), np.linalg.solve(-H, b), atol=5e-2)

    def test_error_estimate_monotone_in_k(self, spd6):
        A, b = spd6
        ests = [float(tls.approx_inverse_apply(
            lambda v: _t(A) @ v, _t(b), backward="neumann_k",
            backward_iters=k, return_info=True)[1].hypergrad_error_estimate)
            for k in (1, 2, 4, 8, 16)]
        assert all(e1 > e2 for e1, e2 in zip(ests, ests[1:])), ests

    def test_matvec_accounting(self, spd6):
        A, b = spd6
        assert tls.approx_matvec_count("jacobian_free") == 0
        assert tls.approx_matvec_count("one_step") == 1
        assert tls.approx_matvec_count("neumann_k", 5) == 5
        with pytest.raises(ValueError, match="unknown approximate"):
            tls.approx_matvec_count("exact")
        calls = []

        def mv(v):
            calls.append(1)
            return _t(A) @ v

        for mode, k, expect in (("jacobian_free", 1, 0), ("one_step", 1, 1),
                                ("neumann_k", 4, 4)):
            calls.clear()
            tls.approx_inverse_apply(mv, _t(b), backward=mode,
                                     backward_iters=k)
            assert len(calls) == expect, (mode, len(calls))
            calls.clear()      # the estimate costs one matvec more
            tls.approx_inverse_apply(mv, _t(b), backward=mode,
                                     backward_iters=k, return_info=True)
            assert len(calls) == expect + 1, (mode, len(calls))

    def test_info_fields_and_estimate_off(self, spd6):
        A, b = spd6
        _, info = tls.approx_inverse_apply(
            lambda v: _t(A) @ v, _t(b), backward="neumann_k",
            backward_iters=3, return_info=True)
        assert int(info.iterations) == 3
        assert info.hypergrad_error_estimate is not None
        _, off = tls.approx_inverse_apply(
            lambda v: _t(A) @ v, _t(b), backward="neumann_k",
            backward_iters=3, error_estimate=False, return_info=True)
        assert off.hypergrad_error_estimate is None
        assert np.isnan(float(off.residual)) and not bool(off.converged)

    def test_rejects_exact_and_bad_iters(self, spd6):
        A, b = spd6
        with pytest.raises(ValueError, match="route 'exact'"):
            tls.approx_inverse_apply(lambda v: _t(A) @ v, _t(b),
                                     backward="exact")
        with pytest.raises(ValueError, match="backward_iters"):
            tls.approx_inverse_apply(lambda v: _t(A) @ v, _t(b),
                                     backward="neumann_k", backward_iters=0)

    def test_batched_apply_matches_jax(self):
        A = np.stack([_spd(s, 5, r) for s, r in ((2, 0.2), (3, 0.6),
                                                   (4, 0.9))])
        b = _vec(5, 3, 5)
        kw = dict(backward="neumann_k", backward_iters=5, batch_ndim=1,
                  return_info=True)
        uj, ij = jls.approx_inverse_apply(
            jls.operators.DenseOperator(jnp.asarray(A)), jnp.asarray(b), **kw)
        ut, it = tls.approx_inverse_apply(
            tls.operators.DenseOperator(_t(A)), _t(b), **kw)
        np.testing.assert_allclose(_np(ut), np.asarray(uj), atol=TOL)
        _close_est(it.hypergrad_error_estimate, ij.hypergrad_error_estimate)
        est = _np(it.hypergrad_error_estimate)
        assert est[0] < est[1] < est[2]


class TestSpecValidation:
    def test_unknown_mode_rejected(self):
        for pkg in (tdiff, jdiff):
            with pytest.raises(ValueError, match="backward"):
                pkg.ImplicitDiffSpec(optimality_fun=lambda x, t: x,
                                     backward="bogus")

    def test_neumann_needs_positive_iters(self):
        for pkg in (tdiff, jdiff):
            with pytest.raises(ValueError, match="backward_iters"):
                pkg.ImplicitDiffSpec(optimality_fun=lambda x, t: x,
                                     backward="neumann_k", backward_iters=0)

    def test_backward_kwargs_roundtrip(self):
        kw = dict(backward="neumann_k", backward_iters=5)
        spec = tdiff.ImplicitDiffSpec(optimality_fun=lambda x, t: x, **kw)
        assert spec.backward_kwargs() == kw == jdiff.ImplicitDiffSpec(
            optimality_fun=lambda x, t: x, **kw).backward_kwargs()
        assert spec.error_estimate is True and spec.system_operator is None


class TestWrappedModeParity:
    """Every mode, both autodiff directions, through the decorators."""

    d = 8

    def _solvers(self, A, **kw):
        Ainv = np.linalg.inv(A)
        js = jimp.custom_root(lambda x, t: t - jnp.asarray(A) @ x,
                              solve="cg", tol=1e-10, **kw)(
            lambda init, t: jnp.asarray(Ainv) @ t)
        ts = timp.custom_root(lambda x, t: t - _t(A) @ x, solve="cg",
                              tol=1e-10, **kw)(lambda init, t: _t(Ainv) @ t)
        return js, ts

    @pytest.mark.parametrize("mode,k", MODES)
    def test_vjp_and_jvp_match_polynomial_and_jax(self, mode, k):
        A = _spd(0, self.d, 0.3)
        c, th, v = _vec(1, self.d), _vec(2, self.d), _vec(3, self.d)
        js, ts = self._solvers(A, backward=mode, backward_iters=k)
        x0 = torch.zeros(self.d, dtype=torch.float64)
        g = torch.func.grad(lambda t: _t(c) @ ts(x0, t))(_t(th))
        np.testing.assert_allclose(_np(g), _poly(mode, k, A, c), atol=1e-7)
        gj = jax.grad(lambda t: jnp.asarray(c) @ js(jnp.zeros(self.d), t))(
            jnp.asarray(th))
        np.testing.assert_allclose(_np(g), np.asarray(gj), atol=GTOL)
        _, dx = torch.func.jvp(lambda t: ts(x0, t), (_t(th),), (_t(v),))
        np.testing.assert_allclose(_np(dx), _poly(mode, k, A, v), atol=1e-7)
        _, dxj = jax.jvp(lambda t: js(jnp.zeros(self.d), t),
                         (jnp.asarray(th),), (jnp.asarray(v),))
        np.testing.assert_allclose(_np(dx), np.asarray(dxj), atol=GTOL)

    def test_neumann_large_k_recovers_exact_grad(self):
        A = _spd(0, self.d, 0.3)
        th = _t(_vec(2, self.d))
        _, exact = self._solvers(A)
        _, approx = self._solvers(A, backward="neumann_k", backward_iters=60)
        x0 = torch.zeros(self.d, dtype=torch.float64)
        loss = lambda s: (lambda t: (s(x0, t) ** 2).sum())
        np.testing.assert_allclose(_np(torch.func.grad(loss(approx))(th)),
                                   _np(torch.func.grad(loss(exact))(th)),
                                   atol=1e-7)

    def test_fixed_point_decorator_takes_backward(self):
        # contractive T: neumann_k is the phantom-gradient approximation
        W = 0.4 * _spd(0, self.d, 0.5)
        Wt = _t(W)
        T = lambda x, t: Wt @ x + t
        solve = lambda init, t: torch.linalg.solve(
            torch.eye(self.d, dtype=torch.float64) - Wt, t)
        th = _t(_vec(2, self.d))
        g_ex = torch.func.grad(lambda t: timp.custom_fixed_point(
            T, solve="cg")(solve)(None, t).sum())(th)
        g_nk = torch.func.grad(lambda t: timp.custom_fixed_point(
            T, backward="neumann_k", backward_iters=40)(solve)(None, t).sum()
        )(th)
        np.testing.assert_allclose(_np(g_nk), _np(g_ex), atol=1e-6)

    def test_root_vjp_estimate_both_directions(self):
        A = _spd(0, self.d, 0.5)
        th, v = _vec(2, self.d), _vec(3, self.d)
        x_star = np.linalg.solve(A, th)
        kw = dict(solve="cg", backward="neumann_k", backward_iters=4,
                  error_estimate=True, return_info=True)
        (gt,), it = tdiff.root_vjp(lambda x, t: t - _t(A) @ x, _t(x_star),
                                   (_t(th),), _t(v), **kw)
        (gj,), ij = jdiff.root_vjp(lambda x, t: t - jnp.asarray(A) @ x,
                                   jnp.asarray(x_star), (jnp.asarray(th),),
                                   jnp.asarray(v), **kw)
        np.testing.assert_allclose(_np(gt), np.asarray(gj), atol=GTOL)
        _close_est(it.hypergrad_error_estimate, ij.hypergrad_error_estimate)
        dt, jt = tdiff.root_jvp(lambda x, t: t - _t(A) @ x, _t(x_star),
                                (_t(th),), (_t(v),), **kw)
        dj, jj = jdiff.root_jvp(lambda x, t: t - jnp.asarray(A) @ x,
                                jnp.asarray(x_star), (jnp.asarray(th),),
                                (jnp.asarray(v),), **kw)
        np.testing.assert_allclose(_np(dt), np.asarray(dj), atol=GTOL)
        _close_est(jt.hypergrad_error_estimate, jj.hypergrad_error_estimate)


class TestVmapOneBatchedPass:
    """The approximate backward under ``torch.func.vmap`` is ONE batched
    polynomial pass: the count of F evaluations does not grow with B."""

    def _counted_grad(self, B, mode, k):
        d = 4
        A = _spd(0, d, 0.3)
        Ainv = np.linalg.inv(A)
        executed = []

        def F(x, theta):
            executed.append(1)
            return theta - _t(A) @ x

        solver = timp.custom_root(F, backward=mode, backward_iters=k)(
            lambda init, t: _t(Ainv) @ t)
        loss = lambda t: (solver(torch.zeros(d, dtype=torch.float64), t)
                          ** 2).sum()
        g = torch.func.vmap(torch.func.grad(loss))(_t(_vec(1, B, d)))
        return len(executed), g

    @pytest.mark.parametrize("mode,k", [("one_step", 1), ("neumann_k", 3),
                                        ("jacobian_free", 1)])
    def test_count_independent_of_batch(self, mode, k):
        n1, _ = self._counted_grad(1, mode, k)
        n8, g8 = self._counted_grad(8, mode, k)
        assert n1 == n8, (f"{mode}: F ran {n8} times at B=8 vs {n1} at "
                          "B=1 — the backward did not batch")
        assert g8.shape == (8, 4)


class TestDeprecatedShimsRejectBackward:
    def test_custom_root_jvp_rejects(self):
        F = lambda x, t: t - x
        with pytest.raises(TypeError, match="backward"):
            timp.custom_root_jvp(F, backward="one_step")
        with pytest.raises(TypeError, match="backward"):
            timp.custom_root_jvp(F, backward_iters=4)

    def test_custom_fixed_point_jvp_rejects(self):
        T = lambda x, t: 0.5 * x + t
        with pytest.raises(TypeError, match="backward"):
            timp.custom_fixed_point_jvp(T, backward="jacobian_free")
        with pytest.raises(TypeError, match="backward"):
            timp.custom_fixed_point_jvp(T, backward_iters=2)


def _gd(pkg, A, **kw):
    arr = jnp.asarray if pkg is jrt else _t
    Am = arr(A)
    return pkg.GradientDescent(fun=lambda x, t: 0.5 * x @ Am @ x - t @ x,
                               maxiter=400, tol=1e-11, **kw)


class TestSolverRuntime:
    def test_estimate_hypergrad_error_matches_jax(self):
        d = 6
        A, th = _spd(0, d, 0.3), _vec(1, d)
        ests = []
        for k in (2, 6):
            kw = dict(backward="neumann_k", backward_iters=k,
                      precond="jacobi")
            gt, gj = _gd(trt, A, **kw), _gd(jrt, A, **kw)
            pt, _ = gt.run(torch.zeros(d, dtype=torch.float64), _t(th))
            pj, _ = gj.run(jnp.zeros(d), jnp.asarray(th))
            np.testing.assert_allclose(_np(pt), np.asarray(pj), atol=TOL)
            et = float(gt.estimate_hypergrad_error(pt, _t(th)))
            ej = float(gj.estimate_hypergrad_error(pj, jnp.asarray(th)))
            _close_est(et, ej)
            ests.append(et)
        assert ests[1] < ests[0] < 1.0, ests

    def test_bilevel_populates_estimate(self):
        d = 6
        A = _spd(0, d, 0.3)
        z = np.zeros(d)
        outer_t = lambda x, t: 0.5 * ((x - 1.0) ** 2).sum()
        outer_j = lambda x, t: 0.5 * jnp.sum((x - 1.0) ** 2)
        kw = dict(outer_steps=2, backward="neumann_k", backward_iters=6)
        st = tbilevel.solve_bilevel(outer_t, _gd(trt, A, precond="jacobi"),
                                    _t(z), _t(z), **kw)
        sj = jbilevel.solve_bilevel(outer_j, _gd(jrt, A, precond="jacobi"),
                                    jnp.asarray(z), jnp.asarray(z), **kw)
        est = st.inner_info.hypergrad_error_estimate
        assert est is not None and float(est) < 0.05
        _close_est(est, sj.inner_info.hypergrad_error_estimate)
        np.testing.assert_allclose(_np(st.theta), np.asarray(sj.theta),
                                   atol=GTOL)
        exact = tbilevel.solve_bilevel(outer_t, _gd(trt, A, precond="jacobi"),
                                       _t(z), _t(z), outer_steps=2)
        assert exact.inner_info.hypergrad_error_estimate is None

    def test_deq_neumann_k_matches_exact_and_jax(self):
        d = 6
        xn = _vec(0, d)

        def out(deq, arr, tanh):
            cell = lambda z, x, w: tanh(w * z * 0.3 + x)
            return lambda xx, **kw: deq(cell, arr(np.zeros(d)), xx, 0.5,
                                        fwd_tol=1e-10, **kw).sum()

        ot = out(tdeq, _t, torch.tanh)
        oj = out(jdeq, jnp.asarray, jnp.tanh)
        g_ex = torch.func.grad(lambda xx: ot(xx, bwd_solve="normal_cg"))(
            _t(xn))
        g_nk = torch.func.grad(lambda xx: ot(xx, backward="neumann_k",
                                             backward_iters=30))(_t(xn))
        np.testing.assert_allclose(_np(g_nk), _np(g_ex), atol=1e-5)
        gj = jax.grad(lambda xx: oj(xx, backward="neumann_k",
                                    backward_iters=30))(jnp.asarray(xn))
        np.testing.assert_allclose(_np(g_nk), np.asarray(gj), atol=GTOL)


class TestSolveService:
    def _system(self, d=6):
        A, th, ct = _spd(0, d, 0.3), _vec(1, d), _vec(2, d)
        return A, th, ct, np.linalg.solve(A, th)

    def _submit_all(self, svc, F, x_star, th, ct, to):
        futs = {
            "exact": svc.submit_hypergrad(F, to(x_star), to(th), to(ct)),
            "one_step": svc.submit_hypergrad(F, to(x_star), to(th), to(ct),
                                             backward="one_step"),
            "neumann_k": svc.submit_hypergrad(F, to(x_star), to(th), to(ct),
                                              backward="neumann_k",
                                              backward_iters=8),
            "jacobian_free": svc.submit_hypergrad(
                F, to(x_star), to(th), to(ct), backward="jacobian_free"),
        }
        svc.flush()
        return {m: f.result() for m, f in futs.items()}

    def test_approx_buckets_and_estimates_match_jax(self):
        A, th, ct, x_star = self._system()
        res = self._submit_all(SolveService(device="cpu"),
                               lambda x, t: t - _t(A) @ x, x_star, th, ct,
                               _t)
        ref = self._submit_all(JService(),
                               lambda x, t: t - jnp.asarray(A) @ x, x_star,
                               th, ct, jnp.asarray)
        np.testing.assert_allclose(_np(res["one_step"].x[0]),
                                   2 * ct - A @ ct, atol=1e-9)
        np.testing.assert_allclose(_np(res["jacobian_free"].x[0]), ct,
                                   atol=1e-12)
        np.testing.assert_allclose(_np(res["exact"].x[0]),
                                   np.linalg.solve(A, ct), atol=1e-5)
        # distinct matvec budgets prove distinct bucket arms
        assert [res[m].info.iterations for m in
                ("one_step", "neumann_k", "jacobian_free")] == [1, 8, 0]
        assert (res["neumann_k"].info.hypergrad_error_estimate
                < res["one_step"].info.hypergrad_error_estimate)
        for m in ("one_step", "neumann_k", "jacobian_free"):
            np.testing.assert_allclose(_np(res[m].x[0]),
                                       np.asarray(ref[m].x[0]), atol=TOL)
            _close_est(res[m].info.hypergrad_error_estimate,
                       ref[m].info.hypergrad_error_estimate)
            assert res[m].info.iterations == ref[m].info.iterations

    def test_spec_default_and_override(self):
        A, th, ct, x_star = self._system()
        F = lambda x, t: t - _t(A) @ x
        spec = tdiff.ImplicitDiffSpec(optimality_fun=F,
                                      backward="neumann_k", backward_iters=4)
        svc = SolveService(device="cpu")
        f_spec = svc.submit_hypergrad(F, _t(x_star), _t(th), _t(ct),
                                      spec=spec)
        f_over = svc.submit_hypergrad(F, _t(x_star), _t(th), _t(ct),
                                      spec=spec, backward="exact")
        svc.flush()
        assert int(f_spec.result().info.iterations) == 4
        np.testing.assert_allclose(_np(f_over.result().x[0]),
                                   np.linalg.solve(A, ct), atol=1e-5)

    def test_approx_requests_never_enter_cache(self):
        A, th, ct, x_star = self._system()
        F = lambda x, t: t - _t(A) @ x
        svc = SolveService(device="cpu")
        svc.submit_hypergrad(F, _t(x_star), _t(th), _t(ct),
                             backward="one_step")
        svc.flush()
        assert len(svc.cache) == 0
        assert svc.cache.hits == svc.cache.misses == 0
        svc.submit_hypergrad(F, _t(x_star), _t(th), _t(ct))
        svc.flush()
        assert len(svc.cache) == 1

    def test_block_jacobi_approx_and_unknown_mode_rejected(self):
        A, th, ct, x_star = self._system()
        F = lambda x, t: t - _t(A) @ x
        svc = SolveService(device="cpu")
        with pytest.raises(ValueError, match="block_jacobi"):
            svc.submit_hypergrad(F, _t(x_star), _t(th), _t(ct),
                                 backward="one_step", precond="block_jacobi")
        with pytest.raises(ValueError, match="backward"):
            svc.submit_hypergrad(F, _t(x_star), _t(th), _t(ct),
                                 backward="bogus")
        with pytest.raises(ValueError, match="backward_iters"):
            svc.submit_hypergrad(F, _t(x_star), _t(th), _t(ct),
                                 backward="neumann_k", backward_iters=0)
        # block_jacobi stays legal on the exact arm
        f = svc.submit_hypergrad(F, _t(x_star), _t(th), _t(ct),
                                 precond="block_jacobi")
        svc.flush()
        np.testing.assert_allclose(_np(f.result().x[0]),
                                   np.linalg.solve(A, ct), atol=1e-5)


def test_block_jacobi_on_the_cotangent_system_is_that_of_At():
    """Documented difference (ROADMAP C): with an approximate mode and
    ``precond="block_jacobi"`` on a nonsymmetric A, the port's reverse
    mode preconditions Aᵀu = v with Aᵀ's blocks, as the reference's
    ``root_vjp`` and ``mode="vjp"`` do; the reference's default wrapper
    reuses A's blocks for the transposed system.  Forward mode and
    ``"jacobi"`` (the same diagonal either way) agree with the default."""
    d = 6
    A = np.eye(d) + 0.3 * _vec(0, d, d)
    Ainv = np.linalg.inv(A)
    c, th = _vec(1, d), _vec(2, d)
    kw = dict(backward="neumann_k", backward_iters=3)

    def jsolver(precond, mode):
        spec = jdiff.ImplicitDiffSpec(
            optimality_fun=lambda x, t: t - jnp.asarray(A) @ x,
            precond=precond, **kw)
        return jdiff.implicit_diff(spec, mode=mode)(
            lambda init, t: jnp.asarray(Ainv) @ t)

    for precond in ("jacobi", "block_jacobi"):
        ts = timp.custom_root(lambda x, t: t - _t(A) @ x, precond=precond,
                              **kw)(lambda init, t: _t(Ainv) @ t)
        gt = torch.func.grad(lambda t: _t(c) @ ts(None, t))(_t(th))
        gj = jax.grad(lambda t: jnp.asarray(c) @ jsolver(precond, "vjp")(
            None, t))(jnp.asarray(th))
        np.testing.assert_allclose(_np(gt), np.asarray(gj), atol=GTOL)
        _, dt = torch.func.jvp(lambda t: ts(None, t), (_t(th),), (_t(c),))
        _, dj = jax.jvp(lambda t: jsolver(precond, "auto")(None, t),
                        (jnp.asarray(th),), (jnp.asarray(c),))
        np.testing.assert_allclose(_np(dt), np.asarray(dj), atol=GTOL)
