"""The port's LinearOperator layer against the JAX package and dense truth.

Ported from ``tests/test_operators.py``: matvec, rmatvec, ``.T``,
``diagonal``, ``materialize`` and the dict-leaf ordering of
``ravel_view``.  Inputs come from numpy; both packages compute in float64
(``tests/conftest.py`` enables x64).  Tolerance 1e-12.
"""
import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import operators as jops
from repro_torch.core import operators as tops
from repro_torch.core._tree import ravel_pytree
from repro_torch.interop import from_numpy, to_numpy

ATOL = 1e-12
F64 = torch.float64


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _tree_fun_jax(theta):
    def f(t):
        w, b = t["w"], t["b"]
        return {"w": 2.0 * w + b[:, None] * theta,
                "b": jnp.sin(theta) * b + w.sum(axis=1)}
    return f


def _tree_fun_torch(theta):
    def f(t):
        w, b = t["w"], t["b"]
        return {"w": 2.0 * w + b[:, None] * theta,
                "b": np.sin(theta) * b + w.sum(dim=1)}
    return f


def _examples(rng, d=3):
    # insertion order w, b: JAX ravels dicts in sorted-key order (b, w)
    x = {"w": rng.standard_normal((d, 2)), "b": rng.standard_normal(d)}
    v = {"w": rng.standard_normal((d, 2)), "b": rng.standard_normal(d)}
    return x, v


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                               rtol=0)


def _flat_np(tree):
    return np.asarray(jax.flatten_util.ravel_pytree(
        jax.tree_util.tree_map(jnp.asarray, tree))[0])


class TestJacobianOperator:

    @pytest.mark.parametrize("negate", [False, True])
    def test_protocol_matches_jax(self, rng, negate):
        x, v = _examples(rng)
        theta = 0.7
        Jj = jops.JacobianOperator(_tree_fun_jax(theta),
                                   jax.tree_util.tree_map(jnp.asarray, x),
                                   negate=negate)
        Jt = tops.JacobianOperator(_tree_fun_torch(theta),
                                   from_numpy(x, device="cpu"),
                                   negate=negate)
        vj = jax.tree_util.tree_map(jnp.asarray, v)
        vt = from_numpy(v, device="cpu")
        _close(Jt.materialize(), Jj.materialize())
        _close(_flat_np(to_numpy(Jt.diagonal())), _flat_np(Jj.diagonal()))
        _close(_flat_np(to_numpy(Jt.matvec(vt))), _flat_np(Jj.matvec(vj)))
        _close(_flat_np(to_numpy(Jt.rmatvec(vt))), _flat_np(Jj.rmatvec(vj)))
        _close(Jt.T.materialize(), Jj.T.materialize())

    def test_materialize_is_dense_jacobian(self, rng):
        x, _ = _examples(rng)
        xt = from_numpy(x, device="cpu")
        f = _tree_fun_torch(0.3)
        flat, unravel = ravel_pytree(xt)
        dense = torch.func.jacrev(
            lambda u: ravel_pytree(f(unravel(u)))[0])(flat)
        _close(tops.JacobianOperator(f, xt).materialize(), dense)

    def test_transpose_roundtrip_and_symmetric_shortcut(self, rng):
        x, _ = _examples(rng)
        J = tops.JacobianOperator(_tree_fun_torch(0.3),
                                  from_numpy(x, device="cpu"))
        assert J.T.T is J
        _close(J.T.materialize(), J.materialize().T)
        S = tops.JacobianOperator(lambda t: t, from_numpy(x, device="cpu"),
                                  symmetric=True)
        assert S.T is S

    def test_pd_implies_symmetric_and_conflict_rejected(self, rng):
        x, _ = _examples(rng)
        op = tops.JacobianOperator(lambda t: t, from_numpy(x, device="cpu"),
                                   positive_definite=True)
        assert op.symmetric is True
        with pytest.raises(ValueError, match="contradicts"):
            tops.JacobianOperator(lambda t: t, from_numpy(x, device="cpu"),
                                  symmetric=False, positive_definite=True)


class TestRavelView:

    def test_dict_leaves_ravel_in_jax_order(self, rng):
        x, _ = _examples(rng)
        vt = tops.ravel_view(lambda t: t, from_numpy(x, device="cpu"))
        vj = jops.ravel_view(lambda t: t,
                             jax.tree_util.tree_map(jnp.asarray, x))
        _close(vt.b, vj.b)
        assert np.allclose(np.asarray(vt.b[0, :3]), x["b"])   # "b" first
        back = to_numpy(vt.to_tree(vt.b))
        _close(back["w"], x["w"])
        _close(back["b"], x["b"])

    def test_batched_view_matches_jax(self, rng):
        B = 4
        x = {"w": rng.standard_normal((B, 3, 2)),
             "b": rng.standard_normal((B, 3))}
        scale = rng.standard_normal(8)

        def mv(s):
            return lambda t: {"w": t["w"] * s[2:].reshape(3, 2),
                              "b": t["b"] * s[:2].sum()}

        vt = tops.ravel_view(mv(_t(scale)), from_numpy(x, device="cpu"), 1)
        vj = jops.ravel_view(mv(jnp.asarray(scale)),
                             jax.tree_util.tree_map(jnp.asarray, x), 1)
        assert vt.batched and vj.batched
        _close(vt.b, vj.b)
        _close(vt.mv(vt.b), vj.mv(vj.b))


class TestDenseAndRidge:

    @pytest.mark.parametrize("batched", [False, True])
    def test_dense_operator_protocol(self, rng, batched):
        shape = (3, 5, 5) if batched else (5, 5)
        A = rng.standard_normal(shape)
        v = rng.standard_normal(shape[:-1])
        Dt = tops.DenseOperator(_t(A))
        Dj = jops.DenseOperator(jnp.asarray(A))
        assert Dt.batch_ndim == Dj.batch_ndim
        _close(Dt.matvec(_t(v)), Dj.matvec(jnp.asarray(v)))
        _close(Dt.rmatvec(_t(v)), Dj.rmatvec(jnp.asarray(v)))
        _close(Dt.diagonal(), Dj.diagonal())
        _close(Dt.materialize(), A)
        _close(Dt.T.materialize(), np.swapaxes(A, -1, -2))
        # the probing defaults agree with the O(1) overrides
        probe = tops.FunctionOperator(Dt.matvec, _t(v),
                                      batch_ndim=Dt.batch_ndim)
        _close(probe.materialize(), A)
        _close(probe.diagonal(), np.diagonal(A, axis1=-2, axis2=-1))
        _close(probe.rmatvec(_t(v)), Dj.rmatvec(jnp.asarray(v)))

    def test_ridge_shifted(self, rng):
        A = rng.standard_normal((4, 4))
        A = A @ A.T
        v = rng.standard_normal(4)
        Rt = tops.RidgeShifted(tops.DenseOperator(_t(A), symmetric=True),
                               0.5, positive_definite=True)
        Rj = jops.RidgeShifted(jops.DenseOperator(jnp.asarray(A),
                                                  symmetric=True),
                               0.5, positive_definite=True)
        assert Rt.symmetric and Rt.positive_definite
        _close(Rt.materialize(), Rj.materialize())
        _close(Rt.diagonal(), Rj.diagonal())
        _close(Rt.matvec(_t(v)), Rj.matvec(jnp.asarray(v)))
        _close(Rt.rmatvec(_t(v)), Rj.rmatvec(jnp.asarray(v)))

    def test_function_operator_explicit_rmatvec(self, rng):
        A = rng.standard_normal((4, 4))
        At = _t(A)
        op = tops.FunctionOperator(lambda v: At @ v, torch.zeros(4,
                                                                 dtype=F64),
                                   rmatvec=lambda v: At.T @ v)
        v = rng.standard_normal(4)
        _close(op.rmatvec(_t(v)), A.T @ v)
        _close(op.T.materialize(), A.T)


class TestAdapters:

    def test_as_operator(self, rng):
        A = rng.standard_normal((3, 3))
        assert isinstance(tops.as_operator(A), tops.DenseOperator)
        assert isinstance(tops.as_operator(_t(A)), tops.DenseOperator)
        op = tops.as_operator(lambda v: 2 * v, torch.zeros(3, dtype=F64))
        assert isinstance(op, tops.FunctionOperator)
        assert tops.as_operator(op) is op
        with pytest.raises(ValueError, match="example"):
            tops.as_operator(lambda v: v)
        with pytest.raises(TypeError):
            tops.as_operator(3.0)

    def test_jacobi_preconditioner_from_structure(self, rng):
        x, v = _examples(rng)
        Jt = tops.JacobianOperator(_tree_fun_torch(0.4),
                                   from_numpy(x, device="cpu"))
        Jj = jops.JacobianOperator(_tree_fun_jax(0.4),
                                   jax.tree_util.tree_map(jnp.asarray, x))
        Mt = tops.jacobi_preconditioner_from(Jt)
        Mj = jops.jacobi_preconditioner_from(Jj)
        out_t = Mt(from_numpy(v, device="cpu"))
        out_j = Mj(jax.tree_util.tree_map(jnp.asarray, v))
        _close(_flat_np(to_numpy(out_t)), _flat_np(out_j))


def _jt(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


class TestRemainingOperators:
    """SampledJacobianOperator, BlockDiagonal, ComposedOperator,
    RaveledOperator and block_jacobi_preconditioner against the JAX
    package on the same numpy inputs."""

    @pytest.mark.parametrize("symmetric", [None, True])
    def test_sampled_jacobian_matches_jax(self, rng, symmetric):
        d, k, n = 4, 3, 6
        x0 = rng.standard_normal(d)
        batches = {"X": rng.standard_normal((k, n, d)),
                   "y": rng.standard_normal((k, n))}
        v = rng.standard_normal(d)

        def grad_map(lib):
            def fun(x, batch):
                X, y = batch["X"], batch["y"]
                r = X @ x - y
                t = lib.tanh(x) if lib is jnp else torch.tanh(x)
                return X.T @ r / n + 0.1 * t ** 3
            return fun

        Sj = jops.SampledJacobianOperator(grad_map(jnp), jnp.asarray(x0),
                                          _jt(batches), negate=True,
                                          symmetric=symmetric)
        St = tops.SampledJacobianOperator(grad_map(torch), _t(x0),
                                          from_numpy(batches, device="cpu"),
                                          negate=True, symmetric=symmetric)
        assert St.num_samples == Sj.num_samples == k
        _close(St.matvec(_t(v)), Sj.matvec(jnp.asarray(v)))
        _close(St.rmatvec(_t(v)), Sj.rmatvec(jnp.asarray(v)))
        _close(St.materialize(), Sj.materialize())
        with pytest.raises(ValueError, match="non-empty"):
            tops.SampledJacobianOperator(grad_map(torch), _t(x0), {})

    @pytest.mark.parametrize("batched", [False, True])
    def test_block_diagonal_matches_jax(self, rng, batched):
        shape = (2,) if batched else ()
        A1 = rng.standard_normal(shape + (3, 3))
        A2 = rng.standard_normal(shape + (2, 2))
        A2 = A2 @ np.swapaxes(A2, -1, -2) + np.eye(2)
        v = (rng.standard_normal(shape + (3,)),
             rng.standard_normal(shape + (2,)))
        Bt = tops.BlockDiagonal([tops.DenseOperator(_t(A1)),
                                 tops.DenseOperator(_t(A2), symmetric=True)])
        Bj = jops.BlockDiagonal([jops.DenseOperator(jnp.asarray(A1)),
                                 jops.DenseOperator(jnp.asarray(A2),
                                                    symmetric=True)])
        assert Bt.symmetric is Bj.symmetric is None
        assert Bt.batch_ndim == Bj.batch_ndim == len(shape)
        vt, vj = tuple(_t(a) for a in v), tuple(jnp.asarray(a) for a in v)
        for got, want in zip(Bt.matvec(vt), Bj.matvec(vj)):
            _close(got, want)
        for got, want in zip(Bt.rmatvec(vt), Bj.rmatvec(vj)):
            _close(got, want)
        for got, want in zip(Bt.T.matvec(vt), Bj.T.matvec(vj)):
            _close(got, want)
        for got, want in zip(Bt.diagonal(), Bj.diagonal()):
            _close(got, want)
        _close(Bt.materialize(), Bj.materialize())
        spd = tops.BlockDiagonal([tops.DenseOperator(_t(A2),
                                                     positive_definite=True)])
        assert spd.positive_definite and spd.T is spd
        with pytest.raises(ValueError, match="at least one"):
            tops.BlockDiagonal([])
        with pytest.raises(ValueError, match="batch_ndim"):
            tops.BlockDiagonal([tops.DenseOperator(_t(A1[None] if not batched
                                                      else A1)),
                                tops.DenseOperator(_t(A2[0] if batched
                                                      else A2))])

    def test_composed_operator_matches_jax(self, rng):
        M = rng.standard_normal((4, 4))
        A = rng.standard_normal((4, 4))
        v = rng.standard_normal(4)
        Ct = tops.ComposedOperator(tops.DenseOperator(_t(M)),
                                   tops.DenseOperator(_t(A)))
        Cj = jops.ComposedOperator(jops.DenseOperator(jnp.asarray(M)),
                                   jops.DenseOperator(jnp.asarray(A)))
        assert Ct.symmetric is None and not Ct.positive_definite
        _close(Ct.matvec(_t(v)), Cj.matvec(jnp.asarray(v)))
        _close(Ct.rmatvec(_t(v)), Cj.rmatvec(jnp.asarray(v)))
        _close(Ct.T.matvec(_t(v)), Cj.T.matvec(jnp.asarray(v)))
        _close(Ct.materialize(), M @ A)
        _close(Ct.T.materialize(), (M @ A).T)
        sym = tops.ComposedOperator(tops.DenseOperator(_t(M)),
                                    tops.DenseOperator(_t(A)),
                                    symmetric=True)
        assert sym.T is sym

    def test_raveled_operator_matches_jax(self, rng):
        x, v = _examples(rng)
        Jt = tops.JacobianOperator(_tree_fun_torch(0.7),
                                   from_numpy(x, device="cpu"))
        Jj = jops.JacobianOperator(_tree_fun_jax(0.7), _jt(x))
        Rt, Rj = Jt.raveled(), Jj.raveled()
        assert Rt.raveled() is Rt
        vf = _flat_np(v)
        _close(Rt.ravel(from_numpy(v, device="cpu")), vf)
        _close(Rt.matvec(_t(vf)), Rj.matvec(jnp.asarray(vf)))
        _close(Rt.rmatvec(_t(vf)), Rj.rmatvec(jnp.asarray(vf)))
        _close(Rt.diagonal(), Rj.diagonal())
        _close(Rt.materialize(), Rj.materialize())
        back = Rt.unravel(_t(vf))
        _close(_flat_np(to_numpy(back)), vf)
        double = Rt.ravel_fn(lambda t: {k: 2 * a for k, a in t.items()})
        _close(double(_t(vf)), 2 * vf)
        with pytest.raises(ValueError, match="instance-shaped"):
            tops.RaveledOperator(tops.DenseOperator(_t(np.ones((2, 3, 3)))))

    def test_block_jacobi_preconditioner_matches_jax(self, rng):
        # BlockDiagonal: exact per-block inverse, with and without the
        # dense matrix supplied
        A1 = rng.standard_normal((3, 3)) + 3 * np.eye(3)
        A2 = rng.standard_normal((2, 2)) + 3 * np.eye(2)
        v = (rng.standard_normal(3), rng.standard_normal(2))
        Bt = tops.BlockDiagonal([tops.DenseOperator(_t(A1)),
                                 tops.DenseOperator(_t(A2))])
        Bj = jops.BlockDiagonal([jops.DenseOperator(jnp.asarray(A1)),
                                 jops.DenseOperator(jnp.asarray(A2))])
        for mat in (None, Bt.materialize()):
            Mt = tops.block_jacobi_preconditioner(Bt, materialized=mat)
            Mj = jops.block_jacobi_preconditioner(
                Bj, materialized=None if mat is None else jnp.asarray(mat))
            for got, want in zip(Mt(tuple(_t(a) for a in v)),
                                 Mj(tuple(jnp.asarray(a) for a in v))):
                _close(got, want)
        # any other operator: the domain's pytree leaves are the blocks
        x, w = _examples(rng)
        Jt = tops.JacobianOperator(_tree_fun_torch(0.3),
                                   from_numpy(x, device="cpu"))
        Jj = jops.JacobianOperator(_tree_fun_jax(0.3), _jt(x))
        out_t = tops.block_jacobi_preconditioner(Jt)(
            from_numpy(w, device="cpu"))
        out_j = jops.block_jacobi_preconditioner(Jj)(_jt(w))
        _close(_flat_np(to_numpy(out_t)), _flat_np(out_j))
        # batched leaves
        A = rng.standard_normal((2, 5, 5)) + 4 * np.eye(5)
        ex = {"a": np.zeros((2, 3)), "b": np.zeros((2, 2))}
        u = {"a": rng.standard_normal((2, 3)), "b": rng.standard_normal((2, 2))}
        Dt = tops.DenseOperator(_t(A), from_numpy(ex, device="cpu"))
        Dj = jops.DenseOperator(jnp.asarray(A), _jt(ex))
        got = to_numpy(tops.block_jacobi_preconditioner(Dt)(
            from_numpy(u, device="cpu")))
        want = jops.block_jacobi_preconditioner(Dj)(_jt(u))
        for key in u:
            _close(got[key], want[key])
