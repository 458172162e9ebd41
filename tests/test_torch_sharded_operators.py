"""The port's sharded operators and solvers against the JAX package's.

Single rank, in process: a gloo process group over a file store under
``tmp_path`` (destroyed at teardown) and a one-rank ``DeviceMesh`` from
``repro_torch.launch.mesh.make_solve_mesh``, against the JAX package on its
one-device mesh — the port of ``tests/test_sharded_operators.py``.  The
same numpy inputs, float64 against float64:

  * the ``ShardedOperator`` protocol against its base (matvec, rmatvec,
    transpose, diagonal, materialize, factory operands) and against JAX's;
    plain tensors (global values) and DTensors (to_local / from_local);
  * ``sharded_cg`` / ``sharded_normal_cg`` / ``sharded_dense_gmres``
    against JAX's: solutions within 1e-10, per-instance iteration counts
    equal; ``sharded_dense_gmres`` refuses instance sharding;
  * ``auto`` routing and the ``cg`` → ``sharded_cg`` upgrade, cold and
    with seeded tuning caches; ``route_solve`` sizing from one instance;
    the Jacobi preconditioner through ``sharded_cg``;
  * grad, jvp and ``mode="vjp"`` of a sharded ``implicit_diff``,
    ``root_vjp`` / ``root_jvp(sharding=...)`` and
    ``GradientDescent(sharding=...)``, each against JAX within 1e-8; a spy
    that counts one sharded backward solve per gradient; ``vmap`` of a
    sharded solve and of a sharded gradient equals JAX's vmap (one folded
    solve where the operator is shared);
  * second derivatives through the sharded solve: the four combinations
    in each ``mode`` against JAX's one-device mesh (a value within 1e-8,
    or a raise where JAX raises), and ``vmap`` of ``hessian`` as one
    folded sharded solve per level;
  * the sharded rows of ``autotune.measure_solver`` and
    ``launch.mesh.auto_mesh_size``;
  * the paper's §4.4 molecular-dynamics sensitivity in the port
    (``repro_torch.launch.md_sensitivity``) against
    ``examples/md_sensitivity.py``'s three routes, computed here by the
    JAX package from the same starting positions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.func
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from repro.core import linear_solve as jls
from repro.core import operators as jops
from repro.core.diff_api import ImplicitDiffSpec as JSpec
from repro.core.diff_api import implicit_diff as jimplicit
from repro.core.diff_api import root_jvp as jroot_jvp
from repro.core.diff_api import root_vjp as jroot_vjp
from repro.core.solver_runtime import GradientDescent as JGD
from repro.distributed.sharded_operators import ShardedOperator as JSharded
from repro.distributed.sharded_operators import SolveSharding as JSolveSharding
from repro.launch import mesh as jmesh_mod
from repro_torch.analysis import autotune
from repro_torch.core import linear_solve as ls
from repro_torch.core import operators as ops
from repro_torch.core.diff_api import ImplicitDiffSpec, implicit_diff
from repro_torch.core.diff_api import root_jvp, root_vjp
from repro_torch.core.solver_runtime import GradientDescent
from repro_torch.distributed.sharded_operators import (ShardedOperator,
                                                       SolveSharding,
                                                       instance_axes,
                                                       psum_reduction)
from repro_torch.distributed import sharded_operators as dso
from repro_torch.distributed.spec import P
from repro_torch.launch import mesh as tmesh_mod

B = 16
SOL_TOL = 1e-10     # solutions
GRAD_TOL = 1e-8     # gradients


@pytest.fixture
def npr():
    return np.random.RandomState(0)


@pytest.fixture
def mesh(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        yield tmesh_mod.make_solve_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jmesh():
    return jmesh_mod.make_solve_mesh()


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(t):
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _spd(npr, n, d, shift=0.5):
    C = npr.randn(n, d, d) / np.sqrt(d)
    return np.einsum("bji,bjk->bik", C, C) + shift * np.eye(d)


class _DiagOp(ops.LinearOperator):
    """Elementwise (block-diagonal) operator — shard-local along ANY dim."""

    def __init__(self, dg, **kw):
        super().__init__(torch.zeros_like(dg), **kw)
        self.dg = dg

    def matvec(self, v):
        return self.dg * v


class _JDiagOp(jops.LinearOperator):
    def __init__(self, dg, **kw):
        super().__init__(jnp.zeros_like(dg), **kw)
        self.dg = dg

    def matvec(self, v):
        return self.dg * v


# ---------------------------------------------------------------------------
# specs and the operator protocol
# ---------------------------------------------------------------------------

def test_partition_spec_reads_like_jax_and_converts_to_placements(mesh):
    from torch.distributed.tensor import Replicate
    from repro_torch.distributed.spec import placements
    for entries in [(), ("data",), ("data", None), (None, ("data",)),
                    (("pod", "data"), None, "model")]:
        assert tuple(P(*entries)) == tuple(JP(*entries))
        assert P(*entries) == tuple(JP(*entries))
        assert len(P(*entries)) == len(JP(*entries))
    assert P("data", None) != P("data")
    assert placements(mesh, P("data", None), 2) == (Shard(0),)
    assert placements(mesh, P(None, "data"), 2) == (Shard(1),)
    assert placements(mesh, P(), 3) == (Replicate(),)
    with pytest.raises(ValueError, match="rank"):
        placements(mesh, P(None, None, "data"), 2)
    with pytest.raises(ValueError, match="not one of"):
        placements(mesh, P("model"), 1)
    with pytest.raises(TypeError):
        P(3)


def test_batch_sharded_dense_matches_base_and_jax(npr, mesh, jmesh):
    d = 5
    A = _spd(npr, B, d)
    v = npr.randn(B, d)
    base = ops.DenseOperator(_t(A), positive_definite=True)
    sh = ShardedOperator(base, mesh, P("data", None))
    jsh = JSharded(jops.DenseOperator(jnp.asarray(A), positive_definite=True),
                   jmesh, JP("data", None))
    assert sh.is_sharded and not base.is_sharded
    assert sh.symmetric and sh.positive_definite and sh.batch_ndim == 1
    assert not sh.instance_sharded and not jsh.instance_sharded
    for got, base_v, want in [
            (sh.matvec(_t(v)), base.matvec(_t(v)), jsh.matvec(jnp.asarray(v))),
            (sh.rmatvec(_t(v)), base.rmatvec(_t(v)),
             jsh.rmatvec(jnp.asarray(v))),
            (sh.diagonal(), base.diagonal(), jsh.diagonal()),
            (sh.materialize(), _t(A), jsh.materialize())]:
        np.testing.assert_allclose(_np(got), _np(base_v), rtol=1e-12)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-12)


def test_dtensors_cross_without_a_gather(npr, mesh):
    d = 4
    A = _spd(npr, B, d)
    v = _t(npr.randn(B, d))
    sh = ShardedOperator(ops.DenseOperator(_t(A), positive_definite=True),
                         mesh, P("data", None))
    vd = distribute_tensor(v, mesh, [Shard(0)])
    out = sh.matvec(vd)
    assert isinstance(out, DTensor) and out.placements == (Shard(0),)
    np.testing.assert_allclose(_np(out), _np(sh.matvec(v)), rtol=1e-14)
    # a DTensor on another placement is redistributed to the spec first
    out = sh.matvec(vd.redistribute(mesh, [torch.distributed.tensor
                                           .Replicate()]))
    assert out.placements == (Shard(0),)
    x, info = ls.solve(sh, vd, method="sharded_cg", tol=1e-12,
                       return_info=True)
    assert isinstance(x, DTensor) and isinstance(info.iterations, DTensor)
    np.testing.assert_allclose(
        _np(x), np.linalg.solve(A, _np(v)[..., None])[..., 0], atol=SOL_TOL)


def test_nonsymmetric_transpose_roundtrip(npr, mesh, jmesh):
    d = 4
    A = npr.randn(B, d, d)
    v = npr.randn(B, d)
    base = ops.DenseOperator(_t(A), symmetric=False)
    sh = ShardedOperator(base, mesh, P("data", None))
    jsh = JSharded(jops.DenseOperator(jnp.asarray(A), symmetric=False),
                   jmesh, JP("data", None))
    np.testing.assert_allclose(_np(sh.T.matvec(_t(v))),
                               _np(base.rmatvec(_t(v))), rtol=1e-12)
    np.testing.assert_allclose(_np(sh.T.matvec(_t(v))),
                               np.asarray(jsh.T.matvec(jnp.asarray(v))),
                               rtol=1e-12)
    assert sh.T.is_sharded and sh.T.symmetric is False
    np.testing.assert_allclose(_np(sh.T.T.matvec(_t(v))),
                               _np(base.matvec(_t(v))), rtol=1e-12)


def test_factory_operands_shard_alongside_domain(npr, mesh, jmesh):
    dg = 1.0 + npr.rand(B)
    v = npr.randn(B)
    sh = ShardedOperator(lambda g: _DiagOp(g, positive_definite=True),
                         mesh, P("data"), operands=(_t(dg),),
                         operand_specs=(P("data"),))
    jsh = JSharded(lambda g: _JDiagOp(g, positive_definite=True), jmesh,
                   JP("data"), operands=(jnp.asarray(dg),),
                   operand_specs=(JP("data"),))
    # spec-based, not size-based: naming an instance axis means the dots
    # go through the reduction hook (identity on a mesh of one)
    assert sh.instance_sharded and jsh.instance_sharded
    np.testing.assert_allclose(_np(sh.matvec(_t(v))), dg * v, rtol=1e-12)
    np.testing.assert_allclose(_np(sh.diagonal()), np.asarray(jsh.diagonal()),
                               rtol=1e-12)


def test_instance_sharded_materialize_returns_per_shard_blocks(npr, mesh,
                                                               jmesh):
    dg = 1.0 + npr.rand(B)
    sh = ShardedOperator(lambda g: _DiagOp(g), mesh, P("data"),
                         operands=(_t(dg),), operand_specs=(P("data"),))
    jsh = JSharded(lambda g: _JDiagOp(g), jmesh, JP("data"),
                   operands=(jnp.asarray(dg),), operand_specs=(JP("data"),))
    blocks = _np(sh.materialize())
    assert blocks.shape == np.asarray(jsh.materialize()).shape == (1, B, B)
    np.testing.assert_allclose(blocks, np.asarray(jsh.materialize()),
                               rtol=1e-12)


def test_psum_reduction_hook(mesh):
    assert instance_axes(P("data", None), batch_ndim=1) == ()
    assert instance_axes(P("data"), batch_ndim=0) == ("data",)
    assert instance_axes(P(None, "data"), batch_ndim=1) == ("data",)
    assert psum_reduction(())(3.0) == 3.0       # identity without axes
    calls = []

    def spy_reduce(x):
        calls.append(1)
        return x

    sh = ShardedOperator(lambda g: _DiagOp(g, positive_definite=True),
                         mesh, P("data"), operands=(torch.ones(B),),
                         operand_specs=(P("data"),), reduce=spy_reduce)
    ls.solve(sh, torch.ones(B), method="sharded_cg", tol=1e-10)
    assert calls, "custom reduction hook never reached the solver"
    # the default hook is an all_reduce over the axis, inside the body only
    dg = 1.0 + torch.arange(B, dtype=torch.float64)
    sh = ShardedOperator(lambda g: _DiagOp(g, positive_definite=True),
                         mesh, P("data"), operands=(dg,),
                         operand_specs=(P("data"),))
    x = ls.solve(sh, torch.ones(B), method="sharded_cg", tol=1e-12)
    np.testing.assert_allclose(_np(x), 1.0 / _np(dg), atol=SOL_TOL)
    with pytest.raises(RuntimeError, match="shard_map body"):
        sh.reduce(torch.ones(()))


def test_plain_capture_defaults_run_at_local_shapes(npr, mesh):
    d = 3
    M = _t(npr.randn(d, d))
    base = ops.FunctionOperator(lambda v: torch.einsum("bd,de->be", v, M),
                                torch.zeros(B, d, dtype=torch.float64),
                                batch_ndim=1, symmetric=False)
    sh = ShardedOperator(base, mesh, P("data", None))
    v = _t(npr.randn(B, d))
    np.testing.assert_allclose(_np(sh.rmatvec(v)), _np(v @ M.T), atol=1e-12)
    np.testing.assert_allclose(_np(sh.T.matvec(v)), _np(v @ M.T),
                               atol=1e-12)
    diag = _np(sh.diagonal())
    assert diag.shape == (B, d)             # not duplicated per shard
    np.testing.assert_allclose(diag, np.broadcast_to(np.diag(_np(M)),
                                                     (B, d)), atol=1e-12)
    dense = _np(sh.materialize())
    assert dense.shape == (B, d, d)
    np.testing.assert_allclose(dense, np.broadcast_to(_np(M).T, (B, d, d)),
                               atol=1e-12)
    b = _t(npr.randn(B, d))
    x = ls.solve(sh, b, method="sharded_normal_cg", tol=1e-12, maxiter=500)
    np.testing.assert_allclose(_np(x) @ _np(M), _np(b), atol=1e-6)


def test_constructor_validation(npr, mesh):
    base = ops.DenseOperator(_t(_spd(npr, B, 3)))
    with pytest.raises(ValueError, match="factory"):
        ShardedOperator(base, mesh, P("data", None),
                        operands=(torch.ones(B),),
                        operand_specs=(P("data"),))
    with pytest.raises(ValueError, match="operand_specs"):
        ShardedOperator(lambda g: _DiagOp(g), mesh, P("data"),
                        operands=(torch.ones(B),), operand_specs=())
    with pytest.raises(TypeError, match="LinearOperator"):
        ShardedOperator(lambda: 3.0, mesh, P("data"))


# ---------------------------------------------------------------------------
# the sharded registry solvers
# ---------------------------------------------------------------------------

def _solver_pair(npr, mesh, jmesh, A, **flags):
    sh = ShardedOperator(ops.DenseOperator(_t(A), **flags), mesh,
                         P("data", None))
    jsh = JSharded(jops.DenseOperator(jnp.asarray(A), **flags), jmesh,
                   JP("data", None))
    return sh, jsh


@pytest.mark.parametrize("method,flags", [
    ("sharded_cg", dict(positive_definite=True)),
    ("sharded_normal_cg", dict(symmetric=False)),
    ("sharded_dense_gmres", dict(symmetric=False)),
])
def test_sharded_solver_matches_jax(npr, mesh, jmesh, method, flags):
    # d = 24 with a spectrum in [~2, ~6]: CG converges geometrically well
    # before d steps, so the step at which each instance crosses tol is not
    # decided by rounding (at d = 6, normal_cg's counts differ by one
    # between the packages' unsharded solvers already)
    d = 24
    A = _spd(npr, B, d, shift=2.0)
    if not flags.get("positive_definite"):
        A = A + 0.1 * npr.randn(B, d, d) / np.sqrt(d)
    b = npr.randn(B, d)
    sh, jsh = _solver_pair(npr, mesh, jmesh, A, **flags)
    x, info = ls.solve(sh, _t(b), method=method, tol=1e-10, maxiter=4000,
                       return_info=True)
    jx, jinfo = jls.solve(jsh, jnp.asarray(b), method=method, tol=1e-10,
                          maxiter=4000, return_info=True)
    np.testing.assert_allclose(_np(x), np.asarray(jx), atol=SOL_TOL)
    np.testing.assert_allclose(
        _np(x), np.linalg.solve(A, b[..., None])[..., 0], atol=1e-8)
    assert _np(info.iterations).shape == (B,)   # per-instance masks intact
    np.testing.assert_array_equal(_np(info.iterations),
                                  np.asarray(jinfo.iterations))
    np.testing.assert_array_equal(_np(info.converged),
                                  np.asarray(jinfo.converged))
    # on a mesh of one the sharded solver is the single-device loop, bit
    # for bit
    x0, info0 = ls.solve(ops.DenseOperator(_t(A), **flags), _t(b),
                         method=method[len("sharded_"):], tol=1e-10,
                         maxiter=4000, return_info=True)
    assert torch.equal(x, x0)
    assert torch.equal(info.iterations, info0.iterations)


def test_sharded_dense_gmres_refuses_instance_sharding(mesh):
    dg_sh = ShardedOperator(lambda g: _DiagOp(g), mesh, P("data"),
                            operands=(torch.ones(B),),
                            operand_specs=(P("data"),))
    assert dg_sh.instance_sharded
    with pytest.raises(ValueError, match="batch sharding only"):
        ls.solve(dg_sh, torch.ones(B), method="sharded_dense_gmres")


def test_instance_sharded_cg_matches_jax(npr, mesh, jmesh):
    dg = 1.0 + npr.rand(B)
    b = npr.randn(B)
    sh = ShardedOperator(lambda g: _DiagOp(g, positive_definite=True), mesh,
                         P("data"), operands=(_t(dg),),
                         operand_specs=(P("data"),))
    jsh = JSharded(lambda g: _JDiagOp(g, positive_definite=True), jmesh,
                   JP("data"), operands=(jnp.asarray(dg),),
                   operand_specs=(JP("data"),))
    x, info = ls.solve(sh, _t(b), method="sharded_cg", tol=1e-12,
                       return_info=True)
    jx, jinfo = jls.solve(jsh, jnp.asarray(b), method="sharded_cg",
                          tol=1e-12, return_info=True)
    np.testing.assert_allclose(_np(x), np.asarray(jx), atol=SOL_TOL)
    assert int(_np(info.iterations)) == int(jinfo.iterations)


def test_auto_routing_and_upgrade(npr, mesh, jmesh):
    d = 6
    spd = ShardedOperator(ops.DenseOperator(_t(_spd(npr, B, d)),
                                            positive_definite=True),
                          mesh, P("data", None))
    gen = ShardedOperator(ops.DenseOperator(_t(npr.randn(B, d, d)),
                                            symmetric=False),
                          mesh, P("data", None))
    big = ShardedOperator(
        ops.FunctionOperator(lambda v: v, torch.zeros(B, 600,
                                                      dtype=torch.float64),
                             batch_ndim=1), mesh, P("data", None))
    zeros = torch.zeros(d, dtype=torch.float64)
    with autotune.use_cache(autotune.TuningCache()):
        assert ls._resolve_auto(spd, zeros) == "sharded_cg"
        assert ls._resolve_auto(gen, zeros) == "sharded_dense_gmres"
        assert ls._resolve_auto(big, torch.zeros(600)) == "sharded_normal_cg"
        # classic names upgrade once the operator carries a mesh
        assert ls._upgrade_for_sharded("cg", spd) == "sharded_cg"
        assert ls._upgrade_for_sharded("cg", ops.DenseOperator(
            _t(_spd(npr, B, d)))) == "cg"
        b = _t(npr.randn(B, d))
        assert torch.equal(ls.solve(spd, b, method="cg", tol=1e-10),
                           ls.solve(spd, b, method="sharded_cg", tol=1e-10))
        # materializing single-device solvers upgrade too
        assert ls._upgrade_for_sharded("pallas_cg", spd) == "sharded_cg"
        assert ls._upgrade_for_sharded("lu", gen) == "sharded_dense_gmres"
        assert ls._upgrade_for_sharded("bicgstab", gen) == "bicgstab"
    # the same names in the JAX package
    jspd = JSharded(jops.DenseOperator(jnp.asarray(_spd(npr, B, d)),
                                       positive_definite=True), jmesh,
                    JP("data", None))
    assert jls._resolve_auto(jspd, jnp.zeros(d)) == "sharded_cg"
    # seeded caches at the operand's own regime: a mesh of one is always
    # accepted, and evidence of a win accepts
    Bn, dd, dtype = autotune.operator_regime(spd)
    assert (Bn, dd, dtype) == (B, d, "float64")
    backend = autotune.current_backend()

    def seeded(sharded_ratio):
        c = autotune.TuningCache()
        c.put(autotune.TuningKey(backend, autotune.single_device_solver(
            True, dd), Bn, dd, dtype), 1e-3)
        c.put(autotune.TuningKey(backend, "sharded_cg", Bn, dd, dtype, 1),
              sharded_ratio * 1e-3)
        return c

    for ratio in (0.5, 2.0):
        with autotune.use_cache(seeded(ratio)):
            assert ls._resolve_auto(spd, zeros) == "sharded_cg"
            assert ls._upgrade_for_sharded("cg", spd) == "sharded_cg"


def test_gated_upgrade_refuses_a_measured_loss():
    """``should_shard``'s refusal keeps the classic name: an operator that
    only claims a larger mesh (routing reads ``mesh.size()``)."""
    class _Mesh:
        def size(self):
            return 2

    op = ops.DenseOperator(_t(_spd(np.random.RandomState(1), B, 4)),
                           positive_definite=True)
    fake = ShardedOperator.__new__(ShardedOperator)
    fake.__dict__.update(op.__dict__, mesh=_Mesh(), _psum_axes=(),
                         _batch_axes=("data",))
    Bn, d, dtype = autotune.operator_regime(fake)
    c = autotune.TuningCache()
    backend = autotune.current_backend()
    c.put(autotune.TuningKey(backend, autotune.single_device_solver(True, d),
                             Bn, d, dtype), 1e-3)
    c.put(autotune.TuningKey(backend, "sharded_cg", Bn, d, dtype, 2), 2e-3)
    with autotune.use_cache(c):
        assert ls._resolve_auto(fake, torch.zeros(d)) == "cg"
        assert ls._upgrade_for_sharded("cg", fake) == "cg"
        # ...but materializing names stay a correctness upgrade
        assert ls._upgrade_for_sharded("pallas_cg", fake) == "sharded_cg"


def test_route_solve_auto_sizes_from_one_instance(npr, mesh):
    d = 40                              # B * d = 640 > MAX_DENSE_DIM
    assert B * d > ls.MAX_DENSE_DIM and d < ls.MAX_DENSE_DIM
    A = 0.3 * npr.randn(B, d, d) + 5.0 * np.eye(d)
    wide = ShardedOperator(ops.DenseOperator(_t(A), symmetric=False), mesh,
                           P("data", None))
    calls = []
    orig = ls.get_spec("sharded_dense_gmres")

    def spy(mv, rhs, **kw):
        calls.append(1)
        return orig.fn(mv, rhs, **kw)

    ls.register_solver("sharded_dense_gmres", spy, supports_precond=True,
                       matrix_free=False, description=orig.description)
    try:
        b = npr.randn(B, d)
        x = ls.route_solve("auto", wide, _t(b), tol=1e-8, maxiter=2000)
    finally:
        ls._REGISTRY["sharded_dense_gmres"] = orig
    assert calls, "auto routed past the dense regime"
    np.testing.assert_allclose(
        _np(x), np.linalg.solve(A, b[..., None])[..., 0], atol=1e-5)


def test_sharded_solver_requires_sharded_operator(npr):
    base = ops.DenseOperator(_t(_spd(npr, B, 4)), positive_definite=True)
    with pytest.raises(ValueError, match="ShardedOperator"):
        ls.solve(base, torch.ones(B, 4, dtype=torch.float64),
                 method="sharded_cg")


def test_jacobi_precond_through_sharded_cg(npr, mesh, jmesh):
    d = 6
    A = _spd(npr, B, d) + 3.0 * np.eye(d)
    b = npr.randn(B, d)
    sh, jsh = _solver_pair(npr, mesh, jmesh, A, positive_definite=True)
    x = ls.solve(sh, _t(b), method="sharded_cg", precond="jacobi",
                 tol=1e-10)
    jx = jls.solve(jsh, jnp.asarray(b), method="sharded_cg",
                   precond="jacobi", tol=1e-10)
    np.testing.assert_allclose(_np(x), np.asarray(jx), atol=SOL_TOL)
    np.testing.assert_allclose(
        _np(x), np.linalg.solve(A, b[..., None])[..., 0], atol=1e-8)


def test_vmap_of_sharded_solve_raises_and_a_loop_equals_jax_vmap(
        npr, mesh, jmesh):
    """Once a documented raise, now parity: ``torch.func.vmap`` of a
    sharded solve equals ``jax.vmap``'s and the loop of single solves.  A
    batch of right-hand sides against the one operator folds into the
    operator's batch: ONE sharded solve; a batch of operators runs one
    solve per slice."""
    d = 4
    A = _spd(npr, B, d)
    rhs = npr.randn(3, B, d)
    sh, jsh = _solver_pair(npr, mesh, jmesh, A, positive_definite=True)
    executed = []

    def counting(matvec, b, **kw):
        executed.append(tuple(b.shape))
        return dso.sharded_solve_cg(matvec, b, **kw)

    ls.register_solver("counting_sharded_cg_vmap", counting,
                       symmetric_only=True, supports_precond=True)
    try:
        xv, (_, _, converged) = torch.func.vmap(lambda bi: (
            lambda x, info: (x, tuple(info[:3])))(*ls.solve(
                sh, bi, method="counting_sharded_cg_vmap", tol=1e-10,
                return_info=True)))(_t(rhs))
    finally:
        ls._REGISTRY.pop("counting_sharded_cg_vmap", None)
    assert len(executed) == 1
    xs = torch.stack([ls.solve(sh, _t(r), method="sharded_cg", tol=1e-10)
                      for r in rhs])
    jxs = jax.vmap(lambda bi: jls.solve(jsh, bi, method="sharded_cg",
                                        tol=1e-10))(jnp.asarray(rhs))
    np.testing.assert_allclose(_np(xv), np.asarray(jxs), atol=SOL_TOL)
    np.testing.assert_allclose(_np(xv), _np(xs), atol=SOL_TOL)
    assert converged.shape == (3, B) and bool(converged.all())
    # a batch of operators: one sharded solve per slice
    As = np.stack([_spd(npr, B, d) for _ in range(3)])
    xo = torch.func.vmap(lambda Ai, bi: ls.solve(
        ShardedOperator(ops.DenseOperator(Ai, positive_definite=True), mesh,
                        P("data", None)), bi, method="sharded_cg",
        tol=1e-10))(_t(As), _t(rhs))
    np.testing.assert_allclose(
        _np(xo), np.linalg.solve(As, rhs[..., None])[..., 0], atol=1e-8)


def test_dispatch_event_carries_mesh_size(npr, mesh):
    from repro_torch.observability import events
    sh = ShardedOperator(ops.DenseOperator(_t(_spd(npr, B, 4)),
                                           positive_definite=True),
                         mesh, P("data", None))
    events.clear_recorded()
    with events.observe(True, record=True):
        ls.route_solve("cg", sh, _t(npr.randn(B, 4)), tol=1e-10)
    got = {ev.kind: ev.tags for ev in events.recorded()}
    events.clear_recorded()
    assert got["dispatch"]["solver"] == "sharded_cg"
    assert got["dispatch"]["mesh_size"] == 1
    assert got["dispatch"]["requested"] == "cg"


# ---------------------------------------------------------------------------
# implicit differentiation on the mesh
# ---------------------------------------------------------------------------

M_ROWS, D_RIDGE = 12, 6


def _ridge_data(npr):
    return (npr.randn(B, M_ROWS, D_RIDGE), npr.randn(B, M_ROWS),
            np.linspace(0.5, 2.0, B))


def _ridge_F(xp):
    def F(x, theta, X, y):
        r = xp.einsum("bmd,bd->bm", X, x) - y
        return xp.einsum("bmd,bm->bd", X, r) + theta[:, None] * x
    return F


def _ridge_solver(xp, eye):
    def solver(init, theta, X, y):
        A = xp.einsum("bmd,bme->bde", X, X) \
            + theta[:, None, None] * eye(X.shape[-1])
        return xp.linalg.solve(
            A, xp.einsum("bmd,bm->bd", X, y)[..., None])[..., 0]
    return solver


T_SOLVER = _ridge_solver(torch, lambda d: torch.eye(d, dtype=torch.float64))
J_SOLVER = _ridge_solver(jnp, jnp.eye)


def _specs(mesh, jmesh, **kw):
    sh = SolveSharding(mesh, P("data", None), batch_ndim=1,
                       theta_specs=(P("data"), P("data", None, None),
                                    P("data", None)))
    jsh = JSolveSharding(jmesh, JP("data", None), batch_ndim=1,
                         theta_specs=(JP("data"), JP("data", None, None),
                                      JP("data", None)))
    return (ImplicitDiffSpec(optimality_fun=_ridge_F(torch), solve="cg",
                             tol=1e-12, sharding=sh, **kw),
            JSpec(optimality_fun=_ridge_F(jnp), solve="cg", tol=1e-12,
                  sharding=jsh, **kw))


def _jax_grad(jspec, X, y, theta, mode="auto"):
    dec = jimplicit(jspec, mode=mode)(J_SOLVER)
    return np.asarray(jax.grad(lambda t: jnp.sum(
        dec(None, t, jnp.asarray(X), jnp.asarray(y)) ** 2))(
            jnp.asarray(theta)))


def test_grad_matches_jax(npr, mesh, jmesh):
    X, y, theta = _ridge_data(npr)
    spec, jspec = _specs(mesh, jmesh)
    want = _jax_grad(jspec, X, y, theta)
    dec = implicit_diff(spec)(T_SOLVER)
    # plain tensors: global values, torch.func.grad
    g = torch.func.grad(lambda t: (dec(None, t, _t(X), _t(y)) ** 2).sum())(
        _t(theta))
    np.testing.assert_allclose(_np(g), want, atol=GRAD_TOL)
    # DTensors: the solver runs on the local shards, nothing is gathered
    def local_solver(init, t, Xd, yd):
        return DTensor.from_local(T_SOLVER(None, t.to_local(), Xd.to_local(),
                                           yd.to_local()), mesh, [Shard(0)],
                                  run_check=False)

    td = distribute_tensor(_t(theta), mesh, [Shard(0)]).requires_grad_()
    Xd = distribute_tensor(_t(X), mesh, [Shard(0)])
    yd = distribute_tensor(_t(y), mesh, [Shard(0)])
    x = implicit_diff(spec)(local_solver)(None, td, Xd, yd)
    (gd,) = torch.autograd.grad((x ** 2).sum(), td)
    assert isinstance(gd, DTensor) and gd.placements == (Shard(0),)
    np.testing.assert_allclose(_np(gd), want, atol=GRAD_TOL)


def test_jvp_matches_jax(npr, mesh, jmesh):
    X, y, theta = _ridge_data(npr)
    spec, jspec = _specs(mesh, jmesh)
    dec = implicit_diff(spec)(T_SOLVER)
    jdec = jimplicit(jspec)(J_SOLVER)
    tangent = np.ones(B)
    jv = torch.func.jvp(lambda t: dec(None, t, _t(X), _t(y)), (_t(theta),),
                        (_t(tangent),))[1]
    want = jax.jvp(lambda t: jdec(None, t, jnp.asarray(X), jnp.asarray(y)),
                   (jnp.asarray(theta),), (jnp.asarray(tangent),))[1]
    np.testing.assert_allclose(_np(jv), np.asarray(want), atol=GRAD_TOL)


def test_vjp_mode_matches_jax(npr, mesh, jmesh):
    X, y, theta = _ridge_data(npr)
    spec, jspec = _specs(mesh, jmesh)
    dec = implicit_diff(spec, mode="vjp")(T_SOLVER)
    tt = _t(theta).requires_grad_()
    (g,) = torch.autograd.grad((dec(None, tt, _t(X), _t(y)) ** 2).sum(), tt)
    np.testing.assert_allclose(_np(g), _jax_grad(jspec, X, y, theta, "vjp"),
                               atol=GRAD_TOL)


def test_root_vjp_and_root_jvp_take_sharding(npr, mesh, jmesh):
    X, y, theta = _ridge_data(npr)
    spec, jspec = _specs(mesh, jmesh)
    x_star = T_SOLVER(None, _t(theta), _t(X), _t(y))
    jx = J_SOLVER(None, jnp.asarray(theta), jnp.asarray(X), jnp.asarray(y))
    v = npr.randn(B, D_RIDGE)
    args = (_t(theta), _t(X), _t(y))
    jargs = (jnp.asarray(theta), jnp.asarray(X), jnp.asarray(y))
    got = root_vjp(_ridge_F(torch), x_star, args, _t(v), solve="cg",
                   tol=1e-12, sharding=spec.sharding)
    want = jroot_vjp(_ridge_F(jnp), jx, jargs, jnp.asarray(v), solve="cg",
                     tol=1e-12, sharding=jspec.sharding)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=GRAD_TOL)
    tangents = (_t(np.ones(B)), torch.zeros_like(args[1]),
                torch.zeros_like(args[2]))
    got = root_jvp(_ridge_F(torch), x_star, args, tangents, solve="cg",
                   tol=1e-12, sharding=spec.sharding)
    want = jroot_jvp(_ridge_F(jnp), jx, jargs,
                     (jnp.ones(B), jnp.zeros_like(jargs[1]),
                      jnp.zeros_like(jargs[2])), solve="cg", tol=1e-12,
                     sharding=jspec.sharding)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=GRAD_TOL)


def test_grad_executes_one_sharded_solve(npr, mesh, jmesh):
    from repro_torch.distributed import sharded_operators as dso
    X, y, theta = _ridge_data(npr)
    spec, _ = _specs(mesh, jmesh)
    executed = []

    def counting_sharded_cg(matvec, b, **kw):
        executed.append(type(matvec).__name__)
        return dso.sharded_solve_cg(matvec, b, **kw)

    ls.register_solver("counting_sharded_cg", counting_sharded_cg,
                       symmetric_only=True, supports_precond=True)
    try:
        dec = implicit_diff(spec.replace(solve="counting_sharded_cg"))(
            T_SOLVER)
        g = torch.func.grad(lambda t: (dec(None, t, _t(X), _t(y)) ** 2)
                            .sum())(_t(theta))
    finally:
        ls._REGISTRY.pop("counting_sharded_cg", None)
    assert executed == ["ShardedOperator"], executed
    assert np.isfinite(_np(g)).all()


def test_vmap_of_a_sharded_gradient_raises(npr, mesh, jmesh):
    """Once a documented raise, now parity: ``vmap`` of a gradient whose
    backward solve is sharded, over the cotangent seed (the operator
    shared) and over θ (a batch of operators), each one folded solve, equals
    ``jax.vmap``'s."""
    X, y, theta = _ridge_data(npr)
    spec, jspec = _specs(mesh, jmesh)
    dec = implicit_diff(spec)(T_SOLVER)
    jdec = jimplicit(jspec)(J_SOLVER)
    seeds = npr.randn(3, B, D_RIDGE)
    thetas = theta[None] * np.array([1.0, 1.5, 2.0])[:, None]
    grad = torch.func.grad(lambda t, s: (dec(None, t, _t(X), _t(y)) * s)
                           .sum())
    jgrad = jax.grad(lambda t, s: jnp.sum(
        jdec(None, t, jnp.asarray(X), jnp.asarray(y)) * s))
    for in_dims, args in (((None, 0), (theta, seeds)),
                          ((0, 0), (thetas, seeds))):
        got = torch.func.vmap(grad, in_dims=in_dims)(*map(_t, args))
        want = jax.vmap(jgrad, in_axes=in_dims)(*map(jnp.asarray, args))
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   atol=GRAD_TOL)


# the four second-order combinations, each the Hessian of Σx*² in θ ∈ R^B
def _second(lib, f):
    if lib == "jax":
        g, eye = jax.grad(f), jnp.eye(B)
        return {"grad(grad)": jax.jacrev(g), "jacfwd(grad)": jax.jacfwd(g),
                "grad(jvp)": lambda t: jax.vmap(lambda e: jax.grad(
                    lambda s: jax.jvp(f, (s,), (e,))[1])(t))(eye),
                "jacfwd(jacfwd)": jax.jacfwd(jax.jacfwd(f))}
    g, eye = torch.func.grad(f), torch.eye(B, dtype=torch.float64)
    return {"grad(grad)": torch.func.jacrev(g),
            "jacfwd(grad)": torch.func.jacfwd(g),
            "grad(jvp)": lambda t: torch.func.vmap(lambda e: torch.func.grad(
                lambda s: torch.func.jvp(f, (s,), (e,))[1])(t))(eye),
            "jacfwd(jacfwd)": torch.func.jacfwd(torch.func.jacfwd(f))}


SECOND = ("grad(grad)", "jacfwd(grad)", "grad(jvp)", "jacfwd(jacfwd)")
# the cells of each mode (JAX raises in the others); the Hessian's diagonal
# starts so on JAX's one-device mesh
SECOND_ALLOWED = {"auto": set(SECOND), "vjp": {"jacfwd(grad)"},
                  "jvp": {"jacfwd(jacfwd)"}}
HESSIAN_DIAG = (0.0360587, 0.1226335, 0.0878542)


@pytest.mark.parametrize("mode", ["auto", "vjp", "jvp"])
def test_second_derivatives_on_the_mesh_match_jax(npr, mesh, jmesh, mode):
    """Each cell of a sharded ``implicit_diff`` as on JAX's one-device
    mesh: the Hessian within 1e-8 where JAX gives it, a raise naming the
    mode where JAX raises (``sharded_cg`` is a loop)."""
    X, y, theta = _ridge_data(npr)
    spec, jspec = _specs(mesh, jmesh)
    dec = implicit_diff(spec, mode=mode)(T_SOLVER)
    jdec = jimplicit(jspec, mode=mode)(J_SOLVER)
    cells_t = _second("torch", lambda t: (dec(None, t, _t(X), _t(y)) ** 2)
                      .sum())
    cells_j = _second("jax", lambda t: jnp.sum(
        jdec(None, t, jnp.asarray(X), jnp.asarray(y)) ** 2))
    given = set()
    for combo in SECOND:
        try:
            want = np.asarray(jax.jit(cells_j[combo])(jnp.asarray(theta)))
        except Exception:                               # noqa: BLE001
            with pytest.raises(RuntimeError, match=f"mode={mode!r}"):
                cells_t[combo](_t(theta))
            continue
        given.add(combo)
        np.testing.assert_allclose(np.diag(want)[:3], HESSIAN_DIAG,
                                   atol=1e-7)
        np.testing.assert_allclose(_np(cells_t[combo](_t(theta))), want,
                                   atol=GRAD_TOL)
    assert given == SECOND_ALLOWED[mode]


def test_vmap_of_a_sharded_hessian_is_one_folded_solve_per_level(
        npr, mesh, jmesh):
    """``vmap(hessian)`` over three θ runs three sharded solves, as one
    ``hessian`` does: each level's solve holds the batch's instances side
    by side.  Its values are ``jax.vmap(jax.hessian)``'s on the mesh, the
    loop's bit for bit, and the unsharded port's."""
    X, y, theta = _ridge_data(npr)
    spec, jspec = _specs(mesh, jmesh)
    thetas = theta[None] * np.array([1.0, 1.5, 2.0])[:, None]
    executed = []

    def counting(matvec, b, **kw):
        executed.append(tuple(b.shape))
        return dso.sharded_solve_cg(matvec, b, **kw)

    ls.register_solver("counting_sharded_cg_hessian", counting,
                       symmetric_only=True, supports_precond=True)
    try:
        dec = implicit_diff(spec.replace(
            solve="counting_sharded_cg_hessian"))(T_SOLVER)
        hess = torch.func.hessian(
            lambda t: (dec(None, t, _t(X), _t(y)) ** 2).sum())
        batch = torch.func.vmap(hess)(_t(thetas))
        n_batch, executed[:] = list(executed), []
        one = hess(_t(thetas[1]))
    finally:
        ls._REGISTRY.pop("counting_sharded_cg_hessian", None)
    assert [b[0] for b in executed] == [B * B, B, B * B]
    assert [b[0] for b in n_batch] == [3 * B * B, 3 * B, 3 * B * B]
    np.testing.assert_array_equal(_np(batch[1]), _np(one))
    jdec = jimplicit(jspec)(J_SOLVER)
    want = jax.jit(jax.vmap(jax.hessian(lambda t: jnp.sum(jdec(
        None, t, jnp.asarray(X), jnp.asarray(y)) ** 2))))(
        jnp.asarray(thetas))
    np.testing.assert_allclose(_np(batch), np.asarray(want), atol=GRAD_TOL)
    plain = implicit_diff(spec.replace(sharding=None))(T_SOLVER)
    unsharded = torch.func.vmap(torch.func.hessian(
        lambda t: (plain(None, t, _t(X), _t(y)) ** 2).sum()))(_t(thetas))
    np.testing.assert_allclose(_np(batch), _np(unsharded), atol=1e-12)


def test_spec_validation(mesh):
    sh = SolveSharding(mesh, P("data", None), batch_ndim=1)
    with pytest.raises(ValueError, match="mutually exclusive"):
        ImplicitDiffSpec(optimality_fun=lambda x, t: x, sharding=sh,
                         system_operator=lambda *a, **k: None)
    with pytest.raises(ValueError, match="named preconditioners"):
        implicit_diff(ImplicitDiffSpec(optimality_fun=lambda x, t: x,
                                       sharding=sh, backward="neumann_k",
                                       precond="jacobi"))


def test_approximate_backward_on_the_mesh_matches_jax(npr, mesh, jmesh):
    X, y, theta = _ridge_data(npr)
    spec, jspec = _specs(mesh, jmesh, backward="neumann_k",
                         backward_iters=3, ridge=50.0)
    dec = implicit_diff(spec)(T_SOLVER)
    g = torch.func.grad(lambda t: (dec(None, t, _t(X), _t(y)) ** 2).sum())(
        _t(theta))
    np.testing.assert_allclose(_np(g), _jax_grad(jspec, X, y, theta),
                               atol=GRAD_TOL)


def test_runtime_solver_with_sharding(npr, mesh, jmesh):
    d = 4
    w = 1.0 + npr.rand(B, d)
    theta = npr.randn(B, d)

    def make(xp, sharding, cls):
        def fun(x, th, w):
            return 0.5 * xp.sum(w * (x - th) ** 2)
        return cls(fun, stepsize=0.5, maxiter=400, tol=1e-12, solve="cg",
                   linsolve_tol=1e-12, sharding=sharding)

    sh = SolveSharding(mesh, P("data", None), batch_ndim=1,
                       theta_specs=(P("data", None), P("data", None)))
    jsh = JSolveSharding(jmesh, JP("data", None), batch_ndim=1,
                         theta_specs=(JP("data", None), JP("data", None)))
    solver = make(torch, sh, GradientDescent)
    jsolver = make(jnp, jsh, JGD)
    x0 = torch.zeros(B, d, dtype=torch.float64)
    g = torch.func.grad(lambda t: (solver.run(x0, t, _t(w))[0] ** 2).sum())(
        _t(theta))
    want = jax.grad(lambda t: jnp.sum(jsolver.run(
        jnp.zeros((B, d)), t, jnp.asarray(w))[0] ** 2))(jnp.asarray(theta))
    np.testing.assert_allclose(_np(g), np.asarray(want), atol=GRAD_TOL)
    # DTensors: the iterate is pinned to the solution's placement
    td = distribute_tensor(_t(theta), mesh, [Shard(0)]).requires_grad_()
    wd = distribute_tensor(_t(w), mesh, [Shard(0)])
    x, info = solver.run(x0, td, wd)
    assert isinstance(x, DTensor) and x.placements == (Shard(0),)
    (gd,) = torch.autograd.grad((x ** 2).sum(), td)
    np.testing.assert_allclose(_np(gd), np.asarray(want), atol=GRAD_TOL)


# ---------------------------------------------------------------------------
# autotune and the mesh front end
# ---------------------------------------------------------------------------

def test_measure_solver_sharded_rows_and_auto_mesh_size(mesh):
    cache = autotune.TuningCache()
    rec = autotune.measure_solver("sharded_cg", 8, 6, dtype="float64",
                                  mesh_size=1, cache=cache, iters=2,
                                  device="cpu")
    assert rec.source == "measured" and rec.seconds > 0
    key = autotune.TuningKey("cpu", "sharded_cg", 8, 6, "float64", 1)
    assert cache.get(key) is rec
    with pytest.raises(ValueError, match="requested 2 devices"):
        autotune.measure_solver("sharded_cg", 8, 6, mesh_size=2,
                                cache=cache, device="cpu")
    with autotune.use_cache(cache):
        assert autotune.should_shard(8, 6, mesh_size=1, dtype="float64")
        assert tmesh_mod.auto_mesh_size(8, 6, dtype="float64") == 1
        # candidates are capped by the world size, whatever the model
        assert tmesh_mod.auto_mesh_size(64, 512) == 1
        assert tmesh_mod.auto_mesh_size(64, 512, max_devices=4) == 4
    assert jmesh_mod.auto_mesh_size(64, 512) == 1


@pytest.mark.parametrize("group", ["none", "caller"])
def test_measure_solver_leaves_the_process_group_as_it_found_it(request,
                                                                group):
    """A sharded row destroys a single-rank group its mesh had to start,
    and leaves a group its caller runs in place."""
    if group == "caller":
        request.getfixturevalue("mesh")
        world = dist.group.WORLD
    assert dist.is_initialized() == (group == "caller")
    rec = autotune.measure_solver("sharded_cg", 8, 6, dtype="float64",
                                  mesh_size=1, cache=autotune.TuningCache(),
                                  iters=1, device="cpu")
    assert rec.source == "measured"
    if group == "caller":
        assert dist.is_initialized() and dist.group.WORLD is world
    else:
        assert not dist.is_initialized()


def test_sharded_operator_has_no_replication_check(mesh, npr):
    """The JAX package's ``check_rep`` only reaches ``shard_map``; the port
    has no replication check, so it refuses the keyword."""
    op = ops.DenseOperator(_t(_spd(npr, B, 4)), positive_definite=True)
    with pytest.raises(TypeError, match="check_rep"):
        ShardedOperator(op, mesh, P("data", None), check_rep=False)


# ---------------------------------------------------------------------------
# the paper's §4.4 experiment
# ---------------------------------------------------------------------------

def _jax_md(x0):
    """``examples/md_sensitivity.py``'s three routes, returned."""
    from benchmarks.molecular_dynamics import fire_minimize, pair_energy
    theta = 0.6
    x_star = fire_minimize(jnp.asarray(x0), theta)

    def F(x, diameter):
        return -jax.grad(lambda x: pair_energy(x, diameter))(x)

    dx = jroot_jvp(F, x_star, (theta,), (1.0,), solve="bicgstab", tol=1e-8,
                   ridge=1e-8)
    solver = JGD(pair_energy, stepsize=2e-3, maxiter=2000, tol=1e-10,
                 solve="bicgstab", ridge=1e-8, linsolve_tol=1e-8)
    (_, _), (dx_rt, _) = jax.jvp(
        lambda dm: solver.run(x_star, dm, mode="jvp"), (theta,), (1.0,))
    thetas = theta + 0.005 * jnp.arange(8)
    flat = x_star.reshape(-1)

    def F_flat(xf, diameter):
        return -jax.grad(lambda x: pair_energy(x, diameter))(
            xf.reshape(x_star.shape)).reshape(-1)

    H = jax.vmap(lambda th: -jax.jacfwd(F_flat)(flat, th))(thetas)
    rhs = jax.vmap(lambda th: jax.jacfwd(
        lambda t: F_flat(flat, t))(th))(thetas)
    n = jmesh_mod.auto_mesh_size(8, flat.shape[0])
    batched = JSharded(jops.DenseOperator(H, symmetric=True),
                       jmesh_mod.make_solve_mesh(devices=n),
                       JP("data", None))
    dx_sweep = jls.solve(batched, rhs, method="auto", tol=1e-8)
    return {k: np.asarray(v) for k, v in dict(
        x_star=x_star, dx=dx, dx_runtime=dx_rt, dx_sweep=dx_sweep).items()}


def test_md_sensitivity_three_routes_match_the_jax_example(mesh):
    from repro_torch.launch import md_sensitivity as md
    x0 = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (32, 2)))
    got = md.run(x0, device="cpu")
    want = _jax_md(x0)
    np.testing.assert_allclose(_np(got["x_star"]), want["x_star"],
                               atol=1e-12)
    for key in ("dx", "dx_runtime", "dx_sweep"):
        np.testing.assert_allclose(_np(got[key]), want[key], atol=GRAD_TOL,
                                   err_msg=key)
    assert got["runtime_drift"] < md.JVP_LIMIT
    assert got["sweep_drift"] < md.SWEEP_LIMIT
    assert got["mesh_size"] == 1
    assert got["sweep_solver"] == "sharded_dense_gmres"
    assert got["residual"] < 1e-6 and got["polish_converged"]
