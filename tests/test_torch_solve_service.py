"""The port's solve service: the behaviours ``tests/test_solve_service.py``
pins for the JAX service, on the CPU (``device="cpu"``), plus parity with
the JAX package (hypergradient against JAX ``root_vjp``, a warm-start cache
saved by the JAX service and loaded by the port)."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.diff_api import root_vjp as jax_root_vjp
from repro.runtime import SolveService as JaxSolveService
from repro.runtime import WarmStartCache as JaxWarmStartCache
from repro_torch.core import DenseOperator, linear_solve as ls
from repro_torch.core.diff_api import ImplicitDiffSpec
from repro_torch.kernels.batched_cg import ops as cg_ops
from repro_torch.runtime import (BucketKey, ServiceResult, SolveService,
                                 WarmStartCache, bucket_capacity)

CPU = "cpu"


def _spd(rng, d):
    M = rng.standard_normal((d, d))
    return M @ M.T + d * np.eye(d)


def _svc(**kw):
    return SolveService(device=CPU, **kw)


# -- device rule -------------------------------------------------------------

def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert SolveService().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SolveService()


# -- bucket shaping ----------------------------------------------------------

def test_bucket_capacity_rounds_to_power_of_two():
    assert [bucket_capacity(n) for n in (1, 2, 3, 5, 9, 64)] == \
        [1, 2, 4, 8, 16, 64]
    assert bucket_capacity(100, max_batch=64) == 64
    with pytest.raises(ValueError):
        bucket_capacity(0)


def test_empty_flush_is_a_noop():
    svc = _svc()
    assert svc.flush() == 0
    assert svc.metrics["dispatches"] == 0


def test_single_request_bucket_runs_the_batched_cg_op():
    svc = _svc(cache=None)
    fut = svc.submit(2.0 * np.eye(4), np.ones(4), positive_definite=True)
    assert svc.flush() == 1
    r = fut.result()
    assert isinstance(r, ServiceResult)
    assert (r.bucket_size, r.bucket_capacity) == (1, 1)
    assert bool(r.info.converged) and r.info.iterations == -1   # pallas_cg
    np.testing.assert_allclose(np.asarray(r.x), 0.5, atol=1e-5)


def test_mixed_d_load_forms_multiple_buckets():
    rng = np.random.default_rng(0)
    svc = _svc()
    futs = [svc.submit(_spd(rng, d), rng.standard_normal(d),
                       positive_definite=True)
            for d in (8, 12, 8, 12, 8, 12, 8, 12)]
    assert svc.flush() == 8
    assert svc.metrics["dispatches"] == 2          # one per d
    assert {f.result().bucket_size for f in futs} == {4}
    assert all(bool(f.result().info.converged) for f in futs)


def test_padding_and_fixed_compiled_shapes():
    """3 requests pad to capacity 4; repeat traffic reuses the function."""
    rng = np.random.default_rng(1)
    svc = _svc(cache=None)
    d = 6
    for _ in range(3):
        futs = [svc.submit(_spd(rng, d), rng.standard_normal(d),
                           positive_definite=True) for _ in range(3)]
        svc.flush()
        for f in futs:
            assert f.result().bucket_capacity == 4
    assert svc.metrics["padded"] == 3 * 1
    assert svc.metrics["compiled"] == 1            # ONE function, all rounds
    assert svc.occupancy == pytest.approx(0.75)


def test_oversized_bucket_splits_into_chunks():
    rng = np.random.default_rng(2)
    svc = _svc(max_batch=4, cache=None)
    futs = [svc.submit(_spd(rng, 5), rng.standard_normal(5),
                       positive_definite=True) for _ in range(10)]
    assert svc.flush() == 10
    assert svc.metrics["dispatches"] == 3          # 4 + 4 + 2
    assert svc.metrics["compiled"] == 2            # cap=4 and cap=2
    assert all(bool(f.result().info.converged) for f in futs)


# -- per-request diagnostics -------------------------------------------------

def test_solveinfo_parity_with_solo_route_solve():
    """A bucketed request's SolveInfo slice matches its solo solve."""
    rng = np.random.default_rng(3)
    d = 12
    systems = [(_spd(rng, d), rng.standard_normal(d)) for _ in range(5)]
    svc = _svc(cache=None, solve="dense_gmres")
    futs = [svc.submit(A, b, positive_definite=True) for A, b in systems]
    svc.flush()
    for (A, b), fut in zip(systems, futs):
        r = fut.result()
        op = DenseOperator(torch.from_numpy(A), symmetric=True,
                           positive_definite=True)
        x_solo, info = ls.route_solve("dense_gmres", op, torch.from_numpy(b),
                                      return_info=True)
        np.testing.assert_allclose(np.asarray(r.x), x_solo.numpy(),
                                   atol=1e-4)
        assert int(r.info.iterations) == int(info.iterations)
        assert bool(r.info.converged)
        assert r.queue_time >= 0.0 and r.solve_time > 0.0


@pytest.mark.parametrize("solve", ["cg", "pallas_cg", "normal_cg"])
def test_hypergrad_request_matches_jax_root_vjp(solve):
    def F_t(x, theta):
        return x * (1.0 + theta) - torch.arange(1.0, 7.0, dtype=x.dtype)

    def F_j(x, theta):
        return x * (1.0 + theta) - jnp.arange(1.0, 7.0)

    theta = 0.3
    x_star = np.arange(1.0, 7.0) / 1.3
    ct = np.random.default_rng(4).standard_normal(6)
    svc = _svc()
    fut = svc.submit_hypergrad(F_t, torch.from_numpy(x_star),
                               (torch.tensor(theta, dtype=torch.float64),),
                               torch.from_numpy(ct), solve=solve, tol=1e-12)
    svc.flush()
    (got,) = fut.result().x
    (want,) = jax_root_vjp(F_j, jnp.asarray(x_star), (jnp.asarray(theta),),
                           jnp.asarray(ct), solve=solve, tol=1e-12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10)


def test_hypergrad_pallas_bucket_goes_through_the_cg_op():
    """Hypergradients with solve='pallas_cg' batch into one pallas_cg
    dispatch (the kernel's route on the card; its plain version here)."""
    def F(x, theta):
        return x * (1.0 + theta) - 1.0

    svc = _svc(cache=None)
    launches = cg_ops.LAUNCHES
    futs = [svc.submit_hypergrad(F, torch.ones(5, dtype=torch.float64) / 1.5,
                                 torch.tensor(0.5, dtype=torch.float64),
                                 torch.ones(5, dtype=torch.float64),
                                 solve="pallas_cg") for _ in range(3)]
    svc.flush()
    assert svc.metrics["dispatches"] == 1
    (bkey, _cap), = svc._compiled.keys()
    assert bkey.solver == "pallas_cg"
    assert cg_ops.LAUNCHES == launches             # CPU tensors: no kernel
    for f in futs:
        (g,) = f.result().x
        np.testing.assert_allclose(float(g), -5 / 1.5 / 1.5, atol=1e-5)
    # an approximate request takes its own bucket, off the kernel's route
    f = svc.submit_hypergrad(F, torch.ones(5, dtype=torch.float64) / 1.5,
                             torch.tensor(0.5, dtype=torch.float64),
                             torch.ones(5, dtype=torch.float64),
                             solve="pallas_cg", backward="one_step")
    svc.flush()
    assert cg_ops.LAUNCHES == launches
    assert f.result().info.iterations == 1
    assert {k.backward for k, _ in svc._compiled} == {"exact", "one_step"}


def test_spec_routing_overrides_and_rejections():
    svc = _svc(cache=None)
    spec = ImplicitDiffSpec(solve="cg", tol=1e-9)
    fut = svc.submit(3.0 * np.eye(4), np.ones(4), positive_definite=True,
                     spec=spec, maxiter=77)
    svc.flush()
    assert fut.result().info is not None
    (bkey, _cap), = svc._compiled.keys()
    assert (bkey.solver, bkey.tol, bkey.maxiter) == ("cg", 1e-9, 77)
    with pytest.raises(ValueError, match="custom"):
        svc.submit(np.eye(3), np.ones(3), solve=lambda mv, b: b)
    with pytest.raises(ValueError, match="precond"):
        svc.submit(np.eye(3), np.ones(3), precond=lambda v: v)
    with pytest.raises(ValueError, match="MAX_DENSE_DIM"):
        svc.submit(np.eye(600), np.ones(600))


def test_explicit_none_overrides_spec_precond():
    svc = _svc(cache=None)
    spec = ImplicitDiffSpec(solve="cg", precond="jacobi")
    svc.submit(3.0 * np.eye(4), np.ones(4), positive_definite=True,
               spec=spec)
    svc.submit(3.0 * np.eye(4), np.ones(4), positive_definite=True,
               spec=spec, precond=None)
    assert [r.key.precond for r in svc._queue] == ["jacobi", None]


def test_bad_routing_fails_fast_at_admission():
    svc = _svc(cache=None)
    upper = np.triu(np.ones((4, 4)))               # detectably nonsymmetric
    with pytest.raises(ValueError, match="symmetric-only"):
        svc.submit(upper, np.ones(4), solve="cg")
    with pytest.raises(ValueError, match="symmetric-only"):
        svc.submit(np.eye(4), np.ones(4), symmetric=False,
                   solve="pallas_cg")
    with pytest.raises(ValueError, match="unknown linear solver"):
        svc.submit(np.eye(4), np.ones(4), solve="no_such_solver")
    assert svc.metrics["requests"] == 0


def test_tensor_and_pytree_requests():
    """Tensors are admitted like arrays; a dict rhs comes back as a dict."""
    svc = _svc(cache=None, solve="cg")
    A = torch.diag(torch.arange(1.0, 6.0, dtype=torch.float64))
    f1 = svc.submit(A, torch.ones(5, dtype=torch.float64),
                    positive_definite=True)
    f2 = svc.submit(A, {"b": np.ones(2), "a": np.ones(3)},
                    positive_definite=True)
    svc.flush()
    np.testing.assert_allclose(f1.result().x, 1.0 / np.arange(1.0, 6.0))
    x2 = f2.result().x
    np.testing.assert_allclose(x2["a"].numpy(), [1.0, 1 / 2, 1 / 3])
    np.testing.assert_allclose(x2["b"].numpy(), [1 / 4, 1 / 5])


# -- warm-start cache --------------------------------------------------------

def test_warm_start_hits_and_counters():
    rng = np.random.default_rng(5)
    A, b = _spd(rng, 8), rng.standard_normal(8)
    svc = _svc()
    cold = svc.submit(A, b, positive_definite=True)
    svc.flush()
    warm = svc.submit(A, b, positive_definite=True)
    svc.flush()
    assert not cold.result().warm_start and warm.result().warm_start
    assert int(warm.result().info.iterations) == 0     # exact repeat
    assert (svc.cache.hits, svc.cache.misses) == (1, 1)
    assert svc.hit_rate == 0.5
    near = svc.submit(A * (1 + 1e-9), b, positive_definite=True)
    svc.flush()
    assert near.result().warm_start


def test_cache_eviction_under_capacity_pressure():
    rng = np.random.default_rng(6)
    cache = WarmStartCache(capacity=4)
    svc = _svc(cache=cache)
    systems = [(_spd(rng, 6), rng.standard_normal(6)) for _ in range(8)]
    for A, b in systems:
        svc.submit(A, b, positive_definite=True)
    svc.flush()
    assert len(cache) == 4 and cache.evictions == 4
    futs = [svc.submit(A, b, positive_definite=True) for A, b in systems]
    svc.flush()
    warm_flags = [f.result().warm_start for f in futs]
    assert warm_flags[4:] == [True] * 4
    assert warm_flags[:4] == [False] * 4
    assert svc.metrics["cache_evictions"] == cache.evictions


def test_fingerprints_match_the_jax_cache():
    """Same numpy sketch, same BucketKey repr: the same fingerprint."""
    from repro.runtime import BucketKey as JaxBucketKey
    rng = np.random.default_rng(7)
    A, b = _spd(rng, 6), rng.standard_normal(6)
    fields = (6, "dense_gmres", None, True, True, "float64", 1e-6, 1000, 0.0)
    assert repr(BucketKey(*fields)) == repr(JaxBucketKey(*fields))
    assert WarmStartCache().fingerprint(A, b, BucketKey(*fields)) == \
        JaxWarmStartCache().fingerprint(A, b, JaxBucketKey(*fields))
    k2 = BucketKey(*fields)._replace(solver="cg")
    assert WarmStartCache().fingerprint(A, b, k2) != \
        WarmStartCache().fingerprint(A, b, BucketKey(*fields))


def test_cache_saved_by_jax_service_loads_with_same_hits(tmp_path):
    rng = np.random.default_rng(8)
    systems = [(_spd(rng, 6), rng.standard_normal(6)) for _ in range(5)]
    jsvc = JaxSolveService()
    for A, b in systems:
        jsvc.submit(A, b, positive_definite=True)
    jsvc.flush()
    path = jsvc.cache.save(tmp_path / "warm")
    svc = _svc(cache=WarmStartCache.load(path))
    assert len(svc.cache) == 5
    futs = [svc.submit(A, b, positive_definite=True) for A, b in systems]
    svc.flush()
    assert all(f.result().warm_start for f in futs)
    assert all(int(f.result().info.iterations) == 0 for f in futs)
    assert svc.cache.hits == 5
    # and back: the port's save loads in the JAX package
    back = JaxWarmStartCache.load(svc.cache.save(tmp_path / "back"))
    assert len(back) == 5


def test_warm_start_disabled_per_request_and_per_service():
    A, b = 2.0 * np.eye(4), np.ones(4)
    svc = _svc()
    svc.submit(A, b, positive_definite=True)
    svc.flush()
    f = svc.submit(A, b, positive_definite=True, warm_start=False)
    svc.flush()
    assert not f.result().warm_start
    svc_off = _svc(cache=None)
    g = svc_off.submit(A, b, positive_definite=True)
    svc_off.flush()
    assert not g.result().warm_start and svc_off.hit_rate == 0.0


# -- fault isolation ---------------------------------------------------------

@pytest.fixture
def _boom_solver():
    name = "_svc_test_boom"

    def boom(matvec, b, **kwargs):
        raise RuntimeError("kaboom")

    ls.register_solver(name, boom)
    try:
        yield name
    finally:
        ls._REGISTRY.pop(name, None)


def test_dispatch_failure_is_fault_isolated(_boom_solver):
    svc = _svc(cache=None)
    bad = svc.submit(np.eye(4), np.ones(4), solve=_boom_solver)
    good = svc.submit(2.0 * np.eye(6), np.ones(6), positive_definite=True)
    assert svc.flush() == 2
    with pytest.raises(RuntimeError, match="kaboom"):
        bad.result(timeout=5.0)
    assert bool(good.result(timeout=5.0).info.converged)


def test_scheduler_thread_survives_dispatch_failure(_boom_solver):
    svc = _svc(cache=None)
    svc.start(interval=0.001)
    try:
        bad = svc.submit(np.eye(4), np.ones(4), solve=_boom_solver)
        with pytest.raises(RuntimeError, match="kaboom"):
            bad.result(timeout=30.0)
        good = svc.submit(2.0 * np.eye(4), np.ones(4),
                          positive_definite=True)
        assert bool(good.result(timeout=30.0).info.converged)
    finally:
        svc.stop()


# -- concurrency -------------------------------------------------------------

def test_background_scheduler_thread():
    rng = np.random.default_rng(9)
    svc = _svc()
    svc.start(interval=0.001)
    try:
        futs = [svc.submit(_spd(rng, 8), rng.standard_normal(8),
                           positive_definite=True) for _ in range(12)]
        svc.drain(timeout=30.0)
        assert all(f.done() for f in futs)
        results = [f.result(timeout=30.0) for f in futs]
    finally:
        svc.stop()
    assert all(bool(r.info.converged) for r in results)
    assert svc.metrics["requests"] == 12


def test_concurrent_submitters():
    svc = _svc(cache=None)
    out = []
    lock = threading.Lock()

    def client(seed):
        r = np.random.default_rng(seed)
        f = svc.submit(_spd(r, 8), r.standard_normal(8),
                       positive_definite=True)
        with lock:
            out.append(f)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
        assert not t.is_alive()
    assert svc.flush() == 8
    results = [f.result() for f in out]
    assert all(bool(r.info.converged) for r in results)
    assert len({r.uid for r in results}) == 8


def test_metrics_exports():
    svc = _svc()
    svc.submit(2.0 * np.eye(3), np.ones(3), positive_definite=True)
    svc.flush()
    summary = svc.metrics_summary()
    assert summary["dispatches"] == 1 and summary["cache_size"] == 1
    snap = svc.metrics_snapshot()
    assert snap["repro_service_requests_total"]["type"] == "counter"
    assert "repro_service_solve_seconds_bucket" in \
        svc.registry.to_prometheus()
