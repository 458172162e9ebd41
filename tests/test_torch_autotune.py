"""The port's tuning cache and cost model against the JAX package, and the
batched-CG kernel's tuned layout.

CPU: a cache saved by either package loads in the other with equal
entries; ``predict_solve_seconds``, ``should_shard``, ``auto_mesh_size``,
``mesh_candidates``, ``normalize_precond`` and ``operator_regime`` decide
as the reference does on the same seeded caches, backend names given
explicitly (roofline *seconds* differ by design: the port's constants are
the H100's); the ``repro_autotune_*`` counters carry the reference's
names and labels; ``choose_layout`` on a cold cache equals
``kernel.layout`` for every (d, dtype) the kernel takes, on a measured
cache gives the argmin, and raises on an entry whose layout does not
fit; ``batched_cg(layout=...)`` on CPU tensors equals the plain version.

Card (``cuda`` marker; skipped without a CUDA device):
``measure_layout_schedule`` records one entry per fitting layout,
``choose_layout`` resolves to the layout a ``pallas_cg`` solve launches,
and a cache entry naming a layout that does not fit raises.  The JAX
package is imported inside the tests that use it, so that on a machine
without JAX the card tests run alone::

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \
        tests/test_torch_autotune.py
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.analysis import autotune as tat
from repro_torch.analysis import roofline as troof
from repro_torch.core import linear_solve as tls
from repro_torch.core import operators as tops
from repro_torch.kernels.batched_cg import kernel, ops, ref
from repro_torch.observability import metrics as tmetrics

BACKEND = "cuda"


def _jax_autotune():
    return importlib.import_module("repro.analysis.autotune")


def _key(at, solver, B, d, mesh_size=1, variant="", backend=BACKEND,
         dtype="float32", precond=""):
    return at.TuningKey(backend, solver, B, d, dtype, mesh_size, precond,
                        variant)


def _seeded(at, B, d, *, sharded_loses, mesh_sizes=(2, 4, 8), spd=True):
    """A cache where every sharded candidate measures 2x worse (or 2x
    better) than the measured single-device route."""
    cache = at.TuningCache()
    single = at.single_device_solver(spd, d)
    sharded = "sharded_cg" if spd else "sharded_normal_cg"
    cache.put(_key(at, single, B, d), 1e-3)
    for m in mesh_sizes:
        cache.put(_key(at, sharded, B, d, mesh_size=m),
                  2e-3 if sharded_loses else 5e-4)
    return cache


def _plain(items):
    return [(tuple(k), (r.seconds, r.source, r.samples)) for k, r in items]


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

def _filled(at):
    cache = at.TuningCache()
    cache.put(_key(at, "pallas_cg", 64, 16), 4.2e-4)
    cache.put(_key(at, "sharded_cg", 64, 16, mesh_size=8), 1.3e-3,
              samples=7)
    cache.put(_key(at, "batched_cg", 64, 512, variant="layout=C8"), 2.8e-4,
              samples=100)
    cache.put(_key(at, "cg", 8, 4, backend="cpu", dtype="float64",
                   precond="jacobi"), 1e-3, source="roofline")
    return cache


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_files_cross_between_packages(tmp_path, writer):
    jat = _jax_autotune()
    src, dst = (jat, tat) if writer == "jax" else (tat, jat)
    cache = _filled(src)
    path = cache.save(tmp_path / "tuned")
    assert path.endswith(".json")
    restored = dst.TuningCache.load(path)
    assert _plain(restored.items()) == _plain(cache.items())
    assert restored.get(_key(dst, "sharded_cg", 64, 16, mesh_size=8)
                        ).samples == 7


def test_cache_round_trip_version_and_scoping(tmp_path, monkeypatch):
    import json
    cache = _filled(tat)
    assert cache.lookup(backend=BACKEND, solver="pallas_cg", B=64, d=16) \
        == cache.get(_key(tat, "pallas_cg", 64, 16))
    assert len(cache) == 4 and _key(tat, "pallas_cg", 64, 16) in cache
    path = cache.save(tmp_path / "tuned.json")
    blob = json.load(open(path))
    blob["format_version"] = tat.TuningCache._SAVE_VERSION + 1
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(blob))
    with pytest.raises(ValueError, match="format version"):
        tat.TuningCache.load(bad)
    monkeypatch.setenv(tat.CACHE_ENV_VAR, path)
    prev = tat.set_default_cache(None)
    try:
        assert _plain(tat.default_cache().items()) == _plain(cache.items())
    finally:
        tat.set_default_cache(prev)
    inner = tat.TuningCache()
    outer = tat.default_cache()
    with tat.use_cache(inner):
        assert tat.default_cache() is inner
    assert tat.default_cache() is outer


# ---------------------------------------------------------------------------
# decisions, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sharded_loses", [True, False])
@pytest.mark.parametrize("B,d,spd", [(64, 16, True), (16, 600, False),
                                     (64, 512, True)])
def test_decisions_equal_reference(B, d, spd, sharded_loses):
    jat = _jax_autotune()
    out = {}
    for name, at in (("jax", jat), ("port", tat)):
        cache = _seeded(at, B, d, sharded_loses=sharded_loses, spd=spd)
        cold = at.TuningCache()
        out[name] = [
            at.single_device_solver(spd, d),
            at.should_shard(B, d, mesh_size=8, spd=spd, cache=cache,
                            backend=BACKEND),
            at.should_shard(B, d, mesh_size=1, spd=spd, cache=cache,
                            backend=BACKEND),
            at.should_shard(B, d, mesh_size=4, spd=spd, cache=cold,
                            backend=BACKEND),
            at.should_shard(4, 600, mesh_size=8, spd=spd, cache=cold,
                            instance_sharded=True, backend=BACKEND),
            at.auto_mesh_size(B, d, max_devices=8, spd=spd, cache=cache,
                              backend=BACKEND),
            at.auto_mesh_size(B, d, max_devices=8, spd=spd, cache=cold,
                              backend=BACKEND),
            at.predict_solve_seconds(
                at.single_device_solver(spd, d), B, d, cache=cache,
                backend=BACKEND),
            at.predict_solve_seconds("sharded_cg", B, d, mesh_size=8,
                                     cache=cold, backend=BACKEND)[1],
        ]
    assert out["port"] == out["jax"]


def test_auto_mesh_size_and_candidates_equal_reference():
    jat = _jax_autotune()
    for B in (1, 4, 6, 12, 64, 96):
        for cap in (1, 2, 4, 8):
            assert tat.mesh_candidates(B, cap) == jat.mesh_candidates(B, cap)
    for at in (jat, tat):
        cache = _seeded(at, 64, 16, sharded_loses=True)
        cache.put(_key(at, "sharded_cg", 64, 16, mesh_size=1), 8e-4)
        cache.put(_key(at, "sharded_cg", 64, 16, mesh_size=4), 3e-4)
        assert at.auto_mesh_size(64, 16, max_devices=8, cache=cache,
                                 backend=BACKEND) == 4
        one = at.TuningCache()
        one.put(_key(at, "sharded_cg", 64, 16, mesh_size=2), 1e-3)
        assert at.auto_mesh_size(64, 16, max_devices=8, cache=one,
                                 backend=BACKEND) == 2
        cold = at.TuningCache()
        assert [at.auto_mesh_size(B, 16, max_devices=8, cache=cold,
                                  backend=BACKEND) for B in (64, 4, 6)] \
            == [8, 4, 2]
    assert tat.mesh_candidates(64) == tat.mesh_candidates(
        64, torch.cuda.device_count())


def test_normalize_precond_and_operator_regime_equal_reference():
    jat = _jax_autotune()
    import jax.numpy as jnp
    for pc in (None, "jacobi", "block_jacobi", lambda v: v):
        assert tat.normalize_precond(pc) == jat.normalize_precond(pc)
    from repro.core import operators as jops
    rng = np.random.default_rng(0)
    for shape, dtype in (((8, 5, 5), np.float32), ((7, 7), np.float32),
                         ((3, 4, 4), np.float64)):
        A = rng.standard_normal(shape).astype(dtype)
        got = tat.operator_regime(tops.DenseOperator(torch.from_numpy(A)))
        want = jat.operator_regime(jops.DenseOperator(jnp.asarray(A)))
        assert got == want


def test_predictions_measured_first_roofline_else():
    cache = tat.TuningCache()
    cache.put(_key(tat, "pallas_cg", 64, 512), 2.9e-4)
    assert tat.predict_solve_seconds("pallas_cg", 64, 512, cache=cache,
                                     backend=BACKEND) == (2.9e-4, "measured")
    secs, source = tat.predict_solve_seconds("cg", 64, 512, cache=cache,
                                             backend=BACKEND)
    want = troof.analyze_solve(64, 512, dtype_bytes=4).step_time_s
    assert source == "roofline" and secs == pytest.approx(want)
    # a roofline record in the cache is not a measurement
    cache.put(_key(tat, "cg", 64, 512), 1.0, source="roofline")
    assert tat.predict_solve_seconds("cg", 64, 512, cache=cache,
                                     backend=BACKEND)[1] == "roofline"


def test_counters_named_as_in_reference():
    jat = _jax_autotune()
    from repro.observability import metrics as jmetrics
    snaps = {}
    for name, at, reg in (("jax", jat, jmetrics), ("port", tat, tmetrics)):
        registry = reg.reset_global_registry()
        cache = _seeded(at, 64, 16, sharded_loses=True)
        cache.put(_key(at, "cg", 1, 1), 1.0, source="roofline")
        at.predict_solve_seconds("pallas_cg", 64, 16, cache=cache,
                                 backend=BACKEND)
        at.predict_solve_seconds("cg", 64, 16, cache=cache, backend=BACKEND)
        at.should_shard(64, 16, mesh_size=8, cache=cache, backend=BACKEND)
        at.should_shard(64, 16, mesh_size=1, cache=cache, backend=BACKEND)
        at.should_shard(64, 16, mesh_size=8, cache=at.TuningCache(),
                        backend=BACKEND)
        snaps[name] = {k: v for k, v in registry.snapshot().items()
                       if k.startswith("repro_autotune_")}
    assert set(snaps["port"]) == {"repro_autotune_cache_puts_total",
                                  "repro_autotune_predictions_total",
                                  "repro_autotune_shard_decisions_total"}
    assert snaps["port"] == snaps["jax"]


def test_measure_and_measure_solver_on_the_cpu():
    calls = []
    assert tat.measure(lambda: calls.append(1), warmup=2, iters=3) >= 0.0
    assert len(calls) == 5
    cache = tat.TuningCache()
    rec = tat.measure_solver("cg", 4, 6, dtype="float64", cache=cache,
                             iters=2, device="cpu")
    assert rec.source == "measured" and rec.samples == 2
    assert cache.get(_key(tat, "cg", 4, 6, backend="cpu",
                          dtype="float64")) == rec
    # a sharded row needs a mesh of mesh_size ranks; one process has one,
    # and asking for more starts no process group
    with pytest.raises(ValueError, match="requested 2 devices"):
        tat.measure_solver("sharded_cg", 4, 6, mesh_size=2, device="cpu")
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="mesh_size"):
        tat.measure_solver("cg", 4, 6, mesh_size=2, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tat.measure_layout_schedule(4, 6, device="cpu")


# ---------------------------------------------------------------------------
# the batched-CG kernel's layout
# ---------------------------------------------------------------------------

def test_layout_candidates_at_the_swept_shapes():
    assert tat.layout_candidates(512, "float32") == ["C8", "stream"]
    assert tat.layout_candidates(128, torch.float32) == \
        ["C1", "C2", "C4", "C8", "stream"]
    assert tat.layout_candidates(512, "float64") == ["stream"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_choose_layout_cold_is_the_rule(dtype):
    with tat.use_cache(tat.TuningCache()):
        for d in range(1, kernel.MAX_DIM + 1):
            got = tat.choose_layout(64, d, dtype)
            assert got == kernel.layout(d, dtype), d
            assert got in tat.layout_candidates(d, dtype)


def test_choose_layout_measured_argmin_and_misfit():
    cache = tat.TuningCache()
    for name, secs in (("C1", 3e-4), ("C2", 2e-4), ("C4", 2e-4),
                       ("C8", 5e-4), ("stream", 9e-4)):
        cache.put(_key(tat, "batched_cg", 64, 128,
                       variant=f"layout={name}"), secs)
    assert tat.choose_layout(64, 128, "float32", cache=cache,
                             backend=BACKEND) == "C2"     # tie: rule order
    assert tat.choose_layout(32, 128, "float32", cache=cache,
                             backend=BACKEND) == kernel.layout(128,
                                                               torch.float32)
    cache.put(_key(tat, "batched_cg", 64, 512, variant="layout=C1"), 1e-5)
    with pytest.raises(ValueError, match="does not fit"):
        tat.choose_layout(64, 512, "float32", cache=cache, backend=BACKEND)
    cache.put(_key(tat, "batched_cg", 64, 512, variant="layout=C8"), 2e-4,
              source="roofline")
    with pytest.raises(ValueError, match="does not fit"):
        tat.choose_layout(64, 512, torch.float32, cache=cache,
                          backend=BACKEND)


@pytest.mark.parametrize("layout", [None, "auto", "C1", "stream"])
def test_layout_argument_on_cpu_tensors_equals_plain(layout):
    rng = np.random.default_rng(3)
    C = rng.standard_normal((5, 9, 9))
    A = torch.from_numpy(np.einsum("bji,bjk->bik", C, C) + np.eye(9))
    b = torch.from_numpy(rng.standard_normal((5, 9)))
    cache = tat.TuningCache()   # a misfit entry: ignored on the CPU
    cache.put(_key(tat, "batched_cg", 5, 9, variant="layout=C8"), 1e-9)
    with tat.use_cache(cache):
        x = ops.batched_cg(A, b, tol=1e-12, device="cpu", layout=layout)
    want = ref.batched_cg_ref(A, b, tol=1e-12, maxiter=9)
    assert torch.equal(x, want)


def test_unknown_layout_name_raises():
    A = torch.eye(3, dtype=torch.float64)[None]
    with pytest.raises(ValueError, match="layout"):
        ops.batched_cg(A, torch.ones(1, 3, dtype=torch.float64),
                       device="cpu", layout="C3")


def test_solve_pallas_cg_on_cpu_is_unchanged():
    rng = np.random.default_rng(4)
    C = rng.standard_normal((4, 6, 6))
    A = torch.from_numpy(np.einsum("bji,bjk->bik", C, C) + np.eye(6))
    b = torch.from_numpy(rng.standard_normal((4, 6)))
    op = tops.DenseOperator(A, positive_definite=True)
    x = tls.solve(op, b, method="pallas_cg", tol=1e-12)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(
        A.numpy(), b.numpy()[..., None])[..., 0], rtol=1e-9)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with `pytest -m cuda` on the "
                    "card)")
    return torch.device("cuda")


def _launched(before):
    return {k: v - before[k] for k, v in ops.LAUNCHES_BY_LAYOUT.items()
            if v != before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(128, "float32"), (512, "float32"),
                                     (512, "float64")])
def test_layout_schedule_records_each_fitting_layout(cuda_device, d, dtype):
    cache = tat.TuningCache()
    recs = tat.measure_layout_schedule(16, d, dtype=dtype, cache=cache,
                                       reps=2, replays=2)
    assert list(recs) == tat.layout_candidates(d, dtype)
    assert len(cache) == len(recs)
    for name, rec in recs.items():
        assert rec.source == "measured" and rec.seconds > 0
        assert cache.get(_key(tat, "batched_cg", 16, d, dtype=dtype,
                              variant=f"layout={name}")) == rec


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 512])
def test_choose_layout_is_what_pallas_cg_launches(cuda_device, d):
    rng = np.random.default_rng(d)
    C = rng.standard_normal((16, d, d)) / np.sqrt(d)
    A = torch.from_numpy(np.einsum("bji,bjk->bik", C, C) + 0.5 * np.eye(d)
                         ).float().to(cuda_device)
    b = torch.from_numpy(rng.standard_normal((16, d))).float().to(
        cuda_device)
    op = tops.DenseOperator(A, positive_definite=True)
    want = ref.batched_cg_ref(A, b, tol=1e-6, maxiter=d)
    for cache in (tat.TuningCache(), None):
        if cache is None:
            cache = tat.TuningCache()
            tat.measure_layout_schedule(16, d, cache=cache, reps=2,
                                        replays=2, device=cuda_device)
        chosen = tat.choose_layout(16, d, torch.float32, cache=cache)
        with tat.use_cache(cache):
            before = dict(ops.LAUNCHES_BY_LAYOUT)
            x = tls.solve(op, b, method="pallas_cg", tol=1e-6)
            torch.cuda.synchronize()
        assert _launched(before) == {chosen: 1}
        assert float(torch.linalg.vector_norm(x - want)
                     / torch.linalg.vector_norm(want)) <= 1e-4


@pytest.mark.cuda
def test_misfit_cache_entry_raises_on_the_card(cuda_device):
    A = torch.eye(512, device=cuda_device)[None].repeat(2, 1, 1)
    b = torch.ones(2, 512, device=cuda_device)
    cache = tat.TuningCache()
    cache.put(_key(tat, "batched_cg", 2, 512, variant="layout=C2"), 1e-6)
    before = dict(ops.LAUNCHES_BY_LAYOUT)
    with tat.use_cache(cache), pytest.raises(ValueError,
                                             match="does not fit"):
        ops.batched_cg(A, b, layout="auto")
    with pytest.raises(ValueError, match="shared memory"):
        ops.batched_cg(A, b, layout="C2")
    assert _launched(before) == {}
