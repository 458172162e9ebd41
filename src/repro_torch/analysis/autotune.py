"""Measured cost model + persistent tuning cache behind dispatch (PyTorch).

Counterpart of ``repro.analysis.autotune``.  The dispatch layer's
decisions rest on measurements where the cache has them and on the
roofline model where it has none:

  * ``TuningCache`` — a persistent map from a dispatch regime
    ``TuningKey(backend, solver, B, d, dtype, mesh_size, precond,
    variant)`` to a measured (or modeled) solve time.  Versioned JSON
    ``save``/``load``, the same format as the JAX package's (a file saved
    by either package loads in the other); ``REPRO_AUTOTUNE_CACHE``
    pre-loads the process default, so a deployment ships a pre-tuned
    cache as a file.
  * measurement — ``measure_solver`` / ``measure_layout_schedule`` time
    candidate micro-benchmarks and record them.  Measurement NEVER
    happens inside dispatch: decisions read the cache, which is filled on
    demand from host code or offline sweeps.
  * prediction — ``predict_solve_seconds`` returns the measured entry
    when one exists and otherwise falls back to the roofline solve model
    (``roofline.analyze_solve``).  Costs are only ever compared
    LIKE-FOR-LIKE: measured against measured, roofline against roofline.
  * decisions — ``should_shard`` and ``auto_mesh_size`` (the cost model
    that gates ``linear_solve``'s routing to the sharded solvers and picks
    ``launch.mesh.auto_mesh_size``'s extent) and ``choose_layout``, the tuned layout of the
    batched-CG kernel behind ``batched_cg(layout="auto")`` — the
    counterpart of the JAX package's ``choose_block_b`` (a TPU tile
    height): B.1's cluster size, measured per ``(backend, B, d, dtype)``
    and keyed ``variant="layout=<L>"``.

``current_backend()`` is ``"cuda"`` on a host with a CUDA device and
``"cpu"`` otherwise; a measurement is keyed by the device it ran on.  The
``repro_autotune_*`` counters go to the port's global metrics registry
under the JAX package's names.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import threading
import time
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import _device
from repro_torch.observability import metrics as obs_metrics

# repro_torch.core and the kernels' ops are imported inside functions:
# linear_solve and the batched-CG op consult this module at dispatch time.

_SHARD_ACCEPT_SLACK = 1.05   # shard when predicted <= single * slack


class TuningKey(NamedTuple):
    """One dispatch regime: everything a timing is conditioned on.

    ``backend`` is the device type the measurement ran on (``"cuda"`` or
    ``"cpu"``; timings never transfer across backends), ``solver`` a
    registry name (or ``"batched_cg"`` for kernel-layout entries),
    ``B``/``d``/``dtype`` the batched-system shape, ``mesh_size`` the 1-D
    solve-mesh extent (1 = single device), ``precond`` the normalized
    preconditioner tag ("" for none) and ``variant`` a free-form schedule
    qualifier (``"layout=C8"``).
    """
    backend: str
    solver: str
    B: int
    d: int
    dtype: str = "float32"
    mesh_size: int = 1
    precond: str = ""
    variant: str = ""


@dataclasses.dataclass(frozen=True)
class TuningRecord:
    """A cached cost: ``seconds`` per solve, its ``source`` (``"measured"``
    or ``"roofline"``) and how many timed ``samples`` produced it."""
    seconds: float
    source: str = "measured"
    samples: int = 0


def normalize_precond(precond) -> str:
    """Fold a ``precond`` argument to its cache-key tag ("" for none)."""
    if precond is None:
        return ""
    if isinstance(precond, str):
        return precond
    return "callable"


def current_backend() -> str:
    """The backend dispatch decisions are conditioned on: ``"cuda"`` on a
    host with a CUDA device, ``"cpu"`` otherwise."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _dtype_name(dtype) -> str:
    """``"float32"`` for ``torch.float32`` or ``"float32"``."""
    return str(dtype).replace("torch.", "")


class TuningCache:
    """Thread-safe store of ``TuningKey -> TuningRecord`` with versioned
    JSON persistence."""

    _SAVE_VERSION = 1

    def __init__(self):
        self._mutex = threading.Lock()
        self._store: Dict[TuningKey, TuningRecord] = {}

    def put(self, key: TuningKey, seconds: float, *,
            source: str = "measured", samples: int = 1) -> TuningRecord:
        """Insert/overwrite the cost record for ``key``."""
        rec = TuningRecord(seconds=float(seconds), source=str(source),
                           samples=int(samples))
        with self._mutex:
            self._store[TuningKey(*key)] = rec
        obs_metrics.global_registry().counter(
            "repro_autotune_cache_puts_total",
            help="tuning-cache inserts by record source",
            source=rec.source).inc()
        return rec

    def get(self, key: TuningKey) -> Optional[TuningRecord]:
        """The record for ``key``, or None when never tuned."""
        with self._mutex:
            return self._store.get(TuningKey(*key))

    def lookup(self, **fields) -> Optional[TuningRecord]:
        """Keyword-style ``get`` (defaults fill unspecified key fields)."""
        return self.get(TuningKey(**fields))

    def __len__(self) -> int:
        with self._mutex:
            return len(self._store)

    def __contains__(self, key: TuningKey) -> bool:
        return self.get(key) is not None

    def items(self) -> List[Tuple[TuningKey, TuningRecord]]:
        """A stable snapshot of all entries (sorted by key)."""
        with self._mutex:
            return sorted(self._store.items())

    def save(self, path) -> str:
        """Persist all entries to ``path`` as version-stamped JSON.

        Layout: ``{"format_version": 1, "entries": [{<key fields>,
        "seconds", "source", "samples"}, ...]}``.  Returns the path
        written (``.json`` appended when missing).
        """
        path = str(path)
        if not path.endswith(".json"):
            path += ".json"
        entries = [{**k._asdict(), **dataclasses.asdict(r)}
                   for k, r in self.items()]
        with open(path, "w") as f:
            json.dump({"format_version": self._SAVE_VERSION,
                       "entries": entries}, f, indent=1, sort_keys=True)
        return path

    @classmethod
    def load(cls, path) -> "TuningCache":
        """Restore a cache written by ``save``; rejects unknown versions."""
        with open(str(path)) as f:
            blob = json.load(f)
        version = int(blob.get("format_version", -1))
        if version != cls._SAVE_VERSION:
            raise ValueError(
                f"tuning cache file {str(path)!r} has format version "
                f"{version}; this build reads version {cls._SAVE_VERSION}")
        cache = cls()
        for e in blob["entries"]:
            key = TuningKey(**{f: e[f] for f in TuningKey._fields})
            cache.put(key, e["seconds"], source=e["source"],
                      samples=e["samples"])
        return cache


# ---------------------------------------------------------------------------
# the process-default cache
# ---------------------------------------------------------------------------

_DEFAULT_CACHE: Optional[TuningCache] = None
_DEFAULT_MUTEX = threading.Lock()

#: environment variable naming a ``TuningCache.save`` file to pre-load as
#: the process default — how a deployment ships a pre-tuned cache.
CACHE_ENV_VAR = "REPRO_AUTOTUNE_CACHE"


def default_cache() -> TuningCache:
    """The process-wide cache every dispatch decision consults.

    Created empty on first use — unless ``REPRO_AUTOTUNE_CACHE`` names a
    readable ``TuningCache.save`` file, which is loaded instead.
    """
    global _DEFAULT_CACHE
    with _DEFAULT_MUTEX:
        if _DEFAULT_CACHE is None:
            path = os.environ.get(CACHE_ENV_VAR, "")
            if path and os.path.exists(path):
                _DEFAULT_CACHE = TuningCache.load(path)
            else:
                _DEFAULT_CACHE = TuningCache()
        return _DEFAULT_CACHE


def set_default_cache(cache: Optional[TuningCache]) -> Optional[TuningCache]:
    """Replace the process-default cache; returns the previous one.

    ``None`` resets to lazy re-initialization (re-reading the env var).
    """
    global _DEFAULT_CACHE
    with _DEFAULT_MUTEX:
        prev, _DEFAULT_CACHE = _DEFAULT_CACHE, cache
    return prev


@contextlib.contextmanager
def use_cache(cache: TuningCache):
    """Scope ``cache`` as the process default (tests seed decisions so)."""
    prev = set_default_cache(cache)
    try:
        yield cache
    finally:
        set_default_cache(prev)


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def measure(fn: Callable[[], object], *, warmup: int = 1,
            iters: int = 5) -> float:
    """Median wall-clock seconds of ``fn()`` over ``iters`` timed runs.

    ``warmup`` untimed calls run first (kernel builds and allocator
    warm-up never count); each timed run ends in
    ``torch.cuda.synchronize()`` on a host with a CUDA device, since a
    launch returns before the device finishes.
    """
    for _ in range(max(warmup, 0)):
        fn()
    _sync()
    samples = []
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        fn()
        _sync()
        samples.append(time.perf_counter() - t0)
    return float(statistics.median(samples))


def device_seconds(fn: Callable[[], object], *, reps: int = 20,
                   replays: int = 5, warmup: int = 3) -> float:
    """Device seconds of one call of ``fn`` on the current CUDA device.

    ``warmup`` calls run on a side stream, then ``reps`` calls are
    captured in a CUDA graph, replayed once, and replayed ``replays``
    times between two CUDA events: the host's cost of each call (checks,
    allocation, the ctypes call) is left out.  ``fn`` runs on the device
    ``warmup + reps * (1 + replays)`` times.
    """
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / (reps * replays)


def _synthetic_spd(B: int, d: int, dtype: str, seed: int = 0):
    """A well-conditioned random SPD batch (B, d, d) + rhs (B, d)."""
    rng = np.random.RandomState(seed)
    C = rng.randn(B, d, d) / np.sqrt(d)
    A = np.einsum("bji,bjk->bik", C, C) + 0.5 * np.eye(d)
    b = rng.randn(B, d)
    # cast LAST: NumPy-2 scalar promotion would float64 the intermediate
    return A.astype(dtype), b.astype(dtype)


def measure_solver(solver: str, B: int, d: int, *, dtype: str = "float32",
                   mesh_size: int = 1, precond=None,
                   cache: Optional[TuningCache] = None, tol: float = 1e-6,
                   maxiter: int = 200, warmup: int = 1, iters: int = 5,
                   seed: int = 0, device=None) -> TuningRecord:
    """Micro-benchmark one registry solver on a synthetic SPD regime and
    record the median into the cache.

    The system is a ``DenseOperator`` on ``device`` (``None``: ``cuda``),
    solved through ``linear_solve.solve(method=solver)``.  ``sharded_*``
    solvers run on a fresh 1-D mesh of ``mesh_size`` ranks
    (``launch.mesh.make_solve_mesh``) with the batch axis sharded (the
    production hypergradient layout); every rank holds the whole synthetic
    batch and solves its slice.  The median of ``measure`` (wall clock,
    synchronized) captures steady-state execution, host dispatch and the
    sharded path's placement overhead included, with the first call in the
    warmup.  A single-rank process group that the mesh had to start is
    destroyed before returning; a group the caller runs stays.
    """
    from repro_torch.core import linear_solve as ls
    from repro_torch.core import operators as ops

    cache = cache if cache is not None else default_cache()
    dev = _device.resolve(device)
    A_np, b_np = _synthetic_spd(B, d, dtype, seed)
    A = torch.as_tensor(A_np, device=dev)
    b = torch.as_tensor(b_np, device=dev)
    op = ops.DenseOperator(A, positive_definite=True)
    if not solver.startswith("sharded_"):
        if mesh_size != 1:
            raise ValueError(f"single-device solver {solver!r} cannot be "
                             f"measured at mesh_size={mesh_size}")
        seconds = measure(lambda: ls.solve(op, b, method=solver, tol=tol,
                                           maxiter=maxiter),
                          warmup=warmup, iters=iters)
    else:
        import torch.distributed as dist

        from repro_torch.distributed.sharded_operators import ShardedOperator
        from repro_torch.distributed.spec import P
        from repro_torch.launch import mesh as mesh_mod
        started_here = not dist.is_initialized()
        try:
            mesh = mesh_mod.make_solve_mesh(devices=int(mesh_size),
                                            device=dev)
            sop = ShardedOperator(op, mesh, P("data", None))
            seconds = measure(lambda: ls.solve(sop, b, method=solver,
                                               tol=tol, maxiter=maxiter),
                              warmup=warmup, iters=iters)
        finally:
            if started_here:
                mesh_mod._release_own_group()
    key = TuningKey(dev.type, solver, int(B), int(d), dtype,
                    int(mesh_size), normalize_precond(precond))
    return cache.put(key, seconds, source="measured", samples=iters)


# ---------------------------------------------------------------------------
# the batched-CG kernel's layout (the counterpart of block_b="auto")
# ---------------------------------------------------------------------------

def _layout_key(backend: str, B: int, d: int, dtype: str,
                layout: str) -> TuningKey:
    return TuningKey(backend, "batched_cg", int(B), int(d), dtype, 1, "",
                     f"layout={layout}")


def layout_candidates(d: int, dtype) -> List[str]:
    """The batched-CG kernel's layouts (``kernel.LAYOUTS``) whose slice of
    A fits a CTA's shared memory at ``d`` in ``dtype``
    (``kernel.smem_bytes``); the stream route always fits."""
    from repro_torch.kernels.batched_cg import kernel
    itemsize = torch.empty((), dtype=getattr(
        torch, _dtype_name(dtype))).element_size()
    return [name for name in kernel.LAYOUTS
            if name == "stream" or kernel.smem_bytes(
                int(d), itemsize, int(name[1:])) <= kernel.SMEM_BUDGET]


def measure_layout_schedule(B: int, d: int, *, dtype: str = "float32",
                            candidates: Optional[Iterable[str]] = None,
                            cache: Optional[TuningCache] = None,
                            tol: float = 1e-6,
                            maxiter: Optional[int] = None, reps: int = 20,
                            replays: int = 5, seed: int = 0,
                            device=None) -> Dict[str, TuningRecord]:
    """Time the batched-CG kernel at each layout at one ``(B, d, dtype)``
    point and record each candidate.

    Each candidate (default: ``layout_candidates(d, dtype)``) is one
    ``kernel.launch(A, b, layout=L)`` on a synthetic SPD batch on
    ``device`` (``None``: ``cuda``; the plain version has no layouts, so a
    CPU device raises), timed by device time (``device_seconds``: launches
    replayed from a CUDA graph between CUDA events — the host's ~20 µs a
    launch would blur layouts a few µs apart).  Entries are keyed
    ``solver="batched_cg"``, ``variant="layout=<L>"``.
    """
    from repro_torch.kernels.batched_cg import kernel

    cache = cache if cache is not None else default_cache()
    dev = _device.resolve(device)
    if dev.type != "cuda":
        raise ValueError("measure_layout_schedule times the batched-CG "
                         f"kernel, which runs on a CUDA device; got {dev}")
    A_np, b_np = _synthetic_spd(B, d, dtype, seed)
    A = torch.as_tensor(A_np, device=dev)
    b = torch.as_tensor(b_np, device=dev)
    maxiter = int(d) if maxiter is None else int(maxiter)
    out: Dict[str, TuningRecord] = {}
    with torch.cuda.device(dev):
        for name in (layout_candidates(d, dtype) if candidates is None
                     else candidates):
            seconds = device_seconds(
                lambda name=name: kernel.launch(A, b, tol=tol,
                                                maxiter=maxiter,
                                                layout=name),
                reps=reps, replays=replays)
            out[name] = cache.put(_layout_key("cuda", B, d, dtype, name),
                                  seconds, source="measured",
                                  samples=reps * replays)
    return out


def choose_layout(B: int, d: int, dtype, *,
                  cache: Optional[TuningCache] = None,
                  backend: Optional[str] = None) -> str:
    """The batched-CG kernel's layout for ``layout="auto"``.

    The fastest measured ``variant="layout=<L>"`` entry for this
    ``(backend, B, d, dtype)`` regime (``measure_layout_schedule`` or an
    offline sweep fills them); with no measurement, the kernel's own rule
    ``kernel.layout(d, dtype)`` — so ``"auto"`` never differs from the
    rule without a measurement.  A measured entry naming a layout whose
    slice does not fit ``d`` raises: nothing falls back.
    """
    from repro_torch.kernels.batched_cg import kernel

    cache = cache if cache is not None else default_cache()
    backend = backend or current_backend()
    name = _dtype_name(dtype)
    fits = layout_candidates(d, name)
    measured: Dict[str, float] = {}
    for layout in kernel.LAYOUTS:
        rec = cache.get(_layout_key(backend, B, d, name, layout))
        if rec is None or rec.source != "measured":
            continue
        if layout not in fits:
            raise ValueError(
                f"the tuning cache names batched_cg layout {layout} for "
                f"(B={B}, d={d}, {name}), whose slice does not fit; the "
                f"layouts that fit are {fits}")
        measured[layout] = rec.seconds
    if measured:
        return min(measured, key=lambda lay: (measured[lay],
                                              kernel.LAYOUTS.index(lay)))
    return kernel.layout(int(d), getattr(torch, name))


# ---------------------------------------------------------------------------
# prediction (measured first, roofline fallback)
# ---------------------------------------------------------------------------

def _dtype_bytes(dtype: str) -> int:
    return int(np.dtype(dtype).itemsize)


def roofline_solve_seconds(B: int, d: int, *, dtype: str = "float32",
                           mesh_size: int = 1,
                           instance_sharded: bool = False) -> float:
    """The cold-cache estimate: ``roofline.analyze_solve`` step time."""
    from repro_torch.analysis import roofline
    terms = roofline.analyze_solve(int(B), int(d),
                                   dtype_bytes=_dtype_bytes(dtype),
                                   mesh_size=int(mesh_size),
                                   instance_sharded=bool(instance_sharded))
    return terms.step_time_s


def predict_solve_seconds(solver: str, B: int, d: int, *,
                          dtype: str = "float32", mesh_size: int = 1,
                          precond=None, instance_sharded: bool = False,
                          cache: Optional[TuningCache] = None,
                          backend: Optional[str] = None) \
        -> Tuple[float, str]:
    """Predicted seconds for one solve and the prediction's source.

    Returns ``(seconds, "measured")`` when the cache holds a measurement
    for this exact regime, else ``(seconds, "roofline")`` from the
    hardware model.  Callers comparing candidates must compare like
    sources only — see ``should_shard``.
    """
    cache = cache if cache is not None else default_cache()
    key = TuningKey(backend or current_backend(), solver, int(B), int(d),
                    dtype, int(mesh_size), normalize_precond(precond))
    rec = cache.get(key)
    counter = obs_metrics.global_registry().counter
    if rec is not None and rec.source == "measured":
        counter("repro_autotune_predictions_total",
                help="cost predictions by source", source="measured").inc()
        return rec.seconds, "measured"
    counter("repro_autotune_predictions_total",
            help="cost predictions by source", source="roofline").inc()
    return roofline_solve_seconds(
        B, d, dtype=dtype, mesh_size=mesh_size,
        instance_sharded=instance_sharded), "roofline"


# ---------------------------------------------------------------------------
# decisions
# ---------------------------------------------------------------------------

def single_device_solver(spd: bool, d: int, plain: bool = True) -> str:
    """The single-device registry solver a regime would route to — the
    comparison point for every sharding decision (mirrors the dense /
    matrix-free split in ``linear_solve._resolve_auto``)."""
    from repro_torch.core import linear_solve as ls
    if d <= ls.MAX_DENSE_DIM:
        return "pallas_cg" if (spd and plain) else "dense_gmres"
    return "cg" if spd else "normal_cg"


def should_shard(B: int, d: int, *, mesh_size: int,
                 instance_sharded: bool = False, spd: bool = True,
                 dtype: str = "float32", precond=None, plain: bool = True,
                 cache: Optional[TuningCache] = None,
                 backend: Optional[str] = None) -> bool:
    """True when the cost model predicts the sharded solver wins (within
    5% slack) over the single-device path at this operand's mesh size.

    ``mesh_size <= 1`` always shards (a 1-device mesh is the
    single-device path).  Otherwise the sharded candidate
    (``sharded_cg`` for SPD, ``sharded_normal_cg`` else) is compared
    against ``single_device_solver``'s pick — measured-vs-measured when
    the cache holds BOTH sides, otherwise roofline-vs-roofline.  A cold
    cache therefore keeps structural behavior (the hardware model has
    batch sharding dividing per-device work with zero communication)
    until measurements prove a regime loses.
    """
    counter = obs_metrics.global_registry().counter

    def _decide(shard: bool, basis: str) -> bool:
        counter("repro_autotune_shard_decisions_total",
                help="sharding decisions by outcome and evidence basis",
                decision="shard" if shard else "single",
                basis=basis).inc()
        return shard

    if mesh_size <= 1:
        return _decide(True, "trivial")
    cache = cache if cache is not None else default_cache()
    backend = backend or current_backend()
    sharded = "sharded_cg" if spd else "sharded_normal_cg"
    single = single_device_solver(spd, d, plain)
    pc = normalize_precond(precond)
    rec_sh = cache.get(TuningKey(backend, sharded, int(B), int(d), dtype,
                                 int(mesh_size), pc))
    rec_si = cache.get(TuningKey(backend, single, int(B), int(d), dtype,
                                 1, pc))
    if rec_sh is not None and rec_si is not None:
        t_sh, t_si = rec_sh.seconds, rec_si.seconds
        basis = "measured"
    else:
        t_sh = roofline_solve_seconds(B, d, dtype=dtype,
                                      mesh_size=mesh_size,
                                      instance_sharded=instance_sharded)
        t_si = roofline_solve_seconds(B, d, dtype=dtype, mesh_size=1)
        basis = "roofline"
    return _decide(t_sh <= t_si * _SHARD_ACCEPT_SLACK, basis)


def mesh_candidates(B: int, max_devices: Optional[int] = None) -> List[int]:
    """Power-of-two mesh extents that divide ``B`` and fit the device
    count (``torch.cuda.device_count()`` unless ``max_devices``; 1 is
    always a candidate)."""
    cap = torch.cuda.device_count() if max_devices is None \
        else int(max_devices)
    out = [m for m in (1, 2, 4, 8, 16, 32, 64, 128)
           if m <= cap and m <= B and B % m == 0]
    return out or [1]


def auto_mesh_size(B: int, d: int, *, max_devices: Optional[int] = None,
                   spd: bool = True, dtype: str = "float32",
                   instance_sharded: bool = False, precond=None,
                   cache: Optional[TuningCache] = None,
                   backend: Optional[str] = None) -> int:
    """The mesh extent the cost model picks for a (B, d) solve regime.

    Candidates are power-of-two extents dividing ``B`` up to the local
    CUDA device count (or ``max_devices``).  When ANY candidate has a
    measured cache entry the argmin runs over measured candidates only (a
    measurement always outranks a model); a fully cold cache falls back
    to the roofline argmin, which for batch sharding selects the largest
    extent.  Ties break toward the smaller mesh.
    """
    cache = cache if cache is not None else default_cache()
    backend = backend or current_backend()
    solver = "sharded_cg" if spd else "sharded_normal_cg"
    pc = normalize_precond(precond)
    measured: Dict[int, float] = {}
    modeled: Dict[int, float] = {}
    for m in mesh_candidates(B, max_devices):
        rec = cache.get(TuningKey(backend, solver, int(B), int(d), dtype,
                                  int(m), pc))
        if rec is not None and rec.source == "measured":
            measured[m] = rec.seconds
        modeled[m] = roofline_solve_seconds(
            B, d, dtype=dtype, mesh_size=m,
            instance_sharded=instance_sharded)
    pool = measured if measured else modeled
    return min(sorted(pool), key=lambda m: (pool[m], m))


def operator_regime(A) -> Tuple[int, int, str]:
    """(B, d, dtype) of a ``LinearOperator``'s example — the dispatch
    regime key.  Batch-aware operators (``batch_ndim == 1``) read B off
    the leading axis; unbatched operators are B=1 with d the full raveled
    size."""
    from repro_torch.core._tree import tree_leaves
    leaves = tree_leaves(A.example)
    if not leaves:
        return 1, 1, "float32"
    dtype = _dtype_name(leaves[0].dtype)
    n = int(sum(leaf.numel() for leaf in leaves))
    if getattr(A, "batch_ndim", 0) == 1:
        Bn = int(leaves[0].shape[0])
        return Bn, max(n // max(Bn, 1), 1), dtype
    return 1, n, dtype
