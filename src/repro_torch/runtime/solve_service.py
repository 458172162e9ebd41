"""Continuous-batching implicit-diff solve service with a warm-start cache.

Counterpart of ``repro.runtime.solve_service`` in PyTorch.  Requests for
linear solves and implicit hypergradients from independent callers are
aggregated into **shape buckets**, and each bucket is dispatched as ONE
batched masked solve through ``route_solve`` on a stacked
``DenseOperator`` — on the GPU, SPD buckets of the plain ``"auto"`` route
(no cache, no preconditioner) run the hand-written batched-CG kernel.

  * **Bucketing** — requests are keyed by
    ``(d, solver, precond, symmetric/PD flags, dtype, tol, maxiter, ridge,
    backward mode)`` (``BucketKey``); one bucket is one batched
    block-diagonal system.
  * **Fixed shapes** — buckets are padded to power-of-two capacities
    (``bucket_capacity``) with identity systems and zero right-hand sides,
    which converge at loop entry.  The JAX service compiles one program
    per ``(key, capacity)``; this one runs the same function eagerly and
    builds one dispatch function per ``(key, capacity)``, counted in
    ``metrics["compiled"]``.
  * **Warm-start cache** — ``WarmStartCache``, keyed by a quantized
    problem fingerprint, with LRU eviction; its fingerprints are computed
    with numpy exactly as the JAX package computes them, so a cache saved
    by either package gives the same hits in the other.  A hit seeds the
    request's slot with the cached solution (``init``).
  * **Per-request diagnostics** — every request resolves to a
    ``ServiceResult`` with its own ``SolveInfo`` slice.

Staging stays on the host (numpy) and moves to the device with one copy
per stacked buffer per bucket.  dtypes are kept as the request gives them
(float64 stays float64) — the JAX service canonicalizes the dtype, which
is the identity under ``jax_enable_x64``.

The service runs on ``device`` (default ``"cuda"``; on a host without a
CUDA device ``SolveService()`` raises — pass ``device="cpu"`` for the
CPU).  Hypergradient requests may ask for an approximate backward mode
(``one_step`` / ``neumann_k`` / ``jacobian_free``): those get buckets of
their own, dispatch through ``approx_inverse_apply`` with its error
estimate, and never touch the warm-start cache.

Quickstart::

    svc = SolveService(device="cuda", cache=None)
    futs = [svc.submit(A_i, b_i, positive_definite=True) for ...]
    svc.flush()                               # ONE batched solve per bucket
    results = [f.result() for f in futs]      # ServiceResult each
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import itertools
import json
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.func

from repro_torch import _device
from repro_torch.core import linear_solve as ls
from repro_torch.core import operators as ops
from repro_torch.core._tree import canonical, ravel_pytree, tree_map
from repro_torch.core.linear_solve import MAX_DENSE_DIM, SolveInfo
from repro_torch.observability import events as obs_events
from repro_torch.observability import spans as obs_spans
from repro_torch.observability.metrics import LATENCY_BUCKETS, MetricsRegistry

# "argument not given" marker, distinct from None: an explicit ``None`` is a
# real override (e.g. ``precond=None`` clears a spec's preconditioner).
_UNSET = object()


class BucketKey(NamedTuple):
    """The bucket identity: requests sharing a key batch into one solve.

    Field names, order and value types match the JAX package's, so the
    warm-start fingerprints (which hash ``repr(key)``) agree across them.
    """
    d: int                       # instance dimension (raveled)
    solver: str                  # resolved registry solver name
    precond: Optional[str]       # None | "jacobi" | "block_jacobi"
    symmetric: Optional[bool]    # operator's declared symmetry flag
    positive_definite: bool      # operator's declared PD flag
    dtype: str                   # numpy name of the result dtype of (A, b)
    tol: float
    maxiter: int
    ridge: float
    # approximate-backward arm: exact and approximate hypergradient traffic
    # never share a bucket ("exact" | "one_step" | "neumann_k" |
    # "jacobian_free"; backward_iters is the neumann_k depth, 0 otherwise)
    backward: str = "exact"
    backward_iters: int = 0


def _bucket_label(key: BucketKey) -> str:
    """Compact, stable bucket tag for spans/events."""
    label = f"{key.solver}:d={key.d}:{key.dtype}"
    if key.backward != "exact":
        label += f":{key.backward}"
    return label


def bucket_capacity(n: int, max_batch: int = 64) -> int:
    """Pad a bucket of ``n`` requests to its fixed capacity: the next power
    of two, clamped to ``max_batch``."""
    if n < 1:
        raise ValueError(f"bucket needs at least one request, got n={n}")
    cap = 1
    while cap < n:
        cap *= 2
    return min(cap, max_batch)


@dataclasses.dataclass
class ServiceResult:
    """What a request's ``Future`` resolves to.

    ``x`` is the request's payload — the solution for a solve request (host
    numpy for a flat ``(d,)`` right-hand side, the unraveled tensor pytree
    on the service's device otherwise), the per-θ-argument gradient tuple
    for a hypergradient request.  ``info`` is this request's own
    ``SolveInfo`` slice (Python scalars).  ``queue_time``/``solve_time``
    are seconds spent waiting for a flush / inside the batched dispatch;
    ``bucket_size``/``bucket_capacity`` give the dispatch's occupancy;
    ``warm_start`` says whether a cached solution seeded the slot.
    """
    uid: int
    x: Any
    info: SolveInfo
    queue_time: float
    solve_time: float
    bucket_size: int
    bucket_capacity: int
    warm_start: bool


@dataclasses.dataclass
class _PendingRequest:
    """Internal queue entry: one admitted, not-yet-dispatched request."""
    uid: int
    key: BucketKey
    A: np.ndarray                # (d, d) materialized operator (host)
    b: np.ndarray                # (d,) raveled right-hand side (host)
    unravel: Optional[Callable]  # flat (d,) -> pytree; None = flat rhs
    future: Future
    fingerprint: Optional[str]   # warm-start cache key (None: cache off)
    init: Optional[np.ndarray]   # cached warm-start solution, if any
    finish: Optional[Callable]   # post-solve hook (hypergrad θ-VJP)
    enqueue_t: float = 0.0
    admit_t: float = 0.0         # admission start (span tracing)


def _host(a) -> np.ndarray:
    """A tensor or array-like as host numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class WarmStartCache:
    """LRU cache of solved systems keyed by a quantized problem fingerprint.

    The fingerprint is a sketch — ``A @ p`` for a fixed per-``d`` probe
    vector ``p`` (drawn with numpy from ``seed + d``), concatenated with
    ``b``, normalized and quantized to ``qtol`` relative resolution, then
    hashed together with the ``BucketKey``.  Exact repeats always collide;
    nearby problems usually collide, and a spurious collision only costs a
    worse initial guess.  Thread-safe.

    ``save(path)`` / ``WarmStartCache.load(path)`` persist the cache as a
    version-stamped ``.npz`` in the JAX package's layout: either package
    reads what the other wrote.
    """

    _SAVE_VERSION = 1

    def __init__(self, capacity: int = 256, qtol: float = 1e-3,
                 seed: int = 1234):
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.qtol = float(qtol)
        self._seed = int(seed)
        self._mutex = threading.Lock()
        self._store: "collections.OrderedDict[str, np.ndarray]" = \
            collections.OrderedDict()
        self._keys: dict = {}       # fingerprint -> BucketKey provenance
        self._probes: dict = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def _probe(self, d: int) -> np.ndarray:
        """The fixed unit probe vector for dimension ``d`` (built once)."""
        with self._mutex:
            p = self._probes.get(d)
            if p is None:
                rng = np.random.default_rng(self._seed + d)
                p = rng.standard_normal(d)
                p /= np.linalg.norm(p)
                self._probes[d] = p
            return p

    def fingerprint(self, A, b, key: BucketKey) -> str:
        """Hash a problem to its cache key (see the class docstring)."""
        A = np.asarray(_host(A), np.float64)
        b = np.asarray(_host(b), np.float64)
        sketch = np.concatenate([A @ self._probe(A.shape[-1]), b])
        scale = float(np.linalg.norm(sketch))
        if not np.isfinite(scale) or scale == 0.0:
            scale = 1.0
        q = np.round(sketch / (scale * self.qtol)).astype(np.int64)
        h = hashlib.blake2b(digest_size=16)
        h.update(repr(key).encode())
        h.update(q.tobytes())
        return h.hexdigest()

    def get(self, fingerprint: str) -> Optional[np.ndarray]:
        """Look up a warm start; counts a hit or a miss and refreshes LRU."""
        with self._mutex:
            x = self._store.get(fingerprint)
            if x is None:
                self.misses += 1
                return None
            self.hits += 1
            self._store.move_to_end(fingerprint)
            return x

    def put(self, fingerprint: str, x, key: Optional[BucketKey] = None) -> \
            None:
        """Insert/refresh a solution; evicts the LRU entry over capacity."""
        with self._mutex:
            self._store[fingerprint] = np.asarray(_host(x))
            self._store.move_to_end(fingerprint)
            if key is not None:
                self._keys[fingerprint] = key
            while len(self._store) > self.capacity:
                evicted, _ = self._store.popitem(last=False)
                self._keys.pop(evicted, None)
                self.evictions += 1

    def __len__(self) -> int:
        """Number of cached solutions currently resident."""
        with self._mutex:
            return len(self._store)

    @property
    def hit_rate(self) -> float:
        """Fraction of lookups served from cache (0.0 when none yet)."""
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def save(self, path) -> str:
        """Persist the cache to ``path`` as version-stamped ``.npz``; returns
        the path written (``.npz`` appended when missing)."""
        path = str(path)
        if not path.endswith(".npz"):
            path += ".npz"
        with self._mutex:
            items = list(self._store.items())
            keys = dict(self._keys)
        payload = {
            "format_version": np.asarray(self._SAVE_VERSION),
            "qtol": np.asarray(self.qtol),
            "seed": np.asarray(self._seed),
            "capacity": np.asarray(self.capacity),
            "fingerprints": np.asarray([fp for fp, _ in items]),
            "bucket_keys": np.asarray(
                [json.dumps(keys[fp]._asdict()) if fp in keys else ""
                 for fp, _ in items]),
        }
        for i, (_, x) in enumerate(items):
            payload[f"solution_{i}"] = np.asarray(x)
        np.savez(path, **payload)
        return path

    @classmethod
    def load(cls, path) -> "WarmStartCache":
        """Restore a cache written by ``save`` (either package's); rejects
        unknown versions.  Counters start fresh."""
        with np.load(str(path), allow_pickle=False) as z:
            version = int(z["format_version"])
            if version != cls._SAVE_VERSION:
                raise ValueError(
                    f"warm-start cache file {path!r} has format version "
                    f"{version}; this build reads version "
                    f"{cls._SAVE_VERSION}")
            cache = cls(capacity=int(z["capacity"]), qtol=float(z["qtol"]),
                        seed=int(z["seed"]))
            fingerprints = [str(fp) for fp in z["fingerprints"]]
            key_blobs = [str(s) for s in z["bucket_keys"]]
            for i, fp in enumerate(fingerprints):
                cache._store[fp] = np.asarray(z[f"solution_{i}"])
                if key_blobs[i]:
                    cache._keys[fp] = BucketKey(**json.loads(key_blobs[i]))
        return cache


class SolveService:
    """Async front end that batches independent solve requests per bucket.

    ``submit`` / ``submit_hypergrad`` enqueue work and return
    ``concurrent.futures.Future`` objects; ``flush()`` drains the queue,
    groups requests by ``BucketKey``, pads each group to a fixed capacity
    and dispatches it as ONE batched masked solve.  A background scheduler
    thread (``start()`` / ``stop()``) can flush continuously.

    Admission materializes each request's operator to its dense ``(d, d)``
    form on the host (``d ≤ MAX_DENSE_DIM``).

    Parameters:
      max_batch: bucket capacity ceiling (larger groups split into chunks).
      cache: a ``WarmStartCache`` (default: capacity 256) or ``None``.
      solve / tol / maxiter / ridge / precond: per-request defaults,
        overridable per call or by a routing-only ``ImplicitDiffSpec``.
      device: where dispatches run (default ``"cuda"``; raises on a host
        without a CUDA device).
    """

    _DEFAULT_CACHE = object()    # sentinel: build a fresh cache per service

    def __init__(self, *, max_batch: int = 64,
                 cache: Optional[WarmStartCache] = _DEFAULT_CACHE,
                 solve: Union[str, Callable] = "auto", tol: float = 1e-6,
                 maxiter: int = 1000, ridge: float = 0.0,
                 precond: Optional[str] = None, device=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.device = _device.resolve(device)
        self.max_batch = int(max_batch)
        self.cache = WarmStartCache() if cache is self._DEFAULT_CACHE \
            else cache
        self.defaults = dict(solve=solve, tol=float(tol),
                             maxiter=int(maxiter), ridge=float(ridge),
                             precond=precond)
        self._queue: "collections.deque[_PendingRequest]" = \
            collections.deque()
        self._compiled: dict = {}          # (BucketKey, cap) -> dispatch fn
        # reentrant: the MetricsRegistry below shares this lock
        self._lock = threading.RLock()
        self._uid = itertools.count()
        self._inflight = 0                 # requests popped but not resolved
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.registry = MetricsRegistry(lock=self._lock)
        reg = self.registry
        self._m_requests = reg.counter(
            "repro_service_requests_total", help="requests admitted")
        self._m_dispatches = reg.counter(
            "repro_service_dispatches_total", help="batched dispatches run")
        self._m_instances = reg.counter(
            "repro_service_instances_total",
            help="real (non-padding) instances dispatched")
        self._m_padded = reg.counter(
            "repro_service_padded_total",
            help="padding slots dispatched alongside real instances")
        self._m_occupancy_sum = reg.gauge(
            "repro_service_occupancy_sum",
            help="sum over dispatches of real/capacity occupancy")
        self._m_solve_time = reg.histogram(
            "repro_service_solve_seconds", buckets=LATENCY_BUCKETS,
            help="wall-clock seconds per batched dispatch")
        self._m_queue_wait = reg.histogram(
            "repro_service_queue_wait_seconds", buckets=LATENCY_BUCKETS,
            help="per-request seconds between enqueue and dispatch start")
        self._m_compiled = reg.gauge(
            "repro_service_compiled_programs",
            help="distinct (BucketKey, capacity) dispatch functions built")
        self._m_cache_hits = reg.gauge(
            "repro_service_cache_hits", help="warm-start cache hits")
        self._m_cache_misses = reg.gauge(
            "repro_service_cache_misses", help="warm-start cache misses")
        self._m_cache_evictions = reg.gauge(
            "repro_service_cache_evictions",
            help="warm-start cache LRU evictions")

    # -- admission -----------------------------------------------------------

    def _routing(self, spec, solve, tol, maxiter, ridge, precond) -> dict:
        """Merge service defaults < ``spec`` routing < explicit keywords.

        Omitted keywords arrive as ``_UNSET``, so an explicit ``None`` is a
        real override.
        """
        r = dict(self.defaults)
        if spec is not None:
            r.update(solve=spec.solve, **spec.routing_kwargs())
        for name, val in (("solve", solve), ("tol", tol),
                          ("maxiter", maxiter), ("ridge", ridge),
                          ("precond", precond)):
            if val is not _UNSET:
                r[name] = val
        if callable(r["solve"]):
            raise ValueError(
                "the solve service buckets by registry solver name; custom "
                "solve callables cannot be batched across requests — call "
                "route_solve directly for those")
        if r["precond"] is not None and not isinstance(r["precond"], str):
            raise ValueError(
                "the solve service buckets by preconditioner kind; pass "
                "precond=None/'jacobi'/'block_jacobi' (a callable M⁻¹ is "
                "request-specific and cannot key a shared bucket)")
        r["tol"] = float(r["tol"])
        r["maxiter"] = int(r["maxiter"])
        r["ridge"] = float(r["ridge"])
        return r

    def _on_device(self, tree):
        """Numpy leaves of a request pytree as tensors on the device."""
        return tree_map(lambda l: l if isinstance(l, torch.Tensor)
                        else torch.as_tensor(l, device=self.device), tree)

    def _admit_operator(self, A, b, symmetric, positive_definite):
        """Materialize the request operator and ravel the rhs, on the host.

        Accepts an instance-shaped ``LinearOperator``, a dense ``(d, d)``
        array or tensor, or a bare matvec callable (probed).  Returns
        ``(A_host, b_flat, unravel, symmetric, pd)``; a flat ``(d,)`` rhs
        takes the fast path (``unravel is None``).
        """
        if isinstance(A, ops.LinearOperator):
            if A.batch_ndim != 0:
                raise ValueError(
                    "submit() takes ONE instance per request (batch_ndim=0);"
                    " the service does the batching — split a batched "
                    "operator into per-instance requests")
            symmetric = A.symmetric if symmetric is None else symmetric
            positive_definite = A.positive_definite or bool(positive_definite)
            A_host = _host(A.materialize())        # d probing matvecs
        elif callable(A) and not hasattr(A, "ndim"):
            op = ops.FunctionOperator(
                A, self._on_device(b), symmetric=symmetric,
                positive_definite=bool(positive_definite))
            A_host = _host(op.materialize())
        else:
            A_host = _host(A)
            if A_host.ndim != 2 or A_host.shape[0] != A_host.shape[1]:
                raise ValueError(
                    f"expected a (d, d) operator, got {A_host.shape}")
            if symmetric is None:       # concrete matrix: detect, don't guess
                if positive_definite:   # declared PD certifies symmetry
                    symmetric = True
                else:
                    tol = 1e-8 * max(float(np.abs(A_host).max()), 1.0) + 1e-10
                    symmetric = bool(
                        np.abs(A_host - A_host.T).max() <= tol)
        if isinstance(b, (np.ndarray, torch.Tensor)) and b.ndim == 1:
            b_flat, unravel = _host(b), None       # flat fast path
        else:
            b_vec, unravel = ravel_pytree(self._on_device(b))
            b_flat = _host(b_vec)
        d = b_flat.shape[0]
        if d > MAX_DENSE_DIM:
            raise ValueError(
                f"the solve service batches dense instance systems; d={d} "
                f"exceeds MAX_DENSE_DIM={MAX_DENSE_DIM} — solve oversized "
                "systems directly through linear_solve.solve")
        return A_host, b_flat, unravel, symmetric, bool(positive_definite)

    def _resolve_solver(self, positive_definite: bool, precond) -> str:
        """Resolve ``"auto"`` ONCE at admission so bucket keys are stable.

        ``linear_solve._resolve_auto`` restricted to the service's regime.
        With the warm-start cache on the resolution assumes an ``init`` may
        arrive (steering off ``pallas_cg``, which always starts from zero),
        so cold and warm requests for a problem share one bucket.
        """
        plain = precond is None and self.cache is None
        return "pallas_cg" if positive_definite and plain else "dense_gmres"

    def _enqueue(self, pending: _PendingRequest) -> Future:
        pending.enqueue_t = time.perf_counter()
        with self._lock:
            self._queue.append(pending)
            self._m_requests.inc()
        return pending.future

    def _build_request(self, A, b, symmetric, positive_definite, spec,
                       solve, tol, maxiter, ridge, precond,
                       warm_start: bool, backward: str = "exact",
                       backward_iters: int = 0) -> _PendingRequest:
        """Admission: normalize, bucket-key, warm-start lookup (no enqueue)."""
        admit_t = time.perf_counter()
        r = self._routing(spec, solve, tol, maxiter, ridge, precond)
        A_dense, b_flat, unravel, sym, pd = self._admit_operator(
            A, b, symmetric, positive_definite)
        d = int(b_flat.shape[0])
        solver = r["solve"]
        if solver == "auto":
            solver = self._resolve_solver(pd, r["precond"])
        # unroutable requests fail HERE, in the caller's submit(), never
        # inside a batched dispatch where the whole bucket would pay
        solver_spec = ls.get_spec(solver)
        if solver_spec.symmetric_only and sym is False:
            raise ValueError(
                f"requested solver {solver!r} is symmetric-only, but this "
                f"request's operator declares symmetric={sym} "
                f"(positive_definite={pd}) — route a general solver "
                "(gmres/bicgstab/normal_cg/dense_gmres) instead, or fix "
                "the declared flags if the operator really is symmetric")
        dtype = np.result_type(A_dense.dtype, b_flat.dtype)
        key = BucketKey(d=d, solver=solver, precond=r["precond"],
                        symmetric=sym, positive_definite=pd,
                        dtype=str(dtype), tol=r["tol"],
                        maxiter=r["maxiter"], ridge=r["ridge"],
                        backward=backward, backward_iters=backward_iters)
        fingerprint = init = None
        if self.cache is not None and warm_start and backward == "exact":
            # approximate buckets skip the warm-start path: the polynomial
            # apply has no init to seed, and caching its truncated output
            # would poison the exact buckets' starts
            fingerprint = self.cache.fingerprint(A_dense, b_flat, key)
            init = self.cache.get(fingerprint)
            if init is not None and solver == "pallas_cg":
                init = None     # pallas_cg always starts from zero
            obs_events.emit("cache_hit" if init is not None
                            else "cache_miss", {"solver": solver, "d": d})
        return _PendingRequest(uid=next(self._uid), key=key, A=A_dense,
                               b=b_flat, unravel=unravel, future=Future(),
                               fingerprint=fingerprint, init=init,
                               finish=None, admit_t=admit_t)

    def submit(self, A, b, *, symmetric: Optional[bool] = None,
               positive_definite: bool = False, spec=None, solve=_UNSET,
               tol=_UNSET, maxiter=_UNSET, ridge=_UNSET, precond=_UNSET,
               warm_start: bool = True) -> Future:
        """Enqueue one linear solve ``A x = b``; returns a ``Future``.

        ``A`` is a ``(d, d)`` array or tensor (symmetry auto-detected when
        not declared), an instance-shaped ``LinearOperator`` (flags read
        off it), or a matvec callable; ``b`` any pytree raveling to
        ``d ≤ 512``.  Bad routing raises here, never at dispatch.  The
        future resolves to a ``ServiceResult`` at the flush that dispatches
        this request's bucket.
        """
        return self._enqueue(self._build_request(
            A, b, symmetric, positive_definite, spec, solve, tol, maxiter,
            ridge, precond, warm_start))

    def submit_hypergrad(self, optimality_fun, x_star, theta, cotangent, *,
                         spec=None, solve=_UNSET, tol=_UNSET, maxiter=_UNSET,
                         ridge=_UNSET, precond=_UNSET, backward=_UNSET,
                         backward_iters=_UNSET,
                         warm_start: bool = True) -> Future:
        """Enqueue one implicit hypergradient: resolves to ``vᵀ ∂x*(θ)``.

        Batches the linear-solve step of ``root_vjp`` — ``Aᵀ u = v`` with
        ``A = -∂₁F(x*, θ)`` — into the service's buckets; the per-request
        θ-VJP ``θ̄ = Bᵀ u`` runs when the bucket completes.  ``theta`` is a
        tuple of θ arguments (a single value is accepted); ``x_star``,
        ``theta`` and ``cotangent`` are tensors (numpy leaves are moved to
        the service's device).  ``ServiceResult.x`` is ``root_vjp``'s
        return value.

        ``backward`` selects an approximate cotangent treatment
        (``"one_step"`` / ``"neumann_k"`` / ``"jacobian_free"``,
        ``backward_iters`` the Neumann depth), resolved like the routing
        (service default "exact" < ``spec`` < keyword).  Approximate
        requests land in their own bucket arm, never read or fill the
        warm-start cache, and their ``ServiceResult.info`` carries the
        ``hypergrad_error_estimate`` relative residual.
        """
        if optimality_fun is None:
            if spec is None or spec.is_routing_only:
                raise ValueError("submit_hypergrad needs an optimality "
                                 "mapping: pass optimality_fun= or a spec "
                                 "carrying one")
            optimality_fun = spec.residual_fun
        if not isinstance(theta, tuple):
            theta = (theta,)
        r = self._routing(spec, solve, tol, maxiter, ridge, precond)
        bw = spec.backward if spec is not None else "exact"
        bwk = spec.backward_iters if spec is not None else 8
        if backward is not _UNSET:
            bw = backward
        if backward_iters is not _UNSET:
            bwk = backward_iters
        ls.check_backward(bw, bwk)
        if bw != "exact" and r["precond"] == "block_jacobi":
            raise ValueError(
                "precond='block_jacobi' inverts the full flat block — that "
                "would make the 'approximate' backward an exact solve; use "
                "precond=None or 'jacobi' with approximate backward modes")
        # one_step / jacobian_free take no depth: their key arm is 0
        bwk = int(bwk) if bw == "neumann_k" else 0
        x_star = canonical(self._on_device(x_star))
        theta = tuple(self._on_device(t) for t in theta)
        solver = r["solve"]
        certified = solver != "auto" and ls.solver_is_symmetric(solver)
        A = ops.JacobianOperator(
            lambda x: optimality_fun(x, *theta), x_star, negate=True,
            symmetric=True if certified else None)
        # the bucketed system is Aᵀ u = v (a symmetric-certified A is its
        # own transpose); the θ-VJP below finishes the hypergradient
        AT = A if certified else A.T

        def finish(u_tree):
            _, vjp_theta = torch.func.vjp(
                lambda *targs: canonical(optimality_fun(x_star, *targs)),
                *theta)
            return vjp_theta(self._on_device(u_tree))

        pending = self._build_request(
            AT, cotangent, A.symmetric, False, spec, solve, tol, maxiter,
            ridge, precond, warm_start, backward=bw, backward_iters=bwk)
        pending.finish = finish
        return self._enqueue(pending)

    # -- dispatch ------------------------------------------------------------

    def _dispatch_fn(self, key: BucketKey, cap: int) -> Callable:
        """The batched dispatch for ``(key, cap)``, built once.

        Builds the stacked ``DenseOperator`` (structure flags from the
        bucket key) and routes ONE batched masked solve through
        ``route_solve`` with ``return_info=True``.  ``pallas_cg`` buckets
        never carry warm starts.  An approximate bucket applies its fixed
        polynomial (``approx_inverse_apply``) with the error estimate
        always on: it is the approximate modes' honesty contract, at one
        extra matvec.
        """
        with self._lock:
            fn = self._compiled.get((key, cap))
        if fn is not None:
            return fn
        takes_init = key.solver != "pallas_cg"

        def dispatch(A_stack, b_stack, init_stack):
            op = ops.DenseOperator(A_stack, symmetric=key.symmetric,
                                   positive_definite=key.positive_definite)
            if key.backward != "exact":
                return ls.approx_inverse_apply(
                    op, b_stack, backward=key.backward,
                    backward_iters=max(key.backward_iters, 1),
                    ridge=key.ridge, precond=key.precond, batch_ndim=1,
                    tol=key.tol, error_estimate=True, return_info=True)
            return ls.route_solve(
                key.solver, op, b_stack, tol=key.tol, maxiter=key.maxiter,
                ridge=key.ridge, precond=key.precond,
                init=init_stack if takes_init else None, return_info=True)

        with self._lock:
            # concurrent flushers may race to build the same function; keep
            # the first so the count of dispatch functions stays stable
            fn = self._compiled.setdefault((key, cap), dispatch)
            self._m_compiled.set(len(self._compiled))
        return fn

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _dispatch_bucket(self, key: BucketKey, reqs) -> None:
        """Pad one bucket to capacity and run its single batched solve."""
        n = len(reqs)
        cap = bucket_capacity(n, self.max_batch)
        d = key.d
        dtype = np.dtype(key.dtype)
        label = _bucket_label(key)
        obs_events.emit("dispatch", {"bucket": label, "solver": key.solver},
                        n=n, capacity=cap)
        stage_t = time.perf_counter()
        # host-side staging: padded slots get identity systems with zero
        # rhs/init (they converge at loop entry); each stacked buffer moves
        # to the device once per dispatch
        A_stack = np.empty((cap, d, d), dtype)
        b_stack = np.zeros((cap, d), dtype)
        init_stack = np.zeros((cap, d), dtype)
        A_stack[n:] = np.eye(d, dtype=dtype)
        for i, r in enumerate(reqs):
            A_stack[i] = r.A
            b_stack[i] = r.b
            if r.init is not None:
                init_stack[i] = r.init

        fn = self._dispatch_fn(key, cap)
        t0 = time.perf_counter()
        x, info = fn(self._to_device(A_stack), self._to_device(b_stack),
                     self._to_device(init_stack))
        x_host = _host(x)                   # waits for the device
        t1 = time.perf_counter()
        solve_t = t1 - t0

        with self._lock:
            self._m_dispatches.inc()
            self._m_instances.inc(n)
            self._m_padded.inc(cap - n)
            self._m_occupancy_sum.inc(n / cap)
            self._m_solve_time.observe(solve_t)

        it = _host(info.iterations).tolist()
        rn = _host(info.residual).tolist()
        cv = _host(info.converged).tolist()
        est = info.hypergrad_error_estimate
        est = [None] * cap if est is None else _host(est).tolist()
        tracer = obs_spans.current_tracer()
        for i, req in enumerate(reqs):
            xi = x_host[i]
            if req.fingerprint is not None and self.cache is not None:
                self.cache.put(req.fingerprint, xi, key=req.key)
            queue_t = max(t0 - req.enqueue_t, 0.0)
            deliver_t = time.perf_counter()
            try:
                payload = xi if req.unravel is None \
                    else req.unravel(torch.as_tensor(xi, device=self.device))
                if req.finish is not None:
                    payload = req.finish(payload)
                req.future.set_result(ServiceResult(
                    uid=req.uid, x=payload,
                    info=SolveInfo(iterations=it[i], residual=rn[i],
                                   converged=cv[i],
                                   hypergrad_error_estimate=est[i]),
                    queue_time=queue_t, solve_time=solve_t,
                    bucket_size=n, bucket_capacity=cap,
                    warm_start=req.init is not None))
            except Exception as exc:
                req.future.set_exception(exc)
            if tracer is not None:
                # the request lifecycle crosses threads, so its segments are
                # recorded from measured timestamps under an explicit parent
                end = time.perf_counter()
                root = tracer.record_span(
                    "request", req.admit_t, end, uid=req.uid, bucket=label,
                    warm_start=req.init is not None, iterations=it[i])
                tracer.record_span("admission", req.admit_t, req.enqueue_t,
                                   parent=root)
                tracer.record_span("queue", req.enqueue_t, t0, parent=root)
                tracer.record_span("solve", t0, t1, parent=root,
                                   bucket=label)
                tracer.record_span("delivery", deliver_t, end, parent=root)
        if tracer is not None:
            tracer.record_span("dispatch", stage_t, time.perf_counter(),
                               bucket=label, n=n, capacity=cap)
        with self._lock:
            self._m_queue_wait.observe_many(
                max(t0 - req.enqueue_t, 0.0) for req in reqs)
            if self.cache is not None:
                self._m_cache_hits.set(self.cache.hits)
                self._m_cache_misses.set(self.cache.misses)
                self._m_cache_evictions.set(self.cache.evictions)

    def flush(self) -> int:
        """Drain the queue: dispatch every bucket once; returns #requests.

        Buckets larger than ``max_batch`` split into successive chunks.  A
        failure inside one dispatch is delivered to that chunk's futures
        and every other bucket still dispatches.
        """
        with self._lock:
            pending = list(self._queue)
            self._queue.clear()
            if not pending:
                return 0
            self._inflight += len(pending)
        try:
            buckets: "collections.OrderedDict[BucketKey, list]" = \
                collections.OrderedDict()
            for req in pending:
                buckets.setdefault(req.key, []).append(req)
            for key, reqs in buckets.items():
                for lo in range(0, len(reqs), self.max_batch):
                    chunk = reqs[lo:lo + self.max_batch]
                    try:
                        self._dispatch_bucket(key, chunk)
                    except Exception as exc:
                        for req in chunk:
                            if not req.future.done():
                                req.future.set_exception(exc)
        finally:
            with self._lock:
                self._inflight -= len(pending)
        return len(pending)

    def drain(self, timeout: float = 30.0) -> None:
        """Block until every admitted request has been *resolved*."""
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            with self._lock:
                if not self._queue and self._inflight == 0:
                    return
            time.sleep(0.001)
        raise TimeoutError("solve service did not drain in time")

    # -- background scheduler ------------------------------------------------

    def start(self, interval: float = 0.001) -> None:
        """Start a scheduler thread flushing every ``interval`` seconds."""
        if self._thread is not None:
            raise RuntimeError("service already started")
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                self.flush()
                time.sleep(interval)
            self.flush()                    # final drain

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the scheduler thread (flushes once more on the way out)."""
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=10.0)
        self._thread = None

    # -- metrics -------------------------------------------------------------

    @property
    def metrics(self) -> dict:
        """Frozen scheduler-counter snapshot (flat dict), taken atomically."""
        with self._lock:
            return {
                "requests": int(self._m_requests.value),
                "dispatches": int(self._m_dispatches.value),
                "instances": int(self._m_instances.value),
                "padded": int(self._m_padded.value),
                "occupancy_sum": self._m_occupancy_sum.value,
                "queue_wait_sum": self._m_queue_wait.sum,
                "solve_time_sum": self._m_solve_time.sum,
                "compiled": int(self._m_compiled.value),
                "cache_hits": int(self._m_cache_hits.value),
                "cache_misses": int(self._m_cache_misses.value),
                "cache_evictions": int(self._m_cache_evictions.value),
            }

    @property
    def occupancy(self) -> float:
        """Mean bucket occupancy (real requests / padded capacity)."""
        with self._lock:
            n = self._m_dispatches.value
            return self._m_occupancy_sum.value / n if n else 0.0

    @property
    def hit_rate(self) -> float:
        """Warm-start cache hit rate (0.0 with the cache disabled)."""
        return self.cache.hit_rate if self.cache is not None else 0.0

    @property
    def throughput(self) -> float:
        """Requests served per second of batched solve time."""
        with self._lock:
            t = self._m_solve_time.sum
            return self._m_instances.value / t if t > 0 else 0.0

    def metrics_summary(self) -> dict:
        """One flat dict of scheduler metrics, atomic under the lock."""
        with self._lock:
            return dict(self.metrics, occupancy=self.occupancy,
                        hit_rate=self.hit_rate, throughput=self.throughput,
                        cache_size=len(self.cache) if self.cache else 0)

    def metrics_snapshot(self) -> dict:
        """Full structured registry snapshot (names/labels/histograms)."""
        return self.registry.snapshot()
