"""Solve telemetry: the ``SolveEvent`` stream (eager PyTorch).

Counterpart of ``repro.observability.events``.  The JAX package stages a
``jax.debug.callback`` from traced code so that an event fires at
execution time; eager PyTorch has no trace, so every event here is a plain
host call:

  * :func:`emit` — one event, delivered immediately;
  * :func:`emit_pair` — a ``*_start``/``*_done`` pair sharing one receipt
    time;
  * :func:`jit_event` / :func:`jit_event_pair` — the reference's names for
    events from traced code, bound to ``emit`` / ``emit_pair``: eager
    PyTorch has no traced program, so the event is emitted at the call.

Both are gated by the process-level :func:`observe` switch, and the gate
is one boolean check: with observability off (the default) callers test
:func:`observing` before computing anything they would report, so the
disabled path computes no diagnostics and copies nothing to the host.
When on, tensor values are copied to host numpy at emission, which
synchronizes with the device — that is the cost of enabled mode.

Event kinds (``tags`` are static strings/ints, ``values`` runtime arrays):

  ==================  =====================================================
  ``solve_start``     a registry solver begins (tags: solver, B, d, dtype)
  ``solve``           a registry solve finished (values: iterations,
                      residual, converged — per instance)
  ``iteration``       one solver-loop step (opt-in; deep debugging)
  ``backward_start``  an implicit-diff backward/tangent solve begins
  ``backward_done``   ... and finished
  ``dispatch``        a routing decision resolved
  ``cache_hit`` / ``cache_miss``  warm-start cache lookups
  ==================  =====================================================

Events fan out to: the in-memory recorder (``record=True``), registered
subscribers, the global tracer's JSONL stream (when configured), and a
metrics bridge that folds per-solve iteration counts into the global
``MetricsRegistry`` histograms.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch._C import _functorch

from repro_torch.observability import metrics as _metrics
from repro_torch.observability import spans as _spans

__all__ = [
    "SolveEvent", "EVENT_KINDS", "observe", "observing",
    "observing_iterations", "emit", "emit_pair", "jit_event",
    "jit_event_pair", "subscribe", "recorded", "clear_recorded",
]

EVENT_KINDS = (
    "solve_start", "solve", "iteration", "backward_start", "backward_done",
    "dispatch", "cache_hit", "cache_miss",
)


@dataclasses.dataclass(frozen=True)
class SolveEvent:
    """One telemetry event: a kind, static tags, and runtime values.

    ``t`` is ``time.perf_counter()`` at emission; ``values`` are host
    copies of runtime tensors (iterations, residuals, convergence flags).
    """
    kind: str
    t: float
    tags: Dict[str, Any]
    values: Dict[str, Any]


_lock = threading.Lock()
_enabled = False
_iteration_events = False
_recording = False
_records: list = []
_subscribers: list = []


def observing() -> bool:
    """True when the process-level observability switch is on."""
    return _enabled


def observing_iterations() -> bool:
    """True when per-iteration events are enabled (opt-in; expensive)."""
    return _enabled and _iteration_events


class _ObserveHandle:
    """Context manager restoring the prior observability configuration."""

    def __init__(self, prev_state, owns_tracer: bool):
        self._prev = prev_state
        self._owns_tracer = owns_tracer

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        global _enabled, _iteration_events, _recording
        _enabled, _iteration_events, _recording = self._prev
        if self._owns_tracer:
            _spans.remove_tracer()
        return False


def observe(enabled: bool = True, *, iteration_events: bool = False,
            record: bool = False, trace_path=None) -> _ObserveHandle:
    """Flip the process-level observability switch.

    Applies immediately; the return value doubles as a context manager
    that restores the previous configuration (and removes a tracer this
    call installed) on exit.  ``iteration_events`` opts into per-loop-step
    events; ``record=True`` accumulates events for :func:`recorded`;
    ``trace_path`` installs a global JSONL tracer at that path.
    """
    global _enabled, _iteration_events, _recording
    prev = (_enabled, _iteration_events, _recording)
    _enabled = bool(enabled)
    _iteration_events = bool(iteration_events)
    _recording = bool(record)
    owns_tracer = trace_path is not None
    if owns_tracer:
        _spans.configure_tracer(trace_path)
    return _ObserveHandle(prev, owns_tracer)


def recorded() -> tuple:
    """Events captured so far under ``observe(record=True)``."""
    with _lock:
        return tuple(_records)


def clear_recorded() -> None:
    """Drop the in-process event recording buffer."""
    with _lock:
        _records.clear()


def subscribe(fn: Callable[[SolveEvent], None]) -> Callable[[], None]:
    """Register an event subscriber; returns an unsubscribe callable."""
    with _lock:
        _subscribers.append(fn)

    def unsubscribe():
        with _lock:
            if fn in _subscribers:
                _subscribers.remove(fn)

    return unsubscribe


# -- dispatch ----------------------------------------------------------------

def _host(v):
    """Copy a runtime value to host numpy (labels/strings pass through).

    A tensor inside a ``torch.func`` transform is first unwrapped: under
    ``vmap`` the copy is the physical tensor, with the batch axis."""
    if isinstance(v, (str, bytes, bool, int, float, type(None))):
        return v
    if isinstance(v, torch.Tensor):
        if not _functorch.is_functorch_wrapped_tensor(v):
            return v.detach().cpu().numpy()
        from torch._functorch.pyfunctorch import \
            temporarily_clear_interpreter_stack
        while _functorch.is_functorch_wrapped_tensor(v):
            v = _functorch.get_unwrapped(v)
        with temporarily_clear_interpreter_stack():
            return v.detach().cpu().numpy()
    return np.asarray(v)


def _jsonable(v):
    """JSON-safe rendering of an event value."""
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    return v


def _bridge_metrics(ev: SolveEvent) -> None:
    """Fold an event into the global registry (counters + histograms)."""
    reg = _metrics.global_registry()
    solver = str(ev.tags.get("solver", ""))
    reg.counter("repro_events_total",
                help="telemetry events by kind and solver",
                kind=ev.kind, solver=solver).inc()
    its = ev.values.get("iterations")
    if its is not None and ev.kind == "solve":
        arr = np.asarray(its, dtype=np.float64).ravel()
        arr = arr[arr >= 0]          # -1 marks untracked (pallas_cg)
        if arr.size:
            reg.histogram("repro_solve_iterations",
                          help="per-instance solver iteration counts",
                          buckets=_metrics.ITERATION_BUCKETS,
                          solver=solver).observe_many(arr.tolist())
    est = ev.values.get("hypergrad_error_estimate")
    if est is not None and ev.kind == "backward_done":
        arr = np.asarray(est, dtype=np.float64).ravel()
        arr = arr[np.isfinite(arr)]
        if arr.size:
            reg.histogram("repro_hypergrad_error_estimate",
                          help="relative residual of the implicit "
                               "backward system",
                          buckets=_metrics.DEFAULT_BUCKETS,
                          backward=str(ev.tags.get("backward", "")),
                          ).observe_many(arr.tolist())


def _dispatch(kind: str, tags: Dict[str, Any], values: Dict[str, Any],
              t: float) -> None:
    """Deliver one event to every sink (recorder/metrics/tracer/subs)."""
    ev = SolveEvent(kind=kind, t=t, tags=dict(tags), values=values)
    with _lock:
        if _recording:
            _records.append(ev)
        subs = list(_subscribers)
    _bridge_metrics(ev)
    tr = _spans.current_tracer()
    if tr is not None:
        tr.add_event(ev.kind, ev.t, tags=ev.tags,
                     values={k: _jsonable(v) for k, v in values.items()})
    for fn in subs:
        fn(ev)


def emit(kind: str, tags: Optional[Dict[str, Any]] = None,
         **values) -> None:
    """Emit one event; a no-op while observability is off."""
    if not _enabled:
        return
    _dispatch(kind, tags or {}, {k: _host(v) for k, v in values.items()},
              time.perf_counter())


def emit_pair(start_kind: str, end_kind: str,
              tags: Optional[Dict[str, Any]] = None, **values) -> None:
    """Emit a start/end event pair sharing one receipt time.

    The start event carries tags only; stream ordering is preserved
    (spans, not events, measure time).
    """
    if not _enabled:
        return
    t = time.perf_counter()
    _dispatch(start_kind, tags or {}, {}, t)
    _dispatch(end_kind, tags or {}, {k: _host(v) for k, v in values.items()},
              t)


# The reference stages these inside traced programs; eager PyTorch has no
# traced program, so the event is emitted at the call.
jit_event = emit
jit_event_pair = emit_pair
