"""Spans and counters: one range API for the host tracer and
``torch.profiler``, behind one gate.

Host-only port of ``repro.observability.spans`` (same record schema), with
the port's own gate:

  * :func:`span` is **off** unless a ``torch.profiler`` is recording
    (``torch.autograd._profiler_enabled()``) or a tracer is installed.  Off, it costs one boolean
    check and returns a shared no-op context: no ``record_function``, no
    lock, no allocation of its own.
  * While a profiler records, a span opens a
    ``torch.profiler.record_function`` range of the same name, so it lands
    in the profiler's trace beside the device work, and every kernel
    launched inside it is tied to it by the launch's correlation id.
  * While a tracer is installed, the span is recorded to it (below).
  * :func:`count` adds to a counter of the process-global
    ``MetricsRegistry`` under the same gate (a count that lives on the
    device is computed and read to the host only then).

A :class:`Tracer` records **spans** (named intervals with parent ids, so
nested work reconstructs as a tree) and **events** (instants forwarded
from the solve event stream).  Records are kept in memory and — when a
path is configured — appended to a JSONL trace file, one JSON object per
line:

    {"type": "clock", "perf_counter": 12.000, "epoch_ns": 1792...}
    {"type": "span",  "name": "dispatch", "id": 3, "parent": 1,
     "ts": 12.031, "dur": 0.0042, "tags": {...}}
    {"type": "event", "kind": "solve", "ts": 12.034, "span": 3,
     "tags": {...}, "values": {...}}

Timestamps are ``time.perf_counter()`` seconds: monotonic within the
process, which is what latency analysis needs.  The file's first record,
``clock``, pairs a ``perf_counter`` reading with the Unix-epoch
nanoseconds read back to back with it (``Tracer.clock``).  The
profiler's events (``torch.profiler``'s kineto trace, device work
included) carry Unix-epoch nanoseconds, so :meth:`Tracer.epoch_ns` places
a span on the profiler's timeline.  ``records()`` holds spans and events
only.

Nesting is tracked with a :mod:`contextvars` variable, so ``with
span("dispatch"):`` blocks parent correctly per thread/task; lifecycles
that cross threads (the solve service's per-request spans) record their
segments explicitly via :meth:`Tracer.record_span` with measured start/end
times and an explicit parent id.

``repro_torch.observability.report`` loads and summarizes these files
(p50/p95/p99 latency per span name, iteration histograms, per-bucket
breakdowns).
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import threading
import time
from typing import Optional

from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

from repro_torch.observability import metrics as _metrics

__all__ = ["Span", "Tracer", "configure_tracer", "current_tracer", "span",
           "count"]

_CURRENT_SPAN: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_observability_span", default=None)

# "inherit the ambient span" marker for start_span's parent argument,
# distinct from an explicit parent=None (a root span)
_INHERIT = object()


class Span:
    """An open span handle returned by :meth:`Tracer.start_span`."""

    __slots__ = ("name", "span_id", "parent_id", "t_start", "tags", "_token")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 t_start: float, tags: dict):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.t_start = t_start
        self.tags = tags
        self._token = None


class Tracer:
    """Span/event recorder writing JSONL; thread-safe, append-only.

    ``path=None`` keeps records in memory only (``records()``); a path
    opens the file for writing at construction (truncating — one tracer
    is one trace) and appends each record as it completes.
    """

    def __init__(self, path=None):
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._records: list = []
        self.path = str(path) if path is not None else None
        self._file = open(self.path, "w") if self.path else None
        before = time.perf_counter()
        epoch_ns = time.time_ns()
        after = time.perf_counter()
        self.clock = {"type": "clock", "perf_counter": (before + after) / 2,
                      "epoch_ns": epoch_ns}
        if self._file is not None:
            self._file.write(json.dumps(self.clock) + "\n")

    def epoch_ns(self, ts: float) -> int:
        """Unix-epoch nanoseconds (the profiler's clock) of the
        ``perf_counter`` time ``ts``, through :attr:`clock`."""
        return self.clock["epoch_ns"] + round(
            (ts - self.clock["perf_counter"]) * 1e9)

    # -- low-level record sink ----------------------------------------------

    def _write(self, rec: dict) -> None:
        with self._lock:
            self._records.append(rec)
            if self._file is not None:
                self._file.write(json.dumps(rec) + "\n")

    def records(self) -> list:
        """Copy of every record written so far (spans and events)."""
        with self._lock:
            return list(self._records)

    def flush(self) -> None:
        """Flush the backing file (if any) to disk."""
        with self._lock:
            if self._file is not None:
                self._file.flush()

    def close(self) -> None:
        """Flush and close the backing file; the tracer stays readable."""
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    # -- spans ---------------------------------------------------------------

    def new_id(self) -> int:
        """A fresh span id (monotonic per tracer)."""
        return next(self._ids)

    def start_span(self, name: str, *, parent=_INHERIT, **tags) -> Span:
        """Open a span; parent defaults to the ambient span of this task.

        Pass ``parent=None`` to force a root span, or an explicit span id
        (int) / :class:`Span` for cross-thread lifecycles.  The ambient
        span is NOT redirected — use :meth:`span` for scoped nesting.
        """
        if parent is _INHERIT:
            amb = _CURRENT_SPAN.get()
            parent_id = amb.span_id if amb is not None else None
        elif isinstance(parent, Span):
            parent_id = parent.span_id
        else:
            parent_id = parent
        return Span(name, self.new_id(), parent_id, time.perf_counter(),
                    dict(tags))

    def end_span(self, sp: Span, **tags) -> None:
        """Close a span: records it with its measured duration."""
        t_end = time.perf_counter()
        if tags:
            sp.tags.update(tags)
        self._write({"type": "span", "name": sp.name, "id": sp.span_id,
                     "parent": sp.parent_id, "ts": sp.t_start,
                     "dur": t_end - sp.t_start, "tags": sp.tags})

    def record_span(self, name: str, t_start: float, t_end: float, *,
                    parent=None, **tags) -> int:
        """Record a completed span from measured timestamps.

        For lifecycles that cross threads (queue wait, batched dispatch
        segments): the caller supplies ``perf_counter`` start/end times
        and an explicit ``parent`` id.  Returns the new span's id.
        """
        parent_id = parent.span_id if isinstance(parent, Span) else parent
        sid = self.new_id()
        self._write({"type": "span", "name": name, "id": sid,
                     "parent": parent_id, "ts": float(t_start),
                     "dur": float(t_end) - float(t_start),
                     "tags": dict(tags)})
        return sid

    @contextlib.contextmanager
    def span(self, name: str, **tags):
        """Scoped span: opens, redirects the ambient span, closes on exit."""
        sp = self.start_span(name, **tags)
        token = _CURRENT_SPAN.set(sp)
        try:
            yield sp
        finally:
            _CURRENT_SPAN.reset(token)
            self.end_span(sp)

    # -- events --------------------------------------------------------------

    def add_event(self, kind: str, t: float, *, tags=None,
                  values=None) -> None:
        """Record an instant event, parented under the ambient span."""
        amb = _CURRENT_SPAN.get()
        self._write({"type": "event", "kind": kind, "ts": float(t),
                     "span": amb.span_id if amb is not None else None,
                     "tags": dict(tags or {}), "values": dict(values or {})})


_tracer: Optional[Tracer] = None


def configure_tracer(path=None) -> Tracer:
    """Install (and return) the process-global tracer.

    ``path=None`` gives an in-memory tracer; a string/path writes JSONL.
    An existing :class:`Tracer` instance is installed as-is.  The
    previous tracer (if any) is closed.
    """
    global _tracer
    if _tracer is not None:
        _tracer.close()
    _tracer = path if isinstance(path, Tracer) else Tracer(path)
    return _tracer


def remove_tracer() -> None:
    """Close and uninstall the process-global tracer (no-op when absent)."""
    global _tracer
    if _tracer is not None:
        _tracer.close()
        _tracer = None


def current_tracer() -> Optional[Tracer]:
    """The installed process-global tracer, or ``None``."""
    return _tracer


class _Off:
    """The shared no-op context of a span with tracing off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()


class _Range:
    """A span with tracing on: a ``record_function`` range while a profiler
    records, a tracer span while a tracer is installed."""

    __slots__ = ("name", "tags", "_range", "_scope")

    def __init__(self, name: str, tags: dict):
        self.name = name
        self.tags = tags

    def __enter__(self):
        self._range = None
        if _profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
        tr = _tracer
        self._scope = None if tr is None else tr.span(self.name, **self.tags)
        return None if self._scope is None else self._scope.__enter__()

    def __exit__(self, exc_type, exc, tb):
        if self._scope is not None:
            self._scope.__exit__(exc_type, exc, tb)
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        return None


def span(name: str, **tags):
    """Scoped span: a ``record_function`` range of ``name`` while a
    profiler records, a span of the global tracer (yielded) while one is
    installed, the shared no-op (yielding ``None``) otherwise."""
    if _tracer is None and not _profiler_enabled():
        return _OFF
    return _Range(name, tags)


def count(name: str, n: float = 1.0, **labels) -> None:
    """Add ``n`` to the global registry's counter ``name{labels}`` while a
    profiler records or a tracer is installed; nothing otherwise.  ``n``
    may be a one-element tensor on the device, or a function that returns
    one: it is called and read to the host only while the gate is open."""
    if _tracer is None and not _profiler_enabled():
        return
    if callable(n):
        n = n()
    _metrics.global_registry().counter(name, **labels).inc(float(n))
