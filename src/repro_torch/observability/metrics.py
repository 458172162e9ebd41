"""Metrics registry: counters, gauges and histograms with two export paths.

Host-only port of ``repro.observability.metrics`` (no change of behaviour).

One ``MetricsRegistry`` instance is a self-contained namespace of named,
labelled instruments.  Every layer of the stack reports through a registry
instead of a hand-rolled counter dict:

  * the solve service holds its own registry (sharing the service lock, so
    a scrape never observes torn counters mid-dispatch);
  * host-side control paths (autotune decisions, bilevel outer steps, the
    warm-start cache) report into the process-global registry returned by
    :func:`global_registry`;
  * the event stream (``repro_torch.observability.events``) bridges
    per-solve diagnostics into the global registry when observability is
    enabled.

Export paths: :meth:`MetricsRegistry.snapshot` returns one frozen plain
dict (JSON-ready), :meth:`MetricsRegistry.to_prometheus` renders the
standard Prometheus text exposition format — no client library required.

Instruments are cheap host-side objects (a float behind a lock); none of
this code ever runs on the device.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "global_registry", "reset_global_registry",
    "DEFAULT_BUCKETS", "ITERATION_BUCKETS", "LATENCY_BUCKETS",
]

# generic magnitude buckets (unitless values, occupancies, ratios)
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                   5.0, 10.0)
# iteration-count buckets: powers of two out to the default maxiter
ITERATION_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
                     512.0, 1024.0)
# wall-clock buckets in seconds (microseconds out to tens of seconds)
LATENCY_BUCKETS = (1e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5,
                   1.0, 5.0, 10.0)


def _label_key(labels: Dict[str, str]) -> str:
    """Render a label dict to its canonical (sorted) Prometheus form."""
    if not labels:
        return ""
    return ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))


class Counter:
    """A monotonically increasing value (``inc`` only)."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        """Add ``n`` (must be >= 0) to the counter."""
        if n < 0:
            raise ValueError(f"counters only go up; got inc({n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        """Current accumulated value."""
        with self._lock:
            return self._value


class Gauge:
    """A value that can go up and down (``set``/``inc``)."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0.0

    def set(self, v: float) -> None:
        """Set the gauge to ``v``."""
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        """Add ``n`` (may be negative) to the gauge."""
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        """Current value."""
        with self._lock:
            return self._value


class Histogram:
    """A cumulative-bucket histogram (Prometheus semantics).

    ``observe(v)`` increments every bucket whose upper bound ``le`` is
    >= v (cumulative counts), plus ``sum`` and ``count`` — exactly the
    ``_bucket``/``_sum``/``_count`` triplet the text exposition renders.
    """

    __slots__ = ("_lock", "buckets", "_counts", "_sum", "_count")

    def __init__(self, lock: threading.RLock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self._lock = lock
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts = [0] * len(self.buckets)
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        """Record one observation ``v``."""
        v = float(v)
        with self._lock:
            self._sum += v
            self._count += 1
            for i, le in enumerate(self.buckets):
                if v <= le:
                    self._counts[i] += 1

    def observe_many(self, vs) -> None:
        """Record every observation in an iterable of floats."""
        for v in vs:
            self.observe(v)

    @property
    def sum(self) -> float:
        """Sum of all observed values."""
        with self._lock:
            return self._sum

    @property
    def count(self) -> int:
        """Number of observations."""
        with self._lock:
            return self._count

    def state(self) -> dict:
        """Frozen copy: ``{"count", "sum", "buckets": {le: cum_count}}``."""
        with self._lock:
            return {"count": self._count, "sum": self._sum,
                    "buckets": dict(zip(self.buckets, self._counts))}


_KIND_NAMES = {Counter: "counter", Gauge: "gauge", Histogram: "histogram"}


class MetricsRegistry:
    """A namespace of named, labelled counters/gauges/histograms.

    ``counter(name, **labels)`` (and ``gauge``/``histogram``) get-or-create
    the instrument for that exact ``(name, labels)`` pair — repeated calls
    return the same object, so callers can either cache the handle or
    re-resolve it on every update.  One ``name`` is always one instrument
    kind; mixing kinds under a name raises.

    ``lock`` lets an owner share its own mutex with the registry (the
    solve service passes its service lock), making *every* instrument
    update and the :meth:`snapshot` atomic with respect to the owner's
    critical sections.  The default is a private ``RLock``.
    """

    def __init__(self, lock: Optional[threading.RLock] = None):
        self._lock = lock if lock is not None else threading.RLock()
        self._instruments: Dict[Tuple[str, str], object] = {}
        self._kinds: Dict[str, type] = {}
        self._help: Dict[str, str] = {}

    def _get(self, cls, name: str, labels: Dict[str, str], help: str,
             **extra):
        with self._lock:
            known = self._kinds.get(name)
            if known is not None and known is not cls:
                raise ValueError(
                    f"metric {name!r} is already registered as a "
                    f"{_KIND_NAMES[known]}; cannot re-register as a "
                    f"{_KIND_NAMES[cls]}")
            key = (name, _label_key({k: str(v) for k, v in labels.items()}))
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(self._lock, **extra)
                self._instruments[key] = inst
                self._kinds[name] = cls
                if help:
                    self._help[name] = help
            return inst

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        """Get-or-create the :class:`Counter` for ``(name, labels)``."""
        return self._get(Counter, name, labels, help)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        """Get-or-create the :class:`Gauge` for ``(name, labels)``."""
        return self._get(Gauge, name, labels, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        """Get-or-create the :class:`Histogram` for ``(name, labels)``."""
        return self._get(Histogram, name, labels, help, buckets=buckets)

    def snapshot(self) -> dict:
        """One frozen, JSON-ready copy of every instrument.

        Shape: ``{name: {"type": kind, "help": str, "values":
        {label_key: value}}}`` where a histogram's value is its
        ``state()`` dict.  Taken atomically under the registry lock — a
        scrape never observes a torn multi-counter update from an owner
        that shares the lock.
        """
        with self._lock:
            out: dict = {}
            for (name, lk), inst in self._instruments.items():
                entry = out.setdefault(
                    name, {"type": _KIND_NAMES[type(inst)],
                           "help": self._help.get(name, ""), "values": {}})
                if isinstance(inst, Histogram):
                    entry["values"][lk] = inst.state()
                else:
                    entry["values"][lk] = inst.value
            return out

    def to_prometheus(self) -> str:
        """Render the standard Prometheus text exposition format.

        ``# HELP`` / ``# TYPE`` headers per metric name, one sample line
        per label set; histograms expand to the ``_bucket`` (cumulative,
        with the ``+Inf`` terminal), ``_sum`` and ``_count`` series.
        """
        snap = self.snapshot()
        lines = []
        for name in sorted(snap):
            entry = snap[name]
            if entry["help"]:
                lines.append(f"# HELP {name} {entry['help']}")
            lines.append(f"# TYPE {name} {entry['type']}")
            for lk in sorted(entry["values"]):
                val = entry["values"][lk]
                if entry["type"] == "histogram":
                    for le, c in val["buckets"].items():
                        sep = "," if lk else ""
                        lines.append(
                            f'{name}_bucket{{{lk}{sep}le="{le:g}"}} {c}')
                    sep = "," if lk else ""
                    lines.append(
                        f'{name}_bucket{{{lk}{sep}le="+Inf"}} '
                        f'{val["count"]}')
                    suffix = f"{{{lk}}}" if lk else ""
                    lines.append(f'{name}_sum{suffix} {val["sum"]:g}')
                    lines.append(f'{name}_count{suffix} {val["count"]}')
                else:
                    suffix = f"{{{lk}}}" if lk else ""
                    lines.append(f"{name}{suffix} {val:g}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        """Drop every instrument (tests; a fresh registry is cheaper)."""
        with self._lock:
            self._instruments.clear()
            self._kinds.clear()
            self._help.clear()


_GLOBAL = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    """The process-global registry host-side control paths report into."""
    return _GLOBAL


def reset_global_registry() -> MetricsRegistry:
    """Clear the process-global registry (test isolation); returns it."""
    _GLOBAL.reset()
    return _GLOBAL
