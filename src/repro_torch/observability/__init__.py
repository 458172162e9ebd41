"""Observability for the PyTorch port: solve events, span tracing, metrics.

Counterpart of ``repro.observability``; imports nothing else of the
package:

  * **events** — the ``SolveEvent`` stream behind the process-level
    :func:`observe` switch (one boolean check when off); ``jit_event`` and
    ``jit_event_pair``, the reference's names for events from traced code,
    are ``emit`` and ``emit_pair`` here;
  * **spans** — the one range API (``span``: a ``torch.profiler`` range
    while a profiler records, a span of the host tracer writing JSONL
    while one is installed, one boolean check otherwise) and ``count``,
    counters of the global registry behind the same gate;
  * **metrics** — a ``MetricsRegistry`` of counters/gauges/histograms with
    a JSON snapshot and Prometheus text exposition;
  * **report** — loads JSONL traces and summarizes latency percentiles and
    iteration histograms (CLI:
    ``python -m repro_torch.observability.report trace.jsonl``).
"""
from repro_torch.observability.events import (EVENT_KINDS, SolveEvent,
                                              clear_recorded, emit,
                                              emit_pair, jit_event,
                                              jit_event_pair, observe,
                                              observing,
                                              observing_iterations, recorded,
                                              subscribe)
from repro_torch.observability.metrics import (DEFAULT_BUCKETS,
                                               ITERATION_BUCKETS,
                                               LATENCY_BUCKETS, Counter,
                                               Gauge, Histogram,
                                               MetricsRegistry,
                                               global_registry,
                                               reset_global_registry)
from repro_torch.observability.report import (format_summary, load_trace,
                                              summarize)
from repro_torch.observability.spans import (Span, Tracer, configure_tracer,
                                             count, current_tracer,
                                             remove_tracer, span)

__all__ = [
    "EVENT_KINDS", "SolveEvent", "observe", "observing",
    "observing_iterations", "emit", "emit_pair", "jit_event",
    "jit_event_pair", "subscribe", "recorded",
    "clear_recorded",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "global_registry",
    "reset_global_registry", "DEFAULT_BUCKETS", "ITERATION_BUCKETS",
    "LATENCY_BUCKETS",
    "Span", "Tracer", "configure_tracer", "current_tracer",
    "remove_tracer", "span", "count",
    "load_trace", "summarize", "format_summary",
]
