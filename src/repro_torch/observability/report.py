"""Trace summarizer: load a JSONL trace and report latency/iteration stats.

Host-only port of ``repro.observability.report`` (same summary schema).

``load_trace(path)`` reads the spans and events a ``Tracer`` wrote (the
file's ``clock`` record, which anchors it to the profiler's timeline, is
left out);
``summarize(records)`` reduces them to:

  * per-span-name latency percentiles (count, p50/p95/p99, in ms);
  * event counts by kind;
  * an iterations-per-solve histogram (power-of-two buckets) folded from
    every ``solve``/``converged`` event's per-instance iteration counts;
  * per-bucket breakdowns: spans tagged with a ``bucket`` (the solve
    service's ``BucketKey`` label) grouped into count + p50 latency.

CLI::

    PYTHONPATH=src python -m repro_torch.observability.report trace.jsonl
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List

__all__ = ["load_trace", "summarize", "format_summary", "main"]


def load_trace(path) -> List[dict]:
    """Read a JSONL trace file into a list of its span and event records
    (the ``clock`` record is skipped)."""
    records = []
    with open(str(path)) as f:
        for line in f:
            line = line.strip()
            if line:
                rec = json.loads(line)
                if rec.get("type") != "clock":
                    records.append(rec)
    return records


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted list."""
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def _latency_stats(durs_s: List[float]) -> dict:
    vals = sorted(d * 1e3 for d in durs_s)
    return {"count": len(vals),
            "p50_ms": _percentile(vals, 50.0),
            "p95_ms": _percentile(vals, 95.0),
            "p99_ms": _percentile(vals, 99.0)}


def _iter_histogram(counts: List[float]) -> Dict[str, int]:
    """Power-of-two bucket histogram of iteration counts."""
    hist: Dict[str, int] = {}
    for c in counts:
        if c < 0:                    # -1 marks untracked (pallas_cg)
            continue
        lo = 1
        while lo * 2 <= max(c, 1):
            lo *= 2
        label = f"{lo}-{lo * 2 - 1}" if c >= 1 else "0"
        hist[label] = hist.get(label, 0) + 1
    return dict(sorted(hist.items(),
                       key=lambda kv: int(kv[0].split("-")[0])))


def summarize(records: List[dict]) -> dict:
    """Reduce trace records to the summary dict documented above."""
    span_durs: Dict[str, List[float]] = {}
    bucket_durs: Dict[str, List[float]] = {}
    event_counts: Dict[str, int] = {}
    iterations: List[float] = []
    for rec in records:
        if rec.get("type") == "span":
            span_durs.setdefault(rec["name"], []).append(float(rec["dur"]))
            bucket = rec.get("tags", {}).get("bucket")
            if bucket is not None:
                bucket_durs.setdefault(str(bucket), []).append(
                    float(rec["dur"]))
        elif rec.get("type") == "event":
            kind = rec.get("kind", "?")
            event_counts[kind] = event_counts.get(kind, 0) + 1
            if kind in ("solve", "converged"):
                its = rec.get("values", {}).get("iterations")
                if its is None:
                    continue
                if isinstance(its, (int, float)):
                    iterations.append(float(its))
                else:
                    flat = its
                    while flat and isinstance(flat[0], list):
                        flat = [x for sub in flat for x in sub]
                    iterations.extend(float(x) for x in flat)
    return {
        "spans": {name: _latency_stats(durs)
                  for name, durs in sorted(span_durs.items())},
        "events": dict(sorted(event_counts.items())),
        "iterations_histogram": _iter_histogram(iterations),
        "buckets": {label: {"count": len(durs),
                            "p50_ms": _percentile(
                                sorted(d * 1e3 for d in durs), 50.0)}
                    for label, durs in sorted(bucket_durs.items())},
    }


def format_summary(summary: dict) -> str:
    """Human-readable rendering of :func:`summarize`'s output."""
    lines = ["spans (count / p50 / p95 / p99 ms):"]
    for name, s in summary["spans"].items():
        lines.append(f"  {name:<12} {s['count']:>6}  {s['p50_ms']:8.3f}"
                     f"  {s['p95_ms']:8.3f}  {s['p99_ms']:8.3f}")
    lines.append("events:")
    for kind, n in summary["events"].items():
        lines.append(f"  {kind:<16} {n}")
    if summary["iterations_histogram"]:
        lines.append("iterations per solve:")
        for label, n in summary["iterations_histogram"].items():
            lines.append(f"  {label:<10} {n}")
    if summary["buckets"]:
        lines.append("per-bucket (count / p50 ms):")
        for label, s in summary["buckets"].items():
            lines.append(f"  {label:<40} {s['count']:>6}  "
                         f"{s['p50_ms']:8.3f}")
    return "\n".join(lines)


def main(argv=None) -> None:
    """CLI: summarize one or more JSONL trace files."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="+", help="JSONL trace files")
    ap.add_argument("--json", action="store_true",
                    help="print the raw summary dict as JSON")
    args = ap.parse_args(argv)
    records: List[dict] = []
    for path in args.paths:
        records.extend(load_trace(path))
    summary = summarize(records)
    if args.json:
        print(json.dumps(summary, indent=2))
    else:
        print(format_summary(summary))


if __name__ == "__main__":
    main()
