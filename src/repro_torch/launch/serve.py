"""Serving launcher of the PyTorch port: the implicit-diff solve service.

Drives the solve service with two traffic waves — the second replays the
first, so the warm-start cache hit rate and the scheduler metrics are
exercised end to end::

    PYTHONPATH=src python -m repro_torch.launch.serve --solve-service \\
        --requests 64 --dim 32 --max-batch 64 [--device cpu]

Same flags and defaults as ``python -m repro.launch.serve
--solve-service``, plus ``--device`` (default ``cuda``).  The LM decode
path of the JAX launcher comes with the LM stack.

The service always has a warm-start cache here, so its ``"auto"`` route
resolves the SPD traffic to ``dense_gmres`` (a warm start may arrive) and
never to the batched-CG kernel; ``chip_smoke.py`` drives the kernel arm
with a service built with ``cache=None``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def serve_solves(args) -> None:
    """Drive the solve service with synthetic SPD traffic; print metrics.

    Observability is on for the whole run (``--trace PATH`` also writes a
    JSONL span/event trace for ``python -m
    repro_torch.observability.report``); the Prometheus exposition of the
    service's registry is printed once at exit.
    """
    from repro_torch import observability as obs
    from repro_torch.runtime.solve_service import SolveService, WarmStartCache

    rng = np.random.default_rng(args.seed)
    n, d = args.requests, args.dim
    problems = []
    for _ in range(n):
        M = rng.standard_normal((d, d))
        problems.append((M @ M.T + d * np.eye(d), rng.standard_normal(d)))

    with obs.observe(enabled=True, trace_path=args.trace):
        svc = SolveService(max_batch=args.max_batch,
                           cache=WarmStartCache(
                               capacity=args.cache_capacity),
                           device=args.device)
        svc.start()                   # background scheduler thread
        try:
            for wave in ("cold", "warm"):   # wave 2 replays wave 1: hits
                t0 = time.perf_counter()
                futs = [svc.submit(A, b, positive_definite=True)
                        for A, b in problems]
                results = [f.result(timeout=60.0) for f in futs]
                dt = time.perf_counter() - t0
                iters = [int(r.info.iterations) for r in results]
                print(f"[serve] {wave}: {n} requests d={d} on {svc.device} "
                      f"in {dt*1e3:.1f}ms ({n / dt:.0f} req/s) "
                      f"iters(median)={int(np.median(iters))} "
                      f"warm_started={sum(r.warm_start for r in results)}")
        finally:
            svc.stop()
        summary = svc.metrics_summary()
        print(f"[serve] dispatches={summary['dispatches']} "
              f"compiled={summary['compiled']} "
              f"occupancy={summary['occupancy']:.2f} "
              f"hit_rate={summary['hit_rate']:.2f} "
              f"cache_size={summary['cache_size']}")
        print("[serve] prometheus exposition:")
        print(svc.registry.to_prometheus(), end="")
        tracer = obs.current_tracer()
        if tracer is not None:
            tracer.flush()
            n_spans = sum(1 for r in tracer.records()
                          if r.get("type") == "span")
            print(f"[serve] trace: {tracer.path} ({n_spans} spans)")


def main(argv=None):
    """Parse the command line and run the solve service."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--solve-service", action="store_true",
                    help="serve the implicit-diff solve service (the only "
                         "path of this launcher so far)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=64,
                    help="concurrent requests per wave")
    ap.add_argument("--dim", type=int, default=32,
                    help="instance dimension d")
    ap.add_argument("--max-batch", type=int, default=64,
                    help="bucket capacity ceiling")
    ap.add_argument("--cache-capacity", type=int, default=256,
                    help="warm-start cache capacity")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a JSONL span/event trace")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the service (default: cuda)")
    args = ap.parse_args(argv)
    if not args.solve_service:
        ap.error("only --solve-service is ported; the LM decode path comes "
                 "with the LM stack")
    serve_solves(args)


if __name__ == "__main__":
    main()
