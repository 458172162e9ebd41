"""Serving launcher of the PyTorch port: LM decode or the implicit-diff
solve service.

LM decode (the prompt fed through ``decode_step`` a token at a time to
fill the cache, then greedy decode of the whole batch, as the JAX
launcher)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \\
        --smoke --batch 4 --prompt-len 16 --gen 16 [--device cpu]

Parameters and prompts are drawn from ``--seed`` on the device.  Every
decoder family is served: dense (and the ``vlm`` stub frontend), MoE with
GQA (``granite-moe-3b-a800m``) or MLA (``deepseek-v2-236b``) attention,
RWKV-6 and the Mamba-2 hybrid (``zamba2-7b``); encoder-only archs exit.

Solve service (two traffic waves — the second replays the first, so the
warm-start cache hit rate and the scheduler metrics are exercised end to
end)::

    PYTHONPATH=src python -m repro_torch.launch.serve --solve-service \\
        --requests 64 --dim 32 --max-batch 64 [--device cpu]

Same flags and defaults as ``python -m repro.launch.serve``, plus
``--device`` (default ``cuda``).

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


def serve_lm(args) -> dict:
    """Batched greedy decode of random prompts; prints and returns the
    timings and the tokens."""
    import torch

    from repro_torch import _device, configs
    from repro_torch.models import init_decode_state, init_params
    from repro_torch.runtime.train_loop import make_decode_step

    cfg = configs.get(args.arch, smoke=args.smoke)
    if not cfg.has_decoder:
        raise SystemExit(f"{cfg.name} is encoder-only; nothing to decode")
    dev = _device.resolve(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, device=dev)
    B, P, G = args.batch, args.prompt_len, args.gen

    stub = cfg.embedding_frontend == "stub_embeddings"
    if stub:      # embeddings in; every generated step feeds one fixed frame
        prompts = torch.randn(B, P, cfg.d_model, generator=gen, device=dev)
        frame = torch.randn(B, 1, cfg.d_model, generator=gen, device=dev)
    else:
        prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                                device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    state = init_decode_state(cfg, B, P + G, device=dev)
    step = make_decode_step(cfg)

    # prefill: feed the prompt through decode steps (cache-filling)
    sync()
    t0 = time.perf_counter()
    logits = None
    for i in range(P):
        logits, state = step(params, state, prompts[:, i:i + 1])
    sync()
    t_prefill = time.perf_counter() - t0

    generated = []
    t0 = time.perf_counter()
    tok = logits[:, -1].argmax(dim=-1)[:, None]
    for _ in range(G):
        logits, state = step(params, state, frame if stub else tok)
        tok = logits[:, -1].argmax(dim=-1)[:, None]
        generated.append(tok)
    sync()
    t_decode = time.perf_counter() - t0

    out = torch.cat(generated, dim=1).cpu()
    tok_s = B * G / max(t_decode, 1e-9)
    print(f"[serve] arch={cfg.name} batch={B} prompt={P} gen={G} on {dev}")
    print(f"[serve] prefill={t_prefill*1e3:.1f}ms "
          f"decode={t_decode*1e3:.1f}ms ({tok_s:.1f} tok/s)")
    print(f"[serve] sample tokens: {out[0, :8].tolist()}")
    return {"arch": cfg.name, "device": str(dev), "prefill_s": t_prefill,
            "decode_s": t_decode, "decode_tok_s": tok_s, "tokens": out,
            "logits": logits}


def main(argv=None):
    """Parse the command line and run the LM decode loop or the solve
    service; returns the LM path's summary (None for the service)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None,
                    help="LM decode mode: an arch name of "
                         "repro_torch.configs (required unless "
                         "--solve-service)")
    ap.add_argument("--smoke", action="store_true",
                    help="LM: the arch's small smoke config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--solve-service", action="store_true",
                    help="serve the implicit-diff solve service instead of "
                         "LM decode")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=64,
                    help="solve-service: concurrent requests per wave")
    ap.add_argument("--dim", type=int, default=32,
                    help="solve-service: instance dimension d")
    ap.add_argument("--max-batch", type=int, default=64,
                    help="solve-service: bucket capacity ceiling")
    ap.add_argument("--cache-capacity", type=int, default=256,
                    help="solve-service: warm-start cache capacity")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="solve-service: write a JSONL span/event trace")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.solve_service:
        serve_solves(args)
        return None
    if args.arch is None:
        ap.error("--arch is required unless --solve-service is given")
    from repro_torch import configs
    if args.arch not in configs.names():
        ap.error(f"unknown --arch {args.arch!r}; have {configs.names()}")
    return serve_lm(args)


if __name__ == "__main__":
    main()
