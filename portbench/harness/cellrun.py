"""One run of one cell: set-up, the measured window, the comparison that
decides ``correct``, and (traced) the per-layer metrics.

The entry point the window drives is the port's
``repro_torch.runtime.train_loop.make_prefill_step(cfg, use_kernel=True)``
on the benchmark's bf16 weights: logits at every position of every prompt,
the work of a scoring job.  The traffic is a closed loop: one client
submits a batch of prompts, waits for the logits on the device and for the
first token of each prompt (the argmax of its last position) on the host,
then submits the next batch.  A request's time to first token runs from its
batch's submission to that token on the host.  The window opens after the
warm-up and closes at the end of the first step that ends ``seconds`` or
more after it opened, so every request of the window is complete.

The traffic's ``checked`` requests of the window keep their logits (one
from each of as many equal bands of the batch's rows, drawn from the seed);
once the window has closed and the memory peak has been read, the plain
reference recomputes those prompts and ``compare`` judges every position
of them.  Their copies are the harness's, not the program's: their bytes
are left out of the memory peak, and the trace leaves out the device
operations launched under ``trace.SAMPLE``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import sys
import time
from types import ModuleType
from typing import Callable, Optional

import torch

from portbench.harness import compare, spec, trace as trace_mod, traffic, \
    weights
from portbench.harness.peaks import peaks_of
from portbench.harness.seeds import host_rng

GIB = float(2 ** 30)


@dataclasses.dataclass
class RunView:
    """What a per-layer metric's ``read`` sees."""
    trace: trace_mod.TraceSummary
    config: dict
    traffic: dict
    peaks: Optional[dict]
    reference: ModuleType


def _no_range(name: str):
    return contextlib.nullcontext()


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def program_step(cfg) -> Callable:
    """The timed path: the port's prefill step with its kernels."""
    from repro_torch.runtime.train_loop import make_prefill_step
    return make_prefill_step(cfg, use_kernel=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Sampler:
    """Keeps ``k`` requests, one from each of ``k`` equal bands of the
    batch's rows.  Band j's kept request is drawn uniformly over the
    (batch, row) pairs of that band offered so far: batch i replaces it
    with probability band / ((i + 1) · band), by a row drawn in the band."""

    def __init__(self, seed: int, batch: int, k: int):
        if k < 1 or batch % k:
            raise ValueError(f"{k} checked requests do not split a batch "
                             f"of {batch} into equal bands")
        self.rng = host_rng(seed, "sample")
        self.band = batch // k
        self.kept = [None] * k           # (batch index, row)

    def offer(self, i: int, logits: torch.Tensor, slots: torch.Tensor):
        for j in range(len(self.kept)):
            if self.rng.randrange((i + 1) * self.band) < self.band:
                r = j * self.band + self.rng.randrange(self.band)
                slots[j].copy_(logits[r])
                self.kept[j] = (i, r)


def nearest_rank(values, q: float) -> float:
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def draw_inputs(cell: spec.Cell, seed: int, device):
    """(port config, weights, prompt pool) of ``cell`` from ``seed``."""
    from repro_torch.models.model import init_params_abstract
    cfg = spec.port_config(cell.config)
    params = weights.draw(init_params_abstract(cfg), cell.config["init"],
                          seed, device)
    pool = traffic.prompt_pool(cell.traffic, cfg.vocab_size, seed, device)
    return cfg, params, pool


def reference_logits(cell: spec.Cell, params, tokens, mm=None):
    """The plain reference's float32 logits of ``tokens``; ``mm`` replaces
    its matrix product (the control)."""
    kw = {} if mm is None else {"mm": mm}
    with torch.no_grad(), compare.full_float32():
        return cell.reference.forward(params, cell.config, tokens, **kw)


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, t_start: float, step: Optional[Callable] = None) -> dict:
    """One run of ``cell`` on ``device``; returns the result line's object.
    The caller has checked that the card is there.  ``step`` replaces the
    program's prefill step (the fault tests)."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    stages = [("start", time.perf_counter() - t_start)]
    import repro_torch.models.model  # noqa: F401
    import repro_torch.runtime.train_loop  # noqa: F401
    stages.append(("port import", time.perf_counter() - t_start))
    torch.zeros(1, device=dev)
    stages.append(("context", time.perf_counter() - t_start))
    cfg, params, pool = draw_inputs(cell, seed, dev)
    sync(dev)
    stages.append(("inputs", time.perf_counter() - t_start))
    if step is None:
        step = program_step(cfg)
    tr = cell.traffic
    B, P = int(tr["batch"]), int(tr["pool_batches"])
    sampler = Sampler(seed, B, int(tr["checked"]))
    slots, slot_bytes = None, 0
    with torch.no_grad():
        for i in range(int(tr["warmup_steps"])):
            logits = step(params, pool[i % P])
            logits[:, -1].argmax(-1).cpu()
            if slots is None:
                held = torch.cuda.memory_allocated(dev) if on_card else 0
                slots = logits.new_empty((len(sampler.kept),)
                                         + tuple(logits.shape[1:]))
                if on_card:
                    slot_bytes = torch.cuda.memory_allocated(dev) - held
            slots[0].copy_(logits[0])
            del logits
            stages.append((f"warm-up {i + 1}", time.perf_counter() - t_start))
    sync(dev)
    setup_s = time.perf_counter() - t_start
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    log(f"set-up {setup_s:.3f} s (" + ", ".join(
        f"{name} at {t:.3f}" for name, t in stages) + ")")

    prof = None
    record_function = _no_range
    ttft = []
    n = 0
    with contextlib.ExitStack() as stack:
        if traced:
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if on_card else [])
            prof = stack.enter_context(profile(activities=acts))
        stack.enter_context(torch.no_grad())
        stack.enter_context(record_function(trace_mod.WINDOW))
        t_open = time.perf_counter()
        while True:
            with record_function(trace_mod.STEP):
                t0 = time.perf_counter()
                logits = step(params, pool[n % P])
                logits[:, -1].argmax(-1).cpu()
                t1 = time.perf_counter()
            ttft.append(t1 - t0)
            with record_function(trace_mod.SAMPLE):
                sampler.offer(n, logits, slots)
            del logits
            n += 1
            if t1 - t_open >= seconds:
                break
        sync(dev)
        t_close = time.perf_counter()
    window_s = t_close - t_open
    # the program's peak: the kept copies are the harness's
    window_peak = (torch.cuda.max_memory_allocated(dev) - slot_bytes
                   if on_card else None)
    log(f"window {window_s:.3f} s, {n} steps; peak {window_peak} B without "
        f"the {slot_bytes} B of the kept requests")

    # the program's state goes before the reference runs; the weights and
    # prompts are the benchmark's inputs and stay
    del step
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    tokens = torch.stack([pool[b % P, r] for b, r in sampler.kept])
    t_ref = time.perf_counter()
    ref = reference_logits(cell, params, tokens)
    read = compare.readings(slots, ref)
    del ref
    log(f"reference {time.perf_counter() - t_ref:.3f} s")
    correct = compare.verdict(read, cell.limits)
    for k, v in read.items():
        if k not in cell.limits:
            log(f"reading {k} {v!r} (not compared)")

    requests = n * B
    e2e = {
        "prefill_tok_s": (requests * int(tr["prompt_len"]) / window_s,
                          "tokens/s"),
        "ttft_p95_ms": (1e3 * nearest_rank(
            [t for t in ttft for _ in range(B)], 0.95), "ms"),
        "peak_mem_gib": (None if window_peak is None
                         else window_peak / GIB, "GiB"),
        "setup_s": (setup_s, "s"),
    }
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    result = {
        "correct": bool(correct),
        "attempted": requests,
        "failed": 0,
        "metrics": {},
        "device": {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": 1,
                   "memory_peak_bytes": window_peak},
    }
    if traced:
        summary = trace_mod.reduce(prof, n, trace_mod.port_kernels())
        log(f"trace: {summary.sample_ops} device operations of the kept "
            f"copies left out ({summary.sample_s:.6f} s)")
        view = RunView(trace=summary, config=cell.config, traffic=tr,
                       peaks=peaks_of(kind), reference=cell.reference)
        units = {m["name"]: m["unit"] for m in cell.per_layer_spec}
        for name, reader in cell.per_layer.items():
            value = reader.read(view)
            if value is not None:
                result["metrics"][name] = {"value": value,
                                           "unit": units[name]}
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    else:
        for m in cell.end_to_end:
            if m["name"] not in e2e:
                raise spec.MissingPiece(f"end-to-end metric {m['name']!r}: "
                                        "the harness does not take it")
            value, unit = e2e[m["name"]]
            if unit != m["unit"]:
                raise ValueError(f"{m['name']}: the harness takes it in "
                                 f"{unit}, BENCHMARK.json says {m['unit']}")
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": unit}
    result["checks"] = {k: {"value": read.get(k), "limit": v}
                        for k, v in cell.limits.items()}
    return result
