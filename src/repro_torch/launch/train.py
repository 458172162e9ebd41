"""Training launcher of the PyTorch port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \\
        --smoke --steps 20 --batch 8 --seq 64 [--device cpu] \\
        [--ckpt-dir DIR]

The reference's flags (``python -m repro.launch.train``) and the same run:
AdamW with a linear-warmup cosine schedule (10 warmup steps over
``--steps``, weight decay 0.01), remat on unless ``--smoke``, batches from
the deterministic ``SyntheticLMStream`` of ``--seed``, the straggler
monitor, and a SIGTERM handler that checkpoints and stops.  Rerunning with
the same ``--ckpt-dir`` resumes from its latest checkpoint exactly
(deterministic data stream).  ``--device`` (default ``cuda``) picks the
device; ``--mesh`` raises until training on a mesh (ROADMAP A.12c).

One difference from the reference's launcher: the last checkpoint is
saved at the step the run reached, and only when the loop has not just
saved it.  The reference saves it as step ``--steps`` whatever was
reached (after a preemption too, so a restart would skip the rest), and
fails when ``--steps`` is a multiple of ``--ckpt-every`` (the step's
directory exists already).
"""
from __future__ import annotations

import argparse
import time

import torch
from torch.utils import _pytree as pytree

from repro_torch import _device, configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.optim import adamw, schedules
from repro_torch.runtime import (PreemptionHandler, StragglerMonitor,
                                 TrainStepConfig, make_train_state,
                                 make_train_step, run_train_loop)


def main(argv=None) -> dict:
    """Parse the command line and train; returns the run's summary (arch,
    device, parameter count, first step, logged metrics)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=configs.names())
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", default=None,
                    help="DxM: raises until training on a mesh")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError("--mesh comes with training on a mesh "
                                  "(ROADMAP A.12c)")

    cfg = configs.get(args.arch, smoke=args.smoke)
    dev = _device.resolve(args.device)
    optimizer = adamw(schedules.linear_warmup_cosine(
        args.lr, warmup=10, total=args.steps), weight_decay=0.01)
    tcfg = TrainStepConfig(microbatches=args.microbatches,
                           remat=not args.smoke,
                           compress_grads=args.compress_grads)
    step_fn = make_train_step(cfg, optimizer, tcfg)
    state = make_train_state(
        cfg, optimizer, torch.Generator(device=dev).manual_seed(args.seed),
        compress=args.compress_grads, device=dev)

    n_params = sum(p.numel() for p in pytree.tree_leaves(state.params))
    print(f"[train] arch={cfg.name} params={n_params/1e6:.1f}M "
          f"steps={args.steps} on {dev}", flush=True)

    stream = SyntheticLMStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed))

    mgr = None
    start_step = 0
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        latest = mgr.latest_step()
        if latest is not None:
            state = mgr.restore(latest, state)
            start_step = latest
            print(f"[train] resumed from step {latest}", flush=True)

    def data_iter():
        step = start_step
        while True:
            yield step, stream.batch_at(step)
            step += 1

    handler = PreemptionHandler(install=True)
    monitor = StragglerMonitor()
    t0 = time.perf_counter()
    try:
        state, hist = run_train_loop(
            step_fn, state, data_iter(), num_steps=args.steps - start_step,
            checkpoint_manager=mgr, checkpoint_every=args.ckpt_every,
            monitor=monitor, preemption_flag=handler, log_every=10,
            start_step=start_step)
    finally:
        handler.restore()
    seconds = time.perf_counter() - t0
    for h in hist:
        print(f"[train] step={int(h['step'])} loss={h['loss']:.4f} "
              f"gnorm={h['grad_norm']:.3f}", flush=True)
    reached = int(state.opt_state.step)
    if mgr and mgr.latest_step() != reached:
        mgr.save(reached, state, blocking=True)
    print("[train] done", flush=True)
    return {"arch": cfg.name, "device": str(dev), "n_params": n_params,
            "start_step": start_step, "history": hist, "seconds": seconds,
            "step_s": monitor.medians().get(0)}


if __name__ == "__main__":
    main()
