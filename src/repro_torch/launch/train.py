"""Training launcher of the PyTorch port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \\
        --smoke --steps 20 --batch 8 --seq 64 [--device cpu] \\
        [--mesh DxM] [--ckpt-dir DIR]

    # on a mesh of N = D·M ranks (gloo on the CPU, NCCL on cards)
    PYTHONPATH=src torchrun --standalone --nproc-per-node N \\
        -m repro_torch.launch.train --arch qwen1.5-4b --smoke \\
        --device cpu --mesh DxM

The reference's flags (``python -m repro.launch.train``) and the same run:
AdamW with a linear-warmup cosine schedule (10 warmup steps over
``--steps``, weight decay 0.01), remat on unless ``--smoke``, batches from
the deterministic ``SyntheticLMStream`` of ``--seed``, the straggler
monitor, and a SIGTERM handler that checkpoints and stops.  Rerunning with
the same ``--ckpt-dir`` resumes from its latest checkpoint exactly
(deterministic data stream).  ``--device`` (default ``cuda``) picks the
device.

``--mesh DxM`` trains on a (data, model) ``DeviceMesh`` of D·M ranks
(``launch.mesh.make_host_mesh`` over the running group: ``torchrun``'s
``env://`` group, or a single-rank group it starts), as the reference's
launcher does: every rank draws the state from ``--seed``, which is then
placed by ``params_specs`` (the moments and the error feedback by the
parameters' specs, the step replicated) and each batch over ``data``.
Checkpoints are the reference's files, written by rank 0
(``CheckpointManager``), and resume on any mesh.  Only rank 0 prints.

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
import torch.distributed
from torch.utils import _pytree as pytree

from repro_torch import _device, configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import _release_own_group as release_own_group
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import adamw, schedules
from repro_torch.optim.optimizer import OptState
from repro_torch.runtime import (PreemptionHandler, StragglerMonitor,
                                 TrainState, TrainStepConfig,
                                 make_train_state, make_train_step,
                                 run_train_loop)


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
                    help="DxM, e.g. 4x2: a (data, model) mesh of D·M ranks")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch, smoke=args.smoke)
    dev = _device.resolve(args.device)
    mesh = None
    if args.mesh:      # first: under torchrun this picks the rank's card
        d, m = (int(v) for v in args.mesh.lower().split("x"))
        mesh = make_host_mesh(d, m, device=dev)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
    lead = mesh is None or torch.distributed.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    optimizer = adamw(schedules.linear_warmup_cosine(
        args.lr, warmup=10, total=args.steps), weight_decay=0.01)
    tcfg = TrainStepConfig(microbatches=args.microbatches,
                           remat=not args.smoke,
                           compress_grads=args.compress_grads)
    step_fn = make_train_step(cfg, optimizer, tcfg)
    state = make_train_state(
        cfg, optimizer, torch.Generator(device=dev).manual_seed(args.seed),
        compress=args.compress_grads, device=dev)
    if mesh is not None:
        pspecs = shd.params_specs(state.params, shd.ShardingRules(), mesh)
        state = shd.distribute(state, mesh, TrainState(
            params=pspecs, opt_state=OptState(step=None, mu=pspecs,
                                              nu=pspecs),
            err_state=pspecs if args.compress_grads else None))

    n_params = sum(p.numel() for p in pytree.tree_leaves(state.params))
    where = str(dev)
    if mesh is not None:
        where += f", mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
    say(f"[train] arch={cfg.name} params={n_params/1e6:.1f}M "
        f"steps={args.steps} on {where}", flush=True)

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
            say(f"[train] resumed from step {latest}", flush=True)

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
        say(f"[train] step={int(h['step'])} loss={h['loss']:.4f} "
            f"gnorm={h['grad_norm']:.3f}", flush=True)
    reached = int(state.opt_state.step)
    if mgr:
        mgr.wait()
        # rank 0 writes, so its directory decides (the save is collective)
        missing = [mgr.latest_step() != reached]
        if mesh is not None:
            torch.distributed.broadcast_object_list(missing, src=0)
        if missing[0]:
            mgr.save(reached, state, blocking=True)
    say("[train] done", flush=True)
    if mesh is not None:
        release_own_group()
    return {"arch": cfg.name, "device": str(dev), "n_params": n_params,
            "mesh": None if mesh is None else tuple(mesh.shape),
            "start_step": start_step, "history": hist, "seconds": seconds,
            "step_s": monitor.medians().get(0)}


if __name__ == "__main__":
    main()
