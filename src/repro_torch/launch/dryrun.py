"""Multi-pod dry run of the PyTorch port: one step of every (arch × shape)
on the production mesh, on fake ranks, and its roofline terms.

Counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell for XLA's 256 (512) host devices and reads the
compiled HLO.  The port runs one step of the cell on **fake ranks**:
``torch.distributed``'s fake backend (``FakeStore``, backend ``"fake"``)
at world size 256 (512), this process being rank 0, its collectives
returning at once, and every tensor on the ``meta`` device (shapes and
types, no storage; DTensor's shards of ``meta`` tensors), so nothing is
allocated on a device and the state of a 405 B model costs nothing.  The step is the port's own, on DTensors placed by
the reference's rules (``_rules``, ``_attn_tp``, ``_train_state_specs``):

  * train: ``make_train_step`` with the reference's ``TrainStepConfig``
    (microbatches, remat and its policy, the four shardings, bf16 AdamW
    state);
  * prefill: ``make_prefill_step(act_sharding=...)``, the last position's
    logits;
  * decode: ``make_decode_step`` on caches placed by
    ``decode_state_specs``, sequence-sharded at batch 1.

The run goes under ``analysis.op_census.Census``, which sees rank 0's
aten operations on its shards and the ``_c10d_functional`` collectives
DTensor issues: ``collective_bytes``, ``collective_ops`` and
``roofline.analyze`` (per-rank FLOPs and bytes, ``chips`` ranks,
``model_flops_train`` / ``_decode``) come from it.  The result keeps the
reference's keys and files (``results/dryrun/<arch>_<shape>_<mesh>.json``);
what has no counterpart says so:

  * ``lower_s`` is the seconds to place the state and inputs,
    ``compile_s`` the seconds of the step under the census;
  * ``memory``: ``argument_bytes`` and ``output_bytes`` are rank 0's
    bytes of the step's sharded arguments (state and inputs) and
    outputs; ``temp_bytes`` the peak of
    ``torch.distributed._tools.mem_tracker.MemTracker`` over the step
    less the arguments (None where the tracker fails, with the reason in
    ``memory["note"]``); ``generated_code_bytes`` is None (no compiled
    program);
  * ``xla_cost_analysis`` holds None (no XLA); the census's numbers are in
    ``roofline`` and ``census``.

Run it as its own process, as the reference's: ``main`` / ``lower_cell``
start the fake group (importing this module starts none), and a process
holds one group.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b \\
        --shape train_4k [--multi-pod] [--out results/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch.utils import _pytree as pytree

from repro_torch import configs
from repro_torch._dtensor import constrain, is_dtensor
from repro_torch.analysis import op_census
from repro_torch.analysis import roofline as rf
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.spec import NamedSharding, P
from repro_torch.launch import shapes as shp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as mdl
from repro_torch.optim import optimizer as opt
from repro_torch.runtime import train_loop as tl


def _rules(multi_pod: bool, layout: str = "2d") -> shd.ShardingRules:
    """``2d``: FSDP(data) × TP(model).  ``dp``: pure data parallelism over
    BOTH axes (the right layout for small-activation archs where TP only
    buys collective traffic)."""
    pod = "pod" if multi_pod else None
    if layout == "dp":
        return shd.ShardingRules(data=("data", "model"), model=None,
                                 pod=pod)
    return shd.ShardingRules(pod=pod)


def _attn_tp(cfg, mesh, rules):
    """TP on attention projections only when the heads divide the axis."""
    n_model = shd.mesh_axis_size(mesh, rules.model)
    if cfg.use_mla:
        return cfg.num_heads % n_model == 0
    return (cfg.num_heads % n_model == 0
            and cfg.num_kv_heads * cfg.resolved_head_dim % n_model == 0)


def _train_state_specs(abstract_state, rules, mesh, attn_tp=True):
    pspecs = shd.params_specs(abstract_state.params, rules, mesh,
                              attn_tp=attn_tp)
    mu = shd.params_specs(abstract_state.opt_state.mu, rules, mesh,
                          attn_tp=attn_tp)
    nu = (shd.params_specs(abstract_state.opt_state.nu, rules, mesh,
                           attn_tp=attn_tp)
          if abstract_state.opt_state.nu is not None else None)
    return tl.TrainState(
        params=pspecs,
        opt_state=opt.OptState(step=P(), mu=mu, nu=nu),
        err_state=None)


def _fake_group(chips: int) -> None:
    """Start the fake process group of ``chips`` ranks (this process rank
    0), or keep the one running at that size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == chips:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run runs in a process of its own: a "
                               f"{dist.get_backend()} group is running")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=chips)


def _local_bytes(tree) -> int:
    """Rank 0's bytes of the tensors of ``tree`` (a DTensor's shard)."""
    total = 0
    for t in pytree.tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if is_dtensor(t) else t
            total += t.numel() * t.element_size()
    return total


def _tracked(fn):
    """Run ``fn()`` under a census and ``MemTracker``: (costs, output,
    the tracker's peak bytes or None, a note).  The tracker is the inner
    mode: it sees the DTensor operations first, and the census then counts
    the rank's local operations below them."""
    with op_census.Census() as census:
        try:
            from torch.distributed._tools.mem_tracker import MemTracker
            tracker = MemTracker()
            with tracker:
                out = fn()
            snap = tracker.get_tracker_snapshot("peak")
            peak = max((v.get("Total", 0) for v in snap.values()),
                       default=0)
            return census.costs, out, int(peak), "MemTracker peak"
        except Exception as e:                   # noqa: BLE001
            note = f"MemTracker failed: {e!r}"
    with op_census.Census() as census:          # again, untracked
        out = fn()
    return census.costs, out, None, note


def _step_of_cell(cfg, cell, mesh, rules, microbatches, layout,
                  remat_policy, seq_parallel, grad_accum_bf16,
                  moe_dispatch):
    """(step function, its argument tuple) of one cell: the state and
    inputs as DTensors over ``meta`` shards."""
    specs = shp.input_specs(cfg, cell.name)
    batch = NamedSharding(mesh, shd.batch_spec(rules))
    place = constrain

    if cell.kind == "train":
        optimizer = opt.adamw(1e-4, state_dtype=torch.bfloat16)
        attn_tp = _attn_tp(cfg, mesh, rules)
        mb = microbatches if cell.global_batch % microbatches == 0 else 1
        abstract = tl.make_train_state_abstract(cfg, optimizer)
        state_specs = _train_state_specs(abstract, rules, mesh,
                                         attn_tp=attn_tp)
        grad_shard = pytree.tree_map(
            lambda s: NamedSharding(mesh, s), state_specs.params,
            is_leaf=lambda x: isinstance(x, P))
        sp_shard = None
        if seq_parallel and layout == "2d":
            sp_shard = NamedSharding(mesh, P(rules.batch_axes, "model",
                                             None))
        tcfg = tl.TrainStepConfig(
            microbatches=mb, remat=True, remat_policy=remat_policy,
            microbatch_sharding=NamedSharding(mesh, P(None,
                                                      rules.batch_axes)),
            act_sharding=NamedSharding(mesh, P(rules.batch_axes, None,
                                               None)),
            grad_sharding=grad_shard, sp_sharding=sp_shard,
            moe_dispatch=moe_dispatch,
            grad_accum_dtype=(torch.bfloat16 if grad_accum_bf16
                              else torch.float32))
        state = shd.distribute(abstract, mesh, state_specs)
        args = (state, place(specs["inputs"], batch),
                place(specs["labels"], batch))
        return tl.make_train_step(cfg, optimizer, tcfg), args
    attn_tp = _attn_tp(cfg, mesh, rules)
    abstract_params = mdl.init_params_abstract(cfg)
    params = shd.distribute(abstract_params, mesh, shd.params_specs(
        abstract_params, rules, mesh, attn_tp=attn_tp))
    if cell.kind == "prefill":
        step_fn = tl.make_prefill_step(cfg, act_sharding=NamedSharding(
            mesh, P(rules.batch_axes, None, None)))
        last = NamedSharding(mesh, P(rules.batch_axes))

        def prefill_last(params, inputs):
            # serving: the last position's logits, batch-sharded
            return constrain(step_fn(params, inputs)[:, -1], last)

        return prefill_last, (params, place(specs["inputs"], batch))
    seq_shard = cell.global_batch == 1
    state = mdl.init_decode_state(cfg, cell.global_batch, cell.seq_len,
                                  device="meta")
    caches = shd.distribute(state.caches, mesh, shd.decode_state_specs(
        state.caches, rules, cfg, mesh, seq_shard=seq_shard))
    # batch 1 (long_500k): tokens and logits replicate; the cache is
    # sequence-sharded instead
    tok = NamedSharding(mesh, P() if seq_shard else shd.batch_spec(rules))
    return tl.make_decode_step(cfg), (
        params, mdl.DecodeState(caches=caches, index=0),
        place(specs["tokens"], tok))


def model_flops(cfg, shape: str) -> float:
    """The cell's useful FLOPs: 6·N_active·tokens for a train step,
    2·N_active·tokens for prefill and decode (the reference's)."""
    n_active = cfg.active_param_count()
    toks = shp.tokens_per_step(cfg, shape)
    if shp.SHAPES[shape].kind == "train":
        return rf.model_flops_train(n_active, toks)
    return rf.model_flops_decode(n_active, toks)


def lower_cell(arch: str, shape: str, multi_pod: bool = False,
               microbatches: int = 16, fsdp: bool = True,
               donate: bool = True, extra_tag: str = "",
               layout: str = "2d", remat_policy: str = "nothing",
               seq_parallel: bool = False, grad_accum_bf16: bool = False,
               moe_dispatch: str = "dense"):
    """Run one (arch × shape × mesh) cell on fake ranks; return its result
    dict (see the module docstring).  ``fsdp`` and ``donate`` are taken
    for the reference's signature: its rules ignore ``fsdp`` too, and the
    port's step updates its state in place whatever ``donate`` says."""
    cfg = configs.get(arch)
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    reason = shp.skip_reason(cfg, shape)
    if reason:
        return {"arch": arch, "shape": shape, "mesh": mesh_tag,
                "status": "skipped", "reason": reason}

    chips = 512 if multi_pod else 256
    _fake_group(chips)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    rules = _rules(multi_pod, layout)
    cell = shp.SHAPES[shape]
    t0 = time.time()
    step_fn, args = _step_of_cell(
        cfg, cell, mesh, rules, microbatches, layout, remat_policy,
        seq_parallel, grad_accum_bf16, moe_dispatch)
    t_lower = time.time() - t0
    arg_bytes = _local_bytes(args)
    costs, out, peak, note = _tracked(lambda: step_fn(*args))
    t_compile = time.time() - t0 - t_lower

    coll = {k: int(v) for k, v in costs.per_collective.items()}
    coll["total"] = int(costs.collective_bytes)
    counts = dict(costs.collective_ops)
    terms = rf.analyze(costs.cost_dict(), costs.collective_bytes, chips,
                       model_flops(cfg, shape))
    return {
        "arch": arch, "shape": shape, "mesh": mesh_tag,
        "status": "ok",
        "tag": extra_tag,
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": _local_bytes(out),
            "temp_bytes": None if peak is None else max(peak - arg_bytes,
                                                        0),
            "generated_code_bytes": None,
            "note": note + "; no compiled program, so no generated code",
        },
        "collective_bytes": coll,
        "collective_ops": counts,
        "xla_cost_analysis": {
            "flops": None, "bytes_accessed": None,
            "note": "no XLA: the numbers are the op census's (roofline, "
                    "census)",
        },
        "census": {"flops_by_op": dict(costs.flops_by_op),
                   "custom_calls": dict(costs.custom_calls)},
        "roofline": terms.to_dict(),
    }


CELLS = [(a, s) for a in configs.names()
         for s in shp.SHAPES]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--microbatches", type=int, default=16)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--layout", default="2d", choices=["2d", "dp"])
    ap.add_argument("--remat-policy", default="nothing",
                    choices=["nothing", "dots", "dots_no_batch"])
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--grad-accum-bf16", action="store_true")
    ap.add_argument("--moe-dispatch", default="dense",
                    choices=["dense", "sparse"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    cells = CELLS if args.all else [(args.arch, args.shape)]
    failures = 0
    for arch, shape in cells:
        mesh_tag = "2x16x16" if args.multi_pod else "16x16"
        suffix = f"_{args.tag}" if args.tag else ""
        fname = os.path.join(
            args.out, f"{arch}_{shape}_{mesh_tag}{suffix}.json")
        if os.path.exists(fname):
            print(f"[skip-cached] {fname}")
            continue
        print(f"[dryrun] {arch} × {shape} × {mesh_tag} ...", flush=True)
        try:
            res = lower_cell(arch, shape, multi_pod=args.multi_pod,
                             microbatches=args.microbatches,
                             fsdp=not args.no_fsdp, extra_tag=args.tag,
                             layout=args.layout,
                             remat_policy=args.remat_policy,
                             seq_parallel=args.seq_parallel,
                             grad_accum_bf16=args.grad_accum_bf16,
                             moe_dispatch=args.moe_dispatch)
        except Exception as e:                   # noqa: BLE001
            failures += 1
            res = {"arch": arch, "shape": shape, "mesh": mesh_tag,
                   "status": "error", "error": repr(e),
                   "traceback": traceback.format_exc()}
        with open(fname, "w") as f:
            json.dump(res, f, indent=1)
        status = res["status"]
        extra = ""
        if status == "ok":
            r = res["roofline"]
            extra = (f" dom={r['dominant']} mfu={r['mfu']:.3f} "
                     f"compile={res['compile_s']}s")
        elif status == "error":
            extra = " " + res["error"][:120]
        print(f"  -> {status}{extra}", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
