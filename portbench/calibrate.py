"""Readings of the comparison that decides ``correct``, for setting its
limits: the program's timed step and the control, each against the plain
reference, at the cell's own size, on many seeds in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 \\
        [--control-seeds 1 2 3] [--fault-seeds 1] [--out FILE]

For each seed: the cell's weights and its first batch of prompts are drawn
as a run draws them; the program's prefill step (the window's entry, the
window's whole batch) gives logits, and the traffic's ``checked`` requests
of it, picked as a run picks them (``cellrun.Sampler``), are read by
``compare.readings`` against the plain reference's float32 logits.  For each control seed
the reference with float8 matrix products (``compare.fp8_mm``) stands in
the program's place, and for each fault seed each fault of
``harness/faults.py`` planted under the program's step (a stale step
runs two batches).  One JSON line a seed; the benchmark's own runs
never run this.  It sets the card's limits, so it runs on the card only.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings_for(cell, seed: int, device, control: bool,
                 faults: bool = False) -> dict:
    import torch
    from portbench.harness import cellrun, compare, faults as fault_mod
    cfg, params, pool = cellrun.draw_inputs(cell, seed, device)
    out = {"seed": seed}

    def kept(step):
        """(the checked rows of ``step``'s answer to batch 0, their
        indices), picked as a run with this seed picks them."""
        sampler = cellrun.Sampler(seed, pool.shape[1],
                                  int(cell.traffic["checked"]))
        with torch.no_grad():
            logits = step(params, pool[0])
            slots = logits.new_empty((len(sampler.kept),)
                                     + tuple(logits.shape[1:]))
            sampler.offer(0, logits, slots)
        return slots, [r for _, r in sampler.kept]

    step = cellrun.program_step(cfg)
    with torch.no_grad():
        step(params, pool[0])                 # warm-up
    program, rows = kept(step)
    tokens = pool[0, rows]
    t = time.perf_counter()
    ref = cellrun.reference_logits(cell, params, tokens)
    out["reference_s"] = time.perf_counter() - t
    out["rows"] = rows
    out["program"] = compare.readings(program, ref)
    del program
    if faults:
        out["faults"] = {}
        for name in fault_mod.FAULTS:
            broken = fault_mod.plant(name, step, cfg.vocab_size)
            with torch.no_grad():
                broken(params, pool[1])
            out["faults"][name] = compare.readings(kept(broken)[0], ref)
            del broken
    del step
    if control:
        ctrl = cellrun.reference_logits(cell, params, tokens,
                                        mm=compare.fp8_mm)
        out["control"] = compare.readings(ctrl, ref)
        del ctrl
    out["limits"] = cell.limits
    out["program_passes"] = compare.verdict(out["program"], cell.limits)
    if control:
        out["control_passes"] = compare.verdict(out["control"], cell.limits)
    del ref, params, pool
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch
    from portbench.harness import spec
    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("no CUDA card: the limits are set on the card", file=sys.stderr)
        return 2
    lines = []
    for seed in dict.fromkeys(args.seeds + args.control_seeds
                              + args.fault_seeds):
        r = readings_for(cell, seed, "cuda",
                         control=seed in args.control_seeds,
                         faults=seed in args.fault_seeds)
        r["workload"] = args.workload
        lines.append(json.dumps(r))
        print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
