"""Roofline model of one NVIDIA H100 SXM5 (PyTorch port).

Counterpart of ``repro.analysis.roofline``, formula for formula, with the
card's constants in place of the reference's TPU ones.  Three terms per
(arch × shape × mesh), all in seconds:

    compute    = FLOPs       / (chips × PEAK_FLOPS)
    memory     = bytes       / (chips × HBM_BW)
    collective = coll_bytes  / (chips × ICI_BW)

plus MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) and the
useful-compute ratio MODEL_FLOPS / FLOPs.

The constants are the values of NVIDIA's H100 SXM5 data sheet (dense
rates, no sparsity, at the full 700 W power limit): 989 TFLOP/s of bf16
on the tensor cores (the peak ``mfu`` divides by), 3.35 TB/s of HBM3, and
for ``ICI_BW`` one direction of NVLink 4 (450 GB/s), which no solve of
the port uses until the distributed slice (ROADMAP A.11).
``analyze_solve`` divides its compute term by the peak of the solve's own
type on the CUDA cores (67 TFLOP/s float32, 34 TFLOP/s float64; the
reference divides every solve by its bf16 peak); a CG iteration at
d ≤ 512 is bound by bytes either way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

PEAK_FLOPS = 989e12          # bf16 tensor cores, dense
HBM_BW = 3.35e12             # bytes/s of HBM3
ICI_BW = 450e9               # bytes/s, NVLink 4, one direction

# CUDA-core peaks by element size, for the solve model's compute term
SOLVE_PEAK_FLOPS = {4: 67e12, 8: 34e12}

# A psum over instance-sharding axes is latency-bound at solver scales
# (two scalar reductions per CG iteration), so it is modeled as a fixed
# per-iteration latency rather than link bytes.  The reference's model
# constant; not measured on this card (the sharded solvers come with
# ROADMAP A.11).  Pure *batch* sharding has no cross-device communication
# at all; its real-world overhead is host-side dispatch, which the
# roofline deliberately omits — measured cache entries capture it.
PSUM_LATENCY_S = 1e-6


@dataclasses.dataclass
class RooflineTerms:
    """The three roofline terms of one program and what they rest on."""
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    model_flops: float
    useful_ratio: float
    chips: int
    # per-iteration time of an iterative solve (0.0 for the step-level
    # ``analyze`` path; set by ``analyze_solve``)
    solve_iteration_s: float = 0.0

    @property
    def dominant(self) -> str:
        """The term that bounds the step: compute, memory or collective."""
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Optimistic overlap model: max of the three engines."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline-predicted step time."""
        t = self.step_time_s
        if t == 0:
            return 0.0
        return self.model_flops / (t * self.chips * PEAK_FLOPS)

    def to_dict(self) -> Dict:
        """The fields plus ``dominant``, ``step_time_s`` and ``mfu``."""
        return {**dataclasses.asdict(self),
                "dominant": self.dominant,
                "step_time_s": self.step_time_s,
                "mfu": self.mfu}


def analyze(cost: Dict, coll_bytes: float, chips: int,
            model_flops: float) -> RooflineTerms:
    """``cost``: ``{"flops", "bytes accessed"}`` of one device's program
    (``op_census.Costs.as_cost_dict()``, or any such count)."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    return RooflineTerms(
        compute_s=flops / PEAK_FLOPS,
        memory_s=byts / HBM_BW,
        collective_s=coll_bytes / ICI_BW,
        hlo_flops=flops,
        hlo_bytes=byts,
        collective_bytes=coll_bytes,
        model_flops=model_flops,
        useful_ratio=(model_flops / (flops * chips)) if flops else 0.0,
        chips=chips)


def expected_solve_iters(d: int) -> int:
    """Expected Krylov iteration count for a d-dim system.

    CG terminates in at most ``d`` exact-arithmetic steps; at the
    moderate conditioning the dispatch regimes care about, convergence to
    typical tolerances takes O(sqrt(kappa)) iterations, which we proxy as
    ``2·sqrt(d)`` with a floor of 8 (setup iterations dominate tiny
    systems).
    """
    return int(min(d, max(8, round(2.0 * math.sqrt(d)))))


def analyze_solve(B: int, d: int, *, dtype_bytes: int = 4,
                  iters: int = None, mesh_size: int = 1,
                  instance_sharded: bool = False) -> RooflineTerms:
    """Roofline estimate for one batched iterative solve (B systems, dim d).

    Per iteration, each instance performs one dense-equivalent matvec
    (2·d² FLOPs, d²·dtype_bytes operator bytes) plus O(d) vector updates;
    a mesh of ``mesh_size`` devices divides the batch work evenly.
    Sharded *instance* dims add one latency-bound ``psum`` per iteration
    (``PSUM_LATENCY_S``); pure batch sharding communicates nothing.  The
    returned terms describe the WHOLE solve (``iters`` iterations,
    defaulting to ``expected_solve_iters(d)``), with the per-iteration
    time in ``solve_iteration_s``.  The compute term divides by the
    CUDA-core peak of ``dtype_bytes`` (``SOLVE_PEAK_FLOPS``).  This is the
    autotune layer's cold-cache fallback: it re-reads the operator every
    iteration, so it is relative, not a kernel's bound — a kernel that
    holds A on chip reads it once.
    """
    if iters is None:
        iters = expected_solve_iters(d)
    iters = max(int(iters), 1)
    chips = max(int(mesh_size), 1)
    flops_iter = B * (2.0 * d * d + 6.0 * d)
    bytes_iter = B * (d * d + 6.0 * d) * float(dtype_bytes)
    # per-device program cost, mirroring ``analyze``'s convention
    per_chip_flops = iters * flops_iter / chips
    per_chip_bytes = iters * bytes_iter / chips
    peak = SOLVE_PEAK_FLOPS.get(int(dtype_bytes), PEAK_FLOPS)
    compute_s = per_chip_flops / peak
    memory_s = per_chip_bytes / HBM_BW
    collective_s = (iters * PSUM_LATENCY_S
                    if (instance_sharded and chips > 1) else 0.0)
    model_flops = iters * 2.0 * B * d * d
    return RooflineTerms(
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        hlo_flops=per_chip_flops,
        hlo_bytes=per_chip_bytes,
        collective_bytes=0.0,
        model_flops=model_flops,
        useful_ratio=model_flops / (per_chip_flops * chips),
        chips=chips,
        solve_iteration_s=max(compute_s, memory_s, collective_s) / iters)


def model_flops_train(n_active_params: float, tokens: float) -> float:
    """6·N·D: forward and backward of a dense step."""
    return 6.0 * n_active_params * tokens


def model_flops_decode(n_active_params: float, tokens: float) -> float:
    """2·N·D: a forward (prefill or decode) step."""
    return 2.0 * n_active_params * tokens
