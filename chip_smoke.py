#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N] [--previous DIR]

Drives the port's main paths on the GPU and stops at the first failure
with a non-zero exit: the solve service answering dense solves and
implicit hypergradients, and ``custom_root`` implicit differentiation,
through the hand-written batched-CG kernels (phases 3-8, and 17 and 19:
batches of hypergradients under ``torch.func.vmap``, the service's
approximate arm; phases 18 and 20 run the DEQ layer and the other solvers
and operators, which launch no kernel; phase 21 the stochastic inner
solvers at data scale; phase 22 tunes the kernel's layout through the
autotune cache, phase 23 takes the operation census of a prefill step); the paper's §4.1
multiclass-SVM hyper-parameter optimisation — ``solve_bilevel`` over a
``ProjectedGradient`` inner solver — through the hand-written
simplex-projection kernel (phases 9-11); and LM serving of ``qwen1.5-4b``
and ``rwkv6-3b`` at full width and depth — the prefill step through the
hand-written flash-attention and WKV kernels, the decode loop, the
launcher and the continuous-batching engine (phases 12-16).  Each phase
prints one line:

  1. card: name, device count, ``nvidia-smi`` name and power limit;
  2. build: the four kernel libraries are compiled from the repo's sources
     (one ``nvcc`` each, started together; ``-Xptxas -v``: registers,
     shared memory, spills);
  3. kernel against plain: forward and backward (∂A, ∂b of Σx²) of the
     batched-CG op against the plain PyTorch version on the same CUDA
     tensors, at (B, d) ∈ {(3, 7), (5, 130), (64, 96), (64, 512), (16, 300),
     (8, 400)}, float32 and float64; ‖Δ‖/‖ref‖ ≤ 1e-4 (float32) and 1e-10
     (float64); each (B, d, dtype) printed with the layout it launched
     (read from ``ops.LAUNCHES_BY_LAYOUT``: the cluster route with C = 1,
     2, 4 or 8 CTAs an instance, or the stream route), the run failing
     unless it is the rule's (``kernel.layout``) and all five are taken;
  4. service, kernel arm: ``SolveService(cache=None)`` with 256 ridge
     systems Aᵢ = XᵢᵀXᵢ/m + θᵢI at d = 512 (Xᵢ (1024, 512) standard normal,
     θᵢ log-uniform in [1e-2, 1], float32) — 4 buckets of 64, 4 kernel
     launches, all on the cluster route's C8 layout, every request
     converged with ‖Aᵢxᵢ − bᵢ‖/‖bᵢ‖ ≤ tol;
  5. service, hypergradient arm: 64 ``submit_hypergrad`` requests on
     F(x, θ) = Xᵀ(Xx − y)/m + θx with ``solve="pallas_cg"``, each within
     1e-3 of the port's direct ``root_vjp`` with ``solve="lu"``, relative
     to the largest hypergradient of the batch; every launch C8;
  6. implicit diff: ``torch.autograd.grad`` through a ``custom_root``-wrapped
     ridge solver with ``solve="pallas_cg"`` at d = 512 against the closed
     form (relative error ≤ 1e-3), the forward and the backward (the
     solve on Aᵀ, the transposed load) launching the kernel, all C8;
  7. service, cache arm: a default service (warm-start cache on, so
     ``dense_gmres``), a cold wave and a replayed warm wave of 64 requests;
  8. times, with the card's name and power limit, at (64, 512) float32 and
     tol 1e-3 and 1e-6: the cluster route by device time (launches
     replayed from a CUDA graph between CUDA events), twice, in turns with
     the stream route (and with ``--previous`` the earlier checkout's
     ``batched_cg.cu``) — stream, cluster, cluster, stream; a call through
     ``kernel.launch`` by CUDA events; its bound and share; the most
     clusters resident at once; ``torch.linalg.solve_ex`` by device time
     (its kernels under ``torch.profiler``) and ``torch.linalg.solve`` by
     CUDA events (yardsticks only — the port never calls them); the plain
     version by CUDA events (its loop reads the card every iteration); and
     the service's requests/s and p50/p99 latency of phase 4;
  9. simplex kernel against plain: ``projection_simplex_batched`` (the
     kernel) against the plain PyTorch bisection on the same CUDA tensors
     at (R, d) ∈ {(4, 5), (16, 33), (64, 1000), (3, 4097), (50000, 100),
     (6, 1), (40, 20), (40, 101), (500, 200), (300, 300), (300, 700)} —
     every register layout of ``kernel.layout`` (8, 16 and 32 lanes a row
     at 16 values a lane, 32 lanes at 32) and the
     shared-memory path, each shape printed with its layout and the run
     failing unless all are taken — and at (64, 100) and (8, 2000) rows
     whose threshold equals d - 1 of their values (the kernel's early end
     cannot trigger), float32 and float64 input: max |Δ| ≤
     1e-5·max(1, max|y|) and row sums within 1e-4 of the scale; the op's
     backward, ``torch.func.jvp`` and ``torch.func.vmap`` on CUDA tensors
     against the closed form and the plain version on the CPU;
 10. SVM slice at CIFAR-100's shape (m = 50,000 training rows, p = 3,072
     features, k = 100 classes, 10,000 validation rows; synthetic data
     from ``--seed`` with ``benchmarks/svm_hyperopt.py``'s recipe, float32,
     TF32 off): ``solve_bilevel`` takes 3 outer steps on λ = log θ, the
     inner ``ProjectedGradient`` projecting with the kernel op and the
     backward solve on ``normal_cg``.  Hard checks: the last inner solve
     converged; in every step the kernel launched at least once per inner
     iteration in the forward and at least once in the backward; the
     signed first-step hypergradient (λ₀ − λ₁)/lr of a one-step
     ``solve_bilevel`` with the kernel in float32 within 1e-2 relative of
     the same step in float64 with the sort-based ``projection_simplex``.
     Reported, not gated: the
     mirror-descent fixed point's hypergradient at the same x* (Fig. 4c);
 11. times, with the card's name and power limit: the simplex kernel at
     (50000, 100) float32 (twice, device time: launches replayed from a
     CUDA graph between CUDA events; and a call through the wrapper by
     CUDA events), on rows with ties at the threshold (the bisection's
     50 steps, no early end), its bound (the bytes, or
     the TPU kernel's 50 bisection steps, whichever is larger), with
     ``--previous`` the earlier design's kernel in turns with it, the
     plain version, the
     sort-based projection (information only: ``library_ms`` is null, no
     single PyTorch call projects onto the simplex), and the SVM phase's
     seconds per inner iteration, per backward solve and per outer step;
 12. flash-attention kernels against plain: the op on CUDA tensors against
     ``attention_ref`` (top-left causal) at (B, Sq, Sk, H, Hkv, D) ∈
     {(2, 128, 128, 4, 4, 64) causal and not, (2, 200, 200, 8, 2, 128) GQA
     with a ragged tile, (4, 2048, 2048, 20, 20, 128) the prefill shape},
     float32 and bfloat16, and in bfloat16 (1, 77, 77, 4, 1, 80) MQA with a
     padded head, (1, 64, 130, 2, 2, 256), (3, 33, 17, 6, 3, 64) and
     (2, 100, 100, 4, 2, 32): max |Δ| ≤ 1e-4·max|ref| in float32 (sums in
     another order), |Δ| ≤ 2⁻⁷|ref| + 1e-4·max|ref| in bfloat16 (one
     rounding of the output, one bf16 unit at most); every bfloat16 call
     with D ≥ 64 on the tensor-core route ("tc", ``flash_attention_tc.cu``),
     and the D = 32 call and every float32 call on the CUDA-core route
     ("simt", ``flash_attention.cu``), read from the op's per-route launch
     counts; the bfloat16 calls of the first four shapes also on the
     CUDA-core kernel (``route_name="simt"``), against the same limit;
 13. WKV kernel against plain: the op against ``wkv_scan_ref`` at (B, T, H)
     ∈ {(1, 1, 1), (2, 100, 3), (4, 2048, 40), (1, 37, 1), (3, 130, 7)},
     head size 64, float32 and bfloat16 r/k/v with float32 w, with and
     without ``state0``, with the same limits, each shape printed with how
     the kernel stages its T (chunks of 16 and a short one; the run fails
     unless one short chunk alone, whole chunks alone and both are taken),
     and a state carried across a split of T equal bit for bit to one run;
 14. ``qwen1.5-4b`` at its full published config (40 layers, d 2560,
     vocab 151,936), parameters drawn on the card from ``--seed``, tokens
     (B, S) = (4, 2048).  In float32 (the algorithm at full size):
     ``make_prefill_step(use_kernel=True)`` with exactly 40 flash-attention
     launches, all on the simt route, its logits against
     ``use_kernel=False`` within ‖Δ‖/‖ref‖ ≤ 1e-3; token-by-token
     ``decode_step`` over (2, 64) against the prefill logits within a
     limit set per model from its readings (1e-5 here, 5e-3 for
     ``rwkv6-3b``), and the same at full width and 1 and 4 layers within
     1e-5 for both (a fault of the carried state shows at any depth;
     rounding grows with it; see PERF.md).  In bfloat16, the served type
     and the main path: exactly 40 launches, all on the tc route, the
     logits against ``use_kernel=False`` within a fixed limit per model
     (5e-2 here, 8e-2 for ``rwkv6-3b``, set between the floor — the same
     prefill with the op's plain version in the kernel's place — and the
     controls; see PERF.md); in both types a prefill with a zeroed attention
     output and one with its S and H axes swapped must land above that
     limit; decode against prefill reported; the LM launcher's ``main`` at
     batch 4, prompt 16, gen 16; ``ContinuousBatchingEngine(num_slots=8)``
     serving 16 requests (prompts of 8-32 tokens, 16 new tokens each), all
     complete, and a request served alone equal token for token to the same
     request admitted with 7 others;
 15. ``rwkv6-3b`` at its full config (32 layers, d 2560, 40 heads of 64):
     the same as 14 with the WKV kernel, exactly 32 launches per prefill
     step, the controls a zeroed WKV output and one with T and H swapped;
 16. times, with the card's name and power limit: at the prefill shape
     (bfloat16, causal), by CUDA events in one call and in turns (tc,
     simt, SDPA, tc), the tensor-core flash-attention kernel, the
     CUDA-core kernel's bf16 instantiation and
     ``F.scaled_dot_product_attention`` on the same tensors (yardstick
     only — the port never calls it), each with its TFLOP/s; its bound and
     the plain version; the WKV kernel at (4, 2048, 40, 64) bfloat16
     r/k/v (twice, device time as in 11; with ``--previous`` the earlier
     design's kernel in turns with it), its bound, the plain scan and
     ``wkv_chunked`` (no single
     PyTorch call computes it); the prefill step's ms and tokens/s with
     and without the kernels, one kernel prefill step under
     ``torch.profiler`` (device time of the port's kernels, of the matrix
     products and of the rest; the device busy share of the step), and
     the decode tokens/s of the launcher and the engine, for both models.
 17. a batch of hypergradients as one solve: 64 ridge problems of phase
     4's recipe (Xᵢ (1024, 512), θᵢ log-uniform in [1e-2, 1], yᵢ), float32,
     a ``custom_root`` ridge solver (forward ``torch.linalg.solve``, no
     kernel) with ``solve="pallas_cg"``: (a) ``torch.func.vmap`` of
     ``torch.func.grad`` of Σx*² in θ and (b) ``vmap`` of ``torch.func.jvp``
     in θ each launch the kernel exactly once for the 64, on C8, where a
     Python loop launches it 64 times; values within 1e-4 of the loop and
     1e-3 of the float64 closed form (dx*/dθ = −A⁻¹x*), each limit failed
     by the loop's (closed form's) values shifted by one instance; (c)
     ``vmap`` over ``GradientDescent(solve="pallas_cg").run()`` (step 1/L,
     tol 1e-4 on ‖Δx‖): every instance converged, per-instance iterations
     within 1 of a loop of 64 runs, and ``vmap(grad)`` through it one C8
     launch; wall times of the batched calls and the loops printed;
 18. the DEQ layer at ``qwen1.5-4b``'s width (d 2560, d_ff 6912): the
     cell of ``examples/deq_block.py`` with the norm per token, weights
     × 3/√fan-in (the measured contraction factor, by power iteration on
     the cell's Jacobian at z*, printed and < 1), x (8192, 2560) the tokens
     of a (4, 2048) batch, float32; ``make_deq_block``'s Anderson forward to
     ‖T(z) − z‖ ≤ 5e-3 over all tokens (converged); the gradient of Σz*²
     in W₁, W₂ for ``bwd_solve`` ∈ {normal_cg, neumann, gmres, bicgstab}
     (tol 1e-5) within 1e-3 of normal_cg's, and for ``backward`` ∈
     {neumann_k (k = 8), one_step, jacobian_free} with its
     ``hypergrad_error_estimate`` and cosine to the exact gradient; at 512
     tokens the implicit gradient within 1e-3 of a 100-layer unrolled
     backprop; jacobian_free's gradient is the control of both limits;
 19. the service's approximate arm: A = I − ρS (‖S‖₂ = 1, d = 512, ρ ∈
     {0.5, 0.9}), 64 ``submit_hypergrad`` per (ρ, mode), mode ∈ {exact
     (``solve="pallas_cg"``), one_step, neumann_k (k = 8), jacobian_free},
     on a default service (cache on): each approximate result within 1e-4
     of its polynomial in float64 (the polynomial one term off is the
     control), each estimate within 1e-3 of ‖v − Aᵀu‖/‖v‖ in float64 (the
     same with the requests' u shifted by one is the control), the
     estimates at ρ = 0.9 at or above those at ρ = 0.5, the exact buckets
     within 1e-3 of ``solve="lu"`` on 2 C8 launches, and the approximate
     requests leaving the cache's size as it was;
 20. the new solvers and operators at (64, 512) float32: ``bicgstab`` and
     ``gmres`` on I + 0.5·G/√d, ``neumann`` on I − 0.5·M/‖M‖₂, ``cg`` with
     ``precond="block_jacobi"`` on a ``BlockDiagonal`` of 8 SPD blocks of 64
     (one iteration): each converged at tol 1e-4 and its float64 residual
     within 2e-4 (a solution shifted by one instance is the control); the
     matvecs of a ``ComposedOperator`` and of a ``RaveledOperator`` within
     1e-5 of their materialized matrices (the transpose is the control).
 21. stochastic bilevel at data scale (``benchmarks/stochastic_bilevel.py``
     Part A: per-feature-regularized ridge, the hypergradient of
     ½‖w* − w_true‖² in the d log-regularizers λ = −2): X (1,048,576 ×
     512) ~ N(0, 1/d) float32 on the card from ``--seed`` (2 GiB), one
     epoch of ``SGD`` at B = 1,024 (stepsize 0.5/(1 + 0.02k), Polyak from
     step 512, ``backward_batches=4``, ``backward_iters=10``, the class
     defaults ``neumann_k`` + Jacobi on the sampled operator) against
     full-batch ``GradientDescent`` (stepsize 0.5, tol 1e-6, exact ``cg``
     backward): cosine ≥ 0.9 (the benchmark's limit; the baseline with its
     features permuted is the control); ``estimate_hypergrad_error``
     finite and below 1; ``solve_bilevel`` over 2 steps with
     ``backward="exact"`` reports an estimate; half an epoch restarted from
     its state and average equals the epoch bit for bit; ``vmap(grad)``
     over 8 λ vectors (``backward="exact"``, a counting ``cg``, no
     preconditioner) runs ONE registry solve where the loop runs 8, within
     1e-4 of the loop (the loop shifted by one is the control);
 22. autotune on the batched-CG kernel, in a fresh tuning cache:
     ``measure_layout_schedule`` by device time at (64, 512) float32 (C8,
     stream), (64, 128) float32 (C1, C2, C4, C8, stream) and (64, 512)
     float64 (stream), every candidate's time printed; ``choose_layout``
     equals the argmin; a ``linear_solve.solve(method="pallas_cg")`` at
     each shape launches the rule's layout on the cold cache and the
     chosen one after the sweep (``ops.LAUNCHES_BY_LAYOUT``), within the
     phase-3 limits of the plain version; a cache entry naming C1 at
     d = 512 raises; the cache survives ``save`` → ``load`` through a file
     under ``build/`` and a subprocess with ``REPRO_AUTOTUNE_CACHE``
     preloads it; ``measure_solver`` for ``pallas_cg``, ``cg``,
     ``dense_gmres`` and ``lu`` at (64, 512) float32, predictions
     "measured" for those and "roofline" for an unmeasured regime, beside
     the cost model's cold-cache estimate;
 23. the operation census (``analysis.op_census``) of one ``qwen1.5-4b``
     bfloat16 kernel prefill step at phase 16's (4, 2048): the FLOPs of
     its matrix products within 1 % of 2 · (non-embedding parameters +
     the LM head) · tokens reckoned from the config (the census with its
     products left out is the control), the 40 attention launches as
     custom calls, and ``roofline.analyze``'s compute and memory terms and
     the step's MFU at phase 16's measured prefill time.

Phases 17-23 each print their duration on a line of their own.  The run
fails at once if ``REPRO_AUTOTUNE_CACHE`` is set: phases 3-20 hold every
batched-CG launch to the kernel's rule, which only a cold tuning cache
gives (``solve_pallas_cg`` takes ``layout="auto"``).

Kernel launches are counted by each kernel's ``ops.LAUNCHES`` (and, for
batched_cg, ``ops.LAUNCHES_BY_LAYOUT``; for flash attention,
``ops.LAUNCHES_BY_ROUTE``), set to 0 just before each main-path phase
(4-7, 17's batched derivatives, 19's exact buckets and 22's solves for
batched_cg — not 22's sweep, whose launches it prints apart —
phase 6's forward and backward each on their own, 10 for simplex_proj,
each kernel prefill of 14 for flash_attention and of 15 for rwkv_wkv; the JSON line reports the bfloat16 one, for flash
attention its tc launches, and adds the CUDA-core kernel's time as
``previous_ms``) and read just after.  ``previous_ms`` of batched_cg is
the stream route's time in the same turns; of simplex_proj and rwkv_wkv
the earlier design's time, measured when ``--previous`` names an earlier
checkout (its sources are not kept beside the current ones), and null
otherwise.  The
line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the repo's ``src/`` beside it, the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
# the cluster route (every system whose slice fits; the main path) and the
# stream route (float64 at d = 512), one library
KERNEL_SOURCE = ("src/repro_torch/kernels/batched_cg/csrc/"
                 "batched_cg_cluster.cu")
STREAM_SOURCE = "src/repro_torch/kernels/batched_cg/csrc/batched_cg.cu"
REPLACES = "src/repro/kernels/batched_cg/kernel.py:30"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12                 # H100 SXM float32 outside tensor cores
RTOL = {"float32": 1e-4, "float64": 1e-10}
CG_TOL = {"float32": 1e-6, "float64": 1e-12}
SERVICE_TOL = 1e-3                 # phase 4/7 (float32), see PERF.md
HYPERGRAD_TOL = 1e-6               # phase 5/6 solve tolerance (float32)
# phase 3: (B, d); with kernel.layout's rule, in float32 and float64 they
# take every layout (cluster sizes 1, 2, 4, 8 and the stream route)
CG_SHAPES = [(3, 7), (5, 130), (64, 96), (64, 512), (16, 300), (8, 400)]
MAIN_LAYOUT = "C8"                 # d = 512 float32, phases 4-6

SIMPLEX_SOURCE = "src/repro_torch/kernels/simplex_proj/csrc/simplex_proj.cu"
SIMPLEX_REPLACES = "src/repro/kernels/simplex_proj/kernel.py:25"
SIMPLEX_ATOL = 1e-5                # times max(1, max|y|): float32 bisection
SIMPLEX_TPU_STEPS = 50             # the TPU kernel's bisection steps (bound)
# phase 9: (R, d); with kernel.layout's rule they take every register
# layout (8, 16 and 32 lanes a row at 16 values a lane, 32 at 32) and the
# shared-memory path
SIMPLEX_SHAPES = [(4, 5), (16, 33), (64, 1000), (3, 4097), (50000, 100),
                  (6, 1), (40, 20), (40, 101), (500, 200), (300, 300),
                  (300, 700)]
# and rows whose threshold equals one of their values, so that the early end
# never triggers and every row runs the 50 steps: (R, d) with d - 1 ties
SIMPLEX_TIE_SHAPES = [(64, 100), (8, 2000)]
# phase 10: CIFAR-100's training/validation shapes (see PERF.md §4)
SVM = dict(m=50000, p=3072, k=100, m_val=10000)
SVM_THETA_OVER_L = 0.13            # θ₀ = 0.13·‖X‖₂², the smooth regime
SVM_TOL_REL = 1e-5                 # inner tol = 1e-5·√m (vertex-dual norm)
SVM_OUTER_STEPS = 3
SVM_OUTER_LR = 0.01
SVM_LINSOLVE = dict(linsolve_tol=1e-6, linsolve_maxiter=800)
SVM_MAXITER = 6000
SVM_GRAD_RTOL = 1e-2               # float32 kernel vs float64 sort-based

# the tensor-core kernel (the bfloat16 route the models serve) and the
# CUDA-core kernel (float32, and the bf16 shapes the tc route does not take)
FA_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
             "flash_attention_tc.cu")
FA_SIMT_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu")
FA_REPLACES = "src/repro/kernels/flash_attention/kernel.py:27"
WKV_SOURCE = "src/repro_torch/kernels/rwkv_wkv/csrc/rwkv_wkv.cu"
WKV_REPLACES = "src/repro/kernels/rwkv_wkv/kernel.py:21"
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor cores
# phase 12: (B, Sq, Sk, H, Hkv, D, causal), float32 and bfloat16; the last
# is qwen1.5-4b's prefill
FA_SHAPES = [(2, 128, 128, 4, 4, 64, True), (2, 128, 128, 4, 4, 64, False),
             (2, 200, 200, 8, 2, 128, True),
             (4, 2048, 2048, 20, 20, 128, True)]
# and in bfloat16 only: a ragged D = 80 head with MQA, D = 256 with Sq < Sk,
# and Sq > Sk with GQA, so that the tc route meets them on every run
FA_BF16_SHAPES = [(1, 77, 77, 4, 1, 80, True), (1, 64, 130, 2, 2, 256, True),
                  (3, 33, 17, 6, 3, 64, True),
                  # a head narrower than one 64-column panel: the op sends
                  # it to the CUDA-core kernel
                  (2, 100, 100, 4, 2, 32, True)]
# (B, T, H), N = 64: one step; one short chunk; partial last chunks; odd H
WKV_SHAPES = [(1, 1, 1), (2, 100, 3), (4, 2048, 40), (1, 37, 1), (3, 130, 7)]
LM_PREFILL = (4, 2048)             # (B, S) of the prefill step
LM_DECODE = (2, 64)                # (B, S) of decode against prefill
LM_F32_RTOL = 1e-3                 # ‖Δ‖/‖ref‖ of float32 prefill logits
# ‖Δ‖/‖ref‖ of float32 decode logits against prefill at full depth, each
# set from its model's readings (PERF.md §6); and at the cut depths of the
# decode witness (full width, 1 and 4 layers), for both models
LM_DECODE_RTOL = {"qwen1.5-4b": 1e-5, "rwkv6-3b": 5e-3}
LM_DECODE_DEPTHS = (1, 4)
LM_DECODE_SHALLOW_RTOL = 1e-5
# ‖Δ‖/‖ref‖ of bfloat16 kernel prefill logits against use_kernel=False,
# fixed per model between the plain op's floor and the controls (PERF.md)
LM_RTOL = {"qwen1.5-4b": 5e-2, "rwkv6-3b": 8e-2}
ENGINE = dict(num_slots=8, requests=16, prompt=(8, 32), new_tokens=16,
              max_len=64)

# phases 17-20 (limits and their readings: PERF.md)
VMAP_RTOL = 1e-4                   # phase 17: vmap against the loop
CLOSED_RTOL = 1e-3                 # phase 17: against the float64 closed form
RUN_TOL = 1e-4                     # phase 17 (c): GD's ‖Δx‖ tol, float32
DEQ = dict(d=2560, d_ff=6912, tokens=4 * 2048, unroll_tokens=512,
           depth=100, scale=3.0)   # qwen1.5-4b's width; (4, 2048) tokens
DEQ_FWD = dict(fwd_iters=100, fwd_tol=5e-3)   # ‖T(z) − z‖ over all tokens
DEQ_LINSOLVE = dict(tol=1e-5, maxiter=200)    # the exact backward solvers
DEQ_AGREE_RTOL = 1e-3              # exact solvers against normal_cg
DEQ_UNROLL_RTOL = 1e-3             # implicit against 100 unrolled layers
APPROX = dict(d=512, rhos=(0.5, 0.9), n=64, k=8)
POLY_RTOL = 1e-4                   # phase 19: against the float64 polynomial
EXACT_RTOL = 1e-3                  # phase 19: exact bucket against lu
EST_RTOL = 1e-3                    # phase 19: estimate against float64
SOLVERS_TOL = 1e-4                 # phase 20: the solvers' tol, float32;
#                                    float64 true residual held to 2x it
MATVEC_RTOL = 1e-5                 # phase 20: operator matvecs
# phases 21-23 (limits and their readings: PERF.md)
STOCH = dict(n=1_048_576, d=512, B=1024, backward_batches=4,
             backward_iters=10, vmap_lams=8)
STOCH_COS = 0.9                    # phase 21: the benchmark's own limit
STOCH_VMAP_RTOL = 1e-4             # phase 21: vmap(grad) against the loop
# phase 22: (B, d, dtype) of the layout sweep: C8 and stream; every layout;
# the stream route alone
LAYOUT_SWEEP = [(64, 512, "float32"), (64, 128, "float32"),
                (64, 512, "float64")]
SWEEP_TIMING = dict(reps=20, replays=5)
CENSUS_RTOL = 1e-2                 # phase 23: census against the reckoning


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def rel(a, b) -> float:
    import torch
    a, b = a.detach().double(), b.detach().double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def ridge_batch(gen, B, d, m, dtype, device, theta_range=(1e-2, 1.0)):
    """Aᵢ = XᵢᵀXᵢ/m + θᵢI (θᵢ log-uniform), bᵢ standard normal."""
    import torch
    X = torch.randn(B, m, d, generator=gen, device=device, dtype=dtype)
    lo, hi = (math.log(t) for t in theta_range)
    theta = torch.exp(torch.empty(B, device=device, dtype=dtype)
                      .uniform_(lo, hi, generator=gen))
    A = X.transpose(1, 2) @ X / m + theta[:, None, None] * torch.eye(
        d, device=device, dtype=dtype)
    b = torch.randn(B, d, generator=gen, device=device, dtype=dtype)
    return A, b, X, theta


def ptxas_summary(log: str) -> str:
    """Per kernel of a ``-Xptxas -v`` log: registers, stack frame and spill
    stores / loads in bytes, and whether ptxas serialized its wgmma.  Names are demangled
    by the CUDA toolkit's ``cu++filt`` (``-p``: without parameters)."""
    from repro_torch.kernels import _build
    rows, name, serialized = [], None, set()
    for line in log.splitlines():
        m = re.search(r"serialized due to (.+?) for the function '(\S+)'",
                      line)
        if m:
            serialized.add(m.group(2))
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            spill = f"stack {m.group(1)} B, spill {m.group(2)}/{m.group(3)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, f"{m.group(1)} registers, {spill}"))
            name = None
    names = [n for n, _ in rows]
    try:
        shown = subprocess.run(
            [str(Path(_build.nvcc()).with_name("cu++filt")), "-p", *names],
            capture_output=True, text=True, timeout=60).stdout.splitlines()
    except OSError:                 # a toolkit without cu++filt
        shown = []
    if len(shown) != len(names):
        shown = names
    return "; ".join(
        short.replace("void ", "", 1).replace("(anonymous namespace)::", "")
        + f" {regs}" + (", wgmma serialized" if n in serialized else "")
        for (n, regs), short in zip(rows, shown))


def start_previous_build(previous: Path):
    """Start one ``nvcc`` each (the port's flags) for the batched_cg,
    simplex_proj and rwkv_wkv libraries of an earlier checkout of the
    repository (every ``.cu`` of the library's ``csrc/``), into
    ``build/previous/``; returns what :func:`load_previous` waits for."""
    from repro_torch.kernels import _build
    out = ROOT / "build" / "previous"
    out.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in ("batched_cg", "simplex_proj", "rwkv_wkv"):
        csrc = previous / "src" / "repro_torch" / "kernels" / name / "csrc"
        sources = sorted(csrc.glob("*.cu"))
        check(bool(sources), f"--previous: no .cu source under {csrc}")
        lib = out / f"lib{name}.so"
        running[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             *map(str, sources)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib,
            "".join(p.read_text() for p in sources))
    return running


class Earlier(NamedTuple):
    """An earlier checkout's built library and the text of its sources."""
    lib: ctypes.CDLL
    source: str

    def arity(self, fn: str) -> int:
        """How many parameters the source's C function ``fn`` takes."""
        m = re.search(rf"\b{fn}\s*\(([^)]*)\)", self.source)
        check(m is not None, f"--previous: {fn} not found in its sources")
        return len(m.group(1).split(","))


def load_previous(running):
    """Wait for the builds of :func:`start_previous_build` and load them."""
    libs = {}
    for name, (proc, lib, source) in running.items():
        log, _ = proc.communicate(timeout=900)
        check(proc.returncode == 0, f"build of the earlier {name}:\n{log}")
        libs[name] = Earlier(ctypes.CDLL(str(lib)), source)
    return libs


def sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def percentile(vals, q):
    vals = sorted(vals)
    return vals[min(len(vals) - 1, max(0, round(q / 100 * (len(vals) - 1))))]


# ---------------------------------------------------------------------------
# phases (each returns what main() checks and reports)
# ---------------------------------------------------------------------------

def cg_counts(reset=False):
    """The batched-CG op's launch counts: (all, by layout); with ``reset``
    every count is set to 0 first."""
    from repro_torch.kernels.batched_cg import ops
    if reset:
        ops.LAUNCHES = 0
        for name in ops.LAUNCHES_BY_LAYOUT:
            ops.LAUNCHES_BY_LAYOUT[name] = 0
    return ops.LAUNCHES, {k: v for k, v in ops.LAUNCHES_BY_LAYOUT.items()
                          if v}


def phase_kernel_vs_plain(device, gen, shapes):
    """Kernel (via the op) against the plain version, forward + backward,
    and the layout each (B, d, dtype) launched (from the op's counts)."""
    import torch
    from repro_torch.kernels.batched_cg import ops, ref
    worst, layouts = {}, {}
    err_main = None
    for B, d in shapes:
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).replace("torch.", "")
            tol = CG_TOL[name]
            A, b, _, _ = ridge_batch(gen, B, d, 2 * d, dtype, device,
                                     theta_range=(0.1, 0.1))
            At, bt = A.clone().requires_grad_(), b.clone().requires_grad_()
            before = dict(ops.LAUNCHES_BY_LAYOUT)
            x = ops.batched_cg(At, bt, tol=tol, maxiter=4 * d, device=device)
            gA, gb = torch.autograd.grad((x ** 2).sum(), (At, bt))
            sync(device)
            layouts[(B, d, name)] = "/".join(
                k for k, v in ops.LAUNCHES_BY_LAYOUT.items()
                if v != before[k]) or "plain"
            x_ref = ref.batched_cg_ref(A, b, tol=tol, maxiter=4 * d)
            u_ref = ref.batched_cg_ref(A.transpose(1, 2), 2 * x_ref, tol=tol,
                                       maxiter=4 * d)
            gA_ref = -u_ref[:, :, None] * x_ref[:, None, :]
            errs = (rel(x, x_ref), rel(gA, gA_ref), rel(gb, u_ref))
            worst[(B, d, name)] = max(errs)
            if (B, d, name) == (64, 512, "float32"):
                err_main = float((x.detach() - x_ref).abs().max())
            check(max(errs) <= RTOL[name],
                  f"kernel vs plain at B={B} d={d} {name}: rel errors "
                  f"(x, dA, db) = {errs} > {RTOL[name]}")
    return worst, err_main, layouts


def phase_service_kernel_arm(device, gen, n_req, d, m, max_batch):
    """256 dense SPD requests through SolveService(cache=None)."""
    import numpy as np
    import torch
    from repro_torch.runtime import SolveService
    As, bs = [], []
    for lo in range(0, n_req, max_batch):
        A, b, _, _ = ridge_batch(gen, min(max_batch, n_req - lo), d, m,
                                 torch.float32, device)
        As.append(A.cpu().numpy())
        bs.append(b.cpu().numpy())
    A_host, b_host = np.concatenate(As), np.concatenate(bs)
    svc = SolveService(device=device, cache=None, max_batch=max_batch,
                       tol=SERVICE_TOL)
    # warm-up dispatch (CUDA context, allocator), not measured
    for i in range(min(max_batch, n_req)):
        svc.submit(A_host[i], b_host[i], positive_definite=True)
    svc.flush()
    dispatches0 = svc.metrics["dispatches"]

    from repro_torch.observability import report, spans
    tracer = spans.configure_tracer(None)   # in-memory request spans
    cg_counts(reset=True)
    t_sub, t_done, futs = [0.0] * n_req, [0.0] * n_req, []
    for i in range(n_req):
        t_sub[i] = time.perf_counter()
        fut = svc.submit(A_host[i], b_host[i], positive_definite=True)
        fut.add_done_callback(
            lambda f, i=i: t_done.__setitem__(i, time.perf_counter()))
        futs.append(fut)
    svc.flush()
    launches, by_layout = cg_counts()
    spans.remove_tracer()
    breakdown = report.summarize(tracer.records())["spans"]
    results = [f.result() for f in futs]
    wall = max(t_done) - min(t_sub)
    lat = [t_done[i] - t_sub[i] for i in range(n_req)]
    x = np.stack([np.asarray(r.x) for r in results]).astype(np.float64)
    resid = np.linalg.norm(np.einsum("bij,bj->bi", A_host.astype(np.float64),
                                     x) - b_host, axis=-1)
    relres = resid / np.linalg.norm(b_host, axis=-1)
    return dict(launches=launches, by_layout=by_layout, results=results,
                relres=relres,
                dispatches=svc.metrics["dispatches"] - dispatches0,
                rps=n_req / wall, p50=percentile(lat, 50),
                p99=percentile(lat, 99), A=A_host, b=b_host,
                breakdown=breakdown)


def phase_hypergrad(device, gen, n_req, d, m):
    """submit_hypergrad with solve='pallas_cg' against direct root_vjp/lu."""
    import torch
    from repro_torch.core import root_vjp
    from repro_torch.runtime import SolveService
    f32 = torch.float32
    _, _, X, theta = ridge_batch(gen, n_req, d, m, f32, device)
    y = torch.randn(n_req, m, generator=gen, device=device, dtype=f32)
    v = torch.randn(n_req, d, generator=gen, device=device, dtype=f32)
    A = X.transpose(1, 2) @ X / m + theta[:, None, None] * torch.eye(
        d, device=device, dtype=f32)
    x_star = torch.linalg.solve(A, (X.transpose(1, 2) @ y[..., None])[..., 0]
                                / m)

    def F(i):
        Xi, yi = X[i], y[i]
        return lambda x, th: Xi.T @ (Xi @ x - yi) / m + th * x

    svc = SolveService(device=device, cache=None, max_batch=n_req)
    cg_counts(reset=True)
    futs = [svc.submit_hypergrad(F(i), x_star[i], (theta[i],), v[i],
                                 solve="pallas_cg", tol=HYPERGRAD_TOL)
            for i in range(n_req)]
    svc.flush()
    launches, by_layout = cg_counts()
    got = torch.stack([f.result().x[0] for f in futs])
    want = torch.stack([root_vjp(F(i), x_star[i], (theta[i],), v[i],
                                 solve="lu")[0] for i in range(n_req)])
    # each request's error, relative to the batch's largest hypergradient
    errs = (got - want).abs() / want.abs().max()
    return dict(launches=launches, by_layout=by_layout,
                max_rel=float(errs.max()),
                dispatches=svc.metrics["dispatches"])


def phase_implicit_diff(device, gen, d, m):
    """torch.autograd.grad through custom_root(solve='pallas_cg')."""
    import torch
    from repro_torch.core import DenseOperator, custom_root
    from repro_torch.core import linear_solve
    f32 = torch.float32
    X = torch.randn(m, d, generator=gen, device=device, dtype=f32)
    y = torch.randn(m, generator=gen, device=device, dtype=f32)

    def F(x, theta, y):
        return X.T @ (X @ x - y) / m + theta * x

    @custom_root(F, solve="pallas_cg", tol=HYPERGRAD_TOL)
    def ridge(init, theta, y):
        H = X.T @ X / m + theta * torch.eye(d, device=device, dtype=f32)
        op = DenseOperator(H, positive_definite=True)
        return linear_solve.solve(op, X.T @ y / m, method="pallas_cg",
                                  tol=HYPERGRAD_TOL)

    theta = torch.tensor(0.05, device=device, dtype=f32, requires_grad=True)
    yt = y.clone().requires_grad_()
    cg_counts(reset=True)
    x = ridge(None, theta, yt)
    fwd, fwd_layout = cg_counts()
    cg_counts(reset=True)
    g_theta, g_y = torch.autograd.grad(x.sum(), (theta, yt))
    bwd, bwd_layout = cg_counts()
    # closed form in float64: dL/dθ = -1ᵀA⁻¹x*, dL/dy = X A⁻¹ 1 / m
    Xd, yd = X.double(), y.double()
    H = Xd.T @ Xd / m + 0.05 * torch.eye(d, device=device,
                                         dtype=torch.float64)
    xs = torch.linalg.solve(H, Xd.T @ yd / m)
    w = torch.linalg.solve(H, torch.ones(d, device=device,
                                         dtype=torch.float64))
    want_theta = -(w @ xs)
    want_y = Xd @ w / m
    return dict(fwd=fwd, bwd=bwd, fwd_layout=fwd_layout,
                bwd_layout=bwd_layout,
                err_theta=abs(float(g_theta) - float(want_theta))
                / abs(float(want_theta)),
                err_y=rel(g_y, want_y), err_x=rel(x, xs))


def phase_cache_arm(device, A_host, b_host, n_req):
    """Default service (cache on -> dense_gmres): cold then warm wave."""
    from repro_torch.runtime import SolveService
    svc = SolveService(device=device, tol=SERVICE_TOL, max_batch=n_req)
    cg_counts(reset=True)
    waves = {}
    for wave in ("cold", "warm"):
        t0 = time.perf_counter()
        futs = [svc.submit(A_host[i], b_host[i], positive_definite=True)
                for i in range(n_req)]
        svc.flush()
        results = [f.result() for f in futs]
        waves[wave] = dict(results=results, s=time.perf_counter() - t0)
    keys = {k.solver for k, _ in svc._compiled}
    return dict(waves=waves, solvers=keys, launches=cg_counts()[0],
                hit_rate=svc.hit_rate)


def cuda_time_ms(fn, reps):
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_time_ms(fn, reps, replays=5):
    """Device time of one call of ``fn`` in ms: ``reps`` calls captured in
    a CUDA graph and replayed between two CUDA events, so that the host's
    cost of each call (checks, allocation, the ctypes call) is left out
    (``analysis.autotune.device_seconds``)."""
    from repro_torch.analysis.autotune import device_seconds
    return device_seconds(fn, reps=reps, replays=replays) * 1e3


def profiled_device_ms(fn, reps):
    """Device time of one call of ``fn``: the time during which the card
    runs any of its kernels or copies under ``torch.profiler`` (the union
    of their intervals, so that kernels on side streams are not counted
    twice) over ``reps`` calls, divided by ``reps``; gaps for host work and
    syncs are left out.  For a call that a CUDA graph cannot capture.
    None when the profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for lo, hi in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return busy / 1e3 / reps if busy > 0 else None


def in_turns(kernel_fn, earlier_fn, reps):
    """Device times of ``kernel_fn`` twice and, when given, of
    ``earlier_fn`` (the earlier design) around them: earlier, kernel,
    kernel, earlier.  Returns (kernel times, earlier times)."""
    if earlier_fn is None:
        return [graph_time_ms(kernel_fn, reps) for _ in range(2)], []
    first = graph_time_ms(earlier_fn, reps)
    kernel_ms = [graph_time_ms(kernel_fn, reps) for _ in range(2)]
    return kernel_ms, [first, graph_time_ms(earlier_fn, reps)]


def earlier_function(lib, name, argtypes):
    """A function of an earlier design's library, bound with ctypes, that
    raises when its launch is refused."""
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int

    def call(*args):
        check(fn(*args) == 0, f"the earlier {name} did not launch")
    return call


def timing(kernel_ms, earlier_ms, earlier_diff):
    """The keys phases 11 and 16 report for a kernel timed by
    :func:`in_turns`."""
    return dict(ms=sum(kernel_ms) / 2, kernel_ms=kernel_ms,
                previous_ms=sum(earlier_ms) / 2 if earlier_ms else None,
                previous_turns=earlier_ms, previous_diff=earlier_diff)


def phase_times(device, A_np, b_np, tol, previous=None):
    """batched_cg at (64, 512) float32, and its bound.

    Device time (launches replayed from a CUDA graph, ``graph_time_ms``)
    of the cluster route, twice, in turns with the stream route and, with
    ``previous`` (the earlier checkout's library, see ``--previous``), its
    ``batched_cg_f32``: earlier, stream, cluster, cluster, stream, earlier;
    and the largest differences of their x from the cluster route's.  The
    cluster route at ``maxiter=0`` (its load of A, and x = 0 written: what
    an instance costs besides its iterations) and at tol=0, maxiter=10
    (every instance runs 10 iterations, so the batch takes ⌈B/clusters⌉
    equal waves and an iteration costs the difference over 10 × waves),
    by device time.  A call through ``kernel.launch`` by CUDA events.
    ``torch.linalg.solve_ex`` by device time — the sum of its kernels'
    times under ``torch.profiler`` (a CUDA graph cannot capture it: the
    capture is invalidated) — and by CUDA events, and ``torch.linalg.solve``
    by CUDA events, yardsticks only: the port never calls them.  The plain
    version by CUDA events: its loop reads the card on every iteration
    (``bool(any(...))``), a host sync by construction, so it cannot be
    captured in a graph.  The most clusters resident at once, and the CG
    iterations of each instance.
    """
    import torch
    from repro_torch.core import DenseOperator, linear_solve
    from repro_torch.kernels.batched_cg import kernel, ref
    A = torch.from_numpy(A_np).to(device)
    b = torch.from_numpy(b_np).to(device)
    B, d = b.shape
    maxiter = 1000                          # the service's default

    def cluster():
        return kernel.launch(A, b, tol=tol, maxiter=maxiter)

    def stream():
        return kernel.launch(A, b, tol=tol, maxiter=maxiter, layout="stream")

    turns = [stream]
    x_prev = torch.empty_like(b)
    if previous is not None:       # the stream route's C interface
        fn = earlier_function(previous.lib, "batched_cg_f32", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p])

        def earlier():
            fn(A.data_ptr(), b.data_ptr(), x_prev.data_ptr(), B, d, tol,
               maxiter, 0, torch.cuda.current_stream().cuda_stream)
        turns = [earlier, stream]
    first = [graph_time_ms(f, 20) for f in turns]
    cluster_ms = [graph_time_ms(cluster, 20) for _ in range(2)]
    last = [graph_time_ms(f, 20) for f in reversed(turns)][::-1]
    load_ms = graph_time_ms(
        lambda: kernel.launch(A, b, tol=tol, maxiter=0), 20)
    ten_ms = graph_time_ms(
        lambda: kernel.launch(A, b, tol=0.0, maxiter=10), 20)
    clusters = kernel.max_active_clusters(d, A.dtype)
    waves = -(-B // clusters)
    x = cluster()
    diff = {"stream": float((stream() - x).abs().max())}
    if previous is not None:
        earlier()
        diff["earlier"] = float((x_prev - x).abs().max())
    call_ms = cuda_time_ms(cluster, reps=20)
    plain_ms = cuda_time_ms(
        lambda: ref.batched_cg_ref(A, b, tol=tol, maxiter=maxiter), reps=5)
    solve_ex_ms = profiled_device_ms(lambda: torch.linalg.solve_ex(A, b), 5)
    solve_ex_call_ms = cuda_time_ms(lambda: torch.linalg.solve_ex(A, b), 5)
    library_by = "device time (its kernels under torch.profiler)"
    if solve_ex_ms is None:        # the profiler saw no device time
        solve_ex_ms, library_by = solve_ex_call_ms, "CUDA events"
    solve_ms = cuda_time_ms(lambda: torch.linalg.solve(A, b), reps=5)
    _, info = linear_solve.solve_cg(DenseOperator(A, positive_definite=True),
                                    b, tol=tol, maxiter=maxiter,
                                    batch_ndim=1, return_info=True)
    iters = info.iterations.cpu().tolist()
    nbytes = 4 * (B * d * d + 2 * B * d)   # A and b read once, x written once
    flops = 2 * sum(iters) * d * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / FP32_FLOPS * 1e3
    ms = sum(cluster_ms) / 2
    stream_ms = [first[-1], last[-1]]
    return dict(ms=ms, cluster_ms=cluster_ms, stream_ms=stream_ms,
                previous_ms=sum(stream_ms) / 2,
                earlier_ms=[first[0], last[0]] if previous else [],
                diff=diff, load_ms=load_ms, ten_ms=ten_ms, waves=waves,
                iter_us=(ten_ms - load_ms) / (10 * waves) * 1e3,
                call_ms=call_ms, plain_ms=plain_ms, library_ms=solve_ex_ms,
                library_by=library_by, solve_ex_call_ms=solve_ex_call_ms,
                solve_ms=solve_ms, layout=kernel.layout(d, A.dtype),
                clusters=clusters, iters=iters,
                bound_ms=max(t_bytes, t_flops),
                bound_by="bytes" if t_bytes >= t_flops else "operations",
                t_bytes=t_bytes, t_flops=t_flops,
                read_gb_s=nbytes / (ms * 1e-3) / 1e9,
                streamed_gb_s=sum(iters) / B * nbytes
                / (sum(stream_ms) / 2 * 1e-3) / 1e9)


def say_times(t, tol):
    """Phase 8's numbers at one tolerance."""
    earlier = "earlier checkout not measured (no --previous)"
    if t["earlier_ms"]:
        earlier = ("earlier checkout's batched_cg (--previous) " + " / ".join(
            f"{ms:.4f}" for ms in t["earlier_ms"]) + " ms in turns ("
            f"{sum(t['earlier_ms']) / 2 / t['ms']:.2f}x), max |Δx| "
            f"{t['diff']['earlier']:.2e}")
    return (f"tol={tol}: cluster route [{t['layout']}] "
            f"{t['cluster_ms'][0]:.4f} / {t['cluster_ms'][1]:.4f} ms of "
            f"device time ({t['bound_ms'] / t['ms'] * 100:.2f} % of the "
            f"bound; A read once at {t['read_gb_s']:.1f} GB/s), "
            f"{t['load_ms']:.4f} ms at maxiter=0 (the load alone), "
            f"{t['ten_ms']:.4f} ms at tol=0, maxiter=10 (an iteration "
            f"{t['iter_us']:.3f} µs over {t['waves']} waves), "
            f"{t['call_ms']:.4f} ms a call through kernel.launch, "
            f"{t['clusters']} clusters resident at once; stream route "
            f"{t['stream_ms'][0]:.4f} / {t['stream_ms'][1]:.4f} ms in turns "
            f"({t['previous_ms'] / t['ms']:.2f}x the cluster route, A "
            f"streamed at {t['streamed_gb_s']:.1f} GB/s), max |Δx| "
            f"{t['diff']['stream']:.2e}; {earlier}; CG iterations "
            f"sum={sum(t['iters'])} max={max(t['iters'])}; bound "
            f"{t['bound_ms']:.4f} ms (bytes {t['t_bytes']:.4f} ms, operations"
            f" {t['t_flops']:.4f} ms); plain {t['plain_ms']:.4f} ms (CUDA "
            f"events: a host read every iteration); torch.linalg.solve_ex "
            f"{t['library_ms']:.4f} ms by {t['library_by']}, "
            f"{t['solve_ex_call_ms']:.4f} ms by CUDA events;"
            f" torch.linalg.solve {t['solve_ms']:.4f} ms (CUDA events)")


def simplex_path(d):
    """The kernel layout that ``kernel.layout`` picks for rows of d."""
    from repro_torch.kernels.simplex_proj import kernel
    lanes, values = kernel.layout(d)
    return "smem" if values == 0 else f"L={lanes} V={values}"


def tie_rows(gen, R, d, scale, dtype, device):
    """Rows c·1 + scale·e_k (c a non-zero integer in [-3, 3], k at random):
    the threshold is c, a value of d - 1 entries, so the bracket never
    empties and the kernel's early end cannot trigger."""
    import torch
    c = torch.randint(1, 4, (R, 1), generator=gen, device=device) * (
        2 * torch.randint(0, 2, (R, 1), generator=gen, device=device) - 1)
    y = c.to(dtype).expand(R, d).clone()
    k = torch.randint(0, d, (R,), generator=gen, device=device)
    y[torch.arange(R, device=device), k] += scale
    return y


def phase_simplex_vs_plain(device, gen, shapes, tie_shapes):
    """Simplex kernel (via the op) against the plain bisection, with the
    kernel layout each shape took, and the op's derivatives and vmap rule
    on CUDA tensors against the CPU."""
    import torch
    import torch.func
    from repro_torch.kernels.simplex_proj import ops, ref
    worst, err_main = {}, None
    cases = [(R, d, False) for R, d in shapes] + \
        [(R, d, True) for R, d in tie_shapes]
    for R, d, ties in cases:
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).replace("torch.", "")
            scale = 3.0 if (R, d) == (16, 33) else 1.0
            if ties:
                y = tie_rows(gen, R, d, scale, dtype, device)
            else:
                y = 3 * torch.randn(R, d, generator=gen, device=device,
                                    dtype=dtype)
            x = ops.projection_simplex_batched(y, scale)
            sync(device)
            want = ref.projection_simplex_rows_ref(y, scale)
            err = float((x - want).abs().max())
            limit = SIMPLEX_ATOL * max(1.0, float(y.abs().max()))
            sums = float((x.double().sum(-1) - scale).abs().max())
            key = f"{R}x{d}{' ties' if ties else ''} {name}"
            worst[key] = (err, limit, sums, simplex_path(d))
            if (R, d, name, ties) == (50000, 100, "float32", False):
                err_main = err
            check(x.dtype == dtype and err <= limit,
                  f"simplex kernel vs plain at {key}: max |Δ| "
                  f"= {err:.3e} > {limit:.3e}")
            check(sums <= 1e-4, f"simplex kernel at {key}: row"
                  f" sums off the scale by {sums:.3e} > 1e-4")
    # derivatives and vmap on the card against the closed form / plain CPU
    y = 3 * torch.randn(64, 1000, generator=gen, device=device,
                        dtype=torch.float64)
    t = torch.randn(64, 1000, generator=gen, device=device,
                    dtype=torch.float64)
    x = ops.projection_simplex_batched(y)
    want = ops._jacobian_apply(x.cpu(), t.cpu())
    yg = y.clone().requires_grad_()
    (g,) = torch.autograd.grad((ops.projection_simplex_batched(yg) * t).sum(),
                               yg)
    _, jv = torch.func.jvp(ops.projection_simplex_batched, (y,), (t,))
    y3 = y.reshape(4, 16, 1000)
    mapped = torch.func.vmap(ops.projection_simplex_batched, in_dims=1,
                             out_dims=1)(y3)
    sync(device)
    deriv = dict(backward=float((g.cpu() - want).abs().max()),
                 jvp=float((jv.cpu() - want).abs().max()),
                 vmap=float((mapped.cpu() - ref.projection_simplex_rows_ref(
                     y3.cpu())).abs().max()))
    limit = SIMPLEX_ATOL * max(1.0, float(y.abs().max()))
    check(max(deriv["backward"], deriv["jvp"]) <= 1e-12,
          f"simplex op derivatives on the card vs the CPU closed form: "
          f"{deriv} > 1e-12")
    check(deriv["vmap"] <= limit, f"simplex op vmap on the card vs the "
          f"plain CPU version: {deriv['vmap']:.3e} > {limit:.3e}")
    return worst, err_main, deriv


def svm_problem(device, gen, m, p, k, m_val, dtype):
    """``benchmarks/svm_hyperopt.py::make_problem``'s recipe (class centres
    × 2 plus unit Gaussian noise, one-hot labels), drawn on the device."""
    import torch
    centers = 2 * torch.randn(k, p, generator=gen, device=device, dtype=dtype)
    yt = torch.randint(0, k, (m,), generator=gen, device=device)
    Xt = centers[yt] + torch.randn(m, p, generator=gen, device=device,
                                   dtype=dtype)
    yv = torch.randint(0, k, (m_val,), generator=gen, device=device)
    Xv = centers[yv] + torch.randn(m_val, p, generator=gen, device=device,
                                   dtype=dtype)
    eye = torch.eye(k, device=device, dtype=dtype)
    return Xt, eye[yt], Xv, eye[yv]


def svm_functions(Xt, Yt, Xv, Yv):
    """Inner dual objective f(x, λ) (θ = e^λ), W(x, λ) and the outer
    validation loss on θ = (λ, None), as the benchmark's ``build``."""
    import torch

    def W(x, lam):
        return Xt.T @ (Yt - x) / torch.exp(lam)

    def f(x, lam):
        return 0.5 * torch.exp(lam) * (W(x, lam) ** 2).sum() + (x * Yt).sum()

    def outer_loss(x, theta):
        return 0.5 * ((Xv @ W(x, theta[0]) - Yv) ** 2).sum()

    return f, W, outer_loss


def phase_svm(device, gen, m, p, k, m_val, outer_steps=SVM_OUTER_STEPS):
    """solve_bilevel over ProjectedGradient(proj = the kernel op)."""
    import torch
    from repro_torch.core import (ProjectedGradient, bilevel,
                                  custom_fixed_point, optimality,
                                  projections)
    from repro_torch.kernels.simplex_proj import ops
    from repro_torch.observability import events
    t_data = time.perf_counter()
    data = svm_problem(device, gen, m, p, k, m_val, torch.float32)
    Xt = data[0]
    L = float(torch.linalg.eigvalsh(Xt.double().T @ Xt.double()).max())
    theta0 = SVM_THETA_OVER_L * L
    lam0 = math.log(theta0)
    eta = theta0 / L
    tol = SVM_TOL_REL * math.sqrt(m)
    init = torch.full((m, k), 1.0 / k, device=device)
    sync(device)
    setup_s = time.perf_counter() - t_data

    def solver(f, proj):
        return ProjectedGradient(f, lambda y, tp: proj(y), stepsize=eta,
                                 maxiter=SVM_MAXITER, tol=tol,
                                 solve="normal_cg", **SVM_LINSOLVE)

    # the main path: counts set to 0 just before, read just after; the
    # event stream marks each step's forward end (``converged``), backward
    # solve (``backward_done``) and step end (``bilevel_step``)
    f32, _, outer32 = svm_functions(*data)
    log = []
    unsubscribe = events.subscribe(
        lambda ev: log.append((ev.kind, ev.t, ops.LAUNCHES, ev.values)))
    ops.LAUNCHES = 0
    t0 = time.perf_counter()
    with events.observe(True):
        sol = bilevel.solve_bilevel(
            outer32, solver(f32, ops.projection_simplex_batched),
            (torch.tensor(lam0, device=device), None), init,
            outer_steps=outer_steps, outer_lr=SVM_OUTER_LR)
    sync(device)
    wall = time.perf_counter() - t0
    launches = ops.LAUNCHES
    unsubscribe()
    steps, t_prev, n_prev = [], t0, 0
    step = {}
    for kind, t, n, values in log:
        if kind == "converged":
            step.update(inner=int(values["iterations"]),
                        converged=bool(values["converged"]),
                        error=float(values["error"]), fwd_launches=n - n_prev,
                        fwd_s=t - t_prev, t_fwd=t, n_fwd=n)
        elif kind == "backward_done":
            step.update(bwd_iters=int(values["iterations"]),
                        bwd_residual=float(values["residual"]))
        elif kind == "bilevel_step":
            step.update(bwd_launches=n - step["n_fwd"],
                        bwd_s=t - step["t_fwd"], step_s=t - t_prev,
                        outer=float(values["outer_value"]),
                        hypergrad=float(values["hypergrad_norm"]))
            steps.append(step)
            step, t_prev, n_prev = {}, t, n

    # the signed first-step hypergradient, g = (λ₀ − λ₁)/lr from one outer
    # step: with the kernel in float32, then in float64 with the sort-based
    # projection
    lam32 = torch.tensor(lam0, device=device)
    sol1 = bilevel.solve_bilevel(
        outer32, solver(f32, ops.projection_simplex_batched), (lam32, None),
        init, outer_steps=1, outer_lr=SVM_OUTER_LR)
    g32 = (float(lam32) - float(sol1.theta[0])) / SVM_OUTER_LR
    data64 = tuple(a.double() for a in data)
    f64, _, outer64 = svm_functions(*data64)
    t64 = time.perf_counter()
    sol64 = bilevel.solve_bilevel(
        outer64, solver(f64, projections.projection_simplex),
        (torch.tensor(lam0, device=device, dtype=torch.float64), None),
        init.double(), outer_steps=1, outer_lr=SVM_OUTER_LR)
    sync(device)
    s64 = time.perf_counter() - t64
    g64 = (lam0 - float(sol64.theta[0])) / SVM_OUTER_LR

    # Fig. 4c decoupling: the mirror-descent fixed point's hypergradient at
    # the float64 run's x* (reported, not gated)
    T_md = optimality.mirror_descent_fp(
        f64, lambda y, tp: projections.projection_simplex_kl(y),
        optimality.kl_phi_grad, stepsize=eta)
    x64 = sol64.x_star
    at_x = custom_fixed_point(lambda x, lam: T_md(x, (lam, None)),
                              solve="normal_cg",
                              tol=SVM_LINSOLVE["linsolve_tol"],
                              maxiter=SVM_LINSOLVE["linsolve_maxiter"])(
        lambda init, lam: x64)
    lam = torch.tensor(lam0, device=device, dtype=torch.float64,
                       requires_grad=True)
    (g_md,) = torch.autograd.grad(outer64(at_x(x64, lam), (lam, None)), lam)

    # the per-iteration host read: the same updates without it
    pg = solver(f32, ops.projection_simplex_batched)
    theta_run = (torch.tensor(float(sol.theta[0]), device=device), None)
    x, state = sol.x_star, pg.init_state(sol.x_star, theta_run)
    n_upd = 50
    sync(device)
    t_upd = time.perf_counter()
    for _ in range(n_upd):
        x, state = pg.update(x, state, theta_run)
    sync(device)
    upd_s = (time.perf_counter() - t_upd) / n_upd
    supp = (sol.x_star > 0).sum(-1).float()
    return dict(steps=steps, launches=launches, wall=wall, setup_s=setup_s,
                L=L, theta0=theta0, lam0=lam0, tol=tol, g32=g32, g64=g64,
                inner64=int(sol64.inner_info.iterations), s64=s64,
                g_md=float(g_md), upd_s=upd_s,
                outer_values=[float(v) for v in sol.outer_values],
                theta=float(sol.theta[0]),
                converged=bool(sol.inner_info.converged),
                support_mean=float(supp.mean()),
                interior_rows=float((supp > 1).float().mean()))


def phase_simplex_times(device, gen, previous=None):
    """Simplex kernel, plain and sort-based times at (50000, 100) float32,
    and the bound; with ``previous`` (the earlier design's library, see
    ``--previous``) that kernel too, in turns (earlier, kernel, kernel,
    earlier), and its largest difference from the kernel."""
    import torch
    from repro_torch.core import projections
    from repro_torch.kernels.simplex_proj import kernel, ref
    R, d = 50000, 100
    y = 3 * torch.randn(R, d, generator=gen, device=device)
    earlier, x_prev = None, torch.empty_like(y)
    # its C interface: y, x, R, d, scale (PR 12's design), or y, x, R, d,
    # lanes, values, scale (the layout's, from PR 17 on)
    layout = () if previous is None or \
        previous.arity("simplex_proj_f32") == 6 else kernel.layout(d)
    if previous is not None:
        fn = earlier_function(previous.lib, "simplex_proj_f32", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_int] * len(layout) + [ctypes.c_double,
                                              ctypes.c_void_p])

        def earlier():
            fn(y.data_ptr(), x_prev.data_ptr(), R, d, *layout, 1.0,
               torch.cuda.current_stream().cuda_stream)
    kernel_ms, earlier_ms = in_turns(lambda: kernel.launch(y), earlier, 50)
    ties = tie_rows(gen, R, d, 1.0, torch.float32, device)
    ties_ms = graph_time_ms(lambda: kernel.launch(ties), 50)
    call_ms = cuda_time_ms(lambda: kernel.launch(y), reps=50)
    plain_ms = cuda_time_ms(lambda: ref.projection_simplex_rows_ref(y),
                            reps=5)
    sort_ms = cuda_time_ms(lambda: projections.projection_simplex(y), reps=20)
    nbytes = 4 * 2 * R * d                  # y read once, x written once
    # the function's work is the TPU kernel's 50 steps, however early the
    # kernel stops: subtract, max, add per value and step
    flops = 3 * SIMPLEX_TPU_STEPS * R * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / FP32_FLOPS * 1e3
    earlier_diff = None if earlier is None else \
        float((kernel.launch(y) - x_prev).abs().max())
    return dict(timing(kernel_ms, earlier_ms, earlier_diff), call_ms=call_ms,
                ties_ms=ties_ms, plain_ms=plain_ms, sort_ms=sort_ms,
                bound_ms=max(t_bytes, t_flops),
                bound_by="bytes" if t_bytes >= t_flops else "operations",
                t_bytes=t_bytes, t_flops=t_flops)


def bf16_limit(want, dtype):
    """float32: 1e-4 of the largest |ref| (sums in another order);
    bfloat16: one rounding of the output, at most one bf16 unit (2⁻⁷ of
    the value), plus that."""
    import torch
    big = float(want.float().abs().max())
    if dtype == torch.float32:
        return torch.full_like(want, 1e-4 * big, dtype=torch.float32)
    return 2.0 ** -7 * want.float().abs() + 1e-4 * big


def check_close(got, want, dtype, what):
    """Kernel output against plain under ``bf16_limit``; returns max |Δ|."""
    err = (got.float() - want.float()).abs()
    worst = float((err - bf16_limit(want, dtype)).max())
    check(got.dtype == want.dtype and got.shape == want.shape and worst <= 0,
          f"{what}: max |Δ| {float(err.max()):.3e} over the limit by "
          f"{worst:.3e}")
    return float(err.max())


def phase_flash_vs_plain(device, gen, shapes, bf16_shapes):
    """Flash-attention kernels (via the op) against the plain version; the
    route each call took, read from the op's per-route launch counts.  Each
    bfloat16 case of ``shapes`` runs once more on the CUDA-core kernel
    (``route_name="simt"``, keyed "bfloat16 on simt"), so that its bf16
    instantiation is held to the same limit as the route the op chose."""
    import torch
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    worst, routes, err_main = {}, {}, None
    cases = [(shp, dt) for shp in shapes
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(shp, torch.bfloat16) for shp in bf16_shapes]
    for (B, Sq, Sk, H, Hkv, D, causal), dtype in cases:
        q = torch.randn(B, Sq, H, D, generator=gen, device=device)
        k = torch.randn(B, Sk, Hkv, D, generator=gen, device=device)
        v = torch.randn(B, Sk, Hkv, D, generator=gen, device=device)
        q, k, v = (a.to(dtype) for a in (q, k, v))
        before = dict(ops.LAUNCHES_BY_ROUTE)
        got = ops.flash_attention(q, k, v, causal=causal)
        sync(device)
        took = [r for r, n in ops.LAUNCHES_BY_ROUTE.items()
                if n != before[r]]
        want = ref.attention_ref(q, k, v, causal=causal)
        name = str(dtype).replace("torch.", "")
        key = (B, Sq, Sk, H, Hkv, D, "causal" if causal else "full", name)
        routes[key] = took[0] if len(took) == 1 else str(took)
        worst[key] = check_close(got, want, dtype,
                                 f"flash_attention vs plain at {key}")
        if dtype == torch.bfloat16 and (B, Sq, Sk, H, Hkv, D, causal) \
                in shapes:
            simt = kernel.launch(q, k, v, causal, route_name="simt")
            skey = key[:-1] + ("bfloat16 on simt",)
            worst[skey] = check_close(simt, want, dtype,
                                      f"flash_attention vs plain at {skey}")
            del simt
        if (B, Sq, H, D, name) == (4, 2048, 20, 128, "bfloat16"):
            err_main = worst[key]
        del q, k, v, got, want
    return worst, routes, err_main


def wkv_inputs(device, gen, B, T, H, dtype, with_state=False):
    """r, k, v ~ N(0, 1/4) in ``dtype``; w = exp(-exp(-6 + tanh(N(0, 1))))
    as the model's decay, float32; u ~ N(0, 1/100); state0 ~ N(0, 1)."""
    import torch
    N = 64
    r, k, v = (0.5 * torch.randn(B, T, H, N, generator=gen, device=device)
               for _ in range(3))
    w = torch.exp(-torch.exp(-6.0 + torch.tanh(torch.randn(
        B, T, H, N, generator=gen, device=device))))
    u = 0.1 * torch.randn(H, N, generator=gen, device=device)
    s0 = torch.randn(B, H, N, N, generator=gen, device=device) \
        if with_state else None
    return r.to(dtype), k.to(dtype), v.to(dtype), w, u, s0


def wkv_path(T):
    """How the kernel's staging splits T: whole chunks and a short one."""
    from repro_torch.kernels.rwkv_wkv import kernel
    return f"{T // kernel.CHUNK} chunks of {kernel.CHUNK} + {T % kernel.CHUNK}"


def phase_wkv_vs_plain(device, gen, shapes):
    """WKV kernel (via the op) against the plain scan, with how the
    kernel's staging split each T, and a state carried across a split of
    T."""
    import torch
    from repro_torch.kernels.rwkv_wkv import ops, ref
    worst, err_main = {}, None
    for B, T, H in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            for with_state in (False, True):
                r, k, v, w, u, s0 = wkv_inputs(device, gen, B, T, H, dtype,
                                               with_state)
                out, state = ops.wkv(r, k, v, w, u, s0)
                sync(device)
                want, want_s = ref.wkv_scan_ref(r, k, v, w, u, s0)
                name = str(dtype).replace("torch.", "")
                key = (B, T, H, name, "state0" if with_state else "zeros")
                e_o = check_close(out, want, dtype, f"wkv vs plain at {key}")
                e_s = check_close(state, want_s, torch.float32,
                                  f"wkv final state vs plain at {key}")
                worst[key] = (e_o, e_s, wkv_path(T))
                if (B, T, H, name, with_state) == (4, 2048, 40, "bfloat16",
                                                   False):
                    err_main = e_o
    r, k, v, w, u, s0 = wkv_inputs(device, gen, 2, 100, 3, torch.float32,
                                   True)
    o_all, s_all = ops.wkv(r, k, v, w, u, s0)
    o1, s1 = ops.wkv(r[:, :37], k[:, :37], v[:, :37], w[:, :37], u, s0)
    o2, s2 = ops.wkv(r[:, 37:], k[:, 37:], v[:, 37:], w[:, 37:], u, s1)
    sync(device)
    check(torch.equal(torch.cat([o1, o2], 1), o_all)
          and torch.equal(s2, s_all),
          "wkv kernel: a state carried across a split of T differs from one "
          "run over T")
    return worst, err_main


def logits_error(got, want):
    """(‖Δ‖/‖ref‖, max |Δ|) of two logits tensors, in float32."""
    import torch
    d = got.float() - want.float()
    out = (float(torch.linalg.vector_norm(d)
                 / torch.linalg.vector_norm(want.float())),
           float(d.abs().max()))
    del d
    return out


def lm_prefill_checks(cfg, params, tokens, ops, op_name, replacements):
    """The prefill step with the kernel (launches counted just around it)
    against the plain prefill (``use_kernel=False``), and the same kernel
    prefill with ``ops.<op_name>`` replaced: ``replacements`` maps a name
    to a function of the real op that returns the replacement.  Each
    replacement's logits are measured against the plain prefill and
    against the kernel prefill.  Where the op counts its launches by route
    (``ops.LAUNCHES_BY_ROUTE``), those counts are set to 0 and read with
    ``ops.LAUNCHES``."""
    import torch
    from repro_torch.runtime import make_prefill_step
    kernel_step = make_prefill_step(cfg, use_kernel=True)
    by_route = getattr(ops, "LAUNCHES_BY_ROUTE", {})
    ops.LAUNCHES = 0
    for name in by_route:
        by_route[name] = 0
    logits = kernel_step(params, tokens)
    sync(tokens.device)
    launches = ops.LAUNCHES
    routes = dict(by_route)
    want = make_prefill_step(cfg, use_kernel=False)(params, tokens)
    err = logits_error(logits, want)
    finite = bool(torch.isfinite(logits).all())
    shape_ok = tuple(logits.shape) == tuple(tokens.shape) + (cfg.vocab_size,)
    others = {}
    real = getattr(ops, op_name)
    for name, make in replacements.items():
        setattr(ops, op_name, make(real))
        try:
            got = kernel_step(params, tokens)
        finally:
            setattr(ops, op_name, real)
        others[name] = (logits_error(got, want)[0],
                        logits_error(got, logits)[0])
        del got
    del logits, want
    return dict(launches=launches, routes=routes, err=err, others=others,
                finite=finite, shape_ok=shape_ok)


def lm_decode_vs_prefill(cfg, params, tokens):
    """Token-by-token decode_step against the kernel prefill's logits:
    ‖Δ‖/‖ref‖ and max |Δ| over all positions, ‖Δ‖/‖ref‖ over the later
    half and at each position, and the argmax agreement."""
    import torch
    from repro_torch.models import init_decode_state
    from repro_torch.runtime import make_decode_step, make_prefill_step
    B, S = tokens.shape
    full = make_prefill_step(cfg, use_kernel=True)(params, tokens)
    step = make_decode_step(cfg)
    state = init_decode_state(cfg, B, S, device=tokens.device)
    outs = []
    for t in range(S):
        lg, state = step(params, state, tokens[:, t:t + 1])
        outs.append(lg[:, 0])
    dec = torch.stack(outs, 1)
    agree = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
    late = logits_error(dec[:, S // 2:], full[:, S // 2:])[0]
    per_pos = [logits_error(dec[:, t], full[:, t])[0] for t in range(S)]
    return dict(err=logits_error(dec, full), late=late, per_pos=per_pos,
                agree=agree)


def lm_engine(cfg, params, gen, device):
    """16 requests through ContinuousBatchingEngine(num_slots=8); then
    request 0 (admitted at the first tick with 7 others) served alone."""
    import numpy as np
    import torch
    from repro_torch.runtime import ContinuousBatchingEngine
    lo, hi = ENGINE["prompt"]
    lens = torch.randint(lo, hi + 1, (ENGINE["requests"],), generator=gen,
                         device=device).tolist()
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                             device=device).cpu().numpy().astype(np.int32)
               for n in lens]
    eng = ContinuousBatchingEngine(cfg, params,
                                   num_slots=ENGINE["num_slots"],
                                   max_len=ENGINE["max_len"])
    for p in prompts:
        eng.submit(p, max_new_tokens=ENGINE["new_tokens"])
    sync(device)
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    sync(device)
    wall = time.perf_counter() - t0
    alone = ContinuousBatchingEngine(cfg, params,
                                     num_slots=ENGINE["num_slots"],
                                     max_len=ENGINE["max_len"])
    alone.submit(prompts[0], max_new_tokens=ENGINE["new_tokens"])
    alone_tokens = alone.run_until_drained()[0].generated
    together = [r for r in done if r.uid == 0][0].generated
    return dict(done=len(done), complete=all(
        r.state == "done" and len(r.generated) == ENGINE["new_tokens"]
        for r in done), same=alone_tokens == together, wall=wall,
        steps=eng.metrics["steps"], tokens=eng.metrics["tokens"],
        occupancy=eng.occupancy, prompt_lens=lens)


def lm_launcher(arch, seed, device):
    """The LM launcher's main() at batch 4, prompt 16, gen 16."""
    from repro_torch.launch import serve
    return serve.main(["--arch", arch, "--batch", "4", "--prompt-len", "16",
                       "--gen", "16", "--seed", str(seed), "--device",
                       str(device)])


def prefill_time(cfg, params, tokens, use_kernel, reps=3):
    """Median host-clock seconds of one prefill step, synchronised."""
    from repro_torch.runtime import make_prefill_step
    step = make_prefill_step(cfg, use_kernel=use_kernel)
    times = []
    for _ in range(reps):
        sync(tokens.device)
        t0 = time.perf_counter()
        step(params, tokens)
        sync(tokens.device)
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


# kernel-name fragments of the prefill's matrix products (cuBLAS / CUTLASS)
GEMM_NAMES = ("gemm", "nvjet", "cutlass", "xmma", "cublas")


def prefill_profile(cfg, params, tokens):
    """One kernel prefill step under ``torch.profiler``: the device time of
    the port's kernels (by name), of the matrix products and of everything
    else, the device busy share of the step's host-clock time, and the
    largest other kernels.  None when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime import make_prefill_step
    step = make_prefill_step(cfg, use_kernel=True)
    step(params, tokens)
    sync(tokens.device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, tokens)
        sync(tokens.device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kind, others = {"port kernels": 0.0, "matrix products": 0.0,
                       "other": 0.0}, {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:     # host-side ops and calls
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        name = ev.key
        if "fa_forward" in name or "wkv6_forward" in name:
            by_kind["port kernels"] += us / 1e3
            others[name] = others.get(name, 0.0) + us / 1e3
        elif any(g in name.lower() for g in GEMM_NAMES):
            by_kind["matrix products"] += us / 1e3
        else:
            by_kind["other"] += us / 1e3
            others[name] = others.get(name, 0.0) + us / 1e3
    busy = sum(by_kind.values())
    if busy == 0:
        return None
    top = sorted(others.items(), key=lambda kv: -kv[1])[:4]
    return dict(wall_ms=wall_ms, busy_ms=busy, by_kind=by_kind, top=top)


def say_profile(prof):
    if prof is None:
        return "device time not measured (the profiler saw none)"
    share = prof["busy_ms"] / prof["wall_ms"] * 100
    return (f"profiled step {prof['wall_ms']:.2f} ms, device busy "
            f"{prof['busy_ms']:.2f} ms ({share:.1f} %): " + ", ".join(
                f"{k} {v:.2f} ms" for k, v in prof["by_kind"].items())
            + "; largest: " + ", ".join(
                f"{k[:60]} {v:.2f} ms" for k, v in prof["top"]))


def free(device):
    if device.type == "cuda":
        import torch
        torch.cuda.empty_cache()


def phase_lm(device, gen, arch, seed, ops, op_name, plain_op):
    """One full-size model.  In float32 (the algorithm at full size): the
    kernel prefill against the plain prefill, the controls, decode against
    prefill.  In the config's bfloat16 (the served type, the main path):
    the kernel prefill with its launches counted, against the plain
    prefill and against the floor (the op's plain version in place of the
    kernel), decode against prefill, the engine, the launcher, times."""
    import dataclasses
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch import configs
    from repro_torch.models import init_params
    cfg = configs.get(arch)
    B, S = LM_PREFILL
    Bd, Sd = LM_DECODE
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=device)

    controls = {"zeroed output": zeroed, "swapped axes": swapped}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(cfg32, gen, device=device)
    f32 = lm_prefill_checks(cfg32, params, tokens, ops, op_name, controls)
    f32["dec"] = lm_decode_vs_prefill(cfg32, params, tokens[:Bd, :Sd])
    del params
    free(device)
    # the decode witness: the same check at full width and cut depth, on
    # parameters of its own generator (so the later draws stay as they were)
    f32["dec_depth"] = {}
    for depth in LM_DECODE_DEPTHS:
        cut = dataclasses.replace(cfg32, num_layers=depth)
        params = init_params(cut, torch.Generator(device=device).manual_seed(
            seed + depth), device=device)
        f32["dec_depth"][depth] = lm_decode_vs_prefill(
            cut, params, tokens[:Bd, :Sd])
        del params
        free(device)

    t0 = time.perf_counter()
    params = init_params(cfg, gen, device=device)
    sync(device)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in pytree.tree_leaves(params))
    bf16 = lm_prefill_checks(cfg, params, tokens, ops, op_name,
                             {"plain op": lambda real: plain_op, **controls})
    bf16["dec"] = lm_decode_vs_prefill(cfg, params, tokens[:Bd, :Sd])
    engine = lm_engine(cfg, params, gen, device)
    times = dict(kernel_s=prefill_time(cfg, params, tokens, True),
                 plain_s=prefill_time(cfg, params, tokens, False),
                 profile=prefill_profile(cfg, params, tokens))
    del params, tokens
    free(device)
    launcher = lm_launcher(arch, seed, device)
    del launcher["logits"]
    free(device)
    return dict(cfg=cfg, n_params=n_params, init_s=init_s, f32=f32,
                bf16=bf16, engine=engine, launcher=launcher, **times)


def check_lm(res, name, want_launches, tag, want_routes=None):
    """The hard checks of phases 14 and 15.  ``want_routes`` maps a dtype
    name to the one route all of that prefill's launches must take."""
    f32, bf16, arch = res["f32"], res["bf16"], res["cfg"].name
    limit = LM_RTOL[arch]
    for kind, r in (("float32", f32), ("bfloat16", bf16)):
        check(r["launches"] == want_launches,
              f"phase {tag}: {r['launches']} {name} launches in one "
              f"{kind} prefill step, expected {want_launches}")
        if want_routes:
            want = {route: want_launches if route == want_routes[kind] else 0
                    for route in r["routes"]}
            check(r["routes"] == want, f"phase {tag}: {name} launches by "
                  f"route in one {kind} prefill step {r['routes']}, "
                  f"expected {want}")
        check(r["finite"] and r["shape_ok"], f"phase {tag}: {kind} prefill "
              "logits not finite or of the wrong shape")
        for control in ("zeroed output", "swapped axes"):
            e = r["others"][control][0]
            check(e > limit, f"phase {tag}: a {kind} prefill with {control} "
                  f"is within {limit} of the plain one ({e:.3e})")
    check(f32["err"][0] <= LM_F32_RTOL,
          f"phase {tag}: float32 kernel prefill vs plain ‖Δ‖/‖ref‖ = "
          f"{f32['err'][0]:.3e} > {LM_F32_RTOL}")
    dec = f32["dec"]["err"][0]
    check(dec <= LM_DECODE_RTOL[arch], f"phase {tag}: float32 decode vs "
          f"prefill ‖Δ‖/‖ref‖ = {dec:.3e} > {LM_DECODE_RTOL[arch]}")
    for depth, d in f32["dec_depth"].items():
        check(d["err"][0] <= LM_DECODE_SHALLOW_RTOL,
              f"phase {tag}: float32 decode vs prefill at {depth} layers "
              f"‖Δ‖/‖ref‖ = {d['err'][0]:.3e} > {LM_DECODE_SHALLOW_RTOL}")
    check(bf16["err"][0] <= limit,
          f"phase {tag}: bfloat16 kernel prefill vs plain ‖Δ‖/‖ref‖ = "
          f"{bf16['err'][0]:.3e} > {limit}")
    e = res["engine"]
    check(e["done"] == ENGINE["requests"] and e["complete"],
          f"phase {tag}: the engine finished {e['done']} of "
          f"{ENGINE['requests']} requests")
    check(e["same"], f"phase {tag}: a request served alone differs from the "
          "same request served with others")
    check(res["launcher"]["tokens"].shape == (4, 16),
          f"phase {tag}: the launcher returned tokens of shape "
          f"{tuple(res['launcher']['tokens'].shape)}")


def say_decode(d):
    """One decode-vs-prefill reading: all, later half, the first four
    positions, the largest of each quarter, argmax agreement."""
    pos, q = d["per_pos"], max(1, len(d["per_pos"]) // 4)
    return (f"{d['err'][0]:.3e} (later half {d['late']:.3e}; positions 0-3 "
            + " ".join(f"{e:.2e}" for e in pos[:4]) + "; max per quarter "
            + " ".join(f"{max(pos[i:i + q]):.2e}"
                       for i in range(0, len(pos), q))
            + f"; argmax agreement {d['agree']:.4f})")


def say_lm(res, tag, name):
    e, cfg, f32, bf16 = res["engine"], res["cfg"], res["f32"], res["bf16"]
    limit = LM_RTOL[cfg.name]
    say(tag, f"{cfg.name} ({cfg.num_layers} layers, d={cfg.d_model}, "
        f"vocab={cfg.vocab_size}, {res['n_params']:,} parameters, bfloat16 "
        f"drawn in {res['init_s']:.2f} s), prefill {LM_PREFILL}, "
        f"‖Δ‖/‖ref‖ of logits | float32: {name} launches="
        f"{f32['launches']} {f32['routes'] or ''}, kernel vs plain "
        f"{f32['err'][0]:.3e} (max|Δ| "
        f"{f32['err'][1]:.3e}, limit {LM_F32_RTOL}), controls " + ", ".join(
            f"{k} {v[0]:.3e}" for k, v in f32["others"].items())
        + f" (must exceed {limit}); decode vs prefill {LM_DECODE} "
        + say_decode(f32["dec"]) + f", limit {LM_DECODE_RTOL[cfg.name]}; "
        "at full width and cut depth: " + ", ".join(
            f"{depth} layers {say_decode(d)}"
            for depth, d in f32["dec_depth"].items())
        + f", limit {LM_DECODE_SHALLOW_RTOL}"
        f" | bfloat16: launches={bf16['launches']} {bf16['routes'] or ''}, "
        f"kernel vs plain "
        f"{bf16['err'][0]:.3e} (max|Δ| {bf16['err'][1]:.3e}, limit {limit})"
        f"; the op's plain version in the kernel's place vs plain "
        f"{bf16['others']['plain op'][0]:.3e} and vs the kernel prefill "
        f"{bf16['others']['plain op'][1]:.3e}; controls " + ", ".join(
            f"{k} {v[0]:.3e}" for k, v in bf16["others"].items()
            if k != "plain op")
        + f" (must exceed {limit}); decode vs prefill "
        + say_decode(bf16["dec"]) + " not gated"
        f" | launcher batch 4 prompt 16 "
        f"gen 16: tokens[0,:8]={res['launcher']['tokens'][0, :8].tolist()}"
        f" | engine: {e['done']}/{ENGINE['requests']} requests complete in "
        f"{e['steps']} steps, occupancy {e['occupancy']:.3f}, alone == "
        f"together: {e['same']}")


def flash_times(device, gen):
    """At the prefill shape (bfloat16, causal), by CUDA events in one call
    and in turns (tc, simt, SDPA, tc): the tensor-core kernel, the CUDA-core
    kernel's bf16 instantiation and ``F.scaled_dot_product_attention``
    (yardstick only); then the plain version, and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel, ref
    B, S, H, D = 4, 2048, 20, 128
    q, k, v = (torch.randn(B, S, H, D, generator=gen, device=device)
               .to(torch.bfloat16) for _ in range(3))
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    tc = [cuda_time_ms(lambda: kernel.launch(q, k, v, True, "tc"), reps=20)]
    simt_ms = cuda_time_ms(lambda: kernel.launch(q, k, v, True, "simt"),
                           reps=5)
    library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), reps=20)
    tc.append(cuda_time_ms(lambda: kernel.launch(q, k, v, True, "tc"),
                           reps=20))
    plain_ms = cuda_time_ms(
        lambda: ref.attention_ref(q, k, v, True), reps=3)
    flops = 2 * 2 * B * H * D * (S * (S + 1) // 2)   # QKᵀ and PV, causal
    nbytes = 2 * 4 * B * S * H * D                   # q, k, v read, o written
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / BF16_FLOPS * 1e3
    ms = sum(tc) / len(tc)
    return dict(ms=ms, tc_ms=tc, simt_ms=simt_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=max(t_bytes, t_flops),
                bound_by="bytes" if t_bytes >= t_flops else "operations",
                t_bytes=t_bytes, t_flops=t_flops, gflop=flops / 1e9,
                tflops={name: flops / t / 1e9 for name, t in (
                    ("tc", ms), ("simt", simt_ms), ("sdpa", library_ms),
                    ("plain", plain_ms))})


def wkv_times(device, gen, previous=None):
    """WKV kernel, plain scan and wkv_chunked at (4, 2048, 40, 64) with
    bfloat16 r/k/v and float32 w, and the bound; with ``previous`` (the
    earlier design's library, see ``--previous``) that kernel too, in
    turns (earlier, kernel, kernel, earlier), and its largest differences
    from the kernel (output, final state)."""
    import torch
    from repro_torch.kernels.rwkv_wkv import kernel, ref
    from repro_torch.models.rwkv import wkv_chunked
    B, T, H, N = 4, 2048, 40, 64
    r, k, v, w, u, _ = wkv_inputs(device, gen, B, T, H, torch.bfloat16)
    earlier, earlier_diff = None, None
    o_prev = torch.empty_like(r)
    s_prev = torch.empty(B, H, N, N, device=device)
    if previous is not None:       # the same C interface as the kernel's
        fn = earlier_function(previous.lib, "rwkv_wkv_bf16",
                              [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                              + [ctypes.c_void_p])

        def earlier():
            fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
               u.data_ptr(), None, o_prev.data_ptr(), s_prev.data_ptr(), B,
               T, H, torch.cuda.current_stream().cuda_stream)
    kernel_ms, earlier_ms = in_turns(lambda: kernel.launch(r, k, v, w, u),
                                     earlier, 10)
    if earlier is not None:
        o_new, s_new = kernel.launch(r, k, v, w, u)
        earlier_diff = (float((o_new.float() - o_prev.float()).abs().max()),
                        float((s_new - s_prev).abs().max()))
    plain_ms = cuda_time_ms(lambda: ref.wkv_scan_ref(r, k, v, w, u), reps=1)
    chunked_ms = cuda_time_ms(lambda: wkv_chunked(r, k, v, w, u), reps=3)
    n = B * T * H * N
    # r, k, v (bf16) and w (f32) read, o (bf16) and the final state written
    nbytes = n * (3 * 2 + 4 + 2) + B * H * N * N * 4
    flops = 5 * N * N * B * T * H      # 2N² for o, 3N² for S a (b, h, t)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / FP32_FLOPS * 1e3
    return dict(timing(kernel_ms, earlier_ms, earlier_diff),
                plain_ms=plain_ms, chunked_ms=chunked_ms,
                bound_ms=max(t_bytes, t_flops),
                bound_by="bytes" if t_bytes >= t_flops else "operations",
                t_bytes=t_bytes, t_flops=t_flops, mb=nbytes / 1e6,
                gflop=flops / 1e9)


def previous_line(t):
    """The earlier design's times and difference, for phases 11 and 16."""
    if t["previous_ms"] is None:
        return "earlier design not measured (no --previous)"
    diff = t["previous_diff"]
    diff = diff if isinstance(diff, tuple) else (diff,)
    return (f"earlier design (--previous) " + " / ".join(
        f"{ms:.4f}" for ms in t["previous_turns"]) + " ms in turns ("
        f"{t['previous_ms'] / t['ms']:.2f}x the kernel's time), max |Δ| "
        "from the kernel " + " / ".join(f"{e:.2e}" for e in diff))


# ---------------------------------------------------------------------------
# phases 17-20: the rest of the single-device implicit-diff core
# ---------------------------------------------------------------------------

def rel_rows(a, b):
    """Per row (per entry of a 1-D batch): ‖a_i − b_i‖/‖b_i‖, in float64."""
    import torch
    a, b = a.detach().double(), b.detach().double()
    if a.ndim == 1:
        a, b = a[:, None], b[:, None]
    return torch.linalg.vector_norm(a - b, dim=-1) / \
        torch.linalg.vector_norm(b, dim=-1)


def timed(device, fn):
    """``(fn(), seconds)``, the device drained before and after."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def phase_vmap_hypergrad(device, gen, B, d, m):
    """Phase 17: B ridge hypergradients under ``torch.func.vmap`` — (a) of
    ``grad``, (b) of ``jvp`` in θ, (c) ``GradientDescent.run()`` — against
    a Python loop over the instances and the float64 closed form."""
    import torch
    import torch.func
    from repro_torch.core import GradientDescent, custom_root
    f32 = torch.float32
    _, _, X, theta = ridge_batch(gen, B, d, m, f32, device)
    y = torch.randn(B, m, generator=gen, device=device, dtype=f32)
    eye = torch.eye(d, device=device, dtype=f32)

    def F(x, X, y, t):
        return X.T @ (X @ x - y) / m + t * x

    @custom_root(F, solve="pallas_cg", tol=HYPERGRAD_TOL)
    def ridge(init, X, y, t):
        return torch.linalg.solve(X.T @ X / m + t * eye, X.T @ y / m)

    def grad_theta(X, y, t):                 # (a) d(Σx*²)/dθ
        return torch.func.grad(
            lambda tt: (ridge(None, X, y, tt) ** 2).sum())(t)

    def tangent(X, y, t):                    # (b) dx*/dθ
        return torch.func.jvp(lambda tt: ridge(None, X, y, tt), (t,),
                              (torch.ones_like(t),))[1]

    # float64 closed form: dx*/dθ = −A⁻¹x*, d(Σx*²)/dθ = −2 x*ᵀA⁻¹x*
    Xd = X.double()
    A = Xd.transpose(1, 2) @ Xd / m + theta.double()[:, None, None] * \
        torch.eye(d, device=device, dtype=torch.float64)
    xs = torch.linalg.solve(A, (Xd.transpose(1, 2) @ y.double()[..., None])
                            [..., 0] / m)
    dxs = -torch.linalg.solve(A, xs)
    want = {"grad": 2 * (xs * dxs).sum(-1), "jvp": dxs}
    del A, Xd

    res = {}
    cg_counts(reset=True)
    timed(device, lambda: torch.func.vmap(
        lambda X, y, t: ridge(None, X, y, t))(X, y, theta))
    res["fwd_launches"] = cg_counts()[0]
    for name, fn in (("grad", grad_theta), ("jvp", tangent)):
        torch.func.vmap(fn)(X, y, theta)             # warm-up, not counted
        cg_counts(reset=True)
        got, s_b = timed(device, lambda: torch.func.vmap(fn)(X, y, theta))
        launches, by_layout = cg_counts()
        cg_counts(reset=True)
        loop, s_l = timed(device, lambda: torch.stack(
            [fn(X[i], y[i], theta[i]) for i in range(B)]))
        res[name] = dict(
            launches=launches, by_layout=by_layout,
            loop_launches=cg_counts()[0], batched_s=s_b, loop_s=s_l,
            vs_loop=float(rel_rows(got, loop).max()),
            vs_closed=float(rel_rows(got, want[name]).max()),
            # controls: the same checks against the loop's values shifted
            # by one instance must fail
            control_loop=float(rel_rows(got, loop.roll(1, 0)).max()),
            control_closed=float(rel_rows(got, want[name].roll(1, 0))
                                 .max()))

    # (c) a batch axis over run(): fixed step 1/L, one masked loop
    def f(x, X, y, t):
        return 0.5 * ((X @ x - y) ** 2).sum() / m + 0.5 * t * (x ** 2).sum()

    L = float(torch.linalg.eigvalsh(X.transpose(1, 2) @ X / m).max()) + \
        float(theta.max())
    gd = GradientDescent(f, stepsize=1.0 / L, maxiter=5000, tol=RUN_TOL,
                         solve="pallas_cg", linsolve_tol=HYPERGRAD_TOL)
    x0 = torch.zeros(d, device=device, dtype=f32)

    def run(X, y, t):
        x, info = gd.run(x0, X, y, t)
        return x, info.iterations, info.converged

    (_, its, conv), s_b = timed(device, lambda: torch.func.vmap(run)(
        X, y, theta))
    loop, s_l = timed(device, lambda: [run(X[i], y[i], theta[i])
                                       for i in range(B)])
    loop_its = torch.stack([r[1] for r in loop])
    cg_counts(reset=True)
    g_run, s_g = timed(device, lambda: torch.func.vmap(torch.func.grad(
        lambda X, y, t: (gd.run(x0, X, y, t)[0] ** 2).sum(), argnums=2))(
        X, y, theta))
    launches, by_layout = cg_counts()
    res["run"] = dict(
        its=its.tolist(), loop_its=loop_its.tolist(),
        converged=bool(conv.all()),
        its_diff=int((its - loop_its).abs().max()), batched_s=s_b,
        loop_s=s_l, grad_s=s_g, launches=launches, by_layout=by_layout,
        grad_vs_closed=float(rel_rows(g_run, want["grad"]).max()))
    return res


def deq_cell(z, x, w):
    """``examples/deq_block.py``'s cell, the norm taken per token."""
    import torch
    h = torch.tanh(z @ w["w1"]) @ w["w2"]
    out = x + 0.5 * h
    return out / (1.0 + 0.1 * torch.linalg.vector_norm(out, dim=-1,
                                                        keepdim=True))


def flat64(tree):
    import torch
    return torch.cat([tree[k].detach().double().reshape(-1)
                      for k in sorted(tree)])


def cosine(a, b) -> float:
    import torch
    return float(a @ b / (torch.linalg.vector_norm(a)
                          * torch.linalg.vector_norm(b)))


def phase_deq(device, gen, d, d_ff, tokens, unroll_tokens, depth, scale):
    """Phase 18: the DEQ block at full width — the forward, the gradient
    of Σz*² in the weights for each backward solver and approximate mode,
    and the implicit gradient against an unrolled backprop."""
    import torch
    import torch.func
    from repro_torch import observability as obs
    from repro_torch.core import (ImplicitDiffSpec, deq_fixed_point,
                                  make_deq_solver)
    f32 = torch.float32
    w = {"w1": torch.randn(d, d_ff, generator=gen, device=device,
                           dtype=f32) * (scale / math.sqrt(d)),
         "w2": torch.randn(d_ff, d, generator=gen, device=device,
                           dtype=f32) * (scale / math.sqrt(d_ff))}
    x = torch.randn(tokens, d, generator=gen, device=device, dtype=f32)

    def fwd(n):      # the forward tolerance scales with √(tokens)
        return dict(fwd_iters=DEQ_FWD["fwd_iters"],
                    fwd_tol=DEQ_FWD["fwd_tol"] * math.sqrt(n / DEQ["tokens"]))

    solver = make_deq_solver(deq_cell, **fwd(tokens))
    (z, info), fwd_s = timed(device, lambda: solver.run(
        torch.zeros_like(x), x, w))
    # contraction factor of the cell at z*: power iteration on its Jacobian
    v = torch.randn(z.shape, generator=gen, device=device, dtype=f32)
    for _ in range(20):
        jv = torch.func.jvp(lambda zz: deq_cell(zz, x, w), (z,), (v,))[1]
        rho = float(torch.linalg.vector_norm(jv)
                    / torch.linalg.vector_norm(v))
        v = jv / torch.linalg.vector_norm(jv)
    del v, jv

    def grad_of(n, **kw):
        """d(Σz*²)/dw at the first n tokens, seconds, the backward's
        ``backward_done`` values (iterations or matvec budget)."""
        xs = x[:n]

        def loss(w):
            return (deq_fixed_point(deq_cell, torch.zeros_like(xs), xs, w,
                                    **fwd(n), **kw) ** 2).sum()

        obs.clear_recorded()
        with obs.observe(True, record=True):
            g, secs = timed(device, lambda: flat64(torch.func.grad(loss)(w)))
        done = [e.values for e in obs.recorded() if e.kind == "backward_done"]
        obs.clear_recorded()
        return g, secs, done[-1]

    exact, ref = {}, None
    for solve in ("normal_cg", "neumann", "gmres", "bicgstab"):
        g, secs, done = grad_of(tokens, diff_spec=ImplicitDiffSpec(
            solve=solve, **DEQ_LINSOLVE))
        ref = g if ref is None else ref
        exact[solve] = dict(s=secs, iterations=int(done["iterations"]),
                            converged=bool(done["converged"]),
                            rel=rel(g, ref))
    approx = {}
    for mode, k in (("neumann_k", 8), ("one_step", 1), ("jacobian_free", 1)):
        g, secs, done = grad_of(tokens, backward=mode, backward_iters=k)
        est = make_deq_solver(deq_cell, **fwd(tokens), backward=mode,
                              backward_iters=k).estimate_hypergrad_error(
            z, x, w, cotangent=2 * z)
        approx[mode] = dict(s=secs, matvecs=int(done["iterations"]),
                            est=float(est), cos=cosine(g, ref),
                            rel=rel(g, ref))
    del ref, g
    free(device)

    xu = x[:unroll_tokens]

    def loss_unrolled(w):
        zu = torch.zeros_like(xu)
        for _ in range(depth):
            zu = deq_cell(zu, xu, w)
        return (zu ** 2).sum()

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    gu, unroll_s = timed(device, lambda: flat64(
        torch.func.grad(loss_unrolled)(w)))
    peak = torch.cuda.max_memory_allocated() / 1e9 \
        if device.type == "cuda" else None
    gi, implicit_s, _ = grad_of(unroll_tokens, diff_spec=ImplicitDiffSpec(
        solve="normal_cg", **DEQ_LINSOLVE))
    gj, _, _ = grad_of(unroll_tokens, backward="jacobian_free")
    out = dict(fwd_iters=int(info.iterations), fwd_error=float(info.error),
               fwd_tol=fwd(tokens)["fwd_tol"], converged=bool(info.converged),
               fwd_s=fwd_s, rho=rho, exact=exact, approx=approx,
               unroll=dict(rel=rel(gi, gu), control=rel(gj, gu), s=unroll_s,
                           implicit_s=implicit_s, peak_gb=peak))
    del gu, gi, gj, x, z, w
    free(device)
    return out


def poly(depth, A, V):
    """The approximate modes' polynomial Σ_{j≤depth} (I − A)ʲ v on the rows
    of V (A symmetric): depth 0 jacobian_free, 1 one_step, k neumann_k."""
    U = V
    for _ in range(depth):
        U = U + (V - U @ A.T)
    return U


def phase_approx_service(device, gen, d, rhos, n, k):
    """Phase 19: the solve service's approximate arm — n hypergradient
    requests per (ρ, mode) on A = I − ρS, ‖S‖₂ = 1, against float64."""
    import torch
    from repro_torch.core import root_vjp
    from repro_torch.runtime import SolveService
    f32, f64 = torch.float32, torch.float64
    S = torch.randn(d, d, generator=gen, device=device, dtype=f64)
    S = (S + S.T) / 2
    S = S / torch.linalg.matrix_norm(S, ord=2)
    theta = torch.randn(n, d, generator=gen, device=device, dtype=f32)
    v = torch.randn(n, d, generator=gen, device=device, dtype=f32)
    systems = {}
    for rho in rhos:
        A64 = torch.eye(d, device=device, dtype=f64) - rho * S
        A = A64.to(f32)
        systems[rho] = (A64, A, torch.linalg.solve(A, theta.T).T)

    def F_of(A):
        return lambda x, t: t - A @ x

    depth = {"one_step": 1, "neumann_k": k, "jacobian_free": 0}
    svc = SolveService(device=device, max_batch=n)   # warm-start cache on

    def submit(rho, mode):
        _, A, x_star = systems[rho]
        kw = dict(solve="pallas_cg", tol=HYPERGRAD_TOL) if mode == "exact" \
            else dict(backward=mode, backward_iters=k)
        return [svc.submit_hypergrad(F_of(A), x_star[i], (theta[i],), v[i],
                                     **kw) for i in range(n)]

    cg_counts(reset=True)
    futs = {(rho, "exact"): submit(rho, "exact") for rho in rhos}
    _, exact_s = timed(device, svc.flush)
    launches, by_layout = cg_counts()
    cache_exact = len(svc.cache)
    futs.update({(rho, mode): submit(rho, mode) for rho in rhos
                 for mode in depth})
    _, approx_s = timed(device, svc.flush)
    res = dict(launches=launches, by_layout=by_layout, exact_s=exact_s,
               approx_s=approx_s, cache_exact=cache_exact,
               cache_after=len(svc.cache),
               routes=sorted({f"{key.solver}/{key.backward}"
                              for key, _ in svc._compiled}), rows={})
    v64 = v.double()
    for (rho, mode), fs in futs.items():
        A64, A, x_star = systems[rho]
        results = [f.result() for f in fs]
        u = torch.stack([r.x[0] for r in results]).double()   # θ̄ = u
        row = dict(iterations=sorted({r.info.iterations for r in results}))
        if mode == "exact":
            want = torch.stack([root_vjp(F_of(A), x_star[i], (theta[i],),
                                         v[i], solve="lu")[0]
                                for i in range(n)])
            row["err"] = float(rel_rows(u, want).max())
        else:
            dp = depth[mode]
            row["err"] = float(rel_rows(u, poly(dp, A64, v64)).max())
            # control: the polynomial one term off
            row["control"] = float(rel_rows(u, poly(
                dp + 1 if dp == 0 else dp - 1, A64, v64)).max())
            est = torch.tensor([r.info.hypergrad_error_estimate
                                for r in results], dtype=f64)
            est_ref = rel_rows(u @ A64.T, v64)          # ‖v − Aᵀu‖/‖v‖
            row["est"] = est
            row["est_err"] = float(((est - est_ref.cpu()).abs()
                                    / est_ref.cpu()).max())
            row["est_control"] = float(((est - rel_rows(
                u.roll(1, 0) @ A64.T, v64).cpu()).abs()
                / est_ref.cpu()).max())
        res["rows"][(rho, mode)] = row
    return res


def phase_solvers(device, gen, B, d):
    """Phase 20: bicgstab, gmres, neumann, block-Jacobi cg on a
    BlockDiagonal, and the ComposedOperator / RaveledOperator matvecs."""
    import torch
    from repro_torch.core import (BlockDiagonal, ComposedOperator,
                                  DenseOperator, JacobianOperator,
                                  route_solve)
    f32 = torch.float32
    eye = torch.eye(d, device=device, dtype=f32)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device, dtype=f32)

    general = eye + 0.5 * randn(B, d, d) / math.sqrt(d)
    M = randn(B, d, d)
    M = M / torch.linalg.matrix_norm(M, ord=2)[:, None, None]
    contractive = eye - 0.5 * M
    b = randn(B, d)
    out = {}
    for solver, A in (("bicgstab", general), ("gmres", general),
                      ("neumann", contractive)):
        op = DenseOperator(A, symmetric=False)
        (x, info), secs = timed(device, lambda: route_solve(
            solver, op, b, tol=SOLVERS_TOL, return_info=True))
        Ad = A.double()
        mv = lambda xx: torch.einsum("bij,bj->bi", Ad, xx.double())
        out[solver] = dict(its=info.iterations.tolist(),
                           converged=bool(info.converged.all()),
                           reported=float((info.residual / torch.linalg
                                           .vector_norm(b, dim=-1)).max()),
                           resid=float(rel_rows(mv(x), b).max()),
                           control=float(rel_rows(mv(x.roll(1, 0)), b).max()),
                           s=secs)
    # cg + block_jacobi on 8 SPD blocks of 64: one iteration
    blocks = []
    for _ in range(8):
        G = randn(B, 64, 64)
        blocks.append(DenseOperator(G @ G.transpose(1, 2) / 64
                                    + torch.eye(64, device=device, dtype=f32),
                                    positive_definite=True))
    bd = BlockDiagonal(blocks)
    rhs = tuple(randn(B, 64) for _ in blocks)
    (xb, info), secs = timed(device, lambda: route_solve(
        "cg", bd, rhs, tol=SOLVERS_TOL, precond="block_jacobi",
        return_info=True))
    flat = lambda t: torch.cat(list(t), dim=-1)
    out["block_jacobi"] = dict(
        its=info.iterations.tolist(), converged=bool(info.converged.all()),
        reported=float((info.residual / torch.linalg.vector_norm(
            flat(rhs), dim=-1)).max()),
        resid=float(rel_rows(flat(bd.matvec(xb)), flat(rhs)).max()),
        control=float(rel_rows(flat(bd.matvec(tuple(
            t.roll(1, 0) for t in xb))), flat(rhs)).max()), s=secs)
    # operator matvecs against their materialized matrices
    comp = ComposedOperator(DenseOperator(randn(B, d, d) / math.sqrt(d)),
                            DenseOperator(randn(B, d, d) / math.sqrt(d)))
    vb = randn(B, d)
    dense = comp.materialize()
    want = torch.einsum("bij,bj->bi", dense, vb)
    Wa, Wb = randn(d, d) / math.sqrt(d), randn(d, d) / math.sqrt(d)
    half = d // 2

    def tree_map_(t):
        return {"a": torch.tanh(t["a"] @ Wa[:half, :half]
                                + t["b"] @ Wb[half:, :half]),
                "b": torch.sin(t["b"] @ Wb[:half, half:]) + t["a"]}

    raveled = JacobianOperator(tree_map_, {"a": randn(half),
                                           "b": randn(half)}).raveled()
    vf = randn(d)
    out["matvec"] = dict(
        composed=float(rel_rows(comp.matvec(vb), want).max()),
        composed_control=float(rel_rows(comp.T.matvec(vb), want).max()),
        raveled=rel(raveled.matvec(vf), raveled.materialize() @ vf),
        raveled_control=rel(raveled.rmatvec(vf),
                            raveled.materialize() @ vf))
    return out


# ---------------------------------------------------------------------------
# phases 21-23: the stochastic solvers and the analysis layer
# ---------------------------------------------------------------------------

COUNTING_SOLVER = "chip_smoke_counting_cg"


def counting_cg():
    """A registry CG that appends to the returned list on every call (the
    registry solves of a run, as ``tests/test_stochastic.py`` counts)."""
    from repro_torch.core import linear_solve as ls
    calls = []

    def solve(matvec, b, **kw):
        calls.append(kw.get("batch_ndim", 0))
        return ls.solve_cg(matvec, b, **kw)

    ls.register_solver(COUNTING_SOLVER, solve, symmetric_only=True,
                       supports_precond=True)
    return calls


def phase_stochastic(device, gen, seed, n, d, B, backward_batches,
                     backward_iters, vmap_lams):
    """Phase 21: ``benchmarks/stochastic_bilevel.py``'s Part A at data
    scale — per-feature-regularized ridge, the hypergradient in the d
    log-regularizers — one epoch of minibatch ``SGD`` against full-batch
    ``GradientDescent`` with the exact backward."""
    import dataclasses
    import torch
    import torch.func
    from repro_torch.core import GradientDescent, bilevel
    from repro_torch.core import linear_solve as ls
    from repro_torch.stochastic import SGD, MinibatchSampler, run_stochastic
    from repro_torch.stochastic.solvers import SGDState
    f32 = torch.float32

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device, dtype=f32)

    X = randn(n, d) / math.sqrt(d)
    w_true = randn(d)
    y = X @ w_true + 0.1 * randn(n)
    lam = torch.full((d,), -2.0, device=device, dtype=f32)
    w0 = torch.zeros(d, device=device, dtype=f32)

    def fun(w, batch, lam):
        Xb, yb = batch
        r = Xb @ w - yb
        return 0.5 * torch.mean(r ** 2) + \
            0.5 * torch.sum(torch.exp(lam) * w ** 2)

    def outer(w, lam):
        return 0.5 * torch.sum((w - w_true) ** 2)

    def hypergrad(solver):
        return torch.func.grad(lambda t: outer(solver.run(w0, t)[0], t))

    def backward_timed(solver):
        """The hypergradient by ``torch.autograd.grad``, and the seconds of
        its backward alone (the forward runs first, untimed)."""
        t = lam.clone().requires_grad_()
        loss = outer(solver.run(w0, t)[0], t)
        (g,), secs = timed(device, lambda: torch.autograd.grad(loss, t))
        return g, secs

    sampler = MinibatchSampler(data=(X, y), batch_size=B, seed=seed)
    half = sampler.num_batches // 2
    sgd = SGD(fun, sampler=sampler, stepsize=lambda k: 0.5 / (1.0 + 0.02 * k),
              epochs=1, averaging="polyak", average_from=half,
              backward_batches=backward_batches,
              backward_iters=backward_iters)
    res = dict(x_gib=X.numel() * X.element_size() / 2 ** 30,
               steps=sgd.num_steps())
    run_stochastic(sgd, w0, lam, steps=2)          # warm-up, not timed
    (w_bar, info), res["epoch_s"] = timed(
        device, lambda: run_stochastic(sgd, w0, lam))
    res["error"] = float(info.error)
    g_sgd, res["backward_s"] = backward_timed(sgd)
    ct = torch.func.grad(outer)(w_bar, lam)
    res["est"], res["est_s"] = timed(device, lambda: float(
        sgd.estimate_hypergrad_error(w_bar, lam, cotangent=ct)))

    full = GradientDescent(lambda w, t: fun(w, (X, y), t), stepsize=0.5,
                           maxiter=5000, tol=1e-6, solve="cg")
    (_, info_full), res["full_fwd_s"] = timed(device,
                                              lambda: full.run(w0, lam))
    res["full_iters"] = int(info_full.iterations)
    res["full_converged"] = bool(info_full.converged)
    g_full, res["full_bwd_s"] = backward_timed(full)
    res["cos"] = cosine(g_sgd.double(), g_full.double())
    perm = torch.randperm(d, generator=gen, device=device)
    res["cos_control"] = cosine(g_sgd.double(), g_full.double()[perm])

    # solve_bilevel's estimate for a stochastic solver under "exact"
    sol, res["bilevel_s"] = timed(device, lambda: bilevel.solve_bilevel(
        outer, dataclasses.replace(sgd, backward="exact"), lam, w0,
        outer_steps=2, outer_lr=1e-2))
    est = sol.inner_info.hypergrad_error_estimate
    res["bilevel_est"] = None if est is None else float(est)

    # restart: half an epoch, then the rest from its state and average
    w_mid, _ = run_stochastic(sgd, w0, lam, steps=half)
    w_tail, _ = run_stochastic(
        sgd, w_mid, lam, steps=sgd.num_steps() - half, start_step=half,
        init_state=SGDState(half, torch.tensor(math.inf, device=device)),
        init_average=w_mid)
    res["restart_equal"] = bool(torch.equal(w_tail, w_bar))

    # a batch of hypergradients in λ: ONE registry solve under vmap
    calls = counting_cg()
    try:
        exact = dataclasses.replace(sgd, backward="exact",
                                    solve=COUNTING_SOLVER, precond=None)
        lams = lam + 0.5 * randn(vmap_lams, d)
        f = hypergrad(exact)
        calls.clear()
        g_v, res["vmap_s"] = timed(device, lambda: torch.func.vmap(f)(lams))
        res["vmap_solves"] = list(calls)
        calls.clear()
        g_l, res["loop_s"] = timed(device, lambda: torch.stack(
            [f(t) for t in lams]))
        res["loop_solves"] = list(calls)
    finally:
        ls._REGISTRY.pop(COUNTING_SOLVER, None)
    res["vs_loop"] = float(rel_rows(g_v, g_l).max())
    res["vs_loop_control"] = float(rel_rows(g_v, g_l.roll(1, 0)).max())
    del X, y
    free(device)
    return res


def phase_autotune(device, gen, shapes, reps, replays):
    """Phase 22: ``measure_layout_schedule`` / ``choose_layout`` on the
    batched-CG kernel through a fresh tuning cache, the ``pallas_cg``
    solves that take its choice, the cache's file round trip and
    ``REPRO_AUTOTUNE_CACHE``, and ``measure_solver`` /
    ``predict_solve_seconds`` at (64, 512) float32."""
    import os
    import torch
    from repro_torch.analysis import autotune, roofline
    from repro_torch.core import linear_solve as ls
    from repro_torch.core.operators import DenseOperator
    from repro_torch.kernels.batched_cg import kernel, ref
    res = dict(shapes={}, launches=0, sweep_launches=0)
    cache = autotune.TuningCache()
    with autotune.use_cache(cache):
        for B, d, dt in shapes:
            dtype = getattr(torch, dt)
            A, b, _, _ = ridge_batch(gen, B, d, 2 * d, dtype, device)
            op = DenseOperator(A, positive_definite=True)
            tol = CG_TOL[dt]
            row = dict(rule=kernel.layout(d, dtype))
            cg_counts(reset=True)
            ls.solve(op, b, method="pallas_cg", tol=tol)
            sync(device)
            row["cold"] = cg_counts()[1]
            recs = autotune.measure_layout_schedule(
                B, d, dtype=dt, cache=cache, tol=tol, reps=reps,
                replays=replays, device=device)
            row["ms"] = {k: r.seconds * 1e3 for k, r in recs.items()}
            row["candidates"] = autotune.layout_candidates(d, dt)
            res["sweep_launches"] += len(recs) * (3 + reps * (1 + replays))
            row["argmin"] = min(recs, key=lambda k: recs[k].seconds)
            row["chosen"] = autotune.choose_layout(B, d, dtype)
            cg_counts(reset=True)
            x = ls.solve(op, b, method="pallas_cg", tol=tol)
            sync(device)
            row["tuned"] = cg_counts()[1]
            res["launches"] += 2
            row["err"] = rel(x, ref.batched_cg_ref(A, b, tol=tol,
                                                   maxiter=1000))
            res["shapes"][(B, d, dt)] = row
        # control: an entry whose layout does not fit d must raise
        bad = autotune.TuningCache()
        B, d, dt = shapes[0]
        bad.put(autotune.TuningKey("cuda", "batched_cg", B, d, dt, 1, "",
                                   "layout=C1"), 1e-9)
        A, b, _, _ = ridge_batch(gen, B, d, 2 * d, getattr(torch, dt),
                                 device)
        with autotune.use_cache(bad):
            try:
                ls.solve(DenseOperator(A, positive_definite=True), b,
                         method="pallas_cg")
                res["misfit"] = "no error"
            except ValueError as e:
                res["misfit"] = str(e)
        # the solvers' measured times and the predictions
        res["solvers"] = {}
        for solver in ("pallas_cg", "cg", "dense_gmres", "lu"):
            rec = autotune.measure_solver(solver, 64, 512, cache=cache,
                                          tol=1e-6, device=device)
            secs, source = autotune.predict_solve_seconds(solver, 64, 512)
            res["solvers"][solver] = dict(ms=rec.seconds * 1e3,
                                          predicted_ms=secs * 1e3,
                                          source=source)
        res["unmeasured"] = autotune.predict_solve_seconds("cg", 64, 256)
        res["roofline_ms"] = roofline.analyze_solve(64, 512).step_time_s \
            * 1e3
    # the cache's file, and a process that preloads it
    (ROOT / "build").mkdir(exist_ok=True)
    path = cache.save(ROOT / "build" / "autotune_phase22")
    res["round_trip"] = autotune.TuningCache.load(path).items() \
        == cache.items()
    B, d, dt = shapes[1]
    code = ("import sys; sys.path.insert(0, 'src'); import torch; "
            "from repro_torch.analysis import autotune as a; "
            f"print(len(a.default_cache()), a.choose_layout({B}, {d}, "
            f"torch.{dt}))")
    env = dict(os.environ, **{autotune.CACHE_ENV_VAR: path})
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    res["preloaded"] = out.stdout.split() or [out.stderr[-300:]]
    res["want_preloaded"] = [str(len(cache)),
                             res["shapes"][(B, d, dt)]["chosen"]]
    res["cache_entries"] = len(cache)
    return res


def dense_matrix_params(cfg) -> tuple:
    """(non-embedding parameters, LM head parameters) of a dense config,
    reckoned from its widths: attention with its biases, the MLP's
    matrices, two norms a layer and the final norm."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    attn = 2 * d * H * hd + 2 * d * Hkv * hd
    if cfg.qkv_bias:
        attn += (H + 2 * Hkv) * hd
    mlp = (3 if cfg.mlp_activation == "silu" else 2) * d * cfg.d_ff
    return cfg.num_layers * (attn + mlp + 2 * d) + d, d * cfg.vocab_size


def phase_census(device, seed, arch, prefill_s):
    """Phase 23: the operation census and the roofline of one kernel
    prefill step of ``arch`` (phase 16's (B, S) in bfloat16)."""
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch import configs
    from repro_torch.analysis import op_census, roofline
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import init_params
    from repro_torch.runtime import make_prefill_step
    cfg = configs.get(arch)
    gen = torch.Generator(device=device).manual_seed(seed + 23)
    params = init_params(cfg, gen, device=device)
    B, S = LM_PREFILL
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=device)
    step = make_prefill_step(cfg, use_kernel=True)
    step(params, tokens)
    before = fa_ops.LAUNCHES
    costs, census_s = timed(device, lambda: op_census.analyze_module(
        step, params, tokens))
    nonemb, head = dense_matrix_params(cfg)
    tree = (sum(t.numel() for t in pytree.tree_leaves(
        (params["blocks"], params["final_norm"]))),
        params["embed"]["unembed"].numel())
    T = B * S
    want = 2.0 * (nonemb + head) * T
    model_flops = roofline.model_flops_decode(nonemb + head, T)
    terms = roofline.analyze(costs.cost_dict(), 0.0, 1, model_flops)
    res = dict(flops=costs.flops, want=want, bytes=costs.hbm_bytes,
               rel=abs(costs.flops - want) / want,
               by_op=dict(costs.flops_by_op),
               custom_calls=dict(costs.custom_calls),
               launches=fa_ops.LAUNCHES - before, census_s=census_s,
               nonemb=nonemb, head=head, tree=tree, terms=terms,
               mfu=model_flops / (prefill_s * roofline.PEAK_FLOPS),
               prefill_ms=prefill_s * 1e3)
    # control: the census with its products left out
    left = costs.flops - max(costs.flops_by_op.values(), default=0.0)
    res["control"] = abs(left - want) / want
    del params, tokens
    free(device)
    return res


def zeroed(op):
    """A replacement of a kernel op whose attention / WKV output is 0."""
    def fn(*args, **kw):
        out = op(*args, **kw)
        if isinstance(out, tuple):
            return (out[0].zero_(),) + tuple(out[1:])
        return out.zero_()
    return fn


def swapped(op):
    """A replacement of a kernel op whose output has its sequence and head
    axes swapped (the layout fault of a transposed output)."""
    def fn(*args, **kw):
        out = op(*args, **kw)
        first = out[0] if isinstance(out, tuple) else out
        B, S, H, D = first.shape
        bad = first.transpose(1, 2).contiguous().reshape(B, S, H, D)
        return (bad,) + tuple(out[1:]) if isinstance(out, tuple) else bad
    return fn


# ---------------------------------------------------------------------------

def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of every random problem the run draws")
    ap.add_argument("--previous", type=Path, default=None,
                    help="an earlier checkout of the repository (e.g. "
                         "unpacked by git archive): its batched_cg, "
                         "simplex_proj and rwkv_wkv kernels are built and "
                         "timed in turns with this checkout's")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs the port on an NVIDIA GPU")
    if os.environ.get("REPRO_AUTOTUNE_CACHE"):
        fail("REPRO_AUTOTUNE_CACHE is set: phase 3 holds every launch to the "
             "kernel's rule, which only a cold tuning cache gives; unset it")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"{ROOT / 'src' / 'repro_torch'} not found: run chip_smoke.py "
             "from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(args.seed)

    # 1. card
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    card = smi.strip().splitlines()[0]
    say("1 card", f"{name}; devices={count}; nvidia-smi: {card}")

    # 2. build
    t0 = time.perf_counter()
    running = None if args.previous is None \
        else start_previous_build(args.previous.resolve())
    _build.build()
    previous = {} if running is None else load_previous(running)
    built_s = time.perf_counter() - t0
    for kname, source in (("batched_cg", f"{KERNEL_SOURCE} and "
                                         f"{STREAM_SOURCE}"),
                          ("simplex_proj", SIMPLEX_SOURCE),
                          ("flash_attention",
                           f"{FA_SOURCE} and {FA_SIMT_SOURCE}"),
                          ("rwkv_wkv", WKV_SOURCE)):
        ptx = ptxas_summary(_build.build_log(kname))
        say("2 build", f"{kname} from {source} (all four in {built_s:.1f} s,"
            f" 0 if cached): {ptx}")
    if previous:
        say("2 build", f"earlier batched_cg, simplex_proj and rwkv_wkv from "
            f"{args.previous}")

    # 3. kernel against plain
    from repro_torch.kernels.batched_cg import kernel as cg_kernel
    worst, err_main, layouts3 = phase_kernel_vs_plain(device, gen, CG_SHAPES)
    for key, took in layouts3.items():
        want = cg_kernel.layout(key[1], getattr(torch, key[2]))
        check(took == want, f"phase 3: batched_cg at {key} launched {took}, "
              f"the rule gives {want}")
    check(set(layouts3.values()) == set(cg_kernel.LAYOUTS),
          f"phase 3: the shapes took the layouts "
          f"{sorted(set(layouts3.values()))}, not every one of "
          f"{list(cg_kernel.LAYOUTS)}")
    say("3 kernel vs plain", "[layout] max rel err (x, dA, db) per shape: "
        + ", ".join(f"{B}x{d} {n} [{layouts3[(B, d, n)]}]={e:.2e}"
                    for (B, d, n), e in worst.items()))

    # 4. service, kernel arm
    s4 = phase_service_kernel_arm(device, gen, n_req=256, d=512, m=1024,
                                  max_batch=64)
    check(s4["dispatches"] == 4, f"phase 4: {s4['dispatches']} dispatches, "
          "expected 4 buckets of 64")
    check(s4["launches"] == 4, f"phase 4: {s4['launches']} kernel launches,"
          " expected 4")
    check(s4["by_layout"] == {MAIN_LAYOUT: 4}, f"phase 4: launches by "
          f"layout {s4['by_layout']}, expected all 4 on {MAIN_LAYOUT}")
    check(all(bool(r.info.converged) for r in s4["results"]),
          "phase 4: a request did not converge")
    check(float(s4["relres"].max()) <= SERVICE_TOL,
          f"phase 4: max |Ax-b|/|b| = {s4['relres'].max():.3e} > "
          f"{SERVICE_TOL}")
    say("4 service/kernel", f"256 requests d=512 float32 tol={SERVICE_TOL}: "
        f"dispatches={s4['dispatches']} launches={s4['launches']} "
        f"{s4['by_layout']} max |Ax-b|/|b|={s4['relres'].max():.3e}; all "
        "converged")

    # 5. service, hypergradient arm
    s5 = phase_hypergrad(device, gen, n_req=64, d=512, m=1024)
    check(s5["launches"] >= 1, "phase 5: the kernel was not launched")
    check(s5["by_layout"] == {MAIN_LAYOUT: s5["launches"]}, f"phase 5: "
          f"launches by layout {s5['by_layout']}, expected all on "
          f"{MAIN_LAYOUT}")
    check(s5["max_rel"] <= 1e-3, f"phase 5: hypergradient rel err "
          f"{s5['max_rel']:.3e} > 1e-3 against root_vjp(solve='lu')")
    say("5 service/hypergrad", f"64 submit_hypergrad d=512 pallas_cg: "
        f"dispatches={s5['dispatches']} launches={s5['launches']} "
        f"{s5['by_layout']} max rel err vs root_vjp(lu)={s5['max_rel']:.3e}")

    # 6. implicit diff
    s6 = phase_implicit_diff(device, gen, d=512, m=1024)
    check(s6["bwd"] >= 1, "phase 6: the backward did not launch the kernel")
    check(s6["fwd_layout"] == {MAIN_LAYOUT: s6["fwd"]} and s6["fwd"] >= 1
          and s6["bwd_layout"] == {MAIN_LAYOUT: s6["bwd"]},
          f"phase 6: launches by layout forward {s6['fwd_layout']}, "
          f"backward {s6['bwd_layout']}, expected all on {MAIN_LAYOUT}")
    check(max(s6["err_theta"], s6["err_y"], s6["err_x"]) <= 1e-3,
          f"phase 6: errors vs closed form {s6}")
    say("6 implicit diff", f"custom_root(pallas_cg) d=512: launches "
        f"forward={s6['fwd']} {s6['fwd_layout']} backward={s6['bwd']} "
        f"{s6['bwd_layout']} (the transposed load); rel err vs closed form "
        f"x*={s6['err_x']:.2e} dθ={s6['err_theta']:.2e} "
        f"dy={s6['err_y']:.2e}")

    # 7. service, cache arm
    s7 = phase_cache_arm(device, s4["A"], s4["b"], n_req=64)
    warm = s7["waves"]["warm"]["results"]
    cold = s7["waves"]["cold"]["results"]
    check(s7["solvers"] == {"dense_gmres"},
          f"phase 7: cache-on service routed to {s7['solvers']}")
    check(all(r.warm_start for r in warm), "phase 7: a warm request missed "
          "the cache")
    check(all(bool(r.info.converged) for r in cold + warm),
          "phase 7: a request did not converge")
    say("7 service/cache", f"64 requests cold+warm, dense_gmres: cold "
        f"{s7['waves']['cold']['s'] * 1e3:.1f} ms median iters="
        f"{percentile([r.info.iterations for r in cold], 50)}; warm "
        f"{s7['waves']['warm']['s'] * 1e3:.1f} ms warm_started="
        f"{sum(r.warm_start for r in warm)} hit_rate={s7['hit_rate']:.2f} "
        f"launches={s7['launches']}")

    # 8. times
    t = phase_times(device, s4["A"][:64], s4["b"][:64], SERVICE_TOL,
                    previous.get("batched_cg"))
    t6 = phase_times(device, s4["A"][:64], s4["b"][:64], HYPERGRAD_TOL,
                     previous.get("batched_cg"))
    say("8 times", f"[{card}] batched_cg (64, 512) float32: "
        + say_times(t, SERVICE_TOL) + " | " + say_times(t6, HYPERGRAD_TOL)
        + f" | service phase 4: {s4['rps']:.1f} req/s, p50 "
        f"{s4['p50'] * 1e3:.2f} ms, p99 {s4['p99'] * 1e3:.2f} ms; span "
        "p50/p99 ms: " + ", ".join(
            f"{k} {v['p50_ms']:.2f}/{v['p99_ms']:.2f}"
            for k, v in s4["breakdown"].items()))

    # 9. simplex kernel against plain
    worst9, err9, deriv9 = phase_simplex_vs_plain(
        device, gen, SIMPLEX_SHAPES, SIMPLEX_TIE_SHAPES)
    paths9 = {path for *_, path in worst9.values()}
    every9 = {"L=8 V=16", "L=16 V=16", "L=32 V=16", "L=32 V=32", "smem"}
    check(paths9 == every9, f"phase 9: the shapes took the kernel layouts "
          f"{sorted(paths9)}, not every one of {sorted(every9)}")
    say("9 simplex vs plain", "[layout] max |Δ| (limit) max |row sum - "
        "scale| per shape: " + ", ".join(
            f"{key} [{path}]={e:.2e} ({lim:.1e}) {sm:.1e}"
            for key, (e, lim, sm, path) in worst9.items())
        + f"; on the card vs CPU closed form: backward "
        f"{deriv9['backward']:.1e}, jvp {deriv9['jvp']:.1e}, vmap "
        f"{deriv9['vmap']:.1e}")

    # 10. SVM slice
    s10 = phase_svm(device, gen, **SVM)
    for i, st in enumerate(s10["steps"]):
        check(st["fwd_launches"] >= st["inner"] >= 1,
              f"phase 10 step {i}: {st['fwd_launches']} simplex launches "
              f"in the forward for {st['inner']} inner iterations")
        check(st["bwd_launches"] >= 1,
              f"phase 10 step {i}: the backward launched no simplex kernel")
    check(s10["converged"], "phase 10: the last inner solve did not converge"
          f" (error {s10['steps'][-1]['error']:.3e} > tol {s10['tol']:.3e})")
    rel10 = abs(s10["g32"] - s10["g64"]) / abs(s10["g64"])
    check(rel10 <= SVM_GRAD_RTOL, f"phase 10: first-step hypergradient "
          f"{s10['g32']:.6e} (kernel, float32) vs {s10['g64']:.6e} (sort, "
          f"float64): rel {rel10:.3e} > {SVM_GRAD_RTOL}")
    say("10 svm slice", f"m={SVM['m']} p={SVM['p']} k={SVM['k']} "
        f"m_val={SVM['m_val']} float32: L={s10['L']:.6e} θ0={s10['theta0']:.6e}"
        f" (λ0={s10['lam0']:.6f}) tol={s10['tol']:.3e}; outer trace "
        f"{s10['outer_values']}, final λ={s10['theta']:.6f}; per step "
        "(inner iters, fwd launches, backward normal_cg iters, bwd launches,"
        " hypergrad): " + "; ".join(
            f"({st['inner']}, {st['fwd_launches']}, {st['bwd_iters']}, "
            f"{st['bwd_launches']}, {st['hypergrad']:.6e})"
            for st in s10["steps"])
        + f"; launches={s10['launches']}; one-step signed hypergradient "
        f"kernel/f32 {s10['g32']:.6e} vs sort/f64 {s10['g64']:.6e} (inner iters "
        f"{s10['inner64']}): rel {rel10:.3e} <= {SVM_GRAD_RTOL}; Fig. 4c "
        f"MD fixed point at the same x*: {s10['g_md']:.6e}; support mean "
        f"{s10['support_mean']:.4f}, interior rows {s10['interior_rows']:.4f}")

    # 11. times
    t11 = phase_simplex_times(device, gen, previous.get("simplex_proj"))
    inner_total = sum(st["inner"] for st in s10["steps"])
    fwd_total = sum(st["fwd_s"] for st in s10["steps"])
    say("11 times", f"[{card}] simplex_proj (50000, 100) float32: kernel "
        f"{t11['kernel_ms'][0]:.4f} / {t11['kernel_ms'][1]:.4f} ms of device "
        f"time ({t11['bound_ms'] / t11['ms'] * 100:.1f} % of the bound), "
        f"{t11['call_ms']:.4f} ms a call through kernel.launch, "
        f"{t11['ties_ms']:.4f} ms on rows with ties at the threshold (every "
        "row 50 steps), "
        + previous_line(t11) + f", bound {t11['bound_ms']:.4f} ms (bytes "
        f"{t11['t_bytes']:.4f} ms, operations {t11['t_flops']:.4f} ms), "
        f"plain {t11['plain_ms']:.4f} ms, sort-based projection_simplex "
        f"{t11['sort_ms']:.4f} ms | svm: setup {s10['setup_s']:.3f} s, "
        f"solve_bilevel {s10['wall']:.3f} s for {SVM_OUTER_STEPS} steps; "
        f"inner {fwd_total / inner_total * 1e3:.4f} ms/iteration with the "
        f"per-iteration host read, {s10['upd_s'] * 1e3:.4f} ms/update "
        "without it; per step (forward s, backward s, step s): " + "; ".join(
            f"({st['fwd_s']:.3f}, {st['bwd_s']:.3f}, {st['step_s']:.3f})"
            for st in s10["steps"])
        + f"; float64 sort-based step {s10['s64']:.3f} s")

    # 12. flash-attention kernel against plain
    worst12, routes12, err12 = phase_flash_vs_plain(device, gen, FA_SHAPES,
                                                    FA_BF16_SHAPES)
    for key, took in routes12.items():
        want = "tc" if key[-1] == "bfloat16" and key[5] >= 64 else "simt"
        check(took == want, f"phase 12: flash_attention at {key} took the "
              f"{took} route, expected {want}")
    say("12 flash vs plain", "max |Δ| and route per (B, Sq, Sk, H, Hkv, D, "
        "mask, dtype): " + ", ".join(f"{k}={e:.2e} {routes12.get(k, '')}"
                                     for k, e in worst12.items()))

    # 13. WKV kernel against plain
    worst13, err13 = phase_wkv_vs_plain(device, gen, WKV_SHAPES)
    from repro_torch.kernels.rwkv_wkv import kernel as wkv_kernel
    staged13 = {(T >= wkv_kernel.CHUNK, T % wkv_kernel.CHUNK > 0)
                for _, T, *_ in worst13}
    check(staged13 == {(False, True), (True, False), (True, True)},
          "phase 13: the shapes do not take every staging of T (one short "
          "chunk, whole chunks only, whole chunks and a short one)")
    say("13 wkv vs plain", "[staging of T] max |Δ| (output, final state) "
        "per (B, T, H, dtype, state): " + ", ".join(
            f"{k} [{path}]=({o:.2e}, {st:.2e})"
            for k, (o, st, path) in worst13.items())
        + "; state carried across a split of T: bit for bit")

    # 14. qwen1.5-4b, 15. rwkv6-3b
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rwkv_wkv import ops as wkv_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rwkv_wkv.ref import wkv_scan_ref
    s14 = phase_lm(device, gen, "qwen1.5-4b", args.seed, fa_ops,
                   "flash_attention", attention_ref)
    check_lm(s14, "flash_attention", 40, 14,
             {"bfloat16": "tc", "float32": "simt"})
    say_lm(s14, "14 qwen1.5-4b", "flash_attention")
    s15 = phase_lm(device, gen, "rwkv6-3b", args.seed, wkv_ops, "wkv",
                   wkv_scan_ref)
    check_lm(s15, "rwkv_wkv", 32, 15)
    say_lm(s15, "15 rwkv6-3b", "rwkv_wkv")

    # 16. times
    t16 = flash_times(device, gen)
    w16 = wkv_times(device, gen, previous.get("rwkv_wkv"))
    tok = LM_PREFILL[0] * LM_PREFILL[1]
    tf = t16["tflops"]
    say("16 times", f"[{card}] flash_attention (4, 2048, 20, 128) bfloat16 "
        f"causal, in turns: tc kernel {t16['tc_ms'][0]:.4f} / "
        f"{t16['tc_ms'][1]:.4f} ms ({tf['tc']:.1f} TFLOP/s, "
        f"{t16['bound_ms'] / t16['ms'] * 100:.1f} % of the bound), simt "
        f"kernel {t16['simt_ms']:.4f} ms ({tf['simt']:.1f} TFLOP/s; tc "
        f"{t16['simt_ms'] / t16['ms']:.2f}x faster), "
        f"F.scaled_dot_product_attention {t16['library_ms']:.4f} ms "
        f"({tf['sdpa']:.1f} TFLOP/s); bound {t16['bound_ms']:.4f} ms "
        f"({t16['gflop']:.1f} GFLOP: operations {t16['t_flops']:.4f} ms, "
        f"bytes {t16['t_bytes']:.4f} ms), plain {t16['plain_ms']:.4f} ms "
        f"({tf['plain']:.1f} TFLOP/s); qwen1.5-4b prefill with / without "
        f"the kernel {s14['kernel_s'] / s14['plain_s']:.3f} | "
        f"rwkv_wkv (4, 2048, 40, 64) bfloat16 r/k/v: kernel "
        f"{w16['kernel_ms'][0]:.4f} / {w16['kernel_ms'][1]:.4f} ms ("
        f"{w16['bound_ms'] / w16['ms'] * 100:.1f} % of the bound), "
        + previous_line(w16) + f", bound {w16['bound_ms']:.4f} ms ("
        f"{w16['gflop']:.2f} GFLOP at 5N² a step: operations "
        f"{w16['t_flops']:.4f} ms; {w16['mb']:.1f} MB: bytes "
        f"{w16['t_bytes']:.4f} ms), plain scan {w16['plain_ms']:.4f} ms, "
        f"wkv_chunked {w16['chunked_ms']:.4f} ms | " + " | ".join(
            f"{r['cfg'].name} prefill {LM_PREFILL}: kernel "
            f"{r['kernel_s'] * 1e3:.2f} ms ({tok / r['kernel_s']:.0f} "
            f"tok/s), plain {r['plain_s'] * 1e3:.2f} ms "
            f"({tok / r['plain_s']:.0f} tok/s); {say_profile(r['profile'])}"
            f"; launcher decode batch 4: "
            f"{r['launcher']['decode_tok_s']:.1f} tok/s (its token-by-token "
            f"prompt prefill {r['launcher']['prefill_s'] * 1e3:.1f} ms); "
            f"engine {r['engine']['tokens'] / r['engine']['wall']:.1f} tok/s"
            f" ({r['engine']['steps']} steps in {r['engine']['wall']:.2f} s)"
            for r in (s14, s15)))

    # 17. a batch of hypergradients as one batched solve
    t_phase = time.perf_counter()
    s17 = phase_vmap_hypergrad(device, gen, B=64, d=512, m=1024)
    check(s17["fwd_launches"] == 0, "phase 17: the wrapped solver's "
          f"forward launched the kernel {s17['fwd_launches']} times")
    for path in ("grad", "jvp"):
        r = s17[path]
        check(r["launches"] == 1 and r["by_layout"] == {MAIN_LAYOUT: 1},
              f"phase 17 ({path}): vmap launched {r['launches']} "
              f"{r['by_layout']}, expected one {MAIN_LAYOUT} launch for 64")
        check(r["loop_launches"] == 64, f"phase 17 ({path}): the loop "
              f"launched {r['loop_launches']} times, expected 64")
        check(r["vs_loop"] <= VMAP_RTOL < r["control_loop"],
              f"phase 17 ({path}): vmap against the loop {r['vs_loop']:.3e}"
              f" (limit {VMAP_RTOL}, control {r['control_loop']:.3e})")
        check(r["vs_closed"] <= CLOSED_RTOL < r["control_closed"],
              f"phase 17 ({path}): against the closed form "
              f"{r['vs_closed']:.3e} (limit {CLOSED_RTOL}, control "
              f"{r['control_closed']:.3e})")
    run17 = s17["run"]
    check(run17["converged"], "phase 17 (c): an instance of the vmapped "
          "run() did not converge")
    check(run17["its_diff"] <= 1, f"phase 17 (c): vmapped iterations "
          f"differ from the loop's by {run17['its_diff']} > 1")
    check(run17["launches"] == 1 and run17["by_layout"] == {MAIN_LAYOUT: 1},
          f"phase 17 (c): vmap(grad) through run() launched "
          f"{run17['launches']} {run17['by_layout']}, expected one "
          f"{MAIN_LAYOUT}")
    say("17 vmap hypergrad", "64 ridge hypergradients d=512 float32 "
        "pallas_cg: " + "; ".join(
            f"({name}) vmap {s17[p]['launches']} launch "
            f"{s17[p]['by_layout']} "
            f"in {s17[p]['batched_s'] * 1e3:.1f} ms, loop "
            f"{s17[p]['loop_launches']} launches in "
            f"{s17[p]['loop_s'] * 1e3:.1f} ms; rel vs loop "
            f"{s17[p]['vs_loop']:.2e} (control {s17[p]['control_loop']:.2e})"
            f", vs float64 closed form {s17[p]['vs_closed']:.2e} (control "
            f"{s17[p]['control_closed']:.2e})"
            for p, name in (("grad", "a"), ("jvp", "b")))
        + f"; (c) GradientDescent.run() tol={RUN_TOL}: per-instance "
        f"iterations {run17['its']} (loop {run17['loop_its']}, max |Δ| "
        f"{run17['its_diff']}), vmap {run17['batched_s']:.3f} s, loop "
        f"{run17['loop_s']:.3f} s; vmap(grad) through run() "
        f"{run17['launches']} launch {run17['by_layout']} in "
        f"{run17['grad_s']:.3f} s, rel vs closed form at the converged "
        f"x* {run17['grad_vs_closed']:.2e} (information)")

    say("17 time", f"{time.perf_counter() - t_phase:.1f} s")

    # 18. the DEQ layer at full width
    t_phase = time.perf_counter()
    s18 = phase_deq(device, gen, **DEQ)
    check(s18["converged"], f"phase 18: the DEQ forward did not converge "
          f"(error {s18['fwd_error']:.3e} > {s18['fwd_tol']:.3e})")
    check(s18["rho"] < 1, f"phase 18: contraction factor {s18['rho']:.3f}")
    worst18 = max(e["rel"] for e in s18["exact"].values())
    check(all(e["converged"] for e in s18["exact"].values()),
          f"phase 18: an exact backward solve did not converge "
          f"{ {k: e['converged'] for k, e in s18['exact'].items()} }")
    check(worst18 <= DEQ_AGREE_RTOL < s18["approx"]["jacobian_free"]["rel"],
          f"phase 18: exact solvers apart by {worst18:.3e} (limit "
          f"{DEQ_AGREE_RTOL}, control jacobian_free "
          f"{s18['approx']['jacobian_free']['rel']:.3e})")
    u18 = s18["unroll"]
    check(u18["rel"] <= DEQ_UNROLL_RTOL < u18["control"],
          f"phase 18: implicit vs {DEQ['depth']}-layer unrolled gradient "
          f"{u18['rel']:.3e} (limit {DEQ_UNROLL_RTOL}, control "
          f"{u18['control']:.3e})")
    say("18 deq", f"d={DEQ['d']} d_ff={DEQ['d_ff']} x ({DEQ['tokens']}, "
        f"{DEQ['d']}) float32, weights × {DEQ['scale']}/√fan-in: "
        f"contraction {s18['rho']:.4f}; Anderson forward "
        f"{s18['fwd_iters']} iterations to ‖T(z)−z‖ {s18['fwd_error']:.3e} "
        f"<= {s18['fwd_tol']:.1e} in {s18['fwd_s']:.3f} s; d(Σz*²)/dw per "
        "backward (iterations or matvecs, s, rel vs normal_cg): " + ", ".join(
            f"{k} ({e['iterations']}, {e['s']:.3f}, {e['rel']:.2e})"
            for k, e in s18["exact"].items())
        + "; approximate (matvecs, s, hypergrad_error_estimate, cosine, "
        "rel): " + ", ".join(
            f"{k} ({e['matvecs']}, {e['s']:.3f}, {e['est']:.3e}, "
            f"{e['cos']:.6f}, {e['rel']:.2e})"
            for k, e in s18["approx"].items())
        + f"; at {DEQ['unroll_tokens']} tokens implicit (normal_cg, "
        f"{u18['implicit_s']:.3f} s) vs {DEQ['depth']}-layer unrolled "
        f"({u18['s']:.3f} s, peak {u18['peak_gb'] or 0:.2f} GB): rel "
        f"{u18['rel']:.2e} (limit {DEQ_UNROLL_RTOL}, jacobian_free control "
        f"{u18['control']:.2e})")

    say("18 time", f"{time.perf_counter() - t_phase:.1f} s")

    # 19. the service's approximate arm
    t_phase = time.perf_counter()
    s19 = phase_approx_service(device, gen, **APPROX)
    rows19 = s19["rows"]
    check(s19["launches"] == 2 and s19["by_layout"] == {MAIN_LAYOUT: 2},
          f"phase 19: the exact buckets launched {s19['launches']} "
          f"{s19['by_layout']}, expected 2 on {MAIN_LAYOUT}")
    check(s19["cache_after"] == s19["cache_exact"], f"phase 19: the "
          f"approximate requests moved the cache from {s19['cache_exact']} "
          f"to {s19['cache_after']} entries")
    for (rho, mode), row in rows19.items():
        if mode == "exact":
            check(row["err"] <= EXACT_RTOL, f"phase 19: exact bucket at "
                  f"ρ={rho} {row['err']:.3e} from solve='lu' > {EXACT_RTOL}")
            continue
        check(row["err"] <= POLY_RTOL < row["control"], f"phase 19: {mode} "
              f"at ρ={rho} {row['err']:.3e} from its float64 polynomial "
              f"(limit {POLY_RTOL}, control {row['control']:.3e})")
        check(row["est_err"] <= EST_RTOL < row["est_control"], f"phase 19: "
              f"{mode} estimate at ρ={rho} {row['est_err']:.3e} from float64"
              f" (limit {EST_RTOL}, control {row['est_control']:.3e})")
    lo, hi = APPROX["rhos"]
    for mode in ("one_step", "neumann_k", "jacobian_free"):
        check(bool((rows19[(hi, mode)]["est"] >= rows19[(lo, mode)]["est"])
                   .all()), f"phase 19: {mode} estimates at ρ={hi} below "
              f"those at ρ={lo}")
    say("19 service/approx", f"A = I − ρS d={APPROX['d']} float32, "
        f"{APPROX['n']} submit_hypergrad per (ρ, mode), routes "
        f"{s19['routes']}: exact buckets {s19['launches']} launches "
        f"{s19['by_layout']} in {s19['exact_s'] * 1e3:.1f} ms, approximate "
        f"buckets in {s19['approx_s'] * 1e3:.1f} ms; cache "
        f"{s19['cache_exact']} -> {s19['cache_after']} entries; per (ρ, "
        "mode): " + ", ".join(
            f"({rho}, {mode}) iterations {row['iterations']} err "
            f"{row['err']:.2e}" + ("" if mode == "exact" else
                                   f" (control {row['control']:.2e}) est "
                                   f"{float(row['est'].min()):.3e}–"
                                   f"{float(row['est'].max()):.3e} est err "
                                   f"{row['est_err']:.2e} (control "
                                   f"{row['est_control']:.2e})")
            for (rho, mode), row in rows19.items()))

    say("19 time", f"{time.perf_counter() - t_phase:.1f} s")

    # 20. the new solvers and operators
    t_phase = time.perf_counter()
    s20 = phase_solvers(device, gen, B=64, d=512)
    for solver in ("bicgstab", "gmres", "neumann", "block_jacobi"):
        r = s20[solver]
        check(r["converged"] and r["reported"] <= SOLVERS_TOL,
              f"phase 20: {solver} reported residual {r['reported']:.3e} "
              f"(converged {r['converged']}, tol {SOLVERS_TOL})")
        check(r["resid"] <= 2 * SOLVERS_TOL < r["control"],
              f"phase 20: {solver} float64 residual {r['resid']:.3e} "
              f"(limit {2 * SOLVERS_TOL}, control {r['control']:.3e})")
    check(set(s20["block_jacobi"]["its"]) == {1}, "phase 20: block-Jacobi "
          f"cg took {sorted(set(s20['block_jacobi']['its']))} iterations")
    mv20 = s20["matvec"]
    for op in ("composed", "raveled"):
        check(mv20[op] <= MATVEC_RTOL < mv20[f"{op}_control"],
              f"phase 20: {op} matvec {mv20[op]:.3e} from its "
              f"materialized matrix (limit {MATVEC_RTOL}, control "
              f"{mv20[op + '_control']:.3e})")
    say("20 solvers", f"(64, 512) float32 tol={SOLVERS_TOL}: " + ", ".join(
        f"{name} iterations {min(s20[name]['its'])}–{max(s20[name]['its'])}"
        f" residual {s20[name]['reported']:.2e} (float64 "
        f"{s20[name]['resid']:.2e}, control "
        f"{s20[name]['control']:.2e}) {s20[name]['s'] * 1e3:.1f} ms"
        for name in ("bicgstab", "gmres", "neumann", "block_jacobi"))
        + f"; ComposedOperator matvec vs materialized {mv20['composed']:.2e}"
        f" (control {mv20['composed_control']:.2e}), RaveledOperator "
        f"{mv20['raveled']:.2e} (control {mv20['raveled_control']:.2e})")

    say("20 time", f"{time.perf_counter() - t_phase:.1f} s")

    # 21. stochastic bilevel at data scale
    t_phase = time.perf_counter()
    s21 = phase_stochastic(device, gen, args.seed, **STOCH)
    check(s21["cos"] >= STOCH_COS > s21["cos_control"], f"phase 21: "
          f"hypergradient cosine {s21['cos']:.6f} against the full-batch "
          f"baseline (limit {STOCH_COS}, permuted control "
          f"{s21['cos_control']:.6f})")
    check(s21["full_converged"], "phase 21: the full-batch baseline did "
          "not converge")
    check(math.isfinite(s21["est"]) and s21["est"] < 1, f"phase 21: "
          f"estimate_hypergrad_error {s21['est']}")
    check(s21["bilevel_est"] is not None and math.isfinite(
        s21["bilevel_est"]), f"phase 21: solve_bilevel under "
          f"backward='exact' reported the estimate {s21['bilevel_est']}")
    check(s21["restart_equal"], "phase 21: the restarted half epoch does "
          "not replay the whole epoch bit for bit")
    n_lams = STOCH["vmap_lams"]
    check(len(s21["vmap_solves"]) == 1 and len(s21["loop_solves"]) == n_lams,
          f"phase 21: vmap(grad) over {n_lams} λ ran the registry solves "
          f"{s21['vmap_solves']}, the loop {s21['loop_solves']}")
    check(s21["vs_loop"] <= STOCH_VMAP_RTOL < s21["vs_loop_control"],
          f"phase 21: vmap against the loop {s21['vs_loop']:.3e} (limit "
          f"{STOCH_VMAP_RTOL}, control {s21['vs_loop_control']:.3e})")
    say("21 stochastic", f"ridge n={STOCH['n']} d={STOCH['d']} float32 "
        f"(X {s21['x_gib']:.2f} GiB on the card), hypergradient in the d "
        f"log-regularizers: SGD B={STOCH['B']} {s21['steps']} steps (one "
        f"epoch, Polyak from half) in {s21['epoch_s']:.3f} s, full-batch "
        f"residual {s21['error']:.3e}; backward (sampled operator, "
        f"neumann_k k={STOCH['backward_iters']} + Jacobi, "
        f"{STOCH['backward_batches']} batches) {s21['backward_s']:.3f} s; "
        f"baseline GD {s21['full_iters']} iterations in "
        f"{s21['full_fwd_s']:.3f} s, its exact cg backward "
        f"{s21['full_bwd_s']:.3f} s; cosine {s21['cos']:.6f} (limit "
        f"{STOCH_COS}, permuted control {s21['cos_control']:.6f}); "
        f"estimate_hypergrad_error {s21['est']:.4e} ({s21['est_s']:.3f} s);"
        f" solve_bilevel 2 steps backward='exact' estimate "
        f"{s21['bilevel_est']:.4e} in {s21['bilevel_s']:.3f} s; restart at "
        f"step {s21['steps'] // 2}: bit for bit; vmap(grad) over {n_lams} λ: "
        f"{len(s21['vmap_solves'])} registry solve in {s21['vmap_s']:.3f} s,"
        f" loop {len(s21['loop_solves'])} in {s21['loop_s']:.3f} s, rel "
        f"{s21['vs_loop']:.2e} (limit {STOCH_VMAP_RTOL}, control "
        f"{s21['vs_loop_control']:.2e})")
    say("21 time", f"{time.perf_counter() - t_phase:.1f} s")

    # 22. autotune on the batched-CG kernel
    t_phase = time.perf_counter()
    s22 = phase_autotune(device, gen, LAYOUT_SWEEP, **SWEEP_TIMING)
    for key, row in s22["shapes"].items():
        check(list(row["ms"]) == row["candidates"], f"phase 22: at {key} "
              f"the sweep timed {list(row['ms'])}, the layouts that fit are "
              f"{row['candidates']}")
        check(row["cold"] == {row["rule"]: 1}, f"phase 22: at {key} the "
              f"cold cache launched {row['cold']}, the rule gives "
              f"{row['rule']}")
        check(row["chosen"] == row["argmin"], f"phase 22: at {key} "
              f"choose_layout gave {row['chosen']}, the argmin is "
              f"{row['argmin']}")
        check(row["tuned"] == {row["chosen"]: 1}, f"phase 22: at {key} the "
              f"tuned solve launched {row['tuned']}, not {row['chosen']}")
        check(row["err"] <= RTOL[key[2]], f"phase 22: at {key} the tuned "
              f"layout is {row['err']:.3e} from the plain version")
    check("does not fit" in s22["misfit"], f"phase 22: a cache entry "
          f"naming C1 at d=512 did not raise ({s22['misfit']})")
    check(s22["round_trip"], "phase 22: the cache changed in save/load")
    check(s22["preloaded"] == s22["want_preloaded"], f"phase 22: a process "
          f"with REPRO_AUTOTUNE_CACHE read {s22['preloaded']}, expected "
          f"{s22['want_preloaded']}")
    check(all(r["source"] == "measured" for r in s22["solvers"].values())
          and s22["unmeasured"][1] == "roofline", f"phase 22: predictions "
          f"{ {k: r['source'] for k, r in s22['solvers'].items()} }, "
          f"unmeasured {s22['unmeasured'][1]}")
    say("22 autotune", f"[{card}] batched_cg layouts by device time (ms), "
        "rule → tuned choice: " + "; ".join(
            f"{key}: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                   row["ms"].items())
            + f"; rule {row['rule']} → {row['chosen']} (rel vs plain "
            f"{row['err']:.2e})" for key, row in s22["shapes"].items())
        + f"; sweep launches {s22['sweep_launches']} (not the main path); "
        f"misfit C1 at d=512 raised; cache of {s22['cache_entries']} "
        "entries saved, loaded and preloaded in a subprocess by "
        "REPRO_AUTOTUNE_CACHE; measure_solver (64, 512) float32 median ms: "
        + ", ".join(f"{k} {r['ms']:.3f} ({r['source']})"
                    for k, r in s22["solvers"].items())
        + f"; the cost model's cold-cache estimate (roofline.analyze_solve,"
        f" A re-read every iteration) {s22['roofline_ms']:.4f} ms; "
        f"unmeasured (64, 256) cg: {s22['unmeasured'][1]}")
    say("22 time", f"{time.perf_counter() - t_phase:.1f} s")

    # 23. op census and roofline of the qwen1.5-4b prefill step
    t_phase = time.perf_counter()
    s23 = phase_census(device, args.seed, "qwen1.5-4b", s14["kernel_s"])
    check(s23["tree"] == (s23["nonemb"], s23["head"]), f"phase 23: the "
          f"parameters hold {s23['tree']}, the config gives "
          f"{(s23['nonemb'], s23['head'])}")
    check(s23["rel"] <= CENSUS_RTOL < s23["control"], f"phase 23: census "
          f"FLOPs {s23['flops']:.6e} against {s23['want']:.6e}: rel "
          f"{s23['rel']:.3e} (limit {CENSUS_RTOL}, control "
          f"{s23['control']:.3e})")
    check(s23["custom_calls"] == {"flash_attention": 40} and
          s23["launches"] == 40, f"phase 23: custom calls "
          f"{s23['custom_calls']}, launches {s23['launches']}")
    tm = s23["terms"]
    say("23 census", f"[{card}] qwen1.5-4b bf16 prefill {LM_PREFILL}: "
        f"census FLOPs {s23['flops']:.6e} ({s23['by_op']}) against 2·(non-"
        f"embedding {s23['nonemb']} + head {s23['head']})·tokens = "
        f"{s23['want']:.6e}: rel {s23['rel']:.3e} (limit {CENSUS_RTOL}, "
        f"products left out {s23['control']:.3e}); bytes "
        f"{s23['bytes']:.6e} (every eager op, the kernels' custom calls "
        f"{s23['custom_calls']}); census run {s23['census_s']:.3f} s; "
        f"roofline compute {tm.compute_s * 1e3:.4f} ms, memory "
        f"{tm.memory_s * 1e3:.4f} ms ({tm.dominant}), its mfu "
        f"{tm.mfu:.4f}; at phase 16's measured {s23['prefill_ms']:.2f} ms "
        f"the step's mfu is {s23['mfu']:.4f}")
    say("23 time", f"{time.perf_counter() - t_phase:.1f} s")

    launches = s4["launches"] + s5["launches"] + s6["fwd"] + s6["bwd"] \
        + s7["launches"] + s17["grad"]["launches"] \
        + s17["jvp"]["launches"] + run17["launches"] + s19["launches"] \
        + s22["launches"]
    print(json.dumps({"kernels": [{
        "name": "batched_cg", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": err_main, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"], "previous_ms": t["previous_ms"]}, {
        "name": "simplex_proj", "route": "cuda", "source": SIMPLEX_SOURCE,
        "replaces": SIMPLEX_REPLACES, "launches": s10["launches"],
        "max_abs_err": err9, "ms": t11["ms"], "plain_ms": t11["plain_ms"],
        "bound_ms": t11["bound_ms"], "bound_by": t11["bound_by"],
        "library_ms": None, "previous_ms": t11["previous_ms"]}, {
        "name": "flash_attention", "route": "cuda", "source": FA_SOURCE,
        "replaces": FA_REPLACES,
        "launches": s14["bf16"]["routes"]["tc"],
        "max_abs_err": err12, "ms": t16["ms"], "plain_ms": t16["plain_ms"],
        "bound_ms": t16["bound_ms"], "bound_by": t16["bound_by"],
        "library_ms": t16["library_ms"], "previous_ms": t16["simt_ms"]}, {
        "name": "rwkv_wkv", "route": "cuda", "source": WKV_SOURCE,
        "replaces": WKV_REPLACES, "launches": s15["bf16"]["launches"],
        "max_abs_err": err13, "ms": w16["ms"], "plain_ms": w16["plain_ms"],
        "bound_ms": w16["bound_ms"], "bound_by": w16["bound_by"],
        "library_ms": None, "previous_ms": w16["previous_ms"]}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
