#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Drives the port's two main paths on the GPU and stops at the first failure
with a non-zero exit: the solve service answering dense solves and
implicit hypergradients, and ``custom_root`` implicit differentiation,
through the hand-written batched-CG kernel (phases 3-8); and the paper's
§4.1 multiclass-SVM hyper-parameter optimisation — ``solve_bilevel`` over a
``ProjectedGradient`` inner solver — through the hand-written
simplex-projection kernel (phases 9-11).  Each phase prints one line:

  1. card: name, device count, ``nvidia-smi`` name and power limit;
  2. build: both kernels are compiled from the repo's sources (one
     ``nvcc`` each, started together; ``-Xptxas -v``: registers, shared
     memory, spills);
  3. kernel against plain: forward and backward (∂A, ∂b of Σx²) of the
     kernel against the plain PyTorch version on the same CUDA tensors, at
     (B, d) ∈ {(3, 7), (5, 130), (64, 96), (64, 512)}, float32 and float64;
     ‖Δ‖/‖ref‖ ≤ 1e-4 (float32) and 1e-10 (float64);
  4. service, kernel arm: ``SolveService(cache=None)`` with 256 ridge
     systems Aᵢ = XᵢᵀXᵢ/m + θᵢI at d = 512 (Xᵢ (1024, 512) standard normal,
     θᵢ log-uniform in [1e-2, 1], float32) — 4 buckets of 64, 4 kernel
     launches, every request converged with ‖Aᵢxᵢ − bᵢ‖/‖bᵢ‖ ≤ tol;
  5. service, hypergradient arm: 64 ``submit_hypergrad`` requests on
     F(x, θ) = Xᵀ(Xx − y)/m + θx with ``solve="pallas_cg"``, each within
     1e-3 of the port's direct ``root_vjp`` with ``solve="lu"``, relative
     to the largest hypergradient of the batch;
  6. implicit diff: ``torch.autograd.grad`` through a ``custom_root``-wrapped
     ridge solver with ``solve="pallas_cg"`` at d = 512 against the closed
     form (relative error ≤ 1e-3), the backward launching the kernel;
  7. service, cache arm: a default service (warm-start cache on, so
     ``dense_gmres``), a cold wave and a replayed warm wave of 64 requests;
  8. times, with the card's name and power limit: the kernel at (64, 512)
     float32 by CUDA events, its bound, ``torch.linalg.solve`` on the same
     batch (yardstick only — the port never calls it for this), the plain
     version, and the service's requests/s and p50/p99 latency of phase 4;
  9. simplex kernel against plain: ``projection_simplex_batched`` (the
     kernel) against the plain PyTorch bisection on the same CUDA tensors
     at (R, d) ∈ {(4, 5), (16, 33), (64, 1000), (3, 4097), (50000, 100)},
     float32 and float64 input: max |Δ| ≤ 1e-5·max(1, max|y|) and row sums
     within 1e-4 of the scale; the op's backward, ``torch.func.jvp`` and
     ``torch.func.vmap`` on CUDA tensors against the closed form and the
     plain version on the CPU;
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
     (50000, 100) float32 by CUDA events, its bound, the plain version, the
     sort-based projection (information only: ``library_ms`` is null, no
     single PyTorch call projects onto the simplex), and the SVM phase's
     seconds per inner iteration, per backward solve and per outer step.

Kernel launches are counted by each kernel's ``ops.LAUNCHES``, set to 0
just before each main-path phase (4-7 for batched_cg, 10 for simplex_proj)
and read just after.  The line before the last is a JSON object describing
each kernel; the last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the repo's ``src/`` beside it, the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "src/repro_torch/kernels/batched_cg/csrc/batched_cg.cu"
REPLACES = "src/repro/kernels/batched_cg/kernel.py:30"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12                 # H100 SXM float32 outside tensor cores
RTOL = {"float32": 1e-4, "float64": 1e-10}
CG_TOL = {"float32": 1e-6, "float64": 1e-12}
SERVICE_TOL = 1e-3                 # phase 4/7 (float32), see PERF.md
HYPERGRAD_TOL = 1e-6               # phase 5/6 solve tolerance (float32)

SIMPLEX_SOURCE = "src/repro_torch/kernels/simplex_proj/csrc/simplex_proj.cu"
SIMPLEX_REPLACES = "src/repro/kernels/simplex_proj/kernel.py:25"
SIMPLEX_ATOL = 1e-5                # times max(1, max|y|): float32 bisection
SIMPLEX_SHAPES = [(4, 5), (16, 33), (64, 1000), (3, 4097), (50000, 100)]
# phase 10: CIFAR-100's training/validation shapes (see PERF.md §4)
SVM = dict(m=50000, p=3072, k=100, m_val=10000)
SVM_THETA_OVER_L = 0.13            # θ₀ = 0.13·‖X‖₂², the smooth regime
SVM_TOL_REL = 1e-5                 # inner tol = 1e-5·√m (vertex-dual norm)
SVM_OUTER_STEPS = 3
SVM_OUTER_LR = 0.01
SVM_LINSOLVE = dict(linsolve_tol=1e-6, linsolve_maxiter=800)
SVM_MAXITER = 6000
SVM_GRAD_RTOL = 1e-2               # float32 kernel vs float64 sort-based


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

def phase_kernel_vs_plain(device, gen, shapes):
    """Kernel (via the op) against the plain version, forward + backward."""
    import torch
    from repro_torch.kernels.batched_cg import ops, ref
    worst = {}
    err_main = None
    for B, d in shapes:
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).replace("torch.", "")
            tol = CG_TOL[name]
            A, b, _, _ = ridge_batch(gen, B, d, 2 * d, dtype, device,
                                     theta_range=(0.1, 0.1))
            At, bt = A.clone().requires_grad_(), b.clone().requires_grad_()
            x = ops.batched_cg(At, bt, tol=tol, maxiter=4 * d, device=device)
            gA, gb = torch.autograd.grad((x ** 2).sum(), (At, bt))
            if device.type == "cuda":
                torch.cuda.synchronize()
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
    return worst, err_main


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

    from repro_torch.kernels.batched_cg import ops
    from repro_torch.observability import report, spans
    tracer = spans.configure_tracer(None)   # in-memory request spans
    ops.LAUNCHES = 0
    t_sub, t_done, futs = [0.0] * n_req, [0.0] * n_req, []
    for i in range(n_req):
        t_sub[i] = time.perf_counter()
        fut = svc.submit(A_host[i], b_host[i], positive_definite=True)
        fut.add_done_callback(
            lambda f, i=i: t_done.__setitem__(i, time.perf_counter()))
        futs.append(fut)
    svc.flush()
    launches = ops.LAUNCHES
    spans.remove_tracer()
    breakdown = report.summarize(tracer.records())["spans"]
    results = [f.result() for f in futs]
    wall = max(t_done) - min(t_sub)
    lat = [t_done[i] - t_sub[i] for i in range(n_req)]
    x = np.stack([np.asarray(r.x) for r in results]).astype(np.float64)
    resid = np.linalg.norm(np.einsum("bij,bj->bi", A_host.astype(np.float64),
                                     x) - b_host, axis=-1)
    relres = resid / np.linalg.norm(b_host, axis=-1)
    return dict(launches=launches, results=results, relres=relres,
                dispatches=svc.metrics["dispatches"] - dispatches0,
                rps=n_req / wall, p50=percentile(lat, 50),
                p99=percentile(lat, 99), A=A_host, b=b_host,
                breakdown=breakdown)


def phase_hypergrad(device, gen, n_req, d, m):
    """submit_hypergrad with solve='pallas_cg' against direct root_vjp/lu."""
    import torch
    from repro_torch.core import root_vjp
    from repro_torch.kernels.batched_cg import ops
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
    ops.LAUNCHES = 0
    futs = [svc.submit_hypergrad(F(i), x_star[i], (theta[i],), v[i],
                                 solve="pallas_cg", tol=HYPERGRAD_TOL)
            for i in range(n_req)]
    svc.flush()
    launches = ops.LAUNCHES
    got = torch.stack([f.result().x[0] for f in futs])
    want = torch.stack([root_vjp(F(i), x_star[i], (theta[i],), v[i],
                                 solve="lu")[0] for i in range(n_req)])
    # each request's error, relative to the batch's largest hypergradient
    errs = (got - want).abs() / want.abs().max()
    return dict(launches=launches, max_rel=float(errs.max()),
                dispatches=svc.metrics["dispatches"])


def phase_implicit_diff(device, gen, d, m):
    """torch.autograd.grad through custom_root(solve='pallas_cg')."""
    import torch
    from repro_torch.core import DenseOperator, custom_root
    from repro_torch.core import linear_solve
    from repro_torch.kernels.batched_cg import ops
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
    ops.LAUNCHES = 0
    x = ridge(None, theta, yt)
    fwd = ops.LAUNCHES
    g_theta, g_y = torch.autograd.grad(x.sum(), (theta, yt))
    bwd = ops.LAUNCHES - fwd
    # closed form in float64: dL/dθ = -1ᵀA⁻¹x*, dL/dy = X A⁻¹ 1 / m
    Xd, yd = X.double(), y.double()
    H = Xd.T @ Xd / m + 0.05 * torch.eye(d, device=device,
                                         dtype=torch.float64)
    xs = torch.linalg.solve(H, Xd.T @ yd / m)
    w = torch.linalg.solve(H, torch.ones(d, device=device,
                                         dtype=torch.float64))
    want_theta = -(w @ xs)
    want_y = Xd @ w / m
    return dict(fwd=fwd, bwd=bwd,
                err_theta=abs(float(g_theta) - float(want_theta))
                / abs(float(want_theta)),
                err_y=rel(g_y, want_y), err_x=rel(x, xs))


def phase_cache_arm(device, A_host, b_host, n_req):
    """Default service (cache on -> dense_gmres): cold then warm wave."""
    from repro_torch.kernels.batched_cg import ops
    from repro_torch.runtime import SolveService
    svc = SolveService(device=device, tol=SERVICE_TOL, max_batch=n_req)
    ops.LAUNCHES = 0
    waves = {}
    for wave in ("cold", "warm"):
        t0 = time.perf_counter()
        futs = [svc.submit(A_host[i], b_host[i], positive_definite=True)
                for i in range(n_req)]
        svc.flush()
        results = [f.result() for f in futs]
        waves[wave] = dict(results=results, s=time.perf_counter() - t0)
    keys = {k.solver for k, _ in svc._compiled}
    return dict(waves=waves, solvers=keys, launches=ops.LAUNCHES,
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


def phase_times(device, A_np, b_np, tol):
    """Kernel, plain and library times at (64, 512) float32, and the bound."""
    import torch
    from repro_torch.core import DenseOperator, linear_solve
    from repro_torch.kernels.batched_cg import kernel, ref
    A = torch.from_numpy(A_np).to(device)
    b = torch.from_numpy(b_np).to(device)
    B, d = b.shape
    maxiter = 1000                          # the service's default
    ms = cuda_time_ms(lambda: kernel.launch(A, b, tol=tol, maxiter=maxiter),
                      reps=20)
    plain_ms = cuda_time_ms(
        lambda: ref.batched_cg_ref(A, b, tol=tol, maxiter=maxiter), reps=5)
    library_ms = cuda_time_ms(lambda: torch.linalg.solve(A, b), reps=5)
    _, info = linear_solve.solve_cg(DenseOperator(A, positive_definite=True),
                                    b, tol=tol, maxiter=maxiter,
                                    batch_ndim=1, return_info=True)
    iters = info.iterations.cpu().tolist()
    nbytes = 4 * (B * d * d + 2 * B * d)   # A and b read once, x written once
    flops = 2 * sum(iters) * d * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / FP32_FLOPS * 1e3
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                iters=iters, bound_ms=max(t_bytes, t_flops),
                bound_by="bytes" if t_bytes >= t_flops else "operations",
                t_bytes=t_bytes, t_flops=t_flops,
                streamed_gb_s=sum(iters) / B * nbytes / (ms * 1e-3) / 1e9)


def phase_simplex_vs_plain(device, gen, shapes):
    """Simplex kernel (via the op) against the plain bisection, and the
    op's derivatives and vmap rule on CUDA tensors against the CPU."""
    import torch
    import torch.func
    from repro_torch.kernels.simplex_proj import ops, ref
    worst, err_main = {}, None
    for R, d in shapes:
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).replace("torch.", "")
            scale = 3.0 if (R, d) == (16, 33) else 1.0
            y = 3 * torch.randn(R, d, generator=gen, device=device,
                                dtype=dtype)
            x = ops.projection_simplex_batched(y, scale)
            sync(device)
            want = ref.projection_simplex_rows_ref(y, scale)
            err = float((x - want).abs().max())
            limit = SIMPLEX_ATOL * max(1.0, float(y.abs().max()))
            sums = float((x.double().sum(-1) - scale).abs().max())
            worst[(R, d, name)] = (err, limit, sums)
            if (R, d, name) == (50000, 100, "float32"):
                err_main = err
            check(x.dtype == dtype and err <= limit,
                  f"simplex kernel vs plain at R={R} d={d} {name}: max |Δ| "
                  f"= {err:.3e} > {limit:.3e}")
            check(sums <= 1e-4, f"simplex kernel at R={R} d={d} {name}: row"
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


def phase_simplex_times(device, gen):
    """Simplex kernel, plain and sort-based times at (50000, 100) float32,
    and the bound."""
    import torch
    from repro_torch.core import projections
    from repro_torch.kernels.simplex_proj import kernel, ref
    R, d = 50000, 100
    y = 3 * torch.randn(R, d, generator=gen, device=device)
    ms = cuda_time_ms(lambda: kernel.launch(y), reps=50)
    plain_ms = cuda_time_ms(lambda: ref.projection_simplex_rows_ref(y),
                            reps=5)
    sort_ms = cuda_time_ms(lambda: projections.projection_simplex(y), reps=20)
    nbytes = 4 * 2 * R * d                  # y read once, x written once
    flops = 3 * kernel.ITERS * R * d        # subtract, max, add per step
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / FP32_FLOPS * 1e3
    return dict(ms=ms, plain_ms=plain_ms, sort_ms=sort_ms,
                bound_ms=max(t_bytes, t_flops),
                bound_by="bytes" if t_bytes >= t_flops else "operations",
                t_bytes=t_bytes, t_flops=t_flops)


# ---------------------------------------------------------------------------

def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of every random problem the run draws")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs the port on an NVIDIA GPU")
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
    _build.build()
    built_s = time.perf_counter() - t0
    for kname, source in (("batched_cg", KERNEL_SOURCE),
                          ("simplex_proj", SIMPLEX_SOURCE)):
        ptx = " | ".join(line.split("ptxas info    : ")[-1].strip()
                         for line in _build.build_log(kname).splitlines()
                         if "registers" in line or "spill" in line)
        say("2 build", f"{kname} from {source} (both in {built_s:.1f} s, 0 "
            f"if cached): {ptx}")

    # 3. kernel against plain
    worst, err_main = phase_kernel_vs_plain(
        device, gen, [(3, 7), (5, 130), (64, 96), (64, 512)])
    say("3 kernel vs plain", "max rel err (x, dA, db) per shape: "
        + ", ".join(f"{B}x{d} {n}={e:.2e}" for (B, d, n), e in worst.items()))

    # 4. service, kernel arm
    s4 = phase_service_kernel_arm(device, gen, n_req=256, d=512, m=1024,
                                  max_batch=64)
    check(s4["dispatches"] == 4, f"phase 4: {s4['dispatches']} dispatches, "
          "expected 4 buckets of 64")
    check(s4["launches"] == 4, f"phase 4: {s4['launches']} kernel launches,"
          " expected 4")
    check(all(bool(r.info.converged) for r in s4["results"]),
          "phase 4: a request did not converge")
    check(float(s4["relres"].max()) <= SERVICE_TOL,
          f"phase 4: max |Ax-b|/|b| = {s4['relres'].max():.3e} > "
          f"{SERVICE_TOL}")
    say("4 service/kernel", f"256 requests d=512 float32 tol={SERVICE_TOL}: "
        f"dispatches={s4['dispatches']} launches={s4['launches']} "
        f"max |Ax-b|/|b|={s4['relres'].max():.3e}; all converged")

    # 5. service, hypergradient arm
    s5 = phase_hypergrad(device, gen, n_req=64, d=512, m=1024)
    check(s5["launches"] >= 1, "phase 5: the kernel was not launched")
    check(s5["max_rel"] <= 1e-3, f"phase 5: hypergradient rel err "
          f"{s5['max_rel']:.3e} > 1e-3 against root_vjp(solve='lu')")
    say("5 service/hypergrad", f"64 submit_hypergrad d=512 pallas_cg: "
        f"dispatches={s5['dispatches']} launches={s5['launches']} "
        f"max rel err vs root_vjp(lu)={s5['max_rel']:.3e}")

    # 6. implicit diff
    s6 = phase_implicit_diff(device, gen, d=512, m=1024)
    check(s6["bwd"] >= 1, "phase 6: the backward did not launch the kernel")
    check(max(s6["err_theta"], s6["err_y"], s6["err_x"]) <= 1e-3,
          f"phase 6: errors vs closed form {s6}")
    say("6 implicit diff", f"custom_root(pallas_cg) d=512: launches "
        f"forward={s6['fwd']} backward={s6['bwd']}; rel err vs closed form "
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
    t = phase_times(device, s4["A"][:64], s4["b"][:64], SERVICE_TOL)
    t6 = phase_times(device, s4["A"][:64], s4["b"][:64], HYPERGRAD_TOL)
    say("8 times", f"[{card}] batched_cg (64, 512) float32 tol={SERVICE_TOL}:"
        f" kernel {t['ms']:.4f} ms, CG iterations sum={sum(t['iters'])} "
        f"max={max(t['iters'])}, bound {t['bound_ms']:.4f} ms "
        f"(bytes {t['t_bytes']:.4f} ms, operations {t['t_flops']:.4f} ms), "
        f"A streamed at {t['streamed_gb_s']:.1f} GB/s; plain "
        f"{t['plain_ms']:.4f} ms; torch.linalg.solve {t['library_ms']:.4f} "
        f"ms | tol={HYPERGRAD_TOL}: kernel {t6['ms']:.4f} ms, iterations "
        f"sum={sum(t6['iters'])}, bound {t6['bound_ms']:.4f} ms, plain "
        f"{t6['plain_ms']:.4f} ms | service phase 4: {s4['rps']:.1f} req/s,"
        f" p50 {s4['p50'] * 1e3:.2f} ms, p99 {s4['p99'] * 1e3:.2f} ms; "
        "span p50/p99 ms: " + ", ".join(
            f"{k} {v['p50_ms']:.2f}/{v['p99_ms']:.2f}"
            for k, v in s4["breakdown"].items()))

    # 9. simplex kernel against plain
    worst9, err9, deriv9 = phase_simplex_vs_plain(device, gen, SIMPLEX_SHAPES)
    say("9 simplex vs plain", "max |Δ| (limit) max |row sum - scale| per "
        "shape: " + ", ".join(
            f"{R}x{d} {n}={e:.2e} ({lim:.1e}) {sm:.1e}"
            for (R, d, n), (e, lim, sm) in worst9.items())
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
    t11 = phase_simplex_times(device, gen)
    inner_total = sum(st["inner"] for st in s10["steps"])
    fwd_total = sum(st["fwd_s"] for st in s10["steps"])
    say("11 times", f"[{card}] simplex_proj (50000, 100) float32: kernel "
        f"{t11['ms']:.4f} ms, bound {t11['bound_ms']:.4f} ms (bytes "
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

    launches = s4["launches"] + s5["launches"] + s6["fwd"] + s6["bwd"] \
        + s7["launches"]
    print(json.dumps({"kernels": [{
        "name": "batched_cg", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": err_main, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"]}, {
        "name": "simplex_proj", "route": "cuda", "source": SIMPLEX_SOURCE,
        "replaces": SIMPLEX_REPLACES, "launches": s10["launches"],
        "max_abs_err": err9, "ms": t11["ms"], "plain_ms": t11["plain_ms"],
        "bound_ms": t11["bound_ms"], "bound_by": t11["bound_by"],
        "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
