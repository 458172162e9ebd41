#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Drives the port's main path — the solve service answering dense solves and
implicit hypergradients, and ``custom_root`` implicit differentiation — on
the GPU, through the hand-written batched-CG kernel, and stops at the
first failure with a non-zero exit.  Each phase prints one line:

  1. card: name, device count, ``nvidia-smi`` name and power limit;
  2. build: the kernel is compiled from the repo's sources (``nvcc``,
     ``-Xptxas -v``: registers, shared memory, spills);
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
     version, and the service's requests/s and p50/p99 latency of phase 4.

Kernel launches are counted by ``repro_torch.kernels.batched_cg.ops.LAUNCHES``,
set to 0 just before each main-path phase (4-7) and read just after.  The
line before the last is a JSON object describing each kernel; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the repo's ``src/`` beside it, the script exits non-zero and prints no result.
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
    log = _build.build_log("batched_cg")
    ptx = " | ".join(line.split("ptxas info    : ")[-1].strip()
                     for line in log.splitlines()
                     if "registers" in line or "spill" in line)
    say("2 build", f"batched_cg from {KERNEL_SOURCE} in "
        f"{time.perf_counter() - t0:.1f} s (0 if cached): {ptx}")

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

    launches = s4["launches"] + s5["launches"] + s6["fwd"] + s6["bwd"] \
        + s7["launches"]
    print(json.dumps({"kernels": [{
        "name": "batched_cg", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": err_main, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
