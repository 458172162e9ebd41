"""Molecular-dynamics sensitivity (paper §4.4, Figure 6) in the port.

The port's counterpart of ``examples/md_sensitivity.py``, with its own
copy of ``pair_energy`` and ``fire_minimize`` from
``benchmarks/molecular_dynamics.py`` (K = 32 soft spheres in a 2-D
periodic box of side 4, half of diameter 1 and half of diameter θ; FIRE,
400 steps).  The sensitivity ∂x*/∂θ of the minimum comes three ways:

  1. ``root_jvp`` on the force residual F(x, θ) = −∇ₓE at the FIRE
     minimum, solved by ``bicgstab``;
  2. ``GradientDescent.run(..., mode="jvp")`` polishing the minimum under
     ``torch.func.jvp``, the tangent solve again ``bicgstab``;
  3. a sweep over B = 8 diameters θ₀ + 0.005·b: the B Hessian systems
     H_b dx_b = ∂F/∂θ_b as one batch on a ``ShardedOperator`` on the mesh
     ``launch.mesh.auto_mesh_size`` picks, solved by
     ``linear_solve.solve(method="auto")`` (``sharded_dense_gmres``: the
     Hessians are declared symmetric, not definite).

The example's own limits hold: route 2 within 1e-4 of route 1, route 3
within 1e-6 of it at θ₀.  Float64 throughout.

    PYTHONPATH=src python -m repro_torch.launch.md_sensitivity [--device cpu]

The starting positions are uniform in [0, 1)² from ``--seed`` (numpy);
the JAX example draws them from its own PRNG.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.func

from repro_torch import _device

K_PARTICLES = 32
BOX = 4.0
THETA = 0.6
SWEEP = 8            # diameters in the batched sweep
JVP_LIMIT = 1e-4     # route 2 against route 1 (the example's limit)
SWEEP_LIMIT = 1e-6   # route 3 at θ₀ against route 1 (the example's limit)


def pair_energy(x, theta):
    """Soft-sphere potential with periodic boundary, x in [0,1]^{k×2}."""
    R = x * BOX
    diff = R[:, None, :] - R[None, :, :]
    diff = diff - BOX * torch.round(diff / BOX)          # periodic
    dist = torch.sqrt(torch.sum(diff ** 2, -1) + 1e-12)
    k = x.shape[0]
    half = torch.arange(k, device=x.device) < k // 2
    diam = torch.where(half, torch.ones((), dtype=x.dtype, device=x.device),
                       theta)
    sigma = 0.5 * (diam[:, None] + diam[None, :])
    overlap = torch.clamp_min(1.0 - dist / sigma, 0.0)
    e = (overlap ** 2.5) * (2.0 / 5.0)
    mask = 1.0 - torch.eye(k, dtype=x.dtype, device=x.device)
    return 0.5 * torch.sum(e * mask)


def forces(x, theta):
    """F(x, θ) = −∇ₓE: the optimality residual (a root at the minimum)."""
    return -torch.func.grad(pair_energy)(x, theta)


def fire_minimize(x0, theta, steps: int = 400, dt0: float = 0.02):
    """FIRE descent — the discontinuous optimizer of the paper's §4.4.
    Its step size and mixing stay on the device (no host read a step)."""
    x, v = x0, torch.zeros_like(x0)
    dt = torch.full((), dt0, dtype=x0.dtype, device=x0.device)
    alpha = torch.full((), 0.1, dtype=x0.dtype, device=x0.device)
    zero = torch.zeros_like(v)
    for _ in range(steps):
        f = forces(x, theta)
        power = torch.sum(f * v)
        v = (1 - alpha) * v + alpha * f * (torch.linalg.norm(v) /
                                           (torch.linalg.norm(f) + 1e-12))
        uphill = power < 0
        v = torch.where(uphill, zero, v)
        dt = torch.where(uphill, dt * 0.5, torch.clamp_max(dt * 1.1,
                                                           10 * dt0))
        alpha = torch.where(uphill, torch.full_like(alpha, 0.1),
                            alpha * 0.99)
        v = v + dt * f
        x = x + dt * v / BOX
    return x


def run(x0, *, theta: float = THETA, device=None) -> dict:
    """The three routes from the starting positions ``x0`` ((K, 2), numpy
    or a tensor), in float64 on ``device`` (default ``cuda``).

    Returns the minimum, each route's ∂x*/∂θ, the force residual, the
    polish's iterations, the sweep's mesh size and routed solver, and each
    route's seconds.
    """
    from repro_torch.core import GradientDescent, linear_solve, operators
    from repro_torch.core import root_jvp
    from repro_torch.distributed.sharded_operators import ShardedOperator
    from repro_torch.distributed.spec import P
    from repro_torch.launch.mesh import auto_mesh_size, make_solve_mesh
    from repro_torch.observability import events

    dev = _device.resolve(device)
    f64 = torch.float64
    if not isinstance(x0, torch.Tensor):
        x0 = torch.from_numpy(np.array(x0, dtype=np.float64))
    x0 = x0.to(device=dev, dtype=f64)
    th = torch.tensor(theta, dtype=f64, device=dev)
    one = torch.ones((), dtype=f64, device=dev)
    out = {}

    t0 = time.perf_counter()
    x_star = fire_minimize(x0, th)
    out["fire_s"] = time.perf_counter() - t0
    out["x_star"] = x_star
    out["residual"] = float(torch.linalg.norm(forces(x_star, th)))

    # 1. root_jvp on the force residual at the FIRE minimum
    t0 = time.perf_counter()
    dx = root_jvp(forces, x_star, (th,), (one,), solve="bicgstab",
                  tol=1e-8, ridge=1e-8)
    out["root_jvp_s"] = time.perf_counter() - t0
    out["dx"] = dx

    # 2. the runtime in forward mode, warm-started at the minimum
    solver = GradientDescent(pair_energy, stepsize=2e-3, maxiter=2000,
                             tol=1e-10, solve="bicgstab", ridge=1e-8,
                             linsolve_tol=1e-8)
    t0 = time.perf_counter()
    _, dx_rt = torch.func.jvp(
        lambda dm: solver.run(x_star, dm, mode="jvp")[0], (th,), (one,))
    out["runtime_jvp_s"] = time.perf_counter() - t0
    _, info = solver.run(x_star, th)
    out["polish_iterations"] = int(info.iterations)
    out["polish_converged"] = bool(info.converged)
    out["dx_runtime"] = dx_rt
    out["runtime_drift"] = float(torch.max(torch.abs(dx_rt - dx)))

    # 3. the batched diameter sweep on an auto-sized mesh
    thetas = th + 0.005 * torch.arange(SWEEP, dtype=f64, device=dev)
    flat = x_star.reshape(-1)

    def F_flat(xf, diameter):
        return forces(xf.reshape(x_star.shape), diameter).reshape(-1)

    t0 = time.perf_counter()
    H = torch.func.vmap(
        lambda t: -torch.func.jacfwd(F_flat)(flat, t))(thetas)
    rhs = torch.func.vmap(
        lambda t: torch.func.jacfwd(lambda s: F_flat(flat, s))(t))(thetas)
    n_mesh = auto_mesh_size(SWEEP, flat.shape[0], spd=False,
                            dtype="float64")
    mesh = make_solve_mesh(devices=n_mesh, device=dev)
    batched = ShardedOperator(operators.DenseOperator(H, symmetric=True),
                              mesh, P("data", None))
    routed = []     # the registry solver the sweep ran (its solve event)
    with events.observe(True):
        unsub = events.subscribe(
            lambda ev: routed.append(ev.tags["solver"])
            if ev.kind == "solve" else None)
        try:
            dx_sweep = linear_solve.solve(batched, rhs, method="auto",
                                          tol=1e-8)
        finally:
            unsub()
    out["sweep_s"] = time.perf_counter() - t0
    out["mesh_size"] = n_mesh
    out["sweep_solver"] = routed[-1] if routed else None
    out["dx_sweep"] = dx_sweep
    out["sweep_drift"] = float(torch.max(torch.abs(
        dx_sweep[0].reshape(x_star.shape) - dx)))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    x0 = np.random.RandomState(args.seed).uniform(size=(K_PARTICLES, 2))
    r = run(x0, device=args.device)
    dx, x_star = r["dx"], r["x_star"]
    print(f"force residual at minimum: {r['residual']:.2e}")
    print(f"position sensitivity ∂x*/∂θ: shape {tuple(dx.shape)}, "
          f"L1 norm {float(dx.abs().sum()):.3f}")
    for i in range(4):
        print(f"  particle {i}: pos=({float(x_star[i, 0]):.3f}, "
              f"{float(x_star[i, 1]):.3f})  d pos/d θ=({float(dx[i, 0]):+.4f},"
              f" {float(dx[i, 1]):+.4f})")
    print(f"runtime polish: converged={r['polish_converged']} in "
          f"{r['polish_iterations']} steps; forward-mode sensitivity L1 norm "
          f"{float(r['dx_runtime'].abs().sum()):.3f}, max |Δ| vs root_jvp = "
          f"{r['runtime_drift']:.2e}")
    print(f"batched diameter sweep: B={SWEEP} systems of dim "
          f"{x_star.numel()} on a {r['mesh_size']}-rank mesh (auto-sized, "
          f"{r['sweep_solver']}), max |Δ| vs root_jvp at θ_0 = "
          f"{r['sweep_drift']:.2e}")
    if not (r["runtime_drift"] < JVP_LIMIT and r["sweep_drift"] < SWEEP_LIMIT):
        raise SystemExit(f"the routes disagree: {r['runtime_drift']:.3e} "
                         f"(limit {JVP_LIMIT}), {r['sweep_drift']:.3e} "
                         f"(limit {SWEEP_LIMIT})")
    print("OK")


if __name__ == "__main__":
    main()
