"""The port end to end on the CPU.

The port's ``serve --solve-service --device cpu`` runs end to end as a
subprocess; the same request traffic through the JAX and the torch solve
service gives equal solutions (to 1e-8) and equal per-request iteration
counts; the trace the port writes summarizes the same under both
packages' report modules.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.observability import report as jax_report
from repro.runtime import SolveService as JaxSolveService
from repro_torch.observability import report as torch_report
from repro_torch.runtime import SolveService

REPO = Path(__file__).resolve().parents[1]


def test_serve_solve_service_runs_on_cpu(tmp_path):
    trace = tmp_path / "trace.jsonl"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--solve-service",
         "--device", "cpu", "--requests", "8", "--dim", "6",
         "--trace", str(trace)],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "warm: 8 requests d=6 on cpu" in proc.stdout
    assert "warm_started=8" in proc.stdout
    assert "repro_service_requests_total 16" in proc.stdout
    records = torch_report.load_trace(trace)
    summary = torch_report.summarize(records)
    assert summary == jax_report.summarize(jax_report.load_trace(trace))
    assert summary["spans"]["request"]["count"] == 16
    assert summary["events"]["cache_hit"] == 8


def test_serve_refuses_the_lm_path():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode != 0
    assert "--solve-service" in proc.stderr


def _traffic(rng):
    """Mixed dense traffic: SPD at two sizes, nonsymmetric, repeats."""
    reqs = []
    for d in (6, 10, 6, 10, 6):
        M = rng.standard_normal((d, d))
        reqs.append((M @ M.T + d * np.eye(d), rng.standard_normal(d),
                     dict(positive_definite=True)))
    for d in (6, 6):
        A = rng.standard_normal((d, d)) / np.sqrt(d) + 2.0 * np.eye(d)
        reqs.append((A, rng.standard_normal(d), {}))
    return reqs


@pytest.mark.parametrize("cache", [True, False], ids=["cache", "no_cache"])
def test_same_traffic_same_answers(cache):
    rng = np.random.default_rng(11)
    reqs = _traffic(rng)
    kw = {} if cache else dict(cache=None)
    jsvc = JaxSolveService(tol=1e-10, **kw)
    tsvc = SolveService(tol=1e-10, device="cpu", **kw)
    for wave in range(2):                       # the second wave replays
        jf = [jsvc.submit(A, b, **flags) for A, b, flags in reqs]
        tf = [tsvc.submit(A, b, **flags) for A, b, flags in reqs]
        jsvc.flush()
        tsvc.flush()
        for (A, b, _), fj, ft in zip(reqs, jf, tf):
            rj, rt = fj.result(), ft.result()
            np.testing.assert_allclose(np.asarray(rt.x), np.asarray(rj.x),
                                       atol=1e-8)
            assert int(rt.info.iterations) == int(rj.info.iterations)
            assert bool(rt.info.converged) == bool(rj.info.converged)
            assert rt.warm_start == rj.warm_start == (cache and wave == 1)
    assert tsvc.metrics == jsvc.metrics | {
        "queue_wait_sum": tsvc.metrics["queue_wait_sum"],
        "solve_time_sum": tsvc.metrics["solve_time_sum"]}


def test_same_hypergrad_traffic_same_answers():
    rng = np.random.default_rng(12)
    n, d = 16, 5
    X, y = rng.standard_normal((n, d)), rng.standard_normal(n)

    def F(lib, X, y):
        return lambda x, theta: X.T @ (X @ x - y) + theta * x

    Fj = F(jnp, jnp.asarray(X), jnp.asarray(y))
    Ft = F(torch, torch.from_numpy(X), torch.from_numpy(y))
    jsvc = JaxSolveService(cache=None, tol=1e-12)
    tsvc = SolveService(cache=None, tol=1e-12, device="cpu")
    jf, tf = [], []
    for theta in (0.1, 0.5, 1.0, 2.0):
        x_star = np.linalg.solve(X.T @ X + theta * np.eye(d), X.T @ y)
        ct = rng.standard_normal(d)
        for solve in ("cg", "pallas_cg"):
            jf.append(jsvc.submit_hypergrad(
                Fj, jnp.asarray(x_star), (jnp.asarray(theta),),
                jnp.asarray(ct), solve=solve))
            tf.append(tsvc.submit_hypergrad(
                Ft, torch.from_numpy(x_star),
                (torch.tensor(theta, dtype=torch.float64),),
                torch.from_numpy(ct), solve=solve))
    jsvc.flush()
    tsvc.flush()
    assert tsvc.metrics["dispatches"] == jsvc.metrics["dispatches"] == 2
    for fj, ft in zip(jf, tf):
        rj, rt = fj.result(), ft.result()
        np.testing.assert_allclose(rt.x[0].numpy(), np.asarray(rj.x[0]),
                                   atol=1e-8)
        assert int(rt.info.iterations) == int(rj.info.iterations)
