"""The port's stochastic inner solvers against the JAX package.

The cases of ``tests/test_stochastic.py`` on one CPU: the sampler's
forward and backward index streams equal JAX's index for index; the
averaged iterate and ``OptInfo`` of ``run_stochastic`` for ``SGD`` /
``MomentumSGD`` / ``Adam`` × ``polyak`` / ``ema`` / ``last``; hypergradients
through ``run()`` (sampled and full backward data, ``neumann_k`` and
``exact``, reverse and forward mode); ``estimate_hypergrad_error``;
``solve_bilevel``'s estimate for a stochastic solver under
``backward="exact"``; ``torch.func.vmap`` of ``grad`` running ONE batched
backward solve; restart replay bit for bit; ``from_stream`` on a stub
stream; and the host adapters.  Inputs are made by numpy from fixed seeds
(the ridge problem of ``tests/test_stochastic.py``: n = 256, d = 8,
B = 16) and fed to both packages in float64.  Iterates and ``OptInfo``
agree to 1e-10; hypergradients and estimates to 1e-8.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.func

from repro import stochastic as jsto
from repro.core import bilevel as jbilevel
from repro_torch import stochastic as tsto
from repro_torch.core import bilevel as tbilevel
from repro_torch.core import linear_solve as tls
from repro_torch.stochastic.solvers import SGDState

TOL = 1e-10
GTOL = 1e-8
F64 = torch.float64


def _ridge_data(seed=0, n=256, d=8, noise=0.1):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)) / np.sqrt(d)
    y = X @ rng.standard_normal(d) + noise * rng.standard_normal(n)
    return X, y


def _jfun(w, batch, lam):
    Xb, yb = batch
    r = Xb @ w - yb
    return 0.5 * jnp.mean(r ** 2) + 0.5 * lam * jnp.sum(w ** 2)


def _tfun(w, batch, lam):
    Xb, yb = batch
    r = Xb @ w - yb
    return 0.5 * torch.mean(r ** 2) + 0.5 * lam * torch.sum(w ** 2)


def _samplers(X, y, B=16, seed=0):
    js = jsto.MinibatchSampler(data=(jnp.asarray(X), jnp.asarray(y)),
                               batch_size=B, seed=seed)
    ts = tsto.MinibatchSampler(data=(X, y), batch_size=B, seed=seed,
                               device="cpu")
    return js, ts


def _schedule(k):
    return 0.5 / (1.0 + 0.02 * k)


def _pair(name, js, ts, **kw):
    return (getattr(jsto, name)(_jfun, sampler=js, **kw),
            getattr(tsto, name)(_tfun, sampler=ts, **kw))


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)


def _lam(v=0.1):
    return jnp.asarray(v), torch.tensor(v, dtype=F64)


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 11])
def test_sampler_indices_equal_jax(seed):
    X, y = _ridge_data(n=64)
    js, ts = _samplers(X, y, seed=seed)
    for step in (0, 1, 17, 1000):
        np.testing.assert_array_equal(js.indices(step), ts.indices(step))
    np.testing.assert_array_equal(js.batch_indices(5, 4),
                                  ts.batch_indices(5, 4))
    for got, want in zip(ts.backward_batches(3), js.backward_batches(3)):
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    for got, want in zip(ts.batch_at(7), js.batch_at(7)):
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_sampler_streams_and_budget():
    X, y = _ridge_data(n=64)
    _, ts = _samplers(X, y, seed=3)
    assert ts.num_examples == 64 and ts.num_batches == 4
    assert not np.array_equal(ts.indices(0), tsto.MinibatchSampler(
        data=(X, y), batch_size=16, seed=4, device="cpu").indices(0))
    # backward stream decorrelated from forward
    assert not np.array_equal(_np(ts.backward_batches(1)[0][0]),
                              _np(ts.gather(ts.indices(0))[0]))
    sgd = tsto.SGD(_tfun, sampler=ts, epochs=3)
    assert sgd.num_steps() == 12
    assert tsto.SGD(_tfun, sampler=ts, steps=7).num_steps() == 7
    assert tsto.SGD(_tfun, sampler=ts).num_steps() == 4
    with pytest.raises(ValueError, match="batch_size"):
        tsto.MinibatchSampler(data=(X, y), batch_size=65, device="cpu")
    with pytest.raises(ValueError, match="leading axis"):
        tsto.MinibatchSampler(data=(X, y[:10]), batch_size=4, device="cpu")


def test_sampler_keeps_tensor_leaves_and_places_numpy_ones():
    X, y = _ridge_data(n=32)
    Xt = torch.from_numpy(X)
    s = tsto.MinibatchSampler(data=(Xt, y), batch_size=8, device="cpu")
    assert s.data[0] is Xt
    assert isinstance(s.data[1], torch.Tensor) and s.data[1].dtype == F64


@pytest.mark.parametrize("stream_kind", ["cfg", "nested"])
def test_from_stream_picks_up_seed(stream_kind):
    cfg = types.SimpleNamespace(seed=5)

    class Stream:
        def batch_at(self, step):
            r = np.random.default_rng(step)
            return (r.integers(0, 32, (8, 4)), r.integers(0, 32, (8, 4)))

    stream = Stream()
    if stream_kind == "cfg":
        stream.cfg = cfg
    else:
        stream = types.SimpleNamespace(stream=types.SimpleNamespace(cfg=cfg),
                                       batch_at=stream.batch_at)
    s = tsto.MinibatchSampler.from_stream(stream, num_steps=4, device="cpu")
    assert s.seed == 5 and s.num_examples == 32 and s.batch_size == 8
    np.testing.assert_array_equal(_np(s.data[0][8:16]),
                                  stream.batch_at(1)[0])


# ---------------------------------------------------------------------------
# run_stochastic against JAX
# ---------------------------------------------------------------------------

SOLVERS = [("SGD", dict(stepsize=_schedule)),
           ("MomentumSGD", dict(stepsize=5e-2, momentum=0.9)),
           ("Adam", dict(stepsize=2e-2))]


@pytest.mark.parametrize("averaging", ["polyak", "ema", "last"])
@pytest.mark.parametrize("name,kw", SOLVERS, ids=[s[0] for s in SOLVERS])
def test_run_stochastic_equals_jax(name, kw, averaging):
    X, y = _ridge_data()
    js, ts = _samplers(X, y)
    jsol, tsol = _pair(name, js, ts, epochs=3, averaging=averaging,
                       average_from=20, **kw)
    jl, tl = _lam()
    wj, ij = jsto.run_stochastic(jsol, jnp.zeros(8), jl)
    wt, it = tsto.run_stochastic(tsol, torch.zeros(8, dtype=F64), tl)
    np.testing.assert_allclose(_np(wt), np.asarray(wj), rtol=0, atol=TOL)
    assert int(it.iterations) == int(ij.iterations) == 48
    np.testing.assert_allclose(float(it.error), float(ij.error), rtol=0,
                               atol=TOL)
    assert bool(it.converged) == bool(ij.converged)
    # OptInfo.error is the full-batch residual at the averaged iterate
    g = torch.func.grad(_tfun)(wt, tsol.sampler.data, tl)
    np.testing.assert_allclose(float(it.error),
                               float(torch.linalg.vector_norm(g)),
                               rtol=1e-12)


def test_unknown_modes_raise():
    X, y = _ridge_data(n=64)
    _, ts = _samplers(X, y)
    with pytest.raises(ValueError, match="averaging"):
        tsto.run_stochastic(tsto.SGD(_tfun, sampler=ts, averaging="mean"),
                            torch.zeros(8, dtype=F64), 0.1)
    with pytest.raises(ValueError, match="backward_data"):
        tsto.SGD(_tfun, sampler=ts, backward_data="half").diff_spec()
    with pytest.raises(ValueError, match="MinibatchSampler"):
        tsto.run_stochastic(tsto.SGD(_tfun), torch.zeros(8, dtype=F64), 0.1)


def test_restart_replays_tail_bit_for_bit():
    X, y = _ridge_data()
    _, ts = _samplers(X, y)
    solver = tsto.SGD(_tfun, sampler=ts, stepsize=lambda k: 0.5 / (
        1.0 + 0.1 * k), averaging="last")
    T, k = 12, 5
    w0, lam = torch.zeros(8, dtype=F64), torch.tensor(0.1, dtype=F64)
    w_full, _ = tsto.run_stochastic(solver, w0, lam, steps=T)
    w_mid, _ = tsto.run_stochastic(solver, w0, lam, steps=k)
    w_tail, info = tsto.run_stochastic(
        solver, w_mid, lam, steps=T - k, start_step=k,
        init_state=SGDState(k, torch.tensor(float("inf"), dtype=F64)))
    assert torch.equal(w_full, w_tail) and int(info.iterations) == T


def test_polyak_restart_with_average_replays_bit_for_bit():
    X, y = _ridge_data()
    _, ts = _samplers(X, y)
    solver = tsto.Adam(_tfun, sampler=ts, stepsize=2e-2, average_from=3)
    w0, lam = torch.zeros(8, dtype=F64), torch.tensor(0.1, dtype=F64)
    w_full, _ = tsto.run_stochastic(solver, w0, lam, steps=10)
    # replay the first 4 steps by hand to get the step-4 state and average
    params, state, avg = w0, solver.init_state(w0, lam), w0
    for t in range(4):
        params, state = solver.update(params, state, ts.batch_at(t), lam)
        avg = tsto.solvers._update_average(solver, avg, params,
                                           state.iter_num)
    w_tail, _ = tsto.run_stochastic(solver, params, lam, steps=6,
                                    start_step=4, init_state=state,
                                    init_average=avg)
    assert torch.equal(w_full, w_tail)


# ---------------------------------------------------------------------------
# implicit differentiation through run()
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backward", ["neumann_k", "exact"])
@pytest.mark.parametrize("backward_data", ["sampled", "full"])
def test_hypergrad_equals_jax(backward_data, backward):
    X, y = _ridge_data()
    js, ts = _samplers(X, y)
    jsol, tsol = _pair("SGD", js, ts, stepsize=_schedule, epochs=3,
                       average_from=16, backward_data=backward_data,
                       backward=backward, backward_iters=10)
    jl, tl = _lam()
    w0j, w0t = jnp.zeros(8), torch.zeros(8, dtype=F64)

    def jsol_t(t):
        return jsol.run(w0j, t)[0]

    def tsol_t(t):
        return tsol.run(w0t, t)[0]

    gj = jax.grad(lambda t: jnp.sum(jsol_t(t) ** 2))(jl)
    gt = torch.func.grad(lambda t: torch.sum(tsol_t(t) ** 2))(tl)
    np.testing.assert_allclose(float(gt), float(gj), rtol=GTOL)
    # reverse mode by torch.autograd as well
    lam = tl.clone().requires_grad_()
    (ga,) = torch.autograd.grad(torch.sum(tsol_t(lam) ** 2), lam)
    np.testing.assert_allclose(float(ga), float(gj), rtol=GTOL)
    _, dwj = jax.jvp(jsol_t, (jl,), (jnp.asarray(1.0),))
    _, dwt = torch.func.jvp(tsol_t, (tl,), (torch.tensor(1.0, dtype=F64),))
    np.testing.assert_allclose(_np(dwt), np.asarray(dwj), rtol=0,
                               atol=GTOL * float(np.abs(dwj).max()))


@pytest.mark.parametrize("backward", ["neumann_k", "exact", "one_step"])
@pytest.mark.parametrize("backward_data", ["sampled", "full"])
def test_estimate_hypergrad_error_equals_jax(backward_data, backward):
    X, y = _ridge_data()
    js, ts = _samplers(X, y)
    jsol, tsol = _pair("SGD", js, ts, stepsize=_schedule, epochs=3,
                       average_from=16, backward_data=backward_data,
                       backward=backward, backward_iters=10)
    jl, tl = _lam()
    wj, _ = jsto.run_stochastic(jsol, jnp.zeros(8), jl)
    wt, _ = tsto.run_stochastic(tsol, torch.zeros(8, dtype=F64), tl)
    ct = np.random.default_rng(7).standard_normal(8)
    for cot_j, cot_t in ((None, None), (jnp.asarray(ct),
                                        torch.from_numpy(ct))):
        ej = jsol.estimate_hypergrad_error(wj, jl, cotangent=cot_j)
        et = tsol.estimate_hypergrad_error(wt, tl, cotangent=cot_t)
        np.testing.assert_allclose(float(et), float(ej), rtol=GTOL,
                                   atol=1e-14)


def test_sampled_operator_is_full_operator_on_one_full_batch():
    """B = n and one backward batch: the sampled system IS the full one."""
    X, y = _ridge_data(n=64)
    _, ts = _samplers(X, y, B=64)
    lam = torch.tensor(0.2, dtype=F64)
    kw = dict(stepsize=0.5, steps=40, averaging="last", backward="exact",
              backward_batches=1, precond=None, linsolve_tol=1e-12)
    sampled = tsto.SGD(_tfun, sampler=ts, **kw)
    full = tsto.SGD(_tfun, sampler=ts, backward_data="full", **kw)
    w0 = torch.zeros(8, dtype=F64)
    g = [torch.func.grad(lambda t, s=s: torch.sum(s.run(w0, t)[0] ** 2))(lam)
         for s in (sampled, full)]
    np.testing.assert_allclose(float(g[0]), float(g[1]), rtol=1e-9)


def test_bilevel_reports_stochastic_estimate_under_exact():
    """solve_bilevel gives a stochastic inner solver's estimate under
    backward="exact" (the sampled operator), equal to JAX's."""
    X, y = _ridge_data(n=64)
    js, ts = _samplers(X, y)
    jsol, tsol = _pair("SGD", js, ts, stepsize=_schedule, epochs=2,
                       average_from=4, backward="exact", precond=None)
    jl, tl = _lam()
    sj = jbilevel.solve_bilevel(lambda w, t: jnp.sum(w ** 2), jsol, jl,
                                jnp.zeros(8), outer_steps=2, outer_lr=1e-2)
    st = tbilevel.solve_bilevel(lambda w, t: torch.sum(w ** 2), tsol, tl,
                                torch.zeros(8, dtype=F64), outer_steps=2,
                                outer_lr=1e-2)
    est = st.inner_info.hypergrad_error_estimate
    assert est is not None and float(est) < 0.5
    np.testing.assert_allclose(float(est),
                               float(sj.inner_info.hypergrad_error_estimate),
                               rtol=GTOL)
    np.testing.assert_allclose(float(st.theta), float(sj.theta), rtol=GTOL)
    np.testing.assert_allclose(_np(st.outer_values),
                               np.asarray(sj.outer_values), rtol=GTOL)


@pytest.fixture
def counting_solver():
    """A registered CG that counts its calls (with their batch_ndim)."""
    calls = []

    def counting_cg(matvec, b, **kw):
        calls.append(kw.get("batch_ndim", 0))
        return tls.solve_cg(matvec, b, **kw)

    tls.register_solver("counting_cg_sto_port", counting_cg,
                        symmetric_only=True, supports_precond=True)
    yield calls
    tls._REGISTRY.pop("counting_cg_sto_port", None)


@pytest.mark.parametrize("backward_data", ["sampled", "full"])
def test_vmap_hypergrad_runs_one_batched_solve(counting_solver,
                                               backward_data):
    X, y = _ridge_data(n=64)
    js, ts = _samplers(X, y)
    tsol = tsto.SGD(_tfun, sampler=ts, stepsize=_schedule, epochs=1,
                    average_from=4, backward="exact",
                    solve="counting_cg_sto_port", precond=None,
                    backward_data=backward_data)
    jsol = jsto.SGD(_jfun, sampler=js, stepsize=_schedule, epochs=1,
                    average_from=4, backward="exact", solve="cg",
                    precond=None, backward_data=backward_data)
    w0 = torch.zeros(8, dtype=F64)

    def loss(t):
        return torch.sum(tsol.run(w0, t)[0] ** 2)

    lams = np.array([0.05, 0.1, 0.2, 0.4])
    g_vmap = torch.func.vmap(torch.func.grad(loss))(torch.from_numpy(lams))
    assert counting_solver == [1], \
        f"expected ONE batched backward solve, ran {counting_solver}"
    counting_solver.clear()
    g_loop = torch.stack([torch.func.grad(loss)(torch.tensor(t, dtype=F64))
                          for t in lams])
    assert counting_solver == [0] * 4
    np.testing.assert_allclose(_np(g_vmap), _np(g_loop), rtol=1e-8)
    g_jax = jax.vmap(jax.grad(lambda t: jnp.sum(
        jsol.run(jnp.zeros(8), t)[0] ** 2)))(jnp.asarray(lams))
    np.testing.assert_allclose(_np(g_vmap), np.asarray(g_jax), rtol=GTOL)


def test_vmap_forward_equals_loop():
    X, y = _ridge_data(n=64)
    _, ts = _samplers(X, y)
    tsol = tsto.Adam(_tfun, sampler=ts, stepsize=2e-2, epochs=2,
                     averaging="ema", ema_decay=0.9)
    w0 = torch.zeros(8, dtype=F64)
    lams = torch.tensor([0.05, 0.1, 0.2], dtype=F64)

    def forward(t):
        w, info = tsto.run_stochastic(tsol, w0, t)
        return w, info.error

    w_vmap, err = torch.func.vmap(forward)(lams)
    for i, t in enumerate(lams):
        w_i, info = tsto.run_stochastic(tsol, w0, t)
        np.testing.assert_allclose(_np(w_vmap[i]), _np(w_i), rtol=1e-12)
        np.testing.assert_allclose(float(err[i]), float(info.error),
                                   rtol=1e-12)


# ---------------------------------------------------------------------------
# host adapters
# ---------------------------------------------------------------------------

def test_host_adapters_follow_run_stochastic_step_by_step():
    X, y = _ridge_data()
    _, ts = _samplers(X, y)
    solver = tsto.MomentumSGD(_tfun, sampler=ts, stepsize=5e-2,
                              averaging="last")
    lam = torch.tensor(0.1, dtype=F64)
    w0 = torch.zeros(8, dtype=F64)
    step = tsto.make_stochastic_train_step(solver, lam)
    carry = (w0, solver.init_state(w0, lam))
    data = tsto.stochastic_data_iter(ts, start_step=0)
    for k in range(6):
        data_step, (xb, yb) = next(data)
        assert data_step == k
        carry, metrics = step(carry, xb, yb)
        assert metrics["step"] == k + 1
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(_tfun(carry[0], (xb, yb), lam)))
        w_k, _ = tsto.run_stochastic(solver, w0, lam, steps=k + 1)
        assert torch.equal(carry[0], w_k)
    # restart-safe: a fresh iterator at step 3 yields the same batch
    s3, (x3, _) = next(tsto.stochastic_data_iter(ts, start_step=3))
    assert s3 == 3 and torch.equal(x3, ts.batch_at(3)[0])
