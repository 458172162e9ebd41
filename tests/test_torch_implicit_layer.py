"""The port's DEQ layer (``repro_torch.core.implicit_layer``) against the
JAX package's, at ``examples/deq_block.py``'s size (d = 32, d_ff = 64).

The cell z ← norm(x + ½·tanh(zW₁)W₂), weights and input made by numpy from
a seed, float64 in both packages.  z* within 1e-10 and ``OptInfo``
(iterations equal); gradients of Σz*² with respect to x and the weights
within 1e-8 of ``jax.grad`` for each ``bwd_solve`` and each approximate
``backward`` mode, and forward-mode JVPs against ``jax.jvp``; a batch of
layer inputs under ``torch.func.vmap`` (per-instance iterations equal to
``jax.vmap``'s, one backward solve); the ``diff_spec`` route and its
errors; and the example's own check — the implicit gradient against a
100-layer unrolled backprop within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.func

from repro.core import diff_api as jdiff
from repro.core import implicit_layer as jlayer
from repro_torch.core import diff_api as tdiff
from repro_torch.core import implicit_layer as tlayer
from repro_torch.core import linear_solve as tls

D, DFF = 32, 64
XTOL, GTOL = 1e-10, 1e-8
FWD = dict(fwd_iters=100, fwd_tol=1e-12)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    w = {"w1": 0.9 / np.sqrt(D) * rng.standard_normal((D, DFF)),
         "w2": 0.9 / np.sqrt(DFF) * rng.standard_normal((DFF, D))}
    return w, rng.standard_normal(D), rng.standard_normal((3, D))


def _cell(lib):
    tanh = jnp.tanh if lib == "jax" else torch.tanh
    norm = jnp.linalg.norm if lib == "jax" else torch.linalg.vector_norm

    def cell(z, x, w):
        h = tanh(z @ w["w1"]) @ w["w2"]
        out = x + 0.5 * h
        return out / (1.0 + 0.1 * norm(out))

    return cell


def _jx(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tx(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)


def _losses(**kw):
    def jl(x, w):
        return jnp.sum(jlayer.deq_fixed_point(
            _cell("jax"), jnp.zeros(D), x, w, **FWD, **kw) ** 2)

    def tl(x, w):
        return (tlayer.deq_fixed_point(
            _cell("torch"), torch.zeros(D, dtype=torch.float64), x, w,
            **FWD, **kw) ** 2).sum()

    return jl, tl


def test_forward_and_info_match_jax(inputs):
    w, x, _ = inputs
    zj, ij = jlayer.deq_fixed_point(_cell("jax"), jnp.zeros(D),
                                    jnp.asarray(x), _jx(w), **FWD,
                                    return_info=True)
    zt, it = tlayer.deq_fixed_point(_cell("torch"),
                                    torch.zeros(D, dtype=torch.float64),
                                    torch.from_numpy(x), _tx(w), **FWD,
                                    return_info=True)
    np.testing.assert_allclose(_np(zt), np.asarray(zj), atol=XTOL)
    assert int(it.iterations) == int(ij.iterations)
    assert bool(it.converged) and bool(ij.converged)
    np.testing.assert_allclose(float(it.error), float(ij.error), atol=1e-12)
    for fwd_solver in ("iteration",):
        zj2, ij2 = jlayer.deq_fixed_point(
            _cell("jax"), jnp.zeros(D), jnp.asarray(x), _jx(w),
            fwd_solver=fwd_solver, **FWD, return_info=True)
        zt2, it2 = tlayer.deq_fixed_point(
            _cell("torch"), torch.zeros(D, dtype=torch.float64),
            torch.from_numpy(x), _tx(w), fwd_solver=fwd_solver, **FWD,
            return_info=True)
        np.testing.assert_allclose(_np(zt2), np.asarray(zj2), atol=XTOL)
        assert int(it2.iterations) == int(ij2.iterations)


@pytest.mark.parametrize("kw", [
    dict(), dict(bwd_solve="normal_cg", bwd_iters=200),
    dict(bwd_solve="gmres", bwd_iters=200),
    dict(bwd_solve="bicgstab", bwd_iters=200),
    dict(backward="neumann_k", backward_iters=8),
    dict(backward="one_step"), dict(backward="jacobian_free")],
    ids=["neumann(default)", "normal_cg", "gmres", "bicgstab", "neumann_k8",
         "one_step", "jacobian_free"])
def test_gradients_in_both_modes_match_jax(inputs, kw):
    w, x, _ = inputs
    jl, tl = _losses(**kw)
    gj = jax.grad(jl, argnums=(0, 1))(jnp.asarray(x), _jx(w))
    gt = torch.func.grad(tl, argnums=(0, 1))(torch.from_numpy(x), _tx(w))
    np.testing.assert_allclose(_np(gt[0]), np.asarray(gj[0]), atol=GTOL)
    for k in w:
        np.testing.assert_allclose(_np(gt[1][k]), np.asarray(gj[1][k]),
                                   atol=GTOL)
    # forward mode: the tangent solve, in x and in w
    rng = np.random.default_rng(1)
    dx = rng.standard_normal(D)
    dw = {k: rng.standard_normal(v.shape) for k, v in w.items()}
    _, jj = jax.jvp(jl, (jnp.asarray(x), _jx(w)), (jnp.asarray(dx), _jx(dw)))
    _, jt = torch.func.jvp(tl, (torch.from_numpy(x), _tx(w)),
                           (torch.from_numpy(dx), _tx(dw)))
    np.testing.assert_allclose(float(jt), float(jj), atol=GTOL)


def test_exact_solvers_agree_with_each_other(inputs):
    w, x, _ = inputs
    grads = []
    for solve in ("normal_cg", "gmres", "bicgstab"):
        _, tl = _losses(bwd_solve=solve, bwd_iters=500)
        grads.append(torch.func.grad(tl, argnums=1)(torch.from_numpy(x),
                                                    _tx(w)))
    for g in grads[1:]:
        for k in w:
            np.testing.assert_allclose(_np(g[k]), _np(grads[0][k]),
                                       atol=1e-5)


def test_make_deq_block_under_vmap_matches_jax(inputs):
    """A batch of layer inputs: one masked forward loop (per-instance
    iterations equal to jax.vmap's), one backward solve."""
    w, _, xs = inputs
    kw = dict(**FWD, bwd_solve="normal_cg", bwd_iters=200)
    jb = jlayer.make_deq_block(_cell("jax"), **kw, return_info=True)
    tb = tlayer.make_deq_block(_cell("torch"), **kw, return_info=True)
    zj, ij = jax.vmap(jb, in_axes=(0, None))(jnp.asarray(xs), _jx(w))
    zt, (it, ct) = torch.func.vmap(
        lambda x, w: (lambda z, info: (z, (info.iterations,
                                           info.converged)))(*tb(x, w)),
        in_dims=(0, None))(torch.from_numpy(xs), _tx(w))
    np.testing.assert_allclose(_np(zt), np.asarray(zj), atol=XTOL)
    np.testing.assert_array_equal(_np(it), np.asarray(ij.iterations))
    assert bool(ct.all())

    calls = []

    def counting(matvec, b, **k):
        calls.append(k.get("batch_ndim", 0))
        return tls.solve_normal_cg(matvec, b, **k)

    tls.register_solver("counting_normal_cg_deq", counting)
    try:
        tblock = tlayer.make_deq_block(_cell("torch"), **FWD,
                                       bwd_solve="counting_normal_cg_deq",
                                       bwd_iters=200)
        gt = torch.func.vmap(torch.func.grad(
            lambda x, w: (tblock(x, w) ** 2).sum(), argnums=1),
            in_dims=(0, None))(torch.from_numpy(xs), _tx(w))
    finally:
        tls._REGISTRY.pop("counting_normal_cg_deq", None)
    assert calls == [1]
    jblock = jlayer.make_deq_block(_cell("jax"), **kw)
    gj = jax.vmap(jax.grad(lambda x, w: jnp.sum(jblock(x, w) ** 2),
                           argnums=1), in_axes=(0, None))(jnp.asarray(xs),
                                                          _jx(w))
    for k in w:
        np.testing.assert_allclose(_np(gt[k]), np.asarray(gj[k]), atol=GTOL)


def test_diff_spec_route_and_errors(inputs):
    w, x, _ = inputs
    spec_t = tdiff.ImplicitDiffSpec(solve="bicgstab", maxiter=300, tol=1e-10)
    spec_j = jdiff.ImplicitDiffSpec(solve="bicgstab", maxiter=300, tol=1e-10)
    solver = tlayer.make_deq_solver(_cell("torch"), diff_spec=spec_t, **FWD)
    assert (solver.solve, solver.linsolve_maxiter, solver.linsolve_tol) == \
        ("bicgstab", 300, 1e-10)
    _, tl = _losses(diff_spec=spec_t)
    jl, _ = _losses(diff_spec=spec_j)
    gt = torch.func.grad(tl)(torch.from_numpy(x), _tx(w))
    gj = jax.grad(jl)(jnp.asarray(x), _jx(w))
    np.testing.assert_allclose(_np(gt), np.asarray(gj), atol=GTOL)
    with pytest.raises(ValueError, match="routing-only"):
        tlayer.make_deq_solver(_cell("torch"), diff_spec=tdiff.ImplicitDiffSpec(
            optimality_fun=lambda z, x, w: z))
    with pytest.raises(ValueError, match="fwd_solver"):
        tlayer.make_deq_solver(_cell("torch"), fwd_solver="broyden")
    defaults = tlayer.make_deq_solver(_cell("torch"))
    ref = jlayer.make_deq_solver(_cell("jax"))
    assert type(defaults).__name__ == type(ref).__name__ == \
        "AndersonAcceleration"
    for field in ("maxiter", "tol", "solve", "linsolve_maxiter", "backward",
                  "backward_iters", "mode"):
        assert getattr(defaults, field) == getattr(ref, field), field
    assert tlayer.make_deq_solver(_cell("torch"), mode="vjp").mode == "vjp"


def test_deq_block_example_check(inputs):
    """``examples/deq_block.py`` in torch: the implicit gradient against a
    100-layer unrolled backprop, max |Δ| ≤ 1e-4."""
    w, x, _ = inputs
    cell = _cell("torch")
    xt = torch.from_numpy(x)

    def loss_deq(w):
        z = tlayer.deq_fixed_point(cell, torch.zeros(D, dtype=torch.float64),
                                   xt, w, **FWD, bwd_solve="normal_cg",
                                   bwd_iters=200)
        return (z ** 2).sum()

    def loss_unrolled(w, depth=100):
        z = torch.zeros(D, dtype=torch.float64)
        for _ in range(depth):
            z = cell(z, xt, w)
        return (z ** 2).sum()

    g_deq = torch.func.grad(loss_deq)(_tx(w))
    g_unr = torch.func.grad(loss_unrolled)(_tx(w))
    err = max(float((g_deq[k] - g_unr[k]).abs().max()) for k in w)
    assert err < 1e-4, err
