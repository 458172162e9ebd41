"""The port's projections, prox operators and optimality mappings against
the JAX package's, function by function.

Each case builds the same function in both packages from the same numpy
inputs (float64) and compares the values within 1e-10 and the Jacobian in
the case's input — ``torch.func.jacrev`` and ``torch.func.jacfwd`` against
``jax.jacobian`` — within 1e-8.  Inputs sit away from kinks (support
changes, clipping boundaries).  Tuple-valued mappings (KKT, block prox)
are compared through their concatenation.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.func

from repro.core import optimality as jopt
from repro.core import projections as jproj
from repro.core import prox as jprox
from repro_torch.core import optimality as topt
from repro_torch.core import projections as tproj
from repro_torch.core import prox as tprox

VTOL = 1e-10
JTOL = 1e-8

JAX = types.SimpleNamespace(proj=jproj, prox=jprox, opt=jopt,
                            arr=jnp.asarray, exp=jnp.exp, cat=jnp.concatenate)
TORCH = types.SimpleNamespace(proj=tproj, prox=tprox, opt=topt,
                              arr=torch.from_numpy, exp=torch.exp,
                              cat=torch.cat)

rng = np.random.default_rng(0)
Y5 = rng.standard_normal(5)
Y34 = rng.standard_normal((3, 4))
A = rng.standard_normal((2, 5))
POS = np.abs(rng.standard_normal(5)) + 0.1


def _conv(ns, a):
    if isinstance(a, np.ndarray):
        return ns.arr(a)
    if isinstance(a, tuple):
        return tuple(_conv(ns, b) for b in a)
    return a


def _proj(name, *args):
    return lambda ns: (lambda y: getattr(ns.proj, name)(
        y, *[_conv(ns, a) for a in args]))


def _prox(name, *args):
    return lambda ns: (lambda y: getattr(ns.prox, name)(
        y, *[_conv(ns, a) for a in args]))


def _box_section(ns):
    alpha, beta = ns.arr(-0.5 * np.ones(5)), ns.arr(0.8 * np.ones(5))
    w, c = ns.arr(np.array([1.0, 2.0, 0.5, 1.5, 1.0])), 1.3
    return lambda y: ns.proj.projection_box_section(y, (alpha, beta, w, c))


def _transport(ns):
    a = ns.arr(np.array([0.2, 0.3, 0.5]))
    b = ns.arr(np.array([0.1, 0.4, 0.3, 0.2]))
    return lambda y: ns.proj.projection_transport_kl(y, (a, b), num_iters=50)


def _obj(ns):
    X, t = ns.arr(A), ns.arr(np.array([0.4, -0.3]))
    return lambda x, th: 0.5 * ((X @ x - t) ** 2).sum() + \
        th * ns.exp(0.1 * x).sum()


def _stationary(ns):
    return lambda x: ns.opt.stationary(_obj(ns))(x, 0.7)


def _gd_fp(ns):
    return lambda x: ns.opt.gradient_descent_fp(_obj(ns), 0.1)(x, 0.7)


def _kkt(ns):
    Am = ns.arr(A[:, :3])
    H = lambda z, th: Am @ z - th
    G = lambda z, th: z - th
    f = lambda z, th: 0.5 * ((z - th) ** 2).sum() + ns.exp(0.2 * z).sum()
    F = ns.opt.kkt(f, G=G, H=H)
    theta = (ns.arr(np.array([0.1, 0.2, 0.3])), ns.arr(np.array([0.5, -0.2])),
             ns.arr(np.array([1.0, 1.0, 1.0])))
    return lambda v: ns.cat(F((v[:3], v[3:5], v[5:]), theta))


def _pg_prox_fp(ns):
    T = ns.opt.proximal_gradient_fp(_obj(ns), ns.prox.prox_lasso, 0.1)
    return lambda x: T(x, (0.7, 0.05))


def _pg_proj_fp(ns):
    T = ns.opt.projected_gradient_fp(
        _obj(ns), lambda y, tp: ns.proj.projection_simplex(y, tp), 0.1)
    return lambda x: T(x, (0.7, 1.0))


def _md_fp(ns):
    T = ns.opt.mirror_descent_fp(
        _obj(ns), lambda y, tp: ns.proj.projection_simplex_kl(y, tp),
        ns.opt.kl_phi_grad, 0.1)
    return lambda x: T(x, (0.7, 1.0))


def _kl_phi_grad(ns):
    return ns.opt.kl_phi_grad


def _newton_fp(ns):
    G = lambda x, th: x ** 3 + th * x - 1.0
    return lambda x: ns.opt.newton_fp(G, 0.8)(x, 2.0)


def _block_fp(ns):
    X = ns.arr(A)
    f = lambda x, th: 0.5 * ((X[:, :2] @ x[0] + X[:, 2:] @ x[1]) ** 2).sum() \
        + th * (x[0] ** 2).sum()
    T = ns.opt.block_proximal_gradient_fp(
        f, (ns.prox.prox_lasso, ns.prox.prox_ridge), (0.1, 0.2))
    return lambda v: ns.cat(T((v[:2], v[2:]), (0.7, (0.05, 0.3))))


def _conic(ns):
    proj = ns.opt.make_cone_projector(
        2, [(3, ns.proj.projection_second_order_cone),
            (2, ns.proj.projection_non_negative)])
    S = rng_skew
    return lambda x: ns.opt.conic_residual(proj)(x, ns.arr(S))


_m = np.random.default_rng(1).standard_normal((8, 8))
rng_skew = _m - _m.T

# name -> (build(ns) -> fun, input)
CASES = {
    "projection_non_negative": (_proj("projection_non_negative"), Y5),
    "projection_non_negative_kl": (_proj("projection_non_negative_kl"), Y5),
    "projection_box": (_proj("projection_box", (-0.5, 0.7)), Y5),
    "projection_hypercube": (_proj("projection_hypercube"), Y5 * 0.8 + 0.3),
    "projection_l2_ball_out": (_proj("projection_l2_ball", 0.5), Y5),
    "projection_l2_ball_in": (_proj("projection_l2_ball", 10.0), Y5),
    "projection_linf_ball": (_proj("projection_linf_ball", 0.6), Y5),
    "projection_l1_ball": (_proj("projection_l1_ball", 1.0), Y5),
    "projection_simplex": (_proj("projection_simplex"), Y34),
    "projection_simplex_scale": (_proj("projection_simplex", 2.5), Y34),
    "projection_simplex_kl": (_proj("projection_simplex_kl", 2.0), Y34),
    "projection_hyperplane": (_proj("projection_hyperplane",
                                    (A[0], 0.3)), Y5),
    "projection_halfspace": (_proj("projection_halfspace", (A[0], -2.0)), Y5),
    "projection_affine_set": (_proj("projection_affine_set",
                                    (A, np.array([0.2, -0.1]))), Y5),
    "projection_box_section": (_box_section, Y5),
    "projection_order_simplex": (_proj("projection_order_simplex",
                                       (1.5, -1.0)), Y5),
    "projection_transport_kl": (_transport, Y34),
    "projection_birkhoff_kl": (_proj("projection_birkhoff_kl", 50),
                               Y34[:, :3]),
    "projection_zero_cone": (_proj("projection_zero_cone"), Y5),
    "projection_free_cone": (_proj("projection_free_cone"), Y5),
    "projection_second_order_cone": (_proj("projection_second_order_cone"),
                                     np.array([0.5, 1.0, -0.7, 0.2])),
    "projection_second_order_cone_in": (
        _proj("projection_second_order_cone"),
        np.array([2.0, 1.0, -0.7, 0.2])),
    "prox_none": (_prox("prox_none"), Y5),
    "prox_lasso": (_prox("prox_lasso", 0.3, 0.5), Y5),
    "prox_non_negative_lasso": (_prox("prox_non_negative_lasso", 0.3, 0.5),
                                Y5),
    "prox_elastic_net": (_prox("prox_elastic_net", (0.3, 2.0), 0.5), Y5),
    "prox_ridge": (_prox("prox_ridge", 2.0, 0.5), Y5),
    "prox_group_lasso": (_prox("prox_group_lasso", 0.7, 0.5), Y34),
    "prox_log_barrier": (_prox("prox_log_barrier", 0.3, 0.5), Y5),
    "stationary": (_stationary, Y5),
    "gradient_descent_fp": (_gd_fp, Y5),
    "kkt": (_kkt, rng.standard_normal(8)),
    "proximal_gradient_fp": (_pg_prox_fp, Y5),
    "projected_gradient_fp": (_pg_proj_fp, Y5),
    "mirror_descent_fp": (_md_fp, POS),
    "kl_phi_grad": (_kl_phi_grad, POS),
    "newton_fp": (_newton_fp, POS),
    "block_proximal_gradient_fp": (_block_fp, Y5),
    "conic_residual": (_conic, rng.standard_normal(8)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_value_and_jacobian_match_jax(name):
    build, y = CASES[name]
    fj, ft = build(JAX), build(TORCH)
    vj = np.asarray(fj(jnp.asarray(y)))
    vt = ft(torch.from_numpy(y))
    assert vt.dtype == torch.float64
    np.testing.assert_allclose(vt.numpy(), vj, atol=VTOL, rtol=0)
    jac_j = np.asarray(jax.jacobian(fj)(jnp.asarray(y)))
    jac_rev = torch.func.jacrev(ft)(torch.from_numpy(y))
    jac_fwd = torch.func.jacfwd(ft)(torch.from_numpy(y))
    np.testing.assert_allclose(jac_rev.numpy(), jac_j, atol=JTOL, rtol=0)
    np.testing.assert_allclose(jac_fwd.numpy(), jac_j, atol=JTOL, rtol=0)


def test_prox_registry_matches_jax():
    assert sorted(tprox.PROX_OPERATORS) == sorted(jprox.PROX_OPERATORS)
    for name, fn in tprox.PROX_OPERATORS.items():
        assert fn.__name__ == jprox.PROX_OPERATORS[name].__name__


def test_box_section_derivative_in_theta_matches_jax():
    """The bisection's root carries the implicit 1-D derivative in θ."""
    def make(ns):
        alpha, beta = ns.arr(-0.5 * np.ones(5)), ns.arr(0.8 * np.ones(5))
        w = ns.arr(np.array([1.0, 2.0, 0.5, 1.5, 1.0]))
        y = ns.arr(Y5)
        return lambda c: ns.proj.projection_box_section(y, (alpha, beta, w, c))

    c = np.array(1.3)
    want = np.asarray(jax.jacobian(make(JAX))(jnp.asarray(c)))
    got = torch.func.jacrev(make(TORCH))(torch.from_numpy(c))
    np.testing.assert_allclose(got.numpy(), want, atol=JTOL, rtol=0)
