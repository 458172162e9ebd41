"""Optimality-condition mappings F / fixed-point mappings T (paper Table 1).

Counterpart of ``repro.core.optimality``.  Each factory returns a mapping
with signature ``F(x, *theta)`` (root form) or ``T(x, *theta)``
(fixed-point form), ready for ``custom_root`` / ``custom_fixed_point`` /
``implicit_diff``.  ``jax.grad`` / ``jax.vjp`` / ``jax.jacobian`` become
``torch.func.grad`` / ``vjp`` / ``jacrev``: the implicit-diff layer
evaluates these mappings inside ``torch.func.jvp`` / ``vjp``, and only
``torch.func`` transforms nest (forward-over-reverse for ∂₁F when F is a
gradient).  ``torch.func.grad`` needs ``f`` to return a scalar tensor.

Catalog (paper equation numbers):
  * ``stationary(f)``              — eq. (4): F = ∇₁f
  * ``gradient_descent_fp(f)``     — eq. (5): T = x − η∇₁f
  * ``kkt(f, G, H)``               — eq. (6): stationarity + feasibility + CS
  * ``proximal_gradient_fp(f, prox)``  — eq. (7)
  * ``projected_gradient_fp(f, proj)`` — eq. (9)
  * ``mirror_descent_fp(f, proj_kl, phi)`` — eq. (13)
  * ``newton_fp(G)``               — eq. (14)
  * ``block_proximal_gradient_fp`` — eq. (15)
  * ``conic_residual(cone_proj)``  — eq. (18): homogeneous self-dual embedding
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.func

from repro_torch.core._tree import tree_map


def _grad(f: Callable) -> Callable:
    return torch.func.grad(f, argnums=0)


# ---------------------------------------------------------------------------
# Smooth unconstrained
# ---------------------------------------------------------------------------

def stationary(f: Callable) -> Callable:
    """F(x, θ) = ∇₁f(x, θ) — eq. (4)."""
    return _grad(f)


def gradient_descent_fp(f: Callable, stepsize: float = 1.0) -> Callable:
    """T(x, θ) = x − η ∇₁f(x, θ) — eq. (5); η cancels in the linear system."""
    grad = _grad(f)

    def T(x, *theta):
        return tree_map(lambda xi, gi: xi - stepsize * gi, x,
                        grad(x, *theta))

    return T


# ---------------------------------------------------------------------------
# KKT — eq. (6).  x = (z, nu, lambd); theta = (theta_f, theta_H, theta_G).
# ---------------------------------------------------------------------------

def kkt(f: Callable, G: Optional[Callable] = None,
        H: Optional[Callable] = None) -> Callable:
    """Build the KKT residual for min f(z,θf) s.t. G(z,θG) ≤ 0, H(z,θH) = 0.

    Mirrors paper Fig. 7: stationarity uses VJPs of H and G, feasibility and
    complementary slackness stack below.  ``x`` is a tuple whose members are
    present only for the constraints supplied.
    """
    grad = _grad(f)

    def F(x, theta):
        theta_f = theta[0]
        if H is not None and G is not None:
            z, nu, lambd = x
            theta_H, theta_G = theta[1], theta[2]
        elif H is not None:
            z, nu = x
            theta_H = theta[1]
        elif G is not None:
            z, lambd = x
            theta_G = theta[1]
        else:
            (z,) = x

        stationarity = grad(z, theta_f)
        out = []
        if H is not None:
            _, H_vjp = torch.func.vjp(H, z, theta_H)
            stationarity = stationarity + H_vjp(nu)[0]
        if G is not None:
            _, G_vjp = torch.func.vjp(G, z, theta_G)
            stationarity = stationarity + G_vjp(lambd)[0]
        out.append(stationarity)
        if H is not None:
            out.append(H(z, theta_H))
        if G is not None:
            out.append(lambd * G(z, theta_G))
        return tuple(out)

    return F


# ---------------------------------------------------------------------------
# Proximal / projected gradient fixed points — eqs. (7), (9)
# ---------------------------------------------------------------------------

def proximal_gradient_fp(f: Callable, prox: Callable,
                         stepsize: float = 1.0) -> Callable:
    """T(x, θ) = prox_ηg(x − η∇₁f(x, θf), θg);  θ = (θf, θg)."""
    grad = _grad(f)

    def T(x, theta):
        theta_f, theta_g = theta
        y = tree_map(lambda xi, gi: xi - stepsize * gi, x,
                     grad(x, theta_f))
        return prox(y, theta_g, stepsize)

    return T


def projected_gradient_fp(f: Callable, proj: Callable,
                          stepsize: float = 1.0) -> Callable:
    """T(x, θ) = proj_C(x − η∇₁f(x, θf), θproj);  θ = (θf, θproj)."""
    grad = _grad(f)

    def T(x, theta):
        theta_f, theta_proj = theta
        y = tree_map(lambda xi, gi: xi - stepsize * gi, x,
                     grad(x, theta_f))
        return proj(y, theta_proj)

    return T


# ---------------------------------------------------------------------------
# Mirror descent fixed point — eq. (13)
# ---------------------------------------------------------------------------

def mirror_descent_fp(f: Callable, proj_kl: Callable, phi_grad: Callable,
                      stepsize: float = 1.0) -> Callable:
    """T(x, θ) = proj^φ_C(∇φ(x) − η∇₁f(x, θf), θproj) — paper Fig. 8."""
    grad = _grad(f)

    def T(x, theta):
        theta_f, theta_proj = theta
        y = tree_map(lambda xh, gi: xh - stepsize * gi, phi_grad(x),
                     grad(x, theta_f))
        return proj_kl(y, theta_proj)

    return T


def kl_phi_grad(x, eps: float = 1e-30):
    """∇φ for φ(x) = <x, log x − 1> (KL geometry): log(x)."""
    return torch.log(torch.clamp_min(x, eps))


# ---------------------------------------------------------------------------
# Newton fixed point — eq. (14)
# ---------------------------------------------------------------------------

def newton_fp(G: Callable, stepsize: float = 1.0) -> Callable:
    """T(x, θ) = x − η [∂₁G(x, θ)]⁻¹ G(x, θ) (root finding Newton)."""

    def T(x, *theta):
        g = G(x, *theta)
        J = torch.func.jacrev(G, argnums=0)(x, *theta)
        return x - stepsize * torch.linalg.solve(J, g)

    return T


# ---------------------------------------------------------------------------
# Block proximal gradient — eq. (15)
# ---------------------------------------------------------------------------

def block_proximal_gradient_fp(f: Callable, prox_blocks: Sequence[Callable],
                               stepsizes=None) -> Callable:
    """Block fixed point [T(x, θ)]ᵢ = prox_ηᵢgᵢ(xᵢ − ηᵢ[∇₁f(x, θf)]ᵢ, θgᵢ).

    ``x`` is a tuple of blocks; ``theta`` = (θf, (θg₁, ..., θg_m)).
    """
    grad = _grad(f)
    m = len(prox_blocks)
    if stepsizes is None:
        stepsizes = (1.0,) * m

    def T(x, theta):
        theta_f, theta_gs = theta
        g = grad(x, theta_f)
        return tuple(
            prox_blocks[i](x[i] - stepsizes[i] * g[i], theta_gs[i],
                           stepsizes[i])
            for i in range(m))

    return T


# ---------------------------------------------------------------------------
# Conic programming residual map — eq. (18)
# ---------------------------------------------------------------------------

def conic_residual(cone_proj: Callable) -> Callable:
    """F(x, θ) = ((θ − I) Π + I) x for the homogeneous self-dual embedding.

    ``theta`` is the skew-symmetric data matrix; ``cone_proj`` projects onto
    R^p × K* × R₊ (composition of per-block cone projections).
    """

    def F(x, theta):
        pix = cone_proj(x)
        return theta @ pix - pix + x

    return F


def make_cone_projector(p: int, cone_projs: Sequence[tuple]) -> Callable:
    """Build Π = proj_{R^p × K* × R₊} from per-block (size, projector) pairs.

    The first p coordinates are free; the last coordinate projects onto R₊.
    """

    def proj(x):
        parts = [x[:p]]
        off = p
        for size, blk in cone_projs:
            parts.append(blk(x[off:off + size]))
            off += size
        tail = x[off:]
        parts.append(torch.maximum(tail, torch.zeros((), dtype=x.dtype,
                                                     device=x.device)))
        return torch.cat(parts)

    return proj
