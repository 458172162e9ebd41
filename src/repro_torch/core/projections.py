"""Differentiable projections onto convex sets (paper Appendix C.1), PyTorch.

Counterpart of ``repro.core.projections``, function by function with the
same signatures and ``theta`` conventions: Euclidean projections
``projection_*`` and Bregman/KL projections ``projection_*_kl``.  All are
tensor compositions, so JVPs/VJPs come from autodiff (``torch.autograd``
and every ``torch.func`` transform); where the paper gives a closed-form
Jacobian (simplex) autodiff of the closed-form solution matches it a.e.
The bisection (``projection_box_section``), pool-adjacent-violators and
Sinkhorn loops are Python loops over tensors with the JAX package's
iteration counts.  ``jnp.maximum`` / ``jnp.minimum`` become
``torch.maximum`` / ``torch.minimum``, which split the derivative at a tie
the same way.

The kernel counterpart of ``projection_simplex`` (50-step float32
bisection on the card) is
``repro_torch.kernels.simplex_proj.projection_simplex_batched``; this
sort-based version is its oracle.
"""
from __future__ import annotations

import torch
import torch.func


def _zero(y: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=y.dtype, device=y.device)


def _vdot(a, b):
    return (a * b).sum()


# ---------------------------------------------------------------------------
# Orthants, boxes, balls
# ---------------------------------------------------------------------------

def projection_non_negative(y, theta=None):
    """C = R^d_+ : proj(y) = max(y, 0) (ReLU)."""
    del theta
    return torch.maximum(y, _zero(y))


def projection_non_negative_kl(y, theta=None):
    """KL projection onto the non-negative orthant: exp(y)."""
    del theta
    return torch.exp(y)


def _clip(y, lo, hi):
    """``jnp.clip``: min(max(y, lo), hi) with scalar or tensor bounds."""
    lo = torch.as_tensor(lo, dtype=y.dtype, device=y.device)
    hi = torch.as_tensor(hi, dtype=y.dtype, device=y.device)
    return torch.minimum(torch.maximum(y, lo), hi)


def projection_box(y, theta):
    """C(θ) = [θ₁, θ₂]^d (scalars or per-coordinate tensors)."""
    lo, hi = theta
    return _clip(y, lo, hi)


def projection_hypercube(y, theta=None):
    """C = [0, 1]^d (or the box ``theta``)."""
    return projection_box(y, (0.0, 1.0) if theta is None else theta)


def projection_l2_ball(y, theta=1.0):
    """C(θ) = {x : ||x||₂ ≤ θ}."""
    norm = torch.sqrt(_vdot(y, y))
    scale = torch.where(norm <= theta, torch.ones_like(norm),
                        theta / torch.clamp_min(norm, 1e-30))
    return scale * y


def projection_linf_ball(y, theta=1.0):
    """C(θ) = {x : ||x||∞ ≤ θ}."""
    return _clip(y, -theta, theta)


def projection_l1_ball(y, theta=1.0):
    """Projection onto the ℓ1 ball via simplex projection of |y| [33]."""
    a = torch.abs(y)
    inside = a.sum() <= theta
    p = projection_simplex(a, theta)
    return torch.where(inside, y, torch.sign(y) * p)


# ---------------------------------------------------------------------------
# Simplex
# ---------------------------------------------------------------------------

def projection_simplex(y, scale=1.0):
    """Euclidean projection onto the simplex {x ≥ 0, Σx = scale}.

    O(d log d) sort-based algorithm [49, 33], row-wise over the last axis.
    Differentiable a.e.; autodiff of this composition yields the
    closed-form Jacobian diag(s) − s sᵀ/|s|₁.
    """
    d = y.shape[-1]
    # -- primal threshold via sort (detached: sort's derivative is
    #    irrelevant, and the derivative is recovered implicitly below) --
    y_sg = y.detach()
    u = torch.sort(y_sg, dim=-1, descending=True).values
    cssv = torch.cumsum(u, dim=-1) - scale
    ind = torch.arange(1, d + 1, dtype=y.dtype, device=y.device)
    cond = u - cssv / ind > 0           # True exactly on the first rho entries
    rho = cond.to(y.dtype).sum(dim=-1)
    tau0 = ((u * cond).sum(dim=-1) - scale) / torch.clamp_min(rho, 1.0)
    # -- differentiable correction: τ is the (1-D) root of
    #    φ(τ) = Σ max(yᵢ − τ, 0) − scale, with φ'(τ) = −|support|.  One
    #    Newton step from the exact τ₀ is an identity on primals but carries
    #    the implicit-function-theorem gradient ∂τ/∂yᵢ = sᵢ/|s| (App. C).
    supp = (y_sg - tau0[..., None]) > 0
    nsupp = torch.clamp_min(supp.to(y.dtype).sum(dim=-1), 1.0)
    zero = _zero(y)
    phi = torch.maximum(y - tau0[..., None], zero).sum(dim=-1) - scale
    tau = tau0 + phi / nsupp
    return torch.maximum(y - tau[..., None], zero)


def projection_simplex_kl(y, scale=1.0):
    """KL (Bregman) projection onto the simplex = softmax (closed form)."""
    return scale * torch.softmax(y, dim=-1)


# ---------------------------------------------------------------------------
# Affine sets, hyperplanes, halfspaces
# ---------------------------------------------------------------------------

def projection_hyperplane(y, theta):
    """C(θ) = {x : aᵀx = b}, θ = (a, b)."""
    a, b = theta
    return y - (_vdot(a, y) - b) / _vdot(a, a) * a


def projection_halfspace(y, theta):
    """C(θ) = {x : aᵀx ≤ b}, θ = (a, b)."""
    a, b = theta
    viol = _vdot(a, y) - b
    return y - torch.maximum(viol, _zero(viol)) / _vdot(a, a) * a


def projection_affine_set(y, theta):
    """C(θ) = {x : Ax = b}, θ = (A, b); A assumed full row rank."""
    A, b = theta
    gram = A @ A.T
    resid = A @ y - b
    return y - A.T @ torch.linalg.solve(gram, resid)


# ---------------------------------------------------------------------------
# Box section (singly-constrained bounded QP) — solved by bisection on the
# dual variable; differentiable via the 1-D root formula ∇x*(θ) = Bᵀ/A.
# ---------------------------------------------------------------------------

def projection_box_section(y, theta, maxiter: int = 80):
    """Project onto {z : α ≤ z ≤ β, wᵀz = c}, θ = (alpha, beta, w, c).

    Dual-primal map L(x, θ)_i = clip(w_i x + y_i, α_i, β_i) with scalar dual
    x root of F(x, θ) = wᵀ L(x, θ) − c, found by ``maxiter`` bisection
    steps (Appendix C).
    """
    alpha, beta, w, c = theta

    def L(x):
        return _clip(w * x + y, alpha, beta)

    def phi(x):
        return _vdot(w, L(x)) - c

    # bracket the root (the bracket carries no derivative: the root's
    # derivative comes from the implicit correction below)
    def absmax(v):
        return torch.abs(torch.as_tensor(v, dtype=y.dtype,
                                         device=y.device)).max()

    with torch.no_grad():
        span = (absmax(y) + absmax(beta) + absmax(alpha) + absmax(c)) / (
            absmax(w) + 1e-12) + 1.0
        lo, hi = -span, span
        for _ in range(maxiter):
            mid = 0.5 * (lo + hi)
            # phi is nondecreasing in x (each clip term is monotone in
            # w_i x with slope w_i², ≥ 0)
            go_right = phi(mid) < 0
            lo = torch.where(go_right, mid, lo)
            hi = torch.where(go_right, hi, mid)
        x = 0.5 * (lo + hi)
    x = _implicit_scalar_root(phi, x)
    return _clip(w * x + y, alpha, beta)


def _implicit_scalar_root(phi, x_hat):
    """Return x̂ with derivatives as if x were the exact root of phi (1-D
    implicit function theorem)."""
    x0 = x_hat.detach()
    g = torch.func.grad(phi)(x0)
    g = torch.where(torch.abs(g) < 1e-12, torch.full_like(g, 1e-12), g)
    # x* ≈ x0 − phi(x0)/phi'(x0): a Newton correction whose derivative
    # implements the implicit function theorem for the parameters in phi
    p = phi(x0)
    return x0 - (p - p.detach()) / g


# ---------------------------------------------------------------------------
# Order simplex / isotonic regression (PAV) — Appendix C
# ---------------------------------------------------------------------------

def _isotonic_pav(y):
    """Pool-adjacent-violators for isotonic regression (non-increasing).

    O(d²): 4d Jacobi-style sweeps, as the JAX package's scan; returns the
    projection of y onto {x₁ ≥ x₂ ≥ ... ≥ x_d}.
    """
    d = y.shape[-1]
    x = y
    for _ in range(4 * d):
        viol = x[:-1] < x[1:]
        avg = 0.5 * (x[:-1] + x[1:])
        left = torch.where(viol, avg, x[:-1])
        right = torch.where(viol, avg, x[1:])
        fixed = torch.cat([left, x[-1:]])
        fixed = torch.cat([fixed[:1], torch.where(viol, right, fixed[1:])])
        x = torch.where(viol.any(), fixed, x)
    return x


def projection_order_simplex(y, theta=(1.0, 0.0)):
    """Project onto {θ₁ ≥ x₁ ≥ ... ≥ x_d ≥ θ₂} = clip(isotonic(y))."""
    hi, lo = theta
    return _clip(_isotonic_pav(y), lo, hi)


# ---------------------------------------------------------------------------
# Transportation polytope (Sinkhorn, KL geometry) — Appendix C
# ---------------------------------------------------------------------------

def projection_transport_kl(y, theta, num_iters: int = 100):
    """KL projection of exp(y) onto U(a, b) = {X1 = a, Xᵀ1 = b, X ≥ 0}.

    ``num_iters`` Sinkhorn iterations in log space; θ = (a, b) marginals.
    Differentiable by unrolling, or wrap with ``custom_fixed_point``.
    """
    a, b = theta
    log_a, log_b = torch.log(a), torch.log(b)
    f = torch.zeros_like(a)
    g = torch.zeros_like(b)
    for _ in range(num_iters):
        f = log_a - torch.logsumexp(y + g[None, :], dim=1)
        g = log_b - torch.logsumexp(y + f[:, None], dim=0)
    return torch.exp(y + f[:, None] + g[None, :])


def projection_birkhoff_kl(y, num_iters: int = 100):
    """KL projection onto the doubly-stochastic (Birkhoff) polytope."""
    d = y.shape[-1]
    u = torch.full((d,), 1.0 / d, dtype=y.dtype, device=y.device)
    return projection_transport_kl(y, (u, u), num_iters)


# ---------------------------------------------------------------------------
# Polyhedra via KKT (generic) are handled by repro_torch.core.optimality.kkt;
# cones for the conic residual map (18):
# ---------------------------------------------------------------------------

def projection_zero_cone(y):
    """Projection onto {0}."""
    return torch.zeros_like(y)


def projection_free_cone(y):
    """Projection onto the whole space (identity)."""
    return y


def projection_second_order_cone(y):
    """Project (t, x) onto {(t, x): ||x|| ≤ t}."""
    t, x = y[0], y[1:]
    nx = torch.sqrt(_vdot(x, x))
    in_cone = nx <= t
    in_polar = nx <= -t
    alpha = (t + nx) / 2.0
    scale = alpha / torch.clamp_min(nx, 1e-30)
    proj = torch.cat([alpha[None], scale * x])
    return torch.where(in_cone, y,
                       torch.where(in_polar, torch.zeros_like(y), proj))
