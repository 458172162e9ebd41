"""Proximity operators (paper Appendix C.2), PyTorch.

Counterpart of ``repro.core.prox``: closed-form tensor compositions,
differentiable a.e. by autodiff.  Signature convention:
``prox(y, hyperparams, scaling=1.0)`` computes

    argmin_x  (1/2)||x − y||² + scaling · g(x, hyperparams).
"""
from __future__ import annotations

import torch


def _relu(v):
    return torch.maximum(v, torch.zeros((), dtype=v.dtype, device=v.device))


def prox_none(y, hyperparams=None, scaling=1.0):
    """prox of g = 0: the identity."""
    del hyperparams, scaling
    return y


def prox_lasso(y, lam=1.0, scaling=1.0):
    """Soft thresholding: prox of scaling·λ‖x‖₁ (λ may be per-coordinate)."""
    thr = scaling * lam
    return torch.sign(y) * _relu(torch.abs(y) - thr)


def prox_non_negative_lasso(y, lam=1.0, scaling=1.0):
    """prox of scaling·λ‖x‖₁ + indicator(x ≥ 0)."""
    return _relu(y - scaling * lam)


def prox_elastic_net(y, hyperparams=(1.0, 1.0), scaling=1.0):
    """prox of scaling·(λ‖x‖₁ + (γ/2)‖x‖²)."""
    lam, gamma = hyperparams
    st = prox_lasso(y, lam, scaling)
    return st / (1.0 + scaling * gamma)


def prox_ridge(y, gamma=1.0, scaling=1.0):
    """prox of scaling·(γ/2)‖x‖²."""
    return y / (1.0 + scaling * gamma)


def prox_group_lasso(y, lam=1.0, scaling=1.0):
    """Block soft thresholding on the last axis (one group per row)."""
    thr = scaling * lam
    norm = torch.sqrt((y * y).sum(dim=-1, keepdim=True))
    return _relu(1.0 - thr / torch.clamp_min(norm, 1e-30)) * y


def prox_log_barrier(y, mu=1.0, scaling=1.0):
    """prox of −scaling·μ Σ log(xᵢ): positive root of x² − xy − sμ = 0."""
    s = scaling * mu
    return 0.5 * (y + torch.sqrt(y * y + 4.0 * s))


PROX_OPERATORS = {
    "none": prox_none,
    "lasso": prox_lasso,
    "nn_lasso": prox_non_negative_lasso,
    "elastic_net": prox_elastic_net,
    "ridge": prox_ridge,
    "group_lasso": prox_group_lasso,
    "log_barrier": prox_log_barrier,
}
