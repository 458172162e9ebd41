"""Plain PyTorch bisection: the simplex-projection kernel's CPU path.

The same computation as ``repro/kernels/simplex_proj/kernel.py``: in
float32 whatever the input type, ``kernel.ITERS`` (50) bisection steps on
φ(τ) = Σ max(y − τ, 0) − scale over the bracket hi = max(y),
lo = min(max(y) − scale, min(y) − scale/d), output max(y − τ, 0) cast back
to the input type.  The port's CUDA kernel bisects the same bracket but
stops once no value lies inside it and takes τ in closed form from the
support, which agrees with the 50 steps to float32 rounding.  The
sort-based oracle is ``projection_simplex_ref``, the reference's name for
``repro_torch.core.projections.projection_simplex``.
"""
from __future__ import annotations

import torch

from repro_torch.core.projections import \
    projection_simplex as projection_simplex_ref  # noqa: F401
from repro_torch.kernels.simplex_proj.kernel import ITERS


def projection_simplex_rows_ref(y: torch.Tensor,
                                scale: float = 1.0) -> torch.Tensor:
    """y: (..., d) — project every row onto the scale-simplex."""
    yf = y.to(torch.float32)
    d = yf.shape[-1]
    hi = yf.amax(dim=-1)
    lo = torch.minimum(hi - scale, yf.amin(dim=-1) - scale / d)
    zero = torch.zeros((), dtype=torch.float32, device=y.device)
    for _ in range(ITERS):
        mid = 0.5 * (lo + hi)
        phi = torch.maximum(yf - mid[..., None], zero).sum(dim=-1) - scale
        go_right = phi > 0                        # τ too small
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, mid)
    tau = 0.5 * (lo + hi)
    return torch.maximum(yf - tau[..., None], zero).to(y.dtype)
