"""Plain PyTorch masked CG: the batched-CG kernel's CPU path and oracle.

Line-for-line port of ``repro/kernels/batched_cg/ref.py``: masked CG over
a ``(B, d)`` batch from x₀ = 0, one loop for the whole batch, with the
same guards — α = 0 where pᵀAp = 0, β = 0 where rs = 0,
atol² = max(tol²‖b‖², 1e-30), frozen rows stay frozen, compute dtype
promote(dtype, float32) and output dtype ``b.dtype``.
"""
from __future__ import annotations

import torch


def batched_cg_ref(A: torch.Tensor, b: torch.Tensor, tol: float = 1e-6,
                   maxiter: int = 64) -> torch.Tensor:
    """A: (B, d, d) SPD batch; b: (B, d).  Returns x: (B, d)."""
    dtype = torch.promote_types(torch.promote_types(A.dtype, b.dtype),
                                torch.float32)
    out_dtype = b.dtype
    A = A.to(dtype)
    b = b.to(dtype)
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = torch.sum(r * r, dim=-1)
    atol2 = torch.clamp_min(tol * tol * torch.sum(b * b, dim=-1), 1e-30)
    zero = torch.zeros((), dtype=dtype, device=b.device)
    one = torch.ones((), dtype=dtype, device=b.device)

    k = 0
    while k < maxiter and bool(torch.any(rs > atol2)):
        active = rs > atol2
        ap = torch.einsum("bij,bj->bi", A, p)
        denom = torch.sum(p * ap, dim=-1)
        safe = torch.where(denom == 0, one, denom)
        alpha = torch.where(denom == 0, zero, rs / safe)
        alpha = torch.where(active, alpha, zero)[:, None]
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.sum(r * r, dim=-1)
        beta = torch.where(rs == 0, zero,
                           rs_new / torch.where(rs == 0, one, rs))
        p = torch.where(active[:, None], r + beta[:, None] * p, p)
        rs = torch.where(active, rs_new, rs)
        k += 1
    return x.to(out_dtype)
