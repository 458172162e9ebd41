"""Public batched-simplex-projection op with the closed-form Jacobian.

Counterpart of ``repro/kernels/simplex_proj/ops.py``.  Forward: every row
of ``y`` (shape ``(..., d)``) is projected onto {x ≥ 0, Σx = scale} by the
hand-written Hopper kernel (``kernel.py`` / ``csrc/simplex_proj.cu``) when
``y`` is on a CUDA device, and by the plain PyTorch version (``ref.py``)
when it is on the CPU — that choice is made by the tensor's device alone;
on a CUDA tensor the op launches the kernel or raises.  Both compute in
float32 and return ``y``'s dtype.

The bisection is exact but not differentiable, so the op carries the
paper's closed-form Jacobian (App. C)

    ∂proj(y) = diag(s) − s sᵀ / |s|₁,   s = 1[proj(y) > 0]

as both its ``jvp`` (forward mode) and its ``backward`` (the Jacobian is
symmetric, so the VJP is the same formula), and a ``vmap`` rule that folds
the mapped axis into the rows.  With the three, ``torch.autograd``,
``torch.func.grad`` / ``vjp`` / ``jvp`` / ``jacfwd`` / ``jacrev`` and
``torch.func.vmap`` all go through the op, which is what the implicit
backward needs: ``JacobianOperator`` applies ``torch.func.jvp`` / ``vjp``
of a fixed point that contains it, and materializes by ``vmap``.

``LAUNCHES`` counts kernel launches (a plain int, for showing that a run
went through the kernel).  The JAX op's ``interpret`` argument and the
kernel's ``rows_block`` are TPU parameters and have no counterpart here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.simplex_proj import kernel
from repro_torch.kernels.simplex_proj.ref import projection_simplex_rows_ref

LAUNCHES = 0


def _project_rows(y: torch.Tensor, scale: float) -> torch.Tensor:
    """(R, d) rows: the kernel on CUDA tensors, ``ref`` on CPU ones."""
    global LAUNCHES
    if y.device.type == "cuda":
        work = y if y.dtype in (torch.float32, torch.float64) \
            else y.to(torch.float32)
        x = kernel.launch(work.contiguous(), scale)
        LAUNCHES += 1
        return x.to(y.dtype)
    if y.device.type == "cpu":
        return projection_simplex_rows_ref(y, scale)
    raise ValueError(f"simplex_proj runs on CUDA or CPU tensors; got "
                     f"{y.device}")


def _jacobian_apply(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(diag(s) − s sᵀ/max(|s|₁, 1)) t row-wise, s = 1[x > 0]."""
    s = (x > 0).to(t.dtype)
    inner = (s * t).sum(dim=-1, keepdim=True) / torch.clamp_min(
        s.sum(dim=-1, keepdim=True), 1.0)
    return s * (t - inner)


class _ProjectionSimplex(torch.autograd.Function):
    """Row-wise simplex projection with the closed-form Jacobian."""

    @staticmethod
    def forward(y, scale):
        d = y.shape[-1]
        return _project_rows(y.reshape(-1, d), scale).reshape(y.shape)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)
        ctx.save_for_forward(output)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _jacobian_apply(x, g), None

    @staticmethod
    def jvp(ctx, dy, _dscale):
        (x,) = ctx.saved_tensors
        return _jacobian_apply(x, dy)

    @staticmethod
    def vmap(info, in_dims, y, scale):
        if in_dims[0] is None:
            return _ProjectionSimplex.apply(y, scale), None
        return _ProjectionSimplex.apply(y.movedim(in_dims[0], 0), scale), 0


def projection_simplex_batched(y: torch.Tensor,
                               scale: float = 1.0) -> torch.Tensor:
    """y: (..., d) → row-wise projection onto the scale-simplex."""
    return _ProjectionSimplex.apply(y, float(scale))
