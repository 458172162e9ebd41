"""Public batched-CG op with an implicit-differentiation backward.

Counterpart of ``repro/kernels/batched_cg/ops.py``.  Forward: a
hand-written Hopper kernel solves the whole ``(B, d, d)`` batch of SPD
systems when the tensors are on a CUDA device, and the plain PyTorch
version (``ref.py``) when they are on the CPU — that choice is made by the
tensors' device alone; on a CUDA tensor the op launches a kernel or
raises.  ``kernel.layout(d, dtype)`` picks the kernel before the launch:
the cluster route (``csrc/batched_cg_cluster.cu``, layouts ``"C1"`` …
``"C8"``: A held in the shared memory of a thread-block cluster) for
every system whose slice fits, the stream route (``csrc/batched_cg.cu``,
``"stream"``: A read from device memory every iteration) for the rest
(float64 at d = 512).  Backward: x = A⁻¹b is implicitly defined by
Ax − b = 0, so

    u  = A⁻ᵀ g          (one more batched solve, the same kernel on Aᵀ)
    ∂b = u,   ∂A = −u xᵀ

``layout=`` picks the kernel's layout: ``None`` keeps the rule, a name of
``kernel.LAYOUTS`` is passed to the kernel, and ``"auto"`` resolves on
the host, before the launch, through ``analysis.autotune.choose_layout``
(the measured argmin of the tuning cache; the rule on a cold cache).  The
forward and the backward solve launch the same layout.  On CPU tensors
the argument is ignored: the plain version has no layouts.

``LAUNCHES`` counts every kernel launch, forward and backward, and
``LAUNCHES_BY_LAYOUT`` splits them by layout (plain ints, for showing
that a run went through the kernels).  Each launch is also recorded in
an active ``analysis.op_census.Census`` as a custom call.

The JAX op's ``block_b``, ``interpret`` and ``pad_lanes`` arguments are
TPU tile parameters (VMEM tile height, Pallas interpret mode, 128-lane
padding) and have no counterpart here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import _device
from repro_torch.analysis import autotune, op_census
from repro_torch.core.operators import LinearOperator, ravel_view
from repro_torch.kernels.batched_cg import kernel
from repro_torch.kernels.batched_cg.ref import batched_cg_ref

LAUNCHES = 0
LAUNCHES_BY_LAYOUT = {name: 0 for name in kernel.LAYOUTS}


def _compute_dtype(A: torch.Tensor, b: torch.Tensor) -> torch.dtype:
    return torch.promote_types(torch.promote_types(A.dtype, b.dtype),
                               torch.float32)


def _solve(A: torch.Tensor, b: torch.Tensor, tol: float, maxiter: int,
           transpose: bool = False,
           layout: Optional[str] = None) -> torch.Tensor:
    """One batched solve: a kernel on CUDA tensors (``layout``, or the
    rule's), ``ref`` on CPU ones."""
    global LAUNCHES
    if A.device.type == "cuda":
        dtype = _compute_dtype(A, b)
        name = kernel.layout(A.shape[-1], dtype) if layout is None \
            else layout
        A, b_in = A.to(dtype).contiguous(), b.to(dtype).contiguous()
        x = kernel.launch(A, b_in, tol=tol, maxiter=maxiter,
                          transpose=transpose, layout=name)
        LAUNCHES += 1
        LAUNCHES_BY_LAYOUT[name] += 1
        op_census.record_custom_call("batched_cg", (A, b_in), x)
        return x.to(b.dtype)
    if A.device.type == "cpu":
        return batched_cg_ref(A.transpose(1, 2) if transpose else A, b,
                              tol=tol, maxiter=maxiter)
    raise ValueError(f"batched_cg runs on CUDA or CPU tensors; got "
                     f"{A.device}")


class _BatchedCG(torch.autograd.Function):
    """x = A⁻¹ b with the implicit-function backward."""

    @staticmethod
    def forward(A, b, tol, maxiter, layout):
        return _solve(A, b, tol, maxiter, layout=layout)

    @staticmethod
    def setup_context(ctx, inputs, output):
        A, _, tol, maxiter, layout = inputs
        ctx.save_for_backward(A, output)
        ctx.tol, ctx.maxiter, ctx.layout = tol, maxiter, layout

    @staticmethod
    def backward(ctx, g):
        A, x = ctx.saved_tensors
        u = _solve(A, g, ctx.tol, ctx.maxiter, transpose=True,
                   layout=ctx.layout)
        dA = -u[:, :, None] * x[:, None, :]
        return dA, u, None, None, None


def batched_cg(A, b, *, tol: float = 1e-6, maxiter: Optional[int] = None,
               device=None, layout: Optional[str] = None):
    """Solve the batch of SPD systems A[i] x[i] = b[i].

    Args:
      A: (B, d, d) symmetric positive-definite operators, d ≤ 512 on the
        card — or an SPD ``LinearOperator``, which materializes (O(1) for
        dense/structured operators, d probing matvecs otherwise) with ``b``
        the matching pytree of right-hand sides.
      b: (B, d) right-hand sides ((batched) pytree for operator input).
      tol: relative residual tolerance per instance.
      maxiter: CG iteration cap (default: d, the exact-arithmetic bound).
      device: where to solve; ``None`` means ``cuda`` (raises on a host
        without one).  Inputs are moved there.
      layout: the kernel's layout on CUDA tensors: ``None`` (the rule,
        ``kernel.layout``), a name of ``kernel.LAYOUTS``, or ``"auto"``
        (``autotune.choose_layout``: the tuning cache's measured argmin,
        the rule on a cold cache).  A layout whose slice does not fit
        raises.  Ignored on CPU tensors.

    Differentiable in A and b through the implicit-diff backward (operator
    input: in b, through the materialized matrix).  Computes in
    promote(dtype, float32) and returns ``b``'s dtype.
    """
    if isinstance(A, LinearOperator):
        if A.symmetric is False:
            raise ValueError(f"batched_cg requires an SPD operator; {A!r} "
                             "declares symmetric=False")
        view = ravel_view(A, b, A.batch_ndim)
        dense = A.materialize()
        if A.batch_ndim == 0:
            dense = dense[None]
        x = batched_cg(dense, view.b, tol=tol, maxiter=maxiter,
                       device=device, layout=layout)
        return view.to_tree(x)
    dev = _device.resolve(device)
    A = torch.as_tensor(A).to(dev)
    b = torch.as_tensor(b).to(dev)
    if A.ndim != 3 or A.shape[1] != A.shape[2] or \
            tuple(b.shape) != tuple(A.shape[:2]):
        raise ValueError(f"batched_cg expects A (B, d, d) and b (B, d); got "
                         f"{tuple(A.shape)} and {tuple(b.shape)}")
    if layout is not None and layout != "auto" and \
            layout not in kernel.LAYOUTS:
        raise ValueError(f"batched_cg layout must be None, 'auto' or one of "
                         f"{kernel.LAYOUTS}; got {layout!r}")
    if A.device.type != "cuda":
        layout = None
    elif layout == "auto":
        layout = autotune.choose_layout(A.shape[0], A.shape[-1],
                                        _compute_dtype(A, b))
    if maxiter is None:
        maxiter = A.shape[-1]
    return _BatchedCG.apply(A, b, float(tol), int(maxiter), layout)
