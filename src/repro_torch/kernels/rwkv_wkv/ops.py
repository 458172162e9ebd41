"""Public WKV-6 op: the (B, T, H, N) API of the model's reference scan.

Counterpart of ``repro/kernels/rwkv_wkv/ops.py::wkv``.  On CUDA tensors the
op launches the hand-written Hopper kernel (``kernel.py`` /
``csrc/rwkv_wkv.cu``, head size 64); on CPU tensors it runs the plain
sequential scan (``ref.wkv_scan_ref``).  The choice is made by the tensors'
device alone: on a CUDA tensor the op launches the kernel or raises.
Forward only, as the TPU kernel.

The kernel reads w, u and state0 in float32: the op widens them to float32
(exactly) when they come in another type, as the TPU kernel's
``astype(float32)`` does, and never rounds w down.  r, k and v keep their
type (float32 or bfloat16, one for all three); the output has r's type and
the final state is float32.  Any T ≥ 1 (the JAX op needs T to be a
multiple of its chunk, min(64, T)).  The kernel copies r, k, v and w in
16-byte pieces: a tensor that does not start on such a boundary (a view
at an odd offset) is copied first.

``LAUNCHES`` counts kernel launches (a plain int, for showing that a run
went through the kernel); each launch is also recorded in an active
``analysis.op_census.Census`` as a custom call.  The JAX op's ``chunk`` and ``interpret`` are
TPU parameters and have no counterpart here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.analysis import op_census
from repro_torch.kernels.rwkv_wkv import kernel
from repro_torch.kernels.rwkv_wkv.ref import wkv_scan_ref

LAUNCHES = 0


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on a ``kernel.ALIGN``-byte boundary."""
    t = t.contiguous()
    return t if t.data_ptr() % kernel.ALIGN == 0 else t.clone()


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, state0: Optional[torch.Tensor] = None):
    """r, k, v, w: (B, T, H, N); u: (H, N); state0: (B, H, N, N) or None.
    Returns (out (B, T, H, N), final state (B, H, N, N) float32) — the
    contract of ``wkv_scan_ref``."""
    global LAUNCHES
    if r.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (r, k, v, w, u)):
            raise RuntimeError("the rwkv_wkv kernel is forward only; run it "
                               "under torch.no_grad()")
        f32 = torch.float32
        args = (_aligned(r), _aligned(k), _aligned(v), _aligned(w.to(f32)),
                u.to(f32).contiguous(),
                None if state0 is None else state0.to(f32).contiguous())
        out = kernel.launch(*args)
        LAUNCHES += 1
        op_census.record_custom_call("rwkv_wkv", args, out)
        return out
    if r.device.type == "cpu":
        return wkv_scan_ref(r, k, v, w, u, state0)
    raise ValueError(f"rwkv_wkv runs on CUDA or CPU tensors; got "
                     f"{r.device}")
