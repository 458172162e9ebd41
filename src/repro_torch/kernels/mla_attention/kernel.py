"""ctypes binding of the hand-written Hopper MLA prefill kernel
(``csrc/mla_attention.cu``).

One kernel, one route (``"tc"``): bfloat16 tensor-core tiles (``wgmma``)
fed by TMA, one producer and two consumer warpgroups a block of 128 query
rows, flash_attention's ``tc`` design with a 192-wide QKᵀ (two 64-column
panels of q_nope / k_nope and one of q_rope / k_rope) and a 128-wide PV.
It takes DeepSeek-V2's widths only (nope 128, rope 64, values 128), all
bfloat16, each tensor's base address and strides 16-byte aligned and its
last stride 1 (what TMA needs); strided views are read in place, and the
rope key (B, S, 64) is read by every head from its one copy.  The
attention is causal over one prefill's S positions: queries and keys are
the same positions.

:func:`launch` checks its arguments, allocates the output with
``torch.empty``, launches on PyTorch's current stream and raises if the
launch was refused.  It takes CUDA tensors only: the plain version for
CPU tensors is ``ref.py``, and the choice between them is made in
``ops.py``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

NOPE_DIM, ROPE_DIM, V_DIM = 128, 64, 128
ROUTES = ("tc",)

_FUNC = "mla_attention_tc_bf16"
_Strides3 = ctypes.c_longlong * 3
_Strides2 = ctypes.c_longlong * 2
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
    ctypes.POINTER(ctypes.c_longlong)] * 5 + [ctypes.c_float, ctypes.c_void_p]


def _function():
    fn = getattr(_build.load("mla_attention"), _FUNC)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def dims(q_nope, q_rope, k_nope, k_rope, v) -> Tuple[int, int, int]:
    """(B, S, H) of shapes the MLA core takes (any widths: the plain
    version's contract); raises otherwise."""
    ts = (q_nope, q_rope, k_nope, k_rope, v)
    if not all(isinstance(t, torch.Tensor) for t in ts):
        raise TypeError("mla_attention takes torch tensors")
    if any(t.ndim != 4 for t in (q_nope, q_rope, k_nope, v)) \
            or k_rope.ndim != 3:
        raise ValueError("mla_attention expects q_nope, q_rope, k_nope, v "
                         "(B, S, H, ·) and k_rope (B, S, dr); got "
                         f"{[tuple(t.shape) for t in ts]}")
    B, S, H, dn = q_nope.shape
    dr = q_rope.shape[3]
    if (tuple(q_rope.shape[:3]) != (B, S, H)
            or tuple(k_nope.shape) != (B, S, H, dn)
            or tuple(k_rope.shape) != (B, S, dr)
            or tuple(v.shape[:3]) != (B, S, H)):
        raise ValueError("mla_attention shapes do not agree (a prefill's "
                         "queries and keys are the same S positions): "
                         f"{[tuple(t.shape) for t in ts]}")
    if S == 0:
        raise ValueError("mla_attention needs at least one position")
    return B, S, H


def _tma_ready(t: torch.Tensor) -> bool:
    """Base address and strides 16-byte aligned, last dim contiguous."""
    return (t.data_ptr() % 16 == 0 and t.stride(-1) == 1
            and all(s % 8 == 0 for s in t.stride()[:-1]))


def supported(q_nope, q_rope, k_nope, k_rope, v) -> Optional[str]:
    """None when the kernel takes these tensors, else why not."""
    B, S, H = dims(q_nope, q_rope, k_nope, k_rope, v)
    ts = (q_nope, q_rope, k_nope, k_rope, v)
    if any(t.dtype != torch.bfloat16 for t in ts):
        return f"bfloat16 only; got {[t.dtype for t in ts]}"
    widths = (q_nope.shape[3], q_rope.shape[3], v.shape[3])
    if widths != (NOPE_DIM, ROPE_DIM, V_DIM):
        return (f"nope, rope and value widths {(NOPE_DIM, ROPE_DIM, V_DIM)} "
                f"only; got {widths}")
    if not all(_tma_ready(t) for t in ts):
        return "16-byte aligned base addresses and strides, last stride 1"
    if -(-S // 128) * B * H >= 2 ** 31:
        return f"grid too large: B={B} S={S} H={H}"
    return None


def launch(q_nope: torch.Tensor, q_rope: torch.Tensor, k_nope: torch.Tensor,
           k_rope: torch.Tensor, v: torch.Tensor,
           scale: Optional[float] = None) -> torch.Tensor:
    """The causal MLA core on the card: q_nope (B, S, H, 128), q_rope
    (B, S, H, 64), k_nope (B, S, H, 128), k_rope (B, S, 64), v (B, S, H,
    128), bfloat16 on one CUDA device; ``scale`` defaults to 1/√192.
    Returns o (B, S, H, 128) bfloat16, contiguous."""
    ts = (q_nope, q_rope, k_nope, k_rope, v)
    B, S, H = dims(*ts)
    if q_nope.device.type != "cuda" or any(t.device != q_nope.device
                                           for t in ts):
        raise ValueError("mla_attention kernel needs every tensor on one CUDA "
                         f"device; got {[str(t.device) for t in ts]}")
    why = supported(*ts)
    if why is not None:
        raise ValueError(f"mla_attention kernel: {why}")
    if scale is None:
        scale = 1.0 / math.sqrt(NOPE_DIM + ROPE_DIM)
    o = torch.empty((B, S, H, V_DIM), dtype=q_nope.dtype,
                    device=q_nope.device)
    if B * S * H == 0:
        return o
    with torch.cuda.device(q_nope.device):
        stream = torch.cuda.current_stream(q_nope.device).cuda_stream
        err = _function()(
            *(t.data_ptr() for t in ts), o.data_ptr(), B, S, H,
            _Strides3(*q_nope.stride()[:3]), _Strides3(*q_rope.stride()[:3]),
            _Strides3(*k_nope.stride()[:3]), _Strides2(*k_rope.stride()[:2]),
            _Strides3(*v.stride()[:3]), float(scale), stream)
    if err != 0:
        raise RuntimeError("mla_attention kernel launch failed: "
                           + _describe(err))
    return o


def _describe(err: int) -> str:
    if err == -1000:
        return "the CUDA driver has no cuTensorMapEncodeTiled"
    if err < 0:
        return f"the CUDA driver refused a tensor map (CUresult {-1 - err})"
    return f"CUDA error {err}"
