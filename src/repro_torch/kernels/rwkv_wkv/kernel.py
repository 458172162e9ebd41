"""ctypes binding of the hand-written Hopper WKV-6 kernel.

The CUDA source is ``csrc/rwkv_wkv.cu`` (two blocks of 64 threads per
(batch, head), each thread keeping an 8 x 4 tile of the state in
registers, the inputs staged by ``cp.async`` a chunk ahead; see its header
for the design and what bounds it).  :func:`launch` checks its arguments, allocates the
outputs with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch was refused.  It takes CUDA tensors only: the plain
version for CPU tensors is ``ref.py``, and the choice between them is made
in ``ops.py``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

HEAD_SIZE = 64     # kN in csrc/rwkv_wkv.cu
CHUNK = 16         # time steps staged at once: kChunk
ALIGN = 16         # bytes: r, k, v and w are copied in 16-byte pieces

_FUNCS = {torch.float32: "rwkv_wkv_f32", torch.bfloat16: "rwkv_wkv_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _function(dtype: torch.dtype):
    fn = getattr(_build.load("rwkv_wkv"), _FUNCS[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           w: torch.Tensor, u: torch.Tensor,
           state0: Optional[torch.Tensor] = None):
    """The WKV-6 recurrence on the card.

    r, k, v: (B, T, H, 64), all float32 or all bfloat16; w: (B, T, H, 64)
    float32; u: (H, 64) float32; state0: (B, H, 64, 64) float32 or None
    (zeros); all contiguous, on one CUDA device, r, k, v and w 16-byte
    aligned (as PyTorch allocates them).  Returns (o (B, T, H, 64)
    of r's dtype, final state (B, H, 64, 64) float32).
    """
    ts = [r, k, v, w, u] + ([] if state0 is None else [state0])
    if not all(isinstance(t, torch.Tensor) for t in ts):
        raise TypeError("rwkv_wkv kernel takes torch tensors")
    if r.device.type != "cuda" or any(t.device != r.device for t in ts):
        raise ValueError(f"rwkv_wkv kernel needs every tensor on one CUDA "
                         f"device; got {[str(t.device) for t in ts]}")
    if r.dtype not in _FUNCS or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"rwkv_wkv kernel takes float32 or bfloat16 r, k, v "
                        f"of one dtype; got {r.dtype}, {k.dtype}, {v.dtype}")
    if any(t.dtype != torch.float32 for t in ts[3:]):
        raise TypeError(f"rwkv_wkv kernel takes float32 w, u and state0; got "
                        f"{[t.dtype for t in ts[3:]]}")
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"rwkv_wkv kernel expects r, k, v, w of one shape "
                         f"(B, T, H, N); got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    B, T, H, N = r.shape
    if N != HEAD_SIZE:
        raise ValueError(f"rwkv_wkv kernel handles head size {HEAD_SIZE}; "
                         f"got {N}")
    if tuple(u.shape) != (H, N):
        raise ValueError(f"rwkv_wkv kernel expects u ({H}, {N}); got "
                         f"{tuple(u.shape)}")
    if state0 is not None and tuple(state0.shape) != (B, H, N, N):
        raise ValueError(f"rwkv_wkv kernel expects state0 ({B}, {H}, {N}, "
                         f"{N}); got {tuple(state0.shape)}")
    if 2 * B * H >= 2 ** 31 or T >= 2 ** 31:
        raise ValueError(f"rwkv_wkv kernel grid too large: B*H={B * H}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("rwkv_wkv kernel needs contiguous tensors")
    if any(t.data_ptr() % ALIGN for t in (r, k, v, w)):
        raise ValueError(f"rwkv_wkv kernel needs r, k, v and w aligned to "
                         f"{ALIGN} bytes")
    o = torch.empty_like(r)
    state = torch.empty(B, H, N, N, dtype=torch.float32, device=r.device)
    if B * H == 0:
        return o, state
    fn = _function(r.dtype)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), None if state0 is None else state0.data_ptr(),
                 o.data_ptr(), state.data_ptr(), B, T, H, stream)
    if err != 0:
        raise RuntimeError(f"rwkv_wkv kernel launch failed with CUDA error "
                           f"{err}")
    return o, state
