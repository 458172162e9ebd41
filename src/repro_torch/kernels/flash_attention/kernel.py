"""ctypes binding of the hand-written Hopper flash-attention kernel.

The CUDA source is ``csrc/flash_attention.cu`` (one thread block per
(batch·head, tile of 64 query rows); see its header for the design and
what bounds it).  :func:`launch` checks its arguments, allocates the
output with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch was refused.  It takes CUDA tensors only: the plain
version for CPU tensors is ``ref.py``, and the choice between them is made
in ``ops.py``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

MAX_HEAD_DIM = 256

_FUNCS = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                          ctypes.c_void_p]


def _function(dtype: torch.dtype):
    fn = getattr(_build.load("flash_attention"), _FUNCS[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool = True) -> torch.Tensor:
    """Attention of q over (k, v) on the card, causal top-left.

    q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D) with H % Hkv == 0 and
    D ≤ 256; all float32 or all bfloat16, contiguous, on one CUDA device.
    Returns o: (B, Sq, H, D) of q's dtype.
    """
    ts = (q, k, v)
    if not all(isinstance(t, torch.Tensor) for t in ts):
        raise TypeError("flash_attention kernel takes torch tensors")
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError(f"flash_attention kernel needs q, k, v on one CUDA "
                         f"device; got {[str(t.device) for t in ts]}")
    if q.dtype not in _FUNCS or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype; got "
                        f"{[t.dtype for t in ts]}")
    if any(t.ndim != 4 for t in ts) or k.shape != v.shape or \
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention kernel expects q (B, Sq, H, D) "
                         f"and k, v (B, Sk, Hkv, D); got "
                         f"{[tuple(t.shape) for t in ts]}")
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if Hkv == 0 or H % Hkv != 0:
        raise ValueError(f"flash_attention kernel needs H % Hkv == 0; got "
                         f"H={H} Hkv={Hkv}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel handles 1 <= D <= "
                         f"{MAX_HEAD_DIM}; got D={D}")
    if Sk == 0:
        raise ValueError("flash_attention kernel needs at least one key")
    if B * H >= 2 ** 31 or -(-Sq // 64) >= 2 ** 16:
        raise ValueError(f"flash_attention kernel grid too large: B*H="
                         f"{B * H}, Sq={Sq}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")
    o = torch.empty_like(q)
    if B * Sq * H == 0:
        return o
    fn = _function(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B,
                 Sq, Sk, H, Hkv, D, int(bool(causal)),
                 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA "
                           f"error {err}")
    return o
