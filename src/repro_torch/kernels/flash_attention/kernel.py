"""ctypes binding of the hand-written Hopper flash-attention kernels.

Two kernels, one library (``csrc/``), and a route between them that
:func:`route` picks before the launch from the dtype, the head dim, the
alignment and the sizes alone:

- ``"tc"`` — ``csrc/flash_attention_tc.cu``: bf16 tensor-core tiles
  (``wgmma``) fed by TMA, one producer and two consumer warpgroups a block
  of 128 query rows.  It takes bfloat16 q, k, v with D a multiple of 8 from
  64 to 256, each tensor's base address and strides 16-byte aligned and
  its head-dim stride 1 (what TMA needs), and fewer than 2³¹ blocks of
  128 query rows.
  Strided views are read in place.
- ``"simt"`` — ``csrc/flash_attention.cu``: the CUDA-core kernel (float32
  FMAs in register tiles).  It takes float32, and the bfloat16 inputs the
  tc route does not (D below 64 or not a multiple of 8, a misaligned
  view), contiguous.

The route is explicit: a launch on the tc route that the CUDA driver or
the card refuses raises; it never falls back to the other route.

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

MAX_HEAD_DIM = 256
# Heads narrower than one 64-column panel (D = 8, 16 of the smoke configs;
# every full config has D >= 64) stay on simt by the route's contract.  The
# tc kernel would pad them to 64 columns, a TMA box wider than the tensor,
# which is not checked on the card; the simt kernel's bf16 instantiation
# stays for D not a multiple of 8 and misaligned views in any case.
TC_MIN_HEAD_DIM = 64
ROUTES = ("tc", "simt")

_SIMT_FUNCS = {torch.float32: "flash_attention_f32",
               torch.bfloat16: "flash_attention_bf16"}
_SIMT_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_void_p]
_TC_FUNC = "flash_attention_tc_bf16"
_Strides = ctypes.c_longlong * 3
_TC_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.POINTER(ctypes.c_longlong)] * 3 + [ctypes.c_int, ctypes.c_float,
                                              ctypes.c_void_p]


def _function(name: str, argtypes):
    fn = getattr(_build.load("flash_attention"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _dims(q, k, v) -> Tuple[int, int, int, int, int, int]:
    """(B, Sq, Sk, H, Hkv, D) of valid q, k, v; raises on what neither
    kernel takes."""
    ts = (q, k, v)
    if not all(isinstance(t, torch.Tensor) for t in ts):
        raise TypeError("flash_attention kernel takes torch tensors")
    if q.dtype not in _SIMT_FUNCS or any(t.dtype != q.dtype for t in ts):
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
    return B, Sq, Sk, H, Hkv, D


def _tma_ready(t: torch.Tensor) -> bool:
    """Base address and strides 16-byte aligned, head dim contiguous."""
    return (t.data_ptr() % 16 == 0 and t.stride(3) == 1
            and all(s % 8 == 0 for s in t.stride()[:3]))


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``"tc"`` or ``"simt"`` for these q, k, v, on any device (a pure
    function of dtype, D, alignment, strides and sizes); raises on what
    neither kernel takes (D > 256, mismatched shapes or dtypes)."""
    B, Sq, _, H, _, D = _dims(q, k, v)
    if (q.dtype == torch.bfloat16 and D % 8 == 0
            and TC_MIN_HEAD_DIM <= D <= MAX_HEAD_DIM
            and -(-Sq // 128) * B * H < 2 ** 31
            and all(_tma_ready(t) for t in (q, k, v))):
        return "tc"
    return "simt"


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool = True,
           route_name: Optional[str] = None) -> torch.Tensor:
    """Attention of q over (k, v) on the card, causal top-left.

    q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D) with H % Hkv == 0 and
    D ≤ 256; all float32 or all bfloat16, on one CUDA device.  The kernel
    is ``route_name`` (``route(q, k, v)`` when None); the tc route raises
    on inputs :func:`route` does not send there, the simt route needs
    contiguous tensors.  Returns o: (B, Sq, H, D) of q's dtype, contiguous.
    """
    B, Sq, Sk, H, Hkv, D = _dims(q, k, v)
    ts = (q, k, v)
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError(f"flash_attention kernel needs q, k, v on one CUDA "
                         f"device; got {[str(t.device) for t in ts]}")
    chosen = route(q, k, v)
    name = chosen if route_name is None else route_name
    if name not in ROUTES:
        raise ValueError(f"flash_attention route must be one of {ROUTES}; "
                         f"got {name!r}")
    if name == "tc" and chosen != "tc":
        raise ValueError("flash_attention tc route takes bfloat16 q, k, v "
                         "with D a multiple of 8 in [64, 256] and 16-byte "
                         "aligned base addresses and strides")
    if name == "simt":
        if B * H >= 2 ** 31 or -(-Sq // 64) >= 2 ** 16:
            raise ValueError(f"flash_attention kernel grid too large: B*H="
                             f"{B * H}, Sq={Sq}")
        if not all(t.is_contiguous() for t in ts):
            raise ValueError("flash_attention simt kernel needs contiguous "
                             "q, k, v")
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if B * Sq * H == 0:
        return o
    scale = 1.0 / math.sqrt(D)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if name == "tc":
            fn = _function(_TC_FUNC, _TC_ARGTYPES)
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     B, Sq, Sk, H, Hkv, D,
                     *(_Strides(*t.stride()[:3]) for t in ts),
                     int(bool(causal)), scale, stream)
        else:
            fn = _function(_SIMT_FUNCS[q.dtype], _SIMT_ARGTYPES)
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     B, Sq, Sk, H, Hkv, D, int(bool(causal)), scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {name} kernel launch failed: "
                           + _describe(err))
    return o


def _describe(err: int) -> str:
    if err == -1000:
        return "the CUDA driver has no cuTensorMapEncodeTiled"
    if err < 0:
        return f"the CUDA driver refused a tensor map (CUresult {-1 - err})"
    return f"CUDA error {err}"
