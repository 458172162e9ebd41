"""ctypes binding of the hand-written Hopper batched-CG kernel.

The CUDA source is ``csrc/batched_cg.cu`` (one thread block per instance;
see its header for the design and what bounds it).  :func:`launch` checks
its arguments, allocates the output with ``torch.empty``, launches on
PyTorch's current stream and raises if the launch was refused.  It takes
CUDA tensors only: the plain version for CPU tensors is ``ref.py``, and
the choice between them is made in ``ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_DIM = 512

_FUNCS = {torch.float32: "batched_cg_f32", torch.float64: "batched_cg_f64"}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]


def _function(dtype: torch.dtype):
    fn = getattr(_build.load("batched_cg"), _FUNCS[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch(A: torch.Tensor, b: torch.Tensor, *, tol: float, maxiter: int,
           transpose: bool = False) -> torch.Tensor:
    """Solve ``A[i] x[i] = b[i]`` (``A[i]ᵀ`` with ``transpose``) on the card.

    A: (B, d, d) and b: (B, d), both float32 or both float64, contiguous,
    on one CUDA device, d ≤ 512.  Returns x: (B, d) of b's dtype.
    """
    if not (isinstance(A, torch.Tensor) and isinstance(b, torch.Tensor)):
        raise TypeError("batched_cg kernel takes torch tensors")
    if A.device.type != "cuda" or b.device != A.device:
        raise ValueError(f"batched_cg kernel needs A and b on one CUDA "
                         f"device; got {A.device} and {b.device}")
    if A.dtype not in _FUNCS or b.dtype != A.dtype:
        raise TypeError(f"batched_cg kernel takes float32 or float64 A and "
                        f"b of one dtype; got {A.dtype} and {b.dtype}")
    if A.ndim != 3 or A.shape[1] != A.shape[2] or \
            tuple(b.shape) != tuple(A.shape[:2]):
        raise ValueError(f"batched_cg kernel expects A (B, d, d) and b "
                         f"(B, d); got {tuple(A.shape)} and "
                         f"{tuple(b.shape)}")
    B, d = b.shape
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"batched_cg kernel handles 1 <= d <= {MAX_DIM}; "
                         f"got d={d}")
    if not (A.is_contiguous() and b.is_contiguous()):
        raise ValueError("batched_cg kernel needs contiguous A and b")
    x = torch.empty_like(b)
    if B == 0:
        return x
    fn = _function(A.dtype)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(A.data_ptr(), b.data_ptr(), x.data_ptr(), B, d,
                 float(tol), int(maxiter), int(bool(transpose)), stream)
    if err != 0:
        raise RuntimeError(f"batched_cg kernel launch failed with CUDA "
                           f"error {err}")
    return x
