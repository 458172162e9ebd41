"""ctypes binding of the hand-written Hopper simplex-projection kernel.

The CUDA source is ``csrc/simplex_proj.cu`` (one warp per row; see its
header for the design and what bounds it).  :func:`launch` checks its
arguments, allocates the output with ``torch.empty``, launches on
PyTorch's current stream and raises if the launch was refused.  It takes
CUDA tensors only: the plain version for CPU tensors is ``ref.py``, and the
choice between them is made in ``ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_DIM = 32768
ITERS = 50         # bisection steps: kIters in csrc/simplex_proj.cu

_FUNCS = {torch.float32: "simplex_proj_f32", torch.float64: "simplex_proj_f64"}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_double, ctypes.c_void_p]


def _function(dtype: torch.dtype):
    fn = getattr(_build.load("simplex_proj"), _FUNCS[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch(y: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Project every row of ``y`` onto {x ≥ 0, Σx = scale} on the card.

    y: (R, d), float32 or float64, contiguous, on a CUDA device,
    1 ≤ d ≤ 32768.  Computes in float32; returns x of y's dtype.
    """
    if not isinstance(y, torch.Tensor):
        raise TypeError("simplex_proj kernel takes a torch tensor")
    if y.device.type != "cuda":
        raise ValueError(f"simplex_proj kernel needs y on a CUDA device; got "
                         f"{y.device}")
    if y.dtype not in _FUNCS:
        raise TypeError(f"simplex_proj kernel takes float32 or float64 y; "
                        f"got {y.dtype}")
    if y.ndim != 2:
        raise ValueError(f"simplex_proj kernel expects y (R, d); got "
                         f"{tuple(y.shape)}")
    R, d = y.shape
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"simplex_proj kernel handles 1 <= d <= {MAX_DIM}; "
                         f"got d={d}")
    if R >= 2 ** 31:
        raise ValueError(f"simplex_proj kernel handles fewer than 2**31 rows;"
                         f" got {R}")
    if not y.is_contiguous():
        raise ValueError("simplex_proj kernel needs a contiguous y")
    x = torch.empty_like(y)
    if R == 0:
        return x
    fn = _function(y.dtype)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(y.data_ptr(), x.data_ptr(), R, d, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"simplex_proj kernel launch failed with CUDA "
                           f"error {err}")
    return x
