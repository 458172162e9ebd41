"""ctypes binding of the hand-written Hopper simplex-projection kernel.

The CUDA source is ``csrc/simplex_proj.cu`` (a few lanes per row and a
bisection that stops once the support is known; see its header for the
design and what bounds it).  :func:`layout` is the one rule that picks the
kernel's layout for a row length; :func:`launch` checks its arguments,
allocates the output with ``torch.empty``, launches on PyTorch's current
stream and raises if the launch was refused.  It takes CUDA tensors only:
the plain version for CPU tensors is ``ref.py``, and the choice between
them is made in ``ops.py``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

MAX_DIM = 32768
ITERS = 50         # bisection steps (at most, in the kernel): kIters
MAX_REG_DIM = 1024  # longest row held in registers
VALUES = 16        # values a lane on the register path, up to d = 512
MIN_LANES = 8      # fewest lanes a row on the register path

_FUNCS = {torch.float32: "simplex_proj_f32", torch.float64: "simplex_proj_f64"}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_void_p]


def layout(d: int) -> Tuple[int, int]:
    """(lanes a row, values a lane) of the kernel for rows of length d.

    The rule: a row of d ≤ 1024 gets the fewest lanes L of 8, 16 and 32
    that hold it at 16 values a lane (32 values on the whole warp past
    d = 512), in registers; a longer row gets a warp and shared memory,
    reported as (32, 0).  L stops at 8 below, because a warp of more rows
    runs until the slowest of them ends its bisection.
    """
    if d > MAX_REG_DIM:
        return 32, 0
    if d > 32 * VALUES:
        return 32, 2 * VALUES
    lanes = MIN_LANES
    while lanes * VALUES < d:
        lanes *= 2
    return lanes, VALUES


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
    lanes, values = layout(d)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(y.data_ptr(), x.data_ptr(), R, d, lanes, values,
                 float(scale), stream)
    if err != 0:
        raise RuntimeError(f"simplex_proj kernel launch failed with CUDA "
                           f"error {err}")
    return x
