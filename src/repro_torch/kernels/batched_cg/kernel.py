"""ctypes binding of the hand-written Hopper batched-CG kernels.

Two routes, one library (``csrc/``), and a rule between them,
:func:`layout`, that picks the route from d and the dtype alone:

- ``"C1"``, ``"C2"``, ``"C4"``, ``"C8"`` — ``csrc/batched_cg_cluster.cu``:
  one thread-block cluster of C CTAs an instance, each CTA holding its
  ⌈d/C⌉ rows of A (of Aᵀ for the backward solve) in shared memory for all
  of the instance's iterations, so that A is read from device memory once.
- ``"stream"`` — ``csrc/batched_cg.cu``: one block an instance that reads
  A from device memory on every iteration, for what no cluster holds
  (float64 at d = 512).

A layout that the rule would not pick may be asked for (``launch``'s
``layout=``, for tests and timing); one whose slice does not fit raises,
here and in the C functions.  A refused launch raises too: nothing falls
back to the other route.

:func:`launch` checks its arguments, allocates the output with
``torch.empty``, launches on PyTorch's current stream and raises if the
launch was refused.  It takes CUDA tensors only: the plain version for CPU
tensors is ``ref.py``, and the choice between them is made in ``ops.py``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

MAX_DIM = 512
LAYOUTS = ("C1", "C2", "C4", "C8", "stream")
SMEM_BUDGET = 232448   # bytes of shared memory a block may use: 227 KB
_WARPS = 8             # of a CTA of the cluster route: kThreads / 32
_SLOTS = 3             # kSlots

_STREAM_FUNCS = {torch.float32: "batched_cg_f32",
                 torch.float64: "batched_cg_f64"}
_CLUSTER_FUNCS = {torch.float32: "batched_cg_cluster_f32",
                  torch.float64: "batched_cg_cluster_f64"}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
             ctypes.c_int]


def row_stride(d: int, itemsize: int) -> int:
    """Elements between two rows of a CTA's slice: d rounded up to 128
    bytes, plus 16 (``row_stride`` in the CUDA source)."""
    words = d * itemsize // 4
    return ((words + 31) // 32 * 32 + 4) * 4 // itemsize


def smem_bytes(d: int, itemsize: int, clusters: int) -> int:
    """Shared memory of one CTA of the cluster route with C = ``clusters``:
    its ⌈d/C⌉ rows of A, its x, r and Ap rows, the full p, the warps'
    partials and the slots (``smem_bytes`` in the CUDA source)."""
    rows = -(-d // clusters)
    stride = row_stride(d, itemsize)
    return itemsize * (rows * (stride + 3) + stride + _WARPS + _SLOTS)


def layout(d: int, dtype: torch.dtype) -> str:
    """The kernel's layout for systems of size d in ``dtype``.

    The rule: the smallest cluster size C of 1, 2, 4 and 8 (the portable
    sizes) whose slice fits :data:`SMEM_BUDGET`, named ``"C<C>"``;
    ``"stream"`` when none does.
    """
    itemsize = torch.empty((), dtype=dtype).element_size()
    for c in (1, 2, 4, 8):
        if smem_bytes(d, itemsize, c) <= SMEM_BUDGET:
            return f"C{c}"
    return "stream"


_rule = layout   # launch's ``layout`` argument hides the function


def _function(name: str, argtypes):
    fn = getattr(_build.load("batched_cg"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check_layout(name: str, d: int, dtype: torch.dtype) -> int:
    """C of a cluster layout (0 for the stream route); raises on a name
    that is not a layout and on a slice that does not fit."""
    if name not in LAYOUTS:
        raise ValueError(f"batched_cg kernel layouts are {LAYOUTS}; got "
                         f"{name!r}")
    if name == "stream":
        return 0
    c = int(name[1:])
    itemsize = torch.empty((), dtype=dtype).element_size()
    need = smem_bytes(d, itemsize, c)
    if need > SMEM_BUDGET:
        raise ValueError(f"batched_cg layout {name} at d={d} {dtype} needs "
                         f"{need} bytes of shared memory a CTA, more than "
                         f"{SMEM_BUDGET}")
    return c


def max_active_clusters(d: int, dtype: torch.dtype) -> int:
    """The most clusters of ``layout(d, dtype)`` resident at once on the
    current CUDA device: how many instances run side by side."""
    c = _check_layout(layout(d, dtype), d, dtype)
    if c == 0:
        raise ValueError("the stream route runs no clusters")
    fn = _function("batched_cg_cluster_max_active",
                   [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int)])
    out = ctypes.c_int(0)
    err = fn(torch.empty((), dtype=dtype).element_size(), d, c,
             ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"batched_cg occupancy query failed with CUDA "
                           f"error {err}")
    return out.value


def launch(A: torch.Tensor, b: torch.Tensor, *, tol: float, maxiter: int,
           transpose: bool = False,
           layout: Optional[str] = None) -> torch.Tensor:
    """Solve ``A[i] x[i] = b[i]`` (``A[i]ᵀ`` with ``transpose``) on the card.

    A: (B, d, d) and b: (B, d), both float32 or both float64, contiguous,
    on one CUDA device, d ≤ 512.  ``layout`` (one of :data:`LAYOUTS`)
    overrides the rule's choice.  Returns x: (B, d) of b's dtype.
    """
    if not (isinstance(A, torch.Tensor) and isinstance(b, torch.Tensor)):
        raise TypeError("batched_cg kernel takes torch tensors")
    if A.device.type != "cuda" or b.device != A.device:
        raise ValueError(f"batched_cg kernel needs A and b on one CUDA "
                         f"device; got {A.device} and {b.device}")
    if A.dtype not in _STREAM_FUNCS or b.dtype != A.dtype:
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
    name = _rule(d, A.dtype) if layout is None else layout
    c = _check_layout(name, d, A.dtype)
    if B * max(c, 1) >= 2 ** 31:
        raise ValueError(f"batched_cg kernel takes fewer than 2**31 blocks; "
                         f"got B={B} at layout {name}")
    x = torch.empty_like(b)
    if B == 0:
        return x
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        args = (A.data_ptr(), b.data_ptr(), x.data_ptr(), B, d, float(tol),
                int(maxiter), int(bool(transpose)))
        if c == 0:
            fn = _function(_STREAM_FUNCS[A.dtype],
                           _ARGTYPES + [ctypes.c_void_p])
            err = fn(*args, stream)
        else:
            fn = _function(_CLUSTER_FUNCS[A.dtype],
                           _ARGTYPES + [ctypes.c_int, ctypes.c_void_p])
            err = fn(*args, c, stream)
    if err != 0:
        raise RuntimeError(f"batched_cg kernel launch ({name}) failed with "
                           f"CUDA error {err}")
    return x
