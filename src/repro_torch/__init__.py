"""repro_torch — the PyTorch / CUDA port of ``repro``.

A second package beside the JAX reference ``repro``, laid out module for
module like it (``repro_torch.core.operators`` ↔ ``repro.core.operators``
and so on).  It imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``.  Entry points that take host data run on ``cuda`` unless the
caller passes ``device="cpu"``.

Ported so far: the linear operators, the solve registry and the
implicit-diff API (``core``), the observability layer, the batched-CG
kernel (a hand-written CUDA kernel for Hopper, ``kernels.batched_cg``),
the solve service (``runtime``) and its launcher (``launch.serve``), and
``interop`` for moving problem data and state between the packages.
ROADMAP.md lists what is still to port.
"""
