"""Hand-written Hopper kernels of the PyTorch port.

batched_cg/ — fused batched conjugate gradient over dense small SPD
              systems (d ≤ 512), the implicit-diff backward hot path; CUDA
              C++ for sm_90a, one thread block per instance, with an
              implicit-diff backward (counterpart of the Pallas kernel in
              ``repro/kernels/batched_cg``)

Each kernel ships ``csrc/*.cu`` (the CUDA source), ``kernel.py`` (its
ctypes binding), ``ops.py`` (the public op, which launches the kernel on
CUDA tensors and runs ``ref.py`` on CPU tensors) and ``ref.py`` (the plain
PyTorch version and oracle).  ``_build.py`` compiles the sources with
``nvcc`` at first use.  The other three TPU kernels of the JAX package
(simplex_proj, rwkv_wkv, flash_attention) are not ported yet.
"""
