"""Hand-written Hopper kernels of the PyTorch port.

batched_cg/   — fused batched conjugate gradient over dense small SPD
                systems (d ≤ 512), the implicit-diff backward hot path; CUDA
                C++ for sm_90a, one thread-block cluster per instance with
                A in its shared memory (one block per instance, A read from
                device memory, where no cluster holds it), with an
                implicit-diff backward (counterpart of the Pallas kernel in
                ``repro/kernels/batched_cg``)
simplex_proj/ — row-wise projection onto the scale-simplex by float32
                bisection, the projection of the multiclass-SVM path; CUDA
                C++ for sm_90a, one warp per row, with the closed-form
                Jacobian as its jvp and backward (counterpart of the Pallas
                kernel in ``repro/kernels/simplex_proj``)
flash_attention/ — forward online-softmax attention on the (B, S, H, D)
                layout with GQA, the dense models' prefill attention; CUDA
                C++ for sm_90a, one thread block per (batch·head, 64 query
                rows) (counterpart of ``repro/kernels/flash_attention``)
rwkv_wkv/     — the RWKV-6 WKV recurrence, the RWKV models' prefill time
                mixing; CUDA C++ for sm_90a, one thread block per (batch,
                head) with the 64×64 state in registers (counterpart of
                ``repro/kernels/rwkv_wkv``)

Each kernel ships ``csrc/*.cu`` (the CUDA source), ``kernel.py`` (its
ctypes binding), ``ops.py`` (the public op, which launches the kernel on
CUDA tensors and runs ``ref.py`` on CPU tensors) and ``ref.py`` (the plain
PyTorch version).  ``_build.py`` compiles the sources with ``nvcc`` at
first use, all four at once.  Every TPU kernel of the JAX package has
its counterpart here.
"""
