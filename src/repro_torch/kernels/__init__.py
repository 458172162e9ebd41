"""Hand-written Hopper kernels of the PyTorch port.

batched_cg/   — fused batched conjugate gradient over dense small SPD
                systems (d ≤ 512), the implicit-diff backward hot path; CUDA
                C++ for sm_90a, two routes in one library: the cluster route
                (a thread-block cluster of 1, 2, 4 or 8 CTAs an instance, A
                loaded once into their shared memory) and the stream route
                (one block an instance, A re-read from device memory every
                iteration, where no cluster holds it), with an implicit-diff
                backward (counterpart of the Pallas kernel in
                ``repro/kernels/batched_cg``)
simplex_proj/ — row-wise projection onto the scale-simplex by float32
                bisection, the projection of the multiclass-SVM path; CUDA
                C++ for sm_90a, a row in the registers of 8, 16 or 32 lanes
                (``kernel.layout``; shared memory past d = 1024), with the
                closed-form Jacobian as its jvp and backward (counterpart of
                the Pallas kernel in ``repro/kernels/simplex_proj``)
flash_attention/ — forward online-softmax attention on the (B, S, H, D)
                layout with GQA, the dense models' prefill attention; CUDA
                C++ for sm_90a, two routes in one library: ``tc`` (bfloat16
                on the tensor cores, wgmma and TMA, one producer and two
                consumer warpgroups) and ``simt`` (float32 and the other
                bfloat16 shapes, on the CUDA cores) (counterpart of
                ``repro/kernels/flash_attention``)
rwkv_wkv/     — the RWKV-6 WKV recurrence, the RWKV models' prefill time
                mixing; CUDA C++ for sm_90a, two 64-thread blocks a (batch,
                head), each thread keeping an 8 × 4 tile of the state in
                registers, the inputs staged by ``cp.async`` a chunk ahead
                (counterpart of ``repro/kernels/rwkv_wkv``)
mla_attention/ — DeepSeek-V2's MLA prefill attention core: 192-wide query
                and key heads (128 nope + 64 rope, the rope key one vector
                shared by every head), 128-wide values; CUDA C++ for
                sm_90a, the flash_attention ``tc`` design (wgmma and TMA,
                ``hopper.cuh`` shared) with separate key and value widths
                (no TPU counterpart: the JAX package's MLA is einsums)

Each kernel ships ``csrc/*.cu`` (the CUDA source), ``kernel.py`` (its
ctypes binding), ``ops.py`` (the public op, which launches the kernel on
CUDA tensors and runs ``ref.py`` on CPU tensors) and ``ref.py`` (the plain
PyTorch version).  ``_build.py`` compiles the sources with ``nvcc`` at
first use, all at once.  Every TPU kernel of the JAX package has its
counterpart here.
"""
