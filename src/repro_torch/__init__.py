"""repro_torch — the PyTorch / CUDA port of ``repro``.

A second package beside the JAX reference ``repro``, laid out module for
module like it (``repro_torch.core.operators`` ↔ ``repro.core.operators``
and so on).  It imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``.  Entry points that take host data run on ``cuda`` unless the
caller passes ``device="cpu"``.

Ported so far: the linear operators, the solve registry, the
implicit-diff API, the solver runtime and the bilevel driver (``core``);
the stochastic inner solvers (``stochastic``); the roofline model, the
tuning cache behind dispatch and the operation census (``analysis``); the
observability layer; the solve service, the LM serving engine and the
serve steps (``runtime``); the dense and RWKV-6 models (``models``,
``configs``); the launcher (``launch.serve``); ``interop`` for moving
problem data, state and model weights between the packages; and the four
kernels, written by hand in CUDA for Hopper (``kernels``).  ROADMAP.md
lists what is still to port.
"""

__all__ = ["analysis", "configs", "core", "interop", "kernels", "launch",
           "models", "observability", "runtime", "stochastic"]
