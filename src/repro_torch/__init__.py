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
distributed layer on ``torch.distributed`` — sharded operators and
solvers, sharding rules, the pipeline schedule (``distributed``) and the
mesh builders (``launch.mesh``); the observability layer; the solve
service, the LM serving engine, the serve steps, the train step and loop
and fault tolerance (``runtime``); every decoder family of the model zoo
with its loss and rematerialisation (``models``, ``configs``); the
optimizers, schedules and gradient compression (``optim``); the data
stream (``data``); checkpoints in the reference's file format
(``checkpoint``); the launchers (``launch.serve``, ``launch.train``);
``interop`` for moving problem data, state, model weights and training
state between the packages; and the four kernels, written by hand in CUDA
for Hopper (``kernels``).  ROADMAP.md lists what is still to port.
"""

__all__ = ["analysis", "checkpoint", "configs", "core", "data",
           "distributed", "interop", "kernels", "launch", "models",
           "observability", "optim", "runtime", "stochastic"]
