"""Batched CG over dense SPD systems: Hopper kernel, binding, op, oracle."""
from repro_torch.kernels.batched_cg.ops import batched_cg
from repro_torch.kernels.batched_cg.ref import batched_cg_ref
