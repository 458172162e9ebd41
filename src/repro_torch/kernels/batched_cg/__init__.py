"""Batched CG over dense SPD systems: Hopper kernels (cluster and stream
routes), binding, op, oracle."""
from repro_torch.kernels.batched_cg.ops import batched_cg
from repro_torch.kernels.batched_cg.ref import batched_cg_ref
