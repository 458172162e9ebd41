"""Row-wise simplex projection: Hopper kernel, binding, op, plain version."""
from repro_torch.kernels.simplex_proj.ops import projection_simplex_batched
from repro_torch.kernels.simplex_proj.ref import projection_simplex_rows_ref
