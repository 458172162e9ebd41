"""Forward MLA prefill attention: Hopper kernel, binding, op, plain
version."""
from repro_torch.kernels.mla_attention.ops import mla_attention
from repro_torch.kernels.mla_attention.ref import mla_attention_ref
