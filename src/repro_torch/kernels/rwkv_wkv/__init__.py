"""RWKV-6 WKV recurrence: Hopper kernel, binding, op, plain version."""
from repro_torch.kernels.rwkv_wkv.ops import wkv
from repro_torch.kernels.rwkv_wkv.ref import wkv_scan_ref
