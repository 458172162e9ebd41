"""Public MLA attention op: DeepSeek-V2's prefill attention core.

On CUDA tensors the op launches the hand-written Hopper kernel
(``csrc/mla_attention.cu``, route ``"tc"``); on CPU tensors it runs the
plain PyTorch version (``ref.mla_attention_ref``).  The choice is made by
the tensors' device alone: on a CUDA tensor the op launches the kernel or
raises (bfloat16 at DeepSeek-V2's widths only, ``kernel.supported``).
Forward only.

Inputs are the pieces ``models/layers.mla_apply`` builds: q_nope and q_rope
per head (q_nope may be a strided view of the up-projected query), k_nope
and v per head from the latent, and the rope key (B, S, dr) that every
head shares, which the kernel reads in place from its one copy.

Numerics of the kernel: float32 logits, softmax statistics and
accumulator; P enters the PV product as two bf16 terms (hi and lo, 16
significant bits), as the flash-attention ``tc`` route.

``LAUNCHES`` counts kernel launches and ``LAUNCHES_BY_ROUTE`` by route
(plain ints); each launch is also recorded in an active
``analysis.op_census.Census`` as a custom call.  The op runs in the span
``kernels.mla_attention`` (``observability.spans``; a tracer's span is
tagged with the route).
"""
from __future__ import annotations

import torch

from repro_torch.analysis import op_census
from repro_torch.kernels.mla_attention import kernel
from repro_torch.kernels.mla_attention.ref import mla_attention_ref
from repro_torch.observability.spans import span

LAUNCHES = 0
LAUNCHES_BY_ROUTE = {name: 0 for name in kernel.ROUTES}


def mla_attention(q_nope: torch.Tensor, q_rope: torch.Tensor,
                  k_nope: torch.Tensor, k_rope: torch.Tensor,
                  v: torch.Tensor, scale: float = None) -> torch.Tensor:
    """Causal attention over one prefill's S positions: q_nope (B, S, H,
    dn), q_rope (B, S, H, dr), k_nope (B, S, H, dn), k_rope (B, S, dr),
    v (B, S, H, dv); ``scale`` defaults to 1/√(dn + dr).  Returns
    (B, S, H, dv) in q_nope's type."""
    global LAUNCHES
    if q_nope.device.type not in ("cuda", "cpu"):
        raise ValueError(f"mla_attention runs on CUDA or CPU tensors; got "
                         f"{q_nope.device}")
    ts = (q_nope, q_rope, k_nope, k_rope, v)
    with span("kernels.mla_attention") as sp:
        if q_nope.device.type == "cpu":
            kernel.dims(*ts)
            return mla_attention_ref(*ts, scale=scale)
        if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
            raise RuntimeError("the mla_attention kernel is forward only; "
                               "run it under torch.no_grad()")
        if sp is not None:
            sp.tags["route"] = "tc"
        out = kernel.launch(*ts, scale=scale)
        LAUNCHES += 1
        LAUNCHES_BY_ROUTE["tc"] += 1
        op_census.record_custom_call("mla_attention", ts, out)
        return out
