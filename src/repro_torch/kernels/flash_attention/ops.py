"""Public flash-attention op: the (B, S, H, D) API with GQA.

Counterpart of ``repro/kernels/flash_attention/ops.py::flash_attention``.
On CUDA tensors the op launches a hand-written Hopper kernel; on CPU
tensors it runs the plain PyTorch version (``ref.attention_ref``).  The
choice is made by the tensors' device alone: on a CUDA tensor the op
launches a kernel or raises.  Forward only, as the TPU kernel.

Two kernels, picked by ``kernel.route`` before the launch from dtype, D,
alignment and sizes: ``"tc"`` (``csrc/flash_attention_tc.cu``, bf16
tensor-core tiles fed by TMA) for bfloat16 with D a multiple of 8 in
[64, 256] and 16-byte aligned base addresses and strides, read in place;
``"simt"`` (``csrc/flash_attention.cu``, float32 FMAs on CUDA cores) for
float32 and every other bfloat16 input, made contiguous first.  A failure
on either route raises; neither falls back to the other.

Numerics of the tc route: the logits and the softmax statistics are
float32 as in the TPU kernel, but the PV product takes P in bf16, as two
terms (hi = bf16(p), lo = bf16(p − hi): 16 significant bits) where the
TPU kernel and ``attention_ref`` keep P in float32.  One bf16 term alone
would break the bf16 kernel-against-plain limit (ROADMAP §C).

GQA: k and v keep their Hkv heads; query head h reads kv head
h // (H // Hkv), the layout the JAX op builds with ``jnp.repeat``, without
repeating them in memory.

Causal alignment: when Sq ≠ Sk, query i sees keys j ≤ i (top-left), as the
TPU kernel (``repro/kernels/flash_attention/kernel.py:60``); the JAX
``ref.attention_ref`` is bottom-right (j ≤ i + Sk − Sq).  Both kernels and
the port's ``ref.attention_ref`` are top-left; the models only call it
with Sq = Sk, where the two conventions agree.

``LAUNCHES`` counts kernel launches and ``LAUNCHES_BY_ROUTE`` splits them
by route (plain ints, for showing that a run went through the kernels);
each launch is also recorded in an active ``analysis.op_census.Census``
as a custom call.  The op runs in the span ``kernels.flash_attention``
(``observability.spans``; a tracer's span is tagged with the route), so
its host work (the route choice, the copies) and its launch are named in
a profile.
The JAX op's ``block_q``, ``block_k`` and ``interpret`` are TPU parameters
and have no counterpart here.
"""
from __future__ import annotations

import torch

from repro_torch.analysis import op_census
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.observability.spans import span

LAUNCHES = 0
LAUNCHES_BY_ROUTE = {name: 0 for name in kernel.ROUTES}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D) with H % Hkv == 0.
    Returns (B, Sq, H, D) in q's dtype."""
    global LAUNCHES
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors; got "
                         f"{q.device}")
    with span("kernels.flash_attention") as sp:
        if q.device.type == "cpu":
            return attention_ref(q, k, v, causal=causal)
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            raise RuntimeError("the flash_attention kernel is forward only; "
                               "run it under torch.no_grad()")
        name = kernel.route(q, k, v)
        if sp is not None:
            sp.tags["route"] = name
        if name == "simt":
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out = kernel.launch(q, k, v, causal, route_name=name)
        LAUNCHES += 1
        LAUNCHES_BY_ROUTE[name] += 1
        op_census.record_custom_call("flash_attention", (q, k, v), out)
        return out
