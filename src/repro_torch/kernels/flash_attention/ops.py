"""Public flash-attention op: the (B, S, H, D) API with GQA.

Counterpart of ``repro/kernels/flash_attention/ops.py::flash_attention``.
On CUDA tensors the op launches the hand-written Hopper kernel
(``kernel.py`` / ``csrc/flash_attention.cu``); on CPU tensors it runs the
plain PyTorch version (``ref.attention_ref``).  The choice is made by the
tensors' device alone: on a CUDA tensor the op launches the kernel or
raises.  Forward only, as the TPU kernel.

GQA: k and v keep their Hkv heads; query head h reads kv head
h // (H // Hkv), the layout the JAX op builds with ``jnp.repeat``, without
repeating them in memory.

Causal alignment: when Sq ≠ Sk, query i sees keys j ≤ i (top-left), as the
TPU kernel (``repro/kernels/flash_attention/kernel.py:60``); the JAX
``ref.attention_ref`` is bottom-right (j ≤ i + Sk − Sq).  Both versions of
this op (the kernel and the port's ``ref.attention_ref``) are top-left; the
models only call it with Sq = Sk, where the two conventions agree.

``LAUNCHES`` counts kernel launches (a plain int, for showing that a run
went through the kernel).  The JAX op's ``block_q``, ``block_k`` and
``interpret`` are TPU parameters and have no counterpart here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

LAUNCHES = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D) with H % Hkv == 0.
    Returns (B, Sq, H, D) in q's dtype."""
    global LAUNCHES
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            raise RuntimeError("the flash_attention kernel is forward only; "
                               "run it under torch.no_grad()")
        out = kernel.launch(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal)
        LAUNCHES += 1
        return out
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    raise ValueError(f"flash_attention runs on CUDA or CPU tensors; got "
                     f"{q.device}")
