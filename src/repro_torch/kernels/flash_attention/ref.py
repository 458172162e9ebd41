"""Plain PyTorch attention: the flash-attention op's CPU path and oracle,
and the models' plain attention (``models.layers._sdpa``).

The semantics of ``repro/models/layers.py::_sdpa`` and of the TPU kernel:
q scaled by 1/√D in float32, float32 logits, −1e30 on masked entries,
float32 softmax, output in q's dtype.  k and v may have fewer heads than
q: query head h reads kv head h // (H // Hkv), as
``jnp.repeat(k, H // Hkv, axis=2)`` lays them out.

The causal mask keeps key j for query i when j ≤ i: the top-left alignment
of the TPU kernel (``repro/kernels/flash_attention/kernel.py:60``) and of
the port's CUDA kernel.  The JAX ``kernels/flash_attention/ref.py`` is
bottom-right (j ≤ i + Sk − Sq); the two agree when Sq = Sk, which is the
only case the models call.
"""
from __future__ import annotations

import math

import torch

from repro_torch._dtensor import replicated_like

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D) with H % Hkv == 0.
    Returns (B, Sq, H, D) in q's dtype."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = (q.to(torch.float32) / math.sqrt(D)).reshape(B, Sq, Hkv, H // Hkv,
                                                       D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32))
    if causal:
        mask = (torch.arange(Sk, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None])
        logits = torch.where(replicated_like(mask, logits), logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(torch.float32))
    return out.reshape(B, Sq, H, D).to(q.dtype)
