"""Plain PyTorch MLA attention core: the MLA op's CPU path and the oracle
of its Hopper kernel.

DeepSeek-V2's prefill attention after the up-projections, per head h:
logits = (q_nope·k_nope + q_rope·k_rope) · scale, a query of width
dn + dr = 192 against a key of the same width whose dr = 64 rope columns
are one vector shared by every head; causal over one prefill's S
positions (key j visible to query i when j ≤ i); −1e30 on masked entries;
float32 logits, softmax and weighted sum of the values (width dv = 128);
output in q's type.  It computes what ``models/layers._mla_core`` computes
for a prefill.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def mla_attention_ref(q_nope: torch.Tensor, q_rope: torch.Tensor,
                      k_nope: torch.Tensor, k_rope: torch.Tensor,
                      v: torch.Tensor, scale: float = None) -> torch.Tensor:
    """q_nope (B, S, H, dn), q_rope (B, S, H, dr), k_nope (B, S, H, dn),
    k_rope (B, S, dr), v (B, S, H, dv).  ``scale`` defaults to
    1/√(dn + dr).  Returns (B, S, H, dv) in q_nope's type."""
    f32 = torch.float32
    S = q_nope.shape[1]
    if scale is None:
        scale = (q_nope.shape[-1] + q_rope.shape[-1]) ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q_nope.to(f32), k_nope.to(f32))
    logits = logits + torch.einsum("bqhd,bkd->bhqk", q_rope.to(f32),
                                   k_rope.to(f32))
    logits = logits * scale
    pos = torch.arange(S, device=q_nope.device)
    logits = torch.where(pos[None, :] <= pos[:, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(f32))
    return out.to(q_nope.dtype)
