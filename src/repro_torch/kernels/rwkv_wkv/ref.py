"""Plain PyTorch WKV-6 recurrence: the WKV op's CPU path and oracle.

The sequential scan of ``repro/models/rwkv.py::wkv_scan_ref``, in float32,
one time step after another::

    o_t = r_t · (S + diag(u) k_tᵀ v_t)
    S  ← diag(w_t) S + k_tᵀ v_t

``repro_torch.models.rwkv`` re-exports it, as the JAX package shares one
oracle between its model and its kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch._dtensor import replicated_like


def wkv_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor,
                 state0: Optional[torch.Tensor] = None):
    """r, k, v, w: (B, T, H, N), w the decay in (0, 1); u: (H, N) bonus;
    state0: (B, H, N, N) or None (zeros).  Returns (out (B, T, H, N) in r's
    dtype, final state (B, H, N, N) float32)."""
    B, T, H, N = r.shape
    rf, kf, vf, wf = (a.to(torch.float32) for a in (r, k, v, w))
    uf = u.to(torch.float32)[None, :, :, None]
    S = replicated_like(torch.zeros(B, H, N, N, dtype=torch.float32,
                                    device=r.device), r) \
        if state0 is None else state0.to(torch.float32)
    out = []
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]        # (B,H,N,N)
        out.append(torch.einsum("bhn,bhnm->bhm", rf[:, t], S + uf * kv))
        S = wf[:, t, :, :, None] * S + kv
    return torch.stack(out, dim=1).to(r.dtype), S
