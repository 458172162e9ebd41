"""Mamba-2 (SSD) blocks — for the Zamba2 hybrid backbone.

Counterpart of ``repro/models/mamba.py``.  State-space duality form (Dao &
Gu, 2024): per head with head dim P and state size Nst,

    h_t = exp(a_t) · h_{t−1} + (b_t ⊗ x_t) · Δ_t      h ∈ R^{Nst×P}
    y_t = c_tᵀ h_t + D · x_t

with scalar per-head decay a_t = −Δ_t·exp(A_log) (data-dependent via Δ).
Computed as the reference's chunked parallel scan, in plain PyTorch (the
reference computes it in plain ``jnp``; no kernel stands behind it):
intra-chunk dense products, the inter-chunk recurrence a Python loop over
the chunks where the reference has a ``lax.scan``.

Each of the reference's three-operand einsums is written as explicit
pairwise steps (an elementwise product, then one contraction), so the
contraction order, the peak memory and the float32 rounding do not depend
on whether ``opt_einsum`` is installed; no (Bb, nc, L, L, H, P) tensor is
made.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import _device
from repro_torch._dtensor import merge_last, replicated_like, split_last
from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.models.layers import (dense_init, rmsnorm, rmsnorm_init,
                                       torch_dtype)

Params = Dict[str, Any]

__all__ = ["mamba_init", "ssd_scan_ref", "mamba_apply", "mamba_state_init"]


def _dims(cfg: ArchConfig):
    s = cfg.ssm or SSMConfig()
    d_inner = s.expand * cfg.d_model
    nheads = s.num_heads or d_inner // s.head_dim
    return s, d_inner, nheads


def mamba_init(gen, cfg: ArchConfig, device=None) -> Params:
    s, d_inner, nheads = _dims(cfg)
    d, dt = cfg.d_model, torch_dtype(cfg)
    conv_dim = d_inner + 2 * s.state_size
    f32 = torch.float32
    conv_w = torch.randn(s.conv_width, conv_dim, generator=gen,
                         device=device, dtype=f32) * 0.1
    return {
        # fused input projection: [z (gate), x, B, C, dt]
        "w_in": dense_init(gen, d, 2 * d_inner + 2 * s.state_size + nheads,
                           dt, device),
        "conv_w": conv_w.to(dt),
        "conv_b": torch.zeros(conv_dim, dtype=dt, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads, dtype=f32,
                                          device=device)),
        "D": torch.ones(nheads, dtype=f32, device=device),
        "dt_bias": torch.zeros(nheads, dtype=f32, device=device),
        "norm": rmsnorm_init(d_inner, dt, device),
        "w_out": dense_init(gen, d_inner, d, dt, device),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv1d.  x: (B, T, C); w: (K, C).
    state: (B, K−1, C) trailing context for decode.  Returns (y, new_state).

    The reference's order: a sum of K shifted products, each rounded in
    x's type, then the bias and SiLU."""
    K = w.shape[0]
    pad = torch.zeros_like(x[:, :K - 1]) if state is None \
        else state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    T = x.shape[1]
    y = sum(xp[:, i:i + T] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return F.silu(y + b), new_state


def ssd_scan_ref(x, a, B, C, D, state0=None, chunk: int = 64):
    """Chunked SSD scan.

    x: (Bb, T, H, P) inputs (already Δ-scaled); a: (Bb, T, H) log-decay
    (negative); B, C: (Bb, T, Nst); D: (H,).
    Returns (y (Bb, T, H, P) in x's type, final_state (Bb, H, Nst, P)
    float32)."""
    Bb, T, H, P = x.shape
    Nst = B.shape[-1]
    f32 = torch.float32
    if state0 is None:
        state0 = replicated_like(torch.zeros(Bb, H, Nst, P, dtype=f32,
                                             device=x.device), x)
    assert T % chunk == 0, (T, chunk)
    nc = T // chunk

    xf = x.to(f32).reshape(Bb, nc, chunk, H, P)
    af = a.to(f32).reshape(Bb, nc, chunk, H)
    Bf = B.to(f32).reshape(Bb, nc, chunk, Nst)
    Cf = C.to(f32).reshape(Bb, nc, chunk, Nst)

    cum_a = torch.cumsum(af, dim=2)                       # (Bb,nc,L,H)
    total_a = cum_a[:, :, -1]                             # (Bb,nc,H)

    # --- intra-chunk ---
    # decay from step j to step i (i >= j): exp(cum_a_i - cum_a_j)
    rel = cum_a[:, :, :, None, :] - cum_a[:, :, None, :, :]   # (Bb,nc,L,L,H)
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=x.device))[None, None, :, :, None]
    # mask the EXPONENT (not the value): exp of the masked upper triangle
    # overflows, and inf · 0 = nan under a gradient
    decay = torch.exp(torch.where(replicated_like(mask, rel), rel,
                                  -math.inf))
    cb = torch.einsum("bnis,bnjs->bnij", Cf, Bf)              # (Bb,nc,L,L)
    w_ij = cb[..., None] * decay                              # (Bb,nc,L,L,H)
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", w_ij, xf)
    del rel, decay, w_ij          # free the (L, L, H) chunk tensors early

    # --- chunk states: S_n = sum_j exp(cum_a_last - cum_a_j) B_j x_j ---
    dec_to_end = torch.exp(total_a[:, :, None, :] - cum_a)    # (Bb,nc,L,H)
    chunk_state = torch.einsum("bnjs,bnjhp->bnhsp", Bf,
                               dec_to_end[..., None] * xf)

    # --- inter-chunk recurrence over the chunks ---
    S = state0
    prev = []
    for n in range(nc):
        prev.append(S)                                    # state *before*
        S = torch.exp(total_a[:, n])[..., None, None] * S + chunk_state[:, n]
    prev_states = torch.stack(prev, dim=1)                # (Bb,nc,H,Nst,P)

    # --- contribution of the carried state to each position ---
    dec_from_start = torch.exp(cum_a)                     # (Bb,nc,L,H)
    y_inter = torch.einsum("bnis,bnhsp->bnihp", Cf, prev_states) \
        * dec_from_start[..., None]

    y = (y_intra + y_inter).reshape(Bb, T, H, P)
    y = y + D[None, None, :, None] * x.to(f32)
    return y.to(x.dtype), S


def mamba_apply(params: Params, cfg: ArchConfig, x: torch.Tensor,
                state: Optional[Tuple] = None, chunk: int = 64):
    """Mamba-2 block.  state = (conv_state, ssm_state) for decode.
    Returns (out, new_state).  T not a multiple of ``chunk`` scans in
    chunks of gcd(T, chunk) (T = 1: chunks of 1), as the reference."""
    s, d_inner, nheads = _dims(cfg)
    B_, T, d = x.shape
    P = d_inner // nheads
    Nst = s.state_size

    proj = x @ params["w_in"]
    z, xbc_dt = proj[..., :d_inner], proj[..., d_inner:]
    xbc = xbc_dt[..., :d_inner + 2 * Nst]
    dt_raw = xbc_dt[..., d_inner + 2 * Nst:]

    conv_state = None if state is None else state[0]
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 conv_state)
    xs = split_last(xbc[..., :d_inner], nheads, P)
    Bmat = xbc[..., d_inner:d_inner + Nst]
    Cmat = xbc[..., d_inner + Nst:]

    dt = F.softplus(dt_raw.to(torch.float32) + params["dt_bias"])  # (B,T,H)
    a = -torch.exp(params["A_log"])[None, None] * dt      # log decay (neg)
    x_scaled = xs.to(torch.float32) * dt[..., None]

    ssm_state = None if state is None else state[1]
    if T % chunk != 0:
        chunk = 1 if T == 1 else math.gcd(T, chunk) or 1
    y, new_ssm = ssd_scan_ref(x_scaled, a, Bmat, Cmat, params["D"],
                              ssm_state, chunk=chunk)
    y = merge_last(y).to(x.dtype)
    y = rmsnorm(params["norm"], y, cfg.norm_eps) * F.silu(z)
    out = y @ params["w_out"]
    return out, (new_conv, new_ssm)


def mamba_state_init(cfg: ArchConfig, batch: int, device=None):
    """Zero (conv_state (batch, K−1, conv_dim) in the config's type,
    ssm_state (batch, H, Nst, P) float32) on ``device`` (default
    ``cuda``)."""
    s, d_inner, nheads = _dims(cfg)
    dev = _device.resolve(device)
    conv_dim = d_inner + 2 * s.state_size
    P = d_inner // nheads
    return (torch.zeros(batch, s.conv_width - 1, conv_dim,
                        dtype=torch_dtype(cfg), device=dev),
            torch.zeros(batch, nheads, s.state_size, P,
                        dtype=torch.float32, device=dev))
