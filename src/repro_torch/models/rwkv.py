"""RWKV-6 ("Finch") blocks — attention-free token mixing with
data-dependent decay (arXiv:2404.05892).

Counterpart of ``repro/models/rwkv.py``.  Per head (head size N = 64), per
time step t, with data-dependent decay w_t ∈ (0, 1):

    S_t = diag(w_t) · S_{t−1} + k_tᵀ v_t           (state: N×N per head)
    o_t = r_t · (S_{t−1} + diag(u) k_tᵀ v_t)        (u: bonus for the token)

The time-mixing projections use RWKV's token shift with data-dependent
mixing (a LoRA-style ddlerp); channel mixing is the squared-ReLU FFN.

The recurrence goes, as in the reference's ``time_mix_apply``, through the
WKV op with ``use_kernel`` (``repro_torch.kernels.rwkv_wkv``: the
hand-written Hopper kernel on CUDA tensors), else through ``wkv_chunked``
when T > 1 and T % 32 == 0, else through the sequential ``wkv_scan_ref``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import _device
from repro_torch._dtensor import (is_dtensor, merge_last, replicated_like,
                                  split_last)
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.rwkv_wkv.ref import wkv_scan_ref
from repro_torch.models.layers import _uniform, dense_init, torch_dtype

Params = Dict[str, Any]

HEAD_SIZE = 64   # RWKV-6 fixed head size

__all__ = ["HEAD_SIZE", "time_mix_init", "channel_mix_init", "token_shift",
           "wkv_scan_ref", "wkv_chunked", "time_mix_apply",
           "channel_mix_apply", "rwkv_state_init"]


def _heads(cfg: ArchConfig) -> int:
    assert cfg.d_model % HEAD_SIZE == 0
    return cfg.d_model // HEAD_SIZE


def time_mix_init(gen, cfg: ArchConfig, device=None) -> Params:
    d, dt = cfg.d_model, torch_dtype(cfg)
    H = _heads(cfg)
    lora = 32
    f32 = torch.float32
    return {
        # token-shift data-dependent lerp params (5 targets: w,k,v,r,g)
        "mix_base": _uniform(gen, (5, d), 0.5, dt, device),
        "mix_lora_a": dense_init(gen, d, 5 * lora, dt, device),
        "mix_lora_b": torch.zeros(5, lora, d, dtype=dt, device=device),
        # projections
        "w_r": dense_init(gen, d, d, dt, device),
        "w_k": dense_init(gen, d, d, dt, device),
        "w_v": dense_init(gen, d, d, dt, device),
        "w_g": dense_init(gen, d, d, dt, device),
        "w_o": dense_init(gen, d, d, dt, device),
        # decay: base + LoRA (data-dependent, the RWKV-6 novelty)
        "decay_base": torch.full((d,), -6.0, dtype=f32, device=device),
        "decay_lora_a": dense_init(gen, d, 64, dt, device),
        "decay_lora_b": torch.zeros(64, d, dtype=dt, device=device),
        "bonus": torch.randn(H, HEAD_SIZE, generator=gen, device=device,
                             dtype=f32) * 0.05,
        "ln_x": {"scale": torch.ones(d, dtype=dt, device=device),
                 "bias": torch.zeros(d, dtype=dt, device=device)},
    }


def channel_mix_init(gen, cfg: ArchConfig, device=None) -> Params:
    d, dt = cfg.d_model, torch_dtype(cfg)
    return {
        "mix_k": _uniform(gen, (d,), 0.5, dt, device),
        "w_k": dense_init(gen, d, cfg.d_ff, dt, device),
        "w_v": dense_init(gen, cfg.d_ff, d, dt, device),
    }


def token_shift(x: torch.Tensor, x_prev: Optional[torch.Tensor] = None):
    """Shift the sequence right by one; x_prev supplies the t = −1 row."""
    pad = torch.zeros_like(x[:, :1]) if x_prev is None else x_prev[:, None, :]
    return torch.cat([pad, x[:, :-1]], dim=1)


def wkv_chunked(r, k, v, w, u, state0=None, chunk: int = 32):
    """Chunked WKV-6 (the reference's jnp form of the Pallas schedule).

    Per chunk of length C, with per-channel exclusive decay cumprods cw_t:
      out_t = (r_t ⊙ cw_t)·S₀ + Σ_{j<t} ((r_t⊙cw_t)·(k_j/cw_{j+1})) v_j
              + (r_t⊙u)·k_t v_t
    — one (C×C) matmul per head instead of C rank-1 state updates.  Decay
    ratios are factorised around the chunk-midpoint cumulative log-decay
    and clipped as the reference does.  Falls back to the sequential scan
    when T % chunk != 0.
    """
    B, T, H, N = r.shape
    if T % chunk != 0:
        return wkv_scan_ref(r, k, v, w, u, state0)
    f32 = torch.float32
    rf, kf, vf = (a.to(f32) for a in (r, k, v))
    logw = torch.log(torch.clamp_min(w.to(f32), 1e-38))
    uf = u.to(f32)
    if state0 is None:
        state0 = replicated_like(torch.zeros(B, H, N, N, dtype=f32,
                                             device=r.device), r)
    nc = T // chunk

    shape5 = (B, nc, chunk, H, N)
    rf, kf, vf, logw = (a.reshape(shape5) for a in (rf, kf, vf, logw))
    clw = torch.cumsum(logw, dim=2) - logw                  # (B,nc,C,H,N)
    total_lw = clw[:, :, -1] + logw[:, :, -1]               # (B,nc,H,N)

    c = clw[:, :, chunk // 2][:, :, None]                   # midpoint anchor
    rt = rf * torch.exp(torch.clamp(clw - c, -60.0, 60.0))
    kt = kf * torch.exp(torch.clamp(c - (clw + logw), -60.0, 60.0))

    scores = torch.einsum("bnchx,bnjhx->bnhcj", rt, kt)     # (B,nc,H,C,C)
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    scores = torch.where(replicated_like(mask, scores), scores, 0.0)
    out_intra = torch.einsum("bnhcj,bnjhm->bnchm", scores, vf)
    bonus = torch.einsum("bnchx,bnchx->bnch", rf * uf, kf)
    out_intra = out_intra + bonus[..., None] * vf

    dec_to_end = torch.exp(torch.clamp(
        total_lw[:, :, None] - (clw + logw), -80.0, 0.0))   # (B,nc,C,H,N)
    chunk_kv = torch.einsum("bnchx,bnchm->bnhxm", kf * dec_to_end, vf)
    r_state = rf * torch.exp(clw)

    S = state0.to(f32)
    out_inter = []
    for n in range(nc):
        out_inter.append(torch.einsum("bchx,bhxm->bchm", r_state[:, n], S))
        S = torch.exp(total_lw[:, n])[..., None] * S + chunk_kv[:, n]
    out_inter = torch.stack(out_inter, dim=1)

    out = (out_intra + out_inter).reshape(B, T, H, N)
    return out.to(r.dtype), S


def _wkv_op(r, k, v, w, u, state0):
    """The WKV op; on DTensors, on each rank's own batch rows and heads.

    r, k, v and w are brought to one placement with T and N whole (and no
    partial sums); u (H, N) and state0 (B, H, N, N) are then split as the
    heads (and the batch) are, so each rank's kernel sees the bonus and
    state of its own heads.  The outputs keep r's placements."""
    from repro_torch.kernels.rwkv_wkv import ops as wkv_ops
    if not is_dtensor(r):
        return wkv_ops.wkv(r, k, v, w, u, state0)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = r.device_mesh
    # per mesh dim: the batch or the heads split (as r's), else whole
    places = [p if isinstance(p, Shard) and p.dim in (0, 2) else
              Replicate() for p in r.placements]
    r, k, v, w = (t.redistribute(mesh, places) for t in (r, k, v, w))
    head = [Shard(0) if p == Shard(2) else Replicate() for p in places]
    state = [Shard({0: 0, 2: 1}[p.dim]) if isinstance(p, Shard) else p
             for p in places]
    u = u.redistribute(mesh, head).to_local()
    if state0 is not None:
        state0 = state0.redistribute(mesh, state).to_local()
    out, s = wkv_ops.wkv(r.to_local(), k.to_local(), v.to_local(),
                         w.to_local(), u, state0)
    return (DTensor.from_local(out, mesh, places, run_check=False),
            DTensor.from_local(s, mesh, state, run_check=False))


def time_mix_apply(params: Params, cfg: ArchConfig, x: torch.Tensor,
                   state: Optional[Tuple] = None, use_kernel: bool = False):
    """RWKV-6 time mixing.  ``state`` = (x_prev (B, d), wkv_state (B, H,
    N, N)) for O(1) decode; None for a whole sequence.
    Returns (out, new_state)."""
    B, T, d = x.shape
    H, N = _heads(cfg), HEAD_SIZE
    x_prev = None if state is None else state[0]
    wkv_state = None if state is None else state[1]

    delta = token_shift(x, x_prev) - x
    # data-dependent lerp (ddlerp): 5 mixing vectors from a small LoRA
    lora = split_last(torch.tanh(x @ params["mix_lora_a"]), 5, -1)
    mix = params["mix_base"][None, None] + torch.einsum(
        "btfl,fld->btfd", lora, params["mix_lora_b"])
    xw, xk, xv, xr, xg = [x + delta * mix[:, :, i] for i in range(5)]

    r = split_last(xr @ params["w_r"], H, N)
    k = split_last(xk @ params["w_k"], H, N)
    v = split_last(xv @ params["w_v"], H, N)
    g = F.silu(xg @ params["w_g"])

    # data-dependent decay w_t = exp(-exp(base + lora(xw))), float32
    dec = params["decay_base"][None, None] + (
        torch.tanh(xw @ params["decay_lora_a"]) @ params["decay_lora_b"]
    ).to(torch.float32)
    w = split_last(torch.exp(-torch.exp(dec)), H, N)

    if use_kernel:
        out, new_wkv = _wkv_op(r, k, v, w, params["bonus"], wkv_state)
    elif T > 1 and T % 32 == 0:
        out, new_wkv = wkv_chunked(r, k, v, w, params["bonus"], wkv_state)
    else:
        out, new_wkv = wkv_scan_ref(r, k, v, w, params["bonus"], wkv_state)

    # group norm over heads (ln_x in RWKV), float32, population variance
    outf = out.to(torch.float32)
    mu = outf.mean(dim=-1, keepdim=True)
    var = outf.var(dim=-1, keepdim=True, correction=0)
    outf = (outf - mu) * torch.rsqrt(var + 64e-5)
    out = merge_last(outf) * params["ln_x"]["scale"].to(torch.float32) \
        + params["ln_x"]["bias"].to(torch.float32)
    out = (out.to(x.dtype) * g) @ params["w_o"]
    return out, (x[:, -1], new_wkv)


def channel_mix_apply(params: Params, cfg: ArchConfig, x: torch.Tensor,
                      x_prev: Optional[torch.Tensor] = None):
    """RWKV channel mixing (squared-ReLU FFN with token shift).
    Returns (out, last_x)."""
    xk = x + (token_shift(x, x_prev) - x) * params["mix_k"]
    h = torch.square(F.relu(xk @ params["w_k"]))
    return h @ params["w_v"], x[:, -1]


def rwkv_state_init(cfg: ArchConfig, batch: int, device=None):
    """Per-layer decode state: (x_prev_tm (B, d), wkv (B, H, N, N) float32,
    x_prev_cm (B, d)), zeros on ``device`` (default ``cuda``)."""
    H, N = _heads(cfg), HEAD_SIZE
    dev, dt = _device.resolve(device), torch_dtype(cfg)
    return (torch.zeros(batch, cfg.d_model, dtype=dt, device=dev),
            torch.zeros(batch, H, N, N, dtype=torch.float32, device=dev),
            torch.zeros(batch, cfg.d_model, dtype=dt, device=dev))
