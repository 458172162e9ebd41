"""Shared neural layers of the port's model zoo.

Counterpart of ``repro/models/layers.py``: norms, RoPE and M-RoPE, the
MLPs, GQA attention and DeepSeek-V2's MLA (multi-head latent attention
with a compressed latent cache).  Functional style, as the JAX
package: each layer is ``*_init(generator, cfg, ..., device) -> params``
(a dict of tensors) plus ``apply(params, x, ...) -> y``.  Weights keep the
JAX ``(d_in, d_out)`` layout, so ``x @ w`` needs no transpose and
parameters cross between the packages unchanged (``repro_torch.interop``).

The places where bfloat16 rounds are the reference's: ``rmsnorm`` and
``layernorm`` compute in float32 and cast back after the scale, RoPE
rotates in float32 and casts back, and both attention paths (``_sdpa`` for
prefill, ``_decode_sdpa`` against a cache) take logits, softmax and the
weighted sum in float32 and cast to q's type.

GQA attention's inner product goes through the flash-attention op
(``repro_torch.kernels.flash_attention``: the hand-written Hopper kernel on
CUDA tensors) with ``use_kernel=True``, else through ``_sdpa``, which is
that op's plain version (``kernels/flash_attention/ref.attention_ref``).
MLA's goes through the MLA op (``repro_torch.kernels.mla_attention``:
192-wide query and key heads, 128-wide values, the rope key shared by the
heads) with ``use_kernel=True`` in a bfloat16 prefill without autograd,
else through ``_mla_core``, the float32 einsum formula, which decode
shares.  MLA's RoPE takes DeepSeek-V2's YaRN scaling where the config sets
a factor (``yarn_rope``, ``mla_softmax_scale``).
The reference's ``_sdpa`` also takes a ``q_offset`` that no caller sets;
the port's has none (its mask is top-left, the reference's default).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import _device
from repro_torch._dtensor import (is_dtensor, merge_last, replicated_like,
                                  shard_extent, split_last, whole)
from repro_torch.configs.base import ArchConfig
# the reference's plain attention (top-left causal mask), shared with the
# flash-attention op's CPU path
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.kernels.flash_attention.ref import attention_ref as _sdpa

Params = Dict[str, Any]


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    """The tensor type of ``cfg.dtype`` ("bfloat16" / "float32")."""
    return getattr(torch, cfg.dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device) -> torch.Tensor:
    """(d_in, d_out) standard normal × 1/√d_in, drawn in float32."""
    w = torch.randn(d_in, d_out, generator=gen, device=device,
                    dtype=torch.float32)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def _uniform(gen, shape, scale, dtype, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return (u * scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device=None) -> Params:
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """RMS norm in float32, cast back to x's dtype after the scale."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(x.dtype)


def layernorm_init(d: int, dtype, device=None) -> Params:
    return {"scale": torch.ones(d, dtype=dtype, device=device),
            "bias": torch.zeros(d, dtype=dtype, device=device)}


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    """Layer norm with the population variance, in float32."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)
            + params["bias"].to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (RoPE + Qwen2-VL M-RoPE)
# ---------------------------------------------------------------------------

def _inv_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (..., seq) int -> cos/sin of shape (..., seq, head_dim//2)."""
    ang = positions.to(torch.float32)[..., None] * _inv_freq(
        head_dim, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


def yarn_get_mscale(factor: float, mscale: float = 1.0) -> float:
    """YaRN's attention-temperature factor (DeepSeek-V2's
    ``yarn_get_mscale``): 0.1·mscale·ln(factor) + 1, and 1 for factor ≤ 1."""
    if factor <= 1:
        return 1.0
    return 0.1 * mscale * math.log(factor) + 1.0


def _yarn_correction_dim(rotations: float, dim: int, base: float,
                         max_pos: int) -> float:
    """The rotary dim whose wavelength makes ``rotations`` turns over
    ``max_pos`` positions."""
    return (dim * math.log(max_pos / (rotations * 2 * math.pi))
            / (2 * math.log(base)))


def yarn_inv_freq(cfg: ArchConfig, dim: int, device) -> torch.Tensor:
    """YaRN's inverse frequencies (DeepSeek-V2's
    ``DeepseekV2YarnRotaryEmbedding``): interpolated (÷ factor) below the
    correction range, extrapolated (RoPE's own) above it, blended by a
    linear ramp between the correction dims of ``beta_fast`` and
    ``beta_slow`` rotations over the original context."""
    base, factor = cfg.rope_theta, cfg.yarn_factor
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    freq_extra = 1.0 / (base ** exps)
    freq_inter = 1.0 / (factor * base ** exps)
    max_pos = cfg.yarn_original_max_position
    low = max(math.floor(_yarn_correction_dim(cfg.yarn_beta_fast, dim, base,
                                              max_pos)), 0)
    high = min(math.ceil(_yarn_correction_dim(cfg.yarn_beta_slow, dim, base,
                                              max_pos)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    extra = 1.0 - ramp
    return freq_inter * (1 - extra) + freq_extra * extra


def yarn_rope(cfg: ArchConfig, dim: int, positions: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin of ``positions`` for a rotary width ``dim``: RoPE's
    (``rope_freqs``) without a YaRN factor, else YaRN's frequencies with
    cos and sin × mscale(mscale) / mscale(mscale_all_dim)."""
    if cfg.yarn_factor <= 1:
        return rope_freqs(dim, cfg.rope_theta, positions)
    ang = positions.to(torch.float32)[..., None] * yarn_inv_freq(
        cfg, dim, positions.device)
    m = (yarn_get_mscale(cfg.yarn_factor, cfg.yarn_mscale)
         / yarn_get_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim))
    return torch.cos(ang) * m, torch.sin(ang) * m


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); cos/sin: (..., seq, head_dim//2)."""
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    c = replicated_like(cos[..., :, None, :], x)
    s = replicated_like(sin[..., :, None, :], x)
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(x.dtype)


def mrope_positions(batch: int, seq: int, sections=(16, 24, 24),
                    device=None) -> torch.Tensor:
    """Qwen2-VL M-RoPE position ids, text-only: the temporal, height and
    width channels share the 1-D position.  Returns (3, B, S) int64."""
    pos = torch.arange(seq, device=device)[None, :].expand(batch, seq)
    return torch.stack([pos, pos, pos], dim=0)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections=None) -> torch.Tensor:
    """M-RoPE: the head_dim/2 frequency slots are split into 3 sections fed
    by the (t, h, w) position channels.  positions: (3, B, S).  Default
    sections follow Qwen2-VL's 1:1.5:1.5 split scaled to the head_dim."""
    head_dim = x.shape[-1]
    half = head_dim // 2
    if sections is None:
        t = half // 4
        rem = half - t
        sections = (t, rem - rem // 2, rem // 2)
    assert sum(sections) == half, (sections, half)
    sec = torch.repeat_interleave(
        torch.arange(3, device=positions.device),
        torch.tensor(sections, device=positions.device))
    pos_per_slot = positions.to(torch.float32)[sec]        # (half, B, S)
    ang = pos_per_slot.movedim(0, -1) * _inv_freq(head_dim, theta,
                                                   positions.device)
    return apply_rope(x, torch.cos(ang), torch.sin(ang))


# ---------------------------------------------------------------------------
# Feed-forward blocks
# ---------------------------------------------------------------------------

def mlp_init(gen, cfg: ArchConfig, d_ff: Optional[int] = None,
             device=None) -> Params:
    d, dt = cfg.d_model, torch_dtype(cfg)
    d_ff = d_ff or cfg.d_ff
    if cfg.mlp_activation == "silu":      # gated (SwiGLU): 3 matrices
        return {"w_gate": dense_init(gen, d, d_ff, dt, device),
                "w_up": dense_init(gen, d, d_ff, dt, device),
                "w_down": dense_init(gen, d_ff, d, dt, device)}
    return {"w_up": dense_init(gen, d, d_ff, dt, device),
            "w_down": dense_init(gen, d_ff, d, dt, device)}


def mlp_apply(params: Params, x: torch.Tensor, activation: str
              ) -> torch.Tensor:
    """SwiGLU (``silu``), GELU (tanh approximation, as ``jax.nn.gelu``) or
    squared ReLU (``relu2``, Nemotron-4)."""
    if activation == "silu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    elif activation == "gelu":
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    elif activation == "relu2":
        h = torch.square(F.relu(x @ params["w_up"]))
    else:
        raise ValueError(f"unknown activation {activation}")
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def attention_init(gen, cfg: ArchConfig, device=None) -> Params:
    d, dt = cfg.d_model, torch_dtype(cfg)
    hd = cfg.resolved_head_dim
    p = {"w_q": dense_init(gen, d, cfg.num_heads * hd, dt, device),
         "w_k": dense_init(gen, d, cfg.num_kv_heads * hd, dt, device),
         "w_v": dense_init(gen, d, cfg.num_kv_heads * hd, dt, device),
         "w_o": dense_init(gen, cfg.num_heads * hd, d, dt, device)}
    if cfg.qkv_bias:
        for name, n in (("b_q", cfg.num_heads), ("b_k", cfg.num_kv_heads),
                        ("b_v", cfg.num_kv_heads)):
            p[name] = torch.zeros(n * hd, dtype=dt, device=device)
    return p


def attention_apply(params: Params, cfg: ArchConfig, x: torch.Tensor,
                    positions: Optional[torch.Tensor] = None,
                    kv_cache: Optional[Tuple] = None,
                    cache_index: Optional[int] = None,
                    use_kernel: bool = False):
    """GQA attention.  Returns (out, new_kv_cache).

    Prefill: kv_cache=None, full self-attention over x (the flash-attention
    op with ``use_kernel``).  Decode: kv_cache=(k, v) of a static length;
    the new k/v are written at ``cache_index`` (an int) **in place** into
    the given cache tensors, which are returned as the new cache.  The
    decode mask is a length mask only (keys < cache_index + S), as the
    reference's, so a multi-token decode is not causal within its chunk.
    """
    B, S, _ = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = x @ params["w_q"]
    k = x @ params["w_k"]
    v = x @ params["w_v"]
    if cfg.qkv_bias:
        q, k, v = q + params["b_q"], k + params["b_k"], v + params["b_v"]
    q = split_last(q, H, hd)
    k = split_last(k, Hkv, hd)
    v = split_last(v, Hkv, hd)

    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
        if cache_index is not None:
            positions = positions + int(cache_index)

    if cfg.mrope:
        if positions.ndim == 2:       # text-only: replicate channels
            positions = torch.stack([positions] * 3, dim=0)
        q = apply_mrope(q, positions, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.rope_theta)
    else:
        cos, sin = rope_freqs(hd, cfg.rope_theta, positions)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    if kv_cache is not None:
        ck, cv = kv_cache
        _scatter_cache(ck, k, cache_index)
        _scatter_cache(cv, v, cache_index)
        out = _decode_sdpa(q, ck, cv, int(cache_index) + S)
        new_cache = (ck, cv)
    else:
        if is_dtensor(q):
            q, k, v = _head_placed(q, k, v)
        if use_kernel:
            out = _flash_attention(q, k, v, cfg.causal)
        else:
            out = _sdpa(q, k, v, causal=cfg.causal)
        new_cache = None

    out = merge_last(out) @ params["w_o"]
    return out, new_cache


def _head_placed(q, k, v):
    """DTensors q (B, S, H, D), k and v (B, S, Hkv, D) placed for the
    attention core: per mesh dim, the batch split where q's is, the heads
    split where q's are and both H and Hkv divide the mesh dim (so a
    rank's query heads meet their own kv heads), else whole; S and D
    whole, no partial sums.  DTensor's own choice after the projections
    may split the flattened (batch · heads) of the products unevenly,
    which its sharding rules cannot propagate."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    H, Hkv = q.shape[2], k.shape[2]
    places = []
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        keep = isinstance(p, Shard) and (
            (p.dim == 0 and q.shape[0] % n == 0) or
            (p.dim == 2 and H % n == 0 and Hkv % n == 0))
        places.append(p if keep else Replicate())
    return tuple(t if tuple(t.placements) == tuple(places)
                 else t.redistribute(mesh, places) for t in (q, k, v))


def _flash_attention(q, k, v, causal: bool):
    """The flash-attention op; on DTensors (placed by ``_head_placed``),
    on each rank's own batch rows and heads: the kernel sees the local
    shards and the output keeps q's placements (``DTensor.from_local``)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    if not is_dtensor(q):
        return fa_ops.flash_attention(q, k, v, causal=causal)
    from torch.distributed.tensor import DTensor
    out = fa_ops.flash_attention(q.to_local(), k.to_local(), v.to_local(),
                                 causal=causal)
    return DTensor.from_local(out, q.device_mesh, q.placements,
                              run_check=False)


def _scatter_cache(cache: torch.Tensor, new: torch.Tensor,
                   index) -> torch.Tensor:
    """cache: (B, Smax, ...); new: (B, s, ...) written at ``index``
    in place.  The start is clamped to [0, Smax − s], as
    ``lax.dynamic_update_slice`` clamps it.  Returns ``cache``."""
    s, smax = new.shape[1], cache.shape[1]
    start = min(max(int(index), 0), smax - s)
    if is_dtensor(cache):
        # the cache's sequence dim may be sharded (decode_state_specs), and
        # a slice of a sharded dim is a gathered copy, which a write would
        # miss: each rank writes the new positions that fall in its shard
        from torch.distributed.tensor import Replicate, Shard
        mesh = cache.device_mesh
        new = new.redistribute(mesh, [
            Replicate() if isinstance(p, Shard) and p.dim == 1 else p
            for p in cache.placements]).to_local()
        shape, offset = shard_extent(cache.shape, mesh, cache.placements)
        lo = max(start, offset[1])
        hi = min(start + s, offset[1] + shape[1])
        if lo < hi:
            cache.to_local()[:, lo - offset[1]:hi - offset[1]] = \
                new[:, lo - start:hi - start].to(cache.dtype)
        return cache
    cache[:, start:start + s] = new.to(cache.dtype)
    return cache


def _decode_sdpa(q, k_cache, v_cache, valid_len: int):
    """Decode attention: q (B, Sq, H, D) against the padded cache, keys at
    positions < ``valid_len`` (a length mask only), float32 inside."""
    B, Sq, H, D = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    qg = (q.to(torch.float32) / math.sqrt(D)).reshape(B, Sq, Hkv, H // Hkv,
                                                       D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                          k_cache.to(torch.float32))
    mask = replicated_like(torch.arange(Smax, device=q.device) < valid_len,
                           logits)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs,
                       v_cache.to(torch.float32))
    return out.reshape(B, Sq, H, D).to(q.dtype)


def make_kv_cache(cfg: ArchConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None):
    """Zero (k, v) caches of shape (batch, max_len, Hkv, head_dim) on
    ``device`` (default ``cuda``)."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    dev = _device.resolve(device)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


# ---------------------------------------------------------------------------
# MLA — DeepSeek-V2 multi-head latent attention
# ---------------------------------------------------------------------------

def mla_init(gen, cfg: ArchConfig, device=None) -> Params:
    """With ``q_lora_rank`` the query goes through a low-rank path
    (``w_dq`` → ``q_norm`` → ``w_uq``), else through ``w_q``; keys and
    values through the compressed latent (``w_dkv`` → ``kv_norm`` →
    ``w_uk`` / ``w_uv``) plus one shared rope key of width dr."""
    d, dt = cfg.d_model, torch_dtype(cfg)
    H = cfg.num_heads
    r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank or 0
    dr, dn, dv = cfg.qk_rope_head_dim, cfg.qk_nope_head_dim, cfg.v_head_dim
    p = {}
    if r_q:
        p["w_dq"] = dense_init(gen, d, r_q, dt, device)
        p["q_norm"] = rmsnorm_init(r_q, dt, device)
        p["w_uq"] = dense_init(gen, r_q, H * (dr + dn), dt, device)
    else:
        p["w_q"] = dense_init(gen, d, H * (dr + dn), dt, device)
    p["w_dkv"] = dense_init(gen, d, r_kv + dr, dt, device)  # latent + rope k
    p["kv_norm"] = rmsnorm_init(r_kv, dt, device)
    p["w_uk"] = dense_init(gen, r_kv, H * dn, dt, device)
    p["w_uv"] = dense_init(gen, r_kv, H * dv, dt, device)
    p["w_o"] = dense_init(gen, H * dv, d, dt, device)
    return p


def mla_softmax_scale(cfg: ArchConfig) -> float:
    """1/√(dr + dn), × YaRN's mscale(factor, mscale_all_dim)² where the
    config sets ``yarn_mscale_all_dim`` (DeepSeek-V2's ``softmax_scale``)."""
    scale = 1.0 / math.sqrt(cfg.qk_rope_head_dim + cfg.qk_nope_head_dim)
    if cfg.yarn_mscale_all_dim:
        scale *= yarn_get_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim) ** 2
    return scale


def mla_apply(params: Params, cfg: ArchConfig, x: torch.Tensor,
              positions: Optional[torch.Tensor] = None,
              kv_cache: Optional[Tuple] = None,
              cache_index: Optional[int] = None,
              use_kernel: bool = False):
    """MLA attention.  Returns (out, new_cache).

    The cache holds the *compressed* latent and the shared rope key:
    (latent (B, Smax, r_kv), k_rope (B, Smax, dr)).  As in
    ``attention_apply``, the new positions are written at ``cache_index``
    (clamped as ``lax.dynamic_update_slice`` clamps) **in place** into the
    given cache tensors, and the decode mask is a length mask only.

    The core: with ``use_kernel``, a bfloat16 prefill (no cache) without
    autograd goes through the MLA op (``kernels.mla_attention``: the Hopper
    kernel on CUDA tensors, which reads the one rope key of every head in
    place); everything else through ``_mla_core``, whose logits, softmax
    and weighted sum are float32, cast once to x's type.  RoPE is YaRN's
    where the config sets a factor (``yarn_rope``), and the softmax scale
    ``mla_softmax_scale``."""
    B, S, _ = x.shape
    H = cfg.num_heads
    dr, dn, dv = cfg.qk_rope_head_dim, cfg.qk_nope_head_dim, cfg.v_head_dim
    r_kv = cfg.kv_lora_rank

    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
        if cache_index is not None:
            positions = positions + int(cache_index)

    if "w_dq" in params:
        q_lat = rmsnorm(params["q_norm"], x @ params["w_dq"], cfg.norm_eps)
        q = q_lat @ params["w_uq"]
    else:
        q = x @ params["w_q"]
    q = split_last(q, H, dr + dn)
    q_rope, q_nope = q[..., :dr], q[..., dr:]
    cos, sin = yarn_rope(cfg, dr, positions)
    q_rope = apply_rope(q_rope, cos, sin)

    dkv = x @ params["w_dkv"]
    latent = rmsnorm(params["kv_norm"], dkv[..., :r_kv], cfg.norm_eps)
    k_rope = apply_rope(dkv[..., r_kv:][:, :, None, :], cos, sin)[:, :, 0]

    if kv_cache is not None:
        c_lat, c_kr = kv_cache
        _scatter_cache(c_lat, latent, cache_index)
        _scatter_cache(c_kr, k_rope, cache_index)
        latent_full, k_rope_full = c_lat, c_kr
        valid = int(cache_index) + S
        new_cache = (c_lat, c_kr)
    else:
        latent_full, k_rope_full = latent, k_rope
        valid = None
        new_cache = None

    Sk = latent_full.shape[1]
    k_nope = split_last(latent_full @ params["w_uk"], H, dn)
    v = split_last(latent_full @ params["w_uv"], H, dv)
    scale = mla_softmax_scale(cfg)
    if (use_kernel and kv_cache is None and x.dtype == torch.bfloat16
            and not torch.is_grad_enabled() and not is_dtensor(x)):
        from repro_torch.kernels.mla_attention import ops as mla_ops
        out = mla_ops.mla_attention(q_nope, q_rope, k_nope, k_rope_full, v,
                                    scale=scale)
    else:
        keys = torch.arange(Sk, device=x.device)
        if valid is None:
            mask = keys[None, :] <= torch.arange(S, device=x.device)[:, None]
        else:
            mask = keys < valid
        out = _mla_core(q_nope, q_rope, k_nope, k_rope_full, v, scale, mask)
    out = merge_last(out) @ params["w_o"]
    return out, new_cache


def _mla_core(q_nope, q_rope, k_nope, k_rope, v, scale: float,
              mask: torch.Tensor) -> torch.Tensor:
    """softmax((q_nope·k_nope + q_rope·k_rope) · scale, masked) · v in
    float32, cast to q's type: q_nope (B, S, H, dn), q_rope (B, S, H, dr),
    k_nope (B, Sk, H, dn), k_rope (B, Sk, dr), v (B, Sk, H, dv); ``mask``
    (S, Sk) or (Sk,) keeps the True entries."""
    f32 = torch.float32
    logits = (torch.einsum("bqhd,bkhd->bhqk", q_nope.to(f32),
                           k_nope.to(f32))
              + torch.einsum("bqhd,bkd->bhqk", q_rope.to(f32),
                             k_rope.to(f32))) * scale
    logits = torch.where(replicated_like(mask, logits), logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    del logits
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(f32))
    return out.to(q_nope.dtype)


def make_mla_cache(cfg: ArchConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None):
    """Zero (latent (batch, max_len, r_kv), k_rope (batch, max_len, dr))
    caches on ``device`` (default ``cuda``)."""
    dev = _device.resolve(device)
    return (torch.zeros(batch, max_len, cfg.kv_lora_rank, dtype=dtype,
                        device=dev),
            torch.zeros(batch, max_len, cfg.qk_rope_head_dim, dtype=dtype,
                        device=dev))


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

def embedding_init(gen, cfg: ArchConfig, device=None) -> Params:
    dt = torch_dtype(cfg)
    tok = torch.randn(cfg.vocab_size, cfg.d_model, generator=gen,
                      device=device, dtype=torch.float32)
    p = {"tok": (tok * 0.02).to(dt)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dt,
                                  device)
    return p


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of the token table.  On a DTensor table whose vocab is
    split over one mesh dim (``model``): the Megatron vocab-parallel
    embedding (``_VocabParallelEmbed``), where DTensor's own masked-partial
    rule reduces its output once only (the output feeds the residual and
    the first norm) and computes the table's gradient whole on every rank;
    the plain path indexes the table."""
    tab = params["tok"]
    if not is_dtensor(tab):
        return tab[tokens.long()]
    from torch.distributed.tensor import Shard
    ids = tokens if is_dtensor(tokens) else replicated_like(tokens, tab)
    split = [i for i, p in enumerate(tab.placements)
             if isinstance(p, Shard) and p.dim == 0]
    if not split:          # the table whole on every rank: the plain path
        return tab[ids.long()]
    if len(split) != 1 or any(isinstance(p, Shard) for i, p in
                              enumerate(tab.placements) if i != split[0]):
        return whole(tab, 0, 1)[ids.long()]
    return _VocabParallelEmbed.apply(tab, ids, split[0])


class _VocabParallelEmbed(torch.autograd.Function):
    """Forward: each rank gathers the rows of its vocab shard (the others
    zero) and the rows are summed over the vocab's mesh dim ``t`` (one
    all-reduce); the output keeps the ids' batch split.  Backward: the
    rank's rows of the table gradient, a partial sum over the mesh dims
    that split the batch."""

    @staticmethod
    def forward(ctx, tab, ids, t):
        from torch.distributed import _functional_collectives as funcol
        from torch.distributed.tensor import DTensor, Replicate
        mesh = tab.device_mesh
        rows = [Replicate() if i == t else p
                for i, p in enumerate(ids.placements)]
        idx = ids.redistribute(mesh, rows).to_local().long()
        local = tab.to_local()
        idx = idx - shard_extent(tab.shape, mesh, tab.placements)[1][0]
        inside = (idx >= 0) & (idx < local.shape[0])
        idx = idx.clamp(0, local.shape[0] - 1)
        out = F.embedding(idx, local) * inside[..., None].to(local.dtype)
        out = funcol.all_reduce(out, "sum", (mesh, t))
        ctx.save_for_backward(idx, inside)
        ctx.spec = (mesh, t, tuple(rows), tuple(local.shape), local.dtype)
        return DTensor.from_local(out, mesh, rows, run_check=False)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)
        idx, inside = ctx.saved_tensors
        mesh, t, rows, shape, dtype = ctx.spec
        g = grad.redistribute(mesh, rows).to_local()
        g = g * inside[..., None].to(g.dtype)
        local = torch.zeros(shape, dtype=dtype, device=g.device)
        local.index_put_((idx,), g.to(dtype), accumulate=True)
        places = [Shard(0) if i == t else
                  Partial() if isinstance(p, Shard) else Replicate()
                  for i, p in enumerate(rows)]
        return DTensor.from_local(local, mesh, places,
                                  run_check=False), None, None


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    if "unembed" in params:
        return x @ params["unembed"]
    return x @ params["tok"].T.to(x.dtype)
