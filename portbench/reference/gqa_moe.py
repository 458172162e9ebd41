"""Plain float32 forward of a decoder with grouped-query attention and a
top-k mixture-of-experts MLP, as the port defines its MoE family
(``granite-moe-3b-a800m``).  Plain PyTorch only: it imports nothing of
the program and takes nothing the program made.

Per layer, with h the residual stream (float32 throughout)::

    x  = rmsnorm(h) · scale1
    q, k, v = x W_q, x W_k, x W_v          (H, Hkv heads of D; RoPE on q, k,
                                            halves rotated, θ = rope_theta)
    a  = softmax(q kᵀ / √D, causal) v      (query head j reads kv head
                                            j // (H / Hkv))
    h += a W_o
    x  = rmsnorm(h) · scale2
    p  = softmax(x R);  top-k of p, renormalised to sum 1  → gates g_e
    h += Σ_{e in top-k} g_e · (silu(x G_e) ⊙ (x U_e)) D_e

then logits = rmsnorm(h) · scale_f · W_head.  Every expert is computed on
its routed tokens only.  Every matrix product goes through ``mm`` (exact
float32 with TF32 off by default; the control passes a lower precision).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def exact_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def _f(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * _f(scale)


def rope(x, theta):
    """x: (B, S, H, D) float32, positions 0 … S−1."""
    S, D = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                        device=x.device) / D))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * inv
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def attention(p, c, x, mm):
    B, S, _ = x.shape
    H, Hkv, D = (c["num_attention_heads"], c["num_key_value_heads"],
                 c["head_dim"])
    q = rope(mm(x, _f(p["w_q"])).view(B, S, H, D), c["rope_theta"])
    k = rope(mm(x, _f(p["w_k"])).view(B, S, Hkv, D), c["rope_theta"])
    v = mm(x, _f(p["w_v"])).view(B, S, Hkv, D)
    k = k.repeat_interleave(H // Hkv, dim=2)
    v = v.repeat_interleave(H // Hkv, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))       # (B, H, S, D)
    logits = mm(q / math.sqrt(D), k.transpose(-1, -2))
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    logits = logits.masked_fill(~causal, float("-inf"))
    out = mm(torch.softmax(logits, dim=-1), v)
    del logits
    out = out.transpose(1, 2).reshape(B, S, H * D)
    return mm(out, _f(p["w_o"]))


def moe(p, c, x, mm):
    B, S, d = x.shape
    E, k = c["num_local_experts"], c["num_experts_per_tok"]
    xf = x.reshape(B * S, d)
    probs = torch.softmax(mm(xf, _f(p["router"])), dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)
    topv = topv / topv.sum(-1, keepdim=True)
    out = torch.zeros_like(xf)
    for e in range(E):
        rows, slot = (topi == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = xf[rows]
        h = F.silu(mm(xe, _f(p["w_gate"][e]))) * mm(xe, _f(p["w_up"][e]))
        y = mm(h, _f(p["w_down"][e]))
        out.index_add_(0, rows, y * topv[rows, slot][:, None])
    return out.view(B, S, d)


def forward(params, c: dict, tokens: torch.Tensor, mm=exact_mm):
    """Logits (B, S, V) float32 of ``tokens`` (B, S) under ``params`` (the
    benchmark's weights in the port's layout) and the sizes ``c`` (the
    configuration file)."""
    eps = c["rms_norm_eps"]
    h = _f(params["embed"]["tok"][tokens])
    for blk in params["blocks"]:
        h = h + attention(blk["attn"], c,
                          rmsnorm(h, blk["ln1"]["scale"], eps), mm)
        h = h + moe(blk["mlp"], c, rmsnorm(h, blk["ln2"]["scale"], eps), mm)
    h = rmsnorm(h, params["final_norm"]["scale"], eps)
    return mm(h, _f(params["embed"]["unembed"]))


def step_flops(c: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one prefill of ``batch`` prompts of ``seq`` tokens,
    counted on the equations the port runs and this file follows (Granite's
    multipliers are scalings and cost nothing here; the untied head costs
    what the tied one does): 2 × the matrix parameters a token uses
    (attention, router, its top-k experts, the head), and the causal
    attention products (4·D a pair of query and key at or before it, per
    head).  No padding, no recompute, not the dense dispatch's work on
    unrouted experts."""
    d, L = c["hidden_size"], c["num_hidden_layers"]
    H, Hkv, D = (c["num_attention_heads"], c["num_key_value_heads"],
                 c["head_dim"])
    E, k, f = (c["num_local_experts"], c["num_experts_per_tok"],
               c["intermediate_size"])
    per_layer = d * H * D + 2 * d * Hkv * D + H * D * d + d * E + k * 3 * d * f
    per_token = L * per_layer + d * c["vocab_size"]
    pairs = seq * (seq + 1) / 2
    attn = L * 4 * batch * H * D * pairs
    return 2.0 * per_token * batch * seq + attn
