"""Plain float32 forward of DeepSeek-V2 as the port runs it: multi-head
latent attention (MLA) with YaRN rotary scaling, a dense first layer,
then mixture-of-experts layers with shared experts and group-limited
routing, of which this device holds a share of the routed experts.  Plain
PyTorch only: it imports nothing of the program and takes nothing the
program made.

Per layer, with h the residual stream (float32 throughout), H heads, nope
width dn, rope width dr, value width dv::

    x  = rmsnorm(h) · scale1
    q  = rmsnorm(x W_dq) · q_norm · W_uq           (H heads of dr + dn:
                                                   the rope columns first)
    [c, k_r] = x W_dkv;  c = rmsnorm(c) · kv_norm  (latent r_kv, one rope
                                                   key of dr for all heads)
    k_n, v = c W_uk, c W_uv                        (H heads of dn, dv)
    q_r, k_r rotated by YaRN's RoPE (halves rotated, θ = rope_theta)
    a  = softmax((q_n k_nᵀ + q_r k_rᵀ) · s, causal) v,
         s = mscale(factor, mscale_all_dim)² / √(dn + dr)
    h += a W_o
    x  = rmsnorm(h) · scale2
    layer < first_k_dense_replace:  h += (silu(x G) ⊙ (x U)) D
    otherwise:  p = softmax(x R) over all routed experts; the n_group
         groups scored by their largest p, the best topk_group kept, the
         top num_experts_per_tok of p within them, weights p × routed_
         scaling_factor (not renormalised);
         h += Σ over the chosen experts held here of w_e ·
              (silu(x G_e) ⊙ (x U_e)) D_e  +  shared SwiGLU(x)

then logits = rmsnorm(h) · scale_f · W_head.  YaRN (DeepSeek-V2's
``DeepseekV2YarnRotaryEmbedding``): inverse frequencies blend θ's own
(extrapolation) with them ÷ factor (interpolation) by a linear ramp
between the correction dims of ``beta_fast`` and ``beta_slow`` rotations
over ``original_max_position_embeddings``; cos and sin × mscale(factor,
mscale) / mscale(factor, mscale_all_dim), with mscale(f, m) =
0.1·m·ln f + 1.  Every held expert is computed on its routed tokens
only; what the experts held elsewhere give is left out, as the program
leaves it out.  Attention runs a document at a time, in blocks of heads
and queries (a block's keys end at its last query), so that one 8,192-token
document fits beside the weights.  Every matrix product goes through
``mm`` (exact float32 with TF32 off by default; the control passes a lower
precision).

Departures from the source (DeepSeek-V2's ``modeling_deepseek.py``), none
visible to random weights: rope pairs are rotated as halves, not
interleaved (a fixed permutation of the rope columns of ``W_uq`` and
``W_dkv``); each head's query lays its rope columns before its nope
columns, and ``kv_b_proj`` is split into ``W_uk`` and ``W_uv`` (fixed
permutations of columns); the router is float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

HEAD_BLOCK = 16       # heads a block of the attention
QUERY_BLOCK = 2048    # queries a block of the attention


def exact_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def _f(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * _f(scale)


def mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def yarn(c: dict, S: int, device):
    """(cos, sin) of positions 0 … S−1, each (S, dr/2), and the softmax
    scale."""
    y, dr, base = c["rope_scaling"], c["qk_rope_head_dim"], c["rope_theta"]
    factor, orig = y["factor"], y["original_max_position_embeddings"]
    exps = torch.arange(0, dr, 2, dtype=torch.float32, device=device) / dr
    extra = 1.0 / (base ** exps)
    inter = 1.0 / (factor * base ** exps)

    def dim_of(rotations):
        return dr * math.log(orig / (rotations * 2 * math.pi)) / (
            2 * math.log(base))
    low = max(math.floor(dim_of(y["beta_fast"])), 0)
    high = min(math.ceil(dim_of(y["beta_slow"])), dr - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dr // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    inv = inter * (1 - mask) + extra * mask
    ang = torch.arange(S, dtype=torch.float32, device=device)[:, None] * inv
    m = mscale(factor, y["mscale"]) / mscale(factor, y["mscale_all_dim"])
    scale = mscale(factor, y["mscale_all_dim"]) ** 2 / math.sqrt(
        dr + c["qk_nope_head_dim"])
    return torch.cos(ang) * m, torch.sin(ang) * m, scale


def rotate(x, cos, sin):
    """x: (S, heads, dr) float32, halves rotated."""
    half = x.shape[-1] // 2
    c, s = cos[:, None, :], sin[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def attention(p, c, x, mm, rope):
    """One document: x (S, d)."""
    S = x.shape[0]
    H, dn, dr, dv = (c["num_attention_heads"], c["qk_nope_head_dim"],
                     c["qk_rope_head_dim"], c["v_head_dim"])
    r, eps = c["kv_lora_rank"], c["rms_norm_eps"]
    cos, sin, scale = rope
    q = mm(rmsnorm(mm(x, _f(p["w_dq"])), p["q_norm"]["scale"], eps),
           _f(p["w_uq"])).view(S, H, dr + dn)
    q_r, q_n = rotate(q[..., :dr], cos, sin), q[..., dr:]
    dkv = mm(x, _f(p["w_dkv"]))
    lat = rmsnorm(dkv[:, :r], p["kv_norm"]["scale"], eps)
    k_r = rotate(dkv[:, None, r:], cos, sin)[:, 0]          # (S, dr)
    k_n = mm(lat, _f(p["w_uk"])).view(S, H, dn)
    v = mm(lat, _f(p["w_uv"])).view(S, H, dv)
    del q, dkv, lat
    out = torch.empty(S, H, dv, dtype=torch.float32, device=x.device)
    for h0 in range(0, H, HEAD_BLOCK):
        h1 = min(h0 + HEAD_BLOCK, H)
        qn = q_n[:, h0:h1].transpose(0, 1)                  # (hb, S, dn)
        qr = q_r[:, h0:h1].transpose(0, 1)
        kn = k_n[:, h0:h1].transpose(0, 1)
        vb = v[:, h0:h1].transpose(0, 1)
        for i0 in range(0, S, QUERY_BLOCK):
            i1 = min(i0 + QUERY_BLOCK, S)
            logits = (mm(qn[:, i0:i1], kn[:, :i1].transpose(-1, -2))
                      + mm(qr[:, i0:i1], k_r[:i1].T)) * scale
            causal = (torch.arange(i1, device=x.device)[None, :]
                      <= torch.arange(i0, i1, device=x.device)[:, None])
            logits = logits.masked_fill(~causal, float("-inf"))
            out[i0:i1, h0:h1] = mm(torch.softmax(logits, dim=-1),
                                   vb[:, :i1]).transpose(0, 1)
            del logits
    return mm(out.reshape(S, H * dv), _f(p["w_o"]))


def swiglu(p, x, mm):
    return mm(F.silu(mm(x, _f(p["w_gate"]))) * mm(x, _f(p["w_up"])),
              _f(p["w_down"]))


def moe(p, c, x, mm):
    """One document: x (S, d); the held experts' part and the shared
    experts."""
    E, k = c["router_experts"], c["num_experts_per_tok"]
    G, kg = c["n_group"], c["topk_group"]
    first, held = c["first_held_expert"], c["n_routed_experts"]
    probs = torch.softmax(mm(x, _f(p["router"])), dim=-1)   # (S, E)
    groups = probs.view(-1, G, E // G)
    best = groups.amax(-1).topk(kg, dim=-1).indices
    kept = torch.zeros(groups.shape[:2], dtype=torch.bool, device=x.device)
    kept[torch.arange(kept.shape[0], device=x.device)[:, None], best] = True
    scores = groups.masked_fill(~kept[..., None], 0.0).view(-1, E)
    topv, topi = torch.topk(scores, k, dim=-1)
    if c["norm_topk_prob"]:
        topv = topv / topv.sum(-1, keepdim=True)
    topv = topv * c["routed_scaling_factor"]
    out = swiglu(p["shared"], x, mm)
    for e in range(held):
        rows, slot = (topi == first + e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        h = F.silu(mm(xe, _f(p["w_gate"][e]))) * mm(xe, _f(p["w_up"][e]))
        out.index_add_(0, rows, mm(h, _f(p["w_down"][e]))
                       * topv[rows, slot][:, None])
    return out


def forward(params, c: dict, tokens: torch.Tensor, mm=exact_mm):
    """Logits (B, S, V) float32 of ``tokens`` (B, S) under ``params`` (the
    benchmark's weights in the port's layout) and the sizes ``c`` (the
    configuration file), a document at a time."""
    eps = c["rms_norm_eps"]
    rope = yarn(c, tokens.shape[1], tokens.device)
    out = []
    for doc in tokens:
        h = _f(params["embed"]["tok"][doc])
        for i, blk in enumerate(params["blocks"]):
            h = h + attention(blk["attn"], c,
                              rmsnorm(h, blk["ln1"]["scale"], eps), mm, rope)
            x = rmsnorm(h, blk["ln2"]["scale"], eps)
            h = h + (swiglu(blk["mlp"], x, mm)
                     if i < c["first_k_dense_replace"]
                     else moe(blk["mlp"], c, x, mm))
        h = rmsnorm(h, params["final_norm"]["scale"], eps)
        out.append(mm(h, _f(params["embed"]["unembed"])))
    return torch.stack(out)


def step_flops(c: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one prefill of ``batch`` prompts of ``seq`` tokens on
    the equations the port runs and this file follows: 2 × the matrix
    parameters a token uses (MLA's projections; layer 0's MLP; in an MoE
    layer the router, the shared experts and the routed experts at
    k · held / E pairs a token, the routing being symmetric under random
    weights; the head), and the causal attention at 2·(dn + dr + dv) per
    head and pair of a query and a key at or before it."""
    d, L, V = c["hidden_size"], c["num_hidden_layers"], c["vocab_size"]
    H, dn, dr, dv = (c["num_attention_heads"], c["qk_nope_head_dim"],
                     c["qk_rope_head_dim"], c["v_head_dim"])
    rq, rkv = c["q_lora_rank"], c["kv_lora_rank"]
    mla = (d * rq + rq * H * (dr + dn) + d * (rkv + dr)
           + rkv * H * (dn + dv) + H * dv * d)
    dense = 3 * d * c["intermediate_size"]
    f, E = c["moe_intermediate_size"], c["router_experts"]
    pairs = c["num_experts_per_tok"] * c["n_routed_experts"] / E
    moe_layer = (d * E + 3 * d * f * c["n_shared_experts"]
                 + pairs * 3 * d * f)
    n_dense = min(c["first_k_dense_replace"], L)
    per_token = L * mla + n_dense * dense + (L - n_dense) * moe_layer + d * V
    attn = L * 2 * (dn + dr + dv) * H * batch * seq * (seq + 1) / 2
    return 2.0 * per_token * batch * seq + attn
