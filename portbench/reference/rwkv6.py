"""Plain float32 forward of RWKV-6 ("Finch", arXiv:2404.05892) as the
port defines it (``rwkv6-3b``).  Plain PyTorch only: it imports nothing
of the program and takes nothing the program made.

Per layer, with h the residual stream (float32 throughout), head size N,
x₋ the input shifted one token right (zeros before the first)::

    x  = rmsnorm(h) · scale1;  δ = x₋ − x
    m  = μ + tanh(x A) B                    (five targets w, k, v, r, g;
                                            A: (d, 5·l), B: (5, l, d))
    x_w, x_k, x_v, x_r, x_g = x + δ ⊙ m_i
    r, k, v = x_r W_r, x_k W_k, x_v W_v;  g = silu(x_g W_g)
    w  = exp(−exp(d₀ + tanh(x_w A_d) B_d))  (decay in (0, 1))
    o_t = r_t S + (r_t · (u ⊙ k_t)) v_t;  S ← diag(w_t) S + k_tᵀ v_t
                                            (per head, S₀ = 0, in order)
    o  = groupnorm_heads(o) · γ + β;  h += (o ⊙ g) W_o
    x  = rmsnorm(h) · scale2
    h += relu((x + (x₋ − x) ⊙ μ_k) W_k)² W_v

then logits = rmsnorm(h) · scale_f · W_head.  Every matrix product goes
through ``mm`` (exact float32 with TF32 off by default; the control passes
a lower precision); the recurrence is float32 step by step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def exact_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def _f(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * _f(scale)


def shifted(x):
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def wkv(r, k, v, w, u):
    """The WKV-6 recurrence, one step after another: r, k, v, w (B, T, H,
    N) float32, u (H, N).  Returns o (B, T, H, N)."""
    B, T, H, N = r.shape
    rt, kt, vt, wt = (t.permute(1, 0, 2, 3).reshape(T, B * H, N)
                      for t in (r, k, v, w))
    S = torch.zeros(B * H, N, N, dtype=torch.float32, device=r.device)
    o = torch.empty(T, B * H, 1, N, dtype=torch.float32, device=r.device)
    for t in range(T):
        torch.bmm(rt[t][:, None, :], S, out=o[t])
        S.mul_(wt[t][:, :, None]).baddbmm_(kt[t][:, :, None],
                                           vt[t][:, None, :])
    o = o.view(T, B, H, N).permute(1, 0, 2, 3)
    bonus = (r * _f(u) * k).sum(-1, keepdim=True)          # r_t · (u ⊙ k_t)
    return o + bonus * v


def time_mix(p, c, x, mm):
    B, T, d = x.shape
    N = c["head_size"]
    H, lora = d // N, c["time_mix_extra_dim"]
    delta = shifted(x) - x
    m = torch.tanh(mm(x, _f(p["mix_lora_a"]))).view(B, T, 5, lora)
    mix_b = _f(p["mix_lora_b"])
    mix_base = _f(p["mix_base"])
    xw, xk, xv, xr, xg = (x + delta * (mix_base[i] + mm(m[:, :, i],
                                                        mix_b[i]))
                          for i in range(5))
    r = mm(xr, _f(p["w_r"])).view(B, T, H, N)
    k = mm(xk, _f(p["w_k"])).view(B, T, H, N)
    v = mm(xv, _f(p["w_v"])).view(B, T, H, N)
    g = F.silu(mm(xg, _f(p["w_g"])))
    dec = _f(p["decay_base"]) + mm(torch.tanh(mm(xw, _f(p["decay_lora_a"]))),
                                   _f(p["decay_lora_b"]))
    w = torch.exp(-torch.exp(dec)).view(B, T, H, N)
    o = wkv(r, k, v, w, p["bonus"])
    mu = o.mean(-1, keepdim=True)
    var = ((o - mu) ** 2).mean(-1, keepdim=True)
    o = ((o - mu) * torch.rsqrt(var + c["group_norm_eps"])).reshape(B, T, d)
    o = o * _f(p["ln_x"]["scale"]) + _f(p["ln_x"]["bias"])
    return mm(o * g, _f(p["w_o"]))


def channel_mix(p, x, mm):
    xk = x + (shifted(x) - x) * _f(p["mix_k"])
    return mm(torch.square(torch.relu(mm(xk, _f(p["w_k"])))), _f(p["w_v"]))


def forward(params, c: dict, tokens: torch.Tensor, mm=exact_mm):
    """Logits (B, S, V) float32 of ``tokens`` (B, S) under ``params`` (the
    benchmark's weights in the port's layout) and the sizes ``c`` (the
    configuration file)."""
    eps = c["norm_eps"]
    h = _f(params["embed"]["tok"][tokens])
    for blk in params["blocks"]:
        h = h + time_mix(blk["tm"], c, rmsnorm(h, blk["ln1"]["scale"], eps),
                         mm)
        h = h + channel_mix(blk["cm"], rmsnorm(h, blk["ln2"]["scale"], eps),
                            mm)
    h = rmsnorm(h, params["final_norm"]["scale"], eps)
    return mm(h, _f(params["embed"]["unembed"]))


def step_flops(c: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one prefill of ``batch`` prompts of ``seq`` tokens,
    counted on the port's block, which this file follows, and not on
    Finch's: its channel mix has no receptance gate (Finch's adds 2·d² a
    token and layer, about 7 % of a step).  2 × the matrix parameters a
    token uses (r, k, v, g, o, the two LoRAs, the channel mix, the head)
    and the WKV recurrence at 5·N² a head and step (2N² for o, 3N² for
    S)."""
    d, L, N = c["hidden_size"], c["num_hidden_layers"], c["head_size"]
    lm, ld = c["time_mix_extra_dim"], c["time_decay_extra_dim"]
    per_layer = (5 * d * d + d * 5 * lm + 5 * lm * d + d * ld + ld * d
                 + 2 * d * c["intermediate_size"])
    per_token = L * per_layer + d * c["vocab_size"]
    wkv_flops = L * 5 * N * N * (d // N) * batch * seq
    return 2.0 * per_token * batch * seq + wkv_flops
