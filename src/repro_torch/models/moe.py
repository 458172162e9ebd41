"""Mixture-of-Experts layer (Granite-MoE and DeepSeek-V2 styles).

Counterpart of ``repro/models/moe.py``.  Dense dispatch runs every expert
on every token and the router's top-k weights gate the contributions; it
is the reference's formulation, and the one decode, training, mesh-placed
forwards and every forward on the CPU take.  Dropless dispatch
(``moe_apply_dropless``) computes the same function up to the order of
summation, running each token through its top-k experts only; a forward
on the card without autograd takes it (``models/model._dense_block``).
Two capacity-bounded sparse dispatches compute the same function for the
tokens their capacity keeps: by gather and scatter-add
(``moe_apply_sparse_gather``, what ``forward``'s ``moe_dispatch="sparse"``
selects) and by one-hot dispatch and combine products
(``moe_apply_sparse``).

DeepSeek-V2 details: shared experts (always on, in the span
``model.moe.shared``), top-k over the routed experts limited to the
``topk_group`` best of ``n_group`` groups (``group_limited_greedy``),
weights without renormalisation and × ``routed_scaling_factor`` where the
config says so, the Switch-style auxiliary load-balancing loss.

The expert share (``MoEConfig.first_held`` / ``num_held``, expert
parallelism's part of one device): the router keeps its width over all
routed experts, the layer holds the stacks of its own experts only, and
every dispatch computes the part of the result that the pairs routed to
them give (plus the shared experts).  Nothing stands in for the absent
experts.  Dense and dropless dispatch take a share; the capacity-bounded
sparse dispatches raise on one.

Layout: the experts are stacked (E, d, f) as in the reference, and the
expert products are batched over E (``torch.matmul`` of the (N, d) tokens
against the (E, d, f) stack), so no copy of a weight stack is made; the
down-projection contracts (e, f) jointly, as the reference's
``"bsef,efd->bsd"`` does.  Dropless dispatch multiplies each expert's
rows by its own (d, f) and (f, d) slices of the stacks, all experts in one
grouped product (``torch._grouped_mm``).  The router is float32 in a
bfloat16 model.

While tracing is on (``observability.spans``), the router runs in the span
``model.moe.router`` and each dispatch counts its expert rows in
``moe_expert_rows_total``: ``kind="computed"`` the rows the expert products
run (E·N for dense dispatch, E·cap for the sparse ones, k·N for dropless
dispatch; under a share, the held experts' E_held·N for dense dispatch and
the pairs routed here plus one padding row for dropless dispatch),
``kind="routed"`` the pairs the router assigns to the experts held here
(k·N, from shapes, when all are held; else a count on the device, read to
the host only while tracing).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch._dtensor import is_dtensor
from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models.layers import dense_init, torch_dtype
from repro_torch.observability.spans import count, span

Params = Dict[str, Any]

__all__ = ["moe_init", "moe_apply_dense", "moe_apply_dropless",
           "moe_apply_sparse_gather", "moe_apply_sparse"]


def moe_init(gen, cfg: ArchConfig, device=None) -> Params:
    """Router (d, E) float32 over all E routed experts; expert stacks
    (E_held, d, f) and (E_held, f, d) of the experts held here in the
    config's type, standard normal × 1/√fan-in; shared experts as one
    SwiGLU MLP of width f × num_shared_experts."""
    m = cfg.moe
    d, dff = cfg.d_model, m.expert_d_ff
    dt = torch_dtype(cfg)
    E = m.num_experts
    first, end = m.held
    Eh = end - first

    def stack(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (w * (1.0 / math.sqrt(fan_in))).to(dt)

    p = {"router": dense_init(gen, d, E, torch.float32, device),
         "w_gate": stack((Eh, d, dff), d),
         "w_up": stack((Eh, d, dff), d),
         "w_down": stack((Eh, dff, d), dff)}
    if m.num_shared_experts:
        sdff = dff * m.num_shared_experts
        p["shared"] = {"w_gate": dense_init(gen, d, sdff, dt, device),
                       "w_up": dense_init(gen, d, sdff, dt, device),
                       "w_down": dense_init(gen, sdff, d, dt, device)}
    return p


def _router_probs(params: Params, m: MoEConfig, x: torch.Tensor):
    """Returns (top-k gates (..., E) over all routed experts, dense-masked,
    aux).  The top-k of the softmax, taken with ``n_group`` > 1 within the
    ``topk_group`` groups whose largest probability is highest (DeepSeek-V2's
    ``group_limited_greedy``: the others' probabilities masked to 0);
    renormalised to sum 1 where ``norm_topk_prob``, then × the routed
    scaling factor."""
    with span("model.moe.router"):
        logits = x.to(torch.float32) @ params["router"]
        probs = torch.softmax(logits, dim=-1)
        scores = probs
        if m.n_group > 1:
            grouped = probs.unflatten(-1, (m.n_group, -1))
            best = grouped.amax(dim=-1).topk(m.topk_group, dim=-1).indices
            kept = torch.zeros_like(grouped[..., 0], dtype=torch.bool)
            kept.scatter_(-1, best, True)
            scores = grouped.masked_fill(~kept[..., None], 0.0).flatten(-2)
        topv, topi = torch.topk(scores, m.top_k, dim=-1)
        if m.norm_topk_prob:
            topv = topv / topv.sum(dim=-1, keepdim=True)   # renormalise
        if m.routed_scaling_factor != 1.0:
            topv = topv * m.routed_scaling_factor
        gates = torch.zeros_like(probs).scatter_(-1, topi, topv)
        # Switch-style load balancing: E * Σ_e f_e · p̄_e
        E = probs.shape[-1]
        frac_routed = (gates.reshape(-1, E) > 0).to(torch.float32).mean(
            dim=0)
        mean_prob = probs.reshape(-1, E).mean(dim=0)
        aux = E * torch.sum(frac_routed * mean_prob)
        return gates, aux


def _count_rows(computed: int, routed) -> None:
    """The rows the expert products run and the pairs routed here
    (``routed`` in any form ``spans.count`` takes)."""
    count("moe_expert_rows_total", computed, kind="computed")
    count("moe_expert_rows_total", routed, kind="routed")


def _shared(params: Params, x: torch.Tensor) -> torch.Tensor:
    sp = params["shared"]
    with span("model.moe.shared"):
        return (F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])) @ sp["w_down"]


def _held_gates(gates: torch.Tensor, m: MoEConfig) -> torch.Tensor:
    """The (N, E_held) columns of the (…, E) gates of the experts held
    here."""
    first, end = m.held
    g = gates.reshape(-1, gates.shape[-1])
    return g[:, first:end] if m.is_share else g


def _no_share(m: MoEConfig, dispatch: str) -> None:
    if m.is_share:
        raise NotImplementedError(
            f"{dispatch} takes every routed expert; this layer holds experts "
            f"{m.held[0]}..{m.held[1] - 1} of {m.num_experts}: use dense or "
            "dropless dispatch")


def _experts(params: Params, xe: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert on its rows: xe (E, n, d) or (n, d), shared
    by all experts -> (E, n, f).  On DTensors the shared rows are expanded
    over E first: the backward of ``matmul``'s own broadcast views a
    non-contiguous shard, which fails."""
    if is_dtensor(xe) and xe.ndim == 2:
        xe = xe.expand(params["w_gate"].shape[0], *xe.shape)
    return F.silu(torch.matmul(xe, params["w_gate"])) \
        * torch.matmul(xe, params["w_up"])


def moe_apply_dense(params: Params, cfg: ArchConfig,
                    x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-dispatch MoE: out = Σ_e gate_e · FFN_e(x) (+ shared experts).
    Returns (out (B, S, d), aux)."""
    m = cfg.moe
    B, S, d = x.shape
    first, end = m.held
    E, N = end - first, B * S
    gates, aux = _router_probs(params, m, x)              # (B, S, E_all)
    g = _held_gates(gates, m)                             # (N, E)
    _count_rows(E * N, (lambda: (g > 0).sum()) if m.is_share
                else m.top_k * N)
    h = _experts(params, x.reshape(N, d))                 # (E, N, f)
    # gate before the down-projection, which contracts (e, f) jointly
    h = h * g.T.to(x.dtype)[..., None]
    f = h.shape[-1]
    out = h.transpose(0, 1).reshape(N, E * f) \
        @ params["w_down"].reshape(E * f, d)
    out = out.reshape(B, S, d)
    if m.num_shared_experts:
        out = out + _shared(params, x)
    return out, aux


def moe_apply_dropless(params: Params, cfg: ArchConfig,
                       x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless top-k MoE: each routed (token, expert) pair runs its
    expert's SwiGLU once, so the products run k·N rows where dense dispatch
    runs E·N; the same function as ``moe_apply_dense`` up to the order of
    summation.  Returns (out (B, S, d), aux), the router's own.
    Under an expert share (``MoEConfig.num_held``) only the pairs routed to
    the experts held here run, and their number is read to the host once
    a layer to size the buffers: a static bound (k·N, or N a held expert)
    would be several times the pairs routed here, all run by the grouped
    products.  The shared experts are launched before the wait for that
    number (``_read_later``), so the card has their products to run while
    the host waits.

    The pairs are those whose gate is > 0, in expert-major order, tokens
    ascending, in (k·N, ·) buffers: the tokens' rows gathered once, then
    each of the three products one grouped product over all experts
    (``torch._grouped_mm``, each expert's rows against its own slice of the
    stack, cut by per-expert offsets that stay on the device), and between
    them SiLU·up and the gate, in the working type before the down product
    as dense dispatch gates.  Nothing is read to the host.  A pair whose
    gate underflowed to 0 (it adds nothing under dense dispatch either)
    leaves a padding row at the end, gate 0, run with the last expert: its
    output is exactly 0, and a token with fewer than k pairs reads the last
    row in their place.  Each token then sums its k outputs in float32,
    experts ascending, rounded to the working type once.  Nothing is
    (E, N, ·): the largest transients are the (k·N, d) rows gathered in and
    their outputs.
    """
    m = cfg.moe
    B, S, d = x.shape
    first, end = m.held
    E, k, N = end - first, m.top_k, B * S
    dev = x.device
    gates, aux = _router_probs(params, m, x)              # (B, S, E_all)
    g = _held_gates(gates, m)                             # (N, E)
    routed = (g > 0).T.contiguous()          # (E, N), k a token at most
    if m.is_share:
        count = _read_later(routed.sum())
    # launched before the wait for the count, so the card runs them then
    shared = _shared(params, x) if m.num_shared_experts else None
    if m.is_share:
        # the pairs routed here, and one padding row
        n_routed = count()
        P = n_routed + 1
    else:
        n_routed = P = k * N
    _count_rows(P, n_routed)
    # the routed (e, n) cells in expert-major order, E·N (token 0, gate 0)
    # at a padding place; nonzero_static reads nothing to the host
    em = routed.view(-1)
    pair = torch.nonzero_static(em, size=P, fill_value=E * N).squeeze(1)
    gate = F.pad(g.T.reshape(-1), (0, 1))[pair].to(x.dtype)[:, None]
    offs = routed.sum(dim=1).cumsum(0).to(torch.int32)
    offs[-1] = P                                          # padding: last expert
    xs = x.reshape(N, d).index_select(0, pair % N)        # (P, d)
    h = F.silu(torch._grouped_mm(xs, params["w_gate"], offs=offs)).mul_(
        torch._grouped_mm(xs, params["w_up"], offs=offs)).mul_(gate)
    del xs
    y = torch._grouped_mm(h, params["w_down"], offs=offs)  # (P, d)
    del h
    # token n's places, experts ascending: its j-th routed expert's place
    # in slot j, the padding row P - 1 in a slot it lacks, unrouted cells
    # in slot k, dropped
    place = em.cumsum(0).view(E, N) - 1
    slot = torch.where(routed, routed.cumsum(0) - 1, k)
    src = torch.full((k + 1, N), P - 1, device=dev).scatter_(
        0, slot, place)[:k].T
    out = y.index_select(0, src.reshape(-1)).view(N, k, d).sum(
        dim=1, dtype=torch.float32).to(x.dtype).reshape(B, S, d)
    if shared is not None:
        out = out + shared
    return out, aux


def _read_later(t: torch.Tensor):
    """A function that returns ``int(t)`` of a one-element tensor whose
    copy to the host starts now: on the card into pinned memory behind an
    event, so that the wait holds up neither the work launched after this
    call nor the card, which runs it meanwhile."""
    if not t.is_cuda:
        value = int(t)
        return lambda: value
    host = torch.empty((), dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait() -> int:
        done.synchronize()
        return int(host)
    return wait


def _capacity(capacity_factor: float, N: int, k: int, E: int) -> int:
    return max(1, int(capacity_factor * N * k / E))


def moe_apply_sparse_gather(params: Params, cfg: ArchConfig,
                            x: torch.Tensor, capacity_factor: float = 2.0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-bounded sparse dispatch by gather and scatter-add.

    Per expert: its token ids are the first ``cap`` rows of a stable sort
    of the keep mask (kept tokens first, in token order); the (E, cap, d)
    gather runs the expert FFNs batched over E, and the gated outputs are
    added back into their tokens (``index_add_``; a slot past the kept
    tokens adds zeros).  Tokens beyond an expert's capacity are dropped
    from it.  Compute scales with E·cap ≈ cf·k·N instead of E·N.
    """
    m = cfg.moe
    _no_share(m, "moe_apply_sparse_gather")
    B, S, d = x.shape
    E, k = m.num_experts, m.top_k
    N = B * S
    xf = x.reshape(N, d)
    cap = _capacity(capacity_factor, N, k, E)
    _count_rows(E * cap, k * N)
    gates, aux = _router_probs(params, m, x)
    gflat = gates.reshape(N, E)

    active = gflat > 0
    pos = torch.cumsum(active.to(torch.int32), dim=0) - 1
    keep = active & (pos < cap)
    # stable sort of the inverted mask (torch sorts no bool: an int copy)
    order = torch.argsort((~keep).to(torch.int8), dim=0, stable=True)
    ids = order[:cap].T                                   # (E, cap)
    valid = torch.take_along_dim(keep, order[:cap], dim=0).T

    ye = _experts(params, xf[ids]) @ params["w_down"]     # (E, cap, d)
    g_slot = torch.take_along_dim(gflat.T, ids, dim=1) \
        * valid.to(gflat.dtype)                           # (E, cap)
    contrib = (ye * g_slot[..., None].to(ye.dtype)).reshape(-1, d)
    out = torch.zeros(N, d, dtype=x.dtype, device=x.device).index_add_(
        0, ids.reshape(-1), contrib.to(x.dtype))
    out = out.reshape(B, S, d)
    if m.num_shared_experts:
        out = out + _shared(params, x)
    return out, aux


def moe_apply_sparse(params: Params, cfg: ArchConfig, x: torch.Tensor,
                     capacity_factor: float = 2.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-bounded sparse dispatch by one-hot (N, E, cap) dispatch and
    combine products.  Tokens beyond an expert's capacity are dropped
    (the residual passes them through)."""
    m = cfg.moe
    _no_share(m, "moe_apply_sparse")
    B, S, d = x.shape
    E, k = m.num_experts, m.top_k
    N = B * S
    xf = x.reshape(N, d)
    cap = _capacity(capacity_factor, N, k, E)
    _count_rows(E * cap, k * N)
    gates, aux = _router_probs(params, m, x)
    gflat = gates.reshape(N, E)

    active = (gflat > 0).to(torch.int32)
    pos = torch.cumsum(active, dim=0) - 1                 # (N, E)
    keep = (pos < cap) & (active > 0)
    # one-hot of pos over cap slots (all zeros where pos is -1 or >= cap)
    slots = torch.arange(cap, device=x.device)
    disp_f = (keep[..., None] & (pos[..., None] == slots)).to(x.dtype)
    xe = torch.einsum("nec,nd->ecd", disp_f, xf)          # (E, cap, d)
    ye = _experts(params, xe) @ params["w_down"]          # (E, cap, d)
    combine = disp_f * gflat[..., None].to(x.dtype)
    out = torch.einsum("nec,ecd->nd", combine, ye).reshape(B, S, d)
    if m.num_shared_experts:
        out = out + _shared(params, x)
    return out, aux
