"""Top-level model: init / forward / loss / decode for every decoder family.

Counterpart of ``repro/models/model.py``: ``dense`` (and ``vlm`` /
``audio``, whose backbone is the dense block; their frontends are stubs
that take embeddings), ``moe`` (GQA or MLA attention with an MoE MLP:
``granite-moe-3b-a800m``, ``deepseek-v2-236b``), ``ssm`` (RWKV-6) and
``hybrid`` (Zamba2: a Mamba-2 trunk and ONE weight-shared attention + MLP
block applied after every ``SHARED_ATTN_EVERY`` trunk layers and after the
last, shorter segment).  ``loss_fn`` is the training loss (float32
log-softmax cross-entropy plus the MoE aux term).

On a mesh the parameters are DTensors placed by
``distributed.sharding.params_specs`` (``sharding.distribute``), the
inputs DTensors placed by ``batch_spec``, and every family runs as it
does on one device: DTensor's sharding rules choose each operation's
collectives, as GSPMD does for the reference.  ``act_sharding`` and
``sp_sharding`` (``distributed.spec.NamedSharding``s) redistribute the
activations where the reference calls ``with_sharding_constraint``: after
the embedding, after each trunk block (``sp_sharding``; not in the
hybrid's segments, as there) and before the final norm.  Where DTensor
has no usable rule, or its greedy per-operation choice would change the
layout from layer to layer (GSPMD carries the reference's constraints
through its scan body), the model places tensors itself
(``repro_torch._dtensor``), each place tested on gloo ranks:

  * each block's weights are gathered over the mesh dims that split the
    batch (ZeRO-3; their model-axis split stays), a row-parallel output
    is reduced with Megatron's "g" (``_dtensor.reduced``: an identity
    gradient), and without ``sp_sharding`` the residual after every block
    takes ``act_sharding`` (no value changes);
  * the vocab-parallel embedding and cross-entropy on each rank's vocab
    shard (``layers._VocabParallelEmbed``, ``_VocabParallelNLL``):
    DTensor's masked-partial embedding reduces its output once only and
    cannot take a partial gradient, and its ``gather`` on a split vocab
    fails to apply its mask;
  * a reshape that unflattens a split dim the mesh does not divide (20
    heads on 16 ranks, RWKV-6's 5 mixing targets) gathers that dim first,
    forward and backward (``_dtensor.split_last`` / ``merge_last``), and
    the attention's q, k and v are placed for its core
    (``layers._head_placed``);
  * MoE expert products: the shared (N, d) rows expanded over E before
    the batched product (the backward of ``matmul``'s own broadcast views
    a non-contiguous shard; ``moe._experts``);
  * tensors made from nothing (positions, rotary tables, causal masks,
    zero scan states) join as replicated DTensors
    (``_dtensor.replicated_like``); a decode writes each rank's own cache
    positions (``layers._scatter_cache``).

A split over a mesh dim of one rank is no split (``_dtensor.effective``):
on a mesh of one rank every operation runs as the plain path does.  The
flash-attention and WKV ops (``use_kernel``, forward only) run on each
rank's local heads (``layers._flash_attention``, ``rwkv._wkv_op``).

Rematerialisation (``remat=True``, the reference's default) checkpoints
each trunk block as the reference's ``jax.checkpoint`` does — the
hybrid's shared block stays outside it, as there — with
``torch.utils.checkpoint`` (non-reentrant).  ``REMAT_POLICIES`` names what
a block saves: ``"nothing"`` (its input only), ``"dots"`` (every matrix
product's output) and ``"dots_no_batch"`` (the 2-D products only, ``mm`` /
``addmm``; attention's batched ``bmm`` is recomputed), the counterparts of
``jax.checkpoint_policies``.  Without autograd (``torch.no_grad()``, the
serving steps) there is nothing to recompute and ``remat`` changes
nothing.

Behaviours of the reference kept as they are: MLA never reaches the
flash-attention op, and decode runs MoE with dense dispatch whatever
``forward``'s ``moe_dispatch``.  Beyond the reference, each behind a config
field whose default keeps the reference's: the layers before
``moe_layer_start`` of an MoE model are dense (a SwiGLU MLP of width
``d_ff`` under ``model.mlp``; the reference does not read the field, and
the registered configs leave it 0), MLA's core goes through the MLA op with
``use_kernel`` (``layers.mla_apply``), and the MoE layer takes DeepSeek-V2's
group-limited routing, weights and an expert share (``models/moe``).
``forward``'s dense dispatch is the reference's on the CPU, under autograd
and on a mesh; a forward on the card without autograd, large enough that
dense dispatch's wasted products outweigh the dropless path's launches
(``DROPLESS_MIN_WASTE_FLOP``), runs the same function by dropless dispatch
(``moe.moe_apply_dropless``: each token through its top-k experts only).

Spans (``observability.spans.span``: ranges in a ``torch.profiler`` trace
while one records, spans of an installed tracer, one boolean check
otherwise) name the forward's layers, one name per block kind:
``model.embed``; ``model.attention`` (``ln1``, the attention, the residual
add), then ``model.mlp`` or ``model.moe`` (``ln2``, the MLP or the
dispatch with its router ``model.moe.router`` and its shared experts
``model.moe.shared``, the residual add);
``model.time_mix`` and ``model.channel_mix`` (RWKV-6); ``model.mamba`` and
``model.shared_attention`` (the hybrid); ``model.head`` (the final norm and
the unembedding).  The kernel ops open ``kernels.flash_attention``,
``kernels.mla_attention`` and ``kernels.rwkv_wkv`` inside them.

Differences of form from the reference, none of result:

  * Parameters are a dict of tensors whose names are the JAX pytree paths
    (``embed/tok``, ``blocks/attn/w_q``, …), with ``blocks`` a list of
    per-layer dicts instead of one stack with a leading L axis: PyTorch
    runs the layer loop in Python, not as a ``lax.scan``.
  * Decode caches keep the reference's stacked layout (L, B, …; the
    hybrid's shared-attention caches (n_shared, B, …)), so the slot axis
    of every cache leaf is axis 1, as the serving engine's ``_merge_slot``
    needs.  ``DecodeState.index`` is a Python int.
  * ``decode_step`` does not modify the state it is given: it copies the
    KV (or MLA latent) cache once (as the reference's un-donated jit does)
    and writes the new positions into the copy in place.
  * ``init_params_abstract(cfg)`` gives the parameter tree on the ``meta``
    device (shapes and types, no storage), where the reference takes a key
    and returns ``jax.ShapeDtypeStruct``s.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch import _device
from repro_torch._dtensor import (constrain, gathered_over_batch, is_dtensor,
                                  reduced, shard_extent, whole)
from repro_torch.distributed.spec import NamedSharding
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as X
from repro_torch.models import rwkv as R
from repro_torch.observability.spans import span

Params = Dict[str, Any]

SHARED_ATTN_EVERY = 27   # Zamba2: shared attention block cadence


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _block_init(gen, cfg: ArchConfig, device, moe: bool) -> Params:
    """One layer's params for the arch's trunk: an MoE MLP where ``moe``
    (``_is_moe``), else a dense one."""
    dt = L.torch_dtype(cfg)
    if cfg.family == "ssm":                       # RWKV-6
        return {"ln1": L.rmsnorm_init(cfg.d_model, dt, device),
                "tm": R.time_mix_init(gen, cfg, device),
                "ln2": L.rmsnorm_init(cfg.d_model, dt, device),
                "cm": R.channel_mix_init(gen, cfg, device)}
    if cfg.family == "hybrid":                    # Mamba-2 trunk
        return {"ln1": L.rmsnorm_init(cfg.d_model, dt, device),
                "mamba": M.mamba_init(gen, cfg, device)}
    return {"ln1": L.rmsnorm_init(cfg.d_model, dt, device),
            "ln2": L.rmsnorm_init(cfg.d_model, dt, device),
            "attn": (L.mla_init(gen, cfg, device) if cfg.use_mla
                     else L.attention_init(gen, cfg, device)),
            "mlp": (X.moe_init(gen, cfg, device) if moe
                    else L.mlp_init(gen, cfg, device=device))}


def _is_moe(cfg: ArchConfig, layer: int) -> bool:
    """Whether trunk layer ``layer`` has an MoE MLP: every layer from
    ``moe_layer_start`` on, in a model with MoE."""
    return cfg.moe is not None and layer >= cfg.moe_layer_start


def init_params(cfg: ArchConfig, generator: torch.Generator = None,
                device=None) -> Params:
    """Random parameters drawn on ``device`` (default ``cuda``) from
    ``generator`` (default: seed 0 on that device).  The distributions are
    the reference's: dense weights and expert stacks standard normal ×
    1/√d_in, the token embedding × 0.02, the Mamba conv weights × 0.1,
    RWKV mixing vectors uniform × 0.5, the bonus normal × 0.05, zeros,
    ones and the log-spaced A where it has them.  The numbers differ from
    ``jax.random``'s; to run both packages on the same weights, carry them
    across with ``repro_torch.interop.params_from_numpy``."""
    dev = _device.resolve(device)
    gen = generator
    if gen is None and dev.type != "meta":
        gen = torch.Generator(device=dev).manual_seed(0)
    if gen is not None and gen.device.type != dev.type:
        raise ValueError(f"init_params: the generator is on {gen.device}, "
                         f"the parameters go to {dev}")
    dt = L.torch_dtype(cfg)
    p = {"embed": L.embedding_init(gen, cfg, dev),
         "blocks": [_block_init(gen, cfg, dev, _is_moe(cfg, i))
                    for i in range(cfg.num_layers)],
         "final_norm": L.rmsnorm_init(cfg.d_model, dt, dev)}
    if cfg.family == "hybrid":
        # shared attention (+ its MLP): ONE weight set reused across depth
        p["shared_attn"] = {"ln1": L.rmsnorm_init(cfg.d_model, dt, dev),
                            "attn": L.attention_init(gen, cfg, dev),
                            "ln2": L.rmsnorm_init(cfg.d_model, dt, dev),
                            "mlp": L.mlp_init(gen, cfg, device=dev)}
    return p


def init_params_abstract(cfg: ArchConfig) -> Params:
    """The parameter tree of ``cfg`` on the ``meta`` device: every leaf's
    shape and type, no storage (the counterpart of ``jax.eval_shape`` of
    ``init_params``)."""
    return init_params(cfg, device="meta")


# ---------------------------------------------------------------------------
# Forward (training / prefill)
# ---------------------------------------------------------------------------

def _dense_block(bp: Params, cfg: ArchConfig, h: torch.Tensor,
                 use_kernel: bool, moe: bool, moe_dispatch: str = "dense"):
    """One attention layer; its MLP is MoE where ``moe`` (``_is_moe``)."""
    bp = gathered_over_batch(bp, h)
    with span("model.attention"):
        x = L.rmsnorm(bp["ln1"], h, cfg.norm_eps)
        if cfg.use_mla:
            a, _ = L.mla_apply(bp["attn"], cfg, x, use_kernel=use_kernel)
        else:
            a, _ = L.attention_apply(bp["attn"], cfg, x,
                                     use_kernel=use_kernel)
        h = h + reduced(a)
    if not moe:
        with span("model.mlp"):
            mo = L.mlp_apply(bp["mlp"], L.rmsnorm(bp["ln2"], h, cfg.norm_eps),
                             cfg.mlp_activation)
            return h + reduced(mo), 0.0
    with span("model.moe"):
        m_in = L.rmsnorm(bp["ln2"], h, cfg.norm_eps)
        if moe_dispatch == "sparse":
            mo, aux = X.moe_apply_sparse_gather(bp["mlp"], cfg, m_in)
        elif _dropless(m_in, cfg):
            mo, aux = X.moe_apply_dropless(bp["mlp"], cfg, m_in)
        else:
            mo, aux = X.moe_apply_dense(bp["mlp"], cfg, m_in)
        return h + reduced(mo), aux


# Dense dispatch's expert products spend 6·(E - k)·N·d·f FLOP a layer on
# rows the router did not choose (over E experts held here, k·E/E_all of
# whose pairs a token routes here).  Dropless dispatch launches about twice
# as many ops a layer, 0.7-0.95 ms more host time on an H100's host at 2 k
# to 8 k tokens, which paces a small forward.  Below this much waste (about
# the products' time for it at the 600-775 TFLOP/s they reach there) the
# launches cost more than the waste: granite-moe-3b-a800m's prefill of one
# 2,048-token prompt (3.1e11) ran 57 % longer by dropless dispatch, of four
# (1.2e12) 39 % shorter, deepseek-v2-236b's of one (1.5e13) 47 % shorter.
DROPLESS_MIN_WASTE_FLOP = 6e11


def _dropless(x: torch.Tensor, cfg: ArchConfig) -> bool:
    """Whether dense dispatch gives way to ``moe_apply_dropless``: on the
    card, off a mesh and without autograd, as a prefill or scoring forward
    runs, over enough tokens that dense dispatch's wasted products reach
    ``DROPLESS_MIN_WASTE_FLOP``.  Training and mesh-placed forwards keep
    the reference's formulation, which autograd and DTensor's sharding
    rules go through."""
    m = cfg.moe
    first, end = m.held
    held = end - first
    waste = (6 * (held - m.top_k * held / m.num_experts) * x.numel()
             * m.expert_d_ff)
    return (x.is_cuda and not is_dtensor(x) and not torch.is_grad_enabled()
            and waste >= DROPLESS_MIN_WASTE_FLOP)


def _rwkv_block(bp: Params, cfg: ArchConfig, h: torch.Tensor,
                use_kernel: bool):
    bp = gathered_over_batch(bp, h)
    with span("model.time_mix"):
        a, _ = R.time_mix_apply(bp["tm"], cfg,
                                L.rmsnorm(bp["ln1"], h, cfg.norm_eps),
                                use_kernel=use_kernel)
        h = h + reduced(a)
    with span("model.channel_mix"):
        c, _ = R.channel_mix_apply(bp["cm"], cfg,
                                   L.rmsnorm(bp["ln2"], h, cfg.norm_eps))
        return h + reduced(c), 0.0


def _mamba_block(bp: Params, cfg: ArchConfig, h: torch.Tensor):
    bp = gathered_over_batch(bp, h)
    with span("model.mamba"):
        a, _ = M.mamba_apply(bp["mamba"], cfg,
                             L.rmsnorm(bp["ln1"], h, cfg.norm_eps))
        return h + reduced(a), 0.0


def _shared_attn_block(sp: Params, cfg: ArchConfig, h: torch.Tensor,
                       use_kernel: bool, kv_cache=None, cache_index=None):
    sp = gathered_over_batch(sp, h)
    with span("model.shared_attention"):
        a, cache = L.attention_apply(sp["attn"], cfg,
                                     L.rmsnorm(sp["ln1"], h, cfg.norm_eps),
                                     kv_cache=kv_cache,
                                     cache_index=cache_index,
                                     use_kernel=use_kernel)
        h = h + reduced(a)
        return h + reduced(L.mlp_apply(
            sp["mlp"], L.rmsnorm(sp["ln2"], h, cfg.norm_eps),
            cfg.mlp_activation)), cache


def _segments(cfg: ArchConfig):
    """The hybrid trunk's segments: (first layer, end) of each run of
    ``SHARED_ATTN_EVERY`` layers (read at call time), the last one shorter
    where the depth is not a multiple; the shared block follows each."""
    n = cfg.num_layers
    every = min(SHARED_ATTN_EVERY, n)
    return [(s, min(s + every, n)) for s in range(0, n, every)]


def _embed_inputs(params: Params, cfg: ArchConfig, inputs: torch.Tensor):
    if cfg.embedding_frontend == "stub_embeddings" and inputs.ndim == 3:
        return inputs.to(L.torch_dtype(cfg))
    return L.embed(params["embed"], inputs)


def _saving_products(batched: bool):
    """A selective-checkpoint policy that saves the outputs of the matrix
    products (the 2-D ones only unless ``batched``) and recomputes the
    rest."""
    aten = torch.ops.aten
    saved = {aten.mm.default, aten.addmm.default}
    if batched:
        saved |= {aten.bmm.default, aten.baddbmm.default}

    def policy(ctx, op, *args, **kwargs):
        return (_ckpt.CheckpointPolicy.MUST_SAVE if op in saved
                else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


REMAT_POLICIES = {
    "nothing": None,
    "dots": _saving_products(batched=True),
    "dots_no_batch": _saving_products(batched=False),
}


def _rematted(block, policy_name: str):
    """``block`` under ``torch.utils.checkpoint`` with the named policy."""
    policy = REMAT_POLICIES[policy_name]
    context_fn = _ckpt.noop_context_fn if policy is None else \
        functools.partial(_ckpt.create_selective_checkpoint_contexts, policy)

    def run(*args):
        return _ckpt.checkpoint(block, *args, use_reentrant=False,
                                context_fn=context_fn)
    return run


def forward(params: Params, cfg: ArchConfig, inputs: torch.Tensor,
            use_kernel: bool = False, remat: bool = True,
            act_sharding=None, remat_policy: str = "nothing",
            sp_sharding=None, moe_dispatch: str = "dense") -> Tuple:
    """Full forward pass.  ``inputs``: int tokens (B, S) or precomputed
    embeddings (B, S, d) for stub frontends.  Returns (logits, aux_loss):
    aux_loss is the MoE load-balancing loss summed over the layers (a
    float32 scalar tensor), 0.0 for a model without MoE.

    ``use_kernel`` routes GQA attention (the hybrid's shared block
    included) through the flash-attention op and the RWKV recurrence
    through the WKV op; both are forward only, as the reference's Pallas
    kernels.  ``moe_dispatch="sparse"`` runs the MoE layers with
    ``moe_apply_sparse_gather``, anything else with dense dispatch, which
    on the card without autograd, off a mesh and over enough tokens
    (``_dropless``) is ``moe_apply_dropless`` (the same function up to
    summation order) and elsewhere ``moe_apply_dense``; a model without
    MoE ignores it.  ``remat`` checkpoints each trunk block under
    ``REMAT_POLICIES[remat_policy]`` when autograd records (see the module
    docstring).  ``act_sharding`` places the (B, S, d) activations after
    the embedding and before the final norm; ``sp_sharding`` the residual
    after every trunk block (sequence parallelism), both
    ``NamedSharding``s; without ``sp_sharding`` the residual after every
    block takes ``act_sharding`` (see the module docstring)."""
    with span("model.embed"):
        h = constrain(_embed_inputs(params, cfg, inputs), act_sharding)
    # block(bp, h, moe): ``moe`` is ``_is_moe`` of the layer (the RWKV and
    # Mamba trunks have no MoE)
    if cfg.family == "ssm":
        block = lambda bp, h, moe=False: _rwkv_block(bp, cfg, h, use_kernel)
    elif cfg.family == "hybrid":
        block = lambda bp, h, moe=False: _mamba_block(bp, cfg, h)
    else:
        block = lambda bp, h, moe: _dense_block(bp, cfg, h, use_kernel, moe,
                                                moe_dispatch)
    if remat and torch.is_grad_enabled():
        block = _rematted(block, remat_policy)

    blocks = params["blocks"]
    # one layout for the residual stream after every block (see the
    # module docstring)
    between = sp_sharding if sp_sharding is not None else act_sharding
    auxs = []
    if cfg.family == "hybrid":
        for start, end in _segments(cfg):
            for bp in blocks[start:end]:
                h, _ = block(bp, h)
                h = constrain(h, act_sharding)
            h, _ = _shared_attn_block(params["shared_attn"], cfg, h,
                                      use_kernel)
            h = constrain(h, act_sharding)
    else:
        for i, bp in enumerate(blocks):
            h, aux = block(bp, h, _is_moe(cfg, i))
            h = constrain(h, between)
            auxs.append(aux)
    with span("model.head"):
        h = L.rmsnorm(params["final_norm"], constrain(h, act_sharding),
                      cfg.norm_eps)
        logits = L.unembed(params["embed"], h)
    moe_aux = [a for a in auxs if isinstance(a, torch.Tensor)]
    aux_total = torch.stack(moe_aux).sum() if moe_aux else 0.0
    return logits, aux_total


def loss_fn(params: Params, cfg: ArchConfig, inputs, labels,
            use_kernel: bool = False, remat: bool = True,
            act_sharding=None, remat_policy: str = "nothing",
            sp_sharding=None, moe_dispatch: str = "dense") -> torch.Tensor:
    """Mean next-token cross-entropy (+ MoE aux), a float32 scalar tensor.
    ``labels``: (B, S) int."""
    logits, aux = forward(params, cfg, inputs, use_kernel, remat,
                          act_sharding=act_sharding,
                          remat_policy=remat_policy,
                          sp_sharding=sp_sharding,
                          moe_dispatch=moe_dispatch)
    if is_dtensor(logits):
        nll = _vocab_parallel_nll(logits.to(torch.float32), labels.long())
    else:
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    loss = torch.mean(nll)
    if cfg.moe:
        loss = loss + cfg.moe.router_aux_loss * aux / cfg.num_layers
    return loss


def _vocab_parallel_nll(lf, labels):
    """−log softmax(lf)[label] of float32 DTensor logits (B, S, V).  With
    the vocab split over one mesh dim (the column-parallel unembed), the
    Megatron vocab-parallel cross-entropy (``_VocabParallelNLL``) on each
    rank's shard: no rank gathers the vocab, and the logits' gradient keeps
    their placements.  Otherwise the vocab is gathered and the plain
    formula runs on DTensors."""
    from torch.distributed.tensor import Shard
    split = [i for i, p in enumerate(lf.placements)
             if isinstance(p, Shard) and p.dim == lf.ndim - 1]
    if len(split) != 1 or any(isinstance(p, Shard) and p.dim != 0
                              for i, p in enumerate(lf.placements)
                              if i != split[0]):
        logp = torch.log_softmax(whole(lf, -1), dim=-1)
        lab = labels if is_dtensor(labels) else \
            constrain(labels, NamedSharding(lf.device_mesh, None))
        return -torch.gather(logp, -1, lab[..., None])[..., 0]
    return _VocabParallelNLL.apply(lf, labels, split[0])


class _VocabParallelNLL(torch.autograd.Function):
    """Forward: each rank's max, sum of exps and label logit over its vocab
    shard, reduced over the vocab's mesh dim ``t`` (a max and two sums of
    (B, S) values); the output keeps the batch split, whole over ``t``.
    Backward: softmax − one-hot on the rank's shard."""

    @staticmethod
    def forward(ctx, lf, labels, t):
        from torch.distributed import _functional_collectives as funcol
        from torch.distributed.tensor import DTensor, Replicate
        mesh = lf.device_mesh
        rows = [Replicate() if i == t else p
                for i, p in enumerate(lf.placements)]
        lab = labels if is_dtensor(labels) else \
            constrain(labels, NamedSharding(mesh, None))
        lab = lab.redistribute(mesh, rows).to_local()
        local = lf.to_local()
        start = shard_extent(lf.shape, mesh, lf.placements)[1][-1]
        idx = lab - start
        inside = (idx >= 0) & (idx < local.shape[-1])
        idx = idx.clamp(0, local.shape[-1] - 1)
        group = (mesh, t)
        m = funcol.all_reduce(local.amax(-1), "max", group)
        e = torch.exp(local - m[..., None])
        total = funcol.all_reduce(e.sum(-1), "sum", group)
        picked = funcol.all_reduce(
            torch.gather(local, -1, idx[..., None])[..., 0] * inside,
            "sum", group)
        ctx.save_for_backward(e, total, idx, inside)
        ctx.spec = (mesh, tuple(lf.placements), tuple(rows))
        out = torch.log(total) + m - picked
        return DTensor.from_local(out, mesh, rows, run_check=False)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor
        e, total, idx, inside = ctx.saved_tensors
        mesh, places, rows = ctx.spec
        g = grad.redistribute(mesh, rows).to_local()
        d = e / total[..., None]
        d.scatter_add_(-1, idx[..., None], -inside[..., None].to(d.dtype))
        return DTensor.from_local(d * g[..., None], mesh, places,
                                  run_check=False), None, None


# ---------------------------------------------------------------------------
# Decode (serve_step)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DecodeState:
    """Stacked per-layer caches and the shared write index."""
    caches: Any            # dense / moe: (k, v) of (L, B, Smax, Hkv, D);
    #                        MLA: (latent (L, B, Smax, r_kv),
    #                              k_rope (L, B, Smax, dr));
    #                        ssm: (x_tm (L, B, d), wkv (L, B, H, N, N), x_cm);
    #                        hybrid: {"trunk": (conv (L, B, K−1, C),
    #                                           ssm (L, B, H, Nst, P)),
    #                                 "shared": (k, v) of
    #                                           (n_shared, B, Smax, Hkv, D)}
    index: int             # current length


def _stacked(one, n: int):
    return tuple(a.new_zeros((n,) + tuple(a.shape)) for a in one)


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      device=None) -> DecodeState:
    """Zero caches for ``batch`` sequences of up to ``max_len`` tokens on
    ``device`` (default ``cuda``)."""
    Ln, dt = cfg.num_layers, L.torch_dtype(cfg)
    if cfg.family == "ssm":
        caches = _stacked(R.rwkv_state_init(cfg, batch, device), Ln)
    elif cfg.family == "hybrid":
        caches = {"trunk": _stacked(M.mamba_state_init(cfg, batch, device),
                                    Ln),
                  "shared": _stacked(L.make_kv_cache(cfg, batch, max_len, dt,
                                                     device),
                                     len(_segments(cfg)))}
    elif cfg.use_mla:
        caches = _stacked(L.make_mla_cache(cfg, batch, max_len, dt, device),
                          Ln)
    else:
        caches = _stacked(L.make_kv_cache(cfg, batch, max_len, dt, device),
                          Ln)
    return DecodeState(caches=caches, index=0)


def decode_step(params: Params, cfg: ArchConfig, state: DecodeState,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, DecodeState]:
    """One serve step: tokens (B, S) int (or (B, S, d) embeddings) →
    (logits (B, S, V), new state).  ``state`` is left as it was."""
    if not cfg.has_decoder:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    h = _embed_inputs(params, cfg, tokens)
    idx = int(state.index)

    if cfg.family == "ssm":
        x_tm, wkv, x_cm = state.caches
        new = tuple(torch.empty_like(c) for c in state.caches)
        for l, bp in enumerate(params["blocks"]):
            a, (nx_tm, nwkv) = R.time_mix_apply(
                bp["tm"], cfg, L.rmsnorm(bp["ln1"], h, cfg.norm_eps),
                state=(x_tm[l], wkv[l]))
            h = h + a
            c, nx_cm = R.channel_mix_apply(
                bp["cm"], cfg, L.rmsnorm(bp["ln2"], h, cfg.norm_eps),
                x_prev=x_cm[l])
            h = h + c
            new[0][l], new[1][l], new[2][l] = nx_tm, nwkv, nx_cm
    elif cfg.family == "hybrid":
        conv, ssm = state.caches["trunk"]
        trunk = (torch.empty_like(conv), torch.empty_like(ssm))
        sk, sv = (c.clone() for c in state.caches["shared"])
        for si, (start, end) in enumerate(_segments(cfg)):
            for l in range(start, end):
                bp = params["blocks"][l]
                a, (nconv, nssm) = M.mamba_apply(
                    bp["mamba"], cfg, L.rmsnorm(bp["ln1"], h, cfg.norm_eps),
                    state=(conv[l], ssm[l]))
                h = h + a
                trunk[0][l], trunk[1][l] = nconv, nssm
            h, _ = _shared_attn_block(params["shared_attn"], cfg, h, False,
                                      kv_cache=(sk[si], sv[si]),
                                      cache_index=idx)
        new = {"trunk": trunk, "shared": (sk, sv)}
    else:
        new = tuple(c.clone() for c in state.caches)
        for l, bp in enumerate(params["blocks"]):
            x = L.rmsnorm(bp["ln1"], h, cfg.norm_eps)
            attn = L.mla_apply if cfg.use_mla else L.attention_apply
            a, _ = attn(bp["attn"], cfg, x, kv_cache=(new[0][l], new[1][l]),
                        cache_index=idx)
            h = h + a
            m_in = L.rmsnorm(bp["ln2"], h, cfg.norm_eps)
            if _is_moe(cfg, l):   # dense dispatch, as the reference
                mo, _ = X.moe_apply_dense(bp["mlp"], cfg, m_in)
            else:
                mo = L.mlp_apply(bp["mlp"], m_in, cfg.mlp_activation)
            h = h + mo

    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = L.unembed(params["embed"], h)
    return logits, DecodeState(caches=new, index=idx + tokens.shape[1])
