"""Top-level model: init / forward / loss / decode for every decoder family.

Counterpart of ``repro/models/model.py``: ``dense`` (and ``vlm`` /
``audio``, whose backbone is the dense block; their frontends are stubs
that take embeddings), ``moe`` (GQA or MLA attention with an MoE MLP:
``granite-moe-3b-a800m``, ``deepseek-v2-236b``), ``ssm`` (RWKV-6) and
``hybrid`` (Zamba2: a Mamba-2 trunk and ONE weight-shared attention + MLP
block applied after every ``SHARED_ATTN_EVERY`` trunk layers and after the
last, shorter segment).  ``loss_fn`` is the training loss (float32
log-softmax cross-entropy plus the MoE aux term).  The sharding
constraints of ``forward`` (``act_sharding``, ``sp_sharding``) raise
``NotImplementedError`` until training on a mesh (ROADMAP A.12c).

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

Behaviours of the reference kept as they are: ``moe_layer_start`` is not
read (every layer of ``deepseek-v2-236b`` is MoE), MLA never reaches the
flash-attention op, and decode runs MoE with dense dispatch whatever
``forward``'s ``moe_dispatch``.

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
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as X
from repro_torch.models import rwkv as R

Params = Dict[str, Any]

SHARED_ATTN_EVERY = 27   # Zamba2: shared attention block cadence


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _block_init(gen, cfg: ArchConfig, device) -> Params:
    """One layer's params for the arch's (homogeneous) trunk."""
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
            "mlp": (X.moe_init(gen, cfg, device) if cfg.moe
                    else L.mlp_init(gen, cfg, device=device))}


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
         "blocks": [_block_init(gen, cfg, dev)
                    for _ in range(cfg.num_layers)],
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
                 use_kernel: bool, moe_dispatch: str = "dense"):
    x = L.rmsnorm(bp["ln1"], h, cfg.norm_eps)
    if cfg.use_mla:
        a, _ = L.mla_apply(bp["attn"], cfg, x)
    else:
        a, _ = L.attention_apply(bp["attn"], cfg, x, use_kernel=use_kernel)
    h = h + a
    m_in = L.rmsnorm(bp["ln2"], h, cfg.norm_eps)
    if cfg.moe:
        if moe_dispatch == "sparse":
            mo, aux = X.moe_apply_sparse_gather(bp["mlp"], cfg, m_in)
        else:
            mo, aux = X.moe_apply_dense(bp["mlp"], cfg, m_in)
    else:
        mo, aux = L.mlp_apply(bp["mlp"], m_in, cfg.mlp_activation), 0.0
    return h + mo, aux


def _rwkv_block(bp: Params, cfg: ArchConfig, h: torch.Tensor,
                use_kernel: bool):
    a, _ = R.time_mix_apply(bp["tm"], cfg,
                            L.rmsnorm(bp["ln1"], h, cfg.norm_eps),
                            use_kernel=use_kernel)
    h = h + a
    c, _ = R.channel_mix_apply(bp["cm"], cfg,
                               L.rmsnorm(bp["ln2"], h, cfg.norm_eps))
    return h + c, 0.0


def _mamba_block(bp: Params, cfg: ArchConfig, h: torch.Tensor):
    a, _ = M.mamba_apply(bp["mamba"], cfg,
                         L.rmsnorm(bp["ln1"], h, cfg.norm_eps))
    return h + a, 0.0


def _shared_attn_block(sp: Params, cfg: ArchConfig, h: torch.Tensor,
                       use_kernel: bool, kv_cache=None, cache_index=None):
    a, cache = L.attention_apply(sp["attn"], cfg,
                                 L.rmsnorm(sp["ln1"], h, cfg.norm_eps),
                                 kv_cache=kv_cache, cache_index=cache_index,
                                 use_kernel=use_kernel)
    h = h + a
    return h + L.mlp_apply(sp["mlp"], L.rmsnorm(sp["ln2"], h, cfg.norm_eps),
                           cfg.mlp_activation), cache


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
    ``moe_apply_sparse_gather``, anything else with dense dispatch; a
    model without MoE ignores it.  ``remat`` checkpoints each trunk block
    under ``REMAT_POLICIES[remat_policy]`` when autograd records (see the
    module docstring).  ``act_sharding`` and ``sp_sharding`` raise
    ``NotImplementedError`` until training on a mesh (ROADMAP A.12c)."""
    if act_sharding is not None or sp_sharding is not None:
        raise NotImplementedError("sharding constraints come with training "
                                  "on a mesh (ROADMAP A.12c)")
    h = _embed_inputs(params, cfg, inputs)
    if cfg.family == "ssm":
        block = lambda bp, h: _rwkv_block(bp, cfg, h, use_kernel)
    elif cfg.family == "hybrid":
        block = lambda bp, h: _mamba_block(bp, cfg, h)
    else:
        block = lambda bp, h: _dense_block(bp, cfg, h, use_kernel,
                                           moe_dispatch)
    if remat and torch.is_grad_enabled():
        block = _rematted(block, remat_policy)

    blocks = params["blocks"]
    auxs = []
    if cfg.family == "hybrid":
        for start, end in _segments(cfg):
            for bp in blocks[start:end]:
                h, _ = block(bp, h)
            h, _ = _shared_attn_block(params["shared_attn"], cfg, h,
                                      use_kernel)
    else:
        for bp in blocks:
            h, aux = block(bp, h)
            auxs.append(aux)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    aux_total = torch.stack(auxs).sum() if cfg.moe else 0.0
    return L.unembed(params["embed"], h), aux_total


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
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    loss = torch.mean(nll)
    if cfg.moe:
        loss = loss + cfg.moe.router_aux_loss * aux / cfg.num_layers
    return loss


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
            if cfg.moe:       # decode MoE is dense dispatch, as the reference
                mo, _ = X.moe_apply_dense(bp["mlp"], cfg, m_in)
            else:
                mo = L.mlp_apply(bp["mlp"], m_in, cfg.mlp_activation)
            h = h + mo

    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = L.unembed(params["embed"], h)
    return logits, DecodeState(caches=new, index=idx + tokens.shape[1])
