"""Top-level model: init / forward / decode for the dense and RWKV-6 families.

Counterpart of ``repro/models/model.py`` for the families the port serves
so far: ``dense`` (and ``vlm`` / ``audio``, whose backbone is the dense
block; their frontends are stubs that take embeddings) and ``ssm``
(RWKV-6).  MoE, MLA and the hybrid (Mamba-2) family raise
``NotImplementedError`` until their slice (ROADMAP A.12), as do the
training-side options of ``forward`` (``remat``, the sharding constraints,
sparse MoE dispatch).

Differences of form from the reference, none of result:

  * Parameters are a dict of tensors whose names are the JAX pytree paths
    (``embed/tok``, ``blocks/attn/w_q``, …), with ``blocks`` a list of
    per-layer dicts instead of one stack with a leading L axis: PyTorch
    runs the layer loop in Python, not as a ``lax.scan``.
  * Decode caches keep the reference's stacked layout (L, B, …), so the
    slot axis of every cache leaf is axis 1, as the serving engine's
    ``_merge_slot`` needs.  ``DecodeState.index`` is a Python int.
  * ``decode_step`` does not modify the state it is given: it copies the
    KV cache once (as the reference's un-donated jit does) and writes the
    new positions into the copy in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch import _device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import rwkv as R

Params = Dict[str, Any]


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not serve yet."""
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (ROADMAP A.12)")
    if cfg.use_mla:
        raise NotImplementedError(
            f"{cfg.name}: MLA attention is not ported yet (ROADMAP A.12)")
    if cfg.family == "hybrid":
        raise NotImplementedError(
            f"{cfg.name}: the hybrid (Mamba-2) family is not ported yet "
            "(ROADMAP A.12)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _block_init(gen, cfg: ArchConfig, device) -> Params:
    """One layer's params."""
    dt = L.torch_dtype(cfg)
    if cfg.family == "ssm":                       # RWKV-6
        return {"ln1": L.rmsnorm_init(cfg.d_model, dt, device),
                "tm": R.time_mix_init(gen, cfg, device),
                "ln2": L.rmsnorm_init(cfg.d_model, dt, device),
                "cm": R.channel_mix_init(gen, cfg, device)}
    return {"ln1": L.rmsnorm_init(cfg.d_model, dt, device),
            "ln2": L.rmsnorm_init(cfg.d_model, dt, device),
            "attn": L.attention_init(gen, cfg, device),
            "mlp": L.mlp_init(gen, cfg, device=device)}


def init_params(cfg: ArchConfig, generator: torch.Generator = None,
                device=None) -> Params:
    """Random parameters drawn on ``device`` (default ``cuda``) from
    ``generator`` (default: seed 0 on that device).  The distributions are
    the reference's: dense weights standard normal × 1/√d_in, the token
    embedding × 0.02, RWKV mixing vectors uniform × 0.5, the bonus normal
    × 0.05, zeros and ones where it has them.  The numbers differ from
    ``jax.random``'s; to run both packages on the same weights, carry them
    across with ``repro_torch.interop.params_from_numpy``."""
    check_supported(cfg)
    dev = _device.resolve(device)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    if gen.device.type != dev.type:
        raise ValueError(f"init_params: the generator is on {gen.device}, "
                         f"the parameters go to {dev}")
    dt = L.torch_dtype(cfg)
    return {"embed": L.embedding_init(gen, cfg, dev),
            "blocks": [_block_init(gen, cfg, dev)
                       for _ in range(cfg.num_layers)],
            "final_norm": L.rmsnorm_init(cfg.d_model, dt, dev)}


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _dense_block(bp: Params, cfg: ArchConfig, h: torch.Tensor,
                 use_kernel: bool) -> torch.Tensor:
    a, _ = L.attention_apply(bp["attn"], cfg,
                             L.rmsnorm(bp["ln1"], h, cfg.norm_eps),
                             use_kernel=use_kernel)
    h = h + a
    m_in = L.rmsnorm(bp["ln2"], h, cfg.norm_eps)
    return h + L.mlp_apply(bp["mlp"], m_in, cfg.mlp_activation)


def _rwkv_block(bp: Params, cfg: ArchConfig, h: torch.Tensor,
                use_kernel: bool) -> torch.Tensor:
    a, _ = R.time_mix_apply(bp["tm"], cfg,
                            L.rmsnorm(bp["ln1"], h, cfg.norm_eps),
                            use_kernel=use_kernel)
    h = h + a
    c, _ = R.channel_mix_apply(bp["cm"], cfg,
                               L.rmsnorm(bp["ln2"], h, cfg.norm_eps))
    return h + c


def _embed_inputs(params: Params, cfg: ArchConfig, inputs: torch.Tensor):
    if cfg.embedding_frontend == "stub_embeddings" and inputs.ndim == 3:
        return inputs.to(L.torch_dtype(cfg))
    return L.embed(params["embed"], inputs)


def forward(params: Params, cfg: ArchConfig, inputs: torch.Tensor,
            use_kernel: bool = False, remat: bool = False,
            act_sharding=None, remat_policy: str = "nothing",
            sp_sharding=None, moe_dispatch: str = "dense") -> Tuple:
    """Full forward pass.  ``inputs``: int tokens (B, S) or precomputed
    embeddings (B, S, d) for stub frontends.  Returns (logits, aux_loss);
    aux_loss is 0.0 (no MoE yet).

    ``use_kernel`` routes attention through the flash-attention op and the
    RWKV recurrence through the WKV op.  ``remat`` (default False here: the
    reference defaults to True, which only matters under a gradient),
    ``act_sharding``, ``sp_sharding`` and ``moe_dispatch != "dense"`` raise
    ``NotImplementedError`` until the training slice (ROADMAP A.12);
    ``remat_policy`` is only read with ``remat``."""
    check_supported(cfg)
    if remat:
        raise NotImplementedError("forward(remat=True) comes with the "
                                  "training slice (ROADMAP A.12)")
    if act_sharding is not None or sp_sharding is not None:
        raise NotImplementedError("sharding constraints come with the "
                                  "training slice (ROADMAP A.12)")
    if moe_dispatch != "dense":
        raise NotImplementedError("MoE dispatch comes with the MoE slice "
                                  "(ROADMAP A.12)")
    block = _rwkv_block if cfg.family == "ssm" else _dense_block
    h = _embed_inputs(params, cfg, inputs)
    for bp in params["blocks"]:
        h = block(bp, cfg, h, use_kernel)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return L.unembed(params["embed"], h), 0.0


# ---------------------------------------------------------------------------
# Decode (serve_step)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DecodeState:
    """Stacked per-layer caches and the shared write index."""
    caches: Any            # dense: (k, v) of (L, B, Smax, Hkv, D);
    #                        ssm: (x_tm (L, B, d), wkv (L, B, H, N, N), x_cm)
    index: int             # current length


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      device=None) -> DecodeState:
    """Zero caches for ``batch`` sequences of up to ``max_len`` tokens on
    ``device`` (default ``cuda``)."""
    check_supported(cfg)
    Ln = cfg.num_layers
    if cfg.family == "ssm":
        one = R.rwkv_state_init(cfg, batch, device)
    else:
        one = L.make_kv_cache(cfg, batch, max_len, L.torch_dtype(cfg),
                              device)
    caches = tuple(a.new_zeros((Ln,) + tuple(a.shape)) for a in one)
    return DecodeState(caches=caches, index=0)


def decode_step(params: Params, cfg: ArchConfig, state: DecodeState,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, DecodeState]:
    """One serve step: tokens (B, S) int (or (B, S, d) embeddings) →
    (logits (B, S, V), new state).  ``state`` is left as it was."""
    if not cfg.has_decoder:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    check_supported(cfg)
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
    else:
        new = tuple(c.clone() for c in state.caches)
        for l, bp in enumerate(params["blocks"]):
            x = L.rmsnorm(bp["ln1"], h, cfg.norm_eps)
            a, _ = L.attention_apply(bp["attn"], cfg, x,
                                     kv_cache=(new[0][l], new[1][l]),
                                     cache_index=idx)
            h = h + a
            m_in = L.rmsnorm(bp["ln2"], h, cfg.norm_eps)
            h = h + L.mlp_apply(bp["mlp"], m_in, cfg.mlp_activation)

    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = L.unembed(params["embed"], h)
    return logits, DecodeState(caches=new, index=idx + tokens.shape[1])
