"""Architecture config system.

One ``ArchConfig`` describes an LM-family backbone.  Every assigned arch gets
a module ``repro_torch.configs.<id>`` exporting ``CONFIG`` (exact published config)
and ``SMOKE_CONFIG`` (same family, tiny).  ``registry.get(name)`` resolves
``--arch <id>`` CLI flags.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0            # routed experts
    num_shared_experts: int = 0     # DeepSeek-style always-on experts
    top_k: int = 2
    expert_d_ff: int = 0            # per-expert FFN width
    router_aux_loss: float = 0.001  # load-balancing loss weight
    # DeepSeek-V2 routing: the top-k is taken within the ``topk_group``
    # groups (of ``n_group`` equal groups of experts) whose largest
    # probability is highest; 1 / 1 is the plain top-k over all experts
    n_group: int = 1
    topk_group: int = 1
    norm_topk_prob: bool = True     # renormalise the top-k weights to sum 1
    routed_scaling_factor: float = 1.0   # multiplies the routed weights
    # the routed experts held here (expert parallelism's share of one
    # device): experts first_held .. first_held + num_held - 1 of the
    # router's num_experts; 0 holds them all
    first_held: int = 0
    num_held: int = 0

    @property
    def held(self) -> Tuple[int, int]:
        """(first, end) of the routed experts held here."""
        n = self.num_held or self.num_experts - self.first_held
        return self.first_held, self.first_held + n

    @property
    def is_share(self) -> bool:
        """Whether only part of the routed experts is held here."""
        first, end = self.held
        return first > 0 or end < self.num_experts


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_size: int = 64            # per-channel recurrent state (Mamba2)
    conv_width: int = 4
    expand: int = 2
    num_heads: int = 0              # Mamba2 value heads (0 = d_inner/state)
    head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads
    # block types per layer for hybrids: 'attn' | 'rwkv' | 'mamba' | 'shared_attn'
    block_pattern: Optional[Tuple[str, ...]] = None
    mlp_activation: str = "silu"    # silu | gelu | relu2 (squared ReLU)
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mrope: bool = False             # multimodal rotary (Qwen2-VL)
    tie_embeddings: bool = False
    causal: bool = True             # False => encoder-only (HuBERT)
    has_decoder: bool = True        # False => no serve_step decode shapes
    # MLA (DeepSeek-V2) options
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128
    # YaRN rotary scaling (DeepSeek-V2's rope_scaling); factor 1 is plain
    # RoPE
    yarn_factor: float = 1.0
    yarn_original_max_position: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    moe_layer_start: int = 0        # DeepSeek: first k layers dense
    norm_eps: float = 1e-5
    # frontends ([vlm]/[audio]) are stubs: inputs arrive as embeddings
    embedding_frontend: str = "tokens"   # tokens | stub_embeddings
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic context handling (SSM / hybrid) — long_500k cells."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline MODEL_FLOPS)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.resolved_head_dim
        n = V * d                      # embedding
        if not self.tie_embeddings:
            n += V * d                 # unembedding
        pattern = self.block_pattern or self._default_pattern()
        for kind in pattern:
            n += 2 * d                 # norms (pre-attn + pre-mlp, RMS)
            if kind in ("attn", "shared_attn"):
                if self.use_mla:
                    r_kv, r_q = self.kv_lora_rank, (self.q_lora_rank or d)
                    qk = self.qk_rope_head_dim + self.qk_nope_head_dim
                    n += d * r_q + r_q * self.num_heads * qk
                    n += d * (r_kv + self.qk_rope_head_dim)
                    n += r_kv * self.num_heads * (self.qk_nope_head_dim
                                                  + self.v_head_dim)
                    n += self.num_heads * self.v_head_dim * d
                else:
                    n += d * self.num_heads * hd          # Q
                    n += 2 * d * self.num_kv_heads * hd   # K, V
                    n += self.num_heads * hd * d          # O
            elif kind == "rwkv":
                n += 4 * d * d + 2 * d * d // 1          # r,k,v,o + w,u approx
            elif kind == "mamba":
                s = self.ssm or SSMConfig()
                d_in = s.expand * d
                n += d * 2 * d_in + d_in * d + d_in * (2 * s.state_size)
            # MLP
            if kind == "mamba":
                pass                                      # mamba block has no extra MLP
            elif self.moe and kind != "dense_mlp_only":
                m = self.moe
                act = d * m.expert_d_ff * 3
                n += m.num_experts * act + m.num_shared_experts * act
                n += d * m.num_experts                    # router
            else:
                mult = 3 if self.mlp_activation == "silu" else 2
                n += mult * d * self.d_ff
        if self.family == "hybrid":
            # one weight-shared attention (+MLP) block reused across depth
            hd = self.resolved_head_dim
            n += d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
                + self.num_heads * hd * d
            n += (3 if self.mlp_activation == "silu" else 2) * d * self.d_ff
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared only)."""
        if not self.moe:
            return self.param_count()
        m = self.moe
        full = self.param_count()
        act = 3 * self.d_model * m.expert_d_ff
        inactive = (m.num_experts - m.top_k) * act * self.num_layers
        return full - inactive

    def _default_pattern(self) -> Tuple[str, ...]:
        if self.family == "ssm":
            return ("rwkv",) * self.num_layers
        if self.family == "hybrid":
            return ("mamba",) * self.num_layers
        return ("attn",) * self.num_layers


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY = {}


def register(config: ArchConfig, smoke: ArchConfig):
    _REGISTRY[config.name] = (config, smoke)
    return config


def get(name: str, smoke: bool = False) -> ArchConfig:
    try:
        full, small = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}") \
            from None
    return small if smoke else full


def names():
    return sorted(_REGISTRY)
