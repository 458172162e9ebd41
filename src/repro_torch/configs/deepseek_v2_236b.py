"""DeepSeek-V2-236B [arXiv:2405.04434] — MLA (kv_lora=512),
2 shared + 160 routed experts top-6; first layer dense."""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
    d_ff=1536, vocab_size=102400, mlp_activation="silu",
    use_mla=True, kv_lora_rank=512, q_lora_rank=1536,
    qk_rope_head_dim=64, qk_nope_head_dim=128, v_head_dim=128,
    moe=MoEConfig(num_experts=160, num_shared_experts=2, top_k=6,
                  expert_d_ff=1536))

SMOKE_CONFIG = ArchConfig(
    name="deepseek-v2-236b-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=96, vocab_size=512, mlp_activation="silu",
    use_mla=True, kv_lora_rank=32, q_lora_rank=48,
    qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32,
    moe=MoEConfig(num_experts=8, num_shared_experts=2, top_k=2,
                  expert_d_ff=96))

register(CONFIG, SMOKE_CONFIG)
