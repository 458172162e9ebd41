"""Granite-MoE-3B-A800M [hf:ibm-granite] — 40 experts, top-8, d_ff=512/expert."""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    d_ff=512, vocab_size=49155, mlp_activation="silu",
    moe=MoEConfig(num_experts=40, top_k=8, expert_d_ff=512))

SMOKE_CONFIG = ArchConfig(
    name="granite-moe-3b-a800m-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=64, vocab_size=512, mlp_activation="silu",
    moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=64))

register(CONFIG, SMOKE_CONFIG)
