"""Zamba2-7B [arXiv:2411.15242] — Mamba2 trunk + weight-shared attention
blocks (hybrid; runs the long_500k cell)."""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000, mlp_activation="silu",
    ssm=SSMConfig(state_size=64, conv_width=4, expand=2, head_dim=64))

SMOKE_CONFIG = ArchConfig(
    name="zamba2-7b-smoke", family="hybrid",
    num_layers=3, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=512, mlp_activation="silu",
    ssm=SSMConfig(state_size=16, conv_width=4, expand=2, head_dim=32))

register(CONFIG, SMOKE_CONFIG)
