"""Qwen2.5-32B [hf:Qwen] — dense GQA with QKV bias."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="qwen2.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=27648, vocab_size=152064, mlp_activation="silu", qkv_bias=True,
    rope_theta=1000000.0)

SMOKE_CONFIG = ArchConfig(
    name="qwen2.5-32b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=192, vocab_size=512, mlp_activation="silu", qkv_bias=True)

register(CONFIG, SMOKE_CONFIG)
