"""Qwen1.5-4B [hf:Qwen] — dense MHA (kv == q heads) with QKV bias."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="qwen1.5-4b", family="dense",
    num_layers=40, d_model=2560, num_heads=20, num_kv_heads=20,
    d_ff=6912, vocab_size=151936, mlp_activation="silu", qkv_bias=True)

SMOKE_CONFIG = ArchConfig(
    name="qwen1.5-4b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=192, vocab_size=512, mlp_activation="silu", qkv_bias=True)

register(CONFIG, SMOKE_CONFIG)
