"""Llama-3-405B [arXiv:2407.21783] — dense GQA, 128k vocab, SwiGLU."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="llama3-405b", family="dense",
    num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
    d_ff=53248, vocab_size=128256, mlp_activation="silu",
    rope_theta=500000.0)

SMOKE_CONFIG = ArchConfig(
    name="llama3-405b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
    d_ff=192, vocab_size=512, mlp_activation="silu",
    rope_theta=500000.0)

register(CONFIG, SMOKE_CONFIG)
