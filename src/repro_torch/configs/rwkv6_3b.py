"""RWKV-6 "Finch" 3B [arXiv:2404.05892] — attention-free, data-dependent
decay, O(1)-state decode (runs the long_500k cell)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm",
    num_layers=32, d_model=2560, num_heads=40, num_kv_heads=40,
    d_ff=8960, vocab_size=65536)

SMOKE_CONFIG = ArchConfig(
    name="rwkv6-3b-smoke", family="ssm",
    num_layers=2, d_model=128, num_heads=2, num_kv_heads=2,
    d_ff=448, vocab_size=512)

register(CONFIG, SMOKE_CONFIG)
