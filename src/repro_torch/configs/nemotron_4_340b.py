"""Nemotron-4-340B [arXiv:2402.16819] — dense GQA, squared-ReLU MLP."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8,
    d_ff=73728, vocab_size=256000, mlp_activation="relu2",
    rope_theta=10000.0)

SMOKE_CONFIG = ArchConfig(
    name="nemotron-4-340b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=512, mlp_activation="relu2")

register(CONFIG, SMOKE_CONFIG)
