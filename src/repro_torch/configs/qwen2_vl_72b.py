"""Qwen2-VL-72B [arXiv:2409.12191] — VLM backbone with M-RoPE.

The vision frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings; the backbone transformer is fully implemented
with multimodal rotary position embeddings (t/h/w sections)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=29568, vocab_size=152064, mlp_activation="silu", qkv_bias=True,
    mrope=True, rope_theta=1000000.0,
    embedding_frontend="stub_embeddings")

SMOKE_CONFIG = ArchConfig(
    name="qwen2-vl-72b-smoke", family="vlm",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=512, mlp_activation="silu", qkv_bias=True,
    mrope=True, embedding_frontend="stub_embeddings")

register(CONFIG, SMOKE_CONFIG)
