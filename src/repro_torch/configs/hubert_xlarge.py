"""HuBERT-XLarge [arXiv:2106.07447] — encoder-only audio transformer.

The audio frontend (CNN feature extractor) is a STUB per the assignment:
input_specs() provides precomputed frame embeddings.  Encoder-only: no
decode shapes (noted in DESIGN.md)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="hubert-xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=504, mlp_activation="gelu",
    causal=False, has_decoder=False,
    embedding_frontend="stub_embeddings")

SMOKE_CONFIG = ArchConfig(
    name="hubert-xlarge-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=128, mlp_activation="gelu",
    causal=False, has_decoder=False,
    embedding_frontend="stub_embeddings")

register(CONFIG, SMOKE_CONFIG)
