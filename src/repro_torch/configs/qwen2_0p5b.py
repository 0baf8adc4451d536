"""qwen2-0.5b — GQA with QKV bias.

[arXiv:2407.10671; hf]  24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936.
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="qwen2-0.5b-reduced",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    qkv_bias=True,
    tie_embeddings=True,
)
