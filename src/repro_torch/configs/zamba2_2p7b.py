"""zamba2-2.7b — Mamba2 backbone + weight-shared attention blocks.

[arXiv:2411.15242; hf]  54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64.  One shared (weight-tied) full-attention transformer block is
applied after every 6 Mamba2 layers.  Attention head_dim 80 (2560 / 32),
d_inner 5120 = 80 SSM heads of head_dim 64, chunk 256; the head is untied,
as in the JAX package's config.
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,
    rope_theta=10000.0,
    notes="hybrid: Mamba2 + shared attn; long_500k RUNS (sub-quadratic)",
)

REDUCED = ModelConfig(
    name="zamba2-reduced",
    family="hybrid",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=16,
    attn_every=2,
    rope_theta=10000.0,
)
