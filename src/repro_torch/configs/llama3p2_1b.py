"""llama3.2-1b — small dense llama3.

[hf:meta-llama/Llama-3.2-1B]  16L d_model=2048 32H (GQA kv=8)
d_ff=8192 vocab=128256, tied embeddings, rope_theta 5e5.
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500000.0,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="llama3.2-1b-reduced",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    d_ff=256,
    vocab_size=256,
    tie_embeddings=True,
)
