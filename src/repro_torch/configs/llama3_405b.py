"""llama3-405b — dense GQA transformer, 128k vocab.

[arXiv:2407.21783; unverified]  126L d_model=16384 128H (GQA kv=8)
d_ff=53248 vocab=128256.
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=500000.0,
    notes="long_500k SKIPPED: pure full attention (see DESIGN.md)",
)

REDUCED = ModelConfig(
    name="llama3-405b-reduced",
    family="dense",
    num_layers=3,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    d_ff=192,
    vocab_size=256,
    rope_theta=500000.0,
)
