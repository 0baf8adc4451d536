"""qwen2-72b — GQA with QKV bias.

[arXiv:2407.10671; hf]  80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064.
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    notes="long_500k SKIPPED: pure full attention (see DESIGN.md)",
)

REDUCED = ModelConfig(
    name="qwen2-72b-reduced",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    d_ff=192,
    vocab_size=256,
    qkv_bias=True,
)
