"""llama-20b-paper — the paper's own workhorse model (Fig 11, Case-1).

Not in the assigned pool; used by the reproduction benchmarks so that the
issue-latency-distribution and kernel-issue-stall experiments run on the
same model family/scale the paper used (Llama-20B on 256 H800s).
Shape chosen as a standard ~20B llama: 62L d_model=5120 40H kv=8 d_ff=13824.
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="llama-20b-paper",
    family="dense",
    num_layers=62,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=32000,
    rope_theta=10000.0,
)

REDUCED = ModelConfig(
    name="llama-20b-reduced",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=192,
    vocab_size=256,
)
