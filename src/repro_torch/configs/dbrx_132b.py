"""dbrx-132b — fine-grained MoE, 16 experts top-4.

[hf:databricks/dbrx-base; unverified]  40L d_model=6144 48H (GQA kv=8)
d_ff=10752 vocab=100352.
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    num_experts=16,
    experts_per_token=4,
    rope_theta=500000.0,
)

REDUCED = ModelConfig(
    name="dbrx-reduced",
    capacity_factor=8.0,  # no token drops at smoke-test scale
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    num_experts=4,
    experts_per_token=2,
)
