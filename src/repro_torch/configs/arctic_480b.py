"""arctic-480b — 128-expert top-2 MoE with a dense residual path.

[hf:Snowflake/snowflake-arctic-base; hf]  35L d_model=7168 56H (GQA kv=8)
d_ff=4864 vocab=32000.
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    num_experts=128,
    experts_per_token=2,
    moe_dense_residual=True,
    rope_theta=10000.0,
)

REDUCED = ModelConfig(
    name="arctic-reduced",
    capacity_factor=8.0,  # no token drops at smoke-test scale
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=96,
    vocab_size=256,
    num_experts=8,
    experts_per_token=2,
    moe_dense_residual=True,
)
