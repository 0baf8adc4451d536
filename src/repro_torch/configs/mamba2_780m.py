"""mamba2-780m — pure SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified]  48L d_model=1536 vocab=50280 ssm_state=128,
d_inner 3072 = 48 SSM heads of head_dim 64, conv width 4, chunk 256.  The
head is untied, as in the JAX package's config.
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
)

REDUCED = ModelConfig(
    name="mamba2-reduced",
    family="ssm",
    num_layers=3,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=256,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=16,
)
