"""llama-3.2-vision-11b — decoder with gated cross-attention image layers.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified]  40L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=128256.  A cross-attention layer follows every
4 self-attention layers (8 of 40 layers are cross-attn).  The vision
frontend is a stub: the model takes precomputed patch embeddings of shape
(batch, vision_tokens, vision_d).
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    cross_attn_every=4,
    vision_tokens=1600,
    vision_d=4096,
    rope_theta=500000.0,
    notes="vision frontend stubbed",
)

REDUCED = ModelConfig(
    name="llama-vision-reduced",
    family="vlm",
    num_layers=5,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    cross_attn_every=4,
    vision_tokens=16,
    vision_d=64,
)
