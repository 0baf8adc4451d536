"""musicgen-large — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf]  48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048.
Backbone only: the EnCodec frontend is a stub, so the model takes token ids
as the dense family does (``models/registry.py::modality_inputs`` gives it
no other input).
"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    rope_theta=10000.0,
    notes="audio frontend stubbed",
)

REDUCED = ModelConfig(
    name="musicgen-reduced",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=128,
)
