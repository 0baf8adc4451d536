"""Architecture configs of the port.

The port's own copy of ``ModelConfig`` (the field names and defaults of the
JAX package's, so a config reads the same in both) and the registry of the
architectures the port serves.  Each arch module exports ``CONFIG`` (the
published shape) and ``REDUCED`` (same family, tiny, for CPU tests).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """Static architecture description (model shape only, no run knobs)."""

    name: str
    family: str  # the port serves the "dense" family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    notes: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)


ARCH_MODULES: dict[str, str] = {
    "llama3.2-1b": "llama3p2_1b",
    "qwen2-0.5b": "qwen2_0p5b",
}


def _load(name: str):
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _load(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _load(name).REDUCED


def list_archs() -> list[str]:
    return list(ARCH_MODULES)
