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
    family: str  # the port serves "dense" (TransformerLM), "ssm" (MambaLM)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    conv_width: int = 4
    ssm_chunk: int = 256
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    notes: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0


ARCH_MODULES: dict[str, str] = {
    "llama3.2-1b": "llama3p2_1b",
    "qwen2-0.5b": "qwen2_0p5b",
    "mamba2-780m": "mamba2_780m",
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
