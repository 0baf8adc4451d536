"""Architecture configs of the port.

The port's own copy of ``ModelConfig`` (the field names and defaults of the
JAX package's, so a config reads the same in both) and the registry of the
architectures the port serves.  Each arch module exports ``CONFIG`` (the
published shape) and ``REDUCED`` (same family, tiny, for CPU tests).
``scale(cfg, **overrides)`` cuts a config (the VLM's one-group training
cut: ``num_layers=5``; the MoE training cuts: ``num_layers=1`` and, for
arctic, ``num_experts=32``).  ``SHAPES`` are the JAX package's four input
shapes and ``cells()`` its (arch, shape) cells, which the dry-run walks.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class ModelConfig:
    """Static architecture description (model shape only, no run knobs)."""

    name: str
    family: str  # the port builds "dense", "moe", "audio" and "vlm"
    #              (TransformerLM), "ssm" (MambaLM), "hybrid" (Zamba2LM)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_dense_residual: bool = False  # arctic: dense FF in parallel with MoE
    capacity_factor: float = 1.25
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    conv_width: int = 4
    ssm_chunk: int = 256
    # --- hybrid (zamba2): one weight-shared attention block every k SSM layers
    attn_every: int = 0
    # --- VLM: a cross-attention layer after every k self-attention layers ---
    cross_attn_every: int = 0
    vision_tokens: int = 0
    vision_d: int = 0
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    notes: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports 500k-token decode (SSM/hybrid)."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def n_cross(self) -> int:
        """The vlm family's cross-attention layers, one a group."""
        c = self.cross_attn_every
        return self.num_layers // (c + 1) if c else 0

    @property
    def n_self(self) -> int:
        """Self-attention layers: ``cross_attn_every`` a group in the vlm
        family, which builds only whole groups."""
        return self.num_layers - self.n_cross

    # ------------------------------------------------------------------ #
    # The JAX package's analytic counts, for the families the port builds
    # (used for the 6*N*D flops of a training step).
    def param_count(self) -> int:
        """Analytic parameter count."""
        d, v, L = self.d_model, self.vocab_size, self.num_layers
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d  # lm head
        n += d  # final norm
        hd = self.head_dim
        attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) \
            + (self.num_heads * hd) * d if self.num_heads else 0
        if self.qkv_bias and self.num_heads:
            attn += (self.num_heads + 2 * self.num_kv_heads) * hd
        ff_dense = 3 * d * self.d_ff  # SwiGLU: gate, up, down
        per_layer_norms = 2 * d
        if self.family in ("dense", "audio"):
            n += L * (attn + ff_dense + per_layer_norms)
        elif self.family == "moe":
            moe = self.num_experts * 3 * d * self.d_ff + d * self.num_experts
            dense_res = ff_dense if self.moe_dense_residual else 0
            n += L * (attn + moe + dense_res + per_layer_norms)
        elif self.family == "ssm":
            n += L * (self._mamba_block_params() + d)
        elif self.family == "hybrid":
            # L mamba layers + ONE shared attention block (+ its ff)
            n += L * (self._mamba_block_params() + d)
            n += attn + ff_dense + per_layer_norms
        elif self.family == "vlm":
            # the reference's formula: a cross layer counts its scalar gate
            # as d and leaves out kv_proj and gate_mlp (the built model
            # holds vision_d * d + 2 - d more a cross layer)
            cross = attn + d
            n += self.n_self * (attn + ff_dense + per_layer_norms)
            n += self.n_cross * (cross + ff_dense + per_layer_norms)
        else:
            raise NotImplementedError(
                f"the port counts no {self.family!r} parameters")
        return n

    def _mamba_block_params(self) -> int:
        d, di = self.d_model, self.d_inner
        h = self.ssm_heads
        n = d * (2 * di + 2 * self.ssm_state + h) + di  # in_proj(z,x,B,C,dt)
        n += self.conv_width * (di + 2 * self.ssm_state)  # conv over x,B,C
        n += h + h  # A_log, D
        n += di * d  # out_proj
        n += di  # gate norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token, for 6*N_active*D: the moe family's
        routed experts only (``experts_per_token`` of ``num_experts``),
        every parameter of the others (the hybrid's shared block counts
        once, however often it runs)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.num_layers
        all_experts = L * self.num_experts * 3 * d * self.d_ff
        active = L * self.experts_per_token * 3 * d * self.d_ff
        return self.param_count() - all_experts + active


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        # decode processes ONE new token per sequence in the batch
        n = 1 if self.kind == "decode" else self.seq_len
        return n * self.global_batch


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# the JAX package's assigned archs, in its order (every arch but the
# paper's own llama-20b-paper)
ASSIGNED_ARCHS = ["zamba2-2.7b", "dbrx-132b", "arctic-480b", "llama3-405b",
                  "llama3.2-1b", "qwen2-0.5b", "qwen2-72b", "musicgen-large",
                  "mamba2-780m", "llama-3.2-vision-11b"]

ARCH_MODULES: dict[str, str] = {
    "llama3.2-1b": "llama3p2_1b",
    "qwen2-0.5b": "qwen2_0p5b",
    "mamba2-780m": "mamba2_780m",
    "zamba2-2.7b": "zamba2_2p7b",
    "musicgen-large": "musicgen_large",
    "llama-3.2-vision-11b": "llama3p2_vision_11b",
    "dbrx-132b": "dbrx_132b",
    "arctic-480b": "arctic_480b",
    "llama-20b-paper": "llama_20b_paper",
    "qwen2-72b": "qwen2_72b",
    "llama3-405b": "llama3_405b",
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


def cells(include_skipped: bool = False):
    """Yield every assigned (arch, shape, skipped) cell; long_500k is
    skipped for the archs that are not sub-quadratic."""
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            skipped = shape.name == "long_500k" and not cfg.sub_quadratic
            if skipped and not include_skipped:
                continue
            yield arch, shape.name, skipped


def scale(cfg: ModelConfig, **overrides: Any) -> ModelConfig:
    return dataclasses.replace(cfg, **overrides)
