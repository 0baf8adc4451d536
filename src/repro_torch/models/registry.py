"""Model registry: ModelConfig -> the port's model for its family, and the
shapes of the stubbed modality inputs."""
from __future__ import annotations

from typing import Optional

from repro_torch.configs import ModelConfig
from repro_torch.kernels.flash_attention.ops import HEAD_DIMS
from repro_torch.kernels.ssd_scan.ops import HEAD_DIMS as HEAD_DIMS_SSD
from repro_torch.kernels.ssd_scan.ops import STATE_DIMS, kernel_takes
from repro_torch.models.layers import Policy
from repro_torch.models.ssm_lm import MambaLM
from repro_torch.models.transformer import AttnImpl, FAMILIES, TransformerLM
from repro_torch.models.zamba2 import Zamba2LM


def build_model(cfg: ModelConfig, policy: Policy = Policy(), device="cuda",
                remat: str = "none", mesh=None, attn_impl: str = "auto",
                fold_depth: int = 4, q_chunk: int = 1024,
                kv_chunk: int = 512):
    """``TransformerLM`` for the dense, moe, audio and vlm families,
    ``MambaLM`` for ssm, ``Zamba2LM`` for hybrid: every family of the JAX
    package's zoo.  ``remat`` ("none", "dots", "full") is what a training
    forward keeps for the backward, as the JAX ``build_model``'s; ``mesh``
    shards the moe family's experts over its model axis and, under
    ``attn_impl="cp"``, the attention's query rows, as the JAX
    ``build_model``'s (zamba2 takes no mesh).  ``attn_impl``
    (``attention.IMPLS``), ``fold_depth``, ``q_chunk`` and ``kv_chunk``
    choose the full-sequence self-attention path; the ssm family has
    none."""
    attn = AttnImpl(attn_impl, fold_depth, q_chunk, kv_chunk)
    if cfg.family in FAMILIES:
        return TransformerLM(cfg, policy, device, remat, mesh, attn)
    if cfg.family == "ssm":
        return MambaLM(cfg, policy, device, remat)
    if cfg.family == "hybrid":
        return Zamba2LM(cfg, policy, device, remat, attn)
    raise NotImplementedError(
        f"the port has no model for the {cfg.family!r} family ({cfg.name})")


def kernel_refusal(cfg: ModelConfig) -> Optional[str]:
    """Why the card's kernels cannot run ``cfg``'s model, or None: the
    SSD-scan kernels for the ssm and hybrid families, flash attention for
    the transformer and hybrid ones.  None for every config of the zoo,
    published and reduced; a config scaled to a width no kernel takes is
    refused here, before anything is built."""
    if cfg.family in ("ssm", "hybrid") and not kernel_takes(
            cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk):
        return (f"the SSD-scan kernels take head_dim {HEAD_DIMS_SSD} and "
                f"state {STATE_DIMS}, not head_dim {cfg.ssm_head_dim}, "
                f"state {cfg.ssm_state}, chunk {cfg.ssm_chunk}")
    if cfg.family in (*FAMILIES, "hybrid") and cfg.head_dim not in HEAD_DIMS:
        return (f"the flash-attention kernels take head_dim {HEAD_DIMS}, "
                f"not {cfg.head_dim}")
    return None


def modality_inputs(cfg: ModelConfig, batch: int) -> dict:
    """Shapes of the stubbed modality-frontend inputs: the vlm family's
    precomputed patch embeddings; none for the others (the audio family
    takes EnCodec token ids)."""
    if cfg.family == "vlm":
        return {"vision_embeds": (batch, cfg.vision_tokens, cfg.vision_d)}
    return {}
