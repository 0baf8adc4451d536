"""Model registry: ModelConfig -> the port's model for its family."""
from __future__ import annotations

from repro_torch.configs import ModelConfig
from repro_torch.models.layers import Policy
from repro_torch.models.ssm_lm import MambaLM
from repro_torch.models.transformer import TransformerLM


def build_model(cfg: ModelConfig, policy: Policy = Policy(), device="cuda"):
    """``TransformerLM`` for the dense family, ``MambaLM`` for ssm; the
    port has no other family yet."""
    if cfg.family == "dense":
        return TransformerLM(cfg, policy, device)
    if cfg.family == "ssm":
        return MambaLM(cfg, policy, device)
    raise NotImplementedError(
        f"the port has no model for the {cfg.family!r} family ({cfg.name})")
