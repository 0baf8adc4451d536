"""Shared layers: RMSNorm, gated RMSNorm, rotary embeddings, SwiGLU MLP, embedding and head,
dtype policy.  Plain tensor functions with the JAX package's layouts
(``wi_gate [D,F]``, ``wo [F,D]``, ``embedding [V,D]``, ``head [D,V]``).

Weights arrive already in the compute dtype (cast once at load), where the
JAX functions cast them at each use; the values are the same.  Norm scales
stay float32 because the JAX ``rmsnorm`` upcasts them.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class Policy:
    """Mixed-precision policy: the dtype weights and activations compute
    in.  Weights are drawn and loaded in float32 (the JAX default
    ``param_dtype``) and cast once to it."""

    compute_dtype: torch.dtype = torch.bfloat16


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(dt)


def gated_rmsnorm(scale: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                  eps: float = 1e-5):
    """Mamba2-style norm: RMSNorm(x * silu(z)), ``z`` cast to x's dtype."""
    return rmsnorm(scale, x * F.silu(z.to(x.dtype)), eps)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Split-halves RoPE.  x [..., S, H, hd]; positions [..., S] (int)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., :, None].float() * freqs      # [..., S, hd/2]
    cos = torch.cos(angles)[..., :, None, :]               # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_apply(wi_gate, wi_up, wo, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x @ wi_gate) * (x @ wi_up)) @ wo, outputs in x.dtype."""
    return (F.silu(x @ wi_gate) * (x @ wi_up)) @ wo


def embed_apply(embedding: torch.Tensor, tokens: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
    return embedding[tokens].to(compute_dtype)


def head_apply(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x @ w


def tied_head_apply(embedding: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x @ embedding.t()
