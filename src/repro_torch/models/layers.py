"""Shared layers: RMSNorm, gated RMSNorm, rotary embeddings, SwiGLU MLP, embedding and head,
cross-entropy, dtype policy.  Plain tensor functions with the JAX package's
layouts (``wi_gate [D,F]``, ``wo [F,D]``, ``embedding [V,D]``,
``head [D,V]``).

Callers pass weights already in the compute dtype: the models cast each
stored weight at its use, as the JAX functions do (``Tensor.to`` returns the
weight itself when it is stored in the compute dtype, as for serving).
Norm scales are upcast to float32 at use, as the JAX ``rmsnorm`` does.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class Policy:
    """Mixed-precision policy: the dtype weights are stored in
    (``param_dtype``, the JAX ``RunConfig.policy``'s) and the dtype weights
    and activations compute in.  Training keeps float32 parameters cast at
    each use (or bfloat16 ones, the JAX package's policy for its largest
    models); serving stores them in the compute dtype (``param_dtype``
    None), drawn and loaded in float32 and cast once.

    ``norm_dtype`` is the dtype norm scales are stored in: a training
    policy's ``param_dtype``, as the JAX ``rmsnorm_init(d, dtype)`` stores
    them, and float32 for serving, where the JAX server keeps float32
    parameters."""

    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: Optional[torch.dtype] = None
    norm_dtype: torch.dtype = field(init=False)

    def __post_init__(self):
        object.__setattr__(self, "norm_dtype",
                           self.param_dtype or torch.float32)
        if self.param_dtype is None:
            object.__setattr__(self, "param_dtype", self.compute_dtype)


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


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE. logits [..., V] upcast to fp32; labels int [...].

    The JAX version picks the label's logit by a one-hot contraction (for
    GSPMD); a gather gives the same fp32 value, as one term is nonzero."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - ll)
