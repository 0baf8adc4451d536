"""What the port's language models share: parameter holders, the
embedding and head, the fused residual add + norm, random init with the
JAX init's distributions, and loading a state dict."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.kernels.fused_norm.ops import fused_residual_rmsnorm
from repro_torch.models import layers as L


INIT_DRAW = 1 << 28     # most elements ``LM.init`` draws in one float32 call
REMAT = ("none", "dots", "full")
# what remat "dots" keeps: the outputs of matrix products without batch
# dims, as JAX's ``checkpoint_dots_with_no_batch_dims``; every other op
# (the batched expert products, flash attention, the fused norm, whose
# kernels write into buffers from ``torch.empty``) runs again
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(_save_dots)


def remat(mode: str, fn, *args):
    """``fn(*args)``, its activations recomputed in the backward (the JAX
    ``_maybe_remat``'s ``jax.checkpoint``) while autograd records:
    ``"full"`` keeps only ``args``, ``"dots"`` also the outputs of
    ``aten.mm`` / ``aten.addmm`` (selective checkpointing), ``"none"``
    keeps everything (``LM`` checks the mode).  ``fn`` must mutate nothing
    outside it: the backward runs it again (up to its last saved
    tensor)."""
    if mode == "none" or not torch.is_grad_enabled():
        return fn(*args)
    from torch.utils.checkpoint import checkpoint
    kw = {"context_fn": _dots_context} if mode == "dots" else {}
    return checkpoint(fn, *args, use_reentrant=False, **kw)


def param(shape, dtype, device) -> nn.Parameter:
    """A trainable parameter; serving runs under ``torch.no_grad``."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class RMSNorm(nn.Module):
    """A norm's scale, stored in ``dtype`` (``Policy.norm_dtype``)."""

    def __init__(self, d, device, dtype=torch.float32):
        super().__init__()
        self.scale = param((d,), dtype, device)


class Embed(nn.Module):
    def __init__(self, vocab, d_model, dtype, device):
        super().__init__()
        self.embedding = param((vocab, d_model), dtype, device)


class Head(nn.Module):
    def __init__(self, d_model, vocab, dtype, device):
        super().__init__()
        self.w = param((d_model, vocab), dtype, device)


def fused(x, res, scale, eps):
    """Residual add + RMSNorm over [..., D] through the [R, D] op."""
    D = x.shape[-1]
    y, h = fused_residual_rmsnorm(x.reshape(-1, D), res.reshape(-1, D),
                                  scale, eps=eps)
    return y.view(x.shape), h.view(x.shape)


class LM(nn.Module):
    """Base of the port's models: ``embed``, ``final_norm``, ``head``
    (None when tied), init and load.  A subclass gives each parameter's
    init by ``_init_std`` (normal stddev) or ``_init_const``.  Weights are
    stored in ``policy.param_dtype`` and cast to the compute dtype at use
    (``cast``).  ``remat`` (``REMAT``) is what a training forward keeps for
    the backward of each layer (``remat``; the JAX model's ``remat``)."""

    def __init__(self, cfg: ModelConfig, policy: L.Policy, device,
                 remat: str = "none"):
        if remat not in REMAT:
            raise ValueError(f"remat is one of {REMAT}, not {remat!r}")
        super().__init__()
        self.cfg = cfg
        self.policy = policy
        self.remat = remat
        self.device = torch.device(device)
        pd = policy.param_dtype
        self.embed = Embed(cfg.vocab_size, cfg.d_model, pd, self.device)
        self.final_norm = RMSNorm(cfg.d_model, self.device,
                                  policy.norm_dtype)
        self.head = (None if cfg.tie_embeddings else
                     Head(cfg.d_model, cfg.vocab_size, pd, self.device))

    def cast(self, w: torch.Tensor) -> torch.Tensor:
        """A stored weight in the compute dtype: the weight itself when it
        is stored so (serving), else a cast that autograd sees through."""
        return w.to(self.policy.compute_dtype)

    def _init_std(self, name: str) -> Optional[float]:
        """Stddev of the JAX init's normal draw for a parameter, None for
        the ones it sets to a constant."""
        raise NotImplementedError

    def max_tokens(self, max_seq: int) -> Optional[int]:
        """Most tokens (prompt and new) that a cache from
        ``init_cache(batch, max_seq)`` holds; None if it has no length."""
        raise NotImplementedError

    def _init_const(self, name: str, p: torch.Tensor):
        """The constant (scalar or tensor) of a parameter the JAX init does
        not draw: norm scales 1, biases 0."""
        return 1.0 if name.endswith("scale") else 0.0

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        """Random weights with the JAX init's distributions (normal draws
        in float32, cast into the parameter), from ``generator``, which
        must live on this model's device.  A tensor of more than
        ``INIT_DRAW`` elements is drawn in slices along its leading axis
        (the MoE experts' [E, D, F] weights), so the float32 draw never
        holds more than that at once."""
        for name, p in self.named_parameters():
            std = self._init_std(name)
            if std is None:
                v = self._init_const(name, p)
                if isinstance(v, torch.Tensor):
                    p.copy_(v)
                else:
                    p.fill_(v)
                continue
            parts = (p.split(max(1, INIT_DRAW // (p.numel() // len(p))))
                     if p.numel() > INIT_DRAW else (p,))
            for part in parts:
                w = torch.randn(part.shape, generator=generator,
                                dtype=torch.float32, device=self.device)
                part.copy_(w.mul_(std))
        return self

    @torch.no_grad()
    def load_params(self, state: dict):
        """Copy a state dict (tensors or numpy arrays, any float dtype)
        into the parameters, casting each once to its stored dtype."""
        own = dict(self.named_parameters())
        if set(state) != set(own):
            raise KeyError(f"parameter names differ: missing "
                           f"{sorted(set(own) - set(state))}, unexpected "
                           f"{sorted(set(state) - set(own))}")
        for name, p in own.items():
            v = state[name]
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.array(v))   # a writable copy
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(v.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(v)
        return self

    def _head(self, h):
        if self.cfg.tie_embeddings:
            return L.tied_head_apply(self.cast(self.embed.embedding), h)
        return L.head_apply(self.cast(self.head.w), h)

    def _embed(self, tokens):
        return L.embed_apply(self.embed.embedding, tokens,
                             self.policy.compute_dtype)
