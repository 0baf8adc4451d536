"""Decoder-only transformer LM, dense family, with KV-cache prefill/decode.

Parameters follow the JAX package's tree, one module per layer instead of a
leading stacked axis: ``embed.embedding``, ``final_norm.scale``,
``layers.<i>.{ln1,ln2}.scale``, ``layers.<i>.attn.{wq,wk,wv,wo[,bq,bk,bv]}``,
``layers.<i>.mlp.{wi_gate,wi_up,wo}`` (``head.w`` when untied).

Every residual add is fused with the norm that follows it
(``fused_residual_rmsnorm``): ``x + attn_out`` -> ``ln2`` and ``x + mlp_out``
-> the next block's ``ln1``, or ``final_norm`` after the last block.  That
is 2·L launches per forward; only the first block's ``ln1`` is a plain
``rmsnorm``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.kernels.fused_norm.ops import fused_residual_rmsnorm
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class RMSNorm(nn.Module):
    def __init__(self, d, device):
        super().__init__()
        self.scale = _param((d,), torch.float32, device)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        D, H, KV, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim)
        self.wq = _param((D, H, hd), dtype, device)
        self.wk = _param((D, KV, hd), dtype, device)
        self.wv = _param((D, KV, hd), dtype, device)
        self.wo = _param((H, hd, D), dtype, device)
        if cfg.qkv_bias:
            self.bq = _param((H, hd), dtype, device)
            self.bk = _param((KV, hd), dtype, device)
            self.bv = _param((KV, hd), dtype, device)
        else:
            self.bq = self.bk = self.bv = None


class MLP(nn.Module):
    def __init__(self, d_model, d_ff, dtype, device):
        super().__init__()
        self.wi_gate = _param((d_model, d_ff), dtype, device)
        self.wi_up = _param((d_model, d_ff), dtype, device)
        self.wo = _param((d_ff, d_model), dtype, device)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device)
        self.ln2 = RMSNorm(cfg.d_model, device)
        self.attn = Attention(cfg, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device)


class Embed(nn.Module):
    def __init__(self, vocab, d_model, dtype, device):
        super().__init__()
        self.embedding = _param((vocab, d_model), dtype, device)


class Head(nn.Module):
    def __init__(self, d_model, vocab, dtype, device):
        super().__init__()
        self.w = _param((d_model, vocab), dtype, device)


def _fused(x, res, scale, eps):
    """Residual add + RMSNorm over [..., D] through the [R, D] op."""
    D = x.shape[-1]
    y, h = fused_residual_rmsnorm(x.reshape(-1, D), res.reshape(-1, D),
                                  scale, eps=eps)
    return y.view(x.shape), h.view(x.shape)


class TransformerLM(nn.Module):
    """Weights live in the compute dtype, cast once at load (the JAX model
    casts them at each use: same values); norm scales stay float32."""

    def __init__(self, cfg: ModelConfig, policy: L.Policy = L.Policy(),
                 device="cuda"):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"the port serves the dense family, not {cfg.family!r}")
        self.cfg = cfg
        self.policy = policy
        self.device = torch.device(device)
        cd = policy.compute_dtype
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cd, self.device)
        self.final_norm = RMSNorm(cfg.d_model, self.device)
        self.head = (None if cfg.tie_embeddings else
                     Head(cfg.d_model, cfg.vocab_size, cd, self.device))
        self.layers = nn.ModuleList(
            Block(cfg, cd, self.device) for _ in range(cfg.num_layers))

    # ------------------------------------------------------------------ #
    # Init / load
    # ------------------------------------------------------------------ #
    def _init_std(self, name: str) -> Optional[float]:
        """Stddev of the JAX init's normal draw for a parameter, None for
        the ones it sets to a constant (norm scales 1, biases 0)."""
        cfg = self.cfg
        leaf = name.rsplit(".", 2)[-2:]
        if leaf[-1] == "scale" or leaf[-1] in ("bq", "bk", "bv"):
            return None
        if name == "embed.embedding":
            return 1.0
        if leaf == ["attn", "wo"]:
            return (cfg.num_heads * cfg.head_dim) ** -0.5
        if leaf == ["mlp", "wo"]:
            return cfg.d_ff ** -0.5
        return cfg.d_model ** -0.5   # wq, wk, wv, wi_gate, wi_up, head.w

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "TransformerLM":
        """Random weights with the JAX init's distributions (normal draws
        in float32), from ``generator``, which must live on this model's
        device."""
        for name, p in self.named_parameters():
            std = self._init_std(name)
            if std is None:
                p.fill_(1.0 if name.endswith("scale") else 0.0)
                continue
            w = torch.randn(p.shape, generator=generator,
                            dtype=torch.float32, device=self.device) * std
            p.copy_(w)
        return self

    @torch.no_grad()
    def load_params(self, state: dict) -> "TransformerLM":
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

    # ------------------------------------------------------------------ #
    # Forward
    # ------------------------------------------------------------------ #
    def _blocks(self, x, positions, cache=None, pos=None):
        """Runs every block; returns the final-normed hidden state.
        ``cache`` None: full causal self-attention, returns (h, [(k, v)]).
        ``cache`` given: one decode token at ``pos``."""
        cfg, eps = self.cfg, self.cfg.norm_eps
        h = L.rmsnorm(self.layers[0].ln1.scale, x, eps)
        kvs = []
        n = len(self.layers)
        for i, blk in enumerate(self.layers):
            a = blk.attn
            q, k, v = attn_lib.project_qkv(
                a.wq, a.wk, a.wv, h, positions, cfg.rope_theta,
                a.bq, a.bk, a.bv)
            if cache is None:
                o = attn_lib.attention(q, k, v, causal=True)
                kvs.append((k, v))
            else:
                # in place, where the JAX model uses dynamic_update_slice
                # on a donated cache
                cache["k"][i, :, pos] = k[:, 0]
                cache["v"][i, :, pos] = v[:, 0]
                o = attn_lib.decode_attention(q, cache["k"][i],
                                              cache["v"][i], pos)
            h, x = _fused(attn_lib.project_out(a.wo, o), x, blk.ln2.scale, eps)
            m = blk.mlp
            y = L.mlp_apply(m.wi_gate, m.wi_up, m.wo, h)
            nxt = (self.layers[i + 1].ln1 if i + 1 < n
                   else self.final_norm).scale
            h, x = _fused(y, x, nxt, eps)
        return h, kvs

    def _head(self, h):
        if self.cfg.tie_embeddings:
            return L.tied_head_apply(self.embed.embedding, h)
        return L.head_apply(self.head.w, h)

    def _embed(self, tokens):
        return L.embed_apply(self.embed.embedding, tokens,
                             self.policy.compute_dtype)

    @torch.no_grad()
    def apply(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B,S] -> logits [B,S,V]."""
        S = tokens.shape[1]
        positions = torch.arange(S, device=tokens.device)[None, :]
        h, _ = self._blocks(self._embed(tokens), positions)
        return self._head(h)

    # ------------------------------------------------------------------ #
    # KV cache serving
    # ------------------------------------------------------------------ #
    def init_cache(self, batch: int, max_seq: int) -> dict:
        cfg = self.cfg
        shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads,
                 cfg.head_dim)
        kw = dict(dtype=self.policy.compute_dtype, device=self.device)
        return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: dict) -> torch.Tensor:
        """Full-sequence forward that fills ``cache`` in place; returns the
        last position's logits [B,V].  Only that position goes through the
        head, which is all the JAX prefill returns."""
        S = tokens.shape[1]
        positions = torch.arange(S, device=tokens.device)[None, :]
        h, kvs = self._blocks(self._embed(tokens), positions)
        for i, (k, v) in enumerate(kvs):
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
        return self._head(h[:, -1])

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: dict,
                    pos: int) -> torch.Tensor:
        """token [B,1]; ``pos`` = index of the new token.  Writes its K/V
        into ``cache`` in place; returns logits [B,V]."""
        positions = torch.full((token.shape[0], 1), pos, dtype=torch.long,
                               device=token.device)
        h, _ = self._blocks(self._embed(token), positions, cache, pos)
        return self._head(h[:, 0])
