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

import torch
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models.lm import LM, RMSNorm, fused, param


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        D, H, KV, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim)
        self.wq = param((D, H, hd), dtype, device)
        self.wk = param((D, KV, hd), dtype, device)
        self.wv = param((D, KV, hd), dtype, device)
        self.wo = param((H, hd, D), dtype, device)
        if cfg.qkv_bias:
            self.bq = param((H, hd), dtype, device)
            self.bk = param((KV, hd), dtype, device)
            self.bv = param((KV, hd), dtype, device)
        else:
            self.bq = self.bk = self.bv = None


class MLP(nn.Module):
    def __init__(self, d_model, d_ff, dtype, device):
        super().__init__()
        self.wi_gate = param((d_model, d_ff), dtype, device)
        self.wi_up = param((d_model, d_ff), dtype, device)
        self.wo = param((d_ff, d_model), dtype, device)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device)
        self.ln2 = RMSNorm(cfg.d_model, device)
        self.attn = Attention(cfg, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device)


def block_apply(blk: Block, h, x, positions, cfg: ModelConfig, w, nxt,
                i: int, cache=None, pos=None, kvs=None):
    """One block on its normed input ``h`` and residual stream ``x``;
    returns the next (normed input, residual) pair, normed by ``nxt`` (the
    scale of the norm that follows).  ``w`` casts a stored weight to the
    compute dtype.  ``cache`` given: one decode token at ``pos``, its K/V
    written into slot ``i`` of the cache in place (where the JAX model uses
    dynamic_update_slice on a donated cache); else full causal
    self-attention, its (k, v) appended to ``kvs`` when given."""
    eps = cfg.norm_eps
    a = blk.attn
    bias = (None,) * 3 if a.bq is None else (w(a.bq), w(a.bk), w(a.bv))
    q, k, v = attn_lib.project_qkv(w(a.wq), w(a.wk), w(a.wv), h, positions,
                                   cfg.rope_theta, *bias)
    if cache is None:
        o = attn_lib.attention(q, k, v, causal=True)
        if kvs is not None:
            kvs.append((k, v))
    else:
        cache["k"][i, :, pos] = k[:, 0]
        cache["v"][i, :, pos] = v[:, 0]
        o = attn_lib.decode_attention(q, cache["k"][i], cache["v"][i], pos)
    h, x = fused(attn_lib.project_out(w(a.wo), o), x, blk.ln2.scale, eps)
    m = blk.mlp
    y = L.mlp_apply(w(m.wi_gate), w(m.wi_up), w(m.wo), h)
    return fused(y, x, nxt, eps)


def init_std(cfg: ModelConfig, name: str) -> Optional[float]:
    """The JAX init's normal stddev of the embedding, the head or a
    block's parameter; None for norm scales and biases."""
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


class TransformerLM(LM):
    """Weights live in ``policy.param_dtype`` and are cast to the compute
    dtype at each use, as in the JAX model (serving stores them in the
    compute dtype, so the cast is the weight itself); norm scales stay
    float32.  ``loss`` trains: its forward and backward go through the
    flash-attention and fused-norm kernels on CUDA tensors."""

    def __init__(self, cfg: ModelConfig, policy: L.Policy = L.Policy(),
                 device="cuda"):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"TransformerLM serves the dense family, not {cfg.family!r}")
        super().__init__(cfg, policy, device)
        self.layers = nn.ModuleList(
            Block(cfg, policy.param_dtype, self.device)
            for _ in range(cfg.num_layers))

    def _init_std(self, name: str) -> Optional[float]:
        return init_std(self.cfg, name)

    # ------------------------------------------------------------------ #
    # Forward
    # ------------------------------------------------------------------ #
    def _blocks(self, x, positions, cache=None, pos=None):
        """Runs every block; returns the final-normed hidden state.
        ``cache`` None: full causal self-attention, returns (h, [(k, v)]).
        ``cache`` given: one decode token at ``pos``."""
        cfg = self.cfg
        h = L.rmsnorm(self.layers[0].ln1.scale, x, cfg.norm_eps)
        kvs = []
        n = len(self.layers)
        for i, blk in enumerate(self.layers):
            nxt = (self.layers[i + 1].ln1 if i + 1 < n
                   else self.final_norm).scale
            h, x = block_apply(blk, h, x, positions, cfg, self.cast, nxt, i,
                               cache, pos, kvs)
        return h, kvs

    def logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B,S] -> logits [B,S,V], recording autograd's graph
        where grad mode is on (training)."""
        S = tokens.shape[1]
        positions = torch.arange(S, device=tokens.device)[None, :]
        h, _ = self._blocks(self._embed(tokens), positions)
        return self._head(h)

    @torch.no_grad()
    def apply(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B,S] -> logits [B,S,V]."""
        return self.logits(tokens)

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Mean next-token cross-entropy of ``tokens`` against ``labels``
        (the JAX ``loss`` of a dense model without MoE)."""
        return L.cross_entropy(self.logits(tokens), labels)

    # ------------------------------------------------------------------ #
    # KV cache serving
    # ------------------------------------------------------------------ #
    def max_tokens(self, max_seq: int) -> Optional[int]:
        return max_seq                  # the KV cache's positions

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
