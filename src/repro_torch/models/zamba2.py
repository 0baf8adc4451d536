"""Zamba2-style hybrid LM: a Mamba2 backbone and ONE weight-shared
attention + MLP block applied after every ``attn_every`` Mamba layers, the
port of the JAX package's ``models/zamba2.py``.

As in the JAX model, the shared block's input is the hidden state itself
(not the released Zamba2's concatenation with the embedding, nor its
per-application LoRA), and each of its ``num_layers // attn_every``
applications keeps its own KV cache.

Parameters follow the JAX package's tree, with the two stacked axes of
``layers`` ([groups, attn_every, ...]) flattened into one module per layer:
``embed.embedding``, ``final_norm.scale``, ``head.w`` (untied),
``layers.<g * attn_every + j>.{ln.scale, mamba.*}`` and
``shared_attn.{ln1,ln2}.scale``, ``shared_attn.attn.{wq,wk,wv,wo}``,
``shared_attn.mlp.{wi_gate,wi_up,wo}``.

Every residual add is fused with the norm that follows it
(``fused_residual_rmsnorm``): after a Mamba layer, the next layer's ``ln``
or, after a group's last layer, ``shared_attn.ln1``; after attention,
``ln2``; after the MLP, the next group's first ``ln`` or ``final_norm``.
That is L + 2·groups launches per forward (72 for zamba2-2.7b); only the
first layer's ``ln`` is a plain ``rmsnorm``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm_lm, transformer
from repro_torch.models.lm import LM, fused, remat


class Zamba2LM(LM):
    """Weights live in ``policy.param_dtype`` and are cast to the compute
    dtype at use (serving stores them in the compute dtype); ``A_log`` and
    ``dt_bias`` stay float32, the norm scales are stored in
    ``policy.norm_dtype``.  ``loss`` trains: its
    forward and backward go through the SSD-scan, flash-attention and
    fused-norm kernels on CUDA tensors; the shared block's gradient is the
    sum over its applications, as autograd accumulates it.  ``attn`` is
    the shared block's full-sequence attention (``transformer.AttnImpl``;
    no mesh, so ``"cp"`` is chunked, as in the JAX model)."""

    def __init__(self, cfg: ModelConfig, policy: L.Policy = L.Policy(),
                 device="cuda", remat: str = "none",
                 attn: transformer.AttnImpl = transformer.AttnImpl()):
        if cfg.family != "hybrid":
            raise NotImplementedError(
                f"Zamba2LM serves the hybrid family, not {cfg.family!r}")
        super().__init__(cfg, policy, device, remat)
        self.attn = attn
        pd = policy.param_dtype
        self.layers = torch.nn.ModuleList(
            ssm_lm.MambaLayer(cfg, pd, self.device, policy.norm_dtype)
            for _ in range(self.n_groups * cfg.attn_every))
        self.shared_attn = transformer.Block(cfg, pd, self.device,
                                             policy.norm_dtype)

    @property
    def n_groups(self) -> int:
        return self.cfg.num_layers // self.cfg.attn_every

    def _init_std(self, name: str) -> Optional[float]:
        init = (transformer.init_std if name.startswith("shared_attn.")
                else ssm_lm.init_std)
        return init(self.cfg, name)

    def _init_const(self, name: str, p: torch.Tensor):
        return ssm_lm.init_const(self.cfg, name, self.device)

    # ------------------------------------------------------------------ #
    # Forward
    # ------------------------------------------------------------------ #
    def _groups(self, x, positions, cache=None, pos=None, collect=False):
        """Runs every group; returns the final-normed hidden state, and with
        ``collect`` each Mamba layer's prefill cache and each application's
        (k, v).  ``cache`` given: one decode token at ``pos``, the cache
        updated in place.  Under remat each group, its Mamba layers and the
        shared block, is one recomputed unit from (h, x) to the next (h,
        x), as the JAX model remats the group (serving, which collects or
        updates a cache, runs no remat)."""
        cfg, per = self.cfg, self.cfg.attn_every
        sp = self.shared_attn
        h = L.rmsnorm(self.layers[0].ln.scale, x, cfg.norm_eps)
        caches = [] if collect else None
        kvs = [] if collect else None

        def group(h, x, g):
            for j in range(per):
                i = g * per + j
                out = ssm_lm.layer_apply(self.layers[i], h, cfg, i, cache,
                                         caches)
                nxt = self.layers[i + 1].ln if j + 1 < per else sp.ln1
                h, x = fused(out, x, nxt.scale, cfg.norm_eps)
            nxt = (self.layers[(g + 1) * per].ln if g + 1 < self.n_groups
                   else self.final_norm)
            return transformer.block_apply(sp, h, x, positions, cfg,
                                           self.cast, nxt.scale, g, cache,
                                           pos, kvs, attn=self.attn)

        for g in range(self.n_groups):
            h, x = remat(self.remat, group, h, x, g)
        return h, caches, kvs

    def logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B,S] -> logits [B,S,V], recording autograd's graph
        where grad mode is on (training)."""
        S = tokens.shape[1]
        positions = torch.arange(S, device=tokens.device)[None, :]
        h, _, _ = self._groups(self._embed(tokens), positions)
        return self._head(h)

    @torch.no_grad()
    def apply(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B,S] -> logits [B,S,V]."""
        return self.logits(tokens)

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Mean next-token cross-entropy of ``tokens`` against ``labels``
        (the JAX ``Zamba2LM.loss``)."""
        return L.cross_entropy(self.logits(tokens), labels)

    # ------------------------------------------------------------------ #
    # Serving: the Mamba layers' recurrent state and one KV cache per
    # application of the shared block
    # ------------------------------------------------------------------ #
    def max_tokens(self, max_seq: int) -> Optional[int]:
        return max_seq                  # the KV caches' positions

    def init_cache(self, batch: int, max_seq: int) -> dict:
        """``state`` [L,B,H,P,N] fp32 and ``conv`` [L,B,W-1,di+2N] per
        Mamba layer; ``k`` and ``v`` [groups,B,max_seq,KV,hd] per
        application of the shared block."""
        cfg = self.cfg
        cd = self.policy.compute_dtype
        cache = ssm_lm.init_cache(cfg, len(self.layers), batch, cd,
                                  self.device)
        shape = (self.n_groups, batch, max_seq, cfg.num_kv_heads,
                 cfg.head_dim)
        cache["k"] = torch.zeros(shape, dtype=cd, device=self.device)
        cache["v"] = torch.zeros(shape, dtype=cd, device=self.device)
        return cache

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: dict) -> torch.Tensor:
        """Full-sequence forward that fills ``cache`` in place; returns the
        last position's logits [B,V]."""
        S = tokens.shape[1]
        positions = torch.arange(S, device=tokens.device)[None, :]
        h, caches, kvs = self._groups(self._embed(tokens), positions,
                                      collect=True)
        for i, c in enumerate(caches):
            cache["state"][i].copy_(c["state"])
            cache["conv"][i].copy_(c["conv"])
        for g, (k, v) in enumerate(kvs):
            cache["k"][g, :, :S] = k
            cache["v"][g, :, :S] = v
        return self._head(h[:, -1])

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: dict,
                    pos: int) -> torch.Tensor:
        """token [B,1]; ``pos`` = index of the new token.  Advances every
        Mamba layer's state and writes the token's K/V into each
        application's cache, in place; returns logits [B,V]."""
        positions = torch.full((token.shape[0], 1), pos, dtype=torch.long,
                               device=token.device)
        h, _, _ = self._groups(self._embed(token), positions, cache, pos)
        return self._head(h[:, 0])
