"""Decoder-only transformer LM with KV-cache prefill/decode: the dense,
moe, audio and vlm families, which the JAX package builds with one
``TransformerLM`` (the audio family is the dense model over EnCodec tokens,
its frontend a stub).

Parameters follow the JAX package's tree, one module per layer instead of a
leading stacked axis: ``embed.embedding``, ``final_norm.scale``,
``layers.<i>.{ln1,ln2}.scale``, ``layers.<i>.attn.{wq,wk,wv,wo[,bq,bk,bv]}``,
``layers.<i>.mlp.{wi_gate,wi_up,wo}`` (``head.w`` when untied).  The moe
family's layers hold ``layers.<i>.moe.{router,wi_gate,wi_up,wo}`` in place
of the MLP, and beside it when ``moe_dense_residual`` is set (arctic); its
loss adds 0.01 times the routers' aux losses summed over the layers.  The vlm
family's JAX tree stacks ``layers`` on [groups, cross_attn_every] and
``cross`` on [groups]: self-attention layer j of group g is the port's
``layers.<g * cross_attn_every + j>``, and the gated cross-attention layer
that follows the group is ``cross.<g>.{ln1,ln2}.scale``,
``cross.<g>.attn.{wq,wk,wv,wo,gate}``, ``cross.<g>.mlp.*``,
``cross.<g>.gate_mlp`` and ``cross.<g>.kv_proj`` [vision_d, d_model].

Every residual add is fused with the norm that follows it
(``fused_residual_rmsnorm``): ``x + attn_out`` -> ``ln2`` and ``x + mlp_out``
-> the next block's ``ln1``, or ``final_norm`` after the last block; a cross
layer's adds are gated, ``x + tanh(gate)·out``.  That is 2·L launches per
forward (llama-3.2-vision-11b: 32 flash, 80 fused); only the first block's
``ln1`` is a plain ``rmsnorm``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models.lm import LM, RMSNorm, fused, param, remat


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


class CrossAttention(Attention):
    """Cross-attention projections (no biases, as the JAX model's) and the
    scalar tanh gate of its residual add."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__(dataclasses.replace(cfg, qkv_bias=False), dtype,
                         device)
        self.gate = param((), dtype, device)


class MLP(nn.Module):
    def __init__(self, d_model, d_ff, dtype, device):
        super().__init__()
        self.wi_gate = param((d_model, d_ff), dtype, device)
        self.wi_up = param((d_model, d_ff), dtype, device)
        self.wo = param((d_ff, d_model), dtype, device)


class Block(nn.Module):
    """Attention and an MLP; with ``num_experts`` set, the MoE FF in place
    of the MLP, or beside it with ``moe_dense_residual`` (the JAX
    ``_layer_init``), of E / ``shards`` experts on a rank of a model axis
    of ``shards`` (expert parallelism)."""

    def __init__(self, cfg: ModelConfig, dtype, device,
                 norm_dtype=torch.float32, shards: int = 1):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device, norm_dtype)
        self.ln2 = RMSNorm(cfg.d_model, device, norm_dtype)
        self.attn = Attention(cfg, dtype, device)
        self.moe = (moe_lib.MoE(cfg, dtype, device, shards)
                    if cfg.num_experts else None)
        self.mlp = (MLP(cfg.d_model, cfg.d_ff, dtype, device)
                    if not cfg.num_experts or cfg.moe_dense_residual
                    else None)


class CrossBlock(nn.Module):
    """The vlm family's gated cross-attention layer: queries from the text,
    keys and values from the vision embeddings through ``kv_proj``."""

    def __init__(self, cfg: ModelConfig, dtype, device,
                 norm_dtype=torch.float32):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device, norm_dtype)
        self.ln2 = RMSNorm(cfg.d_model, device, norm_dtype)
        self.attn = CrossAttention(cfg, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device)
        self.gate_mlp = param((), dtype, device)
        self.kv_proj = param((cfg.vision_d, cfg.d_model), dtype, device)


@dataclasses.dataclass(frozen=True)
class AttnImpl:
    """How a model's full-sequence self-attention runs (the JAX models'
    ``attn_impl``, ``fold_depth``, ``q_chunk`` and ``kv_chunk``): ``impl``
    one of ``attention.IMPLS``; ``"cp"`` with a mesh is context-parallel
    over its model axis."""

    impl: str = "auto"
    fold_depth: int = 4
    q_chunk: int = 1024
    kv_chunk: int = 512

    def __post_init__(self):
        if self.impl not in attn_lib.IMPLS:
            raise ValueError(f"attn_impl is one of {attn_lib.IMPLS}, not "
                             f"{self.impl!r}")

    def __call__(self, q, k, v, mesh=None):
        """Causal self-attention of q/k/v [B,S,*,hd] by this impl."""
        if self.impl == "cp" and mesh is not None:
            return attn_lib.context_parallel_attention(
                q, k, v, mesh, causal=True, q_chunk=self.q_chunk,
                kv_chunk=self.kv_chunk)
        return attn_lib.attention(
            q, k, v, causal=True, impl=self.impl, fold_depth=self.fold_depth,
            q_chunk=self.q_chunk, kv_chunk=self.kv_chunk)


def block_apply(blk: Block, h, x, positions, cfg: ModelConfig, w, nxt,
                i: int, cache=None, pos=None, kvs=None, auxs=None,
                mesh=None, attn: AttnImpl = AttnImpl()):
    """One block on its normed input ``h`` and residual stream ``x``;
    returns the next (normed input, residual) pair, normed by ``nxt`` (the
    scale of the norm that follows).  ``w`` casts a stored weight to the
    compute dtype.  ``cache`` given: one decode token at ``pos``, its K/V
    written into slot ``i`` of the cache in place (where the JAX model uses
    dynamic_update_slice on a donated cache); else full causal
    self-attention, its (k, v) appended to ``kvs`` when given.  A moe
    block's FF is the MoE (plus the MLP on the same ``h`` with a dense
    residual), its router's aux loss appended to ``auxs`` when given, its
    experts parallel over ``mesh``'s model axis when a mesh is given
    (``moe.moe_apply``).  ``attn`` is the full-sequence attention's impl
    (context-parallel over ``mesh``'s model axis under ``"cp"``)."""
    eps = cfg.norm_eps
    a = blk.attn
    bias = (None,) * 3 if a.bq is None else (w(a.bq), w(a.bk), w(a.bv))
    q, k, v = attn_lib.project_qkv(w(a.wq), w(a.wk), w(a.wv), h, positions,
                                   cfg.rope_theta, *bias)
    if cache is None:
        o = attn(q, k, v, mesh)
        if kvs is not None:
            kvs.append((k, v))
    else:
        cache["k"][i, :, pos] = k[:, 0]
        cache["v"][i, :, pos] = v[:, 0]
        o = attn_lib.decode_attention(q, cache["k"][i], cache["v"][i], pos)
    h, x = fused(attn_lib.project_out(w(a.wo), o), x, blk.ln2.scale, eps)
    m = blk.mlp
    if blk.moe is None:
        y = L.mlp_apply(w(m.wi_gate), w(m.wi_up), w(m.wo), h)
    else:
        y, aux = moe_lib.moe_apply(blk.moe, h, cfg, w, mesh)
        if auxs is not None:
            auxs.append(aux)
        if m is not None:
            y = y + L.mlp_apply(w(m.wi_gate), w(m.wi_up), w(m.wo), h)
    return fused(y, x, nxt, eps)


def cross_apply(blk: CrossBlock, h, x, vision, cfg: ModelConfig, w, nxt,
                g: int, cache=None, kvs=None):
    """The gated cross-attention block ``g`` on its normed input ``h`` and
    residual stream ``x``; returns the next (normed input, residual) pair,
    normed by ``nxt``.  K and V are the vision embeddings [B,T,vision_d]
    through ``kv_proj`` and wk/wv, no RoPE (appended to ``kvs`` when
    given); ``cache`` given, they are its ``cross_k``/``cross_v`` slot g,
    which the prefill filled (the JAX decode recomputes K/V of x and
    discards them).  Attention is not causal: direct while S·T <= 2^22,
    chunked above, as the JAX model's."""
    eps = cfg.norm_eps
    a = blk.attn
    if cache is None:
        vkv = vision @ w(blk.kv_proj)
        q, k, v = attn_lib.project_qkv(w(a.wq), w(a.wk), w(a.wv), h,
                                       kv_x=vkv)
        if kvs is not None:
            kvs.append((k, v))
    else:
        q = attn_lib.project(w(a.wq), h)
        k, v = cache["cross_k"][g], cache["cross_v"][g]
    o = attn_lib.attention(q, k, v, causal=False, impl=cross_impl(
        q.shape[1], k.shape[1]))
    out = attn_lib.project_out(w(a.wo), o)
    h, x = fused(torch.tanh(w(a.gate)) * out, x, blk.ln2.scale, eps)
    m = blk.mlp
    y = L.mlp_apply(w(m.wi_gate), w(m.wi_up), w(m.wo), h)
    return fused(torch.tanh(w(blk.gate_mlp)) * y, x, nxt, eps)


CROSS_DIRECT_MAX = 1 << 22   # the cross layers go direct up to this S·T


def cross_impl(S: int, T: int) -> str:
    """The cross layers' attention impl at S queries and T vision tokens:
    ``"direct"`` while S·T <= 2^22, ``"chunked"`` above (the JAX
    ``_cross_block``)."""
    return "direct" if S * T <= CROSS_DIRECT_MAX else "chunked"


def init_std(cfg: ModelConfig, name: str) -> Optional[float]:
    """The JAX init's normal stddev of the embedding, the head or a
    block's parameter; None for norm scales, biases and the cross layers'
    gates (constants)."""
    leaf = name.rsplit(".", 2)[-2:]
    if leaf[-1] in ("scale", "bq", "bk", "bv", "gate", "gate_mlp"):
        return None
    if leaf[-1] == "kv_proj":
        return cfg.vision_d ** -0.5
    if name == "embed.embedding":
        return 1.0
    if leaf == ["attn", "wo"]:
        return (cfg.num_heads * cfg.head_dim) ** -0.5
    if leaf in (["mlp", "wo"], ["moe", "wo"]):
        return cfg.d_ff ** -0.5
    # wq, wk, wv, wi_gate, wi_up (the MLP's and the experts'), the MoE
    # router, head.w
    return cfg.d_model ** -0.5


FAMILIES = ("dense", "moe", "audio", "vlm")


class TransformerLM(LM):
    """Weights live in ``policy.param_dtype`` and are cast to the compute
    dtype at each use, as in the JAX model (serving stores them in the
    compute dtype, so the cast is the weight itself); norm scales are
    stored in ``policy.norm_dtype``.  ``loss`` trains: its forward and
    backward go through the flash-attention and fused-norm kernels on CUDA
    tensors (the moe family's dispatch and expert products are PyTorch, as
    the reference's are XLA).  The vlm family's calls take
    ``vision_embeds`` [B, vision_tokens, vision_d].  With a ``mesh``
    (``parallel/mesh.py``, connected) the moe family's experts are parallel
    over its model axis: each layer holds this rank's experts (load a
    state cut by ``moe.shard_experts``) and a call takes this rank's data
    shard of the batch (the JAX model's ``mesh``).  ``attn`` is how the
    self-attention layers attend over the whole sequence (``AttnImpl``;
    ``"cp"`` is context-parallel over the mesh's model axis)."""

    def __init__(self, cfg: ModelConfig, policy: L.Policy = L.Policy(),
                 device="cuda", remat: str = "none", mesh=None,
                 attn: AttnImpl = AttnImpl()):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"TransformerLM serves the {'/'.join(FAMILIES)} families, "
                f"not {cfg.family!r}")
        if cfg.family == "vlm" and cfg.num_layers % (cfg.cross_attn_every + 1):
            raise ValueError(
                f"{cfg.name}: the vlm family builds whole groups of "
                f"{cfg.cross_attn_every} self-attention layers and 1 cross "
                f"layer, so num_layers is a multiple of "
                f"{cfg.cross_attn_every + 1}, not {cfg.num_layers}")
        super().__init__(cfg, policy, device, remat)
        self.mesh = mesh
        self.attn = attn
        pd = policy.param_dtype
        shards = moe_lib.model_shards(mesh)
        self.layers = nn.ModuleList(
            Block(cfg, pd, self.device, policy.norm_dtype, shards)
            for _ in range(cfg.n_self))
        self.cross = nn.ModuleList(
            CrossBlock(cfg, pd, self.device, policy.norm_dtype)
            for _ in range(cfg.n_cross))

    def _init_std(self, name: str) -> Optional[float]:
        return init_std(self.cfg, name)

    # ------------------------------------------------------------------ #
    # Forward
    # ------------------------------------------------------------------ #
    def _stack(self) -> list:
        """The blocks in the order they run: ("self", i, layer), and for the
        vlm family ("cross", g, cross layer) after each group of
        ``cross_attn_every`` self-attention layers."""
        if not len(self.cross):
            return [("self", i, b) for i, b in enumerate(self.layers)]
        per = self.cfg.cross_attn_every
        out = []
        for g, c in enumerate(self.cross):
            out += [("self", g * per + j, self.layers[g * per + j])
                    for j in range(per)]
            out.append(("cross", g, c))
        return out

    def _vision(self, vision_embeds):
        if not len(self.cross):
            return None
        if vision_embeds is None:
            raise ValueError(f"{self.cfg.name}: the vlm family needs "
                             f"vision_embeds [B, {self.cfg.vision_tokens}, "
                             f"{self.cfg.vision_d}]")
        return vision_embeds.to(self.policy.compute_dtype)

    def _blocks(self, x, positions, cache=None, pos=None, vision=None):
        """Runs every block; returns the final-normed hidden state, each
        self-attention layer's (k, v), each cross layer's, and each moe
        layer's aux loss.  ``cache`` None: full causal self-attention.
        ``cache`` given: one decode token at ``pos``.  Under remat each
        block, self or cross, is one recomputed unit from (h, x) to the
        next (h, x) and its aux loss (the JAX model remats the self layers
        and then each vlm group around them: the same values); K/V are
        collected only where no remat runs (serving)."""
        cfg = self.cfg
        stack = self._stack()
        h = L.rmsnorm(stack[0][2].ln1.scale, x, cfg.norm_eps)
        kvs, cross_kvs, auxs = [], [], []
        keep = self.remat == "none" or not torch.is_grad_enabled()
        for n, (kind, i, blk) in enumerate(stack):
            nxt = (stack[n + 1][2].ln1 if n + 1 < len(stack)
                   else self.final_norm).scale
            if kind == "self":
                def unit(h, x, blk=blk, i=i, nxt=nxt):
                    a = []
                    h, x = block_apply(blk, h, x, positions, cfg, self.cast,
                                       nxt, i, cache, pos,
                                       kvs if keep else None, a, self.mesh,
                                       self.attn)
                    return h, x, *a
                h, x, *a = remat(self.remat, unit, h, x)
                auxs += a
            else:
                def unit(h, x, blk=blk, i=i, nxt=nxt):
                    return cross_apply(blk, h, x, vision, cfg, self.cast,
                                       nxt, i, cache,
                                       cross_kvs if keep else None)
                h, x = remat(self.remat, unit, h, x)
        return h, kvs, cross_kvs, auxs

    def logits_and_aux(self, tokens: torch.Tensor,
                       vision_embeds: Optional[torch.Tensor] = None):
        """tokens [B,S] -> (logits [B,S,V], the moe layers' aux losses
        summed, a float32 scalar: 0 for the other families), recording
        autograd's graph where grad mode is on (training)."""
        S = tokens.shape[1]
        positions = torch.arange(S, device=tokens.device)[None, :]
        h, _, _, auxs = self._blocks(self._embed(tokens), positions,
                                     vision=self._vision(vision_embeds))
        aux = (torch.stack(auxs).sum() if auxs else
               torch.zeros((), dtype=torch.float32, device=h.device))
        return self._head(h), aux

    def logits(self, tokens: torch.Tensor,
               vision_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B,S] -> logits [B,S,V], recording autograd's graph
        where grad mode is on (training)."""
        return self.logits_and_aux(tokens, vision_embeds)[0]

    @torch.no_grad()
    def apply(self, tokens: torch.Tensor,
              vision_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B,S] -> logits [B,S,V]."""
        return self.logits(tokens, vision_embeds)

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor,
             vision_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Mean next-token cross-entropy of ``tokens`` against ``labels``,
        plus 0.01 times the aux loss for the moe family (the JAX
        ``loss``)."""
        logits, aux = self.logits_and_aux(tokens, vision_embeds)
        ce = L.cross_entropy(logits, labels)
        return ce + 0.01 * aux if self.cfg.num_experts else ce

    # ------------------------------------------------------------------ #
    # KV cache serving
    # ------------------------------------------------------------------ #
    def max_tokens(self, max_seq: int) -> Optional[int]:
        return max_seq                  # the KV cache's positions

    def init_cache(self, batch: int, max_seq: int) -> dict:
        """``k`` and ``v`` [self-attention layers, B, max_seq, KV, hd]; the
        vlm family's ``cross_k`` and ``cross_v`` [cross layers, B,
        vision_tokens, KV, hd] too."""
        cfg = self.cfg
        kw = dict(dtype=self.policy.compute_dtype, device=self.device)
        shape = (len(self.layers), batch, max_seq, cfg.num_kv_heads,
                 cfg.head_dim)
        cache = {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}
        if len(self.cross):
            shape = (len(self.cross), batch, cfg.vision_tokens,
                     cfg.num_kv_heads, cfg.head_dim)
            cache["cross_k"] = torch.zeros(shape, **kw)
            cache["cross_v"] = torch.zeros(shape, **kw)
        return cache

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: dict,
                vision_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-sequence forward that fills ``cache`` in place; returns the
        last position's logits [B,V].  Only that position goes through the
        head, which is all the JAX prefill returns."""
        S = tokens.shape[1]
        positions = torch.arange(S, device=tokens.device)[None, :]
        h, kvs, cross_kvs, _ = self._blocks(
            self._embed(tokens), positions,
            vision=self._vision(vision_embeds))
        for i, (k, v) in enumerate(kvs):
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
        for g, (k, v) in enumerate(cross_kvs):
            cache["cross_k"][g] = k
            cache["cross_v"][g] = v
        return self._head(h[:, -1])

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: dict,
                    pos: int) -> torch.Tensor:
        """token [B,1]; ``pos`` = index of the new token.  Writes its K/V
        into ``cache`` in place; returns logits [B,V]."""
        positions = torch.full((token.shape[0], 1), pos, dtype=torch.long,
                               device=token.device)
        h, _, _, _ = self._blocks(self._embed(token), positions, cache, pos)
        return self._head(h[:, 0])
