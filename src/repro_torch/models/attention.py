"""GQA attention: projections, the plain direct path, decode, dispatcher.

Layouts: q [B,S,H,hd], k/v [B,T,KV,hd], ``wq [D,H,hd]``, ``wo [H,hd,D]``;
GQA groups G = H // KV.  Causal self-attention (prefill) goes to the
``flash_attention`` op, whose kernel runs on CUDA tensors; decode stays
plain PyTorch, as the JAX package has no kernel for it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_rope

NEG_INF = -1e30


def project_qkv(wq, wk, wv, x, positions=None, rope_theta=None,
                bq=None, bk=None, bv=None):
    """Returns q [B,S,H,hd], k/v [B,S,KV,hd]; RoPE if positions given."""
    B, S, D = x.shape
    q = (x @ wq.reshape(D, -1)).view(B, S, *wq.shape[1:])
    k = (x @ wk.reshape(D, -1)).view(B, S, *wk.shape[1:])
    v = (x @ wv.reshape(D, -1)).view(B, S, *wv.shape[1:])
    if bq is not None:
        q, k, v = q + bq, k + bk, v + bv
    if positions is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def project_out(wo, o):
    """o [B,S,H,hd] @ wo [H,hd,D] -> [B,S,D]."""
    B, S = o.shape[:2]
    return o.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])


def direct_attention(q, k, v, causal=True, q_offset=0):
    """Plain attention with the JAX ``direct_attention``'s roundings:
    scores in the input dtype, softmax in fp32, weights cast back."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).float() * (hd ** -0.5)
    if causal:
        qpos = torch.arange(S, device=q.device) + q_offset
        mask = qpos[:, None] >= torch.arange(T, device=q.device)[None, :]
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.einsum("bkgst,btkh->bskgh", w, v)
    return o.reshape(B, S, H, hd)


def decode_attention(q, k_cache, v_cache, pos: int):
    """q [B,1,H,hd]; caches [B,T,KV,hd]; attends to positions 0..pos.

    The JAX version masks positions > pos over the whole cache; slicing
    them off gives the same sums (masked weights are exactly 0)."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    k = k_cache[:, :pos + 1]
    v = v_cache[:, :pos + 1]
    qg = q.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgh,btkh->bkgt", qg, k).float() * (hd ** -0.5)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgt,btkh->bkgh", w, v)
    return o.reshape(B, 1, H, hd)


def attention(q, k, v, *, causal=True, q_offset=0):
    """Causal self-attention over the whole sequence goes to the flash
    op (the CUDA kernel on CUDA tensors, its plain version on the CPU);
    anything else takes the direct path."""
    if causal and q_offset == 0 and q.shape[1] == k.shape[1]:
        return flash_attention(q, k, v, causal=True)
    return direct_attention(q, k, v, causal, q_offset)
