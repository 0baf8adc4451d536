"""GQA attention: projections, the plain direct path, decode, dispatcher.

Layouts: q [B,S,H,hd], k/v [B,T,KV,hd], ``wq [D,H,hd]``, ``wo [H,hd,D]``;
GQA groups G = H // KV.  Causal self-attention (prefill) goes to the
``flash_attention`` op, whose kernel runs on CUDA tensors; decode stays
plain PyTorch, as the JAX package has no kernel for it.  So does the VLM's
cross-attention (queries of the text, keys and values of the image, S != T,
not causal): the JAX model computes it with ``direct_attention`` in XLA,
and its TPU flash kernel takes k/v of q's length only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_rope

NEG_INF = -1e30


def project(w, x):
    """x [B,S,D] @ w [D,N,hd] -> [B,S,N,hd]."""
    B, S, D = x.shape
    return (x @ w.reshape(D, -1)).view(B, S, *w.shape[1:])


def project_qkv(wq, wk, wv, x, positions=None, rope_theta=None,
                bq=None, bk=None, bv=None, kv_x=None):
    """Returns q [B,S,H,hd], k/v [B,T,KV,hd]; RoPE if positions given.
    K and V come from ``kv_x`` [B,T,D] when given (cross-attention), else
    from x."""
    kv_x = x if kv_x is None else kv_x
    q = project(wq, x)
    k = project(wk, kv_x)
    v = project(wv, kv_x)
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
