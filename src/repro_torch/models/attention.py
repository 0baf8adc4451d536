"""GQA attention: projections, the direct, chunked, folded-causal and
context-parallel paths, decode, and the ``attention(impl=)`` dispatcher.

Layouts: q [B,S,H,hd], k/v [B,T,KV,hd], ``wq [D,H,hd]``, ``wo [H,hd,D]``;
GQA groups G = H // KV.  Under ``impl="auto"`` causal self-attention over
the whole sequence (prefill, training) goes to the ``flash_attention`` op,
whose kernel runs on CUDA tensors; every other call follows the JAX
``attention``'s rule, direct while S·T <= 2^20 and chunked above.  The
other impls are the JAX package's XLA paths, ported as PyTorch code (the
JAX package has no Pallas kernel for them):
  * ``chunked_attention``: online softmax over key chunks, queries in
    chunks, a recompute backward that keeps only q, k, v, o and lse, so
    training memory is O(S) (``_flash_attention_xla``);
  * ``folded_causal_attention``: the causal square split recursively into
    two causal halves and one full block, so the masked upper blocks are
    never computed;
  * ``context_parallel_attention``: each rank of a mesh's model axis takes
    1/M of the query rows against the whole K and V, the rows gathered by
    the port's ring all-gather (its backward a reduce-scatter).
Decode stays plain PyTorch, as the JAX package has no kernel for it.  So
does the VLM's cross-attention (queries of the text, keys and values of
the image, S != T, not causal): direct up to S·T = 2^22, chunked above, as
the JAX model's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_rope
from repro_torch.parallel.collectives import ring_all_gather_local

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


# --------------------------------------------------------------------------- #
# Chunked (flash-style) attention with a recompute backward
# --------------------------------------------------------------------------- #
def _masked(s, qpos, kpos):
    """Scores with the causal mask: key positions after a row's, NEG_INF."""
    return s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)


def _chunk_scan(q, k, v, causal, qpos, kv_chunk):
    """Online softmax over the key chunks for one q block (the JAX
    ``_chunk_scan``, its roundings: products in the input dtype, the
    softmax statistics in fp32, o carried in q's dtype).  q [B,Sq,KV,G,hd],
    qpos fp32 [Sq]; returns (o [B,Sq,KV,G,hd], lse [B,KV,G,Sq] fp32)."""
    B, Sq, KV, G, hd = q.shape
    T = k.shape[1]
    scale = hd ** -0.5
    f32 = dict(dtype=torch.float32, device=q.device)
    o = q.new_zeros((B, KV, G, Sq, hd))
    m = torch.full((B, KV, G, Sq), NEG_INF, **f32)
    l = torch.zeros((B, KV, G, Sq), **f32)
    for j0 in range(0, T, kv_chunk):
        kj, vj = k[:, j0:j0 + kv_chunk], v[:, j0:j0 + kv_chunk]
        s = torch.einsum("bskgh,btkh->bkgst", q, kj).float() * scale
        if causal:
            s = _masked(s, qpos, torch.arange(j0, j0 + kv_chunk, **f32))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bkgst,btkh->bkgsh", p.to(q.dtype), vj)
        o = o * alpha[..., None].to(o.dtype) + pv
        m = m_new
    l = torch.clamp(l, min=1e-30)
    o = o / l[..., None].to(o.dtype)
    return o.permute(0, 3, 1, 2, 4), m + torch.log(l)


def _q_blocks(S: int, q_chunk: int) -> int:
    """Query blocks of the JAX ``_flash_fwd``: S // q_chunk, or one block
    of all S rows when q_chunk does not divide S."""
    return 1 if S % q_chunk else max(S // q_chunk, 1)


def _chunk_bwd(q, k, v, o, do, lse, qpos, causal, kv_chunk):
    """Recompute backward of one q block (the JAX ``_flash_bwd_body``):
    q/o/do [B,bq,KV,G,hd], lse [B,KV,G,bq]; returns (dq, dk, dv), dk/dv
    [B,T,KV,hd] of this block's rows."""
    hd = q.shape[-1]
    T = k.shape[1]
    scale = hd ** -0.5
    f32 = dict(dtype=torch.float32, device=q.device)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 3, 1)
    dq = torch.zeros_like(q)
    dks, dvs = [], []
    for j0 in range(0, T, kv_chunk):
        kj, vj = k[:, j0:j0 + kv_chunk], v[:, j0:j0 + kv_chunk]
        s = torch.einsum("bskgh,btkh->bkgst", q, kj).float() * scale
        if causal:
            s = _masked(s, qpos, torch.arange(j0, j0 + kv_chunk, **f32))
        p = torch.exp(s - lse[..., None])
        dp = torch.einsum("bskgh,btkh->bkgst", do, vj).float()
        ds = (p * (dp - delta[..., None]) * scale).to(q.dtype)
        dq = dq + torch.einsum("bkgst,btkh->bskgh", ds, kj)
        dks.append(torch.einsum("bkgst,bskgh->btkh", ds, q))
        dvs.append(torch.einsum("bkgst,bskgh->btkh", p.to(q.dtype), do))
    return dq, torch.cat(dks, 1), torch.cat(dvs, 1)


class ChunkedAttention(torch.autograd.Function):
    """The JAX ``_flash_attention_xla`` (a ``custom_vjp``): the forward
    saves only q, k, v, o and lse, and the backward recomputes the scores
    one (q block, key chunk) at a time.  qg [B,S,KV,G,hd], qpos fp32 [S];
    k and v's gradients are summed over the q blocks in their dtype."""

    @staticmethod
    def forward(ctx, qg, k, v, qpos, causal, q_chunk, kv_chunk):
        S = qg.shape[1]
        bq = S // _q_blocks(S, q_chunk)
        os_, lses = zip(*(_chunk_scan(qg[:, i:i + bq], k, v, causal,
                                      qpos[i:i + bq], kv_chunk)
                          for i in range(0, S, bq)))
        o, lse = torch.cat(os_, 1), torch.cat(lses, 3)
        ctx.save_for_backward(qg, k, v, qpos, o, lse)
        ctx.causal, ctx.bq, ctx.kv_chunk = causal, bq, kv_chunk
        return o

    @staticmethod
    def backward(ctx, do):
        qg, k, v, qpos, o, lse = ctx.saved_tensors
        bq = ctx.bq
        dqs, dk, dv = [], None, None
        for i in range(0, qg.shape[1], bq):
            dq_i, dk_i, dv_i = _chunk_bwd(
                qg[:, i:i + bq], k, v, o[:, i:i + bq], do[:, i:i + bq],
                lse[..., i:i + bq], qpos[i:i + bq], ctx.causal, ctx.kv_chunk)
            dqs.append(dq_i)
            dk = dk_i if dk is None else dk + dk_i
            dv = dv_i if dv is None else dv + dv_i
        return torch.cat(dqs, 1), dk, dv, None, None, None, None


def chunked_attention(q, k, v, causal=True, q_offset=0, q_chunk=1024,
                      kv_chunk=512):
    """Memory-bounded flash-style attention with a recompute backward (the
    JAX ``chunked_attention``, its chunk rules): ``kv_chunk`` is cut to T,
    and is T itself where it does not divide T; ``q_chunk`` is cut to S,
    and the query axis goes whole where it does not divide S.
    ``q_offset`` (an int or a 0-d tensor) is the first row's position:
    row i attends to keys at positions <= i + q_offset."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    kv_chunk = min(kv_chunk, T)
    if T % kv_chunk:
        kv_chunk = T
    q_chunk = min(q_chunk, S)
    qpos = (torch.arange(S, device=q.device) + q_offset).float()
    og = ChunkedAttention.apply(q.reshape(B, S, KV, H // KV, hd), k, v,
                                qpos, causal, q_chunk, kv_chunk)
    return og.reshape(B, S, H, hd)


# --------------------------------------------------------------------------- #
# Folded-causal attention
# --------------------------------------------------------------------------- #
# Causal attention over S splits as
#   Q_lo -> causal(K_lo)                               (recurse)
#   Q_hi -> full(K_lo) merged with causal(K_hi)        (recurse)
# so each level leaves the strictly upper quadrant out, converging to the
# causal S^2/2 products with ``depth`` levels.
def _merge_partials(o1, m1, l1, o2, m2, l2):
    m = torch.maximum(m1, m2)
    a1, a2 = torch.exp(m1 - m), torch.exp(m2 - m)
    o = o1 * a1[..., None].to(o1.dtype) + o2 * a2[..., None].to(o2.dtype)
    return o, m, l1 * a1 + l2 * a2


def _partial(q, k, v, mask=None):
    """Unnormalised softmax partials (o [B,KV,G,S,hd], m, l) of q
    [B,S,KV,G,hd] against k/v, masked where ``mask`` [S,T] is False."""
    hd = q.shape[-1]
    s = torch.einsum("bskgh,btkh->bkgst", q, k).float() * (hd ** -0.5)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bkgst,btkh->bkgsh", p.to(q.dtype), v)
    return o, m, p.sum(-1)


def _full_partial(q, k, v):
    return _partial(q, k, v)


def _causal_partial(q, k, v, depth):
    S = q.shape[1]
    if depth <= 0 or S % 2 or S < 256:
        i = torch.arange(S, device=q.device)
        return _partial(q, k, v, i[:, None] >= i[None, :])
    h = S // 2
    lo = _causal_partial(q[:, :h], k[:, :h], v[:, :h], depth - 1)
    hi = _merge_partials(*_full_partial(q[:, h:], k[:, :h], v[:, :h]),
                         *_causal_partial(q[:, h:], k[:, h:], v[:, h:],
                                          depth - 1))
    return tuple(torch.cat([a, b], dim=3) for a, b in zip(lo, hi))


def folded_causal_attention(q, k, v, depth=4):
    """Causal self-attention (S == T) by recursive folding, ``depth``
    levels; a level stops where S is odd or below 256 (the JAX
    ``folded_causal_attention``)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    o, _, l = _causal_partial(q.reshape(B, S, KV, H // KV, hd), k, v, depth)
    o = o / torch.clamp(l, min=1e-30)[..., None].to(o.dtype)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)


# --------------------------------------------------------------------------- #
# Context-parallel attention over a mesh's model axis
# --------------------------------------------------------------------------- #
def context_parallel_attention(q, k, v, mesh, *, causal=True, q_offset=0,
                               q_chunk=1024, kv_chunk=512,
                               model_axis="model"):
    """Query rows split over the model axis of a connected ``mesh``
    (``parallel/mesh.py``): model rank m computes rows [m·S/M, (m+1)·S/M)
    against the whole K and V by ``chunked_attention`` at q_offset +
    m·S/M, and the ranks' rows meet through the ring all-gather over the
    model subgroup, so FLARE's ring progress counters see them.  q, k and
    v are this rank's (its data shard's batch, every row).  Where M does
    not divide S, or S/M is not a multiple of 16, every rank computes
    ``chunked_attention`` whole (the JAX rule).

    The gradient: the all-gather's backward, a reduce-scatter on the same
    ring, hands each rank its rows' output gradient summed over the model
    ranks, and ``chunked_attention``'s backward gives dq of those rows and
    the rows' share of dk and dv.  q, k and v are replicated over the
    model axis, so by ``parallel/collectives.py``'s convention each rank
    holds its share of their gradients (and of everything upstream), and
    ``sharding.sum_replicated`` sums the shares over the model subgroup
    through the ring, where the reference's ``shard_map`` psums the k/v
    cotangents."""
    M = mesh.shape[model_axis]
    S = q.shape[1]
    if S % M or (S // M) % 16:
        return chunked_attention(q, k, v, causal, q_offset,
                                 q_chunk=q_chunk, kv_chunk=kv_chunk)
    group = mesh.group(model_axis)
    s_loc = S // M
    m = mesh.axis_index(model_axis)
    o = chunked_attention(q[:, m * s_loc:(m + 1) * s_loc], k, v, causal,
                          q_offset + m * s_loc, q_chunk=min(q_chunk, s_loc),
                          kv_chunk=kv_chunk)
    rows, _ = ring_all_gather_local(o.movedim(1, 0).contiguous(), group)
    return rows.movedim(0, 1).contiguous()


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


IMPLS = ("auto", "direct", "chunked", "folded", "cp")
DIRECT_MAX = 1 << 20      # "auto" goes direct up to S·T of this


def attention(q, k, v, *, causal=True, q_offset=0, impl="auto", fold_depth=4,
              q_chunk=1024, kv_chunk=512):
    """impl (``IMPLS``): ``"direct"``, ``"chunked"``, ``"folded"`` (causal
    self-attention; chunked otherwise) as the JAX ``attention``; ``"cp"``
    without a mesh is chunked, as there.  ``"auto"``: causal
    self-attention over the whole sequence (S == T, q_offset 0) goes to
    the ``flash_attention`` op (the CUDA kernel on CUDA tensors, its plain
    version on the CPU), where the JAX rule picks by size; anything else
    follows that rule, direct while S·T <= 2^20, chunked above."""
    S, T = q.shape[1], k.shape[1]
    if impl not in IMPLS:
        raise ValueError(f"attention impl is one of {IMPLS}, not {impl!r}")
    if impl == "auto":
        if causal and S == T and isinstance(q_offset, int) and not q_offset:
            return flash_attention(q, k, v, causal=True)
        impl = "direct" if S * T <= DIRECT_MAX else "chunked"
    if impl == "direct":
        return direct_attention(q, k, v, causal, q_offset)
    if impl == "folded" and causal and S == T:
        return folded_causal_attention(q, k, v, fold_depth)
    return chunked_attention(q, k, v, causal, q_offset, q_chunk=q_chunk,
                             kv_chunk=kv_chunk)
