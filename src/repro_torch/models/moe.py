"""Mixture-of-Experts FF with sort-based (dropping) dispatch: the port of
the JAX package's ``models/moe.py``, its local path (no mesh; expert
parallelism over a mesh axis is not ported).

A token picks ``experts_per_token`` (k) of ``num_experts`` (E) experts by
the router's fp32 softmax; its k (token, expert) entries are sorted by
expert id, stably, so within an expert they keep the order of their flat
index t·k + j, and each expert takes the first ``capacity`` (C) of them
into an [E, C, D] buffer: the rest are dropped (their output is 0).  Every
one of the E·C slots, the empty ones included, goes through its expert's
SwiGLU, as in the reference.  Decode runs the same rule on its B tokens,
so at B 8 the capacity floor of 4 applies and tokens can be dropped there
too.

Rounding against the reference: the buffer is written with
``index_copy`` (each kept slot once; the dropped entries all land, as
zeros, in the overflow slot E·C, which is cut off) where the JAX code
scatter-adds into zeros, which gives the same values.  The combine adds a
token's k weighted expert outputs one by one in ascending expert id,
rounding to the compute dtype after each add, which is the order in which
the reference's scatter-add into ``y`` meets them (sorted by expert id).
It never adds atomically, so it does not depend on the order in which the
card runs its threads, and neither does its backward: a token's k
gradients are summed by ``expand``'s backward, and every other index has
one writer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.models.lm import param


class MoE(nn.Module):
    """``router`` [D, E], ``wi_gate``/``wi_up`` [E, D, F], ``wo`` [E, F, D],
    the JAX ``moe_init``'s tree."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
        self.router = param((d, e), dtype, device)
        self.wi_gate = param((e, d, f), dtype, device)
        self.wi_up = param((e, d, f), dtype, device)
        self.wo = param((e, f, d), dtype, device)


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots an expert takes from a call of ``tokens`` tokens: T·k·cf // E
    + 1 (Python arithmetic, as the reference's ``_capacity``), at least
    4."""
    c = int(tokens * cfg.experts_per_token * cfg.capacity_factor
            // max(cfg.num_experts, 1)) + 1
    return max(c, 4)


def route(router: torch.Tensor, x_flat: torch.Tensor, cfg: ModelConfig):
    """Router top-k of x_flat [T, D] with ``router`` [D, E] in the compute
    dtype.  Returns (eids [T, k], weights [T, k] in x's dtype, aux): the
    logits in the compute dtype, softmax and top-k in fp32, the weights
    renormalised over the k (floor 1e-9), and the Switch load-balancing
    loss E·Σ_e (share of tokens whose first choice is e)·(mean prob of
    e)."""
    probs = torch.softmax((x_flat @ router).float(), dim=-1)
    w, eids = torch.topk(probs, cfg.experts_per_token, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    E = cfg.num_experts
    frac_tokens = F.one_hot(eids[:, 0], E).float().mean(0)
    aux = E * torch.sum(frac_tokens * probs.mean(0))
    return eids, w.to(x_flat.dtype), aux


def dispatch(key: torch.Tensor, experts: int, capacity: int):
    """Slots of the flat (token, choice) entries ``key`` [T·k] (local
    expert ids, ``experts`` the junk bucket): a stable sort by key, each
    entry's position among its expert's from the sorted offsets, kept
    while the position is below ``capacity`` and the expert is local.
    Returns (dest, keep) [T·k] in flat order: slot e·C + pos of a kept
    entry, the overflow slot E·C of any other."""
    n = key.numel()
    order = torch.sort(key, stable=True).indices
    se = key[order]
    ids = torch.arange(experts + 1, device=key.device, dtype=se.dtype)
    offsets = torch.searchsorted(se, ids)
    pos = torch.arange(n, device=key.device) - offsets[se]
    keep = (se < experts) & (pos < capacity)
    dest = torch.where(keep, se * capacity + pos,
                       torch.full_like(se, experts * capacity))
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=key.device)
    return dest[inv], keep[inv]


def expert_ff_local(x_flat, eids, weights, wi_gate, wi_up, wo,
                    expert_offset: int, capacity: int):
    """Dispatch -> per-expert SwiGLU -> combine for the E_loc experts of
    ``wi_*`` [E_loc, D, F] and ``wo`` [E_loc, F, D], global ids
    ``expert_offset`` .. + E_loc - 1.  x_flat [T, D], eids and weights
    [T, k]; returns y [T, D] in x's dtype."""
    T, D = x_flat.shape
    k = eids.shape[1]
    E_loc, C = wi_gate.shape[0], capacity
    dt = x_flat.dtype
    flat_e = eids.reshape(-1) - expert_offset
    local = (flat_e >= 0) & (flat_e < E_loc)
    key = torch.where(local, flat_e, torch.full_like(flat_e, E_loc))
    dest, keep = dispatch(key, E_loc, C)

    rows = x_flat[:, None, :].expand(T, k, D).reshape(T * k, D)
    buf = x_flat.new_zeros(E_loc * C + 1, D).index_copy(
        0, dest, rows * keep[:, None].to(dt))
    buf = buf[:E_loc * C].view(E_loc, C, D)
    h = F.silu(torch.bmm(buf, wi_gate)) * torch.bmm(buf, wi_up)
    out = torch.cat([torch.bmm(h, wo).reshape(E_loc * C, D),
                     x_flat.new_zeros(1, D)])

    scale = weights.reshape(-1) * keep.to(dt)
    gathered = (out[dest] * scale[:, None]).view(T, k, D)
    # a token's k outputs in ascending expert id, added one at a time
    by_id = torch.argsort(key.view(T, k), dim=1, stable=True)
    gathered = torch.gather(gathered, 1, by_id[..., None].expand(T, k, D))
    y = gathered[:, 0]
    for j in range(1, k):
        y = y + gathered[:, j]
    return y


def moe_apply(moe: MoE, x: torch.Tensor, cfg: ModelConfig, w):
    """x [B, S, D] -> (y [B, S, D], aux), all experts local; ``w`` casts a
    stored weight to the compute dtype.  The capacity is that of this
    call's B·S tokens (a microbatch's, in a microbatched step)."""
    B, S, D = x.shape
    x_flat = x.reshape(B * S, D)
    eids, weights, aux = route(w(moe.router), x_flat, cfg)
    y = expert_ff_local(x_flat, eids, weights, w(moe.wi_gate),
                        w(moe.wi_up), w(moe.wo), 0, capacity(B * S, cfg))
    return y.view(B, S, D), aux
