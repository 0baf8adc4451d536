"""Mixture-of-Experts FF with sort-based (dropping) dispatch: the port of
the JAX package's ``models/moe.py``, its local path and its expert
parallelism over a mesh's ``model`` axis.

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

Expert parallelism (``moe_apply(..., mesh=)``, the reference's
``shard_map`` over the model axis): each model rank holds E / n of the
experts (``shard_experts``: their spec ``("model", None, None)`` cut by
``sharding.shard``) and ``x``, its data shard's tokens.  Routing runs on
every rank as on one; each rank dispatches its tokens to its own experts
at the capacity of its data shard, and the shards' outputs are summed over
the model subgroup by the port's ring all-reduce (the ring-combine kernel
on the card), where the reference takes a ``psum``.  A token's k outputs
then meet in the ring's order of the ranks, not in ascending expert id, so
y is equal to the local path's within rounding, not bitwise.  The aux loss
is the reference's, of all data shards' tokens: the shares it is made of
are averaged over the data axes.

Both sums are the ring collectives' autograd functions, so the expert
parallel path has the reference's gradient under the convention of
``parallel/collectives.py``: a data shard's loss is held by its n model
ranks and seeded with 1 / n (the aux loss, held by every rank, with 1 /
(n·dp)); y's all-reduce hands each model rank the whole output gradient,
so its experts get theirs, and the aux shares' all-reduce sums the data
shards' cotangents.  Each rank's router and x gradients are then its
share, summed over the axes they are replicated on by
``sharding.sum_replicated`` (the router over every axis, x over the model
axis, the experts over the data axes).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.models.lm import param
from repro_torch.parallel.collectives import ring_all_reduce
from repro_torch.parallel.sharding import param_specs, shard

EXPERT_WEIGHTS = ("wi_gate", "wi_up", "wo")


class MoE(nn.Module):
    """``router`` [D, E], ``wi_gate``/``wi_up`` [E, D, F], ``wo`` [E, F, D],
    the JAX ``moe_init``'s tree; on a rank of a model axis of ``shards``,
    the experts' weights hold E / ``shards`` experts (the router all E)."""

    def __init__(self, cfg: ModelConfig, dtype, device, shards: int = 1):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        e = experts_per_shard(cfg, shards)
        self.router = param((d, cfg.num_experts), dtype, device)
        self.wi_gate = param((e, d, f), dtype, device)
        self.wi_up = param((e, d, f), dtype, device)
        self.wo = param((e, f, d), dtype, device)


def experts_per_shard(cfg: ModelConfig, shards: int) -> int:
    if cfg.num_experts % shards:
        raise ValueError(f"{cfg.num_experts} experts do not split over "
                         f"{shards} model ranks")
    return cfg.num_experts // shards


def expert_parallel(mesh, model_axis: str = "model") -> bool:
    """Whether ``moe_apply`` shards the experts over ``mesh``: a mesh with
    a ``model_axis`` (of any size: with data axes beside it, a rank still
    takes its data shard and the aux loss is still averaged over them)."""
    return mesh is not None and model_axis in getattr(mesh, "axis_names", ())


def model_shards(mesh, model_axis: str = "model") -> int:
    """The expert shards of ``mesh`` (1 without expert parallelism)."""
    return mesh.shape[model_axis] if expert_parallel(mesh, model_axis) else 1


def shard_experts(state: dict, mesh, coords) -> dict:
    """``state`` with each MoE expert weight (``*.moe.wi_gate``, ``wi_up``,
    ``wo``) cut to the block of the rank at mesh ``coords``, by its
    parameter spec (``("model", None, None)``)."""
    names = [n for n in state if n.rsplit(".", 2)[-2:-1] == ["moe"]
             and n.rsplit(".", 1)[-1] in EXPERT_WEIGHTS]
    specs = param_specs({n: tuple(state[n].shape) for n in names})
    out = dict(state)
    for n in names:
        out[n] = shard(torch.as_tensor(state[n]), specs[n], mesh, coords)
    return out


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots an expert takes from a call of ``tokens`` tokens: T·k·cf // E
    + 1 (Python arithmetic, as the reference's ``_capacity``), at least
    4."""
    c = int(tokens * cfg.experts_per_token * cfg.capacity_factor
            // max(cfg.num_experts, 1)) + 1
    return max(c, 4)


def route(router: torch.Tensor, x_flat: torch.Tensor, cfg: ModelConfig,
          mean=None):
    """Router top-k of x_flat [T, D] with ``router`` [D, E] in the compute
    dtype.  Returns (eids [T, k], weights [T, k] in x's dtype, aux): the
    logits in the compute dtype, softmax and top-k in fp32, the weights
    renormalised over the k (floor 1e-9), and the Switch load-balancing
    loss E·Σ_e (share of tokens whose first choice is e)·(mean prob of
    e).  ``mean``, if given, averages the two shares over the data shards
    before they are multiplied."""
    probs = torch.softmax((x_flat @ router).float(), dim=-1)
    w, eids = torch.topk(probs, cfg.experts_per_token, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    E = cfg.num_experts
    shares = torch.stack([F.one_hot(eids[:, 0], E).float().mean(0),
                          probs.mean(0)])
    if mean is not None:
        shares = mean(shares)
    aux = E * torch.sum(shares[0] * shares[1])
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


def moe_apply(moe: MoE, x: torch.Tensor, cfg: ModelConfig, w, mesh=None,
              model_axis: str = "model"):
    """x [B, S, D] -> (y [B, S, D], aux); ``w`` casts a stored weight to
    the compute dtype.  The capacity is that of this call's B·S tokens (a
    microbatch's, in a microbatched step).  Without a mesh (or a
    ``model_axis`` in it) all experts are local; with one, ``x`` is this
    rank's data shard and ``moe`` holds this model rank's experts (see the
    module note)."""
    B, S, D = x.shape
    x_flat = x.reshape(B * S, D)
    if not expert_parallel(mesh, model_axis):
        eids, weights, aux = route(w(moe.router), x_flat, cfg)
        y = expert_ff_local(x_flat, eids, weights, w(moe.wi_gate),
                            w(moe.wi_up), w(moe.wo), 0, capacity(B * S, cfg))
        return y.view(B, S, D), aux
    n = model_shards(mesh, model_axis)
    E_loc = experts_per_shard(cfg, n)
    if moe.wi_gate.shape[0] != E_loc:
        raise ValueError(f"moe_apply: a rank of {n} model shards holds "
                         f"{E_loc} experts, this one "
                         f"{moe.wi_gate.shape[0]} (shard_experts)")
    dp_axes = tuple(a for a in mesh.axis_names if a != model_axis)
    dp = math.prod(mesh.shape[a] for a in dp_axes)

    def mean(v):
        for a in dp_axes:
            v = ring_all_reduce(v, mesh.group(a))[0]
        return v / dp

    eids, weights, aux = route(w(moe.router), x_flat, cfg,
                               mean if dp > 1 else None)
    y = expert_ff_local(x_flat, eids, weights, w(moe.wi_gate),
                        w(moe.wi_up), w(moe.wo),
                        mesh.axis_index(model_axis) * E_loc,
                        capacity(B * S, cfg))
    y, _ = ring_all_reduce(y, mesh.group(model_axis))
    return y.view(B, S, D), aux
