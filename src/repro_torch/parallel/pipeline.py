"""GPipe-style pipeline parallelism over a ``stage`` mesh axis, the port of
the JAX package's ``parallel/pipeline.py``.

The schedule is the reference's fill-drain loop, tick for tick: with M
microbatches and S stages it runs T = M + S - 1 ticks, and its bubble
share is (S - 1) / (M + S - 1).  At tick t stage 0 takes microbatch
clip(t, 0, M - 1) and every other stage the activation its left
neighbour passed it; a stage is active while 0 <= t - stage < M; each tick
ends with a ring permute to stage + 1 (``parallel/collectives.py``'s
``exchange`` on the stage subgroup; the last stage's send to stage 0 goes
unused, as the reference's ``ppermute``).  The last stage writes its
outputs; the outputs, zeros on every other stage, are summed over the
stage group by the port's ``ring_all_reduce`` (the ring-combine kernel on
the card) where the reference takes a ``psum``, so every stage returns
them all.  An inactive stage computes nothing (the reference computes and
discards), which changes no output.

Each rank holds only its own stage's parameters: the reference's
``P(axis)`` on the leading [S] axis, cut by ``sharding.shard``
(:func:`stage_block`).  A transformer stage (:func:`block_stage`) carries
``transformer.block_apply``'s (h, x) pair, the normed input and the
residual stream, packed as one tensor [2, mb, S, D].
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Callable

import torch

from repro_torch.models.transformer import block_apply
from repro_torch.parallel.collectives import exchange, ring_all_reduce
from repro_torch.parallel.sharding import Spec, shard


def bubble_share(stages: int, microbatches: int) -> float:
    return (stages - 1) / (microbatches + stages - 1)


def stage_block(params_stacked: dict, mesh, axis: str = "stage") -> dict:
    """This rank's block of stacked stage parameters ({name: [S, ...]}):
    each cut by ``Spec(axis)``, keeping its leading [1]."""
    coords = mesh.coords(torch.distributed.get_rank())
    return {k: shard(v, Spec(axis), mesh, coords)
            for k, v in params_stacked.items()}


def pipeline_apply(stage_fn: Callable, stage_params: dict,
                   x_microbatches: torch.Tensor, mesh,
                   axis: str = "stage") -> torch.Tensor:
    """Run microbatches through the S pipeline stages of ``mesh``'s
    ``axis``; every rank of the stage group calls it.

    stage_fn(stage_params, x) -> x     (one stage's layers)
    stage_params: this rank's block ({name: [1, ...]}, ``stage_block``)
    x_microbatches: [M, mb, ...] activations, the same on every stage
    Returns the [M, mb, ...] outputs of the last stage, on every stage."""
    S = mesh.shape[axis]
    M = x_microbatches.shape[0]
    T = M + S - 1  # total ticks (fill + steady + drain)
    group = mesh.group(axis)
    stage = mesh.axis_index(axis)
    sparams = {k: v[0] for k, v in stage_params.items()}
    buf = torch.zeros_like(x_microbatches[0])  # current activation
    outs = torch.zeros_like(x_microbatches)
    for t in range(T):
        inp = x_microbatches[min(max(t, 0), M - 1)] if stage == 0 else buf
        mb = t - stage  # microbatch this stage processes at tick t
        active = 0 <= mb < M
        y = stage_fn(sparams, inp) if active else buf
        # pass the activation to the next stage (ring; last -> 0 unused)
        buf = (exchange(y, torch.empty_like(y), (stage + 1) % S,
                        (stage - 1) % S, group) if S > 1 else y)
        if active and stage == S - 1:
            outs[mb] = y
    # only the last stage holds real outputs; the sum over the stages
    # hands them to every stage
    return ring_all_reduce(outs, group)[0]


def _view(params: dict) -> SimpleNamespace:
    """Dotted names ("attn.wq", ...) as nested attributes, so that a dict
    of one layer's tensors reads as the port's ``Block`` module."""
    tree: dict = {}
    for name, t in params.items():
        node = tree
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t

    def ns(d):
        return SimpleNamespace(**{k: ns(v) if isinstance(v, dict) else v
                                  for k, v in d.items()})
    return ns(tree)


def stack_block_params(state: dict, cfg, stages: int) -> dict:
    """The stacked stage parameters of a dense transformer's blocks from
    the port's per-layer state ({"layers.<i>.attn.wq": ..., ...,
    "final_norm.scale": ...}): {"attn.wq": [S, L/S, ...], ..., "nxt":
    [S, L/S, D]}, where ``nxt`` of layer i is the scale of the norm after
    it (layer i + 1's ``ln1``, ``final_norm`` after the last).  Layer 0's
    ``ln1`` normed the stages' input and is not among them."""
    L = cfg.num_layers
    if L % stages:
        raise ValueError(f"{L} layers do not split into {stages} stages")
    names = sorted({n.split(".", 2)[2] for n in state
                    if n.startswith("layers.0.")} - {"ln1.scale"})
    out = {n: torch.stack([state[f"layers.{i}.{n}"] for i in range(L)])
           for n in names}
    out["nxt"] = torch.stack([state[f"layers.{i + 1}.ln1.scale"]
                              for i in range(L - 1)] + [
                                  state["final_norm.scale"]])
    return {n: t.reshape(stages, L // stages, *t.shape[1:])
            for n, t in out.items()}


def block_stage(cfg, positions: torch.Tensor,
                cast: Callable = lambda w: w) -> Callable:
    """The stage function of a dense transformer's blocks: ``(sparams, a)
    -> a`` with ``a`` the packed (h, x) pair [2, mb, S, D] and ``sparams``
    one stage's {"attn.wq": [L/S, ...], ..., "nxt": [L/S, D]}
    (``stack_block_params``), each layer through
    ``transformer.block_apply``."""
    def stage_fn(sparams: dict, a: torch.Tensor) -> torch.Tensor:
        h, x = a[0], a[1]
        for j in range(sparams["nxt"].shape[0]):
            blk = _view({n: t[j] for n, t in sparams.items()
                         if n != "nxt"})
            for k in ("bq", "bk", "bv"):
                vars(blk.attn).setdefault(k, None)
            for k in ("mlp", "moe"):
                vars(blk).setdefault(k, None)
            h, x = block_apply(blk, h, x, positions, cfg, cast,
                               sparams["nxt"][j], j)
        return torch.stack([h, x])
    return stage_fn
