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

The gradient.  ``pipeline_apply`` is one ``torch.autograd.Function``: its
backward is the reference's schedule transposed, tick for tick from T - 1
down to 0, so it never leans on autograd's order across ranks.  It first
all-reduces the output gradient over the stages (the output sum's
transpose, by ``parallel/collectives.py``'s convention: each stage's loss
seeded with 1 / S where the loss is replicated); then at each tick every
stage exchanges the reverse permute, sending the gradient of the input it
took at tick t + 1 to stage - 1 (zeros where it took none, or from stage
0) and receiving the gradient of its tick-t output from stage + 1, and
takes the vjp of ``stage_fn`` (``torch.autograd.grad`` of the graph its
forward kept for that tick) only where it was active.  The parameters'
gradients add up microbatch M - 1 first.  ``x_microbatches`` is
replicated over the stages: its gradient is stage 0's and zeros
elsewhere, until ``sharding.sum_replicated`` sums it.

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


def _forward(stage_fn: Callable, block: dict, xs: torch.Tensor, mesh,
             axis: str, keep: bool):
    """The fill-drain schedule.  Returns (the summed outputs, {tick: (the
    stage's input, its output)} of the active ticks with their graphs
    when ``keep``, else empty)."""
    S = mesh.shape[axis]
    M = xs.shape[0]
    group = mesh.group(axis)
    stage = mesh.axis_index(axis)
    buf = torch.zeros_like(xs[0])  # current activation
    outs = torch.zeros_like(xs)
    ticks = {}
    for t in range(M + S - 1):   # fill + steady + drain
        inp = xs[min(max(t, 0), M - 1)] if stage == 0 else buf
        mb = t - stage  # microbatch this stage processes at tick t
        active = 0 <= mb < M
        if active and keep:
            inp = inp.detach().requires_grad_(stage > 0 or xs.requires_grad)
            with torch.enable_grad():
                y = stage_fn({k: v[0] for k, v in block.items()}, inp)
            ticks[t] = (inp, y)
            y = y.detach()
        elif active:
            y = stage_fn({k: v[0] for k, v in block.items()}, inp)
        else:
            y = buf
        # pass the activation to the next stage (ring; last -> 0 unused)
        buf = (exchange(y, torch.empty_like(y), (stage + 1) % S,
                        (stage - 1) % S, group) if S > 1 else y)
        if active and stage == S - 1:
            outs[mb] = y
    # only the last stage holds real outputs; the sum over the stages
    # hands them to every stage
    return ring_all_reduce(outs, group)[0], ticks


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, mesh, axis, names, keep, xs, *params):
        block = dict(zip(names, params))
        if keep:
            block = {k: v.detach().requires_grad_(v.requires_grad)
                     for k, v in block.items()}
        outs, ticks = _forward(stage_fn, block, xs, mesh, axis, keep)
        ctx.mesh, ctx.axis, ctx.ticks, ctx.block = mesh, axis, ticks, block
        ctx.x_grad = xs.requires_grad
        ctx.mb = dict(size=xs.shape[1:], dtype=xs.dtype, device=xs.device)
        return outs

    @staticmethod
    def backward(ctx, grad):
        mesh, axis = ctx.mesh, ctx.axis
        S, M = mesh.shape[axis], grad.shape[0]
        group = mesh.group(axis)
        stage = mesh.axis_index(axis)
        grad = ring_all_reduce(grad.contiguous(), group)[0]
        names = [k for k, v in ctx.block.items() if v.requires_grad]
        sums = dict.fromkeys(names)
        gx = torch.zeros_like(grad) if ctx.x_grad else None
        zero = torch.zeros(**ctx.mb)
        g_in = zero      # the gradient of this stage's input at tick t + 1
        for t in reversed(range(M + S - 1)):
            g_y = (exchange(g_in, torch.empty(**ctx.mb), (stage - 1) % S,
                            (stage + 1) % S, group) if S > 1 else zero)
            g_in = zero
            if t not in ctx.ticks:
                continue
            mb = t - stage
            if stage == S - 1:
                g_y = g_y + grad[mb]
            inp, y = ctx.ticks.pop(t)
            wrt = [ctx.block[k] for k in names] + (
                [inp] if inp.requires_grad else [])
            gs = (torch.autograd.grad(y, wrt, g_y, allow_unused=True)
                  if wrt else ())
            for k, g in zip(names, gs):
                if g is not None:
                    sums[k] = g if sums[k] is None else sums[k] + g
            if inp.requires_grad:
                if stage > 0:
                    g_in = gs[-1]
                else:
                    gx[mb] = gs[-1]
        return (None, None, None, None, None, gx,
                *(sums.get(k) for k in ctx.block))


def pipeline_apply(stage_fn: Callable, stage_params: dict,
                   x_microbatches: torch.Tensor, mesh,
                   axis: str = "stage") -> torch.Tensor:
    """Run microbatches through the S pipeline stages of ``mesh``'s
    ``axis``; every rank of the stage group calls it, with the same
    tensors needing a gradient, and under autograd runs its backward (see
    the module note).

    stage_fn(stage_params, x) -> x     (one stage's layers)
    stage_params: this rank's block ({name: [1, ...]}, ``stage_block``)
    x_microbatches: [M, mb, ...] activations, the same on every stage
    Returns the [M, mb, ...] outputs of the last stage, on every stage."""
    names = list(stage_params)
    params = [stage_params[k] for k in names]
    keep = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x_microbatches, *params))
    return _Pipeline.apply(stage_fn, mesh, axis, names, keep, x_microbatches,
                           *params)


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
