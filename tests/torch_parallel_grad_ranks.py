"""Rank bodies of ``tests/test_torch_parallel_grad.py`` (a module of its
own, so that spawned ranks import it without the test file's JAX
imports).

Each case runs under ``_case``, which keeps a failing case's traceback as
its result, so that one case's fault is reported by that case's test.
The gradient convention is ``parallel/collectives.py``'s: a loss held by
k ranks is seeded with 1 / k, and a replicated tensor's gradient is summed
over the axes it is replicated on (``sharding.sum_replicated``)."""
import datetime
import time
import traceback
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import rmsnorm
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import pipeline as pp
from repro_torch.parallel.mesh import make_mesh, make_test_mesh

COLLECTIVES = ("permute", "reduce_scatter", "all_gather_0", "all_gather_1",
               "all_reduce", "all_reduce_any")
EP_CASES = {"ep14": ((1, 4), "dbrx"), "ep14_drop": ((1, 4), "dbrx_drop"),
            "ep22": ((2, 2), "dbrx"), "ep22_drop": ((2, 2), "dbrx_drop")}
HANG_FAULTS = (0, 2)


def _t(a, grad: bool = False) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _np(t):
    return None if t is None else t.detach().numpy()


def _case(out: dict, tag: str, fn):
    try:
        out[tag] = fn()
    except Exception:
        out[tag] = {"error": traceback.format_exc()}


def fault(rank: int, group) -> dict:
    """The ring all-reduce's fault on 2 ranks: w = rank + 1 everywhere, the
    loss (ring_all_reduce(2w)·arange(8)).sum() held by both ranks, so each
    seeds it with 1/2; w.grad must be 2·arange(8) on each."""
    w = torch.full((8,), rank + 1.0, requires_grad=True)
    y = coll.ring_all_reduce(2 * w, group)[0]
    loss = (y * torch.arange(8.0)).sum()
    (loss / 2).backward()
    return dict(y=_np(y), grad=_np(w.grad))


def collective(name: str, x: torch.Tensor, group) -> torch.Tensor:
    """One collective of ``COLLECTIVES`` on this rank's ``x``."""
    r, n = dist.get_rank(group), dist.get_world_size(group)
    if name == "permute":
        return coll.exchange(x, torch.empty_like(x), (r + 1) % n,
                             (r - 1) % n, group)
    if name == "reduce_scatter":
        return coll.ring_reduce_scatter_local(x, group)[0]
    if name.startswith("all_gather_"):
        return coll.ring_all_gather_local(x, group, int(name[-1]))[0]
    if name == "all_reduce":
        return coll.ring_all_reduce_local(x, group)[0]
    return coll.ring_all_reduce(x, group)[0]


def collectives(rank: int, inputs: dict, group) -> dict:
    """Each collective's gradient: this rank's loss is its own output
    against its own cotangent (not replicated, so seeded with 1)."""
    out = {}
    for name in COLLECTIVES:
        x = _t(inputs[name][rank], True)
        y = collective(name, x, group)
        (y * _t(inputs[name + "_c"][rank])).sum().backward()
        out[name] = _np(x.grad)
    return out


def _moe(state: dict):
    return SimpleNamespace(**{k.rsplit(".", 1)[-1]: v
                              for k, v in state.items()})


def expert_parallel(ctx, mesh, cfg, moe_state: dict, x_all) -> dict:
    """``moe_apply`` on ``mesh``: loss sum(tanh(y)) of this data shard
    (held by its n model ranks) plus aux (held by every rank); then each
    gradient summed over its replicated axes."""
    from repro_torch.parallel.sharding import (Spec, param_specs, replicas,
                                               sum_replicated)
    coords = mesh.coords(ctx.rank)
    state = moe_lib.shard_experts({k: _t(v) for k, v in moe_state.items()},
                                  mesh, coords)
    state = {k: v.requires_grad_() for k, v in state.items()}
    x = _t(x_all).chunk(mesh.shape["data"])[coords[0]].requires_grad_()
    y, aux = moe_lib.moe_apply(_moe(state), x, cfg, lambda w: w, mesh)
    loss = (torch.tanh(y).sum() / replicas(Spec("data"), mesh)
            + aux / replicas(Spec(), mesh))
    loss.backward()
    specs = param_specs({k: tuple(v.shape) for k, v in state.items()})
    grads = {k: _np(sum_replicated(v.grad, specs[k], mesh))
             for k, v in state.items()}
    grads["x"] = _np(sum_replicated(x.grad, Spec("data"), mesh))
    return dict(coords=coords, y=_np(y), aux=float(aux), grads=grads)


def context_parallel(mesh, case: dict) -> dict:
    """``context_parallel_attention`` on (data 1, model 4): the output is
    whole on every rank, so the loss (o·c).sum() is seeded with 1/4; q, k
    and v are whole on every rank, their gradients summed."""
    from repro_torch.parallel.sharding import Spec, replicas, sum_replicated
    q, k, v = (_t(case[n], True) for n in ("q", "k", "v"))
    o = attn_lib.context_parallel_attention(
        q, k, v, mesh, causal=True, q_offset=case["q_offset"],
        q_chunk=case["q_chunk"], kv_chunk=case["kv_chunk"])
    ((o * _t(case["c"])).sum() / replicas(Spec(), mesh)).backward()
    return {n: _np(sum_replicated(t.grad, Spec(), mesh))
            for n, t in (("q", q), ("k", k), ("v", v))}


def tanh_pipeline(mesh, inputs: dict) -> dict:
    """The tanh pipeline on 4 stages: each stage holds its own w, the
    microbatches are whole on every stage."""
    from repro_torch.parallel.sharding import Spec, replicas, sum_replicated
    block = {k: v.requires_grad_() for k, v in pp.stage_block(
        {"w": _t(inputs["ws"])}, mesh).items()}
    xs = _t(inputs["xs"], True)
    out = pp.pipeline_apply(lambda sp, x: torch.tanh(x @ sp["w"]), block, xs,
                            mesh)
    ((out * _t(inputs["xs_c"])).sum() / replicas(Spec(), mesh)).backward()
    return dict(out=_np(out), w=_np(block["w"].grad),
                xs=_np(sum_replicated(xs.grad, Spec(), mesh)))


def llama_pipeline(mesh, inputs: dict, state: dict, cfg) -> dict:
    """The reduced llama's blocks on 2 stages: this stage's block of the
    stacked parameters, the embeddings x and the first norm's scale (both
    whole on every stage) as leaves; the packed (h, x) pairs through the
    pipeline, the loss (out·c).sum() seeded with 1/2."""
    from repro_torch.parallel.sharding import Spec, replicas, sum_replicated
    state = {k: _t(v) for k, v in state.items()}
    block = {k: v.requires_grad_() for k, v in pp.stage_block(
        pp.stack_block_params(state, cfg, mesh.shape["stage"]),
        mesh).items()}
    x = _t(inputs["emb"], True)                       # [M, mb, S, D]
    ln1 = state["layers.0.ln1.scale"].requires_grad_()
    a = torch.stack([rmsnorm(ln1, x, cfg.norm_eps), x], dim=1)
    positions = torch.arange(x.shape[2])[None, :]
    out = pp.pipeline_apply(pp.block_stage(cfg, positions), block, a, mesh)
    ((out * _t(inputs["emb_c"])).sum() / replicas(Spec(), mesh)).backward()
    grads = {k: _np(v.grad) for k, v in block.items()}
    grads["x"] = _np(sum_replicated(x.grad, Spec(), mesh))
    grads["ln1"] = _np(sum_replicated(ln1.grad, Spec(), mesh))
    return dict(out=_np(out), grads=grads, stage=mesh.axis_index("stage"))


def backward_hang(ctx) -> list:
    """The hang drill on a backward: for each rank f of ``HANG_FAULTS``, a
    fresh gloo group runs ``ring_all_reduce_local`` forward, then, with
    rank f's sends dropped from ring step ``HANG_FROM_STEP`` of the
    backward's reduce-scatter on, its backward inside a daemon step.  The
    ring stalls; the daemon's ``on_hang`` callback publishes the backward's
    own progress as the device shows it (the reduce-scatter steps whose
    combine counters are complete, plus the all-gather steps done), beside
    the host's step count and the frozen counters.  The stalled receives
    end at the group's timeout."""
    n, daemon = ctx.world_size, ctx.daemon
    transport = coll.exchange
    timeout0 = daemon.cfg.hang_timeout
    drills = []
    # ranks 2 and 3 skip the llama pipeline that ranks 0 and 1 run just
    # before: the drill's group connects within its timeout only if every
    # rank starts it at once
    dist.barrier()
    for i, f in enumerate(HANG_FAULTS):
        group = dist.new_group(backend="gloo", timeout=datetime.timedelta(
            seconds=launch_mesh.HANG_GROUP_TIMEOUT))
        x = torch.ones(launch_mesh.HANG_NUMEL, requires_grad=True)
        progress = torch.zeros(2 * (n - 1), dtype=torch.int32)
        counters = coll.combine_counters(x, n)
        y, forward = coll.ring_all_reduce_local(
            x, group, grad_progress=progress, grad_counters=counters)
        loss = y.sum()
        seen: dict = {"reports": 0}

        def publish(report, progress=progress, counters=counters, seen=seen):
            blocks = counters.clone()
            full = torch.arange(1, blocks.shape[1] + 1, dtype=torch.int32)
            combined = int((blocks == full).all(1).sum())
            seen.update(steps=combined + int(progress[len(blocks):].sum()),
                        host_steps=int(progress.sum()),
                        counters=blocks.tolist(), report=report,
                        reports=seen["reports"] + 1)

        step = 10 + i
        error = None
        daemon.cfg.hang_timeout = launch_mesh.HANG_TIMEOUT
        daemon.on_hang(publish)
        if ctx.rank == f:
            coll.exchange = launch_mesh.drop_sends_from(
                transport, launch_mesh.HANG_FROM_STEP)
        try:
            daemon.step_begin(step)
            daemon.set_stack([f"step_{step}", "backward",
                              "ring_all_reduce_backward"])
            t0 = time.perf_counter()
            try:
                loss.backward()
            except RuntimeError as e:   # the stalled receive's timeout
                error = f"{type(e).__name__}: {str(e)[:200]}"
            seconds = time.perf_counter() - t0
            daemon.step_end()
        finally:
            coll.exchange = transport
            daemon.on_hang(None)
            daemon.cfg.hang_timeout = timeout0
        drills.append(dict(fault=f, forward=forward.tolist(),
                           steps=seen.get("steps"),
                           host_steps=seen.get("host_steps"),
                           counters=seen.get("counters"),
                           steps_at_end=int(progress.sum()),
                           report=seen.get("report"),
                           reports=seen["reports"], error=error,
                           seconds=seconds))
        dist.barrier()    # every rank is out of this drill
    return drills


def meta_backward(group) -> dict:
    """On meta tensors under the op analysis, an all-gather and an
    all-reduce and their backwards: each backward records its collective
    (a reduce-scatter, an all-reduce) as its forward does."""
    from repro_torch.launch.op_analysis import analyze

    def step(x):
        y = coll.ring_all_gather_local(x, group)[0]
        coll.ring_all_reduce_local(y, group)[0].sum().backward()

    stats = analyze(step, torch.empty((6, 4), device="meta",
                                      requires_grad=True))
    return stats["collectives"]


def grad_rank(ctx, inputs: dict, moe_state: dict, llama_state: dict,
              cfgs: dict, cp_cases: list) -> dict:
    """Every case on 4 gloo ranks; each rank connects the meshes in one
    order, and a rank outside a mesh skips its case."""
    meshes = dict(pair=make_mesh((2,), ("pair",)),
                  m14=make_test_mesh(data=1, model=4),
                  m22=make_test_mesh(data=2, model=2),
                  p4=make_mesh((4,), ("stage",)),
                  p2=make_mesh((2,), ("stage",)))
    r, out = ctx.rank, {}
    if meshes["pair"].member:
        _case(out, "fault", lambda: fault(r, meshes["pair"].group("pair")))
    m14 = meshes["m14"]
    _case(out, "collectives",
          lambda: collectives(r, inputs, m14.group("model")))
    _case(out, "meta", lambda: meta_backward(m14.group("model")))
    for tag, (shape, cfg) in EP_CASES.items():
        mesh = m14 if shape == (1, 4) else meshes["m22"]
        _case(out, tag, lambda: expert_parallel(
            ctx, mesh, cfgs[cfg], moe_state, inputs["moe_x"]))
    for i, case in enumerate(cp_cases):
        _case(out, f"cp{i}", lambda: context_parallel(m14, case))
    _case(out, "pipe_tanh", lambda: tanh_pipeline(meshes["p4"], inputs))
    if meshes["p2"].member:
        _case(out, "pipe_llama", lambda: llama_pipeline(
            meshes["p2"], inputs, llama_state, cfgs["llama"]))
    _case(out, "hang", lambda: backward_hang(ctx))
    return out
