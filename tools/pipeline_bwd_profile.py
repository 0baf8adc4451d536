#!/usr/bin/env python3
"""Where the llama3.2-1b pipeline's backward spends its wall on the card.

    python3 tools/pipeline_bwd_profile.py

On one CUDA card, 4 ranks (``launch/mesh.py``, gloo through pinned host
memory) run ``chip_smoke.py``'s pipeline path at its shapes (4 stages of
4 layers, M 8 x [1, 1024], bf16) twice: the forward alone, then the
forward with autograd's graph kept and its backward (``pipeline_apply``
under autograd, the convention's seed and sum): the rank's first
backward, a second, and a third with the tracing daemon detached.
Around the parts of ``parallel/pipeline.py`` each rank times, with the
card synchronised at both ends: the ring ``exchange``s, the ring
all-reduces, the stage functions and the vjps (``torch.autograd.grad``);
beside them one stage's vjp taken on the main thread, outside a
backward.  Rank 0's third backward runs under ``torch.profiler`` (its
ops by CPU time).  Prints each rank's walls and part totals, with the
card's name and power limit first.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def timed(fn, name: str, totals: dict):
    import torch

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        n, s = totals.get(name, (0, 0.0))
        totals[name] = (n + 1, s + time.perf_counter() - t0)
        return out
    return wrapper


def profile_rank(ctx, seed: int) -> dict:
    import torch
    import chip_smoke as cs
    from repro_torch.parallel import pipeline as pp
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.parallel.sharding import Spec, replicas, sum_replicated

    mesh = make_mesh((cs.PIPE_STAGES,), ("stage",))
    cfg, state, a = cs.pipe_inputs(seed, ctx.device)
    block = pp.stage_block(pp.stack_block_params(state, cfg,
                                                 cs.PIPE_STAGES), mesh)
    del state
    positions = torch.arange(cs.PIPE_S, device=ctx.device)[None, :]
    totals: dict = {}
    fn = timed(pp.block_stage(cfg, positions), "stage_fn", totals)
    pp.exchange = timed(pp.exchange, "exchange", totals)
    pp.ring_all_reduce = timed(pp.ring_all_reduce, "ring_all_reduce",
                               totals)
    grad = torch.autograd.grad
    torch.autograd.grad = timed(grad, "autograd.grad", totals)
    c = cs.par_cotangent(tuple(a.shape), seed + 5, ctx.device)
    out = {}
    for tag in ("forward", "forward", "backward, first", "backward",
                "backward, no daemon"):
        totals.clear()
        if tag == "backward, no daemon":
            ctx.daemon.detach()
        torch.distributed.barrier()
        torch.cuda.synchronize()
        prof = None
        if tag == "backward, no daemon" and ctx.rank == 0:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        if tag == "forward":
            with torch.no_grad():
                pp.pipeline_apply(fn, block, a, mesh)
        else:
            for v in block.values():
                v.grad = None
                v.requires_grad_()
            a.grad = None
            a.requires_grad_()
            o = pp.pipeline_apply(fn, block, a, mesh)
            ((o * c).sum() / replicas(Spec(), mesh)).backward()
            sum_replicated(a.grad, Spec(), mesh)
        torch.cuda.synchronize()
        out[tag] = dict(wall_s=time.perf_counter() - t0,
                        parts={k: (n, round(s, 4))
                               for k, (n, s) in totals.items()})
        if prof is not None:
            prof.__exit__(None, None, None)
            out["profile"] = prof.key_averages().table(
                sort_by="cpu_time_total", row_limit=30)
    torch.autograd.grad = grad
    # one stage's vjp on the main thread, outside a backward
    inp = a[0].detach().requires_grad_()
    params = list(block.values())
    for _ in range(2):
        with torch.enable_grad():
            y = fn({k: v[0] for k, v in block.items()}, inp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grad(y, [inp] + params, c[0])
        torch.cuda.synchronize()
        out["one vjp, main thread"] = dict(
            wall_s=time.perf_counter() - t0, parts={})
    return out


def main():
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build_all
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.fused_norm import ops as fn
    from repro_torch.kernels.ring_reduce import ops as ring
    from repro_torch.launch.mesh import run_ranks

    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    build_all([fa.KERNELS["wgmma"], fa.BWD_KERNELS["wgmma"], fn.KERNEL,
               fn.BWD_KERNEL, ring.KERNEL])
    for r, res in enumerate(run_ranks(profile_rank, cs.PAR_WORLD, 0,
                                      timeout=600.0)):
        table = res.pop("profile", None)
        for tag, x in res.items():
            cs.log("pipeline", f"rank {r} {tag}: wall {x['wall_s']:.3f} s; "
                   f"parts (calls, s) {x['parts']}")
        if table:
            print(table, flush=True)


if __name__ == "__main__":
    main()
