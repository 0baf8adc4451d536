"""Meshes of ranks, and a multi-process world of W ranks, each traced by
its own FLARE daemon.

The counterpart of the JAX package's ``launch/mesh.py``: where JAX fakes W
devices in one process, here W ranks are W processes joined in one
``torch.distributed`` gloo group.  The meshes laid over them
(``Mesh``, ``make_mesh``, ``make_test_mesh``, ``make_production_mesh``,
``dp_axes``) live in ``parallel/mesh.py`` and are re-exported here.

    results = run_ranks(fn, 4, *args, device="cuda", timeout=120.0)

runs ``fn(ctx, *args)`` in each rank and returns the W results in rank
order.  ``fn`` is a module-level function (processes are ``spawn``ed, so
it is pickled by its import path, and so are ``args`` and the results).
Each rank:
  * uses ``cuda:(rank mod device count)`` unless ``device="cpu"`` is asked
    for; several ranks may share one card;
  * joins the gloo group through a file store in a temporary directory, so
    no port is fixed;
  * runs with ``TracingDaemon(DaemonConfig(rank=r, log_path=...))``
    attached, which spills to ``log_dir/rank{r}.jsonl`` when ``log_dir``
    is given.
On CUDA the collectives' kernel is built in the parent before the ranks
start, so that W processes do not race to build the same library.  Every
wait has a deadline: on an error in any rank, or at ``timeout``, every
rank still running is terminated and ``run_ranks`` raises.

Two rank bodies of the ring path live here: :func:`allreduce_rank`, a
traced data-parallel bucket all-reduce checked against the plain ring
order, and :func:`hang_rank`, the hang drill that breaks one ring link
and reads every rank's live ring progress through the daemon's hang
callback.
"""
from __future__ import annotations

import datetime
import itertools
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.core.daemon import DaemonConfig, TracingDaemon
from repro_torch.kernels import build_all
from repro_torch.kernels.ring_reduce.ops import KERNEL as COMBINE_KERNEL
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.mesh import (  # noqa: F401  (re-exported)
    Mesh, dp_axes, make_mesh, make_production_mesh, make_test_mesh)


@dataclass
class RankContext:
    rank: int
    world_size: int
    device: torch.device
    daemon: TracingDaemon


def _rank_main(fn, rank, world_size, store, device_type, log_dir, timeout,
               args, results):
    try:
        if device_type == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout))
        log_path = (str(Path(log_dir) / f"rank{rank}.jsonl") if log_dir
                    else None)
        daemon = TracingDaemon(DaemonConfig(rank=rank, backend="ring",
                                            log_path=log_path)).attach()
        try:
            out = fn(RankContext(rank, world_size, device, daemon), *args)
        finally:
            daemon.detach()
        results.put((rank, True, out))
        dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world_size: int, *args, device: str = "cuda",
              timeout: float = 120.0, log_dir: Optional[str] = None) -> list:
    """Run ``fn(ctx, *args)`` in ``world_size`` spawned ranks; returns their
    results in rank order, or raises (see the module note)."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"run_ranks: device must be 'cuda' or 'cpu', not "
                         f"{device!r}")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("run_ranks: no CUDA device; pass device='cpu' "
                               "to run the ranks on the CPU")
        build_all([COMBINE_KERNEL])
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory(prefix="flare-mesh-") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, name=f"flare-rank{r}",
                             args=(fn, r, world_size, store, device, log_dir,
                                   timeout, args, results))
                 for r in range(world_size)]
        try:
            for p in procs:
                p.start()
            out = {}
            while len(out) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"run_ranks: ranks {sorted(set(range(world_size)) - set(out))} "
                        f"not done within {timeout} s")
                try:
                    rank, ok, res = results.get(timeout=min(left, 0.5))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"run_ranks: rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} without a result")
                    continue
                if not ok:
                    raise RuntimeError(f"run_ranks: rank {rank} failed:\n{res}")
                out[rank] = res
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
            return [out[r] for r in range(world_size)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(5.0)
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
            results.close()


# --------------------------------------------------------------------------- #
# rank bodies of the ring path
# --------------------------------------------------------------------------- #
def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _bucket(numel: int, seed: int, rank: int,
            device: torch.device) -> torch.Tensor:
    """Rank ``rank``'s fp32 gradient bucket: ``numel`` normal draws from
    ``seed``, distinct per rank, made on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed * 1009 + rank)
    return torch.randn(numel, generator=gen, device=device)


def allreduce_rank(ctx: RankContext, numel: int, seed: int,
                   step: int = 0) -> dict:
    """One data-parallel bucket all-reduce in traced step ``step``: this
    rank's fp32 bucket through ``ring_all_reduce``, checked bit for bit
    against ``ring_reduce_ref`` of every rank's bucket (each rank draws all
    W).  Returns the check, this rank's progress, the ring-combine kernel's
    launches in the all-reduce (0 on the CPU, where the plain version runs)
    and its wall time."""
    n, dev = ctx.world_size, ctx.device
    x = _bucket(numel, seed, ctx.rank, dev)
    daemon = ctx.daemon
    daemon.step_begin(step)
    daemon.set_stack([f"step_{step}", "ring_all_reduce"])
    _sync(dev)
    COMBINE_KERNEL.launches = 0
    t0 = time.perf_counter()
    out, progress = coll.ring_all_reduce(x)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = COMBINE_KERNEL.launches
    daemon.step_end(bytes=x.numel() * x.element_size())
    want = coll.ring_reduce_ref([_bucket(numel, seed, r, dev)
                                 for r in range(n)])
    diff = (out - want).abs()
    return dict(rank=ctx.rank, numel=numel,
                bitwise_equal=bool(torch.equal(out, want)),
                max_abs_err=float(diff.max()),
                finite=bool(out.isfinite().all()),
                progress=progress.tolist(), launches=launches, wall_s=wall)


def drop_sends_from(transport: Callable, from_step: int) -> Callable:
    """A ring transport that sends nothing from its ``from_step``-th call
    on (counted from 0) and receives as before: installed in one rank, it
    breaks that rank's link to its right neighbour from that ring step."""
    calls = itertools.count()

    def broken(send, recv, dst, src, group=None):
        if next(calls) >= from_step:
            send = None
        return transport(send, recv, dst, src, group)
    return broken


# the hang drill: links broken (rank f drops its sends to f + 1), from
# which ring step, the size of the all-reduce, the drill group's timeout
# (when the stalled receives end) and the daemon's silence before it calls
# its hang callback (s)
HANG_FAULTS = (0, 2)
HANG_FROM_STEP = 1
HANG_NUMEL = 4096
HANG_GROUP_TIMEOUT = 2.0
HANG_TIMEOUT = 0.25


def hang_rank(ctx: RankContext) -> list:
    """The hang drill, in steps 1, 2, ... of this rank's daemon.  For each
    rank f in ``HANG_FAULTS``, a fresh gloo group runs
    ``ring_all_reduce_local`` inside a daemon step, with rank f's sends on
    link f -> f+1 dropped from ring step ``HANG_FROM_STEP``.  The ring
    stalls; the daemon (``HANG_TIMEOUT`` of silence) calls its ``on_hang``
    callback, which publishes the ring steps this rank has completed as
    the device shows them: the reduce-scatter steps whose combine counters
    (pinned, written by the kernel) are complete, plus the all-gather steps
    done, beside the host's own step count and the frozen counters.  The
    stalled receives end at the group's timeout.  Returns, per fault, the
    last published values, the daemon's hang report (with the published
    stack) and the error that ended the collective."""
    n, daemon = ctx.world_size, ctx.daemon
    transport = coll.exchange
    timeout0 = daemon.cfg.hang_timeout
    x = torch.ones(HANG_NUMEL, device=ctx.device)
    drills = []
    for i, fault in enumerate(HANG_FAULTS):
        group = dist.new_group(backend="gloo", timeout=datetime.timedelta(
            seconds=HANG_GROUP_TIMEOUT))
        progress = torch.zeros(2 * max(n - 1, 1), dtype=torch.int32)
        counters = coll.combine_counters(x, n)
        seen: dict = {"reports": 0}

        def publish(report, progress=progress, counters=counters, seen=seen):
            blocks = counters.clone()
            full = torch.arange(1, blocks.shape[1] + 1, dtype=torch.int32)
            combined = int((blocks == full).all(1).sum())
            seen.update(steps=combined + int(progress[len(blocks):].sum()),
                        host_steps=int(progress.sum()),
                        counters=blocks.tolist(), report=report,
                        reports=seen["reports"] + 1)

        step = 1 + i
        error = None
        daemon.cfg.hang_timeout = HANG_TIMEOUT   # read at every heartbeat
        daemon.on_hang(publish)
        if ctx.rank == fault:
            coll.exchange = drop_sends_from(transport, HANG_FROM_STEP)
        try:
            daemon.step_begin(step)
            daemon.set_stack([f"step_{step}", "ring_all_reduce"])
            t0 = time.perf_counter()
            try:
                coll.ring_all_reduce_local(x, group, progress=progress,
                                           counters=counters)
            except RuntimeError as e:   # the stalled receive's timeout
                error = f"{type(e).__name__}: {str(e)[:200]}"
            seconds = time.perf_counter() - t0
            daemon.step_end()
        finally:
            coll.exchange = transport
            daemon.on_hang(None)
            daemon.cfg.hang_timeout = timeout0
        drills.append(dict(fault=fault, from_step=HANG_FROM_STEP,
                           steps=seen.get("steps"),
                           host_steps=seen.get("host_steps"),
                           counters=seen.get("counters"),
                           steps_at_end=int(progress.sum()),
                           report=seen.get("report"),
                           reports=seen["reports"], error=error,
                           seconds=seconds))
        dist.barrier()    # every rank is out of this drill
    return drills
