"""Device-timeline + cluster simulator (stream semantics, Fig 7).

The diagnostic engine consumes *event streams*; this module produces them
for an N-rank cluster with exact GPU-stream semantics:

    issue_ts   = per-rank CPU dispatch time (bounded run-ahead queue)
    exec_start = max(issue_ts, device_free)          [compute]
    exec_start = max over group of per-rank ready    [collectives]

so kernel-issue stalls (GC, unnecessary sync), fail-slows (underclock,
jitter), void time (uninstrumented kernels, slow dataloader) and hangs all
reproduce the paper's timeline behaviour deterministically — at 1024+
simulated ranks on one host.  A real fleet feeds the same engine from the
per-process daemons instead; nothing in the engine knows which source it is.

Fault injection is PLUGGABLE (``repro_torch.core.injectors``): every
``Injection`` resolves through the injector registry to a
:class:`~repro_torch.core.injectors.FaultInjector` whose hooks this loop drives
at fixed points — host pre-op stalls, cpu/device duration transforms,
minority device time, post-collective sync, hang triggers.  The nine
legacy kinds are themselves registered plugins, byte-equivalent to the
historical inline if-chain; the L4 production taxonomy (checkpoint
storms, ECC throttling, network flaps, MoE stragglers, serving
interference) and any site-specific fault register the same way.

The port's copy of the JAX package's ``core/timeline.py``: numpy only (no
torch), with the reference's names, RNG draw order and event columns, so
a seeded simulation emits the reference's ``EventBatch`` bit for bit.
Two differences, both declared: ``program_from_config`` defaults to the
H100's ceilings, and the ``sync_after_comm`` injector's span is named
``torch.cuda@synchronize`` (``repro_torch.core.injectors.builtins``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.configs import ModelConfig
from repro_torch.core.columnar import EventBatch, EventBatchBuilder
from repro_torch.core.events import EventKind, TraceEvent
from repro_torch.core.injectors import (  # noqa: F401
    FaultInjector, Injection, resolve_injections)

# ----------------------------------------------------------------------- #
# Program model
# ----------------------------------------------------------------------- #
@dataclass(frozen=True)
class SimOp:
    name: str
    kind: str                      # compute | comm | cpu
    duration: float                # seconds (healthy)
    flops: float = 0.0
    bytes: int = 0
    group: str = "dp"              # comm group id (comm ops)
    cpu_overhead: float = 20e-6    # host time to issue this op
    meta: dict = field(default_factory=dict)  # e.g. {"shape": (8192, 8484)}


def program_from_config(cfg: ModelConfig, *, tokens_global: int = 262144,
                        num_chips: int = 32, layer_groups: int = 8,
                        mfu: float = 0.45, chip_flops: float = 989e12,
                        link_bw: float = 5e10,
                        moe_experts: int = 0) -> list[SimOp]:
    """Per-chip, per-step op program whose durations follow the arch FLOPs.

    The model+batch are sharded over ``num_chips``; durations/flops/bytes
    are the per-chip share, so issue-latency scales stay realistic.
    ``moe_experts > 0`` splits each MoE group's FFN share into that many
    per-expert kernels (``moe_ffn[g].expert{e}``) for expert-skew
    scenarios; it is ignored for non-MoE architectures.

    The ceilings default to one NVIDIA H100 80GB HBM3, 700 W (SXM) in an
    8-GPU node.  ``chip_flops=989e12``: the H100 SXM's dense bf16 tensor
    peak (NVIDIA H100 Tensor Core GPU datasheet), the figure the port's
    MFU divides by.  ``link_bw=5e10``: 400 Gb/s, one NDR InfiniBand port
    per GPU (NVIDIA ConnectX-7, as in a DGX H100); the simulated
    data-parallel group of 32-1024 ranks spans nodes, so its ring
    all-reduce is bounded by the inter-node link, not by NVLink.  Both
    are datasheet constants, not measurements.  ``mfu=0.45`` is the
    reference's assumption of achieved efficiency, not a measurement.
    """
    n_active = cfg.active_param_count()
    step_flops = 6.0 * n_active * tokens_global / num_chips
    per_group = step_flops / layer_groups
    ops: list[SimOp] = [SimOp("dataloader.next_batch", "cpu", 1e-3)]
    # split each group: attention-ish op (40%), ffn-ish op (60%), one comm
    comm_bytes = int(2 * 2 * n_active / (layer_groups * num_chips))
    experts = moe_experts if cfg.num_experts else 0
    for g in range(layer_groups):
        ops.append(SimOp(f"attn_core[{g}]", "compute",
                         0.4 * per_group / (chip_flops * mfu),
                         flops=0.4 * per_group))
        if experts:
            share = 0.6 * per_group / experts
            for e in range(experts):
                ops.append(SimOp(f"moe_ffn[{g}].expert{e}", "compute",
                                 share / (chip_flops * mfu), flops=share))
        else:
            ops.append(SimOp(f"ffn_matmul[{g}]", "compute",
                             0.6 * per_group / (chip_flops * mfu),
                             flops=0.6 * per_group,
                             meta={"shape": (8192, cfg.d_ff or 8192)}))
        ops.append(SimOp(f"allreduce[{g}]", "comm",
                         comm_bytes / link_bw, bytes=comm_bytes, group="dp"))
    ops.append(SimOp("optimizer.update", "compute",
                     0.02 * step_flops / (chip_flops * mfu),
                     flops=0.02 * step_flops))
    return ops


@dataclass
class HangSnapshot:
    step: int
    op_index: int
    op_name: str
    comm: bool
    stacks: dict                     # rank -> list[str]
    ring_progress: Optional[np.ndarray]  # per-rank completed ring steps
    group_ranks: list
    truth_rank: int                  # ground truth (for tests/benchmarks)


# ----------------------------------------------------------------------- #
# Simulator
# ----------------------------------------------------------------------- #
class ClusterSimulator:
    def __init__(self, num_ranks: int, program: list[SimOp], *,
                 seed: int = 0, queue_depth: int = 4096,
                 injections: list[Injection] | None = None,
                 ring_total_steps: int | None = None):
        self.n = num_ranks
        self.program = program
        self.rng = np.random.default_rng(seed)
        self.queue_depth = queue_depth
        self._injectors = resolve_injections(injections)
        self.injections = [h.inj for h in self._injectors
                           if h.inj is not None]
        self.ring_total_steps = ring_total_steps or 2 * (num_ranks - 1)
        self.hang: Optional[HangSnapshot] = None

    # ------------------------------------------------------------------ #
    def run(self, num_steps: int) -> dict[int, list[TraceEvent]]:
        """Legacy per-event view; delegates to the columnar fast path."""
        return self.run_batch(num_steps).to_events_by_rank()

    def hit_ranks(self, inj: Injection) -> np.ndarray:
        """The rank-index vector an injection targets (empty = all) —
        deduped/bounded, the way the legacy emitter membership-tested."""
        if not inj.ranks:
            return np.arange(self.n)
        return np.asarray(sorted({r for r in inj.ranks if 0 <= r < self.n}),
                          np.int64)

    _hit_ranks = hit_ranks          # pre-registry spelling (back-compat)

    def run_batch(self, num_steps: int) -> EventBatch:
        """Emit the trace as an ``EventBatch``: whole rank-vectors per op,
        no per-rank Python loops.  Injector hooks run in injection-list
        order at every hook point, and vector draws consume the same
        PCG64 stream as the scalar draws they replaced — so for the
        legacy kinds, timestamps (and therefore every diagnosis) are
        bit-for-bit identical to the historical inline emitter."""
        n = self.n
        all_ranks = np.arange(n)
        b = EventBatchBuilder()
        cpu = np.zeros(n)
        gpu = np.zeros(n)
        ring = np.zeros((n, max(self.queue_depth, 1)))  # issue-queue ends
        qi = 0

        for step in range(num_steps):
            step_t0 = cpu.copy()
            for oi, op in enumerate(self.program):
                inj_hang = self._hang_at(step, oi, op)
                if inj_hang is not None:
                    self._finalize_hang(b, step, oi, op, inj_hang, cpu, gpu)
                    return b.build()
                # ---- host-side pre-op stalls (GC / sync / storms) ------ #
                for h in self._injectors:
                    h.pre_op(self, b, step, oi, op, cpu)
                # ---- issue-queue bound (CPU can't run ahead forever) --- #
                cpu = np.maximum(cpu, ring[:, qi % ring.shape[1]])
                # ---- per-op host overhead ------------------------------ #
                over = op.cpu_overhead * (0.5 + self.rng.random(n))
                issue = cpu + over
                cpu = issue.copy()

                if op.kind == "cpu":
                    dur = self._cpu_duration(op, step)
                    is_dl = "dataloader" in op.name
                    b.append_block(
                        EventKind.DATALOADER if is_dl else EventKind.PY_API,
                        op.name, all_ranks, issue, issue, issue + dur, step,
                        tokens=self.program_tokens() if is_dl else None)
                    cpu = issue + dur
                    continue

                dur = self._device_duration(op, step)
                if op.kind == "compute":
                    start = np.maximum(issue, gpu)
                    end = start + dur
                    gpu = end
                else:  # collective: starts when every rank is ready
                    ready = np.maximum(issue, gpu)
                    start_all = float(ready.max())
                    start = np.full(n, start_all)
                    end = start + float(dur.max())
                    gpu = end.copy()
                # uninstrumented minority kernels occupy the device silently
                gpu = gpu + self._minority_time(op, step)
                ring[:, qi % ring.shape[1]] = end
                qi += 1
                if op.kind == "compute":
                    b.append_block(
                        EventKind.KERNEL_COMPUTE, op.name, all_ranks,
                        issue, start, end, step,
                        flops=op.flops if op.flops else None,
                        extra=op.meta or None)
                else:
                    b.append_block(
                        EventKind.KERNEL_COMM, op.name, all_ranks,
                        issue, start, end, step,
                        nbytes=op.bytes, group=op.group,
                        extra=op.meta or None)
                # ---- post-collective host behavior (Case-1 sync) ------- #
                if op.kind == "comm":
                    for h in self._injectors:
                        h.post_comm(self, b, step, op, cpu, end)
            # ---- step event per rank ------------------------------------ #
            step_end = np.maximum(cpu, gpu)
            b.append_block(EventKind.STEP, f"step_{step}", all_ranks,
                           step_t0, step_t0, step_end, step,
                           tokens=self.program_tokens())
            # step-boundary sync: the loop reads back loss/metrics, so the
            # CPU drains to the device each step (bounds run-ahead; makes
            # healthy issue latencies spread ~uniformly over the step)
            cpu = np.maximum(cpu, gpu)
        return b.build()

    # ------------------------------------------------------------------ #
    def program_tokens(self) -> int:
        return 8192

    def _cpu_duration(self, op: SimOp, step: int) -> np.ndarray:
        dur = np.full(self.n, op.duration)
        for h in self._injectors:
            dur = h.cpu_duration(self, op, step, dur)
        return dur * (0.9 + 0.2 * self.rng.random(self.n))

    def _device_duration(self, op: SimOp, step: int) -> np.ndarray:
        dur = np.full(self.n, op.duration)
        for h in self._injectors:
            dur = h.device_duration(self, op, step, dur)
        return dur * (0.98 + 0.04 * self.rng.random(self.n))

    def _minority_time(self, op: SimOp, step: int) -> np.ndarray:
        extra = np.zeros(self.n)
        for h in self._injectors:
            extra = h.minority_time(self, op, step, extra)
        return extra

    # ------------------------------------------------------------------ #
    def _hang_at(self, step: int, oi: int, op: SimOp) -> Optional[Injection]:
        for h in self._injectors:
            if h.hang_at(self, step, oi, op):
                return h.inj
        return None

    def _finalize_hang(self, b: EventBatchBuilder, step, oi, op, inj,
                       cpu, gpu):
        """Produce the hang snapshot: per-rank stacks + ring progress."""
        r_fault = inj.ranks[0] if inj.ranks else 0
        comm = op.kind == "comm" and not inj.meta.get("noncomm_crash", False)
        stacks = {}
        for r in range(self.n):
            if comm:
                stacks[r] = ["train_step", "backward", op.name]
            else:
                if r == r_fault:
                    stacks[r] = ["train_step", "dataloader.next_batch",
                                 "os.read"]
                else:
                    nxt = next((o.name for o in self.program[oi:]
                                if o.kind == "comm"), "allreduce[0]")
                    stacks[r] = ["train_step", "backward", nxt]
        progress = None
        if comm:
            total = self.ring_total_steps
            s0 = min(int(inj.meta.get("frozen_at", total // 3)),
                     max(total - 1, 0))
            fifo = int(inj.meta.get("fifo_depth", 2))
            progress = np.zeros(self.n, np.int64)
            for d in range(self.n):
                r = (r_fault + d) % self.n
                if d == 0:
                    progress[r] = min(s0 + fifo, total)
                elif d == 1:
                    progress[r] = s0
                else:
                    progress[r] = min(s0 + min(d - 1, fifo), total)
        self.hang = HangSnapshot(
            step=step, op_index=oi, op_name=op.name, comm=comm,
            stacks=stacks, ring_progress=progress,
            group_ranks=list(range(self.n)), truth_rank=r_fault)
        # heartbeat-style HANG_SUSPECT events from every healthy daemon
        now = float(max(cpu.max(), gpu.max()) + 30.0)
        b.append_block(
            EventKind.HANG_SUSPECT, "hang_suspect", np.arange(self.n),
            now, now, now, step,
            extra=[{"stack": stacks[r], "silent_s": 30.0}
                   for r in range(self.n)])
