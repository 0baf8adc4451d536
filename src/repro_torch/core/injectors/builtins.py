"""The nine legacy injection kinds as registered plugins.

Each class reproduces the behavior of the pre-registry
``ClusterSimulator`` if-chain — same hook order, same ``sim.rng`` draw
sequence — so a seeded simulation emits a byte-identical ``EventBatch``
through the registry (the JAX package pins this against a frozen
oracle; ``tests/test_torch_simulator.py`` holds the port's batches to
the reference's bit for bit).  Two deliberate fixes ARE folded in:

  * periodic gc/pyapi stalls phase with :func:`~repro_torch.core.injectors.
    base.stall_phase` (CRC32) instead of salted ``hash()`` — traces are
    now reproducible across processes;
  * ``minority_kernels`` and ``network_jitter`` honour ``Injection.
    ranks`` (the legacy emitter silently hit every rank), and the
    ``straggler``/``underclock`` per-rank Python loop is vectorized.

``network_jitter`` still draws a full ``sim.n``-wide jitter vector even
when only a rank subset is hit, so adding/removing rank targeting never
shifts the RNG stream consumed by later ops.

The port's copy of the JAX package's ``core/injectors/builtins.py``:
numpy only (no torch); the one difference is the Case-1 span's name,
``torch.cuda@synchronize``, with the reference's names and semantics
(its syntax tree is held to the reference's by
``tests/test_torch_simulator.py``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.events import EventKind
from repro_torch.core.injectors.base import FaultInjector, stall_phase
from repro_torch.core.injectors.registry import register_injector


@register_injector
class GcStallInjector(FaultInjector):
    """Periodic host-side GC pause: every ``period_ops`` ops (CRC32
    phase per step), the hit ranks stall ``duration * U[0.75, 1.25)``
    seconds before dispatching — compressing issue latencies (④)."""

    name = "gc"
    emit_kind = EventKind.GC

    def pre_op(self, sim, b, step, oi, op, cpu):
        inj = self.inj
        if step < inj.start_step:
            return
        period = max(inj.period_ops, 1)
        if oi % period != stall_phase(step, inj.kind, period):
            return
        hit = sim.hit_ranks(inj)
        t0 = cpu[hit].copy()
        cpu[hit] += inj.duration * (0.75 + 0.5 * sim.rng.random(hit.size))
        b.append_block(self.emit_kind, inj.api_name, hit, t0, t0,
                       cpu[hit], step)


@register_injector
class PyApiStallInjector(GcStallInjector):
    """Periodic stall in an arbitrary traced Python API (``api_name``):
    package checks, version pings, host-side timers."""

    name = "pyapi_stall"
    emit_kind = EventKind.PY_API


@register_injector
class SyncAfterCommInjector(FaultInjector):
    """Case-1: an unnecessary ``torch.cuda.synchronize`` after every
    collective — the host waits for the device, serializing dispatch.
    The span is named ``torch.cuda@synchronize``, as the port's
    interceptor names the PyTorch call (the reference's is
    ``jax@block_until_ready``); both route to the algorithm team."""

    name = "sync_after_comm"

    def post_comm(self, sim, b, step, op, cpu, end):
        inj = self.inj
        if step < inj.start_step:
            return
        hit = sim.hit_ranks(inj)
        t0 = cpu[hit].copy()
        cpu[hit] = np.maximum(cpu[hit], end[hit])
        b.append_block(EventKind.SYNC, "torch.cuda@synchronize", hit,
                       t0, t0, cpu[hit], step)


@register_injector
class StragglerInjector(FaultInjector):
    """Persistent compute slowdown on the hit ranks (thermal throttling,
    a downclocked GPU): every compute kernel runs ``factor`` slower."""

    name = "straggler"

    def device_duration(self, sim, op, step, dur):
        inj = self.inj
        if step >= inj.start_step and op.kind == "compute":
            dur[sim.hit_ranks(inj)] *= inj.factor
        return dur


@register_injector
class UnderclockInjector(StragglerInjector):
    """Alias kind: GPU underclocking is the straggler fault under its
    fail-slow-attribution name (paper §5.2.3)."""

    name = "underclock"


@register_injector
class SlowComputeInjector(FaultInjector):
    """Uniform slowdown of kernels whose name contains ``op_match`` on
    ALL hit ranks — the Case-2 software/layout regression shape."""

    name = "slow_compute"

    def device_duration(self, sim, op, step, dur):
        inj = self.inj
        if step >= inj.start_step and op.kind == "compute" \
                and inj.op_match in op.name:
            dur[sim.hit_ranks(inj)] *= inj.factor
        return dur


@register_injector
class NetworkJitterInjector(FaultInjector):
    """Persistent noisy slowdown of collectives on the hit ranks:
    ``factor * U[0.8, 1.2)`` per rank per op (congestion, CRC retries)."""

    name = "network_jitter"

    def device_duration(self, sim, op, step, dur):
        inj = self.inj
        if step >= inj.start_step and op.kind == "comm":
            # full-width draw keeps the RNG stream independent of rank
            # targeting (see module docstring)
            r = sim.rng.random(sim.n)
            hit = sim.hit_ranks(inj)
            dur[hit] *= inj.factor * (0.8 + 0.4 * r[hit])
        return dur


@register_injector
class SlowDataloaderInjector(FaultInjector):
    """Case-3: the host dataloader takes ``factor``x longer plus a flat
    ``duration`` seconds — V_inter grows, the device starves."""

    name = "slow_dataloader"

    def cpu_duration(self, sim, op, step, dur):
        inj = self.inj
        if step >= inj.start_step and "dataloader" in op.name:
            dur = dur * inj.factor + inj.duration
        return dur


@register_injector
class MinorityKernelsInjector(FaultInjector):
    """Table-5: un-instrumented minority kernels silently occupy the
    device for ``factor`` of each compute op's span on the hit ranks —
    V_minority grows with no matching trace spans."""

    name = "minority_kernels"

    def minority_time(self, sim, op, step, extra):
        inj = self.inj
        if step >= inj.start_step and op.kind == "compute":
            extra[sim.hit_ranks(inj)] += op.duration * inj.factor
        return extra


@register_injector
class HangInjector(FaultInjector):
    """Freeze the cluster at (``at_step``, ``at_op``); ``at_op == -1``
    means the first collective of that step.  The simulator snapshots
    per-rank stacks + ring progress (``sim.hang``) and emits the
    majority HANG_SUSPECT heartbeat block."""

    name = "hang"

    def hang_at(self, sim, step, oi, op):
        inj = self.inj
        if step != inj.at_step:
            return False
        return inj.at_op == oi or (inj.at_op == -1 and op.kind == "comm")
