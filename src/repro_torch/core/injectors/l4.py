"""Production fault taxonomy beyond the paper's five (L4 / ARGUS,
PAPERS.md): checkpoint-write storms, ECC/thermal throttling, network
flaps, straggly MoE experts, serving-mix interference.

These are ordinary registered plugins — nothing in the simulator knows
they exist — and each maps to a distinct detector signature the scenario
matrix scores (``src/repro_torch/scenarios/``):

    checkpoint_write_storm -> issue_latency regression (checkpoint API)
    ecc_throttle           -> fail_slow, gpu_underclock on culprit ranks
    network_flap           -> fail_slow, per-group bandwidth drop
    moe_straggler          -> flops regression on the hot expert's kernel
    serving_interference   -> fail_slow throughput changepoint, no rank
                              or network attribution (external cause)

Kind-specific knobs ride in ``Injection.meta`` (documented per class);
the shared fields (``start_step``, ``ranks``, ``factor``, ``duration``,
``period_ops``, ``op_match``) keep their usual meaning.

The port's copy of the JAX package's ``core/injectors/l4.py``: stdlib
and numpy only (no torch), with the reference's names and semantics (its
syntax tree is held to the reference's by
``tests/test_torch_simulator.py``).
"""
from __future__ import annotations

from repro_torch.core.events import EventKind
from repro_torch.core.injectors.base import FaultInjector, stall_phase
from repro_torch.core.injectors.registry import register_injector


def _duty_on(step: int, start: int, on_steps: int, off_steps: int) -> bool:
    period = max(on_steps + off_steps, 1)
    return (step - start) % period < on_steps


@register_injector
class CheckpointWriteStormInjector(FaultInjector):
    """Checkpoint-write storm: every ``meta.period_steps`` steps, the job
    spends ``meta.storm_steps`` consecutive steps flushing checkpoint
    shards — multi-``duration``-second host stalls (one every
    ``period_ops`` ops, CRC32-phased like gc) that compress issue
    latencies and starve the device.

    meta: ``period_steps`` (default 8), ``storm_steps`` (default 2),
    ``api_name`` (default ``"checkpoint.save_sync"``)."""

    name = "checkpoint_write_storm"

    def pre_op(self, sim, b, step, oi, op, cpu):
        inj = self.inj
        if step < inj.start_step:
            return
        period_steps = max(int(inj.meta.get("period_steps", 8)), 1)
        storm_steps = max(int(inj.meta.get("storm_steps", 2)), 1)
        if (step - inj.start_step) % period_steps >= storm_steps:
            return
        period = max(inj.period_ops, 1)
        if oi % period != stall_phase(step, inj.kind, period):
            return
        hit = sim.hit_ranks(inj)
        t0 = cpu[hit].copy()
        cpu[hit] += inj.duration * (0.75 + 0.5 * sim.rng.random(hit.size))
        b.append_block(EventKind.PY_API,
                       inj.meta.get("api_name", "checkpoint.save_sync"),
                       hit, t0, t0, cpu[hit], step)


@register_injector
class EccThrottleInjector(FaultInjector):
    """ECC error storm / thermal throttling on a rank subset: compute
    slows down progressively, ramping from 1x at ``start_step`` to
    ``factor``x after ``meta.ramp_steps`` steps (step-correlated, unlike
    the flat ``straggler``).

    meta: ``ramp_steps`` (default 4)."""

    name = "ecc_throttle"

    def device_duration(self, sim, op, step, dur):
        inj = self.inj
        if step >= inj.start_step and op.kind == "compute":
            ramp_steps = max(int(inj.meta.get("ramp_steps", 4)), 1)
            ramp = min(1.0, (step - inj.start_step + 1) / ramp_steps)
            dur[sim.hit_ranks(inj)] *= 1.0 + (inj.factor - 1.0) * ramp
        return dur


@register_injector
class NetworkFlapInjector(FaultInjector):
    """Flapping link / lossy switch: collectives on the hit ranks run
    ``factor``x slower (with per-rank noise) during ON windows of a
    ``meta.on_steps`` / ``meta.off_steps`` duty cycle, and at full speed
    in between — the transient cousin of ``network_jitter``.

    meta: ``on_steps`` (default 2), ``off_steps`` (default 2)."""

    name = "network_flap"

    def device_duration(self, sim, op, step, dur):
        inj = self.inj
        if step >= inj.start_step and op.kind == "comm" and _duty_on(
                step, inj.start_step,
                int(inj.meta.get("on_steps", 2)),
                int(inj.meta.get("off_steps", 2))):
            # full-width draw: rank targeting never shifts the RNG stream
            r = sim.rng.random(sim.n)
            hit = sim.hit_ranks(inj)
            dur[hit] *= inj.factor * (0.9 + 0.2 * r[hit])
        return dur


@register_injector
class MoEStragglerInjector(FaultInjector):
    """Straggly MoE expert: among the per-expert FFN kernels (names
    matched by ``op_match``, e.g. ``"moe_ffn"`` — see
    ``program_from_config(..., moe_experts=)``), the hot expert
    ``meta.hot_expert`` runs ``factor``x slower on every hit rank (token
    skew / a cold cache), the rest run at ``meta.base_factor``.

    meta: ``hot_expert`` (default 0), ``base_factor`` (default 1.0)."""

    name = "moe_straggler"

    def device_duration(self, sim, op, step, dur):
        inj = self.inj
        match = inj.op_match or "moe_ffn"
        if step < inj.start_step or op.kind != "compute" \
                or match not in op.name:
            return dur
        hot = int(inj.meta.get("hot_expert", 0))
        if f".expert{hot}" in op.name:
            dur[sim.hit_ranks(inj)] *= inj.factor
        else:
            base = float(inj.meta.get("base_factor", 1.0))
            if base != 1.0:
                dur[sim.hit_ranks(inj)] *= base
        return dur


@register_injector
class ServingInterferenceInjector(FaultInjector):
    """Serving-mix interference: a co-located inference/background
    workload steals compute from the hit ranks on a duty cycle — every
    compute kernel runs ``factor``x slower during ON windows.  Uniform
    across ranks and gone between bursts, so neither the underclock nor
    the network attribution applies: the textbook "sudden slowdown,
    cause unresolved" fail-slow.

    meta: ``on_steps`` (default 2), ``off_steps`` (default 2)."""

    name = "serving_interference"

    def device_duration(self, sim, op, step, dur):
        inj = self.inj
        if step >= inj.start_step and op.kind == "compute" and _duty_on(
                step, inj.start_step,
                int(inj.meta.get("on_steps", 2)),
                int(inj.meta.get("off_steps", 2))):
            dur[sim.hit_ranks(inj)] *= inj.factor
        return dur
