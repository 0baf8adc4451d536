"""Fault-injection protocol + the Injection record.

An :class:`Injection` is pure *data*: which fault, when, where, how hard.
A :class:`FaultInjector` is the *behavior* bound to one Injection — a
plugin the :class:`~repro_torch.core.timeline.ClusterSimulator` drives through
fixed hook points of its emission loop.  The registry
(``repro_torch.core.injectors.registry``) maps ``Injection.kind`` to the
injector class, exactly like ``EngineConfig.detectors`` maps names to
detector classes: the simulator never hardcodes a fault taxonomy again.

Hook points, in the order the simulator calls them for every op::

    hang_at(sim, step, oi, op)            -> bool: freeze the cluster here
    pre_op(sim, b, step, oi, op, cpu)     host-side stall BEFORE dispatch
                                          (mutate ``cpu``, append events)
    cpu_duration(sim, op, step, dur)      transform host-op durations
    device_duration(sim, op, step, dur)   transform device-op durations
    minority_time(sim, op, step, extra)   add un-instrumented device time
    post_comm(sim, b, step, op, cpu, end) host sync AFTER a collective

Duration hooks receive and return per-rank ``np.ndarray`` vectors (length
``sim.n``); they run BEFORE the simulator applies its healthy noise draw,
so a no-op hook chain is byte-identical to an uninjected run.  Injectors
that need randomness must draw from ``sim.rng`` (never a private RNG) so
a seeded simulation stays reproducible for any injector mix.

``Injection`` is re-exported from ``repro_torch.core.timeline`` for
back-compat; new code should import it from here.

The port's copy of the JAX package's ``core/injectors/base.py``: stdlib
and numpy only (no torch), with the reference's names and semantics (its
syntax tree is held to the reference's by
``tests/test_torch_simulator.py``).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class Injection:
    """One fault to inject.  ``kind`` names a registered injector; see
    ``repro_torch.core.injectors.registry.injector_names()`` for the taxonomy
    (nine legacy kinds + the L4 production set).  Kind-specific knobs
    beyond the shared fields below travel in ``meta``."""

    kind: str
    # gc | sync_after_comm | straggler | underclock | network_jitter |
    # hang | slow_dataloader | minority_kernels | slow_compute |
    # pyapi_stall | checkpoint_write_storm | ecc_throttle | network_flap |
    # moe_straggler | serving_interference | <your-registered-kind>
    start_step: int = 0
    ranks: tuple = ()              # affected ranks (empty = all)
    factor: float = 1.0            # slowdown multiplier
    duration: float = 0.0          # injected span length (gc/pyapi/dataloader)
    period_ops: int = 6            # one injection every N ops (gc/pyapi)
    op_match: str = ""             # substring matched against op names
    api_name: str = "gc.collect"   # emitted event name (pyapi_stall)
    at_step: int = 1               # hang step
    at_op: int = -1                # hang op index (-1 = first comm)
    meta: dict = field(default_factory=dict)

    def hits_rank(self, r: int) -> bool:
        return not self.ranks or r in self.ranks


def stall_phase(step: int, kind: str, period: int) -> int:
    """Deterministic per-(step, kind) phase for periodic in-step stalls.

    The legacy emitter used ``hash((step, kind))`` here — Python string
    hashing is salted per process (PYTHONHASHSEED), so the *same seed*
    emitted *different traces* across runs.  CRC32 is stable everywhere.
    """
    return zlib.crc32(f"{step}:{kind}".encode("ascii")) % max(period, 1)


class FaultInjector:
    """Base class for injector plugins.  Subclass, set ``name`` (the
    registry key, matched against ``Injection.kind``), override the hooks
    you need, and register with ``@register_injector``.  One instance is
    created per Injection per simulator, so hooks may keep state across
    steps (ramp counters, duty-cycle phase) on ``self``."""

    name: str = ""

    def __init__(self, inj: Injection):
        self.inj = inj

    # -------------------------- hook points --------------------------- #
    def hang_at(self, sim, step: int, oi: int, op) -> bool:
        """Return True to freeze the cluster at this op (hang faults)."""
        return False

    def pre_op(self, sim, b, step: int, oi: int, op, cpu: np.ndarray) -> None:
        """Host-side stall before the op is dispatched: mutate ``cpu`` for
        the hit ranks and append the corresponding host-span events."""

    def cpu_duration(self, sim, op, step: int,
                     dur: np.ndarray) -> np.ndarray:
        """Transform a host op's per-rank duration vector (pre-noise)."""
        return dur

    def device_duration(self, sim, op, step: int,
                        dur: np.ndarray) -> np.ndarray:
        """Transform a device op's per-rank duration vector (pre-noise)."""
        return dur

    def minority_time(self, sim, op, step: int,
                      extra: np.ndarray) -> np.ndarray:
        """Add per-rank *un-instrumented* device time after this op."""
        return extra

    def post_comm(self, sim, b, step: int, op, cpu: np.ndarray,
                  end: np.ndarray) -> None:
        """Host behavior after a collective completes (e.g. forced sync):
        mutate ``cpu`` and append host-span events."""
