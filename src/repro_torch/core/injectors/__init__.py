"""Pluggable fault injection — the simulator's extension seam.

The :class:`~repro_torch.core.timeline.ClusterSimulator` does not hardcode a
fault taxonomy: every ``Injection`` in its ``injections`` list resolves
through the registry to a :class:`FaultInjector` plugin driven at fixed
hook points of the emission loop (host pre-op stalls, cpu/device duration
transforms, minority device time, post-collective sync, hang triggers).
The nine legacy kinds are themselves registered plugins
(``builtins.py``), byte-equivalent to the pre-registry emitter; the L4
production taxonomy (``l4.py``) adds checkpoint-write storms, ECC/thermal
throttling, network flaps, straggly MoE experts, and serving-mix
interference.  Adding a fault class is a subclass + one
``@register_injector``, never a simulator edit — see
``src/repro_torch/scenarios/README.md`` for the worked example and the
detector-signature map.

The port's copy of the JAX package's ``core/injectors/__init__.py``:
stdlib and numpy only (no torch), with the reference's names and
semantics (its syntax tree is held to the reference's by
``tests/test_torch_simulator.py``).
"""
from repro_torch.core.injectors.base import (  # noqa: F401
    FaultInjector, Injection, stall_phase)
from repro_torch.core.injectors.builtins import (  # noqa: F401
    GcStallInjector, HangInjector, MinorityKernelsInjector,
    NetworkJitterInjector, PyApiStallInjector, SlowComputeInjector,
    SlowDataloaderInjector, StragglerInjector, SyncAfterCommInjector,
    UnderclockInjector)
from repro_torch.core.injectors.l4 import (  # noqa: F401
    CheckpointWriteStormInjector, EccThrottleInjector, MoEStragglerInjector,
    NetworkFlapInjector, ServingInterferenceInjector)
from repro_torch.core.injectors.registry import (  # noqa: F401
    DuplicateInjectorError, InjectorError, UnknownInjectorError,
    get_injector, injector_names, register_injector, resolve_injections,
    unregister_injector)

__all__ = [
    "Injection", "FaultInjector", "stall_phase",
    "GcStallInjector", "PyApiStallInjector", "SyncAfterCommInjector",
    "StragglerInjector", "UnderclockInjector", "SlowComputeInjector",
    "NetworkJitterInjector", "SlowDataloaderInjector",
    "MinorityKernelsInjector", "HangInjector",
    "CheckpointWriteStormInjector", "EccThrottleInjector",
    "NetworkFlapInjector", "MoEStragglerInjector",
    "ServingInterferenceInjector",
    "register_injector", "unregister_injector", "resolve_injections",
    "get_injector", "injector_names",
    "InjectorError", "UnknownInjectorError", "DuplicateInjectorError",
]
