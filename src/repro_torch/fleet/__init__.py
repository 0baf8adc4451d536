"""FLARE fleet subsystem: streaming multi-job multiplexing, incremental
per-step diagnosis, and mixed-format log replay (the paper's eight-month,
6,000-GPU continuous-operation layer).

Quickstart::

    from repro_torch.fleet import FleetMultiplexer, FleetConfig
    mux = FleetMultiplexer(FleetConfig(watermark_delay=1), history=store)
    mux.add_job("job-a", EngineConfig(backend="dense-train", num_ranks=256))
    mux.ingest("job-a", batch_or_events)      # per chunk, any producer
    for fa in mux.poll():                     # merged, ts-ordered, routed
        print(fa)
    mux.finalize()                            # flush watermarks + hangs

Live daemons plug in via ``daemon.attach_fleet(mux, "job-a")``; recorded
logs via ``FleetReplayer(mux).replay_dir("logs/")`` — add
``worker_kind="process"`` to shard per-job pipelines across worker
processes (``repro_torch.fleet.ipc``), byte-equivalent to serial and free of
the GIL.

Cross-job diagnosis plugs in through the fleet-scope detector tier::

    mux = FleetMultiplexer(FleetConfig(
        fleet_detectors=["cross_job_failslow"]), history=store)
    mux.set_topology("job-a", rack="r12", switch="sw3")

(see ``repro_torch.core.detectors`` — co-occurring fail-slows on a shared
rack/switch are reclassified as INFRASTRUCTURE, ``origin="fleet"``).

The port's copy of the JAX package's ``fleet/__init__.py``: numpy only (no
torch), with the reference's names, thresholds and arithmetic.
"""
from repro_torch.core.detectors.fleet import (  # noqa: F401
    CrossJobFailSlowCorrelator, FleetContext, FleetDetector)
from repro_torch.fleet.ipc import ProcessWorkerPool  # noqa: F401
from repro_torch.fleet.multiplexer import (FleetConfig, FleetJob,  # noqa: F401
                                           FleetMultiplexer)
from repro_torch.fleet.replay import FleetReplayer, ReplayStats  # noqa: F401
from repro_torch.fleet.store import (SharedInterner,  # noqa: F401
                                     StepPartitionedStore)
from repro_torch.fleet.stream import (  # noqa: F401
    DEFAULT_ROUTES, AnomalyStream, FleetAnomaly)

__all__ = [
    "FleetConfig", "FleetJob", "FleetMultiplexer",
    "FleetReplayer", "ReplayStats", "ProcessWorkerPool",
    "SharedInterner", "StepPartitionedStore",
    "AnomalyStream", "FleetAnomaly", "DEFAULT_ROUTES",
    "FleetDetector", "FleetContext", "CrossJobFailSlowCorrelator",
]
