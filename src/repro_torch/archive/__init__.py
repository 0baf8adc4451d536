"""Queryable trace archive: the serving surface over recorded fleets.

::

    from repro_torch.archive import TraceArchive

    ar = TraceArchive("logs/", history=history)
    batch = ar.query_events("job-b", step_range=(40, 60))     # pushdown
    curve = ar.query_metrics("job-b", metric="throughput")    # cached
    crit  = ar.query_anomalies(team="infrastructure")
    print(format_fleet_weather(ar.fleet_weather()))

The JAX package's ``archive/README.md`` is the full API reference.

The port's copy of the JAX package's ``archive/__init__.py``: numpy only (no
torch), with the reference's names, thresholds and arithmetic.
"""
from repro_torch.archive.archive import (SCALAR_METRICS, TraceArchive,
                                         format_fleet_weather)

__all__ = ["TraceArchive", "format_fleet_weather", "SCALAR_METRICS"]
