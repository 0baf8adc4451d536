"""Live fleet service: long-lived ingest + query over the fleet engine.

  * :mod:`repro_torch.serve.protocol` — FLW length-prefixed FCS frame format
    (HELLO / BATCH / BYE) with torn/corrupt-frame detection;
  * :mod:`repro_torch.serve.client` — ``LiveClient`` (explicit, raising) and
    ``LiveBatchSink`` (the daemon's never-blocking counted-drop sink);
  * :mod:`repro_torch.serve.tail` — ``FileTailer`` following growing/rotating
    spill directories, segment boundaries as commit points;
  * :mod:`repro_torch.serve.service` — ``FleetService``: socket + tail
    ingestion planes over an inline or process-sharded engine, live
    cross-job frontier resolution, graceful join/leave;
  * :mod:`repro_torch.serve.query` — the stdlib-HTTP query plane
    (``/anomalies``, ``/weather``, ``/telemetry``, ``/jobs``,
    byte-budgeted ``/archive/*``).

See the JAX package's ``src/repro/serve/README.md`` for the wire
protocol and the determinism contract, which the port keeps.

The port's copy of the JAX package's ``serve/__init__.py``:
stdlib and numpy only (no torch), with the reference's names, formats
and semantics.
"""
from repro_torch.serve.client import (LiveBatchSink, LiveClient,
                                      parse_endpoint)
from repro_torch.serve.protocol import (FRAME_BATCH, FRAME_BYE,
                                        FRAME_HELLO, ProtocolError,
                                        batch_frame, bye_frame, encode_frame,
                                        hello_frame, parse_hello, read_frame)
from repro_torch.serve.query import QueryServer, fleet_anomaly_dict
from repro_torch.serve.service import FleetService, ServiceConfig
from repro_torch.serve.tail import FileTailer

__all__ = [
    "FleetService", "ServiceConfig", "FileTailer", "QueryServer",
    "LiveClient", "LiveBatchSink", "parse_endpoint", "ProtocolError",
    "FRAME_HELLO", "FRAME_BATCH", "FRAME_BYE", "encode_frame",
    "hello_frame", "batch_frame", "bye_frame", "read_frame",
    "parse_hello", "fleet_anomaly_dict",
]
