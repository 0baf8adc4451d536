"""HTTP query plane for :class:`~repro_torch.serve.service.FleetService`.

A minimal stdlib ``ThreadingHTTPServer`` over the service's live state —
the interactive surface an always-on diagnosis deployment needs next to
its ingest planes (ARGUS-style), with no dependency beyond the standard
library:

  ``GET /jobs``                  per-job engine stats + open/departed/queued
  ``GET /anomalies?n=100``       recent diagnosed anomalies (bounded ring)
  ``GET /weather``               cluster-weather rollup of the recent window
  ``GET /telemetry``             full pipeline self-telemetry snapshot
                                 (serve.* counters, per-job gauges, queue
                                 depths)
  ``GET /archive/events?job=...[&step_lo=&step_hi=&t_lo=&t_hi=&kind=
        &severity=&limit=&max_bytes=]``
  ``GET /archive/metrics?job=...[&metric=&step_lo=&step_hi=&bucket=
        &max_bytes=]``

Archive endpoints exist when the service was configured with
``archive_dir``; every archive query runs under a BYTE BUDGET
(``max_bytes`` query param, capped by ``ServiceConfig.archive_max_bytes``)
— a months-long archive answers from the prefix the budget affords and
says so (``"truncated": true``), instead of letting one dashboard query
decode the world.

All responses are JSON; numpy scalars/arrays in anomaly evidence coerce
through the same fallback the report module uses.

The port's copy of the JAX package's ``serve/query.py``:
stdlib and numpy only (no torch), with the reference's names, formats
and semantics.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from repro_torch.core.report import _json_coerce


def fleet_anomaly_dict(fa) -> dict:
    """One JSON-ready record per diagnosed fleet anomaly."""
    a = fa.anomaly
    return {
        "job": fa.job_id, "ts": float(fa.ts), "origin": fa.origin,
        "route": fa.route, "kind": a.kind, "metric": a.metric,
        "team": a.team.value, "root_cause": a.root_cause,
        "step": int(a.step), "severity": float(a.severity),
        "ranks": list(a.ranks), "evidence": a.evidence,
    }


def _batch_rows(batch, limit: int) -> list[dict]:
    """First ``limit`` rows of an ``EventBatch`` as JSON-ready dicts."""
    n = min(len(batch), limit)
    names = batch.names
    out = []
    for i in range(n):
        out.append({
            "kind": int(batch.kind[i]),
            "name": names[int(batch.name_id[i])],
            "rank": int(batch.rank[i]),
            "step": int(batch.step[i]),
            "start_ts": float(batch.start_ts[i]),
            "end_ts": float(batch.end_ts[i]),
        })
    return out


class QueryServer:
    """Serves the endpoints above from daemon threads; ``close()`` stops
    accepting and joins.  Construction binds the port (readable at
    ``.port`` when configured as 0/ephemeral)."""

    def __init__(self, service, host: str = "127.0.0.1", port: int = 0):
        self.service = service
        self._archive = None
        self._archive_lock = threading.Lock()
        handler = self._make_handler()
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            daemon=True, name="flare-serve-query")
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10.0)

    # ------------------------------------------------------------------ #
    def archive(self):
        """Lazily opened :class:`~repro_torch.archive.TraceArchive` over
        ``ServiceConfig.archive_dir`` (None when not configured)."""
        d = self.service.cfg.archive_dir
        if d is None:
            return None
        with self._archive_lock:
            if self._archive is None:
                from repro_torch.archive import TraceArchive
                self._archive = TraceArchive(
                    d, telemetry=self.service.telemetry)
            return self._archive

    def _budget(self, q: dict) -> Optional[int]:
        cap = self.service.cfg.archive_max_bytes
        asked = q.get("max_bytes")
        if asked is None:
            return cap
        asked = int(asked[0])
        return min(asked, cap) if cap is not None else asked

    # ------------------------------------------------------------------ #
    def _route(self, path: str, q: dict):
        svc = self.service
        if path == "/jobs":
            return {"jobs": svc.job_stats()}
        if path == "/anomalies":
            n = int(q["n"][0]) if "n" in q else None
            return {"anomalies": [fleet_anomaly_dict(fa)
                                  for fa in svc.snapshot_recent(n)]}
        if path == "/weather":
            return svc.weather()
        if path == "/telemetry":
            return {"telemetry": svc.mux.telemetry_snapshot(),
                    "queues": svc.queue_depths()}
        if path == "/archive/events":
            arch = self.archive()
            if arch is None:
                return None
            job = q["job"][0]
            kw: dict = {}
            if "step_lo" in q or "step_hi" in q:
                kw["step_range"] = (int(q.get("step_lo", [0])[0]),
                                    int(q.get("step_hi", [1 << 60])[0]))
            if "t_lo" in q or "t_hi" in q:
                kw["time_range"] = (float(q.get("t_lo", [0])[0]),
                                    float(q.get("t_hi", [1e30])[0]))
            if "kind" in q:
                kw["kinds"] = [int(k) for k in q["kind"]]
            if "severity" in q:
                kw["severity"] = q["severity"][0]
            batch, scan = arch.query_events(
                job, with_scan=True, max_bytes=self._budget(q), **kw)
            limit = int(q.get("limit", [1000])[0])
            return {
                "job": job, "rows": len(batch),
                "truncated": scan.truncated,
                "scan": {"segments": scan.segments,
                         "segments_skipped": scan.segments_skipped,
                         "bytes_decoded": scan.bytes_decoded,
                         "bytes_skipped": scan.bytes_skipped},
                "events": _batch_rows(batch, limit),
            }
        if path == "/archive/metrics":
            arch = self.archive()
            if arch is None:
                return None
            job = q["job"][0]
            step_range = None
            if "step_lo" in q or "step_hi" in q:
                step_range = (int(q.get("step_lo", [0])[0]),
                              int(q.get("step_hi", [1 << 60])[0]))
            series, truncated = arch.query_metrics(
                job, step_range, q.get("metric", ["throughput"])[0],
                bucket=int(q.get("bucket", [1])[0]),
                max_bytes=self._budget(q), with_truncation=True)
            return {"job": job, "series": series, "truncated": truncated}
        return None

    def _make_handler(self):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):               # noqa: N802 (stdlib API name)
                u = urlparse(self.path)
                try:
                    body = outer._route(u.path, parse_qs(u.query))
                except (KeyError, ValueError, IndexError) as e:
                    self._reply(400, {"error": str(e)})
                    return
                except Exception as e:      # noqa: BLE001 — a broken
                    # query must not take the query thread down
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                if body is None:
                    self._reply(404, {"error": f"unknown path {u.path}"})
                else:
                    self._reply(200, body)

            def _reply(self, code: int, body: dict) -> None:
                data = json.dumps(body, default=_json_coerce).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, fmt, *args):   # quiet by default
                pass

        return Handler
