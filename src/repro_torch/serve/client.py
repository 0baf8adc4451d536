"""Live-ingest clients for the FLW socket plane.

Two shapes for two callers:

  * :class:`LiveClient` — explicit control for simulators, benchmarks
    and tests: connect, ``hello`` jobs, ``send_batch`` frames, ``bye``,
    close.  Errors raise; nothing is dropped silently.
  * :class:`LiveBatchSink` — the resilient per-daemon sink behind
    ``DaemonConfig.live_endpoint``: a callable that frames one flushed
    :class:`~repro_torch.core.columnar.EventBatch` per call.  Its contract is
    the TracingDaemon heartbeat's: NEVER block for long and NEVER
    raise.  A dead/slow service costs a counted drop
    (``daemon.live_dropped`` in the daemon's telemetry) and a
    reconnect-with-backoff attempt on a later flush — diagnosis
    telemetry must not be able to take training down.

Only ``repro_torch.store`` and the wire protocol are imported here, so the
daemon side never pulls the service (with its fleet machinery) into the
training process.

The port's copy of the JAX package's ``serve/client.py``:
stdlib and numpy only (no torch), with the reference's names, formats
and semantics.
"""
from __future__ import annotations

import socket
import time
from typing import Optional

from repro_torch.serve.protocol import (batch_frame, bye_frame,
                                        hello_frame)
from repro_torch.store import encode_batch_bytes


def parse_endpoint(endpoint: str) -> tuple[str, int]:
    """``"host:port"`` -> ``(host, port)`` (IPv4/hostname form)."""
    host, _, port = endpoint.rpartition(":")
    return host or "127.0.0.1", int(port)


class LiveClient:
    """Blocking, raising client — one socket, many jobs."""

    def __init__(self, host: str, port: int, *, timeout: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)

    def hello(self, job_id: str, topology: Optional[dict] = None,
              engine: Optional[dict] = None) -> None:
        self.sock.sendall(hello_frame(job_id, topology, engine))

    def send_batch(self, job_id: str, batch_or_bytes) -> int:
        """Frame + send one batch (an ``EventBatch`` is FCS-encoded
        first; raw ``bytes`` pass through — a spill segment already on
        hand costs no re-encode).  Returns wire bytes sent."""
        blob = batch_or_bytes if isinstance(batch_or_bytes, (bytes,
                                                             bytearray,
                                                             memoryview)) \
            else encode_batch_bytes(batch_or_bytes)
        frame = batch_frame(job_id, bytes(blob))
        self.sock.sendall(frame)
        return len(frame)

    def bye(self, job_id: str) -> None:
        self.sock.sendall(bye_frame(job_id))

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class LiveBatchSink:
    """Never-blocking, never-raising batch sink for the daemon.

    On send failure the socket is torn down, the batch is counted as
    dropped, and reconnection is attempted no sooner than an
    exponential backoff allows (``backoff_s`` .. ``backoff_max_s``);
    batches arriving while disconnected are counted drops, not queued —
    the service's replay/tail planes exist precisely so lost live
    frames are recoverable from the spill, and an unbounded queue in
    the training process is the failure mode this sink exists to
    prevent."""

    def __init__(self, endpoint: str, job_id: str,
                 *, topology: Optional[dict] = None,
                 engine: Optional[dict] = None,
                 telemetry=None, timeout: float = 1.0,
                 backoff_s: float = 0.5, backoff_max_s: float = 30.0,
                 clock=time.monotonic):
        self.host, self.port = parse_endpoint(endpoint)
        self.job_id = job_id
        self.topology = topology
        self.engine = engine
        self.timeout = timeout
        self.backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self._clock = clock
        self._sock: Optional[socket.socket] = None
        self._next_try = 0.0
        self._fails = 0
        t = telemetry
        self._sent = t.counter("daemon.live_frames") if t else None
        self._bytes = t.counter("daemon.live_bytes") if t else None
        self._dropped = t.counter("daemon.live_dropped") if t else None
        self._reconnects = t.counter("daemon.live_reconnects") if t else None

    def _drop(self) -> None:
        if self._dropped is not None:
            self._dropped.inc()

    def _disconnect(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self._fails += 1
        self._next_try = self._clock() + min(
            self.backoff_s * (2 ** min(self._fails - 1, 16)),
            self.backoff_max_s)

    def _ensure_connected(self) -> bool:
        if self._sock is not None:
            return True
        if self._clock() < self._next_try:
            return False
        try:
            sock = socket.create_connection((self.host, self.port),
                                            timeout=self.timeout)
            sock.settimeout(self.timeout)
            # HELLO rides EVERY fresh connection, not just the first:
            # a service restarted from a checkpoint (or rebooted cold)
            # learns this job's topology + engine overrides again on the
            # next backoff reconnect, with no daemon-side special case
            sock.sendall(hello_frame(self.job_id, self.topology,
                                     self.engine))
        except OSError:
            self._disconnect()
            return False
        self._sock = sock
        if self._fails and self._reconnects is not None:
            self._reconnects.inc()
        self._fails = 0
        return True

    def __call__(self, batch) -> bool:
        """Ship one flushed batch; ``True`` if it went out, ``False``
        for a counted drop.  Safe to call from the daemon's heartbeat
        thread: worst case is one connect/send timeout."""
        try:
            if not self._ensure_connected():
                self._drop()
                return False
            frame = batch_frame(self.job_id, encode_batch_bytes(batch))
            self._sock.sendall(frame)
        except Exception:
            # OSError/timeout from the socket, or anything unexpected
            # from encode: the heartbeat must survive all of it
            self._disconnect()
            self._drop()
            return False
        if self._sent is not None:
            self._sent.inc()
        if self._bytes is not None:
            self._bytes.inc(len(frame))
        return True

    def close(self) -> None:
        """Best-effort ``bye`` + socket close (idempotent)."""
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.sendall(bye_frame(self.job_id))
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
