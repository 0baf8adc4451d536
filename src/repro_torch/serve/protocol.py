"""FLW wire protocol: length-prefixed FCS frames over a stream socket.

One daemon connection speaks three frame types:

  * ``HELLO`` — join a job: payload is a JSON object, at minimum
    ``{"job_id": ...}``, optionally ``topology`` (rack/switch attrs for
    the fleet tier) and ``engine`` (EngineConfig field overrides);
  * ``BATCH`` — one flushed :class:`~repro_torch.core.columnar.EventBatch`,
    encoded with ``repro_torch.store.encode_batch_bytes`` (an FCS v2 segment
    — the exact bytes the spill path writes, ~11.5 B/event);
  * ``BYE`` — graceful leave: the service retires the job (flush + hang
    check + detector finalize) without touching other jobs.

Frame layout (little-endian)::

    magic  b"FLW1"   4 bytes
    type   u8        1=HELLO 2=BATCH 3=BYE
    flags  u8        reserved, 0
    job    u16       job-id byte length
    len    u32       payload byte length
    crc    u32       crc32 of job-id bytes + payload
    job-id bytes, payload bytes

Integrity contract: a clean EOF lands exactly on a frame boundary.  EOF
mid-frame is a TORN frame; bad magic / unknown type / CRC mismatch is a
CORRUPT frame.  Both raise :class:`ProtocolError` — the service counts
them (``serve.dropped_frames``) and drops the connection rather than
guessing at resynchronization, exactly like a truncated FCS tail is
counted and never silently decoded.

The port's copy of the JAX package's ``serve/protocol.py``:
stdlib and numpy only (no torch), with the reference's names, formats
and semantics.
"""
from __future__ import annotations

import json
import socket
import struct
import zlib
from typing import Optional

MAGIC = b"FLW1"
FRAME_HELLO = 1
FRAME_BATCH = 2
FRAME_BYE = 3

_HEADER = struct.Struct("<4sBBHII")

# sanity bound, not a protocol limit: one frame is one daemon flush
# (thousands of events, ~11.5 B each), so anything near this is garbage
# lengths from a corrupt header
MAX_PAYLOAD = 1 << 30


class ProtocolError(Exception):
    """Torn or corrupt frame on a live-ingest connection."""


def encode_frame(ftype: int, job_id: str, payload: bytes = b"") -> bytes:
    job = job_id.encode("utf-8")
    crc = zlib.crc32(payload, zlib.crc32(job)) & 0xFFFFFFFF
    return _HEADER.pack(MAGIC, ftype, 0, len(job), len(payload), crc) \
        + job + payload


def hello_frame(job_id: str, topology: Optional[dict] = None,
                engine: Optional[dict] = None) -> bytes:
    body: dict = {"job_id": job_id}
    if topology:
        body["topology"] = dict(topology)
    if engine:
        body["engine"] = dict(engine)
    return encode_frame(FRAME_HELLO, job_id,
                        json.dumps(body, sort_keys=True).encode("utf-8"))


def bye_frame(job_id: str) -> bytes:
    return encode_frame(FRAME_BYE, job_id)


def batch_frame(job_id: str, fcs_bytes: bytes) -> bytes:
    return encode_frame(FRAME_BATCH, job_id, fcs_bytes)


def _recv_exact(sock: socket.socket, n: int, *, at_boundary: bool,
                stop=None):
    """Read exactly ``n`` bytes; ``None`` on a clean EOF at a frame
    boundary, :class:`ProtocolError` on EOF mid-frame (torn).  With a
    socket timeout set, idle timeouts just poll ``stop()`` — a stall is
    tolerated indefinitely while the service runs, but stopping with a
    half-read frame is a torn frame (and a clean shutdown at a frame
    boundary returns ``None`` like EOF)."""
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            if stop is not None and stop():
                if not buf and at_boundary:
                    return None
                raise ProtocolError(
                    "torn frame: connection stopped mid-frame")
            continue
        if not chunk:
            if not buf and at_boundary:
                return None
            raise ProtocolError(
                f"torn frame: EOF after {len(buf)}/{n} bytes")
        buf.extend(chunk)
    return bytes(buf)


def read_frame(sock: socket.socket, stop=None
               ) -> Optional[tuple[int, str, bytes]]:
    """Read one frame; returns ``(type, job_id, payload)`` or ``None``
    on clean EOF (or a ``stop()``-signalled shutdown at a frame
    boundary).  Raises :class:`ProtocolError` on torn or corrupt
    input."""
    head = _recv_exact(sock, _HEADER.size, at_boundary=True, stop=stop)
    if head is None:
        return None
    magic, ftype, _flags, job_len, payload_len, crc = _HEADER.unpack(head)
    if magic != MAGIC:
        raise ProtocolError(f"bad magic {magic!r} (expected {MAGIC!r})")
    if ftype not in (FRAME_HELLO, FRAME_BATCH, FRAME_BYE):
        raise ProtocolError(f"unknown frame type {ftype}")
    if payload_len > MAX_PAYLOAD:
        raise ProtocolError(f"implausible payload length {payload_len}")
    body = _recv_exact(sock, job_len + payload_len, at_boundary=False,
                       stop=stop) \
        if job_len + payload_len else b""
    if (zlib.crc32(body) & 0xFFFFFFFF) != crc:
        raise ProtocolError("frame CRC mismatch")
    job = body[:job_len].decode("utf-8", errors="replace")
    return ftype, job, body[job_len:]


def parse_hello(payload: bytes) -> dict:
    """Decode a HELLO payload; tolerant of an empty body (job id is in
    the frame header either way)."""
    if not payload:
        return {}
    try:
        body = json.loads(payload)
    except ValueError as e:
        raise ProtocolError(f"corrupt hello payload ({e})") from e
    if not isinstance(body, dict):
        raise ProtocolError("hello payload must be a JSON object")
    return body
