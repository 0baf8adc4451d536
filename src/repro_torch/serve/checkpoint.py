"""Crash-safe checkpoint container for the resident fleet service.

``FleetService`` keeps months of diagnosis state purely in memory —
per-job frontier progress and watermarks, shared intern tables,
stateful detector instances, pending step buffers, tail offsets, the
departed-job set, telemetry counters.  This module is the durability
layer under it: a versioned, CRC-protected, atomically-written snapshot
file, plus a generation-numbered store that always restores the newest
snapshot that is actually *valid*.

File layout (``ckpt-NNNNNNNN.flc``)::

    magic   4s   b"FLC1"
    version u16  FORMAT_VERSION (little-endian, like the FLW wire header)
    flags   u16  reserved (0)
    length  u64  payload byte count
    crc     u32  crc32(payload)
    payload      one pickle of the whole state dict

The payload is deliberately ONE ``pickle.dumps`` call: the resident
state is a web of shared references (every pending ``EventBatch`` slice
points at the interner's live ``names``/``groups`` list objects), and
pickling it as a single object preserves that identity through the
memo — after restore, ``batch.names is interner.names`` still holds,
so the adopt fast path keeps working on the restored pipelines.

Write protocol (power-loss-safe): payload to ``<path>.tmp``, ``flush``
+ ``fsync``, ``os.replace`` onto the final name, then a best-effort
fsync of the directory so the rename itself is durable.  A torn write
can therefore only ever produce a torn ``.tmp`` (ignored) or a torn
final file — which the header length + CRC detect on read, and which
:meth:`CheckpointStore.load_latest` skips back past to the previous
generation.  A checkpoint written by a NEWER format version is refused
with :class:`CheckpointVersionError` (never skipped, never misparsed):
silently restoring a downgraded daemon from state it half-understands
is worse than making the operator pick a matching build.

The port's copy of the JAX package's ``serve/checkpoint.py``:
stdlib and numpy only (no torch), with the reference's names, formats
and semantics.
"""
from __future__ import annotations

import os
import pickle
import re
import struct
import zlib
from typing import Optional

MAGIC = b"FLC1"
FORMAT_VERSION = 1

# magic | version | flags | payload length | crc32(payload)
_HEADER = struct.Struct("<4sHHQI")

_CKPT_RE = re.compile(r"^ckpt-(\d{8})\.flc$")

# Guard against absurd parses from corrupt headers: no service snapshot
# legitimately exceeds this (the resident state is bounded by watermark
# windows and ring sizes, not by stream length).
MAX_PAYLOAD = 1 << 32


class CheckpointError(Exception):
    """Torn, truncated or corrupt checkpoint file."""


class CheckpointVersionError(CheckpointError):
    """Checkpoint written by a NEWER format version — refuse loudly."""


def write_checkpoint(path: str, state: dict) -> int:
    """Atomically write ``state`` to ``path``; returns bytes written.
    Crash-safe: a reader either sees the previous file or the complete
    new one, never a torn intermediate under the final name."""
    payload = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
    header = _HEADER.pack(MAGIC, FORMAT_VERSION, 0, len(payload),
                          zlib.crc32(payload) & 0xFFFFFFFF)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(header)
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")
    return len(header) + len(payload)


def read_checkpoint(path: str) -> dict:
    """Read + verify one checkpoint file.  Raises
    :class:`CheckpointError` on any torn/corrupt shape and
    :class:`CheckpointVersionError` on a newer format version."""
    try:
        with open(path, "rb") as f:
            head = f.read(_HEADER.size)
            if len(head) < _HEADER.size:
                raise CheckpointError(f"{path}: truncated header "
                                      f"({len(head)} bytes)")
            magic, version, _flags, length, crc = _HEADER.unpack(head)
            if magic != MAGIC:
                raise CheckpointError(f"{path}: bad magic {magic!r}")
            if version > FORMAT_VERSION:
                raise CheckpointVersionError(
                    f"{path}: format version {version} is newer than this "
                    f"build understands (max {FORMAT_VERSION}); refusing "
                    "to guess — restore with a matching or newer build")
            if length > MAX_PAYLOAD:
                raise CheckpointError(f"{path}: implausible payload length "
                                      f"{length}")
            payload = f.read(length)
    except OSError as e:
        raise CheckpointError(f"{path}: unreadable ({e})") from e
    if len(payload) < length:
        raise CheckpointError(f"{path}: truncated payload "
                              f"({len(payload)}/{length} bytes)")
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise CheckpointError(f"{path}: CRC mismatch")
    try:
        state = pickle.loads(payload)
    except Exception as e:
        raise CheckpointError(f"{path}: undecodable payload ({e})") from e
    if not isinstance(state, dict):
        raise CheckpointError(f"{path}: payload is not a state dict")
    return state


def _fsync_dir(directory: str) -> None:
    """Durable rename: fsync the directory entry (best effort — not
    every filesystem allows opening a directory for fsync)."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class CheckpointStore:
    """Generation-numbered checkpoint directory.

    ``save`` writes the next generation atomically and prunes old ones
    down to ``keep``; ``load_latest`` walks generations newest-first,
    skipping (and counting) torn/corrupt files until a valid one loads.
    A newer-format file still refuses — skipping past state a newer
    build wrote would silently restore an older view of the world."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = max(int(keep), 1)
        os.makedirs(directory, exist_ok=True)

    def _path(self, generation: int) -> str:
        return os.path.join(self.directory, f"ckpt-{generation:08d}.flc")

    def generations(self) -> list[int]:
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in names:
            m = _CKPT_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def save(self, state: dict) -> tuple[str, int, int]:
        """Write the next generation; returns ``(path, generation,
        bytes_written)``.  Prunes generations beyond ``keep`` (best
        effort; a failed unlink never fails the checkpoint)."""
        gens = self.generations()
        gen = (gens[-1] + 1) if gens else 1
        path = self._path(gen)
        nbytes = write_checkpoint(path, state)
        for old in gens[:max(len(gens) + 1 - self.keep, 0)]:
            try:
                os.unlink(self._path(old))
            except OSError:
                pass
        return path, gen, nbytes

    def load_latest(self) -> Optional[tuple[dict, str, int, list[str]]]:
        """Newest VALID checkpoint: ``(state, path, generation,
        skipped)`` where ``skipped`` lists the torn/corrupt files passed
        over on the way down, or ``None`` when no valid checkpoint
        exists (the caller falls back to a full replay).  Raises
        :class:`CheckpointVersionError` for newer-format files."""
        skipped: list[str] = []
        for gen in reversed(self.generations()):
            path = self._path(gen)
            try:
                state = read_checkpoint(path)
            except CheckpointVersionError:
                raise
            except CheckpointError as e:
                skipped.append(f"{os.path.basename(path)}: {e}")
                continue
            return state, path, gen, skipped
        return None
