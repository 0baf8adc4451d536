"""Segmented trace writer: codec-agnostic spill with size-based rotation.

The daemon spill path appends one batch per drain for the lifetime of a
job — months, for the fleet's long-runners.  ``SegmentedTraceWriter``
owns the on-disk layout of that stream: every ``write`` appends through
the configured codec, and once the current file passes ``rotate_bytes``
the writer rolls to ``<stem>.seg001<ext>``, ``<stem>.seg002<ext>``, …
so any single file stays cheap to ship, replay, or delete.  The replayer
(:func:`job_id_for_path`) strips the ``.segNNN`` infix, so every rotated
piece replays under the same job id, in order (plain lexicographic sort:
the bare base file sorts before its ``.segNNN`` siblings).
"""
from __future__ import annotations

import os
import re
from typing import Optional, Union

from repro_torch.store.base import TraceCodec, codec_for_path, get_codec

_SEG_RE = re.compile(r"\.seg(\d{3,})$")

# non-trace companions that live next to trace files and can collide
# with codec extension globs (JSONL claims ``*.json``): the archive's
# persistent rollup cache (``<trace>.rollup.json``) and its telemetry
# exports (``telemetry-NNN.json``)
_TELEMETRY_RE = re.compile(r"^telemetry-\d+\.json$")

ROLLUP_SUFFIX = ".rollup.json"


def is_sidecar_path(path: str) -> bool:
    """True for archive sidecar files (rollup caches, telemetry exports,
    service checkpoints) that must not be treated as trace logs even
    when a codec's extension glob matches them."""
    base = os.path.basename(path)
    return (base.endswith(ROLLUP_SUFFIX)
            or base.endswith(".flc") or base.endswith(".flc.tmp")
            or bool(_TELEMETRY_RE.match(base)))


def seg_path(base_path: str, index: int) -> str:
    """Path of rotation segment ``index`` (0 = the base path itself)."""
    if index == 0:
        return base_path
    stem, ext = os.path.splitext(base_path)
    return f"{stem}.seg{index:03d}{ext}"


def job_id_for_path(path: str) -> str:
    """Job id for a log file: the stem with any ``.segNNN`` rotation
    infix removed, so ``job-a.fcs`` and ``job-a.seg002.fcs`` replay into
    the same job."""
    stem = os.path.splitext(os.path.basename(path))[0]
    return _SEG_RE.sub("", stem)


def seg_index(path: str) -> int:
    """Rotation index of a log file (0 for the base file).  Replay sorts
    a job's pieces by this NUMERICALLY — lexicographic order breaks past
    ``seg999`` (``seg1000`` < ``seg999`` as strings)."""
    m = _SEG_RE.search(os.path.splitext(os.path.basename(path))[0])
    return int(m.group(1)) if m else 0


class SegmentedTraceWriter:
    """Append batches through a codec, rotating files by size.

    On construction the writer RESUMES an existing rotated stream: it
    scans for the highest ``.segNNN`` piece already on disk and appends
    after it, so a restarted daemon keeps the stream append-only in time
    order instead of interleaving new batches into old segments."""

    def __init__(self, path: str, *, codec: Union[TraceCodec, str, None] = None,
                 rotate_bytes: Optional[int] = None):
        if isinstance(codec, str):
            codec = get_codec(codec)
        self.codec = codec or codec_for_path(path, default="jsonl")
        self.base_path = path
        self.rotate_bytes = rotate_bytes
        self.paths: list[str] = [path]
        self._index = 0
        while os.path.exists(seg_path(path, self._index + 1)):
            self._index += 1
            self.paths.append(seg_path(path, self._index))
        self._current_bytes = os.path.getsize(self.current_path) \
            if os.path.exists(self.current_path) else 0
        self.bytes_written = 0

    @property
    def current_path(self) -> str:
        return self.paths[-1]

    def write(self, batch) -> int:
        """Append one batch; returns bytes written (spill accounting)."""
        if not len(batch):
            return 0
        if (self.rotate_bytes is not None
                and self._current_bytes >= self.rotate_bytes):
            self._index += 1
            nxt = seg_path(self.base_path, self._index)
            self.paths.append(nxt)
            self._current_bytes = os.path.getsize(nxt) \
                if os.path.exists(nxt) else 0
        n = self.codec.write(batch, self.current_path)
        self._current_bytes += n
        self.bytes_written += n
        return n

    def close(self) -> None:
        """Nothing buffered — every ``write`` is a complete append — but
        kept so callers can treat writers uniformly."""
