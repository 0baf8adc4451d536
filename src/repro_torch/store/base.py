"""Trace-storage codec protocol + registry.

A :class:`TraceCodec` is the single seam between the in-memory
``EventBatch`` and its on-disk representation.  Every producer (daemon
spill, benchmarks) and consumer (fleet replay, offline analysis) goes
through a codec looked up here, so adding a format is one module that
calls :func:`register_codec` — no call-site changes.

Two codecs ship in-tree:

  ``jsonl``  line-per-event JSON (human-greppable, appendable, tolerant
             of truncated tails — the historical daemon format);
  ``fcs``    Flare Columnar Segment — numpy-native binary segments,
             ~5x smaller and 50x+ faster to replay (see ``fcs.py`` and
             ``src/repro/store/README.md``).

Format resolution order for a path: explicit codec name > file
extension > content sniff (:func:`sniff_format` reads the magic bytes),
so mixed-format log directories replay without configuration.
"""
from __future__ import annotations

import os
from typing import TYPE_CHECKING, Iterator, Optional, Protocol, runtime_checkable

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (columnar is heavy)
    from repro_torch.core.columnar import EventBatch


class CodecError(ValueError):
    """A trace file (or one segment of it) cannot be decoded.

    Carries ``path`` and ``offset`` (byte position of the broken
    structure) so operators can locate corruption in multi-GB logs."""

    def __init__(self, message: str, *, path: Optional[str] = None,
                 offset: Optional[int] = None):
        loc = ""
        if path is not None:
            loc = f" [{path}" + (f" @ byte {offset}" if offset is not None
                                 else "") + "]"
        super().__init__(message + loc)
        self.path = path
        self.offset = offset


@runtime_checkable
class TraceCodec(Protocol):
    """On-disk trace format.  ``write`` APPENDS one batch (a daemon calls
    it once per drain); ``read`` decodes a whole file; ``iter_chunks``
    streams ``(EventBatch, skipped)`` pieces in file order for replay."""

    name: str
    extensions: tuple[str, ...]

    def write(self, batch: "EventBatch", path: str) -> int:
        """Append ``batch`` to ``path``; returns bytes written."""
        ...

    def read(self, path: str, *, with_skip_count: bool = False):
        """Decode the whole file into one ``EventBatch`` (optionally with
        the count of skipped corrupt lines/segments)."""
        ...

    def iter_chunks(self, path: str, **opts
                    ) -> Iterator[tuple["EventBatch", int]]:
        """Yield ``(EventBatch, skipped)`` per chunk in file order."""
        ...


_REGISTRY: dict[str, TraceCodec] = {}
_BY_EXTENSION: dict[str, TraceCodec] = {}


def register_codec(codec: TraceCodec) -> TraceCodec:
    _REGISTRY[codec.name] = codec
    for ext in codec.extensions:
        _BY_EXTENSION[ext] = codec
    return codec


def get_codec(name: str) -> TraceCodec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown trace codec {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def codecs() -> dict[str, TraceCodec]:
    return dict(_REGISTRY)


def sniff_format(path: str) -> Optional[str]:
    """Look at the leading bytes: FCS files start with the segment magic;
    JSONL files with ``{`` (possibly after whitespace).  Returns a codec
    name or None."""
    from repro_torch.store.fcs import MAGIC
    try:
        with open(path, "rb") as f:
            head = f.read(len(MAGIC) + 16)
    except OSError:
        return None
    if head.startswith(MAGIC):
        return "fcs"
    if head.lstrip()[:1] == b"{" or head.strip() == b"":
        return "jsonl"
    return None


def codec_for_path(path: str, *, default: Optional[str] = None) -> TraceCodec:
    """Resolve the codec for ``path`` by extension, then by content
    sniff, then by ``default``."""
    ext = os.path.splitext(path)[1].lower()
    codec = _BY_EXTENSION.get(ext)
    if codec is not None:
        return codec
    if os.path.exists(path):
        name = sniff_format(path)
        if name is not None:
            return get_codec(name)
    if default is not None:
        return get_codec(default)
    raise CodecError(f"cannot determine trace codec for {path!r} "
                     f"(extension {ext!r} unknown, content sniff failed)",
                     path=path)
