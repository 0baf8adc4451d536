"""Pluggable trace storage: codec registry + on-disk formats.

Usage::

    from repro_torch import store

    store.get_codec("fcs").write(batch, "job-a.fcs")     # append a segment
    batch = store.read_trace("logs/job-a.fcs")           # format-detected
    for chunk, skipped in store.iter_trace_chunks(path): ...

The port's copy of the JAX package's ``store`` package: the same codecs
and on-disk bytes (the reference's ``store/README.md`` sets out the FCS
layout).
"""
from repro_torch.store.base import (CodecError, TraceCodec, codec_for_path,
                                    codecs, get_codec, register_codec,
                                    sniff_format)
from repro_torch.store.compress import have_zstd
from repro_torch.store.fcs import (FcsCodec, FcsV2Codec, FcsV3Codec,
                                   decode_batch_bytes, encode_batch_bytes,
                                   read_fcs, segment_stats,
                                   tail_complete_segments, write_fcs)
from repro_torch.store.jsonl import (JsonlCodec, decode_jsonl_lines,
                                     iter_jsonl_chunks, read_jsonl,
                                     read_jsonl_chunked)
from repro_torch.store.stats import (SEVERITY_KINDS, STAT_COLUMNS, Predicate,
                                     ScanStats, SegmentStats)
from repro_torch.store.writer import (ROLLUP_SUFFIX, SegmentedTraceWriter,
                                      is_sidecar_path, job_id_for_path,
                                      seg_index, seg_path)

JSONL = register_codec(JsonlCodec())
FCS = register_codec(FcsCodec())
FCS2 = register_codec(FcsV2Codec())
FCS3 = register_codec(FcsV3Codec())


def read_trace(path: str, *, codec: str | None = None,
               with_skip_count: bool = False):
    """Decode a whole trace file with an explicit or auto-detected codec."""
    c = get_codec(codec) if codec else codec_for_path(path)
    return c.read(path, with_skip_count=with_skip_count)


def write_trace(batch, path: str, *, codec: str | None = None) -> int:
    """Append ``batch`` to ``path``; returns bytes written."""
    c = get_codec(codec) if codec else codec_for_path(path, default="jsonl")
    return c.write(batch, path)


def iter_trace_chunks(path: str, *, codec: str | None = None, **opts):
    """Stream ``(EventBatch, skipped)`` chunks in file order."""
    c = get_codec(codec) if codec else codec_for_path(path)
    return c.iter_chunks(path, **opts)


__all__ = [
    "CodecError", "TraceCodec", "JsonlCodec", "FcsCodec", "FcsV2Codec",
    "FcsV3Codec", "JSONL", "FCS", "FCS2", "FCS3", "have_zstd",
    "register_codec", "get_codec", "codecs", "codec_for_path",
    "sniff_format", "read_trace", "write_trace", "iter_trace_chunks",
    "read_jsonl", "read_jsonl_chunked", "iter_jsonl_chunks",
    "decode_jsonl_lines", "read_fcs",
    "write_fcs", "encode_batch_bytes", "decode_batch_bytes",
    "segment_stats", "tail_complete_segments",
    "Predicate", "ScanStats", "SegmentStats",
    "SEVERITY_KINDS", "STAT_COLUMNS", "SegmentedTraceWriter", "seg_path",
    "seg_index", "job_id_for_path", "is_sidecar_path", "ROLLUP_SUFFIX",
]
