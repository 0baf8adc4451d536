"""JSONL trace codec — line-per-event JSON (the historical daemon format).

Machinery extracted from ``repro.core.columnar`` behind the
:class:`~repro.store.base.TraceCodec` API: tolerant line-by-line decode,
the slab-wise array-parse fast path, and chunked/parallel file decode.
``EventBatch.from_jsonl*`` remain as thin deprecated shims over this
module.

Chunk decoding supports two executors:

  ``thread``   default — fine when json array-parsing releases enough of
               the GIL between slabs and for warm-cache replay;
  ``process``  a ``ProcessPoolExecutor``: ``json.loads`` is GIL-bound, and
               ``EventBatch`` pickles cheaply (numpy columns), so process
               workers scale decode with cores on multi-GB logs.
"""
from __future__ import annotations

import json
import os
import warnings
from typing import Iterator, Optional

import numpy as np

from repro_torch.core.columnar import (NO_INT, _VALUE_TO_CODE, _split_meta,
                                       EventBatch, EventBatchBuilder)
from repro_torch.core.events import dump_jsonl

_DECODE_SLAB = 65536          # lines array-parsed per json.loads call

_NO_META = (np.nan, NO_INT, NO_INT, None, None)


def _append_dicts(b: EventBatchBuilder, ds: list) -> None:
    """Append parsed JSONL row dicts to the builder with local bindings —
    the per-row ``append_scalar`` call was a third of decode time."""
    code = _VALUE_TO_CODE
    intern = b._intern_name
    igroup = b._intern_group
    sk, sn, sr = b._s_kind, b._s_nid, b._s_rank
    si, ss, se = b._s_issue, b._s_start, b._s_end
    st, sf, sb = b._s_step, b._s_flops, b._s_nbytes
    stk, sg = b._s_tokens, b._s_gid
    extra = b._extra
    base = b._count + len(sk)
    for n, d in enumerate(ds):
        m = d.get("m")
        flops, nbytes, tokens, group, rest = \
            _split_meta(m) if m else _NO_META
        sk.append(code[d["k"]])
        sn.append(intern(d["n"]))
        sr.append(d["r"])
        si.append(d["i"])
        ss.append(d["s"])
        se.append(d["e"])
        st.append(d.get("t", -1))
        sf.append(flops)
        sb.append(nbytes)
        stk.append(tokens)
        sg.append(igroup(group))
        if rest:
            extra[base + n] = rest


def _rollback_slab(b: EventBatchBuilder, n_rows: int, n_extra_base: int):
    """Drop scalar rows staged past ``n_rows`` (a slab whose array parse
    half-applied before hitting a malformed dict)."""
    for lst in (b._s_kind, b._s_nid, b._s_rank, b._s_issue, b._s_start,
                b._s_end, b._s_step, b._s_flops, b._s_nbytes, b._s_tokens,
                b._s_gid):
        del lst[n_rows:]
    for k in [k for k in b._extra if k >= n_extra_base]:
        del b._extra[k]


def decode_jsonl_lines(lines) -> tuple[EventBatch, int]:
    """Decode an iterable of JSONL lines (str or bytes) into one batch,
    skipping (and counting) undecodable lines.  Consumes the iterable
    slab-wise, so a multi-GB file is never materialized as a line list.

    Fast path: each slab is joined into one JSON array and parsed with a
    single ``json.loads`` (~2x a per-line loop).  Only a slab containing a
    corrupt/truncated line (common at the tail of killed jobs' logs) is
    rolled back and re-decoded tolerantly line by line — the intact rest
    of the file keeps the fast path."""
    from itertools import islice
    b = EventBatchBuilder()
    skipped = 0
    it = iter(lines)
    while True:
        raw = list(islice(it, _DECODE_SLAB))
        if not raw:
            break
        slab = [ln for ln in (line.strip() for line in raw) if ln]
        if not slab:
            continue
        lb, sep, rb = (b"[", b",", b"]") if isinstance(slab[0], bytes) \
            else ("[", ",", "]")
        n_rows = len(b._s_kind)
        try:
            _append_dicts(b, json.loads(lb + sep.join(slab) + rb))
            continue
        except (KeyError, TypeError, AttributeError, ValueError):
            _rollback_slab(b, n_rows, b._count + n_rows)
        for line in slab:
            try:
                d = json.loads(line)
                b.append_scalar(_VALUE_TO_CODE[d["k"]], d["n"], d["r"],
                                d["i"], d["s"], d["e"], d.get("t", -1),
                                d.get("m") or {})
            except (KeyError, TypeError, AttributeError, ValueError):
                skipped += 1
    return b.build(), skipped


def _chunk_spans(path: str, chunk_bytes: int) -> list[tuple[int, int]]:
    """Split ``path`` into ~chunk_bytes (lo, hi) byte spans on line
    boundaries: each span ends just after a newline (or at EOF)."""
    size = os.path.getsize(path)
    spans: list[tuple[int, int]] = []
    with open(path, "rb") as f:
        lo = 0
        while lo < size:
            hi = min(lo + chunk_bytes, size)
            if hi < size:
                f.seek(hi)
                f.readline()           # advance to the end of this line
                hi = min(f.tell(), size)
            spans.append((lo, hi))
            lo = hi
    return spans


def _decode_file_span(path: str, lo: int, hi: int) -> tuple[EventBatch, int]:
    with open(path, "rb") as f:
        f.seek(lo)
        data = f.read(hi - lo)
    return decode_jsonl_lines(data.split(b"\n"))


def _make_executor(executor: str, workers: int):
    """``executor`` is pre-validated by :func:`iter_jsonl_chunks`."""
    if executor == "process":
        from concurrent.futures import ProcessPoolExecutor
        try:
            return ProcessPoolExecutor(workers)
        except (OSError, ValueError) as e:   # no fork/spawn available
            warnings.warn(f"process executor unavailable ({e}); falling "
                          "back to threads", stacklevel=3)
    from concurrent.futures import ThreadPoolExecutor
    return ThreadPoolExecutor(workers)


# Below this file size, concurrent chunk decode LOSES to one serial pass:
# per-chunk executor overhead plus GIL contention (thread) or worker
# spawn + pickle cost (process) outweigh the parallel decode of a file
# that one json pass clears in well under a second.  Measured on the
# 256-rank fleet bench (~7 MB logs) where chunked decode ran 0.9x and
# process-pool 0.7x the plain line decoder.
SERIAL_DECODE_BYTES = 24 << 20


def _default_workers(executor: str) -> int:
    """Thread decode contends on the GIL between array-parse slabs, so
    more than a few threads just adds switching; process workers scale
    with cores until pickle traffic dominates."""
    cores = os.cpu_count() or 1
    return min(4, cores) if executor == "thread" else min(8, cores)


def iter_jsonl_chunks(path: str, *, chunk_bytes: int = 8 << 20,
                      max_workers: Optional[int] = None,
                      executor: str = "thread",
                      serial_below: Optional[int] = None,
                      ) -> Iterator[tuple[EventBatch, int]]:
    """Yield ``(EventBatch, skipped_lines)`` per line-aligned chunk of
    ``path``, decoding chunks concurrently but yielding in file order (so
    streaming consumers see events in log order).  In-flight decodes are
    capped at ``workers + 2`` so a slow consumer (e.g. replay driving
    diagnosis) bounds memory instead of buffering the whole decoded file.

    Files below ``serial_below`` bytes (default
    :data:`SERIAL_DECODE_BYTES`; pass ``0`` to force chunking) are
    decoded inline in one pass with no executor: on small-to-mid logs
    the parallel machinery is pure overhead and was measurably SLOWER
    than the line decoder.

    ``executor="process"`` decodes chunks in worker processes —
    ``json.loads`` holds the GIL, so threads cannot scale decode past one
    core, while batches cross the process boundary as cheap numpy-column
    pickles."""
    if executor not in ("thread", "process"):
        raise ValueError(f"executor must be 'thread' or 'process', "
                         f"got {executor!r}")
    threshold = SERIAL_DECODE_BYTES if serial_below is None else serial_below
    size = os.path.getsize(path)
    if size == 0:
        return
    if size < max(threshold, chunk_bytes + 1):
        yield _decode_file_span(path, 0, size)
        return
    spans = _chunk_spans(path, chunk_bytes)
    if len(spans) <= 1:
        if spans:
            yield _decode_file_span(path, *spans[0])
        return
    from collections import deque
    workers = max_workers or _default_workers(executor)
    with _make_executor(executor, workers) as ex:
        window = workers + 2
        futs = deque(ex.submit(_decode_file_span, path, *sp)
                     for sp in spans[:window])
        nxt = window
        while futs:
            yield futs.popleft().result()
            if nxt < len(spans):
                futs.append(ex.submit(_decode_file_span, path, *spans[nxt]))
                nxt += 1


def read_jsonl(path: str, *, with_skip_count: bool = False):
    """Line-by-line decode of a whole file.  Truncated/corrupt lines
    (common in logs of killed jobs) are SKIPPED with one counted warning
    instead of raising; ``with_skip_count=True`` returns
    ``(batch, skipped)``."""
    with open(path) as f:
        batch, skipped = decode_jsonl_lines(f)
    if skipped:
        warnings.warn(f"{path}: skipped {skipped} corrupt/truncated "
                      "JSONL line(s)", stacklevel=2)
    return (batch, skipped) if with_skip_count else batch


def read_jsonl_chunked(path: str, *, chunk_bytes: int = 8 << 20,
                       max_workers: Optional[int] = None,
                       executor: str = "thread",
                       serial_below: Optional[int] = None,
                       with_skip_count: bool = False):
    """Chunked/parallel decode of a whole file (identical result to
    :func:`read_jsonl` — interning order is first appearance in file
    order either way).  This is the replay fast path for multi-GB logs;
    small files auto-fall back to one serial pass (``serial_below``)."""
    parts: list[EventBatch] = []
    skipped = 0
    for b, sk in iter_jsonl_chunks(path, chunk_bytes=chunk_bytes,
                                   max_workers=max_workers,
                                   executor=executor,
                                   serial_below=serial_below):
        parts.append(b)
        skipped += sk
    batch = EventBatch.concat(parts)
    if skipped:
        warnings.warn(f"{path}: skipped {skipped} corrupt/truncated "
                      "JSONL line(s)", stacklevel=2)
    return (batch, skipped) if with_skip_count else batch


class JsonlCodec:
    """``TraceCodec`` facade over the module functions."""

    name = "jsonl"
    extensions = (".jsonl", ".json")

    def write(self, batch: EventBatch, path: str) -> int:
        return dump_jsonl(batch, path)

    def read(self, path: str, *, with_skip_count: bool = False):
        return read_jsonl(path, with_skip_count=with_skip_count)

    def iter_chunks(self, path: str, *, chunk_bytes: int = 8 << 20,
                    max_workers: Optional[int] = None,
                    executor: str = "thread",
                    serial_below: Optional[int] = None, **_ignored
                    ) -> Iterator[tuple[EventBatch, int]]:
        return iter_jsonl_chunks(path, chunk_bytes=chunk_bytes,
                                 max_workers=max_workers, executor=executor,
                                 serial_below=serial_below)
