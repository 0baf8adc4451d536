"""FCS — Flare Columnar Segment: numpy-native binary trace storage.

JSONL replay is json-parse-bound (~0.1 Mev/s/core); a fleet that records
for months needs a format whose decode cost is ~zero.  FCS writes the
``EventBatch`` columns themselves: each ``write`` call appends one
self-contained *segment* — a small header, interning tables, and raw
little-endian column slabs — so reading is a header parse plus
``np.frombuffer`` views straight off an ``np.memmap`` (timestamp slabs
are zero-copy; narrowed columns pay one vectorized ``astype``).  No
per-row work, ever.

Compactness comes from per-column encodings picked at write time, all
lossless:

  ABSENT  column is all-null (0 bytes)
  CONST   all rows equal (one value)
  RAW     narrowest integer dtype that fits the value range
  DICT    value table + per-row codes (flops/bytes/tokens carry a handful
          of distinct per-op values across millions of rows; float tables
          are stored as raw u64 bit patterns so NaN round-trips exactly)
  SAMEAS  column is bit-identical to another (CPU spans: issue == start)

``extra`` meta dicts are dict-encoded too: a table of unique dicts
(Python-literal ``repr`` when it round-trips — preserving tuples exactly,
which JSON cannot — else JSON) plus sparse (row, code) index columns.

Three segment versions share the header and reader (dispatch is on the
header version field, so one file may even mix them — e.g. a daemon
restarted with a different spill config):

  v1  column slabs stored raw; decoding is zero-copy ``np.memmap`` views
      (the online / hot-replay format);
  v2  each column slab individually compressed (zstd when available,
      stdlib zlib otherwise; RAW slabs byte-shuffled first) — the
      archival format, ~2-3x smaller again, trading the memmap fast path
      for a per-slab inflate.  Header, interning blobs, and the column
      directory stay uncompressed so magic sniffing, segment skipping,
      and per-column tooling keep working.  Write it via the ``fcs2``
      codec (:class:`FcsV2Codec`) or ``write_fcs(..., version=2)``.
  v3  v2 plus a CRC-protected **statistics block** between the column
      directory and the payloads (step/time/rank ranges, an event-kind
      presence bitmask, per-column min/max — see ``repro.store.stats``):
      the queryable-archive format.  Readers prune whole segments on a
      :class:`~repro.store.stats.Predicate` without inflating a single
      slab (``iter_segments(path, predicate=...)``), and
      :func:`segment_stats` iterates the stats directory alone.  Write
      it via the ``fcs3`` codec (:class:`FcsV3Codec`) or
      ``write_fcs(..., version=3)``.

The exact byte layout is documented in ``src/repro/store/README.md``.
Corruption (bad magic, unknown version, a truncated tail from a killed
writer) raises :class:`~repro.store.base.CodecError` with file + byte
offset; ``iter_chunks`` yields every intact leading segment first so
replay can skip-and-count the broken tail.
"""
from __future__ import annotations

import ast
import json
import mmap
import os
import struct
from typing import Iterator, Optional

import numpy as np

from repro_torch.core.columnar import NO_INT, EventBatch
from repro_torch.store import compress as _comp
from repro_torch.store.base import CodecError
from repro_torch.store.stats import (Predicate, ScanStats, SegmentStats,
                                     decode_stats_block, encode_stats_block,
                                     stats_size)

MAGIC = b"FCS1"
VERSION = 1                              # default (raw-slab) segment version
VERSION_V2 = 2                           # compressed-slab segment version
VERSION_V3 = 3                           # v2 + per-segment stats block
_VERSIONS = (VERSION, VERSION_V2, VERSION_V3)

# header: magic, version, ncols, n_rows, seg_len, names_len, groups_len,
# extra_len — 48 bytes, so the blob region after it stays 8-aligned.
# Identical for v1 and v2 (seg_len is always the on-disk byte count).
_HEADER = struct.Struct("<4sHHQQQQQ")
_DIRENT = struct.Struct("<BBBBI")        # v1: col_id, enc, dtype/src, 0, len
# v2: col_id, enc, dtype/src, comp (backend | FLAG_SHUFFLE),
#     compressed len, raw len
_DIRENT2 = struct.Struct("<BBBBII")

# slabs below this stay uncompressed in v2: backend framing would only
# grow them, and they are noise next to the timestamp slabs anyway
_MIN_COMPRESS_BYTES = 128

# encodings
ENC_ABSENT, ENC_CONST, ENC_RAW, ENC_DICT, ENC_SAMEAS = range(5)

# storage dtypes (little-endian), ordered by itemsize for narrowing
_DTYPES = ("<u1", "<i1", "<u2", "<i2", "<u4", "<i4", "<i8", "<f8")
_DT_CODE = {dt: i for i, dt in enumerate(_DTYPES)}
_U64 = np.dtype("<u8")

# column table: (slot, runtime dtype, null value, wide storage dtype)
# the two trailing pseudo-columns hold the sparse extra-dict index.
_COLUMNS = (
    ("kind",     np.uint8,   0,       "<u1"),
    ("name_id",  np.int32,   0,       "<i4"),
    ("rank",     np.int32,   0,       "<i4"),
    ("issue_ts", np.float64, 0.0,     "<f8"),
    ("start_ts", np.float64, 0.0,     "<f8"),
    ("end_ts",   np.float64, 0.0,     "<f8"),
    ("step",     np.int32,   -1,      "<i4"),
    ("flops",    np.float64, np.nan,  "<f8"),
    ("nbytes",   np.int64,   NO_INT,  "<i8"),
    ("tokens",   np.int64,   NO_INT,  "<i8"),
    ("group_id", np.int16,   -1,      "<i2"),
    ("_extra_rows",  np.int64, 0, "<i8"),
    ("_extra_codes", np.int64, 0, "<i8"),
)
NCOLS = len(_COLUMNS)
_TS_COLS = (3, 4, 5)
_VALUE_COLS = (7, 8, 9)       # sparse numeric meta: DICT-friendly


def _pad8(n: int) -> int:
    return -n % 8


def _narrowest(mn: int, mx: int) -> str:
    for dt in ("<u1", "<i1", "<u2", "<i2", "<u4", "<i4", "<i8"):
        info = np.iinfo(dt)
        if info.min <= mn and mx <= info.max:
            return dt
    return "<i8"


def _code_dtype(n_values: int) -> str:
    return "<u1" if n_values <= 0xFF else \
           "<u2" if n_values <= 0xFFFF else "<u4"


# --------------------------------------------------------------------- #
# encode
# --------------------------------------------------------------------- #
def _encode_int_col(arr: np.ndarray, *, allow_const: bool = True
                    ) -> tuple[int, str, bytes]:
    """(enc, storage dtype, payload) for an integer column.  The sparse
    extra index columns pass ``allow_const=False``: their length is not
    ``n_rows``, so the decoder must be able to derive it from the payload
    size (RAW only)."""
    if arr.size == 0:
        return ENC_ABSENT, "<u1", b""
    mn, mx = int(arr.min()), int(arr.max())
    dt = _narrowest(mn, mx)
    if mn == mx and allow_const:
        return ENC_CONST, dt, arr[:1].astype(dt).tobytes()
    return ENC_RAW, dt, arr.astype(dt).tobytes()


def _encode_value_col(arr: np.ndarray, null, wide: str
                      ) -> tuple[int, str, bytes]:
    """flops/nbytes/tokens: ABSENT / CONST / DICT / RAW over full-width
    values.  Floats are dict-encoded as u64 bit patterns so NaN behaves
    like any other value (bit-exact, one table slot)."""
    n = arr.size
    is_f = arr.dtype.kind == "f"
    if n == 0:
        return ENC_ABSENT, "<u1", b""
    if is_f:
        if bool(np.isnan(arr).all()):
            return ENC_ABSENT, "<u1", b""
    elif bool((arr == null).all()):
        return ENC_ABSENT, "<u1", b""
    bits = arr.view(_U64) if is_f else arr
    table, codes = np.unique(bits, return_inverse=True)
    if table.size == 1:
        return ENC_CONST, wide, arr[:1].astype(wide).tobytes()
    cdt = _code_dtype(table.size)
    dict_size = 4 + table.size * 8 + n * np.dtype(cdt).itemsize
    if dict_size < n * 8:
        payload = (struct.pack("<I", table.size)
                   + table.astype("<u8" if is_f else "<i8").tobytes()
                   + codes.astype(cdt).tobytes())
        return ENC_DICT, cdt, payload
    return ENC_RAW, wide, arr.astype(wide).tobytes()


def _encode_ts_col(arr: np.ndarray, col_id: int, batch: EventBatch
                   ) -> tuple[int, str, bytes]:
    if arr.size == 0:
        return ENC_ABSENT, "<u1", b""
    # start_ts (col 4) is the canonical timeline; issue/end frequently
    # alias it bit-for-bit (CPU spans, hang markers)
    if col_id != 4 and np.array_equal(arr, batch.start_ts):
        return ENC_SAMEAS, "<f8", b""
    if bool((arr == arr[0]).all()):
        return ENC_CONST, "<f8", arr[:1].astype("<f8").tobytes()
    return ENC_RAW, "<f8", arr.astype("<f8").tobytes()


def _encode_extra(batch: EventBatch
                  ) -> tuple[bytes, np.ndarray, np.ndarray]:
    """Dedupe the row->dict table: returns (json table blob, rows, codes).

    Unique dicts (by identity first — the daemon shares one meta dict
    across a whole rank-vector — then by serialized form) are stored once
    as ``p:<repr>`` when ``ast.literal_eval`` round-trips (tuples survive)
    or ``j:<json>`` otherwise."""
    if not batch.extra:
        return b"", np.empty(0, np.int64), np.empty(0, np.int64)
    table: list[str] = []
    code_by_key: dict[str, int] = {}
    code_by_id: dict[int, int] = {}
    rows = np.fromiter(sorted(batch.extra), np.int64, len(batch.extra))
    codes = np.empty(rows.size, np.int64)
    for i, row in enumerate(rows.tolist()):
        d = batch.extra[row]
        c = code_by_id.get(id(d))
        if c is None:
            key = _serialize_meta(d)
            c = code_by_key.get(key)
            if c is None:
                c = code_by_key[key] = len(table)
                table.append(key)
            code_by_id[id(d)] = c
        codes[i] = c
    return json.dumps(table, separators=(",", ":")).encode(), rows, codes


def _serialize_meta(d: dict) -> str:
    r = repr(d)
    try:
        if ast.literal_eval(r) == d:
            return "p:" + r
    except (ValueError, SyntaxError, MemoryError):
        pass
    try:
        return "j:" + json.dumps(d)
    except (TypeError, ValueError) as e:
        raise CodecError(f"meta dict not serializable for FCS: {d!r} "
                         f"({e})") from e


def _deserialize_meta(s: str) -> dict:
    if s.startswith("p:"):
        return ast.literal_eval(s[2:])
    return json.loads(s[2:])


def _compress_slab(payload: bytes, enc: int, dt_byte: int, backend: int,
                   level: Optional[int]) -> tuple[int, bytes]:
    """(comp byte, on-disk bytes) for one v2 slab.  RAW slabs of multi-
    byte values are byte-shuffled first (timestamps dominate segment
    size and shuffle is what makes them compress); a slab that would not
    shrink is stored verbatim so v2 never exceeds v1 + directory."""
    if backend == _comp.COMP_STORED or len(payload) < _MIN_COMPRESS_BYTES:
        return _comp.COMP_STORED, payload
    flags = 0
    data = payload
    if enc == ENC_RAW:
        itemsize = np.dtype(_DTYPES[dt_byte]).itemsize
        if itemsize > 1:
            data = _comp.shuffle(payload, itemsize)
            flags = _comp.FLAG_SHUFFLE
    cdata = _comp.compress(data, backend, level)
    if len(cdata) >= len(payload):
        return _comp.COMP_STORED, payload
    return backend | flags, cdata


def encode_segment(batch: EventBatch, *, version: int = VERSION,
                   compression: Optional[str] = None,
                   level: Optional[int] = None) -> bytes:
    """One self-contained segment for ``batch`` (appendable bytes).

    ``version=2`` compresses each column slab (``compression`` names the
    backend — ``"zstd"``/``"zlib"``/``None`` = best available — and
    ``level`` its setting); header, interning blobs, and the column
    directory stay plain.  ``version=3`` additionally writes the stats
    block (pruning directory) between the directory and the payloads."""
    if version not in _VERSIONS:
        raise ValueError(f"unsupported FCS segment version {version}")
    n = len(batch)
    names_blob = json.dumps(batch.names, separators=(",", ":")).encode() \
        if batch.names else b""
    groups_blob = json.dumps(batch.groups, separators=(",", ":")).encode() \
        if batch.groups else b""
    extra_blob, extra_rows, extra_codes = _encode_extra(batch)
    backend = _comp.resolve_backend(compression) if version != VERSION \
        else None

    entries: list[bytes] = []
    payloads: list[bytes] = []
    cols = (batch.kind, batch.name_id, batch.rank, batch.issue_ts,
            batch.start_ts, batch.end_ts, batch.step, batch.flops,
            batch.nbytes, batch.tokens, batch.group_id,
            extra_rows, extra_codes)
    for col_id, ((_, _, null, wide), arr) in enumerate(zip(_COLUMNS, cols)):
        if col_id in _TS_COLS:
            enc, dt, payload = _encode_ts_col(arr, col_id, batch)
        elif col_id in _VALUE_COLS:
            enc, dt, payload = _encode_value_col(arr, null, wide)
        else:
            enc, dt, payload = _encode_int_col(arr, allow_const=col_id < 11)
        # SAMEAS stores the source column id (always start_ts) in the
        # dtype slot
        dt_byte = 4 if enc == ENC_SAMEAS else _DT_CODE[dt]
        if version != VERSION:
            comp, disk = _compress_slab(payload, enc, dt_byte, backend,
                                        level)
            entries.append(_DIRENT2.pack(col_id, enc, dt_byte, comp,
                                         len(disk), len(payload)))
        else:
            disk = payload
            entries.append(_DIRENT.pack(col_id, enc, dt_byte, 0,
                                        len(payload)))
        payloads.append(disk + b"\0" * _pad8(len(disk)))

    directory = b"".join(entries)
    stats = encode_stats_block(cols) if version == VERSION_V3 else b""
    blob = names_blob + groups_blob + extra_blob
    body = blob + b"\0" * _pad8(len(blob)) + directory \
        + b"\0" * _pad8(len(directory)) + stats + b"".join(payloads)
    seg_len = _HEADER.size + len(body)
    header = _HEADER.pack(MAGIC, version, NCOLS, n, seg_len,
                          len(names_blob), len(groups_blob),
                          len(extra_blob))
    return header + body


# --------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------- #
def _view(buf, dtype: str, count: int, offset: int,
          path: Optional[str] = None) -> np.ndarray:
    try:
        return np.frombuffer(buf, dtype, count, offset)
    except ValueError as e:
        raise CodecError(f"column slab out of bounds ({e})",
                         path=path, offset=offset) from e


def _decode_col(arrays, sameas, col_id: int, enc: int, dt_byte: int,
                buf, pos: int, plen: int, n: int, path: str) -> None:
    """Decode one column slab (``plen`` raw bytes of ``buf`` at ``pos``)
    into ``arrays[col_id]``.  Shared by v1 (slab = file view) and v2
    (slab = inflated bytes)."""
    _, rdtype, null, _wide = _COLUMNS[col_id]

    def _need(expected: int):
        # a corrupted length field must fail loudly here: frombuffer
        # reads from `pos` regardless of plen while the cursor advances
        # BY plen, so a mismatch would silently shift every later column
        if plen != expected:
            raise CodecError(
                f"column {col_id} slab length {plen} != expected "
                f"{expected} for encoding {enc}", path=path, offset=pos)

    if enc == ENC_ABSENT:
        _need(0)
        # the sparse extra index columns (11, 12) carry their own
        # length; every real column has n_rows entries
        arrays[col_id] = np.empty(0, np.int64) if col_id >= 11 \
            else np.full(n, null, rdtype)
    elif enc == ENC_SAMEAS:
        _need(0)
        sameas.append((col_id, dt_byte))
    elif enc == ENC_CONST:
        dt = _DTYPES[dt_byte]
        _need(np.dtype(dt).itemsize)
        arrays[col_id] = np.full(n, _view(buf, dt, 1, pos, path)[0],
                                 rdtype)
    elif enc == ENC_RAW:
        dt = _DTYPES[dt_byte]
        isz = np.dtype(dt).itemsize
        if col_id < 11:
            _need(n * isz)
            cnt = n
        else:
            if plen % isz:
                raise CodecError(f"column {col_id} slab length {plen} "
                                 f"not a multiple of itemsize {isz}",
                                 path=path, offset=pos)
            cnt = plen // isz
        a = _view(buf, dt, cnt, pos, path)
        arrays[col_id] = a if a.dtype == np.dtype(rdtype) \
            else a.astype(rdtype)
    elif enc == ENC_DICT:
        cdt = _DTYPES[dt_byte]
        if plen < 4:
            raise CodecError(f"column {col_id} DICT payload too short",
                             path=path, offset=pos)
        (ntab,) = struct.unpack_from("<I", buf, pos)
        _need(4 + ntab * 8 + n * np.dtype(cdt).itemsize)
        is_f = np.dtype(rdtype).kind == "f"
        table = _view(buf, "<u8" if is_f else "<i8", ntab, pos + 4, path)
        codes = _view(buf, cdt, n, pos + 4 + ntab * 8, path)
        if codes.size and int(codes.max()) >= ntab:
            raise CodecError(f"column {col_id} DICT code "
                             f"{int(codes.max())} out of table range "
                             f"{ntab}", path=path, offset=pos)
        out = table[codes]
        arrays[col_id] = out.view(np.float64) if is_f \
            else out.astype(rdtype, copy=False)
    else:
        raise CodecError(f"unknown encoding {enc} for column {col_id}",
                         path=path, offset=pos)


def _inflate_slab(buf, pay: int, clen: int, rlen: int, comp: int,
                  dt_byte: int, path: str) -> bytes:
    """v2 slab -> raw bytes: decompress with the per-slab backend, then
    undo the byte shuffle when the writer applied one."""
    backend = comp & _comp.COMP_MASK
    if backend == _comp.COMP_STORED:
        data = bytes(buf[pay:pay + clen])
        if len(data) != rlen:
            raise CodecError(f"stored slab is {len(data)} bytes, "
                             f"directory declares {rlen}",
                             path=path, offset=pay)
    else:
        data = _comp.decompress(buf[pay:pay + clen], backend, rlen,
                                path=path, offset=pay)
    if comp & _comp.FLAG_SHUFFLE:
        if dt_byte >= len(_DTYPES):
            raise CodecError(f"shuffled slab with bad dtype byte {dt_byte}",
                             path=path, offset=pay)
        isz = np.dtype(_DTYPES[dt_byte]).itemsize
        if isz <= 1 or len(data) % isz:
            raise CodecError("shuffled slab length inconsistent with "
                             f"dtype itemsize {isz}", path=path, offset=pay)
        data = _comp.unshuffle(data, isz)
    return data


def _parse_header(buf, off: int, path: str):
    """Validate + unpack one segment header; returns ``(version, ncols,
    n_rows, seg_len, names_len, groups_len, extra_len)``."""
    size = len(buf)
    if off + _HEADER.size > size:
        raise CodecError("truncated segment header "
                         f"({size - off} bytes left, need {_HEADER.size})",
                         path=path, offset=off)
    magic, version, ncols, n, seg_len, names_len, groups_len, extra_len = \
        _HEADER.unpack_from(buf, off)
    if magic != MAGIC:
        raise CodecError(f"bad magic {magic!r} (expected {MAGIC!r})",
                         path=path, offset=off)
    if version not in _VERSIONS:
        raise CodecError(f"unsupported FCS version {version}",
                         path=path, offset=off)
    if seg_len < _HEADER.size:
        raise CodecError(f"implausible segment length {seg_len}",
                         path=path, offset=off)
    if off + seg_len > size:
        raise CodecError("truncated segment: partial slab "
                         f"(need {seg_len} bytes, {size - off} left)",
                         path=path, offset=off)
    return version, ncols, n, seg_len, names_len, groups_len, extra_len


def _stats_offset(off: int, ncols: int, names_len: int, groups_len: int,
                  extra_len: int, dirent_size: int) -> int:
    """Byte offset of a v3 segment's stats block (right after the padded
    column directory)."""
    blob = names_len + groups_len + extra_len
    dir_bytes = ncols * dirent_size
    return off + _HEADER.size + blob + _pad8(blob) \
        + dir_bytes + _pad8(dir_bytes)


def decode_segment(buf, off: int, path: str) -> tuple[EventBatch, int]:
    """Decode one segment of ``buf`` starting at byte ``off``; returns
    ``(batch, next_offset)``.  Dispatches on the header version field
    (v1 raw slabs / v2 compressed slabs / v3 compressed slabs + stats
    block, whose CRC is verified here so corruption never goes quiet).
    Raises :class:`CodecError` on a bad magic, unsupported version, or a
    slab truncated by a killed writer."""
    version, ncols, n, seg_len, names_len, groups_len, extra_len = \
        _parse_header(buf, off, path)
    if ncols < NCOLS:
        raise CodecError(f"segment declares {ncols} columns, need {NCOLS}",
                         path=path, offset=off)

    p = off + _HEADER.size
    try:
        names = json.loads(bytes(buf[p:p + names_len]) or b"[]")
        groups = json.loads(
            bytes(buf[p + names_len:p + names_len + groups_len]) or b"[]")
        eb = bytes(buf[p + names_len + groups_len:
                       p + names_len + groups_len + extra_len])
        extra_table = [_deserialize_meta(s) for s in json.loads(eb)] \
            if eb else []
    except (ValueError, SyntaxError) as e:
        raise CodecError(f"corrupt interning/meta tables ({e})",
                         path=path, offset=p) from e
    blob = names_len + groups_len + extra_len
    p += blob + _pad8(blob)
    dirent = _DIRENT if version == VERSION else _DIRENT2
    dir_bytes = ncols * dirent.size
    if p + dir_bytes > off + seg_len:
        raise CodecError("column directory overruns segment "
                         "(corrupt blob lengths)", path=path, offset=p)

    arrays: list[Optional[np.ndarray]] = [None] * NCOLS
    sameas: list[tuple[int, int]] = []
    pay = p + dir_bytes + _pad8(dir_bytes)
    if version == VERSION_V3:
        # verify the stats block even on a full decode: a bit-flipped
        # stats entry must fail loudly here, not mis-prune a later scan
        decode_stats_block(buf, pay, ncols, off, seg_len, n, version,
                           path=path)
        pay += stats_size(ncols)
    for i in range(ncols):
        ent = p + i * dirent.size
        if version == VERSION:
            col_id, enc, dt_byte, _, disk_len = _DIRENT.unpack_from(buf, ent)
        else:
            col_id, enc, dt_byte, comp, disk_len, raw_len = \
                _DIRENT2.unpack_from(buf, ent)
        if pay + disk_len > off + seg_len:
            raise CodecError(f"column {col_id} slab overruns segment",
                             path=path, offset=pay)
        if col_id >= NCOLS:      # forward-compat: ignore unknown columns
            pay += disk_len + _pad8(disk_len)
            continue
        if version == VERSION:
            # raw slab decoded in place: memmap views stay zero-copy
            _decode_col(arrays, sameas, col_id, enc, dt_byte,
                        buf, pay, disk_len, n, path)
        else:
            slab = _inflate_slab(buf, pay, disk_len, raw_len, comp,
                                 dt_byte, path)
            _decode_col(arrays, sameas, col_id, enc, dt_byte,
                        slab, 0, raw_len, n, path)
        pay += disk_len + _pad8(disk_len)
    for col_id, src in sameas:
        if arrays[src] is None:
            raise CodecError(f"SAMEAS column {col_id} references "
                             f"unresolved column {src}", path=path, offset=off)
        arrays[col_id] = arrays[src]

    extra: dict[int, dict] = {}
    rows_a, codes_a = arrays[11], arrays[12]
    if rows_a is not None and rows_a.size:
        for r, c in zip(rows_a.tolist(), codes_a.tolist()):
            try:
                extra[int(r)] = extra_table[int(c)]
            except IndexError:
                raise CodecError(f"extra code {c} out of table range",
                                 path=path, offset=off) from None
    batch = EventBatch(arrays[0], arrays[1], arrays[2], arrays[3],
                       arrays[4], arrays[5], arrays[6], arrays[7],
                       arrays[8], arrays[9], arrays[10],
                       list(names), list(groups), extra)
    return batch, off + seg_len


def _open_buffer(path: str, use_mmap: bool):
    """Map (or read) the file; a memory-map keeps decoded column views
    zero-copy, and the views hold a reference to the map so they stay
    valid after every file handle is closed."""
    with open(path, "rb") as f:
        if not use_mmap:
            return f.read()
        size = os.fstat(f.fileno()).st_size
        if size == 0:
            return b""
        return mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)


def _segment_stats_at(buf, off: int, path: str) -> SegmentStats:
    """Stats for the segment at ``off`` without touching any slab: v3
    parses + CRC-checks the stats block; v1/v2 return header-only facts
    with ``has_stats=False`` (meaning "cannot prune")."""
    version, ncols, n, seg_len, names_len, groups_len, extra_len = \
        _parse_header(buf, off, path)
    if version != VERSION_V3:
        return SegmentStats(offset=off, seg_len=seg_len, n_rows=n,
                            version=version)
    spos = _stats_offset(off, ncols, names_len, groups_len, extra_len,
                         _DIRENT2.size)
    return decode_stats_block(buf, spos, ncols, off, seg_len, n, version,
                              path=path)


def segment_stats(path: str, *, use_mmap: bool = True
                  ) -> Iterator[SegmentStats]:
    """Iterate the file's stats directory alone — header + stats block
    per segment, hopping by ``seg_len`` — never inflating a column slab.
    v1/v2 segments yield header-only entries (``has_stats=False``);
    corrupt stats blocks raise :class:`CodecError`."""
    buf = _open_buffer(path, use_mmap)
    off = 0
    size = len(buf)
    while off < size:
        try:
            st = _segment_stats_at(buf, off, path)
        except CodecError:
            raise
        except (struct.error, IndexError, ValueError, KeyError) as e:
            raise CodecError(f"corrupt segment ({type(e).__name__}: {e})",
                             path=path, offset=off) from e
        yield st
        off += st.seg_len


def iter_segments(path: str, *, use_mmap: bool = True,
                  predicate: Optional[Predicate] = None,
                  scan: Optional[ScanStats] = None
                  ) -> Iterator[EventBatch]:
    """Yield each intact segment in file order; raises
    :class:`CodecError` at the first corrupt one (after yielding every
    good segment before it).  Bit-rot that slips past the structural
    checks (e.g. a flipped dtype byte making a slab misparse) is
    rewrapped so replay's skip-and-count contract holds.

    With a ``predicate``, v3 segments whose stats prove no row can match
    are skipped on the stats block alone — no slab is inflated, the scan
    just hops ``seg_len`` bytes.  Pruning is segment-granular and
    conservative: yielded segments may still contain non-matching rows
    (callers wanting exact rows apply ``predicate.filter``), and v1/v2
    segments always decode.  Pass a :class:`ScanStats` as ``scan`` to
    account decoded vs skipped bytes."""
    buf = _open_buffer(path, use_mmap)
    off = 0
    size = len(buf)
    prune = predicate is not None and not predicate.empty
    while off < size:
        try:
            if prune:
                st = _segment_stats_at(buf, off, path)
                if st.version == VERSION_V3 and not predicate.may_match(st):
                    if scan is not None:
                        scan.segments += 1
                        scan.segments_skipped += 1
                        scan.bytes_skipped += st.seg_len
                    off += st.seg_len
                    continue
            batch, next_off = decode_segment(buf, off, path)
        except CodecError:
            raise
        except (struct.error, IndexError, ValueError, KeyError) as e:
            raise CodecError(f"corrupt segment ({type(e).__name__}: {e})",
                             path=path, offset=off) from e
        if scan is not None:
            scan.segments += 1
            scan.bytes_decoded += next_off - off
            scan.rows += len(batch)
        off = next_off
        yield batch


def read_fcs(path: str, *, with_skip_count: bool = False,
             use_mmap: bool = True):
    """Decode a whole (possibly multi-segment) file into one batch."""
    parts = list(iter_segments(path, use_mmap=use_mmap))
    batch = parts[0] if len(parts) == 1 else EventBatch.concat(parts)
    return (batch, 0) if with_skip_count else batch


def write_fcs(batch: EventBatch, path: str, *, version: int = VERSION,
              compression: Optional[str] = None,
              level: Optional[int] = None) -> int:
    """Append one segment; returns bytes written.  ``version=2`` writes a
    compressed archival segment, ``version=3`` adds the stats block
    (see :func:`encode_segment`)."""
    seg = encode_segment(batch, version=version, compression=compression,
                         level=level)
    with open(path, "ab") as f:
        f.write(seg)
    return len(seg)


def encode_batch_bytes(batch: EventBatch, *, version: int = VERSION_V2,
                       compression: Optional[str] = None,
                       level: Optional[int] = None) -> bytes:
    """One in-memory FCS segment for ``batch`` — the fleet IPC wire
    format.  Identical bytes to what :func:`write_fcs` appends to disk,
    so a batch shipped across a process boundary costs the same ~11.5
    B/event as the archival spill (v2 compressed slabs by default)
    instead of a numpy pickle.  Round-trips through
    :func:`decode_batch_bytes`."""
    return encode_segment(batch, version=version, compression=compression,
                          level=level)


def tail_complete_segments(path: str, offset: int = 0
                           ) -> tuple[list[EventBatch], int]:
    """Tail a GROWING FCS stream: decode every segment that is complete
    on disk at/after byte ``offset`` and return ``(batches,
    new_offset)``, leaving a partial trailing segment (a write in
    flight, or fewer bytes than a header) for the next call — resume by
    passing ``new_offset`` back in.  This is how a live tailer follows a
    :class:`~repro.store.writer.SegmentedTraceWriter` file without ever
    racing the writer's appends: segment boundaries are the commit
    points.  Structural corruption at a completed offset (bad magic,
    bad version, CRC) raises :class:`CodecError` exactly like
    :func:`iter_segments` — a torn tail that never completes is the
    CALLER's corruption signal at end of stream."""
    with open(path, "rb") as f:
        f.seek(offset)
        data = f.read()
    out: list[EventBatch] = []
    off = 0
    size = len(data)
    while size - off >= _HEADER.size:
        magic, _version, _ncols, _n, seg_len = \
            _HEADER.unpack_from(data, off)[:5]
        if magic != MAGIC:
            raise CodecError(f"bad magic {magic!r} (expected {MAGIC!r})",
                             path=path, offset=offset + off)
        if seg_len < _HEADER.size:
            raise CodecError(f"implausible segment length {seg_len}",
                             path=path, offset=offset + off)
        if off + seg_len > size:
            break                    # incomplete tail: write in flight
        try:
            batch, off = decode_segment(data, off, path)
        except CodecError:
            raise
        except (struct.error, IndexError, ValueError, KeyError) as e:
            raise CodecError(f"corrupt segment ({type(e).__name__}: {e})",
                             path=path, offset=offset + off) from e
        out.append(batch)
    return out, offset + off


def decode_batch_bytes(buf) -> EventBatch:
    """Decode one or more concatenated FCS segments from an in-memory
    buffer (bytes/memoryview) into a single batch.  The inverse of
    :func:`encode_batch_bytes`; multi-segment buffers concat in order."""
    parts: list[EventBatch] = []
    off = 0
    size = len(buf)
    while off < size:
        batch, off = decode_segment(buf, off, "<memory>")
        parts.append(batch)
    if not parts:
        return EventBatch.empty()
    return parts[0] if len(parts) == 1 else EventBatch.concat(parts)


class FcsCodec:
    """v1 (raw-slab) writer; the read side handles both versions, so one
    file may mix v1 and v2 segments and still decode in one pass."""

    name = "fcs"
    extensions = (".fcs",)
    version = VERSION
    compression: Optional[str] = None
    level: Optional[int] = None

    def write(self, batch: EventBatch, path: str) -> int:
        return write_fcs(batch, path, version=self.version,
                         compression=self.compression, level=self.level)

    def read(self, path: str, *, with_skip_count: bool = False):
        return read_fcs(path, with_skip_count=with_skip_count)

    def iter_chunks(self, path: str, *,
                    predicate: Optional[Predicate] = None,
                    scan: Optional[ScanStats] = None, **_ignored
                    ) -> Iterator[tuple[EventBatch, int]]:
        for batch in iter_segments(path, predicate=predicate, scan=scan):
            yield batch, 0


class FcsV2Codec(FcsCodec):
    """Archival FCS: zstd/zlib-compressed column slabs (~2-3x smaller on
    long-horizon logs), same reader, same replay path.  Registered as
    ``"fcs2"`` — select it with ``DaemonConfig(log_codec="fcs2")``, a
    ``.fcs2`` spill extension, or instantiate with an explicit backend
    and level for custom ratio/speed trade-offs."""

    name = "fcs2"
    extensions = (".fcs2",)
    version = VERSION_V2

    def __init__(self, compression: Optional[str] = None,
                 level: Optional[int] = None):
        self.compression = compression
        self.level = level


class FcsV3Codec(FcsV2Codec):
    """Queryable-archive FCS: v2's compressed slabs plus the per-segment
    stats block, so readers prune segments on (step, time, rank,
    severity) predicates without inflating slabs.  ~272 bytes/segment of
    overhead — noise next to any real slab.  Registered as ``"fcs3"`` —
    select it with ``DaemonConfig(log_codec="fcs3")`` or a ``.fcs3``
    spill extension; this is what :class:`repro.archive.TraceArchive`
    expects rotated segments to be written in (though it reads all
    three versions)."""

    name = "fcs3"
    extensions = (".fcs3",)
    version = VERSION_V3
