"""FCS v3 segment statistics: the per-segment pruning directory.

A v3 segment carries a fixed-size **stats block** between the column
directory and the column payloads, written at segment close from the
already-encoded batch.  It holds everything a reader needs to decide
"can any row of this segment match my predicate?" WITHOUT inflating a
single column slab:

  * the segment's step range (over attributed rows, ``step >= 0``),
    event-time range (``min(start_ts) .. max(end_ts)``) and rank range;
  * a presence bitmask over event kinds — HANG_SUSPECT, GC, … — which
    doubles as the *severity* index (:data:`SEVERITY_KINDS` maps named
    severity classes to kind sets, so "any critical event in this
    window?" prunes on bits);
  * per-column min/max for every real column (floats as f8, ints as
    i64), for tooling that filters on e.g. ``flops`` or ``bytes``;
  * a CRC32 over the block, so a truncated or bit-flipped stats entry
    is a loud :class:`~repro.store.base.CodecError` instead of a wrong
    pruning decision.

:class:`Predicate` is the query half: the conservative segment test
(:meth:`Predicate.may_match`) plus the exact row filter
(:meth:`Predicate.filter`) that makes pruned reads byte-equivalent to
full reads — a segment is skipped only when the stats PROVE no row can
match, and segments without stats (v1/v2) always decode.
:class:`ScanStats` counts what a pruned scan actually decoded vs
skipped (the bytes-read accounting ``benchmarks/archive.py`` asserts).
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

import numpy as np

from repro_torch.core.columnar import KIND_TO_CODE, NO_INT
from repro_torch.core.events import EventKind

# --------------------------------------------------------------------- #
# severity classes over event kinds
# --------------------------------------------------------------------- #
# Cumulative severity ladder: "critical" is the daemon screaming (hang
# suspects), "warning" adds interference events (GC pauses, forced
# syncs), "info" is everything.  A severity predicate is sugar for a
# kind-set predicate, which is what the stats bitmask prunes on.
SEVERITY_KINDS: dict[str, tuple[EventKind, ...]] = {
    "critical": (EventKind.HANG_SUSPECT,),
    "warning": (EventKind.HANG_SUSPECT, EventKind.GC, EventKind.SYNC),
    "info": tuple(EventKind),
}


def kind_mask(kinds: Iterable) -> int:
    """Bitmask over kind codes; accepts EventKind members, their string
    values, or raw integer codes."""
    mask = 0
    for k in kinds:
        if isinstance(k, EventKind):
            code = KIND_TO_CODE[k]
        elif isinstance(k, str):
            code = KIND_TO_CODE[EventKind(k)]
        else:
            code = int(k)
        mask |= 1 << code
    return mask


# --------------------------------------------------------------------- #
# on-disk stats block
# --------------------------------------------------------------------- #
# fixed header:  crc32 (over everything after this field), kind_bits,
# step_min/max (i64, over step >= 0 rows; -1 = none), ts_min/max (f8,
# min start_ts / max end_ts), rank_min/max (i64), col_present bitmask,
# 4 pad bytes — 64 bytes, followed by ncols × (min, max) 8-byte pairs
# (floats as <d, ints as <q), so the whole block stays 8-aligned.
STATS_HDR = struct.Struct("<IIqqddqqI4x")
_PAIR_F = struct.Struct("<dd")
_PAIR_I = struct.Struct("<qq")

# column ids whose min/max pair is stored as f8 (mirrors fcs._COLUMNS:
# issue_ts / start_ts / end_ts / flops)
FLOAT_STAT_COLS = frozenset((3, 4, 5, 7))

# batch attribute name -> fcs column id, for value-predicate pushdown
# (``Predicate(columns={"flops": (lo, hi)})``).  Mirrors the real-column
# prefix of fcs._COLUMNS; the sparse extra index columns are internal.
STAT_COLUMNS: dict[str, int] = {
    "kind": 0, "name_id": 1, "rank": 2, "issue_ts": 3, "start_ts": 4,
    "end_ts": 5, "step": 6, "flops": 7, "nbytes": 8, "tokens": 9,
    "group_id": 10,
}

# null sentinels per value column: rows holding the sentinel carry no
# value, so they can never satisfy a bound (mirrors the exclusions
# compute_stats applies when building the per-column min/max)
_NAN_NULL_COLS = frozenset(("flops",))
_INT_NULL_COLS = frozenset(("nbytes", "tokens"))


def stats_size(ncols: int) -> int:
    return STATS_HDR.size + ncols * 16


@dataclass
class SegmentStats:
    """Decoded stats for one segment — or the header-only facts (offset,
    length, row count, version) for a v1/v2 segment, with
    ``has_stats=False`` meaning "cannot prune, must decode"."""
    offset: int
    seg_len: int
    n_rows: int
    version: int
    has_stats: bool = False
    kind_bits: int = 0
    step_min: int = -1          # over attributed rows only; -1 = none
    step_max: int = -1
    ts_min: float = 0.0         # min start_ts
    ts_max: float = 0.0         # max end_ts
    rank_min: int = 0
    rank_max: int = 0
    col_present: int = 0        # bit i: column i min/max is meaningful
    col_min: tuple = ()
    col_max: tuple = ()

    def column_range(self, col_id: int):
        """(min, max) for a column, or None when absent/all-null."""
        if not self.has_stats or not (self.col_present >> col_id) & 1:
            return None
        return self.col_min[col_id], self.col_max[col_id]

    def kinds(self) -> list[EventKind]:
        ks = tuple(EventKind)
        return [ks[i] for i in range(len(ks)) if (self.kind_bits >> i) & 1]


@dataclass
class ScanStats:
    """Accounting for one pruned scan: how much the pushdown actually
    saved.  ``bytes_decoded`` counts the on-disk bytes of segments that
    were decoded; ``bytes_skipped`` those hopped over on stats alone.
    ``truncated`` flags a scan that stopped early because it hit a
    caller-imposed byte budget — the result is an honest PREFIX of the
    full answer, not the full answer."""
    segments: int = 0
    segments_skipped: int = 0
    bytes_decoded: int = 0
    bytes_skipped: int = 0
    rows: int = 0
    truncated: bool = False

    def merge(self, other: "ScanStats") -> None:
        self.segments += other.segments
        self.segments_skipped += other.segments_skipped
        self.bytes_decoded += other.bytes_decoded
        self.bytes_skipped += other.bytes_skipped
        self.rows += other.rows
        self.truncated = self.truncated or other.truncated


def compute_stats(arrays: Sequence[np.ndarray], float_nulls_nan: bool = True
                  ) -> tuple[int, list, list]:
    """(col_present, mins, maxs) over the real columns.  ``arrays`` is
    the fcs column tuple (index = col_id); sparse columns exclude their
    null sentinel (NaN for flops, INT64_MIN for bytes/tokens, -1 for
    group_id stays included — it is a real code)."""
    present = 0
    mins: list = []
    maxs: list = []
    for col_id, arr in enumerate(arrays):
        a = arr
        if a.size and a.dtype.kind == "f" and col_id not in (3, 4, 5):
            a = a[~np.isnan(a)]
        elif a.size and col_id in (8, 9):
            a = a[a != NO_INT]
        if a.size == 0:
            mins.append(0.0 if col_id in FLOAT_STAT_COLS else 0)
            maxs.append(0.0 if col_id in FLOAT_STAT_COLS else 0)
            continue
        present |= 1 << col_id
        if col_id in FLOAT_STAT_COLS:
            mins.append(float(a.min()))
            maxs.append(float(a.max()))
        else:
            mins.append(int(a.min()))
            maxs.append(int(a.max()))
    return present, mins, maxs


def encode_stats_block(arrays: Sequence[np.ndarray]) -> bytes:
    """Serialize the stats block for one segment from its column arrays
    (the same tuple ``encode_segment`` encodes; sparse extra index
    columns get empty stats)."""
    kind_arr, rank_arr = arrays[0], arrays[2]
    step_arr = arrays[6]
    start_arr, end_arr = arrays[4], arrays[5]
    kbits = 0
    if kind_arr.size:
        for code in np.unique(kind_arr).tolist():
            kbits |= 1 << int(code)
    attributed = step_arr[step_arr >= 0] if step_arr.size \
        else np.empty(0, np.int64)
    step_min = int(attributed.min()) if attributed.size else -1
    step_max = int(attributed.max()) if attributed.size else -1
    ts_min = float(start_arr.min()) if start_arr.size else 0.0
    ts_max = float(end_arr.max()) if end_arr.size else 0.0
    rank_min = int(rank_arr.min()) if rank_arr.size else 0
    rank_max = int(rank_arr.max()) if rank_arr.size else 0
    present, mins, maxs = compute_stats(arrays)
    body = STATS_HDR.pack(0, kbits, step_min, step_max, ts_min, ts_max,
                          rank_min, rank_max, present)[4:]
    pairs = []
    for col_id in range(len(arrays)):
        pair = _PAIR_F if col_id in FLOAT_STAT_COLS else _PAIR_I
        pairs.append(pair.pack(mins[col_id], maxs[col_id]))
    tail = b"".join(pairs)
    crc = zlib.crc32(body + tail)
    return struct.pack("<I", crc) + body + tail


def decode_stats_block(buf, pos: int, ncols: int, offset: int,
                       seg_len: int, n_rows: int, version: int,
                       path: Optional[str] = None) -> SegmentStats:
    """Parse + CRC-validate one stats block at ``pos``; raises
    :class:`CodecError` on truncation or bit-rot so a corrupt entry can
    never silently mis-prune."""
    from repro_torch.store.base import CodecError
    size = stats_size(ncols)
    if pos + size > offset + seg_len or pos + size > len(buf):
        raise CodecError(
            f"truncated stats block (need {size} bytes)", path=path,
            offset=pos)
    raw = bytes(buf[pos:pos + size])
    (crc, kbits, step_min, step_max, ts_min, ts_max, rank_min, rank_max,
     present) = STATS_HDR.unpack_from(raw, 0)
    if zlib.crc32(raw[4:]) != crc:
        raise CodecError("stats block CRC mismatch (bit-flipped or "
                         "corrupt stats entry)", path=path, offset=pos)
    mins: list = []
    maxs: list = []
    for col_id in range(ncols):
        pair = _PAIR_F if col_id in FLOAT_STAT_COLS else _PAIR_I
        lo, hi = pair.unpack_from(raw, STATS_HDR.size + col_id * 16)
        mins.append(lo)
        maxs.append(hi)
    return SegmentStats(
        offset=offset, seg_len=seg_len, n_rows=n_rows, version=version,
        has_stats=True, kind_bits=kbits, step_min=step_min,
        step_max=step_max, ts_min=ts_min, ts_max=ts_max,
        rank_min=rank_min, rank_max=rank_max, col_present=present,
        col_min=tuple(mins), col_max=tuple(maxs))


# --------------------------------------------------------------------- #
# predicates
# --------------------------------------------------------------------- #
@dataclass
class Predicate:
    """A conjunctive trace predicate: every given clause must hold.

    ``step_range``/``time_range`` are INCLUSIVE ``(lo, hi)`` bounds; a
    row matches ``time_range`` when its ``[start_ts, end_ts]`` span
    intersects the window.  ``ranks`` is an explicit rank set;
    ``kinds`` an event-kind set; ``severity`` names a class from
    :data:`SEVERITY_KINDS` and unions into ``kinds``.

    ``columns`` adds per-column VALUE bounds keyed by batch attribute
    name (see :data:`STAT_COLUMNS`), e.g. ``{"flops": (1e12, None)}`` —
    inclusive ``(lo, hi)``, either end ``None`` for open.  Rows holding
    a column's null sentinel (NaN flops, missing bytes/tokens) never
    match a bound on it, mirroring the null exclusion the v3 per-column
    min/max already applies — which is what makes the segment-level
    prune sound: a column absent from ``col_present`` has no non-null
    row, so the whole segment is skipped.

    Two faces, kept consistent by construction: :meth:`may_match` is
    the CONSERVATIVE segment test over a stats block (false only when
    no row can possibly match), :meth:`row_mask`/:meth:`filter` the
    exact row-level filter — so pruned scans return byte-identical rows
    to full scans."""
    step_range: Optional[tuple[int, int]] = None
    time_range: Optional[tuple[float, float]] = None
    ranks: Optional[Sequence[int]] = None
    kinds: Optional[Sequence] = None
    severity: Optional[str] = None
    columns: Optional[dict] = None
    _kind_mask: int = field(init=False, default=0, repr=False)
    _rank_set: Optional[np.ndarray] = field(init=False, default=None,
                                            repr=False)
    _col_bounds: dict = field(init=False, default_factory=dict, repr=False)

    def __post_init__(self):
        if self.columns:
            for name, bounds in self.columns.items():
                if name not in STAT_COLUMNS:
                    raise ValueError(
                        f"unknown predicate column {name!r}; known: "
                        f"{sorted(STAT_COLUMNS)}")
                lo, hi = bounds
                if lo is None and hi is None:
                    continue
                self._col_bounds[name] = (lo, hi)
        ks = list(self.kinds) if self.kinds else []
        if self.severity is not None:
            try:
                ks.extend(SEVERITY_KINDS[self.severity])
            except KeyError:
                raise ValueError(
                    f"unknown severity {self.severity!r}; known: "
                    f"{sorted(SEVERITY_KINDS)}") from None
        self._kind_mask = kind_mask(ks) if ks else 0
        if self.ranks is not None:
            self._rank_set = np.unique(np.asarray(list(self.ranks),
                                                  np.int64))

    @property
    def empty(self) -> bool:
        return (self.step_range is None and self.time_range is None
                and self._rank_set is None and self._kind_mask == 0
                and not self._col_bounds)

    # ------------------------- segment test -------------------------- #
    def may_match(self, stats: Optional[SegmentStats]) -> bool:
        """False only when the stats PROVE no row matches.  Segments
        without stats (v1/v2, or ``stats=None``) always decode."""
        if stats is None or not stats.has_stats:
            return True
        if stats.n_rows == 0:
            return False
        if self.step_range is not None:
            lo, hi = self.step_range
            if stats.step_max < 0:          # no attributed rows at all
                return False
            if stats.step_max < lo or stats.step_min > hi:
                return False
        if self.time_range is not None:
            t0, t1 = self.time_range
            if stats.ts_max < t0 or stats.ts_min > t1:
                return False
        if self._rank_set is not None:
            rs = self._rank_set
            if not bool(((rs >= stats.rank_min)
                         & (rs <= stats.rank_max)).any()):
                return False
        if self._kind_mask and not (stats.kind_bits & self._kind_mask):
            return False
        for name, (lo, hi) in self._col_bounds.items():
            cr = stats.column_range(STAT_COLUMNS[name])
            if cr is None:          # no non-null value in any row
                return False
            if lo is not None and cr[1] < lo:
                return False
            if hi is not None and cr[0] > hi:
                return False
        return True

    # --------------------------- row filter --------------------------- #
    def row_mask(self, batch) -> np.ndarray:
        m = np.ones(len(batch), bool)
        if self.step_range is not None:
            lo, hi = self.step_range
            m &= (batch.step >= lo) & (batch.step <= hi)
        if self.time_range is not None:
            t0, t1 = self.time_range
            m &= (batch.end_ts >= t0) & (batch.start_ts <= t1)
        if self._rank_set is not None:
            m &= np.isin(batch.rank, self._rank_set)
        if self._kind_mask:
            codes = [c for c in range(len(EventKind))
                     if (self._kind_mask >> c) & 1]
            m &= np.isin(batch.kind, np.asarray(codes, batch.kind.dtype))
        for name, (lo, hi) in self._col_bounds.items():
            vals = getattr(batch, name)
            if name in _NAN_NULL_COLS:
                valid = ~np.isnan(vals)
            elif name in _INT_NULL_COLS:
                valid = vals != NO_INT
            else:
                valid = None
            cm = np.ones(len(batch), bool) if valid is None else valid
            if lo is not None:
                cm = cm & (vals >= lo)
            if hi is not None:
                cm = cm & (vals <= hi)
            m &= cm
        return m

    def filter(self, batch):
        """Row-filtered batch (shares interning tables via ``take``)."""
        if self.empty:
            return batch
        mask = self.row_mask(batch)
        if bool(mask.all()):
            return batch
        return batch.take(np.nonzero(mask)[0])
