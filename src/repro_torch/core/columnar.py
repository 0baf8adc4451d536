"""Columnar (structure-of-arrays) event store — the hot-path event currency.

``TraceEvent`` dataclasses are convenient at the edges (the per-process
daemon, hand-built tests, JSONL logs) but far too slow as the interchange
format between a thousand-plus-rank simulator and the diagnostic engine:
appending N Python objects per op and re-filtering every rank's list per
step is superlinear in steps and allocates millions of dicts.

``EventBatch`` holds the same information as ``list[TraceEvent]`` in numpy
columns:

    kind      uint8    code into ``KINDS`` (the EventKind declaration order)
    name_id   int32    index into the interned ``names`` table
    rank      int32
    issue_ts  float64  host-side dispatch timestamp
    start_ts  float64  device-side execution start
    end_ts    float64
    step      int32    (-1 = no step attribution)

The common numeric ``meta`` keys get dedicated sparse columns (``flops``
NaN-absent, ``bytes``/``tokens`` INT-sentinel-absent, interned ``group``),
so aggregation never touches a Python dict; every remaining meta key lives
in ``extra`` (row -> dict), which only the slow conversion paths read.
Conversion to/from ``list[TraceEvent]`` and the compact JSONL schema of
``events.py`` is lossless, so the daemon, the hang path, and previously
recorded logs keep working unchanged.

A step index (stable argsort over the step column) is built once per batch
and cached; ``metrics.aggregate_all`` and the engine consume row slices
from it instead of rescanning event lists.

On-disk persistence lives in ``repro.store`` (JSONL + the binary FCS
segment format behind one codec API); the ``from_jsonl``/``write_jsonl``
methods here are thin deprecated shims kept for old call sites.
"""
from __future__ import annotations

import json
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np

from repro_torch.core.events import EventKind, TraceEvent, dump_jsonl

# stable kind <-> code mapping (declaration order of EventKind)
KINDS: tuple[EventKind, ...] = tuple(EventKind)
KIND_TO_CODE: dict[EventKind, int] = {k: i for i, k in enumerate(KINDS)}
_VALUE_TO_CODE: dict[str, int] = {k.value: i for i, k in enumerate(KINDS)}

# sentinel for "meta key absent" in the integer columns
NO_INT = np.iinfo(np.int64).min
_INT_MAX = 2 ** 62


def _split_meta(meta: dict):
    """Split a TraceEvent meta dict into column values + leftover dict.

    Columns only take values whose round-trip is exact (ints for bytes and
    tokens, truthy numbers for flops, str for group); everything else goes
    to the leftover dict so conversion stays lossless.
    """
    flops, nbytes, tokens, group, rest = np.nan, NO_INT, NO_INT, None, None
    for k, v in meta.items():
        if k == "flops" and isinstance(v, (int, float)) \
                and not isinstance(v, bool) and v:
            flops = float(v)
        elif k == "bytes" and isinstance(v, int) and not isinstance(v, bool) \
                and -_INT_MAX < v < _INT_MAX:
            nbytes = v
        elif k == "tokens" and isinstance(v, int) \
                and not isinstance(v, bool) and -_INT_MAX < v < _INT_MAX:
            tokens = v
        elif k == "group" and isinstance(v, str):
            group = v
        else:
            if rest is None:
                rest = {}
            rest[k] = v
    return flops, nbytes, tokens, group, rest


class EventBatch:
    """Immutable structure-of-arrays event store (build via the builder or
    the ``from_*`` constructors; never mutate columns in place)."""

    __slots__ = ("kind", "name_id", "rank", "issue_ts", "start_ts", "end_ts",
                 "step", "flops", "nbytes", "tokens", "group_id",
                 "names", "groups", "extra", "_step_index", "_ranks")

    def __init__(self, kind, name_id, rank, issue_ts, start_ts, end_ts, step,
                 flops, nbytes, tokens, group_id, names, groups, extra):
        self.kind = kind
        self.name_id = name_id
        self.rank = rank
        self.issue_ts = issue_ts
        self.start_ts = start_ts
        self.end_ts = end_ts
        self.step = step
        self.flops = flops
        self.nbytes = nbytes
        self.tokens = tokens
        self.group_id = group_id
        self.names: list[str] = names
        self.groups: list[str] = groups
        self.extra: dict[int, dict] = extra
        self._step_index = None
        self._ranks = None

    def __len__(self) -> int:
        return self.kind.size

    @classmethod
    def empty(cls) -> "EventBatch":
        return cls(np.empty(0, np.uint8), np.empty(0, np.int32),
                   np.empty(0, np.int32), np.empty(0, np.float64),
                   np.empty(0, np.float64), np.empty(0, np.float64),
                   np.empty(0, np.int32), np.empty(0, np.float64),
                   np.empty(0, np.int64), np.empty(0, np.int64),
                   np.empty(0, np.int16), [], [], {})

    # ------------------------------------------------------------------ #
    # indices
    # ------------------------------------------------------------------ #
    def step_index(self):
        """(order, steps, bounds): ``order`` is a stable permutation
        grouping rows by step; rows of step ``steps[i]`` are
        ``order[bounds[i]:bounds[i + 1]]`` in original insertion order."""
        if self._step_index is None:
            order = np.argsort(self.step, kind="stable")
            steps_sorted = self.step[order]
            uniq, starts = np.unique(steps_sorted, return_index=True)
            bounds = np.append(starts, order.size)
            self._step_index = (order, uniq, bounds)
        return self._step_index

    def steps(self) -> list[int]:
        _, uniq, _ = self.step_index()
        return [int(s) for s in uniq.tolist() if s >= 0]

    def ranks(self) -> np.ndarray:
        if self._ranks is None:
            self._ranks = np.unique(self.rank)
        return self._ranks

    def num_distinct_ranks(self) -> int:
        return int(self.ranks().size)

    def take(self, rows: np.ndarray) -> "EventBatch":
        """Row subset (copied columns) that SHARES the interning tables:
        ``names``/``groups`` are the same list objects, so ids stay
        comparable across slices.  The fleet store splits each arriving
        chunk into per-step slices this way and re-merges them through the
        shared-interning fast path of ``concat`` without any re-interning.
        ``rows`` must be unique row indices (e.g. a ``step_index`` slice).
        """
        rows = np.asarray(rows, np.int64)
        extra: dict[int, dict] = {}
        if self.extra and rows.size:
            if np.all(np.diff(rows) >= 0):
                er = np.fromiter(self.extra, np.int64, len(self.extra))
                pos = np.searchsorted(rows, er)
                pos_c = np.minimum(pos, rows.size - 1)
                ok = rows[pos_c] == er
                for r0, p0 in zip(er[ok].tolist(), pos_c[ok].tolist()):
                    extra[p0] = self.extra[r0]
            else:
                inv = {int(r): i for i, r in enumerate(rows.tolist())}
                for r0, d in self.extra.items():
                    i = inv.get(r0)
                    if i is not None:
                        extra[i] = d
        return EventBatch(
            self.kind[rows], self.name_id[rows], self.rank[rows],
            self.issue_ts[rows], self.start_ts[rows], self.end_ts[rows],
            self.step[rows], self.flops[rows], self.nbytes[rows],
            self.tokens[rows], self.group_id[rows],
            self.names, self.groups, extra)

    def slice_rows(self, lo: int, hi: int) -> "EventBatch":
        """Contiguous row range ``[lo, hi)`` as ZERO-COPY column views
        (numpy basic slicing) sharing the interning tables.  This is the
        replay fast path for step-sorted batches — an FCS segment decodes
        to memmap-backed columns, and its per-step slices reach the
        engine as views of the map instead of per-step ``take`` copies.
        Views keep the parent's buffers (and any backing memmap) alive.
        """
        extra: dict[int, dict] = {}
        if self.extra:
            for r, d in self.extra.items():
                if lo <= r < hi:
                    extra[r - lo] = d
        return EventBatch(
            self.kind[lo:hi], self.name_id[lo:hi], self.rank[lo:hi],
            self.issue_ts[lo:hi], self.start_ts[lo:hi], self.end_ts[lo:hi],
            self.step[lo:hi], self.flops[lo:hi], self.nbytes[lo:hi],
            self.tokens[lo:hi], self.group_id[lo:hi],
            self.names, self.groups, extra)

    def is_step_sorted(self) -> bool:
        """True if the step column is non-decreasing — then ``step_index``
        bounds are direct row offsets and per-step slices are contiguous
        (``slice_rows``), no permutation needed."""
        return len(self) < 2 or bool(np.all(self.step[:-1] <= self.step[1:]))

    # ------------------------------------------------------------------ #
    # conversion: TraceEvent lists
    # ------------------------------------------------------------------ #
    @classmethod
    def from_events(cls, events: Iterable[TraceEvent]) -> "EventBatch":
        b = EventBatchBuilder()
        for ev in events:
            b.append_event(ev)
        return b.build()

    @classmethod
    def from_events_by_rank(
            cls, events_by_rank: dict[int, list[TraceEvent]]) -> "EventBatch":
        """Rank-major flattening (matches the legacy dict iteration order)."""
        b = EventBatchBuilder()
        for r in sorted(events_by_rank):
            for ev in events_by_rank[r]:
                b.append_event(ev)
        return b.build()

    def _row_meta(self, row: int, *, fresh: bool = True) -> dict:
        m: dict = {}
        f = self.flops[row]
        if not np.isnan(f):
            m["flops"] = float(f)
        nb = self.nbytes[row]
        if nb != NO_INT:
            m["bytes"] = int(nb)
        g = self.group_id[row]
        if g >= 0:
            m["group"] = self.groups[g]
        tk = self.tokens[row]
        if tk != NO_INT:
            m["tokens"] = int(tk)
        if self.extra:
            rest = self.extra.get(row)
            if rest:
                m.update(rest)
        return m

    def to_events(self) -> list[TraceEvent]:
        kinds = [KINDS[c] for c in self.kind.tolist()]
        names = self.names
        nid = self.name_id.tolist()
        rk = self.rank.tolist()
        iss = self.issue_ts.tolist()
        st = self.start_ts.tolist()
        en = self.end_ts.tolist()
        sp = self.step.tolist()
        return [TraceEvent(kinds[i], names[nid[i]], rk[i], iss[i], st[i],
                           en[i], step=sp[i], meta=self._row_meta(i))
                for i in range(len(self))]

    def to_events_by_rank(self) -> dict[int, list[TraceEvent]]:
        out: dict[int, list[TraceEvent]] = {int(r): [] for r in self.ranks()}
        for ev in self.to_events():
            out[ev.rank].append(ev)
        return out

    # ------------------------------------------------------------------ #
    # conversion: JSONL (same compact schema as TraceEvent.to_json)
    # ------------------------------------------------------------------ #
    def to_jsonl_lines(self) -> Iterator[str]:
        names = self.names
        nid = self.name_id.tolist()
        kind_vals = [KINDS[c].value for c in self.kind.tolist()]
        rk = self.rank.tolist()
        iss = self.issue_ts.tolist()
        st = self.start_ts.tolist()
        en = self.end_ts.tolist()
        sp = self.step.tolist()
        dumps = json.dumps
        for i in range(len(self)):
            d = {"k": kind_vals[i], "n": names[nid[i]], "r": rk[i],
                 "i": round(iss[i], 6), "s": round(st[i], 6),
                 "e": round(en[i], 6), "t": sp[i]}
            m = self._row_meta(i)
            if m:
                d["m"] = {k: v for k, v in m.items() if k != "stack"}
                if "stack" in m:
                    d["m"]["stack"] = list(m["stack"])[-4:]
            yield dumps(d, separators=(",", ":"))

    def write_jsonl(self, path: str) -> int:
        """DEPRECATED shim — use ``repro.store.write_trace``.  Appends to
        ``path``; returns bytes written (Fig 9 accounting)."""
        return dump_jsonl(self, path)

    @classmethod
    def from_jsonl(cls, path: str, *, with_skip_count: bool = False):
        """DEPRECATED shim — use ``repro.store.read_jsonl`` (tolerant
        line-by-line decode; corrupt lines skipped with a counted
        warning)."""
        from repro_torch.store.jsonl import read_jsonl
        return read_jsonl(path, with_skip_count=with_skip_count)

    @classmethod
    def from_jsonl_chunked(cls, path: str, *, chunk_bytes: int = 8 << 20,
                           max_workers: Optional[int] = None,
                           executor: str = "thread",
                           with_skip_count: bool = False):
        """DEPRECATED shim — use ``repro.store.read_jsonl_chunked`` (the
        chunked/parallel replay fast path; identical result to
        ``from_jsonl``)."""
        from repro_torch.store.jsonl import read_jsonl_chunked
        return read_jsonl_chunked(path, chunk_bytes=chunk_bytes,
                                  max_workers=max_workers,
                                  executor=executor,
                                  with_skip_count=with_skip_count)

    # ------------------------------------------------------------------ #
    @classmethod
    def concat(cls, batches: Sequence["EventBatch"]) -> "EventBatch":
        batches = [b for b in batches if len(b)]
        if not batches:
            return cls.empty()
        if len(batches) == 1:
            return batches[0]
        first = batches[0]
        if all(b.names is first.names and b.groups is first.groups
               for b in batches[1:]):
            # shared interning (fleet store slices): ids are already
            # consistent — concatenate columns as-is, no LUT remap.
            extra: dict[int, dict] = {}
            off = 0
            for b in batches:
                for row, d in b.extra.items():
                    extra[off + row] = d
                off += len(b)
            return cls(
                np.concatenate([b.kind for b in batches]),
                np.concatenate([b.name_id for b in batches]),
                np.concatenate([b.rank for b in batches]),
                np.concatenate([b.issue_ts for b in batches]),
                np.concatenate([b.start_ts for b in batches]),
                np.concatenate([b.end_ts for b in batches]),
                np.concatenate([b.step for b in batches]),
                np.concatenate([b.flops for b in batches]),
                np.concatenate([b.nbytes for b in batches]),
                np.concatenate([b.tokens for b in batches]),
                np.concatenate([b.group_id for b in batches]),
                first.names, first.groups, extra)
        names: list[str] = []
        name_map: dict[str, int] = {}
        groups: list[str] = []
        group_map: dict[str, int] = {}
        nid_parts, gid_parts = [], []
        extra: dict[int, dict] = {}
        off = 0
        for b in batches:
            if b.names:
                lut = np.empty(len(b.names), np.int32)
                for i, nm in enumerate(b.names):
                    j = name_map.get(nm)
                    if j is None:
                        j = name_map[nm] = len(names)
                        names.append(nm)
                    lut[i] = j
                nid_parts.append(lut[b.name_id])
            else:
                nid_parts.append(b.name_id)
            if b.groups:
                glut = np.empty(len(b.groups) + 1, np.int16)
                glut[-1] = -1          # group_id -1 stays -1
                for i, gm in enumerate(b.groups):
                    j = group_map.get(gm)
                    if j is None:
                        j = group_map[gm] = len(groups)
                        groups.append(gm)
                    glut[i] = j
                gid_parts.append(glut[b.group_id])
            else:
                gid_parts.append(b.group_id)
            for row, d in b.extra.items():
                extra[off + row] = d
            off += len(b)
        return cls(
            np.concatenate([b.kind for b in batches]),
            np.concatenate(nid_parts).astype(np.int32),
            np.concatenate([b.rank for b in batches]),
            np.concatenate([b.issue_ts for b in batches]),
            np.concatenate([b.start_ts for b in batches]),
            np.concatenate([b.end_ts for b in batches]),
            np.concatenate([b.step for b in batches]),
            np.concatenate([b.flops for b in batches]),
            np.concatenate([b.nbytes for b in batches]),
            np.concatenate([b.tokens for b in batches]),
            np.concatenate(gid_parts).astype(np.int16),
            names, groups, extra)


# ----------------------------------------------------------------------- #
# builder
# ----------------------------------------------------------------------- #
class EventBatchBuilder:
    """Accumulates whole rank-vectors per op (the simulator hot path) or
    scalar rows (conversion paths) and concatenates once at ``build``."""

    def __init__(self):
        self._names: list[str] = []
        self._name_ids: dict[str, int] = {}
        self._groups: list[str] = []
        self._group_ids: dict[str, int] = {}
        self._kind: list[np.ndarray] = []
        self._nid: list[np.ndarray] = []
        self._rank: list[np.ndarray] = []
        self._issue: list[np.ndarray] = []
        self._start: list[np.ndarray] = []
        self._end: list[np.ndarray] = []
        self._step: list[np.ndarray] = []
        self._flops: list[np.ndarray] = []
        self._nbytes: list[np.ndarray] = []
        self._tokens: list[np.ndarray] = []
        self._gid: list[np.ndarray] = []
        self._extra: dict[int, dict] = {}
        self._count = 0
        # scalar-row staging (append_event / append_scalar)
        self._s_kind: list[int] = []
        self._s_nid: list[int] = []
        self._s_rank: list[int] = []
        self._s_issue: list[float] = []
        self._s_start: list[float] = []
        self._s_end: list[float] = []
        self._s_step: list[int] = []
        self._s_flops: list[float] = []
        self._s_nbytes: list[int] = []
        self._s_tokens: list[int] = []
        self._s_gid: list[int] = []

    def __len__(self) -> int:
        return self._count + len(self._s_kind)

    def _intern_name(self, name: str) -> int:
        i = self._name_ids.get(name)
        if i is None:
            i = self._name_ids[name] = len(self._names)
            self._names.append(name)
        return i

    def _intern_group(self, group: Optional[str]) -> int:
        if group is None:
            return -1
        i = self._group_ids.get(group)
        if i is None:
            i = self._group_ids[group] = len(self._groups)
            self._groups.append(group)
        return i

    def _drain_scalars(self):
        if not self._s_kind:
            return
        self._kind.append(np.asarray(self._s_kind, np.uint8))
        self._nid.append(np.asarray(self._s_nid, np.int32))
        self._rank.append(np.asarray(self._s_rank, np.int32))
        self._issue.append(np.asarray(self._s_issue, np.float64))
        self._start.append(np.asarray(self._s_start, np.float64))
        self._end.append(np.asarray(self._s_end, np.float64))
        self._step.append(np.asarray(self._s_step, np.int32))
        self._flops.append(np.asarray(self._s_flops, np.float64))
        self._nbytes.append(np.asarray(self._s_nbytes, np.int64))
        self._tokens.append(np.asarray(self._s_tokens, np.int64))
        self._gid.append(np.asarray(self._s_gid, np.int16))
        self._count += len(self._s_kind)
        for lst in (self._s_kind, self._s_nid, self._s_rank, self._s_issue,
                    self._s_start, self._s_end, self._s_step, self._s_flops,
                    self._s_nbytes, self._s_tokens, self._s_gid):
            lst.clear()

    # ------------------------------------------------------------------ #
    def append_block(self, kind: EventKind, name: str, rank: np.ndarray,
                     issue_ts, start_ts, end_ts, step: int, *,
                     flops: Optional[float] = None,
                     nbytes: Optional[int] = None,
                     tokens: Optional[int] = None,
                     group: Optional[str] = None,
                     extra=None):
        """Append one event per entry of ``rank`` (whole rank-vector).

        ``issue_ts``/``start_ts``/``end_ts`` may be scalars or arrays of
        the same length; values are copied, so callers may keep mutating
        their state vectors.  ``extra`` is either one dict shared by every
        row or a sequence of per-row dicts.
        """
        rank = np.asarray(rank, np.int32)
        m = rank.size
        if m == 0:
            return
        self._drain_scalars()
        self._kind.append(np.full(m, KIND_TO_CODE[kind], np.uint8))
        self._nid.append(np.full(m, self._intern_name(name), np.int32))
        self._rank.append(rank.copy())
        for dst, src in ((self._issue, issue_ts), (self._start, start_ts),
                         (self._end, end_ts)):
            a = np.asarray(src, np.float64)
            dst.append(np.full(m, float(a), np.float64) if a.ndim == 0
                       else a.astype(np.float64, copy=True))
        self._step.append(np.full(m, step, np.int32))
        self._flops.append(np.full(
            m, np.nan if flops is None or not flops else float(flops),
            np.float64))
        self._nbytes.append(np.full(
            m, NO_INT if nbytes is None else int(nbytes), np.int64))
        self._tokens.append(np.full(
            m, NO_INT if tokens is None else int(tokens), np.int64))
        self._gid.append(np.full(m, self._intern_group(group), np.int16))
        if extra is not None:
            base = self._count
            if isinstance(extra, dict):
                if extra:
                    for i in range(m):
                        self._extra[base + i] = extra
            else:
                for i, d in enumerate(extra):
                    if d:
                        self._extra[base + i] = d
        self._count += m

    def append_event(self, ev: TraceEvent):
        flops, nbytes, tokens, group, rest = _split_meta(ev.meta) \
            if ev.meta else (np.nan, NO_INT, NO_INT, None, None)
        self.append_scalar(KIND_TO_CODE[ev.kind], ev.name, ev.rank,
                           ev.issue_ts, ev.start_ts, ev.end_ts, ev.step,
                           None, _split=(flops, nbytes, tokens, group, rest))

    def append_scalar(self, kind_code: int, name: str, rank: int,
                      issue_ts: float, start_ts: float, end_ts: float,
                      step: int, meta: Optional[dict], _split=None):
        if _split is None:
            flops, nbytes, tokens, group, rest = _split_meta(meta or {})
        else:
            flops, nbytes, tokens, group, rest = _split
        self._s_kind.append(kind_code)
        self._s_nid.append(self._intern_name(name))
        self._s_rank.append(rank)
        self._s_issue.append(issue_ts)
        self._s_start.append(start_ts)
        self._s_end.append(end_ts)
        self._s_step.append(step)
        self._s_flops.append(flops)
        self._s_nbytes.append(nbytes)
        self._s_tokens.append(tokens)
        self._s_gid.append(self._intern_group(group))
        if rest:
            self._extra[self._count + len(self._s_kind) - 1] = rest

    # ------------------------------------------------------------------ #
    def build(self) -> EventBatch:
        self._drain_scalars()
        if not self._count:
            return EventBatch.empty()

        def cat(parts, dtype):
            return parts[0] if len(parts) == 1 \
                else np.concatenate(parts).astype(dtype, copy=False)

        return EventBatch(
            cat(self._kind, np.uint8), cat(self._nid, np.int32),
            cat(self._rank, np.int32), cat(self._issue, np.float64),
            cat(self._start, np.float64), cat(self._end, np.float64),
            cat(self._step, np.int32), cat(self._flops, np.float64),
            cat(self._nbytes, np.int64), cat(self._tokens, np.int64),
            cat(self._gid, np.int16), list(self._names), list(self._groups),
            dict(self._extra))


# ----------------------------------------------------------------------- #
# chunked JSONL decoding — moved to repro.store.jsonl
# ----------------------------------------------------------------------- #
def iter_jsonl_chunks(path: str, *, chunk_bytes: int = 8 << 20,
                      max_workers: Optional[int] = None,
                      executor: str = "thread",
                      ) -> Iterator[tuple[EventBatch, int]]:
    """DEPRECATED shim — use ``repro.store.iter_jsonl_chunks``."""
    from repro_torch.store.jsonl import iter_jsonl_chunks as _impl
    return _impl(path, chunk_bytes=chunk_bytes, max_workers=max_workers,
                 executor=executor)


# ----------------------------------------------------------------------- #
# segmented query helpers (exact, fully vectorized)
# ----------------------------------------------------------------------- #
def prev_le(val_t: np.ndarray, val_seg: np.ndarray,
            q_t: np.ndarray, q_seg: np.ndarray) -> np.ndarray:
    """Per query, index of the value with the LARGEST t such that
    ``t <= q_t`` within the same segment; -1 if none.

    Works by merging values and queries into one (segment, t) order and
    running an integer prefix-max whose payload encodes (segment, sorted
    position) — segment boundaries reset for free because the segment term
    dominates the position term.
    """
    nv, nq = val_t.size, q_t.size
    if nq == 0:
        return np.empty(0, np.int64)
    if nv == 0:
        return np.full(nq, -1, np.int64)
    t = np.concatenate([val_t, q_t])
    seg = np.concatenate([val_seg, q_seg]).astype(np.int64)
    is_q = np.concatenate([np.zeros(nv, np.int8), np.ones(nq, np.int8)])
    # segment-major, time-minor; values sort before queries at equal t so
    # an exactly-equal value still qualifies (<= is inclusive)
    order = np.lexsort((is_q, t, seg))
    m = t.size
    seg_s = seg[order]
    isq_s = is_q[order]
    pos = np.where(isq_s == 0, np.arange(m, dtype=np.int64), -1)
    acc = np.maximum.accumulate(pos + seg_s * (m + 1))
    q_pos = np.nonzero(isq_s)[0]
    a = acc[q_pos]
    has = (a // (m + 1)) == seg_s[q_pos]
    val_sorted_pos = np.where(has, a % (m + 1), 0)
    res = np.where(has, order[val_sorted_pos], -1)
    out = np.empty(nq, np.int64)
    out[order[q_pos] - nv] = res
    return out


def next_ge(val_t: np.ndarray, val_seg: np.ndarray,
            q_t: np.ndarray, q_seg: np.ndarray) -> np.ndarray:
    """Per query, index of the value with the SMALLEST t such that
    ``t >= q_t`` within the same segment; -1 if none."""
    return prev_le(-np.asarray(val_t), val_seg, -np.asarray(q_t), q_seg)
