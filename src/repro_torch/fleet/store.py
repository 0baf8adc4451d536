"""Shared-interning, step-partitioned columnar storage for fleet ingest.

A fleet multiplexes many jobs' daemon streams into one process.  Keeping a
separate name table per job would re-intern the same op names (the fleet
runs a handful of model families, so jobs overlap heavily) and make any
cross-job work re-hash strings; instead one :class:`SharedInterner` owns
the fleet-wide ``names``/``groups`` tables and every arriving chunk is
*adopted* — its id columns remapped once, after which all slices of all
jobs speak the same ids and ``EventBatch.concat`` merges them with plain
column concatenation (the shared-interning fast path, no LUTs).

:class:`StepPartitionedStore` is the per-job buffer between ingest and the
incremental evaluator: chunks are split into per-step slices on arrival
(one stable argsort per chunk), a step's slices are merged only when the
watermark closes it, and the slice memory is released right after the
engine consumed it — fleet memory stays proportional to the watermark
window, not to job length.  Hang-suspect stacks are extracted at append
time into a tiny side table so dropping diagnosed steps never loses the
hang path.

The port's copy of the JAX package's ``fleet/store.py``: numpy only (no
torch), with the reference's names, thresholds and arithmetic.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from repro_torch.core.columnar import KIND_TO_CODE, EventBatch
from repro_torch.core.events import EventKind

_C_HANG = KIND_TO_CODE[EventKind.HANG_SUSPECT]


class SharedInterner:
    """Fleet-wide name/group tables; ``adopt`` remaps a batch onto them.

    Adopted batches reference the SAME list objects, so the tables growing
    later never invalidates earlier slices (ids are append-only)."""

    def __init__(self):
        self.names: list[str] = []
        self._name_ids: dict[str, int] = {}
        self.groups: list[str] = []
        self._group_ids: dict[str, int] = {}
        self._lock = threading.Lock()   # jobs adopt from their own threads

    def intern_name(self, name: str) -> int:
        i = self._name_ids.get(name)
        if i is None:
            i = self._name_ids[name] = len(self.names)
            self.names.append(name)
        return i

    def intern_group(self, group: str) -> int:
        i = self._group_ids.get(group)
        if i is None:
            i = self._group_ids[group] = len(self.groups)
            self.groups.append(group)
        return i

    def restore_tables(self, names: list, groups: list) -> None:
        """Adopt checkpointed tables — the VERY list objects, not copies.
        Restored ``EventBatch`` slices from the same checkpoint pickle
        reference these exact objects (single-pickle identity memo), so
        adopting them keeps the ``batch.names is self.names`` fast path
        valid after restore.  Only legal on an empty interner: merging
        into live tables would break that identity."""
        with self._lock:
            if self.names or self.groups:
                raise ValueError("restore_tables on a non-empty interner")
            self.names = names
            self.groups = groups
            self._name_ids = {nm: i for i, nm in enumerate(names)}
            self._group_ids = {gm: i for i, gm in enumerate(groups)}

    def merge_tables(self, names, groups) -> None:
        """Fold another interner's tables in (a replay worker process
        built its own; the parent adopts every name/group it saw).  Ids
        are NOT preserved — merging interns each string in table order,
        which is deterministic as long as workers' tables are merged in
        a deterministic job order (the replayer merges in sorted-path
        group order), so repeated runs produce identical fleet tables."""
        with self._lock:
            for nm in names:
                self.intern_name(nm)
            for gm in groups:
                self.intern_group(gm)

    def adopt(self, batch: EventBatch) -> EventBatch:
        if batch.names is self.names and batch.groups is self.groups:
            return batch
        with self._lock:
            return self._adopt_locked(batch)

    def _adopt_locked(self, batch: EventBatch) -> EventBatch:
        if batch.names:
            lut = np.empty(len(batch.names), np.int32)
            for i, nm in enumerate(batch.names):
                lut[i] = self.intern_name(nm)
            nid = lut[batch.name_id]
        else:
            nid = batch.name_id
        if batch.groups:
            glut = np.empty(len(batch.groups) + 1, np.int16)
            glut[-1] = -1                     # group_id -1 stays -1
            for i, gm in enumerate(batch.groups):
                glut[i] = self.intern_group(gm)
            gid = glut[batch.group_id]
        else:
            gid = batch.group_id
        # rows are unchanged, so the extra dict is shared, not copied
        # (EventBatch is immutable by convention)
        return EventBatch(
            batch.kind, nid.astype(np.int32, copy=False), batch.rank,
            batch.issue_ts, batch.start_ts, batch.end_ts, batch.step,
            batch.flops, batch.nbytes, batch.tokens,
            gid.astype(np.int16, copy=False),
            self.names, self.groups, batch.extra)


class StepPartitionedStore:
    """Per-job buffer: arriving chunks split into per-step slices (shared
    interning), merged per step on demand, dropped once diagnosed."""

    def __init__(self, interner: Optional[SharedInterner] = None):
        self.interner = interner or SharedInterner()
        self._by_step: dict[int, list[EventBatch]] = {}
        self._step_rows: dict[int, int] = {}  # step -> rows buffered
        self.buffered_rows = 0          # total rows currently held
        self._rank_seen = np.zeros(0, bool)   # scatter beats np.unique here
        self._num_ranks = 0
        self._ranks_floor = 0           # restored summary floor (see below)
        self._ranks_dirty = False
        self.max_step_seen = -1
        self.last_ts = 0.0              # max end_ts observed (event time)
        self.events_total = 0
        self.nostep_events = 0          # rows with no step attribution
        self.hang_stacks: dict[int, list] = {}   # rank -> last stack

    @property
    def num_ranks(self) -> int:
        if self._ranks_dirty:
            self._num_ranks = int(np.count_nonzero(self._rank_seen))
            self._ranks_dirty = False
        return max(self._num_ranks, self._ranks_floor)

    def append(self, batch: EventBatch) -> dict[int, int]:
        """Adopt + split one chunk; returns ``step -> rows buffered`` so
        the caller can spot rows for steps it already evaluated."""
        if not len(batch):
            return {}
        b = self.interner.adopt(batch)
        self.events_total += len(b)
        mx = int(b.rank.max())
        if mx >= self._rank_seen.size:
            grown = np.zeros(max(mx + 1, 2 * self._rank_seen.size), bool)
            grown[:self._rank_seen.size] = self._rank_seen
            self._rank_seen = grown
        self._rank_seen[b.rank] = True
        self._ranks_dirty = True
        self.last_ts = max(self.last_ts, float(b.end_ts.max()))
        hang_rows = np.nonzero(b.kind == _C_HANG)[0]
        for row in hang_rows.tolist():
            self.hang_stacks[int(b.rank[row])] = \
                (b.extra.get(row) or {}).get("stack", [])
        touched: dict[int, int] = {}
        s0 = int(b.step[0])
        if b.step[0] == b.step[-1] and bool((b.step == s0).all()):
            # single-step chunk (daemon drained within one step, or an
            # already-split slice): no argsort, no row copies
            if s0 < 0:
                self.nostep_events += len(b)
            else:
                self._by_step.setdefault(s0, []).append(b)
                self._step_rows[s0] = self._step_rows.get(s0, 0) + len(b)
                self.buffered_rows += len(b)
                touched[s0] = len(b)
                if s0 > self.max_step_seen:
                    self.max_step_seen = s0
            return touched
        order, uniq, bounds = b.step_index()
        for i, s in enumerate(uniq.tolist()):
            rows = order[bounds[i]:bounds[i + 1]]
            if s < 0:
                self.nostep_events += rows.size
                continue
            self._by_step.setdefault(s, []).append(b.take(rows))
            self._step_rows[s] = self._step_rows.get(s, 0) + rows.size
            self.buffered_rows += rows.size
            touched[s] = rows.size
            if s > self.max_step_seen:
                self.max_step_seen = s
        return touched

    def pending_steps(self) -> list[int]:
        return sorted(self._by_step)

    def step_batch(self, step: int) -> EventBatch:
        """Merged slice for one step (shared-interning concat, no remap)."""
        return EventBatch.concat(self._by_step[step])

    def pop_step(self, step: int) -> EventBatch:
        """``step_batch`` + release the buffered slices."""
        out = self.step_batch(step)
        del self._by_step[step]
        self.buffered_rows -= self._step_rows.pop(step, 0)
        return out

    def drop_step(self, step: int) -> None:
        self._by_step.pop(step, None)
        self.buffered_rows -= self._step_rows.pop(step, 0)

    # ------------------------------------------------------------------ #
    # process-sharded replay: mirror a worker store's summary facts
    # ------------------------------------------------------------------ #
    def summary(self) -> dict:
        """Picklable facts a replay worker ships back so the parent's
        store mirror answers ``stats()``/hang/flush questions exactly as
        the worker's would.  Buffered slices are NOT shipped — the
        worker flushed before summarizing, so there are none."""
        return {
            "events_total": self.events_total,
            "nostep_events": self.nostep_events,
            "num_ranks": self.num_ranks,
            "max_step_seen": self.max_step_seen,
            "last_ts": self.last_ts,
            "hang_stacks": dict(self.hang_stacks),
        }

    def restore_summary(self, s: dict) -> None:
        """Fold a worker's :meth:`summary` into this (parent-side) store.
        Rank identities don't cross the boundary, so the count lands as a
        floor that later direct ingest can only raise."""
        self.events_total += int(s["events_total"])
        self.nostep_events += int(s["nostep_events"])
        self._ranks_floor = max(self._ranks_floor, int(s["num_ranks"]))
        self.max_step_seen = max(self.max_step_seen, int(s["max_step_seen"]))
        self.last_ts = max(self.last_ts, float(s["last_ts"]))
        self.hang_stacks.update(s["hang_stacks"])

    # ------------------------------------------------------------------ #
    # service checkpoints: FULL state transfer (summary() is lossy — it
    # drops pending slices and rank identities, which a mid-stream
    # restore needs intact)
    # ------------------------------------------------------------------ #
    def snapshot_state(self) -> dict:
        """Complete picklable state, pending ``EventBatch`` slices
        included.  Slices reference the interner's live list objects;
        pickled together with the interner tables (one checkpoint
        pickle) the shared identity survives the round trip."""
        return {
            "by_step": {s: list(v) for s, v in self._by_step.items()},
            "step_rows": dict(self._step_rows),
            "buffered_rows": self.buffered_rows,
            "rank_seen": self._rank_seen.copy(),
            "ranks_floor": self._ranks_floor,
            "max_step_seen": self.max_step_seen,
            "last_ts": self.last_ts,
            "events_total": self.events_total,
            "nostep_events": self.nostep_events,
            "hang_stacks": dict(self.hang_stacks),
        }

    def restore_state(self, s: dict) -> None:
        """Inverse of :meth:`snapshot_state` on a fresh store whose
        interner already adopted the checkpointed tables."""
        self._by_step = {int(k): list(v) for k, v in s["by_step"].items()}
        self._step_rows = {int(k): int(v)
                           for k, v in s["step_rows"].items()}
        self.buffered_rows = int(s["buffered_rows"])
        self._rank_seen = s["rank_seen"]
        self._ranks_floor = int(s["ranks_floor"])
        self._num_ranks = 0
        self._ranks_dirty = True
        self.max_step_seen = int(s["max_step_seen"])
        self.last_ts = float(s["last_ts"])
        self.events_total = int(s["events_total"])
        self.nostep_events = int(s["nostep_events"])
        self.hang_stacks = dict(s["hang_stacks"])
