"""Call-stack reconstruction from span intervals (paper §4.2).

Plug-and-play instrumentation times Python APIs and kernels through
*separate* mechanisms, so the call stack linking them is lost.  The paper
reconstructs the nesting from (start, end) timestamps before events reach
the engine.  We do the same: sort spans, maintain an open-interval stack,
and annotate every event with its enclosing call path.

Invariant (property-tested): spans from a single thread are either nested
or disjoint; partial overlaps are resolved by treating the later-starting
span as a child until its own end (clock skew tolerance `eps`).
"""
from __future__ import annotations

from typing import Iterable

from repro_torch.core.events import EventKind, TraceEvent

_EPS = 1e-9


def reconstruct_stacks(events: list[TraceEvent]) -> list[TraceEvent]:
    """Annotates events in-place with meta['callpath'] per rank."""
    by_rank: dict[int, list[TraceEvent]] = {}
    for ev in events:
        if ev.kind in (EventKind.HEARTBEAT, EventKind.HANG_SUSPECT):
            continue
        by_rank.setdefault(ev.rank, []).append(ev)
    for rank_events in by_rank.values():
        _reconstruct_one(rank_events)
    return events


def _reconstruct_one(events: list[TraceEvent]):
    # host-side nesting uses issue_ts..end for CPU spans; kernels nest under
    # whatever host span was open at their ISSUE time (they execute later).
    order = sorted(events, key=lambda e: (e.issue_ts, -e.end_ts))
    stack: list[TraceEvent] = []
    for ev in order:
        t = ev.issue_ts
        while stack and stack[-1].end_ts <= t + _EPS:
            stack.pop()
        if stack:
            parent = stack[-1]
            ppath = parent.meta.get("callpath", parent.name)
            ev.meta["callpath"] = f"{ppath}/{ev.name}"
            ev.meta["parent"] = parent.name
        else:
            ev.meta["callpath"] = ev.name
        # only host spans can contain others (kernels run on device)
        if ev.kind not in (EventKind.KERNEL_COMPUTE, EventKind.KERNEL_COMM):
            stack.append(ev)


def children_of(events: Iterable[TraceEvent], parent_name: str):
    return [e for e in events if e.meta.get("parent") == parent_name]
