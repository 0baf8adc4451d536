"""Trace event model, bounded ring buffer, and compact JSONL codec.

Events are the single currency between the tracing daemon, the cluster
simulator and the diagnostic engine: any producer that emits this schema
(real process, simulated rank, or a replayed log) exercises the identical
diagnosis code path.
"""
from __future__ import annotations

import enum
import json
import threading
from dataclasses import dataclass, field
from typing import Any, Iterable, Optional


class EventKind(str, enum.Enum):
    PY_API = "py_api"            # intercepted Python API span (sync)
    GC = "gc"                    # Python garbage collection pause
    DATALOADER = "dataloader"    # metric ① seam
    KERNEL_COMPUTE = "k_comp"    # registered compute kernel
    KERNEL_COMM = "k_comm"       # registered communication kernel
    STEP = "step"                # whole training/serving step span
    SYNC = "sync"                # device synchronization span
    HEARTBEAT = "heartbeat"      # daemon liveness
    HANG_SUSPECT = "hang"        # daemon-reported potential hang


# kinds the engine treats as occupying the device timeline
DEVICE_KINDS = (EventKind.KERNEL_COMPUTE, EventKind.KERNEL_COMM)


@dataclass(slots=True)
class TraceEvent:
    kind: EventKind
    name: str
    rank: int
    issue_ts: float          # host-side issue (dispatch) timestamp
    start_ts: float          # device-side execution start (== issue for CPU spans)
    end_ts: float
    step: int = -1
    meta: dict = field(default_factory=dict)
    # meta keys used by the engine:
    #   flops, bytes, comm_group (tuple of ranks), shape, layout,
    #   tokens (dataloader), stack (list[str]), parent (callpath str)

    @property
    def duration(self) -> float:
        return self.end_ts - self.start_ts

    @property
    def issue_latency(self) -> float:
        return self.start_ts - self.issue_ts

    # ---------------------------- codec ------------------------------- #
    def to_json(self) -> str:
        d = {"k": self.kind.value, "n": self.name, "r": self.rank,
             "i": round(self.issue_ts, 6), "s": round(self.start_ts, 6),
             "e": round(self.end_ts, 6), "t": self.step}
        if self.meta:
            d["m"] = {k: v for k, v in self.meta.items() if k != "stack"}
            if "stack" in self.meta:
                d["m"]["stack"] = list(self.meta["stack"])[-4:]
        return json.dumps(d, separators=(",", ":"))

    @classmethod
    def from_json(cls, line: str) -> "TraceEvent":
        d = json.loads(line)
        return cls(kind=EventKind(d["k"]), name=d["n"], rank=d["r"],
                   issue_ts=d["i"], start_ts=d["s"], end_ts=d["e"],
                   step=d.get("t", -1), meta=d.get("m", {}))


class EventRingBuffer:
    """Bounded, thread-safe buffer; overflow drops oldest (counted)."""

    def __init__(self, capacity: int = 200_000):
        self.capacity = capacity
        self._buf: list[Optional[TraceEvent]] = [None] * capacity
        self._head = 0
        self._size = 0
        self.dropped = 0
        self._lock = threading.Lock()

    def append(self, ev: TraceEvent):
        with self._lock:
            idx = (self._head + self._size) % self.capacity
            if self._size == self.capacity:
                self._head = (self._head + 1) % self.capacity
                self.dropped += 1
            else:
                self._size += 1
            self._buf[idx] = ev

    def drain(self) -> list[TraceEvent]:
        with self._lock:
            out = [self._buf[(self._head + i) % self.capacity]
                   for i in range(self._size)]
            self._head = 0
            self._size = 0
            return out  # type: ignore[return-value]

    def __len__(self) -> int:
        return self._size


def dump_jsonl(events, path: str) -> int:
    """Write events; returns bytes written (Fig 9 log-size accounting).

    Accepts any iterable of TraceEvent, or a columnar batch exposing
    ``to_jsonl_lines()`` (duck-typed so this module stays dependency-free).
    """
    if hasattr(events, "to_jsonl_lines"):
        lines = events.to_jsonl_lines()
    else:
        lines = (ev.to_json() for ev in events)
    n = 0
    with open(path, "a") as f:
        for line in lines:
            f.write(line + "\n")
            n += len(line) + 1
    return n


def load_jsonl(path: str) -> list[TraceEvent]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(TraceEvent.from_json(line))
    return out
