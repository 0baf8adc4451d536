"""Self-telemetry: one counter/gauge registry for the whole pipeline.

Flare is judged by how observable it makes *training jobs* — but an
eight-month deployment also needs the pipeline itself to be observable:
is the daemon's spill failing?  How far behind is a job's watermark?
How fast did last night's replay decode?  Those numbers existed as
scattered ad-hoc attributes (``daemon.spill_errors``, ``FleetJob
.late_events``, ``ReplayStats``); this module gives them one home.

Design goals, in order:

  * **hot-path cheap**: a :class:`Counter` is one Python int add behind
    an attribute — no lock, no dict lookup per increment.  Handles are
    resolved once (``registry.counter("daemon.events")``) and cached by
    the instrumented component.  Unlocked increments race exactly as
    benignly as the plain ``+= 1`` attributes they replace: a dropped
    tick under contention, never a crash or a negative value.
  * **tagged**: series are keyed ``name{k=v,...}`` with sorted tags, so
    per-job series (``fleet.late_rows{job=b}``) aggregate naturally and
    render stably.
  * **snapshot-exportable**: :meth:`TelemetryRegistry.snapshot` returns
    a plain-JSON dict (``{"counters": {...}, "gauges": {...}}``); the
    archive layer (``repro.archive``) writes these next to the trace
    segments so "pipeline weather" rides along with the data it
    produced.  ``extra_tags`` lets an aggregator (the multiplexer
    merging its daemons' registries) re-tag a whole snapshot by job.

Components accept a registry via their config (``DaemonConfig
.telemetry``, ``FleetConfig.telemetry``) and default to a private one,
so tests and single-component uses need no global state; pass one
shared registry to see the whole pipeline in one snapshot.
"""
from __future__ import annotations

import threading
import time
from typing import Optional


def series_key(name: str, tags: Optional[dict] = None) -> str:
    """Canonical series key: ``name`` or ``name{k=v,...}``, tags sorted
    so the same (name, tags) always renders the same key."""
    if not tags:
        return name
    inner = ",".join(f"{k}={tags[k]}" for k in sorted(tags))
    return f"{name}{{{inner}}}"


def parse_series_key(key: str) -> tuple[str, dict]:
    """Inverse of :func:`series_key`: ``(name, tags)`` from a serialized
    key.  Tag values come back as strings — the only form they ever had
    in a key."""
    if "{" not in key:
        return key, {}
    name, _, inner = key.partition("{")
    tags = dict(kv.split("=", 1) for kv in inner.rstrip("}").split(","))
    return name, tags


class Counter:
    """Monotonic counter handle.  ``inc`` returns the post-increment
    value so warn-once patterns (``if c.inc() == 1: warn(...)``) need no
    second read."""

    __slots__ = ("name", "tags", "value")

    def __init__(self, name: str, tags: Optional[dict] = None):
        self.name = name
        self.tags = dict(tags) if tags else {}
        self.value = 0

    def inc(self, n: int = 1) -> int:
        self.value += n
        return self.value

    @property
    def key(self) -> str:
        return series_key(self.name, self.tags)


class Gauge:
    """Last-value-wins gauge handle (queue depths, lags, rates)."""

    __slots__ = ("name", "tags", "value")

    def __init__(self, name: str, tags: Optional[dict] = None):
        self.name = name
        self.tags = dict(tags) if tags else {}
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    @property
    def key(self) -> str:
        return series_key(self.name, self.tags)


class TelemetryRegistry:
    """Get-or-create registry of counters and gauges.

    Handle creation is locked (it happens once per series); the handles
    themselves are lock-free.  Re-requesting a (name, tags) pair returns
    the SAME handle, so two components counting the same series add into
    one number instead of shadowing each other."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}

    def counter(self, name: str, **tags) -> Counter:
        key = series_key(name, tags)
        with self._lock:
            c = self._counters.get(key)
            if c is None:
                c = self._counters[key] = Counter(name, tags)
            return c

    def gauge(self, name: str, **tags) -> Gauge:
        key = series_key(name, tags)
        with self._lock:
            g = self._gauges.get(key)
            if g is None:
                g = self._gauges[key] = Gauge(name, tags)
            return g

    def value(self, name: str, **tags) -> float:
        """Current value of a series, 0.0 if it was never touched —
        counter first, gauge as fallback.  Read-only: unlike
        :meth:`counter`/:meth:`gauge` it never materializes the series,
        so probing (tests, the chaos harness asserting on recovery
        counters) leaves snapshots unchanged."""
        key = series_key(name, tags)
        with self._lock:
            c = self._counters.get(key)
            if c is not None:
                return c.value
            g = self._gauges.get(key)
            return g.value if g is not None else 0.0

    # ------------------------------------------------------------------ #
    def snapshot(self, extra_tags: Optional[dict] = None) -> dict:
        """Plain-JSON snapshot of every series.  ``extra_tags`` are
        merged into each series' tags (without mutating the handles) —
        the multiplexer uses this to job-tag its daemons' registries
        when merging them into one fleet snapshot."""
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
        out = {"ts": time.time(), "counters": {}, "gauges": {}}
        for c in counters:
            tags = {**c.tags, **extra_tags} if extra_tags else c.tags
            out["counters"][series_key(c.name, tags)] = c.value
        for g in gauges:
            tags = {**g.tags, **extra_tags} if extra_tags else g.tags
            out["gauges"][series_key(g.name, tags)] = g.value
        return out

    def merge_snapshot(self, snap: dict, into: Optional[dict] = None,
                       extra_tags: Optional[dict] = None) -> dict:
        """Fold an already-taken snapshot dict into ``into`` (or a fresh
        snapshot of this registry): counters ADD on key collision,
        gauges last-write-win.  ``extra_tags`` re-tag the incoming
        series."""
        base = into if into is not None else self.snapshot()
        for kind, combine in (("counters", lambda a, b: a + b),
                              ("gauges", lambda a, b: b)):
            for key, val in snap.get(kind, {}).items():
                k = _retag(key, extra_tags) if extra_tags else key
                if k in base[kind]:
                    base[kind][k] = combine(base[kind][k], val)
                else:
                    base[kind][k] = val
        return base

    def absorb(self, snap: dict,
               extra_tags: Optional[dict] = None) -> None:
        """Fold a snapshot INTO this registry's live handles: counters
        add their value, gauges last-write-win.  Unlike
        :meth:`merge_snapshot` (which merges dicts), this materializes
        handles, so a process-sharded worker's telemetry lands on the
        parent's registry exactly as if the worker had incremented the
        parent's counters directly — the fleet replay path uses this to
        merge per-job worker registries across the IPC boundary."""
        for key, val in snap.get("counters", {}).items():
            k = _retag(key, extra_tags) if extra_tags else key
            name, tags = parse_series_key(k)
            if val:
                self.counter(name, **tags).inc(val)
            else:
                self.counter(name, **tags)       # materialize zero series
        for key, val in snap.get("gauges", {}).items():
            k = _retag(key, extra_tags) if extra_tags else key
            name, tags = parse_series_key(k)
            self.gauge(name, **tags).set(val)


def _retag(key: str, extra_tags: dict) -> str:
    """Re-render a serialized series key with extra tags merged in."""
    name, tags = parse_series_key(key)
    tags.update({k: str(v) for k, v in extra_tags.items()})
    return series_key(name, tags)
