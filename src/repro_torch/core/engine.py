"""The diagnostic engine (paper §3, §5): streaming ingest -> detection ->
root-cause narrowing -> team routing (Table 1).

Pipeline (paper Fig 2):
  ① hang errors: daemon heartbeats -> call-stack analysis -> intra-kernel
     inspecting -> OPERATIONS team.
  ① fail-slows: macro throughput changepoint, validated + attributed with
     micro metrics (per-rank FLOPS, bandwidth) -> OPERATIONS team.
  ② regressions: micro metrics (issue-latency W1, voids, FLOPS, bandwidth)
     vs the healthy historical profile -> ALGORITHM or INFRASTRUCTURE team.
  ③ anything unresolved escalates to cross-team review.

Detection is PLUGGABLE (``repro_torch.core.detectors``): ``EngineConfig.
detectors`` names the per-job detector set, resolved through the registry
into fresh stateful instances bound to this job's ``DetectorContext``.
The paper's checks are themselves registered plugins; the default set
(``DEFAULT_DETECTORS``) reproduces the historical engine byte for byte.
The engine's job is only to aggregate metrics and drive the lifecycle:
``observe_step`` per closed step in ascending order, ``on_hang`` when a
majority of daemons report, ``finalize`` at end of stream.

Storage: events live in a step-partitioned columnar ``EventBatch`` — the
engine never keeps per-rank Python lists.  Producers may feed it TraceEvent
lists (the daemon sink), the legacy rank -> events dict, or EventBatches
directly (``ingest_batch``, zero-copy append); ``evaluate_all`` computes
every step's five metrics in ONE vectorized sweep (``aggregate_all``)
instead of rescanning events per step.  Fleet operation evaluates
INCREMENTALLY instead: ``evaluate_step_batch`` (slice held by the fleet
store) or ``evaluate_new_steps`` (own store, watermark-gated) advance the
same stateful detectors step by step, so a job is diagnosed while it runs
— see the JAX package's ``repro.fleet``, not ported yet.

Conservative policy (paper §8.2): the engine *reports*; it never kills jobs.

The port's copy of the JAX package's ``core/engine.py``: numpy
only (no torch), with the reference's names, thresholds and arithmetic.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.anomaly import Anomaly, Team  # noqa: F401  (re-export)
from repro_torch.core.columnar import KIND_TO_CODE, EventBatch
from repro_torch.core.detectors import DetectorContext, resolve_detectors
from repro_torch.core.events import EventKind, TraceEvent
from repro_torch.core.history import HealthyProfile, HistoryStore
from repro_torch.core.metrics import (StepMetrics, aggregate_all,
                                      aggregate_slice)

_C_HANG = KIND_TO_CODE[EventKind.HANG_SUSPECT]


@dataclass
class EngineConfig:
    backend: str = "dense-train"
    num_ranks: int = 1
    kernel_shapes: dict = field(default_factory=dict)  # name -> shape (layout advisor)
    failslow_window: int = 8
    failslow_drop: float = 0.12
    regression_consecutive: int = 2   # steps a micro signal must persist
    # per-job detector set: registry names, DetectorSpecs, classes, or
    # instances (see repro_torch.core.detectors).  None = DEFAULT_DETECTORS —
    # the paper's five checks + hang analysis, byte-equivalent to the
    # pre-registry engine.
    detectors: Optional[list] = None


class DiagnosticEngine:
    def __init__(self, config: EngineConfig,
                 history: Optional[HistoryStore] = None):
        self.cfg = config
        self.history = history or HistoryStore()
        self._chunks: list[EventBatch] = []
        self._merged: Optional[EventBatch] = None
        self._metrics_cache: Optional[dict[int, StepMetrics]] = None
        self.metrics: dict[int, StepMetrics] = {}
        self.anomalies: list[Anomaly] = []
        self._evaluated: set[int] = set()   # steps seen by the incremental path
        self._finalized = False
        self._finalize_lock = threading.Lock()
        self.ctx = DetectorContext(config=config, history=self.history)
        self.detectors = resolve_detectors(config.detectors)
        for d in self.detectors:
            d.bind(self.ctx)

    @property
    def baseline_metrics(self) -> Optional[StepMetrics]:
        """Metrics of the first evaluated step (shared with detectors)."""
        return self.ctx.baseline

    @baseline_metrics.setter
    def baseline_metrics(self, m: Optional[StepMetrics]):
        self.ctx.baseline = m

    # ------------------------------------------------------------------ #
    # ingest — all producers land in the columnar store
    # ------------------------------------------------------------------ #
    def ingest(self, events: list[TraceEvent]):
        """Daemon-sink entry point: a flat TraceEvent list."""
        if events:
            self._add(EventBatch.from_events(events))

    def ingest_all(self, events_by_rank):
        """Legacy rank -> event-list dict, or an EventBatch."""
        if isinstance(events_by_rank, EventBatch):
            self._add(events_by_rank)
        elif events_by_rank:
            self._add(EventBatch.from_events_by_rank(events_by_rank))

    def ingest_batch(self, batch: EventBatch):
        """Zero-conversion columnar append (the scale path)."""
        self._add(batch)

    def _add(self, batch: EventBatch):
        if len(batch):
            self._chunks.append(batch)
            self._merged = None
            self._metrics_cache = None

    @property
    def batch(self) -> EventBatch:
        """The consolidated columnar store (chunks merged lazily)."""
        if self._merged is None:
            self._merged = EventBatch.concat(self._chunks)
            self._chunks = [self._merged] if len(self._merged) else []
        return self._merged

    @property
    def events_by_rank(self) -> dict[int, list[TraceEvent]]:
        """Materialized per-event view — conversion cost, debugging only."""
        return self.batch.to_events_by_rank()

    def _all_metrics(self) -> dict[int, StepMetrics]:
        if self._metrics_cache is None:
            self._metrics_cache = aggregate_all(self.batch)
        return self._metrics_cache

    @property
    def profile(self) -> Optional[HealthyProfile]:
        return self.history.get(self.cfg.backend, self.cfg.num_ranks)

    # ------------------------------------------------------------------ #
    # per-step evaluation: drive the detector plugins
    # ------------------------------------------------------------------ #
    def evaluate_step(self, step: int) -> list[Anomaly]:
        m = self._all_metrics().get(step)
        if m is None:
            return []
        return self._evaluate_metrics(m, step)

    def _evaluate_metrics(self, m: StepMetrics, step: int) -> list[Anomaly]:
        self.metrics[step] = m
        if self.ctx.baseline is None:
            self.ctx.baseline = m
        found: list[Anomaly] = []
        for d in self.detectors:
            found.extend(d.observe_step(m, step))
        self.anomalies.extend(found)
        return found

    def evaluate_all(self) -> list[Anomaly]:
        """One vectorized metrics sweep, then the per-step detector pass."""
        ms = self._all_metrics()
        out = []
        for step in sorted(ms):
            out.extend(self._evaluate_metrics(ms[step], step))
        out.extend(self.check_hangs())
        out.extend(self.finalize_detectors())
        return out

    def finalize_detectors(self) -> list[Anomaly]:
        """End-of-stream hook: every detector's ``finalize()``, once —
        the check-and-set is locked so an engine driven from a replay
        worker thread and finalized from the main thread can't run a
        stateful detector's flush twice.  The built-ins return nothing
        here; stateful third-party detectors (e.g. trend accumulators)
        flush their tail findings."""
        with self._finalize_lock:
            if self._finalized:
                return []
            self._finalized = True
        found: list[Anomaly] = []
        for d in self.detectors:
            found.extend(d.finalize())
        self.anomalies.extend(found)
        return found

    # ------------------------------------------------------------------ #
    # incremental evaluation (the fleet path)
    # ------------------------------------------------------------------ #
    def evaluate_step_batch(self, step_batch: EventBatch, step: int,
                            num_ranks: Optional[int] = None) -> list[Anomaly]:
        """Evaluate ONE completed step from its columnar slice, held by an
        external step-partitioned store (the fleet multiplexer).
        ``step_batch`` must contain only rows of ``step``, in insertion
        order — exactly what ``StepPartitionedStore.pop_step`` yields.

        Detector state (throughput monitor, baseline metrics, pending-
        regression counters) advances exactly as in ``evaluate_all``, so
        feeding every step's slice in ascending order — then the hang check
        — yields identical anomalies to a terminal ``evaluate_all`` on the
        concatenated batch.  ``num_ranks`` should be the job-wide rank
        count (a single step's slice may not show every rank)."""
        m = aggregate_slice(step_batch, step, num_ranks=num_ranks)
        if m is None:
            return []
        self._evaluated.add(step)
        return self._evaluate_metrics(m, step)

    @property
    def evaluated_steps(self) -> set:
        """Steps the incremental path has diagnosed (single source of
        truth for watermark/late-event bookkeeping in the fleet)."""
        return self._evaluated

    def adopt_evaluated(self, steps) -> None:
        """Mark ``steps`` as already diagnosed — by ANOTHER engine whose
        results this one is mirroring (a fleet replay worker process ran
        the job's evaluation; the parent adopts its record so late-row
        bookkeeping and re-flush stay consistent).  Detector state does
        NOT transfer; only the evaluated-step set does."""
        self._evaluated.update(int(s) for s in steps)

    # ------------------------------------------------------------------ #
    # service checkpoints: full incremental-path state transfer
    # ------------------------------------------------------------------ #
    def snapshot_state(self) -> dict:
        """Picklable state of the INCREMENTAL evaluation path, complete
        enough that a fresh engine restored from it continues the stream
        byte-equivalently: evaluated-step set, finalize flag, the
        first-step baseline, and every detector's instance state (in
        configured order).  The ``metrics``/``anomalies`` histories are
        deliberately NOT included — they are debug/query conveniences
        reconstructed from the archive, not inputs to diagnosis."""
        return {
            "evaluated": sorted(self._evaluated),
            "finalized": self._finalized,
            "baseline": self.ctx.baseline,
            "detectors": [(type(d).name, d.state_dict())
                          for d in self.detectors],
        }

    def restore_state(self, state: dict) -> None:
        """Inverse of :meth:`snapshot_state` on a freshly constructed
        engine with the SAME config (the detector set must match — the
        checkpoint records instance state, not instances)."""
        have = [type(d).name for d in self.detectors]
        want = [nm for nm, _ in state["detectors"]]
        if have != want:
            raise ValueError(
                f"detector set mismatch restoring engine state: "
                f"checkpoint has {want}, engine has {have}")
        self._evaluated = {int(s) for s in state["evaluated"]}
        self._finalized = bool(state["finalized"])
        self.ctx.baseline = state["baseline"]
        for d, (_nm, ds) in zip(self.detectors, state["detectors"]):
            d.load_state(ds)

    def evaluate_new_steps(self, upto: Optional[int] = None) -> list[Anomaly]:
        """Incremental evaluation over the engine's OWN store: evaluate, in
        ascending order, every step not yet evaluated — optionally only
        steps below ``upto`` (the caller's watermark).  Detector work runs
        on the pending steps only, but the store merge + step index are
        still O(total events) per call, so for long-running streamed jobs
        use the fleet path (the JAX package's ``repro.fleet``), whose
        step-partitioned store makes each evaluation proportional to the
        new data.  A terminal
        ``finalize`` is simply ``evaluate_new_steps()`` followed by
        ``check_hangs()``.  Do not mix with ``evaluate_all`` on the same
        engine (it re-runs every step through the stateful detectors)."""
        pending = [s for s in self.batch.steps()
                   if s not in self._evaluated
                   and (upto is None or s < upto)]
        if not pending:
            return []
        ms = aggregate_all(self.batch, steps=pending)
        out: list[Anomaly] = []
        for step in sorted(ms):
            self._evaluated.add(step)
            out.extend(self._evaluate_metrics(ms[step], step))
        return out

    # ------------------------------------------------------------------ #
    # hang path (①)
    # ------------------------------------------------------------------ #
    def check_hangs(self, ring_progress=None) -> list[Anomaly]:
        b = self.batch
        if not len(b):
            return []
        suspects = {}
        for row in np.nonzero(b.kind == _C_HANG)[0].tolist():
            stack = (b.extra.get(row) or {}).get("stack", [])
            suspects[int(b.rank[row])] = stack
        if len(suspects) < max(b.num_distinct_ranks() // 2, 1):
            return []
        return self.on_hang(suspects, ring_progress)

    def on_hang(self, stacks: dict, ring_progress=None) -> list[Anomaly]:
        """Fan a majority-hang report out to every detector's ``on_hang``;
        with the default set, exactly the hang-analysis plugin answers."""
        found: list[Anomaly] = []
        for d in self.detectors:
            a = d.on_hang(stacks, ring_progress)
            if a is not None:
                found.append(a)
        self.anomalies.extend(found)
        return found

    def diagnose_hang(self, stacks: dict,
                      ring_progress=None) -> Optional[Anomaly]:
        """Back-compat single-anomaly hang entry point: first detector
        answer (``None`` only if the configured set has no hang handler)."""
        found = self.on_hang(stacks, ring_progress)
        return found[0] if found else None

    # ------------------------------------------------------------------ #
    # profile learning helper
    # ------------------------------------------------------------------ #
    def learn_healthy(self, steps: Optional[list[int]] = None,
                      margin: float = 1.5) -> HealthyProfile:
        ms_all = self._all_metrics()
        steps = steps if steps is not None else sorted(ms_all)
        ms = [ms_all[s] for s in steps if s in ms_all]
        return self.history.learn_from_metrics(
            self.cfg.backend, self.cfg.num_ranks, ms, margin=margin)
