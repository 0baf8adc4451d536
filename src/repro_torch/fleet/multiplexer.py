"""FleetMultiplexer — streaming multi-job ingest + incremental diagnosis.

The paper's headline deployment is not one job but a fleet: Flare ran for
eight months over 6,000 GPUs, ingesting every concurrent job's daemon
streams and diagnosing them *online*.  This module is that layer:

  * many jobs ingest concurrently into per-job step-partitioned columnar
    stores with fleet-shared name/group interning (``fleet.store``);
  * each job is evaluated INCREMENTALLY: a per-job watermark closes step
    ``s`` once data for step ``s + watermark_delay`` has been seen
    (out-of-order chunks within the window are fine; rows arriving for an
    already-diagnosed step are counted as late and dropped);
  * closed steps run through the job's own ``DiagnosticEngine`` via
    ``evaluate_step_batch`` — the same stateful detectors as a terminal
    ``evaluate_all``, so streaming diagnosis equals batch diagnosis;
  * hang suspects are tracked per job as chunks arrive; when a majority of
    the job's ranks report, pending steps are flushed and the hang is
    diagnosed immediately (a hung job stops producing events — waiting for
    a watermark that will never advance would mask exactly the anomaly the
    daemons are screaming about);
  * a second, FLEET-SCOPE detector tier (``FleetConfig.fleet_detectors``,
    resolved through the same registry at scope ``"fleet"``) observes
    every closed step's anomalies together with the job -> rack/switch
    topology (``set_topology``) — e.g. ``CrossJobFailSlowCorrelator``
    reclassifies co-occurring fail-slows on shared hardware as
    INFRASTRUCTURE.  Its emissions land on the same stream tagged
    ``origin="fleet"``;
  * everything lands in one merged, timestamp-ordered, team-routed
    :class:`~repro_torch.fleet.stream.AnomalyStream` tagged with job ids.

Feed it from live ``TracingDaemon``s (``daemon.attach_fleet(mux, job)``),
from simulators (``mux.ingest(job, batch)``), or from recorded JSONL logs
(``fleet.replay``).  Ingest is thread-safe and parallel across jobs:
each job has its own lock (a global lock guards only the job registry;
the shared interner, the anomaly stream, and the fleet-detector tier lock
internally), so daemon background threads feeding different jobs never
serialize each other's diagnosis.

The port's copy of the JAX package's ``fleet/multiplexer.py``: numpy only
(no torch), with the reference's names, thresholds and arithmetic.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.columnar import EventBatch
from repro_torch.core.detectors.fleet import FleetContext
from repro_torch.core.detectors.registry import resolve_detectors
from repro_torch.core.engine import DiagnosticEngine, EngineConfig, Team
from repro_torch.core.history import HistoryStore
from repro_torch.core.telemetry import Counter, Gauge, TelemetryRegistry
from repro_torch.fleet.store import SharedInterner, StepPartitionedStore
from repro_torch.fleet.stream import AnomalyStream, FleetAnomaly


@dataclass
class FleetConfig:
    watermark_delay: int = 1    # steps behind max-seen before a step closes
    backend: str = "dense-train"
    routes: Optional[dict[Team, str]] = None
    # fleet-scope detector tier: registry names (scope "fleet"),
    # DetectorSpecs, classes, or instances.  Default: none.
    fleet_detectors: Optional[list] = None
    # job_id -> {"rack": ..., "switch": ...}; extend live via set_topology
    topology: Optional[dict[str, dict]] = None
    # self-telemetry registry; None = a private one per multiplexer.
    # ``telemetry_snapshot()`` merges attached daemons' registries in.
    telemetry: Optional[TelemetryRegistry] = None
    # per-job memory cap on the step-partitioned store, in buffered ROWS
    # (None = unbounded).  When a job's pending slices exceed the cap,
    # the oldest pending steps are force-closed (evaluated early) until
    # under it — bounded memory at the cost of possibly dropping
    # late-arriving rows for those steps on pathologically out-of-order
    # streams.  Deterministic per job (depends only on that job's own
    # ingest sequence), so serial/thread/process replays stay
    # byte-equivalent at any cap.  ``fleet.forced_closes{job=}`` counts.
    max_pending_rows: Optional[int] = None


@dataclass
class FleetJob:
    job_id: str
    store: StepPartitionedStore
    engine: DiagnosticEngine
    # telemetry handles (fleet.late_rows{job=}, fleet.watermark_lag{job=},
    # fleet.pending_steps{job=}) — created by add_job from the mux registry
    late_rows: Optional[Counter] = None
    watermark_lag: Optional[Gauge] = None
    pending_depth: Optional[Gauge] = None
    last_closed: int = -1
    hang_reported: bool = False
    daemon: object = None
    anomaly_count: int = 0
    # graceful leave: a departed job is fully diagnosed (flushed, hang
    # checked, detectors finalized) and no longer holds back the fleet
    # frontier; rows arriving afterwards are dropped and counted
    departed: bool = False
    # per-job lock: jobs share no mutable state except the interner and
    # the anomaly stream (each locked internally), so concurrent daemon
    # threads diagnose different jobs in parallel instead of serializing
    # the whole fleet behind one lock
    lock: threading.Lock = field(default_factory=threading.Lock)
    # leaf lock for anomaly_count only: the fleet tier credits a VICTIM
    # job from another job's ingest thread, which must not acquire the
    # victim's work lock (lock-order inversion with its own _observe_fleet)
    counter_lock: threading.Lock = field(default_factory=threading.Lock)

    def count_anomaly(self, n: int = 1) -> None:
        with self.counter_lock:
            self.anomaly_count += n

    @property
    def late_events(self) -> int:
        """Rows that arrived for an already-diagnosed step (historical
        name; the series is ``fleet.late_rows{job=...}``)."""
        return self.late_rows.value if self.late_rows is not None else 0

    @property
    def evaluated(self) -> set:
        """Diagnosed steps — the engine's record is the single source of
        truth (it marks steps in ``evaluate_step_batch``)."""
        return self.engine.evaluated_steps


class FleetMultiplexer:
    def __init__(self, config: Optional[FleetConfig] = None,
                 history: Optional[HistoryStore] = None):
        self.cfg = config or FleetConfig()
        self.history = history or HistoryStore()
        self.interner = SharedInterner()
        self.telemetry = self.cfg.telemetry or TelemetryRegistry()
        self.stream = AnomalyStream(self.cfg.routes)
        # deep-copy the inner attr dicts: set_topology mutates them, and a
        # FleetConfig reused across multiplexers must stay pristine
        self.topology: dict[str, dict] = {
            k: dict(v) for k, v in (self.cfg.topology or {}).items()}
        self.fleet_detectors = resolve_detectors(
            self.cfg.fleet_detectors, scope="fleet")
        self._fleet_ctx = FleetContext(topology=self.topology,
                                       config=self.cfg)
        for fd in self.fleet_detectors:
            fd.bind(self._fleet_ctx)
        self._jobs: dict[str, FleetJob] = {}
        self._lock = threading.RLock()    # job REGISTRY only; work is
        #                                   guarded by each job's own lock
        self._fleet_det_lock = threading.Lock()   # cross-job tier state
        # Fleet-tier frontier state.  Cross-job detectors are ORDER-
        # sensitive (a correlation window closes against whichever
        # observation arrived last), so observations are never fed to
        # them in raw arrival order.  Every closed step's anomalies are
        # buffered per job under a deterministic sort KEY — the job's
        # running max of closed-step timestamps (a cummax, so keys are
        # monotone per job regardless of per-step ts jitter) — and
        # resolved in global ``(key, job_id, per-job order)`` order once
        # the FRONTIER (min progress over active jobs) passes the key.
        # Because every job's future keys are >= its current progress,
        # each resolved batch is a prefix of the full sorted sequence:
        # incremental (live) resolution and one-shot end-of-stream
        # resolution produce byte-identical emissions.
        self._fleet_buf: dict[str, list] = {}       # job -> [(key, step, anoms, ts)]
        self._fleet_progress: dict[str, float] = {}  # job -> cummax closed ts
        # record mode: buffer observations even with no local fleet
        # detectors (a worker process records for its parent's tier) and
        # never resolve locally — drain_fleet_observations ships them
        self._record_fleet = False

    # ------------------------------------------------------------------ #
    # job registry
    # ------------------------------------------------------------------ #
    def add_job(self, job_id: str,
                engine_cfg: Optional[EngineConfig] = None) -> FleetJob:
        """Register a job.  Without an ``engine_cfg`` (and thus without a
        learned profile for its backend/scale) the job still gets the
        macro fail-slow and hang paths; regressions need history."""
        with self._lock:
            if job_id in self._jobs:
                return self._jobs[job_id]
            cfg = engine_cfg or EngineConfig(backend=self.cfg.backend)
            job = FleetJob(
                job_id=job_id,
                store=StepPartitionedStore(self.interner),
                engine=DiagnosticEngine(cfg, self.history),
                late_rows=self.telemetry.counter("fleet.late_rows",
                                                 job=job_id),
                watermark_lag=self.telemetry.gauge("fleet.watermark_lag",
                                                   job=job_id),
                pending_depth=self.telemetry.gauge("fleet.pending_steps",
                                                   job=job_id))
            self._jobs[job_id] = job
            return job

    def job(self, job_id: str) -> FleetJob:
        with self._lock:
            return self._jobs[job_id]

    @property
    def jobs(self) -> list[FleetJob]:
        with self._lock:
            return list(self._jobs.values())

    def set_topology(self, job_id: str, **attrs) -> None:
        """Annotate a job with placement metadata for the fleet-scope
        detector tier (e.g. ``set_topology("job-a", rack="r12",
        switch="sw3")``).  Merges into any attrs set earlier."""
        with self._fleet_det_lock:
            self.topology.setdefault(job_id, {}).update(attrs)

    def register_daemon(self, job_id: str, daemon,
                        engine_cfg: Optional[EngineConfig] = None) -> FleetJob:
        job = self.add_job(job_id, engine_cfg)
        job.daemon = daemon
        return job

    def attach_daemon(self, job_id: str, daemon):
        """Convenience for ``daemon.attach_fleet(self, job_id)``."""
        return daemon.attach_fleet(self, job_id)

    # ------------------------------------------------------------------ #
    # ingest + incremental evaluation
    # ------------------------------------------------------------------ #
    def ingest(self, job_id: str, events) -> None:
        """Append one chunk of a job's stream: an ``EventBatch``, a flat
        ``list[TraceEvent]`` (daemon sink shape), or the legacy
        rank -> event-list dict.  Closes and diagnoses every step the
        chunk's watermark completed."""
        if isinstance(events, EventBatch):
            batch = events
        elif isinstance(events, dict):
            batch = EventBatch.from_events_by_rank(events)
        else:
            batch = EventBatch.from_events(events)
        if not len(batch):
            return
        with self._lock:
            job = self._jobs.get(job_id) or self.add_job(job_id)
        if job.departed:
            # graceful-leave contract: a retired job's diagnosis is
            # closed; stragglers are dropped and counted, never revived
            self.telemetry.counter("fleet.departed_rows",
                                   job=job_id).inc(len(batch))
            return
        with job.lock:
            touched = job.store.append(batch)
            for s, nrows in touched.items():
                if s in job.evaluated:
                    job.late_rows.inc(nrows)
                    job.store.drop_step(s)
            self._advance(job)
            self._maybe_hang(job)
        self.resolve_fleet_ready()

    def ingest_step_aligned(self, job_id: str, batch: EventBatch) -> None:
        """Feed one decoded chunk as per-step slices in step order, so a
        segment spanning many steps (a whole FCS file, a big wire frame)
        advances the watermark incrementally instead of arriving as one
        monolithic batch — diagnosis becomes independent of how the
        stream happened to be chunked on disk or on the wire.
        Single-step chunks pass straight through.

        Step-sorted chunks (the overwhelmingly common shape) are sliced
        as ZERO-COPY views (``slice_rows``); only genuinely interleaved
        chunks pay the ``take`` permutation."""
        order, uniq, bounds = batch.step_index()
        if uniq.size <= 1:
            self.ingest(job_id, batch)
            return
        if batch.is_step_sorted():
            # sorted => the stable argsort is the identity, so bounds are
            # direct row offsets into the original columns
            for j in range(uniq.size):
                self.ingest(job_id, batch.slice_rows(
                    int(bounds[j]), int(bounds[j + 1])))
            return
        for j in range(uniq.size):
            self.ingest(job_id, batch.take(order[bounds[j]:bounds[j + 1]]))

    @staticmethod
    def _job_ranks(job: FleetJob) -> int:
        """Job-wide rank count: the configured engine scale wins over the
        ranks seen so far — early chunks (one daemon's first drain) may
        show a tiny subset, which would skew per-rank metrics and let a
        single suspect clear the majority-hang threshold."""
        return max(job.store.num_ranks, job.engine.cfg.num_ranks)

    def _close_step(self, job: FleetJob, s: int) -> None:
        sb = job.store.pop_step(s)
        anoms = job.engine.evaluate_step_batch(
            sb, s, num_ranks=self._job_ranks(job))
        ts = float(sb.end_ts.max()) if len(sb) else job.store.last_ts
        job.last_closed = s
        for a in anoms:
            self.stream.push(job.job_id, a, ts)
            job.count_anomaly()
        self._observe_fleet(job.job_id, s, anoms, ts)

    def _advance(self, job: FleetJob, flush: bool = False) -> None:
        limit = None if flush \
            else job.store.max_step_seen - self.cfg.watermark_delay
        for s in job.store.pending_steps():
            if limit is not None and s > limit:
                break
            self._close_step(job, s)
        # memory cap: if the pending slices still exceed the per-job row
        # budget, force-close oldest-first until under it (the newest
        # pending step always stays buffered — it is the one still
        # filling).  Early closure means late rows for those steps get
        # dropped, which is the documented trade-off of the cap.
        cap = self.cfg.max_pending_rows
        if cap is not None and not flush and job.store.buffered_rows > cap:
            forced = 0
            while job.store.buffered_rows > cap:
                pending = job.store.pending_steps()
                if len(pending) <= 1:
                    break
                self._close_step(job, pending[0])
                forced += 1
            if forced:
                self.telemetry.counter("fleet.forced_closes",
                                       job=job.job_id).inc(forced)
        # watermark lag = steps seen but not yet closed; pending depth =
        # step buckets currently held (the mux's "queue")
        job.watermark_lag.set(max(job.store.max_step_seen - job.last_closed,
                                  0))
        job.pending_depth.set(len(job.store.pending_steps()))

    # ------------------------------------------------------------------ #
    # fleet tier: deterministic frontier resolution
    # ------------------------------------------------------------------ #
    def record_fleet_observations(self, on: bool = True) -> None:
        """Record mode for worker processes: buffer observations even
        when THIS multiplexer has no fleet detectors, and never resolve
        locally.  :meth:`drain_fleet_observations` ships the keyed
        sequence to the parent (which owns the real detectors)."""
        with self._fleet_det_lock:
            self._record_fleet = bool(on)

    def drain_fleet_observations(self) -> dict[str, list]:
        """Take the buffered ``job_id -> [(key, step, anomalies, ts)]``
        observations (recording stays on).  Keys are the per-job cummax
        described in :meth:`resolve_fleet_ready`; shipping them (rather
        than recomputing from the anomalous subset) keeps the parent's
        global sort identical to an in-process run."""
        with self._fleet_det_lock:
            out, self._fleet_buf = self._fleet_buf, {}
        return out

    def buffer_fleet_observations(self, job_id: str, obs) -> None:
        """Append a worker's shipped ``[(key, step, anomalies, ts)]``
        sequence (in per-job order) to the local buffer.  Keys are
        re-cummaxed against anything already buffered for the job, so
        incremental shipments concatenate cleanly."""
        if not obs:
            return
        with self._fleet_det_lock:
            buf = self._fleet_buf.setdefault(job_id, [])
            prog = self._fleet_progress.get(job_id, float("-inf"))
            for key, step, anoms, ts in obs:
                prog = max(prog, float(key))
                buf.append((prog, int(step), list(anoms), float(ts)))
            self._fleet_progress[job_id] = prog

    def note_fleet_progress(self, job_id: str, ts: float) -> None:
        """Advance a job's fleet frontier (cummax) without an
        observation — how a parent mirrors the progress a worker process
        reports for anomaly-free stretches of a job's stream."""
        with self._fleet_det_lock:
            if ts > self._fleet_progress.get(job_id, float("-inf")):
                self._fleet_progress[job_id] = float(ts)

    def fleet_progress(self, job_id: str) -> float:
        """The job's fleet-tier progress (cummax of closed-step ts)."""
        with self._fleet_det_lock:
            return self._fleet_progress.get(job_id, float("-inf"))

    def _frontier_locked(self) -> float:
        """Min progress over active (non-departed) jobs — the largest
        key the global sorted observation order is already complete up
        to.  Jobs that never closed a step pin it at -inf (their first
        observation could sort anywhere); departed jobs don't count."""
        lo = float("inf")
        with self._lock:
            jobs = list(self._jobs.values())
        for j in jobs:
            if j.departed:
                continue
            p = self._fleet_progress.get(j.job_id, float("-inf"))
            if p < lo:
                lo = p
        return lo

    def _resolve_locked(self, lo: float) -> None:
        """Feed every buffered observation with key strictly below
        ``lo`` to the fleet detectors, in ``(key, job_id, per-job
        order)`` order.  Ties at the frontier are held back until every
        active job's progress passes them (or the job departs), so
        successive calls emit prefixes of one global total order."""
        if not self.fleet_detectors:
            return
        batch: list = []
        done: list[str] = []
        for job_id, buf in self._fleet_buf.items():
            n = 0
            while n < len(buf) and buf[n][0] < lo:
                n += 1
            if n:
                batch.extend((key, job_id, step, anoms, ts)
                             for key, step, anoms, ts in buf[:n])
                del buf[:n]
            if not buf:
                done.append(job_id)
        for job_id in done:
            del self._fleet_buf[job_id]
        if not batch:
            return
        # stable sort: per-job buffers are already in order, so equal
        # (key, job_id) pairs keep their per-job sequence
        batch.sort(key=lambda r: (r[0], r[1]))
        for key, job_id, step, anoms, ts in batch:
            for fd in self.fleet_detectors:
                for jid, a in fd.observe_step(job_id, step, anoms, ts):
                    self.stream.push(jid, a, ts, origin="fleet")
                    with self._lock:
                        j = self._jobs.get(jid)
                    if j is not None:
                        j.count_anomaly()

    def resolve_fleet_ready(self) -> None:
        """Resolve every fleet observation the frontier has passed —
        this is what makes cross-job reclassification fire LIVE: call
        it after ingest progress (the mux does so itself on ingest /
        flush) or after buffering worker shipments."""
        # unlocked fast path: nothing buffered (or no detectors) is the
        # overwhelmingly common per-chunk case — a stale read just means
        # the next call resolves, so ingest never serializes here
        if not self.fleet_detectors or not self._fleet_buf:
            return
        with self._fleet_det_lock:
            self._resolve_locked(self._frontier_locked())

    def resolve_fleet_all(self) -> None:
        """End-of-stream resolution: resolve everything still buffered
        regardless of frontier.  ``replay_dir`` calls this when a
        directory drain completes; ``finalize()`` calls it before the
        detectors' own ``finalize()`` sweep."""
        with self._fleet_det_lock:
            self._resolve_locked(float("inf"))

    def _observe_fleet(self, job_id: str, step: int, anoms: list,
                       ts: float) -> None:
        """Buffer one closed step's anomalies for the fleet-scope tier
        (and advance the job's frontier progress).  Resolution happens
        separately — see :meth:`resolve_fleet_ready`."""
        if not (self.fleet_detectors or self._record_fleet):
            return
        with self._fleet_det_lock:
            prog = max(self._fleet_progress.get(job_id, float("-inf")),
                       float(ts))
            self._fleet_progress[job_id] = prog
            if anoms:
                self._fleet_buf.setdefault(job_id, []).append(
                    (prog, step, list(anoms), ts))

    def restore_job_state(self, job_id: str, state: dict) -> None:
        """Mirror a replay worker process's per-job end state onto this
        (parent) multiplexer: store summary facts, watermark position,
        hang flag, and the engine's evaluated-step record — so
        ``stats()``, a later ``flush()``, and late-row bookkeeping
        behave exactly as if the job had been replayed in-process.
        Anomaly counts are NOT restored; the parent counts them as it
        re-pushes the worker's shipped anomalies."""
        job = self.job(job_id)
        with job.lock:
            job.store.restore_summary(state["store"])
            job.last_closed = max(job.last_closed, int(state["last_closed"]))
            job.hang_reported = job.hang_reported or bool(
                state["hang_reported"])
            job.engine.adopt_evaluated(state["evaluated_steps"])
            job.watermark_lag.set(
                max(job.store.max_step_seen - job.last_closed, 0))
            job.pending_depth.set(len(job.store.pending_steps()))

    # ------------------------------------------------------------------ #
    # service checkpoints: full pipeline state transfer
    # ------------------------------------------------------------------ #
    def snapshot_job_state(self, job_id: str) -> dict:
        """Complete picklable state of ONE job's pipeline — store
        (pending slices included), engine (evaluated set, baseline,
        detector instances), watermark position, flags, counters, and
        the job's fleet-frontier progress.  Unlike the worker terminal
        ``summary()`` (lossy by design), a pipeline restored from this
        continues the stream byte-equivalently."""
        job = self.job(job_id)
        with job.lock:
            state = {
                "store": job.store.snapshot_state(),
                "engine": job.engine.snapshot_state(),
                "last_closed": job.last_closed,
                "hang_reported": job.hang_reported,
                "departed": job.departed,
                "anomaly_count": job.anomaly_count,
            }
        with self._fleet_det_lock:
            state["fleet_progress"] = self._fleet_progress.get(
                job_id, float("-inf"))
        return state

    def restore_job_pipeline(self, job_id: str, state: dict) -> None:
        """Inverse of :meth:`snapshot_job_state` onto an ``add_job``-ed
        job with the same engine config, on an interner that already
        adopted the checkpointed tables."""
        job = self.job(job_id)
        with job.lock:
            job.store.restore_state(state["store"])
            job.engine.restore_state(state["engine"])
            job.last_closed = int(state["last_closed"])
            job.hang_reported = bool(state["hang_reported"])
            job.departed = bool(state["departed"])
            with job.counter_lock:
                job.anomaly_count = int(state["anomaly_count"])
            job.watermark_lag.set(
                max(job.store.max_step_seen - job.last_closed, 0))
            job.pending_depth.set(len(job.store.pending_steps()))
        with self._fleet_det_lock:
            self._fleet_progress[job_id] = float(state["fleet_progress"])

    def snapshot_fleet_state(self) -> dict:
        """Fleet-tier (cross-job) picklable state: the shared intern
        tables (the live list objects — pickled in the same dump as the
        job states so slice identity survives), topology, the buffered
        observation sequences + frontier progress, every fleet
        detector's instance state, and the stream's sequence counter.
        Take it quiesced (no concurrent ingest) with the stream drained."""
        with self._fleet_det_lock:
            return {
                "names": self.interner.names,
                "groups": self.interner.groups,
                "topology": {k: dict(v) for k, v in self.topology.items()},
                "fleet_buf": {j: list(b)
                              for j, b in self._fleet_buf.items()},
                "fleet_progress": dict(self._fleet_progress),
                "fleet_detectors": [(type(fd).name, fd.state_dict())
                                    for fd in self.fleet_detectors],
                "stream_total": self.stream.total,
                "history_profiles": self.history.snapshot_profiles(),
            }

    def restore_fleet_state(self, state: dict) -> None:
        """Inverse of :meth:`snapshot_fleet_state` on a fresh
        multiplexer with the same fleet-detector config.  Call BEFORE
        restoring any job pipeline (they expect the adopted tables).
        Topology merges (``self.topology`` is the live object the bound
        ``FleetContext`` reads, so it mutates in place)."""
        have = [type(fd).name for fd in self.fleet_detectors]
        want = [nm for nm, _ in state["fleet_detectors"]]
        if have != want:
            raise ValueError(
                f"fleet-detector set mismatch restoring state: "
                f"checkpoint has {want}, multiplexer has {have}")
        self.interner.restore_tables(state["names"], state["groups"])
        with self._fleet_det_lock:
            for job_id, attrs in state["topology"].items():
                self.topology.setdefault(job_id, {}).update(attrs)
            self._fleet_buf = {j: list(b)
                               for j, b in state["fleet_buf"].items()}
            self._fleet_progress = dict(state["fleet_progress"])
            for fd, (_nm, fs) in zip(self.fleet_detectors,
                                     state["fleet_detectors"]):
                fd.load_state(fs)
        self.stream.restore_seq(state["stream_total"])
        self.history.restore_profiles(state["history_profiles"])

    def _maybe_hang(self, job: FleetJob) -> None:
        stacks = job.store.hang_stacks
        if job.hang_reported or not stacks:
            return
        if len(stacks) < max(self._job_ranks(job) // 2, 1):
            return
        # a hung job's stream stops: flush pending steps (matching the
        # terminal evaluate_all order), then diagnose from the stacks.
        self._advance(job, flush=True)
        anoms = job.engine.on_hang(dict(stacks), None)
        for a in anoms:
            self.stream.push(job.job_id, a, job.store.last_ts)
            job.count_anomaly()
        self._observe_fleet(job.job_id, -1, anoms, job.store.last_ts)
        job.hang_reported = True

    # ------------------------------------------------------------------ #
    # draining / shutdown
    # ------------------------------------------------------------------ #
    def poll(self) -> list[FleetAnomaly]:
        """New anomalies since the last poll, merged + ordered."""
        return self.stream.drain()

    def flush(self, job_id: Optional[str] = None) -> None:
        """Evaluate pending steps (ignoring watermarks) and run the hang
        check for one job or all jobs.  Anomalies stay in the stream for
        the next ``poll()`` — use ``finalize`` to flush AND drain."""
        targets = [self.job(job_id)] if job_id is not None else self.jobs
        for job in targets:
            with job.lock:
                self._advance(job, flush=True)
                self._maybe_hang(job)
        self.resolve_fleet_ready()

    def retire_job(self, job_id: str) -> None:
        """Graceful LEAVE of one job mid-run, without finalizing the
        fleet: flush its pending steps, run its hang check, run its
        engine's end-of-stream detector finalize, then mark it departed
        — its frontier contribution becomes +inf (so buffered cross-job
        observations from other jobs stop waiting on it) and any rows
        that straggle in afterwards are dropped and counted
        (``fleet.departed_rows{job=}``).  Deterministic: retiring a job
        at its end of stream and finalizing the fleet later yields the
        same merged output as one terminal ``finalize()`` (engine
        finalize is idempotent; the stream drain order is
        ``(ts, job_id, seq)``).  Anomalies stay queued for ``poll()``."""
        job = self.job(job_id)
        with job.lock:
            if job.departed:
                return
            self._advance(job, flush=True)
            self._maybe_hang(job)
            for a in job.engine.finalize_detectors():
                self.stream.push(job.job_id, a, job.store.last_ts)
                job.count_anomaly()
            job.departed = True
        with self._fleet_det_lock:
            self._fleet_progress[job_id] = float("inf")
        self.resolve_fleet_ready()

    def finalize(self, job_id: Optional[str] = None) -> list[FleetAnomaly]:
        """``flush`` + end-of-stream detector finalize + drain: returns
        the merged remaining stream."""
        self.flush(job_id)
        targets = [self.job(job_id)] if job_id is not None else self.jobs
        for job in targets:
            with job.lock:
                for a in job.engine.finalize_detectors():
                    self.stream.push(job.job_id, a, job.store.last_ts)
                    job.count_anomaly()
        if job_id is None:
            self.resolve_fleet_all()
            with self._fleet_det_lock:
                for fd in self.fleet_detectors:
                    for jid, a in fd.finalize():
                        self.stream.push(jid, a, self.stream_last_ts(jid),
                                         origin="fleet")
        else:
            self.resolve_fleet_ready()
        return self.stream.drain()

    def stream_last_ts(self, job_id: str) -> float:
        with self._lock:
            j = self._jobs.get(job_id)
        return j.store.last_ts if j is not None else 0.0

    def close(self) -> list[FleetAnomaly]:
        """Stop every job's attached daemon (idempotent ``stop()``), then
        finalize the whole fleet."""
        for job in self.jobs:
            if job.daemon is not None:
                job.daemon.stop()
        return self.finalize()

    def telemetry_snapshot(self) -> dict:
        """One JSON-ready snapshot of the whole pipeline's self-telemetry:
        this multiplexer's registry (per-job late rows, watermark lag,
        pending depth, plus whatever replay published) merged with every
        attached daemon's registry, the latter re-tagged ``job=<id>`` so
        per-daemon series stay distinguishable.  Daemons sharing the mux
        registry (``DaemonConfig(telemetry=mux.telemetry)``) are already
        in and are not double-counted."""
        snap = self.telemetry.snapshot()
        for job in self.jobs:
            reg = getattr(job.daemon, "telemetry", None)
            if reg is not None and reg is not self.telemetry:
                snap = self.telemetry.merge_snapshot(
                    reg.snapshot(), into=snap,
                    extra_tags={"job": job.job_id})
        return snap

    def stats(self) -> dict[str, dict]:
        out = {}
        for j in self.jobs:
            with j.lock:
                out[j.job_id] = {
                    "events": j.store.events_total,
                    "ranks": j.store.num_ranks,
                    "steps_evaluated": len(j.evaluated),
                    "max_step_seen": j.store.max_step_seen,
                    "late_events": j.late_events,
                    "anomalies": j.anomaly_count,
                    "hang_reported": j.hang_reported,
                }
        return out
