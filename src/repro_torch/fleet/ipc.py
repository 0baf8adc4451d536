"""FCS-over-IPC process workers: the fleet engine past the GIL.

Thread-per-job replay (``FleetReplayer.replay_dir``) is byte-equivalent
to serial but GIL-bound — per-step diagnosis interleaves short Python
sections with numpy windows, so two worker threads on two cores buy
~1.08x, not 2x.  This module ships each job's whole pipeline — decode ->
step-aligned ingest -> ``evaluate_step_batch`` on a private
:class:`~repro_torch.core.engine.DiagnosticEngine` — into a worker *process*,
and moves data across the boundary in the cheapest shapes the codebase
already has:

  * **inputs**: replay workers read trace files straight from disk (no
    event rows cross at all); live-streaming callers ship
    :class:`~repro_torch.core.columnar.EventBatch` chunks as FCS-encoded
    segments (``repro_torch.store.encode_batch_bytes`` — the archival spill
    format, ~11.5 B/event at 256 ranks) instead of numpy pickles;
  * **outputs**: anomalies stream back incrementally on a BOUNDED
    result queue (backpressure: a slow parent stalls its workers, not
    the box's memory), ``"fleet"`` envelopes carry each job's keyed
    fleet-tier observations + frontier progress as they accrue
    (``FleetMultiplexer.record_fleet_observations``), and one terminal
    envelope per job ships the compact serialized end state — job-local
    ``ReplayStats``, any post-flush observations, the job's intern
    tables, a telemetry snapshot, and the store/engine summary the
    parent mirrors back onto its own ``FleetJob``.

The pool is RESIDENT: workers hold their open jobs' multiplexers between
tasks, so a long-lived service (``repro_torch.serve.FleetService``)
streams ``TASK_BATCHES`` frames at a job for hours and closes it
with ``TASK_CLOSE`` when it leaves the fleet. Each job is pinned to one
worker at first submission (per-worker task queues keep a job's tasks
in order); one-shot replay callers just ``submit`` everything and
``drain`` once — the shutdown sentinel closes whatever is still open.

Determinism contract: a worker owns a job exclusively and ships its
anomalies in push order; the parent re-pushes on ITS stream (per-job
order preserved; the stream's ``(ts, job_id, seq)`` drain sort already
makes cross-job interleave scheduling-independent), merges intern
tables and stats in sorted-path group order, and buffers the shipped
fleet observations — whose per-job cummax KEYS the worker computed over
the full stream — for the parent's frontier resolution
(``resolve_fleet_ready`` live, ``resolve_fleet_all`` at end of drain).
Diagnosis output is therefore byte-equivalent to serial by construction
— asserted end to end in ``benchmarks/fleet.py``, ``benchmarks/
live.py`` and ``tests/test_fleet.py``.

Worker entry points are top-level functions with picklable arguments,
so the pool works under both ``fork`` (Linux default) and ``spawn``.

The port's copy of the JAX package's ``fleet/ipc.py``: numpy only (no
torch), with the reference's names, thresholds and arithmetic.
"""
from __future__ import annotations

import multiprocessing as mp
import queue as _queue
import threading
import traceback
from typing import Callable, Optional

# task envelope: (kind, job_id, payload, engine_cfg, record_fleet)
#   ("replay", job_id, [paths], engine_cfg, record_fleet)
#   ("batches", job_id, [fcs_bytes], engine_cfg, record_fleet)
#   ("open", job_id, None, engine_cfg, record_fleet)   explicit join
#   ("close", job_id, None, None, None)                graceful leave
#   ("snapshot", job_id, None, None, None)   ship pending + full job state
#   ("restore", job_id, state, engine_cfg, record_fleet)  rebuild from it
#   None (shutdown sentinel: close every open job, then exit)
TASK_REPLAY = "replay"
TASK_BATCHES = "batches"
TASK_OPEN = "open"
TASK_CLOSE = "close"
TASK_SNAPSHOT = "snapshot"
TASK_RESTORE = "restore"

# result envelopes, on the owning worker's bounded queue:
#   ("anomalies", job_id, [(ts, Anomaly), ...])     incremental
#   ("fleet", job_id, [(key, step, anoms, ts)], progress)  incremental
#   ("snapshot", job_id, state_dict_or_None)        checkpoint answer
#   ("job", job_id, payload_dict)                   terminal, per job
#   ("error", job_id, traceback_str)
#   ("exit",)                                       worker is done
_EXIT = ("exit",)


class _WorkerJob:
    """One open job resident in a worker process: a private single-job
    multiplexer (its own engine + intern tables, so terminal payloads
    keep the exact per-job shape the parent merges deterministically),
    the replayer that drives it, and job-local stats."""

    __slots__ = ("mux", "rep", "stats", "record_fleet")

    def __init__(self, job_id: str, engine_cfg, record_fleet: bool,
                 init: dict):
        from repro_torch.fleet.multiplexer import FleetConfig, FleetMultiplexer
        from repro_torch.fleet.replay import FleetReplayer, ReplayStats
        self.mux = FleetMultiplexer(FleetConfig(**init["fleet"]),
                                    history=init["history"])
        self.mux.add_job(job_id, engine_cfg)
        # record the fleet-tier observation sequence for the parent
        # (which owns the actual cross-job detectors) — skipped when it
        # has none
        if record_fleet:
            self.mux.record_fleet_observations(True)
        self.rep = FleetReplayer(self.mux, job_workers=1, **init["replay"])
        self.stats = ReplayStats(worker_kind="process")
        self.record_fleet = record_fleet


def _ship(result_q, job_id: str, wj: _WorkerJob) -> None:
    """Flush a job's pending outputs to the parent: anomalies in push
    order, then (in record mode) the keyed fleet observations gathered
    since the last ship plus the job's frontier progress — even with no
    new observations, progress is what lets the parent's frontier
    advance past this job's healthy stretches."""
    pend = wj.mux.stream.drain_raw()
    if pend:
        result_q.put(("anomalies", job_id,
                      [(fa.ts, fa.anomaly) for fa in pend]))
    obs = wj.mux.drain_fleet_observations().get(job_id, []) \
        if wj.record_fleet else []
    # shipped even with nothing to say: the envelope count is the
    # parent's per-job acknowledgement (queue-depth gauges), and the
    # progress float is what advances the parent's fleet frontier
    result_q.put(("fleet", job_id, obs, wj.mux.fleet_progress(job_id)))


def _close_job(result_q, job_id: str, wj: _WorkerJob) -> None:
    """Flush + terminal envelope: the job's end state crosses once, in
    the compact summary shape ``FleetMultiplexer.restore_job_state``
    mirrors back."""
    wj.mux.flush(job_id)
    _ship(result_q, job_id, wj)
    obs = wj.mux.drain_fleet_observations().get(job_id, []) \
        if wj.record_fleet else []
    job = wj.mux.job(job_id)
    result_q.put(("job", job_id, {
        "stats": wj.stats,
        "obs": obs,
        "state": {
            "store": job.store.summary(),
            "last_closed": job.last_closed,
            "hang_reported": job.hang_reported,
            "evaluated_steps": sorted(job.engine.evaluated_steps),
        },
        "names": list(wj.mux.interner.names),
        "groups": list(wj.mux.interner.groups),
        "telemetry": wj.mux.telemetry.snapshot(),
    }))


def _snapshot_job(result_q, job_id: str, wj: Optional[_WorkerJob]) -> None:
    """Checkpoint answer for one resident job: flush pending outputs
    first (``_ship`` — so the parent buffers every observation BEFORE
    the snapshot envelope lands; the result queue is FIFO), then ship
    the job's complete pipeline state.  The worker's intern tables ride
    along — restored slices reference them, and pickling state + tables
    as one envelope keeps that identity across the IPC boundary."""
    if wj is None:
        result_q.put(("snapshot", job_id, None))
        return
    _ship(result_q, job_id, wj)
    result_q.put(("snapshot", job_id, {
        "pipeline": wj.mux.snapshot_job_state(job_id),
        "names": wj.mux.interner.names,
        "groups": wj.mux.interner.groups,
        "stats": wj.stats,
        "telemetry": wj.mux.telemetry.snapshot(),
    }))


def _restore_job(job_id: str, state: dict, engine_cfg, record_fleet: bool,
                 init: dict) -> _WorkerJob:
    """Rebuild a resident job from its :func:`_snapshot_job` state: a
    fresh pipeline, then tables + full pipeline state + job-local stats
    + telemetry loaded back in."""
    wj = _WorkerJob(job_id, engine_cfg, bool(record_fleet), init)
    wj.mux.interner.restore_tables(state["names"], state["groups"])
    wj.mux.restore_job_pipeline(job_id, state["pipeline"])
    wj.stats = state["stats"]
    wj.mux.telemetry.absorb(state["telemetry"])
    return wj


def _worker_main(task_q, result_q, init: dict) -> None:
    """Resident worker loop: pull tasks until the shutdown sentinel,
    holding every open job's pipeline between tasks.  An exception in
    one task is shipped as an ``error`` envelope and the worker moves
    on — partial fleet progress is never thrown away by one bad job.
    The sentinel closes still-open jobs in sorted order (deterministic
    terminal-envelope order for one-shot replay callers)."""
    from repro_torch.store import decode_batch_bytes

    jobs: dict[str, _WorkerJob] = {}
    while True:
        task = task_q.get()
        if task is None:
            break
        kind, job_id, payload, engine_cfg, record_fleet = task
        try:
            if kind == TASK_CLOSE:
                wj = jobs.pop(job_id, None)
                if wj is None:
                    wj = _WorkerJob(job_id, engine_cfg, False, init)
                _close_job(result_q, job_id, wj)
                continue
            if kind == TASK_SNAPSHOT:
                _snapshot_job(result_q, job_id, jobs.get(job_id))
                continue
            if kind == TASK_RESTORE:
                jobs[job_id] = _restore_job(job_id, payload, engine_cfg,
                                            bool(record_fleet), init)
                continue
            if kind not in (TASK_OPEN, TASK_REPLAY, TASK_BATCHES):
                raise ValueError(f"unknown worker task kind {kind!r}")
            wj = jobs.get(job_id)
            if wj is None:
                wj = jobs[job_id] = _WorkerJob(job_id, engine_cfg,
                                               bool(record_fleet), init)
            if kind == TASK_REPLAY:
                wj.rep._replay_job(
                    job_id, payload, wj.stats,
                    on_file=lambda: _ship(result_q, job_id, wj))
            elif kind == TASK_BATCHES:
                for blob in payload:
                    batch = decode_batch_bytes(blob)
                    wj.stats.events += len(batch)
                    wj.stats.per_job[job_id] = \
                        wj.stats.per_job.get(job_id, 0) + len(batch)
                    wj.mux.ingest_step_aligned(job_id, batch)
                    _ship(result_q, job_id, wj)
        except BaseException:
            try:
                result_q.put(("error", job_id, traceback.format_exc()))
            except Exception:
                break
    for job_id in sorted(jobs):
        try:
            _close_job(result_q, job_id, jobs[job_id])
        except BaseException:
            try:
                result_q.put(("error", job_id, traceback.format_exc()))
            except Exception:
                break
    result_q.put(_EXIT)


class ProcessWorkerPool:
    """Fixed pool of resident job-pipeline worker processes.

    Each worker has its OWN task queue; a job is pinned to one worker at
    first submission (round-robin over workers), so a job's tasks always
    execute in order on the engine that holds its state.  One BOUNDED
    result queue per worker gives backpressure: a parent that falls
    behind consuming anomalies stalls the producing worker instead of
    buffering unboundedly.

    Two driving styles:

    * **one-shot** (``FleetReplayer._replay_dir_process``): ``submit``
      every task, then ``drain`` exactly once — it starts the drainer
      threads, enqueues one shutdown sentinel per worker (closing every
      still-open job), consumes every result, joins, and raises if any
      worker errored or died.
    * **resident** (``repro_torch.serve.FleetService``): ``start`` the
      drainer threads up front with callbacks,
      ``submit`` tasks for as long as the service lives (``TASK_CLOSE``
      retires one job), and finally ``shutdown`` + ``join``.

    ``close`` is the unconditional cleanup (safe after a drain/join;
    terminates stragglers otherwise)."""

    def __init__(self, workers: int, init: dict, *, result_depth: int = 8,
                 mp_context=None):
        ctx = mp_context or mp.get_context()
        self._task_qs = []
        self._procs = []
        self._result_qs = []
        self._results: dict[str, dict] = {}
        self._errors: list[tuple[str, str]] = []
        self._route: dict[str, int] = {}
        self._next_worker = 0
        self._drainers: list[threading.Thread] = []
        self._shutdown_sent = False
        self._closing = False        # intentional teardown: deaths expected
        self._obs_lock = threading.Lock()
        # job -> [(key, step, anoms, ts)] in ship order, accumulated by
        # the drainers when no on_fleet callback consumes them instead
        self.fleet_observations: dict[str, list] = {}
        self.fleet_progress: dict[str, float] = {}
        self._on_anomalies: Optional[Callable] = None
        self._on_fleet: Optional[Callable] = None
        self._on_job: Optional[Callable] = None
        self._on_error: Optional[Callable] = None
        self._on_snapshot: Optional[Callable] = None
        self._on_death: Optional[Callable] = None
        for i in range(workers):
            tq = ctx.Queue()
            rq = ctx.Queue(maxsize=max(result_depth, 2))
            p = ctx.Process(target=_worker_main, args=(tq, rq, init),
                            daemon=True, name=f"flare-fleet-worker-{i}")
            p.start()
            self._task_qs.append(tq)
            self._procs.append(p)
            self._result_qs.append(rq)

    # ------------------------------------------------------------------ #
    # submission / routing
    # ------------------------------------------------------------------ #
    def worker_for(self, job_id: str) -> int:
        """The worker index a job is (or will be) pinned to."""
        w = self._route.get(job_id)
        if w is None:
            w = self._route[job_id] = self._next_worker
            self._next_worker = (self._next_worker + 1) % len(self._procs)
        return w

    def submit(self, task) -> None:
        """Enqueue one task on its job's pinned worker (pinning the job
        round-robin on first sight)."""
        self._task_qs[self.worker_for(task[1])].put(task)

    def close_job(self, job_id: str) -> None:
        """Graceful per-job leave: the worker flushes the job and ships
        its terminal envelope (surfaced via ``on_job`` / ``results``)."""
        self.submit((TASK_CLOSE, job_id, None, None, None))

    def task_depths(self) -> list[int]:
        """Approximate per-worker task-queue depths (-1 where the
        platform can't say)."""
        out = []
        for q in self._task_qs:
            try:
                out.append(q.qsize())
            except (NotImplementedError, OSError):
                out.append(-1)
        return out

    @property
    def results(self) -> dict[str, dict]:
        """Terminal payloads received so far (job_id -> payload)."""
        return self._results

    # ------------------------------------------------------------------ #
    # draining
    # ------------------------------------------------------------------ #
    def start(self, *, on_anomalies: Optional[Callable] = None,
              on_fleet: Optional[Callable] = None,
              on_job: Optional[Callable] = None,
              on_error: Optional[Callable] = None,
              on_snapshot: Optional[Callable] = None,
              on_death: Optional[Callable] = None) -> None:
        """Start one drainer thread per worker (idempotent).  Callbacks
        may fire from several drainer threads at once — one per worker —
        so they must only touch internally-locked state:

        * ``on_anomalies(job_id, [(ts, Anomaly), ...])`` — incremental,
          in the worker's push order;
        * ``on_fleet(job_id, obs, progress)`` — keyed fleet observations
          plus frontier progress (when absent, both accumulate on
          ``fleet_observations`` / ``fleet_progress`` instead);
        * ``on_snapshot(job_id, state_or_None)`` — ``TASK_SNAPSHOT``
          answer (the job's full pipeline state for a checkpoint);
        * ``on_job(job_id, payload)`` — terminal envelope (always also
          recorded in ``results``);
        * ``on_error(job_id, tb)`` — when absent, errors collect and
          ``join`` raises;
        * ``on_death(worker_index)`` — a worker died WITHOUT its exit
          envelope and the pool is not closing: the recovery hook (when
          absent, an error records instead).  Fires from that worker's
          drainer thread, which returns right after — recovery must run
          elsewhere (never join drainers from it)."""
        if self._drainers:
            return
        self._on_anomalies = on_anomalies
        self._on_fleet = on_fleet
        self._on_job = on_job
        self._on_error = on_error
        self._on_snapshot = on_snapshot
        self._on_death = on_death
        self._drainers = [threading.Thread(
            target=self._drain_one, args=(i, p, rq),
            daemon=True, name=f"flare-fleet-drain-{i}")
            for i, (p, rq) in enumerate(zip(self._procs, self._result_qs))]
        for t in self._drainers:
            t.start()

    def shutdown(self) -> None:
        """Send every worker its shutdown sentinel (idempotent): each
        closes its still-open jobs (terminal envelopes flow to the
        drainers) and exits."""
        if not self._shutdown_sent:
            self._shutdown_sent = True
            self._closing = True
            for q in self._task_qs:
                q.put(None)

    def join(self, *, raise_errors: bool = True) -> dict[str, dict]:
        """Wait for the drainers and workers after ``shutdown``; raises
        the first collected worker error (unless routed to ``on_error``
        or ``raise_errors=False``); returns the terminal payloads."""
        for t in self._drainers:
            t.join()
        for p in self._procs:
            p.join(timeout=10.0)
        if raise_errors and self._errors:
            job_id, tb = self._errors[0]
            more = f" (+{len(self._errors) - 1} more)" \
                if len(self._errors) > 1 else ""
            raise RuntimeError(
                f"fleet replay worker failed on job {job_id!r}{more}:\n{tb}")
        return self._results

    def drain(self, on_anomalies: Optional[Callable] = None
              ) -> dict[str, dict]:
        """One-shot drive: shutdown + consume everything + join; returns
        ``job_id -> terminal payload``.  Shipped fleet observations and
        progress accumulate on ``fleet_observations``/``fleet_progress``
        for the caller to buffer afterwards."""
        self.start(on_anomalies=on_anomalies)
        self.shutdown()
        return self.join()

    def _drain_one(self, index: int, proc, rq) -> None:
        dead_polls = 0
        while True:
            try:
                env = rq.get(timeout=0.2)
            except _queue.Empty:
                if not proc.is_alive():
                    # grace polls: the feeder pipe may still hold data
                    # written just before an abnormal death
                    dead_polls += 1
                    if dead_polls >= 3:
                        if self._closing:
                            return     # intentional teardown, not a death
                        if self._on_death is not None:
                            self._on_death(index)
                            return
                        self._record_error(
                            "<unknown>",
                            f"worker {proc.name} died without an exit "
                            f"envelope (exitcode {proc.exitcode})")
                        return
                continue
            dead_polls = 0
            kind = env[0]
            if kind == "exit":
                return
            if kind == "anomalies":
                if self._on_anomalies is not None:
                    self._on_anomalies(env[1], env[2])
            elif kind == "snapshot":
                if self._on_snapshot is not None:
                    self._on_snapshot(env[1], env[2])
            elif kind == "fleet":
                if self._on_fleet is not None:
                    self._on_fleet(env[1], env[2], env[3])
                else:
                    with self._obs_lock:
                        if env[2]:
                            self.fleet_observations.setdefault(
                                env[1], []).extend(env[2])
                        self.fleet_progress[env[1]] = env[3]
            elif kind == "job":
                self._results[env[1]] = env[2]
                if self._on_job is not None:
                    self._on_job(env[1], env[2])
            elif kind == "error":
                self._record_error(env[1], env[2])

    def _record_error(self, job_id: str, tb: str) -> None:
        if self._on_error is not None:
            self._on_error(job_id, tb)
        else:
            self._errors.append((job_id, tb))

    def kill_worker(self, index: int) -> None:
        """Chaos hook: SIGKILL one worker process mid-flight (its open
        jobs' in-memory state is lost — exactly the failure the service's
        checkpoint recovery exists for)."""
        self._procs[index].kill()

    def stop(self, *, drainer_timeout: float = 10.0) -> None:
        """Abrupt teardown for recovery paths: mark the pool closing
        (so the terminations below don't read as worker deaths), kill
        the processes, and JOIN the drainer threads — after this no
        callback fires again, so the caller can safely rebuild shared
        state the callbacks touch.  Must not be called from a drainer
        thread (a drainer cannot join itself)."""
        self._closing = True
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=5.0)
        # drainers exit via their dead-process grace polls (suppressed
        # by _closing); only then is it safe to close the queues under
        # them
        for t in self._drainers:
            t.join(timeout=drainer_timeout)
        for q in (*self._result_qs, *self._task_qs):
            q.close()
            q.cancel_join_thread()

    def close(self) -> None:
        self._closing = True
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=5.0)
        for q in (*self._result_qs, *self._task_qs):
            q.close()
            q.cancel_join_thread()
