"""FleetService — the always-on diagnosis daemon over the fleet engine.

``FleetReplayer.replay_dir`` is a one-shot drain over a finished
directory; this module keeps the same engine RESIDENT.  One service
instance owns a :class:`~repro_torch.fleet.multiplexer.FleetMultiplexer` and
feeds it from two ingestion planes for as long as it lives:

  * **socket** — an FLW listener (``repro_torch.serve.protocol``): training
    hosts ``HELLO`` a job (with topology for the fleet tier), stream
    ``BATCH`` frames (FCS-encoded ``EventBatch`` segments — the exact
    bytes the spill path writes), and ``BYE`` to leave gracefully;
  * **file tail** — a :class:`~repro_torch.serve.tail.FileTailer` following
    the directory daemons spill into, feeding newly completed segments.

Both planes route into step-aligned ingest
(``FleetMultiplexer.ingest_step_aligned``) on one of two engines:

  * ``worker_kind="inline"`` — decode + diagnose on the service's own
    multiplexer (per-job locks already parallelize connection threads);
  * ``worker_kind="process"`` — frames cross *undecoded* into a
    resident :class:`~repro_torch.fleet.ipc.ProcessWorkerPool` (each job
    pinned to a worker process holding its private engine), anomalies
    and keyed fleet-tier observations streaming back over bounded
    queues.  The parent buffers the observations and resolves its
    cross-job frontier incrementally (``resolve_fleet_ready``), so
    ``cross_job_failslow`` reclassifies LIVE in either mode.

The service is CRASH-SAFE when given ``ServiceConfig.checkpoint_dir``:
:meth:`checkpoint` quiesces ingestion behind a readers-writer gate,
gathers every resident pipeline's full state (workers answer
``TASK_SNAPSHOT`` over the IPC envelope machinery), and writes one
atomic, CRC-protected, generation-numbered snapshot
(``repro_torch.serve.checkpoint``) — periodically, at graceful shutdown, and
on demand.  :meth:`restore` (before :meth:`start`) loads the newest
VALID generation, rebuilds every pipeline, and resumes tailing at the
recorded byte offsets, so only the spill suffix past the checkpointed
frontier is ever replayed and the post-restart anomaly stream is
byte-equivalent to an uninterrupted run (hard-gated in
``benchmarks/live.py --chaos-quick``).  A worker process dying
mid-flight triggers the same restore in-process (pool rebuilt, already
delivered post-checkpoint anomalies suppressed by replay-order dedup).

Determinism contract (asserted in ``benchmarks/live.py`` and
``tests/test_serve.py``): streaming a recorded directory through either
plane, in either mode, then :meth:`finalize`, yields an anomaly
sequence byte-equivalent (after the stream's own ``(ts, job_id, seq)``
merge sort) to ``replay_dir`` + ``finalize`` on the same files — with
the documented caveats that the fleet frontier assumes the job set is
hello'd before its watermarks pass, and hang diagnosis (which fires on
flush granularity) needs hang-free scenarios for bit-exact gates.

A minimal HTTP query plane (``repro_torch.serve.query``) serves
``/anomalies``, ``/weather``, ``/telemetry``, ``/jobs`` and byte-
budgeted archive queries over the same state.

The port's copy of the JAX package's ``serve/service.py``:
stdlib and numpy only (no torch), with the reference's names, formats
and semantics.
"""
from __future__ import annotations

import contextlib
import dataclasses
import socket
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.core.engine import EngineConfig
from repro_torch.fleet.multiplexer import FleetMultiplexer
from repro_torch.fleet.replay import ReplayStats
from repro_torch.fleet.stream import FleetAnomaly
from repro_torch.serve.checkpoint import CheckpointError, CheckpointStore
from repro_torch.serve.protocol import (FRAME_BATCH, FRAME_HELLO,
                                        ProtocolError, parse_hello,
                                        read_frame)
from repro_torch.serve.tail import FileTailer
from repro_torch.store import (CodecError, decode_batch_bytes,
                               encode_batch_bytes)


@dataclass
class ServiceConfig:
    host: str = "127.0.0.1"
    # FLW ingest port: 0 = ephemeral (read it back from ``.port``),
    # None = no socket plane (tail-only service)
    port: Optional[int] = 0
    # HTTP query port: 0 = ephemeral, None = no query plane
    query_port: Optional[int] = None
    worker_kind: str = "inline"        # "inline" | "process"
    workers: Optional[int] = None      # process mode: None = cpu count
    tail_dir: Optional[str] = None     # follow this spill directory
    tail_poll_s: float = 0.05
    # socket recv timeout at frame boundaries — how often an idle
    # connection polls for service shutdown
    idle_poll_s: float = 0.2
    drain_interval_s: float = 0.05     # anomaly collector period
    max_recent_anomalies: int = 4096   # /anomalies ring size
    archive_dir: Optional[str] = None  # /archive/* query root
    archive_max_bytes: Optional[int] = 64 << 20   # per-query byte budget
    # engine template for jobs that HELLO without overrides
    default_engine: Optional[EngineConfig] = None
    # socket plane: concurrent-connection cap (None = unbounded).  Over
    # the cap, new connections get a clean immediate close and a
    # ``serve.rejected_connections`` count — never a hang, never an
    # unbounded thread pile-up.
    max_connections: Optional[int] = None
    # overload shedding (process mode, SOCKET plane only): per-job cap
    # on frames submitted but not yet acknowledged by the worker.  Over
    # the cap the newest frame for that job is dropped and counted
    # (``serve.shed_frames{job=}``) — per-job budgets keep one
    # backlogged job from starving the rest, drop-newest keeps the
    # consumed prefix contiguous, and the spill/tail plane remains the
    # lossless source of truth for whatever was shed.
    max_inflight_frames: Optional[int] = None
    # crash safety: generation-numbered checkpoint directory (None =
    # checkpoints off), optional periodic cadence, generations to keep,
    # and whether graceful finalize() snapshots first.
    checkpoint_dir: Optional[str] = None
    checkpoint_interval_s: Optional[float] = None
    checkpoint_keep: int = 3
    checkpoint_on_finalize: bool = True
    # how long checkpoint() waits for workers to drain + answer
    quiesce_timeout_s: float = 30.0


class _IngestGate:
    """Readers-writer gate around ingestion: frame handlers and the
    tail pump enter as READERS (concurrent, uncontended in steady
    state); :meth:`pause` is the WRITER — it blocks new ingestion and
    waits out in-flight handlers, giving checkpoint/recovery a
    consistent cut without stopping collector or query threads."""

    def __init__(self):
        self._cond = threading.Condition()
        self._active = 0
        self._paused = False

    @contextlib.contextmanager
    def ingest(self):
        with self._cond:
            while self._paused:
                self._cond.wait()
            self._active += 1
        try:
            yield
        finally:
            with self._cond:
                self._active -= 1
                if self._active == 0:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def pause(self):
        with self._cond:
            while self._paused:
                self._cond.wait()
            self._paused = True
            while self._active:
                self._cond.wait()
        try:
            yield
        finally:
            with self._cond:
                self._paused = False
                self._cond.notify_all()


class FleetService:
    """Long-lived ingest + query service over one fleet multiplexer.

    ``on_anomaly(fa, arrival_monotonic)`` (optional) fires for every
    collected anomaly with its collection time — the hook the latency
    benchmark hangs off; the service itself keeps only a bounded ring
    (``recent_anomalies``), so memory stays flat over months."""

    def __init__(self, mux: Optional[FleetMultiplexer] = None,
                 config: Optional[ServiceConfig] = None,
                 *, on_anomaly: Optional[Callable] = None):
        self.cfg = config or ServiceConfig()
        if self.cfg.worker_kind not in ("inline", "process"):
            raise ValueError(f"worker_kind must be 'inline' or 'process', "
                             f"got {self.cfg.worker_kind!r}")
        self.mux = mux or FleetMultiplexer()
        self.telemetry = self.mux.telemetry
        self.on_anomaly = on_anomaly
        self.stats = ReplayStats(worker_kind=f"live-{self.cfg.worker_kind}")
        self.tailer: Optional[FileTailer] = None
        self._pool = None
        self._record_fleet = bool(self.mux.fleet_detectors)
        self._stop = threading.Event()
        self._started = False
        self._finalized = False
        self._abandoned = False               # kill(): skip drain/flush
        self._reg_lock = threading.Lock()     # open-jobs registry
        self._merge_lock = threading.Lock()   # terminal-payload merges
        self._open: set[str] = set()
        self._departed: set[str] = set()
        self._job_cfg: dict[str, Optional[EngineConfig]] = {}
        self._errors: list[tuple[str, str]] = []
        self._rec_lock = threading.Lock()
        self.recent_anomalies: deque[FleetAnomaly] = deque(
            maxlen=self.cfg.max_recent_anomalies)
        self._inflight: dict[str, int] = {}   # process mode: frames queued
        self._lsock: Optional[socket.socket] = None
        self._threads: list[threading.Thread] = []
        self._conn_threads: list[threading.Thread] = []
        self._active_conns = 0
        self._query = None
        self.port: Optional[int] = None
        self.query_port: Optional[int] = None
        # checkpoint/restore plumbing
        self._gate = _IngestGate()
        self._ckpt: Optional[CheckpointStore] = None
        if self.cfg.checkpoint_dir is not None:
            self._ckpt = CheckpointStore(self.cfg.checkpoint_dir,
                                         keep=self.cfg.checkpoint_keep)
        self._restore_worker_states: dict[str, dict] = {}
        self._tail_restore: Optional[dict] = None
        self._recover_lock = threading.Lock()
        self._snap_cond = threading.Condition()
        self._snap_pending: set[str] = set()
        self._snap_states: dict[str, Optional[dict]] = {}
        # worker-death dedup: anomalies delivered since the last
        # checkpoint (guarded by _rec_lock).  Only tracked when a warm
        # recovery could actually replay them.  ``_dup`` is a multiset
        # of delivery keys, not an ordered queue: re-derivation is
        # deterministic per (job, origin) stream, but the INTERLEAVE of
        # job-origin and fleet-origin anomalies across drain boundaries
        # is not, so suppression must not depend on delivery order.
        self._track_dups = (self.cfg.worker_kind == "process"
                            and self._ckpt is not None)
        self._dup_log: list = []
        self._dup: dict[tuple, int] = {}
        t = self.telemetry
        self._c_conns = t.counter("serve.connections")
        self._c_frames = t.counter("serve.frames")
        self._c_bytes = t.counter("serve.bytes_in")
        self._c_dropped = t.counter("serve.dropped_frames")
        self._c_rejected = t.counter("serve.rejected_connections")
        self._c_ckpts = t.counter("serve.checkpoints")
        self._c_respawns = t.counter("serve.worker_respawns")
        self._c_deduped = t.counter("serve.deduped_anomalies")
        self._g_active = t.gauge("serve.active_connections")
        self._g_jobs = t.gauge("serve.jobs")

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def start(self) -> "FleetService":
        if self._started:
            return self
        self._started = True
        if self.cfg.worker_kind == "process":
            self._start_pool()
            if self._restore_worker_states:
                from repro_torch.fleet.ipc import TASK_RESTORE
                for job_id in sorted(self._restore_worker_states):
                    self._pool.submit((
                        TASK_RESTORE, job_id,
                        self._restore_worker_states[job_id],
                        self._job_cfg.get(job_id), self._record_fleet))
                self._restore_worker_states = {}
        if self.cfg.port is not None:
            self._lsock = socket.create_server(
                (self.cfg.host, self.cfg.port))
            self._lsock.settimeout(self.cfg.idle_poll_s)
            self.port = self._lsock.getsockname()[1]
            self._spawn(self._accept_loop, "flare-serve-accept")
        if self.cfg.tail_dir is not None:
            self.tailer = FileTailer(
                self.cfg.tail_dir, self._tail_sink,
                on_join=self.join_job, telemetry=self.telemetry)
            if self._tail_restore is not None:
                self.tailer.load_state(self._tail_restore)
                self._tail_restore = None
            self._spawn(self._tail_loop, "flare-serve-tail")
        self._spawn(self._collect_loop, "flare-serve-collect")
        if self._ckpt is not None and self.cfg.checkpoint_interval_s:
            self._spawn(self._checkpoint_loop, "flare-serve-ckpt")
        if self.cfg.query_port is not None:
            from repro_torch.serve.query import QueryServer
            self._query = QueryServer(self, self.cfg.host,
                                      self.cfg.query_port)
            self.query_port = self._query.port
        return self

    def _spawn(self, target, name: str) -> None:
        t = threading.Thread(target=target, daemon=True, name=name)
        t.start()
        self._threads.append(t)

    def _start_pool(self) -> None:
        import os

        from repro_torch.fleet.ipc import ProcessWorkerPool
        mux = self.mux
        init = {
            "history": mux.history,
            "fleet": {"watermark_delay": mux.cfg.watermark_delay,
                      "backend": mux.cfg.backend,
                      "max_pending_rows": mux.cfg.max_pending_rows},
            "replay": {"chunk_bytes": 8 << 20, "max_workers": None,
                       "executor": "thread", "serial_below": None,
                       "prefetch": 2, "predicate": None},
        }
        workers = self.cfg.workers or os.cpu_count() or 1
        self._pool = ProcessWorkerPool(workers, init)
        self._pool.start(on_anomalies=self._on_worker_anomalies,
                         on_fleet=self._on_worker_fleet,
                         on_job=self._on_worker_job,
                         on_error=self._on_worker_error,
                         on_snapshot=self._on_worker_snapshot,
                         on_death=self._on_worker_death)

    def finalize(self, *, raise_errors: bool = True) -> list[FleetAnomaly]:
        """Graceful shutdown: checkpoint the resident state (when
        configured), stop accepting, drain the tail directory to its end
        (leftover partial tails become corruption counts), close every
        worker job, finalize the multiplexer.  Returns the final drain
        (everything not yet collected); the full stream was delivered
        incrementally via ``on_anomaly``/``recent_anomalies``.
        Idempotent."""
        if self._finalized:
            return []
        if (self._ckpt is not None and self.cfg.checkpoint_on_finalize
                and self._started):
            try:
                self.checkpoint()
            except Exception:
                self.telemetry.counter("serve.checkpoint_errors").inc()
        self._finalized = True
        self._stop.set()
        if self._lsock is not None:
            try:
                self._lsock.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=30.0)
        for t in self._conn_threads:
            t.join(timeout=30.0)
        if self._pool is not None:
            # sentinel closes still-open jobs; terminal envelopes merge
            # through _on_worker_job before join returns
            self._pool.shutdown()
            self._pool.join(raise_errors=False)
            self._pool.close()
        if self.tailer is not None:
            self.tailer.finish()           # no-op if the run thread did
            with self._merge_lock:
                self.stats.merge(self.tailer.stats)
        final = self.mux.finalize()
        self._deliver(final)
        with self._rec_lock:
            leftover = sum(self._dup.values())
            self._dup = {}
        if leftover:
            # pre-death deliveries that never re-derived: the stitched
            # stream is missing them — make that loss visible
            self.telemetry.counter(
                "serve.recovery_dedup_mismatch").inc(leftover)
        if self._query is not None:
            self._query.close()
        if raise_errors and self._errors:
            job_id, tb = self._errors[0]
            more = f" (+{len(self._errors) - 1} more)" \
                if len(self._errors) > 1 else ""
            raise RuntimeError(
                f"fleet service worker failed on job {job_id!r}{more}:\n{tb}")
        return final

    def kill(self) -> None:
        """Abrupt crash-simulating stop (the chaos harness's SIGKILL):
        threads stopped, sockets closed, worker processes terminated —
        NO flush, NO finalize, NO farewell checkpoint.  Whatever state
        was not yet checkpointed is lost, exactly as in a real crash;
        :meth:`restore` on a fresh service is the other half."""
        if self._finalized:
            return
        self._finalized = True
        self._abandoned = True
        self._stop.set()
        if self._lsock is not None:
            try:
                self._lsock.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=10.0)
        for t in self._conn_threads:
            t.join(timeout=10.0)
        if self._pool is not None:
            self._pool.stop()
        if self._query is not None:
            self._query.close()

    @property
    def errors(self) -> list[tuple[str, str]]:
        return list(self._errors)

    # ------------------------------------------------------------------ #
    # job lifecycle + ingest (both planes land here)
    # ------------------------------------------------------------------ #
    def _engine_cfg(self, overrides: Optional[dict]) -> Optional[EngineConfig]:
        if overrides:
            base = self.cfg.default_engine
            if base is not None:
                return dataclasses.replace(base, **overrides)
            return EngineConfig(**overrides)
        return self.cfg.default_engine

    def join_job(self, job_id: str, topology: Optional[dict] = None,
                 engine: Optional[dict] = None) -> None:
        """Register a job (idempotent; re-HELLO just merges topology).
        In process mode the job's resident pipeline opens eagerly, so
        its first frame pays no engine construction."""
        with self._reg_lock:
            if job_id in self._departed:
                return                 # departed jobs are never revived
            known = job_id in self._open
            if not known:
                self._open.add(job_id)
                self._job_cfg[job_id] = self._engine_cfg(engine)
            self._g_jobs.set(len(self._open))
        if topology:
            self.mux.set_topology(job_id, **topology)
        if known:
            return
        self.mux.add_job(job_id, self._job_cfg[job_id])
        if self._pool is not None:
            from repro_torch.fleet.ipc import TASK_OPEN
            self._pool.submit((TASK_OPEN, job_id, None,
                               self._job_cfg[job_id], self._record_fleet))

    def leave_job(self, job_id: str) -> None:
        """Graceful leave (``BYE``): the job's pending steps close, its
        hang analysis and detector finalize run, its fleet-frontier
        contribution releases — other jobs' diagnosis is untouched."""
        with self._reg_lock:
            if job_id not in self._open:
                return
            self._open.discard(job_id)
            self._departed.add(job_id)
            self._g_jobs.set(len(self._open))
        if self._pool is not None:
            # the worker flushes + ships the terminal envelope; the
            # parent-side retire happens in _on_worker_job when it lands
            self._pool.close_job(job_id)
        else:
            self.mux.retire_job(job_id)

    def ingest_frame(self, job_id: str, payload: bytes) -> None:
        """One BATCH frame: an FCS-encoded ``EventBatch`` segment.
        Inline mode decodes here (a ``CodecError`` propagates — the
        connection handler counts it as a dropped frame); process mode
        forwards the bytes undecoded to the job's pinned worker."""
        with self._reg_lock:
            known = job_id in self._open
            departed = job_id in self._departed
        self._c_frames.inc()
        self._c_bytes.inc(len(payload))
        if departed:
            # graceful-leave contract: post-BYE stragglers are dropped
            # and counted, never revived — and never forwarded to a
            # worker, whose closed pipeline they would silently reopen
            # (in process mode the parent mux only marks the job
            # departed once the terminal envelope lands, so the mux
            # guard alone is racy; the service set is authoritative)
            n = len(decode_batch_bytes(bytes(payload)))
            self.telemetry.counter("fleet.departed_rows",
                                   job=job_id).inc(n)
            return
        if not known:
            self.join_job(job_id)
        if self._pool is not None:
            cap = self.cfg.max_inflight_frames
            if cap is not None:
                with self._reg_lock:
                    depth = self._inflight.get(job_id, 0)
                if depth >= cap:
                    # shed without decoding: the sender's spill is the
                    # lossless copy, the tail plane replays it later
                    self.telemetry.counter("serve.shed_frames",
                                           job=job_id).inc()
                    return
            self._note_inflight(job_id, +1)
            self._pool.submit(("batches", job_id, [bytes(payload)],
                               self._job_cfg.get(job_id),
                               self._record_fleet))
            return
        batch = decode_batch_bytes(bytes(payload))
        self._count_events(job_id, len(batch))
        self.mux.ingest_step_aligned(job_id, batch)

    def _tail_sink(self, job_id: str, batch) -> None:
        """Tail plane: newly completed segments (already decoded for the
        boundary check) — process mode re-frames them as FCS bytes so
        the worker boundary stays zero-pickle.  Never shed: the tail IS
        the recovery path, dropping here would lose data for good."""
        with self._reg_lock:
            departed = job_id in self._departed
        if departed:
            self.telemetry.counter("fleet.departed_rows",
                                   job=job_id).inc(len(batch))
            return
        if self._pool is not None:
            self._note_inflight(job_id, +1)
            self._pool.submit(("batches", job_id,
                               [encode_batch_bytes(batch)],
                               self._job_cfg.get(job_id),
                               self._record_fleet))
            return
        self.mux.ingest_step_aligned(job_id, batch)

    def _tail_loop(self) -> None:
        """Service-owned tail pump: each poll runs under the ingest
        gate, so a checkpoint's pause sees segment-aligned tail offsets
        — the consistency cut the checkpointed byte offsets rely on."""
        while not self._stop.is_set():
            with self._gate.ingest():
                self.tailer.poll_once()
            self._stop.wait(self.cfg.tail_poll_s)
        if not self._abandoned:
            with self._gate.ingest():
                self.tailer.finish()

    def _count_events(self, job_id: str, n: int) -> None:
        with self._merge_lock:
            self.stats.events += n
            self.stats.per_job[job_id] = \
                self.stats.per_job.get(job_id, 0) + n

    def _note_inflight(self, job_id: str, d: int) -> None:
        with self._reg_lock:
            n = max(self._inflight.get(job_id, 0) + d, 0)
            self._inflight[job_id] = n
        self.telemetry.gauge("serve.inflight", job=job_id).set(n)

    def queue_depths(self) -> dict:
        """Per-job frames submitted but not yet acknowledged by their
        worker (process mode; empty inline) plus per-worker task-queue
        depths — the ``/telemetry`` queue view."""
        with self._reg_lock:
            per_job = dict(sorted(self._inflight.items()))
        workers = self._pool.task_depths() if self._pool is not None else []
        return {"per_job": per_job, "workers": workers}

    # ------------------------------------------------------------------ #
    # checkpoint / restore
    # ------------------------------------------------------------------ #
    def checkpoint(self) -> dict:
        """Write one consistent snapshot of the full resident state and
        return its metadata (path, generation, anomalies emitted so far,
        tail progress).  The cut: ingestion pauses (readers drain),
        process workers finish their queued frames and answer
        ``TASK_SNAPSHOT`` (their pending anomalies/observations ship
        FIRST on the same FIFO queue), the stream drains through one
        final :meth:`collect` — then everything pickles as ONE payload,
        so interner-table/slice identity survives, and lands atomically
        as the next generation."""
        if self._ckpt is None:
            raise CheckpointError(
                "checkpoint() needs ServiceConfig.checkpoint_dir")
        if not self._started:
            raise CheckpointError("checkpoint() before start()")
        with self._gate.pause():
            self._await_quiesce()
            worker_states = self._gather_worker_states() \
                if self._pool is not None else {}
            self.collect()
            state = self._assemble_state(worker_states)
            path, gen, nbytes = self._ckpt.save(state)
            with self._rec_lock:
                # everything delivered so far is inside the snapshot:
                # a future warm recovery only needs to dedup deliveries
                # made AFTER this cut.  Suppressions still owed from a
                # PREVIOUS recovery that never re-derived are real
                # losses — surface them instead of carrying them over.
                self._dup_log = []
                leftover = sum(self._dup.values())
                self._dup = {}
            if leftover:
                self.telemetry.counter(
                    "serve.recovery_dedup_mismatch").inc(leftover)
        self._c_ckpts.inc()
        self.telemetry.gauge("serve.checkpoint_generation").set(gen)
        self.telemetry.gauge("serve.checkpoint_bytes").set(nbytes)
        return {
            "path": path, "generation": gen, "bytes": nbytes,
            "jobs": len(state["jobs"]),
            "anomalies_emitted": state["service"]["anomalies_emitted"],
            "tail_events": self.tailer.stats.events
            if self.tailer is not None else 0,
            "tail_bytes_decoded": self.tailer.stats.bytes_decoded
            if self.tailer is not None else 0,
        }

    def restore(self) -> Optional[dict]:
        """Load the newest VALID checkpoint generation (torn/corrupt
        files are counted and skipped back past; a newer-format file
        refuses) and rebuild the resident state from it — before
        :meth:`start`, which then resumes tailing at the recorded
        offsets and re-opens worker pipelines via ``TASK_RESTORE``.
        Returns restore metadata, or ``None`` when no valid checkpoint
        exists (the service simply starts cold: full replay)."""
        if self._started:
            raise CheckpointError("restore() must run before start()")
        if self._ckpt is None:
            return None
        loaded = self._ckpt.load_latest()
        if loaded is None:
            self.telemetry.counter("serve.restore_fallbacks").inc()
            return None
        state, path, gen, skipped = loaded
        if skipped:
            self.telemetry.counter("serve.checkpoints_skipped").inc(
                len(skipped))
        if state.get("worker_kind") != self.cfg.worker_kind:
            raise CheckpointError(
                f"{path} was written by a worker_kind="
                f"{state.get('worker_kind')!r} service; this one runs "
                f"{self.cfg.worker_kind!r} — restore with a matching "
                "engine (worker-local state does not translate)")
        self.mux.restore_fleet_state(state["fleet"])
        svc = state["service"]
        with self._reg_lock:
            self._open = set(svc["open"])
            self._departed = set(svc["departed"])
            self._job_cfg = dict(svc["job_cfg"])
        self.stats = svc["stats"]
        with self._rec_lock:
            self.recent_anomalies.extend(svc["recent"])
        for job_id in sorted(state["jobs"]):
            entry = state["jobs"][job_id]
            self.mux.add_job(job_id, self._job_cfg.get(job_id))
            self.mux.restore_job_pipeline(job_id, entry["parent"])
            if entry.get("worker") is not None:
                self._restore_worker_states[job_id] = entry["worker"]
        self.telemetry.absorb(state["telemetry"])
        if state.get("tail") is not None:
            self._tail_restore = state["tail"]
        self._g_jobs.set(len(self._open))
        return {"path": path, "generation": gen, "skipped": skipped,
                "jobs": len(state["jobs"]),
                "anomalies_emitted": svc["anomalies_emitted"]}

    def _await_quiesce(self) -> None:
        """Process mode: with ingestion paused, wait until the workers
        acknowledged every submitted frame (their ``fleet`` envelopes
        decrement the inflight counts) — after this the parent has seen
        every observation the snapshot must contain."""
        if self._pool is None:
            return
        deadline = time.monotonic() + self.cfg.quiesce_timeout_s
        while True:
            with self._reg_lock:
                busy = any(n > 0 for n in self._inflight.values())
            if not busy:
                return
            if time.monotonic() > deadline:
                with self._reg_lock:
                    stuck = {j: n for j, n in self._inflight.items() if n}
                raise CheckpointError(
                    f"quiesce timeout: workers never acknowledged "
                    f"{stuck} frames")
            time.sleep(0.005)

    def _gather_worker_states(self) -> dict[str, dict]:
        """Fan ``TASK_SNAPSHOT`` to every open job's pinned worker and
        collect the answers (each preceded, FIFO, by the job's final
        pending-output ship)."""
        with self._reg_lock:
            want = sorted(self._open)
        if not want:
            return {}
        from repro_torch.fleet.ipc import TASK_SNAPSHOT
        with self._snap_cond:
            self._snap_pending = set(want)
            self._snap_states = {}
        for job_id in want:
            self._pool.submit((TASK_SNAPSHOT, job_id, None, None, None))
        deadline = time.monotonic() + self.cfg.quiesce_timeout_s
        with self._snap_cond:
            while self._snap_pending:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise CheckpointError(
                        f"snapshot timeout: no worker answer for "
                        f"{sorted(self._snap_pending)}")
                self._snap_cond.wait(left)
            return {j: s for j, s in self._snap_states.items()
                    if s is not None}

    def _assemble_state(self, worker_states: dict[str, dict]) -> dict:
        """The full resident state as one picklable dict — see the
        checkpoint-format section of ``serve/README.md``."""
        with self._reg_lock:
            open_ = sorted(self._open)
            departed = sorted(self._departed)
            job_cfg = dict(self._job_cfg)
        jobs = {}
        for job in self.mux.jobs:
            jobs[job.job_id] = {
                "parent": self.mux.snapshot_job_state(job.job_id),
                "worker": worker_states.get(job.job_id),
            }
        with self._rec_lock:
            recent = list(self.recent_anomalies)
        return {
            "worker_kind": self.cfg.worker_kind,
            "service": {
                "open": open_, "departed": departed, "job_cfg": job_cfg,
                "stats": self.stats, "recent": recent,
                "anomalies_emitted": self.mux.stream.total,
            },
            "fleet": self.mux.snapshot_fleet_state(),
            "jobs": jobs,
            "telemetry": self.telemetry.snapshot(),
            "tail": self.tailer.state_dict()
            if self.tailer is not None else None,
        }

    def _checkpoint_loop(self) -> None:
        while not self._stop.wait(self.cfg.checkpoint_interval_s):
            try:
                self.checkpoint()
            except Exception:
                # a failed periodic snapshot must never take the
                # service down — the previous generation still stands
                self.telemetry.counter("serve.checkpoint_errors").inc()

    # ------------------------------------------------------------------ #
    # worker-death recovery (process mode)
    # ------------------------------------------------------------------ #
    def _on_worker_death(self, index: int) -> None:
        # drainer-thread context: recovery joins drainers, so it must
        # run on its own thread
        self.telemetry.counter("serve.worker_deaths").inc()
        t = threading.Thread(target=self._recover_from_death,
                             daemon=True, name="flare-serve-recover")
        t.start()
        self._threads.append(t)

    def _recover_from_death(self) -> None:
        """A worker died mid-flight: instead of poisoning the pool (or
        silently losing the dead worker's resident pipelines), pause
        ingestion, tear the whole pool down, and rewind the service to
        its newest on-disk checkpoint — pipelines restored into a fresh
        pool, tail offsets rewound so the suffix replays, and anomalies
        already delivered since that checkpoint suppressed by replay-
        order dedup (re-derivation is deterministic, so the re-derived
        per-job prefix matches the delivery log byte for byte)."""
        with self._recover_lock:
            if self._finalized or self._stop.is_set():
                return
            with self._gate.pause():
                old_pool = self._pool
                old_pool.stop()          # no callback fires past here
                self.collect()           # deliver (and log) stragglers
                loaded = self._ckpt.load_latest() \
                    if self._ckpt is not None else None
                if loaded is None:
                    self._recover_fresh()
                else:
                    self._recover_from_checkpoint(loaded[0])
                with self._reg_lock:
                    stale = list(self._inflight)
                    self._inflight = {}
                for job_id in stale:
                    self.telemetry.gauge("serve.inflight",
                                         job=job_id).set(0)
            self._c_respawns.inc()

    def _recover_fresh(self) -> None:
        """No checkpoint to rewind to: restart the pool with empty
        pipelines.  Jobs resume from whatever arrives next — counted,
        and explicitly OUTSIDE the byte-equivalence guarantee (that is
        what checkpoints are for)."""
        self.telemetry.counter("serve.recoveries_uncheckpointed").inc()
        self._start_new_pool()
        from repro_torch.fleet.ipc import TASK_OPEN
        with self._reg_lock:
            open_ = sorted(self._open)
        for job_id in open_:
            self._pool.submit((TASK_OPEN, job_id, None,
                               self._job_cfg.get(job_id),
                               self._record_fleet))

    def _recover_from_checkpoint(self, state: dict) -> None:
        with self._rec_lock:
            # deliveries since the checkpoint become a suppression
            # multiset: the restored pipelines will re-derive exactly
            # these (ts, anomaly, origin) keys, once each
            self._dup = {}
            for key in self._dup_log:
                self._dup[key] = self._dup.get(key, 0) + 1
            self._dup_log = []
        old_mux = self.mux
        new_mux = FleetMultiplexer(
            dataclasses.replace(old_mux.cfg, telemetry=self.telemetry),
            history=old_mux.history)
        new_mux.restore_fleet_state(state["fleet"])
        for job_id, attrs in old_mux.topology.items():
            new_mux.set_topology(job_id, **attrs)   # post-snapshot HELLOs
        svc = state["service"]
        for job_id in sorted(state["jobs"]):
            cfg = self._job_cfg.get(job_id) or svc["job_cfg"].get(job_id)
            new_mux.add_job(job_id, cfg)
            new_mux.restore_job_pipeline(job_id,
                                         state["jobs"][job_id]["parent"])
        with self._reg_lock:
            extra = sorted(self._open - set(state["jobs"]))
        for job_id in extra:                        # joined post-snapshot
            new_mux.add_job(job_id, self._job_cfg.get(job_id))
        self.mux = new_mux
        self.stats = svc["stats"]
        self._start_new_pool()
        from repro_torch.fleet.ipc import TASK_OPEN, TASK_RESTORE
        for job_id in sorted(state["jobs"]):
            wstate = state["jobs"][job_id]["worker"]
            if wstate is not None:
                self._pool.submit((TASK_RESTORE, job_id, wstate,
                                   self._job_cfg.get(job_id),
                                   self._record_fleet))
        for job_id in extra:
            self._pool.submit((TASK_OPEN, job_id, None,
                               self._job_cfg.get(job_id),
                               self._record_fleet))
        if self.tailer is not None and state.get("tail") is not None:
            # rewind the tail to the checkpointed offsets: the suffix
            # past the snapshot replays into the restored pipelines
            self.tailer.load_state(state["tail"])
        self.telemetry.counter("serve.jobs_recovered").inc(
            len(state["jobs"]))

    def _start_new_pool(self) -> None:
        self._pool = None
        self._start_pool()

    # ------------------------------------------------------------------ #
    # process-pool callbacks (drainer threads)
    # ------------------------------------------------------------------ #
    def _on_worker_anomalies(self, job_id: str, items) -> None:
        job = self.mux.job(job_id)
        for ts, a in items:
            self.mux.stream.push(job_id, a, ts)
            job.count_anomaly()

    def _on_worker_fleet(self, job_id: str, obs, progress: float) -> None:
        # one envelope per ingested frame: the ack that drives the
        # queue-depth gauge, the observations + progress that advance
        # the parent's cross-job frontier
        self.mux.buffer_fleet_observations(job_id, obs)
        self.mux.note_fleet_progress(job_id, progress)
        self.mux.resolve_fleet_ready()
        self._note_inflight(job_id, -1)

    def _on_worker_snapshot(self, job_id: str, state) -> None:
        with self._snap_cond:
            self._snap_states[job_id] = state
            self._snap_pending.discard(job_id)
            self._snap_cond.notify_all()

    def _on_worker_job(self, job_id: str, res: dict) -> None:
        with self._merge_lock:
            self.mux.interner.merge_tables(res["names"], res["groups"])
            self.mux.telemetry.absorb(res["telemetry"])
            self.mux.restore_job_state(job_id, res["state"])
            self.stats.merge(res["stats"])
            self.mux.buffer_fleet_observations(job_id, res["obs"])
        self.mux.retire_job(job_id)

    def _on_worker_error(self, job_id: str, tb: str) -> None:
        self._errors.append((job_id, tb))
        self._note_inflight(job_id, -1)

    # ------------------------------------------------------------------ #
    # socket plane
    # ------------------------------------------------------------------ #
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return                     # listener closed: shutting down
            maxc = self.cfg.max_connections
            if maxc is not None:
                with self._reg_lock:
                    over = self._active_conns >= maxc
                if over:
                    # clean immediate close, never a hang: the daemon's
                    # sink backs off and retries, its spill keeps the
                    # data; counted so operators see the pressure
                    self._c_rejected.inc()
                    try:
                        conn.close()
                    except OSError:
                        pass
                    continue
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True, name="flare-serve-conn")
            t.start()
            self._conn_threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        self._c_conns.inc()
        with self._reg_lock:
            self._active_conns += 1
            self._g_active.set(self._active_conns)
        conn.settimeout(self.cfg.idle_poll_s)
        try:
            while True:
                fr = read_frame(conn, stop=self._stop.is_set)
                if fr is None:
                    return                  # clean EOF / clean shutdown
                ftype, job_id, payload = fr
                # each frame lands under the ingest gate: a checkpoint's
                # pause happens BETWEEN frames, so the snapshot never
                # cuts a half-applied frame
                with self._gate.ingest():
                    if ftype == FRAME_HELLO:
                        body = parse_hello(payload)
                        self.join_job(str(body.get("job_id") or job_id),
                                      topology=body.get("topology"),
                                      engine=body.get("engine"))
                    elif ftype == FRAME_BATCH:
                        try:
                            self.ingest_frame(job_id, payload)
                        except CodecError as e:
                            raise ProtocolError(
                                f"undecodable BATCH payload ({e})") from e
                    else:
                        self.leave_job(job_id)
        except ProtocolError:
            # torn or corrupt input: count it and drop the connection —
            # resynchronizing a corrupt stream means guessing, and the
            # spill/tail plane is the recovery path
            self._c_dropped.inc()
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._reg_lock:
                self._active_conns -= 1
                self._g_active.set(self._active_conns)

    # ------------------------------------------------------------------ #
    # anomaly collection
    # ------------------------------------------------------------------ #
    def _deliver(self, fas: list[FleetAnomaly]) -> None:
        if not fas:
            return
        deliver = fas
        with self._rec_lock:
            if self._dup:
                # post-recovery replay: suppress anomalies the pre-death
                # service already delivered since the restored
                # checkpoint.  Re-derivation visits each key exactly
                # once, so a multiset decrement is sound; an unknown key
                # simply delivers (fail open — never swallow findings),
                # and keys left over at the next checkpoint are counted
                # as ``serve.recovery_dedup_mismatch``.
                deliver = []
                for fa in fas:
                    key = (fa.job_id, fa.ts, str(fa.anomaly), fa.origin)
                    n = self._dup.get(key, 0)
                    if n:
                        if n == 1:
                            del self._dup[key]
                        else:
                            self._dup[key] = n - 1
                        self._c_deduped.inc()
                        continue
                    deliver.append(fa)
            if self._track_dups:
                for fa in deliver:
                    self._dup_log.append(
                        (fa.job_id, fa.ts, str(fa.anomaly), fa.origin))
            self.recent_anomalies.extend(deliver)
        if self.on_anomaly is not None and deliver:
            now = time.monotonic()
            for fa in deliver:
                self.on_anomaly(fa, now)

    def collect(self) -> list[FleetAnomaly]:
        """Drain newly diagnosed anomalies into the recent ring (and the
        ``on_anomaly`` hook); the collector thread calls this every
        ``drain_interval_s``, tests may call it directly."""
        fas = self.mux.poll()
        self._deliver(fas)
        return fas

    def _collect_loop(self) -> None:
        while not self._stop.wait(self.cfg.drain_interval_s):
            self.collect()

    def snapshot_recent(self, n: Optional[int] = None) -> list[FleetAnomaly]:
        with self._rec_lock:
            out = list(self.recent_anomalies)
        return out[-n:] if n else out

    # ------------------------------------------------------------------ #
    # query-plane views
    # ------------------------------------------------------------------ #
    def job_stats(self) -> dict:
        """Per-job engine stats + live service view (open/departed,
        queued frames)."""
        stats = self.mux.stats()
        with self._reg_lock:
            open_jobs = set(self._open)
            inflight = dict(self._inflight)
        for job in self.mux.jobs:
            row = stats.setdefault(job.job_id, {})
            row["open"] = job.job_id in open_jobs
            row["departed"] = job.departed
            row["queued_frames"] = inflight.get(job.job_id, 0)
        return stats

    def weather(self) -> dict:
        """Cluster-weather summary over the recent ring: what the fleet
        looks like right now, one JSON object."""
        recent = self.snapshot_recent()
        by_kind: dict[str, int] = {}
        by_team: dict[str, int] = {}
        by_job: dict[str, int] = {}
        reclass = 0
        for fa in recent:
            k = getattr(fa.anomaly.kind, "value", str(fa.anomaly.kind))
            t = getattr(fa.anomaly.team, "value", str(fa.anomaly.team))
            by_kind[k] = by_kind.get(k, 0) + 1
            by_team[t] = by_team.get(t, 0) + 1
            by_job[fa.job_id] = by_job.get(fa.job_id, 0) + 1
        reclass = sum(1 for fa in recent if fa.origin == "fleet")
        with self._reg_lock:
            open_jobs = len(self._open)
        return {
            "jobs_open": open_jobs,
            "jobs_total": len(self.mux.jobs),
            "anomalies_recent": len(recent),
            "fleet_reclassified_recent": reclass,
            "by_kind": dict(sorted(by_kind.items())),
            "by_team": dict(sorted(by_team.items())),
            "by_job": dict(sorted(by_job.items())),
            "events_ingested": self.stats.events,
        }
