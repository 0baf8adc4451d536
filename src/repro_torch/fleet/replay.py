"""Offline replay of recorded fleet logs through the multiplexer.

Real deployments accumulate multi-GB trace logs per job — JSONL from the
historical daemons, FCS segments from the binary spill path, rotated
``.segNNN`` pieces from long runs — and replaying a directory of them
re-runs the exact online diagnosis offline.  ``FleetReplayer`` resolves
the codec per file (extension, then content sniff), so mixed-format
directories replay in one pass:

  * JSONL files split on line boundaries and decode concurrently
    (``executor="process"`` scales the json-parse-bound decode past the
    GIL — ``EventBatch`` pickles cheaply; small files auto-fall back to
    one serial pass);
  * FCS files memory-map and stream segment by segment (v2 segments
    inflate slab-wise), each segment ingested as step-aligned slices so
    the per-job watermark closes and diagnoses steps exactly as it would
    have live (and peak memory stays one step, not one file);
  * corrupt input is skipped and counted, never fatal: undecodable JSONL
    lines, truncated FCS tails from killed writers (every intact leading
    segment still replays), and unreadable files.

``replay_dir`` is a PARALLEL pipeline: per-job engines are lock-isolated
(``repro_torch.fleet.multiplexer``), so one worker per job drives that job's
decode -> step-aligned ingest -> incremental diagnosis chain end to
end, overlapping jobs on a multi-core box.  A bounded per-job prefetch
queue lets each job's decode run a couple of chunks ahead of its
diagnosis (backpressure: a slow engine stalls its own decoder, not the
fleet's memory).  Workers come in two kinds:

  * ``worker_kind="thread"`` (default): cheap, shares the multiplexer
    directly — but GIL-bound, so it only overlaps the numpy windows
    (~1.08x at 2 workers / 2 cores);
  * ``worker_kind="process"``: each job's whole pipeline runs in a
    worker PROCESS (``repro_torch.fleet.ipc``) on a private engine, anomalies
    and end state shipped back over bounded queues, event batches
    crossing the boundary (when they must at all) as FCS bytes — real
    multi-core scaling for the decode+diagnose hot path.

Either kind is byte-equivalent to serial replay:

  * jobs are registered up front in sorted path order, so registration
    (and thus flush/finalize) order never depends on worker timing;
  * per-worker ``ReplayStats`` merge deterministically after the join
    (``per_job`` is emitted key-sorted either way);
  * the order-sensitive fleet-scope detector tier never sees raw
    arrival order: observations are buffered under per-job cummax
    timestamp keys and resolved in one global sorted order
    (``FleetMultiplexer.resolve_fleet_all`` at the end of the drain) —
    the same order the live ``FleetService`` resolves incrementally at
    its frontier, so batch replay, parallel replay, and live streaming
    all emit byte-identical fleet-tier reclassifications.  Process
    workers RECORD their job's keyed observations and ship them back
    for the same resolution.

The port's copy of the JAX package's ``fleet/replay.py``: numpy only (no
torch), with the reference's names, thresholds and arithmetic.
"""
from __future__ import annotations

import glob
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Optional

from repro_torch.fleet.multiplexer import FleetMultiplexer
from repro_torch.store import (CodecError, Predicate, ScanStats,
                               codec_for_path, codecs, is_sidecar_path,
                               job_id_for_path, seg_index)


def _known_patterns() -> tuple[str, ...]:
    """One glob per registered codec extension, so a newly registered
    format replays without touching this module."""
    return tuple(f"*{ext}" for c in codecs().values()
                 for ext in c.extensions)


_END = object()


def _iter_prefetch(it: Iterable, depth: int) -> Iterator:
    """Pull ``it`` on a helper thread through a bounded queue: the
    producer (chunk decode) runs at most ``depth`` items ahead of the
    consumer (ingest + diagnosis).  Exceptions — including the
    ``CodecError`` a truncated tail raises mid-file — cross the queue
    and re-raise at the consumption point, after every chunk decoded
    before them was delivered (the skip-and-count contract)."""
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    cancel = threading.Event()

    def _put(pair) -> bool:
        while not cancel.is_set():
            try:
                q.put(pair, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False                         # consumer gone; stop pumping

    def _pump():
        end = (_END, None)
        try:
            for item in it:
                if not _put((item, None)):
                    return
        except BaseException as e:           # delivered, not swallowed
            end = (_END, e)
        _put(end)

    t = threading.Thread(target=_pump, daemon=True,
                         name="flare-replay-prefetch")
    t.start()
    try:
        while True:
            item, exc = q.get()
            if item is _END:
                if exc is not None:
                    raise exc
                return
            yield item
    finally:
        cancel.set()
        t.join(timeout=5.0)


@dataclass
class ReplayStats:
    files: int = 0
    events: int = 0
    skipped_lines: int = 0       # corrupt JSONL lines skipped
    corrupt_files: int = 0       # files with a CodecError (bad magic,
    #                              truncated FCS tail, unknown format)
    skipped_segments: int = 0    # FCS v3 segments pruned on stats alone
    bytes_decoded: int = 0       # segment bytes actually decoded (FCS)
    bytes_skipped: int = 0       # segment bytes hopped over by pushdown
    seconds: float = 0.0
    job_workers: int = 1         # workers the replay actually used
    worker_kind: str = "serial"  # "serial" | "thread" | "process"
    per_job: dict = field(default_factory=dict)   # job_id -> events

    @property
    def events_per_s(self) -> float:
        return self.events / self.seconds if self.seconds > 0 else 0.0

    def merge(self, other: "ReplayStats") -> None:
        """Fold one worker's job-local stats in (call in a deterministic
        job order — the parallel path merges sorted-by-job after the
        join, so totals and ``per_job`` never depend on thread timing)."""
        self.files += other.files
        self.events += other.events
        self.skipped_lines += other.skipped_lines
        self.corrupt_files += other.corrupt_files
        self.skipped_segments += other.skipped_segments
        self.bytes_decoded += other.bytes_decoded
        self.bytes_skipped += other.bytes_skipped
        for job_id, ev in other.per_job.items():
            self.per_job[job_id] = self.per_job.get(job_id, 0) + ev


class FleetReplayer:
    """Replays trace directories into a :class:`FleetMultiplexer`.

    ``chunk_bytes``/``max_workers``/``executor``/``serial_below`` tune
    the per-file chunk decode (JSONL); ``job_workers`` caps the per-job
    workers of :meth:`replay_dir` (``None`` = auto; ``1`` = serial; an
    explicit ``N`` is always honored); ``worker_kind`` picks what a
    worker IS — ``"thread"`` (default; auto stays serial below 4 cores,
    where GIL convoying beats the overlap) or ``"process"``
    (``repro_torch.fleet.ipc``; auto uses one worker per core from 2 cores up,
    since processes don't convoy); ``prefetch`` bounds how many decoded
    chunks each job may queue ahead of its diagnosis (``0`` disables
    the pipeline and decodes inline).

    ``predicate`` (a :class:`repro_torch.store.Predicate`) pushes segment
    pruning into the decode: FCS v3 segments whose stats prove no row
    can match are hopped over without inflating a slab (counted in
    ``ReplayStats.skipped_segments`` / ``bytes_skipped``).  Pruning is
    segment-granular — yielded segments still carry all their rows —
    and v1/v2/JSONL inputs simply decode everything, so a predicate
    never changes which FORMATS replay, only how much I/O v3 archives
    pay.  Use it to re-diagnose a step/time window out of a months-long
    archive without paying a full decode."""

    def __init__(self, mux: FleetMultiplexer, *, chunk_bytes: int = 8 << 20,
                 max_workers: Optional[int] = None,
                 executor: str = "thread",
                 serial_below: Optional[int] = None,
                 job_workers: Optional[int] = None,
                 worker_kind: str = "thread",
                 prefetch: int = 2,
                 predicate: Optional[Predicate] = None):
        if worker_kind not in ("thread", "process"):
            raise ValueError(
                f"worker_kind must be 'thread' or 'process', "
                f"got {worker_kind!r}")
        self.mux = mux
        self.chunk_bytes = chunk_bytes
        self.max_workers = max_workers
        self.executor = executor
        self.serial_below = serial_below
        self.job_workers = job_workers
        self.worker_kind = worker_kind
        self.prefetch = prefetch
        self.predicate = predicate

    def _ingest_step_aligned(self, job_id: str, batch) -> None:
        """Step-aligned ingest — the logic lives on the multiplexer now
        (``FleetMultiplexer.ingest_step_aligned``) so the live service
        feeds wire frames through the exact same slicing."""
        self.mux.ingest_step_aligned(job_id, batch)

    def replay_file(self, job_id: str, path: str,
                    stats: Optional[ReplayStats] = None) -> tuple[int, int]:
        """Stream one job's log into the multiplexer chunk by chunk;
        returns ``(events, skipped_lines)``.  A ``CodecError`` mid-file
        (truncated FCS tail) keeps everything already ingested and is
        counted on ``stats`` instead of raising."""
        codec = codec_for_path(path)
        events = skipped = 0
        scan = ScanStats()
        try:
            chunks = codec.iter_chunks(
                path, chunk_bytes=self.chunk_bytes,
                max_workers=self.max_workers, executor=self.executor,
                serial_below=self.serial_below,
                predicate=self.predicate, scan=scan)
            if self.prefetch > 0:
                chunks = _iter_prefetch(chunks, self.prefetch)
            for batch, sk in chunks:
                events += len(batch)
                skipped += sk
                self._ingest_step_aligned(job_id, batch)
        except CodecError:
            if stats is None:
                raise
            stats.corrupt_files += 1
        if stats is not None:
            stats.skipped_segments += scan.segments_skipped
            stats.bytes_decoded += scan.bytes_decoded
            stats.bytes_skipped += scan.bytes_skipped
        return events, skipped

    def _replay_job(self, job_id: str, paths: list[str],
                    stats: ReplayStats, on_file=None) -> ReplayStats:
        """One job's full pipeline: every rotated/renamed piece in
        order, decode -> step-aligned ingest -> incremental diagnosis on
        that job's (lock-isolated) engine.  Accounting lands on the
        caller-supplied ``stats`` — job-local in the parallel path.
        ``on_file`` fires after each file — the process worker ships
        accumulated anomalies there, for incremental backpressure."""
        for path in paths:
            pre_corrupt = stats.corrupt_files
            try:
                ev, sk = self.replay_file(job_id, path, stats)
            except CodecError:
                stats.corrupt_files += 1
                continue
            finally:
                if on_file is not None:
                    on_file()
            if ev == 0 and stats.corrupt_files > pre_corrupt:
                continue               # nothing usable before the corruption
            stats.files += 1
            stats.events += ev
            stats.skipped_lines += sk
            stats.per_job[job_id] = stats.per_job.get(job_id, 0) + ev
        return stats

    def _resolve_job_workers(self, n_jobs: int, override: Optional[int],
                             kind: str = "thread") -> int:
        w = override if override is not None else self.job_workers
        if w is None:
            cores = os.cpu_count() or 1
            if kind == "process":
                # processes don't convoy on the GIL: one worker per core
                # wins from 2 cores up (spawn cost amortizes over any
                # real replay; tiny dirs stay near-serial anyway)
                w = cores
            else:
                # Thread auto mode is conservative: per-step diagnosis
                # interleaves short GIL-held Python with GIL-releasing
                # numpy windows, so worker threads only overlap usefully
                # when there are enough cores for the windows to land
                # on; measured on a 2-core box the convoy cost makes
                # even independent replays ~0.5-0.8x.  Explicit
                # ``job_workers=N`` always honors the caller.
                w = 1 if cores < 4 else cores
        return max(1, min(w, n_jobs))

    def replay_dir(self, directory: str, *, pattern: Optional[str] = None,
                   flush: bool = True,
                   job_workers: Optional[int] = None,
                   worker_kind: Optional[str] = None) -> ReplayStats:
        """Replay every trace file in ``directory`` (all registered
        formats when ``pattern`` is None), then flush the fleet so
        trailing steps and hangs are diagnosed.  Rotated spill files
        (``job.fcs``, ``job.seg001.fcs``, …) replay into one job, in
        order; files that fail to decode are skipped and counted;
        archive sidecars (rollup caches, telemetry exports) are never
        treated as trace logs.

        Multi-job directories replay in PARALLEL, one worker per job
        (capped by ``job_workers``/cores), each worker owning its job's
        decode -> ingest -> diagnose chain — worker threads by default,
        worker PROCESSES with ``worker_kind="process"`` (the GIL-free
        path; see ``repro_torch.fleet.ipc``).  Anomalies and stats are
        byte-equivalent to a ``job_workers=1`` serial replay either way
        (see module docstring for how ordering is pinned).  Anomalies
        are left in the multiplexer's stream for the caller to
        ``poll()``.  Returns throughput stats."""
        kind = worker_kind if worker_kind is not None else self.worker_kind
        if kind not in ("thread", "process"):
            raise ValueError(
                f"worker_kind must be 'thread' or 'process', got {kind!r}")
        patterns = (pattern,) if pattern is not None else _known_patterns()
        # numeric rotation order: lexicographic sorting would put
        # seg1000 before seg999 on months-long streams
        paths = sorted({p for pat in patterns
                        for p in glob.glob(os.path.join(directory, pat))
                        if not is_sidecar_path(p)},
                       key=lambda p: (job_id_for_path(p), seg_index(p), p))
        groups: dict[str, list[str]] = {}
        for p in paths:
            groups.setdefault(job_id_for_path(p), []).append(p)
        workers = self._resolve_job_workers(len(groups), job_workers, kind)
        stats = ReplayStats(job_workers=workers,
                            worker_kind=kind if workers > 1 else "serial")
        t0 = time.perf_counter()
        if workers <= 1:
            for job_id, jpaths in groups.items():
                self._replay_job(job_id, jpaths, stats)
        elif kind == "process":
            self._replay_dir_process(groups, workers, stats)
        else:
            # registration order must not depend on which worker ingests
            # first: it decides flush/finalize order and fleet-tier
            # resolution order
            for job_id in groups:
                self.mux.add_job(job_id)
            with ThreadPoolExecutor(
                    workers, thread_name_prefix="flare-replay") as ex:
                futs = {job_id: ex.submit(self._replay_job, job_id,
                                          jpaths, ReplayStats())
                        for job_id, jpaths in groups.items()}
                # merge in sorted-path (group) order, not completion
                # order: totals are sums either way, but determinism
                # is the contract
                for job_id in groups:
                    stats.merge(futs[job_id].result())
        if flush:
            self.mux.flush()
        # a directory drain is an end of stream: resolve every buffered
        # fleet-tier observation in the global sorted order (anomalies
        # are ready at the caller's next poll(), no finalize needed)
        self.mux.resolve_fleet_all()
        stats.seconds = time.perf_counter() - t0
        stats.per_job = dict(sorted(stats.per_job.items()))
        self._publish_telemetry(stats)
        return stats

    def _replay_dir_process(self, groups: dict, workers: int,
                            stats: ReplayStats) -> None:
        """Process-sharded replay: each job's pipeline runs in a worker
        process (``repro_torch.fleet.ipc``); the parent re-pushes shipped
        anomalies as they arrive (bounded queues give backpressure),
        buffers the workers' keyed fleet-tier observation shipments
        (incremental ``"fleet"`` envelopes plus each job's terminal
        remainder, concatenated in per-job ship order), and after the
        join merges everything back DETERMINISTICALLY in sorted-path
        group order — intern tables, telemetry, per-job end state,
        stats.  ``resolve_fleet_all`` at the end of ``replay_dir`` then
        sorts the merged observations into the same global order the
        serial path produces."""
        from repro_torch.fleet.ipc import TASK_REPLAY, ProcessWorkerPool
        mux = self.mux
        for job_id in groups:
            mux.add_job(job_id)
        record_fleet = bool(mux.fleet_detectors)
        init = {
            "history": mux.history,
            "fleet": {"watermark_delay": mux.cfg.watermark_delay,
                      "backend": mux.cfg.backend,
                      "max_pending_rows": mux.cfg.max_pending_rows},
            "replay": {"chunk_bytes": self.chunk_bytes,
                       "max_workers": self.max_workers,
                       "executor": self.executor,
                       "serial_below": self.serial_below,
                       "prefetch": self.prefetch,
                       "predicate": self.predicate},
        }

        def _on_anomalies(job_id: str, items) -> None:
            # stream + counter are internally locked; per-job push order
            # is the worker's push order (FIFO queue), which is all the
            # drain sort needs for scheduling-independent output
            job = mux.job(job_id)
            for ts, a in items:
                mux.stream.push(job_id, a, ts)
                job.count_anomaly()

        pool = ProcessWorkerPool(workers, init)
        try:
            for job_id, jpaths in groups.items():
                pool.submit((TASK_REPLAY, job_id, jpaths,
                             mux.job(job_id).engine.cfg, record_fleet))
            results = pool.drain(on_anomalies=_on_anomalies)
        finally:
            pool.close()
        missing = [j for j in groups if j not in results]
        if missing:     # drain() raises on worker errors; belt + braces
            raise RuntimeError(
                f"fleet replay workers returned no result for {missing}")
        for job_id in groups:
            res = results[job_id]
            mux.interner.merge_tables(res["names"], res["groups"])
            mux.telemetry.absorb(res["telemetry"])
            mux.restore_job_state(job_id, res["state"])
            stats.merge(res["stats"])
            mux.buffer_fleet_observations(
                job_id, pool.fleet_observations.get(job_id, []))
            mux.buffer_fleet_observations(job_id, res["obs"])

    def _publish_telemetry(self, stats: ReplayStats) -> None:
        """Land one replay's accounting in the multiplexer's telemetry
        registry (counters accumulate across successive replays into the
        same mux; the rate gauge reflects the latest run)."""
        reg = self.mux.telemetry
        for name, val in (("replay.files", stats.files),
                          ("replay.events", stats.events),
                          ("replay.skipped_lines", stats.skipped_lines),
                          ("replay.corrupt_files", stats.corrupt_files),
                          ("replay.skipped_segments",
                           stats.skipped_segments),
                          ("replay.bytes_decoded", stats.bytes_decoded),
                          ("replay.bytes_skipped", stats.bytes_skipped)):
            if val:
                reg.counter(name).inc(val)
        reg.gauge("replay.events_per_s").set(stats.events_per_s)
        for job_id, ev in stats.per_job.items():
            reg.counter("replay.events", job=job_id).inc(ev)
