"""File-tailer ingestion: follow growing/rotating trace streams live.

The second ingestion plane of :class:`~repro_torch.serve.service.FleetService`
(next to the socket listener): point it at the directory the tracing
daemons spill into and it feeds each job's NEWLY COMPLETED data to a
sink as it lands on disk —

  * FCS streams (``<stem>.fcs``/``.fcs2``/``.fcs3`` + rotated
    ``.segNNN.`` pieces from :class:`~repro_torch.store.writer.
    SegmentedTraceWriter`) advance segment by segment: a segment is
    decoded only once its full ``seg_len`` is on disk
    (``store.tail_complete_segments``), so the tailer never races the
    writer's appends — segment boundaries are the commit points;
  * JSONL streams advance line by line (only up to the last complete
    ``\\n``), corrupt lines skipped and counted exactly like replay.

File progression mirrors ``replay_dir``'s rotation contract: a job's
files are ordered by ``seg_index``; file *N* is FINAL once file *N+1*
exists (the writer rotated away) or the tailer is told the stream ended
(:meth:`FileTailer.finish`).  A final file's leftover bytes — a torn
FCS tail from a killed writer, a partial trailing line — are counted
(``corrupt_files`` / ``skipped_lines``) with the same accounting rules
``FleetReplayer`` uses, so a tailed directory's stats are comparable to
a replayed one.

Drive it with :meth:`poll_once` (deterministic: jobs in sorted order,
files in rotation order — what the equivalence tests do) or hand
:meth:`run` a thread + stop event (what the service does).

The port's copy of the JAX package's ``serve/tail.py``:
stdlib and numpy only (no torch), with the reference's names, formats
and semantics.
"""
from __future__ import annotations

import glob
import os
import threading
from typing import Callable, Optional

from repro_torch.fleet.replay import ReplayStats
from repro_torch.store import (CodecError, codec_for_path, codecs,
                               decode_jsonl_lines, is_sidecar_path,
                               job_id_for_path, seg_index,
                               tail_complete_segments)

_FCS_CODECS = ("fcs", "fcs2", "fcs3")


class _TailFile:
    __slots__ = ("path", "kind", "offset", "events", "dead",
                 "corrupt_counted")

    def __init__(self, path: str, kind: str):
        self.path = path
        self.kind = kind                    # "fcs" | "jsonl" | "skip"
        self.offset = 0                     # consumed bytes
        self.events = 0
        self.dead = False                   # structural corruption: stop
        self.corrupt_counted = False


class _TailJob:
    __slots__ = ("files", "known", "idx")

    def __init__(self):
        self.files: list[_TailFile] = []
        self.known: set[str] = set()
        self.idx = 0                        # current (non-final) file


class FileTailer:
    """Follows every trace stream under ``directory``.

    ``sink(job_id, batch)`` receives each newly completed FCS segment /
    JSONL slab (the service routes it into step-aligned ingest);
    ``on_join(job_id)`` fires once when a job's first file appears.
    ``telemetry`` (optional registry) gets ``serve.tail_files``,
    ``serve.tail_segments``, ``serve.tail_corrupt_files`` and
    ``serve.tail_skipped_lines`` counters.  ``stats`` accumulates
    replay-comparable accounting."""

    def __init__(self, directory: str, sink: Callable,
                 *, on_join: Optional[Callable] = None,
                 telemetry=None, pattern: Optional[str] = None):
        self.directory = directory
        self.sink = sink
        self.on_join = on_join
        self.telemetry = telemetry
        self.pattern = pattern
        self.stats = ReplayStats(worker_kind="tail")
        self._jobs: dict[str, _TailJob] = {}
        self._finished = False

    # ------------------------------------------------------------------ #
    def _count(self, name: str, n: int = 1, **tags) -> None:
        if self.telemetry is not None and n:
            self.telemetry.counter(name, **tags).inc(n)

    def _patterns(self) -> tuple[str, ...]:
        if self.pattern is not None:
            return (self.pattern,)
        return tuple(f"*{ext}" for c in codecs().values()
                     for ext in c.extensions)

    def _classify(self, path: str) -> str:
        try:
            name = codec_for_path(path).name
        except (CodecError, KeyError, ValueError):
            return "skip"
        if name in _FCS_CODECS:
            return "fcs"
        if name == "jsonl":
            return "jsonl"
        return "skip"

    def _discover(self) -> None:
        """Pick up new files (and first-seen jobs).  Rotation only ever
        appends higher ``seg_index`` pieces, so known files keep their
        consumed offsets and new ones append in order."""
        paths = sorted({p for pat in self._patterns()
                        for p in glob.glob(
                            os.path.join(self.directory, pat))
                        if not is_sidecar_path(p)},
                       key=lambda p: (job_id_for_path(p), seg_index(p), p))
        for p in paths:
            job_id = job_id_for_path(p)
            tj = self._jobs.get(job_id)
            if tj is None:
                tj = self._jobs[job_id] = _TailJob()
                if self.on_join is not None:
                    self.on_join(job_id)
            if p not in tj.known:
                tj.known.add(p)
                tj.files.append(_TailFile(p, self._classify(p)))

    # ------------------------------------------------------------------ #
    def _pump(self, job_id: str, tf: _TailFile) -> int:
        """Feed the sink whatever newly completed data ``tf`` holds;
        returns the number of batches delivered."""
        if tf.dead or tf.kind == "skip":
            return 0
        try:
            if tf.kind == "fcs":
                return self._pump_fcs(job_id, tf)
            return self._pump_jsonl(job_id, tf)
        except FileNotFoundError:
            return 0       # vanished (restored state, file pruned): wait
        except CodecError:
            # structural corruption at a COMPLETED offset: count the
            # file once, stop consuming it (replay's skip-and-count)
            tf.dead = True
            if not tf.corrupt_counted:
                tf.corrupt_counted = True
                self.stats.corrupt_files += 1
                self._count("serve.tail_corrupt_files")
            return 0

    def _pump_fcs(self, job_id: str, tf: _TailFile) -> int:
        batches, new_off = tail_complete_segments(tf.path, tf.offset)
        # every byte of every completed segment is decoded exactly once
        # across tailer incarnations (offsets are checkpointed), so this
        # is the suffix-only-replay accounting the chaos gate asserts on
        self.stats.bytes_decoded += new_off - tf.offset
        tf.offset = new_off
        for b in batches:
            n = len(b)
            tf.events += n
            self.stats.events += n
            self._count("serve.tail_segments")
            self.sink(job_id, b)
        return len(batches)

    def _pump_jsonl(self, job_id: str, tf: _TailFile,
                    *, final: bool = False) -> int:
        try:
            size = os.path.getsize(tf.path)
        except OSError:
            return 0
        if size <= tf.offset:
            return 0
        with open(tf.path, "rb") as f:
            f.seek(tf.offset)
            data = f.read()
        if final:
            chunk = data           # trailing partial line: decode-or-count
        else:
            cut = data.rfind(b"\n")
            if cut < 0:
                return 0           # no complete line yet: wait
            chunk = data[:cut + 1]
        batch, skipped = decode_jsonl_lines(chunk.splitlines())
        tf.offset += len(chunk)
        self.stats.bytes_decoded += len(chunk)
        if skipped:
            self.stats.skipped_lines += skipped
            self._count("serve.tail_skipped_lines", skipped)
        n = len(batch)
        if n:
            tf.events += n
            self.stats.events += n
            self._count("serve.tail_segments")
            self.sink(job_id, batch)
        return 1 if (n or skipped) else 0

    def _finish_file(self, job_id: str, tf: _TailFile) -> None:
        """The file is FINAL (rotated away, or end of stream): resolve
        its leftover bytes and land replay-compatible accounting."""
        if tf.kind == "jsonl" and not tf.dead:
            self._pump_jsonl(job_id, tf, final=True)
        elif tf.kind == "fcs" and not tf.dead:
            try:
                size = os.path.getsize(tf.path)
            except OSError:
                size = tf.offset
            if size > tf.offset and not tf.corrupt_counted:
                # a tail that never completed: the killed-writer signal
                tf.corrupt_counted = True
                self.stats.corrupt_files += 1
                self._count("serve.tail_corrupt_files")
        if tf.kind == "skip":
            return
        if tf.events == 0 and tf.corrupt_counted:
            return                 # nothing usable before the corruption
        self.stats.files += 1
        self.stats.per_job[job_id] = \
            self.stats.per_job.get(job_id, 0) + tf.events
        self._count("serve.tail_files")

    # ------------------------------------------------------------------ #
    def poll_once(self) -> int:
        """One deterministic pass: discover files, pump every job's
        stream (sorted job order, rotation order within a job), finalize
        files that later rotation pieces prove complete.  Returns the
        number of batches delivered to the sink."""
        self._discover()
        delivered = 0
        for job_id in sorted(self._jobs):
            tj = self._jobs[job_id]
            while tj.idx < len(tj.files):
                tf = tj.files[tj.idx]
                delivered += self._pump(job_id, tf)
                if tj.idx < len(tj.files) - 1:
                    # a later piece exists: this one is final
                    self._finish_file(job_id, tf)
                    tj.idx += 1
                    continue
                break
        return delivered

    def finish(self) -> None:
        """End of stream: one last pump, then treat every job's current
        file as final (leftover tails become corruption counts, partial
        trailing lines decode-or-count).  Idempotent."""
        if self._finished:
            return
        self._finished = True
        self.poll_once()
        for job_id in sorted(self._jobs):
            tj = self._jobs[job_id]
            while tj.idx < len(tj.files):
                tf = tj.files[tj.idx]
                self._pump(job_id, tf)
                self._finish_file(job_id, tf)
                tj.idx += 1

    # ------------------------------------------------------------------ #
    # service checkpoints: byte/segment offsets + accounting
    # ------------------------------------------------------------------ #
    def state_dict(self) -> dict:
        """Picklable tail position: per-file consumed offsets (FCS
        offsets always sit on segment boundaries — the commit points —
        so a restored tailer resumes mid-file without re-decoding),
        per-job rotation cursors, and the replay-comparable stats."""
        return {
            "jobs": {
                job_id: {
                    "idx": tj.idx,
                    "files": [{
                        "path": tf.path, "kind": tf.kind,
                        "offset": tf.offset, "events": tf.events,
                        "dead": tf.dead,
                        "corrupt_counted": tf.corrupt_counted,
                    } for tf in tj.files],
                } for job_id, tj in self._jobs.items()
            },
            "stats": self.stats,
            "finished": self._finished,
        }

    def load_state(self, state: dict) -> None:
        """Inverse of :meth:`state_dict` on a fresh tailer over the same
        directory: tailing resumes exactly at the recorded offsets (only
        the suffix past them is ever decoded again), and the restored
        stats continue the uninterrupted run's accounting."""
        self._jobs = {}
        for job_id, js in state["jobs"].items():
            tj = self._jobs[job_id] = _TailJob()
            tj.idx = int(js["idx"])
            for fs in js["files"]:
                tf = _TailFile(fs["path"], fs["kind"])
                tf.offset = int(fs["offset"])
                tf.events = int(fs["events"])
                tf.dead = bool(fs["dead"])
                tf.corrupt_counted = bool(fs["corrupt_counted"])
                tj.known.add(tf.path)
                tj.files.append(tf)
        self.stats = state["stats"]
        self._finished = bool(state["finished"])

    def run(self, stop: threading.Event, poll_s: float = 0.05) -> None:
        """Thread body: poll until ``stop`` is set, then ``finish()``."""
        while not stop.is_set():
            self.poll_once()
            stop.wait(poll_s)
        self.finish()

    @property
    def jobs(self) -> list[str]:
        return sorted(self._jobs)
