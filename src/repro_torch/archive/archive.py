"""TraceArchive — the query surface over a directory of rotated segments.

A months-long deployment leaves behind a directory of rotated trace
files per job (``job-a.fcs3``, ``job-a.seg001.fcs3``, …, possibly mixed
with older v1/v2/JSONL pieces).  On-call questions against that archive
are not "replay everything" questions — they are *predicates*
("job B, steps 4000–5000", "any critical event on rack r12 last hour")
and *dashboards* (per-step throughput, anomaly counts per team), asked
repeatedly.  ``TraceArchive`` answers both at interactive latency:

  * **query_events** pushes the predicate into the FCS v3 stats
    directory (``repro_torch.store.stats``): segments that provably contain no
    matching row are hopped over without inflating a slab, then the
    exact row filter runs on what remains — byte-identical results to a
    full decode, a fraction of the bytes (see ``benchmarks/archive.py``).
  * **query_metrics** serves per-job, per-step rollup records
    (throughput, t_step, issue p99, per-rank FLOPS, void fractions)
    from a cache built once per FILE via ``aggregate_slice`` and
    invalidated by (size, mtime) fingerprint — a segment append or
    rotation re-rolls only the file it touched, and warm queries never
    touch the trace bytes at all.  Rollups also PERSIST as
    ``<trace>.rollup.json`` sidecars keyed by the same fingerprint, so
    a cold archive process (tomorrow's dashboard restart) answers
    ``query_metrics`` warm without re-decoding a single segment.
  * **query_anomalies** replays the directory once through a private
    :class:`~repro_torch.fleet.FleetMultiplexer` (same engines, detectors and
    watermark semantics as the live pipeline), caches the merged
    anomaly stream against the directory fingerprint, and filters by
    job / time-range / team.
  * **fleet_weather** condenses all of the above into the per-job
    throughput-trend + anomaly-count report an on-call bot would post.
  * **export_telemetry / telemetry_snapshots** persist pipeline
    self-telemetry (``repro_torch.core.telemetry``) as ``telemetry-NNN.json``
    next to the segments, so "how the pipeline felt" rides along with
    the data it produced.

Every query transparently refreshes against the directory first, so an
archive object can sit behind a dashboard while daemons keep appending.

The port's copy of the JAX package's ``archive/archive.py``: numpy only (no
torch), with the reference's names, thresholds and arithmetic.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
from typing import Optional

import numpy as np

from repro_torch.core.anomaly import Team
from repro_torch.core.columnar import EventBatch
from repro_torch.core.engine import EngineConfig
from repro_torch.core.history import HistoryStore
from repro_torch.core.metrics import aggregate_slice
from repro_torch.core.telemetry import TelemetryRegistry
from repro_torch.fleet.multiplexer import FleetConfig, FleetMultiplexer
from repro_torch.fleet.replay import FleetReplayer
from repro_torch.store import (ROLLUP_SUFFIX, Predicate, ScanStats,
                               codec_for_path, codecs, is_sidecar_path,
                               job_id_for_path, seg_index)
from repro_torch.store.fcs import iter_segments

# scalar rollup fields (events-weighted on merge/bucket); "rank_flops"
# is the one dict-valued metric and merges rank-wise
SCALAR_METRICS = ("throughput", "t_step", "v_inter", "v_minority",
                  "issue_p99", "bandwidth", "events")
_TELEMETRY_RE = re.compile(r"^telemetry-(\d+)\.json$")


def _file_patterns() -> tuple[str, ...]:
    return tuple(f"*{ext}" for c in codecs().values()
                 for ext in c.extensions)


def _fingerprint(path: str) -> tuple:
    st = os.stat(path)
    return (st.st_size, st.st_mtime_ns)


def _rollup_record(m, events: int) -> dict:
    """One step's cached rollup: plain floats/dicts, no numpy arrays, so
    records are JSON-able and cheap to keep for months of steps."""
    lat = m.issue_latencies
    rank_flops: dict[int, float] = {}
    counts: dict[int, int] = {}
    for per_rank in m.flops.values():
        for r, f in per_rank.items():
            r = int(r)
            rank_flops[r] = rank_flops.get(r, 0.0) + float(f)
            counts[r] = counts.get(r, 0) + 1
    rank_flops = {r: v / counts[r] for r, v in rank_flops.items()}
    bw = float(np.mean(list(m.bandwidth.values()))) if m.bandwidth else 0.0
    return {
        "throughput": float(m.throughput),
        "t_step": float(m.t_step),
        "v_inter": float(m.v_inter),
        "v_minority": float(m.v_minority),
        "issue_p99": float(np.percentile(lat, 99)) if lat.size else 0.0,
        "bandwidth": bw,
        "events": float(events),
        "rank_flops": rank_flops,
    }


def _merge_records(a: dict, b: dict) -> dict:
    """Events-weighted merge of two records for the SAME step (a step
    split across rotated files — each side saw only its rows, so the
    merged numbers are an approximation, weighted by how many rows each
    side aggregated)."""
    wa, wb = a["events"], b["events"]
    tot = wa + wb
    if tot <= 0:
        return dict(a)
    out = {}
    for k in SCALAR_METRICS:
        if k == "events":
            out[k] = tot
        else:
            out[k] = (a[k] * wa + b[k] * wb) / tot
    rf: dict[int, float] = {}
    for r in set(a["rank_flops"]) | set(b["rank_flops"]):
        fa, fb = a["rank_flops"].get(r), b["rank_flops"].get(r)
        if fa is None:
            rf[r] = fb
        elif fb is None:
            rf[r] = fa
        else:
            rf[r] = (fa * wa + fb * wb) / tot
    out["rank_flops"] = rf
    return out


class TraceArchive:
    """Queryable archive over ``directory``'s rotated trace files.

    ``history``/``engine_config``/``fleet_config`` configure the private
    replay pipeline behind :meth:`query_anomalies` (a learned
    :class:`HistoryStore` enables the profile-relative detectors, an
    :class:`EngineConfig` pins detector set and rank count per job).
    ``telemetry`` shares a registry with the rest of the pipeline —
    archive cache behavior lands there too (``archive.rollup_builds``
    vs ``archive.rollup_hits`` vs ``archive.rollup_disk_hits``,
    ``archive.queries{kind=...}``).  ``persist_rollups=False`` disables
    the on-disk sidecar cache (e.g. for read-only media; a failed
    sidecar write is silently skipped anyway)."""

    def __init__(self, directory: str, *,
                 history: Optional[HistoryStore] = None,
                 engine_config: Optional[EngineConfig] = None,
                 fleet_config: Optional[FleetConfig] = None,
                 telemetry: Optional[TelemetryRegistry] = None,
                 pattern: Optional[str] = None,
                 persist_rollups: bool = True):
        self.directory = directory
        self.history = history
        self.engine_config = engine_config
        self.fleet_config = fleet_config
        self.telemetry = telemetry or TelemetryRegistry()
        self.pattern = pattern
        self.persist_rollups = persist_rollups
        # job_id -> [paths] in rotation order, refreshed per query
        self._files: dict[str, list[str]] = {}
        # path -> (fingerprint, {step: record})
        self._rollups: dict[str, tuple[tuple, dict[int, dict]]] = {}
        # anomaly cache: (dir fingerprint, [FleetAnomaly]), plus the
        # mux that produced it (kept for telemetry_snapshot merging)
        self._anomaly_fp: Optional[tuple] = None
        self._anomalies: list = []
        self._mux: Optional[FleetMultiplexer] = None
        self._c_builds = self.telemetry.counter("archive.rollup_builds")
        self._c_hits = self.telemetry.counter("archive.rollup_hits")
        self._c_disk_hits = self.telemetry.counter(
            "archive.rollup_disk_hits")

    # ------------------------------------------------------------------ #
    # discovery
    # ------------------------------------------------------------------ #
    def refresh(self) -> dict[str, list[str]]:
        """Re-scan the directory; returns job_id -> ordered path list."""
        patterns = (self.pattern,) if self.pattern else _file_patterns()
        paths = sorted({p for pat in patterns
                        for p in glob.glob(
                            os.path.join(self.directory, pat))
                        if not is_sidecar_path(p)},
                       key=lambda p: (job_id_for_path(p), seg_index(p), p))
        files: dict[str, list[str]] = {}
        for p in paths:
            files.setdefault(job_id_for_path(p), []).append(p)
        self._files = files
        return files

    @property
    def jobs(self) -> list[str]:
        self.refresh()
        return sorted(self._files)

    def _job_paths(self, job: str) -> list[str]:
        self.refresh()
        if job not in self._files:
            raise KeyError(f"no trace files for job {job!r} under "
                           f"{self.directory} (known: {sorted(self._files)})")
        return self._files[job]

    def segment_stats(self, job: str):
        """Per-segment :class:`~repro_torch.store.SegmentStats` for every FCS
        file of ``job``, in rotation order — the raw pruning directory,
        without decoding a slab."""
        from repro_torch.store.fcs import segment_stats as _seg_stats
        for path in self._job_paths(job):
            if codec_for_path(path).name.startswith("fcs"):
                yield from _seg_stats(path)

    # ------------------------------------------------------------------ #
    # events: predicate-pushdown reads
    # ------------------------------------------------------------------ #
    def query_events(self, job: str,
                     predicate: Optional[Predicate] = None, *,
                     step_range: Optional[tuple] = None,
                     time_range: Optional[tuple] = None,
                     ranks=None, kinds=None, severity: Optional[str] = None,
                     columns: Optional[dict] = None,
                     max_bytes: Optional[int] = None,
                     pushdown: bool = True, with_scan: bool = False):
        """Exact matching rows for ``job`` as one :class:`EventBatch`.

        Build the predicate inline (``step_range=...``/``severity=...``/
        ``columns={"flops": (lo, hi)}`` — per-column value bounds pruned
        against the v3 per-column min/max) or pass one.
        ``pushdown=False`` decodes every segment (the equivalence oracle
        — same row filter, same concat order, so results are
        byte-identical; benchmarks assert it).  With ``with_scan=True``
        returns ``(batch, ScanStats)`` so callers see how many bytes the
        stats directory saved.

        ``max_bytes`` is a per-query DECODE budget: the scan stops at
        the first segment boundary past it (stats-pruned bytes are
        free — only inflated bytes spend budget) and flags
        ``ScanStats.truncated`` — the result is the archive-order prefix
        the budget affords, deterministic for a given archive.  A
        dashboard query against a months-long job can therefore never
        decode the world; it says "truncated" instead."""
        self.telemetry.counter("archive.queries", kind="events").inc()
        if predicate is None:
            predicate = Predicate(step_range=step_range,
                                  time_range=time_range, ranks=ranks,
                                  kinds=kinds, severity=severity,
                                  columns=columns)
        scan = ScanStats()
        parts: list[EventBatch] = []
        for path in self._job_paths(job):
            if scan.truncated:
                break
            codec = codec_for_path(path)
            if codec.name.startswith("fcs"):
                it = iter_segments(path,
                                   predicate=predicate if pushdown else None,
                                   scan=scan)
                for seg in it:
                    parts.append(predicate.filter(seg))
                    if max_bytes is not None \
                            and scan.bytes_decoded >= max_bytes:
                        scan.truncated = True
                        break
            else:
                # non-segmented formats decode whole-file; budget them
                # by on-disk size so mixed archives still terminate
                for batch, _sk in codec.iter_chunks(path):
                    scan.segments += 1
                    scan.rows += len(batch)
                    parts.append(predicate.filter(batch))
                try:
                    scan.bytes_decoded += os.path.getsize(path)
                except OSError:
                    pass
                if max_bytes is not None \
                        and scan.bytes_decoded >= max_bytes:
                    scan.truncated = True
        if scan.truncated:
            self.telemetry.counter("archive.truncated_queries",
                                   kind="events").inc()
        out = EventBatch.concat(parts) if parts else EventBatch.empty()
        return (out, scan) if with_scan else out

    # ------------------------------------------------------------------ #
    # metrics: cached per-file rollups
    # ------------------------------------------------------------------ #
    def _rollup_sidecar(self, path: str) -> str:
        return path + ROLLUP_SUFFIX

    def _load_disk_rollup(self, path: str, fp: tuple
                          ) -> Optional[dict[int, dict]]:
        """Sidecar rollup for ``path`` if present AND fingerprint-fresh;
        any unreadable/stale/mismatched sidecar means rebuild."""
        try:
            with open(self._rollup_sidecar(path)) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return None
        if tuple(data.get("fingerprint", ())) != fp:
            return None
        rollup: dict[int, dict] = {}
        try:
            for s, rec in data["rollup"].items():
                rec = dict(rec)
                rec["rank_flops"] = {int(r): v for r, v
                                     in rec["rank_flops"].items()}
                rollup[int(s)] = rec
        except (KeyError, TypeError, ValueError):
            return None                    # malformed sidecar: rebuild
        return rollup

    def _store_disk_rollup(self, path: str, fp: tuple,
                           rollup: dict[int, dict]) -> None:
        """Best-effort atomic sidecar write (tmp + fsync + rename); a
        read-only archive directory just stays cold."""
        sidecar = self._rollup_sidecar(path)
        tmp = sidecar + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump({"fingerprint": list(fp), "rollup": rollup}, f,
                          separators=(",", ":"))
                # fsync BEFORE the rename: otherwise a crash can leave
                # the sidecar name pointing at not-yet-flushed bytes —
                # a torn rollup that parses as garbage on the next boot
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, sidecar)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _file_rollup(self, path: str) -> dict[int, dict]:
        """step -> record for one file, (size, mtime)-cached in memory
        AND on disk (``<trace>.rollup.json``): an append or rotation
        invalidates exactly the file it touched; a fresh process warms
        from the sidecars without decoding anything."""
        fp = _fingerprint(path)
        cached = self._rollups.get(path)
        if cached is not None and cached[0] == fp:
            self._c_hits.inc()
            return cached[1]
        if self.persist_rollups:
            rollup = self._load_disk_rollup(path, fp)
            if rollup is not None:
                self._c_disk_hits.inc()
                self._rollups[path] = (fp, rollup)
                return rollup
        self._c_builds.inc()
        batch = codec_for_path(path).read(path)
        rollup: dict[int, dict] = {}
        if len(batch):
            order, uniq, bounds = batch.step_index()
            num_ranks = batch.num_distinct_ranks()
            sorted_ = batch.is_step_sorted()
            for j in range(uniq.size):
                s = int(uniq[j])
                if s < 0:
                    continue            # unattributed rows roll up nowhere
                sb = batch.slice_rows(int(bounds[j]), int(bounds[j + 1])) \
                    if sorted_ else batch.take(order[bounds[j]:bounds[j + 1]])
                m = aggregate_slice(sb, s, num_ranks=num_ranks)
                if m is not None:
                    rollup[s] = _rollup_record(m, len(sb))
        self._rollups[path] = (fp, rollup)
        if self.persist_rollups:
            self._store_disk_rollup(path, fp, rollup)
        return rollup

    def rollups(self, job: str, *, max_bytes: Optional[int] = None,
                with_truncation: bool = False):
        """Merged step -> record across the job's rotated files.

        ``max_bytes`` budgets the files folded in by their ON-DISK size
        — rotation-order prefix, so the answer is deterministic for a
        given archive regardless of which rollups happened to be cached
        (a warm cache makes the same truncated query faster, never
        different).  ``with_truncation=True`` returns
        ``(rollup, truncated)``."""
        out: dict[int, dict] = {}
        used = 0
        truncated = False
        for path in self._job_paths(job):
            if max_bytes is not None and used >= max_bytes:
                truncated = True
                break
            try:
                used += os.path.getsize(path)
            except OSError:
                pass
            for s, rec in self._file_rollup(path).items():
                out[s] = _merge_records(out[s], rec) if s in out else rec
        return (out, truncated) if with_truncation else out

    def query_metrics(self, job: str,
                      step_range: Optional[tuple] = None,
                      metric: str = "throughput", *,
                      bucket: int = 1,
                      max_bytes: Optional[int] = None,
                      with_truncation: bool = False):
        """``[(step, value), ...]`` for one rollup metric, step-sorted.

        ``metric`` is one of ``throughput | t_step | v_inter |
        v_minority | issue_p99 | bandwidth | events | rank_flops``
        (the last returns a per-rank dict per step).  ``bucket > 1``
        groups steps into ``bucket``-wide buckets keyed by their first
        step, events-weighted.  ``max_bytes`` budgets the rollup as in
        :meth:`rollups`; ``with_truncation=True`` returns
        ``(series, truncated)``."""
        if metric != "rank_flops" and metric not in SCALAR_METRICS:
            raise ValueError(f"unknown metric {metric!r}; known: "
                             f"{SCALAR_METRICS + ('rank_flops',)}")
        self.telemetry.counter("archive.queries", kind="metrics").inc()
        recs, truncated = self.rollups(job, max_bytes=max_bytes,
                                       with_truncation=True)
        if truncated:
            self.telemetry.counter("archive.truncated_queries",
                                   kind="metrics").inc()
        if step_range is not None:
            lo, hi = step_range
            recs = {s: r for s, r in recs.items() if lo <= s <= hi}
        if bucket > 1:
            grouped: dict[int, dict] = {}
            for s in sorted(recs):
                b = (s // bucket) * bucket
                grouped[b] = _merge_records(grouped[b], recs[s]) \
                    if b in grouped else dict(recs[s])
            recs = grouped
        series = [(s, recs[s][metric]) for s in sorted(recs)]
        return (series, truncated) if with_truncation else series

    # ------------------------------------------------------------------ #
    # anomalies: cached full-archive replay
    # ------------------------------------------------------------------ #
    def _dir_fingerprint(self) -> tuple:
        self.refresh()
        return tuple((p, _fingerprint(p))
                     for paths in self._files.values() for p in paths)

    def _replay_all(self) -> list:
        fp = self._dir_fingerprint()
        if self._anomaly_fp == fp:
            self.telemetry.counter("archive.replay_cache_hits").inc()
            return self._anomalies
        cfg = self.fleet_config or FleetConfig()
        if cfg.telemetry is None:
            cfg = dataclasses.replace(cfg, telemetry=self.telemetry)
        mux = FleetMultiplexer(cfg, self.history)
        if self.engine_config is not None:
            for job_id in self._files:
                mux.add_job(job_id, self.engine_config)
        replayer = FleetReplayer(mux)
        replayer.replay_dir(self.directory, pattern=self.pattern,
                            flush=False)
        anomalies = mux.finalize()
        self._anomaly_fp = fp
        self._anomalies = anomalies
        self._mux = mux
        return anomalies

    def query_anomalies(self, job: Optional[str] = None,
                        time_range: Optional[tuple] = None,
                        team=None) -> list:
        """Diagnosed :class:`~repro_torch.fleet.stream.FleetAnomaly` list for
        the whole archive (cached until any file changes), filtered by
        job, event-time range, and owning team (a
        :class:`~repro_torch.core.anomaly.Team` or its string value)."""
        self.telemetry.counter("archive.queries", kind="anomalies").inc()
        out = self._replay_all()
        if job is not None:
            out = [a for a in out if a.job_id == job]
        if time_range is not None:
            t0, t1 = time_range
            out = [a for a in out if t0 <= a.ts <= t1]
        if team is not None:
            want = team if isinstance(team, Team) else Team(team)
            out = [a for a in out if a.team is want]
        return list(out)

    # ------------------------------------------------------------------ #
    # fleet weather
    # ------------------------------------------------------------------ #
    def fleet_weather(self) -> dict:
        """Per-job health summary + fleet totals: steps/events covered,
        mean throughput, the throughput TREND (% change, second half of
        the step range vs the first), and anomaly counts by team."""
        anomalies = self._replay_all()
        report: dict = {"jobs": {}, "fleet": {}}
        tot_events = tot_steps = tot_anoms = 0
        for job in sorted(self._files):
            recs = self.rollups(job)
            steps = sorted(recs)
            thr = [recs[s]["throughput"] for s in steps]
            trend = 0.0
            if len(thr) >= 4:
                half = len(thr) // 2
                a, b = float(np.mean(thr[:half])), float(np.mean(thr[half:]))
                if a > 0:
                    trend = (b - a) / a * 100.0
            by_team: dict[str, int] = {}
            ja = [a for a in anomalies if a.job_id == job]
            for a in ja:
                by_team[a.team.value] = by_team.get(a.team.value, 0) + 1
            events = int(sum(recs[s]["events"] for s in steps))
            report["jobs"][job] = {
                "steps": len(steps),
                "events": events,
                "throughput_mean": float(np.mean(thr)) if thr else 0.0,
                "throughput_trend_pct": trend,
                "anomalies": len(ja),
                "anomalies_by_team": dict(sorted(by_team.items())),
            }
            tot_events += events
            tot_steps += len(steps)
            tot_anoms += len(ja)
        report["fleet"] = {"jobs": len(report["jobs"]),
                           "steps": tot_steps, "events": tot_events,
                           "anomalies": tot_anoms}
        return report

    # ------------------------------------------------------------------ #
    # telemetry export
    # ------------------------------------------------------------------ #
    def telemetry_snapshot(self) -> dict:
        """This archive's own registry, merged with the replay
        pipeline's (mux + replay counters) when a cached replay exists.
        When both share one registry the merge is the identity."""
        mux = self._mux
        if mux is not None and mux.telemetry is not self.telemetry:
            return self.telemetry.merge_snapshot(mux.telemetry_snapshot())
        return self.telemetry.snapshot()

    def export_telemetry(self, snapshot: Optional[dict] = None) -> str:
        """Write a telemetry snapshot (default: :meth:`telemetry_snapshot`)
        as ``telemetry-NNN.json`` next to the segments; returns the path.
        Successive exports number upward, so the directory accumulates a
        coarse time series of pipeline health alongside the traces."""
        snap = snapshot if snapshot is not None else self.telemetry_snapshot()
        existing = [int(m.group(1)) for f in os.listdir(self.directory)
                    if (m := _TELEMETRY_RE.match(f))]
        nxt = max(existing, default=-1) + 1
        path = os.path.join(self.directory, f"telemetry-{nxt:03d}.json")
        with open(path, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True)
        return path

    def telemetry_snapshots(self) -> list[dict]:
        """Every exported snapshot in export order."""
        found = sorted((int(m.group(1)), f)
                       for f in os.listdir(self.directory)
                       if (m := _TELEMETRY_RE.match(f)))
        out = []
        for _, f in found:
            with open(os.path.join(self.directory, f)) as fh:
                out.append(json.load(fh))
        return out


def format_fleet_weather(report: dict) -> str:
    """Render :meth:`TraceArchive.fleet_weather` as the fixed-width
    table an on-call channel would receive."""
    lines = [f"{'job':<12} {'steps':>6} {'events':>9} {'tok/s':>12} "
             f"{'trend':>8}  anomalies"]
    for job, j in report["jobs"].items():
        teams = ", ".join(f"{t}:{n}" for t, n in
                          j["anomalies_by_team"].items()) or "-"
        lines.append(f"{job:<12} {j['steps']:>6} {j['events']:>9} "
                     f"{j['throughput_mean']:>12.1f} "
                     f"{j['throughput_trend_pct']:>+7.1f}%  {teams}")
    f = report["fleet"]
    lines.append(f"fleet: {f['jobs']} jobs, {f['steps']} steps, "
                 f"{f['events']} events, {f['anomalies']} anomalies")
    return "\n".join(lines)
