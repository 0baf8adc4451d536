#!/usr/bin/env python3
"""Replay a directory of FLARE spills through the port's fleet and print
the merged anomaly stream as JSON.

    python3 tools/fleet_replay.py DIR --history HIST_DIR --spec SPEC.json \
        [--job-workers N] [--worker-kind thread|process]

``HIST_DIR`` holds the healthy profiles as ``HistoryStore`` JSON files;
``SPEC.json`` (``write_spec``) the fleet's watermark delay, fleet-scope
detectors and topology, and each job's ``EngineConfig``.  Every job of the
spec is added to the multiplexer before the replay, as a live fleet added
it.  The replay runs in this interpreter, which imports numpy and the
port's numpy modules only (no torch): its process workers are forked from
a process that holds no CUDA context and no threads of a training run.

Prints one JSON object: ``stream`` (``stream_rows``: job, ts, origin,
route and the anomaly's fields, in the stream's drain order), ``stats``
(``stats_signature``), ``late_rows`` and ``forced_closes`` by job, and
``torch_imported``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def stream_rows(fleet_anomalies) -> list:
    """The stream as plain rows: job id, event time, origin and route,
    then the anomaly as ``report.anomalies_json`` writes it."""
    from repro_torch.core.report import anomalies_json
    rows = json.loads(anomalies_json([fa.anomaly for fa in fleet_anomalies]))
    return [dict(job=fa.job_id, ts=fa.ts, origin=fa.origin, route=fa.route,
                 **row) for fa, row in zip(fleet_anomalies, rows)]


def stats_signature(stats) -> dict:
    """The parts of a ``ReplayStats`` that do not depend on timing or on
    the kind of worker."""
    return dict(files=stats.files, events=stats.events,
                skipped_lines=stats.skipped_lines,
                corrupt_files=stats.corrupt_files,
                skipped_segments=stats.skipped_segments,
                bytes_decoded=stats.bytes_decoded,
                bytes_skipped=stats.bytes_skipped,
                per_job=dict(stats.per_job))


def write_spec(path, jobs: dict, fleet_cfg) -> None:
    """``jobs``: job id -> ``EngineConfig`` (its detector set the default
    or registry names); ``fleet_cfg``: the ``FleetConfig`` of the live
    fleet, with its topology."""
    spec = dict(
        watermark_delay=fleet_cfg.watermark_delay,
        fleet_detectors=fleet_cfg.fleet_detectors,
        topology=fleet_cfg.topology or {},
        jobs={j: dict(backend=c.backend, num_ranks=c.num_ranks,
                      kernel_shapes={k: list(v)
                                     for k, v in c.kernel_shapes.items()},
                      detectors=c.detectors)
              for j, c in jobs.items()})
    Path(path).write_text(json.dumps(spec, indent=1))


def read_spec(path) -> tuple:
    """(``FleetConfig``, job id -> ``EngineConfig``) from ``write_spec``'s
    file; shapes come back as tuples."""
    from repro_torch.core.engine import EngineConfig
    from repro_torch.fleet import FleetConfig
    spec = json.loads(Path(path).read_text())
    jobs = {j: EngineConfig(backend=c["backend"], num_ranks=c["num_ranks"],
                            kernel_shapes={k: tuple(v) for k, v in
                                           c["kernel_shapes"].items()},
                            detectors=c["detectors"])
            for j, c in spec["jobs"].items()}
    cfg = FleetConfig(watermark_delay=spec["watermark_delay"],
                      fleet_detectors=spec["fleet_detectors"],
                      topology=spec["topology"])
    return cfg, jobs


def replay(directory, history_dir, spec_path, job_workers: int = 1,
           worker_kind: str = "thread") -> dict:
    """One replay of ``directory`` into a fresh multiplexer; returns the
    printed object (the stream drained once, after the replay's flush)."""
    from repro_torch.core.history import HistoryStore
    from repro_torch.fleet import FleetMultiplexer, FleetReplayer
    cfg, jobs = read_spec(spec_path)
    mux = FleetMultiplexer(cfg, history=HistoryStore(str(history_dir)))
    for job, ecfg in jobs.items():
        mux.add_job(job, ecfg)
    stats = FleetReplayer(mux).replay_dir(
        str(directory), job_workers=job_workers, worker_kind=worker_kind)
    stream = mux.finalize()
    counter = mux.telemetry.counter
    return dict(
        stream=stream_rows(stream), stats=stats_signature(stats),
        worker_kind=stats.worker_kind, job_workers=stats.job_workers,
        late_rows={j.job_id: j.late_events for j in mux.jobs},
        forced_closes={j.job_id: counter("fleet.forced_closes",
                                         job=j.job_id).value
                       for j in mux.jobs},
        seconds=stats.seconds)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("directory")
    ap.add_argument("--history", required=True)
    ap.add_argument("--spec", required=True)
    ap.add_argument("--job-workers", type=int, default=1)
    ap.add_argument("--worker-kind", default="thread",
                    choices=("thread", "process"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    out = replay(args.directory, args.history, args.spec, args.job_workers,
                 args.worker_kind)
    out["torch_imported"] = "torch" in sys.modules
    print(json.dumps(out))


if __name__ == "__main__":
    main()
