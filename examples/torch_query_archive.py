"""The on-call workflow against a recorded fleet: query, don't replay.

Records a 3-job fleet (job-a healthy, job-b with two GPUs underclocked
from step 40, job-c with GC stalls) to rotated FCS v3 segments — the
stats-directory format a production daemon spill would leave behind —
then answers the questions an on-call engineer actually asks, through
``TraceArchive``:

  1. "How did job-b's throughput move?"  ``query_metrics`` off cached
     per-step rollups (warm queries never touch the trace bytes).
  2. "WHICH ranks regressed after step 40?"  Compare per-rank FLOPS
     rollups before/after the onset — the culprits fall out as the
     ranks whose compute rate dropped the most.
  3. "Show me the raw events for one culprit in the bad window."
     ``query_events`` pushes the (step-range, rank) predicate into the
     v3 stats directory and decodes only the segments that can match.
  4. "How's the fleet?"  ``fleet_weather`` + anomaly counts by team,
     and the pipeline's own telemetry exported next to the traces.

    PYTHONPATH=src python examples/torch_query_archive.py --ranks 32

The port's counterpart of ``examples/query_archive.py``: the same
arguments and output, numpy only, importing nothing but ``repro_torch``;
the simulated program takes the H100's ceilings (``program_from_config``).
"""
import argparse
import json
import os
import tempfile

from repro_torch import store
from repro_torch.archive import TraceArchive, format_fleet_weather
from repro_torch.configs import get_config
from repro_torch.core.engine import DiagnosticEngine, EngineConfig
from repro_torch.core.history import HistoryStore
from repro_torch.core.timeline import (ClusterSimulator, Injection,
                                       program_from_config)

ONSET = 40          # job-b's bad GPUs kick in here
CULPRITS = (5, 11)


def record_fleet(logdir: str, prog, num_ranks: int, steps: int) -> None:
    """One rotated .fcs3 stream per job, one segment per step — the
    shape a size-rotating daemon spill converges to."""
    jobs = {
        "job-a": [],
        "job-b": [Injection(kind="underclock", ranks=CULPRITS, factor=2.6,
                            start_step=ONSET)],
        "job-c": [Injection(kind="gc", duration=0.03, period_ops=6)],
    }
    for i, (job_id, inj) in enumerate(jobs.items()):
        batch = ClusterSimulator(num_ranks, prog, seed=31 + i,
                                 injections=inj).run_batch(steps)
        w = store.SegmentedTraceWriter(
            os.path.join(logdir, f"{job_id}.fcs3"), codec="fcs3",
            rotate_bytes=96 << 10)
        order, uniq, bounds = batch.step_index()
        for j in range(uniq.size):
            w.write(batch.take(order[bounds[j]:bounds[j + 1]]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=32)
    ap.add_argument("--steps", type=int, default=48)
    args = ap.parse_args()
    N, steps = args.ranks, max(args.steps, ONSET + 4)

    cfg = get_config("llama-20b-paper")
    prog = program_from_config(cfg, num_chips=N, layer_groups=6)
    hist = HistoryStore()
    learn = DiagnosticEngine(
        EngineConfig(backend="dense-train", num_ranks=N), hist)
    print(f"learning healthy profile from 2 runs x {N} ranks ...")
    for seed in range(2):
        learn.ingest_batch(ClusterSimulator(N, prog, seed=seed).run_batch(3))
    learn.learn_healthy()

    with tempfile.TemporaryDirectory() as logdir:
        print(f"recording 3 jobs x {N} ranks x {steps} steps "
              f"to rotated FCS v3 segments ...")
        record_fleet(logdir, prog, N, steps)
        files = sorted(os.listdir(logdir))
        print(f"  {len(files)} files, e.g. {files[:3]}")

        ar = TraceArchive(logdir, history=hist,
                          engine_config=EngineConfig(
                              backend="dense-train", num_ranks=N))

        # 1. throughput curve around the onset, off cached rollups
        print(f"\n=== job-b throughput (tok/s), steps {ONSET - 3}"
              f"..{ONSET + 3} ===")
        for s, thr in ar.query_metrics(
                "job-b", step_range=(ONSET - 3, ONSET + 3)):
            bar = "#" * int(thr / 2000)
            print(f"  step {s:>3}  {thr:>10.0f}  {bar}")

        # 2. which ranks regressed after step 40?  per-rank FLOPS
        # rollups, after-vs-before ratio, worst first
        before = dict(ar.query_metrics("job-b", step_range=(0, ONSET - 1),
                                       metric="rank_flops", bucket=ONSET))
        after = dict(ar.query_metrics("job-b",
                                      step_range=(ONSET, steps - 1),
                                      metric="rank_flops", bucket=steps))
        b, a = next(iter(before.values())), next(iter(after.values()))
        ratios = sorted(((a[r] / b[r], r) for r in a if b.get(r)),
                        key=lambda t: t[0])
        print(f"\n=== job-b per-rank FLOPS, after/before step {ONSET} ===")
        for ratio, r in ratios[:4]:
            tag = "  <-- regressed" if ratio < 0.7 else ""
            print(f"  rank {r:>3}  {ratio:5.2f}x{tag}")
        flagged = tuple(sorted(r for ratio, r in ratios if ratio < 0.7))
        print(f"  flagged: {flagged} (injected: {tuple(CULPRITS)})")

        # 3. raw events for one culprit in the bad window — the stats
        # directory prunes the segments that can't match
        batch, scan = ar.query_events(
            "job-b", step_range=(ONSET, ONSET + 3), ranks=[flagged[0]],
            with_scan=True)
        print(f"\n=== raw events: job-b rank {flagged[0]}, steps "
              f"{ONSET}..{ONSET + 3} ===")
        print(f"  {len(batch)} rows; pushdown skipped "
              f"{scan.segments_skipped}/{scan.segments} segments, "
              f"decoded {scan.bytes_decoded >> 10} KiB "
              f"(skipped {scan.bytes_skipped >> 10} KiB)")

        # 4. fleet weather + anomaly routing + self-telemetry
        print("\n=== fleet weather ===")
        print(format_fleet_weather(ar.fleet_weather()))
        crit = ar.query_anomalies(job="job-b")
        print(f"\njob-b anomalies ({len(crit)}), first 3:")
        for fa in crit[:3]:
            print(f"  {fa}")

        path = ar.export_telemetry()
        snap = json.load(open(path))
        interesting = {k: v for k, v in snap["counters"].items()
                       if k.startswith(("archive.", "replay."))}
        print(f"\npipeline telemetry -> {os.path.basename(path)}")
        for k in sorted(interesting):
            print(f"  {k:<42} {interesting[k]}")


if __name__ == "__main__":
    main()
