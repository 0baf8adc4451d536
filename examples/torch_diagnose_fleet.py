"""FLARE as a fleet service: N concurrent jobs, diagnosed while they run.

Simulates a cluster operating several training jobs at once — some
healthy, some with injected anomalies (GC stalls, an underclocked GPU,
a misaligned kernel, network jitter, a communication hang) — and streams
their per-step event chunks round-robin into a ``FleetMultiplexer``.
Anomalies surface incrementally with job tags and team routing as each
job's watermark closes steps; the hung job is diagnosed the moment a
majority of its daemons report.

The fleet-scope detector tier is on: every job is placed on a rack
(``mux.set_topology``) and the registered ``cross_job_failslow``
correlator watches the merged stream — the two jitter-afflicted jobs
sharing rack0 are reclassified from per-job operations findings to a
shared-rack INFRASTRUCTURE diagnosis (``origin="fleet"`` lines).

    PYTHONPATH=src python examples/torch_diagnose_fleet.py --jobs 6 --ranks 128

The port's counterpart of ``examples/diagnose_fleet.py``: the same
arguments and output, numpy only, importing nothing but ``repro_torch``;
the simulated program takes the H100's ceilings (``program_from_config``).
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.core.engine import DiagnosticEngine, EngineConfig
from repro_torch.core.history import HistoryStore
from repro_torch.core.timeline import (ClusterSimulator, Injection,
                                       program_from_config)
from repro_torch.fleet import FleetConfig, FleetMultiplexer


def job_scenarios(n_jobs: int, num_ranks: int):
    """Cycle through the paper's anomaly classes across the fleet.  The
    first two slots are network jitter ON THE SAME RACK — the cross-job
    correlator's bread and butter."""
    jitter = [Injection(kind="network_jitter", factor=3.0, start_step=3)]
    templates = [
        ("net-jitter", jitter),
        ("net-jitter", jitter),
        ("healthy", []),
        ("gc-stalls", [Injection(kind="gc", duration=0.05, period_ops=4)]),
        ("underclock", [Injection(kind="underclock",
                                  ranks=(137 % num_ranks,), factor=2.4,
                                  start_step=3)]),
        ("misaligned-ffn", [Injection(kind="slow_compute",
                                      op_match="ffn_matmul", factor=2.9)]),
        ("comm-hang", [Injection(kind="hang", ranks=(611 % num_ranks,),
                                 at_step=2)]),
    ]
    return [(f"job-{i}-{templates[i % len(templates)][0]}",
             templates[i % len(templates)][1]) for i in range(n_jobs)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--ranks", type=int, default=128)
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    N = args.ranks

    cfg = get_config("llama-20b-paper")
    prog = program_from_config(cfg, num_chips=N, layer_groups=6)
    store = HistoryStore()
    learn = DiagnosticEngine(
        EngineConfig(backend="dense-train", num_ranks=N), store)
    print(f"learning healthy profile from 2 runs x {N} ranks ...")
    for seed in range(2):
        learn.ingest_batch(ClusterSimulator(N, prog, seed=seed).run_batch(3))
    learn.learn_healthy()

    shapes = {f"ffn_matmul[{g}]": (8192, 8484) for g in range(6)}
    # fleet-scope tier: the cross-job fail-slow correlator, resolved by
    # registry name exactly like the per-job detector set
    mux = FleetMultiplexer(FleetConfig(
        watermark_delay=1, fleet_detectors=["cross_job_failslow"]),
        history=store)

    # run every job's simulator, pre-split into per-step chunks (each chunk
    # stands in for one drain of that job's daemons)
    chunks = {}
    for i, (job_id, inj) in enumerate(job_scenarios(args.jobs, N)):
        mux.add_job(job_id, EngineConfig(backend="dense-train", num_ranks=N,
                                         kernel_shapes=shapes))
        # placement: jobs 0 and 1 (both jittery) share rack0
        mux.set_topology(job_id, rack="rack0" if i < 2 else f"rack{i}",
                         switch=f"sw{i // 2}")
        batch = ClusterSimulator(N, prog, seed=77,
                                 injections=inj).run_batch(args.steps)
        order, uniq, bounds = batch.step_index()
        chunks[job_id] = [batch.take(order[bounds[i]:bounds[i + 1]])
                          for i in range(uniq.size)]

    print(f"streaming {args.jobs} jobs x {N} ranks, round-robin per step\n")
    round_no = 0
    while any(chunks.values()):
        for job_id, pending in chunks.items():
            if pending:
                mux.ingest(job_id, pending.pop(0))
        round_no += 1
        for fa in mux.poll():
            print(f"  r{round_no:02d} {fa}")
    for fa in mux.finalize():
        print(f"  fin {fa}")

    print("\n=== fleet summary ===")
    total_ev = 0
    for job_id, st in mux.stats().items():
        total_ev += st["events"]
        flag = "HANG" if st["hang_reported"] else \
            f"{st['anomalies']} anomalies"
        print(f"  {job_id:26s} {st['events']:>9d} ev  "
              f"{st['steps_evaluated']} steps  {flag}")
    print(f"  fleet total: {total_ev} events, "
          f"{len(mux.interner.names)} shared interned names")


if __name__ == "__main__":
    main()
