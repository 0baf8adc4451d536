"""FLARE at scale: diagnose anomalies on a 1024-rank simulated cluster.

Learns a healthy profile, then runs four unhealthy jobs (GC stalls, a
straggler GPU, a misaligned kernel, and a communication hang at rank 611)
and prints FLARE's routed diagnosis plus the ops-team runbook actions.

    PYTHONPATH=src python examples/torch_diagnose_cluster_sim.py --ranks 1024

The port's counterpart of ``examples/diagnose_cluster_sim.py``: the same
arguments and output, numpy only, importing nothing but ``repro_torch``;
the simulated program takes the H100's ceilings (``program_from_config``).
``chip_smoke.py``'s ``simulate`` phase calls ``program``,
``learn_profile``, ``jobs``, ``simulate_job`` and ``diagnose_job``.
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.core.engine import DiagnosticEngine, EngineConfig
from repro_torch.core.history import HistoryStore
from repro_torch.core.inspecting import inspect_cost_model, probe_search_cost
from repro_torch.core.report import anomaly_report
from repro_torch.core.timeline import (ClusterSimulator, Injection,
                                       program_from_config)
from repro_torch.runtime.supervisor import Supervisor

ARCH = "llama-20b-paper"
LAYER_GROUPS = 6
PROFILE_RUNS, PROFILE_STEPS = 2, 3
JOB_SEED, JOB_STEPS = 77, 6


def program(num_ranks: int):
    """The per-rank op program of ``ARCH`` over ``num_ranks`` chips."""
    return program_from_config(get_config(ARCH), num_chips=num_ranks,
                               layer_groups=LAYER_GROUPS)


def learn_profile(prog, num_ranks: int, store: HistoryStore):
    """The healthy profile of ``PROFILE_RUNS`` clean simulations, learned
    into ``store``."""
    learn = DiagnosticEngine(EngineConfig(backend="dense-train",
                                          num_ranks=num_ranks), store)
    for seed in range(PROFILE_RUNS):
        learn.ingest_batch(ClusterSimulator(num_ranks, prog, seed=seed)
                           .run_batch(PROFILE_STEPS))
    return learn.learn_healthy()


def jobs(num_ranks: int) -> list:
    """The four unhealthy jobs: (name, injections)."""
    N = num_ranks
    return [
        ("job-1: python GC stalls",
         [Injection(kind="gc", duration=0.3, period_ops=4)]),
        ("job-2: straggler GPU (underclocked)",
         [Injection(kind="underclock", ranks=(137 % N,), factor=2.4,
                    start_step=3)]),
        ("job-3: misaligned FFN after backend migration",
         [Injection(kind="slow_compute", op_match="ffn_matmul",
                    factor=2.9)]),
        ("job-4: comm hang at rank 611",
         [Injection(kind="hang", ranks=(611 % N,), at_step=2)]),
    ]


def simulate_job(prog, num_ranks: int, inj) -> tuple:
    """One job simulated: (the simulator, its ``EventBatch``)."""
    sim = ClusterSimulator(num_ranks, prog, seed=JOB_SEED, injections=inj)
    return sim, sim.run_batch(JOB_STEPS)


def diagnose_job(num_ranks: int, store: HistoryStore, sim, batch) -> list:
    """One simulated job diagnosed: its anomalies (the hang's diagnosis
    where the simulator hung)."""
    shapes = {f"ffn_matmul[{g}]": (8192, 8484) for g in range(LAYER_GROUPS)}
    eng = DiagnosticEngine(EngineConfig(
        backend="dense-train", num_ranks=num_ranks, kernel_shapes=shapes),
        store)
    eng.ingest_batch(batch)
    if sim.hang:
        return [eng.diagnose_hang(sim.hang.stacks, sim.hang.ring_progress)]
    return eng.evaluate_all()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=1024)
    args = ap.parse_args()
    N = args.ranks

    prog = program(N)
    store = HistoryStore()
    print(f"learning healthy profile from 2 runs x {N} ranks ...")
    prof = learn_profile(prog, N, store)
    print(f"  W1 threshold={prof.issue_w1_threshold:.4f}  "
          f"V_inter thr={prof.v_inter_threshold:.3f}  "
          f"V_minority thr={prof.v_minority_threshold:.3f}\n")

    sup = Supervisor()
    for name, inj in jobs(N):
        sim, batch = simulate_job(prog, N, inj)
        anomalies = diagnose_job(N, store, sim, batch)
        print(f"=== {name} ===")
        if sim.hang:
            print(f"  O(1) inspection: {inspect_cost_model(N):.0f}s vs "
                  f"NCCL-test sweep: {probe_search_cost(N) / 60:.0f}min")
        print(anomaly_report(anomalies))
        actions = sup.apply_diagnosis(anomalies)
        for a in actions:
            print(f"  -> cluster action: {a.kind} {a.ranks} ({a.note})")
        print()


if __name__ == "__main__":
    main()
