"""Fault-injection demo: run the labelled scenario matrix on one config
and print the scored verdict table — what fired, whether the fault was
caught, routed to the right team, attributed to the right ranks, and the
resulting per-detector precision/recall.

Also shows the plugin seam end-to-end: registers a custom
``pcie_downgrade`` injector, grades it against a hand-written ground
truth, then unregisters it.

    PYTHONPATH=src python examples/torch_inject_faults.py [--config qwen2-0.5b]

The port's counterpart of ``examples/inject_faults.py``: the same
arguments and output, numpy only, importing nothing but ``repro_torch``;
the simulated programs take the H100's ceilings (``program_from_config``).
"""
import argparse

from repro_torch.core.injectors import (FaultInjector, Injection,
                                        register_injector,
                                        unregister_injector)
from repro_torch.scenarios import (GroundTruth, Scenario,
                                   SCENARIOS_BY_NAME, run_cell, run_matrix,
                                   score_matrix)


def verdict_table(cells):
    head = (f"{'scenario':<24} {'verdict':<8} {'team':>5} {'ranks':>5} "
            f"{'onset':>5}  fired")
    print(head)
    print("-" * len(head))
    for c in cells:
        verdict = "OK" if c.ok else "FAIL"
        if c.healthy:
            verdict = "clean" if c.ok else "NOISY"
        mark = lambda b: "yes" if b else "NO"   # noqa: E731
        print(f"{c.scenario:<24} {verdict:<8} "
              f"{mark(c.team_ok):>5} {mark(c.ranks_ok):>5} "
              f"{mark(c.onset_ok):>5}  {', '.join(c.fired) or '-'}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="qwen2-0.5b")
    args = ap.parse_args()

    print(f"scenario matrix on {args.config!r} "
          f"(every fault labelled with ground truth)\n")
    cells = run_matrix([args.config])
    verdict_table(cells)

    s = score_matrix(cells)
    print(f"\nper-detector precision/recall over {s['cells']} cells "
          f"({s['faulty_cells']} faulty):")
    for key, d in s["detectors"].items():
        print(f"  {key:<32} P={d['precision']:.2f} R={d['recall']:.2f} "
              f"(tp={d['tp']} fp={d['fp']} fn={d['fn']})")
    print(f"  micro P={s['micro_precision']:.2f} "
          f"R={s['micro_recall']:.2f}  missed={s['missed'] or 'none'}")

    # ---- the plugin seam: a fault class this repo never shipped ------- #
    print("\ncustom injector: pcie_downgrade (registered at runtime)")

    @register_injector
    class PcieDowngradeInjector(FaultInjector):
        name = "pcie_downgrade"

        def device_duration(self, sim, op, step, dur):
            if op.kind != "comm" or step < self.inj.start_step:
                return dur
            out = dur.copy()
            out[sim.hit_ranks(self.inj)] *= self.inj.factor
            return out

    scn = Scenario(
        name="pcie_downgrade",
        description="PCIe link drops a generation on two ranks",
        inject=lambda step_s, n: [Injection(
            kind="pcie_downgrade", ranks=(4, 5), factor=4.0,
            start_step=3)],
        truth=GroundTruth(kind="fail_slow", team="operations",
                          expect=("fail_slow:bandwidth",
                                  "fail_slow:throughput",),
                          onset_step=3))
    try:
        c = run_cell(scn, args.config)
        verdict_table([c])
    finally:
        unregister_injector("pcie_downgrade")

    known = SCENARIOS_BY_NAME["gpu_underclock"]
    print(f"\n(compare: {known.name!r} expects {known.truth.expect} "
          f"culprits {known.truth.culprit_ranks})")


if __name__ == "__main__":
    main()
