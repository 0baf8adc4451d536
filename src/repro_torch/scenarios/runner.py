"""Matrix runner + scorer: scenarios x model-zoo configs -> P/R per detector.

One *cell* = one scenario run against one config: learn a healthy profile
for that config (clean sims), run the injected sim, diagnose, and grade
the anomalies against the scenario's :class:`GroundTruth`.  The scorer
folds cells into per-detector precision/recall:

  * TP  — an expected key fired on a faulty cell
  * FN  — no expected key fired (charged to ``expect[0]``)
  * FP  — a key fired that is neither expected nor allowed; on a healthy
          cell EVERY firing is a false positive

A cell also grades *attribution*: team routing, culprit-rank coverage and
onset ordering on the catching anomaly.  ``chip_smoke.py``'s
``simulate`` phase asserts hard floors over these results
(``SCENARIO_FLOORS``, copied from ``benchmarks/scenarios.py``).

The port's copy of the JAX package's ``scenarios/runner.py``: numpy only
(no torch), on the port's ``get_config``, ``DiagnosticEngine`` and
``HistoryStore``, with the reference's names and semantics (its syntax
tree is held to the reference's by ``tests/test_torch_scenarios.py``).
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

from repro_torch.configs import get_config
from repro_torch.core.engine import DiagnosticEngine, EngineConfig
from repro_torch.core.history import HistoryStore
from repro_torch.core.timeline import ClusterSimulator, program_from_config
from repro_torch.scenarios.base import Scenario, anomaly_key
from repro_torch.scenarios.library import SCENARIOS_BY_NAME, scenarios_for

DEFAULT_NUM_RANKS = 32
PROFILE_SEEDS = 3
PROFILE_STEPS = 4


@dataclass(frozen=True)
class CellResult:
    """Graded outcome of one (scenario, config) cell."""

    scenario: str
    config: str
    healthy: bool
    fired: tuple[str, ...]       # distinct detector keys, first-fire order
    false_keys: tuple[str, ...]  # fired but neither expected nor allowed
    caught: bool                 # an expected key fired (healthy: True)
    team_ok: bool                # catching anomaly routed to truth.team
    ranks_ok: bool               # culprit ranks covered by its ``ranks``
    onset_ok: bool               # nothing expected fired before onset
    first_step: int              # step of first expected firing (-1: none)
    anomalies: int

    @property
    def ok(self) -> bool:
        if self.healthy:
            return self.anomalies == 0
        return (self.caught and self.team_ok and self.ranks_ok
                and self.onset_ok)


def run_cell(scn: Scenario, config_name: str,
             num_ranks: int = DEFAULT_NUM_RANKS) -> CellResult:
    """Run one scenario against one model-zoo config and grade it."""
    cfg = get_config(config_name)
    prog = program_from_config(cfg, num_chips=num_ranks,
                               moe_experts=scn.moe_experts)
    step_s = float(sum(op.duration for op in prog))

    store = HistoryStore()
    learner = DiagnosticEngine(
        EngineConfig(backend="dense-train", num_ranks=num_ranks), store)
    for seed in range(PROFILE_SEEDS):
        sim = ClusterSimulator(num_ranks, prog, seed=seed)
        learner.ingest_all(sim.run(PROFILE_STEPS))
    learner.learn_healthy()

    eng = DiagnosticEngine(
        EngineConfig(backend="dense-train", num_ranks=num_ranks), store)
    sim = ClusterSimulator(num_ranks, prog, seed=scn.seed,
                           injections=scn.inject(step_s, num_ranks))
    eng.ingest_all(sim.run(scn.steps))
    if sim.hang:
        anomalies = [eng.diagnose_hang(sim.hang.stacks,
                                       sim.hang.ring_progress)]
        anomalies = [a for a in anomalies if a is not None]
    else:
        anomalies = eng.evaluate_all()

    return _grade(scn, config_name, anomalies)


def _grade(scn: Scenario, config_name: str, anomalies) -> CellResult:
    fired: list[str] = []
    for a in anomalies:
        k = anomaly_key(a)
        if k not in fired:
            fired.append(k)

    t = scn.truth
    if t is None:
        return CellResult(
            scenario=scn.name, config=config_name, healthy=True,
            fired=tuple(fired), false_keys=tuple(fired), caught=True,
            team_ok=True, ranks_ok=True, onset_ok=True, first_step=-1,
            anomalies=len(anomalies))

    matching = [a for a in anomalies if anomaly_key(a) in t.expect]
    caught = bool(matching)
    team_ok = any(a.team.value == t.team for a in matching)
    ranks_ok = (not t.culprit_ranks) or any(
        all(r in a.ranks for r in t.culprit_ranks) for a in matching)
    # hang anomalies carry step=-1 (diagnosed post-mortem, not per-step)
    onset_ok = not any(0 <= a.step < t.onset_step for a in matching)
    steps = [a.step for a in matching if a.step >= 0]
    first_step = min(steps) if steps else -1
    ok_keys = set(t.expect) | set(t.allowed)
    false_keys = tuple(k for k in fired if k not in ok_keys)
    return CellResult(
        scenario=scn.name, config=config_name, healthy=False,
        fired=tuple(fired), false_keys=false_keys, caught=caught,
        team_ok=team_ok, ranks_ok=ranks_ok, onset_ok=onset_ok,
        first_step=first_step, anomalies=len(anomalies))


def run_matrix(config_names: list[str],
               num_ranks: int = DEFAULT_NUM_RANKS,
               scenario_names=None) -> list[CellResult]:
    """Sweep applicable scenarios over ``config_names`` (skips cells whose
    scenario doesn't apply to the config, e.g. MoE-only faults)."""
    cells = []
    for config_name in config_names:
        cfg = get_config(config_name)
        for scn in scenarios_for(cfg):
            if scenario_names and scn.name not in scenario_names:
                continue
            cells.append(run_cell(scn, config_name, num_ranks=num_ranks))
    return cells


def score_matrix(cells: list[CellResult]) -> dict:
    """Per-detector precision/recall + matrix-level attribution summary."""
    det: dict[str, dict[str, int]] = defaultdict(
        lambda: {"tp": 0, "fp": 0, "fn": 0})
    missed, misrouted, false_cells = [], [], []
    for c in cells:
        cell_id = f"{c.scenario}@{c.config}"
        if c.healthy:
            for k in c.false_keys:
                det[k]["fp"] += 1
            if c.false_keys:
                false_cells.append(cell_id)
            continue
        t = SCENARIOS_BY_NAME[c.scenario].truth
        hit = [k for k in t.expect if k in c.fired]
        for k in hit:
            det[k]["tp"] += 1
        if not hit:
            det[t.expect[0]]["fn"] += 1
            missed.append(cell_id)
        elif not (c.team_ok and c.ranks_ok and c.onset_ok):
            misrouted.append(cell_id)
        for k in c.false_keys:
            det[k]["fp"] += 1
        if c.false_keys:
            false_cells.append(cell_id)

    detectors = {}
    for key in sorted(det):
        s = det[key]
        tp, fp, fn = s["tp"], s["fp"], s["fn"]
        detectors[key] = {
            "tp": tp, "fp": fp, "fn": fn,
            "precision": tp / (tp + fp) if tp + fp else 1.0,
            "recall": tp / (tp + fn) if tp + fn else 1.0,
        }
    tp = sum(s["tp"] for s in det.values())
    fp = sum(s["fp"] for s in det.values())
    fn = sum(s["fn"] for s in det.values())
    return {
        "detectors": detectors,
        "micro_precision": tp / (tp + fp) if tp + fp else 1.0,
        "micro_recall": tp / (tp + fn) if tp + fn else 1.0,
        "cells": len(cells),
        "faulty_cells": sum(1 for c in cells if not c.healthy),
        "missed": missed,
        "misrouted": misrouted,
        "false_positive_cells": sorted(set(false_cells)),
    }
