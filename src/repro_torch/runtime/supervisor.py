"""Fault-tolerant supervisor: restart-from-checkpoint and straggler
mitigation driven by FLARE diagnoses.

On a real fleet this process runs alongside the job scheduler: FLARE routes
(hang -> isolate machines -> restart; fail-slow underclock -> drain host).
Here the control loop is identical; machine actions are pluggable (the
cluster simulator implements them for tests/benchmarks, logging what a
scheduler would do).  The port's copy of the JAX package's
``runtime/supervisor.py``, driving ``repro_torch.runtime.train.Trainer``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

from repro_torch.core.anomaly import Anomaly, Team


class SimulatedFault(RuntimeError):
    """Raised by fault hooks to simulate a mid-training crash."""


@dataclass
class ClusterAction:
    kind: str            # isolate | drain | restart | rescale
    ranks: list = field(default_factory=list)
    note: str = ""
    ts: float = field(default_factory=time.time)


@dataclass
class Supervisor:
    max_restarts: int = 3
    actions: list = field(default_factory=list)
    restarts: int = 0

    # ------------------------------------------------------------------ #
    def run(self, make_trainer: Callable[[], "object"],
            steps: int) -> list[dict]:
        """Run training with restart-on-fault.  `make_trainer()` must build
        a fresh Trainer that restores from the shared checkpoint dir."""
        history: list[dict] = []
        while True:
            trainer = make_trainer()
            try:
                history.extend(trainer.train(steps))
                return history
            except SimulatedFault as e:
                # keep the partial progress made before the crash — the
                # checkpoint already persisted it, this is just bookkeeping
                history.extend(trainer.history)
                self.restarts += 1
                self.actions.append(ClusterAction(
                    kind="restart", note=f"fault: {e}; restoring from "
                    "latest checkpoint"))
                if self.restarts > self.max_restarts:
                    raise RuntimeError(
                        f"exceeded {self.max_restarts} restarts") from e

    # ------------------------------------------------------------------ #
    def apply_diagnosis(self, anomalies: list[Anomaly]) -> list[ClusterAction]:
        """Translate FLARE anomalies into cluster actions (ops runbook)."""
        out = []
        for a in anomalies:
            if a.team != Team.OPERATIONS:
                continue  # algorithm/infrastructure findings are tickets
            if a.kind == "hang":
                out.append(ClusterAction(
                    kind="isolate", ranks=list(a.ranks),
                    note=f"hang ({a.metric}): {a.root_cause}"))
                out.append(ClusterAction(
                    kind="restart", note="restart excluding isolated hosts"))
            elif a.kind == "fail_slow" and a.ranks:
                out.append(ClusterAction(
                    kind="drain", ranks=list(a.ranks),
                    note=f"straggler mitigation: {a.root_cause}"))
            elif a.kind == "fail_slow":
                out.append(ClusterAction(
                    kind="rescale", note="network fail-slow: reroute/probe "
                    "per attached binary-search plan"))
        self.actions.extend(out)
        return out
