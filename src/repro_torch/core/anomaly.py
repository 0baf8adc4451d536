"""Anomaly record + team routing targets (paper Table 1): the port's copy
of the JAX package's ``core/anomaly.py``, which the supervisor takes its
diagnoses in.  The port's diagnostic engine (``core/engine.py``, its
detectors in ``core/detectors/``) emits these; ``core/engine.py``
re-exports both names, as the reference's does.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field


class Team(str, enum.Enum):
    OPERATIONS = "operations"
    ALGORITHM = "algorithm"
    INFRASTRUCTURE = "infrastructure"
    CROSS_TEAM = "cross-team"


@dataclass
class Anomaly:
    kind: str            # hang | fail_slow | regression
    metric: str          # detector that fired
    team: Team
    root_cause: str
    step: int = -1
    severity: float = 1.0
    ranks: list = field(default_factory=list)
    evidence: dict = field(default_factory=dict)

    def __str__(self):
        return (f"[{self.kind}/{self.metric}] -> {self.team.value}: "
                f"{self.root_cause} (step {self.step}, "
                f"severity {self.severity:.2f})")
