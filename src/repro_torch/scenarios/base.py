"""Scenario model: a fault + its machine-readable ground truth.

A :class:`Scenario` bundles everything needed to *score* diagnosis, not
just run it: the injections (built per-config, scaled to the program's
healthy step time so one scenario transfers across the model zoo), and a
:class:`GroundTruth` naming the anomaly the detector suite MUST report —
expected detector key(s), team attribution, culprit ranks, onset step.
``truth=None`` marks the healthy baseline: any anomaly at all is a false
positive.

Detector keys are ``"<anomaly.kind>:<anomaly.metric>"`` (e.g.
``"fail_slow:throughput"``, ``"regression:issue_latency"``,
``"hang:intra_kernel_inspecting"``) — :func:`anomaly_key` builds them.

The port's copy of the JAX package's ``scenarios/base.py``: stdlib and
numpy only (no torch), with the reference's names and semantics (its
syntax tree is held to the reference's by
``tests/test_torch_scenarios.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.configs import ModelConfig
from repro_torch.core.anomaly import Anomaly
from repro_torch.core.injectors import Injection


def anomaly_key(a: Anomaly) -> str:
    """The scoring identity of a detector firing."""
    return f"{a.kind}:{a.metric}"


@dataclass(frozen=True)
class GroundTruth:
    """What correct diagnosis looks like for one scenario.

    ``expect`` is any-of: the scenario is *caught* when at least one
    expected key fires.  ``allowed`` keys may legitimately fire alongside
    (secondary symptoms of the same fault) and are not penalized; any
    other key is a false positive against that detector's precision.
    ``team`` must match on an expected-key anomaly (else the catch is a
    mis-attribution); ``culprit_ranks``, when set, must all appear in
    that anomaly's ``ranks``.  ``onset_step`` is the injection onset —
    no matching anomaly may fire before it."""

    kind: str                          # fail_slow | regression | hang
    team: str                          # Team value ("operations", ...)
    expect: tuple[str, ...]            # any-of detector keys
    allowed: tuple[str, ...] = ()      # unpenalized secondary keys
    culprit_ranks: tuple[int, ...] = ()
    onset_step: int = 0


@dataclass(frozen=True)
class Scenario:
    """One parameterized fault case, runnable against any model-zoo
    config.  ``inject(step_s, num_ranks)`` builds the injection list;
    ``step_s`` is the program's healthy per-step device+host seconds, so
    absolute stall durations scale with the model instead of being tuned
    to one architecture.  ``families`` restricts the scenario to config
    families that can express it (e.g. ``moe_straggler`` needs experts);
    ``moe_experts`` asks the program builder for per-expert kernels."""

    name: str
    description: str
    inject: Callable[[float, int], list[Injection]]
    truth: Optional[GroundTruth]       # None = healthy baseline
    steps: int = 10
    seed: int = 7
    families: tuple[str, ...] = ()
    moe_experts: int = 0
    tags: tuple[str, ...] = field(default=())

    def applies_to(self, cfg: ModelConfig) -> bool:
        return not self.families or cfg.family in self.families

    @property
    def healthy(self) -> bool:
        return self.truth is None
