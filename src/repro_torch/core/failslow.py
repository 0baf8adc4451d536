"""Fail-slow detection (macro metric ①) + root-cause attribution (§5.2.3).

Fail-slows are *sudden* throughput drops vs earlier steps of the SAME job.
Detection: robust rolling baseline (median + MAD) over a trailing window.
Attribution: per-rank FLOPS outliers => GPU underclocking (route the
machine); per-group bandwidth drops => network (jitter / congestion), with
a binary-search probe plan over the group's links.

The port's copy of the JAX package's ``core/failslow.py``: numpy
only (no torch), with the reference's names, thresholds and arithmetic.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.metrics import StepMetrics


@dataclass
class FailSlowFinding:
    step: int
    drop_frac: float
    cause: str               # "gpu_underclock" | "network" | "unknown"
    ranks: list = field(default_factory=list)
    probe_plan: list = field(default_factory=list)
    evidence: dict = field(default_factory=dict)


class ThroughputMonitor:
    def __init__(self, window: int = 8, drop_threshold: float = 0.12):
        self.window = window
        self.drop_threshold = drop_threshold
        self.history: list[float] = []

    def observe(self, throughput: float) -> Optional[float]:
        """Returns drop fraction if this step is a sudden slowdown."""
        out = None
        if len(self.history) >= max(self.window // 2, 3):
            base = float(np.median(self.history[-self.window:]))
            if base > 0 and throughput < base * (1 - self.drop_threshold):
                out = 1.0 - throughput / base
        if out is None:
            # only healthy-looking steps update the baseline
            self.history.append(throughput)
        return out


def attribute_failslow(m: StepMetrics, baseline: StepMetrics,
                       step: int, drop: float) -> FailSlowFinding:
    # ---- per-rank FLOPS outliers -> GPU underclocking ------------------ #
    slow_ranks: set[int] = set()
    for name, per_rank in m.flops.items():
        base = baseline.flops.get(name)
        if not base:
            continue
        base_med = float(np.median(list(base.values())))
        if base_med <= 0:
            continue
        for r, f in per_rank.items():
            if f < 0.75 * base_med:
                slow_ranks.add(r)
    if slow_ranks and len(slow_ranks) < max(m.num_ranks // 4, 1):
        return FailSlowFinding(
            step=step, drop_frac=drop, cause="gpu_underclock",
            ranks=sorted(slow_ranks),
            evidence={"flops_outlier_ranks": sorted(slow_ranks)})

    # ---- bandwidth drop -> network --------------------------------------#
    slow_groups = []
    for name, bw in m.bandwidth.items():
        base = baseline.bandwidth.get(name)
        if base and bw < 0.75 * base:
            slow_groups.append((name, bw / base))
    if slow_groups:
        plan = binary_search_plan(m.num_ranks)
        return FailSlowFinding(
            step=step, drop_frac=drop, cause="network",
            probe_plan=plan,
            evidence={"slow_groups": slow_groups})
    return FailSlowFinding(step=step, drop_frac=drop, cause="unknown",
                           evidence={})


def binary_search_plan(num_ranks: int) -> list:
    """Bisection probe plan over the ring (paper: 'communication test using
    binary search to pinpoint machines')."""
    plan, lo, hi = [], 0, num_ranks
    while hi - lo > 2:
        mid = (lo + hi) // 2
        plan.append({"test_ranks": (lo, mid), "then": (mid, hi)})
        hi = mid
    plan.append({"test_ranks": (lo, hi), "then": None})
    return plan
