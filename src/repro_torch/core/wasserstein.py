"""Wasserstein-1 distance over empirical samples + healthy-profile thresholds.

The paper (§5.2.2) learns healthy issue-latency distributions per
(backend, scale) and uses the **maximum pairwise W1 distance between
healthy runs** as the alarm threshold.  W1 between empirical distributions
with equal sample weights reduces to the mean absolute difference of the
sorted samples (quantile coupling); for unequal sizes we integrate
|CDF1 - CDF2| exactly over the merged support.

The port's copy of the JAX package's ``core/wasserstein.py``: numpy
only (no torch), with the reference's names, thresholds and arithmetic.
"""
from __future__ import annotations

import numpy as np


def w1_distance(a, b) -> float:
    return w1_distance_sorted(np.sort(np.asarray(a, np.float64)),
                              np.sort(np.asarray(b, np.float64)))


def w1_distance_sorted(a: np.ndarray, b: np.ndarray) -> float:
    """``w1_distance`` for ALREADY-SORTED float64 samples.  The healthy
    reference distribution is fixed per profile, so the per-step detector
    sorts only the current step's samples and reuses the cached sorted
    reference (identical result to ``w1_distance``)."""
    if a.size == 0 or b.size == 0:
        return float("inf") if a.size != b.size else 0.0
    if a.size == b.size:
        return float(np.mean(np.abs(a - b)))
    # exact integral of |F_a - F_b| over merged support
    allv = np.concatenate([a, b])
    allv.sort(kind="mergesort")
    deltas = np.diff(allv)
    ca = np.searchsorted(a, allv[:-1], side="right") / a.size
    cb = np.searchsorted(b, allv[:-1], side="right") / b.size
    return float(np.sum(np.abs(ca - cb) * deltas))


def normalized_w1(a, b) -> float:
    """W1 scaled by the healthy distribution's mean (scale invariance across
    cluster sizes / model sizes)."""
    b = np.asarray(b, np.float64)
    scale = max(float(np.mean(b)), 1e-12)
    return w1_distance(a, b) / scale


def healthy_threshold(healthy_runs: list, margin: float = 1.5) -> float:
    """max pairwise (normalized) W1 among healthy runs, x safety margin."""
    if len(healthy_runs) < 2:
        return 0.25 * margin
    worst = 0.0
    for i in range(len(healthy_runs)):
        for j in range(i + 1, len(healthy_runs)):
            worst = max(worst, normalized_w1(healthy_runs[i],
                                             healthy_runs[j]))
    return worst * margin
