"""Scenario matrix: labelled fault cases scored against the detectors.

``SCENARIOS`` is the library (legacy paper cases + L4 production faults,
each with machine-readable ground truth); ``run_matrix``/``score_matrix``
sweep them over model-zoo configs and fold results into per-detector
precision/recall.  ``chip_smoke.py``'s ``simulate`` phase holds the
matrix to the floors of the JAX package's ``benchmarks/scenarios.py``.

The port's copy of the JAX package's ``scenarios/__init__.py``: stdlib
and numpy only (no torch), with the reference's names and semantics (its
syntax tree is held to the reference's by
``tests/test_torch_scenarios.py``).
"""
from repro_torch.scenarios.base import (  # noqa: F401
    GroundTruth, Scenario, anomaly_key)
from repro_torch.scenarios.library import (  # noqa: F401
    FAULT_KINDS, SCENARIOS, SCENARIOS_BY_NAME, scenarios_for)
from repro_torch.scenarios.runner import (  # noqa: F401
    DEFAULT_NUM_RANKS, CellResult, run_cell, run_matrix, score_matrix)

__all__ = [
    "GroundTruth", "Scenario", "anomaly_key",
    "SCENARIOS", "SCENARIOS_BY_NAME", "FAULT_KINDS", "scenarios_for",
    "CellResult", "run_cell", "run_matrix", "score_matrix",
    "DEFAULT_NUM_RANKS",
]
