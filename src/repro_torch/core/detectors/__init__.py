"""Pluggable anomaly detectors — the diagnosis extension seam.

The engine does not hardcode its checks: ``EngineConfig.detectors`` is a
list of registry names / :class:`DetectorSpec`s resolved through
:func:`resolve_detectors`, and ``evaluate_all`` / the fleet's incremental
path simply drive every resolved plugin's lifecycle.  The paper's five
checks (plus hang analysis) are themselves registered plugins
(``builtins.py``); adding a sixth anomaly class is a new class + one
``@register_detector``, never an engine edit.  See ``README.md`` in the
JAX package's detectors package for the contract and a worked
third-party example.

Two scopes:

  * ``"job"`` — stateful per-job detectors bound to one
    :class:`DetectorContext`, observing one job's ``StepMetrics`` stream
    (``base.py``, ``builtins.py``);
  * ``"fleet"`` — cross-job detectors bound to a :class:`FleetContext`,
    observing every job's anomalies + rack/switch topology through the
    multiplexer (``fleet.py``) — e.g. :class:`CrossJobFailSlowCorrelator`
    reclassifies co-occurring fail-slows on shared hardware as
    INFRASTRUCTURE.

The port's copy of the JAX package's ``core/detectors/__init__.py``: numpy
only (no torch), with the reference's names, thresholds and arithmetic.
"""
from repro_torch.core.detectors.base import (  # noqa: F401
    Detector, DetectorContext, DetectorSpec)
from repro_torch.core.detectors.builtins import (  # noqa: F401
    BandwidthDetector, FailSlowDetector, FlopsDetector, HangAnalysisDetector,
    IssueLatencyDetector, RegressionDetector, VoidsDetector)
from repro_torch.core.detectors.fleet import (  # noqa: F401
    CrossJobFailSlowCorrelator, FleetContext, FleetDetector)
from repro_torch.core.detectors.registry import (  # noqa: F401
    DEFAULT_DETECTORS, DetectorError, DuplicateDetectorError,
    UnknownDetectorError, detector_names, get_detector, register_detector,
    resolve_detectors, unregister_detector)

__all__ = [
    "Detector", "DetectorContext", "DetectorSpec",
    "FleetDetector", "FleetContext", "CrossJobFailSlowCorrelator",
    "RegressionDetector", "FailSlowDetector", "IssueLatencyDetector",
    "VoidsDetector", "FlopsDetector", "BandwidthDetector",
    "HangAnalysisDetector",
    "DEFAULT_DETECTORS", "register_detector", "unregister_detector",
    "resolve_detectors", "get_detector", "detector_names",
    "DetectorError", "UnknownDetectorError", "DuplicateDetectorError",
]
