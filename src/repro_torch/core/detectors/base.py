"""Detector protocol + per-job binding context.

A :class:`Detector` is a *stateful, per-job* plugin: the engine creates a
fresh instance per job (via the registry), binds it once to the job's
:class:`DetectorContext`, then feeds it every closed step's
:class:`~repro_torch.core.metrics.StepMetrics` in ascending step order.  State
(rolling baselines, debounce counters) lives on the instance, which is
what makes streaming diagnosis equal terminal diagnosis: the fleet path
and ``evaluate_all`` advance the same objects through the same calls.

Lifecycle::

    d = DetectorClass(**options)      # from the registry / a DetectorSpec
    d.bind(ctx)                       # once, before any step
    d.observe_step(m, step)           # per closed step, ascending
    d.on_hang(stacks, ring_progress)  # when a majority of daemons report
    d.finalize()                      # once, at end of stream

``observe_step``/``finalize`` return ``list[Anomaly]``; ``on_hang``
returns one ``Anomaly`` or ``None``.  Detectors must not mutate the
metrics object or the context (except detector-private attributes).

Fleet-scope detectors (cross-job correlation) live in
``repro_torch.core.detectors.fleet`` and use ``scope = "fleet"``.

The port's copy of the JAX package's ``core/detectors/base.py``: numpy
only (no torch), with the reference's names, thresholds and arithmetic.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.anomaly import Anomaly


@dataclass
class DetectorContext:
    """What a bound detector may read about its job.

    ``config`` is the job's ``EngineConfig`` (thresholds, rank count,
    kernel shapes).  ``profile`` looks up the learned healthy profile for
    the job's backend/scale *at call time* — profiles may be learned after
    the detector was bound, so do not cache it across steps.  ``baseline``
    is the metrics of the job's FIRST evaluated step (the engine sets it
    before any detector observes that step); ``None`` until then.
    """
    config: object                   # EngineConfig (duck-typed: no import cycle)
    history: object                  # HistoryStore
    baseline: Optional[object] = None   # StepMetrics of the first step

    @property
    def profile(self):
        return self.history.get(self.config.backend, self.config.num_ranks)


@dataclass(frozen=True)
class DetectorSpec:
    """A registry name plus constructor options — the config-file-friendly
    way to parameterize a detector in ``EngineConfig.detectors``."""
    name: str
    options: dict = field(default_factory=dict)


class Detector:
    """Base class for per-job detectors.  Subclass, set ``name`` (the
    registry key) and ``kind`` (the anomaly kind it emits), override the
    lifecycle hooks you need, and register with ``@register_detector``."""

    name: str = ""
    kind: str = ""                   # "fail_slow" | "regression" | "hang" | ...
    scope: str = "job"

    def bind(self, ctx: DetectorContext) -> None:
        self.ctx = ctx

    def state_dict(self) -> dict:
        """Picklable instance state for service checkpoints: everything
        on the instance except the bound context (which the restoring
        engine re-binds).  Detectors holding unpicklable state must
        override this pair."""
        return {k: v for k, v in self.__dict__.items() if k != "ctx"}

    def load_state(self, state: dict) -> None:
        """Inverse of :meth:`state_dict`; call after :meth:`bind`."""
        self.__dict__.update(state)

    def observe_step(self, m, step: int) -> list[Anomaly]:
        return []

    def on_hang(self, stacks: dict, ring_progress=None) -> Optional[Anomaly]:
        return None

    def finalize(self) -> list[Anomaly]:
        return []
