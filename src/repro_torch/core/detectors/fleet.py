"""Fleet-scope detectors: cross-job correlation over the merged stream.

Per-job detectors see one job's metrics; a :class:`FleetDetector` sees
every job's anomalies as their steps close, plus the job -> rack/switch
topology the operator registered with the multiplexer.  That is the seam
for ARGUS-style diagnosis: separating "this job regressed" from "this
machine/network degraded" requires knowing that several *different* jobs
on the *same* hardware went bad at the same time — a question no per-job
engine can answer.

The multiplexer calls ``observe_step(job_id, step, anomalies, ts)`` after
each closed step that produced anomalies (and after a hang, with
``step = -1``); detectors return ``(job_id, Anomaly)`` pairs which the
multiplexer pushes onto the merged stream tagged ``origin="fleet"``.

The port's copy of the JAX package's ``core/detectors/fleet.py``: numpy
only (no torch), with the reference's names, thresholds and arithmetic.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.anomaly import Anomaly, Team
from repro_torch.core.detectors.registry import register_detector


@dataclass
class FleetContext:
    """What a bound fleet detector may read: the shared job -> attrs
    topology dict (``{"rack": ..., "switch": ...}``; live — jobs may be
    annotated after bind) and the fleet config."""
    topology: dict[str, dict] = field(default_factory=dict)
    config: object = None            # FleetConfig (duck-typed)

    def attrs(self, job_id: str) -> dict:
        return self.topology.get(job_id, {})


class FleetDetector:
    """Base class for fleet-scope detectors (registry scope ``"fleet"``)."""

    name: str = ""
    scope: str = "fleet"

    def bind(self, ctx: FleetContext) -> None:
        self.ctx = ctx

    def state_dict(self) -> dict:
        """Picklable instance state for service checkpoints (the bound
        context is excluded; the restoring multiplexer re-binds)."""
        return {k: v for k, v in self.__dict__.items() if k != "ctx"}

    def load_state(self, state: dict) -> None:
        """Inverse of :meth:`state_dict`; call after :meth:`bind`."""
        self.__dict__.update(state)

    def observe_step(self, job_id: str, step: int,
                     anomalies: list[Anomaly],
                     ts: float) -> list[tuple[str, Anomaly]]:
        return []

    def finalize(self) -> list[tuple[str, Anomaly]]:
        return []


@register_detector
class CrossJobFailSlowCorrelator(FleetDetector):
    """Reclassify co-occurring fail-slows on shared hardware.

    A fail-slow inside one job is routed to operations as that job's
    problem.  But when ``min_jobs`` *distinct* jobs sharing a rack or
    switch all report fail-slows within ``window_s`` of event time, the
    job-scoped diagnosis is wrong: the shared hardware is degrading.  This
    detector re-emits the finding per affected job as INFRASTRUCTURE with
    the shared rack/switch as root cause, evidence listing every
    correlated job and the underlying per-job anomalies.

    Each (scope attr, job) pair is reclassified once — repeated fail-slow
    steps from an already-correlated job do not spam the stream, but a new
    job joining the degraded hardware does emit (for the new job, with the
    grown job set in evidence).
    """

    name = "cross_job_failslow"

    def __init__(self, window_s: float = 60.0, min_jobs: int = 2,
                 attrs: tuple = ("rack", "switch")):
        self.window_s = window_s
        self.min_jobs = min_jobs
        self.attrs = tuple(attrs)
        # (attr, value) -> job_id -> (ts, step, metric) of latest fail-slow
        self._seen: dict[tuple, dict[str, tuple]] = {}
        self._emitted: set[tuple] = set()      # (attr, value, job_id)

    def observe_step(self, job_id, step, anomalies, ts):
        slow = [a for a in anomalies if a.kind == "fail_slow"]
        if not slow:
            return []
        topo = self.ctx.attrs(job_id)
        out: list[tuple[str, Anomaly]] = []
        for attr in self.attrs:
            value = topo.get(attr)
            if value is None:
                continue
            group = self._seen.setdefault((attr, value), {})
            group[job_id] = (float(ts), step, slow[-1].metric)
            # event-time window: jobs advance at their own pace, so prune
            # against the newest observation in THIS group, not wall time
            newest = max(t for t, _, _ in group.values())
            stale = [j for j, (t, _, _) in group.items()
                     if newest - t > self.window_s]
            for j in stale:
                del group[j]
            if len(group) < self.min_jobs:
                continue
            jobs = sorted(group)
            for victim in jobs:
                key = (attr, value, victim)
                if key in self._emitted:
                    continue
                self._emitted.add(key)
                v_ts, v_step, v_metric = group[victim]
                out.append((victim, Anomaly(
                    kind="fail_slow", metric="cross_job_correlation",
                    team=Team.INFRASTRUCTURE,
                    root_cause=f"shared {attr} {value!r} degradation: "
                               f"{len(jobs)} jobs failing slow within "
                               f"{self.window_s:.0f}s — hardware, not the "
                               "job (reclassified from operations)",
                    step=v_step, severity=float(len(jobs)),
                    evidence={attr: value, "jobs": jobs,
                              "window_s": self.window_s,
                              "co_occurring": {
                                  j: {"ts": t, "step": s, "metric": mt}
                                  for j, (t, s, mt) in group.items()}})))
        return out
