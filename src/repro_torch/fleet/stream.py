"""Merged fleet anomaly stream: job-tagged, timestamp-ordered, team-routed.

Each job's engine emits plain :class:`~repro_torch.core.engine.Anomaly`
objects; the stream wraps them with the job id, the event time (end of
the step slice that fired), a fleet-wide arrival sequence number, and
the routing target for the anomaly's team (paper Table 1: operations /
algorithm / infrastructure / cross-team).  ``drain()`` returns everything pushed since
the last drain merged across jobs in ``(ts, job_id, seq)`` order — jobs
advance at their own pace, so total order is per drain; a terminal
``finalize`` drain is fully ordered, and equal-timestamp ties across jobs
break by job id, not by (thread-scheduling-dependent) arrival.

The port's copy of the JAX package's ``fleet/stream.py``: numpy only (no
torch), with the reference's names, thresholds and arithmetic.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.engine import Anomaly, Team

DEFAULT_ROUTES: dict[Team, str] = {
    Team.OPERATIONS: "oncall-operations",
    Team.ALGORITHM: "oncall-algorithm",
    Team.INFRASTRUCTURE: "oncall-infrastructure",
    Team.CROSS_TEAM: "cross-team-review",
}


@dataclass
class FleetAnomaly:
    job_id: str
    ts: float                # event time: end of the slice that fired
    seq: int                 # fleet-wide arrival order (total tie-break)
    anomaly: Anomaly
    route: str
    origin: str = "job"      # "job" (per-job engine) | "fleet" (cross-job tier)

    @property
    def team(self) -> Team:
        return self.anomaly.team

    def __str__(self):
        tag = "" if self.origin == "job" else f" ({self.origin})"
        return f"[{self.ts:10.3f}s] {self.job_id}{tag} -> {self.route}: " \
               f"{self.anomaly}"


class AnomalyStream:
    """Collects per-job anomalies; drains them merged and ordered.
    Push/drain are thread-safe (jobs advance on their own threads)."""

    def __init__(self, routes: Optional[dict[Team, str]] = None):
        self.routes = dict(DEFAULT_ROUTES)
        if routes:
            self.routes.update(routes)
        self._pending: list[FleetAnomaly] = []
        self._lock = threading.Lock()
        self.total = 0

    def push(self, job_id: str, anomaly: Anomaly, ts: float,
             origin: str = "job") -> FleetAnomaly:
        with self._lock:
            fa = FleetAnomaly(
                job_id=job_id, ts=float(ts), seq=self.total, anomaly=anomaly,
                route=self.routes.get(anomaly.team,
                                      DEFAULT_ROUTES[Team.CROSS_TEAM]),
                origin=origin)
            self._pending.append(fa)
            self.total += 1
            return fa

    def drain(self) -> list[FleetAnomaly]:
        with self._lock:
            out, self._pending = self._pending, []
        # ts first; equal-ts ties break by job THEN arrival: within one
        # job arrival order is meaningful (one thread pushes that job's
        # anomalies in order) but ACROSS jobs it is thread-scheduling —
        # two jobs replaying the same recorded timestamps must drain
        # identically whether replayed serially or on parallel workers
        out.sort(key=lambda a: (a.ts, a.job_id, a.seq))
        return out

    def restore_seq(self, total: int) -> None:
        """Continue a checkpointed stream's fleet-wide sequence: the
        next push gets ``seq >= total``, so post-restore anomalies never
        reuse the sequence numbers of ones emitted before the snapshot
        (the ring and downstream consumers stay monotone)."""
        with self._lock:
            self.total = max(self.total, int(total))

    def drain_raw(self) -> list[FleetAnomaly]:
        """Pending anomalies in ARRIVAL order, no merge sort.  A replay
        worker process ships these across the IPC boundary; the parent
        re-pushes them onto ITS stream, which preserves per-job order —
        the only order that matters, since :meth:`drain`'s ``(ts,
        job_id, seq)`` sort already makes cross-job interleave
        scheduling-independent."""
        with self._lock:
            out, self._pending = self._pending, []
        return out

    def __len__(self) -> int:
        return len(self._pending)
