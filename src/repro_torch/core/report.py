"""Reporting: anomaly summaries, ASCII timelines, JSON export.

The paper's FLARE also ships a distributed-visualization UI; here we render
the aggregated timeline (Fig 7 style) as ASCII for terminals/logs and emit
machine-readable JSON for dashboards.

The port's copy of the JAX package's ``core/report.py``: numpy
only (no torch), with the reference's names, thresholds and arithmetic.
"""
from __future__ import annotations

import json
from typing import Iterable

import numpy as np

from repro_torch.core.engine import Anomaly
from repro_torch.core.events import DEVICE_KINDS, EventKind, TraceEvent


def anomaly_report(anomalies: Iterable[Anomaly]) -> str:
    lines = ["=" * 72, "FLARE anomaly report", "=" * 72]
    by_team: dict[str, list[Anomaly]] = {}
    for a in anomalies:
        by_team.setdefault(a.team.value, []).append(a)
    if not by_team:
        lines.append("no anomalies detected")
    for team, items in sorted(by_team.items()):
        lines.append(f"\n--> routed to {team.upper()} "
                     f"({len(items)} finding(s))")
        for a in items:
            lines.append(f"  {a}")
            for k, v in list(a.evidence.items())[:4]:
                if k == "api_spans":
                    top = sorted(v.items(), key=lambda kv: -kv[1])[:3]
                    v = {n: round(t, 4) for n, t in top}
                lines.append(f"      {k}: {v}")
    return "\n".join(lines)


def _json_coerce(o):
    """Fallback serializer for detector evidence: vectorized detectors
    attach numpy scalars/arrays (np.float64 severities, outlier-rank
    arrays), and custom plugins attach whatever they like — dashboards
    still need valid JSON, so coerce instead of raising."""
    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (set, frozenset)):
        return sorted(o, key=repr)
    return str(o)


def anomalies_json(anomalies: Iterable[Anomaly]) -> str:
    return json.dumps([{
        "kind": a.kind, "metric": a.metric, "team": a.team.value,
        "root_cause": a.root_cause, "step": int(a.step),
        "severity": float(a.severity), "ranks": list(a.ranks),
        "evidence": a.evidence,
    } for a in anomalies], indent=1, default=_json_coerce)


def ascii_timeline(events: list[TraceEvent], rank: int, step: int,
                   width: int = 96) -> str:
    """Two-lane (CPU/device) timeline for one rank+step, Fig 7 style."""
    evs = [e for e in events if e.rank == rank and e.step == step]
    if not evs:
        return "(no events)"
    t0 = min(e.issue_ts for e in evs)
    t1 = max(e.end_ts for e in evs)
    span = max(t1 - t0, 1e-12)

    def bar(e: TraceEvent, char: str) -> tuple[int, int, str]:
        a = int((e.start_ts - t0) / span * (width - 1))
        b = max(int((e.end_ts - t0) / span * (width - 1)), a + 1)
        return a, b, char

    cpu_lane = [" "] * width
    dev_lane = [" "] * width
    for e in sorted(evs, key=lambda x: x.start_ts):
        if e.kind in DEVICE_KINDS:
            a, b, c = bar(e, "#" if e.kind == EventKind.KERNEL_COMPUTE else "~")
            for i in range(a, min(b, width)):
                dev_lane[i] = c
        elif e.kind in (EventKind.PY_API, EventKind.GC, EventKind.SYNC,
                        EventKind.DATALOADER):
            a, b, c = bar(e, "G" if e.kind == EventKind.GC else
                          ("S" if e.kind == EventKind.SYNC else
                           ("D" if e.kind == EventKind.DATALOADER else "p")))
            for i in range(a, min(b, width)):
                cpu_lane[i] = c
    return (f"rank {rank} step {step}  ({span * 1e3:.1f} ms)\n"
            f"CPU |{''.join(cpu_lane)}|\n"
            f"DEV |{''.join(dev_lane)}|\n"
            f"      # compute  ~ comm  G gc  S sync  D dataloader  p py-api")
