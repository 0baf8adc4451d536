"""Hang detection and two-step diagnosis (paper §5.1, Fig 5).

Step 1 — call-stack analysis: when daemons report a hang, ranks whose last
stack frame is NOT a communication function are the suspects (everyone else
is parked inside a collective waiting for them).  Step 2 — if *all* ranks
sit in the same collective, it is a communication hang: run intra-kernel
inspecting on that collective's ring-progress counters.

The port's copy of the JAX package's ``core/hang.py``: numpy
only (no torch), with the reference's names, thresholds and arithmetic.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.inspecting import RingDiagnosis, diagnose_ring

COMM_MARKERS = ("allreduce", "all_reduce", "allgather", "all_gather",
                "reduce_scatter", "all_to_all", "collective", "ppermute",
                "psum", "sendrecv")


def is_comm_frame(frame: str) -> bool:
    f = frame.lower()
    return any(m in f for m in COMM_MARKERS)


@dataclass
class HangDiagnosis:
    kind: str                       # "non_comm" | "comm" | "unknown"
    faulty_ranks: list
    link: Optional[tuple] = None
    detail: str = ""
    used_inspector: bool = False


def classify_stacks(stacks: dict) -> tuple[str, list]:
    """stacks: rank -> list[str] (innermost last).  Returns (kind, suspects)."""
    non_comm = [r for r, s in stacks.items()
                if not s or not is_comm_frame(s[-1])]
    if non_comm and len(non_comm) < max(len(stacks) // 2, 1):
        return "non_comm", sorted(non_comm)
    if not non_comm:
        return "comm", []
    return "unknown", sorted(non_comm)


def diagnose_hang(stacks: dict,
                  ring_progress: Optional[np.ndarray] = None) -> HangDiagnosis:
    kind, suspects = classify_stacks(stacks)
    if kind == "non_comm":
        return HangDiagnosis(
            kind=kind, faulty_ranks=suspects,
            detail="rank(s) halted outside any collective while peers wait "
                   f"in {_common_comm_frame(stacks)!r}")
    if kind == "comm":
        if ring_progress is None:
            return HangDiagnosis(
                kind="comm", faulty_ranks=[],
                detail="all ranks inside the same collective; ring progress "
                       "unavailable — escalating to probe search")
        d: RingDiagnosis = diagnose_ring(ring_progress)
        return HangDiagnosis(
            kind="comm", faulty_ranks=d.machines, link=d.link,
            used_inspector=True,
            detail=f"ring link {d.link[0]}->{d.link[1]} stalled at step "
                   f"{d.min_step} (confidence={d.confidence})")
    return HangDiagnosis(kind="unknown", faulty_ranks=suspects,
                         detail="mixed stacks; manual review")


def _common_comm_frame(stacks: dict) -> str:
    for s in stacks.values():
        if s and is_comm_frame(s[-1]):
            return s[-1]
    return "?"
