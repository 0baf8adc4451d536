"""Intra-kernel inspecting: O(1) communication-hang localization (§5.1, Fig 6).

Given the per-rank ring-step progress counters of a hung ring collective
(exported by repro_torch.parallel.collectives, or read live by the simulator),
the faulty *connection* is the one with the minimum completed step: its
sender/receiver pair is the isolation set.  This is O(1) in the number of
communication groups — no NCCL-test-style probe sweep.

``probe_search_cost`` models the paper's baseline (terminate job, run
pairwise tests group by group): O(#groups), >=30 min at thousand-GPU scale.

The port's copy of the JAX package's ``core/inspecting.py``: numpy
only (no torch), with the reference's names, thresholds and arithmetic.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class RingDiagnosis:
    link: tuple            # (sender, receiver) ranks of the stalled link
    machines: list         # isolation candidates (both ends)
    min_step: int
    confidence: str        # "high" if unique minimum else "review"


def diagnose_ring(progress: np.ndarray) -> RingDiagnosis:
    """progress[r] = ring steps completed by rank r in the hung collective.

    The receiver that stalled first (global min) identifies the broken
    incoming link; the sender on that link is the primary suspect.
    """
    progress = np.asarray(progress)
    n = progress.shape[0]
    lo = int(progress.min())
    receivers = np.flatnonzero(progress == lo)
    rx = int(receivers[0])
    tx = (rx - 1) % n
    confidence = "high" if receivers.size == 1 else "review"
    return RingDiagnosis(link=(tx, rx), machines=[tx, rx],
                         min_step=lo, confidence=confidence)


def inspect_cost_model(num_ranks: int, protocol: str = "SIMPLE",
                       inter_server: bool = True,
                       gpus_per_server: int = 8) -> float:
    """Wall-clock model of the inspector, calibrated to the paper's Fig 10
    (29.4–309.2 s on 16 A100s): attach + scan threadblocks, fully parallel
    across GPUs => constant in cluster size (O(1)).

    SIMPLE scans only thread 0 per block; LL/LL128 scan whole blocks.
    Inter-server rings have fewer blocks (NIC links < NVLink links).
    """
    attach = 20.0  # cuda-gdb attach + script bootstrap
    blocks = 8 if inter_server else 24
    per_block = {"SIMPLE": 1.0, "LL128": 6.5, "LL": 9.0}[protocol]
    return attach + blocks * per_block


def probe_search_cost(num_ranks: int, tp: int = 8, pp: int = 8,
                      ep: int = 1, test_seconds: float = 75.0) -> float:
    """NCCL-test baseline: every configured communication group must be
    probed (paper: 'exhaustive and blind search ... over half an hour')."""
    dp = max(num_ranks // (tp * pp * ep), 1)
    groups = 0
    groups += num_ranks // tp          # TP groups
    groups += num_ranks // pp          # PP groups
    groups += max(num_ranks // dp, 1)  # DP rings
    if ep > 1:
        groups += num_ranks // ep
    return groups * test_seconds / 32.0 + groups * 2.0
    # /32: tests on disjoint groups batched 32-way, +2 s orchestration each
