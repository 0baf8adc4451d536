"""Historical profile store (paper §8.2).

Healthy profiles are keyed by (backend family, cluster scale bucket) — the
paper's requirement that e.g. an attention-free SSM backend or a CPU-
embedding recommendation backend gets its *own* healthy distribution
(their two §7.3 false positives came from violating this).  Profiles hold:
issue-latency samples, void-percentage thresholds, per-kernel expected
FLOPS and per-group expected bandwidth.

The port's copy of the JAX package's ``core/history.py``: numpy
only (no torch), with the reference's names, thresholds and arithmetic.
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import asdict, dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.wasserstein import healthy_threshold


def scale_bucket(num_ranks: int) -> str:
    if num_ranks <= 0:
        return "0"
    return f"2^{int(math.ceil(math.log2(max(num_ranks, 1))))}"


@dataclass
class HealthyProfile:
    backend: str
    scale: str
    issue_latency_runs: list = field(default_factory=list)  # list[list[float]]
    issue_w1_threshold: float = 0.25
    v_inter_threshold: float = 0.05
    v_minority_threshold: float = 0.12
    expected_flops: dict = field(default_factory=dict)      # name -> FLOP/s
    expected_bandwidth: dict = field(default_factory=dict)  # name -> B/s

    def finalize(self, margin: float = 1.5):
        self.issue_w1_threshold = healthy_threshold(
            self.issue_latency_runs, margin)
        self.__dict__.pop("_ref_cache", None)   # runs may have changed

    def _ref(self):
        """(concatenated, sorted, median, mean) of the healthy latency
        samples, cached — the W1 detector compares EVERY step of EVERY
        fleet job against this fixed reference; re-concatenating and
        re-sorting it per step dominated the incremental hot path.  The
        cache keys on (run count, sample count) and ``finalize`` clears
        it, so re-learning invalidates; mutating a run IN PLACE without
        re-finalizing would serve stale values."""
        key = (len(self.issue_latency_runs),
               sum(len(r) for r in self.issue_latency_runs))
        cached = self.__dict__.get("_ref_cache")
        if cached is not None and cached[0] == key:
            return cached
        if self.issue_latency_runs:
            arr = np.concatenate(
                [np.asarray(r, np.float64) for r in self.issue_latency_runs])
        else:
            arr = np.asarray([], np.float64)
        srt = np.sort(arr)
        med = float(np.median(srt)) if srt.size else 0.0
        mean = float(np.mean(arr)) if arr.size else 0.0
        cached = (key, arr, srt, med, mean)
        self.__dict__["_ref_cache"] = cached
        return cached

    @property
    def reference_latencies(self) -> np.ndarray:
        return self._ref()[1]

    @property
    def reference_sorted(self) -> np.ndarray:
        return self._ref()[2]

    @property
    def reference_median(self) -> float:
        return self._ref()[3]

    @property
    def reference_mean(self) -> float:
        return self._ref()[4]


class HistoryStore:
    def __init__(self, directory: Optional[str] = None):
        self.dir = directory
        self._mem: dict[tuple, HealthyProfile] = {}
        if directory:
            os.makedirs(directory, exist_ok=True)
            self._load_all()

    def key(self, backend: str, num_ranks: int) -> tuple:
        return (backend, scale_bucket(num_ranks))

    def get(self, backend: str, num_ranks: int) -> Optional[HealthyProfile]:
        return self._mem.get(self.key(backend, num_ranks))

    def put(self, profile: HealthyProfile):
        self._mem[(profile.backend, profile.scale)] = profile
        if self.dir:
            fname = f"{profile.backend}__{profile.scale}.json".replace("^", "")
            with open(os.path.join(self.dir, fname), "w") as f:
                json.dump(asdict(profile), f)

    def snapshot_profiles(self) -> dict:
        """Picklable view of every learned healthy profile (service
        checkpoints capture it so a restarted daemon judges regressions
        against the same references even with an empty profile dir)."""
        return dict(self._mem)

    def restore_profiles(self, profiles: dict) -> None:
        """Fold checkpointed profiles back in.  Profiles already present
        win — they are the same or newer than the checkpointed ones."""
        for key, prof in profiles.items():
            self._mem.setdefault(key, prof)

    def _load_all(self):
        for name in os.listdir(self.dir):
            if not name.endswith(".json"):
                continue
            with open(os.path.join(self.dir, name)) as f:
                d = json.load(f)
            p = HealthyProfile(**d)
            self._mem[(p.backend, p.scale)] = p

    # ------------------------------------------------------------------ #
    def learn_from_metrics(self, backend: str, num_ranks: int,
                           metrics_list, margin: float = 1.5,
                           void_margin: float = 1.6) -> HealthyProfile:
        """Build a healthy profile from several healthy-run StepMetrics."""
        prof = HealthyProfile(backend=backend, scale=scale_bucket(num_ranks))
        flops_acc: dict[str, list[float]] = {}
        bw_acc: dict[str, list[float]] = {}
        v_inters, v_minors = [], []
        for m in metrics_list:
            if m.issue_latencies.size:
                prof.issue_latency_runs.append(
                    m.issue_latencies.tolist())
            for name, per_rank in m.flops.items():
                flops_acc.setdefault(name, []).extend(per_rank.values())
            for name, bw in m.bandwidth.items():
                bw_acc.setdefault(name, []).append(bw)
            v_inters.append(m.v_inter)
            v_minors.append(m.v_minority)
        prof.expected_flops = {k: float(np.median(v))
                               for k, v in flops_acc.items()}
        prof.expected_bandwidth = {k: float(np.median(v))
                                   for k, v in bw_acc.items()}
        if v_inters:
            prof.v_inter_threshold = max(
                float(np.max(v_inters)) * void_margin, 0.02)
        if v_minors:
            prof.v_minority_threshold = max(
                float(np.max(v_minors)) * void_margin, 0.05)
        prof.finalize(margin)
        self.put(prof)
        return prof
