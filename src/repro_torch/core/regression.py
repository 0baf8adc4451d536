"""Regression detection + root-cause narrowing (paper §5.2.2, §5.2.4).

Detectors (all compare against the HealthyProfile for this backend/scale):
  * issue-latency distribution drift (normalized W1 > learned threshold)
      -> kernel-issue stall; root cause = traced Python APIs that precede
         the stalled kernels (GC, sync, timers, package checks)
  * V_inter above threshold -> inter-step CPU (dataloader — Case-3)
  * V_minority above threshold -> un-instrumented minority kernels (Table 5)
  * per-kernel FLOPS below expectation on ALL ranks uniformly -> software
      regression; the layout advisor checks input layouts for tensor-core /
      MXU alignment (Case-2: pad 8484 -> 8512)
  * bandwidth below expectation persistently from job start -> software
      (e.g. GDR disabled); sudden mid-job drops are fail-slows, not
      regressions (handled in failslow.py)

The port's copy of the JAX package's ``core/regression.py``: numpy
only (no torch), with the reference's names, thresholds and arithmetic.
Its one change is the module ``layout_advice`` suggests: the port's
``repro_torch.kernels.padded_matmul``.  The advice keeps the paper's
Case-2 rule, ``ALIGN_BYTES`` = 128 (8484 -> 8512 in bf16); that kernel
itself pads N further, to its 128-column tile (8484 -> 8576).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.history import HealthyProfile
from repro_torch.core.metrics import StepMetrics
from repro_torch.core.wasserstein import w1_distance_sorted

ALIGN_BYTES = 128          # tensor-core/MXU tile alignment (paper Case-2)
FLOPS_REGRESSION_FRAC = 0.75
BW_REGRESSION_FRAC = 0.7

# APIs owned by algorithm teams vs infrastructure (routing, Table 1).
# Checkpoint writes are storage-subsystem work: a checkpoint-write storm
# (L4 taxonomy) pages infrastructure, not the model owners.
ALGORITHM_APIS = ("block_until_ready", "synchronize", "timer", "gc.collect",
                  "package", "version", "mask")
INFRA_APIS = ("memory", "allocator", "cuda_malloc", "compile",
              "checkpoint", "ckpt")


@dataclass
class RegressionFinding:
    metric: str          # issue_latency | v_inter | v_minority | flops | bandwidth
    severity: float      # how far past threshold
    root_cause: str
    suggested_team: str  # "algorithm" | "infrastructure"
    evidence: dict = field(default_factory=dict)


def check_issue_latency(m: StepMetrics,
                        prof: HealthyProfile) -> Optional[RegressionFinding]:
    if m.issue_latencies.size < 8 or prof.reference_latencies.size < 8:
        return None
    cur = np.sort(np.asarray(m.issue_latencies, np.float64))
    d = w1_distance_sorted(cur, prof.reference_sorted) \
        / max(prof.reference_mean, 1e-12)
    if d <= prof.issue_w1_threshold:
        return None
    # one-sided: kernel-issue stalls COMPRESS issue latencies (§5.2.2 /
    # Fig 11 — unhealthy CDFs rise much faster).  Larger-than-healthy
    # latencies mean a busier device (jitter, stragglers), which belongs
    # to the fail-slow path, not this detector.
    median_cur = float(np.median(cur))
    if median_cur >= prof.reference_median:
        return None
    # §5.2.4: find traced APIs invoked just before the stalled kernels
    culprit, team = _narrow_api(m)
    return RegressionFinding(
        metric="issue_latency", severity=d / prof.issue_w1_threshold,
        root_cause=culprit or "kernel-issue stall (no traced API matched)",
        suggested_team=team,
        evidence={"w1": d, "threshold": prof.issue_w1_threshold,
                  "median_latency": median_cur,
                  "healthy_median": prof.reference_median,
                  "api_spans": dict(m.api_spans)})


def _narrow_api(m: StepMetrics) -> tuple[Optional[str], str]:
    if not m.api_spans:
        return None, "infrastructure"
    top = max(m.api_spans.items(), key=lambda kv: kv[1])
    name = top[0]
    low = name.lower()
    if "dataloader" in low or "next_batch" in low:
        return f"host dataloader stall ({name})", "algorithm"
    if any(a in low for a in ALGORITHM_APIS):
        team = "algorithm"
        if "gc" in low:
            name = f"python runtime GC ({name})"
        elif "sync" in low or "block_until_ready" in low:
            name = f"unnecessary device synchronization ({name})"
    elif any(a in low for a in INFRA_APIS):
        team = "infrastructure"
    else:
        team = "algorithm"
    return name, team


def check_voids(m: StepMetrics,
                prof: HealthyProfile) -> list[RegressionFinding]:
    out = []
    if m.v_inter > prof.v_inter_threshold:
        out.append(RegressionFinding(
            metric="v_inter", severity=m.v_inter / prof.v_inter_threshold,
            root_cause="inter-step CPU time (dataloader / host preprocessing)",
            suggested_team="algorithm",
            evidence={"v_inter": m.v_inter,
                      "threshold": prof.v_inter_threshold,
                      "t_inter_s": m.t_inter,
                      "api_spans": dict(m.api_spans)}))
    if m.v_minority > prof.v_minority_threshold:
        out.append(RegressionFinding(
            metric="v_minority",
            severity=m.v_minority / prof.v_minority_threshold,
            root_cause="un-instrumented minority GPU kernels "
                       "(un-fused PE/ACT/NORM ops — fusion candidates)",
            suggested_team="infrastructure",
            evidence={"v_minority": m.v_minority,
                      "threshold": prof.v_minority_threshold}))
    return out


def check_flops(m: StepMetrics, prof: HealthyProfile) -> list[RegressionFinding]:
    """Uniform (all-rank) FLOPS deficits => software regression (Case-2)."""
    out = []
    for name, per_rank in m.flops.items():
        if name in m.flops_overlapped or name not in prof.expected_flops:
            continue
        vals = np.asarray(list(per_rank.values()))
        exp = prof.expected_flops[name]
        if exp <= 0 or vals.size == 0:
            continue
        ratio = vals / exp
        # uniform: ALL ranks depressed (rank-specific deficits = fail-slow)
        if float(ratio.max()) < FLOPS_REGRESSION_FRAC:
            finding = RegressionFinding(
                metric="flops", severity=float(exp / max(vals.mean(), 1.0)),
                root_cause=f"kernel {name!r} running at "
                           f"{100 * float(vals.mean()) / exp:.0f}% of expected FLOPS "
                           f"on all ranks (software/layout change)",
                suggested_team="infrastructure",
                evidence={"kernel": name, "expected": exp,
                          "achieved_mean": float(vals.mean())})
            out.append(finding)
    return out


def layout_advice(shape: tuple, dtype_bytes: int = 2) -> Optional[dict]:
    """Case-2 advisor: flag dims misaligned to the 128-byte tile boundary
    and suggest the padded dim (8484 -> 8512)."""
    elems = ALIGN_BYTES // dtype_bytes
    bad = [int(d) for d in shape if d % elems]
    if not bad:
        return None
    return {"misaligned_dims": bad,
            "padded_dims": [int(-(-d // elems) * elems) for d in bad],
            "alignment_elems": elems,
            "suggestion": "pad with repro_torch.kernels.padded_matmul "
                          f"({bad[0]} -> {-(-bad[0] // elems) * elems})"}


def annotate_layout(findings: list[RegressionFinding],
                    kernel_shapes: dict) -> None:
    for f in findings:
        if f.metric != "flops":
            continue
        shape = kernel_shapes.get(f.evidence.get("kernel", ""))
        if shape:
            adv = layout_advice(tuple(shape))
            if adv:
                f.evidence["layout_advice"] = adv
                f.root_cause += (
                    f"; layout advisor: dims {adv['misaligned_dims']} not "
                    f"{ALIGN_BYTES}-byte aligned -> pad to {adv['padded_dims']}")


def check_bandwidth(m: StepMetrics,
                    prof: HealthyProfile) -> list[RegressionFinding]:
    out = []
    for name, bw in m.bandwidth.items():
        exp = prof.expected_bandwidth.get(name)
        if not exp:
            continue
        if bw < BW_REGRESSION_FRAC * exp:
            out.append(RegressionFinding(
                metric="bandwidth", severity=exp / max(bw, 1.0),
                root_cause=f"collective {name!r} at "
                           f"{100 * bw / exp:.0f}% of expected bandwidth "
                           "from job start (configuration/software)",
                suggested_team="infrastructure",
                evidence={"kernel": name, "expected_Bps": exp,
                          "achieved_Bps": bw}))
    return out
