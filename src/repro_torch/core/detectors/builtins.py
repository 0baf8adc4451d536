"""The built-in detector set: the paper's five checks plus hang analysis,
as registered plugins.

Each class wraps the stateless primitives in
``repro_torch.core.failslow`` / ``repro_torch.core.regression`` /
``repro_torch.core.hang`` (which stay importable on
their own — benchmarks and tests use them directly) and owns the per-job
STATE the old engine if-chain kept inline: the throughput changepoint
baseline, the first-step metrics comparison, and the consecutive-step
debounce counters.

The default registry order (``DEFAULT_DETECTORS``) reproduces the
pre-registry engine byte for byte: ``failslow`` (macro ① + sudden
bandwidth), then the regression tier ``issue_latency`` (④),
``voids`` (⑤), ``flops`` (②), ``bandwidth`` (③), then ``hang``.

The port's copy of the JAX package's ``core/detectors/builtins.py``: numpy
only (no torch), with the reference's names, thresholds and arithmetic.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import failslow as fs
from repro_torch.core import regression as rg
from repro_torch.core.anomaly import Anomaly, Team
from repro_torch.core.detectors.base import Detector, DetectorContext
from repro_torch.core.detectors.registry import register_detector
from repro_torch.core.hang import HangDiagnosis, diagnose_hang
from repro_torch.core.metrics import StepMetrics


@register_detector
class FailSlowDetector(Detector):
    """Macro fail-slow (①): rolling-median throughput changepoint with
    micro attribution (per-rank FLOPS -> underclock, per-group bandwidth
    -> network), plus the SUDDEN mid-job bandwidth drop — the paper's
    taxonomy keys on sudden-vs-persistent, so a mid-job drop is a
    fail-slow routed to operations, never a regression."""

    name = "failslow"
    kind = "fail_slow"

    def __init__(self, window: Optional[int] = None,
                 drop: Optional[float] = None):
        self._window = window
        self._drop = drop

    def bind(self, ctx: DetectorContext) -> None:
        super().bind(ctx)
        self._monitor = fs.ThroughputMonitor(
            self._window if self._window is not None
            else ctx.config.failslow_window,
            self._drop if self._drop is not None
            else ctx.config.failslow_drop)

    def observe_step(self, m: StepMetrics, step: int) -> list[Anomaly]:
        found: list[Anomaly] = []
        baseline = self.ctx.baseline

        # ---- macro ①, then micro attribution -------------------------- #
        drop = self._monitor.observe(m.throughput)
        if drop is not None:
            f = fs.attribute_failslow(m, baseline, step, drop)
            found.append(Anomaly(
                kind="fail_slow", metric="throughput", team=Team.OPERATIONS,
                root_cause={"gpu_underclock":
                            f"GPU underclocking on ranks {f.ranks}",
                            "network":
                            "network degradation (jitter/congestion); "
                            "binary-search probe plan attached",
                            "unknown": "sudden slowdown, cause unresolved"
                            }[f.cause],
                step=step, severity=1.0 + drop, ranks=f.ranks,
                evidence={"drop_frac": drop, **f.evidence,
                          "probe_plan": f.probe_plan}))

        # ---- mid-job bandwidth drop => fail-slow (network) ------------ #
        base_bw = baseline.bandwidth
        slow_groups = [(n, bw / base_bw[n]) for n, bw in m.bandwidth.items()
                       if n in base_bw and base_bw[n] > 0
                       and bw < 0.75 * base_bw[n]]
        if slow_groups and m is not baseline:
            found.append(Anomaly(
                kind="fail_slow", metric="bandwidth", team=Team.OPERATIONS,
                root_cause="network degradation on "
                           f"{len(slow_groups)} collective group(s) "
                           "(jitter/CRC/congestion); probe plan attached",
                step=step, severity=1.0 / min(f for _, f in slow_groups),
                evidence={"slow_groups": slow_groups[:6],
                          "probe_plan": fs.binary_search_plan(m.num_ranks)}))
        return found


class RegressionDetector(Detector):
    """Shared debounce machinery for the regression tier (②-⑤): a micro
    finding must persist ``regression_consecutive`` steps before it
    becomes an anomaly, and any step without the finding resets its
    counter.  Subclasses implement ``propose(m, prof)`` returning raw
    :class:`~repro_torch.core.regression.RegressionFinding`s; without a learned
    healthy profile the whole tier is silent."""

    kind = "regression"

    def __init__(self):
        self._pending: dict[str, int] = {}

    def propose(self, m: StepMetrics, prof) -> list[rg.RegressionFinding]:
        raise NotImplementedError

    def observe_step(self, m: StepMetrics, step: int) -> list[Anomaly]:
        prof = self.ctx.profile
        if prof is None:
            return []
        findings = self.propose(m, prof)
        out: list[Anomaly] = []
        for f in findings:
            self._pending[f.metric] = self._pending.get(f.metric, 0) + 1
            if self._pending[f.metric] >= \
                    self.ctx.config.regression_consecutive:
                out.append(Anomaly(
                    kind="regression", metric=f.metric,
                    team=Team(f.suggested_team),
                    root_cause=f.root_cause, step=step,
                    severity=f.severity, evidence=f.evidence))
        fired = {f.metric for f in findings}
        for key in list(self._pending):
            if key not in fired:
                self._pending[key] = 0
        return out


@register_detector
class IssueLatencyDetector(RegressionDetector):
    """Issue-latency W1 drift (④) -> kernel-issue stall, API narrowing."""

    name = "issue_latency"

    def propose(self, m, prof):
        f = rg.check_issue_latency(m, prof)
        if f is None:
            return []
        # prefer the specific detector: when V_inter also fires this step
        # (the voids plugin will report the dataloader), drop the
        # duplicate issue-latency finding with a dataloader root cause.
        if "dataloader" in f.root_cause.lower() \
                and m.v_inter > prof.v_inter_threshold:
            return []
        return [f]


@register_detector
class VoidsDetector(RegressionDetector):
    """Void percentages (⑤): V_inter (dataloader / host preprocessing)
    and V_minority (un-instrumented minority kernels)."""

    name = "voids"

    def propose(self, m, prof):
        return rg.check_voids(m, prof)


@register_detector
class FlopsDetector(RegressionDetector):
    """Uniform per-kernel FLOPS deficit (②) -> software regression, with
    the Case-2 layout advisor on configured kernel shapes."""

    name = "flops"

    def propose(self, m, prof):
        findings = rg.check_flops(m, prof)
        rg.annotate_layout(findings, self.ctx.config.kernel_shapes)
        return findings


@register_detector
class BandwidthDetector(RegressionDetector):
    """Persistent bandwidth deficit (③) -> configuration/software (e.g.
    GDR module down).  Must be low from the job's FIRST step — sudden
    mid-job drops belong to the fail-slow plugin."""

    name = "bandwidth"

    def propose(self, m, prof):
        return [f for f in rg.check_bandwidth(m, prof)
                if self._also_low_at_start(f, prof)]

    def _also_low_at_start(self, finding, prof) -> bool:
        name = finding.evidence.get("kernel", "")
        base = self.ctx.baseline.bandwidth.get(name)
        exp = prof.expected_bandwidth.get(name)
        if base is None or not exp:
            return True
        return base < rg.BW_REGRESSION_FRAC * exp


@register_detector
class HangAnalysisDetector(Detector):
    """Hang path (①): call-stack analysis, escalating to intra-kernel
    inspecting when all ranks sit in the same collective."""

    name = "hang"
    kind = "hang"

    def on_hang(self, stacks: dict, ring_progress=None) -> Anomaly:
        d: HangDiagnosis = diagnose_hang(stacks, ring_progress)
        return Anomaly(
            kind="hang",
            metric="intra_kernel_inspecting" if d.used_inspector
            else "call_stack_analysis",
            team=Team.OPERATIONS,
            root_cause=d.detail, ranks=d.faulty_ranks,
            evidence={"hang_kind": d.kind, "link": d.link})
