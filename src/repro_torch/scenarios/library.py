"""The scenario library: every fault the matrix scores, with ground truth.

Five-plus legacy kinds (the paper's cases) and the five L4 production
faults, each labelled with the detector key(s) that constitute a correct
catch, the team that must be paged, culprit ranks and onset step.  All
absolute stall durations are fractions of the program's healthy step
time, so the same scenario transfers across the model zoo — a 0.5 B
config with 0.3 s steps and a 405 B config with minute steps inject
proportionally identical faults.

``allowed`` keys document real secondary symptoms (a checkpoint storm
also dents throughput; heavy serving interference also depresses
achieved FLOPS uniformly) — they are not scored as false positives, but
anything else firing is.

The port's copy of the JAX package's ``scenarios/library.py``: stdlib
and numpy only (no torch), with the reference's names and semantics (its
syntax tree is held to the reference's by
``tests/test_torch_scenarios.py``).
"""
from __future__ import annotations

from repro_torch.core.injectors import Injection
from repro_torch.scenarios.base import GroundTruth, Scenario

# Detector keys (kind:metric) the suite can emit
FS_TPUT = "fail_slow:throughput"
FS_BW = "fail_slow:bandwidth"
RG_ISSUE = "regression:issue_latency"
RG_VINTER = "regression:v_inter"
RG_VMIN = "regression:v_minority"
RG_FLOPS = "regression:flops"
RG_BW = "regression:bandwidth"
HANG_INSPECT = "hang:intra_kernel_inspecting"
HANG_STACK = "hang:call_stack_analysis"


SCENARIOS: tuple[Scenario, ...] = (
    # ------------------------------------------------------------------ #
    # baseline: a healthy job — ANY anomaly is a false positive
    # ------------------------------------------------------------------ #
    Scenario(
        name="healthy",
        description="clean run; the suite must stay silent",
        inject=lambda step_s, n: [],
        truth=None,
        tags=("baseline",)),
    # ------------------------------------------------------------------ #
    # legacy taxonomy (paper cases)
    # ------------------------------------------------------------------ #
    Scenario(
        name="gc_stall",
        description="periodic Python GC pauses compress issue latencies",
        inject=lambda step_s, n: [Injection(
            kind="gc", duration=0.002 * step_s, period_ops=5)],
        truth=GroundTruth(kind="regression", team="algorithm",
                          expect=(RG_ISSUE,)),
        tags=("legacy", "host")),
    Scenario(
        name="pyapi_package_check",
        description="a package/version check stalls the dispatch thread",
        inject=lambda step_s, n: [Injection(
            kind="pyapi_stall", duration=0.0025 * step_s, period_ops=7,
            api_name="importlib.metadata.version")],
        truth=GroundTruth(kind="regression", team="algorithm",
                          expect=(RG_ISSUE,)),
        tags=("legacy", "host")),
    Scenario(
        name="sync_after_comm",
        description="Case-1: needless block_until_ready after collectives",
        inject=lambda step_s, n: [Injection(kind="sync_after_comm")],
        truth=GroundTruth(kind="regression", team="algorithm",
                          expect=(RG_ISSUE,)),
        tags=("legacy", "host")),
    Scenario(
        name="gpu_underclock",
        description="one rank's GPU drops clocks mid-job",
        inject=lambda step_s, n: [Injection(
            kind="underclock", ranks=(5,), factor=2.5, start_step=3)],
        truth=GroundTruth(kind="fail_slow", team="operations",
                          expect=(FS_TPUT,), culprit_ranks=(5,),
                          onset_step=3),
        tags=("legacy", "hardware")),
    Scenario(
        name="network_jitter",
        description="persistent noisy collective slowdown mid-job",
        inject=lambda step_s, n: [Injection(
            kind="network_jitter", factor=3.0, start_step=3)],
        truth=GroundTruth(kind="fail_slow", team="operations",
                          expect=(FS_BW,), allowed=(FS_TPUT,),
                          onset_step=3),
        tags=("legacy", "network")),
    Scenario(
        name="slow_dataloader",
        description="Case-3: host dataloader starves the device",
        inject=lambda step_s, n: [Injection(
            kind="slow_dataloader", factor=1.0, duration=0.2 * step_s)],
        truth=GroundTruth(kind="regression", team="algorithm",
                          expect=(RG_VINTER,)),
        tags=("legacy", "host")),
    Scenario(
        name="minority_kernels",
        description="Table-5: un-instrumented kernels inflate V_minority",
        inject=lambda step_s, n: [Injection(
            kind="minority_kernels", factor=0.35)],
        truth=GroundTruth(kind="regression", team="infrastructure",
                          expect=(RG_VMIN,)),
        tags=("legacy", "coverage")),
    Scenario(
        name="misaligned_matmul",
        description="Case-2: a layout change halves ffn matmul FLOPS",
        inject=lambda step_s, n: [Injection(
            kind="slow_compute", op_match="ffn_matmul", factor=2.88)],
        truth=GroundTruth(kind="regression", team="infrastructure",
                          expect=(RG_FLOPS,)),
        tags=("legacy", "software")),
    Scenario(
        name="comm_hang",
        description="one rank freezes inside a collective",
        inject=lambda step_s, n: [Injection(
            kind="hang", ranks=(11 % n,), at_step=2)],
        truth=GroundTruth(kind="hang", team="operations",
                          expect=(HANG_INSPECT,), allowed=(HANG_STACK,),
                          culprit_ranks=(11,), onset_step=2),
        steps=6,
        tags=("legacy", "hang")),
    # ------------------------------------------------------------------ #
    # L4 production taxonomy (PAPERS.md)
    # ------------------------------------------------------------------ #
    Scenario(
        name="checkpoint_write_storm",
        description="periodic multi-second blocking checkpoint flushes",
        inject=lambda step_s, n: [Injection(
            kind="checkpoint_write_storm", duration=0.25 * step_s,
            period_ops=6, start_step=2,
            meta={"period_steps": 6, "storm_steps": 3})],
        truth=GroundTruth(kind="regression", team="infrastructure",
                          expect=(RG_ISSUE,), allowed=(FS_TPUT,),
                          onset_step=2),
        tags=("l4", "storage")),
    Scenario(
        name="ecc_throttle",
        description="ECC storm / thermal throttle ramping on two ranks",
        inject=lambda step_s, n: [Injection(
            kind="ecc_throttle", ranks=(4, 5), factor=2.5, start_step=4,
            meta={"ramp_steps": 3})],
        truth=GroundTruth(kind="fail_slow", team="operations",
                          expect=(FS_TPUT,), culprit_ranks=(4, 5),
                          onset_step=4),
        tags=("l4", "hardware")),
    Scenario(
        name="network_flap",
        description="a link flaps: collectives degrade on a duty cycle",
        inject=lambda step_s, n: [Injection(
            kind="network_flap", factor=3.0, start_step=4,
            meta={"on_steps": 2, "off_steps": 2})],
        truth=GroundTruth(kind="fail_slow", team="operations",
                          expect=(FS_BW,), allowed=(FS_TPUT,),
                          onset_step=4),
        tags=("l4", "network")),
    Scenario(
        name="moe_straggler",
        description="one hot MoE expert runs 3x slow on its FFN kernels",
        inject=lambda step_s, n: [Injection(
            kind="moe_straggler", op_match="moe_ffn", factor=3.0,
            meta={"hot_expert": 2})],
        truth=GroundTruth(kind="regression", team="infrastructure",
                          expect=(RG_FLOPS,)),
        families=("moe",), moe_experts=4,
        tags=("l4", "moe")),
    Scenario(
        name="serving_interference",
        description="co-located serving burst steals compute on a duty "
                    "cycle (uniform, transient, no rank/network culprit)",
        inject=lambda step_s, n: [Injection(
            kind="serving_interference", factor=1.3, start_step=4,
            meta={"on_steps": 2, "off_steps": 2})],
        truth=GroundTruth(kind="fail_slow", team="operations",
                          expect=(FS_TPUT,), allowed=(RG_FLOPS,),
                          onset_step=4),
        tags=("l4", "multitenant")),
)

SCENARIOS_BY_NAME: dict[str, Scenario] = {s.name: s for s in SCENARIOS}

#: distinct fault kinds covered (hang + healthy included)
FAULT_KINDS: tuple[str, ...] = tuple(sorted(
    {inj.kind for s in SCENARIOS for inj in s.inject(1.0, 32)}))


def scenarios_for(cfg) -> list[Scenario]:
    """Scenarios applicable to one model-zoo config."""
    return [s for s in SCENARIOS if s.applies_to(cfg)]
