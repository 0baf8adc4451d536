"""The port's scenario matrix and its example scripts against the JAX
package's, on the CPU.

``repro_torch.scenarios`` is a numpy copy of ``repro.scenarios``, run on
the port's simulator, configs and engine.  At the same ceilings (the
reference's ``program_from_config`` given the port's H100 defaults
through ``monkeypatch``, its file untouched) both grade every cell alike:

* the syntax trees of ``scenarios/`` equal the reference's;
* the library (names, injections, ground truth, families), ``FAULT_KINDS``
  and ``scenarios_for`` agree;
* ``run_matrix(["qwen2-0.5b"])``, dbrx-132b's ``moe_straggler`` cell and
  the ``sync_after_comm`` cell (whose span the port names
  ``torch.cuda@synchronize``) give equal ``CellResult``s, and the matrix
  meets the floors ``chip_smoke.py``'s ``simulate`` phase holds it to;
* a runtime ``pcie_downgrade`` injector, as the README registers it,
  grades the same in both packages;
* the four ``examples/torch_*.py`` run with jax and repro blocked, and
  print what their JAX counterparts print when ``program_from_config``'s
  keyword defaults are set to the H100's in memory (``runpy``, nothing on
  disk edited): every job's anomalies (kind, metric, team, ranks, step),
  the 1024-rank cluster example's GC-stall job included.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro.core import injectors as ref_injectors
from repro.core import timeline as ref_timeline
from repro import scenarios as ref_scenarios
from repro_torch.core import injectors as port_injectors
from repro_torch import scenarios as port_scenarios
from torch_ast import tree

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the phase's floors)

H100 = dict(chip_flops=989e12, link_bw=5e10)
SCENARIO_MODULES = ("scenarios/__init__.py", "scenarios/base.py",
                    "scenarios/library.py", "scenarios/runner.py")


@pytest.fixture
def ref_at_h100(monkeypatch):
    """The reference's ``program_from_config`` with the port's ceilings
    as its defaults, for this test only."""
    fn = ref_timeline.program_from_config
    monkeypatch.setattr(fn, "__kwdefaults__", {**fn.__kwdefaults__, **H100})


def cells_equal(ref, port):
    assert [dataclasses.asdict(c) for c in ref] == \
        [dataclasses.asdict(c) for c in port]


@pytest.mark.parametrize("rel", SCENARIO_MODULES)
def test_syntax_tree_equals_the_references(rel):
    assert tree("repro_torch", rel) == tree("repro", rel)


def test_library_equals_the_references():
    ref, port = ref_scenarios.SCENARIOS, port_scenarios.SCENARIOS
    assert [s.name for s in ref] == [s.name for s in port]
    assert len(port) == 15
    for a, b in zip(ref, port):
        assert (a.truth is None) == (b.truth is None)
        if a.truth is not None:
            assert dataclasses.asdict(a.truth) == dataclasses.asdict(b.truth)
        assert (a.steps, a.seed, a.families, a.moe_experts, a.tags,
                a.description) == (b.steps, b.seed, b.families,
                                   b.moe_experts, b.tags, b.description)
        for step_s, n in ((1.0, 32), (0.3, 1024)):
            assert [dataclasses.asdict(i) for i in a.inject(step_s, n)] == \
                [dataclasses.asdict(i) for i in b.inject(step_s, n)]
    assert ref_scenarios.FAULT_KINDS == port_scenarios.FAULT_KINDS
    from repro.configs import get_config as ref_cfg
    from repro_torch.configs import get_config as port_cfg
    for arch in ("qwen2-0.5b", "dbrx-132b", "mamba2-780m", "zamba2-2.7b"):
        assert [s.name for s in ref_scenarios.scenarios_for(ref_cfg(arch))] \
            == [s.name for s in port_scenarios.scenarios_for(port_cfg(arch))]


def test_quick_matrix_grades_every_cell_as_the_reference(ref_at_h100):
    ref = ref_scenarios.run_matrix(["qwen2-0.5b"])
    port = port_scenarios.run_matrix(["qwen2-0.5b"])
    assert len(port) == 14
    cells_equal(ref, port)
    scores = port_scenarios.score_matrix(port)
    assert scores == ref_scenarios.score_matrix(ref)
    assert chip_smoke.scenario_floor_violations(
        port, scores, port_scenarios.FAULT_KINDS) == []
    assert (scores["micro_precision"], scores["micro_recall"]) == (1.0, 1.0)


def test_floors_catch_a_missed_cell():
    """The phase's floors fail a matrix that misses a fault."""
    cell = port_scenarios.run_cell(
        port_scenarios.SCENARIOS_BY_NAME["gpu_underclock"], "qwen2-0.5b",
        num_ranks=8)
    missed = dataclasses.replace(cell, caught=False, fired=())
    scores = port_scenarios.score_matrix([missed])
    bad = chip_smoke.scenario_floor_violations(
        [missed], scores, port_scenarios.FAULT_KINDS)
    assert any("MISSED" in b for b in bad)
    assert any("recall" in b for b in bad)


@pytest.mark.parametrize("scenario, config", [
    ("moe_straggler", "dbrx-132b"), ("sync_after_comm", "qwen2-0.5b")])
def test_cell_grades_as_the_reference(ref_at_h100, scenario, config):
    ref = ref_scenarios.run_cell(
        ref_scenarios.SCENARIOS_BY_NAME[scenario], config)
    port = port_scenarios.run_cell(
        port_scenarios.SCENARIOS_BY_NAME[scenario], config)
    cells_equal([ref], [port])
    assert port.ok and not port.healthy


def _pcie(pkg_injectors, pkg_scenarios):
    """The README's runtime injector and its hand-written ground truth,
    in one package."""
    class PcieDowngradeInjector(pkg_injectors.FaultInjector):
        name = "pcie_downgrade"

        def device_duration(self, sim, op, step, dur):
            if op.kind != "comm" or step < self.inj.start_step:
                return dur
            out = dur.copy()
            out[sim.hit_ranks(self.inj)] *= self.inj.factor
            return out

    scn = pkg_scenarios.Scenario(
        name="pcie_downgrade",
        description="PCIe link drops a generation on two ranks",
        inject=lambda step_s, n: [pkg_injectors.Injection(
            kind="pcie_downgrade", ranks=(4, 5), factor=4.0,
            start_step=3)],
        truth=pkg_scenarios.GroundTruth(
            kind="fail_slow", team="operations",
            expect=("fail_slow:bandwidth", "fail_slow:throughput"),
            onset_step=3))
    return PcieDowngradeInjector, scn


def test_runtime_injector_grades_as_the_reference(ref_at_h100):
    cells = []
    for inj_pkg, scn_pkg in ((ref_injectors, ref_scenarios),
                             (port_injectors, port_scenarios)):
        inj, scn = _pcie(inj_pkg, scn_pkg)
        inj_pkg.register_injector(inj)
        try:
            cells.append(scn_pkg.run_cell(scn, "qwen2-0.5b"))
        finally:
            inj_pkg.unregister_injector("pcie_downgrade")
    cells_equal(cells[:1], cells[1:])
    assert cells[1].caught and cells[1].ok
    assert "pcie_downgrade" not in port_injectors.injector_names()


# --------------------------------------------------------------------------- #
# the example scripts
# --------------------------------------------------------------------------- #
_BLOCKED = """
import runpy, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "torch"):
            raise ImportError(f"blocked import of {name}")
sys.meta_path.insert(0, Block())
path = sys.argv[1]
sys.argv = [path, *sys.argv[2:]]
runpy.run_path(path, run_name="__main__")
"""

_AT_H100 = """
import runpy, sys
from repro.core import timeline
fn = timeline.program_from_config
fn.__kwdefaults__ = {**fn.__kwdefaults__, "chip_flops": 989e12,
                     "link_bw": 5e10}
path = sys.argv[1]
sys.argv = [path, *sys.argv[2:]]
runpy.run_path(path, run_name="__main__")
"""

EXAMPLES = {
    "diagnose_cluster_sim-64": ("diagnose_cluster_sim", ["--ranks", "64"]),
    "diagnose_cluster_sim-1024": ("diagnose_cluster_sim", []),
    "inject_faults": ("inject_faults", []),
    "diagnose_fleet": ("diagnose_fleet", ["--ranks", "64", "--steps", "3"]),
    "query_archive": ("query_archive", ["--ranks", "64", "--steps", "3"]),
}


def run_both(script: str, args: list) -> tuple:
    """The port's example with jax, repro and torch blocked, and the
    reference's at the H100's ceilings, side by side: their stdouts."""
    env = dict(PATH=os.environ.get("PATH", "/usr/bin:/bin"),
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(ROOT / "examples" / name), *args],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for code, name in ((_BLOCKED, f"torch_{script}.py"),
                           (_AT_H100, f"{script}.py"))]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        outs.append(out)
    return tuple(outs)


def job_anomalies(out: str) -> dict:
    """Each ``=== job ===`` section's routed anomaly lines (kind, metric,
    team, ranks and step among them)."""
    jobs, cur = {}, None
    for line in out.splitlines():
        m = re.match(r"=== (.*) ===$", line)
        if m:
            cur = jobs.setdefault(m.group(1), [])
        elif cur is not None and re.match(r"\s+\[\w+/\w+\] -> ", line):
            cur.append(line.strip())
        elif cur is not None and line.strip() == "no anomalies detected":
            cur.append(line.strip())
    return jobs


@pytest.mark.parametrize("case", list(EXAMPLES))
def test_example_prints_what_the_references_prints(case):
    script, args = EXAMPLES[case]
    port, ref = run_both(script, args)
    assert port.strip()
    # the layout advice names the port's padded matmul, the one difference
    assert port == ref.replace("repro.kernels.padded_matmul",
                               "repro_torch.kernels.padded_matmul")
    if script == "diagnose_cluster_sim":
        jobs = job_anomalies(port)
        assert jobs == job_anomalies(ref.replace(
            "repro.kernels.", "repro_torch.kernels."))
        assert len(jobs) == 4
        culprit = 137 % int(dict(zip(args[::2], args[1::2])).get(
            "--ranks", 1024))
        assert any(f"GPU underclocking on ranks [{culprit}]" in a
                   for a in jobs["job-2: straggler GPU (underclocked)"])
        if not args:
            # at 1024 ranks the reference misses the GC stalls; so does
            # the port (ROADMAP, faults)
            assert jobs["job-1: python GC stalls"] == \
                ["no anomalies detected"]
    if script == "inject_faults":
        assert "missed=none" in port
        assert re.search(r"pcie_downgrade\s+OK", port)
