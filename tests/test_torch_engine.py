"""The port's diagnostic engine against the JAX package's, on the CPU.

The port keeps its own copies of the reference's numpy modules
(``repro_torch.core.{wasserstein,metrics,history,regression,failslow,
inspecting,hang,engine,report}`` and ``core/detectors``).  The same inputs,
made from numpy seeds or by the JAX package's cluster simulator, go through
both; the simulator's batches reach the port as FCS bytes
(``repro.store.encode_batch_bytes``, then the port's
``decode_batch_bytes``).  Both are the same numpy arithmetic, so every
comparison is exact:

* ``aggregate_all`` and ``aggregate_step`` give equal ``StepMetrics``,
  field by field, on the simulator's batches and on the port's own CPU
  traces (reduced llama through ``Trainer``, masks ``fast`` and
  ``naive``);
* every scenario of ``tests/test_engine_scenarios.py``, on the same
  32-rank world, gives equal anomaly lists (kind, metric, team, step,
  severity, ranks, root cause, evidence) and equal reports; the layout
  advice's module name is the one difference;
* ``HistoryStore`` profiles written by either package load in the other;
* the registry's errors and ``resolve_detectors`` behave as the
  reference's; the stateless primitives (W1, thresholds, ring diagnosis,
  stack classification, fail-slow plans, cost models) agree;
* each copied module's syntax tree equals the reference's once docstrings
  are dropped and the package's name in imports and in the layout
  advice's module name is made the same.

The ring drills' hangs are diagnosed by the port's engine in
``tests/test_torch_ring.py``, beside its spawn of the ranks.
"""
import json

import numpy as np
import pytest

from repro import store as ref_store
from repro.configs import get_config
from repro.core import events as ref_events
from repro.core import failslow as ref_failslow
from repro.core import hang as ref_hang
from repro.core import inspecting as ref_inspecting
from repro.core import metrics as ref_metrics
from repro.core import regression as ref_regression
from repro.core import report as ref_report
from repro.core import wasserstein as ref_w
from repro.core.detectors import registry as ref_registry
from repro.core.engine import DiagnosticEngine as RefEngine
from repro.core.engine import EngineConfig as RefConfig
from repro.core.history import HistoryStore as RefStore
from repro.core.timeline import ClusterSimulator, Injection, program_from_config
from repro_torch import store as port_store
from repro_torch.configs import get_reduced
from repro_torch.core import detectors as port_detectors
from repro_torch.core import events as port_events
from repro_torch.core import failslow as port_failslow
from repro_torch.core import hang as port_hang
from repro_torch.core import inspecting as port_inspecting
from repro_torch.core import metrics as port_metrics
from repro_torch.core import regression as port_regression
from repro_torch.core import report as port_report
from repro_torch.core import wasserstein as port_w
from repro_torch.core.anomaly import Anomaly as PortAnomaly
from repro_torch.core.engine import Anomaly, DiagnosticEngine, EngineConfig
from repro_torch.core.history import HistoryStore
from repro_torch.runtime.train import RunConfig, Trainer
from torch_ast import tree

N = 32
REF_SUGGESTION = "repro.kernels.padded_matmul"
PORT_SUGGESTION = "repro_torch.kernels.padded_matmul"


def to_port(batch):
    """A JAX-package ``EventBatch`` as the port's, through FCS bytes."""
    return port_store.decode_batch_bytes(ref_store.encode_batch_bytes(batch))


def assert_metrics_equal(ref, port):
    """Every field equal, dict orders included (both packages build them
    by the same first-appearance rule)."""
    assert type(port).__module__ == "repro_torch.core.metrics"
    for f in ("step", "t_step", "throughput", "v_inter", "v_minority",
              "t_inter", "num_ranks"):
        assert getattr(port, f) == getattr(ref, f), f
    for f in ("flops", "bandwidth", "api_spans"):
        assert list(getattr(port, f).items()) == \
            list(getattr(ref, f).items()), f
    assert port.flops_overlapped == ref.flops_overlapped
    np.testing.assert_array_equal(port.issue_latencies, ref.issue_latencies)
    assert port.issue_latencies.dtype == ref.issue_latencies.dtype


def _sim_batch(injections, steps, ranks=8, seed=3):
    prog = program_from_config(get_config("llama-20b-paper"),
                               num_chips=ranks)
    return ClusterSimulator(ranks, prog, seed=seed,
                            injections=injections).run_batch(steps)


SIM_CASES = {
    "healthy": [],
    "gc": [Injection(kind="gc", duration=0.25, period_ops=5)],
    "minority": [Injection(kind="minority_kernels", factor=0.4)],
    "dataloader": [Injection(kind="slow_dataloader", duration=8.0)],
    "sync": [Injection(kind="sync_after_comm")],
    "underclock": [Injection(kind="underclock", ranks=(5,), factor=2.5,
                             start_step=1)],
    "hang": [Injection(kind="hang", ranks=(3,), at_step=1)],
}


@pytest.mark.parametrize("case", list(SIM_CASES))
def test_metrics_equal_the_reference_on_simulator_batches(case):
    """``aggregate_all`` on the batch carried through FCS, and
    ``aggregate_step`` on its per-rank events (the oracle path)."""
    batch = _sim_batch(SIM_CASES[case], steps=3)
    pb = to_port(batch)
    ref_all = ref_metrics.aggregate_all(batch)
    port_all = port_metrics.aggregate_all(pb)
    assert list(port_all) == list(ref_all) and ref_all
    assert port_metrics.steps_in(pb) == ref_metrics.steps_in(batch)
    ref_by_rank = batch.to_events_by_rank()
    port_by_rank = pb.to_events_by_rank()
    for s in ref_all:
        assert_metrics_equal(ref_all[s], port_all[s])
        assert_metrics_equal(ref_metrics.aggregate_step(ref_by_rank, s),
                             port_metrics.aggregate_step(port_by_rank, s))
        rows = np.flatnonzero(pb.step == s)
        assert_metrics_equal(
            ref_metrics.aggregate_slice(batch.take(np.flatnonzero(
                batch.step == s)), s, num_ranks=8),
            port_metrics.aggregate_slice(pb.take(rows), s, num_ranks=8))


@pytest.fixture(scope="module")
def cpu_traces(tmp_path_factory):
    """The port's own traces: reduced llama trained on the CPU with the
    daemon spilling JSONL, the Case-3 masks ``fast`` and ``naive``."""
    tmp = tmp_path_factory.mktemp("engine_traces")
    out = {}
    for mode in ("fast", "naive"):
        log = str(tmp / f"{mode}.jsonl")
        run = RunConfig(model=get_reduced("llama3.2-1b"), global_batch=2,
                        seq_len=64, steps=4, warmup_steps=2, flare=True,
                        mask_mode=mode, flare_log=log,
                        data_prefetch=mode == "fast", device="cpu")
        Trainer(run).train()
        out[mode] = log
    return out


@pytest.mark.parametrize("mode", ["fast", "naive"])
def test_metrics_equal_the_reference_on_port_traces(cpu_traces, mode):
    """The port's spill read by each package's ``load_jsonl``: equal
    metrics by both paths, with the trainer's spans in them."""
    ref_by_rank = {0: ref_events.load_jsonl(cpu_traces[mode])}
    port_by_rank = {0: port_events.load_jsonl(cpu_traces[mode])}
    ref_b = ref_store.read_trace(cpu_traces[mode])
    port_b = port_store.read_trace(cpu_traces[mode])
    ref_all = ref_metrics.aggregate_all(ref_b)
    port_all = port_metrics.aggregate_all(port_b)
    assert sorted(port_all) == list(range(4))
    for s in range(4):
        assert_metrics_equal(ref_all[s], port_all[s])
        assert_metrics_equal(ref_metrics.aggregate_step(ref_by_rank, s),
                             port_metrics.aggregate_step(port_by_rank, s))
        m = port_all[s]
        assert {"train_step_exec", "flash_attention",
                "fused_residual_rmsnorm"} <= set(m.flops)
        assert "dataloader.next_batch" in m.api_spans
        assert m.t_inter > 0 and 0 < m.v_inter < 1


# --------------------------------------------------------------------------- #
# the engine on every scenario of tests/test_engine_scenarios.py
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def world():
    """The reference's 32-rank world: the healthy profile learned by each
    package's engine from the same three simulator batches."""
    prog = program_from_config(get_config("llama-20b-paper"), num_chips=N)
    ref_hist, port_hist = RefStore(), HistoryStore()
    ref0 = RefEngine(RefConfig(backend="dense-train", num_ranks=N), ref_hist)
    port0 = DiagnosticEngine(EngineConfig(backend="dense-train",
                                          num_ranks=N), port_hist)
    for seed in range(3):
        b = ClusterSimulator(N, prog, seed=seed).run_batch(4)
        ref0.ingest_batch(b)
        port0.ingest_batch(to_port(b))
    ref_prof = ref0.learn_healthy()
    port_prof = port0.learn_healthy()
    return prog, ref_hist, port_hist, ref_prof, port_prof


def _diagnose(world, injections, steps=6, seed=7, shapes=None):
    """(reference anomalies, port anomalies, the port's batch)."""
    prog, ref_hist, port_hist, _, _ = world
    sim = ClusterSimulator(N, prog, seed=seed, injections=injections)
    batch = sim.run_batch(steps)
    ref = RefEngine(RefConfig(backend="dense-train", num_ranks=N,
                              kernel_shapes=shapes or {}), ref_hist)
    port = DiagnosticEngine(EngineConfig(backend="dense-train", num_ranks=N,
                                         kernel_shapes=shapes or {}),
                            port_hist)
    pb = to_port(batch)
    ref.ingest_batch(batch)
    port.ingest_batch(pb)
    if sim.hang:
        return ([ref.diagnose_hang(sim.hang.stacks, sim.hang.ring_progress)],
                [port.diagnose_hang(sim.hang.stacks, sim.hang.ring_progress)],
                pb)
    return ref.evaluate_all(), port.evaluate_all(), pb


def _plain(a, port: bool):
    """An anomaly as plain values; the port's layout advice names the
    port's kernel, which is put back to the reference's name here."""
    ev = json.loads(json.dumps(a.evidence, default=ref_report._json_coerce))
    adv = ev.get("layout_advice")
    cause = a.root_cause
    if port and adv:
        assert PORT_SUGGESTION in adv["suggestion"]
        adv["suggestion"] = adv["suggestion"].replace(PORT_SUGGESTION,
                                                      REF_SUGGESTION)
    elif adv:
        assert PORT_SUGGESTION not in adv["suggestion"]
    return (a.kind, a.metric, a.team.value, a.step, a.severity,
            list(a.ranks), cause, ev)


SCENARIOS = {
    "healthy_clean": dict(injections=[]),
    "gc_stall": dict(injections=[
        Injection(kind="gc", duration=0.02, period_ops=5)]),
    "sync_stall": dict(injections=[Injection(kind="sync_after_comm")]),
    "case3_dataloader": dict(injections=[
        Injection(kind="slow_dataloader", factor=1.0, duration=2.0)]),
    "table5_minority": dict(injections=[
        Injection(kind="minority_kernels", factor=0.35)]),
    "failslow_underclock": dict(injections=[
        Injection(kind="underclock", ranks=(5,), factor=2.5, start_step=3)]),
    "failslow_jitter": dict(injections=[
        Injection(kind="network_jitter", factor=3.0, start_step=3)]),
    "case2_flops": dict(
        injections=[Injection(kind="slow_compute", op_match="ffn_matmul",
                              factor=2.88)],
        shapes={f"ffn_matmul[{g}]": (8192, 8484) for g in range(8)}),
    "comm_hang": dict(injections=[
        Injection(kind="hang", ranks=(11,), at_step=2)]),
    "noncomm_hang": dict(injections=[
        Injection(kind="hang", ranks=(3,), at_step=2, at_op=0,
                  meta={"noncomm_crash": True})]),
}
# test_paper_accuracy_batch's jobs: 8 healthy seeds, 4 regressions
ACCURACY = ([dict(injections=[], seed=100 + s, steps=4) for s in range(8)]
            + [dict(injections=inj, seed=200 + s) for s, inj in enumerate([
                [Injection(kind="gc", duration=0.02, period_ops=5)],
                [Injection(kind="sync_after_comm")],
                [Injection(kind="minority_kernels", factor=0.4)],
                [Injection(kind="slow_dataloader", duration=2.5)]])])


@pytest.mark.parametrize("name", [*SCENARIOS, "paper_accuracy_batch"])
def test_engine_equals_the_reference_on_the_scenarios(world, name):
    """Equal anomaly lists, in order, and equal reports; each scenario
    still finds what its reference test asserts (the healthy job nothing,
    every injected one something)."""
    jobs = ACCURACY if name == "paper_accuracy_batch" else [SCENARIOS[name]]
    for job in jobs:
        ref, port, pb = _diagnose(world, **job)
        assert all(isinstance(a, PortAnomaly) for a in port)
        assert [_plain(a, True) for a in port] == \
            [_plain(a, False) for a in ref]
        assert bool(ref) == bool(job["injections"]), ref
        if name == "case2_flops":
            hit = [a for a in port if a.metric == "flops"]
            assert hit and hit[0].team.value == "infrastructure"
            assert hit[0].evidence["layout_advice"]["padded_dims"] == [8512]
        # the reports: only the advice's module name differs
        assert port_report.anomaly_report(port) == \
            ref_report.anomaly_report(ref).replace(REF_SUGGESTION,
                                                   PORT_SUGGESTION)
        assert port_report.anomalies_json(port) == \
            ref_report.anomalies_json(ref).replace(REF_SUGGESTION,
                                                   PORT_SUGGESTION)
    events = pb.to_events()
    ref_ev = ref_store.decode_batch_bytes(
        port_store.encode_batch_bytes(pb)).to_events()
    assert port_report.ascii_timeline(events, 0, 1) == \
        ref_report.ascii_timeline(ref_ev, 0, 1)


def test_profiles_learned_from_the_same_batches_are_equal(world):
    _, _, _, ref_prof, port_prof = world
    for f in ("backend", "scale", "issue_latency_runs", "issue_w1_threshold",
              "v_inter_threshold", "v_minority_threshold", "expected_flops",
              "expected_bandwidth"):
        assert getattr(port_prof, f) == getattr(ref_prof, f), f
    np.testing.assert_array_equal(port_prof.reference_sorted,
                                  ref_prof.reference_sorted)
    assert port_prof.reference_median == ref_prof.reference_median


def test_incremental_evaluation_equals_the_reference(world):
    """``evaluate_new_steps`` with a watermark, then the rest, then
    ``check_hangs``: the same anomalies as the reference's engine driven
    the same way, and as its terminal ``evaluate_all``."""
    prog, ref_hist, port_hist, _, _ = world
    batch = ClusterSimulator(N, prog, seed=9, injections=[
        Injection(kind="gc", duration=0.02, period_ops=5)]).run_batch(6)
    ref = RefEngine(RefConfig(backend="dense-train", num_ranks=N), ref_hist)
    port = DiagnosticEngine(EngineConfig(backend="dense-train", num_ranks=N),
                            port_hist)
    ref.ingest_batch(batch)
    port.ingest_batch(to_port(batch))
    got = port.evaluate_new_steps(upto=3) + port.evaluate_new_steps() \
        + port.check_hangs()
    want = ref.evaluate_new_steps(upto=3) + ref.evaluate_new_steps() \
        + ref.check_hangs()
    assert [_plain(a, True) for a in got] == [_plain(a, False) for a in want]
    assert got and port.evaluated_steps == set(range(6))


# --------------------------------------------------------------------------- #
# profiles cross between the two packages' stores
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_history_store_json_crosses_packages(world, tmp_path, writer):
    """``HistoryStore.put`` writes JSON that the other package's store loads
    to the same profile, whose thresholds then judge alike."""
    _, _, _, ref_prof, port_prof = world
    if writer == "reference":
        RefStore(str(tmp_path)).put(ref_prof)
        got = HistoryStore(str(tmp_path)).get("dense-train", N)
        want = ref_prof
    else:
        HistoryStore(str(tmp_path)).put(port_prof)
        got = RefStore(str(tmp_path)).get("dense-train", N)
        want = port_prof
    assert got is not None and got is not want
    assert type(got).__module__ != type(want).__module__
    for f in ("backend", "scale", "issue_latency_runs", "issue_w1_threshold",
              "v_inter_threshold", "v_minority_threshold", "expected_flops",
              "expected_bandwidth"):
        assert getattr(got, f) == getattr(want, f), f
    assert [p.name for p in tmp_path.iterdir()] == ["dense-train__25.json"]


def test_profile_learned_from_port_metrics_matches(cpu_traces):
    """``learn_from_metrics`` on the port's own trace: equal profiles."""
    ms_ref = ref_metrics.aggregate_all(
        ref_store.read_trace(cpu_traces["fast"]))
    ms_port = port_metrics.aggregate_all(
        port_store.read_trace(cpu_traces["fast"]))
    a = RefStore().learn_from_metrics("dense-train", 1,
                                      [ms_ref[s] for s in (1, 2, 3)])
    b = HistoryStore().learn_from_metrics("dense-train", 1,
                                          [ms_port[s] for s in (1, 2, 3)])
    assert json.dumps(b.__dict__, default=repr, sort_keys=True) == \
        json.dumps(a.__dict__, default=repr, sort_keys=True)


# --------------------------------------------------------------------------- #
# the registry
# --------------------------------------------------------------------------- #
def test_registry_defaults_equal_the_reference():
    assert port_detectors.DEFAULT_DETECTORS == \
        ref_registry.DEFAULT_DETECTORS
    for scope in ("job", "fleet"):
        assert port_detectors.detector_names(scope) == \
            ref_registry.detector_names(scope)
    got = port_detectors.resolve_detectors(None)
    assert [type(d).name for d in got] == list(
        port_detectors.DEFAULT_DETECTORS)
    assert port_detectors.resolve_detectors(None, scope="fleet") == []


def test_registry_refuses_duplicates_and_unknown_names():
    class Probe(port_detectors.Detector):
        name = "probe_dup"
        kind = "regression"

    port_detectors.register_detector(Probe)
    try:
        with pytest.raises(port_detectors.DuplicateDetectorError):
            port_detectors.register_detector(Probe)
        with pytest.raises(port_detectors.DuplicateDetectorError):
            port_detectors.register_detector(name="failslow")(Probe)
        port_detectors.register_detector(Probe, replace=True)
    finally:
        port_detectors.unregister_detector("probe_dup")
    with pytest.raises(port_detectors.UnknownDetectorError):
        port_detectors.get_detector("probe_dup")
    with pytest.raises(port_detectors.UnknownDetectorError):
        port_detectors.resolve_detectors(["no_such_detector"])
    with pytest.raises(port_detectors.DetectorError):
        port_detectors.register_detector(type("Nameless",
                                              (port_detectors.Detector,), {}))
    assert issubclass(port_detectors.UnknownDetectorError, ValueError)


def test_resolve_detectors_takes_names_specs_classes_and_instances():
    inst = port_detectors.VoidsDetector()
    got = port_detectors.resolve_detectors([
        "failslow", port_detectors.DetectorSpec("failslow",
                                                {"window": 4, "drop": 0.3}),
        port_detectors.FlopsDetector, inst])
    assert [type(d) for d in got] == [
        port_detectors.FailSlowDetector, port_detectors.FailSlowDetector,
        port_detectors.FlopsDetector, port_detectors.VoidsDetector]
    assert got[3] is inst
    assert (got[1]._window, got[1]._drop) == (4, 0.3)
    assert got[0]._window is None
    with pytest.raises(port_detectors.DetectorError):
        port_detectors.resolve_detectors(["cross_job_failslow"],
                                         scope="job")
    with pytest.raises(port_detectors.DetectorError):
        port_detectors.resolve_detectors(
            [port_detectors.CrossJobFailSlowCorrelator()], scope="job")
    fleet = port_detectors.resolve_detectors(["cross_job_failslow"],
                                             scope="fleet")
    assert isinstance(fleet[0], port_detectors.FleetDetector)


def test_engine_runs_a_custom_detector_set(world):
    """A config's detector list (a spec and a class) drives the engine;
    ``hang`` is absent, so a hang report finds no handler."""
    prog, _, port_hist, _, _ = world
    eng = DiagnosticEngine(EngineConfig(
        backend="dense-train", num_ranks=N,
        detectors=[port_detectors.DetectorSpec("voids"),
                   port_detectors.FailSlowDetector]), port_hist)
    eng.ingest_batch(to_port(ClusterSimulator(N, prog, seed=7, injections=[
        Injection(kind="slow_dataloader", duration=2.0)]).run_batch(6)))
    found = eng.evaluate_all()
    assert found and all(a.metric == "v_inter" for a in found)
    assert eng.diagnose_hang({0: ["f"]}) is None
    state = eng.snapshot_state()
    fresh = DiagnosticEngine(eng.cfg, port_hist)
    fresh.restore_state(state)
    assert fresh.snapshot_state()["evaluated"] == state["evaluated"]


# --------------------------------------------------------------------------- #
# the stateless primitives
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n_a,n_b", [(50, 50), (37, 91), (0, 5), (0, 0)])
def test_w1_and_thresholds_equal_the_reference(n_a, n_b):
    rng = np.random.default_rng(n_a * 100 + n_b)
    a = rng.exponential(1e-3, n_a)
    b = rng.exponential(2e-3, n_b) + 1e-4
    assert port_w.w1_distance(a, b) == ref_w.w1_distance(a, b)
    if n_b:
        assert port_w.normalized_w1(a, b) == ref_w.normalized_w1(a, b)
    runs = [rng.exponential(1e-3, 20 + i).tolist() for i in range(4)]
    for k in (0, 1, 4):
        assert port_w.healthy_threshold(runs[:k], 1.7) == \
            ref_w.healthy_threshold(runs[:k], 1.7)


@pytest.mark.parametrize("seed", range(4))
def test_hang_and_ring_diagnosis_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    n = 8
    progress = rng.integers(2, 6, n)
    progress[seed % n] = 1 if seed < 3 else 2
    p, r = port_inspecting.diagnose_ring(progress), \
        ref_inspecting.diagnose_ring(progress)
    assert p.__dict__ == r.__dict__
    comm = {i: ["train", "ring_all_reduce"] for i in range(n)}
    crashed = {**comm, seed: ["train", "loss.backward"]}
    mixed = {i: (["x"] if i % 2 else ["psum"]) for i in range(n)}
    for stacks in (comm, crashed, mixed):
        for prog in (None, progress):
            assert port_hang.diagnose_hang(stacks, prog).__dict__ == \
                ref_hang.diagnose_hang(stacks, prog).__dict__
    for ranks in (1, 2, 7, 1024):
        assert port_failslow.binary_search_plan(ranks) == \
            ref_failslow.binary_search_plan(ranks)
        assert port_inspecting.probe_search_cost(ranks, ep=seed + 1) == \
            ref_inspecting.probe_search_cost(ranks, ep=seed + 1)
    for proto in ("SIMPLE", "LL128", "LL"):
        assert port_inspecting.inspect_cost_model(64, proto, seed % 2 == 0) \
            == ref_inspecting.inspect_cost_model(64, proto, seed % 2 == 0)


def test_throughput_monitor_equals_the_reference():
    rng = np.random.default_rng(5)
    series = (1000 + 20 * rng.standard_normal(40)).tolist()
    series[25:30] = [600.0] * 5
    p, r = port_failslow.ThroughputMonitor(), ref_failslow.ThroughputMonitor()
    got = [p.observe(x) for x in series]
    assert got == [r.observe(x) for x in series]
    assert [i for i, d in enumerate(got) if d is not None] == \
        list(range(25, 30))


@pytest.mark.parametrize("shape", [(8192, 8484), (4096, 8192), (100, 7),
                                   (8484,)])
@pytest.mark.parametrize("dtype_bytes", [1, 2, 4])
def test_layout_advice_equals_the_reference_but_for_the_kernel(shape,
                                                               dtype_bytes):
    """The paper's rule (128-byte alignment: 8484 -> 8512 in bf16); only
    the suggested module differs."""
    p = port_regression.layout_advice(shape, dtype_bytes)
    r = ref_regression.layout_advice(shape, dtype_bytes)
    assert (p is None) == (r is None)
    if r is not None:
        assert p["suggestion"] == r["suggestion"].replace(REF_SUGGESTION,
                                                          PORT_SUGGESTION)
        assert {k: v for k, v in p.items() if k != "suggestion"} == \
            {k: v for k, v in r.items() if k != "suggestion"}
    if shape == (8192, 8484) and dtype_bytes == 2:
        assert p["padded_dims"] == [8512]
    assert port_regression.ALIGN_BYTES == ref_regression.ALIGN_BYTES == 128


def test_engine_reexports_the_anomaly_record():
    assert Anomaly is PortAnomaly
    from repro_torch.core.anomaly import Team
    from repro_torch.core.engine import Team as EngineTeam
    assert EngineTeam is Team


COPIED = ["core/wasserstein.py", "core/metrics.py", "core/history.py",
          "core/regression.py", "core/failslow.py", "core/inspecting.py",
          "core/hang.py", "core/engine.py", "core/report.py",
          "core/detectors/__init__.py", "core/detectors/base.py",
          "core/detectors/registry.py", "core/detectors/builtins.py",
          "core/detectors/fleet.py"]


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_is_the_reference_but_for_names_and_docstrings(rel):
    """The same code: only docstrings, the package's name and the layout
    advice's module name (the one intended difference) may differ."""
    assert tree("repro_torch", rel) == tree("repro", rel)
