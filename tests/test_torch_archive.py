"""The port's trace archive against the JAX package's, on the CPU.

``repro_torch.archive`` is a numpy copy of ``repro.archive``.  Archives
written by the reference's writers (rotated FCS v3 with one segment a
step, mixed with v1 / v2 pieces) are opened by both packages, each on its
own copy of the directory (the copies keep the files' sizes and mtimes,
which key the rollup caches), and every query is compared exactly:

* each copy's syntax tree equals the reference's (docstrings and the
  package's name aside);
* ``query_events`` with step, rank, severity, time and column predicates,
  pushed down and not, with its scan accounting, and ``segment_stats``;
* ``rollups`` and ``query_metrics`` for every metric, bucketed and by step
  range; ``query_anomalies`` by job, team and time; ``fleet_weather`` and
  its text;
* rollup sidecars written by either package serve the other's cold
  archive from disk with equal answers, a stale one (a segment appended)
  is rebuilt alone, a corrupt one ignored, and replay never reads them;
* telemetry exported by one package reads back in the other;
* the replayer's predicate pushdown accounts the same skips.
"""
import json
import os
import shutil

import numpy as np
import pytest

from repro import store as ref_store
from repro.archive import TraceArchive as RefArchive
from repro.archive import format_fleet_weather as ref_weather_text
from repro.configs import get_config
from repro.core.engine import DiagnosticEngine as RefEngine
from repro.core.engine import EngineConfig as RefConfig
from repro.core.history import HistoryStore as RefHistory
from repro.core.report import anomalies_json as ref_anomalies_json
from repro.core.timeline import ClusterSimulator, Injection, program_from_config
from repro.fleet import FleetConfig as RefFleetConfig
from repro.fleet import FleetMultiplexer as RefMux
from repro.fleet import FleetReplayer as RefReplayer
from repro.store import Predicate as RefPredicate
from repro_torch import store
from repro_torch.archive import SCALAR_METRICS, TraceArchive
from repro_torch.archive import format_fleet_weather
from repro_torch.core.anomaly import Team
from repro_torch.core.engine import DiagnosticEngine, EngineConfig
from repro_torch.core.history import HistoryStore
from repro_torch.core.report import anomalies_json
from repro_torch.fleet import FleetConfig, FleetMultiplexer, FleetReplayer
from repro_torch.store import Predicate
from torch_ast import tree

N = 16
COLS = ("kind", "name_id", "rank", "issue_ts", "start_ts", "end_ts", "step",
        "flops", "nbytes", "tokens", "group_id")
INJECTIONS = {"job-b": [Injection(kind="underclock", ranks=(5,), factor=2.5,
                                  start_step=3)]}


def to_port(batch):
    return store.decode_batch_bytes(ref_store.encode_batch_bytes(batch))


def assert_batches_equal(port, ref):
    """Every column's bytes, the tables and the per-row meta equal."""
    for c in COLS:
        a, b = getattr(port, c), getattr(ref, c)
        assert a.dtype == b.dtype, c
        assert a.tobytes() == b.tobytes(), c
    assert port.names == ref.names and port.groups == ref.groups
    assert port.extra == ref.extra


def rows(fas, to_json=anomalies_json):
    fas = list(fas)
    found = json.loads(to_json([fa.anomaly for fa in fas]))
    return [dict(job=fa.job_id, ts=fa.ts, origin=fa.origin, route=fa.route,
                 **a) for fa, a in zip(fas, found)]


def per_step(b) -> list:
    order, uniq, bounds = b.step_index()
    return [b.take(order[bounds[i]:bounds[i + 1]]) for i in range(uniq.size)]


@pytest.fixture(scope="module")
def world():
    prog = program_from_config(get_config("llama-20b-paper"), num_chips=N)
    ref_hist, port_hist = RefHistory(), HistoryStore()
    ref_eng = RefEngine(RefConfig(backend="dense-train", num_ranks=N),
                        ref_hist)
    port_eng = DiagnosticEngine(EngineConfig(backend="dense-train",
                                             num_ranks=N), port_hist)
    for seed in range(3):
        b = ClusterSimulator(N, prog, seed=seed).run_batch(4)
        ref_eng.ingest_batch(b)
        port_eng.ingest_batch(to_port(b))
    ref_eng.learn_healthy()
    port_eng.learn_healthy()
    return prog, ref_hist, port_hist


def write_archive(logdir, prog, steps=6, jobs=("job-a", "job-b")):
    """One rotated FCS v3 file a job, one segment a step (the reference's
    writer), and a job mixing v1 / v2 / v3 segments in one file and a
    rotated piece."""
    os.makedirs(logdir, exist_ok=True)
    for j, job in enumerate(jobs):
        b = ClusterSimulator(N, prog, seed=21 + j,
                             injections=INJECTIONS.get(job, [])
                             ).run_batch(steps)
        w = ref_store.SegmentedTraceWriter(
            os.path.join(logdir, f"{job}.fcs3"), codec="fcs3",
            rotate_bytes=1)
        for sb in per_step(b):
            w.write(sb)
    segs = per_step(ClusterSimulator(N, prog, seed=5).run_batch(6))
    for i, sb in enumerate(segs[:4]):
        ref_store.write_fcs(sb, os.path.join(logdir, "job-m.fcs"),
                            version=(1, 2, 3, 3)[i])
    for sb in segs[4:]:
        ref_store.write_fcs(sb, os.path.join(logdir, "job-m.seg001.fcs"),
                            version=3)


def twin(tmp_path, prog, **kw) -> tuple:
    """The same archive twice: (the port's directory, the reference's)."""
    a, b = str(tmp_path / "port"), str(tmp_path / "ref")
    write_archive(a, prog, **kw)
    shutil.copytree(a, b)
    return a, b


@pytest.mark.parametrize("rel", ["archive/archive.py", "archive/__init__.py"])
def test_copied_module_is_the_reference_but_for_names_and_docstrings(rel):
    assert tree("repro_torch", rel) == tree("repro", rel)


PREDICATES = {
    "step": dict(step_range=(2, 2)),
    "steps and ranks": dict(step_range=(4, 5), ranks=[0, 1]),
    "severity": dict(severity="warning"),
    "kinds": dict(kinds=["k_comm"]),
    "flops": dict(columns={"flops": (1e9, None)}),
    "nbytes": dict(columns={"nbytes": (None, 1 << 20)}),
}


@pytest.mark.parametrize("name", list(PREDICATES))
@pytest.mark.parametrize("pushdown", [True, False])
def test_query_events_equals_the_reference(tmp_path, world, name, pushdown):
    prog = world[0]
    a, b = twin(tmp_path, prog)
    port, ref = TraceArchive(a), RefArchive(b)
    assert port.jobs == ref.jobs == ["job-a", "job-b", "job-m"]
    for job in port.jobs:
        pb, ps = port.query_events(job, pushdown=pushdown, with_scan=True,
                                   **PREDICATES[name])
        rb, rs = ref.query_events(job, pushdown=pushdown, with_scan=True,
                                  **PREDICATES[name])
        assert_batches_equal(pb, rb)
        assert vars(ps) == vars(rs)
        assert [vars(s) for s in port.segment_stats(job)] == \
            [vars(s) for s in ref.segment_stats(job)]


def test_time_range_and_budget_equal_the_reference(tmp_path, world):
    prog = world[0]
    a, b = twin(tmp_path, prog)
    port, ref = TraceArchive(a), RefArchive(b)
    full = ref.query_events("job-a")
    span = (float(full.start_ts.min()), float(np.median(full.end_ts)))
    for kw in (dict(time_range=span), dict(max_bytes=1),
               dict(step_range=(1, 4), max_bytes=4096)):
        pb, ps = port.query_events("job-a", with_scan=True, **kw)
        rb, rs = ref.query_events("job-a", with_scan=True, **kw)
        assert_batches_equal(pb, rb)
        assert vars(ps) == vars(rs)
    p = Predicate(step_range=(3, 3))
    r = RefPredicate(step_range=(3, 3))
    assert_batches_equal(port.query_events("job-m", p),
                         ref.query_events("job-m", r))


def test_metrics_and_rollups_equal_the_reference(tmp_path, world):
    prog = world[0]
    a, b = twin(tmp_path, prog)
    port, ref = TraceArchive(a), RefArchive(b)
    for job in port.jobs:
        assert port.rollups(job) == ref.rollups(job)
        for metric in (*SCALAR_METRICS, "rank_flops"):
            for kw in ({}, dict(bucket=2), dict(step_range=(1, 3)),
                       dict(max_bytes=1, with_truncation=True)):
                assert port.query_metrics(job, metric=metric, **kw) == \
                    ref.query_metrics(job, metric=metric, **kw), (job, metric)
    assert port.telemetry.snapshot()["counters"] == \
        ref.telemetry.snapshot()["counters"]
    with pytest.raises(ValueError):
        port.query_metrics("job-a", metric="no-such-metric")
    with pytest.raises(KeyError):
        port.query_metrics("job-x")


def test_anomalies_and_fleet_weather_equal_the_reference(tmp_path, world):
    """The archive's replay through each package's fleet: the same
    anomalies by job, team and time, and the same weather report."""
    prog, ref_hist, port_hist = world
    a, b = twin(tmp_path, prog, jobs=("job-a", "job-b"))
    for d in (a, b):
        for f in os.listdir(d):
            if f.startswith("job-m"):
                os.remove(os.path.join(d, f))
    port = TraceArchive(a, history=port_hist, engine_config=EngineConfig(
        backend="dense-train", num_ranks=N))
    ref = RefArchive(b, history=ref_hist, engine_config=RefConfig(
        backend="dense-train", num_ranks=N))
    want = rows(ref.query_anomalies(), ref_anomalies_json)
    assert rows(port.query_anomalies()) == want
    assert [r for r in want if r["job"] == "job-b"]
    for job in ("job-a", "job-b"):
        assert rows(port.query_anomalies(job=job)) == \
            rows(ref.query_anomalies(job=job), ref_anomalies_json)
    for team in Team:
        assert rows(port.query_anomalies(team=team)) == \
            rows(ref.query_anomalies(team=team.value), ref_anomalies_json)
    t0 = want[0]["ts"]
    assert rows(port.query_anomalies(time_range=(t0, t0 + 1.0))) == \
        rows(ref.query_anomalies(time_range=(t0, t0 + 1.0)),
             ref_anomalies_json)
    with pytest.raises(ValueError):
        port.query_anomalies(team="no-such-team")
    hits = port.telemetry.value("archive.replay_cache_hits")
    port.query_anomalies()
    assert port.telemetry.value("archive.replay_cache_hits") == hits + 1
    weather = port.fleet_weather()
    assert weather == ref.fleet_weather()
    assert weather["jobs"]["job-b"]["throughput_trend_pct"] < -5.0
    assert format_fleet_weather(weather) == ref_weather_text(weather)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_rollup_sidecars_cross_packages(tmp_path, world, writer):
    """Sidecars one package's archive wrote serve the other's cold archive
    from disk: no rollup built, the same answers; an appended segment
    makes its file's sidecar stale and that file alone is rebuilt."""
    prog = world[0]
    d = str(tmp_path / "side")
    write_archive(d, prog, steps=4, jobs=("job-a",))
    first, second = (TraceArchive, RefArchive) if writer == "port" \
        else (RefArchive, TraceArchive)
    curve = first(d).query_metrics("job-a", metric="throughput")
    sidecars = [p for p in os.listdir(d) if p.endswith(store.ROLLUP_SUFFIX)]
    assert len(sidecars) == 4
    cold = second(d)
    assert cold.query_metrics("job-a", metric="throughput") == curve
    assert cold.telemetry.value("archive.rollup_builds") == 0
    assert cold.telemetry.value("archive.rollup_disk_hits") == 4
    seg = per_step(ClusterSimulator(N, prog, seed=78).run_batch(5))[-1]
    target = sorted(p for p in os.listdir(d) if p.endswith(".fcs3"))[0]
    ref_store.write_fcs(seg, os.path.join(d, target), version=3)
    again = second(d)
    grown = again.query_metrics("job-a", metric="throughput")
    assert [s for s, _ in grown] == [0, 1, 2, 3, 4]
    assert grown == first(d).query_metrics("job-a", metric="throughput")
    assert again.telemetry.value("archive.rollup_builds") == 1
    assert again.telemetry.value("archive.rollup_disk_hits") == 3


def test_corrupt_sidecar_is_rebuilt_and_replay_ignores_sidecars(tmp_path,
                                                                 world):
    prog, _, port_hist = world
    d = str(tmp_path / "corrupt")
    write_archive(d, prog, steps=3, jobs=("job-a",))
    curve = TraceArchive(d).query_metrics("job-a", metric="throughput")
    side = sorted(p for p in os.listdir(d)
                  if p.endswith(store.ROLLUP_SUFFIX))[0]
    with open(os.path.join(d, side), "w") as f:
        f.write("{ not json")
    ar = TraceArchive(d)
    assert ar.query_metrics("job-a", metric="throughput") == curve
    assert ar.telemetry.value("archive.rollup_builds") == 1
    for f in os.listdir(d):
        if f.startswith("job-m"):
            os.remove(os.path.join(d, f))
    mux = FleetMultiplexer(FleetConfig(watermark_delay=1), history=port_hist)
    stats = FleetReplayer(mux).replay_dir(d)
    assert set(stats.per_job) == {"job-a"}
    assert stats.files == len([p for p in os.listdir(d)
                               if p.endswith(".fcs3")])
    assert stats.skipped_lines == 0 and stats.corrupt_files == 0


def test_telemetry_export_reads_across_packages(tmp_path, world):
    """A replay pipeline's telemetry exported by the port's archive reads
    back in the reference's, and the reference's in the port's, numbered
    upward."""
    prog, _, port_hist = world
    d = str(tmp_path / "tel")
    write_archive(d, prog, steps=4, jobs=("job-a",))
    mux = FleetMultiplexer(FleetConfig(watermark_delay=1), history=port_hist)
    mux.add_job("job-a", EngineConfig(backend="dense-train", num_ranks=N))
    FleetReplayer(mux).replay_dir(d)
    mux.finalize()
    snap = mux.telemetry_snapshot()
    assert snap["counters"]["fleet.late_rows{job=job-a}"] == 0
    assert snap["counters"]["replay.events{job=job-a}"] > 0
    port = TraceArchive(d)
    assert os.path.basename(port.export_telemetry(snap)) == \
        "telemetry-000.json"
    ref = RefArchive(d)
    assert os.path.basename(ref.export_telemetry(snap)) == \
        "telemetry-001.json"
    assert port.telemetry_snapshots() == ref.telemetry_snapshots()
    back = port.telemetry_snapshots()
    assert len(back) == 2 and back[0]["counters"] == snap["counters"]
    assert port.jobs == ["job-a", "job-m"]


def test_replayer_predicate_equals_the_reference(tmp_path, world):
    """Segments pruned by a step predicate are skipped and counted alike
    by both packages' replayers, with the same anomalies."""
    prog, ref_hist, port_hist = world
    a, b = twin(tmp_path, prog, jobs=("job-a",))
    for d in (a, b):
        for f in os.listdir(d):
            if f.startswith("job-m"):
                os.remove(os.path.join(d, f))
    out = []
    for mux_cls, fc, ec, rp, pred, d, hist, to_json in (
            (FleetMultiplexer, FleetConfig, EngineConfig, FleetReplayer,
             Predicate, a, port_hist, anomalies_json),
            (RefMux, RefFleetConfig, RefConfig, RefReplayer, RefPredicate,
             b, ref_hist, ref_anomalies_json)):
        got = []
        for p in (None, pred(step_range=(5, 5))):
            mux = mux_cls(fc(watermark_delay=1), history=hist)
            mux.add_job("job-a", ec(backend="dense-train", num_ranks=N))
            s = rp(mux, predicate=p).replay_dir(d)
            got.append((s.skipped_segments, s.bytes_skipped, s.events,
                        s.bytes_decoded, rows(mux.finalize(), to_json)))
        out.append(got)
    assert out[0] == out[1]
    (full, pruned) = out[0]
    assert full[0] == 0 and pruned[0] == 5 and 0 < pruned[2] < full[2]


def _slow_tail_job(path, t0):
    """Six steps of one rank, 1 s each but the last two, 2 s each: a
    fail-slow at steps 4 and 5 (the monitor's history needs 4 steps)."""
    from repro_torch.core.columnar import EventBatch
    from repro_torch.core.events import EventKind, TraceEvent
    evs, t = [], t0
    for s, dur in enumerate((1.0, 1.0, 1.0, 1.0, 2.0, 2.0)):
        evs.append(TraceEvent(EventKind.STEP, f"step_{s}", 0, t, t, t + dur,
                              step=s, meta={"tokens": 1000}))
        t += dur
    store.write_trace(EventBatch.from_events(evs), str(path))


def test_archive_resolves_the_fleet_tier_before_trailing_steps_close(
        tmp_path):
    """Kept from the reference on purpose: ``TraceArchive`` replays with
    ``flush=False``, and ``replay_dir`` resolves the fleet tier before the
    trailing steps close, so a job whose last step fails slow enters the
    cross-job correlation after a later job's earlier step.  Two jobs on
    one rack (job-b 20 s after job-a): a full replay names job-a's step 5
    as co-occurring, the archive its step 4; both packages alike."""
    d = tmp_path / "tail"
    d.mkdir()
    _slow_tail_job(d / "job-a.fcs", 0.0)
    _slow_tail_job(d / "job-b.fcs", 20.0)
    topo = {j: {"rack": "r0"} for j in ("job-a", "job-b")}
    got = {}
    for name, mux_cls, fc, ec, rp, ar_cls, hist, to_json in (
            ("port", FleetMultiplexer, FleetConfig, EngineConfig,
             FleetReplayer, TraceArchive, HistoryStore, anomalies_json),
            ("ref", RefMux, RefFleetConfig, RefConfig, RefReplayer,
             RefArchive, RefHistory, ref_anomalies_json)):
        cfg = fc(watermark_delay=1, fleet_detectors=["cross_job_failslow"],
                 topology=topo)
        mux = mux_cls(cfg, history=hist())
        for job in topo:
            mux.add_job(job, ec(backend="dense-train"))
        rp(mux).replay_dir(str(d))
        replay = rows(mux.finalize(), to_json)
        archive = rows(ar_cls(str(d), history=hist(),
                              engine_config=ec(backend="dense-train"),
                              fleet_config=cfg).query_anomalies(), to_json)
        got[name] = (replay, archive)
    assert got["port"] == got["ref"]
    replay, archive = got["port"]

    def co_occurring(found):
        return [r["evidence"]["co_occurring"]["job-a"]["step"]
                for r in found if r["origin"] == "fleet"]

    assert co_occurring(replay) == [5, 5]
    assert co_occurring(archive) == [4, 4]
    assert [r for r in replay if r["origin"] == "job"] == \
        [r for r in archive if r["origin"] == "job"]
