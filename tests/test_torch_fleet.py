"""The port's fleet layer against the JAX package's, on the CPU.

``repro_torch.fleet`` (``stream``, ``store``, ``multiplexer``, ``replay``,
``ipc``) is a numpy copy of ``repro.fleet``.  The same inputs go through
both packages: the JAX package's cluster simulator makes the batches,
which reach the port as FCS bytes (``repro.store.encode_batch_bytes``,
then the port's ``decode_batch_bytes``), and the recorded directories are
written by the reference's writers and read by each package's store.  Every
comparison is exact:

* each copy's syntax tree equals the reference's (docstrings and the
  package's name aside);
* a 32-rank world with underclocked jobs on one rack, gc, a hang and a
  healthy job, interleaved step by step into both packages' multiplexers
  with the ``cross_job_failslow`` tier: equal anomaly streams (job, event
  time, origin, route and every field), stats and telemetry;
* streaming equals batch: each job's streamed anomalies are its own
  engine's ``evaluate_all`` on the whole batch, and the reference's;
* a mixed JSONL / rotated FCS v1 / truncated FCS v2 / FCS v3 directory
  replayed serially, on threads and on 2 worker processes by the port, and
  serially by the reference: equal streams and ``ReplayStats``;
* ``max_pending_rows``, ``SharedInterner.merge_tables``, telemetry
  ``absorb``, ``ProcessWorkerPool`` batches round trip and its error
  propagation, as the reference's tests hold them, and equal to the
  reference's results;
* the daemon's fleet seam: ``attach_fleet`` builds the job's
  ``EngineConfig`` from ``DaemonConfig`` as the reference's daemon does,
  ``stop`` is idempotent and ``close`` stops a detached daemon again, and
  on a CPU ``Trainer`` (reduced llama) the live job's stream equals the
  replay of the same daemon's spill, by each package, with no late row.
"""
import json
import os
import subprocess
import sys
import time

import pytest

from repro import store as ref_store
from repro.configs import get_config
from repro.core.daemon import DaemonConfig as RefDaemonConfig
from repro.core.daemon import TracingDaemon as RefDaemon
from repro.core.engine import DiagnosticEngine as RefEngine
from repro.core.engine import EngineConfig as RefConfig
from repro.core.history import HistoryStore as RefHistory
from repro.core.report import anomalies_json as ref_anomalies_json
from repro.core.telemetry import TelemetryRegistry as RefTelemetry
from repro.core.timeline import ClusterSimulator, Injection, program_from_config
from repro.fleet import FleetConfig as RefFleetConfig
from repro.fleet import FleetMultiplexer as RefMux
from repro.fleet import FleetReplayer as RefReplayer
from repro.fleet import SharedInterner as RefInterner
from repro_torch import store
from repro_torch.configs import get_reduced
from repro_torch.core.daemon import DaemonConfig, TracingDaemon
from repro_torch.core.engine import DiagnosticEngine, EngineConfig
from repro_torch.core.events import EventKind
from repro_torch.core.history import HistoryStore
from repro_torch.core.report import anomalies_json
from repro_torch.core.telemetry import TelemetryRegistry
from repro_torch.fleet import (FleetConfig, FleetMultiplexer, FleetReplayer,
                               ReplayStats, SharedInterner)
from repro_torch.runtime.train import RunConfig, Trainer
from torch_ast import tree

N = 32
FLEET_COPIES = ["fleet/stream.py", "fleet/store.py", "fleet/multiplexer.py",
                "fleet/replay.py", "fleet/ipc.py", "fleet/__init__.py"]
SCENARIOS = {
    "healthy": [],
    "gc": [Injection(kind="gc", duration=0.02, period_ops=5)],
    "underclock": [Injection(kind="underclock", ranks=(5,), factor=2.5,
                             start_step=3)],
    "jitter": [Injection(kind="network_jitter", factor=3.0, start_step=3)],
    "hang": [Injection(kind="hang", ranks=(7,), at_step=2)],
}


def to_port(batch):
    """A JAX-package ``EventBatch`` as the port's, through FCS bytes."""
    return store.decode_batch_bytes(ref_store.encode_batch_bytes(batch))


def rows(fleet_anomalies, to_json=anomalies_json) -> list:
    """A stream as plain rows: job, event time, origin, route and the
    anomaly as its package's ``anomalies_json`` writes it."""
    fas = list(fleet_anomalies)
    found = json.loads(to_json([fa.anomaly for fa in fas]))
    return [dict(job=fa.job_id, ts=fa.ts, origin=fa.origin, route=fa.route,
                 **a) for fa, a in zip(fas, found)]


def signature(stats) -> dict:
    return dict(files=stats.files, events=stats.events,
                skipped_lines=stats.skipped_lines,
                corrupt_files=stats.corrupt_files,
                skipped_segments=stats.skipped_segments,
                bytes_decoded=stats.bytes_decoded,
                bytes_skipped=stats.bytes_skipped,
                per_job=dict(stats.per_job))


def step_chunks(batch) -> list:
    order, uniq, bounds = batch.step_index()
    return [batch.take(order[bounds[i]:bounds[i + 1]])
            for i in range(uniq.size)]


@pytest.fixture(scope="module")
def world():
    """The simulator's 32-rank program and a healthy profile learned from
    the same three runs by each package's engine."""
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


@pytest.mark.parametrize("rel", FLEET_COPIES)
def test_copied_module_is_the_reference_but_for_names_and_docstrings(rel):
    assert tree("repro_torch", rel) == tree("repro", rel)


def test_fleet_modules_import_no_torch():
    """The fleet is numpy, as the reference's: importing it (and the
    archive) in a fresh interpreter loads no torch."""
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    code = ("import sys, repro_torch.fleet, repro_torch.archive; "
            "print('torch' in sys.modules, 'jax' in sys.modules, "
            "'repro' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": src})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False", "False"]


RACKS = {"job-a": {"rack": "r0", "switch": "s0"},
         "job-b": {"rack": "r0", "switch": "s0"},
         "job-c": {"rack": "r1", "switch": "s1"},
         "job-d": {"rack": "r1", "switch": "s1"}}
WORLD_JOBS = {
    "job-a": (11, [Injection(kind="underclock", ranks=(5,), factor=2.5,
                             start_step=3)]),
    "job-b": (12, [Injection(kind="underclock", ranks=(9,), factor=2.5,
                             start_step=3)]),
    "job-c": (13, SCENARIOS["gc"]),
    "job-d": (14, []),
    "job-e": (15, SCENARIOS["hang"]),
}


def test_fleet_stream_equals_the_reference(world):
    """Two underclocked jobs on one rack, gc, a healthy job and a hang,
    interleaved step by step into each package's multiplexer with the
    fleet tier on and polled after every round: the same stream, the
    cross-job reclassification among it, and the same stats and
    telemetry."""
    prog, ref_hist, port_hist = world
    ref = RefMux(RefFleetConfig(watermark_delay=1,
                                fleet_detectors=["cross_job_failslow"]),
                 history=ref_hist)
    port = FleetMultiplexer(FleetConfig(
        watermark_delay=1, fleet_detectors=["cross_job_failslow"]),
        history=port_hist)
    chunks = {}
    for job, (seed, inj) in WORLD_JOBS.items():
        b = ClusterSimulator(N, prog, seed=seed, injections=inj).run_batch(6)
        chunks[job] = step_chunks(b)
        ref.add_job(job, RefConfig(backend="dense-train", num_ranks=N))
        port.add_job(job, EngineConfig(backend="dense-train", num_ranks=N))
        if job in RACKS:
            ref.set_topology(job, **RACKS[job])
            port.set_topology(job, **RACKS[job])
    got_ref, got_port = [], []
    while any(chunks.values()):
        for job, cs in chunks.items():
            if cs:
                c = cs.pop(0)
                ref.ingest(job, c)
                port.ingest(job, to_port(c))
        got_ref += rows(ref.poll(), ref_anomalies_json)
        got_port += rows(port.poll())
    got_ref += rows(ref.finalize(), ref_anomalies_json)
    got_port += rows(port.finalize())
    assert got_port == got_ref
    fleet_jobs = {r["job"] for r in got_port if r["origin"] == "fleet"}
    assert fleet_jobs == {"job-a", "job-b"}
    assert all(r["metric"] == "cross_job_correlation"
               and r["team"] == "infrastructure"
               for r in got_port if r["origin"] == "fleet")
    assert any(r["job"] == "job-e" and r["kind"] == "hang"
               for r in got_port)
    assert not [r for r in got_port if r["job"] == "job-d"]
    assert port.stats() == ref.stats()
    assert port.telemetry.snapshot()["counters"] == \
        ref.telemetry.snapshot()["counters"]


def test_streaming_equals_batch_per_job(world):
    """Each job's streamed anomalies equal its engine's terminal
    ``evaluate_all``, the port's and the reference's, with the jobs
    multiplexed into one fleet and interleaved."""
    prog, ref_hist, port_hist = world
    mux = FleetMultiplexer(FleetConfig(watermark_delay=1), history=port_hist)
    oracle, pending = {}, {}
    for name, inj in SCENARIOS.items():
        b = ClusterSimulator(N, prog, seed=7, injections=inj).run_batch(6)
        ref_eng = RefEngine(RefConfig(backend="dense-train", num_ranks=N),
                            ref_hist)
        ref_eng.ingest_batch(b)
        port_eng = DiagnosticEngine(
            EngineConfig(backend="dense-train", num_ranks=N), port_hist)
        port_eng.ingest_batch(to_port(b))
        oracle[name] = anomalies_json(port_eng.evaluate_all())
        assert oracle[name] == ref_anomalies_json(ref_eng.evaluate_all())
        mux.add_job(name, EngineConfig(backend="dense-train", num_ranks=N))
        pending[name] = step_chunks(to_port(b))
    while any(pending.values()):
        for name, cs in pending.items():
            if cs:
                mux.ingest(name, cs.pop(0))
    got = {name: [] for name in SCENARIOS}
    for fa in sorted(mux.poll() + mux.finalize(), key=lambda a: a.seq):
        got[fa.job_id].append(fa.anomaly)
    for name in SCENARIOS:
        assert anomalies_json(got[name]) == oracle[name], name
    assert json.loads(oracle["healthy"]) == []
    assert all(json.loads(oracle[k]) for k in ("gc", "underclock", "hang"))


def write_mixed_dir(logdir, prog) -> dict:
    """Five jobs in five storage shapes, written by the reference: JSONL,
    FCS v1 rotated one segment a step, FCS v2 with a torn tail, one FCS v1
    file, FCS v3 one segment a step.  job-b and job-c (underclock, jitter)
    share a rack.  Returns the topology."""
    os.makedirs(logdir, exist_ok=True)
    b = ClusterSimulator(N, prog, seed=11,
                         injections=SCENARIOS["gc"]).run_batch(5)
    b.write_jsonl(os.path.join(logdir, "job-a.jsonl"))
    b = ClusterSimulator(N, prog, seed=12,
                         injections=SCENARIOS["underclock"]).run_batch(5)
    w = ref_store.SegmentedTraceWriter(os.path.join(logdir, "job-b.fcs"),
                                       codec="fcs", rotate_bytes=1)
    for c in step_chunks(b):
        w.write(c)
    assert len(w.paths) >= 3
    b = ClusterSimulator(N, prog, seed=13,
                         injections=SCENARIOS["jitter"]).run_batch(5)
    cp = os.path.join(logdir, "job-c.fcs2")
    ref_store.write_fcs(b, cp, version=2)
    intact = os.path.getsize(cp)
    ref_store.write_fcs(b, cp, version=2)
    with open(cp, "r+b") as f:
        f.truncate(intact + 57)
    ref_store.write_fcs(ClusterSimulator(N, prog, seed=14).run_batch(5),
                        os.path.join(logdir, "job-d.fcs"))
    b = ClusterSimulator(N, prog, seed=15,
                         injections=SCENARIOS["gc"]).run_batch(5)
    for c in step_chunks(b):
        ref_store.write_fcs(c, os.path.join(logdir, "job-e.fcs3"), version=3)
    return {j: {"rack": "r0", "switch": "s0"} for j in ("job-b", "job-c")}


def _replay(mux, add_cfg, logdir, topo, **kw):
    # registered in reverse order: equality must not lean on registration
    # order matching the replayer's sorted-path order
    for job in ("job-e", "job-d", "job-c", "job-b", "job-a"):
        mux.add_job(job, add_cfg())
        if job in topo:
            mux.set_topology(job, **topo[job])
    return mux


def test_replay_of_a_mixed_dir_equals_the_reference(world, tmp_path):
    """The port's serial, thread (4) and process (2) replays of one mixed
    directory equal each other and the reference's serial replay: the
    stream (the fleet tier's reclassification among it), the stats and
    each job's end state."""
    prog, ref_hist, port_hist = world
    logdir = str(tmp_path / "logs")
    topo = write_mixed_dir(logdir, prog)
    tier = ["cross_job_failslow"]
    ref = _replay(RefMux(RefFleetConfig(watermark_delay=1,
                                        fleet_detectors=tier),
                         history=ref_hist),
                  lambda: RefConfig(backend="dense-train", num_ranks=N),
                  logdir, topo)
    ref_stats = RefReplayer(ref).replay_dir(logdir, job_workers=1)
    want = rows(ref.poll(), ref_anomalies_json)
    assert [r for r in want if r["origin"] == "fleet"]
    assert ref_stats.corrupt_files == 1
    for workers, kind in ((1, "thread"), (4, "thread"), (2, "process")):
        port = _replay(FleetMultiplexer(FleetConfig(watermark_delay=1,
                                                    fleet_detectors=tier),
                                        history=port_hist),
                       lambda: EngineConfig(backend="dense-train",
                                            num_ranks=N),
                       logdir, topo)
        stats = FleetReplayer(port).replay_dir(logdir, job_workers=workers,
                                               worker_kind=kind)
        assert rows(port.poll()) == want, (workers, kind)
        assert signature(stats) == signature(ref_stats), (workers, kind)
        assert (stats.worker_kind, stats.job_workers) == \
            ({1: "serial"}.get(workers, kind), workers)
        assert port.stats() == ref.stats()


def test_max_pending_rows_forced_close_equals_the_reference(world):
    """The per-job row cap: oldest steps force-closed, counted, the
    newest kept, deterministic, and the reference's outcome."""
    prog, ref_hist, port_hist = world
    b = ClusterSimulator(N, prog, seed=71,
                         injections=SCENARIOS["gc"]).run_batch(6)
    chunks = step_chunks(b)
    cap = max(len(c) for c in chunks) + 1

    def run(mux, cfg, convert, to_json):
        mux.add_job("job-m", cfg)
        for c in chunks:
            mux.ingest("job-m", convert(c))
        job = mux.job("job-m")
        held = (job.store.buffered_rows, list(job.store.pending_steps()),
                mux.telemetry.counter("fleet.forced_closes",
                                      job="job-m").value)
        return held, rows(mux.finalize(), to_json)

    def port(c=cap):
        return run(FleetMultiplexer(FleetConfig(watermark_delay=100,
                                                max_pending_rows=c),
                                    history=port_hist),
                   EngineConfig(backend="dense-train", num_ranks=N), to_port,
                   anomalies_json)

    (buffered, pending, forced), found = port()
    assert forced >= 1
    assert buffered <= cap or len(pending) == 1
    assert pending[-1] == max(int(c.step[0]) for c in chunks)
    assert port() == ((buffered, pending, forced), found)
    assert port(None)[0][2] == 0
    ref = run(RefMux(RefFleetConfig(watermark_delay=100,
                                    max_pending_rows=cap), history=ref_hist),
              RefConfig(backend="dense-train", num_ranks=N), lambda c: c,
              ref_anomalies_json)
    assert ref == ((buffered, pending, forced), found)


def test_shared_interner_merge_tables_equals_the_reference():
    got = []
    for cls in (SharedInterner, RefInterner):
        si = cls()
        ids = [si.intern_name("alpha"), si.intern_group("g0")]
        si.merge_tables(["beta", "alpha", "gamma"], ["g1", "g0"])
        first = (list(si.names), list(si.groups))
        si.merge_tables(["gamma", "delta"], [])
        got.append((ids, first, list(si.names), list(si.groups)))
    assert got[0] == got[1]
    assert got[0] == ([0, 0], (["alpha", "beta", "gamma"], ["g0", "g1"]),
                      ["alpha", "beta", "gamma", "delta"], ["g0", "g1"])


def test_telemetry_absorb_equals_the_reference():
    """Counters add (a zero series still appears), gauges take the last
    write, extra tags re-tag: the same snapshots in both packages."""
    snaps = []
    for cls in (TelemetryRegistry, RefTelemetry):
        worker = cls()
        worker.counter("fleet.late_rows", job="a").inc(3)
        worker.counter("fleet.zero", job="a")
        worker.gauge("fleet.watermark_lag", job="a").set(2.0)
        parent = cls()
        parent.counter("fleet.late_rows", job="a").inc(1)
        parent.absorb(worker.snapshot())
        assert parent.counter("fleet.late_rows", job="a").value == 4
        assert parent.counter("fleet.zero", job="a").value == 0
        assert parent.gauge("fleet.watermark_lag", job="a").value == 2.0
        parent.absorb(worker.snapshot(), extra_tags={"shard": "1"})
        assert parent.counter("fleet.late_rows", job="a",
                              shard="1").value == 3
        snap = parent.snapshot()
        snaps.append((snap["counters"], snap["gauges"]))
    assert snaps[0] == snaps[1]


def test_process_pool_batches_round_trip_equals_local_ingest(world):
    """Batches shipped to a worker process as FCS bytes (``TASK_BATCHES``)
    diagnose as a local ``ingest`` of the same chunks does, in the port's
    multiplexer and in the reference's."""
    from repro_torch.fleet.ipc import TASK_BATCHES, ProcessWorkerPool
    prog, ref_hist, port_hist = world
    batch = ClusterSimulator(N, prog, seed=61,
                             injections=SCENARIOS["gc"]).run_batch(5)
    chunks = [to_port(c) for c in step_chunks(batch)]
    cfg = EngineConfig(backend="dense-train", num_ranks=N)

    ref = RefMux(RefFleetConfig(watermark_delay=1), history=ref_hist)
    ref.add_job("job-x", RefConfig(backend="dense-train", num_ranks=N))
    for c in step_chunks(batch):
        ref.ingest("job-x", c)
    ref.flush("job-x")
    want = rows(ref.poll(), ref_anomalies_json)
    assert want

    local = FleetMultiplexer(FleetConfig(watermark_delay=1),
                             history=port_hist)
    local.add_job("job-x", cfg)
    for c in chunks:
        local.ingest("job-x", c)
    local.flush("job-x")
    assert rows(local.poll()) == want

    mux = FleetMultiplexer(FleetConfig(watermark_delay=1), history=port_hist)
    mux.add_job("job-x", cfg)
    init = {"history": port_hist,
            "fleet": {"watermark_delay": 1, "backend": mux.cfg.backend,
                      "max_pending_rows": None},
            "replay": {}}

    def on_anomalies(job_id, items):
        for ts, a in items:
            mux.stream.push(job_id, a, ts)
            mux.job(job_id).count_anomaly()

    pool = ProcessWorkerPool(1, init)
    try:
        pool.submit((TASK_BATCHES, "job-x",
                     [store.encode_batch_bytes(c) for c in chunks], cfg,
                     False))
        results = pool.drain(on_anomalies=on_anomalies)
    finally:
        pool.close()
    res = results["job-x"]
    mux.interner.merge_tables(res["names"], res["groups"])
    mux.telemetry.absorb(res["telemetry"])
    mux.restore_job_state("job-x", res["state"])
    assert rows(mux.poll()) == want
    assert res["stats"].events == len(batch)
    assert res["stats"].per_job == {"job-x": len(batch)}
    assert res["stats"].worker_kind == "process"
    assert mux.stats() == local.stats() == ref.stats()


def test_process_pool_worker_error_propagates(world):
    """A task that fails in a worker surfaces as a RuntimeError naming
    the job, not as a hang or silence."""
    from repro_torch.fleet.ipc import ProcessWorkerPool
    pool = ProcessWorkerPool(1, {"history": world[2],
                                 "fleet": {"watermark_delay": 1},
                                 "replay": {}})
    try:
        pool.submit(("no-such-kind", "job-bad", [], None, False))
        with pytest.raises(RuntimeError, match="job-bad"):
            pool.drain()
    finally:
        pool.close()


def test_replay_stats_merge():
    a = ReplayStats(files=2, events=10, skipped_lines=1, per_job={"a": 10})
    a.merge(ReplayStats(files=1, events=5, corrupt_files=2,
                        per_job={"b": 5}))
    assert (a.files, a.events, a.skipped_lines, a.corrupt_files) == \
        (3, 15, 1, 2)
    assert a.per_job == {"a": 10, "b": 5}


# --------------------------------------------------------------------- #
# the daemon's fleet seam                                               #
# --------------------------------------------------------------------- #
DAEMON_CONFIGS = {
    "default": {},
    "detectors": {"detectors": ["failslow", "hang"]},
    "ranks": {"num_ranks": 8},
    "backend": {"backend": "case2-ffn"},
    "all": {"backend": "moe-train", "num_ranks": 4,
            "detectors": ["failslow"]},
}


@pytest.mark.parametrize("name", list(DAEMON_CONFIGS))
def test_attach_fleet_builds_the_engine_config_as_the_reference(name):
    """Without an explicit ``EngineConfig``, a daemon with any non-default
    ``backend``, ``num_ranks`` or ``detectors`` configures its job's
    engine from them; an all-default one leaves it to the fleet's
    backend; an explicit one wins.  As the reference's daemon does."""
    kw = DAEMON_CONFIGS[name]
    got = []
    for mux_cls, cfg_cls, d_cls, dc_cls, e_cls in (
            (FleetMultiplexer, FleetConfig, TracingDaemon, DaemonConfig,
             EngineConfig),
            (RefMux, RefFleetConfig, RefDaemon, RefDaemonConfig, RefConfig)):
        mux = mux_cls(cfg_cls(backend="fleet-default"))
        d = d_cls(dc_cls(rank=3, **kw))
        d.attach_fleet(mux)
        d.attach_fleet(mux, "explicit", e_cls(backend="x", num_ranks=2))
        assert mux.job("job-rank3").daemon is d
        got.append([(c.backend, c.num_ranks, c.detectors, c.kernel_shapes)
                    for c in (mux.job("job-rank3").engine.cfg,
                              mux.job("explicit").engine.cfg)])
        d.stop()
    assert got[0] == got[1]
    want = ("fleet-default", 1, None) if not kw else (
        kw.get("backend", "dense-train"), kw.get("num_ranks", 1),
        kw.get("detectors"))
    assert got[0][0][:3] == want
    assert got[0][1][:2] == ("x", 2)


def test_daemon_attach_fleet_and_idempotent_stop():
    """The reference's seam test on the port's daemon (CPU: no anchors):
    spans recorded live reach the fleet; a second ``stop`` and the fleet's
    ``close`` after it are no-ops for the daemon."""
    mux = FleetMultiplexer(FleetConfig(watermark_delay=0))
    d = TracingDaemon(DaemonConfig(rank=0, drain_interval=0.01,
                                   hang_timeout=1e9))
    d.attach_fleet(mux, "live-job")
    assert mux.job("live-job").daemon is d
    d.attach()
    for s in range(2):
        d.step_begin(s)
        d.record_span(EventKind.KERNEL_COMPUTE, "k", 0.0, 1.0, flops=5.0)
        d.step_end(tokens=16)
    time.sleep(0.2)
    d.stop()
    d.stop()
    mux.close()
    st = mux.stats()["live-job"]
    assert st["events"] >= 4 and st["ranks"] == 1
    assert st["steps_evaluated"] == 2
    mux.close()


def test_daemon_fleet_seam_sees_hang_suspects_live():
    """A hang_suspect event is never held back with its open step: the
    fleet declares the job's hang from the live drain."""
    mux = FleetMultiplexer(FleetConfig(watermark_delay=1))
    d = TracingDaemon(DaemonConfig(rank=0, drain_interval=0.01,
                                   hang_timeout=0.05))
    d.attach_fleet(mux, "hung", EngineConfig(backend="ring", num_ranks=1))
    d.set_stack(["step_0", "ring_all_reduce"])
    d.attach()
    d.step_begin(0)
    deadline = time.perf_counter() + 30
    while not mux.job("hung").hang_reported:
        assert time.perf_counter() < deadline, "no hang declared"
        time.sleep(0.02)
    d.stop()
    found = [fa for fa in mux.close() if fa.anomaly.kind == "hang"]
    assert len(found) == 1 and found[0].route == "oncall-operations"
    assert mux.job("hung").store.hang_stacks[0] == \
        ["step_0", "ring_all_reduce"]


SLOW_STEPS = (7, 8)      # the CPU job's steps made slow by its fault hook


class SlowSteps:
    """A fault hook that makes each of ``SLOW_STEPS`` three times as long
    as the longest step before it, by sleeping: whatever the machine's
    load, its throughput drops below a third of the median of the steps
    the fail-slow check compares it with."""

    def __init__(self):
        self.last, self.longest = None, 0.0

    def __call__(self, step):
        now = time.perf_counter()
        if self.last is not None:
            self.longest = max(self.longest, now - self.last)
        if step in SLOW_STEPS:
            time.sleep(3 * self.longest)
        self.last = time.perf_counter()


def _cpu_run(steps, log=None, fleet=None, job=None, cfg=None,
             hook=None) -> tuple:
    run = RunConfig(model=get_reduced("llama3.2-1b"), global_batch=2,
                    seq_len=64, steps=steps, warmup_steps=2, flare=True,
                    mask_mode="fast", flare_log=log, data_prefetch=True,
                    device="cpu")
    trainer = Trainer(run, fault_hook=hook)
    events: list = []
    trainer.daemon.add_sink(events.extend)
    if fleet is not None:
        trainer.daemon.attach_fleet(fleet, job, cfg)
    trainer.train()
    return trainer, events


def test_live_trainer_job_equals_the_replay_of_its_spill(tmp_path):
    """A reduced llama trained on the CPU with its daemon attached to a
    fleet (two steps slowed by its fault hook, against a profile learned
    from a run without): the live stream has no late row, names the
    fail-slow, equals the batch engine on the daemon's events, the port's
    replay of its FCS spill with the profile read back from JSON, and the
    reference's replay of the same spill; ``close`` after the trainer
    detached its daemon stops it again harmlessly."""
    hist = HistoryStore(str(tmp_path / "history"))
    _, healthy = _cpu_run(6)
    eng = DiagnosticEngine(EngineConfig(backend="dense-train"), hist)
    eng.ingest(healthy)
    eng.learn_healthy(steps=list(range(1, 6)))
    mux = FleetMultiplexer(FleetConfig(watermark_delay=1), history=hist)
    cfg = EngineConfig(backend="dense-train")
    spill = tmp_path / "fleet" / "cpu-job.fcs"
    spill.parent.mkdir()
    trainer, events = _cpu_run(10, str(spill), mux, "cpu-job", cfg,
                               SlowSteps())
    assert not trainer.daemon._attached
    live = mux.poll() + mux.close()
    assert mux.job("cpu-job").late_events == 0
    assert mux.telemetry.value("fleet.forced_closes", job="cpu-job") == 0
    assert len(mux.job("cpu-job").evaluated) == 10
    batch = DiagnosticEngine(cfg, hist)
    batch.ingest(events)
    assert anomalies_json([fa.anomaly for fa in sorted(
        live, key=lambda a: a.seq)]) == anomalies_json(batch.evaluate_all())
    want = rows(live)
    assert any(r["kind"] == "fail_slow" and r["metric"] == "throughput"
               and r["step"] == SLOW_STEPS[0] for r in want)

    again = FleetMultiplexer(FleetConfig(watermark_delay=1),
                             history=HistoryStore(str(tmp_path / "history")))
    again.add_job("cpu-job", cfg)
    stats = FleetReplayer(again).replay_dir(str(spill.parent))
    assert rows(again.poll()) == want
    assert stats.per_job == {"cpu-job": len(events)}
    assert again.job("cpu-job").late_events == 0

    ref = RefMux(RefFleetConfig(watermark_delay=1),
                 history=RefHistory(str(tmp_path / "history")))
    ref.add_job("cpu-job", RefConfig(backend="dense-train"))
    RefReplayer(ref).replay_dir(str(spill.parent))
    assert rows(ref.poll(), ref_anomalies_json) == want


def _replay_tool():
    """``tools/fleet_replay.py`` as a module."""
    import importlib.util
    path = os.path.join(os.path.dirname(__file__), os.pardir, "tools",
                        "fleet_replay.py")
    spec = importlib.util.spec_from_file_location("fleet_replay", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, path


def test_replay_tool_equals_an_in_process_replay(world, tmp_path):
    """``tools/fleet_replay.py`` (the card's process replay): its spec and
    the profiles saved as JSON give an in-process replay's stream and
    stats, and run as a command in an interpreter of its own, with 2
    worker processes, the same stream without importing torch."""
    prog, _, port_hist = world
    logdir = tmp_path / "logs"
    topo = write_mixed_dir(str(logdir), prog)
    saved = HistoryStore(str(tmp_path / "history"))
    for prof in port_hist.snapshot_profiles().values():
        saved.put(prof)
    tool, path = _replay_tool()
    cfg = FleetConfig(watermark_delay=1, fleet_detectors=["cross_job_failslow"],
                      topology=topo)
    spec = tmp_path / "spec.json"
    tool.write_spec(spec, {j: EngineConfig(backend="dense-train", num_ranks=N,
                                           kernel_shapes={"mm": (8192, 8484)})
                           for j in ("job-a", "job-b", "job-c", "job-d",
                                     "job-e")}, cfg)
    assert tool.read_spec(spec)[1]["job-a"].kernel_shapes == \
        {"mm": (8192, 8484)}
    got = tool.replay(logdir, tmp_path / "history", spec)
    mux = _replay(FleetMultiplexer(cfg, history=port_hist),
                  lambda: EngineConfig(backend="dense-train", num_ranks=N,
                                       kernel_shapes={"mm": (8192, 8484)}),
                  str(logdir), {})
    stats = FleetReplayer(mux).replay_dir(str(logdir), job_workers=1)
    assert got["stream"] == tool.stream_rows(mux.finalize())
    assert got["stats"] == signature(stats)
    assert [r for r in got["stream"] if r["origin"] == "fleet"]
    out = subprocess.run(
        [sys.executable, path, str(logdir), "--history",
         str(tmp_path / "history"), "--spec", str(spec), "--job-workers",
         "2", "--worker-kind", "process"], capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    child = json.loads(out.stdout.splitlines()[-1])
    assert child["stream"] == got["stream"]
    assert child["stats"] == got["stats"]
    assert (child["worker_kind"], child["job_workers"]) == ("process", 2)
    assert child["torch_imported"] is False
    assert not any(child["late_rows"].values())
