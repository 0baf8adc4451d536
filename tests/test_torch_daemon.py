"""The port's tracing daemon (``repro_torch.core.daemon``) on the CPU: its
clock mapping, its spill plane and its config and sink semantics, against
the JAX package's daemon, store and metrics.

* The clock: fake CUDA events whose clock runs 3 ppm slow against a fake
  ``perf_counter`` drive the mapping.  Through the one anchor taken at
  attach, a span issued 10 s later maps 23 µs before its issue; with the
  daemon loop's anchors it maps at or after it, late by no more than an
  on-time anchor's wait, even when most anchors are 5 ms late (the GIL),
  and its duration is its event pair's ``elapsed_time``.
* The spill: by extension or ``log_codec`` / ``log_compression`` (JSONL,
  FCS v1, FCS v2), rotated; each drain one segment, equal to the batch
  sink's batch and to the sink's events, bitwise (JSONL: times rounded to
  1e-6 s), and read back by the JAX package's ``repro.store`` alike.
* A reduced llama ``Trainer`` spilling FCS gives through
  ``repro.core.metrics.aggregate_step`` the per-step results of the same
  run's JSONL, bitwise once the FCS times are rounded as JSONL rounds them.
* The reference's config semantics: ``enabled=False`` attaches nothing,
  ``reconstruct=False`` leaves stacks alone, a failing sink or batch sink
  is swallowed, spill errors are counted and warned once, ``stop()`` is
  idempotent; the config's fields and defaults are the reference's.  A
  daemon attached unpublished times only what it is handed.
"""
import dataclasses
import time
import warnings

import numpy as np
import pytest
import torch

from repro import store as ref_store
from repro.core import daemon as ref_daemon
from repro.core import events as ref_events
from repro.core.metrics import aggregate_step
from repro_torch import store as port_store
from repro_torch.core import daemon as dmod
from repro_torch.core.events import EventKind
from repro_torch.store.fcs import _HEADER
from test_torch_store import as_tuples, jsonl_rounded

def test_config_fields_and_defaults_are_the_references():
    """Every field of the reference's ``DaemonConfig``, the live plane's
    ``live_endpoint``, ``live_job_id`` and ``live_topology`` among them, in
    its order and with its default."""
    ref = {f.name: f.default for f in dataclasses.fields(
        ref_daemon.DaemonConfig)}
    port = {f.name: f.default for f in dataclasses.fields(dmod.DaemonConfig)}
    assert list(port.items()) == list(ref.items())
    assert {"live_endpoint", "live_job_id", "live_topology"} <= set(port)
    assert dmod.DaemonConfig().backend == "dense-train"


# ------------------------------------------------------------------ clock
class FakeWorld:
    """The host's ``perf_counter`` (``t``) and ``sleep``; an event's wait
    returns ``SYNC`` after the card recorded it, and ``GIL`` later still
    where ``late(n)`` holds for the n-th wait."""
    SYNC = 5e-6
    GIL = 5e-3

    def __init__(self, late=lambda n: False):
        self.t = 1000.0
        self.late, self.waits = late, 0

    def perf_counter(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


class FakeEvent:
    """A timing event on a card whose clock runs 3 ppm slow against the
    host's."""
    PPM = 3e-6

    def __init__(self, world):
        self.world, self.dev = world, None

    def record(self, stream=None):
        self.dev = self.world.t * (1 - self.PPM)

    def query(self):
        return True

    def synchronize(self):
        w = self.world
        w.t += w.SYNC + (w.GIL if w.late(w.waits) else 0.0)
        w.waits += 1

    def elapsed_time(self, other):
        return (other.dev - self.dev) * 1e3


def span_after_a_long_attach(monkeypatch, loops: bool,
                             late=lambda n: False):
    """Attach, run 10 s (with the daemon's loops, or none: the anchor taken
    at attach alone; ``late``: which anchors' waits return ``GIL`` late),
    then one op whose kernel starts 2 µs after its issue and runs 100 µs;
    returns its span, its event pair and the daemon."""
    world = FakeWorld(late)
    monkeypatch.setattr(dmod, "time", world)
    monkeypatch.setattr(dmod, "_timing_event", lambda: FakeEvent(world))
    d = dmod.TracingDaemon(dmod.DaemonConfig(drain_interval=0.05))
    spans = []
    d.add_sink(spans.extend)
    d._stream = "side"              # what attach() sets up on a card
    d._take_anchor()                # attach's anchor
    t_attach = world.t
    while world.t < t_attach + 10.0:
        if loops:
            d._tick()
        world.sleep(d.cfg.drain_interval)
    issue = world.t
    world.t += 2e-6
    ev0 = FakeEvent(world)
    ev0.record()
    world.t += 1e-4
    ev1 = FakeEvent(world)
    ev1.record()
    d._pending.put(("fused_residual_rmsnorm", EventKind.KERNEL_COMPUTE,
                    issue, 0, {}, (ev0, ev1)))
    world.sleep(d.cfg.drain_interval)
    if loops:
        d._tick()
    d._probe_pending(wait=True)
    d._flush(final=True)
    (span,) = [e for e in spans if e.name == "fused_residual_rmsnorm"]
    return span, (ev0, ev1), d


def test_one_anchor_maps_a_late_span_before_its_issue(monkeypatch):
    """The fault: 10 s after the one anchor, 3 ppm of drift (30 µs) exceed
    the anchor's lateness (5 µs) and the kernel's real 2 µs issue
    latency."""
    span, _, _ = span_after_a_long_attach(monkeypatch, loops=False)
    assert span.issue_latency == pytest.approx(
        2e-6 + FakeWorld.SYNC - 10.05 * FakeEvent.PPM, abs=1e-7)
    assert span.issue_latency < 0


def test_the_loops_anchors_map_every_span_at_or_after_its_issue(
        monkeypatch):
    """The repair: an anchor each loop, and a span maps through the least
    late of those within ``ANCHOR_WINDOW_S`` of it: its issue latency is
    the real 2 µs plus an anchor's wait, less at most the window's drift
    (1.5 µs), and its duration is its pair's."""
    span, (ev0, ev1), d = span_after_a_long_attach(monkeypatch, loops=True)
    assert span.issue_latency >= 0
    assert (FakeWorld.SYNC - dmod.ANCHOR_WINDOW_S * FakeEvent.PPM - 1e-9
            <= span.issue_latency - 2e-6 <= FakeWorld.SYNC)
    assert span.end_ts == span.start_ts + ev0.elapsed_time(ev1) / 1e3
    assert d.telemetry.value("daemon.anchors") == 202
    assert d.telemetry.value("daemon.anchor_bracket_max_s") == \
        pytest.approx(FakeWorld.SYNC)
    assert len(d._anchors) == dmod.ANCHORS_KEPT


def test_late_anchors_do_not_carry_into_a_span(monkeypatch):
    """Three anchors in four come back 5 ms late (the daemon thread waiting
    for the GIL), the newest before the span among them: the span still
    maps through an on-time anchor, late by no more than its wait."""
    span, (ev0, _), d = span_after_a_long_attach(
        monkeypatch, loops=True, late=lambda n: n % 4 != 0)
    anchor, host, _ = [a for a in d._anchors if a[0].dev <= ev0.dev][-1]
    assert host - anchor.dev / (1 - FakeEvent.PPM) >= FakeWorld.GIL
    assert (FakeWorld.SYNC - dmod.ANCHOR_WINDOW_S * FakeEvent.PPM - 1e-9
            <= span.issue_latency - 2e-6 <= FakeWorld.SYNC)


# ------------------------------------------------------------------ spill
def drive(d, steps: int = 6, flush: bool = True):
    """``steps`` daemon steps without the daemon thread, each a CPU traced
    op, a dataloader span and the step span, flushed after each step: one
    drain, one spill segment a step."""
    x = torch.ones(4, 8)
    for step in range(steps):
        d.step_begin(step)
        d.record_span(EventKind.DATALOADER, "dataloader.next_batch",
                      d._step_t0, time.perf_counter(), tokens=32)
        d.trace_call("fused_residual_rmsnorm", EventKind.KERNEL_COMPUTE,
                     torch.add, (x, x), {},
                     lambda a, b: {"flops": 3.0 * a.numel(),
                                   "shape": list(a.shape)})
        d._probe_pending()
        d.step_end(tokens=32, loss=float(step))
        if flush:
            d._flush()


SPILL_CONFIGS = [("t.jsonl", {}, None), ("t.fcs", {}, 1),
                 ("t.fcs2", {}, 2), ("t.fcs", {"log_compression": "zlib"}, 2),
                 ("t.fcs", {"log_codec": "fcs2"}, 2),
                 ("t.fcs2", {"log_compression": "zlib",
                             "log_compression_level": 1}, 2)]


def segment_versions(path: str) -> list[int]:
    """The FCS version of each segment of ``path``, from its header."""
    out, off, buf = [], 0, open(path, "rb").read()
    while off < len(buf):
        magic, version = _HEADER.unpack_from(buf, off)[:2]
        assert magic == b"FCS1"
        out.append(version)
        _, off = port_store.fcs.decode_segment(buf, off, path)
    return out


@pytest.mark.parametrize("name,knobs,version", SPILL_CONFIGS)
def test_spill_codec_rotation_and_sinks(tmp_path, name, knobs, version):
    """The spill's codec by extension and knobs, rotated past 512 bytes:
    ``log_paths`` names every piece on disk, in order; each drain is one
    segment (FCS: of ``version``), equal to the batch sink's batch; the
    pieces read back, in the port and in the reference, to the sink's
    events, bitwise (JSONL: as it rounds)."""
    path = tmp_path / name
    d = dmod.TracingDaemon(dmod.DaemonConfig(
        log_path=str(path), log_rotate_bytes=512, **knobs))
    events, batches = [], []
    d.add_sink(events.extend)
    d.add_batch_sink(batches.append)
    drive(d)
    paths = d.log_paths
    assert len(paths) >= 3 and len(batches) == 6
    assert sorted(str(p) for p in tmp_path.iterdir()) == sorted(paths)
    assert d.bytes_logged == sum(p.stat().st_size for p in tmp_path.iterdir())
    assert [e for b in batches for e in as_tuples(b.to_events())] == \
        as_tuples(events)
    for reader in (port_store, ref_store):
        got = [e for p in paths for e in reader.read_trace(p).to_events()]
        want = (jsonl_rounded(events) if version is None
                else as_tuples(events))
        assert as_tuples(got) == want
    if version is None:
        return
    assert [v for p in paths for v in segment_versions(p)] == [version] * 6
    segs = [s for p in paths for s in port_store.fcs.iter_segments(p)]
    assert [as_tuples(s.to_events()) for s in segs] == \
        [as_tuples(b.to_events()) for b in batches]


@pytest.mark.parametrize("reconstruct", [True, False])
def test_reconstruct_false_leaves_stacks_alone(tmp_path, reconstruct):
    d = dmod.TracingDaemon(dmod.DaemonConfig(reconstruct=reconstruct))
    events = []
    d.add_sink(events.extend)
    drive(d, steps=2)
    kernels = [e for e in events if e.kind == EventKind.KERNEL_COMPUTE]
    assert len(kernels) == 2
    if reconstruct:
        assert [e.meta["parent"] for e in kernels] == ["step_0", "step_1"]
    else:
        assert all("parent" not in e.meta and "stack" not in e.meta
                   for e in events)


@pytest.mark.parametrize("failing", ["sink", "batch_sink", "both"])
def test_a_failing_sink_is_swallowed(tmp_path, failing):
    """A sink or batch sink that raises costs only itself: the sinks after
    it and the spill still get every drain."""
    def boom(_):
        raise RuntimeError("sink down")

    d = dmod.TracingDaemon(dmod.DaemonConfig(
        log_path=str(tmp_path / "t.fcs")))
    events, batches = [], []
    if failing in ("sink", "both"):
        d.add_sink(boom)
    if failing in ("batch_sink", "both"):
        d.add_batch_sink(boom)
    d.add_sink(events.extend)
    d.add_batch_sink(batches.append)
    drive(d, steps=3)
    assert len(batches) == 3 and len(events) == 9
    assert d.spill_errors == 0
    back = port_store.read_trace(d.log_paths[0]).to_events()
    assert as_tuples(back) == as_tuples(events)


def test_spill_errors_are_counted_and_warned_once(tmp_path):
    """A spill that cannot write (its directory is missing) counts each
    failed drain and warns once; the sinks still get every drain."""
    d = dmod.TracingDaemon(dmod.DaemonConfig(
        log_path=str(tmp_path / "missing" / "t.fcs")))
    events = []
    d.add_sink(events.extend)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        drive(d, steps=4)
    assert d.spill_errors == 4 and d.bytes_logged == 0
    assert len([w for w in caught if "NOT being persisted"
                in str(w.message)]) == 1
    assert len(events) == 12


def test_enabled_false_attaches_nothing(tmp_path):
    from repro_torch.kernels.fused_norm.ops import fused_residual_rmsnorm
    d = dmod.TracingDaemon(dmod.DaemonConfig(
        enabled=False, log_path=str(tmp_path / "t.fcs")))
    assert d.attach() is d
    assert dmod.get_daemon() is None and d._thread is None
    x = torch.ones(4, 8)
    fused_residual_rmsnorm(x, x, torch.ones(8))
    d.stop()
    assert d.events_emitted == 0 and not (tmp_path / "t.fcs").exists()


def test_an_unpublished_daemon_times_only_what_it_is_handed():
    """``attach(publish=False)``: the traced ops do not report to it (they
    report to the published daemon, or to none), a ``register_kernel``
    wrapper does."""
    from repro_torch.kernels.fused_norm.ops import fused_residual_rmsnorm
    side, main = dmod.TracingDaemon(), dmod.TracingDaemon()
    side_events, main_events = [], []
    side.add_sink(side_events.extend)
    main.add_sink(main_events.extend)
    side.attach(publish=False)
    assert dmod.get_daemon() is None
    main.attach()
    assert dmod.get_daemon() is main
    traced = side.register_kernel("norm", EventKind.KERNEL_COMPUTE)(
        fused_residual_rmsnorm)
    x = torch.ones(4, 8)
    fused_residual_rmsnorm(x, x, torch.ones(8))
    traced(x, x, torch.ones(8))
    main.stop()
    side.stop()
    assert dmod.get_daemon() is None
    names = {"fused_residual_rmsnorm", "norm"}
    assert [e.name for e in side_events if e.name in names] == ["norm"]
    assert [e.name for e in main_events if e.name in names] == \
        ["fused_residual_rmsnorm", "fused_residual_rmsnorm"]


@pytest.mark.parametrize("attach", [False, True])
def test_stop_is_idempotent(tmp_path, attach):
    d = dmod.TracingDaemon(dmod.DaemonConfig(
        log_path=str(tmp_path / "t.fcs"), drain_interval=0.001))
    events = []
    d.add_sink(events.extend)
    if attach:
        d.attach()
        assert dmod.get_daemon() is d
        drive(d, steps=2, flush=False)
    d.stop()
    d.stop()
    assert dmod.get_daemon() is None
    assert d._thread is None or not d._thread.is_alive()
    assert len(events) == (6 if attach else 0)
    assert d.log_paths == [str(tmp_path / "t.fcs")]


def test_shared_telemetry_registry():
    from repro_torch.core.telemetry import TelemetryRegistry
    reg = TelemetryRegistry()
    d = dmod.TracingDaemon(dmod.DaemonConfig(telemetry=reg,
                                             buffer_capacity=4))
    assert d.telemetry is reg and d.buffer.capacity == 4
    drive(d, steps=1)
    assert reg.value("daemon.events_emitted") == 3


# ------------------------------------------------- the Trainer, FCS vs JSONL
def same(a, b):
    """Exact equality of two ``StepMetrics`` values (NaN equal to NaN)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, float) and np.isnan(a):
        return isinstance(b, float) and np.isnan(b)
    return a == b


def same_metrics(a, b):
    assert (a is None) == (b is None)
    for f in dataclasses.fields(a):
        assert same(getattr(a, f.name), getattr(b, f.name)), f.name


def to_reference(events):
    return [ref_events.TraceEvent(ref_events.EventKind(e.kind.value), e.name,
                                  e.rank, e.issue_ts, e.start_ts, e.end_ts,
                                  e.step, e.meta) for e in events]


def test_trainer_fcs_spill_gives_the_jsonl_runs_step_metrics(tmp_path):
    """A reduced llama ``Trainer`` on the CPU with ``flare_log`` ``.fcs``;
    a batch sink writes the same drains as JSONL.  Read back by the JAX
    package's store: the FCS events are the sink's, bitwise, and the
    JSONL's are them as JSONL rounds them.  Through the JAX package's
    ``aggregate_step``, each step's metrics from FCS are those from the
    sink's events, and, with the times rounded as JSONL rounds them,
    those from the JSONL, bitwise; unrounded, ``t_step`` within 1e-6 s."""
    from repro_torch.configs import get_reduced
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train import RunConfig, Trainer

    steps, fcs, jsonl = 4, str(tmp_path / "run.fcs"), str(tmp_path / "r.jsonl")
    run = RunConfig(model=get_reduced("llama3.2-1b"), global_batch=2,
                    seq_len=32, steps=steps, warmup_steps=2,
                    opt=AdamWConfig(), flare_log=fcs, device="cpu")
    t = Trainer(run)
    assert t.daemon.cfg.log_path == fcs and not t.daemon._attached
    sunk = []
    t.daemon.add_sink(sunk.extend)
    jsonl_codec = port_store.get_codec("jsonl")
    t.daemon.add_batch_sink(lambda b: jsonl_codec.write(b, jsonl))
    t.train()
    assert t.daemon.log_paths == [fcs]
    from_fcs = [e for p in t.daemon.log_paths
                for e in ref_store.read_trace(p).to_events()]
    from_jsonl = ref_store.read_trace(jsonl).to_events()
    assert as_tuples(from_fcs) == as_tuples(sunk)
    assert as_tuples(from_jsonl) == jsonl_rounded(sunk)
    rounded = [ref_events.TraceEvent.from_json(e.to_json())
               for e in from_fcs]
    for step in range(steps):
        m_fcs = aggregate_step({0: from_fcs}, step)
        assert m_fcs is not None and m_fcs.throughput > 0
        same_metrics(m_fcs, aggregate_step({0: to_reference(sunk)}, step))
        m_jsonl = aggregate_step({0: from_jsonl}, step)
        same_metrics(aggregate_step({0: rounded}, step), m_jsonl)
        assert abs(m_fcs.t_step - m_jsonl.t_step) <= 1e-6
