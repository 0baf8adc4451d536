"""Per-process tracing daemon (paper §4) for PyTorch on a CUDA card.

The same entry points, spill plane and fleet seam as the JAX package's
daemon (``step_begin``, ``step_end``, ``record_span``, ``register_kernel``,
the hang heartbeat, ``add_sink``, the columnar ``add_batch_sink``, the
spill through ``store.SegmentedTraceWriter``: JSONL, FCS v1 or FCS v2 by
the path's extension or ``log_codec``, compressed and rotated as
configured, ``attach_fleet``, which streams the drains into a
``fleet.FleetMultiplexer``, and ``live_endpoint``, which streams them to a
resident ``serve.FleetService`` through a ``serve.LiveBatchSink``), with
device timing from CUDA events, as the paper's daemon did:

  * a traced op records a pair of ``torch.cuda.Event(enable_timing=True)``
    on the current stream around its launch and queues them on
    ``_pending``.  The serving thread never waits;
  * the daemon thread polls the queued end events with ``query()`` in
    launch order and only waits on them (``synchronize()``) at detach, so
    a hung kernel never stalls the heartbeat;
  * device times are put on the host ``perf_counter`` clock through
    anchors: an event recorded on the daemon's own side stream and waited
    on, its host time read after the wait, so an anchor is never early but
    is late by its wait's return and the GIL (~0.1-0.2 ms at the median
    under a dispatch loop, some ms at worst).  ``attach()`` takes the first
    and the daemon thread one each loop.  Each anchor's device time is
    summed from its predecessor's (``elapsed_time`` over a loop, so the
    float32 milliseconds stay within ~10 ns), and its offset is its host time
    less its device time.  A span's start maps through the least offset
    among the anchors within ``ANCHOR_WINDOW_S`` of it on the card, the
    least late of them: ``t0 = dev(ev0) + min(offset)`` and
    ``t1 = t0 + ev0.elapsed_time(ev1) / 1e3``.  ``duration`` is then the
    pair's device time and ``issue_latency`` (device start minus host
    issue) is real.  The card's clock runs some ppm off the host's, ~1.5 µs
    over the window, below any anchor's wait, so a mapped time stays late;
  * an op on CPU tensors (the explicit-CPU case) keeps host timing.

Kernel events of a step are held back until the step has ended and all of
its kernels have completed, so that stack reconstruction sees the step span
and its kernels in one drain and nests the kernels under ``step_N``.
"""
from __future__ import annotations

import queue
import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.core.columnar import EventBatch
from repro_torch.core.events import EventKind, EventRingBuffer, TraceEvent
from repro_torch.core.interceptor import PyApiInterceptor
from repro_torch.core.stack import reconstruct_stacks
from repro_torch.core.telemetry import TelemetryRegistry
from repro_torch.store import FcsV2Codec, SegmentedTraceWriter

_GLOBAL_DAEMON: Optional["TracingDaemon"] = None

# anchors kept: ~4 s of daemon loops.  A span maps through the least late
# anchor within ANCHOR_WINDOW_S of its start on the card; a span with none
# that near (a backlog longer than that) maps through the nearest
ANCHORS_KEPT = 64
ANCHOR_WINDOW_S = 0.5


@dataclass
class DaemonConfig:
    rank: int = 0
    backend: str = "dense-train"   # historical-profile key (paper §8.2)
    hang_timeout: float = 30.0
    drain_interval: float = 0.05
    log_path: Optional[str] = None
    # spill codec: None = infer from log_path extension ("jsonl" default;
    # ".fcs" spills binary columnar segments, ".fcs2" compressed archival
    # segments — see repro_torch.store).  "fcs2" may also be named
    # explicitly to write v2 segments into a ".fcs" path
    log_codec: Optional[str] = None
    # archival-spill compression: backend name ("zstd"/"zlib"; None =
    # best available) and level for FCS v2 segments.  Setting either
    # implies log_codec="fcs2".
    log_compression: Optional[str] = None
    log_compression_level: Optional[int] = None
    # rotate the spill to <stem>.segNNN<ext> once the current file passes
    # this size; None = single file forever
    log_rotate_bytes: Optional[int] = None
    buffer_capacity: int = 200_000
    reconstruct: bool = True
    enabled: bool = True
    # detector set for the engine diagnosing this daemon's job when it is
    # attached to a fleet without an explicit EngineConfig (registry names
    # / DetectorSpecs, see repro_torch.core.detectors); None = default set
    detectors: Optional[list] = None
    num_ranks: int = 1             # job-wide rank count for that engine
    # self-telemetry registry; None = a private one per daemon.  A fleet's
    # ``telemetry_snapshot`` merges its attached daemons' registries in
    telemetry: Optional[TelemetryRegistry] = None
    # live fleet service endpoint ("host:port"): each drain is FCS-framed
    # (the repro_torch.serve wire protocol) and shipped from the daemon
    # thread with reconnect and backoff; a dead or slow service costs
    # counted drops (daemon.live_dropped), never a blocked heartbeat or a
    # dead daemon, and the spill holds whatever live frames were lost
    live_endpoint: Optional[str] = None
    live_job_id: Optional[str] = None      # default: "job-rank<rank>"
    live_topology: Optional[dict] = None   # rack/switch attrs, HELLO'd


def _first_tensor_device(args, kwargs) -> Optional[torch.device]:
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            return a.device
    return None


def _timing_event():
    return torch.cuda.Event(enable_timing=True)


class TracingDaemon:
    def __init__(self, config: DaemonConfig | None = None):
        self.cfg = config or DaemonConfig()
        self.buffer = EventRingBuffer(self.cfg.buffer_capacity)
        self.interceptor = PyApiInterceptor(self._on_api_span, self._on_gc)
        self._sinks: list[Callable[[list[TraceEvent]], None]] = []
        self._batch_sinks: list = []
        self._hang_cb: Optional[Callable[[dict], None]] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._step = -1
        self._step_t0 = 0.0
        self._in_step = False
        self._last_completion = time.perf_counter()
        # (name, kind, issue, step, meta, timing): timing is a pair of CUDA
        # events, or a pair of host perf_counter floats for CPU ops.  The
        # op's outputs are not queued: held until the device caught up,
        # they would keep every traced op's outputs of a step alive (under
        # remat, every layer's recomputed activations)
        self._pending: "queue.Queue" = queue.Queue()
        self._inflight: deque = deque()
        self._held: list[TraceEvent] = []
        self._probe_lock = threading.Lock()
        self._last_stack: list[str] = []
        self._stream = None              # the anchors' side stream
        # (event, host time, device time): device times from the first
        # anchor's, summed over consecutive anchors
        self._anchors: deque = deque(maxlen=ANCHORS_KEPT)
        self.telemetry = self.cfg.telemetry or TelemetryRegistry()
        self._c_bytes = self.telemetry.counter("daemon.bytes_logged")
        self._c_events = self.telemetry.counter("daemon.events_emitted")
        self._c_spill_errors = self.telemetry.counter("daemon.spill_errors")
        self._c_anchors = self.telemetry.counter("daemon.anchors")
        self._g_heartbeat = self.telemetry.gauge("daemon.heartbeat_age_s")
        self._g_queue = self.telemetry.gauge("daemon.queue_depth")
        self._g_rate = self.telemetry.gauge("daemon.events_per_s")
        # the widest anchor bracket so far: host time from before an
        # anchor's record to after its wait, which bounds how late it is
        self._g_bracket = self.telemetry.gauge("daemon.anchor_bracket_max_s")
        self._rate_t0 = time.perf_counter()
        self._rate_n0 = 0
        self._attached = False
        self._spill = None
        if self.cfg.log_path:
            codec = self.cfg.log_codec
            if (self.cfg.log_compression is not None
                    or self.cfg.log_compression_level is not None):
                # an explicit compression knob means the archival (v2)
                # spill, with a per-daemon backend/level instance
                codec = FcsV2Codec(compression=self.cfg.log_compression,
                                   level=self.cfg.log_compression_level)
            self._spill = SegmentedTraceWriter(
                self.cfg.log_path, codec=codec,
                rotate_bytes=self.cfg.log_rotate_bytes)
        self._live = None
        if self.cfg.live_endpoint:
            # imported here: a daemon without an endpoint never loads the
            # service plane
            from repro_torch.serve.client import LiveBatchSink
            self._live = LiveBatchSink(
                self.cfg.live_endpoint,
                self.cfg.live_job_id or f"job-rank{self.cfg.rank}",
                topology=self.cfg.live_topology,
                telemetry=self.telemetry)
            self.add_batch_sink(self._live)

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def attach(self, publish: bool = True):
        """Attach to the current process (plug-and-play).  ``publish``: as
        the process's daemon (``get_daemon()``), which the port's traced
        ops report to; unpublished, it times only the calls it is handed
        (``trace_call``, ``register_kernel``)."""
        if self._attached or not self.cfg.enabled:
            return self
        if torch.cuda.is_available():
            if self._stream is None:
                self._stream = torch.cuda.Stream()
            self._take_anchor()
        self.interceptor.register_from_env()
        self.interceptor.install()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="flare-daemon")
        self._thread.start()
        self._attached = True
        if publish:
            global _GLOBAL_DAEMON
            _GLOBAL_DAEMON = self
        return self

    def _take_anchor(self):
        """Record an event on the side stream (no other work there, so it
        waits on none) and wait on it; the host time read after the wait is
        at or after the event's device time."""
        before = time.perf_counter()
        anchor = _timing_event()
        anchor.record(self._stream)
        anchor.synchronize()
        host = time.perf_counter()
        with self._probe_lock:
            dev = 0.0
            if self._anchors:
                prev, _, prev_dev = self._anchors[-1]
                dev = prev_dev + prev.elapsed_time(anchor) / 1e3
            self._anchors.append((anchor, host, dev))
        self._c_anchors.inc()
        if host - before > self._g_bracket.value:
            self._g_bracket.set(host - before)

    def detach(self):
        if not self._attached:
            return
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60.0)
            if self._thread.is_alive():
                raise RuntimeError("flare daemon thread did not stop")
        self.interceptor.uninstall()
        self._probe_pending(wait=True)
        self._flush(final=True)
        if self._live is not None:
            self._live.close()        # best-effort BYE; reconnects if
            #                           the daemon attaches again
        self._attached = False
        global _GLOBAL_DAEMON
        if _GLOBAL_DAEMON is self:
            _GLOBAL_DAEMON = None

    def stop(self):
        """Idempotent shutdown: safe on a never-attached or already-stopped
        daemon and safe to call repeatedly: the fleet's ``close`` stops
        every job's daemons without tracking which already exited."""
        self.detach()

    def attach_fleet(self, mux, job_id: Optional[str] = None,
                     engine_cfg=None):
        """Fleet seam: stream this daemon's drains into a
        ``repro_torch.fleet.FleetMultiplexer`` as job ``job_id`` (a batch
        sink, one ``EventBatch`` a drain) and hand the daemon to the
        multiplexer, so that ``mux.close()`` can ``stop()`` it.

        ``engine_cfg`` configures the job's diagnostic engine.  Without
        one, a daemon whose ``detectors``, ``num_ranks`` or ``backend`` is
        not the default builds it from those; an all-default daemon leaves
        it to the multiplexer's ``FleetConfig.backend``.  The sink runs on
        the daemon thread, with diagnosis of the steps its drain closes;
        a drain holds whole steps only (``_flush``), so a live job has no
        late rows."""
        jid = job_id if job_id is not None else f"job-rank{self.cfg.rank}"
        if engine_cfg is None and (self.cfg.detectors is not None
                                   or self.cfg.num_ranks > 1
                                   or self.cfg.backend != DaemonConfig.backend):
            from repro_torch.core.engine import EngineConfig
            engine_cfg = EngineConfig(
                backend=self.cfg.backend, num_ranks=self.cfg.num_ranks,
                detectors=self.cfg.detectors)
        mux.register_daemon(jid, self, engine_cfg)
        self.add_batch_sink(lambda batch, _jid=jid: mux.ingest(_jid, batch))
        return self

    def add_sink(self, sink: Callable[[list[TraceEvent]], None]):
        self._sinks.append(sink)

    def add_batch_sink(self, sink):
        """Columnar sink: receives each drain as one ``EventBatch``."""
        self._batch_sinks.append(sink)

    def on_hang(self, cb: Callable[[dict], None]):
        self._hang_cb = cb

    @property
    def log_paths(self) -> list[str]:
        """Every spill file written so far (>1 once rotation kicks in)."""
        return list(self._spill.paths) if self._spill is not None else []

    # ------------------------------------------------------------------ #
    # event entry points
    # ------------------------------------------------------------------ #
    @property
    def bytes_logged(self) -> int:
        return self._c_bytes.value

    @property
    def events_emitted(self) -> int:
        return self._c_events.value

    @property
    def spill_errors(self) -> int:
        return self._c_spill_errors.value

    def _emit(self, ev: TraceEvent):
        self.buffer.append(ev)
        self._c_events.inc()
        self._last_completion = time.perf_counter()

    def _on_api_span(self, name: str, t0: float, t1: float):
        self._emit(TraceEvent(EventKind.PY_API, name, self.cfg.rank,
                              t0, t0, t1, step=self._step))

    def _on_gc(self, name: str, t0: float, t1: float):
        self._emit(TraceEvent(EventKind.GC, name, self.cfg.rank,
                              t0, t0, t1, step=self._step))

    def record_span(self, kind: EventKind, name: str, t0: float, t1: float,
                    **meta):
        self._emit(TraceEvent(kind, name, self.cfg.rank, t0, t0, t1,
                              step=self._step, meta=meta))

    def step_begin(self, step: int):
        self._step = step
        self._step_t0 = time.perf_counter()
        self._in_step = True

    def step_end(self, **meta):
        t1 = time.perf_counter()
        self._emit(TraceEvent(EventKind.STEP, f"step_{self._step}",
                              self.cfg.rank, self._step_t0, self._step_t0,
                              t1, step=self._step, meta=meta))
        self._in_step = False

    def set_stack(self, stack: list[str]):
        """The serving thread publishes its logical call stack (hang
        analysis)."""
        self._last_stack = list(stack)

    # ------------------------------------------------------------------ #
    # kernel registration — the explicit infra-team interface
    # ------------------------------------------------------------------ #
    def trace_call(self, name: str, kind: EventKind, fn, args, kwargs,
                   meta_fn: Optional[Callable[..., dict]] = None):
        """Run ``fn(*args, **kwargs)`` and queue its span.  On CUDA tensors
        the span is a pair of CUDA events on the current stream; the
        caller is not blocked."""
        dev = _first_tensor_device(args, kwargs)
        issue = time.perf_counter()
        if dev is not None and dev.type == "cuda":
            if not self._anchors:
                raise RuntimeError(
                    "flare daemon has no CUDA clock anchor: it was attached "
                    "in a process without a CUDA device")
            stream = torch.cuda.current_stream(dev)
            ev0, ev1 = _timing_event(), _timing_event()
            ev0.record(stream)
            out = fn(*args, **kwargs)
            ev1.record(stream)
            timing = (ev0, ev1)
        else:
            out = fn(*args, **kwargs)
            timing = (issue, time.perf_counter())
        meta = meta_fn(*args, **kwargs) if meta_fn else {}
        self._pending.put((name, kind, issue, self._step, meta, timing))
        return out

    def register_kernel(self, name: str, kind: EventKind,
                        meta_fn: Optional[Callable[..., dict]] = None):
        """Decorator: wraps an op-library entry point with ``trace_call``
        while this daemon is attached."""
        def deco(fn):
            def wrapped(*args, **kwargs):
                if not self._attached:
                    return fn(*args, **kwargs)
                return self.trace_call(name, kind, fn, args, kwargs, meta_fn)
            wrapped.__name__ = getattr(fn, "__name__", name)
            wrapped.__wrapped__ = fn
            return wrapped
        return deco

    # ------------------------------------------------------------------ #
    # background thread: timing manager + heartbeat + streaming
    # ------------------------------------------------------------------ #
    def _run(self):
        while not self._stop.is_set():
            self._tick()
            time.sleep(self.cfg.drain_interval)

    def _tick(self):
        """One loop of the daemon thread."""
        if self._stream is not None:
            self._take_anchor()
        self._probe_pending()
        self._flush()
        self._heartbeat()

    def _device_span(self, ev0, ev1) -> tuple[float, float]:
        """Host times of a completed event pair, through the least offset
        among the anchors within ``ANCHOR_WINDOW_S`` of ``ev0`` (caller
        holds ``_probe_lock``).  ``ev0``'s device time is read from the
        newest anchor at or before it (the oldest if none is)."""
        for anchor, host, dev in reversed(self._anchors):
            ms = anchor.elapsed_time(ev0)
            if ms >= 0:
                break
        dev0 = dev + ms / 1e3
        offset = min((h - d for _, h, d in self._anchors
                      if abs(d - dev0) <= ANCHOR_WINDOW_S), default=host - dev)
        t0 = dev0 + offset
        return t0, t0 + ev0.elapsed_time(ev1) / 1e3

    def _probe_pending(self, wait: bool = False):
        """Emit the spans of completed ops, oldest first.  Stops at the
        first CUDA op still running unless ``wait``."""
        with self._probe_lock:
            while True:
                try:
                    self._inflight.append(self._pending.get_nowait())
                except queue.Empty:
                    break
            while self._inflight:
                name, kind, issue, step, meta, timing = self._inflight[0]
                t0, t1 = timing
                if not isinstance(t1, float):
                    if not t1.query():
                        if not wait:
                            return
                        t1.synchronize()
                    t0, t1 = self._device_span(t0, t1)
                self._inflight.popleft()
                self._emit(TraceEvent(kind, name, self.cfg.rank, issue,
                                      t0, t1, step=step, meta=meta))

    def _open_steps(self) -> set:
        """Steps whose events must wait: the step in progress and every
        step with a kernel not yet emitted.  ``_in_step`` is read before
        the queue, so an op queued before ``step_end`` is always seen."""
        steps = {self._step} if self._in_step else set()
        with self._pending.mutex:
            steps.update(item[3] for item in self._pending.queue)
        steps.update(item[3] for item in self._inflight)
        return steps

    def _flush(self, final: bool = False):
        # the open steps are read before the buffer is drained: a step that
        # ends between the two would otherwise count as closed while its
        # step span is not among the drained events, and its kernels would
        # be spilled without the span they nest under
        open_steps = set() if final else self._open_steps()
        events = self._held + self.buffer.drain()
        self._held = []
        if not final:
            keep = [e.step in open_steps
                    and e.kind is not EventKind.HANG_SUSPECT for e in events]
            self._held = [e for e, k in zip(events, keep) if k]
            events = [e for e, k in zip(events, keep) if not k]
        if not events:
            return
        if self.cfg.reconstruct:
            reconstruct_stacks(events)
        for sink in self._sinks:
            try:
                sink(events)
            except Exception:
                pass
        if not (self._batch_sinks or self._spill is not None):
            return
        batch = EventBatch.from_events(events)
        for sink in self._batch_sinks:
            try:
                sink(batch)
            except Exception:
                pass
        if self._spill is not None:
            # one codec segment (or JSONL line run) per drain; the daemon
            # thread must survive a failing spill (disk full, meta the codec
            # cannot hold): counted and warned once, never silent
            try:
                self._c_bytes.inc(self._spill.write(batch))
            except Exception as e:
                if self._c_spill_errors.inc() == 1:
                    warnings.warn(
                        f"trace spill to {self.cfg.log_path} failing "
                        f"({type(e).__name__}: {e}); events continue to "
                        "stream to sinks but are NOT being persisted",
                        stacklevel=2)

    def _heartbeat(self):
        now = time.perf_counter()
        silent = now - self._last_completion
        self._g_heartbeat.set(silent)
        self._g_queue.set(self._pending.qsize() + len(self._inflight))
        dt = now - self._rate_t0
        if dt >= 1.0:
            n = self._c_events.value
            self._g_rate.set((n - self._rate_n0) / dt)
            self._rate_t0, self._rate_n0 = now, n
        if self._in_step and silent > self.cfg.hang_timeout:
            report = {"rank": self.cfg.rank, "silent_s": silent,
                      "step": self._step, "stack": self._last_stack}
            self._emit(TraceEvent(EventKind.HANG_SUSPECT, "hang_suspect",
                                  self.cfg.rank, now, now, now,
                                  step=self._step, meta=report))
            if self._hang_cb:
                self._hang_cb(report)
            self._last_completion = now  # rate-limit repeat reports


def get_daemon() -> Optional[TracingDaemon]:
    return _GLOBAL_DAEMON
