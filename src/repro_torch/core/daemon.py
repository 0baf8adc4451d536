"""Per-process tracing daemon (paper §4) for PyTorch on a CUDA card.

The same entry points as the JAX package's daemon (``step_begin``,
``step_end``, ``record_span``, ``register_kernel``, the hang heartbeat and
a JSONL spill to ``log_path``), with device timing from CUDA events, as
the paper's daemon did:

  * a traced op records a pair of ``torch.cuda.Event(enable_timing=True)``
    on the current stream around its launch and queues them on
    ``_pending``.  The serving thread never waits;
  * the daemon thread polls the queued end events with ``query()`` in
    launch order and only waits on them (``synchronize()``) at detach, so
    a hung kernel never stalls the heartbeat;
  * device times are put on the host ``perf_counter`` clock through an
    anchor event recorded and synchronised at ``attach()``:
    ``t = anchor_host + anchor.elapsed_time(ev) / 1e3``.  ``duration`` is
    then device time and ``issue_latency`` (device start minus host
    issue) is real.  The anchor's host time is read after its
    synchronise, so mapped times lag the device by at most that
    synchronise's latency and never precede their issue;
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

from repro_torch.core.events import (EventKind, EventRingBuffer, TraceEvent,
                                     dump_jsonl)
from repro_torch.core.interceptor import PyApiInterceptor
from repro_torch.core.stack import reconstruct_stacks
from repro_torch.core.telemetry import TelemetryRegistry

_GLOBAL_DAEMON: Optional["TracingDaemon"] = None


@dataclass
class DaemonConfig:
    rank: int = 0
    backend: str = "dense-serve"   # historical-profile key (paper §8.2)
    hang_timeout: float = 30.0
    drain_interval: float = 0.05
    log_path: Optional[str] = None  # JSONL spill, appended per drain


def _first_tensor_device(args, kwargs) -> Optional[torch.device]:
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            return a.device
    return None


class TracingDaemon:
    def __init__(self, config: DaemonConfig | None = None):
        self.cfg = config or DaemonConfig()
        self.buffer = EventRingBuffer(200_000)
        self.interceptor = PyApiInterceptor(self._on_api_span, self._on_gc)
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
        self._anchor: Optional[torch.cuda.Event] = None
        self._anchor_host = 0.0
        self.telemetry = TelemetryRegistry()
        self._c_bytes = self.telemetry.counter("daemon.bytes_logged")
        self._c_events = self.telemetry.counter("daemon.events_emitted")
        self._c_spill_errors = self.telemetry.counter("daemon.spill_errors")
        self._g_heartbeat = self.telemetry.gauge("daemon.heartbeat_age_s")
        self._g_queue = self.telemetry.gauge("daemon.queue_depth")
        self._g_rate = self.telemetry.gauge("daemon.events_per_s")
        self._rate_t0 = time.perf_counter()
        self._rate_n0 = 0
        self._attached = False

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def attach(self):
        """Attach to the current process (plug-and-play)."""
        if self._attached:
            return self
        if torch.cuda.is_available():
            self._take_anchor()
        self.interceptor.register_from_env()
        self.interceptor.install()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="flare-daemon")
        self._thread.start()
        self._attached = True
        global _GLOBAL_DAEMON
        _GLOBAL_DAEMON = self
        return self

    def _take_anchor(self):
        torch.cuda.synchronize()
        anchor = torch.cuda.Event(enable_timing=True)
        anchor.record()
        anchor.synchronize()
        self._anchor_host = time.perf_counter()
        self._anchor = anchor

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
        self._attached = False
        global _GLOBAL_DAEMON
        if _GLOBAL_DAEMON is self:
            _GLOBAL_DAEMON = None

    def on_hang(self, cb: Callable[[dict], None]):
        self._hang_cb = cb

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
            if self._anchor is None:
                raise RuntimeError(
                    "flare daemon has no CUDA clock anchor: it was attached "
                    "in a process without a CUDA device")
            stream = torch.cuda.current_stream(dev)
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
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
            self._probe_pending()
            self._flush()
            self._heartbeat()
            time.sleep(self.cfg.drain_interval)

    def _device_ts(self, ev: torch.cuda.Event) -> float:
        return self._anchor_host + self._anchor.elapsed_time(ev) / 1e3

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
                if isinstance(t1, torch.cuda.Event):
                    if not t1.query():
                        if not wait:
                            return
                        t1.synchronize()
                    t0, t1 = self._device_ts(t0), self._device_ts(t1)
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
        reconstruct_stacks(events)
        if self.cfg.log_path:
            # the daemon thread must survive a failing spill (disk full):
            # the failure is counted and warned once, never silent
            try:
                self._c_bytes.inc(dump_jsonl(events, self.cfg.log_path))
            except OSError as e:
                if self._c_spill_errors.inc() == 1:
                    warnings.warn(
                        f"trace spill to {self.cfg.log_path} failing "
                        f"({type(e).__name__}: {e}); events are NOT being "
                        "persisted", stacklevel=2)

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
