"""Plug-and-play Python API interception (paper §4.1).

The paper hooks CPython's profiling API (``PyEval_SetProfile``) against the
bytecode of a configured list of APIs, so no backend codebase is patched.
We use the modern equivalent, ``sys.monitoring`` (PEP 669): LOCAL
PY_START/PY_RETURN events are enabled *only* on the registered code
objects, giving the same only-the-traced-APIs-fire selectivity.  APIs
implemented in C (no bytecode — e.g. ``gc.collect``) fall back to a wrapper
installed by the daemon at attach time (still zero backend modification),
and GC pauses themselves are additionally captured via ``gc.callbacks``.

On Python < 3.12 ``sys.monitoring`` does not exist; EVERY registered API
then takes the wrapper path, which preserves the plug-and-play contract
(install at attach, restore at detach, daemon threads never traced).

Easy-to-play interface (paper): environment variable
    FLARE_TRACED_PYTHON_API="torch.cuda@synchronize,gc@collect,mod.sub@fn"
"""
from __future__ import annotations

import gc
import importlib
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

ENV_VAR = "FLARE_TRACED_PYTHON_API"
_TOOL_NAME = "flare"
_HAS_MONITORING = hasattr(sys, "monitoring")   # PEP 669, Python >= 3.12


def parse_api_spec(spec: str) -> list[tuple[str, str]]:
    """'mod.sub@fn,mod2@fn2' -> [('mod.sub','fn'), ...]"""
    out = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        if "@" not in item:
            raise ValueError(
                f"bad {ENV_VAR} entry {item!r}: expected 'module@function'")
        mod, fn = item.split("@", 1)
        out.append((mod, fn))
    return out


@dataclass
class _Traced:
    module: str
    func: str
    code: object = None          # code object (sys.monitoring path)
    wrapper_installed: bool = False
    original: Callable = None


class PyApiInterceptor:
    """Intercepts configured Python APIs; emits (name, t0, t1) to a callback."""

    def __init__(self, on_span: Callable[[str, float, float], None],
                 on_gc: Optional[Callable[[str, float, float], None]] = None):
        self.on_span = on_span
        self.on_gc = on_gc or on_span
        self._traced: dict[object, _Traced] = {}   # code obj -> info
        self._wrapped: list[_Traced] = []
        self._tool_id: Optional[int] = None
        self._starts: dict[tuple, float] = {}      # (thread, code) -> t0
        self._gc_t0: Optional[float] = None
        self._gc_cb_installed = False

    # ------------------------------------------------------------------ #
    def register_from_env(self):
        spec = os.environ.get(ENV_VAR, "")
        for mod, fn in parse_api_spec(spec):
            self.register(mod, fn)

    def register(self, module: str, func: str):
        try:
            obj = importlib.import_module(module)
        except ImportError:
            return False
        target = obj
        parts = func.split(".")
        for p in parts[:-1]:
            target = getattr(target, p)
        f = getattr(target, parts[-1], None)
        if f is None:
            return False
        code = getattr(f, "__code__", None)
        name = f"{module}@{func}"
        if code is not None and _HAS_MONITORING:
            self._traced[code] = _Traced(module, func, code=code)
            if self._tool_id is not None:
                self._enable_local(code)
        else:
            # C-implemented API — or an interpreter without sys.monitoring:
            # wrapper fallback (installed at attach, not backend-edited)
            info = _Traced(module, func, original=f)

            def wrapper(*a, __flare_name=name, __orig=f, **kw):
                if self._own_thread():   # observer-effect guard
                    return __orig(*a, **kw)
                t0 = time.perf_counter()
                try:
                    return __orig(*a, **kw)
                finally:
                    self.on_span(__flare_name, t0, time.perf_counter())

            setattr(target, parts[-1], wrapper)
            info.wrapper_installed = True
            self._wrapped.append(info)
        return True

    # ------------------------------------------------------------------ #
    def install(self):
        if _HAS_MONITORING:
            mon = sys.monitoring
            for tid in range(6):
                try:
                    mon.use_tool_id(tid, _TOOL_NAME)
                    self._tool_id = tid
                    break
                except ValueError:
                    continue
            if self._tool_id is None:
                raise RuntimeError("no free sys.monitoring tool id")
            E = mon.events
            mon.register_callback(self._tool_id, E.PY_START, self._py_start)
            mon.register_callback(self._tool_id, E.PY_RETURN, self._py_return)
            for code in self._traced:
                self._enable_local(code)
        if not self._gc_cb_installed:
            gc.callbacks.append(self._gc_cb)
            self._gc_cb_installed = True

    def _enable_local(self, code):
        E = sys.monitoring.events
        sys.monitoring.set_local_events(
            self._tool_id, code, E.PY_START | E.PY_RETURN)

    def uninstall(self):
        if _HAS_MONITORING and self._tool_id is not None:
            for code in self._traced:
                sys.monitoring.set_local_events(self._tool_id, code, 0)
            sys.monitoring.free_tool_id(self._tool_id)
            self._tool_id = None
        for info in self._wrapped:
            try:
                obj = importlib.import_module(info.module)
                target = obj
                parts = info.func.split(".")
                for p in parts[:-1]:
                    target = getattr(target, p)
                setattr(target, parts[-1], info.original)
            except Exception:
                pass
        self._wrapped.clear()
        if self._gc_cb_installed:
            try:
                gc.callbacks.remove(self._gc_cb)
            except ValueError:
                pass
            self._gc_cb_installed = False

    # ------------------------------------------------------------------ #
    @staticmethod
    def _own_thread() -> bool:
        # never trace the daemon's own threads (observer effect: e.g. the
        # JSONL writer itself calls json.dumps)
        return threading.current_thread().name.startswith("flare-")

    def _py_start(self, code, _offset):
        if code in self._traced and not self._own_thread():
            self._starts[(threading.get_ident(), id(code))] = time.perf_counter()

    def _py_return(self, code, _offset, _retval):
        info = self._traced.get(code)
        if info is None or self._own_thread():
            return
        t0 = self._starts.pop((threading.get_ident(), id(code)), None)
        if t0 is not None:
            self.on_span(f"{info.module}@{info.func}", t0, time.perf_counter())

    def _gc_cb(self, phase, info):
        # a collection on the daemon's own thread is its observer effect,
        # as its API calls are; and the callbacks' bytecode can hand the
        # GIL to the workload's thread between the start and stop times,
        # so that such a span would enclose kernel issues of another step
        if self._own_thread():
            return
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif phase == "stop" and self._gc_t0 is not None:
            self.on_gc(f"gc.collect(gen={info.get('generation', '?')})",
                       self._gc_t0, time.perf_counter())
            self._gc_t0 = None

    @property
    def traced_names(self) -> list[str]:
        names = [f"{t.module}@{t.func}" for t in self._traced.values()]
        names += [f"{t.module}@{t.func}" for t in self._wrapped]
        return names
