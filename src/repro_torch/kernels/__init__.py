"""Hand-written CUDA kernels for Hopper (sm_90a) + the FLARE tracing seam.

Kernels (each: ``csrc/<name>.cu`` = the CUDA source with a plain C launch
function, ``<name>/ops.py`` = the PyTorch wrapper, its plain PyTorch
version and the FLARE registration):

  flash_attention — causal / full GQA attention forward (prefill and
                    training) and backward, both routes on the tensor
                    cores: bf16 (``flash_attention_wgmma.cu``,
                    ``flash_attention_bwd_wgmma.cu``) and fp32 as split
                    TF32 (``flash_attention_tf32.cu``,
                    ``flash_attention_bwd_tf32.cu``, their pre-pass in
                    ``flash_tf32_split.cuh``)
  fused_norm      — residual add + RMSNorm (``fused_norm.cu``) and its
                    backward (``fused_norm_bwd.cu``, rows by TMA bulk copy)
  ssd_scan        — Mamba2 chunked SSD scan with initial / final state
                    (prefill and training), both routes on the tensor
                    cores: bf16 (``ssd_scan_wgmma.cu``) and fp32 as split
                    TF32 (``ssd_scan_tf32.cu``, Bm and Cm split by the
                    flash pre-pass); its backward, both routes on the
                    tensor cores: bf16 (``ssd_scan_bwd_wgmma.cu``) and fp32
                    as split TF32 (``ssd_scan_bwd_tf32.cu``), sharing
                    ``ssd_bwd_common.cuh``
  padded_matmul   — the Case-2 matmul, both routes on the tensor cores:
                    bf16 (``padded_matmul_wgmma.cu``) and fp32 as split
                    TF32 (``padded_matmul_tf32.cu``, with its own b^T
                    pre-pass)
  ring_reduce     — the ring-combine step with host-visible progress

The tensor-core kernels share ``csrc/hopper.cuh`` (TMA tensor maps and
loads, mbarriers, wgmma descriptors and instructions, the tf32 split,
programmatic dependent launch).  A kernel with two
routes picks one by dtype alone in its wrapper's ``route``, and each
route's ``CudaKernel`` counts its own launches (two C entries of one
source are two ``CudaKernel``s of one build).

Meta route: each wrapper takes meta tensors too (``device="meta"``, as the
dry-run builds its models): it applies the kernel's own argument checks,
returns empty meta tensors of the outputs' shapes, launches nothing, and
charges the kernel's work (its ``ops.py``'s ``work``, the formula the
card's bounds use) to the op analysis in progress (``charge``;
``launch/op_analysis.py``), never the plain version's operations.

Build: each source is compiled on first use by ``nvcc`` into its own shared
library under ``kernels/build/`` and loaded with ``ctypes``.  Every tensor
pointer and the stream cross as ``c_void_p``; the C function returns
``cudaGetLastError()`` after its launch and the wrapper raises on anything
but 0.  A missing ``nvcc`` or a failed build raises too: nothing on a CUDA
tensor falls back to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Optional

import torch

from repro_torch.core.daemon import get_daemon
from repro_torch.core.events import EventKind

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
CUDA_ROOTS = ("/usr/local/cuda",)   # searched after PATH and $CUDA_HOME
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def traced_op(name: str, kind: str = "compute",
              meta_fn: Optional[Callable] = None):
    """Wrap an op entry point with FLARE kernel tracing when a daemon is
    attached.  Queues the same ``(name, kind, issue, step, out, meta)`` as
    the JAX package's ``traced_op``, plus the span's CUDA events."""
    ekind = (EventKind.KERNEL_COMPUTE if kind == "compute"
             else EventKind.KERNEL_COMM)

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            daemon = get_daemon()
            if daemon is None:
                return fn(*args, **kwargs)
            return daemon.trace_call(name, ekind, fn, args, kwargs, meta_fn)
        return wrapped
    return deco


# the op analyses in progress (``launch/op_analysis.py``), innermost last
ANALYSES: list = []


def charge(name: str, work: dict):
    """Charge one kernel call's work (``{"flops", "ops", "bytes"}``, its
    ``ops.py``'s ``work``) to the innermost op analysis in progress; a
    meta route calls it once a call, and nothing counts it otherwise."""
    if ANALYSES:
        ANALYSES[-1].charge(name, work)


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), *CUDA_ROOTS):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of repro_torch are built with nvcc on first use")


def _lib_path(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.name == source or f.suffix == ".cuh":
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def _nvcc_cmd(nvcc: str, source: str, out: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out),
            str(CSRC / source)]


class CudaKernel:
    """One CUDA source, its C launch function, and its launch count.

    ``launches`` grows by one at each successful launch and nowhere else,
    so a run can show that its main path went through the kernel."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""
        self.build_seconds = 0.0
        self._fn = None
        self._err = None
        self._lock = threading.Lock()

    def _load(self, path: Path):
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = lib.flare_cuda_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._err = fn, err

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start nvcc for this source unless its library is built; returns
        the process (``finish_build`` waits for it)."""
        out = _lib_path(self.source)
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        self._t0, self._tmp = time.perf_counter(), tmp
        return subprocess.Popen(_nvcc_cmd(find_nvcc(), self.source, tmp),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def finish_build(self, proc: Optional[subprocess.Popen]):
        if proc is not None:
            log, _ = proc.communicate()
            self.build_log = log
            self.build_seconds = time.perf_counter() - self._t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {self.source} "
                    f"(exit {proc.returncode}):\n{log}")
            os.replace(self._tmp, _lib_path(self.source))
        self._load(_lib_path(self.source))

    def ensure_built(self):
        with self._lock:
            if self._fn is None:
                self.finish_build(self.start_build())

    def launch(self, *args):
        """Call the C launch function; raise on any CUDA error."""
        if self._fn is None:
            self.ensure_built()
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} failed: CUDA error {rc} "
                               f"({self._err(rc).decode()})")
        self.launches += 1


def build_all(kernels: list[CudaKernel]) -> None:
    """Build several kernels at once: one nvcc per source, all started
    together (kernels that share a source share its build)."""
    first = {}
    for k in kernels:
        if k.source not in first:
            first[k.source] = (k, k.start_build())
    for k, p in first.values():
        with k._lock:
            k.finish_build(p)
    for k in kernels:
        k.ensure_built()


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
