"""Ring-combine step with progress export: CUDA kernel wrapper, plain
version, tracing.

Replaces the TPU kernel ``src/repro/kernels/ring_reduce/kernel.py``
(``ring_combine_step``): ``out = acc + incoming`` over ``C / block``
blocks, with ``progress[i] = i + 1`` once block ``i`` has combined, the
counters FLARE reads out of a hung collective (paper §5.1, Fig 6).  Bound
on an H100: memory, ``3·C·itemsize`` bytes.  The kernel
(``csrc/ring_combine.cu``) gives whole ring blocks to warps, one wave of
CUDA blocks walking them in a grid stride (``combine_grid``,
``worker_ring_blocks``), each lane issuing all its loads of a ring block
before its stores (``lane_elements``), 16 bytes an access where the
pointers and the block allow (``combine_vec``).

``progress`` always lives in host memory.  On a CUDA tensor it is a
pinned (page-locked) CPU tensor that the kernel writes through its device
pointer, block by block, with a system-scope store after a device-scope
fence: a host thread can read it while the kernel runs, and a hung kernel
leaves it frozen where it stopped.  A caller that reads the counters live
(the ring collectives, whose hang callback publishes them) passes its own
``progress``; otherwise the wrapper allocates it.  The wrapper returns
before the kernel ends: synchronise the stream before taking ``progress``
as final.  PyTorch's pinned-memory cache would hand a freed block out
again while the kernel still writes it, so the wrapper keeps each launch's
counters referenced until an event recorded after the launch has
completed.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from collections import deque

import torch

from repro_torch.kernels import (CudaKernel, charge, ptr, stream_ptr,
                                 traced_op)

KERNEL = CudaKernel(
    "ring_combine.cu", "ring_combine_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
# the kernel's CUDA block (4 warps; __launch_bounds__ keeps 4 of them
# resident on an SM) and the elements a warp loads before it stores
WARPS_PER_CTA = 4
CTAS_PER_SM = 4
WARP_STEP = 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# (event after the launch, its pinned counters), oldest first
_IN_FLIGHT: deque = deque()
_IN_FLIGHT_LOCK = threading.Lock()


def _hold_until_done(progress, stream):
    """Keep ``progress`` referenced until the stream has passed the launch
    just queued on it; drop the entries of launches that have ended."""
    ev = torch.cuda.Event()
    ev.record(stream)
    with _IN_FLIGHT_LOCK:
        while _IN_FLIGHT and _IN_FLIGHT[0][0].query():
            _IN_FLIGHT.popleft()
        _IN_FLIGHT.append((ev, progress))


def work(C: int, itemsize: int = 4) -> dict:
    """The combine's work, the bounds' formula: no tensor-core ``flops``,
    C adds on the FP32 pipes (``ops``), ``bytes`` acc and incoming read and
    the sum written once."""
    return {"flops": 0.0, "ops": float(C), "bytes": 3 * C * itemsize}


def _meta(acc, incoming, **kw):
    """The JAX ``ring_reduce/ops.py::_meta`` keys and formula."""
    return {"bytes": 3 * acc.numel() * acc.element_size(),
            "shape": list(acc.shape)}


def _blocks(acc, incoming, block: int) -> tuple[int, int]:
    """(block, n_blocks) under the TPU kernel's contract: ``block =
    min(block, C)`` and ``C % block == 0``; raises otherwise."""
    if acc.dim() != 1 or incoming.shape != acc.shape:
        raise ValueError(f"ring_combine wants acc, incoming [C]; got "
                         f"{tuple(acc.shape)}, {tuple(incoming.shape)}")
    C = acc.shape[0]
    block = min(block, C)
    if block <= 0 or C % block:
        raise ValueError(f"ring_combine: C {C} is not a multiple of block "
                         f"{block}")
    return block, C // block


def combine_vec(block: int, itemsize: int, *ptrs: int) -> int:
    """Elements per access: 16 bytes' worth when every pointer is 16-byte
    aligned and ``block`` is a multiple of it, else 1."""
    vec = 16 // itemsize
    if block % vec or any(p % 16 for p in ptrs):
        return 1
    return vec


def combine_grid(n_blocks: int, sms: int) -> int:
    """CUDA blocks for ``n_blocks`` ring blocks: one warp a ring block, at
    most one wave of resident blocks (``CTAS_PER_SM`` on each of ``sms``
    SMs), whose warps then walk the rest in a grid stride."""
    return max(1, min(-(-n_blocks // WARPS_PER_CTA), CTAS_PER_SM * sms))


def worker_ring_blocks(worker: int, n_blocks: int, grid: int) -> range:
    """The ring blocks that warp ``worker`` of a ``grid``-block launch
    combines, in the order it combines them (and stores their counters)."""
    return range(worker, n_blocks, grid * WARPS_PER_CTA)


def lane_elements(lane: int, block: int, vec: int) -> list[int]:
    """The offsets in a ring block that ``lane`` of its warp combines, in
    its order: ``WARP_STEP`` elements a warp at a time, each lane's ``vec``
    elements at ``(u·32 + lane)·vec`` of a step; within a step every load
    comes before the first store."""
    out = []
    for i0 in range(0, block, WARP_STEP):
        for u in range(WARP_STEP // (32 * vec)):
            i = i0 + (u * 32 + lane) * vec
            if i < block:
                out.extend(range(i, i + vec))
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def combine_ref(acc, incoming):
    """Plain PyTorch version of the combine."""
    return acc + incoming


def progress_ref(C: int, block: int):
    """Plain PyTorch version of the counters after a complete combine."""
    return torch.arange(1, C // block + 1, dtype=torch.int32)


def _counters(progress, n_blocks: int, pinned: bool):
    """The caller's ``progress`` checked against the launch, or fresh
    zeroed counters."""
    if progress is None:
        return torch.zeros(n_blocks, dtype=torch.int32, pin_memory=pinned)
    if (progress.shape != (n_blocks,) or progress.dtype != torch.int32
            or progress.device.type != "cpu"
            or not progress.is_contiguous()
            or (pinned and not progress.is_pinned())):
        raise ValueError(
            f"ring_combine: progress must be contiguous int32 [{n_blocks}] in "
            f"{'pinned ' if pinned else ''}host memory; got {progress.dtype} "
            f"{tuple(progress.shape)} on {progress.device}")
    return progress


def _check_dtypes(acc, incoming):
    if acc.dtype not in _DTYPE_CODE or incoming.dtype != acc.dtype:
        raise TypeError(f"ring_combine kernel takes float32 or bfloat16 "
                        f"acc/incoming of one dtype; got {acc.dtype}, "
                        f"{incoming.dtype}")


def ring_combine_cuda(acc, incoming, block=1024, progress=None):
    """Launch the CUDA kernel; raises on anything it does not take.
    Returns ``(out, progress)`` without waiting for the kernel."""
    block, n_blocks = _blocks(acc, incoming, block)
    _check_dtypes(acc, incoming)
    if incoming.device != acc.device:
        raise ValueError("ring_combine: tensors on different devices")
    if not (acc.is_contiguous() and incoming.is_contiguous()):
        raise ValueError("ring_combine kernel takes contiguous acc/incoming")
    progress = _counters(progress, n_blocks, pinned=True)
    out = torch.empty_like(acc)
    vec = combine_vec(block, acc.element_size(), acc.data_ptr(),
                      incoming.data_ptr(), out.data_ptr())
    grid = combine_grid(n_blocks, _sm_count(acc.device.index))
    KERNEL.launch(ptr(acc), ptr(incoming), ptr(out), ptr(progress), n_blocks,
                  block, _DTYPE_CODE[acc.dtype], vec, grid,
                  stream_ptr(acc.device))
    _hold_until_done(progress, torch.cuda.current_stream(acc.device))
    return out, progress


def ring_combine_meta(acc, incoming, block=1024, progress=None):
    """The meta route: the kernel's checks, an empty meta sum and the
    caller's (or zeroed) counters; launches nothing."""
    block, n_blocks = _blocks(acc, incoming, block)
    _check_dtypes(acc, incoming)
    charge("ring_combine", work(acc.shape[0], acc.element_size()))
    return torch.empty_like(acc), _counters(progress, n_blocks, pinned=False)


@traced_op("ring_combine", "comm", _meta)
def ring_combine(acc, incoming, block=1024, progress=None):
    """acc, incoming [C] -> (acc + incoming [C], progress [C // block]
    int32 in host memory; pinned on a CUDA tensor, see the module note).
    ``progress``, if given, is the caller's counters to write (not
    cleared first).

    CUDA tensors go to the kernel; CPU tensors to the plain version; meta
    tensors to the meta route (the kernel's checks, an empty meta sum and
    zero counters, the work charged to the op analysis in progress)."""
    if acc.device.type == "cuda":
        return ring_combine_cuda(acc, incoming, block, progress)
    if acc.device.type == "meta":
        return ring_combine_meta(acc, incoming, block, progress)
    if acc.device.type == "cpu":
        block, n_blocks = _blocks(acc, incoming, block)
        done = progress_ref(acc.shape[0], block)
        if progress is not None:
            done = _counters(progress, n_blocks, pinned=False).copy_(done)
        return combine_ref(acc, incoming), done
    raise ValueError(f"ring_combine: unsupported device {acc.device}")
