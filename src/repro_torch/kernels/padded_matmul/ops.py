"""Case-2 padded matmul: CUDA kernel wrappers, plain version, tracing.

Replaces the TPU kernel ``src/repro/kernels/padded_matmul/kernel.py``
(``matmul_tiled``) and its wrapper ``ops.py::padded_matmul``: the paper's
Case-2 fix pads a misaligned dimension (the FFN width 8484) up to the 128
tile, runs the tiled kernel on aligned shapes and slices the result back.
Bound on an H100: operations at the Case-2 shape.

Two hand-written kernels, one route per dtype (``route``), both wgmma on
the tensor cores with fp32 accumulators, operands brought by TMA:
  * bf16 -> ``"wgmma"``, ``csrc/padded_matmul_wgmma.cu``: TMA needs 16-byte
    rows, so a call whose K or N is not a multiple of 8 runs on operands
    padded with zeros to that and is sliced back (``tma_operands``);
  * fp32 -> ``"tf32x3"``, ``csrc/padded_matmul_tf32.cu``: split TF32, the
    product as a_hi.b_hi + a_hi.b_lo + a_lo.b_hi of tf32 terms (hi = x
    rounded to tf32, lo = the rest rounded to tf32), on the tensor cores
    and not the FP32 pipes, held to a full-fp32 product (3e-4, atol at
    least 2e-3·√K, a width that would admit one TF32 pass too: the card
    check also holds the route well below one pass's error against an
    fp64 product).  tf32 wgmma reads only K-major operands: a pre-pass
    writes b^T split into scratch the wrapper allocates
    (``tf32_scratch``), and a is split in shared memory by the warpgroup
    that reads it, or by the pre-pass too where TMA cannot read a (an
    address off 16 bytes, K off a multiple of 4).  The pre-pass loads
    with masks, so the route takes operands at any address and shape.
Each route counts its own launches.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import (CudaKernel, charge, ptr, stream_ptr,
                                 traced_op)

TILE = 128

TMA_ALIGN = 8      # bf16 elements in the 16 bytes a TMA row stride needs

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_TF32_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
KERNELS = {
    "wgmma": CudaKernel("padded_matmul_wgmma.cu", "matmul_wgmma_launch", _ARGS),
    "tf32x3": CudaKernel("padded_matmul_tf32.cu", "matmul_tf32_launch",
                         _TF32_ARGS),
}
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}


def _pad_to(x, m0: int, m1: int):
    p0 = (-x.shape[0]) % m0
    p1 = (-x.shape[1]) % m1
    if p0 or p1:
        x = F.pad(x, (0, p1, 0, p0))
    return x


def work(M: int, K: int, N: int, itemsize: int = 2) -> dict:
    """The product's work, the bounds' formula: ``flops`` 2·M·K·N, no
    ``ops`` off the tensor cores, ``bytes`` a and b read and the [M,N]
    result written once."""
    return {"flops": 2.0 * M * K * N, "ops": 0.0,
            "bytes": (M * K + K * N + M * N) * itemsize}


def _meta(a, b, **kw):
    """The JAX ``padded_matmul/ops.py::_meta`` keys and formula: flops of
    the unpadded shape."""
    M, K = a.shape
    N = b.shape[1]
    return {"flops": 2.0 * M * K * N, "shape": [M, K, N]}


def matmul_ref(a, b):
    """Plain PyTorch version: the product in fp32, rounded to a's dtype."""
    return (a.float() @ b.float()).to(a.dtype)


def _check_aligned(a, b):
    """The TPU kernel's contract: each dimension a multiple of the 128
    tile, the tile cut to the dimension (``kernel.py:43-49``), so a
    dimension below 128 may have any length."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul_tiled wants a [M,K], b [K,N]; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    (M, K), N = a.shape, b.shape[1]
    for dim in (M, N, K):
        blk = min(TILE, dim)
        if blk <= 0 or dim % blk:
            raise ValueError(f"matmul_tiled requires aligned shapes, got "
                             f"(M, N, K) = {(M, N, K)}: use padded_matmul")


def route(dtype) -> str:
    """The kernel that a CUDA call in ``dtype`` launches, by dtype alone:
    bf16 -> "wgmma", fp32 -> "tf32x3" (split TF32), both on the tensor
    cores."""
    if dtype not in ROUTES:
        raise TypeError(f"matmul_tiled kernels take float32 or bfloat16, "
                        f"not {dtype}")
    return ROUTES[dtype]


def tf32_split_a_in_kernel(a) -> bool:
    """Whether the tf32x3 kernel splits a in shared memory, which it does
    for an a that TMA can read (16-byte aligned, K a multiple of 4; faster
    than the pre-pass's split at the Case-2 shape); otherwise the pre-pass
    splits a too."""
    return a.data_ptr() % 16 == 0 and a.shape[1] % 4 == 0


def tf32_scratch(M: int, N: int, K: int, split_a_in_kernel: bool) -> dict:
    """The shapes of the tf32x3 route's split scratch, by name, in the
    order its C launch function takes them (Kp = K rounded up to 4, the
    columns past K zero): a's pair [2,M,Kp] (hi, then lo) unless the
    kernel splits a, and b^T's pair [2,N,Kp]."""
    Kp = -(-K // 4) * 4
    shapes = {} if split_a_in_kernel else {"a_pair": (2, M, Kp)}
    shapes["bt_pair"] = (2, N, Kp)
    return shapes


def tf32_scratch_bytes(M: int, N: int, K: int,
                       split_a_in_kernel: bool) -> int:
    """Bytes of ``tf32_scratch`` (fp32)."""
    return sum(4 * math.prod(s) for s in
               tf32_scratch(M, N, K, split_a_in_kernel).values())


def tma_operands(a, b):
    """a [M,K], b [K,N] as the wgmma kernel takes them: K and N padded with
    zeros to a multiple of ``TMA_ALIGN`` (zeros in K add nothing to the
    sum; the caller slices the extra columns off)."""
    K, N = b.shape
    pk, pn = (-K) % TMA_ALIGN, (-N) % TMA_ALIGN
    if pk:
        a = F.pad(a, (0, pk))
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    return a, b


def check_operands(a, b) -> str:
    """Everything the kernels need of a and b but their device: shapes,
    dtypes, contiguity, alignment.  Returns the route."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul_tiled wants a [M,K], b [K,N]; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if b.dtype != a.dtype:
        raise TypeError(f"matmul_tiled kernels take a/b of one dtype; got "
                        f"{a.dtype}, {b.dtype}")
    r = route(a.dtype)
    if b.device != a.device:
        raise ValueError("matmul_tiled: tensors on different devices")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul_tiled kernels take contiguous a/b")
    if r == "wgmma" and (a.data_ptr() % 16 or b.data_ptr() % 16):
        raise ValueError("matmul_tiled's wgmma kernel takes 16-byte-aligned "
                         "a/b (TMA)")
    return r


def matmul_cuda(a, b):
    """Launch the kernel of a's dtype on a [M,K] @ b [K,N]; raises on
    anything it does not take.  The kernels mask ragged edges, which the
    contract leaves to dimensions below the tile."""
    r = check_operands(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"matmul_tiled kernels take CUDA tensors, not "
                         f"{a.device}")
    M, N = a.shape[0], b.shape[1]
    if r == "tf32x3":
        K = a.shape[1]
        in_kernel = tf32_split_a_in_kernel(a)
        scratch = {name: torch.empty(shape, dtype=torch.float32,
                                     device=a.device)
                   for name, shape in tf32_scratch(M, N, K,
                                                   in_kernel).items()}
        out = torch.empty((M, N), dtype=a.dtype, device=a.device)
        a_pair = scratch.get("a_pair")
        KERNELS[r].launch(ptr(a), ptr(b), ptr(out),
                          None if a_pair is None else ptr(a_pair),
                          ptr(scratch["bt_pair"]), M, N, K, int(in_kernel),
                          stream_ptr(a.device))
        return out
    a, b = tma_operands(a, b)
    K, Nk = b.shape
    out = torch.empty((M, Nk), dtype=a.dtype, device=a.device)
    KERNELS[r].launch(ptr(a), ptr(b), ptr(out), M, Nk, K,
                      stream_ptr(a.device))
    return out if Nk == N else out[:, :N].contiguous()


def matmul_meta(a, b):
    """The meta route: the kernel's checks, an empty meta result, the work
    charged to the op analysis in progress; launches nothing."""
    check_operands(a, b)
    (M, K), N = a.shape, b.shape[1]
    charge("padded_matmul", work(M, K, N, a.element_size()))
    return torch.empty((M, N), dtype=a.dtype, device=a.device)


def matmul_tiled(a, b):
    """a [M,K] @ b [K,N] in a's dtype; every dimension must be a multiple
    of the 128 tile or below it (``padded_matmul`` pads).  CUDA tensors go
    to the kernel; CPU tensors to the plain version; meta tensors to the
    meta route."""
    _check_aligned(a, b)
    if a.device.type == "cuda":
        return matmul_cuda(a, b)
    if a.device.type == "cpu":
        return matmul_ref(a, b)
    if a.device.type == "meta":
        return matmul_meta(a, b)
    raise ValueError(f"matmul_tiled: unsupported device {a.device}")


@traced_op("padded_matmul", "compute", _meta)
def padded_matmul(a, b, block=TILE):
    """a [M,K] @ b [K,N] for any shape: M, K and N are padded with zeros up
    to a multiple of ``block``, multiplied by ``matmul_tiled`` and the
    result sliced back to [M,N] (a view of the padded product).  ``block``
    must be a multiple of the kernel's 128 tile."""
    if block <= 0 or block % TILE:
        raise ValueError(f"padded_matmul: block {block} is not a multiple "
                         f"of the {TILE} tile")
    M, N = a.shape[0], b.shape[1]
    ap = _pad_to(a, block, block)
    bp = _pad_to(b, block, block)
    return matmul_tiled(ap, bp)[:M, :N]
