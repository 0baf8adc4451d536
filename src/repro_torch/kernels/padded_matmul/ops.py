"""Case-2 padded matmul: CUDA kernel wrappers, plain version, tracing.

Replaces the TPU kernel ``src/repro/kernels/padded_matmul/kernel.py``
(``matmul_tiled``) and its wrapper ``ops.py::padded_matmul``: the paper's
Case-2 fix pads a misaligned dimension (the FFN width 8484) up to the 128
tile, runs the tiled kernel on aligned shapes and slices the result back.
Bound on an H100: operations at the Case-2 shape.

Two hand-written kernels, one route per dtype (``route``):
  * bf16 -> ``csrc/padded_matmul_wgmma.cu``: wgmma on the tensor cores
    with an fp32 accumulator, operands brought by TMA; TMA needs 16-byte
    rows, so a call whose K or N is not a multiple of 8 runs on operands
    padded with zeros to that and is sliced back (``tma_operands``);
  * fp32 -> ``csrc/padded_matmul.cu``: IEEE fp32 fused multiply-adds on the
    FP32 pipes, chosen on purpose: its result is held to a full-fp32
    product, not to TF32.
Each route counts its own launches.  A bf16 call never takes the FP32
pipes.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import CudaKernel, ptr, stream_ptr, traced_op

TILE = 128

TMA_ALIGN = 8      # bf16 elements in the 16 bytes a TMA row stride needs

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
KERNELS = {
    "wgmma": CudaKernel("padded_matmul_wgmma.cu", "matmul_wgmma_launch", _ARGS),
    "fp32": CudaKernel("padded_matmul.cu", "matmul_tiled_launch", _ARGS),
}
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "fp32"}


def _pad_to(x, m0: int, m1: int):
    p0 = (-x.shape[0]) % m0
    p1 = (-x.shape[1]) % m1
    if p0 or p1:
        x = F.pad(x, (0, p1, 0, p0))
    return x


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
    bf16 -> "wgmma" (tensor cores), fp32 -> "fp32" (FP32 pipes)."""
    if dtype not in ROUTES:
        raise TypeError(f"matmul_tiled kernels take float32 or bfloat16, "
                        f"not {dtype}")
    return ROUTES[dtype]


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
    if r == "wgmma":
        a, b = tma_operands(a, b)
    K, Nk = b.shape
    out = torch.empty((M, Nk), dtype=a.dtype, device=a.device)
    KERNELS[r].launch(ptr(a), ptr(b), ptr(out), M, Nk, K,
                      stream_ptr(a.device))
    return out if Nk == N else out[:, :N].contiguous()


def matmul_tiled(a, b):
    """a [M,K] @ b [K,N] in a's dtype; every dimension must be a multiple
    of the 128 tile or below it (``padded_matmul`` pads).  CUDA tensors go
    to the kernel; CPU tensors to the plain version."""
    _check_aligned(a, b)
    if a.device.type == "cuda":
        return matmul_cuda(a, b)
    if a.device.type == "cpu":
        return matmul_ref(a, b)
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
