"""Fused residual add + RMSNorm, forward and backward: CUDA kernel
wrappers, plain versions, autograd, tracing.

Replaces the TPU kernel ``src/repro/kernels/fused_norm/kernel.py``
(``fused_residual_rmsnorm_fwd``).  Bound on an H100: memory, 4*R*D*itemsize
bytes (x, res read; y, h written); the kernel (``csrc/fused_norm.cu``) reads
each row once with 16-byte accesses, one block per row, and keeps the
sum of squares in fp32.  At decode (R = batch) a launch costs more than its
bytes.

The backward (``csrc/fused_norm_bwd.cu``) is what the JAX package gets by
autodiff of ``kernels/fused_norm/ref.py::fused_ref``: no Pallas kernel, so
no traced-op name of its own.  It reads each input once (a thread keeps
its columns' h and dy in registers across the row's reduction, the next
row's inputs in flight, and its dscale partial in registers across rows)
and takes D up to ``BWD_MAX_D`` (rows wider than 4096, the MoE models'
6144 and 7168, without the staging ring: each thread loads its own
columns; rows wider than 8192, llama3-405b's 16384, on blocks of 1024
threads, one an SM, two passes over a row, and scale and the dscale
partial in shared memory).  ``fused_residual_rmsnorm`` is a
``torch.autograd.Function`` when a gradient is wanted.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (CudaKernel, charge, ptr, stream_ptr,
                                 traced_op)

KERNEL = CudaKernel(
    "fused_norm.cu", "fused_residual_rmsnorm_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                             ctypes.c_int, ctypes.c_void_p])
BWD_KERNEL = CudaKernel(
    "fused_norm_bwd.cu", "fused_residual_rmsnorm_bwd_launch",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_float,
                                                  ctypes.c_int,
                                                  ctypes.c_void_p])
BWD_BLOCKS_PER_SM = 2          # rows_kernel's grid, and dscale's partials
BWD_WIDE_D = 8192              # wider rows: wide_rows_kernel, 1 block an SM
BWD_MAX_D = 16384              # the widest row the backward takes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def bwd_blocks(R: int, D: int, sms: int) -> int:
    """The backward's grid, which is also its dscale partial rows: two
    blocks an SM, one for rows over ``BWD_WIDE_D`` (a block of 1024
    threads fills an SM), never more than R."""
    return min(R, (1 if D > BWD_WIDE_D else BWD_BLOCKS_PER_SM) * sms)


def work(R: int, D: int, itemsize: int = 2, backward: bool = False,
         dh: bool = True) -> dict:
    """The function's work, the bounds' formula: no tensor-core ``flops``;
    ``ops`` on the FP32 pipes, 6 an element forward (add, square, sum,
    scale twice, the product), 12 backward; ``bytes`` each input read and
    each output written once: forward x, res read, y, h written and scale
    (fp32) read; backward x, res, dy (and dh) read, dx written, scale read
    and dscale written (fp32)."""
    if backward:
        return {"flops": 0.0, "ops": 12.0 * R * D,
                "bytes": (4 + dh) * R * D * itemsize + 2 * D * 4}
    return {"flops": 0.0, "ops": 6.0 * R * D,
            "bytes": 4 * R * D * itemsize + D * 4}


def _meta(x, res, scale, eps=1e-5):
    return {"flops": 6.0 * x.numel(),
            "bytes": 4 * x.numel() * x.element_size(),
            "shape": list(x.shape)}


def fused_ref(x, res, scale, eps=1e-5):
    """Plain PyTorch version: (y, h) in ``x.dtype``, math in fp32."""
    h = x.float() + res.float()
    var = torch.mean(h * h, dim=-1, keepdim=True)
    y = h * torch.rsqrt(var + eps) * scale.float()
    return y.to(x.dtype), h.to(x.dtype)


def fused_bwd_ref(x, res, scale, dy, dh=None, eps=1e-5):
    """Plain PyTorch version of the backward kernel, step by step in fp32:
    h = x + res, r = rsqrt(mean(h^2) + eps), g = dy*scale,
    dh_total = dh + r*g - h*r^3*mean(h*g), dscale = sum_rows dy*h*r.
    Returns (dx, dscale): dx (= dres) in x's dtype, dscale float32."""
    h = x.float() + res.float()
    r = torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    dyf = dy.float()
    g = dyf * scale.float()
    dt = r * g - h * r ** 3 * torch.mean(h * g, dim=-1, keepdim=True)
    if dh is not None:
        dt = dt + dh.float()
    return dt.to(x.dtype), (dyf * h * r).sum(0)


def _check(x, res, scale):
    if x.dim() != 2 or res.shape != x.shape or scale.shape != x.shape[-1:]:
        raise ValueError(f"fused_residual_rmsnorm wants x,res [R,D] and "
                         f"scale [D]; got {tuple(x.shape)}, "
                         f"{tuple(res.shape)}, {tuple(scale.shape)}")
    if x.dtype not in _DTYPE_CODE or res.dtype != x.dtype:
        raise TypeError(f"fused_residual_rmsnorm kernel takes float32 or "
                        f"bfloat16 x/res of one dtype; got {x.dtype}, "
                        f"{res.dtype}")
    if not (res.device == scale.device == x.device):
        raise ValueError("fused_residual_rmsnorm: tensors on different devices")
    if not (x.is_contiguous() and res.is_contiguous()):
        raise ValueError("fused_residual_rmsnorm kernel takes contiguous x/res")


def fused_cuda(x, res, scale, eps=1e-5):
    """Launch the CUDA kernel; raises on anything it does not take."""
    _check(x, res, scale)
    scale = scale.to(torch.float32).contiguous()
    R, D = x.shape
    y = torch.empty_like(x)
    h = torch.empty_like(x)
    KERNEL.launch(ptr(x), ptr(res), ptr(scale), ptr(y), ptr(h), R, D,
                  float(eps), _DTYPE_CODE[x.dtype], stream_ptr(x.device))
    return y, h


def fused_meta(x, res, scale, eps=1e-5):
    """The meta route: the kernel's checks, empty meta outputs, the work
    charged to the op analysis in progress; launches nothing."""
    _check(x, res, scale)
    charge("fused_residual_rmsnorm", work(*x.shape, x.element_size()))
    return torch.empty_like(x), torch.empty_like(x)


def _check_bwd(x, res, scale, dy, dh):
    _check(x, res, scale)
    for name, t in (("dy", dy), ("dh", dh)):
        if t is None and name == "dh":
            continue
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"fused_residual_rmsnorm backward: {name} must "
                             f"match x {tuple(x.shape)} {x.dtype}; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_residual_rmsnorm backward takes a "
                             f"contiguous {name}")
    if x.shape[1] > BWD_MAX_D:
        raise ValueError(f"fused_residual_rmsnorm backward kernel takes D up "
                         f"to {BWD_MAX_D}, not {x.shape[1]}")


def fused_bwd_meta(x, res, scale, dy, dh=None, eps=1e-5):
    """The backward's meta route (see ``fused_meta``)."""
    _check_bwd(x, res, scale, dy, dh)
    charge("fused_residual_rmsnorm_bwd",
           work(*x.shape, x.element_size(), backward=True,
                dh=dh is not None))
    return (torch.empty_like(x),
            torch.empty(x.shape[1], dtype=torch.float32, device=x.device))


def fused_bwd_cuda(x, res, scale, dy, dh=None, eps=1e-5):
    """Launch the backward kernel; raises on anything it does not take.
    Returns (dx, dscale) as ``fused_bwd_ref``."""
    _check_bwd(x, res, scale, dy, dh)
    R, D = x.shape
    if x.device.type != "cuda":
        raise ValueError(f"fused_residual_rmsnorm kernels take CUDA tensors, "
                         f"not {x.device}")
    scale = scale.to(torch.float32).contiguous()
    dx = torch.empty_like(x)
    if R == 0:
        return dx, torch.zeros(D, dtype=torch.float32, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = bwd_blocks(R, D, sms)
    partial = torch.empty(blocks, D, dtype=torch.float32, device=x.device)
    dscale = torch.empty(D, dtype=torch.float32, device=x.device)
    BWD_KERNEL.launch(ptr(x), ptr(res), ptr(scale), ptr(dy),
                      None if dh is None else ptr(dh), ptr(dx), ptr(partial),
                      ptr(dscale), R, D, blocks, float(eps),
                      _DTYPE_CODE[x.dtype], stream_ptr(x.device))
    return dx, dscale


@traced_op("fused_residual_rmsnorm", "compute", _meta)
def _forward(x, res, scale, eps=1e-5):
    """The traced call, one span a launch: the kernel on CUDA tensors, the
    plain version on CPU ones, the meta route on meta ones.  It runs inside
    ``FusedResidualRMSNorm``'s forward, so its span closes before autograd
    saves the inputs: under remat, PyTorch stops a layer's recompute right
    there when this is the layer's last op, which would otherwise end the
    span unrecorded."""
    if x.device.type == "cuda":
        return fused_cuda(x, res, scale, eps)
    if x.device.type == "cpu":
        return fused_ref(x, res, scale, eps)
    if x.device.type == "meta":
        return fused_meta(x, res, scale, eps)
    raise ValueError(f"fused_residual_rmsnorm: unsupported device {x.device}")


class FusedResidualRMSNorm(torch.autograd.Function):
    """The forward kernel, and the backward kernel on the cotangents of y
    and h (h's may be absent: the final norm's h is unused).  Saves x, res
    and scale; dx and dres are the same tensor."""

    @staticmethod
    def forward(ctx, x, res, scale, eps):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, res, scale)
        ctx.eps = eps
        return _forward(x, res, scale, eps)

    @staticmethod
    def backward(ctx, dy, dh):
        x, res, scale = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        if dh is not None:
            dh = dh.contiguous()
        if x.device.type == "cuda":
            bwd = fused_bwd_cuda
        elif x.device.type == "meta":
            bwd = fused_bwd_meta
        else:
            bwd = fused_bwd_ref
        dx, dscale = bwd(x, res, scale, dy.contiguous(), dh, ctx.eps)
        return dx, dx, dscale.to(scale.dtype), None


def fused_residual_rmsnorm(x, res, scale, eps=1e-5):
    """x, res [R, D]; scale [D] -> (normed [R, D], new residual [R, D]).

    CUDA tensors go to the kernels; CPU tensors to the plain versions;
    meta tensors to the meta routes.  When a gradient is wanted the call
    goes through ``FusedResidualRMSNorm``."""
    if torch.is_grad_enabled() and (x.requires_grad or res.requires_grad
                                    or scale.requires_grad):
        return FusedResidualRMSNorm.apply(x, res, scale, eps)
    return _forward(x, res, scale, eps)
