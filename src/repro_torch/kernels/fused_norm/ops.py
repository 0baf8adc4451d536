"""Fused residual add + RMSNorm: CUDA kernel wrapper, plain version, tracing.

Replaces the TPU kernel ``src/repro/kernels/fused_norm/kernel.py``
(``fused_residual_rmsnorm_fwd``).  Bound on an H100: memory, 4*R*D*itemsize
bytes (x, res read; y, h written); the kernel (``csrc/fused_norm.cu``) reads
each row once with 16-byte accesses, one block per row, and keeps the
sum of squares in fp32.  At decode (R = batch) a launch costs more than its
bytes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import CudaKernel, ptr, stream_ptr, traced_op

KERNEL = CudaKernel(
    "fused_norm.cu", "fused_residual_rmsnorm_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                             ctypes.c_int, ctypes.c_void_p])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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


def fused_cuda(x, res, scale, eps=1e-5):
    """Launch the CUDA kernel; raises on anything it does not take."""
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
    scale = scale.to(torch.float32).contiguous()
    R, D = x.shape
    y = torch.empty_like(x)
    h = torch.empty_like(x)
    KERNEL.launch(ptr(x), ptr(res), ptr(scale), ptr(y), ptr(h), R, D,
                  float(eps), _DTYPE_CODE[x.dtype], stream_ptr(x.device))
    return y, h


@traced_op("fused_residual_rmsnorm", "compute", _meta)
def fused_residual_rmsnorm(x, res, scale, eps=1e-5):
    """x, res [R, D]; scale [D] -> (normed [R, D], new residual [R, D]).

    CUDA tensors go to the kernel; CPU tensors to the plain version."""
    if x.device.type == "cuda":
        return fused_cuda(x, res, scale, eps)
    if x.device.type == "cpu":
        return fused_ref(x, res, scale, eps)
    raise ValueError(f"fused_residual_rmsnorm: unsupported device {x.device}")
