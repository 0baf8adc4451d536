"""Flash-attention forward: CUDA kernel wrapper, plain version, tracing.

Replaces the TPU kernel ``src/repro/kernels/flash_attention/kernel.py``
(``flash_attention_fwd``): causal or full GQA attention with ``S == T``,
which is what prefill computes.  Bound on an H100: operations
(4*B*S^2*H*hd flops, half of it causal).  The kernel
(``csrc/flash_attention.cu``) streams K/V tiles through shared memory
up to the causal frontier with an fp32 online softmax, on the FP32 pipes;
it masks the ragged edge itself, so any S is taken.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import CudaKernel, ptr, stream_ptr, traced_op

NEG_INF = -1e30
HEAD_DIMS = (64, 128)

KERNEL = CudaKernel(
    "flash_attention.cu", "flash_attention_fwd_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _meta(q, k, v, causal=True):
    B, S, H, hd = q.shape
    factor = 0.5 if causal else 1.0
    return {"flops": 4.0 * B * S * S * H * hd * factor,
            "shape": list(q.shape)}


def attention_ref(q, k, v, causal=True):
    """Plain PyTorch version. q [B,S,H,hd]; k/v [B,T,KV,hd] -> [B,S,H,hd];
    fp32 softmax, output in ``q.dtype``."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd).float()
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * (hd ** -0.5)
    if causal:
        mask = (torch.arange(S, device=q.device)[:, None]
                >= torch.arange(T, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkh->bskgh", w, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)


def attention_cuda(q, k, v, causal=True):
    """Launch the CUDA kernel; raises on anything it does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention wants q [B,S,H,hd], k/v "
                         f"[B,S,KV,hd]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd or H % KV:
        raise ValueError(f"flash_attention kernel needs k/v [B,S,KV,hd] with "
                         f"H % KV == 0; got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel has head_dim {HEAD_DIMS}, "
                         f"not {hd}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (k.device == v.device == q.device):
        raise ValueError("flash_attention: tensors on different devices")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention kernel takes contiguous, "
                             "16-byte-aligned q/k/v")
    o = torch.empty_like(q)
    KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(o), B, S, H, KV, hd,
                  int(bool(causal)), _DTYPE_CODE[q.dtype],
                  stream_ptr(q.device))
    return o


@traced_op("flash_attention", "compute", _meta)
def flash_attention(q, k, v, causal=True):
    """q [B,S,H,hd]; k/v [B,S,KV,hd] -> [B,S,H,hd].

    CUDA tensors go to the kernel; CPU tensors to the plain version."""
    if q.device.type == "cuda":
        return attention_cuda(q, k, v, causal)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal)
    raise ValueError(f"flash_attention: unsupported device {q.device}")
