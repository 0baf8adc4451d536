"""Flash-attention forward: CUDA kernel wrappers, plain version, tracing.

Replaces the TPU kernel ``src/repro/kernels/flash_attention/kernel.py``
(``flash_attention_fwd``): causal or full GQA attention with ``S == T``,
which is what prefill computes.  Bound on an H100: operations
(4*B*S^2*H*hd flops, half of it causal).  Two hand-written kernels, one
route per dtype (``route``), head_dim 64 and 128, any S (each masks its
ragged edge):
  * bf16 -> ``csrc/flash_attention_wgmma.cu``: Q.K^T and P.V by wgmma on
    the tensor cores, Q/K/V brought by TMA, online softmax in fp32
    registers, P rounded to bf16 for P.V;
  * fp32 -> ``csrc/flash_attention.cu``: K/V tiles through shared memory
    with an fp32 online softmax on the FP32 pipes, so that the fp32 result
    is held to a full-fp32 reference and not to TF32.
Each route counts its own launches.  A bf16 call never takes the FP32
pipes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import CudaKernel, ptr, stream_ptr, traced_op

NEG_INF = -1e30
HEAD_DIMS = (64, 128)

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
KERNELS = {
    "wgmma": CudaKernel("flash_attention_wgmma.cu",
                        "flash_attention_wgmma_launch", _ARGS),
    "fp32": CudaKernel("flash_attention.cu", "flash_attention_fwd_launch",
                       _ARGS),
}
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "fp32"}


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


def route(dtype, head_dim: int) -> str:
    """The kernel that a CUDA call in ``dtype`` with this head_dim
    launches, by dtype alone: bf16 -> "wgmma" (tensor cores), fp32 ->
    "fp32" (FP32 pipes).  Raises on what neither kernel takes."""
    if dtype not in ROUTES:
        raise TypeError(f"flash_attention kernels take float32 or bfloat16, "
                        f"not {dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernels have head_dim "
                         f"{HEAD_DIMS}, not {head_dim}")
    return ROUTES[dtype]


def check_operands(q, k, v) -> str:
    """Everything the kernels need of q/k/v but their device: shapes,
    dtypes, head_dim, contiguity, alignment.  Returns the route."""
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
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernels take q/k/v of one dtype; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    r = route(q.dtype, hd)
    if not (k.device == v.device == q.device):
        raise ValueError("flash_attention: tensors on different devices")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention kernels take contiguous, "
                             "16-byte-aligned q/k/v")
    return r


def attention_cuda(q, k, v, causal=True):
    """Launch the kernel of q's dtype; raises on anything it does not
    take."""
    r = check_operands(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernels take CUDA tensors, not "
                         f"{q.device}")
    B, S, H, hd = q.shape
    o = torch.empty_like(q)
    KERNELS[r].launch(ptr(q), ptr(k), ptr(v), ptr(o), B, S, H, k.shape[2],
                      hd, int(bool(causal)), stream_ptr(q.device))
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
