"""Flash attention, forward and backward: CUDA kernel wrappers, plain
versions, autograd, tracing.

Replaces the TPU kernel ``src/repro/kernels/flash_attention/kernel.py``
(``flash_attention_fwd``): causal or full GQA attention with ``S == T``,
which is what prefill and training compute.  Bound on an H100: operations
(4*B*S^2*H*hd flops, half of it causal).  Two hand-written forward
kernels, one route per dtype (``route``), both on the tensor cores by
wgmma with TMA, head_dim ``HEAD_DIMS`` (8, 16, 32, 64, 80 and 128; a
width off a whole tile in tiles of 64 or 128 columns on the bf16 routes
and 32 or 96 on the fp32 ones, the tensor maps at the true head_dim so
that the columns past it load as zeros, which add exact zeros to every
product, and only the real columns stored; 8 to 32 are the JAX package's
reduced configs and its kernel sweep), any S (each masks its ragged
edge):
  * bf16 -> ``"wgmma"``, ``csrc/flash_attention_wgmma.cu``: Q.K^T and P.V
    in bf16, online softmax in fp32 registers, P rounded to bf16 for P.V;
  * fp32 -> ``"tf32x3"``, ``csrc/flash_attention_tf32.cu``: split TF32,
    each product X.Y as X_hi.Y_hi + X_hi.Y_lo + X_lo.Y_hi of tf32 terms
    (hi = x rounded to tf32, lo = the rest rounded to tf32) into fp32
    accumulators, so that the fp32 result is held to a full-fp32
    reference (3e-4), which one TF32 pass misses; a pre-pass splits K and
    V^T (``csrc/flash_tf32_split.cuh``) into scratch the wrapper allocates
    (``tf32_scratch``).
Each route counts its own launches.  Both write, on request, the rows'
log-sum-exp ``lse`` [B,H,S] (fp32, scaled scores) that the backward
needs; serving asks for none.

The backward is the recompute backward that the JAX package runs through
XLA (``src/repro/models/attention.py:164-235``): it has no Pallas kernel,
so it has no traced-op name either, and its time falls in the training
step's span.  Two hand-written backward kernels, one route per dtype
(``BWD_ROUTES``, the same split as the forward's), head_dim ``HEAD_DIMS``,
any S, each with its own launch count, both deterministic (a dK/dV kernel
over key tiles and a dQ kernel over q tiles, no atomics):
  * bf16 -> ``"wgmma"``, ``csrc/flash_attention_bwd_wgmma.cu``: S, dP and
    the three gradient products by wgmma, P and dS rounded to bf16 as
    register operands;
  * fp32 -> ``"tf32x3"``, ``csrc/flash_attention_bwd_tf32.cu``: the same
    passes in split TF32, after a pre-pass that computes delta and splits
    k, v and the transposes of q, dO, k that the products over the
    sequence read into the scratch ``tf32_scratch`` sizes.
``flash_attention`` is a ``torch.autograd.Function`` when a gradient is
wanted.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import (CudaKernel, charge, ptr, stream_ptr,
                                 traced_op)

NEG_INF = -1e30
HEAD_DIMS = (8, 16, 32, 64, 80, 128)

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_TF32_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
KERNELS = {
    "wgmma": CudaKernel("flash_attention_wgmma.cu",
                        "flash_attention_wgmma_launch", _ARGS),
    "tf32x3": CudaKernel("flash_attention_tf32.cu",
                         "flash_attention_tf32_launch", _TF32_ARGS),
}
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}
_BWD_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_BWD_TF32_ARGS = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 6
                  + [ctypes.c_void_p])
BWD_KERNELS = {
    "wgmma": CudaKernel("flash_attention_bwd_wgmma.cu",
                        "flash_attention_bwd_wgmma_launch", _BWD_ARGS),
    "tf32x3": CudaKernel("flash_attention_bwd_tf32.cu",
                         "flash_attention_bwd_tf32_launch", _BWD_TF32_ARGS),
}
BWD_ROUTES = {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}


def tf32_scratch(B: int, S: int, H: int, KV: int, hd: int,
                 backward: bool) -> dict:
    """The shapes of the tf32x3 route's split scratch, by name, in the
    order its C launch function takes them (``csrc/flash_tf32_split.cuh``):
    a direct split [2,B,S,heads,hd] is the hi terms then the lo terms; a
    transposed one [B,heads,hd,2*S16] holds, per 16-row block of the
    sequence (S16 = S rounded up to 16), the rows' hi terms then their lo
    terms, each 8 rows in the order 0,2,4,6,1,3,5,7.  The forward splits
    K and V^T; the backward k, v and the transposes of q, dO, k (its
    kernels split q and dO tiles in shared memory)."""
    t = 2 * (-(-S // 16) * 16)
    if not backward:
        return {"k_pair": (2, B, S, KV, hd), "vt": (B, KV, hd, t)}
    return {"k_pair": (2, B, S, KV, hd), "v_pair": (2, B, S, KV, hd),
            "qt": (B, H, hd, t), "dot": (B, H, hd, t), "kt": (B, KV, hd, t)}


def tf32_scratch_bytes(B: int, S: int, H: int, KV: int, hd: int,
                       backward: bool) -> int:
    """Bytes of ``tf32_scratch`` (fp32), delta's [B,H,S] not counted."""
    return sum(4 * math.prod(s) for s in
               tf32_scratch(B, S, H, KV, hd, backward).values())


def _scratch(q, k, backward):
    B, S, H, hd = q.shape
    return [torch.empty(shape, dtype=torch.float32, device=q.device)
            for shape in tf32_scratch(B, S, H, k.shape[2], hd,
                                      backward).values()]


def work(B: int, S: int, H: int, KV: int, hd: int, causal: bool = True,
         itemsize: int = 2, backward: bool = False,
         lse: bool = False) -> dict:
    """The function's work, the bounds' formula: ``flops`` of its
    tensor-core products (2 per multiply-add; forward Q·Kᵀ and P·V over
    the (query, key) pairs, S(S+1)/2 of them causal; the backward's five
    products 2.5x that), ``ops`` off the tensor cores (none counted), and
    ``bytes`` each input read and each output written once: forward q, k,
    v read, o written (and lse [B,H,S] fp32 with ``lse``); backward q, k,
    v, o, dO and lse read, dq, dk, dv written."""
    pairs = S * (S + 1) / 2 if causal else S * S
    flops = 4.0 * B * H * hd * pairs
    if backward:
        return {"flops": 2.5 * flops, "ops": 0.0,
                "bytes": 4 * B * S * (H + KV) * hd * itemsize + 4 * B * H * S}
    return {"flops": flops, "ops": 0.0,
            "bytes": 2 * B * S * (H + KV) * hd * itemsize
            + (4 * B * H * S if lse else 0)}


def _work_of(q, k, causal, **kw) -> dict:
    B, S, H, hd = q.shape
    return work(B, S, H, k.shape[2], hd, causal, q.element_size(), **kw)


def _meta(q, k, v, causal=True):
    B, S, H, hd = q.shape
    factor = 0.5 if causal else 1.0
    return {"flops": 4.0 * B * S * S * H * hd * factor,
            "shape": list(q.shape)}


def _scores(q, k, causal):
    """fp32 scaled scores [B,KV,G,S,T], masked with NEG_INF."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd).float()
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * (hd ** -0.5)
    if causal:
        mask = (torch.arange(S, device=q.device)[:, None]
                >= torch.arange(T, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return s


def attention_ref(q, k, v, causal=True, return_lse=False):
    """Plain PyTorch version. q [B,S,H,hd]; k/v [B,T,KV,hd] -> [B,S,H,hd];
    fp32 softmax, output in ``q.dtype``.  With ``return_lse`` also the
    rows' log-sum-exp of the scaled scores, [B,H,S] fp32."""
    B, S, H, hd = q.shape
    s = _scores(q, k, causal)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkh->bskgh", w, v.float())
    o = o.reshape(B, S, H, hd).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1).reshape(B, H, S)
    return o


def attention_bwd_ref(q, k, v, o, do, lse, causal=True):
    """Plain PyTorch version of the backward kernel, step by step in fp32:
    delta = rowsum(dO*O); P = exp(s - lse); dP = dO.V^T;
    dS = P*(dP - delta)*scale; dQ = dS.K, dK = dS^T.Q and dV = P^T.dO
    summed over the query heads of each KV head.  Returns (dq, dk, dv) in
    the inputs' dtype."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qf = q.reshape(B, S, KV, G, hd).float()
    dof = do.reshape(B, S, KV, G, hd).float()
    kf, vf = k.float(), v.float()
    delta = (dof * o.reshape(B, S, KV, G, hd).float()).sum(-1)
    delta = delta.permute(0, 2, 3, 1)                     # [B,KV,G,S]
    p = torch.exp(_scores(q, k, causal) - lse.reshape(B, KV, G, S, 1))
    dp = torch.einsum("bskgh,btkh->bkgst", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bkgst,btkh->bskgh", ds, kf).reshape(B, S, H, hd)
    dk = torch.einsum("bkgst,bskgh->btkh", ds, qf)
    dv = torch.einsum("bkgst,bskgh->btkh", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def route(dtype, head_dim: int) -> str:
    """The kernel that a CUDA call in ``dtype`` with this head_dim
    launches, by dtype alone: bf16 -> "wgmma", fp32 -> "tf32x3" (split
    TF32), both on the tensor cores.  Raises on what neither kernel
    takes."""
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


def _check_cuda(q):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernels take CUDA tensors, not "
                         f"{q.device}")


def attention_cuda(q, k, v, causal=True, return_lse=False):
    """Launch the kernel of q's dtype; raises on anything it does not
    take.  With ``return_lse`` the kernel also writes lse [B,H,S] fp32."""
    r = check_operands(q, k, v)
    _check_cuda(q)
    B, S, H, hd = q.shape
    o = torch.empty_like(q)
    lse = (torch.empty(B, H, S, dtype=torch.float32, device=q.device)
           if return_lse else None)
    args = [ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse) if return_lse else None]
    if r == "tf32x3":
        args += [ptr(t) for t in _scratch(q, k, backward=False)]
    KERNELS[r].launch(*args, B, S, H, k.shape[2], hd, int(bool(causal)),
                      stream_ptr(q.device))
    return (o, lse) if return_lse else o


def attention_meta(q, k, v, causal=True, return_lse=False):
    """The meta route: the kernel's checks, empty meta outputs, the work
    charged to the op analysis in progress; launches nothing."""
    check_operands(q, k, v)
    B, S, H, hd = q.shape
    charge("flash_attention", _work_of(q, k, causal, lse=return_lse))
    o = torch.empty_like(q)
    lse = (torch.empty(B, H, S, dtype=torch.float32, device=q.device)
           if return_lse else None)
    return (o, lse) if return_lse else o


def _check_bwd(q, k, v, o, do, lse):
    check_operands(q, k, v)
    B, S, H, hd = q.shape
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention backward: {name} must match q "
                             f"{tuple(q.shape)} {q.dtype}; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention backward takes a contiguous, "
                             f"16-byte-aligned {name}")
    if (lse.shape != (B, H, S) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash_attention backward wants lse [B,H,S] = "
                         f"{(B, H, S)} contiguous float32 on {q.device}; got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")


def attention_bwd_meta(q, k, v, o, do, lse, causal=True):
    """The backward's meta route (see ``attention_meta``)."""
    _check_bwd(q, k, v, o, do, lse)
    charge("flash_attention_bwd", _work_of(q, k, causal, backward=True))
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def attention_bwd_cuda(q, k, v, o, do, lse, causal=True):
    """Launch the backward kernel of q's dtype (``BWD_ROUTES``); raises on
    anything it does not take.  Returns (dq, dk, dv) in the inputs'
    dtype."""
    _check_bwd(q, k, v, o, do, lse)
    r = BWD_ROUTES[q.dtype]
    _check_cuda(q)
    B, S, H, hd = q.shape
    delta = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    args = [ptr(t) for t in (q, k, v, o, do, lse, delta, dq, dk, dv)]
    if r == "tf32x3":
        args += [ptr(t) for t in _scratch(q, k, backward=True)]
    BWD_KERNELS[r].launch(*args, B, S, H, k.shape[2], hd, int(bool(causal)),
                          stream_ptr(q.device))
    return dq, dk, dv


def _forward(q, k, v, causal, return_lse=False):
    if q.device.type == "cuda":
        return attention_cuda(q, k, v, causal, return_lse)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal, return_lse)
    if q.device.type == "meta":
        return attention_meta(q, k, v, causal, return_lse)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


class FlashAttention(torch.autograd.Function):
    """The forward kernel with lse, and the backward kernel (plain versions
    for CPU tensors, meta routes for meta ones).  Saves q, k, v, o and
    lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = _forward(q, k, v, causal, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cuda":
            bwd = attention_bwd_cuda
        elif q.device.type == "meta":
            bwd = attention_bwd_meta
        else:
            bwd = attention_bwd_ref
        dq, dk, dv = bwd(q, k, v, o, do.contiguous(), lse, ctx.causal)
        return dq, dk, dv, None


@traced_op("flash_attention", "compute", _meta)
def flash_attention(q, k, v, causal=True):
    """q [B,S,H,hd]; k/v [B,S,KV,hd] -> [B,S,H,hd].

    CUDA tensors go to the kernels; CPU tensors to the plain versions;
    meta tensors to the meta routes.  When a gradient is wanted the call
    goes through ``FlashAttention``."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal)
