"""Mamba2 chunked SSD scan: CUDA kernel wrappers, plain version, tracing.

Replaces the TPU kernel ``src/repro/kernels/ssd_scan/kernel.py``
(``ssd_scan_fwd``) and, on the prefill path, the model's ``ssd_chunked``:
unlike the TPU kernel it takes an initial state and returns the final
state (``[B,H,P,N]`` fp32, the model's layout), which prefill hands to
decode.  With ``initial_state=None`` its ``y`` is what ``ssd_scan_fwd``
computes.  Bound on an H100: bytes at the serving shape (the work it
needs is less than the JAX ``_meta`` flops, which count C·Bᵀ per head and
whole).  Two hand-written kernels, one route per dtype (``route``), each a
block per (batch, head) that walks the chunks in order and masks the
ragged last chunk, so any L is taken; both run all four products on the
tensor cores by wgmma with fp32 accumulators, tiles by TMA, the ``[P,N]``
fp32 state in the accumulator registers:
  * bf16 -> ``"wgmma"``, ``csrc/ssd_scan_wgmma.cu``: bf16 operands; the
    scores, the scaled ``w∘x`` and the chunk-start state are rounded to
    bf16 as operands;
  * fp32 -> ``"tf32x3"``, ``csrc/ssd_scan_tf32.cu``: split TF32, each
    product X·Y as X_hi·Y_hi + X_hi·Y_lo + X_lo·Y_hi of tf32 terms, so
    that the fp32 result is held to a full-fp32 reference (3e-4); a
    pre-pass splits Bm and Cm, which every head
    reads, into scratch the wrapper allocates (``tf32_scratch``), and the
    block writes x_sᵀ split, each 8 rows in the order 0,2,4,6,1,3,5,7,
    from the raw x tile that only it reads.
Both sum the cumulative decay in fp64.  Each route counts its own
launches.

Widths: every route's tiles are head_dim padded to 64 columns and the
state to 64 or 128; the true head_dim (``HEAD_DIMS``) and state
(``STATE_DIMS``) are taken at run time, the tensor maps at the true widths
so that the columns past them load as zeros, which add exact zeros to every
product; the inputs and outputs keep their true widths.  The chunk is a
blocking of the scan, not a part of the function (every chunk gives the
same y and final state up to rounding): a CUDA call runs at the chunk its
64-row tiles take (``kernel_chunk``), the trace's ``_meta`` keeps the
requested one, and the plain version runs the requested one.

The backward is port-only: the JAX package differentiates ``ssd_chunked``
(``src/repro/models/mamba2.py:22``) by XLA autodiff, so it has no Pallas
kernel and no traced-op name, and its time falls in the training step's
span.  Two hand-written kernels, one route per dtype (``BWD_ROUTES``),
each with its own launch count (``BWD_KERNELS``), both with every product
on the tensor cores by wgmma and dB and dC summed over groups of
``BWD_HEAD_GROUP`` heads in registers, then over the groups (no atomics);
they share the finish and sum kernels (``csrc/ssd_bwd_common.cuh``):
  * bf16 -> ``"wgmma"``, ``csrc/ssd_scan_bwd_wgmma.cu``: the operands that
    are fp32 results (scores, w∘x, exp(cum)∘dy, the chunk states and their
    cotangents) as bf16 hi + lo pairs;
  * fp32 -> ``"tf32x3"``, ``csrc/ssd_scan_bwd_tf32.cu``: split TF32, each
    product as X_hi·Y_hi + X_hi·Y_lo + X_lo·Y_hi of tf32 terms; a pre-pass
    splits Bm and Cm into direct pairs and dy, Bm and Cm into transposes
    (each 8 rows 0,2,4,6,1,3,5,7, so that an accumulator is the A fragment
    as it lies); the blocks split xᵀ and the direct x and dy tiles; the
    state kernel writes S_prevᵀ, dS and dSᵀ split; the blocks of a head
    group compute C·Bᵀ once for the group; scratch from the wrapper
    (``tf32_bwd_scratch``).
``ssd_bwd_ref`` is their plain version, the same chunked passes in
PyTorch.  ``ssd_scan`` is a ``torch.autograd.Function`` (``SSDScan``) when
a gradient is wanted; training starts from a zero state, so an initial
state that requires grad is refused.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import (CudaKernel, charge, ptr, stream_ptr,
                                 traced_op)

HEAD_DIMS = (8, 16, 32, 64)
STATE_DIMS = (8, 16, 32, 64, 128)
TILE = 64          # the kernels' row tile; a chunk is 1 to 4 tiles

_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_TF32_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
KERNELS = {
    "wgmma": CudaKernel("ssd_scan_wgmma.cu", "ssd_scan_wgmma_launch", _ARGS),
    "tf32x3": CudaKernel("ssd_scan_tf32.cu", "ssd_scan_tf32_launch",
                         _TF32_ARGS),
}
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}
BWD_KERNELS = {
    "wgmma": CudaKernel("ssd_scan_bwd_wgmma.cu", "ssd_scan_bwd_wgmma_launch",
                        [ctypes.c_void_p] * 23 + [ctypes.c_int] * 7
                        + [ctypes.c_void_p]),
    "tf32x3": CudaKernel("ssd_scan_bwd_tf32.cu", "ssd_scan_bwd_tf32_launch",
                         [ctypes.c_void_p] * 29 + [ctypes.c_int] * 7
                         + [ctypes.c_void_p]),
}
BWD_ROUTES = {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}
# heads whose dB and dC one block of either backward route sums in
# registers: the partials are [B, ceil(H / 8), L, N] fp32
BWD_HEAD_GROUP = 8


def kernel_takes(P: int, N: int, chunk: int) -> bool:
    """Whether the CUDA kernels take head_dim ``P``, state ``N`` and
    ``chunk`` (any chunk >= 1, run at ``kernel_chunk``); the wrapper raises
    on anything else."""
    return P in HEAD_DIMS and N in STATE_DIMS and chunk >= 1


def kernel_chunk(chunk: int) -> int:
    """The chunk a CUDA call runs for a requested ``chunk``: a whole
    number of the kernels' 64-row tiles, 1 to 4 of them (64 below 64, else
    the largest multiple of 64 not above it, at most 256)."""
    return min(4 * TILE, max(TILE, chunk // TILE * TILE))


def padded_state(N: int) -> int:
    """The kernels' state columns for state ``N``: 64 or 128."""
    return TILE if N <= TILE else 2 * TILE


def tf32_scratch(B: int, L: int, N: int) -> dict:
    """The shapes of the tf32x3 route's split scratch, by name, in the
    order its C launch function takes them: Bm's and Cm's pairs
    [2,B,L,N], the tf32 hi terms then the lo terms."""
    return {"bm_pair": (2, B, L, N), "cm_pair": (2, B, L, N)}


def tf32_scratch_bytes(B: int, L: int, N: int) -> int:
    """Bytes of ``tf32_scratch`` (fp32)."""
    return sum(4 * math.prod(s) for s in tf32_scratch(B, L, N).values())


def tf32_bwd_scratch(B: int, L: int, H: int, N: int, chunk: int,
                     P: int = 64) -> dict:
    """The shapes of the tf32x3 backward's scratch, by name, in the order
    its C launch function takes them (``cum`` float64, the rest fp32), for
    head_dim ``P``, state ``N`` and the kernel's ``chunk``: the pre-pass's
    splits at the true widths, of dy transposed [B,H,P,2·L16] (L16 = L
    rounded up to 16), and of Bm and Cm, direct pairs [2,B,L,N] and
    transposed [B,N,2·L16]; at the padded state NP (``padded_state``) the
    state kernel's cum, its S_prevᵀ, dS and dSᵀ as split 64 x 64 items
    [B,H,nc,NP/64,2,64,64] and ⟨dS, S_prev⟩; ddt's row terms; the head
    groups' dB and dC partials [B,ng,L,NP]; the (b, h) shares of dA."""
    NP = padded_state(N)
    nc = -(-L // chunk)
    Lp, L16 = nc * chunk, -(-L // 16) * 16
    ng = -(-H // BWD_HEAD_GROUP)
    items = (B, H, nc, NP // TILE, 2, TILE, TILE)
    return {"dyt": (B, H, P, 2 * L16),
            "bm_pair": (2, B, L, N), "cm_pair": (2, B, L, N),
            "bmt": (B, N, 2 * L16), "cmt": (B, N, 2 * L16),
            "cum": (B, H, Lp), "spt": items, "ds": items, "dst": items,
            "dss": (B, H, nc), "rowe": (B, H, Lp), "ddi": (B, H, Lp),
            "dds": (B, H, Lp), "db_part": (B, ng, L, NP),
            "dc_part": (B, ng, L, NP), "da_part": (B, H)}


def tf32_bwd_scratch_bytes(B: int, L: int, H: int, N: int, chunk: int,
                           P: int = 64) -> int:
    """Bytes of ``tf32_bwd_scratch`` (``cum`` 8 a value, the rest 4)."""
    return sum((8 if name == "cum" else 4) * math.prod(s) for name, s in
               tf32_bwd_scratch(B, L, H, N, chunk, P).items())


def work(B: int, L: int, H: int, P: int, N: int, chunk: int = 256,
         itemsize: int = 2, backward: bool = False,
         initial_state: bool = False, d_final_state: bool = False) -> dict:
    """The function's work, the bounds' formula, chunk by chunk as the
    data runs (the ragged last chunk at its length); ``flops`` of its
    products (2 per multiply-add), ``ops`` off the tensor cores (none
    counted), ``bytes`` each input read and each output written once.

    Forward: C·Bᵀ over the causal (t, s) pairs once per (b, chunk), since
    Bm and Cm are shared by the heads; per head the causal scores times
    x, the inter-chunk C·S and the state update Bᵀ(w∘x).  Bytes: x, Bm,
    Cm read, y written (``itemsize``); dt, A read and the final state
    written (fp32), the initial state read if given.  (The trace's
    ``_meta`` keeps the JAX formula, which counts C·Bᵀ per head and
    whole.)

    Backward: C·Bᵀ once per (b, chunk); per head over the causal pairs
    dy·xᵀ, dx, dB and dC (four products), and per row the chunk-start
    state (the forward's recurrence, which the backward recomputes),
    S_prevᵀ·dy, dS·B, dSᵀ·x and the state cotangent's dy·Cᵀ (five
    products of P·N).  Bytes: x, dy, Bm, Cm, dt and A read, dx, dBm, dCm,
    ddt and dA written (the initial state and the final state's
    cotangent read if given)."""
    flops = 0.0
    for c0 in range(0, L, chunk):
        q = min(chunk, L - c0)
        pairs = q * (q + 1) / 2
        if backward:
            flops += 2 * pairs * N + H * (4 * pairs * (P + N)
                                          + 10 * q * P * N)
        else:
            flops += 2 * pairs * N + H * (2 * pairs * P + 4 * q * N * P)
    state = 4 * B * H * P * N
    if backward:
        nbytes = ((3 * B * L * H * P + 4 * B * L * N) * itemsize
                  + 4 * (2 * B * L * H + 2 * H)
                  + state * (initial_state + d_final_state))
    else:
        nbytes = ((2 * B * L * H * P + 2 * B * L * N) * itemsize
                  + 4 * (B * L * H + H) + state * (1 + initial_state))
    return {"flops": B * flops, "ops": 0.0, "bytes": nbytes}


def _meta(x, dt, A, Bm, Cm, chunk=256, initial_state=None):
    """The JAX ``ssd_scan/ops.py::_meta`` keys and formula."""
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    flops = 2.0 * B * L * H * (chunk * (N + P) + N * P * 2)
    return {"flops": flops, "shape": list(x.shape)}


def _pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 copy of ``t`` with ``n`` zero rows appended on axis 1."""
    t = t.float()
    if n == 0:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], n, *t.shape[2:]))], dim=1)


def ssd_ref(x, dt, A, Bm, Cm, chunk=256, initial_state=None):
    """Plain PyTorch version: the chunked math of the JAX ``ssd_chunked``,
    in fp32 but for the cumulative decay (fp64).  x [B,L,H,P], dt [B,L,H],
    A [H], Bm/Cm [B,L,N] ->
    (y [B,L,H,P] in x's dtype, final_state [B,H,P,N] fp32).

    A ragged last chunk is padded with rows of ``dt = 0, x = 0``, which add
    nothing to y or to the state and leave the chunk's last cumulative
    decay at the last real row's, as the kernel does.  (``ssd_chunked``
    takes one chunk of length L instead: the same sums, grouped
    otherwise.)"""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    nc = -(-L // Q)
    pad = nc * Q - L
    xc = _pad_rows(x, pad).view(Bsz, nc, Q, H, P)
    dtc = _pad_rows(dt, pad).view(Bsz, nc, Q, H)
    Bc = _pad_rows(Bm, pad).view(Bsz, nc, Q, N)
    Cc = _pad_rows(Cm, pad).view(Bsz, nc, Q, N)

    # cumulative decay [B,nc,Q,H] (<= 0), summed in fp64 as the kernel
    # does: it reaches ~-700 within a chunk at the model's dt, where an
    # fp32 prefix sum puts ~1e-4 of relative error on exp(cum_t - cum_s)
    cum = torch.cumsum((dtc * A.float()).double(), dim=2)
    # intra-chunk: (C_t . B_s) exp(cum_t - cum_s) dt_s x_s for s <= t
    cb = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    decay = torch.exp((cum[:, :, :, None, :] - cum[:, :, None, :, :]).float())
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    decay = torch.where(tri[None, None, :, :, None], decay,
                        torch.zeros((), device=x.device))
    scores = cb[..., None] * decay * dtc[:, :, None, :, :]
    y = torch.einsum("bctsh,bcshp->bcthp", scores, xc)
    # chunk states and the inter-chunk recurrence
    last = cum[:, :, -1:, :]
    w = torch.exp((last - cum).float()) * dtc
    S_c = torch.einsum("bcsh,bcsn,bcshp->bchpn", w, Bc, xc)
    chunk_decay = torch.exp(last[:, :, 0, :].float())    # [B,nc,H]
    S = (x.new_zeros((Bsz, H, P, N), dtype=torch.float32)
         if initial_state is None else initial_state.float())
    starts = []
    for c in range(nc):
        starts.append(S)
        S = S * chunk_decay[:, c, :, None, None] + S_c[:, c]
    S_prev = torch.stack(starts, dim=1)                  # [B,nc,H,P,N]
    y = y + torch.einsum("bcth,bctn,bchpn->bcthp", torch.exp(cum.float()), Cc,
                         S_prev)
    y = y.reshape(Bsz, nc * Q, H, P)[:, :L]
    return y.to(x.dtype), S


def ssd_bwd_ref(x, dt, A, Bm, Cm, dy, d_final_state=None, chunk=256,
                initial_state=None):
    """Plain PyTorch version of the backward kernel: the gradients of
    ``ssd_ref``'s (y, final_state) for the cotangents dy [B,L,H,P] and
    ``d_final_state`` [B,H,P,N] (None: zero), step by step in fp32 with
    the cumulative decays in fp64, in the kernel's chunked passes.  Per
    (b, h) and chunk, with a_t = dt_t·A, cum_t its inclusive prefix sum,
    L_ts = exp(cum_t − cum_s) for s ≤ t, G_ts = C_t·B_s, M_ts = dy_t·x_s,
    w_s = exp(cum_last − cum_s)·dt_s, S_prev the chunk-start state and dS
    the cotangent of the chunk-end state:
      pass 1, chunks in order: S_prev (the forward's recurrence);
      pass 2, chunks in reverse, carrying dS from ``d_final_state``:
        dx_s  = Σ_{t≥s} G_ts L_ts dt_s dy_t + w_s·(dS B_s)
        dC_t  = Σ_{s≤t} M_ts L_ts dt_s B_s + exp(cum_t)·S_prevᵀ dy_t
        dB_s  = Σ_{t≥s} M_ts L_ts dt_s C_t + w_s·dSᵀ x_s
        ddt_s = Σ_{t≥s} G_ts L_ts M_ts + exp(cum_last − cum_s)·x_s·(dS B_s)
                + A·da_s, with da the reverse cumsum (fp64) of dcum, the
                cotangent of cum from every exp term
                (exp(cum_last)·⟨dS, S_prev⟩ at the chunk's last row);
        dA   += Σ_s dt_s·da_s;
        dS   <- exp(cum_last)·dS + Σ_t exp(cum_t)·dy_t C_tᵀ.
    dBm and dCm sum over the heads, dA over the batch.  Returns (dx, ddt,
    dA, dBm, dCm) in the dtypes of (x, dt, A, Bm, Cm)."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    nc = -(-L // Q)
    pad = nc * Q - L
    xc = _pad_rows(x, pad).view(Bsz, nc, Q, H, P)
    dyc = _pad_rows(dy, pad).view(Bsz, nc, Q, H, P)
    dtc = _pad_rows(dt, pad).view(Bsz, nc, Q, H)
    Bc = _pad_rows(Bm, pad).view(Bsz, nc, Q, N)
    Cc = _pad_rows(Cm, pad).view(Bsz, nc, Q, N)
    Af = A.float()

    cum = torch.cumsum((dtc * Af).double(), dim=2)        # [B,nc,Q,H]
    last = cum[:, :, -1:, :]
    w = torch.exp((last - cum).float()) * dtc              # [B,nc,Q,H]
    ecum = torch.exp(cum.float())
    decay = torch.exp(last[:, :, 0, :].float())            # [B,nc,H]

    # pass 1: the chunk-start states
    S_c = torch.einsum("bcsh,bcsn,bcshp->bchpn", w, Bc, xc)
    S = (x.new_zeros((Bsz, H, P, N), dtype=torch.float32)
         if initial_state is None else initial_state.float())
    starts = []
    for c in range(nc):
        starts.append(S)
        S = S * decay[:, c, :, None, None] + S_c[:, c]
    S_prev = torch.stack(starts, dim=1)                   # [B,nc,H,P,N]

    # pass 2: the chunk-end state cotangents, in reverse
    U = torch.einsum("bcth,bcthp,bctn->bchpn", ecum, dyc, Cc)
    dS = (x.new_zeros((Bsz, H, P, N), dtype=torch.float32)
          if d_final_state is None else d_final_state.float())
    ends = [None] * nc
    for c in reversed(range(nc)):
        ends[c] = dS
        dS = dS * decay[:, c, :, None, None] + U[:, c]
    dS_end = torch.stack(ends, dim=1)                     # [B,nc,H,P,N]

    # intra-chunk terms over the causal (t, s) pairs
    G = torch.einsum("bctn,bcsn->bcts", Cc, Bc)[..., None]
    M = torch.einsum("bcthp,bcshp->bctsh", dyc, xc)
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    Lm = torch.where(tri[None, None, :, :, None],
                     torch.exp((cum[:, :, :, None, :]
                                - cum[:, :, None, :, :]).float()),
                     torch.zeros((), device=x.device))
    GL, ML = G * Lm, M * Lm                               # [B,nc,t,s,H]
    dts = dtc[:, :, None, :, :]                           # dt_s
    # state terms: V_s = dS B_s
    V = torch.einsum("bchpn,bcsn->bcshp", dS_end, Bc)
    dx = (torch.einsum("bctsh,bcthp->bcshp", GL * dts, dyc)
          + w[..., None] * V)
    dB = (torch.einsum("bctsh,bctn->bcsn", ML * dts, Cc)
          + torch.einsum("bcsh,bchpn,bcshp->bcsn", w, dS_end, xc))
    dC = (torch.einsum("bctsh,bcsn->bctn", ML * dts, Bc)
          + torch.einsum("bcth,bchpn,bcthp->bctn", ecum, S_prev, dyc))

    # the cotangent of cum, then of a = dt·A by a reverse cumsum
    D = GL * M                                            # G L M [t,s]
    ddt_intra = D.sum(dim=2)                              # Σ_t, at s
    ddt_state = (torch.exp((last - cum).float())
                 * torch.einsum("bcshp,bcshp->bcsh", xc, V))
    row = (D * dts).sum(dim=3)                            # Σ_s, at t
    E = ecum * torch.einsum("bcthp,bchpn,bctn->bcth", dyc, S_prev, Cc)
    dcum = row - dtc * ddt_intra + E - dtc * ddt_state
    dcum[:, :, -1] += (decay * (dS_end * S_prev).sum(dim=(-2, -1))
                       + (dtc * ddt_state).sum(dim=2))
    da = torch.flip(torch.cumsum(torch.flip(dcum.double(), [2]), dim=2), [2])
    ddt = ddt_intra + ddt_state + (Af.double() * da).float()
    dA = (dtc.double() * da).sum(dim=(0, 1, 2))

    def rows(t):
        return t.reshape(Bsz, nc * Q, *t.shape[3:])[:, :L]
    return (rows(dx).to(x.dtype), rows(ddt).to(dt.dtype), dA.to(A.dtype),
            rows(dB).to(Bm.dtype), rows(dC).to(Cm.dtype))


def route(dtype) -> str:
    """The kernel that a CUDA call with x in ``dtype`` launches, by dtype
    alone: bf16 -> "wgmma", fp32 -> "tf32x3" (split TF32), both on the
    tensor cores."""
    if dtype not in ROUTES:
        raise TypeError(f"ssd_scan kernels take float32 or bfloat16 x/Bm/Cm, "
                        f"not {dtype}")
    return ROUTES[dtype]


def check_operands(x, dt, A, Bm, Cm, chunk=256, initial_state=None) -> str:
    """Everything the kernels need of their operands but the device:
    shapes, instances, dtypes, contiguity, alignment.  Returns the
    route."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 3:
        raise ValueError(f"ssd_scan wants x [B,L,H,P], dt [B,L,H], A [H], "
                         f"Bm/Cm [B,L,N]; got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}")
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    if (dt.shape != (B, L, H) or A.shape != (H,) or Bm.shape != (B, L, N)
            or Cm.shape != Bm.shape):
        raise ValueError(f"ssd_scan: shapes disagree: x {tuple(x.shape)}, "
                         f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
                         f"Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    if not kernel_takes(P, N, chunk):
        raise ValueError(f"ssd_scan kernels take head_dim {HEAD_DIMS}, state "
                         f"{STATE_DIMS} and a chunk >= 1, not P {P}, N {N}, "
                         f"chunk {chunk}")
    r = route(x.dtype)
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_scan kernels take x/Bm/Cm of one dtype; got "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan kernels take float32 dt and A; got "
                        f"{dt.dtype}, {A.dtype}")
    tensors = [x, dt, A, Bm, Cm]
    if initial_state is not None:
        if (initial_state.shape != (B, H, P, N)
                or initial_state.dtype != torch.float32):
            raise ValueError(f"ssd_scan: initial_state must be float32 "
                             f"[B,H,P,N] = {(B, H, P, N)}; got "
                             f"{initial_state.dtype} "
                             f"{tuple(initial_state.shape)}")
        tensors.append(initial_state)
    if any(t.device != x.device for t in tensors):
        raise ValueError("ssd_scan: tensors on different devices")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("ssd_scan kernels take contiguous, "
                             "16-byte-aligned tensors")
    return r


def ssd_cuda(x, dt, A, Bm, Cm, chunk=256, initial_state=None):
    """Launch the kernel of x's dtype; raises on anything it does not
    take."""
    r = check_operands(x, dt, A, Bm, Cm, chunk, initial_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan kernels take CUDA tensors, not "
                         f"{x.device}")
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    chunk = kernel_chunk(chunk)
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    init = None if initial_state is None else ptr(initial_state)
    # the scratch stays referenced until the launch is queued
    scratch = ([torch.empty(shape, dtype=torch.float32, device=x.device)
                for shape in tf32_scratch(B, L, N).values()]
               if r == "tf32x3" else [])
    KERNELS[r].launch(ptr(x), ptr(dt), ptr(A), ptr(Bm), ptr(Cm), init,
                      ptr(y), ptr(state), *(ptr(t) for t in scratch), B, L,
                      H, P, N, chunk, stream_ptr(x.device))
    return y, state


def _work_of(x, Bm, chunk, initial_state, **kw) -> dict:
    """The work of a call at the chunk the kernels run."""
    B, L, H, P = x.shape
    return work(B, L, H, P, Bm.shape[-1], kernel_chunk(chunk),
                x.element_size(), initial_state=initial_state is not None,
                **kw)


def ssd_meta(x, dt, A, Bm, Cm, chunk=256, initial_state=None):
    """The meta route: the kernel's checks, empty meta outputs, the work
    charged to the op analysis in progress; launches nothing."""
    check_operands(x, dt, A, Bm, Cm, chunk, initial_state)
    B, L, H, P = x.shape
    charge("ssd_scan", _work_of(x, Bm, chunk, initial_state))
    return torch.empty_like(x), torch.empty(
        (B, H, P, Bm.shape[-1]), dtype=torch.float32, device=x.device)


def _check_bwd(x, dt, A, Bm, Cm, dy, d_final_state, chunk, initial_state):
    check_operands(x, dt, A, Bm, Cm, chunk, initial_state)
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"ssd_scan backward: dy must match x "
                         f"{tuple(x.shape)} {x.dtype}; got "
                         f"{tuple(dy.shape)} {dy.dtype} on {dy.device}")
    tensors = [dy]
    if d_final_state is not None:
        if (d_final_state.shape != (B, H, P, N)
                or d_final_state.dtype != torch.float32
                or d_final_state.device != x.device):
            raise ValueError(f"ssd_scan backward: d_final_state must be "
                             f"float32 [B,H,P,N] = {(B, H, P, N)} on "
                             f"{x.device}; got {d_final_state.dtype} "
                             f"{tuple(d_final_state.shape)} on "
                             f"{d_final_state.device}")
        tensors.append(d_final_state)
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("ssd_scan backward takes a contiguous, "
                             "16-byte-aligned dy and d_final_state")


def ssd_bwd_meta(x, dt, A, Bm, Cm, dy, d_final_state=None, chunk=256,
                 initial_state=None):
    """The backward's meta route (see ``ssd_meta``)."""
    _check_bwd(x, dt, A, Bm, Cm, dy, d_final_state, chunk, initial_state)
    charge("ssd_scan_bwd", _work_of(x, Bm, chunk, initial_state,
                                    backward=True,
                                    d_final_state=d_final_state is not None))
    return tuple(torch.empty_like(t) for t in (x, dt, A, Bm, Cm))


def ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, d_final_state=None, chunk=256,
                 initial_state=None):
    """Launch the backward kernels of x's dtype (``BWD_ROUTES``); raises on
    anything they do not take.  Returns (dx, ddt, dA, dBm, dCm) as
    ``ssd_bwd_ref``."""
    _check_bwd(x, dt, A, Bm, Cm, dy, d_final_state, chunk, initial_state)
    r = BWD_ROUTES[x.dtype]
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan kernels take CUDA tensors, not "
                         f"{x.device}")
    chunk = kernel_chunk(chunk)
    NP = padded_state(N)
    nc = -(-L // chunk) if L else 0
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dA, dBm, dCm = torch.empty_like(A), torch.empty_like(Bm), \
        torch.empty_like(Cm)
    init = None if initial_state is None else ptr(initial_state)
    dfinal = None if d_final_state is None else ptr(d_final_state)
    args = (ptr(x), ptr(dt), ptr(A), ptr(Bm), ptr(Cm), init, ptr(dy), dfinal,
            ptr(dx), ptr(ddt), ptr(dA), ptr(dBm), ptr(dCm))
    if r == "tf32x3":
        # the scratch stays referenced until the launch is queued
        scratch = [torch.empty(shape, dtype=torch.float64 if name == "cum"
                               else torch.float32, device=x.device)
                   for name, shape in tf32_bwd_scratch(B, L, H, N, chunk,
                                                       P).items()]
        BWD_KERNELS[r].launch(*args, *(ptr(t) for t in scratch), B, L, H, P,
                              N, chunk, BWD_HEAD_GROUP, stream_ptr(x.device))
        return dx, ddt, dA, dBm, dCm
    Lp = nc * chunk
    ng = -(-H // BWD_HEAD_GROUP)
    cum = torch.empty((B, H, Lp), dtype=torch.float64, device=x.device)
    # the chunk-start states and the chunk-end cotangents as bf16 hi and lo
    # tiles in the kernels' swizzled layout, at the padded widths
    sp16 = torch.empty((B, H, nc, 2, TILE, NP), dtype=torch.bfloat16,
                       device=x.device)
    ds16 = torch.empty_like(sp16)
    dss = torch.empty((B, H, nc), **f32)              # <dS, S_prev>
    rowe, ddi, dds = torch.empty((3, B, H, Lp), **f32)  # ddt's row terms
    dB_part = torch.empty((B, ng, L, NP), **f32)      # per-group partials
    dC_part = torch.empty((B, ng, L, NP), **f32)
    dA_part = torch.empty((B, H), **f32)              # per-(b, h) partials
    BWD_KERNELS[r].launch(*args, ptr(cum), ptr(sp16), ptr(ds16), ptr(dss),
                          ptr(rowe), ptr(ddi), ptr(dds), ptr(dB_part),
                          ptr(dC_part), ptr(dA_part), B, L, H, P, N, chunk,
                          BWD_HEAD_GROUP, stream_ptr(x.device))
    return dx, ddt, dA, dBm, dCm


def _forward(x, dt, A, Bm, Cm, chunk, initial_state):
    if x.device.type == "cuda":
        return ssd_cuda(x, dt, A, Bm, Cm, chunk, initial_state)
    if x.device.type == "cpu":
        return ssd_ref(x, dt, A, Bm, Cm, chunk, initial_state)
    if x.device.type == "meta":
        return ssd_meta(x, dt, A, Bm, Cm, chunk, initial_state)
    raise ValueError(f"ssd_scan: unsupported device {x.device}")


class SSDScan(torch.autograd.Function):
    """The forward kernel, and the backward kernel on the cotangents of y
    and of the final state (None counts as zero; a given one seeds the
    reverse state recurrence); plain versions for CPU tensors.  Saves the
    inputs: the backward recomputes the chunk-start states."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk, initial_state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm, initial_state)
        ctx.chunk = chunk
        return _forward(x, dt, A, Bm, Cm, chunk, initial_state)

    @staticmethod
    def backward(ctx, dy, d_final_state):
        x, dt, A, Bm, Cm, initial_state = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if d_final_state is not None:
            d_final_state = d_final_state.contiguous()
        if x.device.type == "cuda":
            bwd = ssd_bwd_cuda
        elif x.device.type == "meta":
            bwd = ssd_bwd_meta
        else:
            bwd = ssd_bwd_ref
        return (*bwd(x, dt, A, Bm, Cm, dy, d_final_state, ctx.chunk,
                     initial_state), None, None)


@traced_op("ssd_scan", "compute", _meta)
def ssd_scan(x, dt, A, Bm, Cm, chunk=256, initial_state=None):
    """x [B,L,H,P]; dt [B,L,H] fp32 (> 0); A [H] fp32 (< 0); Bm/Cm [B,L,N]
    -> (y [B,L,H,P] in x's dtype, final_state [B,H,P,N] fp32).  Pass
    ``chunk`` as a keyword: the trace's flops are computed from it.

    CUDA tensors go to the kernels; CPU tensors to the plain versions;
    meta tensors to the meta routes.  When a gradient is wanted the call
    goes through ``SSDScan``; an
    ``initial_state`` that requires grad is refused."""
    if torch.is_grad_enabled():
        if initial_state is not None and initial_state.requires_grad:
            raise ValueError("ssd_scan has no gradient for initial_state: "
                             "training starts from a zero state")
        if any(t.requires_grad for t in (x, dt, A, Bm, Cm)):
            return SSDScan.apply(x, dt, A, Bm, Cm, chunk, initial_state)
    return _forward(x, dt, A, Bm, Cm, chunk, initial_state)
