"""Progress-instrumented ring collectives over ``torch.distributed``.

FLARE's intra-kernel inspecting (paper §5.1, Fig 6) reads per-ring-step
progress counters out of a hung collective to localise the faulty link in
O(1).  As in the JAX package (``parallel/collectives.py``), progress export
is an output of the collective itself: the ring reduce-scatter and
all-gather return, beside their result, an int32 vector with a 1 for each
ring step this rank has completed.  A caller that passes its own
``progress`` tensor can read it while the collective runs, so that under a
hang the frozen counts are the state ``core/inspecting.diagnose_ring``
needs (the daemon's ``on_hang`` callback is the place to read them).
Beside it, each reduce-scatter combine leaves the ring-combine kernel's
per-block counters in a row of ``counters`` (:func:`combine_counters`,
pinned host memory on the card): a caller that passes its own reads them
frozen under a hang, and a row is complete once that step's combine has
run on the device.

The schedule is the JAX package's, rank for rank and step for step, so the
results are equal: at ring step s rank r sends its chunk (r - s) mod n to
rank r + 1 and adds the chunk it receives from rank r - 1 into its chunk
(r - s - 1) mod n, through the ring-combine kernel
(``kernels/ring_reduce``).  Each per-rank body takes a ``torch.distributed``
group where the JAX body took ``axis_name, axis_size``.

Every message goes through :func:`exchange`, one function, so a test can
replace it in a rank process to break a link.  The transport is
``dist.batch_isend_irecv`` on the group: under NCCL device tensors go as
they are; gloo moves host memory, so a CUDA tensor is staged through
pinned host buffers.  The combine always runs on the tensor's device.

On a meta tensor a collective moves nothing: it returns an empty result
of its shape and zero progress, and records its kind, result bytes and
group size into the op analysis in progress (``launch/op_analysis.py``),
if there is one.

Gradients.  Each collective is a ``torch.autograd.Function`` whose
backward is the transposed collective on the same ring, through the same
:func:`exchange` and, for a reduce-scatter, the same combine kernel: an
all-reduce's backward is an all-reduce, an all-gather's a reduce-scatter
(rank r gets the chunk its own input filled), a reduce-scatter's an
all-gather, a permute's the reverse permute.  A backward has a progress
vector and combine counters of its own: a caller that passes
``grad_progress`` (and ``grad_counters``) reads them while the backward
runs, as it reads the forward's, so the hang inspector sees a backward
stall too.  On meta tensors a backward records its collective into the op
analysis as a forward does.

The convention every caller keeps (the transpose of the reference's
``shard_map``): each rank seeds ``backward`` of its loss with 1 / (the
number of ranks that hold that same loss), and the gradient of a tensor
held whole on several ranks is summed over the mesh axes it is replicated
on (``sharding.sum_replicated``).  Each rank's gradients are then its
share of the one global loss's, and the sums are that loss's gradient.
A collective's backward must run on every rank of its group once it runs
on one, so its output must reach the loss on every rank; a missing output
gradient counts as zeros.  On a CUDA tensor autograd runs a backward on
its device thread, with the forward's stream current: the staging copies
and the combine kernel queue on that stream, as in the forward.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels import ANALYSES
from repro_torch.kernels.ring_reduce.ops import ring_combine

COMBINE_BLOCK = 1024   # the TPU kernel's block


def _pinned_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` crosses the group's transport through host memory."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _transfer(send: Optional[torch.Tensor], recv: torch.Tensor, dst: int,
              src: int, group) -> torch.Tensor:
    """The messages of one ring step (see :func:`exchange`)."""
    group = dist.group.WORLD if group is None else group
    staged = _staged(recv, group)
    hrecv = _pinned_like(recv) if staged else recv
    ops = [dist.P2POp(dist.irecv, hrecv, group=group, group_peer=src)]
    if send is not None:
        hsend = _pinned_like(send).copy_(send) if staged else send
        ops.append(dist.P2POp(dist.isend, hsend, group=group, group_peer=dst))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        recv.copy_(hrecv, non_blocking=True)
    return recv


class _Permute(torch.autograd.Function):
    """``exchange`` of a tensor that needs a gradient: the gradient of what
    this rank received goes back to ``src``, and the gradient of what it
    sent comes from ``dst``."""

    @staticmethod
    def forward(ctx, send, recv, dst, src, group):
        ctx.peers, ctx.group = (dst, src), group
        ctx.sent = dict(size=send.shape, dtype=send.dtype, device=send.device)
        ctx.mark_dirty(recv)
        return _transfer(send, recv, dst, src, group)

    @staticmethod
    def backward(ctx, grad):
        dst, src = ctx.peers
        back = exchange(grad.contiguous(), torch.empty(**ctx.sent), src, dst,
                        ctx.group)
        return back, None, None, None, None


def exchange(send: Optional[torch.Tensor], recv: torch.Tensor, dst: int,
             src: int, group=None) -> torch.Tensor:
    """One ring step's messages: send ``send`` to group rank ``dst`` (no
    send if None) and receive from group rank ``src`` into ``recv``;
    returns ``recv`` once the messages are done.  Where ``send`` needs a
    gradient, the result carries one: its backward is the reverse permute
    (every rank of the ring must run it)."""
    if send is not None and send.requires_grad and torch.is_grad_enabled():
        return _Permute.apply(send, recv, dst, src, group)
    return _transfer(send, recv, dst, src, group)


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """In-place ``dist.all_reduce``, staged through host memory as
    :func:`exchange` is."""
    group = dist.group.WORLD if group is None else group
    if _staged(t, group):
        h = _pinned_like(t).copy_(t)
        dist.all_reduce(h, op=op, group=group)
        return t.copy_(h, non_blocking=True)
    dist.all_reduce(t, op=op, group=group)
    return t


def _ring(group) -> tuple[int, int]:
    return dist.get_rank(group), dist.get_world_size(group)


def _meta(kind: str, result: torch.Tensor, n: int):
    """A collective on meta tensors, with this (empty) result on ``n``
    ranks: recorded into the op analysis in progress, if any."""
    if ANALYSES:
        ANALYSES[-1].collective(kind, result.numel() * result.element_size(),
                                n)
    return result


def _progress(n: int, progress: Optional[torch.Tensor],
              phases: int = 1) -> torch.Tensor:
    """The progress vector of ``phases`` ring phases: ``max(n - 1, 1)``
    int32 counters each, the caller's tensor if given (written in place)."""
    steps = phases * max(n - 1, 1)
    if progress is None:
        return torch.zeros(steps, dtype=torch.int32)
    if progress.shape != (steps,) or progress.dtype != torch.int32:
        raise ValueError(f"progress must be int32 of shape ({steps},); got "
                         f"{progress.dtype} {tuple(progress.shape)}")
    return progress


def _chunk_pad(chunk: int) -> int:
    """Zeros that bring a chunk longer than one combine block to a multiple
    of it, so the ring-combine kernel always runs whole blocks."""
    return (-chunk) % COMBINE_BLOCK if chunk > COMBINE_BLOCK else 0


def combine_counters(x: torch.Tensor, n: int) -> torch.Tensor:
    """The ring-combine kernel's counters for one reduce-scatter of ``x``
    over ``n`` ranks: int32 [max(n - 1, 1), blocks per chunk], zeros, in
    pinned host memory for a CUDA ``x``.  Row s is step s's combine; a host
    thread reads it while the collective runs (see ``kernels/ring_reduce``)."""
    chunk = x.numel() // n
    chunk += _chunk_pad(chunk)
    blocks = chunk // min(COMBINE_BLOCK, chunk) if chunk else 0
    return torch.zeros((max(n - 1, 1), blocks), dtype=torch.int32,
                       pin_memory=x.is_cuda)


def _reduce_scatter(x: torch.Tensor, group, progress: torch.Tensor,
                    counters: Optional[torch.Tensor],
                    slot_offset: int = 1) -> torch.Tensor:
    """The reduce-scatter's ring (see :func:`ring_reduce_scatter_local`)."""
    rank, n = _ring(group)
    if x.shape[0] % n:
        raise ValueError(f"ring_reduce_scatter: leading dim {x.shape[0]} is "
                         f"not a multiple of the group size {n}")
    chunk_shape = (x.shape[0] // n,) + tuple(x.shape[1:])
    if x.is_meta:
        return _meta("reduce-scatter", x.new_empty(chunk_shape), n)
    if n == 1:
        return x.clone()
    flat = x.reshape(n, -1)
    chunk = flat.shape[1]
    pad = _chunk_pad(chunk)
    if pad:
        flat = F.pad(flat, (0, pad))
    acc = list(flat.unbind(0))    # flat chunks, views of x unless padded
    shift = (1 - slot_offset) % n
    if shift:       # the ring's chunk j is x's chunk j - shift
        acc = acc[-shift:] + acc[:-shift]
    if counters is None:
        counters = combine_counters(x, n)
    right, left = (rank + 1) % n, (rank - 1) % n
    for s in range(n - 1):
        send_idx = (rank - s) % n
        recv_idx = (rank - s - 1) % n
        sent = exchange(acc[send_idx], torch.empty_like(acc[recv_idx]),
                        right, left, group)
        acc[recv_idx], _ = ring_combine(acc[recv_idx], sent,
                                        block=COMBINE_BLOCK,
                                        progress=counters[s])
        progress[s] = 1
    return acc[(rank + 1) % n][:chunk].reshape(chunk_shape)


def _all_gather(x: torch.Tensor, group, slot_offset: int,
                progress: torch.Tensor) -> torch.Tensor:
    """The all-gather's ring (see :func:`ring_all_gather_local`)."""
    rank, n = _ring(group)
    shape = (n * x.shape[0],) + tuple(x.shape[1:])
    if x.is_meta:
        return _meta("all-gather", x.new_empty(shape), n)
    out = x.new_zeros((n,) + tuple(x.shape))
    out[(rank + slot_offset) % n] = x
    right, left = (rank + 1) % n, (rank - 1) % n
    cur = x.contiguous()
    for s in range(n - 1):
        cur = exchange(cur, torch.empty_like(cur), right, left, group)
        # the received chunk originated at rank (rank - s - 1)
        out[(rank - s - 1 + slot_offset) % n] = cur
        progress[s] = 1
    return out.reshape(shape)


def _all_reduce_ring(x: torch.Tensor, group, progress: torch.Tensor,
                     counters: Optional[torch.Tensor]) -> torch.Tensor:
    """Reduce-scatter then all-gather; ``progress`` of both phases."""
    n = dist.get_world_size(group)
    if x.is_meta:
        return _meta("all-reduce", x.new_empty(x.shape), n)
    steps = max(n - 1, 1)
    owned = _reduce_scatter(x, group, progress[:steps], counters)
    return _all_gather(owned, group, 1, progress[steps:])


class _ReduceScatter(torch.autograd.Function):
    """Backward: the all-gather that hands every rank its chunk's
    gradient back (rank r owned chunk r + slot_offset)."""

    @staticmethod
    def forward(ctx, x, group, progress, counters, grad_progress,
                slot_offset):
        ctx.group, ctx.grad_progress = group, grad_progress
        ctx.slot_offset = slot_offset
        return _reduce_scatter(x, group, progress, counters, slot_offset)

    @staticmethod
    def backward(ctx, grad):
        n = dist.get_world_size(ctx.group)
        full = _all_gather(grad.contiguous(), ctx.group, ctx.slot_offset,
                           _progress(n, ctx.grad_progress))
        return full, None, None, None, None, None


class _AllGather(torch.autograd.Function):
    """Backward: the reduce-scatter of the gathered gradient that leaves
    on rank r the slot its own chunk filled, (r + slot_offset) mod n: the
    ring's reduce-scatter owns slot r + 1, so the slots are rolled by
    1 - slot_offset first."""

    @staticmethod
    def forward(ctx, x, group, slot_offset, progress, grad_progress,
                grad_counters):
        ctx.group, ctx.slot_offset = group, slot_offset
        ctx.grad_progress, ctx.grad_counters = grad_progress, grad_counters
        return _all_gather(x, group, slot_offset, progress)

    @staticmethod
    def backward(ctx, grad):
        n = dist.get_world_size(ctx.group)
        shift = (1 - ctx.slot_offset) % n
        if shift and not grad.is_meta:
            grad = torch.roll(grad.reshape(n, -1), shift, 0).reshape(
                grad.shape)
        owned = _reduce_scatter(grad.contiguous(), ctx.group,
                                _progress(n, ctx.grad_progress),
                                ctx.grad_counters)
        return owned, None, None, None, None, None


class _AllReduce(torch.autograd.Function):
    """Backward: the all-reduce of the gradient, on the same ring."""

    @staticmethod
    def forward(ctx, x, group, progress, counters, grad_progress,
                grad_counters):
        ctx.group = group
        ctx.grad_progress, ctx.grad_counters = grad_progress, grad_counters
        return _all_reduce_ring(x, group, progress, counters)

    @staticmethod
    def backward(ctx, grad):
        n = dist.get_world_size(ctx.group)
        full = _all_reduce_ring(grad.contiguous(), ctx.group,
                                _progress(n, ctx.grad_progress, phases=2),
                                ctx.grad_counters)
        return full, None, None, None, None, None


def ring_reduce_scatter_local(x: torch.Tensor, group=None,
                              progress: Optional[torch.Tensor] = None,
                              counters: Optional[torch.Tensor] = None,
                              grad_progress: Optional[torch.Tensor] = None,
                              slot_offset: int = 1):
    """Per-rank body: x [n*chunk, ...] -> (owned chunk [chunk, ...],
    progress).

    Classic ring reduce-scatter: n - 1 steps; at step s each rank sends the
    chunk it just accumulated to its right neighbour and combines the one it
    receives; progress[s] = 1 once step s completed on this rank.  Rank r
    ends owning the fully reduced chunk (r + slot_offset) mod n (the ring's
    own r + 1 by default; 0 hands rank r chunk r, as ``sharding.shard``
    cuts: the chunks enter the ring rotated, which moves no data).  Each
    combine is the
    ring-combine kernel, whose per-block counters go to row s of
    ``counters`` (:func:`combine_counters`; allocated if not given).  A
    flattened chunk longer than one combine block travels padded with zeros
    to a multiple of it.  The backward is an all-gather (``grad_progress``
    its progress, if given).
    """
    n = dist.get_world_size(group)
    progress = _progress(n, progress)
    return _ReduceScatter.apply(x, group, progress, counters,
                                grad_progress, slot_offset), progress


def ring_all_gather_local(x: torch.Tensor, group=None, slot_offset: int = 0,
                          progress: Optional[torch.Tensor] = None,
                          grad_progress: Optional[torch.Tensor] = None,
                          grad_counters: Optional[torch.Tensor] = None):
    """Per-rank body: x [chunk, ...] -> (gathered [n*chunk, ...], progress).

    ``slot_offset``: rank r's local chunk is global chunk (r + slot_offset)
    mod n; reduce-scatter hands rank r chunk r + 1, so the composed
    all-reduce passes slot_offset=1.  The backward is a reduce-scatter
    (``grad_progress`` and ``grad_counters`` its progress and combine
    counters, if given; ``combine_counters`` of the gathered shape).
    """
    n = dist.get_world_size(group)
    progress = _progress(n, progress)
    return _AllGather.apply(x, group, slot_offset, progress, grad_progress,
                            grad_counters), progress


def ring_all_reduce_local(x: torch.Tensor, group=None,
                          progress: Optional[torch.Tensor] = None,
                          counters: Optional[torch.Tensor] = None,
                          grad_progress: Optional[torch.Tensor] = None,
                          grad_counters: Optional[torch.Tensor] = None):
    """Reduce-scatter then all-gather; 2·max(n - 1, 1) progress steps.
    ``progress``, if given, is written in place as the steps complete;
    ``counters`` are the reduce-scatter's combine counters.  The backward
    is an all-reduce (``grad_progress`` and ``grad_counters`` its own)."""
    n = dist.get_world_size(group)
    progress = _progress(n, progress, phases=2)
    return _AllReduce.apply(x, group, progress, counters, grad_progress,
                            grad_counters), progress


def ring_all_reduce(x: torch.Tensor, group=None):
    """All-reduce ``x`` of any shape over the group's ring; returns
    (result of x's shape, this rank's progress [2·max(n - 1, 1)]).  The
    flattened input is padded with zeros to a multiple of the group size,
    which changes no sum."""
    n = dist.get_world_size(group)
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = F.pad(flat, (0, pad))
    full, progress = ring_all_reduce_local(flat, group)
    return full[:x.numel()].reshape(x.shape), progress


def ring_reduce_ref(xs: list[torch.Tensor]) -> torch.Tensor:
    """Plain version of ``ring_all_reduce`` from every rank's input (any
    shape, one for all): chunk c of the flattened, zero-padded input is
    summed in the ring's order, x_{c+n-1}[c] + (... + (x_{c+1}[c] +
    x_c[c])), one rounding per add, so it equals the collective's result
    bit for bit."""
    n = len(xs)
    numel = xs[0].numel()
    pad = (-numel) % n
    chunks = [F.pad(x.reshape(-1), (0, pad)).reshape(n, -1) for x in xs]
    out = []
    for c in range(n):
        acc = chunks[c][c]
        for j in range(1, n):
            acc = chunks[(c + j) % n][c] + acc
        out.append(acc)
    return torch.cat(out)[:numel].reshape(xs[0].shape)


# --------------------------------------------------------------------------- #
# int8-compressed gradient all-reduce (distributed-optimization trick)
# --------------------------------------------------------------------------- #
def quantize_int8(x: torch.Tensor, block: int = 256,
                  rng: Optional[torch.Generator] = None):
    """Block-wise absmax int8 quantization with optional stochastic rounding
    (``rng`` draws the uniform noise)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    blocks = F.pad(flat, (0, pad)).reshape(-1, block).float()
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = blocks / scale
    if rng is not None:
        q = torch.floor(q + torch.rand(q.shape, generator=rng,
                                       device=q.device))
    else:
        q = torch.round(q)
    q = torch.clamp(q, -127, 127).to(torch.int8)
    return q, scale[:, 0], tuple(x.shape), pad


def dequantize_int8(q, scale, shape, pad):
    flat = (q.float() * scale[:, None]).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def compressed_psum_local(x: torch.Tensor, group=None,
                          error: Optional[torch.Tensor] = None,
                          block: int = 256):
    """int8 all-reduce with error feedback, per rank.

    Shares one scale per block (an all-reduce MAX of the local absmax),
    sums the int8 payload as int32 (an all-reduce SUM) and carries the
    local quantization error to the next call (error feedback keeps
    SGD/Adam convergence, Karimireddy et al. 2019).
    Returns (reduced fp32, new_error).
    """
    xf = x.float()
    if error is not None:
        xf = xf + error
    flat = xf.reshape(-1)
    pad = (-flat.numel()) % block
    blocks = F.pad(flat, (0, pad)).reshape(-1, block)
    scale = _all_reduce(blocks.abs().amax(dim=1), dist.ReduceOp.MAX,
                        group) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127)
    local_dq = (q * scale[:, None]).reshape(-1)
    local_dq = local_dq[:local_dq.numel() - pad] if pad else local_dq
    new_error = xf - local_dq.reshape(xf.shape)
    summed = _all_reduce(q.to(torch.int32), dist.ReduceOp.SUM, group)
    out = (summed.float() * scale[:, None]).reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(xf.shape), new_error
