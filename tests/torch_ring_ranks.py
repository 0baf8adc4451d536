"""Rank bodies of ``tests/test_torch_ring.py`` (a module of its own, so
that spawned ranks import it without the test file's JAX imports)."""
import numpy as np
import torch

from repro_torch.kernels.padded_matmul.ops import padded_matmul
from repro_torch.launch import mesh
from repro_torch.parallel import collectives as coll


def semantics_rank(ctx, inputs: dict, numel: int, odd_numel: int,
                   seed: int) -> dict:
    """This rank's share of ``inputs`` (numpy arrays [W, ...]) through each
    ring body and ``compressed_psum_local``; then a traced bucket
    all-reduce (step 0), the hang drill for faults 0 and 2 (steps 1, 2), a
    traced ``padded_matmul`` (step 3) and a traced all-reduce of a bucket
    whose chunk is longer than a combine block and not a multiple of it
    (step 4)."""
    r = ctx.rank

    def mine(name):
        return torch.from_numpy(np.ascontiguousarray(inputs[name][r]))

    out = {}
    owned, p = coll.ring_reduce_scatter_local(mine("rs"))
    out["reduce_scatter"], out["reduce_scatter_progress"] = owned, p
    for off in (0, 1):
        full, p = coll.ring_all_gather_local(mine("ag"), slot_offset=off)
        out[f"all_gather_{off}"], out[f"all_gather_{off}_progress"] = full, p
    full, p = coll.ring_all_reduce_local(mine("rs"))
    out["all_reduce"], out["all_reduce_progress"] = full, p
    for err in (None, "cp_err"):
        red, new_err = coll.compressed_psum_local(
            mine("cp"), error=None if err is None else mine(err))
        tag = "compressed" if err is None else "compressed_err"
        out[tag], out[f"{tag}_error"] = red, new_err
    out = {k: v.numpy() for k, v in out.items()}

    out["bucket"] = mesh.allreduce_rank(ctx, numel, seed)
    out["hang"] = mesh.hang_rank(ctx)
    ctx.daemon.step_begin(3)
    a = torch.from_numpy(inputs["mm_a"])
    b = torch.from_numpy(inputs["mm_b"])
    out["matmul"] = padded_matmul(a, b).numpy()
    ctx.daemon.step_end()
    out["odd_bucket"] = mesh.allreduce_rank(ctx, odd_numel, seed, step=4)
    return out


def failing_rank(ctx):
    if ctx.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return ctx.rank
