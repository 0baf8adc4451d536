"""Rank bodies of ``tests/test_torch_mesh_train.py`` (a module of its own,
so that spawned ranks import it without the test file's JAX imports).

Each case runs under ``_case``, which keeps a failing case's traceback as
its result, so that one case's fault fails that case's test.  Every rank
calls ``make_train_step(model, cfg, mesh=)``'s step with the same global
batch."""
import datetime
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_reduced, scale
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import moe as moe_lib
from repro_torch.models.registry import build_model, modality_inputs
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.mesh import make_mesh, make_test_mesh
from repro_torch.runtime.train import RunConfig, make_train_step

W = 4
MESH = (2, 2)                  # (data, model)
B, S, STEPS = 8, 16, 3
PEAK_LR, WARMUP = 1e-2, 1      # lr 0 at step 0, the peak at step 1
# int8 moments: the reference's RunConfig default.  Where a v code rounds
# to 0 under a nonzero m code the update is m / eps (ROADMAP §3); at 1e-2
# the reduced dbrx's loss doubles in one step, and the codes that a
# rounding boundary flips between two sums of one gradient then move the
# next step's grad_norm by 2e-3
INT8_LR = 3e-4
# int8: the parameters and moments are held after this many steps (the
# moments updated twice, the parameters once); a code flipped at a
# rounding boundary moves a parameter by ~1e-5 in step 1, enough to flip
# the reduced dbrx's routing of a token in step 2, whose gradients then
# differ by percents
SETTLED = 2
# tag -> (arch, moment dtype, microbatches, capacity factor or None): each
# reduced arch at its dry-run policy's moment dtype and at float32
CASES = {
    "llama3.2-1b": ("llama3.2-1b", "float32", 1, None),
    "mamba2-780m": ("mamba2-780m", "float32", 2, None),
    "zamba2-2.7b": ("zamba2-2.7b", "bfloat16", 2, None),
    "zamba2-2.7b-f32": ("zamba2-2.7b", "float32", 2, None),
    "llama-3.2-vision-11b": ("llama-3.2-vision-11b", "bfloat16", 2, None),
    "llama-3.2-vision-11b-f32": ("llama-3.2-vision-11b", "float32", 2, None),
    "dbrx-132b": ("dbrx-132b", "int8", 2, None),
    "dbrx-132b-f32": ("dbrx-132b", "float32", 2, None),
    "dbrx-132b-cf0.5": ("dbrx-132b", "float32", 2, 0.5),
}
LAYOUT_CASE = "dbrx-132b-cf0.5"
HANG_ARCH = "llama3.2-1b"
HANG_MESH = (W, 1)             # a 4-rank ring on the data axis
HANG_FAULTS = (0, 2)


def model_config(tag: str):
    arch, _, _, cf = CASES[tag]
    cfg = get_reduced(arch)
    return cfg if cf is None else scale(cfg, capacity_factor=cf)


def run_config(tag: str, cfg=None, microbatches=None) -> RunConfig:
    _, opt, m, _ = CASES[tag]
    return RunConfig(model=cfg or model_config(tag), global_batch=B,
                     seq_len=S, num_microbatches=microbatches or m,
                     steps=10, warmup_steps=WARMUP,
                     peak_lr=INT8_LR if opt == "int8" else PEAK_LR,
                     opt=AdamWConfig(state_dtype=opt),
                     param_dtype="float32", compute_dtype="float32",
                     device="cpu")


def batches(tag: str, seed: int = 0) -> list:
    """The global batches of the case's steps, numpy, from a seed."""
    cfg = model_config(tag)
    rng = np.random.default_rng(100 + seed)
    out = []
    for _ in range(STEPS):
        b = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)
             for k in ("tokens", "labels")}
        vis = modality_inputs(cfg, B).get("vision_embeds")
        if vis is not None:
            b["vision_embeds"] = rng.standard_normal(vis).astype(np.float32)
        out.append(b)
    return out


def rank_first(batch: dict, dp: int, microbatches: int) -> dict:
    """The global batch reordered so that the step's microbatch-first split
    hands data rank d, in microbatch i, the rows a rank-first split would:
    rank d's block of the whole batch, then its i-th chunk."""
    rows = B // (dp * microbatches)
    order = [d * (B // dp) + i * rows + j for i in range(microbatches)
             for d in range(dp) for j in range(rows)]
    return {k: v[order] for k, v in batch.items()}


def _tensors(b: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _case(out: dict, tag: str, fn):
    try:
        out[tag] = fn()
    except Exception:
        out[tag] = {"error": traceback.format_exc()}


class Drops:
    """Counts the entries ``moe.dispatch`` drops while it is entered."""

    def __enter__(self):
        self.orig, self.n = moe_lib.dispatch, 0

        def dispatch(*args, **kwargs):
            dest, keep = self.orig(*args, **kwargs)
            self.n += int((~keep).sum())
            return dest, keep
        moe_lib.dispatch = dispatch
        return self

    def __exit__(self, *exc):
        moe_lib.dispatch = self.orig


def _model(cfg, run, mesh, state: dict, coords):
    model = build_model(cfg, run.policy(), "cpu", mesh=mesh)
    if cfg.num_experts:
        state = moe_lib.shard_experts(state, mesh, coords)
    model.load_params(state)
    return model


def _tree(t):
    if isinstance(t, dict):
        return {k: _tree(v) for k, v in t.items()}
    return _np(t)


def mesh_case(ctx, mesh, tag: str, state: dict) -> dict:
    """Three steps of the case on ``mesh``: each step's metrics, the
    rank's parameters after them, the gathered moments (rank 0's), the
    resident optimizer bytes against the specs' count, and each leaf's
    specs."""
    cfg = model_config(tag)
    run = run_config(tag, cfg)
    coords = mesh.coords(ctx.rank)
    model = _model(cfg, run, mesh, state, coords)
    step = make_train_step(model, run, mesh=mesh)
    opt = step.zero.init()
    metrics = []
    for s, b in enumerate(batches(tag)):
        with Drops() as drops:
            opt, m = step(opt, _tensors(b), s)
        if s == 0:
            dropped_step0 = drops.n
        metrics.append((float(m["loss"]), float(m["grad_norm"]),
                        float(m["lr"])))
        if s == 0:
            resident = step.zero.resident_bytes(opt)
        if s == SETTLED - 1 and run.opt.state_dtype == "int8":
            settled = dict(params={n: _np(p) for n, p in
                                   model.named_parameters()},
                           state=_tree(step.zero.gather_state(opt)))
    whole = step.zero.gather_state(opt)
    out = dict(coords=coords, metrics=metrics,
               params={n: _np(p) for n, p in model.named_parameters()},
               resident=resident, resident_end=step.zero.resident_bytes(opt),
               count=int(opt["count"]),
               leaves={leaf.name: dict(spec=tuple(leaf.spec),
                                       scale=leaf.scale and tuple(leaf.scale),
                                       shape=leaf.shape, names=leaf.names)
                       for leaf in step.zero.leaves},
               state=_tree(whole) if ctx.rank == 0 else None)
    if run.opt.state_dtype == "int8":
        out["settled"] = settled
    if tag == LAYOUT_CASE:
        out["dropped"] = dropped_step0
        model = _model(cfg, run, mesh, state, coords)
        step = make_train_step(model, run, mesh=mesh)
        with Drops() as drops:
            _, m = step(step.zero.init(), _tensors(rank_first(
                batches(tag)[0], mesh.shape["data"], run.num_microbatches)),
                0)
        out["rank_first"] = (float(m["loss"]), float(m["grad_norm"]))
        out["dropped_rank_first"] = drops.n
    return out


def mesh_hang(ctx, state: dict) -> list:
    """The hang drill in the mesh step: for each rank f of
    ``HANG_FAULTS``, the reduced llama on a (data 4, model 1) mesh whose
    subgroups time out after ``HANG_GROUP_TIMEOUT``; step 0 runs whole,
    then rank f drops its sends from ring step ``HANG_FROM_STEP`` of step
    1's first gradient reduce-scatter.  The daemon's hang callback
    publishes that collective's own progress as its combine counters show
    it (the rows complete), beside the host's count; the stalled receives
    end at the subgroup's timeout."""
    daemon = ctx.daemon
    transport = coll.exchange
    timeout0 = daemon.cfg.hang_timeout
    b = _tensors(batches(HANG_ARCH)[0])
    drills = []
    for i, f in enumerate(HANG_FAULTS):
        dist.barrier()    # the subgroups connect within their timeout
        mesh = make_mesh(HANG_MESH, ("data", "model"),
                         timeout=datetime.timedelta(
                             seconds=launch_mesh.HANG_GROUP_TIMEOUT))
        cfg = get_reduced(HANG_ARCH)
        run = RunConfig(model=cfg, global_batch=B, seq_len=S, steps=10,
                        warmup_steps=WARMUP, peak_lr=PEAK_LR,
                        compute_dtype="float32", device="cpu")
        model = _model(cfg, run, mesh, state, mesh.coords(ctx.rank))
        step = make_train_step(model, run, mesh=mesh)
        opt = step.zero.init()
        base = 20 + 2 * i
        daemon.step_begin(base)
        opt, _ = step(opt, b, 0)
        daemon.step_end()
        seen: dict = {"reports": 0}

        def publish(report, zero=step.zero, seen=seen):
            if not zero.rings:
                return
            ring = zero.rings[0]
            blocks = ring["counters"].clone()
            full = torch.arange(1, blocks.shape[1] + 1, dtype=torch.int32)
            seen.update(steps=int((blocks == full).all(1).sum()),
                        host_steps=int(ring["progress"].sum()),
                        counters=blocks.tolist(), leaf=ring["leaf"],
                        axis=ring["axis"], report=report,
                        reports=seen["reports"] + 1)

        error = None
        daemon.cfg.hang_timeout = launch_mesh.HANG_TIMEOUT
        daemon.on_hang(publish)
        if ctx.rank == f:
            coll.exchange = launch_mesh.drop_sends_from(
                transport, launch_mesh.HANG_FROM_STEP)
        try:
            daemon.step_begin(base + 1)
            daemon.set_stack([f"step_{base + 1}", "train_step",
                              "zero.reduce_scatter"])
            t0 = time.perf_counter()
            try:
                step(opt, b, 1)
            except RuntimeError as e:   # a stalled receive's timeout
                error = f"{type(e).__name__}: {str(e)[:200]}"
            seconds = time.perf_counter() - t0
            daemon.step_end()
        finally:
            coll.exchange = transport
            daemon.on_hang(None)
            daemon.cfg.hang_timeout = timeout0
        first = step.zero.rings[0] if step.zero.rings else None
        drills.append(dict(
            fault=f, steps=seen.get("steps"),
            host_steps=seen.get("host_steps"),
            counters=seen.get("counters"), leaf=seen.get("leaf"),
            axis=seen.get("axis"), report=seen.get("report"),
            reports=seen["reports"], error=error, seconds=seconds,
            first_leaf=first and first["leaf"],
            steps_at_end=first and int(first["progress"].sum())))
        dist.barrier()    # every rank is out of this drill
    return drills


def mesh_train_rank(ctx, states: dict) -> dict:
    """Every case on the (2, 2) mesh, then the hang drill; each rank
    connects its meshes in one order.  ``states`` maps an arch to its
    port state (numpy)."""
    torch.set_num_threads(1)
    mesh = make_test_mesh(*MESH)
    out = {}
    for tag, (arch, *_) in CASES.items():
        _case(out, tag, lambda: mesh_case(ctx, mesh, tag, states[arch]))
    _case(out, "hang", lambda: mesh_hang(ctx, states[HANG_ARCH]))
    return out
