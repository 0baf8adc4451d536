"""Multi-pod dry-run: every (arch x shape) cell on the production meshes,
its memory and cost at the H100's ceilings, and its roofline terms; the
port of the JAX package's ``launch/dryrun.py``.

    python -m repro_torch.launch.dryrun --arch mamba2-780m --shape long_500k
    python -m repro_torch.launch.dryrun --all [--multi-pod]

Nothing runs on a device: each cell's step (a train step, a prefill or a
decode step) runs once at the cell's global shape on meta tensors under the
op analysis (``launch/op_analysis.py``), on the CPU and on the card's host
alike.  The memory and collective terms come from the port's sharding
specs on the production mesh (16 x 16, or 2 x 16 x 16 with
``--multi-pod``).  How each number is taken is written into the cell's
JSON under ``method``; in short:

* ``memory.argument_bytes``: exact, the local shard bytes of parameters,
  optimizer state, batch, cache and step under the port's specs
  (sanitised, ZeRO-sharded under ``fsdp``, ``opt_state_specs``,
  ``cache_specs``) on the production mesh;
* ``flops_per_device`` / ``bytes_per_device``: the counted step divided by
  the chips, the even split the plan aims at (the reference's HLO also
  counts replicated work, so the port's ``useful_flops_ratio`` is an upper
  bound on the reference's);
* ``memory.temp_bytes``: the meta run's peak live intermediate bytes
  divided by the chips, the port's estimate;
* ``collectives``: what the port's parallel plane would run under the plan,
  by the ring formulas; no tensor-parallel activation collectives, since
  the port runs no tensor parallelism.

Declared difference from the reference: ``DryrunPolicy.attn_impl``
defaults to ``"auto"``, the flash kernel, which the port's trainer and
server run on the H100; ``--override attn_impl=chunked`` gives the
reference's default.  The JSON files go to ``--out`` (default
``dryrun_torch_out``) under the reference's names.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from dataclasses import dataclass

import torch

from repro_torch.configs import SHAPES, cells, get_config
from repro_torch.launch import op_analysis
from repro_torch.models.layers import Policy
from repro_torch.models.registry import build_model, modality_inputs
from repro_torch.optim.adamw import (AdamWConfig, QBLOCK, adamw_init,
                                     adamw_update, opt_state_specs)
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.mesh import dp_axes, make_production_mesh
from repro_torch.runtime.train import (RunConfig, loss_and_grads,
                                       make_train_step)

# ---------------------------------------------------------------- hardware
CHIP = "NVIDIA H100 80GB HBM3, 700.00 W"
CHIP_PEAK_FLOPS = 989e12     # H100 SXM, dense bf16 tensor cores
CHIP_HBM_BW = 3.35e12        # B/s, HBM3
LINK_BW = 5e10               # B/s, one 400 Gb/s NDR port per GPU


# ---------------------------------------------------------------- policies
@dataclass
class DryrunPolicy:
    param_dtype: str
    opt_dtype: str
    microbatches: int
    remat: str
    attn_impl: str = "auto"
    fsdp: bool = False               # shard params over data axes too
    q_chunk: int = 1024
    kv_chunk: int = 512
    grad_accum_dtype: str = "float32"
    fold_depth: int = 4

    def policy(self) -> Policy:
        return Policy(torch.bfloat16, getattr(torch, self.param_dtype))


BIG = {"llama3-405b", "arctic-480b", "dbrx-132b", "qwen2-72b"}
MID = {"llama-3.2-vision-11b", "musicgen-large", "zamba2-2.7b",
       "llama-20b-paper"}


def dryrun_policy(arch: str, overrides: dict | None = None) -> DryrunPolicy:
    if arch in BIG:
        p = DryrunPolicy("bfloat16", "int8", 16, "full", fsdp=True)
    elif arch in MID:
        p = DryrunPolicy("float32", "bfloat16", 4, "full", fsdp=True)
    else:
        p = DryrunPolicy("float32", "float32", 4, "none")
    known = {f.name for f in dataclasses.fields(p)}
    for k, v in (overrides or {}).items():
        if k not in known:
            raise ValueError(f"dry-run policy has no option {k!r}; the "
                             f"port models {sorted(known)}")
        setattr(p, k, v)
    return p


# ---------------------------------------------------------------- specs
def cache_specs(cfg, mesh, batch: int, max_seq: int, policy: Policy,
                model) -> tuple:
    """({name: meta tensor}, {name: Spec}) of ``model``'s cache: for each
    of the port's cache tensors the reference's spec (``dryrun.py``'s
    ``cache_specs``), where the reference stacks a tensor on two leading
    axes [groups, per] (the vlm's self-attention k/v, zamba2's state and
    conv) and the port on one, their two None entries as one.  A batch the
    data axes divide is sharded over them; a smaller one (batch 1, long
    context) shards the sequence instead."""
    dp = dp_axes(mesh)
    n_dp = math.prod(mesh.shape[a] for a in dp)
    batch_ok = batch % n_dp == 0 and batch >= n_dp
    bspec = dp if batch_ok else None
    sspec = None if batch_ok else dp
    fam = cfg.family

    def spec_for(key: str) -> sh.Spec:
        if fam in ("dense", "moe", "audio"):
            return sh.Spec(None, bspec, sspec, "model", None)
        if fam == "vlm":
            if key.startswith("cross"):
                return sh.Spec(None, bspec, None, "model", None)
            return sh.Spec(None, bspec, sspec, "model", None)
        if fam in ("ssm", "hybrid"):
            if key == "state":
                return sh.Spec(None, bspec, "model", None, None)
            if key == "conv":
                return sh.Spec(None, bspec, None, "model")
            return sh.Spec(None, bspec, sspec, "model", None)
        raise ValueError(fam)

    shapes = model.init_cache(batch, max_seq)
    return shapes, {k: spec_for(k) for k in shapes}


def shard_inputs(leaves: dict, mesh) -> dict:
    """{name: a meta tensor of the per-device shard shape} of ``leaves``
    ({name: (shape, dtype, spec)}), each spec sanitised first (as the
    reference's ``_sds``), through ``sharding.shaped_with_sharding``."""
    return sh.shaped_with_sharding(
        {k: tuple(s) for k, (s, _, _) in leaves.items()},
        {k: sh.sanitize_spec(spec, tuple(s), mesh)
         for k, (s, _, spec) in leaves.items()},
        mesh, {k: d for k, (_, d, _) in leaves.items()})


def local_bytes(leaves: dict, mesh) -> int:
    """One device's bytes of ``leaves`` ({name: (shape, dtype, spec)})."""
    return sum(t.numel() * t.element_size()
               for t in shard_inputs(leaves, mesh).values())


def _n(mesh, axes) -> int:
    return max(math.prod(mesh.shape[a] for a in axes), 1)


def _batch_spec(mesh, b: int, ndim: int) -> sh.Spec:
    dp = dp_axes(mesh)
    return sh.Spec(dp if b % _n(mesh, dp) == 0 else None,
                   *(None,) * (ndim - 1))


def param_leaves(model, mesh, pol: DryrunPolicy) -> dict:
    """{reference leaf: (stacked shape, dtype, spec)} of the parameters
    (one stacked leaf for every layer's copy of a parameter, as the
    reference's tree holds it), with ZeRO over the data axes under
    ``fsdp``; and the same of the optimizer state under ``"opt:"`` keys
    (``opt_state_specs`` on the stacked shapes, ``count`` included)."""
    cfg = model.cfg
    dp = dp_axes(mesh)
    params = dict(model.named_parameters())
    specs = sh.param_specs(model, stacked=True)
    if pol.fsdp:
        specs = {k: sh.zero_spec(s, sh.stack_dims(k, cfg)
                                 + tuple(params[k].shape), mesh, axes=dp)
                 for k, s in specs.items()}
    opt = AdamWConfig(state_dtype=pol.opt_dtype)
    ospecs = opt_state_specs(specs, model, mesh, opt, stacked=True)
    out = {}
    for name, p in params.items():
        leaf = sh.ref_leaf(name)
        if leaf in out:
            continue
        shape = sh.stack_dims(name, cfg) + tuple(p.shape)
        out[leaf] = (shape, p.dtype, specs[name])
        s = ospecs["mu_nu"][name]
        if pol.opt_dtype == "int8":
            last = shape[-1] if shape else 1
            nb = (last + QBLOCK - 1) // QBLOCK
            moment = {"q": (shape or (1,), torch.int8, s["m"]["q"]),
                      "scale": (shape[:-1] + (nb,), torch.float32,
                                s["m"]["scale"])}
        else:
            dt = (torch.bfloat16 if pol.opt_dtype == "bfloat16"
                  else torch.float32)
            moment = {"": (shape, dt, s["m"])}
        for m in ("m", "v"):
            for f, v in moment.items():
                out[f"opt:{leaf}/{m}{'/' + f if f else ''}"] = v
    out["opt:count"] = ((), torch.int32, sh.Spec())
    return out


# ---------------------------------------------------------------- cells
@dataclass
class Cell:
    """A cell's step on meta tensors: ``fn()`` runs it once at the global
    shape; ``args`` are the argument leaves {name: (shape, dtype, spec)}
    (shape and spec stacked as the reference's tree), ``outputs`` what
    the step writes anew (the port updates parameters, optimizer state
    and a decode's cache in place); ``micro`` the microbatches a train
    step runs, of which ``fn`` runs one and counts the rest."""

    fn: object
    args: dict
    outputs: object
    info: dict
    micro: int = 1


def build_cell(arch: str, shape_name: str, mesh, overrides=None) -> Cell:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    pol = dryrun_policy(arch, overrides)
    policy = pol.policy()
    model = build_model(cfg, policy, "meta", pol.remat,
                        attn_impl=pol.attn_impl, fold_depth=pol.fold_depth,
                        q_chunk=pol.q_chunk, kv_chunk=pol.kv_chunk)
    B, S = shape.global_batch, shape.seq_len
    info = {"arch": arch, "shape": shape_name, "kind": shape.kind,
            "family": cfg.family, "tokens": shape.tokens,
            "param_count": cfg.param_count(),
            "active_param_count": cfg.active_param_count(),
            "policy": vars(pol).copy()}
    leaves = param_leaves(model, mesh, pol)
    params = {k: v for k, v in leaves.items() if not k.startswith("opt:")}
    meta = dict(dtype=torch.int32, device="meta")

    def tokens(b, s):
        return torch.empty((b, s), **meta)

    vis = modality_inputs(cfg, B).get("vision_embeds")
    vision = (None if vis is None else
              torch.empty(vis, dtype=torch.bfloat16, device="meta"))
    extra = {} if vision is None else {"vision_embeds": vision}
    args = dict(params)

    if shape.kind == "train":
        run = RunConfig(model=cfg, global_batch=B, seq_len=S,
                        num_microbatches=pol.microbatches,
                        opt=AdamWConfig(state_dtype=pol.opt_dtype),
                        param_dtype=pol.param_dtype, remat=pol.remat,
                        attn_impl=pol.attn_impl,
                        grad_accum_dtype=pol.grad_accum_dtype, device="meta")
        opt_state = adamw_init(dict(model.named_parameters()), run.opt)
        batch = {"tokens": tokens(B, S), "labels": tokens(B, S), **extra}
        seen = []

        def grads(model, mb, params):
            """The first microbatch runs; the others count as it did."""
            an = op_analysis.current()
            if not seen:
                before = an.snapshot()
                out = loss_and_grads(model, mb, params)
                seen.append((before, an.snapshot()))
                return out
            an.add(*seen[0])
            return (torch.empty((), device="meta"),
                    {k: torch.empty_like(p) for k, p in params.items()})

        def update(g, state, params, opt, lr):
            """One parameter's update of each (shape, dtype) runs; the
            others of its shape count as it did."""
            an = op_analysis.current()
            done = {}
            for k, p in params.items():
                key = (tuple(p.shape), p.dtype)
                if key in done:
                    an.add(*done[key])
                    continue
                before = an.snapshot()
                _, one, om = adamw_update(
                    {k: g[k]}, {"mu_nu": {k: state["mu_nu"][k]},
                                "count": state["count"]}, {k: p}, opt, lr)
                done[key] = (before, an.snapshot())
            return params, state, om

        step_fn = make_train_step(model, run, grads=grads, update=update)
        args.update({k: v for k, v in leaves.items()
                     if k.startswith("opt:")})
        for k, t in batch.items():
            args[f"batch:{k}"] = (tuple(t.shape), t.dtype,
                                  _batch_spec(mesh, B, t.dim()))
        args["step"] = ((), torch.int32, sh.Spec())
        step = torch.empty((), **meta)
        return Cell(lambda: step_fn(opt_state, batch, step)[1], args,
                    None, info, pol.microbatches)

    cache_shapes, cspecs = cache_specs(cfg, mesh, B, S, policy, model)
    if shape.kind == "prefill":
        toks = tokens(B, S)
        args["tokens"] = ((B, S), torch.int32, _batch_spec(mesh, B, 2))
        for k, t in extra.items():
            args[k] = (tuple(t.shape), t.dtype, _batch_spec(mesh, B, 3))

        def prefill():
            cache = model.init_cache(B, S)
            return model.prefill(toks, cache, **extra), cache
        return Cell(prefill, args, (_batch_spec(mesh, B, 2), cspecs), info)

    # decode: one new token against a full cache
    args["token"] = ((B, 1), torch.int32, _batch_spec(mesh, B, 2))
    for k, t in cache_shapes.items():
        args[f"cache:{k}"] = (tuple(t.shape), t.dtype, cspecs[k])
    args["pos"] = ((), torch.int32, sh.Spec())
    tok = tokens(B, 1)
    return Cell(lambda: (model.decode_step(tok, cache_shapes, S - 1), {}),
                args, (_batch_spec(mesh, B, 2), cspecs), info)


# ---------------------------------------------------------------- analysis
def _collectives(cell: Cell, mesh, model_cfg) -> dict:
    """Per device, what the port's parallel plane would run under the plan,
    by the ring formulas (``op_analysis.wire_bytes``)."""
    pol = DryrunPolicy(**cell.info["policy"])
    shape = SHAPES[cell.info["shape"]]
    dp = dp_axes(mesh)
    n_dp, n_model = _n(mesh, dp), mesh.shape["model"]
    an = op_analysis.OpAnalysis()
    passes = 1                       # forwards of each microbatch
    if shape.kind == "train":
        passes = cell.micro * (1 if pol.remat == "none" else 2)
        acc = (getattr(torch, pol.grad_accum_dtype) if cell.micro > 1
               else getattr(torch, pol.param_dtype))
        for name, (shp, dtype, spec) in cell.args.items():
            if name.startswith(("opt:", "batch:")) or name == "step":
                continue
            spec = sh.sanitize_spec(spec, shp, mesh)
            local = math.prod(sh.local_shape(shp, spec, mesh))
            used = {a for e in spec if e is not None
                    for a in (e if isinstance(e, tuple) else (e,))}
            if used & set(dp):
                # ZeRO-sharded: the gradient reduce-scattered into the
                # shard; the parameter gathered before each forward
                an.collective("reduce-scatter", local
                              * torch.empty((), dtype=acc).element_size(),
                              n_dp)
                an.collective("all-gather", local * n_dp * torch.empty(
                    (), dtype=dtype).element_size(), n_dp, times=passes)
            else:
                an.collective("all-reduce", local * torch.empty(
                    (), dtype=acc).element_size(), n_dp)
    b = shape.global_batch // (cell.micro if shape.kind == "train" else 1)
    s = 1 if shape.kind == "decode" else shape.seq_len
    b_loc = b // n_dp if b % n_dp == 0 else b
    if model_cfg.num_experts:
        an.collective("all-reduce", b_loc * s * model_cfg.d_model * 2,
                      n_model, times=model_cfg.num_layers * passes)
    if (pol.attn_impl == "cp" and shape.kind != "decode"
            and model_cfg.num_heads and s % n_model == 0
            and (s // n_model) % 16 == 0):
        layers = (model_cfg.n_self if model_cfg.family != "hybrid"
                  else model_cfg.num_layers // model_cfg.attn_every)
        an.collective("all-gather", b_loc * s * model_cfg.num_heads
                      * model_cfg.head_dim * 2, n_model,
                      times=layers * passes)
    return an.stats()


METHOD = {
    "argument_bytes": "exact: the local shard bytes of parameters, "
    "optimizer state, batch, cache and step under the port's specs "
    "(sanitised; ZeRO under fsdp; opt_state_specs; cache_specs) on the "
    "production mesh",
    "output_bytes": "the local bytes of what the step writes anew under the "
    "same specs (parameters, optimizer state and a decode's cache are "
    "updated in place)",
    "temp_bytes": "the meta run's peak live intermediate bytes / chips (the "
    "port's estimate, not XLA's)",
    "flops_per_device": "the counted step (products only; port kernels by "
    "their work()) / chips: the even split the plan aims at",
    "bytes_per_device": "the counted step's eager traffic / chips",
    "collectives": "what the port's parallel plane would run under the plan, "
    "by the ring formulas: gradient all-reduce over the data axes "
    "(reduce-scatter under ZeRO), the fsdp parameter all-gather before each "
    "forward and remat recompute, the MoE outputs' all-reduce over the model "
    "axis, and under attn_impl=cp the rows' all-gather; no tensor-parallel "
    "activation collectives (the port runs none)",
    "ceilings": f"{CHIP}: {CHIP_PEAK_FLOPS:.4g} FLOP/s dense bf16, "
    f"{CHIP_HBM_BW:.4g} B/s HBM, {LINK_BW:.4g} B/s a link",
}


def analyze(cell: Cell, stats: dict, mesh, chips: int) -> dict:
    """The cell's JSON (the reference's keys, ``hlo_*`` and
    ``cost_analysis_*`` as ``flops_per_device`` and ``bytes_per_device``)
    from the meta run's ``stats``."""
    args = local_bytes(cell.args, mesh)
    out = 12 if cell.info["kind"] == "train" else 0   # loss, lr, grad_norm
    if cell.outputs is not None:
        logits, cache = stats["result"]
        lspec, cspecs = cell.outputs
        out += local_bytes({"logits": (logits.shape, logits.dtype, lspec),
                            **{k: (t.shape, t.dtype, cspecs[k])
                               for k, t in cache.items()}}, mesh)
    coll = _collectives(cell, mesh, get_config(cell.info["arch"]))
    flops = stats["flops"] / chips
    bytes_acc = stats["traffic_bytes"] / chips
    wire = coll["total_wire_bytes"]
    temp = stats["peak_live_bytes"] / chips
    flops_per_param = 6.0 if cell.info["kind"] == "train" else 2.0
    model_flops = (flops_per_param * cell.info["active_param_count"]
                   * cell.info["tokens"])
    t_compute = flops / CHIP_PEAK_FLOPS
    t_memory = bytes_acc / CHIP_HBM_BW
    t_coll = wire / LINK_BW
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]
    return {
        **cell.info,
        "chips": chips,
        "chip": CHIP,
        "memory": {"argument_bytes": args, "output_bytes": out,
                   "temp_bytes": temp, "peak_bytes": args + out + temp},
        "flops_per_device": flops,
        "bytes_per_device": bytes_acc,
        "collectives": coll["collectives"],
        "total_wire_bytes": wire,
        "model_flops_global": model_flops,
        "model_flops_per_device": model_flops / chips,
        "useful_flops_ratio": (model_flops / chips) / flops if flops else 0.0,
        "roofline_s": {"compute": t_compute, "memory": t_memory,
                       "collective": t_coll},
        "dominant": dominant,
        "kernels": stats["kernels"],
        "traffic_by_op": stats["traffic_by_op"],
        "method": METHOD,
    }


# ---------------------------------------------------------------- the CLI
def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str | None = None, overrides=None, tag: str = "",
             runs: dict | None = None) -> dict:
    """One cell on one production mesh.  ``runs``, if given, keeps each
    cell's meta run (which does not depend on the mesh) for the next call
    of the same cell on the other mesh."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    t0 = time.time()
    cell = build_cell(arch, shape_name, mesh, overrides)
    key = (arch, shape_name, tuple(sorted((overrides or {}).items())))
    runs = {} if runs is None else runs
    if key not in runs:
        runs[key] = op_analysis.analyze(cell.fn)
    res = analyze(cell, runs[key], mesh, chips)
    res["mesh"] = "2x16x16" if multi_pod else "16x16"
    res["analysis_s"] = round(time.time() - t0, 1)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        fname = (f"{arch}_{shape_name}_{res['mesh'].replace('x', '-')}"
                 f"{suffix}.json")
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(res, f, indent=1)
    return res


def row(r: dict) -> str:
    """The reference's ``OK`` row of a cell."""
    mem_gb = r["memory"]["peak_bytes"] / 2 ** 30
    roof = r["roofline_s"]
    return (f"OK   {r['arch']:22s} {r['shape']:12s} {r['mesh']:8s} "
            f"peak/dev={mem_gb:6.2f}GiB "
            f"compute={roof['compute'] * 1e3:8.2f}ms "
            f"memory={roof['memory'] * 1e3:8.2f}ms "
            f"coll={roof['collective'] * 1e3:8.2f}ms "
            f"dom={r['dominant']:10s} "
            f"useful={r['useful_flops_ratio']:.2f} "
            f"[analysis {r['analysis_s']}s]")


def main(argv=None):
    ap = argparse.ArgumentParser(description="FLARE port multi-pod dry-run")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every assigned cell on this mesh")
    ap.add_argument("--out", default="dryrun_torch_out")
    ap.add_argument("--override", default="",
                    help="k=v,k=v policy overrides (e.g. attn_impl=folded)")
    ap.add_argument("--tag", default="", help="suffix for output json")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.override.split(","):
        if "=" in kv:
            k, v = kv.split("=", 1)
            overrides[k] = int(v) if v.isdigit() else v

    if args.all:
        todo = [(a, s) for a, s, _ in cells()]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        todo = [(args.arch, args.shape)]

    failures = []
    for arch, shape_name in todo:
        try:
            r = run_cell(arch, shape_name, args.multi_pod, args.out,
                         overrides, args.tag)
            print(row(r), flush=True)
        except Exception as e:  # noqa: BLE001
            failures.append((arch, shape_name, repr(e)[:300]))
            print(f"FAIL {arch:22s} {shape_name:12s}: {e!r}"[:240],
                  flush=True)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
