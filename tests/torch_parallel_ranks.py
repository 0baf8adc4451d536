"""Rank bodies of ``tests/test_torch_sharding.py`` and
``tests/test_torch_parallel.py`` (a module of its own, so that spawned
ranks import it without the test files' JAX imports)."""
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import Policy, rmsnorm
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import Block, block_apply
from repro_torch.parallel import pipeline as pp
from repro_torch.parallel.mesh import make_mesh, make_test_mesh
from repro_torch.parallel.sharding import gather, shard

# (mesh shape, axes, tensor shape, spec)
SHARD_CASES = [
    ((2, 2, 2), ("pod", "data", "model"), (8, 6, 4),
     (("pod", "data"), None, "model")),
    ((2, 2, 2), ("pod", "data", "model"), (2, 4, 2, 3),
     ("pod", "data", "model", None)),
    ((2, 4), ("data", "model"), (4, 8, 3), ("model", "data", None)),
    ((2, 4), ("data", "model"), (6, 16), (None, ("data", "model"))),
    ((1, 4), ("data", "model"), (16, 5), ("model", None)),
    ((4,), ("stage",), (4, 3, 2), ("stage",)),
]


def expected_block(t: torch.Tensor, spec, mesh, coords) -> torch.Tensor:
    """The block by numpy's row-major index over each dim's axes."""
    out = t
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        sizes = [mesh.shape[a] for a in names]
        idx = int(np.ravel_multi_index(
            [coords[mesh.axis_names.index(a)] for a in names], sizes))
        out = torch.chunk(out, int(np.prod(sizes)), dim=dim)[idx]
    return out


def shard_gather_rank(ctx, seed: int) -> list:
    """Each case of ``SHARD_CASES``: every rank connects its mesh (in one
    order); a rank of the mesh cuts its block of a seeded tensor and
    gathers it back."""
    out = []
    for i, (mshape, axes, shape, spec) in enumerate(SHARD_CASES):
        mesh = make_mesh(mshape, axes)
        if not mesh.member:
            out.append(None)
            continue
        rng = np.random.default_rng(seed + i)
        t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        coords = mesh.coords(ctx.rank)
        block = shard(t, spec, mesh, coords)
        full = gather(block, spec, mesh)
        out.append(dict(
            block_equal=bool(torch.equal(
                block, expected_block(t, spec, mesh, coords))),
            gathered_equal=bool(torch.equal(full, t)),
            block_shape=tuple(block.shape)))
    return out


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _ns(prefix: str, state: dict):
    return SimpleNamespace(**{k.rsplit(".", 1)[-1]: v for k, v in
                              state.items() if k.startswith(prefix)})


def _block(state: dict, cfg, prefix: str) -> Block:
    """The port's ``Block`` holding ``state``'s ``prefix`` entries."""
    blk = Block(cfg, torch.float32, "meta")
    for name, _ in list(blk.named_parameters()):
        mod, _, leaf = name.rpartition(".")
        setattr(blk.get_submodule(mod), leaf,
                torch.nn.Parameter(state[prefix + name], requires_grad=False))
    return blk


def parallel_rank(ctx, inputs: dict, llama_state: dict, moe_state: dict,
                  lm_state: dict, cfgs: dict) -> dict:
    """The parallel plane on 8 ranks: (a) the tanh pipeline on a stage mesh
    of 4, (b) a 2-stage pipeline of the reduced llama's blocks beside
    their sequential application on rank 0, (c) ``moe_apply`` of the
    reduced dbrx's experts on a (2, 4) mesh, at its capacity factor and at
    a lower one (tokens dropped), and on a (1, 4) mesh, and (d) the reduced
    dbrx ``TransformerLM`` built with the (2, 4) mesh on this rank's data
    shard of the tokens.  Every rank connects the meshes in one order; a
    rank outside a mesh skips its case."""
    meshes = dict(p4=make_mesh((4,), ("stage",)),
                  p2=make_mesh((2,), ("stage",)),
                  m24=make_test_mesh(data=2, model=4),
                  m14=make_test_mesh(data=1, model=4))
    out = {}
    p4 = meshes["p4"]
    if p4.member:
        block = pp.stage_block({"w": _t(inputs["ws"])}, p4)
        out["pipe_tanh"] = pp.pipeline_apply(
            lambda sp, x: torch.tanh(x @ sp["w"]), block, _t(inputs["xs"]),
            p4).numpy()
    p2 = meshes["p2"]
    if p2.member:
        cfg = cfgs["llama"]
        state = {k: _t(v) for k, v in llama_state.items()}
        x = _t(inputs["emb"])                     # [M, mb, S, D]
        h = rmsnorm(state["layers.0.ln1.scale"], x, cfg.norm_eps)
        a = torch.stack([h, x], dim=1)            # [M, 2, mb, S, D]
        positions = torch.arange(x.shape[2])[None, :]
        stacked = pp.stack_block_params(state, cfg, 2)
        fn = pp.block_stage(cfg, positions)
        out["pipe_llama"] = pp.pipeline_apply(
            fn, pp.stage_block(stacked, p2), a, p2).numpy()
        if ctx.rank == 0:        # the port's Blocks, nothing of pipeline.py
            L = cfg.num_layers
            blocks = [_block(state, cfg, f"layers.{i}.") for i in range(L)]
            nxts = [state[f"layers.{i + 1}.ln1.scale"]
                    for i in range(L - 1)] + [state["final_norm.scale"]]
            seq = []
            for mb in a:
                h, x = mb[0], mb[1]
                for i, (blk, nxt) in enumerate(zip(blocks, nxts)):
                    h, x = block_apply(blk, h, x, positions, cfg,
                                       lambda w: w, nxt, i)
                seq.append(torch.stack([h, x]))
            out["seq_llama"] = torch.stack(seq).numpy()
    for tag, mesh_name, cfg_name in (("ep24", "m24", "dbrx"),
                                     ("ep24_drop", "m24", "dbrx_drop"),
                                     ("ep14", "m14", "dbrx")):
        mesh = meshes[mesh_name]
        if not mesh.member:
            continue
        cfg = cfgs[cfg_name]
        coords = mesh.coords(ctx.rank)
        state = moe_lib.shard_experts(
            {k: _t(v) for k, v in moe_state.items()}, mesh, coords)
        x = _t(inputs["moe_x"])
        d, dp = coords[0], mesh.shape["data"]
        x = x.chunk(dp)[d]
        y, aux = moe_lib.moe_apply(_ns("moe.", state), x, cfg,
                                   lambda w: w, mesh)
        out[tag] = dict(y=y.numpy(), aux=float(aux), coords=coords,
                        experts=int(state["moe.wi_gate"].shape[0]))
    mesh = meshes["m24"]
    coords = mesh.coords(ctx.rank)
    model = build_model(cfgs["dbrx"], Policy(torch.float32), "cpu",
                        mesh=mesh).load_params(moe_lib.shard_experts(
                            {k: _t(v) for k, v in lm_state.items()}, mesh,
                            coords))
    tokens = _t(inputs["lm_tokens"]).chunk(mesh.shape["data"])[coords[0]]
    with torch.no_grad():
        logits, aux = model.logits_and_aux(tokens)
    out["lm24"] = dict(logits=logits.numpy(), aux=float(aux), coords=coords)
    return out
