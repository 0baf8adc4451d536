"""The gradient of the port's parallel plane against the JAX package's
``jax.grad`` through ``shard_map`` and against the port's one-process
gradient, on the CPU.

The reference runs once, in a subprocess with 4 fake XLA devices
(``--xla_force_host_platform_device_count``, so this process keeps one),
and writes an ``.npz``; the port runs on 4 gloo CPU ranks
(``run_ranks(device="cpu")``, bodies in
``tests/torch_parallel_grad_ranks.py``), one spawn for the module, whose
timeout turns a hung backward into a failure.  Inputs and cotangents are numpy draws from a seed; weights are
the JAX init's, carried by ``models/bridge.py::params_from_jax``.  Every
rank keeps ``parallel/collectives.py``'s convention: a loss held by k ranks
is seeded with 1 / k, and the gradient of a tensor held whole on several
ranks is summed over the axes it is replicated on
(``sharding.sum_replicated``); the sums are the one global loss's
gradient.

* the ring all-reduce's fault of record: on 2 ranks, w = rank + 1 and the
  loss (ring_all_reduce(2w)·arange(8)).sum() gave each rank the gradient
  of only the chunk it owned after the reduce-scatter; now 2·arange(8);
* each collective (permute, reduce-scatter, all-gather at slot offsets 0
  and 1, all-reduce, the padded all-reduce of any shape) against the JAX
  body's gradient and the one-process gradient, fp32 within 1e-5;
* the reduced dbrx ``moe_apply`` on (1, 4) and (2, 2) meshes, at the
  config's capacity factor and at 0.5 (tokens dropped), the loss
  sum(tanh(y)) + aux; ``context_parallel_attention`` on (1, 4), causal,
  at q_offset 0 and 24; the tanh pipeline on 4 stages and the reduced
  llama's blocks on 2: within 3e-4 of the reference's ``jax.grad`` and
  1e-5 of the port's one-process gradient, fp32;
* the hang drill on a backward: rank f drops its sends from ring step 1 of
  an all-reduce's backward reduce-scatter, and the backward's own
  progress, read from the daemon's hang callback, names link f -> f+1.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.core.hang import diagnose_hang as jax_diagnose_hang
from repro.models.moe import moe_init
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import get_reduced, scale
from repro_torch.core.hang import diagnose_hang
from repro_torch.core.inspecting import diagnose_ring
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.bridge import params_from_jax
from repro_torch.models.transformer import Block, block_apply
from torch_parallel_grad_ranks import (COLLECTIVES, EP_CASES, HANG_FAULTS,
                                       grad_rank)

ROOT = Path(__file__).resolve().parents[1]
W = 4
M, MB, WIDTH = 8, 4, 16            # the tanh pipeline
LM_M, LM_MB, LM_S = 4, 2, 8        # the llama pipeline
MOE_B, MOE_S = 4, 8
DROP_CF = 0.5
LLAMA_SEED = 5
# (q_offset, q_chunk, kv_chunk) at B 2, S 128, H 4 over KV 2, hd 16: 32
# rows a rank
CP_CASES = [(0, 32, 32), (24, 32, 64)]
REF_TOL = 3e-4     # the reference's jax.grad
PORT_TOL = 1e-5    # the port's one-process gradient

_JAX_GRADS = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_reduced, scale
    from repro.launch.mesh import _mk, make_test_mesh
    from repro.models import build_model, layers as L
    from repro.models.attention import context_parallel_attention
    from repro.models.moe import moe_apply
    from repro.parallel.collectives import (ring_all_gather_local,
        ring_all_reduce_local, ring_reduce_scatter_local)
    from repro.parallel.compat import shard_map
    from repro.parallel.pipeline import pipeline_apply

    inp = dict(np.load(sys.argv[1]))
    drop_cf, llama_seed = float(sys.argv[3]), int(sys.argv[4])
    n = 4
    out = {}
    m14 = make_test_mesh(data=1, model=n)

    def flat(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                flat(v, prefix + k + ".")
            else:
                out[prefix + k] = np.asarray(v)

    def padded(x):
        f = x.reshape(-1)
        pad = (-f.size) % n
        full = ring_all_reduce_local(jnp.pad(f, (0, pad)), "model", n)[0]
        return full[:f.size].reshape(x.shape)

    bodies = {
        "permute": lambda x: jax.lax.ppermute(
            x, "model", [(i, (i + 1) % n) for i in range(n)]),
        "reduce_scatter": lambda x: ring_reduce_scatter_local(
            x, "model", n)[0],
        "all_gather_0": lambda x: ring_all_gather_local(
            x, "model", n, slot_offset=0)[0],
        "all_gather_1": lambda x: ring_all_gather_local(
            x, "model", n, slot_offset=1)[0],
        "all_reduce": lambda x: ring_all_reduce_local(x, "model", n)[0],
        "all_reduce_any": padded}
    for name, body in bodies.items():
        x, c = inp[name], inp[name + "_c"]
        f = shard_map(body, mesh=m14, in_specs=P("model"),
                      out_specs=P("model"), check_vma=False)
        cg = jnp.asarray(c.reshape((-1,) + c.shape[2:]))
        g = jax.jit(jax.grad(lambda xg: jnp.sum(f(xg) * cg)))(
            jnp.asarray(x.reshape((-1,) + x.shape[2:])))
        out[name] = np.asarray(g).reshape(x.shape)

    params = {k.split(".", 1)[1]: jnp.asarray(v) for k, v in inp.items()
              if k.startswith("moe.")}
    cfg = get_reduced("dbrx-132b")
    cfgs = {"dbrx": cfg, "dbrx_drop": scale(cfg, capacity_factor=drop_cf)}
    x = jnp.asarray(inp["moe_x"])
    for tag, shape, cname in (("ep14", (1, 4), "dbrx"),
                              ("ep14_drop", (1, 4), "dbrx_drop"),
                              ("ep22", (2, 2), "dbrx"),
                              ("ep22_drop", (2, 2), "dbrx_drop")):
        mesh, c = make_test_mesh(*shape), cfgs[cname]

        def loss(p, v, c=c, mesh=mesh):
            y, aux = moe_apply(p, v, c, mesh=mesh)
            return jnp.sum(jnp.tanh(y)) + aux
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
        flat(gp, tag + ".moe.")
        out[tag + ".x"] = np.asarray(gx)

    for i in range(int(inp["cp_n"])):
        q, k, v, c = (jnp.asarray(inp[f"cp{i}_{s}"]) for s in "qkvc")
        off, qc, kc = (int(v_) for v_ in inp[f"cp{i}_args"])

        def loss(q, k, v, c=c, off=off, qc=qc, kc=kc):
            return jnp.sum(context_parallel_attention(
                q, k, v, m14, causal=True, q_offset=off, q_chunk=qc,
                kv_chunk=kc) * c)
        for s, g in zip("qkv", jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
                q, k, v)):
            out[f"cp{i}.{s}"] = np.asarray(g)

    p4 = _mk((4,), ("stage",))
    xs_c = jnp.asarray(inp["xs_c"])
    gw, gx = jax.jit(jax.grad(lambda w, x: jnp.sum(pipeline_apply(
        lambda w_, x_: jnp.tanh(x_ @ w_), w, x, p4, axis="stage") * xs_c),
        argnums=(0, 1)))(jnp.asarray(inp["ws"]), jnp.asarray(inp["xs"]))
    out["pipe_tanh.w"], out["pipe_tanh.xs"] = np.asarray(gw), np.asarray(gx)

    lcfg = get_reduced("llama3.2-1b")
    lm = build_model(lcfg)
    lp = lm.init(jax.random.PRNGKey(llama_seed))
    S2, Ly = 2, lcfg.num_layers
    emb, ec = jnp.asarray(inp["emb"]), jnp.asarray(inp["emb_c"])
    positions = jnp.arange(emb.shape[2])[None, :]

    def stage_fn(sp, x):
        for j in range(Ly // S2):
            x = lm._self_block(jax.tree.map(lambda a: a[j], sp), x,
                               positions)[0]
        return x

    def loss(layers, fnorm, e):
        stacked = jax.tree.map(
            lambda a: a.reshape((S2, Ly // S2) + a.shape[1:]), layers)
        xo = pipeline_apply(stage_fn, stacked, e, _mk((S2,), ("stage",)),
                            axis="stage")
        h = L.rmsnorm(fnorm, xo, lcfg.norm_eps)
        return jnp.sum(h * ec[:, 0]) + jnp.sum(xo * ec[:, 1])
    gl, gf, ge = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        lp["layers"], lp["final_norm"], emb)
    flat({"layers": gl, "final_norm": gf}, "llama.")
    out["llama.x"] = np.asarray(ge)
    np.savez(sys.argv[2], **out)
""")


def _inputs() -> dict:
    rng = np.random.default_rng(36)
    f32 = np.float32

    def draw(*shape, s=1.0):
        return (s * rng.standard_normal(shape)).astype(f32)
    # per rank: (input shape, output shape) of each collective
    shapes = {"permute": ((5, 3), (5, 3)),
              "reduce_scatter": ((4 * W, 3), (4, 3)),
              "all_gather_0": ((3, 5), (3 * W, 5)),
              "all_gather_1": ((3, 5), (3 * W, 5)),
              "all_reduce": ((2 * W, 3), (2 * W, 3)),
              "all_reduce_any": ((7, 3), (7, 3))}
    out = {}
    for name, (i, o) in shapes.items():
        out[name], out[name + "_c"] = draw(W, *i), draw(W, *o)
    lcfg = get_reduced("llama3.2-1b")
    dcfg = get_reduced("dbrx-132b")
    out.update(ws=draw(4, WIDTH, WIDTH, s=0.5), xs=draw(M, MB, WIDTH),
               xs_c=draw(M, MB, WIDTH),
               emb=draw(LM_M, LM_MB, LM_S, lcfg.d_model),
               emb_c=draw(LM_M, 2, LM_MB, LM_S, lcfg.d_model),
               moe_x=draw(MOE_B, MOE_S, dcfg.d_model))
    return out


def _cp_cases() -> list:
    rng = np.random.default_rng(37)
    cases = []
    for off, qc, kc in CP_CASES:
        q, k, v, c = (rng.standard_normal(s).astype(np.float32) for s in (
            (2, 128, 4, 16), (2, 128, 2, 16), (2, 128, 2, 16),
            (2, 128, 4, 16)))
        cases.append(dict(q=q, k=k, v=v, c=c, q_offset=off, q_chunk=qc,
                          kv_chunk=kc))
    return cases


def _setup():
    """(inputs, CP cases, the MoE's state, the reduced llama's state, the
    configs)."""
    moe = jax.tree.map(np.asarray, moe_init(
        jax.random.PRNGKey(2), jax_get_reduced("dbrx-132b"), jnp.float32))
    llama = params_from_jax(jax.tree.map(np.asarray, jax_build_model(
        jax_get_reduced("llama3.2-1b")).init(jax.random.PRNGKey(LLAMA_SEED))))
    cfg = get_reduced("dbrx-132b")
    cfgs = {"llama": get_reduced("llama3.2-1b"), "dbrx": cfg,
            "dbrx_drop": scale(cfg, capacity_factor=DROP_CF)}
    return (_inputs(), _cp_cases(), {f"moe.{k}": v for k, v in moe.items()},
            llama, cfgs)


@pytest.fixture(scope="module")
def grad_run(tmp_path_factory):
    """(port results per rank, JAX gradients, inputs, CP cases, MoE state,
    llama state, configs): the JAX subprocess runs while the 4 ranks do."""
    tmp = tmp_path_factory.mktemp("parallel_grad")
    inputs, cp_cases, moe_state, llama, cfgs = _setup()
    cp = {"cp_n": np.array(len(cp_cases))}
    for i, c in enumerate(cp_cases):
        cp.update({f"cp{i}_{s}": c[s] for s in "qkvc"})
        cp[f"cp{i}_args"] = np.array([c["q_offset"], c["q_chunk"],
                                      c["kv_chunk"]])
    np.savez(tmp / "inputs.npz", **inputs, **moe_state, **cp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_GRADS, str(tmp / "inputs.npz"),
         str(tmp / "jax.npz"), str(DROP_CF), str(LLAMA_SEED)], env=env,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ranks = run_ranks(grad_rank, W, inputs, moe_state, llama, cfgs,
                          cp_cases, device="cpu", timeout=120.0)
        log, _ = jax_proc.communicate(timeout=240)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0, log
    return (ranks, dict(np.load(tmp / "jax.npz")), inputs, cp_cases,
            moe_state, llama, cfgs)


def _result(ranks, r: int, tag: str):
    res = ranks[r][tag]
    assert not (isinstance(res, dict) and "error" in res), res.get("error")
    return res


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# --------------------------------------------------------------------------- #
# the fault of record, and each collective
# --------------------------------------------------------------------------- #
def test_ring_all_reduce_gradient_is_whole_on_both_ranks(grad_run):
    """y = ring_all_reduce(2w) is 2·(1 + 2) = 6 everywhere, and the loss
    (y·arange(8)).sum(), held by both ranks and seeded with 1/2 on each,
    gives dw = 2·arange(8) on each rank: every chunk, not only the one the
    rank owned after the reduce-scatter."""
    ranks = grad_run[0]
    for r in range(2):
        res = _result(ranks, r, "fault")
        np.testing.assert_array_equal(res["y"], np.full(8, 6.0))
        np.testing.assert_array_equal(res["grad"], 2 * np.arange(8.0))
    assert all("fault" not in ranks[r] for r in range(2, W))


def _one_process_collective(name: str, xs: np.ndarray,
                            cs: np.ndarray) -> np.ndarray:
    """The gradient of Σ_r (out_r·c_r).sum() w.r.t. every rank's input,
    from the collective written as sums in one process."""
    n = xs.shape[0]
    x = torch.tensor(xs, requires_grad=True)
    if name == "permute":
        outs = [x[(r - 1) % n] for r in range(n)]
    elif name == "reduce_scatter":
        outs = [sum(x[j].reshape(n, -1)[(r + 1) % n] for j in range(n))
                .reshape(cs.shape[1:]) for r in range(n)]
    elif name.startswith("all_gather_"):
        off = int(name[-1])
        slots = [x[(s - off) % n] for s in range(n)]
        outs = [torch.cat(slots)] * n
    else:
        outs = [x.sum(0)] * n
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cs)).backward()
    return x.grad.numpy()


@pytest.mark.parametrize("oracle", ["jax", "one_process"])
@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_gradient(grad_run, name, oracle):
    """Each rank's gradient of its own input, within 1e-5 of the JAX body's
    ``jax.grad`` under ``shard_map`` and of the one-process gradient."""
    ranks, jax_out, inputs = grad_run[:3]
    want = (jax_out[name] if oracle == "jax" else _one_process_collective(
        name, inputs[name], inputs[name + "_c"]))
    for r in range(W):
        _close(_result(ranks, r, "collectives")[name], want[r], PORT_TOL)


def test_backward_on_meta_tensors_records_its_collectives(grad_run):
    """An all-gather of a [6, 4] fp32 meta tensor, an all-reduce of the
    gathered [24, 4] and both backwards under the op analysis: the
    all-gather's backward records a reduce-scatter to [6, 4], the
    all-reduce's another all-reduce; nothing moves."""
    ranks = grad_run[0]
    rows, chunk = 24 * 4 * 4, 6 * 4 * 4
    for r in range(W):
        got = _result(ranks, r, "meta")
        assert got == {
            "all-gather": {"count": 1, "result_bytes": rows,
                           "wire_bytes": rows * (W - 1) / W},
            "all-reduce": {"count": 2, "result_bytes": 2 * rows,
                           "wire_bytes": 2 * 2 * rows * (W - 1) / W},
            "reduce-scatter": {"count": 1, "result_bytes": chunk,
                               "wire_bytes": chunk * (W - 1)}}, got


@pytest.mark.parametrize("spec,n", [((), 8), (("data",), 4),
                                    ((None, "model"), 2),
                                    ((("data", "model"),), 1)])
def test_replicas_counts_the_ranks_that_hold_a_tensor(spec, n):
    """A tensor under a spec is held whole on the product of the axes the
    spec does not name (a replicated loss's seed is its inverse), and its
    gradient's sum crosses only those axes: none, without a single ring
    call, when the spec names every axis of more than one rank."""
    from repro_torch.parallel.mesh import Mesh
    from repro_torch.parallel.sharding import Spec, replicas, sum_replicated
    mesh = Mesh((2, 4), ("data", "model"))
    assert replicas(Spec(*spec), mesh) == n
    g = torch.arange(6.0)
    assert sum_replicated(g, Spec(("data", "model")), mesh) is g
    assert sum_replicated(g, Spec("model"), Mesh((1, 4), ("data", "model"))) \
        is g


# --------------------------------------------------------------------------- #
# expert parallelism
# --------------------------------------------------------------------------- #
def _moe_one_process(moe_state: dict, x: np.ndarray, cfg, dp: int) -> dict:
    """The port's local MoE path on each of ``dp`` data shards, all experts,
    with the aux loss of the shares averaged over the shards (the mesh
    path's): the gradient of sum(tanh(y)) + aux."""
    p = {k.split(".", 1)[1]: torch.tensor(v, requires_grad=True)
         for k, v in moe_state.items()}
    xt = torch.tensor(x, requires_grad=True)
    shares, loss = [], 0.0
    for xd in xt.chunk(dp):
        xf = xd.reshape(-1, xd.shape[-1])
        eids, w, _ = moe_lib.route(p["router"], xf, cfg,
                                   lambda s: shares.append(s) or s)
        y = moe_lib.expert_ff_local(xf, eids, w, p["wi_gate"], p["wi_up"],
                                    p["wo"], 0,
                                    moe_lib.capacity(xf.shape[0], cfg))
        loss = loss + torch.tanh(y).sum()
    s = torch.stack(shares).mean(0)
    (loss + cfg.num_experts * (s[0] * s[1]).sum()).backward()
    out = {f"moe.{k}": v.grad.numpy() for k, v in p.items()}
    out["x"] = xt.grad.numpy()
    return out


@pytest.mark.parametrize("oracle", ["jax", "one_process"])
@pytest.mark.parametrize("tag", list(EP_CASES))
def test_expert_parallel_gradient(grad_run, tag, oracle):
    """Every rank's router, expert and x gradients after the replicated-
    axis sums: the router's whole, its experts' block, its data shard's
    rows of x; 3e-4 of the reference, 1e-5 of the one-process path."""
    ranks, jax_out, inputs, _, moe_state, _, cfgs = grad_run
    (dp, n), cname = EP_CASES[tag]
    if oracle == "jax":
        want = {k: jax_out[f"{tag}.{k}"] for k in (*moe_state, "x")}
        tol = REF_TOL
    else:
        want = _moe_one_process(moe_state, inputs["moe_x"], cfgs[cname], dp)
        tol = PORT_TOL
    e_loc = cfgs[cname].num_experts // n
    rows = MOE_B // dp
    for r in range(W):
        res = _result(ranks, r, tag)
        d, m = res["coords"]
        for k, g in res["grads"].items():
            w = want[k]
            if k in ("moe.wi_gate", "moe.wi_up", "moe.wo"):
                w = w[m * e_loc:(m + 1) * e_loc]
            elif k == "x":
                w = w[d * rows:(d + 1) * rows]
            _close(g, w, tol)


def test_expert_parallel_drops_entries_at_capacity_factor_half(grad_run):
    """The low capacity factor's cases hold dropped tokens: fewer kept
    entries than routed ones, so their gradients cover a dropping
    dispatch."""
    _, _, inputs, _, moe_state, _, cfgs = grad_run
    cfg = cfgs["dbrx_drop"]
    router = torch.tensor(moe_state["moe.router"])
    for dp in (1, 2):
        for xd in torch.tensor(inputs["moe_x"]).chunk(dp):
            xf = xd.reshape(-1, xd.shape[-1])
            eids, _, _ = moe_lib.route(router, xf, cfg)
            _, keep = moe_lib.dispatch(eids.reshape(-1), cfg.num_experts,
                                       moe_lib.capacity(xf.shape[0], cfg))
            assert int((~keep).sum()) > 0


# --------------------------------------------------------------------------- #
# context parallelism
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("oracle", ["jax", "one_process"])
@pytest.mark.parametrize("i", range(len(CP_CASES)))
def test_context_parallel_gradient(grad_run, i, oracle):
    """dq, dk and dv on every rank after the sum over the model axis:
    3e-4 of the reference's, 1e-5 of ``chunked_attention`` whole."""
    ranks, jax_out, _, cp_cases = grad_run[:4]
    c = cp_cases[i]
    if oracle == "jax":
        want, tol = {s: jax_out[f"cp{i}.{s}"] for s in "qkv"}, REF_TOL
    else:
        q, k, v = (torch.tensor(c[s], requires_grad=True) for s in "qkv")
        o = attn_lib.chunked_attention(q, k, v, True, c["q_offset"],
                                       q_chunk=c["q_chunk"],
                                       kv_chunk=c["kv_chunk"])
        (o * torch.from_numpy(c["c"])).sum().backward()
        want, tol = {"q": q.grad, "k": k.grad, "v": v.grad}, PORT_TOL
    for r in range(W):
        res = _result(ranks, r, f"cp{i}")
        for s in "qkv":
            _close(res[s], np.asarray(want[s]), tol)


# --------------------------------------------------------------------------- #
# the pipelines
# --------------------------------------------------------------------------- #
def _tanh_one_process(inputs: dict) -> dict:
    ws = torch.tensor(inputs["ws"], requires_grad=True)
    xs = torch.tensor(inputs["xs"], requires_grad=True)
    out = xs
    for i in range(4):
        out = torch.tanh(out @ ws[i])
    (out * torch.from_numpy(inputs["xs_c"])).sum().backward()
    return {"w": ws.grad.numpy(), "xs": xs.grad.numpy(),
            "out": out.detach().numpy()}


@pytest.mark.parametrize("oracle", ["jax", "one_process"])
def test_tanh_pipeline_gradient(grad_run, oracle):
    """Each stage's own w gradient, and the microbatches' gradient summed
    over the stages on every stage."""
    ranks, jax_out, inputs = grad_run[:3]
    if oracle == "jax":
        want = {"w": jax_out["pipe_tanh.w"], "xs": jax_out["pipe_tanh.xs"]}
        tol = REF_TOL
    else:
        want, tol = _tanh_one_process(inputs), PORT_TOL
    for r in range(W):
        res = _result(ranks, r, "pipe_tanh")
        _close(res["w"][0], want["w"][r], tol)
        _close(res["xs"], want["xs"], tol)


def _llama_one_process(inputs: dict, state: dict, cfg) -> dict:
    """The port's Blocks in order, one microbatch at a time, nothing of
    ``parallel/pipeline.py``: the gradient of the same loss, by port
    name (``ln1`` the first norm's scale, ``x`` the embeddings)."""
    L = cfg.num_layers
    blocks = []
    for i in range(L):
        blk = Block(cfg, torch.float32, "meta")
        for name, _ in list(blk.named_parameters()):
            mod, _, leaf = name.rpartition(".")
            setattr(blk.get_submodule(mod), leaf, torch.nn.Parameter(
                torch.tensor(state[f"layers.{i}.{name}"])))
        blocks.append(blk)
    final = torch.tensor(state["final_norm.scale"], requires_grad=True)
    nxts = [blocks[i + 1].ln1.scale for i in range(L - 1)] + [final]
    x = torch.tensor(inputs["emb"], requires_grad=True)
    from repro_torch.models.layers import rmsnorm
    positions = torch.arange(LM_S)[None, :]
    outs = []
    for mb in range(LM_M):
        h, xx = rmsnorm(blocks[0].ln1.scale, x[mb], cfg.norm_eps), x[mb]
        for i, blk in enumerate(blocks):
            h, xx = block_apply(blk, h, xx, positions, cfg, lambda w: w,
                                nxts[i], i)
        outs.append(torch.stack([h, xx]))
    (torch.stack(outs) * torch.from_numpy(inputs["emb_c"])).sum().backward()
    grads = {f"layers.{i}.{n}": p.grad.numpy()
             for i, blk in enumerate(blocks)
             for n, p in blk.named_parameters() if p.grad is not None}
    grads["final_norm.scale"] = final.grad.numpy()
    grads["x"] = x.grad.numpy()
    return grads


@pytest.mark.parametrize("oracle", ["jax", "one_process"])
def test_llama_pipeline_gradient(grad_run, oracle):
    """Each stage's block gradients (layer s·L/S + j's, its ``nxt`` the next
    layer's first norm or the final norm), and the embeddings' and first
    norm's gradients summed over the stages."""
    ranks, jax_out, inputs, _, _, llama, cfgs = grad_run
    cfg = cfgs["llama"]
    if oracle == "jax":
        tree: dict = {}
        for k, v in jax_out.items():
            if k.startswith("llama.") and k != "llama.x":
                node = tree
                *path, leaf = k.split(".")[1:]
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = v
        want = params_from_jax(tree)
        want["x"], tol = jax_out["llama.x"], REF_TOL
    else:
        want, tol = _llama_one_process(inputs, llama, cfg), PORT_TOL
    L, S = cfg.num_layers, 2
    per = L // S
    for r in range(S):
        res = _result(ranks, r, "pipe_llama")
        s, grads = res["stage"], res["grads"]
        assert s == r
        _close(grads["x"], want["x"], tol)
        _close(grads["ln1"], want["layers.0.ln1.scale"], tol)
        for name, g in grads.items():
            if name in ("x", "ln1"):
                continue
            for j in range(per):
                i = s * per + j
                key = (f"layers.{i}.{name}" if name != "nxt" else
                       f"layers.{i + 1}.ln1.scale" if i + 1 < L else
                       "final_norm.scale")
                _close(g[0, j], want[key], tol)


# --------------------------------------------------------------------------- #
# the hang drill on a backward
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("fault", HANG_FAULTS)
def test_backward_hang_drill_names_the_broken_link(grad_run, fault):
    """Rank f drops its sends from ring step 1 of the backward's
    reduce-scatter: the forward completed on every rank, the backward's
    progress each rank published from the daemon's hang callback (the
    frozen combine counters of its reduce-scatter, the steps of its
    all-gather) names link f -> f+1 through ``diagnose_ring`` and
    ``diagnose_hang``, the port's and the reference's."""
    ranks = grad_run[0]
    drills = [next(d for d in _result(ranks, r, "hang") if d["fault"] == fault)
              for r in range(W)]
    for d in drills:
        assert d["forward"] == [1] * (2 * (W - 1)), d
        assert d["reports"] >= 1 and d["error"] is not None, d
        assert d["steps"] == d["host_steps"] == d["steps_at_end"], d
        blocks = np.array(d["counters"])
        assert blocks.shape == (W - 1, 1), d
        done = min(d["steps"], W - 1)
        assert (blocks[:done] == 1).all() and (blocks[done:] == 0).all(), d
    progress = np.array([d["steps"] for d in drills])
    assert diagnose_ring(progress).link == (fault, (fault + 1) % W)
    stacks = {r: d["report"]["stack"] for r, d in enumerate(drills)}
    for diagnose in (diagnose_hang, jax_diagnose_hang):
        diag = diagnose(stacks, progress)
        assert diag.kind == "comm" and diag.used_inspector
        assert diag.link == (fault, (fault + 1) % W), (progress, diag)
