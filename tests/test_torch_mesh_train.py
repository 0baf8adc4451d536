"""The port's mesh training step (``make_train_step(model, cfg, mesh=)``,
ZeRO-sharded AdamW over the ring, ``optim/zero.py``) against the JAX
package's jitted mesh step and against the port's one-process step, on
the CPU.

The reference runs once, in a subprocess with 4 fake XLA devices
(``--xla_force_host_platform_device_count``): ``jax.jit`` of its
``make_train_step(model, run, mesh=make_test_mesh(2, 2))``, the model
built with ``constrain=MeshRules(mesh), mesh=mesh``, the parameters
placed under ``sanitize_specs(param_specs)`` and the moments under
``opt_state_specs`` of those, and writes an ``.npz``.  The port runs on 4
gloo CPU ranks (``run_ranks(device="cpu")``, bodies in
``tests/torch_mesh_train_ranks.py``), one spawn for the module.  Weights
are the JAX init's, carried by ``models/bridge.py::params_from_jax`` (the
vlm's gates opened); batches are numpy draws from a seed.  Each case runs
3 fp32 steps at a warm-up of 1, so step 0 updates the moments at lr 0 and
steps 1 and 2 the parameters at the peak.

* Each reduced arch (llama3.2-1b, mamba2-780m, zamba2-2.7b,
  llama-3.2-vision-11b and dbrx-132b with its experts parallel) at its
  dry-run policy's moment dtype and at float32: every step's loss and
  grad_norm, the parameters and the moments after the last step within
  3e-4 of the reference's and within 1e-5 of the one-process step's
  (dbrx's one-process step dispatches each data shard's tokens at that
  shard's capacity, the reference's expert parallelism).  Compressed
  moments round: a bf16 moment may differ by one ulp, an int8 code by one
  quantisation step, where a value sits on a rounding boundary; such
  elements, and the parameters they moved, are counted and held to few
  (``FEW``), the rest to the tolerance.  int8 moments are compared
  decoded, at the reference's default peak lr (3e-4: where a v code rounds
  to 0 the update is m / eps), after ``SETTLED`` steps (a flipped code
  moves a parameter ~1e-5 in step 1, which flips the reduced dbrx's
  routing of a token in step 2), every step's metrics to 3e-4.
* The microbatch layout: at capacity factor 0.5 dbrx drops tokens, and
  the rank-first split (a rank's block of the batch, then its chunks)
  gives another loss than the reference's microbatch-first one.
* Each rank's resident optimizer bytes equal the reference device's
  shard bytes (layer-axis ZeRO included), and int8's scales where the
  ZeRO cut splits a 256-block on the last axis equal the reference's.
  The one-process step's int8 moments of 0-d parameters (the vlm's
  per-layer gates) are encoded as the reference's stacked leaf.
* The hang drill: rank f drops its sends from ring step 1 of step 1's
  first gradient reduce-scatter; that collective's own progress, read in
  the daemon's hang callback, names link f -> f+1.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.core.hang import diagnose_hang as jax_diagnose_hang
from repro.models.registry import build_model as jax_build_model
from repro_torch.core.hang import diagnose_hang
from repro_torch.core.inspecting import diagnose_ring
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import moe as moe_lib
from repro_torch.models.bridge import params_from_jax
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import QBLOCK, adamw_init
from repro_torch.parallel import sharding as sh
from repro_torch.runtime.train import make_train_step
from torch_mesh_train_ranks import (B, CASES, HANG_FAULTS, LAYOUT_CASE, MESH,
                                    S, SETTLED, STEPS, W, batches,
                                    mesh_train_rank, model_config,
                                    rank_first, run_config)

ROOT = Path(__file__).resolve().parents[1]
REF_TOL = 3e-4     # the reference's jitted mesh step
PORT_TOL = 1e-5    # the port's one-process step
FEW = 1e-3         # at most this share of a compressed case's elements off
SEEDS = {"llama3.2-1b": 1, "mamba2-780m": 2, "zamba2-2.7b": 3,
         "llama-3.2-vision-11b": 4, "dbrx-132b": 5}
VLM_GATES = {"gate": 0.5, "gate_mlp": -0.7}

_JAX_STEPS = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_cpu_multi_thread_eigen=false")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_reduced, scale
    from repro.launch.mesh import make_test_mesh
    from repro.models.registry import build_model
    from repro.optim.adamw import AdamWConfig, adamw_init, opt_state_specs
    from repro.parallel.sharding import (MeshRules, named, param_specs,
                                         sanitize_specs)
    from repro.runtime.train import RunConfig, make_train_step

    inp = dict(np.load(sys.argv[1]))
    B, S, steps, warmup = (int(inp["B"]), int(inp["S"]),
                           int(inp["steps"]), int(inp["warmup"]))
    mesh = make_test_mesh(2, 2)
    devices = list(mesh.devices.flat)
    out = {}

    def nest(prefix):
        tree = {}
        for k, v in inp.items():
            if not k.startswith(prefix):
                continue
            node = tree
            *path, leaf = k[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(v)
        return tree

    def flat(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                flat(v, prefix + k + "/")
            else:
                v = np.asarray(v)
                out[prefix + k] = (v.astype(np.float32)
                                   if v.dtype.name == "bfloat16" else v)

    for tag in str(inp["tags"]).split(","):
        arch, opt = str(inp[tag + "|arch"]), str(inp[tag + "|opt"])
        m, cf = int(inp[tag + "|M"]), float(inp[tag + "|cf"])
        lr = float(inp[tag + "|lr"])
        cfg = get_reduced(arch)
        if cf > 0:
            cfg = scale(cfg, capacity_factor=cf)
        run = RunConfig(model=cfg, global_batch=B, seq_len=S,
                        num_microbatches=m, steps=10, warmup_steps=warmup,
                        peak_lr=lr, opt=AdamWConfig(state_dtype=opt),
                        param_dtype="float32", compute_dtype="float32")
        model = build_model(cfg, policy=run.policy(),
                            constrain=MeshRules(mesh), mesh=mesh)
        params = nest(tag + "|p|")
        pspecs = sanitize_specs(param_specs(params), params, mesh)
        ospecs = opt_state_specs(pspecs, params, mesh, run.opt)
        state = adamw_init(params, run.opt)
        params = jax.device_put(params, named(mesh, pspecs))
        state = jax.device_put(state, named(mesh, ospecs))
        step = jax.jit(make_train_step(model, run, mesh=mesh),
                       out_shardings=(named(mesh, pspecs),
                                      named(mesh, ospecs), None))
        dp = NamedSharding(mesh, P("data"))
        metrics = []
        for s in range(steps):
            batch = {k.split("|")[-1]: jax.device_put(jnp.asarray(v), dp)
                     for k, v in inp.items()
                     if k.startswith(f"{tag}|b{s}|")}
            params, state, met = step(params, state, batch, jnp.int32(s))
            metrics.append([float(met["loss"]), float(met["grad_norm"]),
                            float(met["lr"])])
            if s == int(inp["settled"]) - 1 and opt == "int8":
                flat(jax.tree.map(np.asarray, params), tag + "|p1|")
                flat(jax.tree.map(np.asarray, state["mu_nu"]), tag + "|o1|")
        out[tag + "|metrics"] = np.array(metrics)
        flat(jax.tree.map(np.asarray, params), tag + "|p|")
        flat(jax.tree.map(np.asarray, state["mu_nu"]), tag + "|o|")
        out[tag + "|count"] = np.asarray(state["count"])
        nbytes = [0] * len(devices)
        for leaf in jax.tree.leaves(state["mu_nu"]):
            for sh in leaf.addressable_shards:
                nbytes[devices.index(sh.device)] += sh.data.nbytes
        out[tag + "|device_bytes"] = np.array(nbytes)
        if tag == str(inp["layout"]):
            step = jax.jit(make_train_step(model, run, mesh=mesh))
            p0 = jax.device_put(nest(tag + "|p|"), named(mesh, pspecs))
            s0 = jax.device_put(adamw_init(p0, run.opt), named(mesh, ospecs))
            batch = {k.split("|")[-1]: jax.device_put(jnp.asarray(v), dp)
                     for k, v in inp.items() if k.startswith(f"{tag}|rf|")}
            met = step(p0, s0, batch, jnp.int32(0))[2]
            out[tag + "|rank_first"] = np.array(
                [float(met["loss"]), float(met["grad_norm"])])
    np.savez(sys.argv[2], **out)
""")


def _jax_params(arch: str) -> dict:
    """The JAX init of the reduced arch (numpy), the vlm's gates open."""
    tree = jax.tree.map(np.asarray, jax_build_model(
        jax_get_reduced(arch)).init(jax.random.PRNGKey(SEEDS[arch])))
    if "cross" in tree:
        g = tree["cross"]["gate_mlp"].shape[0]
        tree["cross"]["attn"]["gate"] = np.full(
            (g,), VLM_GATES["gate"], np.float32)
        tree["cross"]["gate_mlp"] = np.full(
            (g,), VLM_GATES["gate_mlp"], np.float32)
    return tree


def _flat(tree: dict, prefix: str, out: dict):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(v, prefix + k + "/", out)
        else:
            out[prefix + k] = np.asarray(v)


def _nest(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        node = tree
        *path, leaf = k[len(prefix):].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _one_process_moe(mesh_dp: int):
    """``moe_apply`` in one process with the reference's expert
    parallelism on ``mesh_dp`` data shards: the routing and aux loss of
    the whole batch, each shard's tokens dispatched to all experts at the
    shard's capacity."""
    def moe_apply(moe, x, cfg, w, mesh=None, model_axis="model"):
        Bx, Sx, D = x.shape
        xf = x.reshape(Bx * Sx, D)
        eids, weights, aux = moe_lib.route(w(moe.router), xf, cfg)
        rows = xf.shape[0] // mesh_dp
        cap = moe_lib.capacity(rows, cfg)
        ys = [moe_lib.expert_ff_local(
            xf[d * rows:(d + 1) * rows], eids[d * rows:(d + 1) * rows],
            weights[d * rows:(d + 1) * rows], w(moe.wi_gate),
            w(moe.wi_up), w(moe.wo), 0, cap) for d in range(mesh_dp)]
        return torch.cat(ys).view(Bx, Sx, D), aux
    return moe_apply


def _snapshot(model, opt) -> dict:
    return dict(params={n: p.detach().numpy().copy() for n, p in
                        model.named_parameters()},
                state={n: {k: ({f: t.numpy().copy() for f, t in v.items()}
                               if isinstance(v, dict)
                               else v.float().numpy().copy())
                           for k, v in s.items()}
                       for n, s in opt["mu_nu"].items()})


def _one_process(tag: str, state: dict) -> dict:
    """The port's one-process step on the global batches: each step's
    metrics, the parameters and the moments (by port name) after them
    (int8: also after ``SETTLED`` steps)."""
    cfg = model_config(tag)
    run = run_config(tag, cfg)
    model = build_model(cfg, run.policy(), "cpu")
    model.load_params(state)
    step = make_train_step(model, run)
    opt = adamw_init(dict(model.named_parameters()), run.opt)
    orig = moe_lib.moe_apply
    if cfg.num_experts:
        moe_lib.moe_apply = _one_process_moe(MESH[0])
    out = {}
    try:
        metrics = []
        for s, b in enumerate(batches(tag)):
            opt, m = step(opt, {k: torch.from_numpy(v) for k, v in
                                b.items()}, s)
            metrics.append((float(m["loss"]), float(m["grad_norm"]),
                            float(m["lr"])))
            if s == SETTLED - 1 and run.opt.state_dtype == "int8":
                out["settled"] = _snapshot(model, opt)
    finally:
        moe_lib.moe_apply = orig
    return dict(out, metrics=np.array(metrics), **_snapshot(model, opt))


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """(the ranks' results, the reference's outputs, the port states by
    arch): the JAX subprocess runs while the 4 ranks do."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    trees = {arch: _jax_params(arch) for arch in SEEDS}
    states = {arch: params_from_jax(t) for arch, t in trees.items()}
    inp = dict(B=np.array(B), S=np.array(S), steps=np.array(STEPS),
               warmup=np.array(run_config("llama3.2-1b").warmup_steps),
               tags=np.array(",".join(CASES)), layout=np.array(LAYOUT_CASE),
               settled=np.array(SETTLED))
    for tag, (arch, opt, m, cf) in CASES.items():
        inp.update({f"{tag}|arch": np.array(arch), f"{tag}|opt": np.array(opt),
                    f"{tag}|M": np.array(m), f"{tag}|cf": np.array(cf or 0.0),
                    f"{tag}|lr": np.array(run_config(tag).peak_lr)})
        _flat(trees[arch], f"{tag}|p|", inp)
        for s, b in enumerate(batches(tag)):
            inp.update({f"{tag}|b{s}|{k}": v for k, v in b.items()})
    for k, v in rank_first(batches(LAYOUT_CASE)[0], MESH[0],
                           CASES[LAYOUT_CASE][2]).items():
        inp[f"{LAYOUT_CASE}|rf|{k}"] = v
    np.savez(tmp / "inputs.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_STEPS, str(tmp / "inputs.npz"),
         str(tmp / "jax.npz")], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        ranks = run_ranks(mesh_train_rank, W, states, device="cpu",
                          timeout=240.0)
        log, _ = jax_proc.communicate(timeout=300)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0, log
    return ranks, dict(np.load(tmp / "jax.npz")), states


@pytest.fixture(scope="module")
def one_process(mesh_run):
    states = mesh_run[2]
    return {tag: _one_process(tag, states[arch])
            for tag, (arch, *_) in CASES.items()}


def _result(ranks, r: int, tag: str):
    res = ranks[r][tag]
    assert not (isinstance(res, dict) and "error" in res), res.get("error")
    return res


def _off(got, want, tol) -> np.ndarray:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want) > tol + tol * np.abs(want)


def _whole_params(got: list, res: list) -> dict:
    """The parameters whole from every rank's (``got[r]["params"]``, rank
    r's coordinates in ``res[r]``): a rank's own where it holds them
    whole, the expert weights put together from the model ranks' blocks
    (data rank 0's)."""
    out = dict(got[0]["params"])
    for n in out:
        if n.rsplit(".", 1)[-1] in moe_lib.EXPERT_WEIGHTS and ".moe." in n:
            blocks = sorted((x["coords"][1], g["params"][n])
                            for g, x in zip(got, res)
                            if x["coords"][0] == 0)
            out[n] = np.concatenate([b for _, b in blocks])
    return out


def _stacked(leaves: dict, per_name: dict) -> dict:
    """{leaf: {moment: stacked array}} of a per-name state (the one-process
    step's), in each leaf's stacked order."""
    out = {}
    for leaf, info in leaves.items():
        shape = tuple(info["shape"])

        def stack(key, field=None):
            parts = [per_name[n][key] if field is None
                     else per_name[n][key][field] for n in info["names"]]
            a = np.stack(parts)
            if field == "scale":
                return a.reshape(shape[:-1] + (a.shape[-1],))
            return a.reshape(shape)
        out[leaf] = {k: ({"q": stack(k, "q"), "scale": stack(k, "scale")}
                         if isinstance(per_name[info["names"][0]][k], dict)
                         else stack(k)) for k in ("m", "v")}
    return out


def _decode(s: dict) -> np.ndarray:
    """``_q_dec`` of whole stacked codes and scales, in numpy."""
    q, scale = s["q"].astype(np.float32), s["scale"]
    cols = np.arange(q.shape[-1]) // QBLOCK
    return q * scale[..., cols]


def _check(tag: str, got: dict, want: dict, tol: float, counted: bool,
           what: str) -> dict:
    """Every tensor of ``got`` within ``tol`` of ``want``; with compressed
    moments (``counted``) the elements off are counted instead, and
    returned."""
    off = total = 0
    for k, w in want.items():
        g = got[k]
        assert np.shape(g) == np.shape(w), (tag, what, k)
        bad = _off(g, w, tol)
        if not counted:
            assert not bad.any(), (
                f"{tag} {what} {k}: {int(bad.sum())} of {bad.size} off, max "
                f"{float(np.abs(np.asarray(g, np.float64) - w).max()):.3e}")
        off += int(bad.sum())
        total += bad.size
    return dict(off=off, total=total)


def _moments(tag: str, state: dict, int8: bool) -> dict:
    """{leaf/moment: array} of whole stacked moments, int8 decoded."""
    return {f"{leaf}/{k}": (_decode(v) if int8 else np.asarray(v, np.float32))
            for leaf, s in state.items() for k, v in s.items()}


def _ref_state(jax_out: dict, tag: str, leaves: dict, pre: str) -> dict:
    mu = _nest(jax_out, f"{tag}{pre}")
    out = {}
    for leaf in leaves:
        node = mu
        for p in leaf.split("/"):
            node = node[p]
        out[leaf] = node
    return out


def _codes_apart(got: dict, want: dict) -> tuple:
    """(codes that differ, the largest difference) over every int8
    moment."""
    n, top = 0, 0
    for leaf, s in want.items():
        for k in ("m", "v"):
            d = np.abs(got[leaf][k]["q"].astype(np.int32)
                       - s[k]["q"].astype(np.int32))
            n += int((d > 0).sum())
            top = max(top, int(d.max()))
    return n, top


# --------------------------------------------------------------------------- #
# the steps against the reference and the one-process step
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("oracle", ["jax", "one_process"])
@pytest.mark.parametrize("tag", list(CASES))
def test_mesh_step_matches(mesh_run, one_process, tag, oracle):
    """Every step's loss, grad_norm and lr on every rank, the parameters
    and the moments after the last step: within 3e-4 of the reference's
    jitted mesh step, within 1e-5 of the one-process step.  With int8
    moments the codes are at most one quantisation step apart and the
    elements off are few."""
    ranks, jax_out = mesh_run[:2]
    arch, opt, _, _ = CASES[tag]
    int8 = opt == "int8"
    counted = opt != "float32"
    res = [_result(ranks, r, tag) for r in range(W)]
    leaves = res[0]["leaves"]
    held = SETTLED if int8 else STEPS     # steps before the comparison
    pre = "|p1|" if int8 else "|p|"
    if oracle == "jax":
        tol = REF_TOL
        want_m = jax_out[f"{tag}|metrics"]
        want_p = params_from_jax(_nest(jax_out, f"{tag}{pre}"))
        want_s = _ref_state(jax_out, tag, leaves, "|o1|" if int8 else "|o|")
        assert int(jax_out[f"{tag}|count"]) == STEPS
    else:
        tol = PORT_TOL
        ref = one_process[tag]
        want_m = ref["metrics"]
        ref = ref["settled"] if int8 else ref
        want_p, want_s = ref["params"], _stacked(leaves, ref["state"])
    for x in res:
        assert x["count"] == STEPS
        got_m = np.array(x["metrics"])
        assert not _off(got_m[:held], want_m[:held], tol).any(), (got_m,
                                                                  want_m)
        assert not _off(got_m, want_m, REF_TOL).any(), (got_m, want_m)
        if oracle == "one_process":
            assert [m[2] for m in x["metrics"]] == [float(v) for v in
                                                    want_m[:, 2]]
    got = [x["settled"] if int8 else x for x in res]
    counts = _check(tag, _whole_params(got, res), want_p, tol, counted,
                    "parameters")
    got_s = got[0]["state"]
    counts_s = _check(tag, _moments(tag, got_s, int8),
                      _moments(tag, want_s, int8), tol, counted, "moments")
    if int8:
        apart, top = _codes_apart(got_s, want_s)
        codes = sum(s[k]["q"].size for s in want_s.values() for k in "mv")
        assert top <= 1, f"{tag}: codes {top} steps apart"
        assert apart <= FEW * codes, (apart, codes)
    if counted:
        for c in (counts, counts_s):
            assert c["off"] <= FEW * c["total"], (tag, counts, counts_s)


def test_int8_codes_are_the_whole_tensors_where_zero_splits_a_block(
        mesh_run, one_process):
    """dbrx's int8 case holds leaves whose ZeRO cut falls on the last axis
    at a width that is not a multiple of 256 (the final norm's d 64 over
    data 2, the embedding's d over data): their scales after the steps are
    one a 256-block of the whole tensor, the reference's, and equal to
    the one-process step's."""
    ranks, jax_out = mesh_run[:2]
    tag = "dbrx-132b"
    res = _result(ranks, 0, tag)
    state = res["settled"]["state"]
    mesh = {"data": MESH[0], "model": MESH[1]}
    split = []
    for leaf, info in res["leaves"].items():
        e = info["spec"][-1]
        if e is None:
            continue
        parts = int(np.prod([mesh[a] for a in sh._names(e)]))
        if (info["shape"][-1] // parts) % QBLOCK:
            split.append(leaf)
    assert {"final_norm/scale", "embed/embedding"} <= set(split), split
    want = _ref_state(jax_out, tag, res["leaves"], "|o1|")
    one = _stacked(res["leaves"], one_process[tag]["settled"]["state"])
    for leaf in split:
        for k in ("m", "v"):
            got = state[leaf][k]
            nb = -(-res["leaves"][leaf]["shape"][-1] // QBLOCK)
            assert got["scale"].shape[-1] == nb
            np.testing.assert_allclose(got["scale"], want[leaf][k]["scale"],
                                       rtol=REF_TOL, atol=1e-12)
            np.testing.assert_allclose(got["scale"], one[leaf][k]["scale"],
                                       rtol=PORT_TOL, atol=1e-12)


@pytest.mark.parametrize("steps", [1, 3])
def test_one_process_int8_scalars_quantise_as_the_stacked_leaf(steps):
    """The vlm's per-layer gates are 0-d parameters that the reference
    stacks into one [n_cross] leaf, so their int8 moments share one absmax
    a 256-block.  The port's one-process ``adamw_update`` on two layers'
    gates is held to the reference's on the stacked leaves.  Codes must be
    equal; scales and parameters must agree within 1e-6.  In step 0 the
    first moments stand 10 : 3, so layer 1's m codes 38 of layer 0's
    127, where a scale a layer would code it 127."""
    from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
    from repro.optim.adamw import adamw_init as jax_adamw_init
    from repro.optim.adamw import adamw_update as jax_adamw_update
    from repro_torch.optim.adamw import AdamWConfig, adamw_update

    leaves = ("attn.gate", "gate_mlp")
    rng = np.random.default_rng(37)
    p0 = {leaf: np.array([0.5, -0.2], np.float32) for leaf in leaves}
    grads = [{"attn.gate": np.array([0.1, 0.03], np.float32),
              "gate_mlp": np.array([-0.05, 0.02], np.float32)}]
    grads += [{leaf: (rng.standard_normal(2) * 0.05).astype(np.float32)
               for leaf in leaves} for _ in range(steps - 1)]
    jcfg, tcfg = JaxAdamWConfig(state_dtype="int8"), \
        AdamWConfig(state_dtype="int8")
    jp = {leaf: jax.numpy.asarray(v) for leaf, v in p0.items()}
    js = jax_adamw_init(jp, jcfg)
    tp = {f"cross.{i}.{leaf}": torch.tensor(float(p0[leaf][i]))
          for i in range(2) for leaf in leaves}
    ts = adamw_init(tp, tcfg)
    for s, g in enumerate(grads):
        lr = 1e-2 * (s + 1)
        jp, js, _ = jax_adamw_update(
            {leaf: jax.numpy.asarray(v) for leaf, v in g.items()}, js, jp,
            jcfg, jax.numpy.float32(lr))
        adamw_update({f"cross.{i}.{leaf}": torch.tensor(float(g[leaf][i]))
                      for i in range(2) for leaf in leaves}, ts, tp, tcfg,
                     lr)
        if s == 0:
            assert list(np.asarray(js["mu_nu"]["attn.gate"]["m"]["q"])) \
                == [127, 38]
    for leaf in leaves:
        for i in range(2):
            name = f"cross.{i}.{leaf}"
            np.testing.assert_allclose(float(tp[name]),
                                       float(jp[leaf][i]), rtol=1e-6,
                                       atol=1e-6, err_msg=name)
            for k in ("m", "v"):
                got, want = ts["mu_nu"][name][k], js["mu_nu"][leaf][k]
                assert int(got["q"][0]) == int(want["q"][i]), (name, k)
                np.testing.assert_allclose(
                    float(got["scale"][0]), float(want["scale"][0]),
                    rtol=1e-6, atol=0, err_msg=f"{name} {k}")


# --------------------------------------------------------------------------- #
# the microbatch layout
# --------------------------------------------------------------------------- #
def test_rank_first_microbatches_give_another_loss(mesh_run):
    """At capacity factor 0.5 the reduced dbrx drops entries (its
    dispatches keep fewer than they are given, in both layouts' step 0).
    Splitting the batch into microbatches first and handing each rank its
    rows of each (the reference's layout) gives the reference's step-0
    loss and grad_norm within 1e-5; taking each rank's block of the batch
    first and chunking it gives another loss, farther from the
    reference's than that, and the reference gives the same other loss
    for the reordered batch."""
    ranks, jax_out = mesh_run[:2]
    tag = LAYOUT_CASE
    want = jax_out[f"{tag}|metrics"][0, :2]
    want_rf = jax_out[f"{tag}|rank_first"]
    for r in range(W):
        res = _result(ranks, r, tag)
        assert res["dropped"] > 0 and res["dropped_rank_first"] > 0, res
        got, got_rf = np.array(res["metrics"][0][:2]), np.array(
            res["rank_first"])
        assert not _off(got, want, PORT_TOL).any(), (got, want)
        assert not _off(got_rf, want_rf, PORT_TOL).any(), (got_rf, want_rf)
        # the rank-first loss misses the reference's by more than the
        # tolerance the microbatch-first one meets
        assert _off(got_rf[0], want[0], PORT_TOL), (got, got_rf, want)


# --------------------------------------------------------------------------- #
# resident optimizer state
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("tag", list(CASES))
def test_resident_optimizer_bytes_are_the_reference_shards(mesh_run, tag):
    """Between steps each rank holds exactly its blocks of m and v (codes
    and scales for int8): the bytes of the reference device at its mesh
    coordinates, and no whole moment (below half of the whole state).  llama3.2-1b, zamba2 and dbrx put
    ZeRO's data axis on the stacked layer axis."""
    ranks, jax_out = mesh_run[:2]
    device_bytes = jax_out[f"{tag}|device_bytes"]
    state = _result(ranks, 0, tag)["state"]
    whole = sum(np.asarray(t).nbytes for s in state.values()
                for v in s.values()
                for t in (v.values() if isinstance(v, dict) else [v]))
    for x in [_result(ranks, r, tag) for r in range(W)]:
        r = x["coords"][0] * MESH[1] + x["coords"][1]
        assert x["resident"] == x["resident_end"] \
            == int(device_bytes[r]), (x["resident"], device_bytes)
        assert x["resident"] < whole / 2
    if tag in ("llama3.2-1b", "zamba2-2.7b", "dbrx-132b"):
        leaves = _result(ranks, 0, tag)["leaves"]
        assert any(info["spec"][0] == "data" and len(info["names"]) > 1
                   for info in leaves.values()), leaves


# --------------------------------------------------------------------------- #
# the hang drill in the mesh step
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("fault", HANG_FAULTS)
def test_mesh_step_hang_drill_names_the_broken_link(mesh_run, fault):
    """Rank f drops its sends from ring step 1 of step 1's first gradient
    reduce-scatter (the embedding's, over the data axis of a (4, 1)
    mesh): that collective's progress, published from the daemon's hang
    callback (its combine counters' complete rows), names link f -> f+1
    through ``diagnose_ring`` and ``diagnose_hang``, the port's and the
    reference's."""
    ranks = mesh_run[0]
    drills = [next(d for d in _result(ranks, r, "hang")
                   if d["fault"] == fault) for r in range(W)]
    for d in drills:
        assert d["reports"] >= 1 and d["error"] is not None, d
        assert d["leaf"] == d["first_leaf"] == "embed/embedding", d
        assert d["axis"] == "data", d
        assert d["steps"] == d["host_steps"] == d["steps_at_end"], d
        assert np.array(d["counters"]).shape[0] == W - 1, d
    progress = np.array([d["steps"] for d in drills])
    assert diagnose_ring(progress).link == (fault, (fault + 1) % W)
    stacks = {r: d["report"]["stack"] for r, d in enumerate(drills)}
    for diagnose in (diagnose_hang, jax_diagnose_hang):
        diag = diagnose(stacks, progress)
        assert diag.kind == "comm" and diag.used_inspector
        assert diag.link == (fault, (fault + 1) % W), (progress, diag)


def test_make_train_step_takes_the_mesh_path_only_with_a_mesh():
    """``make_train_step`` without a mesh takes no ZeRO path: its step has
    no ``zero``; with one it refuses the dry-run's ``grads=`` and
    ``update=`` hooks, and a moe model built without that mesh (whose
    experts would be whole and whose aux loss would be its shard's)."""
    from repro_torch.parallel.mesh import Mesh
    cfg = model_config("llama3.2-1b")
    run = run_config("llama3.2-1b", cfg)
    model = build_model(cfg, run.policy(), "cpu")
    assert not hasattr(make_train_step(model, run), "zero")
    with pytest.raises(ValueError, match="grads= or update="):
        make_train_step(model, run, grads=lambda *a: None, mesh=object())
    cfg = model_config("dbrx-132b")
    with pytest.raises(ValueError, match="moe model with the step's mesh"):
        make_train_step(build_model(cfg, device="cpu"),
                        run_config("dbrx-132b", cfg),
                        mesh=Mesh(MESH, ("data", "model")))
