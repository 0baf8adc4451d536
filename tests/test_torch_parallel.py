"""The port's parallel plane (``parallel/pipeline.py``, expert
parallelism in ``models/moe.py``, on ``launch/mesh.py``'s meshes) against
the JAX package's, on the CPU.

The reference runs once, in a subprocess with 8 fake XLA devices
(``--xla_force_host_platform_device_count``, so this process keeps one),
and writes an ``.npz``; the port runs on 8 gloo CPU ranks
(``run_ranks(device="cpu")``), one spawn for the module.  Inputs are numpy
draws from a seed; weights are the JAX init's, carried by
``models/bridge.py::params_from_jax``.

* (a) ``tests/test_multidevice.py``'s pipeline, tanh(x·w), S 4, M 8, mb
  4, width 16, fp32: within the reference's 2e-5;
* (b) a 2-stage pipeline of the reduced llama's blocks (the (h, x) pair
  packed as one tensor): equal (``torch.equal``) to the same blocks
  applied in order, one microbatch at a time, and within 3e-4 of the
  reference's layers (``TransformerLM._self_block`` and its final norm);
* (c) ``moe_apply`` of the reduced dbrx on the reference's
  ``make_test_mesh(data=2, model=4)`` against the port's 8 ranks on the
  same layout, at the config's capacity factor and at 0.5 (tokens dropped),
  and on a (1, 4) mesh: y and the aux loss within the reference's 2e-4,
  fp32;
* (d) the reduced dbrx ``TransformerLM`` built with that (2, 4) mesh
  (``build_model(cfg, mesh=)``, the experts cut by ``shard_experts``) on
  each rank's data shard of the tokens: its logits and aux loss within
  3e-4 of the reference model's with the same mesh under ``jit``, fp32.
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
from repro.models import layers as JL
from repro.models.moe import moe_init
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import get_reduced, scale
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import moe
from repro_torch.models.bridge import params_from_jax
from repro_torch.parallel.pipeline import bubble_share
from torch_parallel_ranks import parallel_rank

ROOT = Path(__file__).resolve().parents[1]
W = 8
M, MB, WIDTH = 8, 4, 16            # (a)
LM_M, LM_MB, LM_S = 4, 2, 8        # (b)
MOE_B, MOE_S = 4, 8                # (c), (d)
LM_SEED = 7                        # (d)
DROP_CF = 0.5

_JAX_PARALLEL = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_reduced, scale
    from repro.launch.mesh import _mk, make_test_mesh
    from repro.models import build_model, layers as L
    from repro.models.moe import moe_apply
    from repro.parallel.pipeline import pipeline_apply

    inp = dict(np.load(sys.argv[1]))
    out = {}
    pmesh = _mk((4,), ("stage",))
    out["pipe_tanh"] = np.asarray(pipeline_apply(
        lambda w, x: jnp.tanh(x @ w), jnp.asarray(inp["ws"]),
        jnp.asarray(inp["xs"]), pmesh, axis="stage"))
    params = {k.split(".", 1)[1]: jnp.asarray(v) for k, v in inp.items()
              if k.startswith("moe.")}
    x = jnp.asarray(inp["moe_x"])
    cfg = get_reduced("dbrx-132b")
    for tag, c, mesh in (
            ("ep24", cfg, make_test_mesh(data=2, model=4)),
            ("ep24_drop", scale(cfg, capacity_factor=float(sys.argv[3])),
             make_test_mesh(data=2, model=4)),
            ("ep14", cfg, make_test_mesh(data=1, model=4))):
        y, aux = jax.jit(lambda p, v: moe_apply(p, v, c, mesh=mesh))(
            params, x)
        out[tag + "_y"], out[tag + "_aux"] = np.asarray(y), np.asarray(aux)
        dp = mesh.shape["data"]
        out[tag + "_local"] = np.concatenate([np.asarray(moe_apply(
            params, xs, c, mesh=None)[0]) for xs in jnp.split(x, dp)])
    lm = build_model(cfg, policy=L.Policy(jnp.float32, jnp.float32),
                     mesh=make_test_mesh(data=2, model=4))
    lm_params = lm.init(jax.random.PRNGKey(int(sys.argv[4])))
    logits, aux = jax.jit(lm.apply)(lm_params, jnp.asarray(inp["lm_tokens"]))
    out["lm24_logits"], out["lm24_aux"] = np.asarray(logits), np.asarray(aux)
    np.savez(sys.argv[2], **out)
""")


def _setup():
    """(inputs, the reduced llama's port state and JAX params, the MoE's
    state, the reduced dbrx model's port state, the configs)."""
    rng = np.random.default_rng(33)
    f32 = np.float32
    lcfg = jax_get_reduced("llama3.2-1b")
    params = jax_build_model(lcfg).init(jax.random.PRNGKey(5))
    dcfg = jax_get_reduced("dbrx-132b")
    moe = jax.tree.map(np.asarray, moe_init(jax.random.PRNGKey(2), dcfg,
                                            jnp.float32))
    inputs = {"ws": (0.5 * rng.standard_normal((4, WIDTH, WIDTH))).astype(
                  f32),
              "xs": rng.standard_normal((M, MB, WIDTH)).astype(f32),
              "emb": rng.standard_normal(
                  (LM_M, LM_MB, LM_S, lcfg.d_model)).astype(f32),
              "moe_x": rng.standard_normal(
                  (MOE_B, MOE_S, dcfg.d_model)).astype(f32),
              "lm_tokens": rng.integers(0, dcfg.vocab_size,
                                        (MOE_B, MOE_S)).astype(np.int64)}
    lm = jax_build_model(dcfg, policy=JL.Policy(jnp.float32, jnp.float32))
    lm_state = params_from_jax(jax.tree.map(
        np.asarray, lm.init(jax.random.PRNGKey(LM_SEED))))
    moe_state = {f"moe.{k}": v for k, v in moe.items()}
    cfg = get_reduced("dbrx-132b")
    cfgs = {"llama": get_reduced("llama3.2-1b"), "dbrx": cfg,
            "dbrx_drop": scale(cfg, capacity_factor=DROP_CF)}
    llama = params_from_jax(jax.tree.map(np.asarray, params))
    return inputs, llama, params, moe_state, lm_state, cfgs


@pytest.fixture(scope="module")
def parallel_run(tmp_path_factory):
    """(port results per rank, JAX results, inputs, JAX llama params): the
    JAX subprocess runs while the 8 ranks do."""
    tmp = tmp_path_factory.mktemp("parallel")
    inputs, llama, params, moe_state, lm_state, cfgs = _setup()
    np.savez(tmp / "inputs.npz", **inputs, **moe_state)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_PARALLEL, str(tmp / "inputs.npz"),
         str(tmp / "jax.npz"), str(DROP_CF), str(LM_SEED)], env=env,
        cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ranks = run_ranks(parallel_rank, W, inputs, llama, moe_state,
                          lm_state, cfgs, device="cpu", timeout=150.0)
        log, _ = jax_proc.communicate(timeout=300)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0, log
    return ranks, dict(np.load(tmp / "jax.npz")), inputs, params


def test_bubble_share():
    assert bubble_share(4, 8) == 3 / 11
    assert bubble_share(1, 5) == 0


def test_tanh_pipeline_equals_the_reference(parallel_run):
    """(a) every stage returns the last stage's outputs, within the
    reference's 2e-5 of its pipeline and of the sequential product."""
    ranks, want, inputs, _ = parallel_run
    ref = inputs["xs"]
    for i in range(4):
        ref = np.tanh(ref @ inputs["ws"][i])
    for r in range(4):
        got = ranks[r]["pipe_tanh"]
        np.testing.assert_allclose(got, want["pipe_tanh"], rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    assert all("pipe_tanh" not in ranks[r] for r in range(4, W))


def test_llama_pipeline_equals_its_blocks_in_order(parallel_run):
    """(b) the 2-stage pipeline's (h, x) pairs are the blocks' applied in
    order, one microbatch at a time, bit for bit, on both stages."""
    ranks, _, _, _ = parallel_run
    seq = ranks[0]["seq_llama"]
    assert seq.shape == (LM_M, 2, LM_MB, LM_S, 64)
    for r in range(2):
        np.testing.assert_array_equal(ranks[r]["pipe_llama"], seq)


def test_llama_pipeline_equals_the_reference_layers(parallel_run):
    """(b) against the reference's two layers and its final norm, 3e-4."""
    ranks, _, inputs, params = parallel_run
    cfg = jax_get_reduced("llama3.2-1b")
    model = jax_build_model(cfg)
    got = ranks[0]["pipe_llama"]
    positions = jnp.arange(LM_S)[None, :]
    for m in range(LM_M):
        x = jnp.asarray(inputs["emb"][m])
        for i in range(cfg.num_layers):
            lp = jax.tree.map(lambda a: a[i], params["layers"])
            x = model._self_block(lp, x, positions)[0]
        h = JL.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        np.testing.assert_allclose(got[m, 1], np.asarray(x), rtol=3e-4,
                                   atol=3e-4)
        np.testing.assert_allclose(got[m, 0], np.asarray(h), rtol=3e-4,
                                   atol=3e-4)


@pytest.mark.parametrize("tag,ranks_in,dp", [
    ("ep24", 8, 2), ("ep24_drop", 8, 2), ("ep14", 4, 1)])
def test_expert_parallel_moe_equals_the_reference(parallel_run, tag,
                                                  ranks_in, dp):
    """(c) each rank's y, its data shard's, and the aux loss within the
    reference's 2e-4 of the reference's ``moe_apply`` on the same mesh
    (and of its local path on each data shard's tokens); each rank held E
    / 4 experts.  At capacity factor 0.5 the data shards drop tokens, so
    a wrong drop would show."""
    ranks, want, inputs, _ = parallel_run
    rows = MOE_B // dp
    for r in range(W):
        res = ranks[r].get(tag)
        if r >= ranks_in:
            assert res is None
            continue
        d = res["coords"][0]
        assert res["experts"] == 1
        sl = slice(d * rows, (d + 1) * rows)
        np.testing.assert_allclose(res["y"], want[f"{tag}_y"][sl],
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(res["y"], want[f"{tag}_local"][sl],
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(res["aux"], want[f"{tag}_aux"],
                                   rtol=2e-4, atol=2e-4)


def test_drop_case_drops_tokens():
    """At ``DROP_CF`` each data shard of the reduced dbrx drops entries
    (so ``ep24_drop`` exercises the drop path)."""
    inputs, _, _, moe_state, _, cfgs = _setup()
    cfg = cfgs["dbrx_drop"]
    router = torch.from_numpy(np.array(moe_state["moe.router"]))
    x = torch.from_numpy(inputs["moe_x"])
    for shard in x.chunk(2):
        flat = shard.reshape(-1, cfg.d_model)
        eids, _, _ = moe.route(router, flat, cfg)
        C = moe.capacity(flat.shape[0], cfg)
        _, keep = moe.dispatch(eids.reshape(-1), cfg.num_experts, C)
        assert not bool(keep.all())


def test_expert_parallel_model_equals_the_reference(parallel_run):
    """(d) each rank's logits, of its data shard's tokens, and the aux
    losses summed over the layers within 3e-4 of the reference
    ``TransformerLM`` built with the same mesh."""
    ranks, want, _, _ = parallel_run
    rows = MOE_B // 2
    for r in range(W):
        res = ranks[r]["lm24"]
        d = res["coords"][0]
        np.testing.assert_allclose(
            res["logits"], want["lm24_logits"][d * rows:(d + 1) * rows],
            rtol=3e-4, atol=3e-4)
        np.testing.assert_allclose(res["aux"], want["lm24_aux"], rtol=3e-4,
                                   atol=3e-4)
