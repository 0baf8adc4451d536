"""The zoo's last three dense configs in the port against the JAX package,
on the CPU: ``llama-20b-paper`` (the paper's own model), ``qwen2-72b`` (qkv
bias) and ``llama3-405b``, and the JAX package's training policy for them
(``src/repro/launch/dryrun.py``: bf16 parameters and int8 moments for the
largest models).

* the configs: every ``ModelConfig`` field, ``param_count`` and
  ``active_param_count`` equal to the JAX package's (17,393,894,400,
  72,706,203,648 and 405,853,388,800), and the model the port builds (on
  the meta device) holds that many;
* each reduced config through the port's entry points against the JAX
  model on bridged weights: apply, prefill (logits and the K/V cache) and a
  decode step (fp32 3e-4, bf16 5e-2 in relative norm, as
  ``tests/test_torch_models.py`` holds the audio family), and one fp32
  ``make_train_step`` step (loss, grad_norm and every parameter within
  3e-4, as ``tests/test_torch_train.py``);
* bf16 parameters: one ``make_train_step`` step with ``param_dtype``
  bfloat16 and int8 moments against the JAX step — every parameter's dtype
  (norm scales too: the JAX ``rmsnorm_init(d, dtype)`` stores them in the
  parameter dtype) and its value after the update; the checkpoint of such
  a step keeps the scales in bf16 and the JAX ``CheckpointManager`` reads
  them back bit for bit;
* the launchers take the three archs (reduced on the CPU only: head_dim 16
  and 8, which the flash kernels do not take).
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.models import layers as JL
from repro.models.registry import build_model as jax_build_model
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.runtime.train import RunConfig as JaxRunConfig
from repro.runtime.train import make_train_step as jax_make_train_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.data import DataConfig, ShardedLoader
from repro_torch.models import layers as TL
from repro_torch.models.bridge import params_from_jax
from repro_torch.models.registry import build_model, kernel_refusal
from repro_torch.models.transformer import TransformerLM
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime.train import RunConfig, Trainer, make_train_step

ARCHS = ["llama-20b-paper", "qwen2-72b", "llama3-405b"]
COUNTS = {"llama-20b-paper": 17_393_894_400, "qwen2-72b": 72_706_203_648,
          "llama3-405b": 405_853_388_800}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_references(arch):
    assert arch in list_archs()
    for ours, ref in ((get_config(arch), jax_get_config(arch)),
                      (get_reduced(arch), jax_get_reduced(arch))):
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(ref, f.name), f.name
        assert ours.param_count() == ref.param_count()
        assert ours.active_param_count() == ref.active_param_count()
    assert get_config(arch).param_count() == COUNTS[arch]
    assert get_config(arch).active_param_count() == COUNTS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_built_parameters_are_the_analytic_count(arch):
    for cfg in (get_config(arch), get_reduced(arch)):
        m = TransformerLM(cfg, device="meta")
        assert sum(p.numel() for p in m.parameters()) == cfg.param_count()


def _jax_model(arch, dtype):
    """The JAX reduced model (fp32 parameters, ``dtype`` compute), its
    parameters as numpy with the qkv biases made nonzero, and the port's
    state dict of them."""
    model = jax_build_model(jax_get_reduced(arch), policy=JL.Policy(
        jnp.float32, getattr(jnp, dtype)))
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    attn = params["layers"]["attn"]
    for b in ("bq", "bk", "bv"):
        if b in attn:
            attn[b] = (0.1 * rng.standard_normal(attn[b].shape)
                       ).astype(np.float32)
    return model, params, params_from_jax(params)


def _close_norm(got, want, dtype, err_msg=""):
    """fp32: rtol = atol = 3e-4; bf16: |got - want| <= 5e-2 |want| in
    norm."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4,
                                   err_msg=err_msg)
    else:
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= 5e-2, f"{err_msg} relative error {err}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_logits_prefill_and_decode_match_jax(arch, dtype):
    jm, params, state = _jax_model(arch, dtype)
    tm = build_model(get_reduced(arch), TL.Policy(getattr(torch, dtype)),
                     "cpu").load_params(state)
    B, S = 2, 12
    V = get_reduced(arch).vocab_size
    toks = np.random.default_rng(1).integers(0, V, (B, S + 1))
    jp = jax.tree.map(jnp.asarray, params)

    full_j, _ = jm.apply(jp, jnp.asarray(toks[:, :S]))
    _close_norm(tm.apply(torch.from_numpy(toks[:, :S])).float(), full_j,
                dtype, "apply")
    last_j, cache_j = jm.prefill(jp, jnp.asarray(toks[:, :S]),
                                 jm.init_cache(B, S + 4))
    cache_t = tm.init_cache(B, S + 4)
    last_t = tm.prefill(torch.from_numpy(toks[:, :S]), cache_t)
    _close_norm(last_t.float(), last_j, dtype, "prefill")
    for key in ("k", "v"):
        assert tuple(cache_t[key].shape) == tuple(cache_j[key].shape)
        _close_norm(cache_t[key].float(), cache_j[key], dtype, key)
    step_j, _ = jm.decode_step(jp, jnp.asarray(toks[:, S:]), cache_j,
                               jnp.int32(S))
    step_t = tm.decode_step(torch.from_numpy(toks[:, S:]), cache_t, S)
    _close_norm(step_t.float(), step_j, dtype, "decode")


def _step_pair(arch, compute_dtype, param_dtype="float32",
               state_dtype="float32", lr=1e-2):
    """The JAX and the port's train step on the same reduced model, with
    the given parameter and moment dtypes."""
    kw = dict(global_batch=4, seq_len=32, steps=10, warmup_steps=2,
              peak_lr=lr, compute_dtype=compute_dtype,
              param_dtype=param_dtype)
    jrun = JaxRunConfig(model=jax_get_reduced(arch), opt=JaxAdamWConfig(
        lr=lr, state_dtype=state_dtype), **kw)
    jm = jax_build_model(jrun.model, policy=jrun.policy())
    jp = jm.init(jax.random.PRNGKey(0))
    jo = jax_adamw_init(jp, jrun.opt)
    jstep = jax.jit(jax_make_train_step(jm, jrun))
    run = RunConfig(model=get_reduced(arch), device="cpu", opt=AdamWConfig(
        lr=lr, state_dtype=state_dtype), **kw)
    tm = Trainer(run).model
    # bf16 leaves go through float32, which holds them exactly
    tm.load_params(params_from_jax(jax.tree.map(
        lambda a: np.asarray(a, np.float32), jp)))
    to = adamw_init(dict(tm.named_parameters()), run.opt)
    return (jstep, jp, jo), (make_train_step(tm, run), tm, to)


def _steps(arch, pair, steps=(0, 1, 2)):
    """The steps of index ``steps`` of both from the same batches (by
    default as ``tests/test_torch_train.py`` runs them: step 0's learning
    rate is 0, step 2 ends the warmup); the parameters and metrics after the
    last."""
    (jstep, jp, jo), (tstep, tm, to) = pair
    cfg = get_reduced(arch)
    loader = ShardedLoader(DataConfig(vocab_size=cfg.vocab_size, batch=4,
                                      seq_len=32))
    for step in steps:
        b = {k: v for k, v in loader.next_batch().items()
             if k in ("tokens", "labels")}
        jp, jo, jmet = jstep(jp, jo, {k: jnp.asarray(v)
                                      for k, v in b.items()},
                             jnp.int32(step))
        to, tmet = tstep(to, {k: torch.as_tensor(v, dtype=torch.long)
                              for k, v in b.items()}, step)
    return jp, jmet, tm, tmet


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_train_step_matches_jax(arch):
    """Three fp32 steps: loss, grad_norm and every parameter after the
    last update within 3e-4."""
    jp, jmet, tm, tmet = _steps(arch, _step_pair(arch, "float32"))
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=3e-4,
                               atol=3e-4)
    want = params_from_jax(jax.tree.map(np.asarray, jp))
    own = dict(tm.named_parameters())
    assert set(own) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(own[k].detach().numpy(), v, rtol=3e-4,
                                   atol=3e-4, err_msg=k)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_parameters_and_int8_moments_step_as_the_reference(
        arch, compute_dtype):
    """The JAX package's policy for its largest models: one step at the
    peak learning rate with bfloat16 parameters (so bfloat16 gradients)
    and int8 moments.  Every parameter keeps the JAX parameter's dtype, the
    norm scales included, and its value after the update: with fp32
    compute within one bf16 ulp (rtol 2^-7) and 3e-4, since only a rounding
    at the edge of two bf16 values may differ; with bf16 compute within
    5e-2.  One step: from the second on, an embedding row whose int8 v
    rounded to 0 where its m did not moves by lr·m̂/eps once its token is
    absent from the batch (the JAX ``_q_enc``; ``ROADMAP.md`` §3), which
    turns a one-ulp difference into any other."""
    jp, jmet, tm, tmet = _steps(arch, _step_pair(
        arch, compute_dtype, "bfloat16", "int8"), steps=(2,))
    own = dict(tm.named_parameters())
    want = params_from_jax(jax.tree.map(
        lambda a: np.asarray(a, np.float32), jp))
    # every JAX parameter is bf16, so every port parameter must be
    assert {a.dtype for a in jax.tree.leaves(jp)} == {jnp.dtype(jnp.bfloat16)}
    assert set(own) == set(want)
    for k, v in want.items():
        assert own[k].dtype == torch.bfloat16, k
        if compute_dtype == "float32":
            np.testing.assert_allclose(own[k].detach().float().numpy(), v,
                                       rtol=2 ** -7, atol=3e-4, err_msg=k)
        else:
            np.testing.assert_allclose(own[k].detach().float().numpy(), v,
                                       rtol=5e-2, atol=5e-2, err_msg=k)
    tol = 3e-4 if compute_dtype == "float32" else 5e-2
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=tol, atol=tol)
    # the norm scales moved off their init of 1 and stayed in bf16
    assert not torch.all(own["final_norm.scale"] == 1)


def test_bf16_checkpoint_keeps_the_scales_in_bf16(tmp_path):
    """A bf16-parameter step's checkpoint: every parameter is written as
    bfloat16 in the manifest, as the JAX ``CheckpointManager`` writes the
    JAX step's, and the JAX manager reads the port's scales back bit for
    bit."""
    arch = ARCHS[0]
    jp, _, tm, _ = _steps(arch, _step_pair(arch, "float32", "bfloat16",
                                           "int8"), steps=(2,))
    params = dict(tm.named_parameters())
    CheckpointManager(str(tmp_path / "port")).save(0, {"params": params})
    JaxCheckpointManager(str(tmp_path / "jax")).save(0, {"params": jp})
    port = JaxCheckpointManager(str(tmp_path / "port"))
    ref = JaxCheckpointManager(str(tmp_path / "jax")).metadata()["arrays"]
    arrays = port.metadata()["arrays"]
    assert {a["dtype"] for a in arrays.values()} == {"bfloat16"}
    assert ref["params/final_norm/scale"]["dtype"] == "bfloat16"
    assert ref["params/layers/ln1/scale"]["dtype"] == "bfloat16"
    names = [n for n in params if n.endswith("scale")]
    back = port.restore({"params": {n: 0 for n in names}})["params"]
    for n in names:
        got = np.asarray(back[n]).view(ml_dtypes.bfloat16)
        want = params[n].detach().view(torch.int16).numpy().view(
            ml_dtypes.bfloat16)
        np.testing.assert_array_equal(got, want, err_msg=n)


@pytest.mark.parametrize("device, ok", [("cuda", False), ("cpu", True)])
@pytest.mark.parametrize("entry", ["serve", "train"])
@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_take_the_three_archs(monkeypatch, capsys, tmp_path, arch,
                                        entry, device, ok):
    """Reduced, they serve and train with ``--device cpu`` and on the card,
    whose kernels take their head_dim 16 and 8 (without a card the
    ``Server`` and ``Trainer`` refuse ``--device cuda``); the full
    configs are taken."""
    assert kernel_refusal(get_config(arch)) is None
    if entry == "serve":
        from repro_torch.launch import serve as launch
        argv = ["serve", "--arch", arch, "--reduced", "--device", device,
                "--batch", "1", "--prompt-len", "12", "--new-tokens", "2"]
        done = "generated (1, 14) tokens"
    else:
        from repro_torch.launch import train as launch
        argv = ["train", "--arch", arch, "--reduced", "--device", device,
                "--steps", "3", "--batch", "2", "--seq", "16", "--remat",
                "full", "--flare-log", str(tmp_path / "t.jsonl")]
        done = "final loss:"
    monkeypatch.setattr(sys, "argv", argv)
    if ok or torch.cuda.is_available():
        # the card takes the reduced config as it is
        launch.main()
        assert done in capsys.readouterr().out
    else:
        # no card here: Server or Trainer refuses to build on CUDA
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch.main()


def test_reference_int8_moments_diverge_where_bf16_moments_train():
    """Why the card trains qwen2-72b and llama3-405b with bf16 moments: the
    JAX package's int8 moments (``_q_enc``: one absmax scale a block of
    256 along the last axis) round most of a block's second moments to 0,
    where the first moments stay nonzero, so the next updates take
    lr·m̂/eps.  Six steps of the reference's own ``make_train_step`` on the
    reduced qwen2-72b, bf16 parameters, lr 1e-2: with int8 moments the loss
    more than doubles and the embedding grows from |3.9| past |50|; with
    bf16 moments the loss falls and the embedding stays put."""
    from repro.data import DataConfig as JaxDataConfig
    from repro.data import ShardedLoader as JaxShardedLoader
    out = {}
    for sd in ("int8", "bfloat16"):
        (jstep, jp, jo), _ = _step_pair("qwen2-72b", "bfloat16", "bfloat16",
                                        sd)
        loader = JaxShardedLoader(JaxDataConfig(vocab_size=256, batch=4,
                                                seq_len=32))
        losses = []
        for step in range(6):
            b = {k: jnp.asarray(v) for k, v in loader.next_batch().items()
                 if k in ("tokens", "labels")}
            jp, jo, met = jstep(jp, jo, b, jnp.int32(step))
            losses.append(float(met["loss"]))
        out[sd] = (losses, float(jnp.max(jnp.abs(
            jp["embed"]["embedding"].astype(jnp.float32)))))
    (l8, e8), (lb, eb) = out["int8"], out["bfloat16"]
    assert l8[-1] > 2 * l8[0] and e8 > 50, out
    assert lb[-1] < lb[0] and eb < 5, out
