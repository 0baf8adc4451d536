"""The port's hybrid ``Zamba2LM`` against the JAX package's (CPU).

Weights are drawn by the JAX init of the reduced ``zamba2-2.7b`` (4 Mamba
layers in 2 groups of 2, one shared attention + MLP block applied twice,
d_model 64, 4 heads of head_dim 16, P 16, N 16, chunk 16) and shared
through ``repro_torch.models.bridge.params_from_jax``; inputs are made with
numpy.  Tolerances: 3e-4 at fp32 (``tests/test_kernels.py``'s), entry by
entry; at bf16 5e-2 in relative norm (``_close``).  The bf16 activations
round at other places in the two packages (the JAX bf16 SiLU rounds after
each of exp, add and divide, ``F.silu`` once; ``tests/test_torch_mamba.py``),
and through 4 Mamba layers and 2 attention + MLP applications a few logits
in 10^4 drift past 5e-2 of the logits' RMS (1.5e-2 in norm): the same
drift with the JAX ``direct_attention``'s roundings in place of the flash
op's, so it is not attention's.  The reduced chunk 16 keeps the
reference's own ``ssd_chunked`` gradient finite (it is NaN at chunks of
~32 rows and more).
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.models import layers as JL
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import get_config, get_reduced
from repro_torch.models import layers as TL
from repro_torch.models.bridge import params_from_jax
from repro_torch.models.registry import build_model
from repro_torch.models.zamba2 import Zamba2LM

ARCH = "zamba2-2.7b"
TOL = {"float32": 3e-4, "bfloat16": 5e-2}


def _close(got, want, dtype, err_msg=""):
    """fp32: rtol = atol = 3e-4; bf16: |got - want| <= 5e-2 |want| in
    norm."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg=err_msg)
    else:
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= TOL[dtype], f"{err_msg} relative error {err}"


def _jax_model(dtype, seed=0):
    model = jax_build_model(jax_get_reduced(ARCH), policy=JL.Policy(
        jnp.float32, getattr(jnp, dtype)))
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed)))
    return model, params, params_from_jax(params)


def _port_model(dtype, state, param_dtype=None):
    policy = TL.Policy(getattr(torch, dtype), param_dtype)
    return build_model(get_reduced(ARCH), policy, "cpu").load_params(state)


def _layers(a):
    """The JAX cache's [groups, per, ...] Mamba leaves as the port's
    [L, ...]."""
    a = np.asarray(a)
    return a.reshape(-1, *a.shape[2:])


@pytest.mark.parametrize("name", ["zamba2-2.7b", "reduced"])
def test_param_count_equals_the_reference(name):
    """L Mamba layers plus ONE shared attention + MLP block, for the full
    config (2,422,659,008) and the reduced one."""
    ours, ref = ((get_config(ARCH), jax_get_config(ARCH)) if name == ARCH
                 else (get_reduced(ARCH), jax_get_reduced(ARCH)))
    assert ours.param_count() == ref.param_count()
    assert ours.active_param_count() == ref.active_param_count()
    if name == ARCH:
        assert ours.param_count() == 2_422_659_008


def test_full_config_is_the_reference():
    cfg, ref = get_config(ARCH), jax_get_config(ARCH)
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab_size", "head_dim", "ssm_state", "ssm_head_dim",
              "ssm_chunk", "attn_every", "rope_theta", "tie_embeddings"):
        assert getattr(cfg, f) == getattr(ref, f), f
    assert (cfg.head_dim, cfg.ssm_heads, cfg.d_inner) == (80, 80, 5120)


def test_bridge_names_every_parameter():
    """``layers/*`` stacked on [groups, per] become ``layers.<g*per+j>.*``;
    ``shared_attn.*`` is copied as it is; every name and shape matches the
    port's model, float32 leaves until ``load_params`` casts them."""
    _, params, state = _jax_model("bfloat16")
    cfg = get_reduced(ARCH)
    model = Zamba2LM(cfg, TL.Policy(torch.bfloat16), "cpu")
    own = dict(model.named_parameters())
    assert set(state) == set(own)
    for n, p in own.items():
        assert tuple(state[n].shape) == tuple(p.shape), n
        assert state[n].dtype == np.float32, n
    per = cfg.attn_every
    for g in range(cfg.num_layers // per):
        for j in range(per):
            np.testing.assert_array_equal(
                state[f"layers.{g * per + j}.mamba.in_x"],
                params["layers"]["mamba"]["in_x"][g, j])
    np.testing.assert_array_equal(state["shared_attn.attn.wq"],
                                  params["shared_attn"]["attn"]["wq"])
    model.load_params(state)
    assert own["shared_attn.ln1.scale"].dtype == torch.float32
    assert own["shared_attn.mlp.wo"].dtype == torch.bfloat16
    assert own["layers.3.mamba.A_log"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [32, 20])
def test_logits_and_cache_match_jax(S, dtype):
    """apply, prefill (logits and the whole cache: SSM state and conv per
    layer, K/V per application) and decode_step logits against the JAX
    Zamba2LM: S 32 is two chunks, S 20 a ragged one."""
    jm, params, state = _jax_model(dtype)
    tm = _port_model(dtype, state)
    B = 2
    toks = np.random.default_rng(1).integers(0, 256, (B, S + 1))
    jp = jax.tree.map(jnp.asarray, params)

    full_j, _ = jm.apply(jp, jnp.asarray(toks[:, :S]))
    full_t = tm.apply(torch.from_numpy(toks[:, :S]))
    _close(full_t.float(), full_j, dtype)

    last_j, cache_j = jm.prefill(jp, jnp.asarray(toks[:, :S]),
                                 jm.init_cache(B, S + 4))
    cache_t = tm.init_cache(B, S + 4)
    last_t = tm.prefill(torch.from_numpy(toks[:, :S]), cache_t)
    _close(last_t.float(), last_j, dtype)
    assert cache_t["state"].dtype == torch.float32
    for key in ("conv", "k", "v"):
        assert cache_t[key].dtype == getattr(torch, dtype), key
    assert tuple(cache_t["k"].shape) == tuple(cache_j["k"].shape)
    _close(cache_t["state"], _layers(cache_j["state"]), dtype)
    _close(cache_t["conv"].float(), _layers(cache_j["conv"]), dtype)
    for key in ("k", "v"):
        _close(cache_t[key].float(), cache_j[key], dtype,
               err_msg=key)

    step_j, _ = jm.decode_step(jp, jnp.asarray(toks[:, S:]), cache_j,
                               jnp.int32(S))
    step_t = tm.decode_step(torch.from_numpy(toks[:, S:]), cache_t, S)
    _close(step_t.float(), step_j, dtype)


@pytest.mark.parametrize("S", [32, 21])
def test_decode_reproduces_apply(S):
    """prefill at S, then decode steps at S and S + 1: each gives apply()'s
    logits at its position (fp32, 3e-4)."""
    _, _, state = _jax_model("float32")
    tm = _port_model("float32", state)
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, 256, (2, S + 2)))
    full = tm.apply(toks)
    cache = tm.init_cache(2, S + 8)
    last = tm.prefill(toks[:, :S], cache)
    torch.testing.assert_close(last, full[:, S - 1], rtol=3e-4, atol=3e-4)
    for i in range(2):
        step = tm.decode_step(toks[:, S + i:S + i + 1], cache, S + i)
        torch.testing.assert_close(step, full[:, S + i], rtol=3e-4,
                                   atol=3e-4)


@pytest.mark.parametrize("S", [32, 20])
def test_loss_and_gradients_match_jax(S):
    """The loss and its gradients against ``jax.grad`` of the JAX
    ``Zamba2LM.loss`` (fp32, 3e-4): the embedding, the head, one Mamba
    layer's every parameter and every parameter of the shared block, whose
    gradient sums its applications."""
    jm, params, state = _jax_model("float32")
    tm = _port_model("float32", state)
    toks = np.random.default_rng(4).integers(0, 256, (2, S + 1))
    batch = {"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])}
    (loss_j, _), grads_j = jax.value_and_grad(jm.loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params), batch)
    want = params_from_jax(jax.tree.map(np.asarray, grads_j))

    own = dict(tm.named_parameters())
    loss_t = tm.loss(torch.from_numpy(toks[:, :-1]),
                     torch.from_numpy(toks[:, 1:]))
    names = [n for n in own if n.startswith(("embed.", "head.", "layers.1.",
                                             "shared_attn."))]
    assert sum(n.startswith("shared_attn.") for n in names) == 9
    grads_t = torch.autograd.grad(loss_t, [own[n] for n in names])
    _close(loss_t.detach(), np.asarray(loss_j), "float32")
    for n, g in zip(names, grads_t):
        assert bool((g != 0).any()), n
        _close(g, want[n], "float32", err_msg=n)


def test_init_follows_jax_distributions():
    """Random init: the Mamba layers' constants and stddevs as
    ``MambaLM``'s, the shared block's as ``TransformerLM``'s."""
    cfg = get_reduced(ARCH)
    m = Zamba2LM(cfg, TL.Policy(torch.float32), "cpu")
    m.init(torch.Generator().manual_seed(0))
    p = dict(m.named_parameters())
    jp = jax.tree.map(np.asarray, jax_build_model(jax_get_reduced(ARCH)).init(
        jax.random.PRNGKey(0)))["layers"]["mamba"]
    for leaf in ("dt_bias", "A_log", "D", "conv_b"):
        np.testing.assert_allclose(p[f"layers.3.mamba.{leaf}"].detach(),
                                   jp[leaf][1, 1], rtol=1e-6, atol=1e-6,
                                   err_msg=leaf)
    for name in ("final_norm.scale", "layers.2.ln.scale",
                 "shared_attn.ln1.scale", "shared_attn.ln2.scale"):
        assert torch.all(p[name] == 1), name
    big = Zamba2LM(get_reduced(ARCH).__class__(
        **{**cfg.__dict__, "d_model": 256, "d_ff": 512, "num_heads": 8,
           "num_kv_heads": 8, "head_dim": 32}), TL.Policy(torch.float32),
        "cpu")
    big.init(torch.Generator().manual_seed(0))
    bp = dict(big.named_parameters())
    for name, std in (("embed.embedding", 1.0),
                      ("head.w", 256 ** -0.5),
                      ("layers.1.mamba.in_z", 256 ** -0.5),
                      ("layers.1.mamba.out", 512 ** -0.5),
                      ("shared_attn.attn.wq", 256 ** -0.5),
                      ("shared_attn.attn.wo", 256 ** -0.5),
                      ("shared_attn.mlp.wi_up", 256 ** -0.5),
                      ("shared_attn.mlp.wo", 512 ** -0.5)):
        assert abs(float(bp[name].detach().std()) / std - 1) < 0.1, name


def test_forward_launches_per_group():
    """zamba2-2.7b's counts per forward, on the meta device at full width:
    54 SSD scans, 9 flash calls (one per application of the shared block)
    and 72 fused residual + norms (54 after the Mamba layers, 2 per
    application)."""
    from repro_torch.models import ssm_lm, transformer, zamba2
    calls = {"ssd": 0, "flash": 0, "fused": 0}
    cfg = get_config(ARCH)
    m = Zamba2LM(cfg, device="meta")

    def layer(lyr, h, *a):
        calls["ssd"] += 1
        return h

    def block(blk, h, x, *a, **kw):
        calls["flash"] += 1
        calls["fused"] += 2          # attention's add + ln2, the MLP's + next
        return h, x

    def fused(out, x, scale, eps):
        calls["fused"] += 1
        return out, x

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ssm_lm, "layer_apply", layer)
        mp.setattr(transformer, "block_apply", block)
        mp.setattr(zamba2, "fused", fused)
        x = torch.empty((1, 4, cfg.d_model), device="meta",
                        dtype=torch.bfloat16)
        m._groups(x, torch.arange(4)[None])
    assert calls == {"ssd": 54, "flash": 9, "fused": 72}


def test_training_policy_reaches_every_parameter():
    """float32 parameters, bf16 compute: one backward reaches every
    parameter, the shared block's included, with a finite gradient."""
    m = Zamba2LM(get_reduced(ARCH), TL.Policy(torch.bfloat16, torch.float32),
                 "cpu")
    m.init(torch.Generator().manual_seed(0))
    params = dict(m.named_parameters())
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 33)))
    assert m.logits(toks[:, :-1]).dtype == torch.bfloat16
    grads = torch.autograd.grad(m.loss(toks[:, :-1], toks[:, 1:]),
                                list(params.values()))
    for n, g in zip(params, grads):
        assert g.dtype == torch.float32 and bool(g.isfinite().all()), n
        assert bool((g != 0).any()), n


@pytest.mark.parametrize("device, ok", [("cuda", False), ("cpu", True)])
@pytest.mark.parametrize("entry", ["serve", "train"])
def test_launchers_run_reduced_zamba2_on_the_cpu_only(monkeypatch, capsys,
                                                      tmp_path, entry, device,
                                                      ok):
    """``--arch zamba2-2.7b --reduced`` serves and trains with ``--device
    cpu`` and on the card, whose kernels take its SSD widths (P 16, N 16,
    chunk 16, run at 64) and attention head_dim 16; without a card the
    ``Server`` and ``Trainer`` refuse ``--device cuda``."""
    if entry == "serve":
        from repro_torch.launch import serve as launch
        argv = ["serve", "--arch", ARCH, "--reduced", "--device", device,
                "--batch", "1", "--prompt-len", "20", "--new-tokens", "2"]
        done = "generated (1, 22) tokens"
    else:
        from repro_torch.launch import train as launch
        argv = ["train", "--arch", ARCH, "--reduced", "--device", device,
                "--steps", "3", "--batch", "2", "--seq", "32",
                "--flare-log", str(tmp_path / "t.jsonl")]
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
