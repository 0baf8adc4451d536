"""The port's layers and dense transformer against the JAX package (CPU).

Weights are drawn by the JAX init and shared through
``repro_torch.models.bridge.params_from_jax``; inputs are made with numpy.
Tolerances: 2e-3 at fp32 (as ``tests/test_models_smoke.py``), 5e-2 at bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import layers as JL
from repro.models.registry import build_model
from repro_torch.configs import get_reduced
from repro_torch.models import layers as TL
from repro_torch.models.bridge import params_from_jax
from repro_torch.models.transformer import TransformerLM

ARCHS = ["llama3.2-1b", "qwen2-0.5b"]
TOL = {"float32": 2e-3, "bfloat16": 5e-2}


def _jax_model(arch, dtype, seed=0):
    """JAX reduced model + params, qkv biases made nonzero so the bias path
    is exercised, and the same params as the port's state dict."""
    model = build_model(jax_get_reduced(arch), policy=JL.Policy(
        jnp.float32, getattr(jnp, dtype)))
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    attn = params["layers"]["attn"]
    for b in ("bq", "bk", "bv"):
        if b in attn:
            attn[b] = (0.1 * rng.standard_normal(attn[b].shape)
                       ).astype(np.float32)
    return model, params, params_from_jax(params)


def _port_model(arch, dtype, state):
    return TransformerLM(get_reduced(arch), TL.Policy(
        getattr(torch, dtype)), "cpu").load_params(state)


def _close(got, want, dtype, logits=False):
    """rtol = atol = TOL[dtype].  bf16 logits get atol = 5e-2 of their RMS:
    a bf16 hidden state carries ~3 significant digits into a sum over
    d_model, so the logits' absolute error scales with their size."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    atol = TOL[dtype]
    if logits and dtype == "bfloat16":
        atol *= float(np.sqrt(np.mean(want * want)))
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(rng, dtype):
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    s = rng.standard_normal((64,)).astype(np.float32)
    got = TL.rmsnorm(torch.from_numpy(s),
                     torch.from_numpy(x).to(getattr(torch, dtype)))
    want = JL.rmsnorm({"scale": jnp.asarray(s)},
                      jnp.asarray(x, getattr(jnp, dtype)))
    _close(got.float(), want, dtype)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
@pytest.mark.parametrize("pos_shape", ["prefill", "decode"])
def test_apply_rope_matches_jax(rng, theta, pos_shape):
    B, S, H, hd = 2, 9, 3, 16
    if pos_shape == "prefill":
        pos = np.arange(S)[None, :] + 5
    else:
        S = 1
        pos = np.full((B, 1), 1234)
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(got, want, "float32")


def test_mlp_apply_matches_jax(rng):
    D, F = 32, 96
    p = {k: (rng.standard_normal(s) * 0.2).astype(np.float32)
         for k, s in (("wi_gate", (D, F)), ("wi_up", (D, F)), ("wo", (F, D)))}
    x = rng.standard_normal((2, 7, D)).astype(np.float32)
    got = TL.mlp_apply(*(torch.from_numpy(p[k])
                         for k in ("wi_gate", "wi_up", "wo")),
                       torch.from_numpy(x))
    want = JL.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x))
    _close(got, want, "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_names_every_parameter(arch):
    _, _, state = _jax_model(arch, "float32")
    model = TransformerLM(get_reduced(arch), TL.Policy(), "cpu")
    assert set(state) == {n for n, _ in model.named_parameters()}
    for n, p in model.named_parameters():
        assert tuple(state[n].shape) == tuple(p.shape), n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_jax(arch, dtype):
    """apply, prefill and decode_step logits against the JAX model."""
    jm, params, state = _jax_model(arch, dtype)
    tm = _port_model(arch, dtype, state)
    cfg = get_reduced(arch)
    B, S = 2, 12
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S + 1))
    jp = jax.tree.map(jnp.asarray, params)

    full_j, _ = jm.apply(jp, jnp.asarray(toks[:, :S]))
    full_t = tm.apply(torch.from_numpy(toks[:, :S]))
    _close(full_t.float(), full_j, dtype, logits=True)

    cache_j = jm.init_cache(B, S + 4)
    last_j, cache_j = jm.prefill(jp, jnp.asarray(toks[:, :S]), cache_j)
    cache_t = tm.init_cache(B, S + 4)
    last_t = tm.prefill(torch.from_numpy(toks[:, :S]), cache_t)
    _close(last_t.float(), last_j, dtype, logits=True)
    _close(cache_t["k"].float(), cache_j["k"], dtype)

    step_j, _ = jm.decode_step(jp, jnp.asarray(toks[:, S:]), cache_j,
                               jnp.int32(S))
    step_t = tm.decode_step(torch.from_numpy(toks[:, S:]), cache_t, S)
    _close(step_t.float(), step_j, dtype, logits=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """decode_step at position S reproduces apply()'s logits[S]."""
    _, _, state = _jax_model(arch, "float32")
    tm = _port_model(arch, "float32", state)
    cfg = get_reduced(arch)
    B, S = 2, 16
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S + 2)))
    full = tm.apply(toks)
    cache = tm.init_cache(B, S + 8)
    last = tm.prefill(toks[:, :S], cache)
    torch.testing.assert_close(last, full[:, S - 1], rtol=2e-3, atol=2e-3)
    for i in range(2):
        step = tm.decode_step(toks[:, S + i:S + i + 1], cache, S + i)
        torch.testing.assert_close(step, full[:, S + i], rtol=2e-3,
                                   atol=2e-3)


def test_init_follows_jax_distributions():
    """Random init: the JAX init's stddevs, unit norm scales, zero biases."""
    cfg = get_reduced("qwen2-0.5b")
    m = TransformerLM(cfg, TL.Policy(torch.float32), "cpu")
    m.init(torch.Generator().manual_seed(0))
    p = dict(m.named_parameters())
    assert torch.all(p["final_norm.scale"] == 1)
    assert torch.all(p["layers.0.attn.bq"] == 0)
    for name, std in (("embed.embedding", 1.0),
                      ("layers.1.attn.wq", cfg.d_model ** -0.5),
                      ("layers.1.mlp.wo", cfg.d_ff ** -0.5)):
        assert abs(float(p[name].std()) / std - 1) < 0.1, name
