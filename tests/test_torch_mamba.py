"""The port's Mamba2 layers and ``MambaLM`` against the JAX package (CPU).

Weights are drawn by the JAX init of the reduced ``mamba2-780m`` (3 layers,
d_model 64, chunk 16) and shared through
``repro_torch.models.bridge.params_from_jax``; inputs are made with numpy.
Tolerances: 2e-3 at fp32 (as ``tests/test_models_smoke.py``); at bf16
5e-2, with the atol of logits scaled by their RMS (the rule of
``tests/test_torch_models.py``).  The bf16 SSM state is held to 5e-2 in
relative norm instead: it is an fp32 sum over the sequence of products of
bf16 activations, and those differ by a rounding between the two packages
(the JAX bf16 SiLU rounds its sigmoid after each of exp, add and divide;
``F.silu`` rounds once), which single entries that nearly cancel carry
undamped.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import layers as JL
from repro.models import mamba2 as JM
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import get_config, get_reduced
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as TM
from repro_torch.models.bridge import params_from_jax
from repro_torch.models.registry import build_model
from repro_torch.models.ssm_lm import MambaLM
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.zamba2 import Zamba2LM

ARCH = "mamba2-780m"
TOL = {"float32": 2e-3, "bfloat16": 5e-2}


def _close(got, want, dtype, scaled=False):
    """rtol = atol = TOL[dtype]; ``scaled`` bf16 logits get atol = 5e-2 of
    their RMS: a bf16 hidden state carries ~3 significant digits into a sum
    over d_model."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    atol = TOL[dtype]
    if scaled and dtype == "bfloat16":
        atol *= float(np.sqrt(np.mean(want * want)))
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=atol)


def _t(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, dtype))


def _jax_model(dtype, seed=0):
    model = jax_build_model(jax_get_reduced(ARCH), policy=JL.Policy(
        jnp.float32, getattr(jnp, dtype)))
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed)))
    return model, params, params_from_jax(params)


def _port_model(dtype, state):
    return build_model(get_reduced(ARCH), TL.Policy(getattr(torch, dtype)),
                       "cpu").load_params(state)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_rmsnorm_matches_jax(rng, dtype):
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    z = rng.standard_normal((2, 5, 64)).astype(np.float32)
    s = rng.standard_normal((64,)).astype(np.float32)
    got = TL.gated_rmsnorm(_t(s), _t(x, dtype), _t(z), 1e-5)
    assert got.dtype == getattr(torch, dtype)
    want = JL.gated_rmsnorm({"scale": jnp.asarray(s)},
                            jnp.asarray(x, getattr(jnp, dtype)),
                            jnp.asarray(z), 1e-5)
    _close(got.float(), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("history", [False, True])
def test_causal_conv_matches_jax(rng, history, dtype):
    B, L, C, W = 2, 9, 24, 4
    x = rng.standard_normal((B, L, C)).astype(np.float32)
    w = (rng.standard_normal((W, C)) * 0.5).astype(np.float32)
    b = (rng.standard_normal((C,)) * 0.1).astype(np.float32)
    hist = (rng.standard_normal((B, W - 1, C)).astype(np.float32)
            if history else None)
    got = TM.causal_conv(_t(x, dtype), _t(w), _t(b),
                         None if hist is None else _t(hist, dtype))
    jd = getattr(jnp, dtype)
    want = JM.causal_conv(jnp.asarray(x, jd), jnp.asarray(w), jnp.asarray(b),
                          None if hist is None else jnp.asarray(hist, jd))
    _close(got.float(), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [32, 20])
def test_logits_and_cache_match_jax(S, dtype):
    """apply, prefill and decode_step logits, and the cache after prefill,
    against the JAX MambaLM: S 32 is two chunks, S 20 a ragged one."""
    jm, params, state = _jax_model(dtype)
    tm = _port_model(dtype, state)
    B = 2
    toks = np.random.default_rng(1).integers(0, 256, (B, S + 1))
    jp = jax.tree.map(jnp.asarray, params)

    full_j, _ = jm.apply(jp, jnp.asarray(toks[:, :S]))
    full_t = tm.apply(torch.from_numpy(toks[:, :S]))
    _close(full_t.float(), full_j, dtype, scaled=True)

    last_j, cache_j = jm.prefill(jp, jnp.asarray(toks[:, :S]),
                                 jm.init_cache(B, S + 4))
    cache_t = tm.init_cache(B, S + 4)
    last_t = tm.prefill(torch.from_numpy(toks[:, :S]), cache_t)
    _close(last_t.float(), last_j, dtype, scaled=True)
    assert cache_t["state"].dtype == torch.float32
    assert cache_t["conv"].dtype == getattr(torch, dtype)
    if dtype == "float32":
        _close(cache_t["state"], cache_j["state"], dtype)
    else:
        got, want = cache_t["state"].numpy(), np.asarray(cache_j["state"])
        assert np.linalg.norm(got - want) <= 5e-2 * np.linalg.norm(want)
    _close(cache_t["conv"].float(), cache_j["conv"], dtype)

    step_j, _ = jm.decode_step(jp, jnp.asarray(toks[:, S:]), cache_j,
                               jnp.int32(S))
    step_t = tm.decode_step(torch.from_numpy(toks[:, S:]), cache_t, S)
    _close(step_t.float(), step_j, dtype, scaled=True)


@pytest.mark.parametrize("S", [32, 21])
def test_prefill_decode_matches_forward(S):
    """prefill + 2 decode steps reproduce apply()'s logits."""
    _, _, state = _jax_model("float32")
    tm = _port_model("float32", state)
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, 256, (2, S + 2)))
    full = tm.apply(toks)
    cache = tm.init_cache(2, S + 8)
    last = tm.prefill(toks[:, :S], cache)
    torch.testing.assert_close(last, full[:, S - 1], rtol=2e-3, atol=2e-3)
    for i in range(2):
        step = tm.decode_step(toks[:, S + i:S + i + 1], cache, S + i)
        torch.testing.assert_close(step, full[:, S + i], rtol=2e-3,
                                   atol=2e-3)


def test_bridge_names_every_parameter():
    """layers.ln.scale and layers.mamba.* (stacked on L) become
    layers.<i>.ln.scale and layers.<i>.mamba.*, float32 leaves stay float32
    until load_params casts them."""
    _, params, state = _jax_model("bfloat16")
    cfg = get_reduced(ARCH)
    model = MambaLM(cfg, TL.Policy(torch.bfloat16), "cpu")
    own = dict(model.named_parameters())
    assert set(state) == set(own)
    for n, p in own.items():
        assert tuple(state[n].shape) == tuple(p.shape), n
        assert state[n].dtype == np.float32, n
    for i in range(cfg.num_layers):
        np.testing.assert_array_equal(state[f"layers.{i}.mamba.A_log"],
                                      params["layers"]["mamba"]["A_log"][i])
        assert f"layers.{i}.mamba.norm.scale" in state
    model.load_params(state)
    for leaf in ("A_log", "dt_bias", "norm.scale"):
        assert own[f"layers.0.mamba.{leaf}"].dtype == torch.float32, leaf
    for leaf in ("in_x", "conv_w", "conv_b", "D", "out"):
        assert own[f"layers.0.mamba.{leaf}"].dtype == torch.bfloat16, leaf
    assert own["layers.1.ln.scale"].dtype == torch.float32


def test_init_follows_jax_distributions():
    """Random init: the JAX init's stddevs, the dt_bias / A_log linspaces,
    D 1, conv_b 0, unit norm scales."""
    cfg = get_reduced(ARCH)
    m = MambaLM(cfg, TL.Policy(torch.float32), "cpu")
    m.init(torch.Generator().manual_seed(0))
    p = dict(m.named_parameters())
    jp = jax.tree.map(np.asarray, jax_build_model(jax_get_reduced(ARCH)).init(
        jax.random.PRNGKey(0)))["layers"]["mamba"]
    for leaf in ("dt_bias", "A_log", "D", "conv_b"):
        for i in range(cfg.num_layers):
            np.testing.assert_allclose(
                p[f"layers.{i}.mamba.{leaf}"].detach().numpy(), jp[leaf][i],
                rtol=1e-6, atol=1e-6, err_msg=leaf)
    for name in ("final_norm.scale", "layers.0.ln.scale",
                 "layers.2.mamba.norm.scale"):
        assert torch.all(p[name] == 1), name
    for name, std in (("embed.embedding", 1.0),
                      ("head.w", cfg.d_model ** -0.5),
                      ("layers.1.mamba.in_z", cfg.d_model ** -0.5),
                      ("layers.1.mamba.in_dt", cfg.d_model ** -0.5),
                      ("layers.1.mamba.out", cfg.d_inner ** -0.5)):
        assert abs(float(p[name].std()) / std - 1) < 0.1, name
    w = p["layers.0.mamba.conv_w"]
    assert abs(float(w.std()) * cfg.conv_width ** 0.5 - 1) < 0.15


def test_registry_builds_each_family():
    assert type(build_model(get_reduced(ARCH), device="cpu")) is MambaLM
    assert type(build_model(get_reduced("llama3.2-1b"),
                            device="cpu")) is TransformerLM
    assert type(build_model(get_reduced("zamba2-2.7b"),
                            device="cpu")) is Zamba2LM
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.d_inner, cfg.ssm_heads,
            cfg.ssm_head_dim, cfg.ssm_state, cfg.conv_width, cfg.ssm_chunk,
            cfg.vocab_size, cfg.tie_embeddings) == (
        48, 1536, 3072, 48, 64, 128, 4, 256, 50280, False)
    other = get_reduced(ARCH).__class__(
        name="x", family="rwkv", num_layers=1, d_model=8, num_heads=1,
        num_kv_heads=1, d_ff=8, vocab_size=8)
    with pytest.raises(NotImplementedError, match="rwkv"):
        build_model(other, device="cpu")


@pytest.mark.parametrize("S", [1, 2])
def test_short_prompts_decode_like_the_full_sequence(monkeypatch, S):
    """Prompts of 1 and 2 tokens, shorter than the conv history of W - 1 =
    3 columns: the port pads the history with zeros.  The JAX package
    raises here (its ``mamba2.py:186`` keeps fewer columns), so the
    oracles are the port's own forward over the whole sequence, with its
    chunked SSD scan and with the step recurrence ``ssd_sequential``:
    prefill + 2 decode steps give their logits (reduced config, fp32)."""
    _, _, state = _jax_model("float32")
    tm = _port_model("float32", state)
    n = 3
    toks = torch.from_numpy(
        np.random.default_rng(S).integers(0, 256, (2, S + n)))
    full = tm.apply(toks)
    cache = tm.init_cache(2, S + n)
    steps = [tm.prefill(toks[:, :S], cache)]
    for i in range(n - 1):
        steps.append(tm.decode_step(toks[:, S + i:S + i + 1], cache, S + i))
    got = torch.stack(steps, dim=1)
    torch.testing.assert_close(got, full[:, S - 1:S + n - 1], rtol=2e-3,
                               atol=2e-3)
    monkeypatch.setattr(
        TM, "ssd_scan", lambda x, dt, A, Bm, Cm, chunk, initial_state=None:
        TM.ssd_sequential(x, dt, A, Bm, Cm, initial_state))
    sequential = tm.apply(toks)
    torch.testing.assert_close(got, sequential[:, S - 1:S + n - 1],
                               rtol=2e-3, atol=2e-3)


def test_parameters_are_fp32_masters_cast_at_use():
    """The training policy (float32 parameters, bf16 compute): every
    parameter is a float32 leaf that requires grad, the forward runs in
    bf16, and one backward reaches every parameter with a finite
    gradient."""
    cfg = get_reduced(ARCH)
    m = MambaLM(cfg, TL.Policy(torch.bfloat16, torch.float32), "cpu")
    m.init(torch.Generator().manual_seed(0))
    params = dict(m.named_parameters())
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in params.values())
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 33)))
    logits = m.logits(toks[:, :-1])
    assert logits.dtype == torch.bfloat16
    grads = torch.autograd.grad(m.loss(toks[:, :-1], toks[:, 1:]),
                                list(params.values()))
    for n, g in zip(params, grads):
        assert g.dtype == torch.float32 and bool(g.isfinite().all()), n
        assert bool((g != 0).any()), n


@pytest.mark.parametrize("S", [32, 20])
def test_serving_logits_unchanged_by_fp32_masters(S):
    """The same float32 weights stored in bf16 (serving) and kept in
    float32 and cast at use (training) give the same bf16 logits bit for
    bit, and both meet the JAX MambaLM of the training policy."""
    jm = jax_build_model(jax_get_reduced(ARCH), policy=JL.Policy(
        jnp.float32, jnp.bfloat16))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    state = params_from_jax(params)
    serve = _port_model("bfloat16", state)
    train = build_model(get_reduced(ARCH),
                        TL.Policy(torch.bfloat16, torch.float32),
                        "cpu").load_params(state)
    toks = np.random.default_rng(2).integers(0, 256, (2, S))
    got = train.apply(torch.from_numpy(toks))
    assert torch.equal(got, serve.apply(torch.from_numpy(toks)))
    want, _ = jm.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(toks))
    _close(got.float(), want, "bfloat16", scaled=True)
