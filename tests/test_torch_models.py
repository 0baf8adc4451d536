"""The port's layers and transformer (the dense and audio families) against
the JAX package (CPU).

Weights are drawn by the JAX init and shared through
``repro_torch.models.bridge.params_from_jax``; inputs are made with numpy.
Tolerances: 2e-3 at fp32 (as ``tests/test_models_smoke.py``), 5e-2 at bf16;
the audio family (``musicgen-large``'s reduced config) is also held to
3e-4 at fp32 and 5e-2 in relative norm at bf16 (``_close_norm``), as the
vlm family in ``tests/test_torch_vlm.py``.
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
from repro.models.registry import build_model
from repro_torch.configs import get_config, get_reduced
from repro_torch.models import layers as TL
from repro_torch.models.bridge import params_from_jax
from repro_torch.models.registry import kernel_refusal
from repro_torch.models.transformer import TransformerLM

AUDIO = "musicgen-large"
ARCHS = ["llama3.2-1b", "qwen2-0.5b", AUDIO]
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


def test_audio_config_is_the_reference():
    """musicgen-large: 48 layers, d_model 2048, 32 heads over 32 KV heads
    of head_dim 64, vocab 2048, untied, rope 1e4; its reduced cut too."""
    for ours, ref in ((get_config(AUDIO), jax_get_config(AUDIO)),
                      (get_reduced(AUDIO), jax_get_reduced(AUDIO))):
        for f in ("family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "d_ff", "vocab_size", "head_dim",
                  "rope_theta", "tie_embeddings", "qkv_bias"):
            assert getattr(ours, f) == getattr(ref, f), f
    assert get_config(AUDIO).family == "audio"


@pytest.mark.parametrize("arch", ARCHS)
def test_built_parameters_are_the_analytic_count(arch):
    """The model the port builds holds ``param_count`` parameters, full
    width (on the meta device) and reduced; musicgen-large 3,229,812,736,
    the reference's count."""
    for cfg, ref in ((get_config(arch), jax_get_config(arch)),
                     (get_reduced(arch), jax_get_reduced(arch))):
        assert cfg.param_count() == ref.param_count()
        m = TransformerLM(cfg, device="meta")
        assert sum(p.numel() for p in m.parameters()) == cfg.param_count()
    if arch == AUDIO:
        assert get_config(arch).param_count() == 3_229_812_736


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_audio_logits_and_cache_match_jax(dtype):
    """musicgen's reduced model: apply, prefill (logits and the whole K/V
    cache) and decode_step against the JAX TransformerLM, at 3e-4 (fp32)
    and 5e-2 in relative norm (bf16)."""
    jm, params, state = _jax_model(AUDIO, dtype)
    tm = _port_model(AUDIO, dtype, state)
    B, S = 2, 12
    toks = np.random.default_rng(1).integers(0, 128, (B, S + 1))
    jp = jax.tree.map(jnp.asarray, params)

    full_j, _ = jm.apply(jp, jnp.asarray(toks[:, :S]))
    _close_norm(tm.apply(torch.from_numpy(toks[:, :S])).float(), full_j,
                dtype)
    last_j, cache_j = jm.prefill(jp, jnp.asarray(toks[:, :S]),
                                 jm.init_cache(B, S + 4))
    cache_t = tm.init_cache(B, S + 4)
    last_t = tm.prefill(torch.from_numpy(toks[:, :S]), cache_t)
    _close_norm(last_t.float(), last_j, dtype)
    for key in ("k", "v"):
        assert tuple(cache_t[key].shape) == tuple(cache_j[key].shape)
        _close_norm(cache_t[key].float(), cache_j[key], dtype, key)
    step_j, _ = jm.decode_step(jp, jnp.asarray(toks[:, S:]), cache_j,
                               jnp.int32(S))
    step_t = tm.decode_step(torch.from_numpy(toks[:, S:]), cache_t, S)
    _close_norm(step_t.float(), step_j, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    """The loss and the gradient of every parameter against ``jax.grad`` of
    the JAX ``TransformerLM.loss`` (fp32, 3e-4)."""
    jm, params, state = _jax_model(arch, "float32")
    tm = _port_model(arch, "float32", state)
    V = get_reduced(arch).vocab_size
    toks = np.random.default_rng(4).integers(0, V, (2, 17))
    batch = {"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])}
    (loss_j, _), grads_j = jax.value_and_grad(jm.loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params), batch)
    want = params_from_jax(jax.tree.map(np.asarray, grads_j))
    own = dict(tm.named_parameters())
    loss_t = tm.loss(torch.from_numpy(toks[:, :-1]),
                     torch.from_numpy(toks[:, 1:]))
    grads_t = torch.autograd.grad(loss_t, list(own.values()))
    _close_norm(loss_t.detach(), np.asarray(loss_j), "float32")
    for n, g in zip(own, grads_t):
        _close_norm(g, want[n], "float32", n)


def test_audio_init_follows_jax_distributions():
    cfg = get_reduced(AUDIO).__class__(**{
        **get_reduced(AUDIO).__dict__, "d_model": 256, "d_ff": 512,
        "head_dim": 32, "num_heads": 8, "num_kv_heads": 8})
    m = TransformerLM(cfg, TL.Policy(torch.float32), "cpu")
    m.init(torch.Generator().manual_seed(0))
    p = dict(m.named_parameters())
    assert m.head is not None and torch.all(p["layers.1.ln1.scale"] == 1)
    for name, std in (("embed.embedding", 1.0), ("head.w", 256 ** -0.5),
                      ("layers.1.attn.wv", 256 ** -0.5),
                      ("layers.0.attn.wo", 256 ** -0.5),
                      ("layers.1.mlp.wo", 512 ** -0.5)):
        assert abs(float(p[name].detach().std()) / std - 1) < 0.1, name


def test_audio_forward_launches_at_full_width():
    """musicgen-large on the meta device at full width: a forward runs
    flash 48 times and the fused residual + norm 96 times; a decode step
    the fused norm 96 times and flash never."""
    from repro_torch.models import attention, transformer
    calls = {"flash": 0, "fused": 0}
    cfg = get_config(AUDIO)
    m = TransformerLM(cfg, device="meta")

    def flash(q, k, v, causal=True):
        calls["flash"] += 1
        return q

    def fused(out, x, scale, eps):
        calls["fused"] += 1
        return out, x

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention, "flash_attention", flash)
        mp.setattr(transformer, "fused", fused)
        x = torch.empty((1, 4, cfg.d_model), device="meta",
                        dtype=torch.bfloat16)
        m._blocks(x, torch.arange(4, device="meta")[None])
        assert calls == {"flash": 48, "fused": 96}
        calls.update(flash=0, fused=0)
        m._blocks(x[:, :1], torch.full((1, 1), 4, device="meta"),
                  m.init_cache(1, 8), 4)
        assert calls == {"flash": 0, "fused": 96}


@pytest.mark.parametrize("device, ok", [("cuda", False), ("cpu", True)])
@pytest.mark.parametrize("entry", ["serve", "train"])
def test_launchers_run_reduced_musicgen_on_the_cpu_only(monkeypatch, capsys,
                                                        tmp_path, entry,
                                                        device, ok):
    """``--arch musicgen-large --reduced`` serves and trains with
    ``--device cpu`` and on the card, whose kernels take its head_dim 16
    (without a card ``Server`` and ``Trainer`` refuse ``--device
    cuda``); the full config is taken."""
    assert kernel_refusal(get_config(AUDIO)) is None
    if entry == "serve":
        from repro_torch.launch import serve as launch
        argv = ["serve", "--arch", AUDIO, "--reduced", "--device", device,
                "--batch", "1", "--prompt-len", "12", "--new-tokens", "2"]
        done = "generated (1, 14) tokens"
    else:
        from repro_torch.launch import train as launch
        argv = ["train", "--arch", AUDIO, "--reduced", "--device", device,
                "--steps", "3", "--batch", "2", "--seq", "16",
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
