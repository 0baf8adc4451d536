"""The port's vlm ``TransformerLM`` against the JAX package's (CPU).

Weights are drawn by the JAX init of the reduced ``llama-3.2-vision-11b``
(one group: 4 self-attention layers and 1 gated cross-attention layer,
d_model 64, 4 heads over 2 KV heads of head_dim 16, 16 vision tokens of
width 64) and of a 10-layer ``scale`` of it (two groups), and shared through
``repro_torch.models.bridge.params_from_jax``.  The JAX init sets every
cross layer's gates to 0, so its cross layers add nothing; here they are set
to other values (``GATES``) in the JAX tree before it is bridged, and the
vision embeddings are a seeded normal draw, so a fault on the cross path
shows.  Tolerances: 3e-4 at fp32 (``tests/test_kernels.py``'s), entry by
entry; at bf16 5e-2 in relative norm, as ``tests/test_torch_zamba2.py``.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.configs import scale as jax_scale
from repro.models import layers as JL
from repro.models.registry import build_model as jax_build_model
from repro.models.registry import modality_inputs as jax_modality_inputs
from repro_torch.configs import get_config, get_reduced, scale
from repro_torch.models import layers as TL
from repro_torch.models.bridge import params_from_jax
from repro_torch.models.registry import (build_model, kernel_refusal,
                                         modality_inputs)
from repro_torch.models.transformer import TransformerLM

ARCH = "llama-3.2-vision-11b"
TOL = {"float32": 3e-4, "bfloat16": 5e-2}
GATES = {"gate": (0.5, -0.3), "gate_mlp": (-0.7, 0.4)}   # per group
GROUPS = [1, 2]
B, S = 2, 12


def _configs(groups):
    """(port config, JAX config) of ``groups`` groups of 4 + 1 layers."""
    ours, ref = get_reduced(ARCH), jax_get_reduced(ARCH)
    if groups != 1:
        ours = scale(ours, num_layers=5 * groups)
        ref = jax_scale(ref, num_layers=5 * groups)
    return ours, ref


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


def _set_gates(params):
    """The JAX tree's cross-layer gates set to ``GATES`` (group g takes
    entry g)."""
    cross = params["cross"]
    g = cross["gate_mlp"].shape[0]
    cross["attn"]["gate"] = np.asarray(GATES["gate"][:g], np.float32)
    cross["gate_mlp"] = np.asarray(GATES["gate_mlp"][:g], np.float32)
    return params


def _jax_model(dtype, groups=1, seed=0):
    _, ref = _configs(groups)
    model = jax_build_model(ref, policy=JL.Policy(jnp.float32,
                                                  getattr(jnp, dtype)))
    params = _set_gates(jax.tree.map(
        np.asarray, model.init(jax.random.PRNGKey(seed))))
    return model, params, params_from_jax(params)


def _port_model(dtype, state, groups=1):
    cfg, _ = _configs(groups)
    return build_model(cfg, TL.Policy(getattr(torch, dtype)),
                       "cpu").load_params(state)


def _vision(seed=5, batch=B):
    cfg = get_reduced(ARCH)
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.vision_tokens, cfg.vision_d)).astype(np.float32)


def _self_layers(a):
    """The JAX cache's [groups, per, ...] self-attention leaves as the
    port's [layers, ...]."""
    a = np.asarray(a)
    return a.reshape(-1, *a.shape[2:])


def test_full_config_is_the_reference():
    cfg, ref = get_config(ARCH), jax_get_config(ARCH)
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab_size", "head_dim", "cross_attn_every", "vision_tokens",
              "vision_d", "rope_theta", "tie_embeddings", "family"):
        assert getattr(cfg, f) == getattr(ref, f), f
    for f in ("num_layers", "d_model", "vision_tokens", "vision_d"):
        assert getattr(get_reduced(ARCH), f) == getattr(
            jax_get_reduced(ARCH), f), f


@pytest.mark.parametrize("name", ["full", "one group", "reduced",
                                  "reduced, two groups"])
def test_param_count_is_the_references_and_the_built_count_its_gap(name):
    """The analytic count equals the reference's (9,775,190,016 at full
    width; 2,141,241,344 for the one-group cut), and the model the port
    builds holds exactly the reference's gap more: each cross layer's
    ``kv_proj`` (vision_d x d_model) and ``gate_mlp``, less the d that the
    formula counts for the scalar ``gate``."""
    ours, ref = {
        "full": (get_config(ARCH), jax_get_config(ARCH)),
        "one group": (scale(get_config(ARCH), num_layers=5),
                      jax_scale(jax_get_config(ARCH), num_layers=5)),
        "reduced": _configs(1),
        "reduced, two groups": _configs(2)}[name]
    assert ours.param_count() == ref.param_count()
    assert ours.active_param_count() == ref.active_param_count()
    n_cross = ours.num_layers // (ours.cross_attn_every + 1)
    gap = n_cross * (ours.vision_d * ours.d_model + 2 - ours.d_model)
    m = TransformerLM(ours, device="meta")
    assert sum(p.numel() for p in m.parameters()) == ours.param_count() + gap
    if name == "full":
        assert ours.param_count() == 9_775_190_016
        assert ours.param_count() + gap == 9_909_374_992
    if name == "one group":
        assert ours.param_count() == 2_141_241_344
    if name.startswith("reduced"):          # the JAX model's leaves too
        jm = jax_build_model(ref)
        leaves = jax.tree.leaves(jax.eval_shape(jm.init,
                                                jax.random.PRNGKey(0)))
        assert sum(x.size for x in leaves) == ours.param_count() + gap


@pytest.mark.parametrize("layers", [5, 10, 40])
def test_layer_counts_are_the_references_and_the_models(layers):
    """``n_self``/``n_cross`` are the reference model's, and the port's
    model builds that many self-attention and cross layers."""
    cfg = scale(get_config(ARCH), num_layers=layers)
    ref = jax_build_model(jax_scale(jax_get_config(ARCH), num_layers=layers))
    assert (cfg.n_self, cfg.n_cross) == (ref.n_self, ref.n_cross)
    m = TransformerLM(cfg, device="meta")
    assert (len(m.layers), len(m.cross)) == (cfg.n_self, cfg.n_cross)


@pytest.mark.parametrize("layers", [4, 7, 11])
def test_model_refuses_a_depth_of_partial_groups(layers):
    """A vlm depth that is not whole groups of 4 + 1 layers is refused:
    the reference would build other layers than its counts name."""
    with pytest.raises(ValueError, match="multiple of 5, not"):
        TransformerLM(scale(get_reduced(ARCH), num_layers=layers),
                      device="meta")


def test_modality_inputs_are_the_references():
    for cfg, ref in ((get_config(ARCH), jax_get_config(ARCH)),
                     (get_config("musicgen-large"),
                      jax_get_config("musicgen-large"))):
        assert modality_inputs(cfg, 8) == jax_modality_inputs(ref, 8)
    assert modality_inputs(get_config(ARCH), 8) == {
        "vision_embeds": (8, 1600, 4096)}


@pytest.mark.parametrize("groups", GROUPS)
def test_bridge_names_every_parameter(groups):
    """``layers/*`` stacked on [groups, per] become ``layers.<g*per+j>.*``,
    ``cross/*`` on [groups] ``cross.<g>.*`` (scalar gates included); every
    name and shape matches the port's model."""
    _, params, state = _jax_model("float32", groups)
    cfg, _ = _configs(groups)
    model = TransformerLM(cfg, TL.Policy(torch.float32), "cpu")
    own = dict(model.named_parameters())
    assert set(state) == set(own)
    for n, p in own.items():
        assert tuple(state[n].shape) == tuple(p.shape), n
    per = cfg.cross_attn_every
    assert len(model.layers) == groups * per and len(model.cross) == groups
    for g in range(groups):
        for j in range(per):
            np.testing.assert_array_equal(
                state[f"layers.{g * per + j}.attn.wq"],
                params["layers"]["attn"]["wq"][g, j])
        np.testing.assert_array_equal(state[f"cross.{g}.kv_proj"],
                                      params["cross"]["kv_proj"][g])
        assert state[f"cross.{g}.attn.gate"].shape == ()
        assert state[f"cross.{g}.attn.gate"] == np.float32(GATES["gate"][g])
        assert state[f"cross.{g}.gate_mlp"] == np.float32(
            GATES["gate_mlp"][g])
    model.load_params(state)
    assert float(own["cross.0.gate_mlp"].detach()) == np.float32(
        GATES["gate_mlp"][0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups", GROUPS)
def test_logits_and_cache_match_jax(groups, dtype):
    """apply, prefill (logits and the whole cache: self-attention K/V of
    every layer, the cross layers' K/V of the vision embeddings) and
    decode_step logits against the JAX TransformerLM."""
    jm, params, state = _jax_model(dtype, groups)
    tm = _port_model(dtype, state, groups)
    toks = np.random.default_rng(1).integers(0, 256, (B, S + 1))
    vis = _vision()
    jp = jax.tree.map(jnp.asarray, params)
    jv, tv = jnp.asarray(vis), torch.from_numpy(vis)

    full_j, _ = jm.apply(jp, jnp.asarray(toks[:, :S]), vision_embeds=jv)
    full_t = tm.apply(torch.from_numpy(toks[:, :S]), tv)
    _close(full_t.float(), full_j, dtype)

    last_j, cache_j = jm.prefill(jp, jnp.asarray(toks[:, :S]),
                                 jm.init_cache(B, S + 4), vision_embeds=jv)
    cache_t = tm.init_cache(B, S + 4)
    last_t = tm.prefill(torch.from_numpy(toks[:, :S]), cache_t, tv)
    _close(last_t.float(), last_j, dtype)
    for key in ("k", "v"):
        assert cache_t[key].dtype == getattr(torch, dtype), key
        _close(cache_t[key].float(), _self_layers(cache_j[key]), dtype,
               err_msg=key)
    for key in ("cross_k", "cross_v"):
        assert tuple(cache_t[key].shape) == tuple(cache_j[key].shape)
        _close(cache_t[key].float(), cache_j[key], dtype, err_msg=key)

    step_j, _ = jm.decode_step(jp, jnp.asarray(toks[:, S:]), cache_j,
                               jnp.int32(S))
    step_t = tm.decode_step(torch.from_numpy(toks[:, S:]), cache_t, S)
    _close(step_t.float(), step_j, dtype)


@pytest.mark.parametrize("groups", GROUPS)
def test_decode_reproduces_apply(groups):
    """prefill at S, then decode steps at S and S + 1: each gives apply()'s
    logits at its position (fp32, 3e-4), the cross layers reading the
    cached K/V of the vision embeddings."""
    _, _, state = _jax_model("float32", groups)
    tm = _port_model("float32", state, groups)
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, 256, (B, S + 2)))
    vis = torch.from_numpy(_vision(7))
    full = tm.apply(toks, vis)
    cache = tm.init_cache(B, S + 8)
    last = tm.prefill(toks[:, :S], cache, vis)
    torch.testing.assert_close(last, full[:, S - 1], rtol=3e-4, atol=3e-4)
    for i in range(2):
        step = tm.decode_step(toks[:, S + i:S + i + 1], cache, S + i)
        torch.testing.assert_close(step, full[:, S + i], rtol=3e-4,
                                   atol=3e-4)


def test_logits_follow_the_vision_embeddings():
    """With the gates open, other vision embeddings give other logits; a
    call without them is refused."""
    _, _, state = _jax_model("float32")
    tm = _port_model("float32", state)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (B, S)))
    a = tm.apply(toks, torch.from_numpy(_vision(1)))
    b = tm.apply(toks, torch.from_numpy(_vision(2)))
    assert float((a - b).abs().max()) > 1e-2 * float(a.abs().max())
    with pytest.raises(ValueError, match="vision_embeds"):
        tm.apply(toks)


@pytest.mark.parametrize("groups", GROUPS)
def test_loss_and_cross_gradients_match_jax(groups):
    """The loss and its gradients against ``jax.grad`` of the JAX
    ``TransformerLM.loss`` (fp32, 3e-4): the embedding, the head, one
    self-attention layer and every parameter of every cross layer (the
    gates, ``kv_proj``, the norms, attention and MLP)."""
    jm, params, state = _jax_model("float32", groups)
    tm = _port_model("float32", state, groups)
    toks = np.random.default_rng(4).integers(0, 256, (B, S + 1))
    vis = _vision(9)
    batch = {"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])}
    (loss_j, _), grads_j = jax.value_and_grad(jm.loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params), batch, jnp.asarray(vis))
    want = params_from_jax(jax.tree.map(np.asarray, grads_j))

    own = dict(tm.named_parameters())
    loss_t = tm.loss(torch.from_numpy(toks[:, :-1]),
                     torch.from_numpy(toks[:, 1:]), torch.from_numpy(vis))
    names = [n for n in own if n.startswith(("embed.", "head.", "layers.1.",
                                             "cross."))]
    assert sum(n.startswith("cross.") for n in names) == 12 * groups
    grads_t = torch.autograd.grad(loss_t, [own[n] for n in names])
    _close(loss_t.detach(), np.asarray(loss_j), "float32")
    for n, g in zip(names, grads_t):
        assert bool((g != 0).any()), n
        _close(g, want[n], "float32", err_msg=n)


def test_init_follows_jax_distributions():
    """Random init: the gates 0 (the JAX init's constants), the norm scales
    1, ``kv_proj`` of stddev vision_d^-0.5 and the rest as the dense
    family's."""
    cfg = scale(get_reduced(ARCH), d_model=256, d_ff=512, vision_d=128,
                num_heads=8, num_kv_heads=4, head_dim=32)
    m = TransformerLM(cfg, TL.Policy(torch.float32), "cpu")
    m.init(torch.Generator().manual_seed(0))
    p = dict(m.named_parameters())
    for name in ("cross.0.attn.gate", "cross.0.gate_mlp"):
        assert p[name].shape == () and float(p[name].detach()) == 0.0, name
    for name in ("final_norm.scale", "cross.0.ln1.scale", "cross.0.ln2.scale",
                 "layers.3.ln2.scale"):
        assert torch.all(p[name] == 1), name
    for name, std in (("embed.embedding", 1.0),
                      ("head.w", 256 ** -0.5),
                      ("cross.0.kv_proj", 128 ** -0.5),
                      ("cross.0.attn.wq", 256 ** -0.5),
                      ("cross.0.attn.wo", 256 ** -0.5),
                      ("cross.0.mlp.wo", 512 ** -0.5),
                      ("layers.2.attn.wk", 256 ** -0.5)):
        assert abs(float(p[name].detach().std()) / std - 1) < 0.1, name
    jp = jax_build_model(jax_get_reduced(ARCH)).init(jax.random.PRNGKey(0))
    assert not np.asarray(jp["cross"]["attn"]["gate"]).any()
    assert not np.asarray(jp["cross"]["gate_mlp"]).any()


def test_forward_launches_at_full_width():
    """llama-3.2-vision-11b's counts on the meta device at full width: a
    forward runs flash 32 times (the self-attention layers; the cross
    layers take ``direct_attention``) and the fused residual + norm 80
    times (2 a layer, cross layers included); a decode step the fused norm
    80 times and flash never."""
    from repro_torch.models import attention, transformer
    calls = {"flash": 0, "fused": 0, "direct": 0}
    cfg = get_config(ARCH)
    m = TransformerLM(cfg, device="meta")
    direct = attention.direct_attention

    def flash(q, k, v, causal=True):
        calls["flash"] += 1
        return q

    def fused(out, x, scale, eps):
        calls["fused"] += 1
        return out, x

    def counted_direct(q, k, v, causal=True, q_offset=0):
        calls["direct"] += 1
        assert not causal and k.shape[1] == cfg.vision_tokens
        return direct(q, k, v, causal, q_offset)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention, "flash_attention", flash)
        mp.setattr(attention, "direct_attention", counted_direct)
        mp.setattr(transformer, "fused", fused)
        kw = dict(device="meta", dtype=torch.bfloat16)
        x = torch.empty((1, 4, cfg.d_model), **kw)
        vis = torch.empty((1, cfg.vision_tokens, cfg.vision_d), **kw)
        m._blocks(x, torch.arange(4, device="meta")[None], vision=vis)
        assert calls == {"flash": 32, "fused": 80, "direct": 8}
        cache = m.init_cache(1, 8)
        assert tuple(cache["k"].shape) == (32, 1, 8, 8, 128)
        assert tuple(cache["cross_k"].shape) == (8, 1, 1600, 8, 128)
        calls.update(flash=0, fused=0, direct=0)
        m._blocks(x[:, :1], torch.full((1, 1), 4, device="meta"), cache, 4)
        assert calls == {"flash": 0, "fused": 80, "direct": 8}


def test_training_policy_reaches_every_parameter():
    """float32 parameters, bf16 compute, open gates: one backward reaches
    every parameter, each cross layer's included, with a finite
    gradient."""
    _, _, state = _jax_model("float32", 2)
    cfg, _ = _configs(2)
    m = TransformerLM(cfg, TL.Policy(torch.bfloat16, torch.float32),
                      "cpu").load_params(state)
    params = dict(m.named_parameters())
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 17)))
    vis = torch.from_numpy(_vision(3))
    assert m.logits(toks[:, :-1], vis).dtype == torch.bfloat16
    grads = torch.autograd.grad(m.loss(toks[:, :-1], toks[:, 1:], vis),
                                list(params.values()))
    for n, g in zip(params, grads):
        assert g.dtype == torch.float32 and bool(g.isfinite().all()), n
        assert bool((g != 0).any()), n


def test_full_width_is_taken_on_the_card():
    """The flash kernels take the full config's head_dim 128 and the
    reduced config's 16."""
    assert kernel_refusal(get_config(ARCH)) is None
    assert kernel_refusal(scale(get_config(ARCH), num_layers=5)) is None
    assert kernel_refusal(get_reduced(ARCH)) is None


@pytest.mark.parametrize("device, ok", [("cuda", False), ("cpu", True)])
@pytest.mark.parametrize("entry", ["serve", "train"])
def test_launchers_run_reduced_vlm_on_the_cpu_only(monkeypatch, capsys,
                                                   tmp_path, entry, device,
                                                   ok):
    """``--arch llama-3.2-vision-11b --reduced`` serves and trains with
    ``--device cpu`` (on the stubbed vision frontend's ones) and on the
    card, whose kernels take its head_dim 16; without a card ``Server``
    and ``Trainer`` refuse ``--device cuda``."""
    if entry == "serve":
        from repro_torch.launch import serve as launch
        argv = ["serve", "--arch", ARCH, "--reduced", "--device", device,
                "--batch", "1", "--prompt-len", "12", "--new-tokens", "2"]
        done = "generated (1, 14) tokens"
    else:
        from repro_torch.launch import train as launch
        argv = ["train", "--arch", ARCH, "--reduced", "--device", device,
                "--steps", "3", "--batch", "2", "--seq",
                "16", "--flare-log", str(tmp_path / "t.jsonl")]
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
