"""The port's moe family (``models/moe.py`` and the moe ``TransformerLM``)
against the JAX package's, on the CPU.

Weights are drawn by the JAX init of the reduced ``dbrx-132b`` (2 layers,
d_model 64, 4 experts top-2) and ``arctic-480b`` (8 experts top-2 and the
dense residual MLP) and shared through ``params_from_jax``; inputs are
numpy draws.  The reduced configs set ``capacity_factor`` 8, at which no
token is dropped, so a wrong drop path would pass there: every comparison
also runs at ``capacity_factor`` 1 (``DROPS``), where the tests assert that
tokens are dropped, in the prefill and in the decode step.  Tolerances:
3e-4 at fp32, entry by entry; at bf16 5e-2 in relative norm, as
``tests/test_torch_vlm.py``; routing (expert ids) identical, its weights
and aux loss within 1e-6.
"""
import functools
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
from repro.models import moe as jmoe
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import get_config, get_reduced, scale
from repro_torch.models import layers as TL
from repro_torch.models import moe
from repro_torch.models.bridge import params_from_jax
from repro_torch.models.registry import build_model, kernel_refusal
from repro_torch.models.transformer import TransformerLM, init_std

ARCHS = ["dbrx-132b", "arctic-480b"]
DROPS = 1.0                 # a capacity factor at which tokens are dropped
TOL = {"float32": 3e-4, "bfloat16": 5e-2}
B, S = 8, 12


def _configs(arch, cf=None):
    ours, ref = get_reduced(arch), jax_get_reduced(arch)
    if cf is not None:
        ours = scale(ours, capacity_factor=cf)
        ref = jax_scale(ref, capacity_factor=cf)
    return ours, ref


def _close(got, want, dtype, err_msg=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg=err_msg)
    else:
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= TOL[dtype], f"{err_msg} relative error {err}"


@functools.lru_cache(maxsize=None)
def _jax_model(arch, dtype, cf=None, seed=0):
    """The JAX model, its parameters (numpy) and the port's state dict,
    drawn once a (arch, dtype, cf); no test writes into them."""
    _, ref = _configs(arch, cf)
    model = jax_build_model(ref, policy=JL.Policy(jnp.float32,
                                                  getattr(jnp, dtype)))
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed)))
    return model, params, params_from_jax(params)


def _port_model(arch, dtype, state, cf=None):
    cfg, _ = _configs(arch, cf)
    return build_model(cfg, TL.Policy(getattr(torch, dtype)),
                       "cpu").load_params(state)


class Dropped:
    """Counts the (token, choice) entries that ``moe.dispatch`` drops while
    entered (``expert_ff_local`` looks it up at each call)."""

    def __enter__(self):
        self.calls = []
        self.orig = moe.dispatch

        def counted(key, experts, capacity):
            dest, keep = self.orig(key, experts, capacity)
            self.calls.append(int((~keep).sum()))
            return dest, keep
        moe.dispatch = counted
        return self

    def __exit__(self, *exc):
        moe.dispatch = self.orig


def _layer0(params):
    """Layer 0's MoE tree of a JAX parameter tree."""
    return jax.tree.map(lambda a: a[0], params["layers"]["moe"])


# --------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_references(arch):
    for ours, ref in ((get_config(arch), jax_get_config(arch)),
                      (get_reduced(arch), jax_get_reduced(arch))):
        for f in ("family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "head_dim", "d_ff", "vocab_size",
                  "num_experts", "experts_per_token", "moe_dense_residual",
                  "capacity_factor", "rope_theta", "tie_embeddings"):
            assert getattr(ours, f) == getattr(ref, f), (ours.name, f)


COUNTS = {"dbrx-132b": (131_596_523_520, 36_469_708_800),
          "arctic-480b": (476_850_275_328, 15_584_314_368)}


@pytest.mark.parametrize("cut", ["full", "reduced", "one layer, 32 experts"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_are_the_references(arch, cut):
    """``param_count`` and ``active_param_count`` equal the reference's
    (the published numbers at full width), and the model the port builds
    holds ``param_count`` parameters (on the meta device)."""
    ours, ref = {
        "full": (get_config(arch), jax_get_config(arch)),
        "reduced": _configs(arch),
        "one layer, 32 experts": (
            scale(get_config(arch), num_layers=1, num_experts=32),
            jax_scale(jax_get_config(arch), num_layers=1, num_experts=32))}[cut]
    assert ours.param_count() == ref.param_count()
    assert ours.active_param_count() == ref.active_param_count()
    if cut == "full":
        assert (ours.param_count(), ours.active_param_count()) == COUNTS[arch]
    m = build_model(ours, device="meta")
    assert type(m) is TransformerLM
    assert sum(p.numel() for p in m.parameters()) == ours.param_count()


@pytest.mark.parametrize("tokens", [1, 2, 8, 96, 1000, 4096, 8192])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_is_the_references(arch, tokens):
    for cfg, ref in ((get_config(arch), jax_get_config(arch)),
                     _configs(arch), _configs(arch, DROPS)):
        assert moe.capacity(tokens, cfg) == jmoe._capacity(tokens, ref)
    # the card's paths: dbrx prefill 2561, arctic 161, decode the floor 4
    if tokens in (8, 8192):
        want = {("dbrx-132b", 8192): 2561, ("arctic-480b", 8192): 161}
        assert moe.capacity(tokens, get_config(arch)) == want.get(
            (arch, tokens), 4)


# ---------------------------------------------------------------- the MoE
def _moe_inputs(arch, T, seed=3):
    cfg, ref = _configs(arch, DROPS)
    params = _layer0(_jax_model(arch, "float32", DROPS)[1])
    x = np.random.default_rng(seed).standard_normal(
        (T, cfg.d_model)).astype(np.float32)
    return cfg, ref, params, x


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax(arch):
    """Expert ids identical, weights and the aux loss within 1e-6."""
    cfg, ref, params, x = _moe_inputs(arch, 96)
    eids_j, w_j, aux_j = jmoe.route(params, jnp.asarray(x), ref)
    eids, w, aux = moe.route(torch.tensor(params["router"]),
                             torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(eids.numpy(), np.asarray(eids_j))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-6,
                               atol=1e-6)
    assert w.dtype == torch.float32 and aux.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_ff_local_matches_jax_with_drops(arch, offset, dtype):
    """``expert_ff_local`` at a capacity that drops tokens, on all experts
    (offset 0) and on the last two of them (offset 2: the others' entries
    go to the junk bucket, as on one shard of the reference's expert
    mesh)."""
    cfg, ref, params, x = _moe_inputs(arch, 96)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    eids, w, _ = jmoe.route(params, jnp.asarray(x, jdt), ref)
    E = 2 if offset else cfg.num_experts
    ws = {n: params[n][offset:offset + E] for n in ("wi_gate", "wi_up", "wo")}
    C = moe.capacity(96, cfg)
    want = jmoe.expert_ff_local(jnp.asarray(x, jdt), eids, w, *(
        jnp.asarray(ws[n], jdt) for n in ("wi_gate", "wi_up", "wo")),
        offset, C)
    with Dropped() as d:
        got = moe.expert_ff_local(
            torch.from_numpy(x).to(tdt), torch.from_numpy(np.asarray(eids)),
            torch.from_numpy(np.asarray(w, np.float32)).to(tdt),
            *(torch.from_numpy(ws[n]).to(tdt)
              for n in ("wi_gate", "wi_up", "wo")), offset, C)
    assert got.dtype == tdt
    local = int(((np.asarray(eids) >= offset)
                 & (np.asarray(eids) < offset + E)).sum())
    assert d.calls[0] > eids.size - local, "no token dropped"
    _close(got.float(), want, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax_with_drops(arch):
    """The layer, [B, S, D] in and out, and its aux loss (fp32)."""
    cfg, ref, params, x = _moe_inputs(arch, B * S)
    x = x.reshape(B, S, -1)
    want, aux_j = jmoe.moe_apply(params, jnp.asarray(x), ref)
    layer = moe.MoE(cfg, torch.float32, "cpu")
    with torch.no_grad():
        for n, p in layer.named_parameters():
            p.copy_(torch.from_numpy(params[n]))
    with Dropped() as d:
        got, aux = moe.moe_apply(layer, torch.from_numpy(x), cfg,
                                 lambda t: t)
    assert d.calls[0] > 0, "no token dropped"
    _close(got.detach(), want, "float32")
    np.testing.assert_allclose(float(aux.detach()), float(aux_j), rtol=1e-6,
                               atol=1e-6)


def test_dispatch_keeps_the_first_entries_of_each_expert_in_flat_order():
    """Slots follow the flat index t·k + j within an expert; past the
    capacity, and for the junk bucket, the overflow slot E·C."""
    key = torch.tensor([1, 0, 1, 2, 1, 1, 0, 3])     # E 3, 3 the junk
    dest, keep = moe.dispatch(key, 3, 2)
    assert keep.tolist() == [True, True, True, True, False, False, True,
                             False]
    assert dest.tolist() == [2, 0, 3, 4, 6, 6, 1, 6]


# ------------------------------------------------------------ the model
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [None, DROPS], ids=["reduced", "drops"])
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_prefill_and_decode_match_jax(arch, cf, dtype):
    """apply, prefill (its logits and K/V cache) and a decode step (B 8
    tokens through the MoE) against the JAX TransformerLM; at
    ``capacity_factor`` 1 tokens are dropped in the prefill and in the
    decode step."""
    jm, params, state = _jax_model(arch, dtype, cf)
    tm = _port_model(arch, dtype, state, cf)
    toks = np.random.default_rng(1).integers(0, 256, (B, S + 1))
    jp = jax.tree.map(jnp.asarray, params)

    full_j, aux_j = jm.apply(jp, jnp.asarray(toks[:, :S]))
    toks_t = torch.from_numpy(toks)
    _close(tm.apply(toks_t[:, :S]).float(), full_j, dtype)

    last_j, cache_j = jm.prefill(jp, jnp.asarray(toks[:, :S]),
                                 jm.init_cache(B, S + 4))
    cache_t = tm.init_cache(B, S + 4)
    with Dropped() as prefill:
        last_t = tm.prefill(toks_t[:, :S], cache_t)
    _close(last_t.float(), last_j, dtype)
    for key in ("k", "v"):
        _close(cache_t[key].float(), cache_j[key], dtype, err_msg=key)

    step_j, _ = jm.decode_step(jp, jnp.asarray(toks[:, S:]), cache_j,
                               jnp.int32(S))
    with Dropped() as decode:
        step_t = tm.decode_step(toks_t[:, S:], cache_t, S)
    _close(step_t.float(), step_j, dtype)
    if cf == DROPS:
        assert min(prefill.calls) > 0 and max(decode.calls) > 0, (
            prefill.calls, decode.calls)
    else:
        assert not any(prefill.calls + decode.calls)


@pytest.mark.parametrize("cf", [None, DROPS], ids=["reduced", "drops"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_and_every_gradient_match_jax(arch, cf):
    """The loss (CE + 0.01 aux), the aux loss on its own (0.01 aux is
    below the loss's tolerance) and the gradient of every parameter, the
    routers' included, against ``jax.value_and_grad`` of the JAX
    ``TransformerLM.loss`` (fp32, 3e-4)."""
    jm, params, state = _jax_model(arch, "float32", cf)
    tm = _port_model(arch, "float32", state, cf)
    toks = np.random.default_rng(4).integers(0, 256, (B, S + 1))
    batch = {"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])}
    (loss_j, parts), grads_j = jax.value_and_grad(jm.loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params), batch)
    want = params_from_jax(jax.tree.map(np.asarray, grads_j))

    own = dict(tm.named_parameters())
    tt = torch.from_numpy(toks)
    _, aux_t = tm.logits_and_aux(tt[:, :-1])
    np.testing.assert_allclose(float(aux_t), float(parts["aux"]), rtol=3e-4,
                               atol=3e-4)
    assert float(parts["aux"]) > 1.0    # E·Σ f·p is 1 when balanced
    loss_t = tm.loss(tt[:, :-1], tt[:, 1:])
    _close(loss_t.detach(), np.asarray(loss_j), "float32")
    grads_t = torch.autograd.grad(loss_t, list(own.values()))
    assert set(own) == set(want)
    for n, g in zip(own, grads_t):
        assert bool((g != 0).any()), n
        _close(g, want[n], "float32", err_msg=n)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_names_every_parameter(arch):
    """``layers/moe/*`` [L, ...] become ``layers.<i>.moe.*`` (and arctic's
    ``layers/mlp/*`` ``layers.<i>.mlp.*``); every name and shape matches
    the port's model."""
    _, params, state = _jax_model(arch, "float32")
    cfg = get_reduced(arch)
    model = TransformerLM(cfg, TL.Policy(torch.float32), "cpu")
    own = dict(model.named_parameters())
    assert set(state) == set(own)
    for n, p in own.items():
        assert tuple(state[n].shape) == tuple(p.shape), n
    for i in range(cfg.num_layers):
        for n in ("router", "wi_gate", "wi_up", "wo"):
            np.testing.assert_array_equal(state[f"layers.{i}.moe.{n}"],
                                          params["layers"]["moe"][n][i])
        assert (f"layers.{i}.mlp.wo" in state) == cfg.moe_dense_residual
    E, D, F = cfg.num_experts, cfg.d_model, cfg.d_ff
    assert own["layers.1.moe.router"].shape == (D, E)
    assert own["layers.1.moe.wi_up"].shape == (E, D, F)
    assert own["layers.1.moe.wo"].shape == (E, F, D)


def test_init_std_of_the_moe_names():
    """The router and the experts' wi_* take d_model^-0.5, the experts' wo
    d_ff^-0.5 (the JAX ``moe_init``); a drawn model follows them."""
    cfg = scale(get_reduced("arctic-480b"), d_model=256, d_ff=512)
    for name, std in (("layers.0.moe.router", 256 ** -0.5),
                      ("layers.0.moe.wi_gate", 256 ** -0.5),
                      ("layers.0.moe.wi_up", 256 ** -0.5),
                      ("layers.0.moe.wo", 512 ** -0.5),
                      ("layers.0.mlp.wo", 512 ** -0.5),
                      ("layers.0.attn.wo", (4 * 16) ** -0.5)):
        assert init_std(cfg, name) == std, name
    m = TransformerLM(cfg, TL.Policy(torch.float32), "cpu")
    m.init(torch.Generator().manual_seed(0))
    p = dict(m.named_parameters())
    for name in ("layers.0.moe.router", "layers.1.moe.wi_gate",
                 "layers.0.moe.wo"):
        std = init_std(cfg, name)
        assert abs(float(p[name].detach().std()) / std - 1) < 0.05, name


def test_init_draws_large_tensors_in_slices(monkeypatch):
    """A tensor over ``INIT_DRAW`` elements is drawn a slice of its leading
    axis at a time, each with the tensor's stddev."""
    from repro_torch.models import lm
    monkeypatch.setattr(lm, "INIT_DRAW", 3000)
    cfg = scale(get_reduced("dbrx-132b"), d_model=32, d_ff=48)
    shapes = []
    randn = torch.randn

    def counted(shape, **kw):
        shapes.append(tuple(shape))
        return randn(shape, **kw)

    monkeypatch.setattr(torch, "randn", counted)
    m = TransformerLM(cfg, TL.Policy(torch.float32), "cpu")
    m.init(torch.Generator().manual_seed(0))
    assert max(np.prod(s) for s in shapes) <= 3000
    assert shapes.count((1, 32, 48)) == 2 * 2 * 4      # wi_gate, wi_up
    assert (256, 32) not in shapes                   # the embedding, in rows
    p = dict(m.named_parameters())
    assert abs(float(p["layers.0.moe.wo"].detach().std()) * 48 ** 0.5
               - 1) < 0.1


def test_forward_launches_at_full_width():
    """At full width on the meta device a forward runs flash once a layer
    and the fused norm twice (dbrx 40 and 80, arctic 35 and 70), and the
    MoE once a layer; a decode step the fused norm and the MoE alone."""
    from repro_torch.models import attention, transformer
    for arch, L in (("dbrx-132b", 40), ("arctic-480b", 35)):
        calls = {"flash": 0, "fused": 0, "moe": 0}
        cfg = get_config(arch)
        m = TransformerLM(cfg, device="meta")

        def flash(q, k, v, causal=True):
            calls["flash"] += 1
            return q

        def fused(out, x, scale, eps):
            calls["fused"] += 1
            return out, x

        def moe_apply(layer, x, cfg, w, mesh=None):
            calls["moe"] += 1
            return x, torch.zeros((), device="meta")

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(attention, "flash_attention", flash)
            mp.setattr(transformer, "fused", fused)
            mp.setattr(moe, "moe_apply", moe_apply)
            x = torch.empty((1, 4, cfg.d_model), device="meta",
                            dtype=torch.bfloat16)
            m._blocks(x, torch.arange(4, device="meta")[None])
            assert calls == {"flash": L, "fused": 2 * L, "moe": L}
            cache = m.init_cache(1, 8)
            calls.update(flash=0, fused=0, moe=0)
            m._blocks(x[:, :1], torch.full((1, 1), 4, device="meta"), cache,
                      4)
            assert calls == {"flash": 0, "fused": 2 * L, "moe": L}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_is_taken_on_the_card(arch):
    """hd 128 has flash kernels, and so has the reduced configs' 16."""
    assert kernel_refusal(get_config(arch)) is None
    assert kernel_refusal(get_reduced(arch)) is None


@pytest.mark.parametrize("device, ok", [("cuda", False), ("cpu", True)])
@pytest.mark.parametrize("entry", ["serve", "train"])
@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_run_reduced_moe_on_the_cpu_only(monkeypatch, capsys,
                                                   tmp_path, arch, entry,
                                                   device, ok):
    if entry == "serve":
        from repro_torch.launch import serve as launch
        argv = ["serve", "--arch", arch, "--reduced", "--device", device,
                "--batch", "2", "--prompt-len", "12", "--new-tokens", "2"]
        done = "generated (2, 14) tokens"
    else:
        from repro_torch.launch import train as launch
        argv = ["train", "--arch", arch, "--reduced", "--device", device,
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
