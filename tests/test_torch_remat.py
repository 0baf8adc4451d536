"""Remat (activation recomputation) in the port against no remat and
against the JAX package's remat, on the CPU.

``remat`` "full" recomputes each layer (the ssm family's Mamba layer, the
transformer families' block, the hybrid's group of Mamba layers and its
shared block) in the backward; "dots" keeps the outputs of ``aten.mm`` /
``aten.addmm`` and recomputes the rest.  Both compute the same function as
"none":

* for each family's reduced model (dense, moe, audio, vlm, ssm, hybrid),
  the loss and every gradient under "full" and "dots" are bitwise those
  under "none", in fp32 and bf16 compute (one intra-op thread: this torch
  build's CPU kernels otherwise vary in the last bits from run to run);
* the same loss and gradients are within fp32's 3e-4 of ``jax.grad`` of the
  JAX model built with the same ``remat``;
* the recompute runs again what a forward runs (the fused norm's plain
  version twice a step under remat), and appends nothing twice: the moe
  aux losses count once;
* the Trainer's trace keeps a span for every launch, the recompute's too;
* ``--remat`` of the train launcher reaches the model.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import layers as JL
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import get_reduced
from repro_torch.kernels.fused_norm import ops as fused_ops
from repro_torch.models.bridge import params_from_jax
from repro_torch.models.layers import Policy
from repro_torch.models.registry import build_model
from repro_torch.runtime.train import loss_and_grads

FAMILIES = {"dense": "llama-20b-paper", "moe": "dbrx-132b",
            "audio": "musicgen-large", "vlm": "llama-3.2-vision-11b",
            "ssm": "mamba2-780m", "hybrid": "zamba2-2.7b"}
MODES = ("full", "dots")


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _batch(cfg, seed=0):
    """Tokens and labels [2, 32] (and the vlm's vision embeddings) as
    numpy arrays."""
    rng = np.random.default_rng(seed)
    b = {k: rng.integers(0, cfg.vocab_size, (2, 32))
         for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        b["vision_embeds"] = rng.standard_normal(
            (2, cfg.vision_tokens, cfg.vision_d)).astype(np.float32)
    return b


def _torch_batch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _port(arch, remat, compute=torch.float32, state=None):
    """The reduced model with ``remat``, from ``state`` or a seeded init
    (the vlm's gates opened: the init closes its cross layers)."""
    m = build_model(get_reduced(arch), Policy(compute, torch.float32), "cpu",
                    remat)
    if state is not None:
        return m.load_params(state)
    m.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for c in getattr(m, "cross", ()):
            c.attn.gate.fill_(0.5)
            c.gate_mlp.fill_(-0.7)
    return m


def _loss_and_grads(m, b):
    return loss_and_grads(m, _torch_batch(b), dict(m.named_parameters()))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_gives_the_loss_and_gradients_of_no_remat_bitwise(
        one_thread, family, mode, compute):
    arch = FAMILIES[family]
    dt = getattr(torch, compute)
    b = _batch(get_reduced(arch))
    loss0, grads0 = _loss_and_grads(_port(arch, "none", dt), b)
    loss, grads = _loss_and_grads(_port(arch, mode, dt), b)
    assert torch.equal(loss, loss0)
    assert set(grads) == set(grads0)
    for k, g in grads.items():
        assert torch.equal(g, grads0[k]), k


def _jax_pair(arch, remat):
    """The JAX reduced model built with ``remat`` (fp32) and its params,
    and the port's with the same remat and weights."""
    jm = jax_build_model(jax_get_reduced(arch), policy=JL.Policy(
        jnp.float32, jnp.float32), remat=remat)
    jp = jm.init(jax.random.PRNGKey(0))
    if "cross" in jp:                   # the JAX init closes the gates
        g = jp["cross"]["gate_mlp"].shape[0]
        jp["cross"]["attn"]["gate"] = jnp.full((g,), 0.5)
        jp["cross"]["gate_mlp"] = jnp.full((g,), -0.7)
    state = params_from_jax(jax.tree.map(np.asarray, jp))
    return jm, jp, _port(arch, remat, state=state)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_loss_and_gradients_match_the_jax_remat(family, mode):
    """fp32, 3e-4 in rtol and atol: the tolerance of the port's fp32
    training agreements (``tests/test_torch_train.py``)."""
    arch = FAMILIES[family]
    jm, jp, tm = _jax_pair(arch, mode)
    b = _batch(get_reduced(arch), seed=1)
    vis = b.get("vision_embeds")
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (loss_j, _), grads_j = jax.value_and_grad(
        lambda p: jm.loss(p, jb, vision_embeds=None if vis is None
                          else jb["vision_embeds"]), has_aux=True)(jp)
    want = params_from_jax(jax.tree.map(np.asarray, grads_j))
    loss_t, grads_t = _loss_and_grads(tm, b)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=3e-4,
                               atol=3e-4)
    assert set(grads_t) == set(want)
    for k, g in grads_t.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=3e-4, atol=3e-4,
                                   err_msg=k)


@pytest.mark.parametrize("mode", ("none", *MODES))
@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid"])
def test_remat_recomputes_each_layer_and_appends_nothing_twice(
        monkeypatch, family, mode):
    """A step's fused-norm forwards: as many as a forward runs, twice under
    remat (the recompute runs each unit again); the moe family's aux
    losses, one a layer, summed once into the loss."""
    arch = FAMILIES[family]
    cfg = get_reduced(arch)
    calls = []
    orig = fused_ops.fused_ref
    monkeypatch.setattr(fused_ops, "fused_ref",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    m = _port(arch, mode)
    b = _torch_batch(_batch(cfg))
    loss = m.loss(b["tokens"], b["labels"])
    per_forward = len(calls)
    torch.autograd.grad(loss, list(m.parameters()))
    assert len(calls) == per_forward * (1 if mode == "none" else 2)
    if family == "dense":
        assert per_forward == 2 * cfg.num_layers
    if family == "moe":
        h, _, _, auxs = m._blocks(m._embed(b["tokens"]),
                                  torch.arange(32)[None])
        assert len(auxs) == cfg.num_layers
        torch.autograd.grad(h.float().sum(), list(m.parameters()),
                            allow_unused=True)
        assert len(auxs) == cfg.num_layers
        _, aux = m.logits_and_aux(b["tokens"])
        with torch.no_grad():
            _, aux0 = _port(arch, "none").logits_and_aux(b["tokens"])
        torch.testing.assert_close(aux, aux0, rtol=0, atol=0)


def test_remat_is_one_of_the_references_modes():
    with pytest.raises(ValueError, match="remat is one of"):
        build_model(get_reduced("llama-20b-paper"), Policy(), "cpu",
                    "selective")


@pytest.mark.parametrize("mode", ("none", *MODES))
def test_launcher_remat_reaches_the_model(monkeypatch, capsys, tmp_path,
                                          mode):
    from repro_torch.launch import train as launch
    seen = []

    class Recording(launch.Trainer):
        def __init__(self, cfg, *a, **kw):
            super().__init__(cfg, *a, **kw)
            seen.append((cfg.remat, self.model.remat))

    monkeypatch.setattr(launch, "Trainer", Recording)
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "llama-20b-paper", "--reduced", "--device", "cpu",
        "--steps", "2", "--batch", "2", "--seq", "16", "--remat", mode,
        "--flare-log", str(tmp_path / "t.jsonl")])
    launch.main()
    assert seen == [(mode, mode)]
    assert "final loss:" in capsys.readouterr().out


@pytest.mark.parametrize("mode", ("none", *MODES))
def test_remat_trace_keeps_a_span_for_each_launch(tmp_path, mode):
    """The Trainer's trace under remat: the forward's kernel spans twice a
    step, the recompute's too (the recompute runs each unit to its end, so
    the last fused norm of a unit closes its span), each under its step."""
    from repro.core.events import load_jsonl
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train import RunConfig, Trainer
    cfg = get_reduced("llama-20b-paper")
    log = tmp_path / "t.jsonl"
    Trainer(RunConfig(model=cfg, global_batch=2, seq_len=16, steps=2,
                      warmup_steps=1, remat=mode, opt=AdamWConfig(),
                      flare_log=str(log), device="cpu")).train()
    runs = 1 if mode == "none" else 2
    events = load_jsonl(str(log))
    for name, n in (("flash_attention", cfg.num_layers),
                    ("fused_residual_rmsnorm", 2 * cfg.num_layers)):
        evs = [e for e in events if e.name == name]
        assert sorted(e.step for e in evs) == sorted(
            [0] * n * runs + [1] * n * runs), name
        assert all(e.meta["parent"] == f"step_{e.step}" for e in evs)
