"""The port's training path against the JAX package, on the CPU.

* data: the port's loader gives the JAX ``ShardedLoader``'s batches bit
  for bit (mask modes none, naive and fast), naive masks equal fast ones,
  and a loader started at a later batch resumes the same stream;
* the train step: the reduced ``llama3.2-1b`` with the JAX init's weights
  (``params_from_jax``), three steps of the JAX ``make_train_step`` (jitted
  on the CPU) against the port's: in fp32 the loss, ``grad_norm`` and every
  parameter after each step within 3e-4; in bf16 the loss within 5e-2;
  two microbatches accumulated in float32;
* the ``Trainer`` with the FLARE daemon: the port's forms of
  ``tests/test_system.py`` (the loss falls; the spill reads back through
  the JAX package's ``load_jsonl`` with step, dataloader and k_comp events;
  ``train_step_exec`` carries 6·N·tokens flops; Case-3's v_inter);
* checkpoints (round trip of parameters and float32, bf16 and int8
  moments, keep-3, atomicity, manifests that the JAX
  ``CheckpointManager`` reads), resumed training equal to uninterrupted
  training bitwise, and the port's forms of ``tests/test_supervisor.py``;
* the launcher and ``Trainer`` refuse the card where they cannot run.

The ssm family (``mamba2-780m``'s reduced cut) takes the train-step,
Trainer and launcher checks too; the train step also runs the hybrid,
audio, vlm and moe families (the vlm with its gates opened and seeded
vision embeddings, which two microbatches split as they split the tokens;
the moe family's loss with its 0.01·aux, the capacity that of each
microbatch's tokens).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import get_reduced as jax_get_reduced
from repro.core.events import load_jsonl
from repro.core.metrics import aggregate_step, steps_in
from repro.data import DataConfig as JaxDataConfig
from repro.data import ShardedLoader as JaxShardedLoader
from repro.models.registry import build_model as jax_build_model
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.runtime.train import RunConfig as JaxRunConfig
from repro.runtime.train import make_train_step as jax_make_train_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_reduced
from repro_torch.core.anomaly import Anomaly, Team
from repro_torch.data import DataConfig, ShardedLoader
from repro_torch.data.masks import (mask_fast_linear, mask_naive_quadratic,
                                    materialize_from_starts,
                                    segment_ids_from_docs)
from repro_torch.models.bridge import params_from_jax
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.runtime.supervisor import SimulatedFault, Supervisor
from repro_torch.runtime.train import RunConfig, Trainer, make_train_step

ARCH = "llama3.2-1b"
SSM = "mamba2-780m"
HYBRID = "zamba2-2.7b"
AUDIO = "musicgen-large"
VLM = "llama-3.2-vision-11b"
MOE = ("dbrx-132b", "arctic-480b")


# ---------------------------------------------------------------------- data
@pytest.mark.parametrize("mask_mode", ["none", "naive", "fast"])
def test_loader_batches_equal_the_reference(mask_mode):
    kw = dict(vocab_size=500, batch=2, seq_len=64, seed=5,
              mask_mode=mask_mode)
    ours = ShardedLoader(DataConfig(**kw))
    ref = JaxShardedLoader(JaxDataConfig(**kw))
    for _ in range(3):
        a, b = ours.next_batch(), ref.next_batch()
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_mask_naive_equals_fast(rng):
    for _ in range(5):
        lens = rng.integers(1, 30, 4).tolist()
        seg = segment_ids_from_docs(lens, 64)
        np.testing.assert_array_equal(
            mask_naive_quadratic(seg),
            materialize_from_starts(mask_fast_linear(seg)))


@pytest.mark.parametrize("mask_mode", ["none", "fast"])
def test_loader_resumes_at_a_later_batch(mask_mode):
    cfg = DataConfig(vocab_size=300, batch=2, seq_len=32, mask_mode=mask_mode)
    full = ShardedLoader(cfg)
    batches = [full.next_batch() for _ in range(5)]
    later = ShardedLoader(cfg, start_step=3)
    later.start()                       # through the prefetch thread
    try:
        for want in batches[3:]:
            got = later.next_batch()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
    finally:
        later.stop()


# ---------------------------------------------------------------- train step
def _step_pair(arch, compute_dtype, microbatches=1, lr=1e-2):
    """The JAX and the port's train step on the same reduced model."""
    kw = dict(global_batch=4, seq_len=32, steps=10, warmup_steps=2,
              peak_lr=lr, compute_dtype=compute_dtype,
              num_microbatches=microbatches)
    jrun = JaxRunConfig(model=jax_get_reduced(arch), **kw)
    jm = jax_build_model(jrun.model, policy=jrun.policy())
    jp = jm.init(jax.random.PRNGKey(0))
    if jrun.model.family == "vlm":      # the JAX init closes the gates
        g = jp["cross"]["gate_mlp"].shape[0]
        jp["cross"]["attn"]["gate"] = jnp.full((g,), 0.5)
        jp["cross"]["gate_mlp"] = jnp.full((g,), -0.7)
    jo = jax_adamw_init(jp, jrun.opt)
    jstep = jax.jit(jax_make_train_step(jm, jrun))
    run = RunConfig(model=get_reduced(arch), device="cpu", **kw)
    trainer_model = Trainer(run).model
    trainer_model.load_params(params_from_jax(jax.tree.map(np.asarray, jp)))
    to = adamw_init(dict(trainer_model.named_parameters()), run.opt)
    return (jstep, jp, jo), (make_train_step(trainer_model, run),
                             trainer_model, to)


STEP_CASES = [("float32", 1), ("bfloat16", 1), ("float32", 2)]
STEP_ARCHS = [ARCH, SSM, HYBRID, AUDIO, VLM, *MOE]


@pytest.mark.parametrize(
    "arch, compute_dtype, microbatches",
    [(a, *c) for a in STEP_ARCHS for c in STEP_CASES],
    ids=[f"{d}-{m}" if a == ARCH else f"{a}-{d}-{m}"
         for a in STEP_ARCHS for d, m in STEP_CASES])
def test_train_steps_match_the_reference(arch, compute_dtype, microbatches):
    """Three steps of each family's reduced model (the mamba2 cut: 3
    layers, d_model 64, P 16, N 16, chunk 16, so S 32 is two chunks; the
    zamba2 cut: 2 groups of 2 such layers, each followed by the shared
    attention + MLP block; the vlm cut: one group of 4 self-attention
    layers and a cross layer over 16 vision tokens)."""
    (jstep, jp, jo), (tstep, tm, to) = _step_pair(arch, compute_dtype,
                                                  microbatches)
    cfg = get_reduced(arch)
    loader = ShardedLoader(DataConfig(vocab_size=cfg.vocab_size, batch=4,
                                      seq_len=32))
    rng = np.random.default_rng(11)
    for step in range(3):
        b = {k: v for k, v in loader.next_batch().items()
             if k in ("tokens", "labels")}
        if cfg.family == "vlm":
            b["vision_embeds"] = rng.standard_normal(
                (4, cfg.vision_tokens, cfg.vision_d)).astype(np.float32)
        jp, jo, jmet = jstep(jp, jo, {k: jnp.asarray(v) for k, v in
                                      b.items()}, jnp.int32(step))
        to, tmet = tstep(to, {k: torch.as_tensor(
            v, dtype=torch.long if k != "vision_embeds" else None)
            for k, v in b.items()}, step)
        if compute_dtype == "bfloat16":
            np.testing.assert_allclose(float(tmet["loss"]),
                                       float(jmet["loss"]), rtol=5e-2,
                                       atol=5e-2)
            continue
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=3e-4, atol=3e-4)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=3e-4,
                                   atol=3e-4)
        assert float(tmet["lr"]) == float(jmet["lr"])
        want = params_from_jax(jax.tree.map(np.asarray, jp))
        own = dict(tm.named_parameters())
        assert set(own) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(own[k].detach().numpy(), v, rtol=3e-4,
                                       atol=3e-4, err_msg=f"step {step} {k}")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-0.5b",
                                  "mamba2-780m", "zamba2-2.7b", AUDIO, VLM,
                                  *MOE])
def test_param_counts_equal_the_reference(arch):
    """The counts behind ``train_step_exec``'s 6·N·tokens flops."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    for ours, ref in ((get_config(arch), jax_get_config(arch)),
                      (get_reduced(arch), jax_get_reduced(arch))):
        assert ours.param_count() == ref.param_count()
        assert ours.active_param_count() == ref.active_param_count()


def test_parameters_are_fp32_masters_cast_to_bf16_at_use():
    t = Trainer(RunConfig(model=get_reduced(ARCH), device="cpu"))
    params = dict(t.model.named_parameters())
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in params.values())
    assert t.model.cast(params["layers.0.attn.wq"]).dtype == torch.bfloat16


# ------------------------------------------------------- Trainer with daemon
@pytest.fixture
def one_thread():
    """CPU math in one intra-op thread: with several, this torch build's
    CPU kernels give run-to-run differences in the last bits, which a few
    training steps amplify, so no two runs would be bitwise equal."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _train_with_log(log_path, *, steps=10, mask_mode="none", seq=64,
                    lr=1e-3, prefetch=True):
    run = RunConfig(model=get_reduced(ARCH), global_batch=4, seq_len=seq,
                    steps=steps, peak_lr=lr, warmup_steps=5,
                    opt=AdamWConfig(lr=lr), flare=True, mask_mode=mask_mode,
                    flare_log=log_path, data_prefetch=prefetch, device="cpu")
    t = Trainer(run)
    return t, t.train()


def test_train_loss_decreases_with_flare(tmp_path):
    log = str(tmp_path / "trace.jsonl")
    t, hist = _train_with_log(log, steps=30, lr=3e-3)
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.2, (first, last)
    assert 0 < t.daemon.bytes_logged < 5e6
    events = load_jsonl(log)                 # the JAX package's reader
    kinds = {e.kind.value for e in events}
    assert {"step", "dataloader", "k_comp"} <= kinds
    tokens = 4 * 64
    flops = 6.0 * get_reduced(ARCH).active_param_count() * tokens
    by_name = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e)
    assert len(by_name["train_step_exec"]) == 30
    assert all(e.meta["flops"] == flops and e.kind.value == "k_comp"
               for e in by_name["train_step_exec"])
    assert all(e.meta["tokens"] == tokens
               for e in by_name["dataloader.next_batch"])
    steps = [e for e in events if e.kind.value == "step"]
    assert sorted(e.step for e in steps) == list(range(30))
    assert all(e.meta["tokens"] == tokens and np.isfinite(e.meta["loss"])
               for e in steps)
    # the forward ops keep their spans, under their step; 2 layers
    assert len(by_name["flash_attention"]) == 2 * 30
    assert len(by_name["fused_residual_rmsnorm"]) == 4 * 30
    assert all(e.meta["parent"] == f"step_{e.step}"
               for e in by_name["flash_attention"])
    assert [h["step"] for h in hist] == list(range(30))
    assert set(hist[0]) == {"step", "loss", "lr", "grad_norm", "step_time_s",
                            "tokens_per_s"}


def test_train_mamba2_with_flare(tmp_path):
    """The ssm family through the same loop: the loss falls; the spill
    reads back through the JAX package's ``load_jsonl`` with a step,
    dataloader and ``train_step_exec`` span per step, and the forward's
    ``ssd_scan`` and ``fused_residual_rmsnorm`` spans (L a step each) under
    their step; the daemon's backend is ``ssm-train``."""
    log = str(tmp_path / "trace.jsonl")
    steps, tokens = 12, 4 * 32
    run = RunConfig(model=get_reduced(SSM), global_batch=4, seq_len=32,
                    steps=steps, peak_lr=3e-3, warmup_steps=3,
                    opt=AdamWConfig(lr=3e-3), flare=True, flare_log=log,
                    device="cpu")
    t = Trainer(run)
    hist = t.train()
    assert t.daemon.cfg.backend == "ssm-train"
    first = np.mean([h["loss"] for h in hist[:3]])
    last = np.mean([h["loss"] for h in hist[-3:]])
    assert last < first - 0.2, (first, last)
    events = load_jsonl(log)
    by_name = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e)
    flops = 6.0 * get_reduced(SSM).active_param_count() * tokens
    assert [e.meta["flops"] for e in by_name["train_step_exec"]] == \
        [flops] * steps
    assert sorted(e.step for e in events if e.kind.value == "step") == \
        list(range(steps))
    assert all(e.meta["tokens"] == tokens
               for e in by_name["dataloader.next_batch"])
    layers = get_reduced(SSM).num_layers
    for name, keys in (("ssd_scan", {"flops", "shape"}),
                       ("fused_residual_rmsnorm", {"flops", "bytes",
                                                   "shape"})):
        evs = by_name[name]
        assert len(evs) == layers * steps, name
        assert all(keys <= set(e.meta) and e.kind.value == "k_comp"
                   and e.meta["parent"] == f"step_{e.step}" for e in evs)


def test_case3_v_inter_from_real_events(tmp_path, one_thread):
    """naive O(L^2) mask generation must raise v_inter vs the fast path.

    One intra-op thread: with several in each of the suite's worker
    processes, oversubscribed cores slow the step's CPU math far more than
    the single-threaded mask loop, which is not the regime Case-3 is
    about."""
    def v_inter_for(mask_mode):
        log = str(tmp_path / f"{mask_mode}.jsonl")
        _train_with_log(log, steps=6, mask_mode=mask_mode, seq=512,
                        prefetch=False)
        by_rank = {0: load_jsonl(log)}
        return float(np.mean([aggregate_step(by_rank, s).v_inter
                              for s in steps_in(by_rank)[2:]]))

    v_fast = v_inter_for("fast")
    v_naive = v_inter_for("naive")
    assert v_naive > 2.0 * v_fast, (v_fast, v_naive)
    assert v_naive > 0.05, v_naive


# --------------------------------------------------------------- checkpoints
def _state(sd, seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"layers.0.w": torch.randn(3, 300, generator=g),
              "final_norm.scale": torch.randn(5, generator=g)}
    cfg = AdamWConfig(state_dtype=sd)
    opt = adamw_init(params, cfg)
    adamw_update({k: torch.randn(p.shape, generator=g) for k, p in
                  params.items()}, opt, params, cfg, 1e-2)
    return {"params": params, "opt": opt}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("sd", ["float32", "bfloat16", "int8"])
def test_checkpoint_roundtrip(tmp_path, sd):
    cm = CheckpointManager(str(tmp_path))
    saved = _state(sd, seed=1)
    cm.save(4, saved, {"loss": 1.5})
    fresh = _state(sd, seed=2)
    cm.restore(fresh)
    a, b = _leaves(saved), _leaves(fresh)
    assert set(a) == set(b)
    assert "opt/mu_nu/layers.0.w/m" + ("/q" if sd == "int8" else "") in a
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    man = cm.metadata(4)
    assert man["metadata"] == {"loss": 1.5} and man["step"] == 4
    dtypes = {v["dtype"] for v in man["arrays"].values()}
    assert {"float32", "int32"} <= dtypes
    assert ("bfloat16" in dtypes) == (sd == "bfloat16")
    assert ("int8" in dtypes) == (sd == "int8")
    assert man["arrays"]["params/layers.0.w"] == {
        "file": "params__layers.0.w.npy", "shape": [3, 300],
        "dtype": "float32"}


def test_checkpoint_keeps_three_and_the_reference_reads_them(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    for s in (1, 3, 5, 9, 11):
        cm.save(s, _state("bfloat16"), {"step": s})
    assert cm.all_steps() == [5, 9, 11]
    ref = JaxCheckpointManager(str(tmp_path))
    assert ref.all_steps() == [5, 9, 11] and ref.latest_step() == 11
    assert ref.metadata(9)["metadata"]["step"] == 9
    assert ref.metadata()["arrays"] == cm.metadata()["arrays"]


def test_checkpoint_atomicity(tmp_path):
    """A .tmp dir from a crashed save must never be listed as a step."""
    cm = CheckpointManager(str(tmp_path))
    cm.save(2, {"x": torch.ones(3)})
    os.makedirs(str(tmp_path / "step_00000007.tmp"))
    assert cm.all_steps() == [2]
    assert cm.latest_step() == 2
    with pytest.raises(KeyError, match="missing"):
        cm.restore({"x": torch.ones(3), "y": torch.ones(2)})


def _run(tmp_path, ckpt=None, fault_hook=None, steps=6):
    run = RunConfig(model=get_reduced(ARCH), global_batch=2, seq_len=32,
                    steps=steps, warmup_steps=2, peak_lr=1e-3,
                    opt=AdamWConfig(lr=1e-3, state_dtype="int8"),
                    checkpoint_dir=ckpt, checkpoint_every=2, flare=False,
                    device="cpu")
    return Trainer(run, fault_hook=fault_hook)


def test_resumed_training_equals_uninterrupted(tmp_path, one_thread):
    whole = _run(tmp_path)
    hist = whole.train()
    crashed = {"flag": False}

    def fault_hook(step):
        if step == 4 and not crashed["flag"]:
            crashed["flag"] = True
            raise SimulatedFault("injected node failure at step 4")

    sup = Supervisor(max_restarts=1)
    ckpt = str(tmp_path / "ckpt")
    resumed = []
    hist2 = sup.run(lambda: resumed.append(_run(tmp_path, ckpt, fault_hook))
                    or resumed[-1], steps=6)
    assert sup.restarts == 1
    assert [h["step"] for h in hist2] == [0, 1, 2, 3, 4, 5]
    assert [h["loss"] for h in hist2] == [h["loss"] for h in hist]
    final = dict(resumed[-1].model.named_parameters())
    for k, p in whole.model.named_parameters():
        assert torch.equal(p, final[k]), k
    _, opt_a = whole.final_state
    _, opt_b = resumed[-1].final_state
    assert torch.equal(opt_a["count"], opt_b["count"])
    for k in opt_a["mu_nu"]:
        for m in ("m", "v"):
            for f in ("q", "scale"):
                assert torch.equal(opt_a["mu_nu"][k][m][f],
                                   opt_b["mu_nu"][k][m][f])


# ---------------------------------------------------------------- supervisor
def test_restart_from_checkpoint_continues(tmp_path):
    cfg = get_reduced("qwen2-0.5b")
    crashed = {"flag": False}

    def fault_hook(step):
        if step == 6 and not crashed["flag"]:
            crashed["flag"] = True
            raise SimulatedFault("injected node failure at step 6")

    def make_trainer():
        run = RunConfig(model=cfg, global_batch=2, seq_len=32, steps=10,
                        peak_lr=1e-3, opt=AdamWConfig(lr=1e-3),
                        checkpoint_dir=str(tmp_path), checkpoint_every=2,
                        flare=False, device="cpu")
        return Trainer(run, fault_hook=fault_hook)

    sup = Supervisor(max_restarts=2)
    hist = sup.run(make_trainer, steps=10)
    assert sup.restarts == 1
    steps = [h["step"] for h in hist]
    assert steps[-1] == 9
    assert set(range(10)) <= set(steps)
    assert any(a.kind == "restart" for a in sup.actions)


def test_apply_diagnosis_runbook():
    sup = Supervisor()
    anomalies = [
        Anomaly(kind="hang", metric="intra_kernel_inspecting",
                team=Team.OPERATIONS, root_cause="link 3->4", ranks=[3, 4]),
        Anomaly(kind="fail_slow", metric="throughput",
                team=Team.OPERATIONS, root_cause="underclock", ranks=[7]),
        Anomaly(kind="regression", metric="issue_latency",
                team=Team.ALGORITHM, root_cause="gc"),
    ]
    kinds = [a.kind for a in sup.apply_diagnosis(anomalies)]
    assert "isolate" in kinds and "restart" in kinds and "drain" in kinds
    assert not any(set(a.ranks) == set() and a.kind == "drain"
                   for a in sup.actions)


# ------------------------------------------------------------------ refusals
def test_trainer_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: Trainer runs on it")
    assert RunConfig(model=get_reduced(ARCH)).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(RunConfig(model=get_reduced(ARCH)))


@pytest.mark.parametrize("device, ok", [("cuda", False), ("cpu", True)])
def test_launcher_trains_reduced_llama_on_the_cpu_only(monkeypatch, capsys,
                                                        tmp_path, device, ok):
    from repro_torch.launch import train as launch

    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", ARCH, "--reduced", "--device", device, "--steps",
        "3", "--batch", "2", "--seq", "16", "--flare-log",
        str(tmp_path / "t.jsonl")])
    if ok or torch.cuda.is_available():
        # the card takes the reduced config as it is
        launch.main()
        assert "final loss:" in capsys.readouterr().out
        assert load_jsonl(str(tmp_path / "t.jsonl"))
    else:
        # no card here: Server or Trainer refuses to build on CUDA
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch.main()


@pytest.mark.parametrize("device, ok", [("cuda", False), ("cpu", True)])
def test_launcher_trains_reduced_mamba2_on_the_cpu_only(monkeypatch, capsys,
                                                         tmp_path, device,
                                                         ok):
    """``--arch mamba2-780m --reduced`` trains with ``--device cpu`` and
    on the card, whose SSD-scan kernels take its P 16, N 16, chunk 16;
    without a card ``Trainer`` refuses ``--device cuda``."""
    from repro_torch.launch import train as launch

    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", SSM, "--reduced", "--device", device, "--steps",
        "3", "--batch", "2", "--seq", "32", "--flare-log",
        str(tmp_path / "t.jsonl")])
    if ok or torch.cuda.is_available():
        # the card takes the reduced config as it is
        launch.main()
        assert "final loss:" in capsys.readouterr().out
        assert any(e.name == "ssd_scan"
                   for e in load_jsonl(str(tmp_path / "t.jsonl")))
    else:
        # no card here: Server or Trainer refuses to build on CUDA
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch.main()


def test_trainer_builds_mamba2_on_the_card_by_default():
    """Without a card, a ``Trainer`` of the full mamba2-780m that does not
    ask for the CPU raises, as the dense family's does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: Trainer runs on it")
    from repro_torch.configs import get_config
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(RunConfig(model=get_config(SSM)))
