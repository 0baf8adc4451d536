"""The port's serving slice against the JAX package, on the CPU.

* the port's ``Server`` and the JAX ``Server`` generate the same tokens from
  the same weights, for each family the port serves (dense, ssm, hybrid,
  audio, vlm: its gates opened and its vision embeddings a seeded draw);
* the port's JSONL trace reads back in the JAX package's event codec and
  metrics, with the JAX kernels' ``_meta`` flops;
* the port imports neither ``jax`` nor ``repro``;
* without an explicit CPU the port refuses to run where there is no card,
  and the kernel builder names ``nvcc`` when it is missing.
"""
import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.core.events import EventKind, load_jsonl
from repro.core.metrics import aggregate_step, steps_in
from repro.kernels.flash_attention.ops import _meta as jax_flash_meta
from repro.kernels.fused_norm.ops import _meta as jax_fused_meta
from repro.kernels.ssd_scan.ops import _meta as jax_ssd_meta
from repro.runtime.serve import ServeConfig as JaxServeConfig
from repro.runtime.serve import Server as JaxServer
from repro_torch import kernels as tk
from repro_torch.configs import get_reduced
from repro_torch.models.bridge import params_from_jax
from repro_torch.runtime.serve import ServeConfig, Server

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["llama3.2-1b", "qwen2-0.5b", "mamba2-780m", "zamba2-2.7b",
         "musicgen-large", "llama-3.2-vision-11b", "dbrx-132b", "arctic-480b"]
# prompt lengths: the mamba2 and zamba2 prompts span two chunks of the
# reduced configs (chunk 16), the second one ragged
PROMPT = {"llama3.2-1b": 10, "qwen2-0.5b": 10, "mamba2-780m": 20,
          "zamba2-2.7b": 20, "musicgen-large": 10,
          "llama-3.2-vision-11b": 10, "dbrx-132b": 10, "arctic-480b": 10}


def _serve_pair(arch, tmp_path, B=2, new=6):
    """(JAX tokens, port tokens, port trace path) from one set of weights."""
    S0 = PROMPT[arch]
    jcfg = JaxServeConfig(model=jax_get_reduced(arch), batch=B, max_seq=32,
                          compute_dtype="float32")
    jserver = JaxServer(jcfg)
    rng = np.random.default_rng(7)
    vis = None
    if jcfg.model.family == "vlm":
        # the JAX init closes the gates (0), so the cross layers would add
        # nothing; open them, and draw the vision embeddings
        cross = jserver.params["cross"]
        g = cross["gate_mlp"].shape[0]
        cross["attn"]["gate"] = jnp.full((g,), 0.5)
        cross["gate_mlp"] = jnp.full((g,), -0.7)
        vis = rng.standard_normal((B, jcfg.model.vision_tokens,
                                   jcfg.model.vision_d)).astype(np.float32)
    state = params_from_jax(jax.tree.map(np.asarray, jserver.params))
    trace = tmp_path / f"{arch}.jsonl"
    tserver = Server(ServeConfig(model=get_reduced(arch), batch=B, max_seq=32,
                                 compute_dtype="float32", device="cpu",
                                 log_path=str(trace)), params=state)
    prompts = rng.integers(0, jcfg.model.vocab_size,
                           (B, S0)).astype(np.int32)
    try:
        want = jserver.generate(prompts, new_tokens=new, vision_embeds=vis)
        got = tserver.generate(prompts, new_tokens=new, vision_embeds=vis)
    finally:
        jserver.close()
        tserver.close()
    return want, got, trace


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax_server(arch, tmp_path):
    want, got, _ = _serve_pair(arch, tmp_path)
    assert got.shape == want.shape == (2, PROMPT[arch] + 6)
    np.testing.assert_array_equal(got, want)


def test_trace_reads_back_in_the_jax_package(tmp_path):
    B, new = 2, 6
    S0 = PROMPT["llama3.2-1b"]
    _, _, trace = _serve_pair("llama3.2-1b", tmp_path, B, new)
    events = load_jsonl(str(trace))
    cfg = get_reduced("llama3.2-1b")
    L, H, hd = cfg.num_layers, cfg.num_heads, cfg.head_dim

    steps = {e.step: e for e in events if e.kind == EventKind.STEP}
    assert sorted(steps) == list(range(new + 1))
    assert steps[0].meta["tokens"] == B * S0
    assert all(steps[i].meta["tokens"] == B for i in range(1, new + 1))

    comp = [e for e in events if e.kind == EventKind.KERNEL_COMPUTE]
    flash = [e for e in comp if e.name == "flash_attention"]
    fused = [e for e in comp if e.name == "fused_residual_rmsnorm"]
    assert len(flash) == L
    assert len(fused) == 2 * L * (1 + new)
    q = jnp.zeros((B, S0, H, hd), jnp.float32)
    want = jax_flash_meta(q, None, None, causal=True)
    for e in flash:
        assert e.step == 0 and e.meta["parent"] == "step_0"
        assert e.meta["flops"] == want["flops"]
        assert e.meta["shape"] == want["shape"]
    for e in fused:
        R = B * S0 if e.step == 0 else B
        x = jnp.zeros((R, cfg.d_model), jnp.float32)
        w = jax_fused_meta(x, x, None)
        assert (e.meta["flops"], e.meta["bytes"], e.meta["shape"]) == (
            w["flops"], w["bytes"], w["shape"])
        assert e.meta["parent"] == f"step_{e.step}"
        assert e.start_ts >= e.issue_ts and e.end_ts >= e.start_ts

    by_rank = {0: events}
    assert steps_in(by_rank) == list(range(new + 1))
    m = aggregate_step(by_rank, 0)
    assert m.throughput > 0
    assert set(m.flops) == {"flash_attention", "fused_residual_rmsnorm"}


def test_mamba_trace_reads_back_in_the_jax_package(tmp_path):
    """The ssm server's spans: one ``ssd_scan`` per layer at the prefill,
    with the JAX ``_meta`` flops of the same call (chunk passed as a
    keyword), and L fused norms per forward."""
    B, new = 2, 6
    arch = "mamba2-780m"
    S0 = PROMPT[arch]
    _, _, trace = _serve_pair(arch, tmp_path, B, new)
    events = load_jsonl(str(trace))
    cfg = get_reduced(arch)
    L, H, P, N = (cfg.num_layers, cfg.ssm_heads, cfg.ssm_head_dim,
                  cfg.ssm_state)

    steps = {e.step: e for e in events if e.kind == EventKind.STEP}
    assert sorted(steps) == list(range(new + 1))
    comp = [e for e in events if e.kind == EventKind.KERNEL_COMPUTE]
    ssd = [e for e in comp if e.name == "ssd_scan"]
    fused = [e for e in comp if e.name == "fused_residual_rmsnorm"]
    assert len(ssd) == L
    assert len(fused) == L * (1 + new)
    want = jax_ssd_meta(jnp.zeros((B, S0, H, P)), None, None,
                        jnp.zeros((B, S0, N)), None, chunk=cfg.ssm_chunk)
    for e in ssd:
        assert e.step == 0 and e.meta["parent"] == "step_0"
        assert e.meta["flops"] == want["flops"]
        assert e.meta["shape"] == want["shape"]
        assert e.start_ts >= e.issue_ts and e.end_ts >= e.start_ts
    for e in fused:
        R = B * S0 if e.step == 0 else B
        assert e.meta["shape"] == [R, cfg.d_model]
        assert e.meta["parent"] == f"step_{e.step}"
    m = aggregate_step({0: events}, 0)
    assert set(m.flops) == {"ssd_scan", "fused_residual_rmsnorm"}


_BLOCK_IMPORTS = """
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
sys.meta_path.insert(0, Block())
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
print(" ".join(mods))
print(len(mods))
"""

# the diagnosis plane, the JAX package's numpy modules copied into the port:
# the engine and its detectors, the fleet and the trace archive
ENGINE_MODULES = tuple(f"repro_torch.core.{m}" for m in (
    "wasserstein", "metrics", "history", "regression", "failslow",
    "inspecting", "hang", "engine", "report", "detectors",
    "detectors.base", "detectors.registry", "detectors.builtins",
    "detectors.fleet")) + tuple(f"repro_torch.{m}" for m in (
        "fleet", "fleet.stream", "fleet.store", "fleet.multiplexer",
        "fleet.replay", "fleet.ipc", "archive", "archive.archive"))
# the resident fleet service over them, as numpy and stdlib as they are
SERVE_MODULES = tuple(f"repro_torch.serve.{m}" for m in (
    "protocol", "client", "tail", "checkpoint", "service", "query")) + (
        "repro_torch.serve",)
# the cluster simulator, its injectors and the scenario matrix, numpy
# copies of the reference's as well
SIM_MODULES = ("repro_torch.core.timeline", "repro_torch.core.injectors") \
    + tuple(f"repro_torch.core.injectors.{m}" for m in (
        "base", "registry", "builtins", "l4")) + ("repro_torch.scenarios",) \
    + tuple(f"repro_torch.scenarios.{m}" for m in (
        "base", "library", "runner"))


def test_port_imports_neither_jax_nor_repro():
    """Every module imports with jax and repro blocked, the diagnosis
    plane's 22 among them (the engine's 14, the fleet's 6, the archive's
    2), the service's 7 and the simulator's 10, and no source of the port,
    of chip_smoke.py, of the port's example scripts or of
    tools/sim_check.py names them in an import, even in a function; nor
    does the diagnosis plane, the service or the simulator name torch:
    they are numpy, as the reference's."""
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", _BLOCK_IMPORTS], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 62
    assert set(ENGINE_MODULES) <= set(out.stdout.split())
    assert set(SERVE_MODULES) <= set(out.stdout.split())
    assert set(SIM_MODULES) <= set(out.stdout.split())
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(examples) == 4
    files = [ROOT / "chip_smoke.py", ROOT / "tools" / "sim_check.py",
             *examples,
             *sorted((ROOT / "src" / "repro_torch").rglob("*.py"))]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    f"{f}: imports {n}"
    for m in ENGINE_MODULES + SERVE_MODULES + SIM_MODULES:
        rel = m.split(".")[1:]
        f = ROOT / "src" / "repro_torch" / Path(*rel[:-1]) / f"{rel[-1]}.py"
        if not f.exists():
            f = f.with_suffix("") / "__init__.py"
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = [a.name for a in node.names] \
                    if isinstance(node, ast.Import) else [node.module or ""]
                assert not any(n.split(".")[0] == "torch" for n in mods), \
                    f"{f}: imports torch"


def test_server_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: Server runs on it")
    assert ServeConfig(model=get_reduced("llama3.2-1b")).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        Server(ServeConfig(model=get_reduced("llama3.2-1b")))


@pytest.mark.parametrize("arch, limited", [("llama3.2-1b", True),
                                           ("mamba2-780m", False),
                                           ("zamba2-2.7b", True),
                                           ("llama-3.2-vision-11b", True)])
def test_generate_checks_the_models_cache_length(arch, limited):
    """The KV cache holds max_seq positions (the hybrid's too); the SSM
    state has no length."""
    server = Server(ServeConfig(model=get_reduced(arch), batch=1, max_seq=8,
                                compute_dtype="float32", device="cpu"))
    prompts = np.zeros((1, 6), np.int32)
    try:
        if limited:
            with pytest.raises(ValueError, match="max_seq 8"):
                server.generate(prompts, new_tokens=3)
        else:
            assert server.generate(prompts, new_tokens=3).shape == (1, 9)
    finally:
        server.close()


@pytest.mark.parametrize("device, ok", [("cuda", False), ("cpu", True)])
def test_launcher_serves_reduced_mamba_on_the_cpu_only(monkeypatch, capsys,
                                                        device, ok):
    from repro_torch.launch import serve as launch

    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "mamba2-780m", "--reduced", "--device", device,
        "--batch", "1", "--prompt-len", "20", "--new-tokens", "2"])
    if ok:
        launch.main()
        assert "generated (1, 22) tokens" in capsys.readouterr().out
    else:
        with pytest.raises(SystemExit) as e:
            launch.main()
        assert e.value.code == 2
        assert "--device cpu" in capsys.readouterr().err


@pytest.mark.parametrize("device, ok", [("cuda", False), ("cpu", True)])
def test_launcher_serves_reduced_llama_on_the_cpu_only(monkeypatch, capsys,
                                                        device, ok):
    """The reduced llama has head_dim 16, which the flash-attention kernels
    do not take: on the card the launcher refuses it before it builds a
    model."""
    from repro_torch.launch import serve as launch

    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "llama3.2-1b", "--reduced", "--device", device,
        "--batch", "1", "--prompt-len", "20", "--new-tokens", "2"])
    if ok:
        launch.main()
        assert "generated (1, 22) tokens" in capsys.readouterr().out
    else:
        with pytest.raises(SystemExit) as e:
            launch.main()
        assert e.value.code == 2
        err = capsys.readouterr().err
        assert "head_dim (64, 80, 128), not 16" in err and "--device cpu" in err


def test_builder_names_nvcc_when_missing(monkeypatch, tmp_path):
    monkeypatch.setattr(tk.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(tk, "CUDA_ROOTS", (str(tmp_path / "no-cuda"),))
    monkeypatch.setattr(tk, "BUILD_DIR", tmp_path / "build")
    kernel = tk.CudaKernel("fused_norm.cu", "fused_residual_rmsnorm_launch",
                           [])
    with pytest.raises(RuntimeError, match="nvcc"):
        kernel.launch()
    assert kernel.launches == 0


def test_daemon_times_cpu_ops_on_the_host(tmp_path):
    """A traced op on CPU tensors gets a host-timed k_comp span nested under
    its step, with the JAX kernel meta."""
    from repro_torch.core.daemon import DaemonConfig, TracingDaemon
    from repro_torch.kernels.fused_norm.ops import fused_residual_rmsnorm

    path = tmp_path / "t.jsonl"
    d = TracingDaemon(DaemonConfig(log_path=str(path),
                                   drain_interval=0.001)).attach()
    try:
        d.step_begin(0)
        x = torch.ones(4, 8)
        fused_residual_rmsnorm(x, x, torch.ones(8))
        d.step_end(tokens=4)
    finally:
        d.detach()
    ev = {e.kind: e for e in load_jsonl(str(path))}
    k = ev[EventKind.KERNEL_COMPUTE]
    assert k.name == "fused_residual_rmsnorm"
    assert k.meta["parent"] == "step_0" and k.meta["bytes"] == 4 * 32 * 4
    assert ev[EventKind.STEP].start_ts <= k.issue_ts <= k.start_ts <= k.end_ts


def test_daemon_keeps_a_step_whole_when_it_ends_during_a_flush(tmp_path):
    """A step that ends while the daemon thread flushes, after it drained
    the buffer: its kernel spans are held for the next flush, which holds
    the step span too, so each still nests under its step."""
    from repro_torch.core.daemon import DaemonConfig, TracingDaemon

    path = tmp_path / "t.jsonl"
    d = TracingDaemon(DaemonConfig(log_path=str(path)))
    d.step_begin(0)
    d.trace_call("fused_residual_rmsnorm", EventKind.KERNEL_COMPUTE,
                 torch.add, (torch.ones(4), torch.ones(4)), {})
    d._probe_pending()                  # the op's span is in the buffer
    drain = d.buffer.drain

    def drain_then_end_step():
        out = drain()
        d.buffer.drain = drain          # once
        d.step_end(tokens=4)
        return out

    d.buffer.drain = drain_then_end_step
    d._flush()
    d._flush(final=True)
    ev = {e.kind: e for e in load_jsonl(str(path))}
    assert ev[EventKind.KERNEL_COMPUTE].meta["parent"] == "step_0"


def test_daemon_keeps_no_traced_op_output_alive(tmp_path):
    """A traced op's span waits in the daemon's queue until the device
    completes it, but its outputs do not: freed by the caller, they are
    gone while the span is still queued (held, they would pin a step's
    activations, every layer's recompute under remat)."""
    import weakref
    from repro_torch.core.daemon import DaemonConfig, TracingDaemon

    d = TracingDaemon(DaemonConfig(log_path=str(tmp_path / "t.jsonl")))
    d.step_begin(0)
    out = d.trace_call("fused_residual_rmsnorm", EventKind.KERNEL_COMPUTE,
                       torch.add, (torch.ones(4), torch.ones(4)), {})
    ref = weakref.ref(out)
    del out
    assert d._pending.qsize() == 1       # the span is queued
    assert ref() is None                 # the output is not
    d._probe_pending()
    d.step_end(tokens=4)
    d._flush(final=True)
    assert [e.name for e in load_jsonl(str(tmp_path / "t.jsonl"))
            if e.kind == EventKind.KERNEL_COMPUTE] == ["fused_residual_rmsnorm"]
