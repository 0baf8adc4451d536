"""The port's op analysis (``launch/op_analysis.py``), dry-run
(``launch/dryrun.py``) and kernels' ``work`` against the JAX package's
``launch/hlo_analysis.py`` and ``launch/dryrun.py`` (CPU).

* The op analysis reproduces ``analyze_hlo``'s flops exactly on the four
  cases of ``tests/test_hlo_analysis.py`` written in torch (12 chained 128²
  products, 3 x 5 nested 64² products, ``bik,bkj``), keeps 10 elementwise
  passes' traffic within [10, 80] one-pass bytes as ``analyze_hlo`` does,
  and counts a reduced model's forward (B 2 x S 64, ``attn_impl="direct"``)
  within 1 % of ``analyze_hlo`` on the jitted JAX forward (exactly, in
  fact: no product is on one side only).
* The dry-run's copies (``SHAPES``, ``cells``, ``dryrun_policy``) equal the
  reference's but for the declared ``attn_impl`` default; ``cache_specs``
  equals the reference's for every family on both production meshes (a
  ``FakeMesh``, as ``tests/test_torch_sharding.py``).
* ``argument_bytes`` is exact: a subprocess with 512 forced XLA host
  devices (as ``tests/test_dryrun_cells.py``) sums the reference's per-device
  bytes from ``build_cell``'s inputs (``sharding.shard_shape`` x itemsize,
  no compile), and the port's equals it, to the byte, on every cell of both
  meshes; ``local_shape`` equals ``shard_shape`` leaf by leaf.  The
  committed ``dryrun_out/mamba2-780m_long_500k_16-16.json`` (583,345,348 B,
  XLA's count) is that sum less the 4 bytes of the int32 ``pos``, which the
  SSM decode leaves unused and XLA drops (the subprocess compiles the cell
  to show it).
* Each kernel's ``work`` gives the bound column of ``PERF.md`` §6 at its
  rows' shapes under ``chip_smoke.py``'s peaks.
* ``python -m repro_torch.launch.dryrun`` prints ``OK`` rows with ``dom=``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import cells as jax_cells
from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
# the reference's dry-run sets XLA_FLAGS for 512 host devices when it is
# imported; the flag is put back at once, so that this process, and the
# test modules that pytest imports beside this one, keep one device
_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as RD  # noqa: E402
if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS
from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa
from repro_torch.configs import (SHAPES, cells, get_config,  # noqa: E402
                                 get_reduced)
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.fused_norm import ops as fn  # noqa: E402
from repro_torch.kernels.padded_matmul import ops as mm  # noqa: E402
from repro_torch.kernels.ring_reduce import ops as ring  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.op_analysis import analyze  # noqa: E402
from repro_torch.models import attention as attn_lib  # noqa: E402
from repro_torch.models.layers import Policy  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.transformer import AttnImpl  # noqa: E402
from repro_torch.parallel.sharding import (Spec, local_shape,  # noqa: E402
                                           named, shaped_with_sharding)

ROOT = Path(__file__).resolve().parents[1]


class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}
    size = 256


class FakePodMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}
    size = 512


MESHES = {False: FakeMesh(), True: FakePodMesh()}


def _meta(*shape):
    return torch.empty(*shape, device="meta")


def _hlo(fn_, *specs):
    return analyze_hlo(jax.jit(fn_).lower(*specs).compile().as_text())


# --------------------------------------------------------------------------- #
# the op analysis against analyze_hlo
# --------------------------------------------------------------------------- #
def test_chained_products():
    def port(x):
        for _ in range(12):
            x = x @ x + 1.0
        return x.sum()

    def ref(x):
        y, _ = jax.lax.scan(lambda x, _: (jnp.dot(x, x) + 1.0, None), x,
                            None, length=12)
        return jnp.sum(y)

    want = _hlo(ref, jax.ShapeDtypeStruct((128, 128), jnp.float32))["flops"]
    assert analyze(port, _meta(128, 128))["flops"] == want \
        == 12 * 2 * 128 ** 3


def test_nested_products():
    def port(x):
        for _ in range(5):
            for _ in range(3):
                x = x @ x
        return x.sum()

    def ref(x):
        def outer(x, _):
            y, _ = jax.lax.scan(lambda x, _: (jnp.dot(x, x), None), x,
                                None, length=3)
            return y, None
        y, _ = jax.lax.scan(outer, x, None, length=5)
        return jnp.sum(y)

    want = _hlo(ref, jax.ShapeDtypeStruct((64, 64), jnp.float32))["flops"]
    assert analyze(port, _meta(64, 64))["flops"] == want == 15 * 2 * 64 ** 3


def test_contracting_dims():
    a, b = (4, 32, 64), (4, 64, 16)
    want = _hlo(lambda a, b: jnp.einsum("bik,bkj->bij", a, b),
                jax.ShapeDtypeStruct(a, jnp.float32),
                jax.ShapeDtypeStruct(b, jnp.float32))["flops"]
    got = analyze(lambda a, b: torch.einsum("bik,bkj->bij", a, b),
                  _meta(*a), _meta(*b))["flops"]
    assert got == want == 2 * 4 * 32 * 16 * 64


def test_elementwise_traffic_within_the_references_bounds():
    def port(x):
        for _ in range(10):
            x = x * 2.0 + 1.0
        return x

    def ref(x):
        y, _ = jax.lax.scan(lambda x, _: (x * 2.0 + 1.0, None), x, None,
                            length=10)
        return y

    one = 1024 * 1024 * 4
    got = analyze(port, _meta(1024, 1024))["traffic_bytes"]
    want = _hlo(ref, jax.ShapeDtypeStruct((1024, 1024), jnp.float32))[
        "traffic_bytes"]
    for t in (got, want):
        assert 10 * one <= t <= 80 * one
    assert got == 40 * one      # 20 eager ops, each one read and one write


def test_the_analysis_counts_meta_tensors_only():
    """A tensor on a device, as an argument or met inside ``fn``, raises:
    the kernels' meta routes and the collectives' meta branches are taken
    by device, so an analysis over device tensors would count nothing of
    them."""
    with pytest.raises(ValueError, match="meta tensors only"):
        analyze(lambda x: x * 2, torch.ones(4))
    y = torch.ones(4)
    with pytest.raises(ValueError, match="meta tensors only"):
        analyze(lambda: y * 2)
    assert analyze(lambda x: x * 2, _meta(4))["traffic_bytes"] == 2 * 4 * 4


def test_views_are_free_and_copies_cost_twice():
    x = _meta(64, 32)
    assert analyze(lambda x: x.view(32, 64).t()[:4], x)["traffic_bytes"] == 0
    assert analyze(lambda x: x.t().contiguous(), x)["traffic_bytes"] == \
        2 * 64 * 32 * 4
    upd = _meta(8, 32)
    idx = torch.empty(8, dtype=torch.long, device="meta")
    assert analyze(lambda x: x.index_copy(0, idx, upd), x)[
        "traffic_bytes"] == 2 * 8 * 32 * 4


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-0.5b",
                                  "llama-3.2-vision-11b", "dbrx-132b"])
def test_reduced_forward_flops_match_analyze_hlo(arch):
    """B 2 x S 64, ``attn_impl="direct"``: every product of the JAX forward
    is a product of the port's (the MoE's expert products and the VLM's
    cross layer too), so the counts are equal."""
    cfg = jax_get_reduced(arch)
    jm = jax_build_model(cfg, attn_impl="direct")
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    toks = jax.ShapeDtypeStruct((2, 64), jnp.int32)
    port = build_model(get_reduced(arch), Policy(torch.bfloat16,
                                                 torch.float32), "meta",
                       attn_impl="direct")
    args = [torch.empty(2, 64, dtype=torch.int32, device="meta")]
    if cfg.family == "vlm":
        vis = (2, cfg.vision_tokens, cfg.vision_d)
        want = _hlo(lambda p, t, v: jm.apply(p, t, vision_embeds=v), params,
                    toks, jax.ShapeDtypeStruct(vis, jnp.bfloat16))["flops"]
        args.append(torch.empty(vis, dtype=torch.bfloat16, device="meta"))
    else:
        want = _hlo(jm.apply, params, toks)["flops"]
    got = analyze(port.apply, *args)["flops"]
    assert got == pytest.approx(want, rel=0.01)
    assert got == want


def test_kernels_are_charged_by_their_work():
    """A causal self-attention forward and backward on meta tensors: the
    flash kernels' work, nothing of their plain versions."""
    q = torch.empty(2, 128, 4, 64, device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.empty(2, 128, 2, 64, device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    st = analyze(lambda: fa.flash_attention(q, k, k).sum().backward())
    fwd = fa.work(2, 128, 4, 2, 64, True, 2, lse=True)
    bwd = fa.work(2, 128, 4, 2, 64, True, 2, backward=True)
    assert st["kernels"] == {
        "flash_attention": {"calls": 1, **{f: fwd[f]
                                           for f in ("flops", "bytes")}},
        "flash_attention_bwd": {"calls": 1, **{f: bwd[f]
                                               for f in ("flops", "bytes")}}}
    assert st["flops"] == fwd["flops"] + bwd["flops"]


# --------------------------------------------------------------------------- #
# the kernels' work: PERF.md section 6's bound column
# --------------------------------------------------------------------------- #
BOUNDS = [
    ("flash fwd B8 S1024 H32 KV8 hd64 causal bf16",
     lambda: fa.work(8, 1024, 32, 8, 64, True, 2), 0.0348),
    ("fused norm R8192 D2048 bf16", lambda: fn.work(8192, 2048, 2), 0.0401),
    ("SSD bwd B8 L512 H48 N128",
     lambda: ssd.work(8, 512, 48, 64, 128, 256, 2, backward=True), 0.0360),
    ("padded matmul bf16 Case-2", lambda: mm.work(4096, 8192, 8484, 2),
     0.5757),
    ("ring combine C 1,638,400", lambda: ring.work(1638400, 4), 0.0059),
]


@pytest.mark.parametrize("name, work, want", BOUNDS,
                         ids=[b[0] for b in BOUNDS])
def test_work_gives_the_bound_column(name, work, want):
    """At the bf16 tensor-core peak (989 TFLOP/s), the FP32 pipes' (67)
    and HBM's 3.35 TB/s, as ``chip_smoke.bound`` takes them."""
    ms, _ = chip_smoke.bound(work(), chip_smoke.PEAK_BF16_FLOPS)
    assert round(ms, 4) == want


def test_ssd_backward_work_flops():
    assert ssd.work(8, 512, 48, 64, 128, 256, 2, backward=True)["flops"] \
        == pytest.approx(3.564e10, rel=1e-3)


# --------------------------------------------------------------------------- #
# the dry-run's copies of the reference
# --------------------------------------------------------------------------- #
def test_shapes_and_cells_equal_the_references():
    assert {k: vars(v) for k, v in SHAPES.items()} == {
        k: vars(v) for k, v in JAX_SHAPES.items()}
    assert {k: v.tokens for k, v in SHAPES.items()} == {
        k: v.tokens for k, v in JAX_SHAPES.items()}
    assert list(cells(include_skipped=True)) == list(
        jax_cells(include_skipped=True))
    assert list(cells()) == list(jax_cells())


@pytest.mark.parametrize("overrides", [None, {"attn_impl": "folded"},
                                       {"microbatches": 2, "fsdp": True,
                                        "q_chunk": 512}])
def test_dryrun_policy_equals_the_references(overrides):
    """Equal but for the declared ``attn_impl`` default and the
    reference's sequence-parallel options, which the port does not model
    (it runs no tensor or sequence parallelism): an override of one is
    refused."""
    for arch, _, _ in cells():
        got = vars(D.dryrun_policy(arch, overrides))
        want = vars(RD.dryrun_policy(arch, overrides))
        if not (overrides or {}).get("attn_impl"):
            assert (got.pop("attn_impl"), want.pop("attn_impl")) == (
                "auto", "chunked")               # the declared difference
        assert (want.pop("sequence_parallel"), want.pop("sp_prefill")) == (
            True, False)                         # not modelled
        assert got == want
    assert (D.BIG, D.MID) == (RD.BIG, RD.MID)


@pytest.mark.parametrize("knob", ["sequence_parallel", "sp_prefill",
                                  "no_such_option"])
def test_dryrun_policy_refuses_options_it_does_not_model(knob):
    with pytest.raises(ValueError, match=knob):
        D.dryrun_policy("llama3.2-1b", {knob: True})


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-2.7b",
                                  "llama-3.2-vision-11b", "dbrx-132b"])
def test_build_cell_gives_every_family_the_policys_chunks(arch, monkeypatch):
    """The policy's attention options reach the model of every family with
    attention (zamba2's shared block too) through ``build_model``."""
    built, real = [], D.build_model
    monkeypatch.setattr(D, "build_model",
                        lambda *a, **kw: built.append(real(*a, **kw))
                        or built[-1])
    D.build_cell(arch, "decode_32k", MESHES[False],
                 {"attn_impl": "chunked", "q_chunk": 256, "kv_chunk": 128,
                  "fold_depth": 2})
    assert built[0].attn == AttnImpl("chunked", 2, 256, 128)


def test_zamba2_attention_takes_the_chunks_it_was_built_with(monkeypatch):
    seen, real = [], attn_lib.chunked_attention

    def spy(q, k, v, *a, **kw):
        seen.append((kw["q_chunk"], kw["kv_chunk"]))
        return real(q, k, v, *a, **kw)
    monkeypatch.setattr(attn_lib, "chunked_attention", spy)
    model = build_model(get_reduced("zamba2-2.7b"), Policy(torch.float32),
                        "cpu", attn_impl="chunked", q_chunk=16, kv_chunk=8)
    model.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.apply(torch.zeros(1, 32, dtype=torch.long))
    assert seen and set(seen) == {(16, 8)}


def _ref_model(arch):
    return jax_build_model(jax_get_config(arch))


@pytest.mark.parametrize("pod", [False, True])
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_cache_specs_equal_the_references(pod, shape):
    """Every arch (every family) at batch 128 and at batch 1, where the
    sequence takes the data axes; the reference's two stacked None
    entries (vlm self-attention k/v, zamba2 state and conv) are the port's
    one."""
    mesh = MESHES[pod]
    sp = SHAPES[shape]
    for arch, s, _ in cells(include_skipped=True):
        if s != shape:
            continue
        cfg = get_config(arch)
        model = build_model(cfg, Policy(torch.bfloat16, torch.float32),
                            "meta")
        shapes, specs = D.cache_specs(cfg, mesh, sp.global_batch,
                                      sp.seq_len, None, model)
        jcfg = jax_get_config(arch)
        _, jspecs = RD.cache_specs(jcfg, mesh, sp.global_batch, sp.seq_len,
                                   None, _ref_model(arch))
        assert set(specs) == set(jspecs)
        for k, want in jspecs.items():
            want = tuple(want)
            if len(want) == len(tuple(specs[k])) + 1:
                assert want[:2] == (None, None)
                want = want[1:]
            assert tuple(specs[k]) == want, (arch, k)


# --------------------------------------------------------------------------- #
# argument bytes, exact
# --------------------------------------------------------------------------- #
_REF_BYTES = r"""
import json, math, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from repro.configs import cells
from repro.launch.dryrun import build_cell
from repro.launch.mesh import make_production_mesh
out = {"sums": {}, "leaves": [], "mamba": {}}
for pod in (False, True):
    mesh = make_production_mesh(multi_pod=pod)
    for arch, shape, _ in cells():
        fn, args, info = build_cell(arch, shape, mesh)
        total = 0
        for l in jax.tree.leaves(args):
            local = (l.sharding.shard_shape(l.shape) if l.sharding is not None
                     else l.shape)
            total += math.prod(local) * l.dtype.itemsize
            if l.sharding is not None:
                out["leaves"].append([pod, list(l.shape), [
                    list(e) if isinstance(e, tuple) else e
                    for e in l.sharding.spec], list(local)])
        out["sums"][f"{arch}|{shape}|{pod}"] = total
        if (arch, shape, pod) == ("mamba2-780m", "long_500k", False):
            with mesh:
                c = jax.jit(fn).lower(*args).compile()
            out["mamba"] = {"sum": total, "xla": c.memory_analysis()
                            .argument_size_in_bytes,
                            "scalars": [list(l.shape) for l in
                                        jax.tree.leaves(args)
                                        if l.sharding is None]}
json.dump(out, sys.stdout)
"""


@pytest.fixture(scope="module")
def ref_bytes():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF_BYTES], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout)


@pytest.mark.parametrize("pod", [False, True])
def test_argument_bytes_equal_the_references(ref_bytes, pod):
    from repro_torch.parallel.mesh import make_production_mesh
    mesh = make_production_mesh(multi_pod=pod)
    for arch, shape, _ in cells():
        cell = D.build_cell(arch, shape, mesh)
        got = D.local_bytes(cell.args, mesh)
        assert got == ref_bytes["sums"][f"{arch}|{shape}|{pod}"], \
            (arch, shape, pod)


def test_local_shape_equals_shard_shape_leaf_by_leaf(ref_bytes):
    """``local_shape``, ``named``'s ``Named.shard_shape`` and the shapes of
    ``shaped_with_sharding``'s meta tensors, each against JAX's
    ``NamedSharding.shard_shape``."""
    for pod, shape, spec, want in ref_bytes["leaves"]:
        spec = Spec(*(tuple(e) if isinstance(e, list) else e for e in spec))
        mesh = MESHES[pod]
        assert list(local_shape(tuple(shape), spec, mesh)) == want
        assert list(named(mesh, {"x": spec})["x"].shard_shape(
            tuple(shape))) == want
    shape, spec = (48, 2048, 32, 64), Spec(None, "data", "model", None)
    t = shaped_with_sharding({"x": shape}, {"x": spec}, FakeMesh(),
                             {"x": torch.bfloat16})["x"]
    assert (t.shape, t.dtype, t.device.type) == (
        (48, 128, 2, 64), torch.bfloat16, "meta")
    assert t.global_shape == shape and t.sharding.spec == spec


def test_the_committed_mamba2_long_500k_argument_bytes(ref_bytes):
    m = ref_bytes["mamba"]
    committed = json.loads((ROOT / "dryrun_out" /
                            "mamba2-780m_long_500k_16-16.json").read_text())
    assert m["xla"] == committed["memory"]["argument_bytes"] == 583_345_348
    assert m["scalars"] == [[]] and m["sum"] == m["xla"] + 4
    from repro_torch.parallel.mesh import make_production_mesh
    mesh = make_production_mesh()
    cell = D.build_cell("mamba2-780m", "long_500k", mesh)
    assert D.local_bytes(cell.args, mesh) == m["sum"]


# --------------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------------- #
def _cli(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out",
         str(tmp_path)], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=300)


@pytest.mark.parametrize("extra", [[], ["--multi-pod"]])
def test_decode_cell_both_meshes(tmp_path, extra):
    r = _cli(tmp_path, "--arch", "qwen2-0.5b", "--shape", "decode_32k",
             *extra)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("OK ") and "dom=" in r.stdout
    mesh = "2-16-16" if extra else "16-16"
    res = json.loads((tmp_path / f"qwen2-0.5b_decode_32k_{mesh}.json")
                     .read_text())
    assert res["chips"] == (512 if extra else 256)
    assert res["chip"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert set(res["method"]) >= {"argument_bytes", "temp_bytes",
                                  "flops_per_device", "collectives"}


def test_hybrid_long_context_cell(tmp_path):
    r = _cli(tmp_path, "--arch", "mamba2-780m", "--shape", "long_500k")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OK " in r.stdout and "dom=" in r.stdout


def test_train_cell_counts_every_microbatch_and_the_update():
    """llama3.2-1b's train_4k: 4 microbatches of 64, one run and counted
    four times; its flops are 6·N·tokens-like (the reference's model
    flops over the counted ones within the attention's share), and the
    gradient all-reduce moves each parameter's fp32 gradient."""
    from repro_torch.parallel.mesh import make_production_mesh
    res = D.run_cell("llama3.2-1b", "train_4k", False)
    assert res["kernels"]["flash_attention"]["calls"] == 16 * 4
    assert res["kernels"]["flash_attention_bwd"]["calls"] == 16 * 4
    assert 0.8 < res["useful_flops_ratio"] < 1.0
    cfg = get_config("llama3.2-1b")
    ar = res["collectives"]["all-reduce"]
    mesh = make_production_mesh()
    # every parameter's gradient, fp32 (the accumulation dtype), a device's
    # model shard of it
    assert ar["count"] == len([k for k in D.build_cell(
        "llama3.2-1b", "train_4k", mesh).args
        if not k.startswith(("opt:", "batch:")) and k != "step"])
    assert ar["result_bytes"] > 4 * cfg.param_count() / 16 * 0.9
