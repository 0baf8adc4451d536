"""The port's sharding plane (``parallel/sharding.py``, the mesh of
``launch/mesh.py``, ``optim/adamw.py::opt_state_specs``) against the JAX
package's, on the CPU.

* every parameter spec of the eleven archs, at ``REDUCED`` and at
  published width, on both production meshes (16 x 16 and 2 x 16 x 16, a
  ``FakeMesh`` as in ``tests/test_sharding_rules.py``): the reference's
  ``param_specs`` -> ``sanitize_specs`` on ``jax.eval_shape`` of its init
  (nothing full-width is allocated), the port's on a model built on the
  ``meta`` device, computed on the reference's stacked shapes; the port's
  per-layer spec equals the reference's without its stacked entries.
  Where the reference puts a mesh axis on a stacked axis the list of such
  entries is recorded (``ON_STACK``): none from ``sanitize_spec``, only
  ``zero_spec``'s data axis on the layer axis;
* ``opt_state_specs`` for float32, bfloat16 and int8 moments, the same
  way;
* ``sanitize_spec`` and ``zero_spec`` on hypothesis-drawn shapes, specs and
  axis tuples, and on ``tests/test_sharding_rules.py``'s cases;
* ``MeshRules``' cleaning against the spec the reference's
  ``MeshRules.__call__`` gives its output under ``jit`` on 8 fake devices
  (a subprocess, so this process keeps one JAX device);
* the mesh's row-major layout against ``jax.make_mesh``'s, and ``shard``
  then ``gather`` bitwise on 8 gloo CPU ranks (one spawn).
"""
import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.configs import list_archs
from repro.models import build_model as jax_build_model
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import opt_state_specs as jax_opt_state_specs
from repro.parallel import sharding as jsh
from repro_torch.configs import get_config, get_reduced
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamWConfig, opt_state_specs
from repro_torch.parallel.mesh import Mesh, make_production_mesh
from repro_torch.parallel import sharding as sh
from torch_parallel_ranks import SHARD_CASES, shard_gather_rank

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list_archs()
assert len(ARCHS) == 11


class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class FakePodMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


MESHES = {"pod": FakePodMesh(), "single": FakeMesh()}

# (arch, published width, mesh) whose specs place a mesh axis on a
# reference stacked axis, which the port's per-layer tensors do not have:
# only ZeRO's data axis, on the layer axis of the archs whose L 16 divides
ON_STACK = {(a, m): ("data",) for a in (
    "llama3.2-1b", "mamba2-780m", "musicgen-large", "qwen2-72b")
    for m in MESHES}


def norm(spec, n: int) -> tuple:
    """A spec as a tuple of ``n`` entries (None-padded), one-name tuples
    as the name: how both packages' specs compare."""
    t = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
              for e in tuple(spec))
    return t + (None,) * (n - len(t))


@functools.lru_cache(maxsize=None)
def reference(arch: str, full: bool):
    """The reference's config and the shapes of its init's tree."""
    cfg = (jax_get_config if full else jax_get_reduced)(arch)
    shapes = jax.eval_shape(jax_build_model(cfg).init, jax.random.PRNGKey(0))
    return cfg, shapes


def ref_leaves(tree) -> dict:
    """{dotted path: leaf} of a reference tree (specs or shapes)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {".".join(str(p.key) for p in path): leaf for path, leaf in flat}


def port_model(arch: str, full: bool):
    cfg = (get_config if full else get_reduced)(arch)
    return build_model(cfg, device="meta")


def ref_key(name: str) -> str:
    parts = name.split(".")
    if parts[0] in ("layers", "cross") and parts[1].isdigit():
        del parts[1]
    return ".".join(parts)


def layer_part(spec, n: int, k: int) -> tuple:
    """A reference spec on a stacked shape of ``n`` dims, ``k`` of them
    stacked, without its stacked entries (``sh.per_layer``)."""
    return tuple(sh.per_layer(norm(spec, n), k))


def on_stack(spec, n: int, k: int) -> set:
    """The mesh axes a reference spec places on its ``k`` stacked dims."""
    return {e for e in norm(spec, n)[:k] if e is not None}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "published"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, full, mesh):
    """param_specs -> sanitize_specs: the port's per-layer specs, computed
    on the reference's stacked shapes, equal the reference's without their
    stacked entries for every parameter; the reference places no mesh axis
    on a stacked dim."""
    m = MESHES[mesh]
    cfg, shapes = reference(arch, full)
    want_raw = ref_leaves(jsh.param_specs(shapes))
    want = ref_leaves(jsh.sanitize_specs(jsh.param_specs(shapes), shapes, m))
    ref_shapes = ref_leaves(shapes)
    model = port_model(arch, full)
    raw = sh.param_specs(model)
    got = sh.sanitize_specs(raw, model, m)
    names = dict(model.named_parameters())
    assert {ref_key(n) for n in names} == set(want)
    for name, p in names.items():
        key = ref_key(name)
        dims = sh.stack_dims(name, model.cfg)
        assert dims + tuple(p.shape) == tuple(ref_shapes[key].shape), name
        k, n = len(dims), len(dims) + p.dim()
        assert norm(raw[name], p.dim()) == layer_part(want_raw[key], n, k)
        assert norm(got[name], p.dim()) == layer_part(want[key], n, k), name
        assert not on_stack(want[key], n, k), name


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_specs_equal_the_reference(arch, state_dtype):
    """opt_state_specs (ZeRO over data) at reduced and published width on
    both meshes: every moment's per-layer spec (an int8 moment's payload
    and scale) equals the reference's without its stacked entries; the
    only axis the reference places on a stacked dim is ZeRO's data axis,
    on the archs of ``ON_STACK``."""
    for full in (False, True):
        cfg, shapes = reference(arch, full)
        model = port_model(arch, full)
        names = dict(model.named_parameters())
        for mesh, m in MESHES.items():
            jspecs = jsh.sanitize_specs(jsh.param_specs(shapes), shapes, m)
            want = jax_opt_state_specs(
                jspecs, shapes, m, JaxAdamWConfig(state_dtype=state_dtype))
            assert want["count"] == P()
            want = ref_leaves(want["mu_nu"])
            got = opt_state_specs(
                sh.sanitize_specs(sh.param_specs(model), model, m), model,
                m, AdamWConfig(state_dtype=state_dtype))
            assert got["count"] == sh.Spec()
            placed = set()
            for name, p in names.items():
                dims = sh.stack_dims(name, model.cfg)
                k, n = len(dims), len(dims) + p.dim()
                for mom in ("m", "v"):
                    fields = ("q", "scale") if state_dtype == "int8" else (
                        None,)
                    for f in fields:
                        key = f"{ref_key(name)}.{mom}" + (f".{f}" if f else "")
                        g = got["mu_nu"][name][mom]
                        if f:
                            g = g[f]
                        top = max(n, len(want[key]))
                        assert norm(g, top - k) == layer_part(
                            want[key], top, k), (name, key)
                        placed |= on_stack(want[key], top, k)
            assert placed == set(ON_STACK.get((arch, mesh), ())
                                 if full else ()), (full, mesh, placed)


# --------------------------------------------------------------------------- #
# sanitize_spec and zero_spec, case by case
# --------------------------------------------------------------------------- #
RULE_CASES = [   # tests/test_sharding_rules.py's, and a few more
    ("sanitize", (None, "model", None), (24, 2, 64), None),
    ("sanitize", ("model",), (6,), None),
    ("sanitize", (None, "model"), (10, 32), None),
    ("sanitize", (None, "model"), (32, 6), None),
    ("sanitize", (("pod", "data"), None), (64, 7), None),
    ("sanitize", (None, ("pod", "data")), (8, 32, 64), None),
    ("zero", (None, "model"), (64, 32), ("data",)),
    ("zero", ("data", "model"), (64, 32), ("data",)),
    ("zero", (None, None), (6, 32), ("data",)),
    ("zero", (None, None), (64, 7), ("pod", "data")),
    ("zero", (None, "model"), (6, 32), ("pod",)),
    ("zero", (None,), (5,), ("data",)),
]


def both(kind, spec, shape, axes, mesh):
    if kind == "sanitize":
        return (jsh.sanitize_spec(P(*spec), shape, mesh),
                sh.sanitize_spec(sh.Spec(*spec), shape, mesh))
    return (jsh.zero_spec(P(*spec), shape, mesh, axes),
            sh.zero_spec(sh.Spec(*spec), shape, mesh, axes))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("case", RULE_CASES, ids=lambda c: f"{c[0]}-{c[2]}")
def test_rule_cases_equal_the_reference(case, mesh):
    kind, spec, shape, axes = case
    want, got = both(kind, spec, shape, axes, MESHES[mesh])
    assert tuple(got) == tuple(want)


def test_rule_cases_of_the_reference_test():
    """The assertions of tests/test_sharding_rules.py, on the port."""
    m = FakePodMesh()
    S = sh.Spec
    assert sh.sanitize_spec(S(None, "model", None), (24, 2, 64), m) == S(
        None, None, "model")
    assert sh.sanitize_spec(S("model"), (6,), m) == S(None)
    assert sh.sanitize_spec(S(None, "model"), (10, 32), m) == S(None, "model")
    assert sh.sanitize_spec(S(None, "model"), (32, 6), m) == S(None, None)
    s = sh.zero_spec(S(None, "model"), (64, 32), m, axes=("data",))
    assert s == S("data", "model")
    assert sh.zero_spec(s, (64, 32), m, axes=("data",)) == s
    assert sh.zero_spec(S(None, None), (6, 32), m, ("data",)) == S(None,
                                                                   "data")
    assert sh.zero_spec(S(None, None), (64, 7), m, ("pod", "data")) == S(
        ("pod", "data"), None)
    specs = sh.param_specs(build_model(get_reduced("dbrx-132b"),
                                       device="meta"))
    assert specs["embed.embedding"] == S("model", None)
    assert specs["layers.0.attn.wq"] == S(None, "model", None)
    assert specs["layers.1.moe.wi_gate"] == S("model", None, None)
    assert specs["layers.0.ln1.scale"] == S(None)


ENTRY = st.sampled_from([None, None, "model", "data", "pod",
                         ("pod", "data"), ("data", "model")])
DIM = st.sampled_from([1, 2, 3, 4, 6, 7, 8, 12, 16, 24, 32, 48, 64, 96])


@st.composite
def spec_and_shape(draw):
    shape = tuple(draw(st.lists(DIM, min_size=0, max_size=4)))
    entries = draw(st.lists(ENTRY, min_size=0, max_size=len(shape)))
    used, spec = set(), []
    for e in entries:                     # an axis at most once
        names = set(e if isinstance(e, tuple) else (e,)) - {None}
        spec.append(None if names & used else e)
        used |= names
    return tuple(spec), shape


@settings(max_examples=300, deadline=None)
@given(case=spec_and_shape(), mesh=st.sampled_from(sorted(MESHES)),
       axes=st.sampled_from([("data",), ("pod", "data"), ("pod",),
                             ("model",), ()]))
def test_sanitize_and_zero_spec_equal_the_reference(case, mesh, axes):
    spec, shape = case
    for kind in ("sanitize", "zero"):
        want, got = both(kind, spec, shape, axes, MESHES[mesh])
        assert tuple(got) == tuple(want), (kind, spec, shape, axes)
    s = jsh.sanitize_spec(P(*spec), shape, MESHES[mesh])
    assert tuple(sh.zero_spec(sh.Spec(*s), shape, MESHES[mesh], axes)) == \
        tuple(jsh.zero_spec(s, shape, MESHES[mesh], axes))


# --------------------------------------------------------------------------- #
# MeshRules against the reference's constraint under jit
# --------------------------------------------------------------------------- #
RULES_CASES = [   # (mesh, sequence_parallel, shape, logical axes)
    ("dm", False, (8, 16, 32), ("batch", "seq", "embed")),
    ("dm", True, (8, 16, 32), ("batch", "seq", "embed")),
    ("dm", False, (8, 16, 4, 8), ("batch", "seq", "heads", None)),
    ("dm", True, (8, 16, 4, 8), ("batch", "seq", "heads", None)),
    ("dm", False, (8, 16, 2, 8), ("batch", "seq", "kv_heads", None)),
    ("dm", False, (3, 16, 64), ("batch", "seq", "ff")),
    ("dm", True, (8, 6, 64), ("batch", "seq", "ff")),
    ("dm", False, (8, 16, 100), ("batch", "seq", "vocab")),
    ("dm", False, (1, 16, 32), ("batch", "seq", "embed")),
    ("dm", False, (8, 4, 16), ("experts", None, "embed")),
    ("pdm", False, (8, 16, 32), ("batch", "seq", "embed")),
    ("pdm", True, (8, 16, 4, 8), ("batch", "seq", "heads", None)),
    ("pdm", False, (2, 16, 32), ("batch", "seq", "embed")),
    ("pdm", False, (6, 16, 6), ("batch", "seq", "ff")),
]
MESH_SHAPES = {"dm": ((2, 4), ("data", "model")),
               "pdm": ((2, 2, 2), ("pod", "data", "model"))}

_JAX_RULES = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    from repro.launch.mesh import _mk
    from repro.parallel.sharding import MeshRules
    cases, shapes = json.loads(sys.argv[1])
    out = []
    for mesh, sp, shape, axes in cases:
        m = _mk(*shapes[mesh])
        rules = MeshRules(m, sequence_parallel=sp)
        y = jax.jit(lambda x: rules(x, tuple(axes)))(jnp.zeros(shape))
        out.append([list(e) if isinstance(e, tuple) else e
                    for e in y.sharding.spec])
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_rules():
    import json
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    arg = json.dumps([RULES_CASES, {k: [list(a), list(b)] for k, (a, b)
                                    in MESH_SHAPES.items()}])
    r = subprocess.run([sys.executable, "-c", _JAX_RULES, arg], env=env,
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("i", range(len(RULES_CASES)))
def test_mesh_rules_cleaning_equals_the_reference(jax_rules, i):
    mesh, sp, shape, axes = RULES_CASES[i]
    rules = sh.MeshRules(Mesh(*MESH_SHAPES[mesh]), sequence_parallel=sp)
    want = tuple(tuple(e) if isinstance(e, list) else e
                 for e in jax_rules[i])
    got = rules.cleaned(shape, axes)
    assert norm(got, len(shape)) == norm(want, len(shape))
    assert rules.spec(axes) == sh.Spec(*(rules.rules.get(a) if a else None
                                         for a in axes))


def test_mesh_rules_leave_other_ranks_alone():
    rules = sh.MeshRules(Mesh((2, 4), ("data", "model")))
    assert rules.cleaned((8, 16), ("batch", "seq", "embed")) is None


# --------------------------------------------------------------------------- #
# the mesh and shard / gather
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("shape,axes", [
    ((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
    ((4,), ("stage",)), ((1, 4), ("data", "model"))])
def test_mesh_layout_is_jax_make_mesh_row_major(shape, axes):
    """jax.make_mesh lays devices 0..n-1 row-major over a CPU mesh; the
    port's coordinates of rank r are device r's there."""
    n = int(np.prod(shape))
    devices = np.arange(n).reshape(shape)   # make_mesh's order on CPU
    m = Mesh(shape, axes)
    for r in range(n):
        assert devices[m.coords(r)] == r
        assert m.rank_of(m.coords(r)) == r
        for a in axes:
            sl = m.slice_ranks(a, r)
            assert len(sl) == m.shape[a] and r in sl
            assert [m.coords(x)[axes.index(a)] for x in sl] == list(
                range(m.shape[a]))
    prod = make_production_mesh(multi_pod=True)
    assert prod.shape == {"pod": 2, "data": 16, "model": 16}
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert not prod.member


def test_models_and_specs_do_not_load_the_launcher():
    """The mesh, the spec rules, the pipeline, the optimizer's state specs
    and the models sit below the launcher: importing them loads nothing
    of ``repro_torch.launch`` (``run_ranks``, its process pool)."""
    code = ("import sys, repro_torch.models.registry, "
            "repro_torch.parallel.sharding, repro_torch.parallel.pipeline, "
            "repro_torch.optim.adamw; print(sorted(m for m in sys.modules "
            "if m.startswith('repro_torch.launch')))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_production_mesh_is_shape_only():
    with pytest.raises(RuntimeError, match="shape-only"):
        make_production_mesh().group("data")


@pytest.fixture(scope="module")
def shard_run():
    return run_ranks(shard_gather_rank, 8, 23, device="cpu", timeout=120.0)


@pytest.mark.parametrize("i", range(len(SHARD_CASES)))
def test_shard_then_gather_is_the_tensor(shard_run, i):
    """Every rank's block is the slice its coordinates name, and gather
    over the mesh's subgroups returns the tensor bit for bit on every
    rank of the mesh."""
    mesh_shape, axes, shape, spec = SHARD_CASES[i]
    n = int(np.prod(mesh_shape))
    for r, res in enumerate(shard_run):
        if r >= n:
            assert res[i] is None
            continue
        assert res[i]["gathered_equal"], (r, res[i])
        assert res[i]["block_equal"], (r, res[i])
