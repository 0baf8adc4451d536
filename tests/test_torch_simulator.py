"""The port's cluster simulator against the JAX package's, on the CPU.

The port keeps its own numpy copies of ``repro.core.timeline`` and
``repro.core.injectors`` (``repro_torch.core.timeline``,
``repro_torch.core.injectors``).  A seeded simulation is numpy arithmetic
on one PCG64 stream, so the same program, seed, ranks and injections give
the same ``EventBatch`` in both packages, column for column and bit for
bit:

* each copied module's syntax tree equals the reference's once docstrings
  are dropped, the package's name is made the same and the two declared
  differences are written as the reference's (``torch_ast.DECLARED``):
  ``program_from_config``'s H100 ceilings and the Case-1 span's name;
* ``program_from_config`` gives the same ops for all eleven archs, at
  ``moe_experts`` 0 and 4, when the reference is passed the port's
  ceilings (989e12 FLOP/s, 5e10 B/s) explicitly;
* ``ClusterSimulator.run_batch`` emits the reference's batch at 64 ranks
  x 4 steps for every registered kind (the 15 of the registry, a
  rank-targeted ``network_jitter`` and ``moe_straggler`` on a
  ``moe_experts=4`` program among them) and for no injection, the
  reference's program carried over by ``port_program``; the hang's
  snapshot too.  The one difference is ``torch.cuda@synchronize`` where
  the reference names ``jax@block_until_ready``;
* the registry raises as the reference's, and two processes with
  different ``PYTHONHASHSEED`` emit the same batch.
"""
import dataclasses
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro import configs as ref_configs
from repro.core import injectors as ref_injectors
from repro.core import timeline as ref_timeline
from repro_torch import configs as port_configs
from repro_torch.core import injectors as port_injectors
from repro_torch.core import timeline as port_timeline
from torch_ast import DECLARED, tree

ROOT = Path(__file__).resolve().parents[1]
N, STEPS, SEED = 64, 4, 7
# the port's ceilings (program_from_config's defaults), passed to the
# reference explicitly
H100 = dict(chip_flops=989e12, link_bw=5e10)
SYNC = {"jax@block_until_ready": "torch.cuda@synchronize"}

SIM_MODULES = ("core/injectors/__init__.py", "core/injectors/base.py",
               "core/injectors/registry.py", "core/injectors/builtins.py",
               "core/injectors/l4.py", "core/timeline.py")


def port_program(ops) -> list:
    """A reference program (``list[repro.core.timeline.SimOp]``) as the
    port's, every field copied."""
    return [port_timeline.SimOp(**{f.name: getattr(op, f.name)
                                   for f in dataclasses.fields(op)})
            for op in ops]


def assert_batches_equal(ref, port, names: dict | None = None):
    """Two ``EventBatch``es equal column for column, bit for bit; the
    reference's names mapped through ``names`` first."""
    assert len(ref) == len(port)
    for col in ("kind", "name_id", "rank", "issue_ts", "start_ts", "end_ts",
                "step", "flops", "nbytes", "tokens", "group_id"):
        a, b = getattr(ref, col), getattr(port, col)
        assert a.dtype == b.dtype, col
        assert a.tobytes() == b.tobytes(), col
    names = names or {}
    assert [names.get(n, n) for n in ref.names] == port.names
    assert ref.groups == port.groups
    assert ref.extra == port.extra


def both_programs(arch: str, **kw):
    ref = ref_timeline.program_from_config(ref_configs.get_config(arch),
                                           **H100, **kw)
    port = port_timeline.program_from_config(port_configs.get_config(arch),
                                             **kw)
    return ref, port


@pytest.mark.parametrize("rel", SIM_MODULES)
def test_syntax_tree_equals_the_references(rel):
    assert tree("repro_torch", rel) == tree("repro", rel)


@pytest.mark.parametrize("rel", SIM_MODULES)
def test_only_the_declared_constants_differ(rel):
    """Without ``DECLARED`` the trees differ exactly where a declared
    constant stands, each once in the port's module."""
    port, ref = tree("repro_torch", rel, declared=False), tree("repro", rel)
    assert (port == ref) == (rel not in DECLARED)
    for port_value, ref_value in DECLARED.get(rel, {}).items():
        assert port.count(f"value={port_value!r}") == 1
        assert ref.count(f"value={ref_value!r}") == 1
        assert port.replace(f"value={port_value!r}",
                            f"value={ref_value!r}") == ref


def test_ceiling_defaults_are_the_h100s():
    kw = port_timeline.program_from_config.__kwdefaults__
    ref_kw = ref_timeline.program_from_config.__kwdefaults__
    assert (kw["chip_flops"], kw["link_bw"], kw["mfu"]) == (989e12, 5e10,
                                                            0.45)
    assert ref_kw["chip_flops"] == 197e12
    assert {k: v for k, v in kw.items() if k != "chip_flops"} == \
        {k: v for k, v in ref_kw.items() if k != "chip_flops"}


@pytest.mark.parametrize("experts", [0, 4])
@pytest.mark.parametrize("arch", ref_configs.list_archs())
def test_program_from_config_equals_the_references(arch, experts):
    """Op by op, at the reference's call with the port's ceilings; the
    counts the durations come from equal too."""
    rc, pc = ref_configs.get_config(arch), port_configs.get_config(arch)
    assert (rc.param_count(), rc.active_param_count()) == \
        (pc.param_count(), pc.active_param_count())
    assert (rc.family, rc.d_ff, rc.num_experts) == \
        (pc.family, pc.d_ff, pc.num_experts)
    for kw in ({}, dict(num_chips=1024, layer_groups=6,
                        tokens_global=1 << 20)):
        ref, port = both_programs(arch, moe_experts=experts, **kw)
        # SimOp's equality holds only between ops of one class: every
        # field of the port's copy of each reference op
        assert port_program(ref) == port


# every registered kind (the ten legacy kinds, the five L4 kinds), a
# rank-targeted network_jitter, and no injection
CASES = {
    "healthy": [],
    "gc": [dict(kind="gc", duration=0.02, period_ops=5)],
    "pyapi_stall": [dict(kind="pyapi_stall", duration=0.03, period_ops=7,
                         api_name="importlib.metadata.version")],
    "sync_after_comm": [dict(kind="sync_after_comm", start_step=1)],
    "straggler": [dict(kind="straggler", ranks=(3, 7), factor=2.0,
                       start_step=2)],
    "underclock": [dict(kind="underclock", ranks=(5,), factor=2.5,
                        start_step=3)],
    "slow_compute": [dict(kind="slow_compute", op_match="ffn_matmul",
                          factor=2.88)],
    "slow_dataloader": [dict(kind="slow_dataloader", factor=1.0,
                             duration=2.0)],
    "network_jitter": [dict(kind="network_jitter", factor=3.0,
                            start_step=2)],
    "network_jitter_ranks": [dict(kind="network_jitter", factor=3.0,
                                  ranks=(1, 9, 40, 200), start_step=1)],
    "minority_kernels": [dict(kind="minority_kernels", factor=0.35,
                              ranks=(0, 63))],
    "hang": [dict(kind="hang", ranks=(11,), at_step=2)],
    "hang_noncomm": [dict(kind="hang", ranks=(6,), at_step=1, at_op=1,
                          meta={"noncomm_crash": True})],
    "checkpoint_write_storm": [dict(
        kind="checkpoint_write_storm", duration=0.05, period_ops=6,
        start_step=1, meta={"period_steps": 3, "storm_steps": 2})],
    "ecc_throttle": [dict(kind="ecc_throttle", ranks=(4, 5), factor=2.5,
                          start_step=1, meta={"ramp_steps": 2})],
    "network_flap": [dict(kind="network_flap", factor=3.0, ranks=(2, 30),
                          start_step=1, meta={"on_steps": 1,
                                              "off_steps": 1})],
    "moe_straggler": [dict(kind="moe_straggler", op_match="moe_ffn",
                           factor=3.0, meta={"hot_expert": 2,
                                             "base_factor": 1.1})],
    "serving_interference": [dict(kind="serving_interference", factor=1.3,
                                  start_step=1, meta={"on_steps": 1,
                                                      "off_steps": 1})],
    "mixed": [dict(kind="gc", duration=0.01, period_ops=4),
              dict(kind="network_jitter", factor=2.0, ranks=(7,)),
              dict(kind="underclock", ranks=(5,), factor=2.0)],
}


def simulate(case: str):
    """Both packages' simulators on the same program (the reference's,
    carried over), seed and injections: (ref sim, ref batch, port sim,
    port batch)."""
    arch = "dbrx-132b" if case == "moe_straggler" else "llama-20b-paper"
    ref_prog, _ = both_programs(arch, num_chips=N, layer_groups=4,
                                moe_experts=4)
    out = []
    for pkg, prog in ((ref_timeline, ref_prog),
                      (port_timeline, port_program(ref_prog))):
        sim = pkg.ClusterSimulator(N, prog, seed=SEED, injections=[
            pkg.Injection(**inj) for inj in CASES[case]])
        out += [sim, sim.run_batch(STEPS)]
    return out


def test_every_registered_kind_is_a_case():
    kinds = {i["kind"] for c in CASES.values() for i in c}
    assert kinds == set(port_injectors.injector_names()) == \
        set(ref_injectors.injector_names())
    assert len(kinds) == 15


@pytest.mark.parametrize("case", list(CASES))
def test_run_batch_equals_the_references(case):
    ref_sim, ref, port_sim, port = simulate(case)
    assert len(port) > 0
    assert_batches_equal(ref, port, SYNC)
    if "sync" in case:
        assert "torch.cuda@synchronize" in port.names
        assert "jax@block_until_ready" in ref.names
    assert (ref_sim.hang is None) == (port_sim.hang is None)
    if ref_sim.hang is not None:
        a, b = ref_sim.hang, port_sim.hang
        for f in ("step", "op_index", "op_name", "comm", "stacks",
                  "group_ranks", "truth_rank"):
            assert getattr(a, f) == getattr(b, f), f
        assert (a.ring_progress is None) == (b.ring_progress is None)
        if a.ring_progress is not None:
            assert a.ring_progress.dtype == b.ring_progress.dtype
            assert np.array_equal(a.ring_progress, b.ring_progress)
    # the legacy per-event view is the batch's
    assert {r: len(v) for r, v in port_sim.run(STEPS).items()} == \
        {r: len(v) for r, v in ref_sim.run(STEPS).items()}


def test_unknown_kind_names_the_registry():
    prog = port_program(both_programs("qwen2-0.5b", num_chips=8)[0])
    said = []
    for pkg, sim_pkg in ((port_injectors, port_timeline),
                         (ref_injectors, ref_timeline)):
        with pytest.raises(pkg.UnknownInjectorError) as e:
            sim_pkg.ClusterSimulator(8, prog, injections=[
                sim_pkg.Injection(kind="solar_flare")])
        assert "solar_flare" in str(e.value)
        assert "network_jitter" in str(e.value)
        said.append(str(e.value))
    assert said[0] == said[1]


def test_duplicate_and_unnamed_registrations_raise():
    for pkg in (port_injectors, ref_injectors):
        with pytest.raises(pkg.DuplicateInjectorError):
            @pkg.register_injector
            class Gc(pkg.FaultInjector):
                name = "gc"
        with pytest.raises(pkg.InjectorError):
            @pkg.register_injector
            class Unnamed(pkg.FaultInjector):
                pass
        with pytest.raises(pkg.InjectorError):
            pkg.resolve_injections(["gc"])
    assert port_injectors.get_injector("gc") is port_injectors.GcStallInjector


def test_replace_and_unregister_restore_the_registry():
    before = port_injectors.injector_names()

    @port_injectors.register_injector(name="gc", replace=True)
    class LoudGc(port_injectors.GcStallInjector):
        pass

    try:
        assert port_injectors.get_injector("gc") is LoudGc
    finally:
        port_injectors.register_injector(port_injectors.GcStallInjector,
                                         name="gc", replace=True)
    assert port_injectors.get_injector("gc") is port_injectors.GcStallInjector
    @port_injectors.register_injector(name="temp_kind")
    class Temp(port_injectors.UnderclockInjector):
        pass

    assert port_injectors.get_injector("temp_kind") is Temp
    port_injectors.unregister_injector("temp_kind")
    assert port_injectors.injector_names() == before


def test_stall_phase_equals_the_references():
    for step in range(40):
        for kind in ("gc", "pyapi_stall", "checkpoint_write_storm"):
            for period in (1, 4, 7):
                assert port_injectors.stall_phase(step, kind, period) == \
                    ref_injectors.stall_phase(step, kind, period)


_SUBPROC = """
import hashlib, sys
sys.path.insert(0, {src!r})
from repro_torch.configs import get_config
from repro_torch.core.timeline import (ClusterSimulator, Injection,
                                       program_from_config)
prog = program_from_config(get_config("llama-20b-paper"), num_chips={n})
for kind, inj in (("gc", Injection(kind="gc", duration=0.02, period_ops=5)),
                  ("ckpt", Injection(kind="checkpoint_write_storm",
                                     duration=0.05, period_ops=6))):
    b = ClusterSimulator({n}, prog, seed={seed},
                         injections=[inj]).run_batch({steps})
    h = hashlib.sha256()
    for col in (b.kind, b.rank, b.issue_ts, b.start_ts, b.end_ts, b.step):
        h.update(col.tobytes())
    h.update("|".join(b.names).encode())
    print(kind, h.hexdigest())
"""


def test_same_batch_across_hash_seeds():
    """The periodic stalls' phase is CRC32, not the salted ``hash()``: two
    processes with different hash seeds emit the same batches, with jax
    and repro nowhere on their path."""
    code = _SUBPROC.format(src=str(ROOT / "src"), n=N, seed=SEED,
                           steps=STEPS)
    outs = []
    for hash_seed in ("0", "424242"):
        env = dict(PATH=os.environ.get("PATH", "/usr/bin:/bin"),
                   PYTHONHASHSEED=hash_seed)
        r = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        outs.append(r.stdout)
    assert outs[0] == outs[1]
    assert len(outs[0].split()) == 4
    prog = port_timeline.program_from_config(
        port_configs.get_config("llama-20b-paper"), num_chips=N)
    b = port_timeline.ClusterSimulator(N, prog, seed=SEED, injections=[
        port_timeline.Injection(kind="gc", duration=0.02, period_ops=5)]
    ).run_batch(STEPS)
    h = hashlib.sha256()
    for col in (b.kind, b.rank, b.issue_ts, b.start_ts, b.end_ts, b.step):
        h.update(col.tobytes())
    h.update("|".join(b.names).encode())
    assert outs[0].split()[1] == h.hexdigest()
