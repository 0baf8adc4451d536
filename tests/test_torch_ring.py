"""The port's ring path against the JAX package, on the CPU.

* ``ring_combine`` (plain path) against the JAX ``ring_combine`` (Pallas,
  interpret mode) at the reference's cases: ``out`` exact, ``progress``
  equal; both refuse a chunk that the block does not divide;
* ``quantize_int8`` / ``dequantize_int8`` against the JAX helpers;
* one spawn of 4 gloo ranks (``launch/mesh.py``), with distinct per-rank
  inputs from a numpy seed, against the JAX ring bodies under
  ``shard_map`` on a 4-device CPU mesh (a subprocess with
  ``--xla_force_host_platform_device_count=4``, so this process keeps one
  JAX device): reduce-scatter, all-gather (slot offsets 0 and 1) and
  all-reduce equal in fp32, with equal progress; ``compressed_psum_local``
  within 1e-6;
* in the same spawn: traced bucket all-reduces checked bit for bit
  against the plain ring order, one of a chunk that the combine block does
  not divide; the hang drill, whose live ring progress (from the frozen
  combine counters) ``diagnose_hang`` turns into the broken link; a traced
  ``padded_matmul``; the traces read back in the JAX package's codec and
  metrics.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.events import EventKind, load_jsonl
from repro.core.hang import diagnose_hang
from repro.core.metrics import aggregate_step
from repro.kernels.padded_matmul.ops import _meta as jax_matmul_meta
from repro.kernels.ring_reduce.ops import _meta as jax_ring_meta
from repro.kernels.ring_reduce.ops import ring_combine as jax_ring_combine
from repro.kernels.ring_reduce.ref import progress_ref as jax_progress_ref
from repro.parallel.collectives import dequantize_int8 as jax_dequantize_int8
from repro.parallel.collectives import quantize_int8 as jax_quantize_int8
from repro_torch.kernels.ring_reduce.ops import (CTAS_PER_SM, WARPS_PER_CTA,
                                                 _meta, combine_grid,
                                                 combine_vec, lane_elements,
                                                 ring_combine,
                                                 worker_ring_blocks)
from repro_torch.launch.mesh import run_ranks
from repro_torch.parallel.collectives import (COMBINE_BLOCK, combine_counters,
                                              dequantize_int8, quantize_int8)
from torch_ring_ranks import failing_rank, semantics_rank

ROOT = Path(__file__).resolve().parents[1]
W = 4
BUCKET = 1001          # not a multiple of W: ring_all_reduce pads
ODD_BUCKET = 5003      # chunk 1251: padded to 2048, two combine blocks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,block", [(4096, 512), (2048, 1024), (1024, 1024)])
def test_ring_combine_matches_jax(rng, C, block, dtype):
    a = rng.standard_normal(C).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    ta = torch.from_numpy(a).to(getattr(torch, dtype))
    tb = torch.from_numpy(b).to(getattr(torch, dtype))
    out, prog = ring_combine(ta, tb, block=block)
    jout, jprog = jax_ring_combine(jnp.asarray(a, dtype), jnp.asarray(b, dtype),
                                   block=block)
    assert out.dtype == ta.dtype and prog.dtype == torch.int32
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(jout, np.float32))
    np.testing.assert_array_equal(prog.numpy(), np.asarray(jprog))
    np.testing.assert_array_equal(prog.numpy(),
                                  np.asarray(jax_progress_ref(C, block)))
    assert _meta(ta, tb) == jax_ring_meta(jnp.asarray(a, dtype), None)


def test_ring_combine_refuses_a_block_that_does_not_divide():
    x = np.zeros(1536, np.float32)
    with pytest.raises(AssertionError):
        jax_ring_combine(jnp.asarray(x), jnp.asarray(x), block=1024)
    with pytest.raises(ValueError, match="multiple of block"):
        ring_combine(torch.from_numpy(x), torch.from_numpy(x), block=1024)


def test_ring_combine_writes_the_callers_counters(rng):
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    counters = torch.zeros((2, 4), dtype=torch.int32)
    out, prog = ring_combine(x, x, block=1024, progress=counters[1])
    assert torch.equal(out, x + x)
    assert prog.data_ptr() == counters[1].data_ptr()
    np.testing.assert_array_equal(counters.numpy(), [[0] * 4, [1, 2, 3, 4]])
    with pytest.raises(ValueError, match="progress must be"):
        ring_combine(x, x, block=1024, progress=counters[:, 0])


# (C, block, itemsize): the ring's chunk of a 25 MB fp32 bucket, the odd
# bucket's chunk padded to 1601 blocks (fp32 and bf16), a block that is not
# a multiple of the 16-byte access, a block above the warp's 1024-element
# step, and the JAX cases' smaller blocks
SCHEDULES = [(1638400, 1024, 4), (1601 * 1024, 1024, 4),
             (1601 * 1024, 1024, 2), (3 * 1022, 1022, 4), (3 * 1022, 1022, 2),
             (4 * 2048, 2048, 4), (4096, 512, 2), (1024, 1024, 4)]


@pytest.mark.parametrize("sms", [132, 7, 1])
@pytest.mark.parametrize("C,block,itemsize", SCHEDULES)
def test_combine_schedule_covers_every_ring_block_once(C, block, itemsize,
                                                       sms):
    """The kernel's grid (``combine_grid``) is at most one wave, its warps
    take every ring block exactly once, each in increasing order (so each
    warp's counters rise in order), and a warp's lanes cover every element
    of a ring block exactly once."""
    n = C // block
    grid = combine_grid(n, sms)
    assert 1 <= grid <= CTAS_PER_SM * sms
    assert grid * WARPS_PER_CTA >= min(n, CTAS_PER_SM * sms * WARPS_PER_CTA)
    seen = []
    for w in range(grid * WARPS_PER_CTA):
        mine = list(worker_ring_blocks(w, n, grid))
        assert mine == sorted(mine)
        seen += mine
    assert sorted(seen) == list(range(n))
    vec = combine_vec(block, itemsize, 0, 16, 4096)
    assert vec == (16 // itemsize if block % (16 // itemsize) == 0 else 1)
    lanes = [lane_elements(lane, block, vec) for lane in range(32)]
    assert sorted(e for lane in lanes for e in lane) == list(range(block))


def test_combine_one_warp_a_ring_block_at_the_rings_chunk():
    """At the ring's chunk (1600 ring blocks) on 132 SMs the grid is one
    wave in which each warp combines one ring block, with 16-byte accesses:
    8 loads an input a lane (fp32), all before its first store."""
    n = 1638400 // 1024
    grid = combine_grid(n, 132)
    assert grid == n // WARPS_PER_CTA <= CTAS_PER_SM * 132
    assert all(len(worker_ring_blocks(w, n, grid)) == 1
               for w in range(grid * WARPS_PER_CTA))
    assert combine_vec(1024, 4, 0, 16, 32) == 4
    assert len(lane_elements(0, 1024, 4)) == 8 * 4


@pytest.mark.parametrize("ptrs", [(4, 0, 0), (0, 2, 0), (0, 0, 8)])
def test_combine_vec_falls_back_on_unaligned_pointers(ptrs):
    assert combine_vec(1024, 4, *ptrs) == 1
    assert combine_vec(1024, 2, *ptrs) == 1


@pytest.mark.parametrize("numel,blocks", [
    (4 * 1000, 1), (4 * 1024, 1), (4 * 1025, 2), (4 * 1638401, 1601)])
def test_combine_counters_cover_the_padded_chunk(numel, blocks):
    """One row per reduce-scatter step; a chunk longer than a combine block
    is padded to whole blocks."""
    c = combine_counters(torch.zeros(numel), W)
    assert c.shape == (W - 1, blocks) and c.dtype == torch.int32
    assert not c.any() and not c.is_pinned()


def test_quantize_int8_matches_jax(rng):
    x = (3 * rng.standard_normal((5, 77))).astype(np.float32)
    q, scale, shape, pad = quantize_int8(torch.from_numpy(x))
    jq, jscale, jshape, jpad = jax_quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and (shape, pad) == (tuple(jshape), jpad)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), rtol=1e-7)
    got = dequantize_int8(q, scale, shape, pad).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_dequantize_int8(jq, jscale, jshape, jpad)),
        rtol=0, atol=1e-6)
    assert np.abs(got - x).max() <= 0.5 * float(scale.max()) + 1e-6


def test_stochastic_quantize_rounds_down_or_up(rng):
    """With a generator, each value rounds to the int8 step below or above
    it (the JAX and torch generators draw different noise)."""
    x = (3 * rng.standard_normal(1000)).astype(np.float32)
    q, scale, shape, pad = quantize_int8(
        torch.from_numpy(x), rng=torch.Generator().manual_seed(0))
    qd, _, _, _ = quantize_int8(torch.from_numpy(x))
    diff = q.int() - qd.int()
    assert set(diff.unique().tolist()) <= {-1, 0, 1}
    err = dequantize_int8(q, scale, shape, pad).numpy() - x
    step = np.repeat(scale.numpy(), 256)[:x.size]
    assert (np.abs(err) <= step + 1e-6).all()


def test_run_ranks_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the ranks run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_ranks(failing_rank, 2)


def test_run_ranks_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(failing_rank, 2, device="cpu", timeout=60.0)


# --------------------------------------------------------------------------- #
# one spawn of the ring, against the JAX bodies under shard_map
# --------------------------------------------------------------------------- #
_JAX_RING = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.launch.mesh import make_test_mesh
    from repro.parallel.collectives import (compressed_psum_local,
        ring_all_gather_local, ring_all_reduce_local,
        ring_reduce_scatter_local)
    from repro.parallel.compat import shard_map

    inp = dict(np.load(sys.argv[1]))
    n = 4
    mesh = make_test_mesh(data=1, model=n)

    def run(body, *arrays):
        out = jax.jit(shard_map(body, mesh=mesh,
                                in_specs=(P("model"),) * len(arrays),
                                out_specs=P("model"), check_vma=False))(
            *[jnp.asarray(a.reshape((-1,) + a.shape[2:])) for a in arrays])
        return [np.asarray(o).reshape((n, -1) + o.shape[1:]) for o in out]

    out = {}
    out["reduce_scatter"], out["reduce_scatter_progress"] = run(
        lambda x: ring_reduce_scatter_local(x, "model", n), inp["rs"])
    for off in (0, 1):
        out[f"all_gather_{off}"], out[f"all_gather_{off}_progress"] = run(
            lambda x: ring_all_gather_local(x, "model", n, slot_offset=off),
            inp["ag"])
    out["all_reduce"], out["all_reduce_progress"] = run(
        lambda x: ring_all_reduce_local(x, "model", n), inp["rs"])
    out["compressed"], out["compressed_error"] = run(
        lambda x: compressed_psum_local(x, "model", None), inp["cp"])
    out["compressed_err"], out["compressed_err_error"] = run(
        lambda x, e: compressed_psum_local(x, "model", e),
        inp["cp"], inp["cp_err"])
    np.savez(sys.argv[2], **out)
""")


def _inputs() -> dict:
    rng = np.random.default_rng(13)
    f32 = np.float32
    return {"rs": rng.standard_normal((W, 4 * W, 6)).astype(f32),
            "ag": rng.standard_normal((W, 3, 5)).astype(f32),
            "cp": rng.standard_normal((W, 300)).astype(f32),
            "cp_err": (0.01 * rng.standard_normal((W, 300))).astype(f32),
            "mm_a": rng.standard_normal((64, 100)).astype(f32),
            "mm_b": rng.standard_normal((100, 212)).astype(f32)}


@pytest.fixture(scope="module")
def ring_run(tmp_path_factory):
    """(port results per rank, JAX results, trace dir, inputs): the JAX
    subprocess runs while the 4 ranks do."""
    tmp = tmp_path_factory.mktemp("ring")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_RING, str(tmp / "inputs.npz"),
         str(tmp / "jax.npz")], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        ranks = run_ranks(semantics_rank, W, inputs, BUCKET, ODD_BUCKET, 5,
                          device="cpu", timeout=90.0,
                          log_dir=str(tmp / "traces"))
        log, _ = jax_proc.communicate(timeout=120)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0, log
    return ranks, dict(np.load(tmp / "jax.npz")), tmp / "traces", inputs


@pytest.mark.parametrize("name", [
    "reduce_scatter", "all_gather_0", "all_gather_1", "all_reduce"])
def test_ring_bodies_equal_the_jax_bodies(ring_run, name):
    """fp32, same ring order: equal, not close; progress all ones."""
    ranks, want, _, _ = ring_run
    got = np.stack([r[name] for r in ranks])
    np.testing.assert_array_equal(got, want[name])
    prog = np.stack([r[f"{name}_progress"] for r in ranks])
    np.testing.assert_array_equal(prog, want[f"{name}_progress"])
    assert prog.shape == (W, (2 if name == "all_reduce" else 1) * (W - 1))
    assert (prog == 1).all()


def test_all_reduce_equals_the_sum(ring_run):
    ranks, _, _, inputs = ring_run
    got = np.stack([r["all_reduce"] for r in ranks])
    want = inputs["rs"].astype(np.float64).sum(0)
    np.testing.assert_allclose(got, np.broadcast_to(want, got.shape),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["compressed", "compressed_err"])
def test_compressed_psum_matches_jax(ring_run, name):
    ranks, want, _, _ = ring_run
    for key in (name, f"{name}_error"):
        got = np.stack([r[key] for r in ranks])
        np.testing.assert_allclose(got, want[key], rtol=0, atol=1e-6)


def test_bucket_all_reduce_equals_the_plain_ring_order(ring_run):
    ranks, _, _, _ = ring_run
    for r in ranks:
        b = r["bucket"]
        assert b["bitwise_equal"] and b["finite"], b
        assert b["progress"] == [1] * (2 * (W - 1))
        assert b["launches"] == 0      # the CPU runs the plain version


def test_odd_bucket_combines_whole_blocks(ring_run):
    """A chunk of 1251 elements travels padded to 2048: each of the n - 1
    combines runs two whole 1024-element blocks; the result is still bit
    for bit the plain ring order."""
    ranks, _, traces, _ = ring_run
    for r in ranks:
        b = r["odd_bucket"]
        assert b["numel"] == ODD_BUCKET
        assert b["bitwise_equal"] and b["finite"], b
        assert b["progress"] == [1] * (2 * (W - 1))
    for rank in range(W):
        ring = [e for e in load_jsonl(str(traces / f"rank{rank}.jsonl"))
                if e.name == "ring_combine" and e.step == 4]
        assert len(ring) == W - 1
        for e in ring:
            assert e.meta["shape"] == [2 * COMBINE_BLOCK]
            assert e.meta["parent"] == "step_4"


@pytest.mark.parametrize("fault", [0, 2])
def test_hang_drill_names_the_broken_link(ring_run, fault):
    """Rank f drops its sends to f+1 from ring step 1; the steps each rank
    published from the daemon's hang callback localise the link."""
    ranks, _, _, _ = ring_run
    drills = [next(d for d in r["hang"] if d["fault"] == fault)
              for r in ranks]
    for d in drills:
        assert d["reports"] >= 1 and d["error"] is not None, d
        assert d["steps"] == d["host_steps"] == d["steps_at_end"], d
        # the frozen combine counters: a row per reduce-scatter step, whole
        # where the step's combine ran, zero where it never started
        blocks = np.array(d["counters"])
        assert blocks.shape == (W - 1, 1), d
        done = min(d["steps"], W - 1)
        assert (blocks[:done] == 1).all() and (blocks[done:] == 0).all(), d
    stacks = {r: d["report"]["stack"] for r, d in enumerate(drills)}
    progress = np.array([d["steps"] for d in drills])
    diag = diagnose_hang(stacks, progress)
    assert diag.kind == "comm" and diag.used_inspector
    assert diag.link == (fault, (fault + 1) % W), (progress, diag)
    assert int(progress.argmin()) == (fault + 1) % W
    assert (progress == progress.min()).sum() == 1


def test_ring_trace_reads_back_in_the_jax_package(ring_run):
    """Each rank's spill: n - 1 ``ring_combine`` spans (kind comm) in the
    bucket step with the JAX ``_meta`` bytes and shape, a
    ``padded_matmul`` span with the JAX ``_meta`` flops; the JAX metrics
    give a ring-combine bandwidth and a padded-matmul flops entry."""
    ranks, _, traces, inputs = ring_run
    by_rank = {r: load_jsonl(str(traces / f"rank{r}.jsonl"))
               for r in range(W)}
    chunk = -(-BUCKET // W)
    want_ring = jax_ring_meta(jnp.zeros(chunk, jnp.float32), None)
    a, b = inputs["mm_a"], inputs["mm_b"]
    want_mm = jax_matmul_meta(jnp.asarray(a), jnp.asarray(b))
    for r, events in by_rank.items():
        ring = [e for e in events if e.name == "ring_combine" and e.step == 0]
        assert len(ring) == W - 1
        for e in ring:
            assert e.kind == EventKind.KERNEL_COMM
            assert e.meta["bytes"] == want_ring["bytes"]
            assert e.meta["shape"] == want_ring["shape"]
            assert e.meta["parent"] == "step_0"
        mm = [e for e in events if e.name == "padded_matmul"]
        assert len(mm) == 1 and mm[0].kind == EventKind.KERNEL_COMPUTE
        assert mm[0].step == 3 and mm[0].meta["parent"] == "step_3"
        assert mm[0].meta["flops"] == want_mm["flops"]
        assert mm[0].meta["shape"] == want_mm["shape"]
        hangs = [e for e in events if e.kind == EventKind.HANG_SUSPECT]
        assert {e.step for e in hangs} == {1, 2}
    m0 = aggregate_step(by_rank, 0)
    assert m0.bandwidth["ring_combine"] > 0
    m3 = aggregate_step(by_rank, 3)
    assert set(m3.flops) == {"padded_matmul"}
    assert all(v > 0 for v in m3.flops["padded_matmul"].values())
    np.testing.assert_allclose(ranks[0]["matmul"], a @ b, rtol=1e-4,
                               atol=1e-4)
