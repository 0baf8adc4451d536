"""The widths the JAX package runs beside the published ones, on the CPU.

The JAX package's kernels take any head_dim, any SSD head_dim and state,
and any chunk; its reduced configs (head_dim 16, 8 for qwen2-72b and
llama3-405b; the SSD at P 16, N 16, chunk 16) and its own kernel sweep
(``tests/test_kernels.py``: flash at hd 32, the SSD scan at P 8 to 32, N 8
and 16, chunk 32) run at widths the published configs never reach.  The
port's kernels take them too (flash head_dim 8, 16, 32, 64, 80, 128; the
SSD scan head_dim 8, 16, 32, 64 and state 8, 16, 32, 64, 128, any chunk,
run at the chunk of its 64-row tiles).  The kernels run only on the card
(``chip_smoke.py``); here, on the same inputs made from a seed with numpy,
the port's plain versions (what its wrappers compute on CPU tensors, and
what the kernels are held to on the card) meet the JAX package:

* flash attention forward and backward at the JAX sweep's shapes and at
  hd 8 and 16, both causal values, against
  ``repro.kernels.flash_attention.ref.attention_ref`` and its ``jax.vjp``.
  The JAX package's Pallas flash kernel cannot run here: jax 0.9.0 has no
  ``pl.load``, which it calls, so its own sweep fails on this jax
  (``tests/test_kernels.py::test_flash_attention_sweep``), and the oracle
  is its plain reference;
* the SSD scan at the JAX sweep's shapes against the Pallas ``ssd_scan``
  in interpret mode, and the port at its kernels' chunk (64) against the
  JAX package at chunk 16 and 32: the chunk is a blocking of the scan, not
  a part of the function, which is what lets the card run a reduced
  config's chunk 16 at 64;
* the one place that says which widths the kernels take (``route``,
  ``check_operands``, ``kernel_takes``, the meta routes): every width of
  the table taken, one outside it refused, a CPU tensor refused by the
  CUDA wrappers before a launch;
* the split-TF32 scratch at the narrow widths, sized by the padded tiles;
* ``registry.kernel_refusal``: None for every config of the zoo.

Tolerances are those of ``tests/test_kernels.py``: flash fp32 3e-4, bf16
5e-2; the SSD scan 4e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.ssd_scan import ops as ssd
from repro_torch.models.registry import kernel_refusal

TOLS = {"float32": dict(rtol=3e-4, atol=3e-4),
        "bfloat16": dict(rtol=5e-2, atol=5e-2)}
SSD_TOL = dict(rtol=4e-4, atol=4e-4)

# the JAX sweep's flash shapes (B, S, H, KV, hd), then hd 8 and 16 on its
# hd 32 shape and at the reduced configs' group sizes (4 and 2)
FLASH_SWEEP = [(1, 256, 4, 2, 64), (2, 384, 6, 3, 32), (1, 128, 2, 1, 128)]
FLASH_NARROW = [(2, 384, 6, 3, 8), (2, 384, 6, 3, 16), (2, 64, 4, 1, 16),
                (2, 64, 8, 2, 8)]
# the JAX sweep's SSD shapes (B, L, H, P, N)
SSD_SWEEP = [(1, 64, 2, 8, 8), (2, 128, 3, 16, 8), (1, 96, 1, 32, 16)]
FLASH_TAKEN = (8, 16, 32, 64, 80, 128)
SSD_P_TAKEN = (8, 16, 32, 64)
SSD_N_TAKEN = (8, 16, 32, 64, 128)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _qkv(rng, B, S, H, KV, hd, dtype):
    """q, k, v and the output's cotangent as (jax arrays, torch leaves that
    want a gradient) of ``dtype``, from one float32 numpy draw each."""
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                      (B, S, H, hd))]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_()
          for a in arrs]
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_SWEEP + FLASH_NARROW)
def test_flash_forward_at_the_jax_widths(rng, shape, causal, dtype):
    (jq, jk, jv, _), (q, k, v, _) = _qkv(rng, *shape, dtype)
    got = fa.flash_attention(q.detach(), k.detach(), v.detach(), causal)
    want = jax_attention(jq, jk, jv, causal=causal)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), **TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_SWEEP + FLASH_NARROW)
def test_flash_backward_at_the_jax_widths(rng, shape, causal, dtype):
    """The port's autograd (``FlashAttention``, whose backward is
    ``attention_bwd_ref`` on CPU tensors) against ``jax.vjp`` of the JAX
    oracle, on the same cotangent."""
    (jq, jk, jv, jdo), (q, k, v, do) = _qkv(rng, *shape, dtype)
    o = fa.flash_attention(q, k, v, causal)
    got = torch.autograd.grad(o, (q, k, v), do.detach())
    _, vjp = jax.vjp(lambda a, b, c: jax_attention(a, b, c, causal=causal),
                     jq, jk, jv)
    for g, w in zip(got, vjp(jdo)):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), _np(w), **TOLS[dtype])


def _ssd_inputs(rng, B, L, H, P, N):
    """float32 numpy inputs as the JAX sweep draws them."""
    return (rng.standard_normal((B, L, H, P)).astype(np.float32),
            rng.uniform(0.01, 0.2, (B, L, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (H,)).astype(np.float32),
            rng.standard_normal((B, L, N)).astype(np.float32),
            rng.standard_normal((B, L, N)).astype(np.float32))


@pytest.mark.parametrize("shape", SSD_SWEEP)
def test_ssd_scan_at_the_jax_sweep(rng, shape):
    """The JAX sweep's shapes at its chunk (32 where it divides L, else L)
    against the Pallas kernel in interpret mode."""
    B, L, H, P, N = shape
    chunk = 32 if L % 32 == 0 else L
    arrs = _ssd_inputs(rng, *shape)
    y, state = ssd.ssd_scan(*(torch.from_numpy(a) for a in arrs),
                            chunk=chunk)
    want = jax_ssd_scan(*(jnp.asarray(a) for a in arrs), chunk=chunk,
                        interpret=True)
    assert state.shape == (B, H, P, N)
    np.testing.assert_allclose(_np(y), _np(want), **SSD_TOL)


@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("shape", [(2, 64, 8, 16, 16), (2, 128, 3, 16, 8)])
def test_ssd_scan_kernel_chunk_is_the_same_function(rng, shape, chunk):
    """A CUDA call runs a requested chunk 16 or 32 at 64
    (``kernel_chunk``); the port's plain version at 64 equals the JAX
    package's Pallas kernel at the requested chunk, and its own run at that
    chunk (y and the final state), within the SSD tolerance."""
    assert ssd.kernel_chunk(chunk) == 64
    arrs = _ssd_inputs(rng, *shape)
    t = [torch.from_numpy(a) for a in arrs]
    y64, s64 = ssd.ssd_ref(*t, chunk=64)
    y, s = ssd.ssd_ref(*t, chunk=chunk)
    want = jax_ssd_scan(*(jnp.asarray(a) for a in arrs), chunk=chunk,
                        interpret=True)
    np.testing.assert_allclose(_np(y64), _np(want), **SSD_TOL)
    np.testing.assert_allclose(_np(y64), _np(y), **SSD_TOL)
    np.testing.assert_allclose(_np(s64), _np(s), **SSD_TOL)


@pytest.mark.parametrize("chunk, runs", [(1, 64), (16, 64), (63, 64),
                                         (64, 64), (96, 64), (200, 192),
                                         (256, 256), (1024, 256)])
def test_kernel_chunk(chunk, runs):
    assert ssd.kernel_chunk(chunk) == runs
    assert ssd.kernel_takes(16, 16, chunk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_takes_every_width_of_the_table(dtype):
    """``route`` and ``check_operands`` take each head_dim of the table,
    the meta route returns its outputs and charges nothing but on an
    analysis; hd 24 is refused by all three."""
    assert fa.HEAD_DIMS == FLASH_TAKEN
    for hd in FLASH_TAKEN:
        q = torch.zeros(1, 8, 4, hd, dtype=dtype)
        k = torch.zeros(1, 8, 2, hd, dtype=dtype)
        want = {torch.float32: "tf32x3", torch.bfloat16: "wgmma"}[dtype]
        assert fa.route(dtype, hd) == want
        assert fa.check_operands(q, k, k) == want
        o = fa.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))
        assert o.is_meta and o.shape == q.shape
    q = torch.zeros(1, 8, 4, 24, dtype=dtype)
    for call in (lambda: fa.route(dtype, 24),
                 lambda: fa.check_operands(q, q, q),
                 lambda: fa.flash_attention(*(q.to("meta"),) * 3)):
        with pytest.raises(ValueError, match="head_dim"):
            call()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_takes_every_width_of_the_table(dtype):
    """``kernel_takes`` and ``check_operands`` take each (P, N) of the
    table at a chunk the kernels do not tile (16), the meta routes of both
    directions return their outputs; P 24, N 24 and chunk 0 are refused."""
    assert ssd.HEAD_DIMS == SSD_P_TAKEN and ssd.STATE_DIMS == SSD_N_TAKEN
    for P in SSD_P_TAKEN:
        for N in SSD_N_TAKEN:
            assert ssd.kernel_takes(P, N, 16)
            x = torch.zeros(1, 8, 2, P, dtype=dtype)
            bm = torch.zeros(1, 8, N, dtype=dtype)
            dt, A = torch.ones(1, 8, 2), -torch.ones(2)
            assert ssd.check_operands(x, dt, A, bm, bm, 16) == ssd.route(dtype)
            m = [t.to("meta") for t in (x, dt, A, bm, bm)]
            y, s = ssd.ssd_scan(*m, chunk=16)
            assert y.is_meta and s.shape == (1, 2, P, N)
            grads = ssd.ssd_bwd_meta(*m, m[0], chunk=16)
            assert [g.shape for g in grads] == [t.shape for t in m]
    for P, N, chunk in ((24, 16, 16), (16, 24, 16), (16, 16, 0)):
        assert not ssd.kernel_takes(P, N, chunk)
        x = torch.zeros(1, 8, 2, P, dtype=dtype)
        bm = torch.zeros(1, 8, N, dtype=dtype)
        with pytest.raises(ValueError, match="ssd_scan kernels take"):
            ssd.check_operands(x, torch.ones(1, 8, 2), -torch.ones(2), bm,
                               bm, chunk)


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_cuda_wrappers_refuse_cpu_tensors_at_narrow_widths(direction):
    """At a narrow width the CUDA wrappers raise on a CPU tensor before a
    launch, as at the published ones: nothing falls back to the plain
    version."""
    x = torch.zeros(1, 8, 2, 16)
    bm = torch.zeros(1, 8, 16)
    dt, A = torch.ones(1, 8, 2), -torch.ones(2)
    kernels = {"forward": [*fa.KERNELS.values(), *ssd.KERNELS.values()],
               "backward": [*fa.BWD_KERNELS.values(),
                            *ssd.BWD_KERNELS.values()]}[direction]
    before = [k.launches for k in kernels]
    q = torch.zeros(1, 8, 4, 16)
    lse = torch.zeros(1, 4, 8)
    calls = {"forward": (lambda: fa.attention_cuda(q, q, q),
                         lambda: ssd.ssd_cuda(x, dt, A, bm, bm, 16)),
             "backward": (lambda: fa.attention_bwd_cuda(q, q, q, q, q, lse),
                          lambda: ssd.ssd_bwd_cuda(x, dt, A, bm, bm, x,
                                                   chunk=16))}[direction]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert [k.launches for k in kernels] == before


def test_tf32_scratch_at_the_narrow_widths():
    """The fp32 routes' scratch at the reduced widths: every buffer
    non-empty; the direct and transposed splits at the true widths, the
    SSD backward's items and partials at the padded state (64 columns)."""
    B, L, H, P, N, chunk = 2, 200, 8, 16, 16, 64
    fwd = ssd.tf32_scratch(B, L, N)
    assert fwd == {"bm_pair": (2, B, L, N), "cm_pair": (2, B, L, N)}
    bwd = ssd.tf32_bwd_scratch(B, L, H, N, chunk, P)
    nc, L16 = -(-L // chunk), -(-L // 16) * 16
    assert bwd["dyt"] == (B, H, P, 2 * L16)
    assert bwd["bmt"] == bwd["cmt"] == (B, N, 2 * L16)
    assert bwd["spt"] == bwd["ds"] == bwd["dst"] == (B, H, nc, 1, 2, 64, 64)
    assert bwd["db_part"] == bwd["dc_part"] == (B, 1, L, 64)
    assert all(np.prod(s) > 0 for s in bwd.values())
    assert ssd.tf32_bwd_scratch_bytes(B, L, H, N, chunk, P) == sum(
        (8 if n == "cum" else 4) * int(np.prod(s)) for n, s in bwd.items())
    # state 8 and 32 pad to 64 columns, 128 stays 2 items
    assert ssd.tf32_bwd_scratch(B, L, H, 8, chunk, 8)["spt"][3] == 1
    assert ssd.tf32_bwd_scratch(B, L, H, 128, chunk, 8)["spt"][3] == 2
    for hd in (8, 16, 32):
        for backward in (False, True):
            shapes = fa.tf32_scratch(B, 64, 4, 2, hd, backward)
            assert all(np.prod(s) > 0 and hd in s for s in shapes.values())


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", list_archs())
def test_kernel_refusal_takes_every_config_of_the_zoo(arch, reduced):
    """The card's kernels take every config of the JAX package's zoo,
    published and reduced, at its own widths."""
    cfg = get_reduced(arch) if reduced else get_config(arch)
    assert kernel_refusal(cfg) is None
