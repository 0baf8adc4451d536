"""The port's SSD-scan op against the JAX package, on the CPU.

On a CPU tensor ``repro_torch.kernels.ssd_scan.ops.ssd_scan`` computes its
plain version ``ssd_ref``, the function its CUDA kernel is held to on the
card (``chip_smoke.py``).  Here it meets, on the same inputs made from a
seed with numpy:

* the Pallas ``ssd_scan`` (interpret mode), at an L that is a multiple of
  the chunk, which that kernel asserts;
* the model's ``ssd_chunked``, with and without an initial state, on y and
  the final state, at an L that is and one that is not a multiple of the
  chunk (``ssd_chunked`` then takes one chunk of length L, the op pads);
* the step recurrence ``ssd_sequential``, the JAX package's and the port's.

The bf16 route's kernel (``csrc/ssd_scan_wgmma.cu``) rounds more than the
plain version: the scores, ``w∘x`` and the chunk-start state become bf16
operands of its tensor-core products.  ``_tensor_core_ssd`` repeats that
arithmetic in plain PyTorch and is held to the same three oracles (the
fp32 route's split TF32 in ``test_torch_ssd_tf32.py``).  The routes (bf16
-> "wgmma", fp32 -> "tf32x3", both on the tensor cores), the route the mamba2
prefill takes, and the wrappers' refusals are checked here too; the
kernels themselves run only on the card (``chip_smoke.py``).

Tolerances: fp32 4e-4 (``tests/test_kernels.py``' SSD tolerance), bf16
5e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import _meta as jax_meta
from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro.models.mamba2 import ssd_sequential as jax_ssd_sequential
from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels.ssd_scan.ops import (KERNELS, TILE, _meta,
                                             check_operands, kernel_takes,
                                             route, ssd_cuda, ssd_ref,
                                             ssd_scan)
from repro_torch.models import mamba2 as TM
from repro_torch.models.layers import Policy
from repro_torch.models.mamba2 import ssd_sequential

TOLS = {"float32": dict(rtol=4e-4, atol=4e-4),
        "bfloat16": dict(rtol=5e-2, atol=5e-2)}


def _inputs(rng, B, L, H, P, N, init=False):
    """float32 numpy inputs: dt = softplus of a normal draw (> 0), A < 0."""
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)) - 1.0)
                  ).astype(np.float32)
    A = -np.linspace(1.0, 4.0, H).astype(np.float32)
    Bm = rng.standard_normal((B, L, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, N)).astype(np.float32)
    s0 = (rng.standard_normal((B, H, P, N)).astype(np.float32)
          if init else None)
    return x, dt, A, Bm, Cm, s0


def _torch(x, dt, A, Bm, Cm, s0, dtype):
    """x, Bm, Cm in ``dtype`` (round to nearest even, as JAX does); dt, A
    and the state float32."""
    cd = getattr(torch, dtype)
    t = torch.from_numpy
    return (t(x).to(cd), t(dt), t(A), t(Bm).to(cd), t(Cm).to(cd),
            None if s0 is None else t(s0))


def _jax(x, dt, A, Bm, Cm, s0, dtype):
    cd = getattr(jnp, dtype)
    return (jnp.asarray(x, cd), jnp.asarray(dt), jnp.asarray(A),
            jnp.asarray(Bm, cd), jnp.asarray(Cm, cd),
            None if s0 is None else jnp.asarray(s0))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 64, 2, 16, 16, 16),
                                   (2, 96, 3, 8, 16, 32),
                                   (1, 64, 3, 16, 8, 32)])
def test_ssd_scan_matches_pallas_kernel(rng, shape, dtype):
    """shape (B, L, H, P, N, chunk): y against the Pallas kernel."""
    B, L, H, P, N, chunk = shape
    a = _inputs(rng, B, L, H, P, N)
    y, state = ssd_scan(*_torch(*a, dtype)[:5], chunk=chunk)
    assert y.dtype == getattr(torch, dtype) and y.shape == (B, L, H, P)
    assert state.dtype == torch.float32 and state.shape == (B, H, P, N)
    want = jax_ssd_scan(*_jax(*a, dtype)[:5], chunk=chunk)
    np.testing.assert_allclose(_np(y), _np(want), **TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("L,chunk", [(64, 16), (50, 16), (96, 32), (20, 32)])
def test_ssd_scan_matches_ssd_chunked(rng, L, chunk, init, dtype):
    """y and final state against the model's chunked scan; L 50 and 20 are
    ragged (20 < chunk: one short chunk)."""
    a = _inputs(rng, 2, L, 3, 16, 16, init)
    y, state = ssd_scan(*_torch(*a, dtype)[:5], chunk=chunk,
                        initial_state=_torch(*a, dtype)[5])
    yj, sj = jax_ssd_chunked(*_jax(*a, dtype)[:5], chunk, _jax(*a, dtype)[5])
    np.testing.assert_allclose(_np(y), _np(yj), **TOLS[dtype])
    np.testing.assert_allclose(_np(state), _np(sj), **TOLS[dtype])


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("L,chunk", [(48, 16), (37, 16)])
def test_ssd_scan_matches_sequential(rng, L, chunk, init):
    """The chunked op against the step recurrence, the port's and the JAX
    package's (fp32)."""
    a = _inputs(rng, 2, L, 2, 16, 16, init)
    t = _torch(*a, "float32")
    y, state = ssd_scan(*t[:5], chunk=chunk, initial_state=t[5])
    ys, ss = ssd_sequential(*t[:5], initial_state=t[5])
    yj, sj = jax_ssd_sequential(*_jax(*a, "float32")[:5],
                                initial_state=_jax(*a, "float32")[5])
    for want_y, want_s in ((ys, ss), (yj, sj)):
        np.testing.assert_allclose(_np(y), _np(want_y), **TOLS["float32"])
        np.testing.assert_allclose(_np(state), _np(want_s),
                                   **TOLS["float32"])


def test_ssd_ref_is_the_wrappers_cpu_path(rng):
    a = _torch(*_inputs(rng, 1, 40, 2, 8, 8, True), "float32")
    y, s = ssd_scan(*a[:5], chunk=16, initial_state=a[5])
    yr, sr = ssd_ref(*a[:5], 16, a[5])
    assert torch.equal(y, yr) and torch.equal(s, sr)


@pytest.mark.parametrize("chunk", [16, 128, 256])
def test_meta_matches_jax(chunk):
    """The trace's flops and shape for one call, from the same formula."""
    B, L, H, P, N = 2, 300, 48, 64, 128
    x = torch.zeros(B, L, H, P)
    bm = torch.zeros(B, L, N)
    want = jax_meta(jnp.zeros((B, L, H, P)), None, None,
                    jnp.zeros((B, L, N)), None, chunk=chunk)
    assert _meta(x, None, None, bm, None, chunk=chunk) == want


@pytest.mark.parametrize("cfg, takes", [(get_config("mamba2-780m"), True),
                                        (get_reduced("mamba2-780m"), True)])
def test_kernel_takes_the_full_config_only(cfg, takes):
    """The CUDA kernels take the full mamba2-780m (P 64, N 128, chunk
    256) and, since they widened, the reduced one (P 16, N 16, chunk 16,
    run at the kernels' chunk 64)."""
    assert kernel_takes(cfg.ssm_head_dim, cfg.ssm_state,
                        cfg.ssm_chunk) is takes


def _tensor_core_ssd(x, dt, A, Bm, Cm, chunk, initial_state=None):
    """The arithmetic of ``csrc/ssd_scan_wgmma.cu`` on bf16 x/Bm/Cm: per
    chunk (padded to whole 64-row tiles with rows of dt = 0 and zero
    operands) the cumulative decay summed in fp64 from the fp32 products
    dt·A; G = C·Bᵀ in fp32 from the bf16 operands; the scores G ∘ decay
    ∘ dt_s for s ≤ t rounded to bf16 before they multiply x, the decay
    factorised at the first row ref of t's 16-row band where s < ref,
    exp(fp32(cum_t − cum_ref)) · (exp(fp32(cum_ref − cum_s)) · dt_s), and
    exp(fp32(cum_t − cum_s)) · dt_s on the band's diagonal block; the
    inter-chunk term C·S16ᵀ from S16, the chunk-start state
    rounded to bf16, times exp(cum_t); the state decayed by exp(cum_last)
    in fp32 plus (w∘x)ᵀ·B with w∘x rounded to bf16.  Sums in fp32; y
    rounded to bf16 at the end, the state kept in fp32."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    xf, Bf, Cf, dtf, Af = x.float(), Bm.float(), Cm.float(), dt.float(), A
    S = (torch.zeros(Bsz, H, P, N) if initial_state is None
         else initial_state.float().clone())
    y = torch.zeros(Bsz, L, H, P)
    for t0 in range(0, L, chunk):
        lc = min(chunk, L - t0)
        Q = -(-lc // TILE) * TILE

        def rows(t):
            t = t[:, t0:t0 + lc]
            return torch.cat([t, t.new_zeros((Bsz, Q - lc, *t.shape[2:]))], 1)
        xc, Bc, Cc, dtc = rows(xf), rows(Bf), rows(Cf), rows(dtf)
        cum = torch.cumsum((dtc * Af).double(), dim=1)            # [B,Q,H]
        cl = cum[:, -1]                                           # [B,H]
        G = torch.einsum("btn,bsn->bts", Cc, Bc)[..., None]      # [B,t,s,1]
        pos = torch.arange(Q)
        ref = pos // 16 * 16                                      # per t
        cref = cum[:, ref]                                        # [B,t,H]
        et = torch.exp((cum - cref).float())[:, :, None, :]
        es = (torch.exp((cref[:, :, None, :] - cum[:, None, :, :]).float())
              * dtc[:, None, :, :])
        exact = torch.exp((cum[:, :, None, :] - cum[:, None, :, :]).float())
        factor = (pos[None, :] < ref[:, None])[None, :, :, None]
        tri = (pos[None, :] <= pos[:, None])[None, :, :, None]
        scores = torch.where(factor, G * et * es,
                             torch.where(tri, G * exact * dtc[:, None, :, :],
                                         torch.zeros(())))
        scores = scores.bfloat16().float()                        # [B,t,s,H]
        S16 = S.bfloat16().float()
        yc = (torch.einsum("btn,bhpn->bthp", Cc, S16)
              * torch.exp(cum.float())[..., None]
              + torch.einsum("btsh,bshp->bthp", scores, xc))
        y[:, t0:t0 + lc] = yc[:, :lc]
        w = torch.exp((cl[:, None, :] - cum).float()) * dtc       # [B,Q,H]
        wx = (w[..., None] * xc).bfloat16().float()
        S = (S * torch.exp(cl.float())[..., None, None]
             + torch.einsum("bshp,bsn->bhpn", wx, Bc))
    return y.bfloat16(), S


# (B, L, H, P, N): L 1, a ragged L and L 320 (five 64-row chunks)
TC_SHAPES = [(2, 1, 3, 16, 32), (2, 100, 3, 16, 32), (1, 320, 2, 16, 32)]


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("shape", TC_SHAPES)
def test_tensor_core_arithmetic_matches_jax(rng, shape, init):
    """The bf16 route's extra roundings stay inside the bf16 tolerance of
    the model's ``ssd_chunked``, the JAX and the port's ``ssd_sequential``
    and, where L is a multiple of the chunk and no state comes in, the
    Pallas kernel; chunk 64, the kernel's smallest."""
    B, L, H, P, N = shape
    chunk = 64
    a = _inputs(rng, B, L, H, P, N, init)
    t = _torch(*a, "bfloat16")
    j = _jax(*a, "bfloat16")
    y, state = _tensor_core_ssd(*t[:5], chunk, t[5])
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    want = [jax_ssd_chunked(*j[:5], chunk, j[5]),
            jax_ssd_sequential(*j[:5], initial_state=j[5]),
            ssd_sequential(*t[:5], initial_state=t[5])]
    for want_y, want_s in want:
        np.testing.assert_allclose(_np(y), _np(want_y), **TOLS["bfloat16"])
        np.testing.assert_allclose(_np(state), _np(want_s),
                                   **TOLS["bfloat16"])
    if L % chunk == 0 and not init:
        np.testing.assert_allclose(_np(y), _np(jax_ssd_scan(*j[:5],
                                                            chunk=chunk)),
                                   **TOLS["bfloat16"])


def test_tensor_core_arithmetic_rounds_where_the_kernel_does(rng):
    """The emulation is not the plain version by another name: its bf16
    operands move y and the state off ``ssd_ref``, within the bf16
    tolerance."""
    t = _torch(*_inputs(rng, 1, 320, 2, 16, 32, True), "bfloat16")
    y, state = _tensor_core_ssd(*t[:5], 64, t[5])
    yr, sr = ssd_ref(*t[:5], 64, t[5])
    assert not torch.equal(y, yr) and not torch.equal(state, sr)
    np.testing.assert_allclose(_np(y), _np(yr), **TOLS["bfloat16"])
    np.testing.assert_allclose(_np(state), _np(sr), **TOLS["bfloat16"])


@pytest.mark.parametrize("dtype, want", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "tf32x3")])
def test_route_by_dtype(dtype, want):
    assert route(dtype) == want
    assert set(KERNELS) == {"wgmma", "tf32x3"}


def test_route_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float16"):
        route(torch.float16)


@pytest.mark.parametrize("dtype, want", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "tf32x3")])
def test_mamba2_prefill_takes_the_route_of_its_dtype(monkeypatch, dtype,
                                                     want):
    """One full-width mamba2-780m block's prefill (B 8, L 1024) on the meta
    device: the scan's operands are ones the kernels take, on the route of
    the compute dtype."""
    cfg = get_config("mamba2-780m")
    routes = []

    def record(x, dt, A, Bm, Cm, chunk=256, initial_state=None):
        routes.append(check_operands(x, dt, A, Bm, Cm, chunk, initial_state))
        B, L, H, P = x.shape
        return (torch.empty_like(x),
                x.new_empty((B, H, P, Bm.shape[-1]), dtype=torch.float32))

    monkeypatch.setattr(TM, "ssd_scan", record)
    block = TM.Mamba2Block(cfg, Policy(dtype).compute_dtype, "meta")
    u = torch.empty(8, 1024, cfg.d_model, dtype=dtype, device="meta")
    out, cache = TM.mamba_apply(block, u, cfg, return_state=True)
    assert routes == [want]
    assert out.shape == u.shape and cache["state"].dtype == torch.float32


def _operands(dtype=torch.bfloat16, B=1, L=8, H=2, P=64, N=128):
    return (torch.zeros(B, L, H, P, dtype=dtype), torch.zeros(B, L, H),
            torch.zeros(H), torch.zeros(B, L, N, dtype=dtype),
            torch.zeros(B, L, N, dtype=dtype))


@pytest.mark.parametrize("case", ["P16", "N32", "chunk100", "float16",
                                  "mixed", "dt_bf16", "state_bf16",
                                  "transposed", "unaligned", "cpu"])
def test_ssd_cuda_refuses_what_the_kernels_do_not_take(case):
    x, dt, A, Bm, Cm = _operands()
    kw, err, match = {}, ValueError, None
    if case == "P16":
        # head_dim 16, state 32 and chunk 100 are taken (the kernels run the
        # chunk at 64): only the CPU tensors are refused
        x, dt, A, Bm, Cm = _operands(P=16)
        match = "CUDA tensors"
    elif case == "N32":
        x, dt, A, Bm, Cm = _operands(N=32)
        match = "CUDA tensors"
    elif case == "chunk100":
        kw, match = {"chunk": 100}, "CUDA tensors"
    elif case == "float16":
        x, dt, A, Bm, Cm = _operands(torch.float16)
        err, match = TypeError, "float16"
    elif case == "mixed":
        Bm, err, match = Bm.float(), TypeError, "one dtype"
    elif case == "dt_bf16":
        dt, err, match = dt.bfloat16(), TypeError, "float32 dt"
    elif case == "state_bf16":
        kw = {"initial_state": torch.zeros(1, 2, 64, 128,
                                           dtype=torch.bfloat16)}
        match = "initial_state"
    elif case == "transposed":
        x = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16).transpose(1, 2)
        match = "contiguous"
    elif case == "unaligned":
        x = torch.zeros(8 * 2 * 64 + 2, dtype=torch.bfloat16)[2:].view(
            1, 8, 2, 64)
        match = "aligned"
    else:
        match = "CUDA tensors"
    with pytest.raises(err, match=match):
        ssd_cuda(x, dt, A, Bm, Cm, **kw)
