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
from repro_torch.kernels.ssd_scan.ops import (_meta, kernel_takes, ssd_ref,
                                             ssd_scan)
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
                                        (get_reduced("mamba2-780m"), False)])
def test_kernel_takes_the_full_config_only(cfg, takes):
    """The CUDA kernel has an instance for the full mamba2-780m (P 64,
    N 128, chunk 256), not for the reduced one (P 16, N 16, chunk 16)."""
    assert kernel_takes(cfg.ssm_head_dim, cfg.ssm_state,
                        cfg.ssm_chunk) is takes
