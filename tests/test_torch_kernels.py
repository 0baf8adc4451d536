"""The port's kernel modules against the JAX package, on the CPU.

On a CPU tensor each wrapper of ``repro_torch.kernels`` computes its plain
PyTorch version, the same function its CUDA kernel is held to on the card
(``chip_smoke.py``).  Here the plain versions meet the JAX oracles on the
same inputs, made from a seed with numpy:

* ``fused_ref`` against the Pallas ``fused_residual_rmsnorm`` (interpret
  mode) and the JAX ``fused_norm/ref.py`` oracle;
* ``attention_ref`` against the JAX ``flash_attention/ref.py`` oracle and
  the model's ``direct_attention``.  The Pallas flash kernel cannot be the
  oracle: its body calls ``pl.load``, which the installed JAX no longer
  has.

Tolerances are those of ``tests/test_kernels.py``: fp32 3e-4, bf16 5e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.fused_norm.ops import fused_residual_rmsnorm as jax_fused
from repro.kernels.fused_norm.ref import fused_ref as jax_fused_ref
from repro.models.attention import direct_attention as jax_direct
from repro_torch.kernels.flash_attention.ops import (attention_ref,
                                                     flash_attention)
from repro_torch.kernels.fused_norm.ops import (fused_ref,
                                                fused_residual_rmsnorm)
from repro_torch.kernels.ssd_scan.ops import ssd_scan

TOLS = {"float32": dict(rtol=3e-4, atol=3e-4),
        "bfloat16": dict(rtol=5e-2, atol=5e-2)}


def _pair(a: np.ndarray, dtype: str):
    """One float32 numpy array as a JAX and a torch array of ``dtype``;
    both round float32 -> bfloat16 to nearest even, so the inputs agree."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(256, 64), (512, 96), (128, 256)])
def test_fused_ref_matches_jax(rng, shape, dtype):
    R, D = shape
    xj, xt = _pair(rng.standard_normal((R, D)).astype(np.float32), dtype)
    rj, rt = _pair(rng.standard_normal((R, D)).astype(np.float32), dtype)
    sj, st = _pair(rng.standard_normal((D,)).astype(np.float32), dtype)
    y, h = fused_residual_rmsnorm(xt, rt, st)
    assert y.dtype == h.dtype == xt.dtype
    for yj, hj in (jax_fused(xj, rj, sj, block_r=128),
                   jax_fused_ref(xj, rj, sj)):
        np.testing.assert_allclose(_np(y), _np(yj), **TOLS[dtype])
        np.testing.assert_allclose(_np(h), _np(hj), **TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 100, 4, 4, 16), (2, 130, 4, 2, 64),
                                   (1, 77, 8, 2, 16), (1, 256, 8, 2, 64)])
def test_attention_ref_matches_jax(rng, shape, causal, dtype):
    """shape (B, S, H, KV, hd): S off the 128 grid, hd 16/64, G 1/2/4."""
    B, S, H, KV, hd = shape
    qj, qt = _pair(rng.standard_normal((B, S, H, hd)).astype(np.float32), dtype)
    kj, kt = _pair(rng.standard_normal((B, S, KV, hd)).astype(np.float32), dtype)
    vj, vt = _pair(rng.standard_normal((B, S, KV, hd)).astype(np.float32), dtype)
    o = flash_attention(qt, kt, vt, causal=causal)
    assert o.dtype == qt.dtype and o.shape == qt.shape
    np.testing.assert_allclose(_np(o), _np(attention_ref(qt, kt, vt, causal)),
                               rtol=0, atol=0)
    for ref in (jax_attention_ref(qj, kj, vj, causal=causal),
                jax_direct(qj, kj, vj, causal=causal)):
        np.testing.assert_allclose(_np(o), _np(ref), **TOLS[dtype])


def test_fused_ref_is_the_unfused_math(rng):
    """y is RMSNorm of h = x + res with fp32 statistics."""
    x = torch.from_numpy(rng.standard_normal((8, 32)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((8, 32)).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal((32,)).astype(np.float32))
    y, h = fused_ref(x, r, s, eps=1e-6)
    hh = x + r
    want = hh / torch.sqrt((hh * hh).mean(-1, keepdim=True) + 1e-6) * s
    torch.testing.assert_close(h, hh)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("op", ["fused", "flash", "ssd"])
def test_wrappers_refuse_other_devices(op):
    """Only CPU tensors take the plain version; others launch or raise."""
    if op == "fused":
        x = torch.empty(4, 8, device="meta")
        with pytest.raises(ValueError, match="device"):
            fused_residual_rmsnorm(x, x, torch.empty(8, device="meta"))
    elif op == "flash":
        q = torch.empty(1, 4, 2, 64, device="meta")
        with pytest.raises(ValueError, match="device"):
            flash_attention(q, q, q)
    else:
        x = torch.empty(1, 4, 2, 64, device="meta")
        bm = torch.empty(1, 4, 128, device="meta")
        with pytest.raises(ValueError, match="device"):
            ssd_scan(x, torch.empty(1, 4, 2, device="meta"),
                     torch.empty(2, device="meta"), bm, bm, chunk=256)
