"""The port's Case-2 padded matmul against the JAX package, on the CPU.

On a CPU tensor ``padded_matmul`` pads to the 128 tile, runs the plain
version of ``matmul_tiled`` and slices back, the path its CUDA kernel
takes on the card (``chip_smoke.py``).  Here it meets the JAX
``padded_matmul`` (Pallas, interpret mode) and the JAX ``matmul_ref`` on
the same inputs, made from a seed with numpy, over the reference's sweep,
at the reference's tolerances (``tests/test_kernels.py``: fp32 3e-4, bf16
5e-2, atol at least 2e-3·√K).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.padded_matmul.kernel import matmul_tiled as jax_matmul_tiled
from repro.kernels.padded_matmul.ops import _meta as jax_meta
from repro.kernels.padded_matmul.ops import padded_matmul as jax_padded_matmul
from repro.kernels.padded_matmul.ref import matmul_ref as jax_matmul_ref
from repro_torch.kernels.padded_matmul.ops import (_meta, matmul_ref,
                                                   matmul_tiled,
                                                   padded_matmul)

TOLS = {"float32": dict(rtol=3e-4, atol=3e-4),
        "bfloat16": dict(rtol=5e-2, atol=5e-2)}
SWEEP = [(128, 128, 128), (64, 100, 212), (256, 384, 212), (32, 848, 96)]


def _pair(a: np.ndarray, dtype: str):
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mkn", SWEEP)
def test_padded_matmul_matches_jax(rng, mkn, dtype):
    M, K, N = mkn
    aj, at = _pair(rng.standard_normal((M, K)).astype(np.float32), dtype)
    bj, bt = _pair(rng.standard_normal((K, N)).astype(np.float32), dtype)
    got = padded_matmul(at, bt)
    assert got.shape == (M, N) and got.dtype == at.dtype
    tol = dict(TOLS[dtype])
    tol["atol"] = max(tol["atol"], 2e-3 * K ** 0.5)
    for want in (jax_padded_matmul(aj, bj), jax_matmul_ref(aj, bj),
                 matmul_ref(at, bt)):
        np.testing.assert_allclose(got.float().numpy(),
                                   _np(want), **tol)


@pytest.mark.parametrize("mkn", SWEEP)
def test_meta_is_the_jax_meta_of_the_unpadded_shape(mkn):
    M, K, N = mkn
    a, b = np.zeros((M, K), np.float32), np.zeros((K, N), np.float32)
    want = jax_meta(jnp.asarray(a), jnp.asarray(b))
    assert _meta(torch.from_numpy(a), torch.from_numpy(b)) == want
    assert want["flops"] == 2.0 * M * K * N and want["shape"] == [M, K, N]


@pytest.mark.parametrize("mkn", [(200, 128, 128), (128, 300, 128),
                                 (128, 128, 130)])
def test_matmul_tiled_refuses_unaligned_shapes(mkn):
    """Where the TPU kernel asserts, the port raises."""
    M, K, N = mkn
    a, b = np.ones((M, K), np.float32), np.ones((K, N), np.float32)
    with pytest.raises(AssertionError):
        jax_matmul_tiled(jnp.asarray(a), jnp.asarray(b), interpret=True)
    with pytest.raises(ValueError, match="aligned"):
        matmul_tiled(torch.from_numpy(a), torch.from_numpy(b))


def test_matmul_tiled_takes_blocks_cut_to_small_dims(rng):
    """``block = min(block, dim)``: a 64-row a is aligned, as in JAX."""
    a = rng.standard_normal((64, 256)).astype(np.float32)
    b = rng.standard_normal((256, 128)).astype(np.float32)
    got = matmul_tiled(torch.from_numpy(a), torch.from_numpy(b))
    want = jax_matmul_tiled(jnp.asarray(a), jnp.asarray(b), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=3e-4)


def test_matmul_tiled_takes_ragged_dims_below_the_tile(rng):
    """Below the tile a dimension may have any length (the tile is cut to
    it): M 64, K 100, N 96 run unpadded, as in JAX."""
    a = rng.standard_normal((64, 100)).astype(np.float32)
    b = rng.standard_normal((100, 96)).astype(np.float32)
    got = matmul_tiled(torch.from_numpy(a), torch.from_numpy(b))
    want = jax_matmul_tiled(jnp.asarray(a), jnp.asarray(b), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=3e-4)


def test_padded_matmul_refuses_a_block_off_the_tile():
    a = torch.ones(64, 64)
    with pytest.raises(ValueError, match="multiple of the 128 tile"):
        padded_matmul(a, a, block=64)
    assert padded_matmul(a, a, block=256).shape == (64, 64)
