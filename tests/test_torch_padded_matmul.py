"""The port's Case-2 padded matmul against the JAX package, on the CPU.

On a CPU tensor ``padded_matmul`` pads to the 128 tile, runs the plain
version of ``matmul_tiled`` and slices back, the path its CUDA kernel
takes on the card (``chip_smoke.py``).  Here it meets the JAX
``padded_matmul`` (Pallas, interpret mode) and the JAX ``matmul_ref`` on
the same inputs, made from a seed with numpy, over the reference's sweep,
at the reference's tolerances (``tests/test_kernels.py``: fp32 3e-4, bf16
5e-2, atol at least 2e-3·√K).  The bf16 tensor-core kernel's order of
summation (K steps of 64, fp32 sums of exact bf16 products) is emulated
here and held to the Pallas kernel (the fp32 route's split TF32 in
``test_torch_matmul_tf32.py``); the choice of kernel (route) by dtype,
the zero padding that TMA's 16-byte rows need, and what the CUDA wrapper
refuses before it launches are checked as plain Python.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.padded_matmul.kernel import matmul_tiled as jax_matmul_tiled
from repro.kernels.padded_matmul.ops import _meta as jax_meta
from repro.kernels.padded_matmul.ops import padded_matmul as jax_padded_matmul
from repro.kernels.padded_matmul.ref import matmul_ref as jax_matmul_ref
from repro_torch.kernels.padded_matmul.ops import (_meta, check_operands,
                                                   matmul_cuda, matmul_ref,
                                                   matmul_tiled,
                                                   padded_matmul, route,
                                                   tma_operands)

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


def _k_chunked(a, b, step=64):
    """The bf16 wgmma kernel's sum: each K step of 64 is an fp32 sum of
    exact bf16 products, added into one fp32 accumulator; rounded once."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], step):
        acc += a[:, k0:k0 + step].float() @ b[k0:k0 + step].float()
    return acc.to(a.dtype)


@pytest.mark.parametrize("mkn", SWEEP + [(128, 1000, 520)])
def test_k_chunked_bf16_sum_matches_pallas(rng, mkn):
    M, K, N = mkn
    aj, at = _pair(rng.standard_normal((M, K)).astype(np.float32), "bfloat16")
    bj, bt = _pair(rng.standard_normal((K, N)).astype(np.float32), "bfloat16")
    got = _k_chunked(at, bt)
    tol = dict(TOLS["bfloat16"])
    tol["atol"] = max(tol["atol"], 2e-3 * K ** 0.5)
    np.testing.assert_allclose(_np(got), _np(jax_padded_matmul(aj, bj)),
                               **tol)


CASE2 = (4096, 8192, 8484)   # padded to N 8576 by the op


@pytest.mark.parametrize("dtype, want", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "tf32x3")])
def test_case2_shape_takes_the_route_of_its_dtype(dtype, want):
    M, K, N = CASE2
    Np = N + (-N) % 128
    assert route(dtype) == want
    a = torch.empty(M, K, dtype=dtype, device="meta")
    b = torch.empty(K, Np, dtype=dtype, device="meta")
    assert check_operands(a, b) == want


@pytest.mark.parametrize("kn", [(100, 96), (768, 100), (100, 212), (8, 8),
                                (8192, 8576)])
def test_tma_operands_pad_k_and_n_to_16_bytes(rng, kn):
    """K and N of a bf16 call go up to a multiple of 8 with zeros, which
    add nothing to the product; the Case-2 operands pass as they are."""
    K, N = kn
    M = 32
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    a2, b2 = tma_operands(a.bfloat16(), b.bfloat16())
    Kp, Np = K + (-K) % 8, N + (-N) % 8
    assert a2.shape == (M, Kp) and b2.shape == (Kp, Np)
    assert a2.is_contiguous() and b2.is_contiguous()
    assert torch.equal(a2[:, :K], a.bfloat16()) and not a2[:, K:].any()
    assert torch.equal(b2[:K, :N], b.bfloat16())
    assert not b2[K:].any() and not b2[:, N:].any()
    np.testing.assert_allclose(
        (a2.float() @ b2.float())[:, :N].numpy(),
        (a.bfloat16().float() @ b.bfloat16().float()).numpy(),
        rtol=1e-5, atol=1e-5)


def test_tma_operands_keep_aligned_operands():
    a = torch.zeros(16, 8192, dtype=torch.bfloat16)
    b = torch.zeros(8192, 8576, dtype=torch.bfloat16)
    a2, b2 = tma_operands(a, b)
    assert a2 is a and b2 is b


def _unaligned(shape, dtype):
    """A contiguous tensor whose data starts 2 elements past an
    allocation, so not on a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 2, dtype=dtype)[2:].view(shape)


@pytest.mark.parametrize("case", ["float16", "mixed", "transposed",
                                  "unaligned_bf16", "cpu"])
def test_matmul_cuda_refuses_what_the_kernels_do_not_take(case):
    bf = torch.bfloat16
    a, b = torch.zeros(64, 128, dtype=bf), torch.zeros(128, 96, dtype=bf)
    err, match = ValueError, None
    if case == "float16":
        a, b, err, match = a.half(), b.half(), TypeError, "float16"
    elif case == "mixed":
        b, err, match = b.float(), TypeError, "one dtype"
    elif case == "transposed":
        a, match = torch.zeros(128, 64, dtype=bf).t(), "contiguous"
    elif case == "unaligned_bf16":
        a, match = _unaligned((64, 128), bf), "aligned"
    else:
        match = "CUDA tensors"
    with pytest.raises(err, match=match):
        matmul_cuda(a, b)


def test_fp32_route_takes_unaligned_operands():
    """The tf32x3 kernel's pre-pass masks its vector loads (and splits an
    a that TMA cannot read), so only the bf16 route needs 16 bytes."""
    a = _unaligned((64, 128), torch.float32)
    assert check_operands(a, torch.zeros(128, 96)) == "tf32x3"
