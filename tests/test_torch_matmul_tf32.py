"""The split-TF32 fp32 matmul kernel's arithmetic, on the CPU.

``csrc/padded_matmul_tf32.cu`` (the fp32 route of the Case-2 padded matmul,
``"tf32x3"``) runs only on the card, where ``chip_smoke.py`` holds it to
``matmul_ref``.  Its arithmetic is pinned here first, in plain PyTorch:

* the pre-pass: b^T split into hi and lo, [2, N, Kp] with Kp = K rounded up
  to 4 and the columns past K zero; a split the same way, in shared memory
  by the warpgroup that reads it or, for an a that TMA cannot read, by the
  pre-pass into [2, M, Kp];
* the sum: one fp32 accumulator per output, the K axis in k8 steps in
  order, each adding a_hi.b_lo, a_lo.b_hi and a_hi.b_hi;
* the layouts: the pre-pass's index functions, a TMA box of each stage in
  the 128-byte swizzle and the K-major wgmma descriptor's k8 step, element
  by element.

The emulation is held against the JAX package on the same fp32 inputs,
made from a seed with numpy, at the reference's padded-matmul tolerance
(``tests/test_kernels.py``: fp32 3e-4, atol at least 2e-3·√K, which is
``chip_smoke.matmul_tol``): ``matmul_tiled`` in interpret mode on shapes it
takes unpadded (aligned, or below the 128 tile with K or N off a multiple
of 4) and ``padded_matmul`` over the reference's sweep.  The emulation
rounds each fp32 addition to nearest; the card's tensor cores accumulate
with less care, which only the card check sees.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.padded_matmul.kernel import matmul_tiled as jax_matmul_tiled
from repro.kernels.padded_matmul.ops import padded_matmul as jax_padded_matmul
from repro_torch.kernels.padded_matmul import ops
from torch_tf32 import k_major_read, mm1, split, swizzled

BK = 32            # a stage's K step: 32 fp32, one 128-byte swizzle row
BM, BN = 128, 256  # the output tile


def matmul_tol(K: int) -> dict:
    return dict(rtol=3e-4, atol=max(3e-4, 2e-3 * K ** 0.5))


def kp(K: int) -> int:
    return -(-K // 4) * 4


# ------------------------------------------------------------ pre-pass --
def bt_index(k: int, n: int, N: int, Kp: int, lo: bool) -> int:
    """The float offset of b[k, n]'s hi (or lo) term in the pre-pass's
    b^T pair [2, N, Kp]."""
    return int(lo) * N * Kp + n * Kp + k


def a_index(m: int, k: int, M: int, Kp: int, lo: bool) -> int:
    """The float offset of a[m, k]'s hi (or lo) term in a's pair
    [2, M, Kp]."""
    return int(lo) * M * Kp + m * Kp + k


def prepass_bt(b: torch.Tensor) -> torch.Tensor:
    """The pre-pass's b^T pair, flat, written through ``bt_index``."""
    K, N = b.shape
    Kp = kp(K)
    hi, lo = split(b)
    out = torch.full((2 * N * Kp,), float("nan"))
    for k in range(Kp):
        for n in range(N):
            out[bt_index(k, n, N, Kp, False)] = hi[k, n] if k < K else 0.0
            out[bt_index(k, n, N, Kp, True)] = lo[k, n] if k < K else 0.0
    return out


# ------------------------------------------------------------ emulation --
def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor, passes: int = 3):
    """The arithmetic of ``padded_matmul_tf32.cu`` on fp32 a [M,K], b [K,N]:
    both split (zeros past K to Kp), then per k8 step a_hi.b_lo, a_lo.b_hi,
    a_hi.b_hi added in that order into one fp32 accumulator (``passes`` 1:
    a_hi.b_hi alone)."""
    M, K = a.shape
    N = b.shape[1]
    Kp = kp(K)
    ah, al = split(torch.nn.functional.pad(a, (0, Kp - K)))
    bh, bl = split(torch.nn.functional.pad(b, (0, 0, 0, Kp - K)))
    acc = torch.zeros(M, N)
    for k0 in range(0, Kp, 8):
        s = slice(k0, k0 + 8)
        if passes == 3:
            acc += ah[:, s] @ bl[s]
            acc += al[:, s] @ bh[s]
        acc += ah[:, s] @ bh[s]
    return acc


def padded(a, b, block=128):
    """The op's padding to the tile, as ``ops.padded_matmul`` does."""
    M, K = a.shape
    N = b.shape[1]
    return (torch.nn.functional.pad(a, (0, (-K) % block, 0, (-M) % block)),
            torch.nn.functional.pad(b, (0, (-N) % block, 0, (-K) % block)))


# ---------------------------------------------------------------- tests --
# shapes matmul_tiled takes unpadded: aligned, below the tile, K or N off a
# multiple of 4
TILED = [(128, 128, 128), (64, 100, 96), (32, 101, 99), (96, 127, 7),
         (256, 384, 126)]
SWEEP = [(128, 128, 128), (64, 100, 212), (256, 384, 212), (32, 848, 96)]


@pytest.mark.parametrize("mkn", TILED)
def test_arithmetic_matches_pallas_matmul_tiled(rng, mkn):
    M, K, N = mkn
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    got = tf32x3_matmul(torch.from_numpy(a), torch.from_numpy(b))
    want = jax_matmul_tiled(jnp.asarray(a), jnp.asarray(b), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **matmul_tol(K))


@pytest.mark.parametrize("mkn", SWEEP)
def test_arithmetic_matches_pallas_padded_matmul(rng, mkn):
    """Through the op's padding to the 128 tile, sliced back."""
    M, K, N = mkn
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    ap, bp = padded(torch.from_numpy(a), torch.from_numpy(b))
    got = tf32x3_matmul(ap, bp)[:M, :N]
    want = jax_padded_matmul(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **matmul_tol(K))


def fp32_in_kernel_order(a, b):
    """The fp32 product summed as the kernel sums: k8 steps in order into
    one fp32 accumulator, each step's products exact in fp32."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], 8):
        acc += a[:, k0:k0 + 8] @ b[k0:k0 + 8]
    return acc


def test_three_passes_are_fp32_where_one_is_not(rng):
    """At the Case-2 K of 8192, against an fp64 product: the three passes
    are within 4x the error of exact fp32 products summed in the kernel's
    order (they add three terms a k8 step where that sum adds one; the
    split itself drops ~2^-22 of each product) and meet fp32's 3e-4; one
    TF32 pass is ~100x further off and misses 3e-4.  matmul_tol's
    √K atol (0.181 here) admits one pass on unit normals all the same, so
    a card check at matmul_tol alone cannot tell one pass from three:
    ``chip_smoke.py`` also holds the route's error against an fp64 product
    beside that of ``torch.matmul`` fp32."""
    K = 8192
    a = torch.from_numpy(rng.standard_normal((32, K)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((K, 48)).astype(np.float32))
    exact = a.double() @ b.double()
    three = tf32x3_matmul(a, b)
    one = tf32x3_matmul(a, b, passes=1)
    assert torch.allclose(one, mm1(a, b), rtol=1e-5, atol=1e-3)
    err = {name: float((got.double() - exact).abs().max())
           for name, got in (("three", three), ("one", one),
                             ("fp32", fp32_in_kernel_order(a, b)))}
    assert err["three"] < 4 * err["fp32"]
    assert err["one"] > 50 * err["three"]
    fp32 = dict(rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(three.numpy(), exact.numpy(), **fp32)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(one.numpy(), exact.numpy(), **fp32)
    np.testing.assert_allclose(one.numpy(), exact.numpy(), **matmul_tol(K))


@pytest.mark.parametrize("kn", [(40, 24), (37, 9), (70, 33)])
def test_prepass_layout_is_what_each_k8_step_reads(rng, kn):
    """b^T's pair written through ``bt_index``, brought stage by stage as
    the kernel's TMA boxes (32 columns of K, 256 rows of n, the 128-byte
    swizzle, zeros past the tensor), then read through the K-major
    descriptor of each k8 step: every element of b's split arrives at the
    (row n, K index) the product reads, and nothing else does."""
    K, N = kn
    Kp = kp(K)
    b = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    flat = prepass_bt(b)
    hi, lo = split(b)
    for half, want in ((False, hi), (True, lo)):
        base = int(half) * N * Kp
        for kt in range(-(-Kp // BK)):
            tile = torch.zeros(BN * BK)        # the stage's box, swizzled
            for r in range(min(BN, N)):
                for c in range(BK):
                    k = kt * BK + c
                    if k < Kp:
                        tile[swizzled(BN, r, c)] = flat[base + r * Kp + k]
            for kk in range(BK // 8):
                for r in range(min(BN, N)):
                    for j in range(8):
                        k = kt * BK + 8 * kk + j
                        got = float(tile[k_major_read(BN, r, kk, j)])
                        assert got == (float(want[k, r]) if k < K else 0.0)


def test_a_pair_index_is_row_major_hi_then_lo():
    """a's pair [2, M, Kp] is K-major as a lies, so the same box and
    descriptor read it; the lo terms follow all the hi terms."""
    M, K = 5, 9
    Kp = kp(K)
    offs = {a_index(m, k, M, Kp, lo) for m in range(M) for k in range(Kp)
            for lo in (False, True)}
    assert offs == set(range(2 * M * Kp))
    assert a_index(0, 0, M, Kp, True) == M * Kp


def test_scratch_is_what_the_launch_function_takes():
    """The scratch by name in the C function's order (a_pair, bt_pair),
    its shapes and bytes at the Case-2 shape (N padded to 8576): b^T's pair
    562,036,736 B; with a split by the pre-pass too, 830,472,192 B."""
    K = ops.KERNELS["tf32x3"]
    assert K.source == "padded_matmul_tf32.cu"
    assert K.symbol == "matmul_tf32_launch"
    # a, b, out, a_pair, bt_pair; M, N, K, split_a_in_kernel; stream
    assert len(K.argtypes) == 10
    assert ops.tf32_scratch(4096, 8576, 8192, True) == {
        "bt_pair": (2, 8576, 8192)}
    assert list(ops.tf32_scratch(4096, 8576, 8192, False)) == ["a_pair",
                                                              "bt_pair"]
    assert ops.tf32_scratch_bytes(4096, 8576, 8192, True) == 562_036_736
    assert ops.tf32_scratch_bytes(4096, 8576, 8192, False) == 830_472_192
    # K off a multiple of 4 rounds up: the rows stay 16 bytes apart
    assert ops.tf32_scratch(32, 99, 101, False) == {
        "a_pair": (2, 32, 104), "bt_pair": (2, 99, 104)}


def _at(shape, offset):
    n = int(np.prod(shape))
    return torch.zeros(n + offset)[offset:].view(shape)


@pytest.mark.parametrize("K, offset, want", [(8192, 0, True), (100, 0, True),
                                             (101, 0, False),
                                             (8192, 1, False)])
def test_a_is_split_in_the_kernel_where_tma_reads_it(K, offset, want):
    """A 16-byte-aligned a with K a multiple of 4 is split in shared
    memory; any other a by the pre-pass."""
    assert ops.tf32_split_a_in_kernel(_at((16, K), offset)) is want


def test_route_and_kernels():
    assert ops.route(torch.float32) == "tf32x3"
    assert set(ops.KERNELS) == {"wgmma", "tf32x3"}
