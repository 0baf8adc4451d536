"""Split TF32 in plain PyTorch, for the CPU tests of the port's tf32x3
kernels (``flash_attention_tf32.cu``, ``flash_attention_bwd_tf32.cu``,
``padded_matmul_tf32.cu``, ``ssd_scan_tf32.cu``):

* ``tf32``: fp32 -> the nearest tf32 (10 mantissa bits), ties away from
  zero, as ``cvt.rna.tf32.f32``;
* ``split``: hi = tf32(x), lo = tf32(x - hi);
* ``mm3`` / ``mm1``: a product as the three tf32 products hi.lo + lo.hi +
  hi.hi, or as one;
* the layouts the kernels share: ``permuted_row`` (the pre-pass's order of
  each 8 rows, ``flash_tf32_split.cuh``), ``fragment_order`` (a lane-by-lane
  simulation of the accumulator-to-A-fragment hand-over that order
  serves), and ``swizzled`` (the 128-byte swizzle of a tile of 32-float
  rows, TMA's and wgmma's).
"""
import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest tf32 (10 mantissa bits), ties away from zero:
    ``cvt.rna.tf32.f32``, as an fp32 tensor."""
    assert x.dtype == torch.float32
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (u + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32)
    return r.view(torch.float32).reshape(x.shape)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a, b):
    """a @ b as three tf32 products in fp32: hi.lo + lo.hi + hi.hi."""
    ah, al = split(a)
    bh, bl = split(b)
    return ah @ bl + al @ bh + ah @ bh


def mm1(a, b):
    """a @ b as one tf32 product."""
    return tf32(a) @ tf32(b)


def fragment_order():
    """The key of each A column of a k8 step, simulated lane by lane: lane l
    of warp w holds accumulator d[4i+e] = D[16w + l/4 + 8(e>>1)][8i +
    2(l%4) + (e&1)]; split_a hands d[4i], d[4i+2], d[4i+1], d[4i+3] over as
    a[0..3], which the tf32 A fragment reads as A[r][l%4], A[r+8][l%4],
    A[r][l%4+4], A[r+8][l%4+4].  Returns, for each A column c, the
    accumulator column it came from (the same for every row)."""
    order = {}
    for w in range(4):
        for lane in range(32):
            r = 16 * w + lane // 4
            t = lane % 4
            d = {e: (r + 8 * (e >> 1), 2 * t + (e & 1)) for e in range(4)}
            a = [d[0], d[2], d[1], d[3]]
            for (row, col), (arow, acol) in zip(
                    a, [(r, t), (r + 8, t), (r, t + 4), (r + 8, t + 4)]):
                assert row == arow
                assert order.setdefault(acol, col) == col
    return [order[c] for c in range(8)]


def permuted_row(p: int) -> int:
    """``flash_tf32_split.cuh::permuted_row``: the row of a 16-row block
    that position p of the transposed layout holds."""
    return (p & 8) | ((p & 3) << 1) | ((p >> 2) & 1)


def swizzled(rows: int, row: int, col: int) -> int:
    """The float offset of (row, col) in a tile of ``rows`` rows held as
    column blocks of [rows][32] fp32 (128-byte rows) in the 128-byte
    swizzle: the 16-byte chunk index XOR the row mod 8 (the kernels'
    ``swz``, and what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B)."""
    return ((col // 32) * rows * 32 + row * 32
            + ((((col % 32) // 4) ^ (row % 8)) * 4) + col % 4)


def k_major_read(rows: int, row: int, kk: int, j: int) -> int:
    """The float offset that a K-major wgmma operand descriptor (128-byte
    swizzle, SBO 1024) started at k8 step ``kk`` of a column block reads
    for its row ``row`` and K index ``j`` (0..7): the start advances 32
    bytes a step, and the hardware applies the swizzle to the address."""
    block, step = kk // 4, kk % 4
    byte = (row // 8) * 1024 + (row % 8) * 128 + step * 32 + j * 4
    chunk, within = (byte % 128) // 16, byte % 16
    byte = byte - (byte % 128) + ((chunk ^ (row % 8)) * 16) + within
    return block * rows * 32 + byte // 4
