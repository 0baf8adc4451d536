"""The split-TF32 fp32 SSD-scan backward's arithmetic, on the CPU.

``csrc/ssd_scan_bwd_tf32.cu`` (the fp32 route of the SSD backward,
``"tf32x3"``) runs only on the card, where ``chip_smoke.py`` holds it to
``ssd_bwd_ref``.  Its arithmetic is pinned here first, in plain PyTorch
(``tf32x3_backward``): ``ssd_bwd_ref``'s chunked passes with every product
X·Y as X_hi·Y_lo + X_lo·Y_hi + X_hi·Y_hi of tf32 terms, both operands split
(the inputs x, dy, Bm, Cm and the fp32 results that enter a product: w∘B
and exp(cum)∘C in the chunk states, S_prev, dS, the scores G·L·dt_s and
M·L·dt_s), G = C·Bᵀ once for every head (the kernel computes it once a
head group), the decay factorised off each warp's 16-row diagonal block
as each tile kernel does it, dB and dC summed over each group of
``BWD_HEAD_GROUP`` heads, then over the groups in order, ⟨dS, S_prev⟩
with S_prev as its hi + lo.
It is held against ``jax.vjp`` of the JAX package's ``ssd_chunked`` (chunk
16: its own gradient is NaN at longer chunks, ``test_torch_ssd_bwd``) and
``ssd_sequential`` on the same fp32 inputs made from a seed with numpy,
within 3e-4 (ddt and dA with ``chip_smoke.ssd_bwd_tol``'s atol), and, at B
2, L 512, N 128, chunk 256 and H 48, 12 and 20 (the last head group cut
short), against ``ssd_bwd_ref`` under ``chip_smoke.py``'s own check, which
one TF32 pass a product fails.

The layouts the kernel reads are simulated element by element: the
pre-pass's direct pairs and transposes (each 8 rows 0,2,4,6,1,3,5,7) as
the TMA boxes bring them, and the blocks' own splits of the raw x and dy
tiles (xᵀ in the pre-pass's transposed layout, x_s and dy_t in place), as
the k8 steps of a K-major descriptor read them; the state kernel's
S_prevᵀ, dSᵀ and dS items as its threads write them; the A fragments
(from a raw tile, from an accumulator, and the state products' transposed
A) lane by lane; and each block's ring of loads against the order in
which its loops use them.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro.models.mamba2 import ssd_sequential as jax_ssd_sequential
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ops import BWD_HEAD_GROUP, _pad_rows
from torch_tf32 import (fragment_order, k_major_read, permuted_row, split,
                        swizzled, tf32)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

NAMES = ("dx", "ddt", "dA", "dBm", "dCm")


def _x3(eq, a, b, passes=3):
    """einsum ``eq`` of a and b as split TF32: both operands split, three
    products hi·lo + lo·hi + hi·hi (``passes`` 1: one TF32 product)."""
    if passes == 1:
        return torch.einsum(eq, tf32(a.contiguous()), tf32(b.contiguous()))
    ah, al = split(a.contiguous())
    bh, bl = split(b.contiguous())
    return (torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)
            + torch.einsum(eq, ah, bh))


def tf32x3_backward(x, dt, A, Bm, Cm, dy, d_final_state=None, chunk=256,
                    initial_state=None, passes=3):
    """The arithmetic of ``ssd_scan_bwd_tf32.cu`` on fp32 inputs: returns
    (dx, ddt, dA, dBm, dCm) as ``ssd_bwd_ref``."""
    def mm(eq, a, b):
        return _x3(eq, a, b, passes)

    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    # the kernel's chunks, a short sequence padded to whole 16-row blocks
    # (the warps' decay blocks) with rows of dt = 0
    Q = chunk if L >= chunk else -(-L // 16) * 16
    nc = -(-L // Q)
    pad = nc * Q - L
    xc = _pad_rows(x, pad).view(Bsz, nc, Q, H, P)
    dyc = _pad_rows(dy, pad).view(Bsz, nc, Q, H, P)
    dtc = _pad_rows(dt, pad).view(Bsz, nc, Q, H)
    Bc = _pad_rows(Bm, pad).view(Bsz, nc, Q, N)
    Cc = _pad_rows(Cm, pad).view(Bsz, nc, Q, N)
    Af = A.float()
    cum = torch.cumsum((dtc * Af).double(), dim=2)        # [B,nc,Q,H]
    last = cum[:, :, -1:, :]
    e = torch.exp((last - cum).float())
    w = e * dtc
    ecum = torch.exp(cum.float())
    decay = torch.exp(last[:, :, 0, :].float())

    # the state kernel: S^T += (w o B)^T x in order, dS^T += (e o C)^T dy in
    # reverse, the scaled rows split again
    S_c = mm("bcshn,bcshp->bchpn", Bc[:, :, :, None, :] * w[..., None], xc)
    S = (x.new_zeros((Bsz, H, P, N)) if initial_state is None
         else initial_state.float())
    starts = []
    for c in range(nc):
        starts.append(S)
        S = S * decay[:, c, :, None, None] + S_c[:, c]
    S_prev = torch.stack(starts, dim=1)                   # [B,nc,H,P,N]
    U = mm("bcthn,bcthp->bchpn", Cc[:, :, :, None, :] * ecum[..., None], dyc)
    dS = (x.new_zeros((Bsz, H, P, N)) if d_final_state is None
          else d_final_state.float())
    ends = [None] * nc
    for c in reversed(range(nc)):
        ends[c] = dS
        dS = dS * decay[:, c, :, None, None] + U[:, c]
    dS_end = torch.stack(ends, dim=1)
    sp_hi, sp_lo = split(S_prev)
    dss = (dS_end * (sp_hi + sp_lo)).sum(dim=(-2, -1))    # [B,nc,H]

    # the dx/dB and dC kernels: G once for every head, the scores split.
    # The decay of a pair s <= t [t, s]: on a warp's own 16 x 16 diagonal
    # block exp(cum_t - cum_s); off it the product of two exps at the
    # warp's reference row, the dx/dB kernel's (rows s) its last row, the
    # dC kernel's (rows t) its first, dt_s folded into the dC kernel's
    # column factor
    G = mm("bctn,bcsn->bcts", Cc, Bc)[..., None]
    M = mm("bcthp,bcshp->bctsh", dyc, xc)
    blk = torch.arange(Q) // 16
    tri = torch.ones(Q, Q, dtype=torch.bool).tril()[None, None, :, :, None]
    same = (blk[:, None] == blk[None, :])[None, None, :, :, None]
    below = (blk[:, None] > blk[None, :])[None, None, :, :, None]
    direct = torch.exp((cum[:, :, :, None, :] - cum[:, :, None, :, :])
                       .float())
    cref = cum[:, :, blk * 16 + 15]                       # per s row
    LX = torch.where(same & tri, direct, torch.where(
        below, torch.exp((cum[:, :, :, None, :] - cref[:, :, None, :, :])
                         .float()) * torch.exp((cref - cum).float())[
                             :, :, None], torch.zeros(())))
    cref = cum[:, :, blk * 16]                            # per t row
    dts = dtc[:, :, None, :, :]
    LD = torch.where(same & tri, direct * dts, torch.where(
        below, torch.exp((cum - cref).float())[:, :, :, None]
        * (torch.exp((cref[:, :, :, None, :] - cum[:, :, None, :, :])
                     .float()) * dts), torch.zeros(())))
    GL = G * LX
    V = mm("bchpn,bcsn->bcshp", dS_end, Bc)
    dx = w[..., None] * V + mm("bctsh,bcthp->bcshp", GL * dts, dyc)
    dBh = (w[..., None] * mm("bcshp,bchpn->bcshn", xc, dS_end)
           + mm("bctsh,bctn->bcshn", M * LX * dts, Cc))
    Z = mm("bcthp,bchpn->bcthn", dyc, S_prev)
    dCh = ecum[..., None] * Z + mm("bctsh,bcsn->bcthn", M * LD, Bc)
    ng = -(-H // BWD_HEAD_GROUP)

    def by_groups(t):                                     # [B,nc,Q,H,N]
        t = torch.cat([t, t.new_zeros((*t.shape[:3], ng * BWD_HEAD_GROUP - H,
                                       N))], dim=3)
        t = t.view(*t.shape[:3], ng, BWD_HEAD_GROUP, N).sum(dim=4)
        out = t[:, :, :, 0]
        for g in range(1, ng):
            out = out + t[:, :, :, g]
        return out
    dB, dC = by_groups(dBh), by_groups(dCh)

    # the finish kernel
    ddt_intra = (GL * M).sum(dim=2)
    ddt_state = e * torch.einsum("bcshp,bcshp->bcsh", xc, V)
    row = (G * LD * M).sum(dim=3)
    E = ecum * torch.einsum("bcthn,bctn->bcth", Z, Cc)
    dcum = (row + E) - dtc * (ddt_intra + ddt_state)
    dcum[:, :, -1] += decay * dss + (dtc * ddt_state).sum(dim=2)
    da = torch.flip(torch.cumsum(torch.flip(dcum.double(), [2]), dim=2), [2])
    ddt = ddt_intra + ddt_state + (Af.double() * da).float()
    dA = (dtc.double() * da).sum(dim=(1, 2)).sum(dim=0)

    def rows(t):
        return t.reshape(Bsz, nc * Q, *t.shape[3:])[:, :L]
    return (rows(dx), rows(ddt), dA.float(), rows(dB), rows(dC))


def _inputs(rng, B, L, H, P, N):
    """float32 numpy x, dt, A, Bm, Cm and the cotangents dy, dS, dt as the
    model draws it (softplus of a normal draw plus the init's dt_bias)."""
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    bias = np.log(np.expm1(np.linspace(1e-3, 1e-1, H)))
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)) + bias)).astype(
        np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    Bm = rng.standard_normal((B, L, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, N)).astype(np.float32)
    dy = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dS = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return (x, dt, A, Bm, Cm), dy, dS


def _jax_grads(fn, args, dy, dS):
    (_, S), vjp = jax.vjp(fn, *map(jnp.asarray, args))
    g = vjp((jnp.asarray(dy),
             jnp.zeros_like(S) if dS is None else jnp.asarray(dS)))
    return [np.asarray(a, np.float32) for a in g]


def _close(got, want, B, L, chunk, err_msg=""):
    """3e-4, ddt and dA with ``chip_smoke.ssd_bwd_tol``'s atol."""
    for name, g, w in zip(NAMES, got, want):
        tol = chip_smoke.ssd_bwd_tol(name, "float32", B, L, chunk)
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"{err_msg} {name}",
                                   **tol)


def _emulated(args, dy, dS, chunk, **kw):
    t = [torch.from_numpy(a) for a in (*args, dy)]
    return tf32x3_backward(*t, None if dS is None else torch.from_numpy(dS),
                           chunk, **kw)


# (B, L, H, P, N, chunk): L a multiple of the chunk, ragged L (one chunk of
# length L in ssd_chunked), N 16 and 128, H 12 (a head group of 8 and one
# of 4)
CHUNKED = [(2, 64, 3, 16, 16, 16), (2, 20, 3, 16, 16, 16),
           (2, 48, 2, 16, 128, 16), (1, 32, 12, 8, 16, 16)]
SEQUENTIAL = CHUNKED + [(2, 96, 2, 16, 128, 32), (2, 37, 3, 16, 16, 32),
                        (1, 100, 2, 16, 16, 64), (1, 70, 20, 8, 16, 64)]


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("shape", CHUNKED)
def test_emulation_matches_jax_grad_of_ssd_chunked(rng, shape, final):
    B, L, H, P, N, chunk = shape
    args, dy, dS = _inputs(rng, B, L, H, P, N)
    dS = dS if final else None
    want = _jax_grads(lambda *a: jax_ssd_chunked(*a, chunk), args, dy, dS)
    _close(_emulated(args, dy, dS, chunk), want, B, L, chunk, "tf32x3")


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("shape", SEQUENTIAL)
def test_emulation_matches_jax_grad_of_ssd_sequential(rng, shape, final):
    B, L, H, P, N, chunk = shape
    args, dy, dS = _inputs(rng, B, L, H, P, N)
    dS = dS if final else None
    want = _jax_grads(jax_ssd_sequential, args, dy, dS)
    _close(_emulated(args, dy, dS, chunk), want, B, L, chunk, "tf32x3")


@pytest.mark.parametrize("init", [False, True])
def test_emulation_is_not_the_plain_version(rng, init):
    """The split products move every output off ``ssd_bwd_ref``'s fp32
    products, inside the tolerance, with a final-state cotangent and an
    initial state."""
    B, L, H, P, N, chunk = 2, 100, 3, 16, 32, 64
    args, dy, dS = _inputs(rng, B, L, H, P, N)
    t = [torch.from_numpy(a) for a in (*args, dy)]
    s0 = (torch.from_numpy(rng.standard_normal((B, H, P, N)).astype(
        np.float32)) if init else None)
    got = tf32x3_backward(*t, torch.from_numpy(dS), chunk, s0)
    want = ops.ssd_bwd_ref(*t, torch.from_numpy(dS), chunk, s0)
    for name, g, w in zip(NAMES, got, want):
        assert not torch.equal(g, w), name
    _close(got, [w.numpy() for w in want], B, L, chunk, "against ssd_bwd_ref")


def _card_inputs(seed, B, L, H, N):
    """``chip_smoke.ssd_inputs`` in fp32 and its cotangent dy, drawn with
    numpy."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x = normal(B, L, H, 64)
    dt_bias = torch.log(torch.expm1(torch.linspace(1e-3, 1e-1, H)))
    dt = torch.nn.functional.softplus(normal(B, L, H) + dt_bias)
    A = -torch.exp(torch.log(torch.linspace(1.0, 16.0, H)))
    return x, dt, A, normal(B, L, N), normal(B, L, N), normal(B, L, H, 64)


def _card_check(got, want, B, L, chunk):
    """``chip_smoke.ssd_bwd_case``'s fp32 check: each output within
    ``ssd_bwd_tol``.  Raises AssertionError on a failure."""
    for name, g, w in zip(chip_smoke.SSD_BWD_NAMES, got, want):
        try:
            chip_smoke.max_err(g, w, "float32",
                               chip_smoke.ssd_bwd_tol(name, "float32", B, L,
                                                      chunk))
        except AssertionError as e:
            raise AssertionError(f"{name}: {e}") from None


@pytest.mark.parametrize("H", [48, 12, 20])
def test_emulation_passes_the_card_check(H):
    """At B 2, L 512, N 128, chunk 256 (two chunks at the model's widths;
    H 48, and H 12 and 20, whose last head group is cut short): the
    emulation against ``ssd_bwd_ref`` passes the card's fp32 check."""
    B, L, N, chunk = 2, 512, 128, 256
    args = _card_inputs(H, B, L, H, N)
    _card_check(tf32x3_backward(*args, None, chunk),
                ops.ssd_bwd_ref(*args, None, chunk), B, L, chunk)


def test_one_tf32_pass_fails_the_card_check():
    """The same products with one TF32 pass each (no lo terms) fail the
    card's check at the training widths: the check sees a kernel that
    drops them."""
    B, L, H, N, chunk = 2, 512, 48, 128, 256
    args = _card_inputs(0, B, L, H, N)
    with pytest.raises(AssertionError, match="outside tolerance"):
        _card_check(tf32x3_backward(*args, None, chunk, passes=1),
                    ops.ssd_bwd_ref(*args, None, chunk), B, L, chunk)


# ------------------------------------------------------------- layouts --
def swz(r: int, c: int) -> int:
    """The kernel's ``swz``: (r, c) of a 64-row fp32 tile of column blocks
    [64][32] in the 128-byte swizzle."""
    return ((c // 32) * 64 * 32 + r * 32 + ((((c % 32) // 4) ^ (r % 8)) * 4)
            + c % 4)


def item_read(kk: int, row: int, j: int, transposed: bool, lo: bool) -> int:
    """The float offset of an item (hi then lo, or the pre-pass's 16-row
    blocks) that the kernel's ``rs4`` descriptor of k8 step kk reads for
    B's row ``row`` and K index j: direct, hi at column block kk / 4 step
    kk % 4, lo 4096 floats on; transposed, block kk / 2, hi at byte 32 (kk
    % 2) of its row, lo 64 bytes on."""
    if transposed:
        return k_major_read(64, row, 4 * (kk // 2) + kk % 2 + 2 * lo, j)
    return k_major_read(64, row, kk, j) + 64 * 64 * lo


def test_kernel_swizzle_is_tmas():
    assert all(swz(r, c) == swizzled(64, r, c)
               for r in range(64) for c in range(128))


def test_accumulator_fragment_meets_the_pre_pass_row_order():
    """The accumulator as A (``acc_a``): A column j holds accumulator
    column order[j], which is the pre-pass's row of K position j."""
    assert fragment_order() == [permuted_row(j) for j in range(8)]


def _transposed_split(x: torch.Tensor) -> torch.Tensor:
    """``flash_tf32_split.cuh``'s transposed split of x [B,S,heads,hd]:
    [B,heads,hd,2*S16], each 16-row block as 16 hi then 16 lo in the
    order ``permuted_row``, zeros past S."""
    B, S, heads, hd = x.shape
    S16 = -(-S // 16) * 16
    hi, lo = split(x)
    out = torch.zeros(B, heads, hd, 2 * S16)
    for blk in range(S16 // 16):
        for p in range(16):
            s = blk * 16 + permuted_row(p)
            if s < S:
                out[:, :, :, blk * 32 + p] = hi[:, s]
                out[:, :, :, blk * 32 + 16 + p] = lo[:, s]
    return out


@pytest.mark.parametrize("hd, heads, d0", [(64, 3, 0), (128, 1, 0),
                                           (128, 1, 64)])
def test_transposed_items_are_what_each_k8_step_reads(hd, heads, d0):
    """dy_tᵀ (hd 64, every head; x_sᵀ, which the state kernel writes in
    the same layout, ``test_block_split_xt_is_the_pre_pass_layout``) and
    the halves of B_sᵀ / C_tᵀ (hd 128, one head): the pre-pass's
    transposed split as the kernel's TMA boxes
    (32, 64, 1, 1) at (2·row + 32q, d0, h, b) bring it, column block q of
    the item, swizzled; the descriptor of k8 step kk reads for B's row d
    and K index j the hi (lo) of sequence row row + 8kk + order[j] — the
    row whose score the accumulator's A column j holds."""
    g = torch.Generator().manual_seed(0)
    B, S = 2, 100
    x = torch.randn(B, S, heads, hd, generator=g)
    hi, lo = split(x)
    t = _transposed_split(x)
    order = fragment_order()
    for b in range(B):
        for h in range(heads):
            for row in range(0, S, 64):
                item = torch.zeros(4 * 64 * 32)
                for q in range(4):
                    c0 = 2 * row + 32 * q
                    for d in range(64):
                        for c in range(32):
                            v = (float(t[b, h, d0 + d, c0 + c])
                                 if c0 + c < t.shape[-1] else 0.0)
                            item[q * 64 * 32 + swizzled(64, d, c)] = v
                for kk in range(8):
                    for d in range(0, 64, 7):
                        for j in range(8):
                            s = row + 8 * kk + order[j]
                            for is_lo, want in ((False, hi), (True, lo)):
                                got = float(item[item_read(kk, d, j, True,
                                                           is_lo)])
                                assert got == (float(want[b, s, h, d0 + d])
                                               if s < S else 0.0)


def test_block_split_xt_is_the_pre_pass_layout():
    """The state kernel's ``split_transposed``, simulated thread by
    thread: element idx = tid + 128 j (j < 8) takes p = idx % 64, column
    block q = idx / 256 and positions pos0 = (idx / 64) % 4 · 4 + e, reads
    the raw x tile at s = 16q + permuted_row(pos0 + e) and writes its hi
    at (p, pos0 + e) and its lo at (p, 16 + pos0 + e) of block q: the
    pre-pass's transposed split of the same 64 rows, every element once."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(1, 64, 1, 64, generator=g)
    want = _transposed_split(x)[0, 0]                  # [64 p][128]
    hi, lo = split(x[0, :, 0])                         # [64 s][64 p]
    item = {}
    for tid in range(128):
        for j in range(8):
            idx = tid + 128 * j
            p, q, pos0 = idx % 64, idx // 64 // 4, (idx // 64) % 4 * 4
            for e in range(4):
                s = 16 * q + permuted_row(pos0 + e)
                for off, src in ((0, hi), (16, lo)):
                    key = q * 64 * 32 + swz(p, off + pos0 + e)
                    assert key not in item
                    item[key] = float(src[s, p])
    assert len(item) == 64 * 64 * 2
    for q in range(4):
        for p in range(64):
            for c in range(32):
                assert item[q * 64 * 32 + swz(p, c)] == float(
                    want[p, 32 * q + c])


@pytest.mark.parametrize("cols, c0, heads", [(64, 0, 2), (128, 64, 1),
                                             (128, 0, 1)])
def test_direct_items_are_what_each_k8_step_reads(cols, c0, heads):
    """The halves of C_t / B_s (128 columns, one head): the pre-pass's
    direct pair [2,B,L,1,N] as ``load_pair`` brings it (boxes of 32
    columns x 64 rows, hi then lo); dy_t / x_s (64 columns, a head): the
    raw tile as ``load_raw`` brings it, split in place by
    ``split_in_place`` (each thread's float4 at 4 (tid + 128 j): its hi
    where it lies, its lo 4096 floats on).  Either is read by the
    descriptor of each k8 step over the item's K = c0 + 8kk + j for B's
    row r."""
    g = torch.Generator().manual_seed(1)
    B, L = 1, 70
    x = torch.randn(B, L, heads, cols, generator=g)
    hi, lo = split(x)
    for h in range(heads):
        for row in range(0, L, 64):
            item = torch.zeros(2 * 64 * 64)
            if cols == 128:
                for half, src in ((0, hi), (1, lo)):
                    for cb in range(2):
                        for r in range(64):
                            for c in range(32):
                                v = (float(src[0, row + r, h,
                                               c0 + 32 * cb + c])
                                     if row + r < L else 0.0)
                                item[half * 4096 + cb * 2048
                                     + swizzled(64, r, c)] = v
            else:
                for cb in range(2):                    # load_raw
                    for r in range(64):
                        for c in range(32):
                            item[cb * 2048 + swizzled(64, r, c)] = (
                                float(x[0, row + r, h, 32 * cb + c])
                                if row + r < L else 0.0)
                for tid in range(128):                 # split_in_place
                    for j in range(8):
                        at = 4 * (tid + 128 * j)
                        v = item[at:at + 4].clone()
                        vh, vl = split(v)
                        item[at:at + 4] = vh
                        item[4096 + at:4096 + at + 4] = vl
            for kk in range(8):
                for r in range(64):
                    for j in range(8):
                        k = c0 + 8 * kk + j
                        for is_lo, want in ((False, hi), (True, lo)):
                            got = float(item[item_read(kk, r, j, False,
                                                       is_lo)])
                            assert got == (float(want[0, row + r, h, k])
                                           if row + r < L else 0.0)


def _state_fragments():
    """(warp, lane, e, i) -> the accumulator element (n, p) of S^T [n][p]
    that thread (warp, lane) holds in st[hh][4i + e], n local to the half:
    rows 16w + l/4 (+ 8), columns 8i + 2(l%4) (+ 1)."""
    for w in range(4):
        for lane in range(32):
            r0, c0 = 16 * w + lane // 4, 2 * (lane % 4)
            for i in range(8):
                for e in range(4):
                    yield (r0, c0, i, e, r0 + 8 * (e >> 1),
                           8 * i + c0 + (e & 1))


def test_state_items_are_what_the_products_read():
    """The state kernel's writes, simulated lane by lane: S_prevᵀ and dSᵀ
    items [n][p] (``store_t_items``, element (n, p) at (r0 + 8r, 8i + c0)
    and its neighbour) and dS items [p][n] (``store_items``), each hi
    then lo; the descriptor of k8 step kk reads (n, p = 8kk + j) from the
    first (K = p: dy_t·S_prev, x_s·dS) and (p, n = 8kk + j) from the
    second (K = n: B_s·dSᵀ)."""
    st_t, st = {}, {}
    for r0, c0, i, e, n, p in _state_fragments():
        r = e >> 1
        off = swz(r0 + 8 * r, 8 * i + c0) + (e & 1)   # float2 of a row
        st_t[off] = (n, p)
        st[swz(8 * i + c0 + (e & 1), r0 + 8 * (e >> 1))] = (p, n)
    assert len(st_t) == len(st) == 64 * 64
    for kk in range(8):
        for row in range(64):
            for j in range(8):
                assert st_t[item_read(kk, row, j, False, False)] == (
                    row, 8 * kk + j)
                assert st[item_read(kk, row, j, False, False)] == (
                    row, 8 * kk + j)


def test_raw_a_fragment_meets_the_direct_item():
    """``raw_a``: lane l of warp w reads the raw tile at rows 16w + l/4
    (+ 8) and columns col0 + 8kk + l%4 (+ 4), which the tf32 A fragment
    holds as columns l%4 and l%4 + 4; a direct item's K index j is column
    col0 + 8kk + j: each A column meets B's K of the same column."""
    for kk in range(8):
        for w in range(4):
            for lane in range(32):
                r0, c = 16 * w + lane // 4, 8 * kk + lane % 4
                built = [(r0, c), (r0 + 8, c), (r0, c + 4), (r0 + 8, c + 4)]
                frag = [(r0, lane % 4), (r0 + 8, lane % 4),
                        (r0, lane % 4 + 4), (r0 + 8, lane % 4 + 4)]
                for (row, col), (arow, acol) in zip(built, frag):
                    assert row == arow and col == 8 * kk + acol


def test_state_a_fragment_meets_the_transposed_row():
    """``state_a``: lane l of warp w builds (f∘rows)ᵀ at n = n0 + 16w + l/4
    (+ 8) and s = 8kk + 2(l%4) (+ 1), A columns l%4 and l%4 + 4; the
    transposed B (x_sᵀ, dy_tᵀ) holds at K index j the row 8kk + order[j]:
    every A column meets the B row of its own s."""
    order = fragment_order()
    for kk in range(8):
        for lane in range(32):
            s0 = 8 * kk + 2 * (lane % 4)
            assert s0 == 8 * kk + order[lane % 4]
            assert s0 + 1 == 8 * kk + order[lane % 4 + 4]


def _walk(kind: str, nt: int, j: int, H: int, kH: int) -> list:
    """The items a dx/dB (``kind`` "dxdb", s tile j) or dC ("dc", t tile
    j) block uses, in the order its loops use them."""
    used = []
    tiles = range(j, nt) if kind == "dxdb" else range(j + 1)
    first = ("C", "pair") if kind == "dxdb" else ("B", "pair")
    for t in tiles:
        for hf in range(kH):
            used.append((first, None, t, hf))
    for h in range(H):
        if kind == "dxdb":
            used += [(("dS", "item"), h, None, hf) for hf in range(kH)]
            used += [(("dS^T", "item"), h, None, hf) for hf in range(kH)]
            for t in tiles:
                used += [(("dy", "pair"), h, t, 0), (("dy", "T"), h, t, 0)]
                used += [(("C", "T"), None, t, hf) for hf in range(kH)]
        else:
            used += [(("S_prev^T", "item"), h, None, hf) for hf in range(kH)]
            for t in tiles:
                used.append((("x", "pair"), h, t, 0))
                used += [(("B", "T"), None, t, hf) for hf in range(kH)]
    return used


def _issued(kind: str, nt: int, j: int, H: int, kH: int) -> list:
    """The kernels' ``issue(n)``, item by item: what load n brings."""
    ntj = nt - j if kind == "dxdb" else j + 1
    pre = ntj * kH
    per_head = (2 * kH + ntj * (2 + kH) if kind == "dxdb"
                else kH + ntj * (1 + kH))
    out = []
    for n in range(pre + H * per_head):
        if n < pre:
            t = (j + n // kH) if kind == "dxdb" else n // kH
            out.append(((("C" if kind == "dxdb" else "B"), "pair"), None, t,
                        n % kH))
            continue
        m = n - pre
        h, r = m // per_head, m % per_head
        if kind == "dxdb":
            if r < 2 * kH:
                out.append((("dS" if r < kH else "dS^T", "item"), h, None,
                            r % kH))
                continue
            r -= 2 * kH
            t, r = j + r // (2 + kH), r % (2 + kH)
            out.append([(("dy", "pair"), h, t, 0), (("dy", "T"), h, t, 0)][r]
                       if r < 2 else (("C", "T"), None, t, r - 2))
        else:
            if r < kH:
                out.append((("S_prev^T", "item"), h, None, r))
                continue
            r -= kH
            t, r = r // (1 + kH), r % (1 + kH)
            out.append((("x", "pair"), h, t, 0) if r == 0
                       else (("B", "T"), None, t, r - 1))
    return out


@pytest.mark.parametrize("kind", ["dxdb", "dc"])
@pytest.mark.parametrize("kH", [1, 2])
def test_the_rings_bring_each_item_where_it_is_used(kind, kH):
    """Each block's 3-stage ring: load n (``issue``) is the n-th item its
    loops wait for, for every tile of a 4-tile chunk and a short group."""
    for nt in range(1, 5):
        for j in range(nt):
            for H in (1, 3, 8):
                assert _issued(kind, nt, j, H, kH) == _walk(kind, nt, j, H,
                                                            kH)


def test_scratch_is_what_the_launch_function_takes():
    """The scratch, by name in the C function's order, at the training
    shape (B 8, L 512, H 48, N 128, chunk 256)."""
    k = ops.BWD_KERNELS["tf32x3"]
    assert (k.source, k.symbol) == ("ssd_scan_bwd_tf32.cu",
                                    "ssd_scan_bwd_tf32_launch")
    names = list(ops.tf32_bwd_scratch(8, 512, 48, 128, 256))
    assert names == ["dyt", "bm_pair", "cm_pair", "bmt", "cmt", "cum", "spt",
                     "ds", "dst", "dss", "rowe", "ddi", "dds", "db_part",
                     "dc_part", "da_part"]
    # x, dt, A, Bm, Cm, init, dy, dfinal, dx, ddt, dA, dBm, dCm, the
    # scratch; B, L, H, P, N, chunk, group; stream
    assert len(k.argtypes) == 13 + len(names) + 7 + 1
    s = ops.tf32_bwd_scratch(8, 512, 48, 128, 256)
    assert s["dyt"] == (8, 48, 64, 1024) and s["bmt"] == (8, 128, 1024)
    assert s["spt"] == (8, 48, 2, 2, 2, 64, 64)
    assert s["db_part"] == (8, 6, 512, 128)
    pairs = 2 * 2 * 8 * 512 * 128
    transposed = 8 * 48 * 64 * 1024 + 2 * 8 * 128 * 1024
    items = 3 * 8 * 48 * 2 * 2 * 2 * 64 * 64
    rows = 4 * 8 * 48 * 512 + 8 * 48 * 2 + 8 * 48
    assert ops.tf32_bwd_scratch_bytes(8, 512, 48, 128, 256) == (
        4 * (pairs + transposed + items + rows + 2 * 8 * 6 * 512 * 128)
        + 8 * 8 * 48 * 512 - 4 * 8 * 48 * 512)


def test_fp32_cuda_call_refuses_cpu_tensors_before_a_launch():
    x = torch.zeros(1, 8, 2, 64)
    bm = torch.zeros(1, 8, 128)
    before = {r: k.launches for r, k in ops.BWD_KERNELS.items()}
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd_bwd_cuda(x, torch.zeros(1, 8, 2), torch.zeros(2), bm, bm,
                         torch.zeros_like(x), chunk=64)
    assert before == {r: k.launches for r, k in ops.BWD_KERNELS.items()}
