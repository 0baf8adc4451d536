"""The split-TF32 fp32 SSD-scan kernel's arithmetic, on the CPU.

``csrc/ssd_scan_tf32.cu`` (the fp32 route of the SSD scan, ``"tf32x3"``)
runs only on the card, where ``chip_smoke.py`` holds it to ``ssd_ref``.
Its arithmetic is pinned here first, in plain PyTorch (``tf32x3_ssd``):

* the pre-pass: Bm and Cm split once into hi and lo [2, B, L, N];
* per (b, h), chunk and 64-row t tile: the inter-chunk term C_t·Sᵀ from
  the chunk-start state split by n halves of 64, scaled by exp(cum_t);
  then over the s tiles 0..t (the one the previous t tile left resident
  first, ``s_tile_of``): G = C_t·B_sᵀ by n halves, the scores G ∘
  decay ∘ dt_s (the decay factorised at each 16-row band's first row, as
  the bf16 kernel does), split, times x_s split; on the chunk's last t
  tile the state decays and adds (w ∘ B_s)ᵀ·x_s, its A operand rebuilt
  from B_s's pair (hi + lo), scaled by w_s and split again;
* each product X·Y as X_hi·Y_lo + X_lo·Y_hi + X_hi·Y_hi per k8 step, in
  the kernel's order, into fp32 sums;
* the layouts: x_sᵀ written by the block with each 8 s in the order
  0,2,4,6,1,3,5,7 in the 128-byte swizzle, read by the k8 steps of its
  K-major descriptor; the A fragments of the scores (the accumulator as
  it lies) and of the state update (built from the B_s tile) simulated
  lane by lane: every A column meets the B row of the same s.

The emulation is held against the JAX package on the same fp32 inputs,
made from a seed with numpy, with and without an initial state, at ragged
L and N 64 and 128: the Pallas ``ssd_scan_fwd`` (interpret mode, L a
multiple of the chunk and no state, which it asserts) and the model's
``ssd_chunked`` at 4e-4 (``tests/test_kernels.py``' SSD tolerance: the
JAX scan sums the decay in fp32), and the port's ``ssd_ref`` (the card
check's oracle, decay in fp64) at the card's 3e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_scan_fwd as jax_ssd_scan_fwd
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd_scan import ops
from torch_tf32 import (fragment_order, k_major_read, permuted_row, split,
                        swizzled)

TILE = 64          # rows of a t or s tile
HALF = 64          # n columns of a B_s item and an S half
JAX_TOL = dict(rtol=4e-4, atol=4e-4)
CARD_TOL = dict(rtol=3e-4, atol=3e-4)


def s_tile_of(ti: int, k: int) -> int:
    """The kernel's walk over the s tiles of t tile ti: the one left
    resident by the previous t tile first, then 0 .. ti - 2, then the
    diagonal."""
    if ti == 0:
        return 0
    if k == 0:
        return ti - 1
    return k - 1 if k < ti else ti


def _x3(ah, al, bh, bl, eq):
    """One k8 step of a split product, in the kernel's order."""
    return (torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)
            + torch.einsum(eq, ah, bh))


def tf32x3_ssd(x, dt, A, Bm, Cm, chunk, initial_state=None):
    """The arithmetic of ``ssd_scan_tf32.cu`` on fp32 x [B,L,H,P], dt
    [B,L,H], A [H], Bm/Cm [B,L,N]: (y [B,L,H,P], final state [B,H,P,N])."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    halves = [slice(h, h + HALF) for h in range(0, N, HALF)]
    Bh, Bl = split(Bm)                                  # the pre-pass
    Ch, Cl = split(Cm)
    S = (torch.zeros(Bsz, H, P, N) if initial_state is None
         else initial_state.clone())                    # [B,H,P,N]
    y = torch.zeros(Bsz, L, H, P)
    for t0 in range(0, L, chunk):
        lc = min(chunk, L - t0)
        nt = -(-lc // TILE)
        Q = nt * TILE

        def rows(t):
            t = t[:, t0:t0 + lc]
            return torch.cat([t, t.new_zeros((Bsz, Q - lc, *t.shape[2:]))], 1)
        xc, dtc = rows(x), rows(dt)
        bh, bl, ch, cl = rows(Bh), rows(Bl), rows(Ch), rows(Cl)
        cum = torch.cumsum((dtc * A).double(), dim=1)            # [B,Q,H]
        clast = cum[:, -1]                                       # [B,H]
        ecum = torch.exp(cum.float())
        w = torch.exp((clast[:, None] - cum).float()) * dtc     # [B,Q,H]
        dl = torch.exp(clast.float())
        pos = torch.arange(Q)
        ref = pos // 16 * 16                                     # per t
        for ti in range(nt):
            T = slice(ti * TILE, ti * TILE + TILE)
            yt = torch.zeros(Bsz, H, TILE, P)
            for hs in halves:                                   # C_t . S^T
                sh, sl = split(S[..., hs])
                for k in range(0, HALF, 8):
                    n = slice(hs.start + k, hs.start + k + 8)
                    yt += _x3(ch[:, T, n], cl[:, T, n], sh[..., k:k + 8],
                              sl[..., k:k + 8], "btn,bhpn->bhtp")
            yt *= ecum[:, T].permute(0, 2, 1)[..., None]
            if ti == nt - 1:
                S = S * dl[..., None, None]
            for k in range(ti + 1):
                sj = s_tile_of(ti, k)
                Sr = slice(sj * TILE, sj * TILE + TILE)
                g = torch.zeros(Bsz, TILE, TILE)
                for hs in halves:                               # C_t . B_s^T
                    for k in range(0, HALF, 8):
                        n = slice(hs.start + k, hs.start + k + 8)
                        g += _x3(ch[:, T, n], cl[:, T, n], bh[:, Sr, n],
                                 bl[:, Sr, n], "btn,bsn->bts")
                tp, sp = pos[T], pos[Sr]
                cref = cum[:, ref[T]]                            # [B,t,H]
                et = torch.exp((cum[:, T] - cref).float())[:, :, None]
                es = (torch.exp((cref[:, :, None] - cum[:, None, Sr]).float())
                      * dtc[:, None, Sr])                        # [B,t,s,H]
                exact = (torch.exp((cum[:, T, None] - cum[:, None, Sr])
                                   .float()) * dtc[:, None, Sr])
                factor = (sp[None, :] < ref[T][:, None])[None, :, :, None]
                tri = (sp[None, :] <= tp[:, None])[None, :, :, None]
                scores = torch.where(factor, g[..., None] * et * es,
                                     torch.where(tri, g[..., None] * exact,
                                                 torch.zeros(())))
                sch, scl = split(scores.permute(0, 3, 1, 2))    # [B,H,t,s]
                xh, xl = split(xc[:, Sr])                        # [B,s,H,P]
                for k in range(0, TILE, 8):                      # scores . x
                    yt += _x3(sch[..., k:k + 8], scl[..., k:k + 8],
                              xh[:, k:k + 8], xl[:, k:k + 8],
                              "bhts,bshp->bhtp")
                if ti == nt - 1:                                 # the state
                    a = ((bh[:, Sr] + bl[:, Sr])[:, :, None, :]
                         * w[:, Sr, :, None])                    # [B,s,H,N]
                    ah, al = split(a)
                    for k in range(0, TILE, 8):
                        S += _x3(ah[:, k:k + 8], al[:, k:k + 8],
                                 xh[:, k:k + 8], xl[:, k:k + 8],
                                 "bshn,bshp->bhpn")
            m = min(TILE, lc - ti * TILE)                        # rows < L
            y[:, t0 + ti * TILE:t0 + ti * TILE + m] = \
                yt.permute(0, 2, 1, 3)[:, :m]
    return y, S


def _inputs(rng, B, L, H, P, N, init):
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


def _torch(*a):
    return [None if t is None else torch.from_numpy(t) for t in a]


def _jax(*a):
    return [None if t is None else jnp.asarray(t) for t in a]


# (B, L, H, P, N, chunk): ragged L at both state sizes, several chunks, a
# short L
SHAPES = [(2, 100, 2, 16, 64, 64), (1, 200, 2, 16, 128, 128),
          (1, 130, 3, 16, 128, 64), (2, 1, 2, 16, 64, 64)]


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_arithmetic_matches_ssd_chunked_and_ssd_ref(rng, shape, init):
    B, L, H, P, N, chunk = shape
    a = _inputs(rng, B, L, H, P, N, init)
    y, state = tf32x3_ssd(*_torch(*a)[:5], chunk, _torch(*a)[5])
    yj, sj = jax_ssd_chunked(*_jax(*a)[:5], chunk, _jax(*a)[5])
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **JAX_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(sj), **JAX_TOL)
    yr, sr = ops.ssd_ref(*_torch(*a)[:5], chunk, _torch(*a)[5])
    np.testing.assert_allclose(y.numpy(), yr.numpy(), **CARD_TOL)
    np.testing.assert_allclose(state.numpy(), sr.numpy(), **CARD_TOL)


@pytest.mark.parametrize("N", [64, 128])
def test_arithmetic_matches_pallas_ssd_scan(rng, N):
    """L a multiple of the chunk, no state: the Pallas kernel's case."""
    a = _inputs(rng, 1, 128, 2, 16, N, False)
    y, _ = tf32x3_ssd(*_torch(*a)[:5], 64)
    want = jax_ssd_scan_fwd(*_jax(*a)[:5], chunk=64, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **JAX_TOL)


def test_emulation_is_not_the_plain_version(rng):
    """The split products move y off ``ssd_ref``'s fp32 products, inside
    the tolerance."""
    a = _torch(*_inputs(rng, 1, 130, 2, 16, 128, True))
    y, state = tf32x3_ssd(*a[:5], 64, a[5])
    yr, sr = ops.ssd_ref(*a[:5], 64, a[5])
    assert not torch.equal(y, yr)
    np.testing.assert_allclose(y.numpy(), yr.numpy(), **CARD_TOL)
    np.testing.assert_allclose(state.numpy(), sr.numpy(), **CARD_TOL)


# ------------------------------------------------------------- layouts --
def xt_position(s: int) -> int:
    """The K position of x_sᵀ that holds s (0..63): each 8 in the order
    0,2,4,6,1,3,5,7 (``permuted_row``)."""
    for pos in range(64):
        if (pos & ~15) | permuted_row(pos & 15) == s:
            return pos
    raise ValueError(s)


def test_xt_layout_is_what_each_k8_step_reads():
    """The block writes x_s[s, p] split at row p, position
    ``xt_position(s)`` of the swizzled [64 p][64] tile (the kernel's
    ``swz<kP>``); the K-major descriptor of k8 step kk reads, for row p
    and K index j, the element of s = 8kk + order[j], where ``order`` is
    the A fragment's column order: so the scores' A column j (the
    accumulator's column order[j]) meets x of the same s."""
    order = fragment_order()
    tile = {}
    for s in range(64):
        for p in range(64):
            tile[swizzled(64, p, xt_position(s))] = (s, p)
    assert len(tile) == 64 * 64
    for kk in range(8):
        for p in range(64):
            for j in range(8):
                assert tile[k_major_read(64, p, kk, j)] == (8 * kk + order[j],
                                                            p)


def test_state_a_fragment_meets_the_same_s():
    """The state update's A operand [n][s], built per k8 step kk by lane l
    of warp w from the B_s tile: a[0] at (s = 8kk + 2(l%4), n = 16w + l/4),
    a[1] at n + 8, a[2] and a[3] at s + 1.  The tf32 A fragment reads them
    as columns l%4 and l%4 + 4, which x_sᵀ's K positions fill with s =
    8kk + order[column]: every lane's column meets its own s."""
    order = fragment_order()
    for kk in range(8):
        for w in range(4):
            for lane in range(32):
                s0 = 8 * kk + 2 * (lane % 4)
                n0 = 16 * w + lane // 4
                built = [(s0, n0), (s0, n0 + 8), (s0 + 1, n0),
                         (s0 + 1, n0 + 8)]
                frag = [(n0, lane % 4), (n0 + 8, lane % 4),
                        (n0, lane % 4 + 4), (n0 + 8, lane % 4 + 4)]
                for (s, n), (row, col) in zip(built, frag):
                    assert n == row and s == 8 * kk + order[col]


def test_the_walk_visits_each_pair_once_and_loads_each_tile_once():
    """Each t tile's walk (``s_tile_of``) visits s tiles 0..t once each; the
    tile it starts with is the previous t tile's last, so a chunk of nt
    tiles loads 1 + nt (nt - 1) / 2 of them (7 for its 10 pairs at nt 4)."""
    for nt in range(1, 5):
        walk = [(ti, s_tile_of(ti, k)) for ti in range(nt)
                for k in range(ti + 1)]
        assert sorted(walk) == [(t, s) for t in range(nt)
                                for s in range(t + 1)]
        loads = [s for i, (t, s) in enumerate(walk)
                 if i == 0 or s != walk[i - 1][1]]
        assert len(loads) == 1 + nt * (nt - 1) // 2


def test_b_and_c_pairs_are_what_the_tiles_read():
    """Bm's pair [2, B, L, N] (the flash pre-pass's direct split, one head)
    as the kernel's 4-D TMA boxes of 32 n x 64 rows, swizzled, read by
    the K-major descriptor of each k8 step over n: G's operands."""
    g = torch.Generator().manual_seed(0)
    B, L, N = 2, 70, 128
    bm = torch.randn(B, L, N, generator=g)
    hi, lo = split(bm)
    pair = torch.stack([hi, lo])                           # [2,B,L,N]
    for half, want in ((0, hi), (1, lo)):
        for b in range(B):
            for row0 in range(0, L, 64):
                for cb in range(N // 32):
                    box = torch.zeros(64 * 32)
                    for r in range(64):
                        if row0 + r < L:
                            for c in range(32):
                                box[swizzled(64, r, c)] = pair[
                                    half, b, row0 + r, cb * 32 + c]
                    for kk in range(4):
                        for r in range(64):
                            for j in range(8):
                                got = float(box[k_major_read(64, r, kk, j)])
                                n = cb * 32 + 8 * kk + j
                                assert got == (float(want[b, row0 + r, n])
                                               if row0 + r < L else 0.0)


def test_scratch_is_what_the_launch_function_takes():
    """Bm's and Cm's pairs, by name in the C function's order, at the
    serving shape: 16,777,216 bytes."""
    k = ops.KERNELS["tf32x3"]
    assert (k.source, k.symbol) == ("ssd_scan_tf32.cu",
                                    "ssd_scan_tf32_launch")
    # x, dt, A, Bm, Cm, init, y, final_state, bm_pair, cm_pair; B, L, H,
    # P, N, chunk; stream
    assert len(k.argtypes) == 17
    assert ops.tf32_scratch(8, 1024, 128) == {"bm_pair": (2, 8, 1024, 128),
                                              "cm_pair": (2, 8, 1024, 128)}
    assert ops.tf32_scratch_bytes(8, 1024, 128) == 16_777_216


def test_fp32_cuda_call_refuses_cpu_tensors_before_a_launch():
    x = torch.zeros(1, 8, 2, 64)
    bm = torch.zeros(1, 8, 128)
    before = {r: k.launches for r, k in ops.KERNELS.items()}
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd_cuda(x, torch.zeros(1, 8, 2), torch.zeros(2), bm, bm, 64)
    assert before == {r: k.launches for r, k in ops.KERNELS.items()}
