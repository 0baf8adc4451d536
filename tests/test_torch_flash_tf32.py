"""The split-TF32 flash-attention kernels' arithmetic, on the CPU.

``csrc/flash_attention_tf32.cu`` and ``csrc/flash_attention_bwd_tf32.cu``
(the fp32 route, ``"tf32x3"``) run only on the card, where
``chip_smoke.py`` holds them to ``attention_ref`` and
``attention_bwd_ref``.  Their arithmetic is pinned here first, in plain
PyTorch:

* the split: hi = x rounded to the nearest tf32 (ties away from zero, as
  ``cvt.rna.tf32.f32``), lo = (x - hi) rounded likewise;
* each product as X_hi.Y_hi + X_hi.Y_lo + X_lo.Y_hi, summed in fp32;
* the layouts: the pre-pass's transposed split (per 16 rows their hi, then
  their lo; each 8 rows in the order 0,2,4,6,1,3,5,7), and the register
  hand-over that order serves: a lane of an fp32 accumulator holds columns
  2(l%4), 2(l%4)+1 of each 8, a lane of a tf32 A fragment l%4, l%4+4,
  simulated lane by lane;
* the tiles: the forward's key tiles (64 keys at hd 64, 32 at hd 80 and
  128) with the online softmax in exp2, the backward's dK/dV blocks of 64
  keys whose q steps (32 rows at hd 64, 16 at hd 80 and 128) two
  warpgroups take in turn and sum at the end, and its dQ items (128 rows
  at hd 64, 64 at hd 80 and 128) over key tiles (32, 16);
* hd 80, which is not a whole number of the kernels' 32-column boxes: the
  direct tiles carry zero columns 80-95 that no k8 step reads, and the
  products over the sequence run at N 80 on the transposed splits' 80
  rows.

The emulation is held against the JAX package on the same fp32 inputs,
made from a seed with numpy, at 3e-4 (the fp32 tolerance of
``chip_smoke.py`` and ``tests/test_kernels.py``): the forward and its lse
against ``repro.kernels.flash_attention.ref.attention_ref``, the backward
against ``jax.vjp`` of ``chunked_attention`` (the XLA recompute backward,
``repro/models/attention.py:164-235``).  One case shows that a single
TF32 pass misses 3e-4 at S 1024, hd 64, where the three passes meet it.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models.attention import chunked_attention as jax_chunked
from repro_torch.kernels.flash_attention import ops
from torch_tf32 import fragment_order, mm1, mm3
from torch_tf32 import permuted_row as _permuted_row
from torch_tf32 import split, tf32

LOG2E = 1.4426950408889634
NEG_INF = -1e30
TOL = dict(rtol=3e-4, atol=3e-4)


# --------------------------------------------------------------- layouts --
PERM8 = fragment_order()


def transposed_split(x: torch.Tensor, length: int) -> torch.Tensor:
    """The pre-pass's transposed split of x [B,S,heads,hd]: [B,heads,hd,
    2*S16], each 16-row block's hi then lo, rows in ``_permuted_row``
    order, zeros for rows >= S; padded with zeros (TMA's out-of-bounds
    fill) to ``length`` columns."""
    B, S, NH, hd = x.shape
    s16 = -(-S // 16) * 16
    xp = torch.zeros(B, s16, NH, hd)
    xp[:, :S] = x
    rows = torch.tensor([_permuted_row(p) for p in range(16)])
    blocks = xp.reshape(B, s16 // 16, 16, NH, hd)[:, :, rows]
    hi, lo = split(blocks)
    t = torch.cat([hi, lo], dim=2).permute(0, 3, 4, 1, 2)
    t = t.reshape(B, NH, hd, 2 * s16)
    return torch.nn.functional.pad(t, (0, max(0, length - 2 * s16)))


def rs_product(a, t, k0, K, passes=3):
    """D += A[..., K] . B[K, hd] the way the kernels issue it over keys (or
    q rows) k0..k0+K: A is the fp32 accumulator whose columns the fragment
    hands over in ``PERM8`` order, B the transposed split ``t`` read by
    k8 step kk at column 2*k0 + 32*(kk//2) + 8*(kk%2) (hi) and 16 on
    (lo)."""
    idx, cols = [], []
    for kk in range(K // 8):
        idx += [8 * kk + PERM8[c] for c in range(8)]
        cols += [2 * k0 + 32 * (kk // 2) + 8 * (kk % 2) + c for c in range(8)]
    cols = torch.tensor(cols)
    a = a[..., torch.tensor(idx)]
    bh = t[..., cols].transpose(-1, -2)
    bl = t[..., cols + 16].transpose(-1, -2)
    ah, al = split(a)
    if passes == 1:
        return ah @ bh
    return ah @ bl + al @ bh + ah @ bh


def _rows(x, r0, n):
    """Rows r0..r0+n of x [..., S, d], zeros past S (TMA's fill)."""
    out = torch.zeros(*x.shape[:-2], n, x.shape[-1])
    m = max(0, min(n, x.shape[-2] - r0))
    out[..., :m, :] = x[..., r0:r0 + m, :]
    return out


# -------------------------------------------------------------- emulation --
def tf32x3_forward(q, k, v, causal, passes=3):
    """The arithmetic of ``flash_attention_tf32.cu`` on fp32 q [B,S,H,hd],
    k/v [B,S,KV,hd]: (o [B,S,H,hd], lse [B,H,S])."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    bk = 64 if hd == 64 else 32
    scale_log2 = LOG2E / math.sqrt(hd)
    mm = mm3 if passes == 3 else mm1
    qh = q.permute(0, 2, 1, 3)
    kh = k.repeat_interleave(G, 2).permute(0, 2, 1, 3)
    n_tiles = -(-S // bk)
    vt = transposed_split(v, 2 * n_tiles * bk).repeat_interleave(G, 1)
    qpos = torch.arange(S)[:, None]
    m = torch.full((B, H, S), NEG_INF)
    l = torch.zeros(B, H, S)
    o = torch.zeros(B, H, S, hd)
    for n in range(n_tiles):
        k0 = n * bk
        s = mm(qh, _rows(kh, k0, bk).transpose(-1, -2))
        key = torch.arange(k0, k0 + bk)[None, :]
        bad = (key >= S) | ((key > qpos) if causal else False)
        s = torch.where(bad, NEG_INF, s)
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - mx) * scale_log2)
        p = torch.exp2(s * scale_log2 - (mx * scale_log2)[..., None])
        l = l * alpha + p.sum(-1)
        m = mx
        o = o * alpha[..., None] + rs_product(p, vt, k0, bk, passes)
    lse = m * (scale_log2 / LOG2E) + torch.log(l)
    return (o / l[..., None]).permute(0, 2, 1, 3), lse


def tf32x3_backward(q, k, v, o, do, lse, causal):
    """The arithmetic of ``flash_attention_bwd_tf32.cu`` on fp32 inputs:
    (dq, dk, dv)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    scale_log2 = scale * LOG2E
    nq, nk, rows = (32, 32, 128) if hd == 64 else (16, 16, 64)
    delta = (do * o).sum(-1).permute(0, 2, 1)                 # [B,H,S]
    lse2 = lse * LOG2E
    length = 2 * (-(-S // 128) * 128 + 128)
    qt, dot, kt = (transposed_split(x, length) for x in (q, do, k))
    qh, doh = q.permute(0, 2, 1, 3), do.permute(0, 2, 1, 3)    # [B,H,S,hd]
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)      # [B,KV,S,hd]

    def p_and_ds(s, dp, qrow, key, heads):
        """P and dS of scores s [.., q, key] (rows qrow, columns key)."""
        idx = qrow.clamp(max=S - 1)
        l2 = torch.where(qrow < S, lse2[:, heads][..., idx], 0.0)
        dl = torch.where(qrow < S, delta[:, heads][..., idx], 0.0)
        p = torch.exp2(s * scale_log2 - l2)
        bad = (qrow >= S) | (key >= S) | ((key > qrow) if causal else False)
        p = torch.where(bad, 0.0, p)
        return p, p * (dp - dl) * scale

    dk = torch.zeros(B, KV, S, hd)
    dv = torch.zeros(B, KV, S, hd)
    for k0 in range(0, S, 64):
        kb, vb = _rows(kh, k0, 64), _rows(vh, k0, 64)          # [B,KV,64,hd]
        q_begin = k0 if causal else 0
        q_tiles = -(-(S - q_begin) // nq)
        part = [[torch.zeros(B, KV, 64, hd) for _ in range(2)]
                for _ in range(2)]
        for n in range(G * q_tiles):
            g, q0 = n // q_tiles, q_begin + (n % q_tiles) * nq
            heads = torch.arange(KV) * G + g
            st = mm3(kb, _rows(qh[:, heads], q0, nq).transpose(-1, -2))
            dpt = mm3(vb, _rows(doh[:, heads], q0, nq).transpose(-1, -2))
            qrow = torch.arange(q0, q0 + nq)[None, :]
            key = torch.arange(k0, k0 + 64)[:, None]
            # P^T, dS^T [B,KV,keys,q]: lse and delta by column
            pt, dst = p_and_ds(st, dpt, qrow, key, heads)
            dv_w, dk_w = part[n % 2]
            dv_w += rs_product(pt, dot[:, heads], q0, nq)
            dk_w += rs_product(dst, qt[:, heads], q0, nq)
        m = max(0, min(64, S - k0))
        dk[:, :, k0:k0 + m] = (part[0][1] + part[1][1])[:, :, :m]
        dv[:, :, k0:k0 + m] = (part[0][0] + part[1][0])[:, :, :m]
    dq = torch.zeros(B, H, S, hd)
    kth = kt.repeat_interleave(G, 1)
    kg, vg = kh.repeat_interleave(G, 1), vh.repeat_interleave(G, 1)
    heads = torch.arange(H)
    for q0 in range(0, S, rows):
        acc = torch.zeros(B, H, rows, hd)
        kv_end = min(S, q0 + rows) if causal else S
        for k0 in range(0, kv_end, nk):
            s = mm3(_rows(qh, q0, rows), _rows(kg, k0, nk).transpose(-1, -2))
            dp = mm3(_rows(doh, q0, rows), _rows(vg, k0, nk).transpose(-1, -2))
            qrow = torch.arange(q0, q0 + rows)[:, None]
            key = torch.arange(k0, k0 + nk)[None, :]
            _, ds = p_and_ds(s, dp, qrow, key, heads)
            acc += rs_product(ds, kth, k0, nk)
        m = min(rows, S - q0)
        dq[:, :, q0:q0 + m] = acc[:, :, :m]
    return (dq.permute(0, 2, 1, 3), dk.permute(0, 2, 1, 3),
            dv.permute(0, 2, 1, 3))


# ------------------------------------------------------------------ JAX --
def _inputs(rng, B, S, H, KV, hd):
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd), (B, S, H, hd))]


def _jax_lse(q, k, causal):
    """log-sum-exp [B,H,S] of the scaled, masked scores, in JAX."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = jnp.asarray(q).reshape(B, S, KV, H // KV, hd)
    s = jnp.einsum("bskgh,btkh->bkgst", qg, jnp.asarray(k)) * hd ** -0.5
    if causal:
        mask = jnp.arange(S)[:, None] >= jnp.arange(S)[None, :]
        s = jnp.where(mask, s, NEG_INF)
    return np.asarray(jax.nn.logsumexp(s, axis=-1).reshape(B, H, S))


# ------------------------------------------------------------------ tests --
def test_the_split_is_round_to_nearest_and_exact_to_2_22(rng):
    """hi and lo are tf32 (13 low bits zero), hi is x rounded to nearest
    (ties away from zero), and hi + lo is x to ~2^-22 of |x|."""
    x = torch.from_numpy((rng.standard_normal(100_000)
                          * 10.0 ** rng.integers(-6, 6, 100_000))
                         .astype(np.float32))
    hi, lo = split(x)
    for t in (hi, lo):
        assert int((t.view(torch.int32) & 0x1FFF).abs().max()) == 0
    d = x.double()
    assert bool(((d - hi.double()).abs()
                 <= d.abs() * 2.0 ** -11 * (1 + 1e-9)).all())
    assert float(((d - hi.double() - lo.double()).abs() / d.abs()).max()) \
        <= 2.0 ** -22
    # ties: 1 + 2^-11 is halfway between two tf32 values; away from zero
    t = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)])
    assert tf32(t).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]


def test_three_products_meet_fp32_where_one_does_not(rng):
    """Against an fp64 product over K 1024: the three tf32 products are
    within fp32's own rounding; one tf32 product is ~2^-11 off."""
    a = torch.from_numpy(rng.standard_normal((64, 1024)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((1024, 64)).astype(np.float32))
    exact = a.double() @ b.double()
    err3 = float((mm3(a, b).double() - exact).abs().max())
    err1 = float((mm1(a, b).double() - exact).abs().max())
    err32 = float(((a @ b).double() - exact).abs().max())
    assert err3 < 4 * err32 + 1e-5
    assert err1 > 30 * err3


def test_the_fragment_order_matches_the_pre_pass_layout():
    """The A fragment takes the accumulator's columns 0,2,4,6,1,3,5,7 (a
    lane-by-lane simulation), and the pre-pass writes B's rows in the
    same order, so the product sums each key once with its own row."""
    assert PERM8 == [0, 2, 4, 6, 1, 3, 5, 7]
    assert [_permuted_row(p) for p in range(16)] == \
        PERM8 + [8 + p for p in PERM8]
    g = torch.Generator().manual_seed(0)
    p = torch.randn(3, 64, 48, generator=g)          # [.., rows, keys]
    v = torch.randn(1, 48 + 5, 3, 16, generator=g)   # [B,S,heads,hd]
    t = transposed_split(v, 2 * 128)[0]              # [heads,hd,2*S16]
    got = rs_product(p[..., 16:48], t, 16, 32)       # keys 16..47
    want = p[..., 16:48].double() @ v[0, 16:48].permute(1, 0, 2).double()
    assert float((got.double() - want).abs().max()) < 1e-5


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 80, 128])
@pytest.mark.parametrize("S", [64, 129, 200])
def test_forward_arithmetic_matches_jax(rng, S, hd, causal):
    """o and lse of the emulated kernel against the JAX oracle at 3e-4:
    one key tile, ragged, and across several."""
    B, H, KV = 1, 4, 2
    q, k, v, _ = _inputs(rng, B, S, H, KV, hd)
    o, lse = tf32x3_forward(*(torch.from_numpy(a) for a in (q, k, v)),
                            causal)
    want = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, causal), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 80, 128])
@pytest.mark.parametrize("S", [64, 129, 200])
def test_backward_arithmetic_matches_jax_vjp(rng, S, hd, causal):
    """dq, dk, dv of the emulated kernel (fed the emulated forward's o and
    lse) against ``jax.vjp`` of the reference's chunked attention, whose
    backward is the XLA recompute backward, at 3e-4."""
    B, H, KV = 1, 4, 2
    q, k, v, w = _inputs(rng, B, S, H, KV, hd)
    tq, tk, tv, tw = (torch.from_numpy(a) for a in (q, k, v, w))
    o, lse = tf32x3_forward(tq, tk, tv, causal)
    got = tf32x3_backward(tq, tk, tv, o, tw, lse, causal)
    _, vjp = jax.vjp(lambda q, k, v: jax_chunked(q, k, v, causal, q_chunk=32,
                                                 kv_chunk=32),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, t, name in zip(got, vjp(jnp.asarray(w)), ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(t), **TOL,
                                   err_msg=f"{name} S{S} hd{hd}")


def test_backward_emulation_is_the_plain_backward(rng):
    """The emulation against ``attention_bwd_ref`` (the card check's
    oracle) at GQA 8 over 2, S 150: the same function."""
    B, S, H, KV, hd = 1, 150, 8, 2, 64
    q, k, v, w = (torch.from_numpy(a) for a in _inputs(rng, B, S, H, KV, hd))
    o, lse = ops.attention_ref(q, k, v, True, return_lse=True)
    got = tf32x3_backward(q, k, v, o, w, lse, True)
    for g, t in zip(got, ops.attention_bwd_ref(q, k, v, o, w, lse, True)):
        np.testing.assert_allclose(g.numpy(), t.numpy(), **TOL)


def test_one_tf32_pass_misses_the_fp32_tolerance(rng):
    """At S 1024, hd 64 (8 heads, causal), one TF32 pass per product is
    outside 3e-4 of the JAX oracle; the three passes are inside it, so the
    split cannot quietly become one pass."""
    B, S, H, KV, hd = 1, 1024, 8, 8, 64
    q, k, v, _ = _inputs(rng, B, S, H, KV, hd)
    want = np.asarray(jax_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=True))
    args = [torch.from_numpy(a) for a in (q, k, v)]
    three, _ = tf32x3_forward(*args, True)
    one, _ = tf32x3_forward(*args, True, passes=1)
    np.testing.assert_allclose(three.numpy(), want, **TOL)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(one.numpy(), want, **TOL)
    assert float(np.abs(one.numpy() - want).max()) > 3e-4


def test_hd80_layouts_serve_the_n80_products():
    """At hd 80 the pre-pass's transposed split has 80 rows a (hd, 16-row
    block): each TMA box of one 16-row block is 80 x 32 floats, 10240
    bytes, a whole number of 1024-byte swizzle atoms, so the blocks of a
    tile stay aligned; a product over the sequence read from it at N 80
    (every row a column of D) sums each key once with its own row.  The
    direct tiles at hd 80 are three 32-column boxes; the k8 steps over hd
    (10) read only the real columns, so the zero fill of 80-95 adds
    nothing."""
    hd = 80
    assert 80 * 32 * 4 % 1024 == 0
    g = torch.Generator().manual_seed(1)
    p = torch.randn(2, 64, 48, generator=g)          # [.., rows, keys]
    v = torch.randn(1, 48 + 5, 2, hd, generator=g)   # [B,S,heads,hd]
    t = transposed_split(v, 2 * 128)[0]              # [heads,hd,2*S16]
    assert tuple(t.shape) == (2, hd, 2 * 128)
    got = rs_product(p[..., 16:48], t, 16, 32)       # keys 16..47, N 80
    want = p[..., 16:48].double() @ v[0, 16:48].permute(1, 0, 2).double()
    assert tuple(got.shape) == (2, 64, hd)
    assert float((got.double() - want).abs().max()) < 1e-5
    # Q.K^T over three 32-column boxes, columns 80-95 zero (TMA's fill):
    # the 10 k8 steps of the real dims give the product over hd
    a = torch.randn(64, hd, generator=g)
    b = torch.randn(32, hd, generator=g)
    ap = torch.nn.functional.pad(a, (0, 16))
    bp = torch.nn.functional.pad(b, (0, 16))
    steps = sum(mm3(ap[:, 8 * kk:8 * kk + 8], bp[:, 8 * kk:8 * kk + 8].T)
                for kk in range(hd // 8))
    assert float((steps - mm3(a, b.T)).abs().max()) < 1e-4


@pytest.mark.parametrize("backward", [False, True])
def test_scratch_is_what_the_launch_functions_take(backward):
    """The wrapper's scratch, by name in the C functions' order, at the
    serving (forward) and training (backward) shapes: K's pair and V^T
    (67.1 MB); k, v pairs and q^T, dO^T, k^T (184.5 MB)."""
    B, S, H, KV, hd = (8, 512, 32, 8, 64) if backward else (8, 1024, 32, 8,
                                                              64)
    shapes = ops.tf32_scratch(B, S, H, KV, hd, backward)
    names = (["k_pair", "v_pair", "qt", "dot", "kt"] if backward
             else ["k_pair", "vt"])
    assert list(shapes) == names
    assert ops.tf32_scratch_bytes(B, S, H, KV, hd, backward) == (
        184_549_376 if backward else 67_108_864)
    # a ragged S rounds the transposed splits up to whole 16-row blocks
    t = ops.tf32_scratch(2, 77, 4, 2, 128, backward)
    assert t["kt" if backward else "vt"] == (2, 2, 128, 2 * 80)
    # zamba2's shapes (hd 80 over 32 KV heads): 80 rows a transposed split
    t = ops.tf32_scratch(8, 512 if backward else 1024, 32, 32, 80, backward)
    assert t["kt" if backward else "vt"] == (
        8, 32, 80, 2 * (512 if backward else 1024))
    assert t["k_pair"] == (2, 8, 512 if backward else 1024, 32, 80)


@pytest.mark.parametrize("fn", ["forward", "backward"])
def test_fp32_cuda_call_refuses_cpu_tensors_before_a_launch(fn):
    """The tf32x3 wrappers take CUDA tensors only: a CPU fp32 tensor raises
    before any launch count moves (``flash_attention`` itself gives a CPU
    tensor the plain version)."""
    q = torch.zeros(1, 16, 4, 64)
    kv = torch.zeros(1, 16, 2, 64)
    before = ({r: k.launches for r, k in ops.KERNELS.items()},
              {r: k.launches for r, k in ops.BWD_KERNELS.items()})
    with pytest.raises(ValueError, match="CUDA"):
        if fn == "forward":
            ops.attention_cuda(q, kv, kv, True, return_lse=True)
        else:
            ops.attention_bwd_cuda(q, kv, kv, q, q, torch.zeros(1, 4, 16))
    assert before == ({r: k.launches for r, k in ops.KERNELS.items()},
                      {r: k.launches for r, k in ops.BWD_KERNELS.items()})
