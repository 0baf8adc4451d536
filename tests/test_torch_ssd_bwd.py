"""The port's SSD-scan backward against the JAX package, on the CPU.

The JAX package differentiates its chunked scan by autodiff; the port's
backward is a kernel per dtype (``csrc/ssd_scan_bwd_wgmma.cu`` and
``csrc/ssd_scan_bwd_tf32.cu``, run only on the card by ``chip_smoke.py``;
the fp32 route's arithmetic is ``test_torch_ssd_bwd_tf32``'s) whose plain
version ``ssd_bwd_ref`` spells out the same chunked passes in PyTorch.  Here, on the same inputs made from a seed with
numpy (dt drawn as the model draws it: softplus of a normal draw plus the
init's dt_bias, A = -linspace(1, 16, H), as ``chip_smoke.py::ssd_inputs``),
with and without a cotangent on the final state:

* ``ssd_bwd_ref`` and the gradients of ``ssd_scan`` (``SSDScan`` on CPU
  tensors) against ``jax.vjp`` of the reference's ``ssd_chunked`` and
  ``ssd_sequential``: dx, ddt, dA, dBm and dCm, at an L that is a multiple
  of the chunk and at a ragged one (``ssd_chunked`` then takes one chunk of
  length L, the port pads), N 16 and 128;
* ``ssd_bwd_ref`` against torch autograd of ``ssd_ref``;
* ``_wgmma_backward``, an emulation of the bf16 tensor-core kernel's
  arithmetic (``csrc/ssd_scan_bwd_wgmma.cu``), against ``jax.vjp`` of
  ``ssd_chunked`` and ``ssd_sequential`` on the same bf16 inputs within the
  bf16 tolerance, and at B 2, L 512, H 48, N 128, chunk 256 against
  ``ssd_bwd_ref`` under ``chip_smoke.py``'s own check, which it passes
  and the same emulation with plain bf16 operands fails;
* the backward's routes, the CUDA wrapper's refusals, the refusal of an
  initial state that requires grad, and serving without grad on the
  forward-only path.

Tolerance: fp32 within 3e-4 (``tests/test_kernels.py``' fp32 tolerance).
The reference's functions compute in float32 whatever the inputs (they cast
to it), so ``jax.enable_x64`` would not change their oracle; it is inside
3e-4 of the port's fp64 cumulative decay at these shapes.  The
reference's ``ssd_chunked`` has no finite gradient once a chunk's masked
decays exp(cum_t - cum_s), s > t, overflow float32 (chunks of ~32 rows and
more at the model's dt): its ddt and dA are NaN there
(``test_reference_chunked_gradient_overflows``).  So it is the oracle at
chunk 16 (and ragged L of one chunk up to 24 rows), and
``ssd_sequential``, which has no such term, at every shape.
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
from repro_torch.kernels.ssd_scan.ops import (BWD_HEAD_GROUP, BWD_KERNELS,
                                             BWD_ROUTES, SSDScan, _pad_rows,
                                             ssd_bwd_cuda, ssd_bwd_ref,
                                             ssd_ref, ssd_scan)

ROOT = Path(__file__).resolve().parents[1]

TOL = dict(rtol=3e-4, atol=3e-4)
NAMES = ("dx", "ddt", "dA", "dBm", "dCm")


def _inputs(rng, B, L, H, P, N):
    """float32 numpy x, dt, A, Bm, Cm and the cotangents dy, dS."""
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
    """jax.vjp of ``fn``'s (y, final_state) for the cotangents (dS None:
    zero), as float32 numpy."""
    (_, S), vjp = jax.vjp(fn, *map(jnp.asarray, args))
    g = vjp((jnp.asarray(dy),
             jnp.zeros_like(S) if dS is None else jnp.asarray(dS)))
    return [np.asarray(a, np.float32) for a in g]


def _autograd(args, dy, dS, chunk):
    """The gradients of ``ssd_scan`` on CPU tensors (through ``SSDScan``)
    for the same cotangents."""
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y, S = ssd_scan(*ts, chunk=chunk)
    loss = (y * torch.from_numpy(dy)).sum()
    if dS is not None:
        loss = loss + (S * torch.from_numpy(dS)).sum()
    return torch.autograd.grad(loss, ts)


def _close(got, want, err_msg=""):
    got = [g.numpy() if isinstance(g, torch.Tensor) else g for g in got]
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=f"{err_msg} {name}", **TOL)


# (B, L, H, P, N, chunk): L a multiple of the chunk, ragged L (one chunk of
# length L in ssd_chunked), N 16 and 128
CHUNKED = [(2, 64, 3, 16, 16, 16), (2, 20, 3, 16, 16, 16),
           (2, 48, 2, 16, 128, 16), (1, 24, 2, 8, 128, 16)]
# longer chunks, ragged L, against the step recurrence only
SEQUENTIAL = CHUNKED + [(2, 96, 2, 16, 128, 32), (2, 37, 3, 16, 16, 32),
                        (1, 100, 2, 16, 16, 64)]


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("shape", CHUNKED)
def test_backward_matches_jax_grad_of_ssd_chunked(rng, shape, final):
    B, L, H, P, N, chunk = shape
    args, dy, dS = _inputs(rng, B, L, H, P, N)
    dS = dS if final else None
    want = _jax_grads(lambda *a: jax_ssd_chunked(*a, chunk), args, dy, dS)
    t = [torch.from_numpy(a) for a in (*args, dy)]
    _close(ssd_bwd_ref(*t, None if dS is None else torch.from_numpy(dS),
                       chunk), want, "ssd_bwd_ref")
    _close(_autograd(args, dy, dS, chunk), want, "SSDScan")


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("shape", SEQUENTIAL)
def test_backward_matches_jax_grad_of_ssd_sequential(rng, shape, final):
    B, L, H, P, N, chunk = shape
    args, dy, dS = _inputs(rng, B, L, H, P, N)
    dS = dS if final else None
    want = _jax_grads(jax_ssd_sequential, args, dy, dS)
    _close(_autograd(args, dy, dS, chunk), want, "SSDScan")


def test_reference_chunked_gradient_overflows(rng):
    """A fault of the reference that the port does not copy: at chunk 64
    and the model's dt, ``ssd_chunked`` masks exp(cum_t - cum_s) for s > t
    after computing it, the masked entries overflow float32, and autodiff
    carries 0 * inf into ddt and dA.  The port's backward takes the decay
    only where s <= t: finite, and equal to the step recurrence's."""
    args, dy, dS = _inputs(rng, 1, 128, 2, 16, 16)
    chunked = _jax_grads(lambda *a: jax_ssd_chunked(*a, 64), args, dy, dS)
    assert not np.isfinite(chunked[1]).all()      # ddt
    assert not np.isfinite(chunked[2]).all()      # dA
    got = ssd_bwd_ref(*(torch.from_numpy(a) for a in (*args, dy)),
                      torch.from_numpy(dS), 64)
    assert all(bool(g.isfinite().all()) for g in got)
    _close(got, _jax_grads(jax_ssd_sequential, args, dy, dS))


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("shape", [(2, 64, 3, 8, 16, 16),
                                   (2, 50, 3, 8, 16, 16),
                                   (1, 37, 2, 16, 8, 32)])
def test_ssd_bwd_ref_matches_autograd_of_ssd_ref(rng, shape, init):
    """The chunked passes against torch autograd of the forward's plain
    version, with a final-state cotangent and, where given, an initial
    state (which the backward's pass 1 starts from)."""
    B, L, H, P, N, chunk = shape
    args, dy, dS = _inputs(rng, B, L, H, P, N)
    s0 = (torch.from_numpy(rng.standard_normal((B, H, P, N)).astype(
        np.float32)) if init else None)
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y, S = ssd_ref(*ts, chunk, s0)
    loss = ((y * torch.from_numpy(dy)).sum()
            + (S * torch.from_numpy(dS)).sum())
    want = [g.numpy() for g in torch.autograd.grad(loss, ts)]
    got = ssd_bwd_ref(*(torch.from_numpy(a) for a in (*args, dy)),
                      torch.from_numpy(dS), chunk, s0)
    _close(got, want)


def test_backward_keeps_the_inputs_dtypes(rng):
    args, dy, _ = _inputs(rng, 1, 40, 2, 8, 16)
    t = [torch.from_numpy(a) for a in args]
    x, Bm, Cm = (a.bfloat16() for a in (t[0], t[3], t[4]))
    got = ssd_bwd_ref(x, t[1], t[2], Bm, Cm,
                      torch.from_numpy(dy).bfloat16(), None, 16)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16]
    assert [tuple(g.shape) for g in got] == [tuple(a.shape) for a in
                                             (x, *t[1:3], Bm, Cm)]


# ------------------------------------------- the tensor-core kernel's arithmetic
def _wgmma_backward(x, dt, A, Bm, Cm, dy, d_final_state=None, chunk=256,
                    initial_state=None, split=True):
    """The arithmetic of ``csrc/ssd_scan_bwd_wgmma.cu`` on bf16
    x/Bm/Cm/dy: ``ssd_bwd_ref``'s chunked passes, with every product that
    the kernel runs on the tensor cores taking its one operand that is an
    fp32 result as the bf16 pair hi + lo (hi = bf16(v), lo = bf16(v − hi);
    ``split=False``: hi alone, a plain bf16 design): w∘x in the chunk
    states, exp(cum)∘dy in the state cotangents' sums, the chunk-start
    state S_prev in dC's state term (dy·S_prev, times exp(cum_t) after)
    and in E, the chunk-end cotangent dS in B·dSᵀ (dx's state term and
    ddt_state) and x·dS (dB's, times w_s after), and the scores G·L·dt_s
    (dx) and M·L·dt_s (dB, dC).  ⟨dS, S_prev⟩ takes S_prev as hi + lo.
    Products in fp32 from the bf16 inputs (G, M exact); cum in fp64; the
    exp of each fp64 difference in fp32; dB and dC summed over the heads
    of each group of ``BWD_HEAD_GROUP`` in fp32, then over the groups in
    order.  Returns (dx, ddt, dA, dBm, dCm) in the dtypes of the
    inputs."""
    def rnd(v):
        hi = v.bfloat16().float()
        return hi + (v - hi).bfloat16().float() if split else hi

    def pair(v):
        hi = v.bfloat16().float()
        return hi + (v - hi).bfloat16().float()

    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
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

    # the state kernel: S_prev forward, dS in reverse
    S_c = torch.einsum("bcshp,bcsn->bchpn", rnd(w[..., None] * xc), Bc)
    S = (x.new_zeros((Bsz, H, P, N), dtype=torch.float32)
         if initial_state is None else initial_state.float())
    starts = []
    for c in range(nc):
        starts.append(S)
        S = S * decay[:, c, :, None, None] + S_c[:, c]
    S_prev = torch.stack(starts, dim=1)                   # [B,nc,H,P,N]
    U = torch.einsum("bcthp,bctn->bchpn", rnd(ecum[..., None] * dyc), Cc)
    dS = (x.new_zeros((Bsz, H, P, N), dtype=torch.float32)
          if d_final_state is None else d_final_state.float())
    ends = [None] * nc
    for c in reversed(range(nc)):
        ends[c] = dS
        dS = dS * decay[:, c, :, None, None] + U[:, c]
    dS_end = torch.stack(ends, dim=1)
    Sp, dSp = rnd(S_prev), rnd(dS_end)
    dss = (dS_end * pair(S_prev)).sum(dim=(-2, -1))       # [B,nc,H]

    # the dx/dB and dC kernels: per head, then the heads' groups
    G = torch.einsum("bctn,bcsn->bcts", Cc, Bc)[..., None]
    M = torch.einsum("bcthp,bcshp->bctsh", dyc, xc)
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    Lm = torch.where(tri[None, None, :, :, None],
                     torch.exp((cum[:, :, :, None, :]
                                - cum[:, :, None, :, :]).float()),
                     torch.zeros((), device=x.device))
    GL = G * Lm
    MLd = rnd(M * Lm * dtc[:, :, None, :, :])
    V = torch.einsum("bchpn,bcsn->bcshp", dSp, Bc)
    dx = (torch.einsum("bctsh,bcthp->bcshp",
                       rnd(GL * dtc[:, :, None, :, :]), dyc)
          + w[..., None] * V)
    dBh = (torch.einsum("bctsh,bctn->bcshn", MLd, Cc)
           + w[..., None] * torch.einsum("bcshp,bchpn->bcshn", xc, dSp))
    Z = torch.einsum("bcthp,bchpn->bcthn", dyc, Sp)
    dCh = (torch.einsum("bctsh,bcsn->bcthn", MLd, Bc)
           + ecum[..., None] * Z)
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
    D = GL * M
    ddt_intra = D.sum(dim=2)
    ddt_state = e * torch.einsum("bcshp,bcshp->bcsh", xc, V)
    row = (D * dtc[:, :, None, :, :]).sum(dim=3)
    E = ecum * torch.einsum("bcthn,bctn->bcth", Z, Cc)
    dcum = (row + E) - dtc * (ddt_intra + ddt_state)
    dcum[:, :, -1] += decay * dss + (dtc * ddt_state).sum(dim=2)
    da = torch.flip(torch.cumsum(torch.flip(dcum.double(), [2]), dim=2), [2])
    ddt = ddt_intra + ddt_state + (Af.double() * da).float()
    dA = (dtc.double() * da).sum(dim=(1, 2)).sum(dim=0)

    def rows(t):
        return t.reshape(Bsz, nc * Q, *t.shape[3:])[:, :L]
    return (rows(dx).to(x.dtype), rows(ddt).to(dt.dtype), dA.to(A.dtype),
            rows(dB).to(Bm.dtype), rows(dC).to(Cm.dtype))


BF16_TOL = dict(rtol=5e-2, atol=5e-2)   # chip_smoke.TOLS["bfloat16"]


def _bf16_problem(rng, B, L, H, P, N):
    """``_inputs`` with x, Bm, Cm and dy rounded to bf16: (torch args with
    those four in bf16, their float32 numpy values, dS)."""
    args, dy, dS = _inputs(rng, B, L, H, P, N)
    t = [torch.from_numpy(a) for a in (*args, dy)]
    for i in (0, 3, 4, 5):
        t[i] = t[i].bfloat16()
    values = [a.float().numpy() for a in t]
    return t, values, dS


def _close_bf16(got, want, err_msg=""):
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.float().numpy(), w,
                                   err_msg=f"{err_msg} {name}", **BF16_TOL)


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("shape", CHUNKED)
def test_wgmma_emulation_matches_jax_grad_of_ssd_chunked(rng, shape, final):
    """The kernel's roundings on bf16 inputs against the exact gradient of
    the same bf16 problem: ``jax.vjp`` of ``ssd_chunked`` at chunk 16 on
    their float32 values, within the card check's bf16 tolerance."""
    B, L, H, P, N, chunk = shape
    t, v, dS = _bf16_problem(rng, B, L, H, P, N)
    dS = dS if final else None
    want = _jax_grads(lambda *a: jax_ssd_chunked(*a, chunk), v[:5], v[5], dS)
    got = _wgmma_backward(*t, None if dS is None else torch.from_numpy(dS),
                          chunk)
    _close_bf16(got, want, "wgmma emulation")


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("shape", SEQUENTIAL)
def test_wgmma_emulation_matches_jax_grad_of_ssd_sequential(rng, shape,
                                                            final):
    B, L, H, P, N, chunk = shape
    t, v, dS = _bf16_problem(rng, B, L, H, P, N)
    dS = dS if final else None
    want = _jax_grads(jax_ssd_sequential, v[:5], v[5], dS)
    got = _wgmma_backward(*t, None if dS is None else torch.from_numpy(dS),
                          chunk)
    _close_bf16(got, want, "wgmma emulation")


@pytest.mark.parametrize("init", [False, True])
def test_wgmma_emulation_is_not_the_plain_version(rng, init):
    """The emulation rounds where ``ssd_bwd_ref`` does not: every output
    differs from the plain version's, and stays within the bf16 tolerance
    of it, with a final-state cotangent and an initial state."""
    B, L, H, P, N, chunk = 2, 100, 3, 16, 32, 64
    t, _, dS = _bf16_problem(rng, B, L, H, P, N)
    s0 = (torch.from_numpy(rng.standard_normal((B, H, P, N)).astype(
        np.float32)) if init else None)
    dS = torch.from_numpy(dS)
    got = _wgmma_backward(*t, dS, chunk, s0)
    want = ssd_bwd_ref(*t, dS, chunk, s0)
    for name, g, w in zip(NAMES, got, want):
        assert not torch.equal(g, w), name
    _close_bf16(got, [w.float().numpy() for w in want], "against ssd_bwd_ref")


def _card_inputs(seed, B, L, H, N):
    """``chip_smoke.ssd_inputs`` and its cotangent dy, drawn with numpy:
    x, Bm, Cm and dy normal in bf16; dt = softplus(u + dt_bias), dt_bias =
    log(expm1(linspace(1e-3, 1e-1, H))); A = -exp(log(linspace(1, 16,
    H)))."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x = normal(B, L, H, 64).bfloat16()
    dt_bias = torch.log(torch.expm1(torch.linspace(1e-3, 1e-1, H)))
    dt = torch.nn.functional.softplus(normal(B, L, H) + dt_bias)
    A = -torch.exp(torch.log(torch.linspace(1.0, 16.0, H)))
    Bm, Cm = normal(B, L, N).bfloat16(), normal(B, L, N).bfloat16()
    return x, dt, A, Bm, Cm, normal(B, L, H, 64).bfloat16()


def _card_check(got, want, B, L, chunk):
    """``chip_smoke.py``'s check of a bf16 SSD backward
    (``ssd_bwd_case``): each output within ``TOLS["bfloat16"]`` widened by
    ``ssd_bwd_tol``, and within ``BWD_BF16_SCALED`` of its largest
    magnitude.  Raises AssertionError on a failure."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    for name, g, w in zip(chip_smoke.SSD_BWD_NAMES, got, want):
        try:
            chip_smoke.max_err(g, w, "bfloat16",
                               chip_smoke.ssd_bwd_tol(name, "bfloat16", B, L,
                                                      chunk))
            chip_smoke.scaled_err(g, w, chip_smoke.BWD_BF16_SCALED)
        except AssertionError as e:
            raise AssertionError(f"{name}: {e}") from None


@pytest.mark.parametrize("seed", [0, 1])
def test_wgmma_emulation_passes_the_card_check_where_plain_bf16_fails(seed):
    """At B 2, L 512, H 48, N 128, chunk 256 (two chunks at the model's
    widths): the emulation against ``ssd_bwd_ref`` passes the card's check;
    the same emulation with plain bf16 operands (no lo halves) fails it,
    so the check sees a kernel that drops them."""
    B, L, H, N, chunk = 2, 512, 48, 128, 256
    args = _card_inputs(seed, B, L, H, N)
    want = ssd_bwd_ref(*args, None, chunk)
    _card_check(_wgmma_backward(*args, None, chunk), want, B, L, chunk)
    with pytest.raises(AssertionError, match="outside tolerance"):
        _card_check(_wgmma_backward(*args, None, chunk, split=False), want,
                    B, L, chunk)


# ----------------------------------------------------------- routes, refusals
@pytest.mark.parametrize("dtype, want", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "tf32x3")])
def test_backward_route_by_dtype(dtype, want):
    assert BWD_ROUTES[dtype] == want
    assert set(BWD_KERNELS) == {"wgmma", "tf32x3"}
    assert {r: k.source for r, k in BWD_KERNELS.items()} == {
        "wgmma": "ssd_scan_bwd_wgmma.cu", "tf32x3": "ssd_scan_bwd_tf32.cu"}
    assert BWD_KERNELS[want] is not BWD_KERNELS[
        "tf32x3" if want == "wgmma" else "wgmma"]


def _operands(dtype=torch.bfloat16, B=1, L=8, H=2, P=64, N=128):
    return (torch.zeros(B, L, H, P, dtype=dtype), torch.zeros(B, L, H),
            torch.zeros(H), torch.zeros(B, L, N, dtype=dtype),
            torch.zeros(B, L, N, dtype=dtype))


@pytest.mark.parametrize("case", ["P16", "N32", "chunk100", "float16",
                                  "dt_bf16", "dy_float32", "dy_transposed",
                                  "dstate_bf16", "dstate_shape", "cpu"])
def test_ssd_bwd_cuda_refuses_what_the_kernel_does_not_take(case):
    x, dt, A, Bm, Cm = _operands()
    dy, kw, err, match = torch.zeros_like(x), {}, ValueError, None
    if case == "P16":
        # head_dim 16, state 32 and chunk 100 are taken (the kernels run the
        # chunk at 64): only the CPU tensors are refused
        x, dt, A, Bm, Cm = _operands(P=16)
        dy, match = torch.zeros_like(x), "CUDA tensors"
    elif case == "N32":
        x, dt, A, Bm, Cm = _operands(N=32)
        match = "CUDA tensors"
    elif case == "chunk100":
        kw, match = {"chunk": 100}, "CUDA tensors"
    elif case == "float16":
        x, dt, A, Bm, Cm = _operands(torch.float16)
        dy, err, match = torch.zeros_like(x), TypeError, "float16"
    elif case == "dt_bf16":
        dt, err, match = dt.bfloat16(), TypeError, "float32 dt"
    elif case == "dy_float32":
        dy, match = dy.float(), "dy must match"
    elif case == "dy_transposed":
        dy = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16).transpose(1, 2)
        match = "contiguous"
    elif case == "dstate_bf16":
        kw = {"d_final_state": torch.zeros(1, 2, 64, 128,
                                           dtype=torch.bfloat16)}
        match = "d_final_state"
    elif case == "dstate_shape":
        kw, match = {"d_final_state": torch.zeros(1, 2, 128, 64)}, \
            "d_final_state"
    else:
        match = "CUDA tensors"
    with pytest.raises(err, match=match):
        ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, **kw)


def test_initial_state_that_requires_grad_is_refused():
    x, dt, A, Bm, Cm = (t.float().requires_grad_() for t in _operands(
        torch.float32, P=8, N=8))
    s0 = torch.zeros(1, 2, 8, 8, requires_grad=True)
    with pytest.raises(ValueError, match="initial_state"):
        ssd_scan(x, dt, A, Bm, Cm, chunk=16, initial_state=s0)
    with torch.no_grad():                 # serving passes a state: no grad
        ssd_scan(x, dt, A, Bm, Cm, chunk=16, initial_state=s0)


def test_the_backward_sends_cpu_tensors_to_the_plain_version(rng,
                                                             monkeypatch):
    """On CPU tensors SSDScan's backward calls ``ssd_bwd_ref`` once, with
    the final-state cotangent when one is given, and never the kernel."""
    calls = []
    orig = ops.ssd_bwd_ref

    def record(*a):
        calls.append(a[6] is not None)
        return orig(*a)

    monkeypatch.setattr(ops, "ssd_bwd_ref", record)
    monkeypatch.setattr(ops, "ssd_bwd_cuda", None)
    args, dy, dS = _inputs(rng, 1, 20, 2, 8, 8)
    _autograd(args, dy, None, 16)
    _autograd(args, dy, dS, 16)
    assert calls == [False, True]


def test_serving_without_grad_takes_the_forward_only_path(rng, monkeypatch):
    """Under no_grad, or with no input that requires grad, ``ssd_scan``
    never enters ``SSDScan``: serving keeps its path."""
    monkeypatch.setattr(SSDScan, "apply", None)
    args, _, _ = _inputs(rng, 1, 20, 2, 8, 8)
    t = [torch.from_numpy(a) for a in args]
    y, S = ssd_scan(*t, chunk=16)
    with torch.no_grad():
        y2, S2 = ssd_scan(*(a.clone().requires_grad_() for a in t),
                          chunk=16)
    assert torch.equal(y, y2) and torch.equal(S, S2)
    assert not y.requires_grad and not y2.requires_grad
