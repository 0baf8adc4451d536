"""The port's SSD-scan backward against the JAX package, on the CPU.

The JAX package differentiates its chunked scan by autodiff; the port's
backward is a kernel (``csrc/ssd_scan_bwd.cu``, run only on the card by
``chip_smoke.py``) whose plain version ``ssd_bwd_ref`` spells out the same
chunked passes in PyTorch.  Here, on the same inputs made from a seed with
numpy (dt drawn as the model draws it: softplus of a normal draw plus the
init's dt_bias, A = -linspace(1, 16, H), as ``chip_smoke.py::ssd_inputs``),
with and without a cotangent on the final state:

* ``ssd_bwd_ref`` and the gradients of ``ssd_scan`` (``SSDScan`` on CPU
  tensors) against ``jax.vjp`` of the reference's ``ssd_chunked`` and
  ``ssd_sequential``: dx, ddt, dA, dBm and dCm, at an L that is a multiple
  of the chunk and at a ragged one (``ssd_chunked`` then takes one chunk of
  length L, the port pads), N 16 and 128;
* ``ssd_bwd_ref`` against torch autograd of ``ssd_ref``;
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
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro.models.mamba2 import ssd_sequential as jax_ssd_sequential
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ops import (BWD_KERNELS, BWD_ROUTES,
                                             SSDScan, ssd_bwd_cuda,
                                             ssd_bwd_ref, ssd_ref, ssd_scan)

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


# ----------------------------------------------------------- routes, refusals
@pytest.mark.parametrize("dtype, want", [(torch.bfloat16, "bf16"),
                                         (torch.float32, "fp32")])
def test_backward_route_by_dtype(dtype, want):
    assert BWD_ROUTES[dtype] == want
    assert set(BWD_KERNELS) == {"bf16", "fp32"}
    assert {k.source for k in BWD_KERNELS.values()} == {"ssd_scan_bwd.cu"}
    assert len({k.symbol for k in BWD_KERNELS.values()}) == 2


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
        x, dt, A, Bm, Cm = _operands(P=16)
        dy, match = torch.zeros_like(x), "head_dim"
    elif case == "N32":
        x, dt, A, Bm, Cm = _operands(N=32)
        match = "state"
    elif case == "chunk100":
        kw, match = {"chunk": 100}, "chunk"
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
