"""The port's backward ops against the JAX package, on the CPU.

On CPU tensors the flash-attention and fused-norm ops run their plain
versions in both directions (``attention_bwd_ref``, ``fused_bwd_ref``: the
arithmetic of the backward kernels, step by step), which the kernels are
held to on the card (``chip_smoke.py``).  Here the gradients meet the JAX
oracles on the same inputs, made from a seed with numpy, through the same
scalar loss:

* flash attention: ``jax.grad`` of the model's ``chunked_attention`` (the
  custom-VJP recompute backward that the JAX package trains with) and of
  ``direct_attention``; ``attention_bwd_ref`` against torch autograd of
  ``attention_ref``; the port's plain ``lse`` against ``_flash_fwd``'s;
* the fused residual + RMSNorm: ``jax.grad`` of
  ``kernels/fused_norm/ref.py::fused_ref`` with cotangents on both outputs
  and on y alone; ``fused_bwd_ref`` against autograd of ``fused_ref``;
* what the backward wrappers refuse before they launch.

Tolerances are those of ``tests/test_kernels.py``: fp32 3e-4, bf16 5e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_norm.ref import fused_ref as jax_fused_ref
from repro.models.attention import _flash_fwd
from repro.models.attention import chunked_attention as jax_chunked
from repro.models.attention import direct_attention as jax_direct
from repro_torch.kernels.flash_attention.ops import (attention_bwd_cuda,
                                                     attention_bwd_ref,
                                                     attention_ref,
                                                     flash_attention)
from repro_torch.kernels.fused_norm.ops import (fused_bwd_cuda, fused_bwd_ref,
                                                fused_ref,
                                                fused_residual_rmsnorm)

TOLS = {"float32": dict(rtol=3e-4, atol=3e-4),
        "bfloat16": dict(rtol=5e-2, atol=5e-2)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _inputs(rng, shapes, dtype):
    """numpy float32 draws as (jax arrays, torch leaves that want a
    gradient) of ``dtype``; both round to nearest even."""
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_()
          for a in arrs]
    return jx, tx


# (S, KV, hd, causal, dtype): B 2, H 4; every value of each axis appears,
# S 96 is ragged against the kernels' 64-row tiles
FLASH_CASES = [(64, 1, 16, True, "float32"), (96, 2, 64, True, "float32"),
               (96, 1, 16, False, "float32"), (64, 2, 64, False, "float32"),
               (64, 2, 16, True, "bfloat16"), (96, 1, 64, True, "bfloat16"),
               (96, 2, 16, False, "bfloat16"), (64, 1, 64, False, "bfloat16")]


@pytest.mark.parametrize("S, KV, hd, causal, dtype", FLASH_CASES)
def test_flash_gradients_match_jax(rng, S, KV, hd, causal, dtype):
    B, H = 2, 4
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        rng, [(B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)], dtype)
    w = rng.standard_normal((B, S, H, hd)).astype(np.float32)

    def loss(fn):
        return lambda q, k, v: jnp.sum(
            fn(q, k, v, causal).astype(jnp.float32) * w)

    # 32-row chunks: several q and kv chunks in the recompute backward
    chunked = loss(lambda q, k, v, c: jax_chunked(q, k, v, c, q_chunk=32,
                                                  kv_chunk=32))
    oracles = {"chunked": jax.grad(chunked, argnums=(0, 1, 2))(jq, jk, jv),
               "direct": jax.grad(loss(jax_direct), argnums=(0, 1, 2))(
                   jq, jk, jv)}
    o = flash_attention(tq, tk, tv, causal)
    assert o.requires_grad
    (o.float() * torch.from_numpy(w)).sum().backward()
    got = (tq.grad, tk.grad, tv.grad)
    for name, want in oracles.items():
        for g, t, label in zip(got, want, ("dq", "dk", "dv")):
            assert g.dtype == getattr(torch, dtype)
            np.testing.assert_allclose(_np(g), _np(t), **TOLS[dtype],
                                       err_msg=f"{name} {label}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S, KV", [(64, 2), (96, 1)])
def test_attention_bwd_ref_matches_autograd(rng, S, KV, causal):
    """The plain backward (the kernel's steps) is torch autograd of the
    plain forward; its lse is the one the forward returns."""
    B, H, hd = 2, 4, 16
    _, (q, k, v) = _inputs(
        rng, [(B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)], "float32")
    do = torch.from_numpy(rng.standard_normal((B, S, H, hd)).astype(
        np.float32))
    o, lse = attention_ref(q, k, v, causal, return_lse=True)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = attention_bwd_ref(q, k, v, o, do, lse, causal)
    for g, t in zip(got, want):
        torch.testing.assert_close(g, t, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S, q_chunk", [(64, 64), (96, 32)])
def test_plain_lse_matches_jax_flash_fwd(rng, S, q_chunk, causal):
    """lse [B,H,S] of ``attention_ref`` is ``_flash_fwd``'s [B,KV,G,S]."""
    B, H, KV, hd = 2, 4, 2, 16
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        rng, [(B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)], "float32")
    qpos = jnp.arange(S, dtype=jnp.float32)
    jo, jlse = _flash_fwd(jq.reshape(B, S, KV, H // KV, hd), jk, jv, qpos,
                          causal, q_chunk, 32)
    o, lse = attention_ref(tq, tk, tv, causal, return_lse=True)
    np.testing.assert_allclose(_np(lse), _np(jlse).reshape(B, H, S),
                               **TOLS["float32"])
    np.testing.assert_allclose(_np(o), _np(jo).reshape(B, S, H, hd),
                               **TOLS["float32"])


@pytest.mark.parametrize("with_dh", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R, D", [(64, 96), (128, 256)])
def test_fused_norm_gradients_match_jax(rng, R, D, dtype, with_dh):
    """Cotangents on y and h, or on y alone (the final norm's h is
    unused: the op's backward then gets no dh)."""
    (jx, jr, js), (tx, tr, ts) = _inputs(rng, [(R, D), (R, D), (D,)], dtype)
    js = js.astype(jnp.float32)
    ts = ts.detach().float().requires_grad_()
    wy, wh = (rng.standard_normal((R, D)).astype(np.float32)
              for _ in range(2))

    def loss(x, r, s):
        y, h = jax_fused_ref(x, r, s)
        out = jnp.sum(y.astype(jnp.float32) * wy)
        if with_dh:
            out = out + jnp.sum(h.astype(jnp.float32) * wh)
        return out

    want = jax.grad(loss, argnums=(0, 1, 2))(jx, jr, js)
    y, h = fused_residual_rmsnorm(tx, tr, ts)
    out = (y.float() * torch.from_numpy(wy)).sum()
    if with_dh:
        out = out + (h.float() * torch.from_numpy(wh)).sum()
    out.backward()
    got = (tx.grad, tr.grad, ts.grad)
    assert ts.grad.dtype == torch.float32
    for g, t, label in zip(got, want, ("dx", "dres", "dscale")):
        # dscale sums R rows: atol grows with sqrt(R) in bf16
        tol = dict(TOLS[dtype])
        if label == "dscale" and dtype == "bfloat16":
            tol["atol"] *= R ** 0.5
        np.testing.assert_allclose(_np(g), _np(t), **tol, err_msg=label)


@pytest.mark.parametrize("with_dh", [True, False])
def test_fused_bwd_ref_matches_autograd(rng, with_dh):
    R, D = 48, 80
    _, (x, r, s) = _inputs(rng, [(R, D), (R, D), (D,)], "float32")
    dy, dh = (torch.from_numpy(rng.standard_normal((R, D)).astype(
        np.float32)) for _ in range(2))
    y, h = fused_ref(x, r, s)
    outs, cots = ((y, h), (dy, dh)) if with_dh else ((y,), (dy,))
    want = torch.autograd.grad(outs, (x, r, s), cots)
    dx, dscale = fused_bwd_ref(x, r, s, dy, dh if with_dh else None)
    for g, t in zip((dx, dx, dscale), want):
        torch.testing.assert_close(g, t, rtol=3e-4, atol=3e-4)


def test_backward_wrappers_refuse_what_their_kernels_do_not_take():
    """CPU tensors, head_dim 24 and float16 never reach a launch (head_dim
    16, the reduced configs', is taken since the kernels widened)."""
    q = torch.zeros(1, 8, 2, 64)
    k = torch.zeros(1, 8, 1, 64)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        attention_bwd_cuda(q, k, k, q, q, lse)
    q16, k16 = q[..., :24].contiguous(), k[..., :24].contiguous()
    with pytest.raises(ValueError, match="head_dim"):
        attention_bwd_cuda(q16, k16, k16, q16, q16, lse)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        attention_bwd_cuda(q.half(), k.half(), k.half(), q.half(), q.half(),
                           lse)
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        fused_bwd_cuda(x, x, torch.ones(8), x, None)
    with pytest.raises(ValueError, match="dy must match"):
        fused_bwd_cuda(x, x, torch.ones(8), torch.zeros(4, 9), None)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_bwd_cuda(x.half(), x.half(), torch.ones(8), x.half(), None)


@pytest.mark.parametrize("D", [6144, 7168, 8192, 8200, 16384, 16392])
def test_fused_bwd_takes_d_up_to_8192(rng, D):
    """The backward kernel takes rows up to ``BWD_MAX_D`` = 16384 (the MoE
    models' 6144 and 7168, llama3-405b's 16384; 8192 until the wide-row
    instance): such a width passes the wrapper's checks up to the device
    (a CPU tensor is refused there), a wider one is refused before; the
    autograd path on CPU tensors (the plain backward) holds to ``jax.grad``
    of ``fused_ref`` at these widths."""
    from repro_torch.kernels.fused_norm.ops import BWD_MAX_D
    assert BWD_MAX_D == 16384
    R = 4
    (jx, jr, js), (tx, tr, ts) = _inputs(rng, [(R, D), (R, D), (D,)],
                                         "float32")
    dy = torch.ones(R, D)
    with pytest.raises(ValueError, match="CUDA" if D <= BWD_MAX_D else
                       f"takes D up to 16384, not {D}"):
        fused_bwd_cuda(tx.detach(), tr.detach(), ts.detach(), dy, None)
    if D > BWD_MAX_D:
        return
    wy = rng.standard_normal((R, D)).astype(np.float32)
    want = jax.grad(lambda x, r, s: jnp.sum(
        jax_fused_ref(x, r, s)[0] * wy), argnums=(0, 1, 2))(jx, jr, js)
    y, _ = fused_residual_rmsnorm(tx, tr, ts)
    (y * torch.from_numpy(wy)).sum().backward()
    for g, t in zip((tx.grad, tr.grad, ts.grad), want):
        np.testing.assert_allclose(_np(g), _np(t), **TOLS["float32"])


def test_ops_without_grad_take_the_serving_path():
    """No autograd graph when no gradient is wanted (serving, no_grad)."""
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    k = torch.randn(1, 8, 1, 16)
    with torch.no_grad():
        assert flash_attention(q, k, k).grad_fn is None
    assert flash_attention(q.detach(), k, k).grad_fn is None
    assert flash_attention(q, k, k).grad_fn is not None
    x = torch.randn(4, 8)
    y, h = fused_residual_rmsnorm(x, x, torch.ones(8))
    assert y.grad_fn is None and h.grad_fn is None
