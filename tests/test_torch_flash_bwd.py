"""The bf16 tensor-core flash-attention backward's arithmetic, and the
backward's routes, on the CPU.

``csrc/flash_attention_bwd_wgmma.cu`` runs only on the card, where
``chip_smoke.py`` holds it to ``attention_bwd_ref``.  Its roundings are
pinned here before any card sees them: ``_wgmma_backward`` repeats the
kernel's arithmetic in plain PyTorch, tile by tile (a dK/dV pass over
128-key blocks and 64-row q tiles from the causal frontier on, a dQ pass
over 128-row q tiles and 128-key tiles at hd 64, 64-key tiles at hd 128),
with fp32 products of the bf16 operands, P = exp2(s·scale·log2e −
lse·log2e), and P^T and dS^T (dS for dQ) rounded to bf16 before the
products they feed.  It is held against ``jax.grad`` of the reference's
``chunked_attention`` (the custom-VJP recompute backward the JAX package
trains with) and ``direct_attention`` on the same bf16 inputs and bf16
cotangent, made from a seed with numpy, within the card check's
tolerance: the elementwise bf16 5e-2 and 1e-2 of each output's largest
magnitude.  JAX differentiates the bf16 inputs in float32, so the oracle is
the exact gradient of the bf16 problem: run in bf16 itself, the
reference's chunked backward rounds on its own (at S 1 its dq and dk are
rounding noise as large as themselves, where the exact ones are 0).

Then the routes: bf16 takes ``"wgmma"``, fp32 ``"tf32x3"`` (split TF32 on
the tensor cores, ``tests/test_torch_flash_tf32.py``), each with its own
kernel and launch count, and what neither takes raises before a launch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import chunked_attention as jax_chunked
from repro.models.attention import direct_attention as jax_direct
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ops import (attention_bwd_cuda,
                                                     attention_bwd_ref,
                                                     attention_ref)
from repro_torch.kernels.fused_norm.ops import BWD_MAX_D, fused_bwd_cuda

LOG2E = 1.4426950408889634
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
# at most this fraction of each output's largest magnitude (as
# chip_smoke.BWD_BF16_SCALED); the magnitude is floored at 1e-3, since at
# S 1 dq and dk are zero up to rounding
SCALED = 1e-2


def _masked(s, q0, k0, S, causal):
    """s [B,H,q,k] of queries q0.. and keys k0.. with the kernel's mask:
    queries or keys >= S, and keys after the query when causal, give no
    probability."""
    q = torch.arange(q0, q0 + s.shape[2])[:, None]
    k = torch.arange(k0, k0 + s.shape[3])[None, :]
    bad = (q >= S) | (k >= S)
    if causal:
        bad = bad | (k > q)
    return bad


def _probs_and_dscores(qf, kf, vf, dof, lse2, delta, qs, ks, S, causal,
                       scale):
    """P and dS [B,H,q,k] of q rows ``qs`` against keys ``ks`` (fp32)."""
    s = torch.einsum("bqhd,bkhd->bhqk", qf[:, qs], kf[:, ks])
    p = torch.exp2(s * (scale * LOG2E) - lse2[:, :, qs, None])
    p = torch.where(_masked(p, qs.start, ks.start, S, causal), 0.0, p)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof[:, qs], vf[:, ks])
    return p, p * (dp - delta[:, :, qs, None]) * scale


def _wgmma_backward(q, k, v, o, do, lse, causal):
    """The arithmetic of ``csrc/flash_attention_bwd_wgmma.cu`` on bf16
    inputs: (dq, dk, dv) in bf16."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    delta = (dof * o.float()).sum(-1).permute(0, 2, 1)       # [B,H,S]
    lse2 = lse * LOG2E
    dq = torch.zeros(B, S, H, hd)
    dk = torch.zeros(B, S, KV, hd)
    dv = torch.zeros(B, S, KV, hd)
    # dK / dV: 128-key blocks, 64-row q tiles from the causal frontier on
    for k0 in range(0, S, 128):
        ks = slice(k0, min(k0 + 128, S))
        for q0 in range(k0 if causal else 0, S, 64):
            qs = slice(q0, min(q0 + 64, S))
            p, ds = _probs_and_dscores(qf, kf, vf, dof, lse2, delta, qs, ks,
                                       S, causal, scale)
            dvh = torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(),
                               dof[:, qs])
            dkh = torch.einsum("bhqk,bqhd->bkhd", ds.bfloat16().float(),
                               qf[:, qs])
            n = ks.stop - ks.start
            dv[:, ks] += dvh.reshape(B, n, KV, G, hd).sum(3)
            dk[:, ks] += dkh.reshape(B, n, KV, G, hd).sum(3)
    # dQ: 128-row q tiles, key tiles of 128 (hd 64) or 64 (hd 80, 128) up
    # to the causal frontier
    bk = 128 if hd == 64 else 64
    for q0 in range(0, S, 128):
        qs = slice(q0, min(q0 + 128, S))
        for k0 in range(0, min(S, q0 + 128) if causal else S, bk):
            ks = slice(k0, min(k0 + bk, S))
            _, ds = _probs_and_dscores(qf, kf, vf, dof, lse2, delta, qs, ks,
                                       S, causal, scale)
            dq[:, qs] += torch.einsum("bhqk,bkhd->bqhd",
                                      ds.bfloat16().float(), kf[:, ks])
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _assert_bf16_close(got, want, label):
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    np.testing.assert_allclose(g, w, **BF16_TOL, err_msg=label)
    err = float(np.abs(g - w).max())
    assert err <= SCALED * max(float(np.abs(w).max()), 1e-3), (
        f"{label}: max abs err {err:.3e} above {SCALED} of the largest "
        f"magnitude {float(np.abs(w).max()):.3e}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 80, 128])
@pytest.mark.parametrize("S", [1, 100, 200])
def test_wgmma_backward_arithmetic_matches_jax(rng, S, hd, causal):
    """The kernel's extra roundings stay inside the card check's tolerance
    of both JAX oracles, at S inside one tile, across tiles and ragged."""
    B, H, KV = 1, 4, 2
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
    w = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    # bf16 inputs and cotangent, differentiated in float32 by JAX
    jq, jk, jv, jw = (jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)
                      for a in (*arrs, w))
    q, k, v = (torch.from_numpy(a).bfloat16() for a in arrs)

    def loss(fn):
        return lambda q, k, v: jnp.sum(fn(q, k, v, causal) * jw)

    chunked = loss(lambda q, k, v, c: jax_chunked(q, k, v, c, q_chunk=32,
                                                  kv_chunk=32))
    oracles = {"chunked": jax.grad(chunked, argnums=(0, 1, 2))(jq, jk, jv),
               "direct": jax.grad(loss(jax_direct), argnums=(0, 1, 2))(
                   jq, jk, jv)}
    o, lse = attention_ref(q, k, v, causal, return_lse=True)
    do = torch.from_numpy(w).bfloat16()
    got = _wgmma_backward(q, k, v, o, do, lse, causal)
    for name, want in oracles.items():
        for g, t, label in zip(got, want, ("dq", "dk", "dv")):
            assert g.dtype == torch.bfloat16
            _assert_bf16_close(g, t, f"{name} {label} S{S} hd{hd}")


@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_backward_arithmetic_matches_the_plain_backward(rng, causal):
    """The same emulation against ``attention_bwd_ref`` (the card check's
    oracle) at GQA 8 over 2, S 150 (ragged against every tile)."""
    B, S, H, KV, hd = 2, 150, 8, 2, 64
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (B, S, n, hd)).astype(np.float32)).bfloat16() for n in (H, KV, KV, H))
    o, lse = attention_ref(q, k, v, causal, return_lse=True)
    got = _wgmma_backward(q, k, v, o, do, lse, causal)
    want = attention_bwd_ref(q, k, v, o, do, lse, causal)
    for g, t, label in zip(got, want, ("dq", "dk", "dv")):
        _assert_bf16_close(g, t.float().numpy(), label)


@pytest.mark.parametrize("dtype, want", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "tf32x3")])
def test_backward_takes_the_route_of_its_dtype(dtype, want):
    """bf16 on the tensor cores, fp32 on them as split TF32: the forward's
    split, each route its own kernel source and launch count."""
    assert ops.BWD_ROUTES[dtype] == want == ops.ROUTES[dtype]
    kernel = ops.BWD_KERNELS[want]
    assert kernel.source == {"wgmma": "flash_attention_bwd_wgmma.cu",
                             "tf32x3": "flash_attention_bwd_tf32.cu"}[want]
    assert kernel is not ops.BWD_KERNELS["tf32x3" if want == "wgmma"
                                         else "wgmma"]
    assert set(ops.BWD_ROUTES) == set(ops.ROUTES)


@pytest.mark.parametrize("case", ["float16", "float64", "hd16", "hd96",
                                  "cpu", "meta"])
def test_backward_refuses_what_neither_route_takes(case):
    """Other dtypes and head_dims raise before a launch; so do tensors off
    the card, for both routes; no launch count moves.  head_dim 16 (the
    reduced configs') is taken: its CPU tensors are refused as off the
    card."""
    dt = torch.float16 if case == "float16" else (
        torch.float64 if case == "float64" else torch.bfloat16)
    hd = {"hd16": 16, "hd96": 96}.get(case, 64)
    device = "meta" if case == "meta" else "cpu"
    q = torch.zeros(1, 8, 4, hd, dtype=dt, device=device)
    kv = torch.zeros(1, 8, 2, hd, dtype=dt, device=device)
    lse = torch.zeros(1, 4, 8, device=device)
    before = {r: k.launches for r, k in ops.BWD_KERNELS.items()}
    err, match = {"float16": (TypeError, "float32 or bfloat16"),
                  "float64": (TypeError, "float32 or bfloat16"),
                  "hd96": (ValueError, "head_dim")}.get(
        case, (ValueError, "CUDA"))
    with pytest.raises(err, match=match):
        attention_bwd_cuda(q, kv, kv, q, q, lse)
    if case == "cpu":
        with pytest.raises(ValueError, match="CUDA"):
            attention_bwd_cuda(q.float(), kv.float(), kv.float(), q.float(),
                               q.float(), lse)
    assert {r: k.launches for r, k in ops.BWD_KERNELS.items()} == before


def test_fused_backward_refuses_rows_wider_than_its_kernel():
    """The fused-norm backward's kernel keeps a row's columns in registers
    and its ring: D above ``BWD_MAX_D`` raises before any launch."""
    x = torch.zeros(2, BWD_MAX_D + 8)
    with pytest.raises(ValueError, match="D up to"):
        fused_bwd_cuda(x, x, torch.ones(BWD_MAX_D + 8), x, None)
