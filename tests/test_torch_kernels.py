"""The port's kernel modules against the JAX package, on the CPU.

On a CPU tensor each wrapper of ``repro_torch.kernels`` computes its plain
PyTorch version, the same function its CUDA kernel is held to on the card
(``chip_smoke.py``).  Here the plain versions meet the JAX oracles on the
same inputs, made from a seed with numpy:

* ``fused_ref`` against the Pallas ``fused_residual_rmsnorm`` (interpret
  mode) and the JAX ``fused_norm/ref.py`` oracle;
* ``attention_ref`` against the JAX ``flash_attention/ref.py`` oracle and
  the model's ``direct_attention``.  The Pallas flash kernel cannot be the
  oracle: its body calls ``pl.load``, which the installed JAX no longer
  has;
* the arithmetic of the bf16 tensor-core flash kernel, emulated here
  (``_tensor_core_attention``), against the same two oracles;
* the choice of kernel (route) by dtype, and what the CUDA wrapper
  refuses before it launches.

Tolerances are those of ``tests/test_kernels.py``: fp32 3e-4, bf16 5e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config

from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.fused_norm.ops import fused_residual_rmsnorm as jax_fused
from repro.kernels.fused_norm.ref import fused_ref as jax_fused_ref
from repro.models.attention import direct_attention as jax_direct
from repro_torch.kernels.flash_attention.ops import (attention_cuda,
                                                     attention_ref,
                                                     check_operands,
                                                     flash_attention, route)
from repro_torch.kernels.fused_norm.ops import (fused_ref,
                                                fused_residual_rmsnorm)
from repro_torch.kernels.ssd_scan.ops import ssd_scan

TOLS = {"float32": dict(rtol=3e-4, atol=3e-4),
        "bfloat16": dict(rtol=5e-2, atol=5e-2)}


def _pair(a: np.ndarray, dtype: str):
    """One float32 numpy array as a JAX and a torch array of ``dtype``;
    both round float32 -> bfloat16 to nearest even, so the inputs agree."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(256, 64), (512, 96), (128, 256)])
def test_fused_ref_matches_jax(rng, shape, dtype):
    R, D = shape
    xj, xt = _pair(rng.standard_normal((R, D)).astype(np.float32), dtype)
    rj, rt = _pair(rng.standard_normal((R, D)).astype(np.float32), dtype)
    sj, st = _pair(rng.standard_normal((D,)).astype(np.float32), dtype)
    y, h = fused_residual_rmsnorm(xt, rt, st)
    assert y.dtype == h.dtype == xt.dtype
    for yj, hj in (jax_fused(xj, rj, sj, block_r=128),
                   jax_fused_ref(xj, rj, sj)):
        np.testing.assert_allclose(_np(y), _np(yj), **TOLS[dtype])
        np.testing.assert_allclose(_np(h), _np(hj), **TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 100, 4, 4, 16), (2, 130, 4, 2, 64),
                                   (1, 77, 8, 2, 16), (1, 256, 8, 2, 64),
                                   (1, 130, 4, 4, 80)])
def test_attention_ref_matches_jax(rng, shape, causal, dtype):
    """shape (B, S, H, KV, hd): S off the 128 grid, hd 16/64/80, G 1/2/4."""
    B, S, H, KV, hd = shape
    qj, qt = _pair(rng.standard_normal((B, S, H, hd)).astype(np.float32), dtype)
    kj, kt = _pair(rng.standard_normal((B, S, KV, hd)).astype(np.float32), dtype)
    vj, vt = _pair(rng.standard_normal((B, S, KV, hd)).astype(np.float32), dtype)
    o = flash_attention(qt, kt, vt, causal=causal)
    assert o.dtype == qt.dtype and o.shape == qt.shape
    np.testing.assert_allclose(_np(o), _np(attention_ref(qt, kt, vt, causal)),
                               rtol=0, atol=0)
    for ref in (jax_attention_ref(qj, kj, vj, causal=causal),
                jax_direct(qj, kj, vj, causal=causal)):
        np.testing.assert_allclose(_np(o), _np(ref), **TOLS[dtype])


def test_fused_ref_is_the_unfused_math(rng):
    """y is RMSNorm of h = x + res with fp32 statistics."""
    x = torch.from_numpy(rng.standard_normal((8, 32)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((8, 32)).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal((32,)).astype(np.float32))
    y, h = fused_ref(x, r, s, eps=1e-6)
    hh = x + r
    want = hh / torch.sqrt((hh * hh).mean(-1, keepdim=True) + 1e-6) * s
    torch.testing.assert_close(h, hh)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("op", ["fused", "flash", "ssd"])
def test_wrappers_refuse_other_devices(op, monkeypatch):
    """Only CPU tensors take the plain version.  Meta tensors take the
    meta route: the kernel's own checks, refusing what the kernel refuses
    (here a width it has no instance for: flash head_dim 24, the SSD scan's
    chunk 0), and empty meta outputs, with
    neither a launch nor the plain version; CUDA tensors launch or raise
    (``test_attention_cuda_refuses_what_the_kernels_do_not_take``)."""
    import repro_torch.kernels.flash_attention.ops as fa_ops
    import repro_torch.kernels.fused_norm.ops as fn_ops
    import repro_torch.kernels.ssd_scan.ops as ssd_ops
    for mod, ref in ((fn_ops, "fused_ref"), (fa_ops, "attention_ref"),
                     (ssd_ops, "ssd_ref")):
        monkeypatch.setattr(mod, ref, None)
    if op == "fused":
        x = torch.empty(4, 8, device="meta", dtype=torch.float16)
        with pytest.raises(TypeError, match="float32 or"):
            fused_residual_rmsnorm(x, x, torch.empty(8, device="meta"))
        x = torch.empty(4, 8, device="meta")
        y, h = fused_residual_rmsnorm(x, x, torch.empty(8, device="meta"))
        assert y.is_meta and h.is_meta and y.shape == h.shape == x.shape
    elif op == "flash":
        q = torch.empty(1, 4, 2, 24, device="meta")
        with pytest.raises(ValueError, match="head_dim"):
            flash_attention(q, q, q)
        q = torch.empty(1, 4, 2, 64, device="meta")
        o = flash_attention(q, q, q)
        assert o.is_meta and o.shape == q.shape
    else:
        x = torch.empty(1, 4, 2, 64, device="meta")
        bm = torch.empty(1, 4, 128, device="meta")
        args = (torch.empty(1, 4, 2, device="meta"),
                torch.empty(2, device="meta"), bm, bm)
        with pytest.raises(ValueError, match="chunk"):
            ssd_scan(x, *args, chunk=0)
        y, state = ssd_scan(x, *args, chunk=256)
        assert y.is_meta and y.shape == x.shape
        assert state.shape == (1, 2, 64, 128)


def _tensor_core_attention(q, k, v, causal, block_k=128):
    """The arithmetic of ``csrc/flash_attention_wgmma.cu`` on bf16 q/k/v:
    fp32 scores of the bf16 products, scaled after the product; 128-key
    tiles with a running max and sum per row; P rounded to bf16 before
    P.V, the sum of P kept in fp32; o / l rounded to bf16.  Key tiles past
    a row's causal frontier add exact zeros, as the kernel's stopped loop
    adds nothing."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    qf = q.float()
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    scale = hd ** -0.5
    o = torch.zeros(B, S, H, hd)
    m = torch.full((B, S, H), -1e30)
    l = torch.zeros(B, S, H)
    qpos = torch.arange(S)[:, None]
    for t0 in range(0, S, block_k):
        kt, vt = kf[:, t0:t0 + block_k], vf[:, t0:t0 + block_k]
        s = torch.einsum("bshd,bthd->bsht", qf, kt)
        if causal:
            keys = torch.arange(t0, t0 + kt.shape[1])[None, :]
            s = torch.where((keys > qpos)[None, :, None, :],
                            torch.full_like(s, -1e30), s)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp((m - m_new) * scale)
        p = torch.exp((s - m_new[..., None]) * scale)
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum(
            "bsht,bthd->bshd", p.bfloat16().float(), vt)
        m = m_new
    return (o / l[..., None]).bfloat16()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 80, 128])
@pytest.mark.parametrize("S", [1, 100, 1000])
def test_tensor_core_softmax_matches_jax(rng, S, hd, causal):
    """The bf16 kernel's one extra rounding (P to bf16 before P.V) stays
    inside the bf16 tolerance of both JAX oracles."""
    B, H, KV = 1, 4, 2
    qj, qt = _pair(rng.standard_normal((B, S, H, hd)).astype(np.float32),
                   "bfloat16")
    kj, kt = _pair(rng.standard_normal((B, S, KV, hd)).astype(np.float32),
                   "bfloat16")
    vj, vt = _pair(rng.standard_normal((B, S, KV, hd)).astype(np.float32),
                   "bfloat16")
    o = _tensor_core_attention(qt, kt, vt, causal)
    for ref in (jax_attention_ref(qj, kj, vj, causal=causal),
                jax_direct(qj, kj, vj, causal=causal),
                attention_ref(qt, kt, vt, causal)):
        np.testing.assert_allclose(_np(o), _np(ref), **TOLS["bfloat16"])


@pytest.mark.parametrize("dtype, want", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "tf32x3")])
def test_llama_prefill_takes_the_route_of_its_dtype(dtype, want):
    """The serving prefill's shape (B 8, S 1024, 32 heads over 8, hd 64):
    bf16 on the tensor cores, fp32 on them as split TF32."""
    cfg = get_config("llama3.2-1b")
    hd = cfg.head_dim
    assert route(dtype, hd) == want
    q = torch.empty(8, 1024, cfg.num_heads, hd, dtype=dtype, device="meta")
    kv = torch.empty(8, 1024, cfg.num_kv_heads, hd, dtype=dtype,
                     device="meta")
    assert check_operands(q, kv, kv) == want


def _unaligned(shape, dtype):
    """A contiguous tensor whose data starts 2 elements past an
    allocation, so not on a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 2, dtype=dtype)[2:].view(shape)


@pytest.mark.parametrize("case", ["hd16", "hd96", "float16", "mixed",
                                  "transposed", "unaligned", "cpu"])
def test_attention_cuda_refuses_what_the_kernels_do_not_take(case):
    bf = torch.bfloat16
    q = torch.zeros(1, 8, 4, 64, dtype=bf)
    kv = torch.zeros(1, 8, 2, 64, dtype=bf)
    args, err, match = (q, kv, kv), ValueError, None
    if case in ("hd16", "hd96"):
        # head_dim 16 (the reduced configs') is taken: only the CPU
        # tensors are refused; 96 is taken by no kernel
        hd = int(case[2:])
        args = (torch.zeros(1, 8, 4, hd, dtype=bf),
                torch.zeros(1, 8, 2, hd, dtype=bf),
                torch.zeros(1, 8, 2, hd, dtype=bf))
        match = "head_dim" if hd == 96 else "CUDA tensors"
    elif case == "float16":
        args, err, match = (q.half(), kv.half(), kv.half()), TypeError, "float16"
    elif case == "mixed":
        args, err, match = (q, kv.float(), kv), TypeError, "one dtype"
    elif case == "transposed":
        qt = torch.zeros(1, 4, 8, 64, dtype=bf).transpose(1, 2)
        args, match = (qt, kv, kv), "contiguous"
    elif case == "unaligned":
        args, match = (_unaligned((1, 8, 4, 64), bf), kv, kv), "aligned"
    else:
        match = "CUDA tensors"
    with pytest.raises(err, match=match):
        attention_cuda(*args)
