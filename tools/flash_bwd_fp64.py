#!/usr/bin/env python3
"""The fp32 (split TF32) flash-attention backward against an fp64
recompute, beside the plain fp32 version's own error.

    python3 tools/flash_bwd_fp64.py

On one CUDA card, at the training shapes of qwen2-72b (B 8, S 512, H 64
over KV 8, hd 128) and llama3-405b (H 128 over 8; B 8 and B 2): dq, dk and
dv of ``attention_bwd_cuda`` (route tf32x3) and of ``attention_bwd_ref``
(fp32, TF32 off) against the same backward computed in float64 from the
same q, k, v, dO and the forward's lse: the largest magnitude, the
kernel's largest difference from the plain version and the elements
outside chip_smoke.py's fp32 tolerance (rtol = atol = 3e-4), and each
one's largest difference from fp64.  This is how the dK/dV accumulation
of ``flash_attention_bwd_tf32.cu`` was found to drift with G·S (the
tensor cores' fp32 sums) and checked after its fix.  Prints the card's
name and power limit first; exits non-zero without a card.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(8, 512, 64, 8, 128), (8, 512, 128, 8, 128), (2, 512, 128, 8, 128)]


def bwd64(q, k, v, do, causal=True):
    """dq, dk, dv of causal GQA attention in float64, softmax recomputed."""
    import torch
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    sc = hd ** -0.5
    qf = q.reshape(B, S, KV, G, hd).double()
    dof = do.reshape(B, S, KV, G, hd).double()
    kf, vf = k.double(), v.double()
    s = torch.einsum("bskgh,btkh->bkgst", qf, kf) * sc
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, -1)
    of = torch.einsum("bkgst,btkh->bskgh", p, vf)
    delta = (dof * of).sum(-1).permute(0, 2, 3, 1)
    dp = torch.einsum("bskgh,btkh->bkgst", dof, vf)
    ds = p * (dp - delta[..., None]) * sc
    dq = torch.einsum("bkgst,btkh->bskgh", ds, kf).reshape(B, S, H, hd)
    dk = torch.einsum("bkgst,bskgh->btkh", ds, qf)
    dv = torch.einsum("bkgst,bskgh->btkh", p, dof)
    return dq, dk, dv


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this measurement needs one card")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build_all
    from repro_torch.kernels.flash_attention import ops

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    build_all([*ops.KERNELS.values(), *ops.BWD_KERNELS.values()])
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (B, S, H, KV, hd) in SHAPES:
        q, k, v, do = (torch.randn(B, S, n, hd, generator=gen, device="cuda")
                       for n in (H, KV, KV, H))
        o, lse = ops.attention_cuda(q, k, v, True, return_lse=True)
        got = ops.attention_bwd_cuda(q, k, v, o, do, lse, True)
        plain = ops.attention_bwd_ref(q, k, v, o, do, lse, True)
        exact = bwd64(q, k, v, do)
        for name, g, pl, ex in zip(("dq", "dk", "dv"), got, plain, exact):
            d = (g.double() - pl.double()).abs()
            bad = d > 3e-4 + 3e-4 * pl.double().abs()
            print(f"B{B} S{S} H{H} KV{KV} hd{hd} {name}: |max| "
                  f"{float(ex.abs().max()):.3f}; kernel - plain max "
                  f"{float(d.max()):.3e}, {int(bad.sum())} of {d.numel()} "
                  f"outside rtol = atol = 3e-4; against fp64: kernel "
                  f"{float((g.double() - ex).abs().max()):.3e}, plain fp32 "
                  f"{float((pl.double() - ex).abs().max()):.3e}", flush=True)
        del q, k, v, do, o, lse, got, plain, exact
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
