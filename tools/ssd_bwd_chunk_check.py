#!/usr/bin/env python3
"""The fp32 SSD backward's error at a chunk its kernels do not tile.

    python3 tools/ssd_bwd_chunk_check.py

On one CUDA card: the fp32 (tf32x3) SSD backward at B 8, L 1024, H 48 at
P 16, N 16 and a requested chunk 16 (which the kernels run at 64,
``kernel_chunk``), and at the published widths' P 64, N 64 chunk 64 and
P 64, N 128 chunk 256, each output against the plain version at the
requested chunk and at the kernel's, and the two plain versions against
each other: the max abs error, |want| where it falls, and how many
elements exceed ``chip_smoke.ssd_bwd_tol`` at each of the two chunks.
The comparison shows whose sum ddt's error is, the kernel's or the
blocking's (``chip_smoke.card_chunk``).  Then, at P 64, N 64, chunk 64 (B
8, L 1024, H 48), both fp32 backwards, the kernel's and the plain
version's, against the same gradients in float64 (autograd of the
chunked scan written in float64, :func:`ssd_fwd64`): each output's max
abs error from fp64, |fp64| where it falls, the largest |fp64|, the
elements past ``chip_smoke.ssd_bwd_tol`` against fp64, and ddt's error
beside max|A| and the error of A·da alone.  Prints the card's name and
power limit first.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CASES = [(8, 1024, 48, 16, 16, 16), (8, 1024, 48, 64, 64, 64),
         (8, 512, 48, 64, 128, 256)]
FP64_CASE = (8, 1024, 48, 64, 64, 64)      # B, L, H, P, N, chunk


def ssd_fwd64(x, dt, A, Bm, Cm, chunk: int):
    """``ssd_scan/ops.py::ssd_ref``'s chunked scan, every step in float64
    (L a multiple of ``chunk``, no initial state): (y, final state)."""
    import torch
    B, L, H, P = x.shape
    N, Q = Bm.shape[-1], chunk
    nc = L // Q
    xc = x.view(B, nc, Q, H, P)
    dtc = dt.view(B, nc, Q, H)
    Bc, Cc = Bm.view(B, nc, Q, N), Cm.view(B, nc, Q, N)
    cum = torch.cumsum(dtc * A, dim=2)
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    seg = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).masked_fill(
        ~tri[None, None, :, :, None], float("-inf"))
    scores = (torch.einsum("bctn,bcsn->bcts", Cc, Bc)[..., None]
              * torch.exp(seg) * dtc[:, :, None, :, :])
    y = torch.einsum("bctsh,bcshp->bcthp", scores, xc)
    last = cum[:, :, -1:, :]
    w = torch.exp(last - cum) * dtc
    S_c = torch.einsum("bcsh,bcsn,bcshp->bchpn", w, Bc, xc)
    decay = torch.exp(last[:, :, 0, :])
    S = x.new_zeros((B, H, P, N))
    starts = []
    for c in range(nc):
        starts.append(S)
        S = S * decay[:, c, :, None, None] + S_c[:, c]
    y = y + torch.einsum("bcth,bctn,bchpn->bcthp", torch.exp(cum), Cc,
                         torch.stack(starts, dim=1))
    return y.reshape(B, L, H, P), S


def fp64_check(cs, ops, gen):
    """Both fp32 backwards against float64 at ``FP64_CASE``."""
    import torch
    B, L, H, P, N, chunk = FP64_CASE
    x, dt, A, Bm, Cm = cs.ssd_inputs(gen, "cuda", B, L, H, N, "float32", P)
    dy = torch.randn(x.shape, generator=gen, device="cuda")
    runs = {"kernel (tf32x3)": ops.ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, None,
                                                chunk),
            "plain fp32": ops.ssd_bwd_ref(x, dt, A, Bm, Cm, dy, None, chunk)}
    ins = [t.double().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    y, _ = ssd_fwd64(*ins, chunk)
    want = torch.autograd.grad(y, ins, dy.double())
    cs.log("ssd_bwd", f"fp64 oracle at B{B} L{L} H{H} P{P} N{N} chunk "
           f"{chunk}; max|A| {float(A.abs().max()):.3e}")
    for tag, got in runs.items():
        for name, g, w in zip(cs.SSD_BWD_NAMES, got, want):
            d = (g.double() - w).abs()
            i = int(d.argmax())
            tol = cs.ssd_bwd_tol(name, "float32", B, L, cs.card_chunk(chunk))
            outside = int((d > tol["atol"] + tol["rtol"] * w.abs()).sum())
            cs.log("ssd_bwd", f"{tag} {name} against fp64: max "
                   f"{float(d.max()):.3e} at |fp64| "
                   f"{float(w.flatten()[i].abs()):.3e} (max |fp64| "
                   f"{float(w.abs().max()):.3e}); past ssd_bwd_tol "
                   f"{tol}: {outside}")
    k, r = runs["kernel (tf32x3)"], runs["plain fp32"]
    for name, a, b in zip(cs.SSD_BWD_NAMES, k, r):
        cs.log("ssd_bwd", f"kernel against plain fp32, {name}: max "
               f"{float((a - b).abs().max()):.3e}")


def main():
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build_all
    from repro_torch.kernels.ssd_scan import ops

    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build_all(list(ops.BWD_KERNELS.values()))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, L, H, P, N, chunk in CASES:
        x, dt, A, Bm, Cm = cs.ssd_inputs(gen, "cuda", B, L, H, N, "float32",
                                         P)
        dy = torch.randn(x.shape, generator=gen, device="cuda")
        kc = ops.kernel_chunk(chunk)
        got = ops.ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, None, chunk)
        at_req = ops.ssd_bwd_ref(x, dt, A, Bm, Cm, dy, None, chunk)
        at_kc = ops.ssd_bwd_ref(x, dt, A, Bm, Cm, dy, None, kc)
        for name, g, r, k in zip(cs.SSD_BWD_NAMES, got, at_req, at_kc):
            for tag, w in (("plain at the requested chunk", r),
                           ("plain at the kernel's chunk", k)):
                d = (g - w).abs()
                i = int(d.argmax())
                outside = []
                for rows in (chunk, kc):
                    tol = cs.ssd_bwd_tol(name, "float32", B, L, rows)
                    outside.append(int((d > tol["atol"]
                                        + tol["rtol"] * w.abs()).sum()))
                cs.log("ssd_bwd", f"P{P} N{N} chunk {chunk} (runs at {kc}) "
                       f"{name} against the {tag}: max {float(d.max()):.3e} "
                       f"at |want| {float(w.flatten()[i].abs()):.3e}; "
                       f"outside the tolerance at chunk {chunk}: "
                       f"{outside[0]}, at {kc}: {outside[1]}")
            cs.log("ssd_bwd", f"P{P} N{N} {name}: the plain versions at "
                   f"chunk {chunk} and {kc} differ by "
                   f"{float((r - k).abs().max()):.3e}")
        torch.cuda.empty_cache()
    fp64_check(cs, ops, gen)


if __name__ == "__main__":
    main()
