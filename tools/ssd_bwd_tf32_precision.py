#!/usr/bin/env python3
"""Where the fp32 SSD backward's ddt loses precision on the tensor cores.

    python3 tools/ssd_bwd_tf32_precision.py

On one CUDA card, at B 8, L 1024, H 48, P 64, N 64, chunk 64: the
arithmetic of ``ssd_scan_bwd_tf32.cu`` written in PyTorch (every product
as the three TF32 products hi·lo + lo·hi + hi·hi, run by cuBLAS on the
tensor cores with TF32 on, the kernels' decays and their order of sums),
in variants that each take one group of products at full fp32 (TF32 off,
the FP32 pipes), beside the kernel, the plain fp32 version and float64
(``ssd_bwd_chunk_check.ssd_fwd64``): each one's ddt and dA error from
fp64, and ddt's largest error by head beside |A|.  It shows which
products' rounding reaches ddt through the reverse cumsum of da, times A.
Prints the card's name and power limit first.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (8, 1024, 48, 64, 64, 64)       # B, L, H, P, N, chunk
# variants: the products taken at full fp32 (the rest as split TF32)
VARIANTS = {"tf32x3 everywhere": (),
            "G, M at fp32 (the scores)": ("G", "M"),
            "every product at fp32": ("G", "M", "state", "dx")}


def tf32(x):
    """fp32 -> the nearest tf32 (``cvt.rna.tf32.f32``), as fp32."""
    import torch
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (u + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32)
    return r.view(torch.float32).reshape(x.shape)


def product(eq: str, a, b, full: bool):
    """einsum ``eq`` of fp32 ``a`` and ``b``: at fp32 on the FP32 pipes
    (``full``), else as split TF32 on the tensor cores."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = not full
    if full:
        return torch.einsum(eq, a, b)
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return (torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)
            + torch.einsum(eq, ah, bh))


def emulated(x, dt, A, Bm, Cm, dy, chunk: int, full: tuple):
    """(dx, ddt, dA) by the kernel's arithmetic (no initial state, no final
    cotangent, L a multiple of the chunk; the state and sum kernels' order
    of sums), the products named in ``full`` at fp32."""
    import torch
    B, L, H, P = x.shape
    N, Q = Bm.shape[-1], chunk
    nc = L // Q
    xc, dyc = x.view(B, nc, Q, H, P), dy.view(B, nc, Q, H, P)
    dtc = dt.view(B, nc, Q, H)
    Bc, Cc = Bm.view(B, nc, Q, N), Cm.view(B, nc, Q, N)
    cum = torch.cumsum((dtc * A).double(), dim=2)
    last = cum[:, :, -1:, :]
    e = torch.exp((last - cum).float())
    w = e * dtc
    ecum = torch.exp(cum.float())
    decay = torch.exp(last[:, :, 0, :].float())
    st = "state" in full
    S_c = product("bcshn,bcshp->bchpn", Bc[:, :, :, None, :] * w[..., None],
                  xc, st)
    S = x.new_zeros((B, H, P, N))
    starts = []
    for c in range(nc):
        starts.append(S)
        S = S * decay[:, c, :, None, None] + S_c[:, c]
    S_prev = torch.stack(starts, dim=1)
    U = product("bcthn,bcthp->bchpn", Cc[:, :, :, None, :] * ecum[..., None],
                dyc, st)
    dS = x.new_zeros((B, H, P, N))
    ends = [None] * nc
    for c in reversed(range(nc)):
        ends[c] = dS
        dS = dS * decay[:, c, :, None, None] + U[:, c]
    dS_end = torch.stack(ends, dim=1)
    dss = (dS_end * S_prev).sum(dim=(-2, -1))
    G = product("bctn,bcsn->bcts", Cc, Bc, "G" in full)[..., None]
    M = product("bcthp,bcshp->bctsh", dyc, xc, "M" in full)
    blk = torch.arange(Q, device=x.device) // 16
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()[
        None, None, :, :, None]
    same = (blk[:, None] == blk[None, :])[None, None, :, :, None]
    below = (blk[:, None] > blk[None, :])[None, None, :, :, None]
    zero = torch.zeros((), device=x.device)
    direct = torch.exp((cum[:, :, :, None, :] - cum[:, :, None, :, :])
                       .float())
    cref = cum[:, :, blk * 16 + 15]
    LX = torch.where(same & tri, direct, torch.where(
        below, torch.exp((cum[:, :, :, None, :] - cref[:, :, None, :, :])
                         .float()) * torch.exp((cref - cum).float())[
                             :, :, None], zero))
    cref = cum[:, :, blk * 16]
    dts = dtc[:, :, None, :, :]
    LD = torch.where(same & tri, direct * dts, torch.where(
        below, torch.exp((cum - cref).float())[:, :, :, None]
        * (torch.exp((cref[:, :, :, None, :] - cum[:, :, None, :, :])
                     .float()) * dts), zero))
    GL = G * LX
    V = product("bchpn,bcsn->bcshp", dS_end, Bc, st)
    dx = w[..., None] * V + product("bctsh,bcthp->bcshp", GL * dts, dyc,
                                    "dx" in full)
    Z = product("bcthp,bchpn->bcthn", dyc, S_prev, st)
    ddt_intra = (GL * M).sum(dim=2)
    ddt_state = e * torch.einsum("bcshp,bcshp->bcsh", xc, V)
    row = (G * LD * M).sum(dim=3)
    E = ecum * torch.einsum("bcthn,bctn->bcth", Z, Cc)
    dcum = (row + E) - dtc * (ddt_intra + ddt_state)
    dcum[:, :, -1] += decay * dss + (dtc * ddt_state).sum(dim=2)
    da = torch.flip(torch.cumsum(torch.flip(dcum.double(), [2]), dim=2), [2])
    ddt = ddt_intra + ddt_state + (A.double() * da).float()
    dA = (dtc.double() * da).sum(dim=(0, 1, 2))
    return dx.reshape(B, L, H, P), ddt.reshape(B, L, H), dA.float()


def main():
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    import chip_smoke as cs
    from repro_torch.kernels import build_all
    from repro_torch.kernels.ssd_scan import ops
    from ssd_bwd_chunk_check import ssd_fwd64

    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    build_all([ops.BWD_KERNELS["tf32x3"]])
    B, L, H, P, N, chunk = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, dt, A, Bm, Cm = cs.ssd_inputs(gen, "cuda", B, L, H, N, "float32", P)
    dy = torch.randn(x.shape, generator=gen, device="cuda")
    ins = [t.double().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    y, _ = ssd_fwd64(*ins, chunk)
    want = torch.autograd.grad(y, ins, dy.double())
    del y, ins
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {"kernel": ops.ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, None, chunk),
            "plain fp32": ops.ssd_bwd_ref(x, dt, A, Bm, Cm, dy, None, chunk)}
    runs = {k: (v[0], v[1], v[2]) for k, v in runs.items()}
    for tag, full in VARIANTS.items():
        runs[f"emulated, {tag}"] = emulated(x, dt, A, Bm, Cm, dy, chunk,
                                            full)
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = cs.ssd_bwd_tol("ddt", "float32", B, L, cs.card_chunk(chunk))
    for tag, (dx, ddt, dA) in runs.items():
        d = (ddt.double() - want[1]).abs()
        by_head = d.amax(dim=(0, 1))
        outside = int((d > tol["atol"] + tol["rtol"] * want[1].abs()).sum())
        dx_err = float((dx.double() - want[0]).abs().max())
        dA_err = float((dA.double() - want[2]).abs().max())
        cs.log("ssd_bwd", f"{tag}: dx {dx_err:.3e}, ddt {float(d.max()):.3e} "
               f"({outside} past {tol}), dA {dA_err:.3e} from fp64; "
               f"ddt's max by head at |A| 1, 4.2, 8.3, 12.3, 16: "
               + ", ".join(f"{float(by_head[i]):.2e}"
                           for i in (0, 12, 24, 36, 47)))


if __name__ == "__main__":
    main()
