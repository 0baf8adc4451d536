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
blocking's (``chip_smoke.card_chunk``).  Prints the card's name and power
limit first.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CASES = [(8, 1024, 48, 16, 16, 16), (8, 1024, 48, 64, 64, 64),
         (8, 512, 48, 64, 128, 256)]


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


if __name__ == "__main__":
    main()
