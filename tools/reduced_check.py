#!/usr/bin/env python3
"""The widths the JAX package runs, and its reduced zoo, on one CUDA card.

    python3 tools/reduced_check.py [--only widths,reduced] [--seed N]

Runs ``chip_smoke.py``'s checks of them alone, after building the
kernels they launch:
  * ``widths``: the flash forward and backward on both routes at the JAX
    package's sweep (``FLASH_REF_SWEEP``) and at the narrow head_dims
    (``FLASH_NARROW`` and the narrow ``FLASH_BWD_CASES``), timed at hd 8,
    16 and 32 beside llama's hd 64 (``FLASH_TIMED``, ``FLASH_BWD_TIMED``);
    then ``check_widths``: the SSD scan's and the fused norm's sweeps, the
    SSD forward and backward at head_dim 8 to 32 and state 8 to 128 on
    both routes, the widths no kernel takes refused, and the SSD scan
    timed at P 16 N 16;
  * ``reduced``: ``reduced_phase``, every arch's reduced config served,
    trained (3 bf16 steps and one fp32 step) and its fp32 prefill held to
    the CPU's, traced, each kernel launched and no plain version called;
    then ``python -m repro_torch.launch.serve --reduced`` and ``...train
    --reduced`` in processes of their own.
Prints the card's name and power limit first; exits non-zero on a
mismatch.  The traces go to ``smoke_out/reduced/``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def narrow_flash(cs, gen) -> dict:
    """``check_flash`` and ``check_flash_bwd`` on their narrow shapes and
    llama's timed one (the first, which the hd 64 summary needs)."""
    cs.FLASH_SHAPES, cs.FLASH_EDGES, cs.FLASH_GROUPS = [], [], []
    cs.FLASH_TIMED = [cs.FLASH_TIMED[0]] + [
        sh for sh in cs.FLASH_TIMED if sh[4] < 64]
    cs.FLASH_BWD_CASES = [c for c in cs.FLASH_BWD_CASES
                          if c[0] in cs.FLASH_REF_SWEEP or c[0][4] < 64]
    cs.FLASH_BWD_TIMED = [cs.FLASH_BWD_TIMED[0]] + [
        sh for sh in cs.FLASH_BWD_TIMED if sh[4] < 64]
    fwd, _ = cs.check_flash(gen, "cuda")
    bwd, _ = cs.check_flash_bwd(gen, "cuda")
    return {"forward": list(fwd.values()), "backward": list(bwd.values())}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="widths,reduced")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    parts = set(args.only.split(","))
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build_all
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.fused_norm import ops as fn
    from repro_torch.kernels.ssd_scan import ops as ssd

    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    kernels = [*fa.KERNELS.values(), *fa.BWD_KERNELS.values(), fn.KERNEL,
               fn.BWD_KERNEL, *ssd.KERNELS.values(),
               *ssd.BWD_KERNELS.values()]
    build_all(kernels)
    cs.log("build", f"built {len(kernels)} kernels in "
           f"{time.perf_counter() - t0:.1f} s")
    for k in kernels:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                cs.log("build", f"{k.source}: {line.strip()}")
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    if "widths" in parts:
        t = time.perf_counter()
        out["flash"] = narrow_flash(cs, gen)
        summaries, cases = cs.check_widths(gen, "cuda")
        out["ssd"] = list(summaries.values())
        out["cases"] = cases
        cs.log("wall", f"widths {time.perf_counter() - t:.1f} s")
    if "reduced" in parts:
        t = time.perf_counter()
        out["reduced"] = cs.reduced_phase(args.seed)
        cs.log("wall", f"reduced {time.perf_counter() - t:.1f} s")
    cs.OUT_DIR.mkdir(parents=True, exist_ok=True)
    (cs.OUT_DIR / "reduced_check.json").write_text(
        json.dumps(out, indent=1, default=str))
    cs.log("wall", f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True}), flush=True)


if __name__ == "__main__":
    main()
