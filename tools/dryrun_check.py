#!/usr/bin/env python3
"""The dry-run's phase on one CUDA card, in ~2 min.

    python3 tools/dryrun_check.py

Runs ``chip_smoke.py``'s ``dryrun`` phase alone: every cell of the dry-run
(``python -m repro_torch.launch.dryrun --all`` and ``--all --multi-pod``)
on meta tensors, then the op analysis on one chip of llama3.2-1b's
training step and prefill against their medians timed on the card.
Builds only the kernels those two paths launch: flash attention forward
and backward (bf16 wgmma) and the fused norm forward and backward.  Prints
the card's name and power limit first; the results go to
``smoke_out/dryrun_check.json``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build_all
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.fused_norm import ops as fn

    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    t_start = time.perf_counter()
    build_all([fa.KERNELS["wgmma"], fa.BWD_KERNELS["wgmma"], fn.KERNEL,
               fn.BWD_KERNEL])
    cs.OUT_DIR.mkdir(parents=True, exist_ok=True)
    walls = {"build": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    run = cs.dryrun_phase(0, cs.start_dryrun_cells())
    walls["dryrun"] = time.perf_counter() - t0
    walls["total"] = time.perf_counter() - t_start
    (cs.OUT_DIR / "dryrun_check.json").write_text(json.dumps(
        dict(dryrun=run, walls=walls), indent=1))
    cs.log("wall", ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))


if __name__ == "__main__":
    main()
