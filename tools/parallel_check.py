#!/usr/bin/env python3
"""The parallel plane's phase on one CUDA card, forward and backward.

    python3 tools/parallel_check.py [--only mesh]

Runs ``chip_smoke.py``'s ``parallel`` phase alone (with ``--only mesh``
its last path alone: ``mesh_phase``, llama3.2-1b whole through 2 steps of
``make_train_step(model, cfg, mesh=)`` on a (data 2, model 2) mesh, its
AdamW state ZeRO-sharded, held to the one-process step): 4 ranks on the card
(``launch/mesh.py``, gloo through pinned host memory) driving the
llama3.2-1b GPipe pipeline (4 stages, 8 microbatches of 1024 tokens)
against its blocks in order, one dbrx-132b block's expert parallelism on
a (1, 4) and a (2, 2) mesh, and on the (2, 2) mesh at a capacity factor
of 0.5 that drops entries, against the local block, and llama3.2-1b's
context-parallel prefill (B 1 x S 4096 on (data 1, model 4)) against the
one-process model; then each path's backward: the pipeline's gradients
equal (``torch.equal``) to the blocks' in order, the EP block's within the
bf16 tolerance at their scale of the local block's, and the CP model's
mean cross-entropy gradients within 5e-2 of each gradient's largest
magnitude in the one-process model (the flash kernel), every oracle run on
its rank in turn.  Builds only the kernels the phase launches: flash
attention forward and backward (bf16 wgmma), the fused norm and its
backward and the ring combine.  Prints the card's name and power limit
first; the results go to ``smoke_out/parallel_check.json``.  On an H100
80GB HBM3 at 700 W it took 85.4 s: the build 12.7 s, the phase 72.7 s,
of which the pipeline's backward 19.7 s (its ranks' first backward), the
three EP backwards 1.8, 5.6 and 4.6 s, the CP backward 12.4 s.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("mesh",), default=None,
                    help="run only the mesh training step's path")
    args = ap.parse_args()
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build_all
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.fused_norm import ops as fn
    from repro_torch.kernels.ring_reduce import ops as ring

    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    t_start = time.perf_counter()
    build_all([fa.KERNELS["wgmma"], fa.BWD_KERNELS["wgmma"], fn.KERNEL,
               fn.BWD_KERNEL, ring.KERNEL])
    cs.OUT_DIR.mkdir(parents=True, exist_ok=True)
    walls = {"build": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    par_run = (cs.mesh_phase(0) if args.only == "mesh"
               else cs.parallel_phase(0))
    walls[args.only or "parallel"] = time.perf_counter() - t0
    walls["total"] = time.perf_counter() - t_start
    (cs.OUT_DIR / "parallel_check.json").write_text(json.dumps(
        dict(parallel=par_run, walls=walls), indent=1))
    cs.log("wall", ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))


if __name__ == "__main__":
    main()
