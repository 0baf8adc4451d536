#!/usr/bin/env python3
"""The FLARE cluster simulator's phase on one CUDA card, in ~2 min.

    python3 tools/sim_check.py

Runs ``chip_smoke.py``'s ``simulate`` phase alone: the port's scenario
matrix at the H100's ceilings held to the floors of
``benchmarks/scenarios.py``, the 1024-rank drills of
``examples/torch_diagnose_cluster_sim.py``, and one resident fleet
service (a spawned process without torch) fed at once by four simulated
1024-rank jobs and svc-m, a traced llama3.2-1b job on the card streaming
through its daemon's live sink.  svc-m's healthy profile comes from the
``diagnose`` phase's Case-3 jobs, which run first (``case3_drill``).
Builds only the kernels svc-m launches: flash attention forward and
backward (bf16 wgmma) and the fused norm forward and backward.  Prints
the card's name and power limit first; the results go to
``smoke_out/sim_check.json``.
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
    fleet = cs.FleetLive()
    case3 = cs.case3_drill(0, fleet)
    walls["case3"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim_run = cs.simulate_phase(0, fleet)
    walls["simulate"] = time.perf_counter() - t0
    walls["total"] = time.perf_counter() - t_start
    (cs.OUT_DIR / "sim_check.json").write_text(json.dumps(
        dict(case3=case3, simulate=sim_run, walls=walls), indent=1))
    cs.log("wall", ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))


if __name__ == "__main__":
    main()
