#!/usr/bin/env python3
"""The FLARE fleet path on one CUDA card, in ~3 min.

    python3 tools/fleet_check.py

Runs ``chip_smoke.py``'s ring path (4 gloo ranks on the card, for the
hang drills' traces), its ``diagnose`` phase with the drilled jobs
streaming live into the fleet, and its ``fleet`` phase: the fail-slow
drill with the spawned co-runner, the live streams against the batch
engine, the serial, thread and process replays of the spills, the trace
archive and the ring's hangs through the fleet.  Builds only the kernels
these paths launch.  Prints the card's name and power limit first; the
phases' results go to ``smoke_out/fleet_check.json``.
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
    from repro_torch.kernels.padded_matmul import ops as mm
    from repro_torch.kernels.ring_reduce import ops as ring

    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    t_start = time.perf_counter()
    build_all([fa.KERNELS["wgmma"], fa.BWD_KERNELS["wgmma"], fn.KERNEL,
               fn.BWD_KERNEL, mm.KERNELS["wgmma"], ring.KERNEL])
    cs.OUT_DIR.mkdir(parents=True, exist_ok=True)
    trace_dir = cs.OUT_DIR / "ring_traces"
    walls = {}
    t0 = time.perf_counter()
    ring_run = cs.ring_path(0, trace_dir)
    walls["ring"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fleet = cs.FleetLive()
    diagnosis = cs.diagnose_phase(0, ring_run, trace_dir, fleet)
    walls["diagnose"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fleet_run = cs.fleet_phase(0, fleet, trace_dir, diagnosis)
    walls["fleet"] = time.perf_counter() - t0
    walls["total"] = time.perf_counter() - t_start
    (cs.OUT_DIR / "fleet_check.json").write_text(json.dumps(
        dict(diagnose=diagnosis, fleet=fleet_run, walls=walls), indent=1))
    cs.log("wall", ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))


if __name__ == "__main__":
    main()
