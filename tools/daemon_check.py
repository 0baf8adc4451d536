#!/usr/bin/env python3
"""The FLARE daemon's spill plane and clock on one CUDA card, in ~2 min.

    python3 tools/daemon_check.py

Runs ``chip_smoke.py``'s daemon checks on llama3.2-1b alone: a daemon
attached first and kept to the end; the serving path with its FCS v2
(zlib) rotated spill, an in-process sink and batch sink, and its traced
generate's wall with each spill codec in turns; the training path (12
steps) with its FCS v1 spill; each spill read back against the sinks
(``check_spill``) and through the trace checks; then the long-attached
daemon's fused-norm spans (``long_attach_check``).  Prints the card's name
and power limit first; the traces go to ``smoke_out/``.
"""
from __future__ import annotations

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
    from repro_torch.store import have_zstd

    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    cs.log("daemon", f"have_zstd() {have_zstd()}")
    t_start = time.perf_counter()
    long_daemon, long_events, t_long = cs.long_attach_daemon()
    build_all([fa.KERNELS["wgmma"], fa.BWD_KERNELS["wgmma"], fn.KERNEL,
               fn.BWD_KERNEL])
    cs.OUT_DIR.mkdir(parents=True, exist_ok=True)
    arch = cs.SPILL_ARCH
    for old in cs.OUT_DIR.glob(f"serve_trace_{arch}*"):
        old.unlink()
    tap = cs.SpillTap()
    run = cs.serve(arch, {}, 0, cs.OUT_DIR / f"serve_trace_{arch}.fcs2",
                   per_call=True, tap=tap)
    events, _ = cs.check_spill(f"{arch} serve, FCS v2 (zlib) rotated",
                               run["spill"], tap, cs.SERVE_SPILL_PIECES)
    cs.check_trace(arch, events, run["new"])
    path = cs.OUT_DIR / f"train_trace_{arch}.fcs"
    path.unlink(missing_ok=True)
    tap = cs.SpillTap()
    n0 = long_daemon.telemetry.value("daemon.anchors")
    run = cs.train(arch, 0, path, with_overhead=False, tap=tap)
    anchors = {arch: long_daemon.telemetry.value("daemon.anchors") - n0}
    events, _ = cs.check_spill(f"{arch} train, FCS v1", run["spill"], tap)
    cs.check_train_trace(arch, events, cs.TRAIN_STEPS)
    cs.long_attach_check(long_daemon, long_events, t_long, anchors)
    cs.log("wall", f"{time.perf_counter() - t_start:.1f} s")


if __name__ == "__main__":
    main()
