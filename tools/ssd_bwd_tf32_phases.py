#!/usr/bin/env python3
"""Where the fp32 (split TF32) SSD backward spends its time, by phase.

    python3 tools/ssd_bwd_tf32_phases.py

On one CUDA card: builds ``csrc/ssd_scan_bwd_tf32.cu`` as it is and in
variants that each leave one phase of its dx/dB or dC kernel out (``#if``
switches around the kernel's own statements, in a copy under
``kernels/build/``), then times the whole backward of every variant in
turns (``chip_smoke.in_turns``, behind a queued sleep) at the training
shape (B 8, L 512, H 48, P 64, chunk 256), N 128 and N 64.  A variant
computes garbage; its time less the kernel's is what the phase it drops
costs on the backward's path, latencies included.  A dropped product
still waits for its operand's load, so the ring runs as it does.  The
phases:
  * ``dxdb_g`` / ``dc_g``: the G^T (G) tiles, once for the head group;
  * ``dxdb_state``: B_s . dS^T and x_s . dS; ``dc_state``: dy_t . S_prev;
  * ``dxdb_split`` / ``dc_split``: the in-place split of dy_t (x_s);
  * ``dxdb_m`` / ``dc_m``: M^T = x_s . dy_t^T (M = dy_t . x_s^T);
  * ``dxdb_decay`` / ``dc_decay``: the decay, mask and dt of the scores;
  * ``dxdb_dx``, ``dxdb_db``, ``dc_dc``: the products into dx, dB, dC;
  * ``dxdb_loads_only`` / ``dc_loads_only``: all of that kernel's phases.
The backward as it is (``base``) is checked against ``ssd_bwd_ref``
first.

The switches find each phase by its statements' text, copied below
(``G_DXDB``, ``V``, ``XDS`` and the rest): an edit to one of those
statements in ``ssd_scan_bwd_tf32.cu``, whitespace or a local's name
included, must be made here too, or the tool stops and names the phase
whose statement it no longer finds.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

G_DXDB = ("      product<false>(g, wait_item(n), [&](Frag& hi, Frag& lo, "
          "int k4) {\n        raw_a(hi, lo, sm.bs, hf * kHalf, k4);\n"
          "      });\n")
G_DC = ("      product<false>(g, wait_item(n), [&](Frag& hi, Frag& lo, "
        "int k4) {\n        raw_a(hi, lo, sm.ct, hf * kHalf, k4);\n"
        "      });\n")
V = ("      product<false>(dxa, wait_item(n), [&](Frag& hi, Frag& lo, "
     "int k4) {\n        raw_a(hi, lo, sm.bs, hf * kHalf, k4);\n"
     "      });\n")
XDS = ("      product<false>(tmp, wait_item(n), [&](Frag& hi, Frag& lo, "
       "int k4) {\n        raw_a(hi, lo, sm.xs, 0, k4);\n      });\n")
DYS = ("      product<false>(tmp, wait_item(n), [&](Frag& hi, Frag& lo, "
       "int k4) {\n        raw_a(hi, lo, sm.dy, 0, k4);\n      });\n")
MT = ("      product<false>(m, dyt, [&](Frag& hi, Frag& lo, int k4) {\n"
      "        raw_a(hi, lo, sm.xs, 0, k4);\n"
      "      });                                        // M^T [s, t]\n")
M = ("      product<false>(m, xs, [&](Frag& hi, Frag& lo, int k4) {\n"
     "        raw_a(hi, lo, sm.dy, 0, k4);\n"
     "      });                                        // M [t, s]\n")
DECAY_DXDB = ("#pragma unroll\n      for (int i = 0; i < 8; ++i) {\n"
              "        const int blk = diag ? i / 2 - warp : 1;\n")
DECAY_DC = ("#pragma unroll\n      for (int k = 0; k < 8; ++k) {\n"
            "        const int blk = diag ? k / 2 - warp : -1;\n")
DX = ("      product<true>(dxa, wait_item(n), [&](Frag& hi, Frag& lo, "
      "int k4) {\n        acc_a(hi, lo, g, k4);\n      });\n")
DB0 = ("      product<true>(db[0], wait_item(n + 1), [&](Frag& hi, Frag& lo,"
       " int k4) {\n        acc_a(hi, lo, m, k4);\n      });\n")
DB1 = ("        product<true>(db[kH - 1], wait_item(n),\n"
       "                      [&](Frag& hi, Frag& lo, int k4) {\n"
       "                        acc_a(hi, lo, m, k4);\n"
       "                      });\n")
DC = ("        product<true>(dc[hf], wait_item(n), [&](Frag& hi, Frag& lo, "
      "int k4) {\n          acc_a(hi, lo, m, k4);\n        });\n")


def _loop_body(src: str, start: str) -> str:
    """The text of the decay loop that starts with ``start``: up to its
    closing brace at the loop's indentation."""
    i = src.index(start)
    j = src.index("\n      }\n", i) + len("\n      }\n")
    return src[i:j]


def phases(src: str) -> dict:
    """phase -> [(statement, what it becomes when the phase is left out)];
    a left-out product keeps waiting for its operand."""
    wait = "      (void)wait_item(n);\n"
    return {
        "dxdb_g": [(G_DXDB, wait)],
        "dxdb_state": [(V, wait), (XDS, wait)],
        "dxdb_split": [("      split_in_place(dyt);\n", "")],
        "dxdb_m": [(MT, "")],
        "dxdb_decay": [(_loop_body(src, DECAY_DXDB), "")],
        "dxdb_dx": [(DX, wait)],
        "dxdb_db": [(DB0, "      (void)wait_item(n + 1);\n"),
                    (DB1, "  " + wait)],
        "dc_g": [(G_DC, wait)],
        "dc_state": [(DYS, wait)],
        "dc_split": [("      split_in_place(xs);\n", "")],
        "dc_m": [(M, "")],
        "dc_decay": [(_loop_body(src, DECAY_DC), "")],
        "dc_dc": [(DC, "  " + wait)],
    }


def variant_source(src: str) -> str:
    """The kernel with each phase's statements inside ``#if
    SKIP_<PHASE>``: the replacement, else the statement."""
    for phase, edits in phases(src).items():
        flag = f"SKIP_{phase.upper()}"
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"FAIL: {phase}: the statement is not in "
                                 f"the kernel once:\n{old}")
            src = src.replace(old, f"#if {flag}\n{new}#else\n{old}#endif\n")
    return src


def main():
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        sys.exit(1)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import SSD_BWD_NAMES, in_turns, max_err, ssd_bwd_tol
    from chip_smoke import ssd_inputs
    from repro_torch.kernels import (BUILD_DIR, CSRC, NVCC_FLAGS, CudaKernel,
                                     find_nvcc)
    from repro_torch.kernels.ssd_scan import ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    text = (CSRC / "ssd_scan_bwd_tf32.cu").read_text()
    src = BUILD_DIR / "ssd_bwd_tf32_phases.cu"
    src.write_text(variant_source(text))
    names = list(phases(text))
    variants = {"base": [], **{p: [p] for p in names},
                **{f"{k}_loads_only": [p for p in names if p.startswith(k)]
                   for k in ("dxdb", "dc")}}
    procs = {}
    for name, skip in variants.items():
        flags = [f"-DSKIP_{p.upper()}=1" for p in skip]
        out = BUILD_DIR / f"ssd_bwd_tf32_phases_{name}.so"
        procs[name] = (out, subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, *flags, "-I", str(CSRC), "-o",
             str(out), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    kernels = {}
    this = ops.BWD_KERNELS["tf32x3"]
    for name, (out, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(f"FAIL: nvcc on the {name} variant:\n{log}")
            sys.exit(1)
        k = CudaKernel(this.source, this.symbol, this.argtypes)
        k._load(out)
        kernels[name] = k

    def call(k, args):
        def fn():
            ops.BWD_KERNELS["tf32x3"] = k
            try:
                return ops.ssd_bwd_cuda(*args)
            finally:
                ops.BWD_KERNELS["tf32x3"] = this
        return fn

    gen = torch.Generator(device="cuda").manual_seed(0)
    B, L, H, chunk = 8, 512, 48, 256
    for N in (128, 64):
        x, dt, A, Bm, Cm = ssd_inputs(gen, "cuda", B, L, H, N, "float32")
        dy = torch.randn(x.shape, generator=gen, device="cuda")
        args = (x, dt, A, Bm, Cm, dy, None, chunk)
        got = call(kernels["base"], args)()
        want = ops.ssd_bwd_ref(*args)
        err = max(max_err(g, w, "float32", ssd_bwd_tol(n, "float32", B, L,
                                                        chunk))
                  for n, g, w in zip(SSD_BWD_NAMES, got, want))
        del got, want
        times = in_turns({n: call(k, args) for n, k in kernels.items()}, 5,
                         behind_sleep=True)
        base = times.pop("base")
        print(f"[phases] ssd bwd [tf32x3] B{B} L{L} H{H} P64 N{N} chunk "
              f"{chunk} fp32: the backward {base:.4f} ms (max abs err "
              f"{err:.3e} against ssd_bwd_ref); without "
              + ", ".join(f"{n} {t:.4f} ({t - base:+.4f})"
                          for n, t in times.items()), flush=True)
        del x, dt, Bm, Cm, dy, args
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
