#!/usr/bin/env python3
"""Where the fp32 (split TF32) SSD-scan kernel spends its time, by phase.

    python3 tools/ssd_tf32_phases.py

On one CUDA card: builds ``csrc/ssd_scan_tf32.cu`` as it is and in
variants that each leave one phase out (``#if`` switches wrapped around
the kernel's own sections in a copy under ``kernels/build/``), then times
every variant in turns (``chip_smoke.in_turns``) at the serving shape (B 8,
L 1024, H 48, P 64, chunk 256) at N 128 and N 64.  A variant computes
garbage; its time less the kernel's is what the phase it drops costs on
the kernel's path, latencies included.  The phases:
  * ``xt``: the split of x_s^T from the raw x tile;
  * ``g``: the products G = C_t . B_s^T;
  * ``state``: the state update's A fragments and products;
  * ``inter``: the chunk-start state's split into shared memory and
    C_t . S^T;
  * ``decay``: the scores' decay and mask;
  * ``scores_y``: the decay, the scores' split and y += scores . x_s;
  * ``loads_only``: all of these, leaving the loads, the cumulative decay,
    the barriers and the stores.
The kernel as it is (``base``) is checked against ``ssd_ref`` first.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# phase -> (first line of the section, the text that ends it), as in
# csrc/ssd_scan_tf32.cu
SECTIONS = {
    "xt": ("#pragma unroll 2\n          for (int j = 0; j < 8; ++j) {",
           "          fence_proxy_async();\n          __syncthreads();\n"
           "          if (tid == 0) load_x(u + 1);"),
    "g": ("#pragma unroll\n        for (int hh = 0; hh < kHalves; ++hh) {\n"
          "          const int sg = (u * kHalves + hh) % kStages;\n"
          "          const uint64_t dbh",
          "        wgmma_commit();\n        wgmma_wait<0>();\n"
          "        fence_regs(g);"),
    "state": ("#pragma unroll\n          for (int hh = 0; hh < kHalves; ++hh) {"
              "\n            const int sg = (u * kHalves + hh) % kStages;\n"
              "            const float* bh",
              "        }\n        // the B_s items of this pair are done with"),
    "inter": ("#pragma unroll\n      for (int hh = 0; hh < kHalves; ++hh) {\n"
              "        __syncthreads();  // every warp is done with the "
              "previous S half",
              "#pragma unroll\n      for (int i = 0; i < 8; ++i) {\n"
              "        yacc[4 * i] *= sm.ecum[tl0];"),
    # scores_y before decay, which it contains: the switches nest
    "scores_y": ("        // ---- scores = G o exp",
                 "\n      }\n\n      // y rows < L"),
    "decay": ("        // ---- scores = G o exp",
              "        // ---- y += scores . x_s"),
}
VARIANTS = {"base": [], **{p: [p] for p in SECTIONS},
            "loads_only": ["xt", "g", "state", "inter", "scores_y"]}


def variant_source(src: str) -> str:
    """The kernel with each section inside ``#if !SKIP_<PHASE>``."""
    for phase, (start, end) in SECTIONS.items():
        i = src.index(start)
        j = src.index(end, i)
        flag = f"SKIP_{phase.upper()}"
        body = src[i:j] if src[i:j].endswith("\n") else src[i:j] + "\n"
        src = src[:i] + f"#if !{flag}\n" + body + "#endif\n" + src[j:]
    return src


def main():
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        sys.exit(1)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import in_turns, max_err, ssd_inputs
    from repro_torch.kernels import BUILD_DIR, CSRC, NVCC_FLAGS, find_nvcc
    from repro_torch.kernels.ssd_scan import ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / "ssd_tf32_phases.cu"
    src.write_text(variant_source((CSRC / "ssd_scan_tf32.cu").read_text()))
    procs = {}
    for name, phases in VARIANTS.items():
        flags = [f"-DSKIP_{p.upper()}=1" for p in phases]
        out = BUILD_DIR / f"ssd_tf32_phases_{name}.so"
        procs[name] = (out, subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, *flags, "-I", str(CSRC), "-o",
             str(out), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (out, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(f"FAIL: nvcc on the {name} variant:\n{log}")
            sys.exit(1)
        fn = ctypes.CDLL(str(out)).ssd_scan_tf32_launch
        fn.argtypes, fn.restype = ops._TF32_ARGS, ctypes.c_int
        fns[name] = fn

    gen = torch.Generator(device="cuda").manual_seed(0)
    B, L, H, chunk = 8, 1024, 48, 256
    for N in (128, 64):
        x, dt, A, Bm, Cm = ssd_inputs(gen, "cuda", B, L, H, N, "float32")
        y = torch.empty_like(x)
        st = torch.empty(B, H, 64, N, device="cuda")
        bp, cp = (torch.empty(s, device="cuda")
                  for s in ops.tf32_scratch(B, L, N).values())
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        def call(fn):
            args = [ctypes.c_void_p(t.data_ptr()) if t is not None else None
                    for t in (x, dt, A, Bm, Cm, None, y, st, bp, cp)]
            return lambda: fn(*args, B, L, H, 64, N, chunk, stream)
        if call(fns["base"])() != 0:
            print("FAIL: the kernel did not launch")
            sys.exit(1)
        yr, sr = ops.ssd_ref(x, dt, A, Bm, Cm, chunk)
        torch.cuda.synchronize()
        err = max(max_err(y, yr, "float32"), max_err(st, sr, "float32"))
        del yr, sr
        times = in_turns({n: call(f) for n, f in fns.items()}, 10)
        base = times.pop("base")
        print(f"[phases] B{B} L{L} H{H} P64 N{N} chunk {chunk} fp32: the "
              f"kernel {base:.4f} ms (max abs err {err:.3e} against "
              f"ssd_ref); without "
              + ", ".join(f"{n} {t:.4f} ({t - base:+.4f})"
                          for n, t in times.items()), flush=True)
        del x, dt, Bm, Cm, y, st, bp, cp
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
