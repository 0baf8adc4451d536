#!/usr/bin/env python3
"""The two tensor-core kernels of the port at more shapes than the smoke run.

    python3 tools/hopper_check.py

On one CUDA card: builds ``flash_attention_wgmma.cu`` and
``padded_matmul_wgmma.cu``, prints their ptxas lines and the HGMMA count
of their SASS, holds each against its plain version at a few shapes
(bf16 5e-2; the matmul's atol at least 2e-3·√K), then times each at
shapes beyond the serving path's (long sequences, hd 128, square
matmuls) beside the one PyTorch call that computes the same function
(SDPA with the KV heads expanded beforehand; ``torch.matmul``), in the
order kernel, library, library, kernel.  Exits non-zero on a mismatch or
without a card.  A short first call for a changed kernel: it builds in
seconds and runs in under a minute.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

FLASH_CHECK = [(8, 1024, 32, 8, 64), (2, 1000, 16, 4, 128), (2, 1, 16, 4, 64),
               (2, 129, 16, 4, 128), (1, 2048, 8, 2, 128)]
FLASH_TIME = [(8, 1024, 32, 8, 64), (8, 4096, 32, 8, 64),
              (2, 4096, 32, 8, 128)]
MATMUL_CHECK = [(128, 128, 128), (64, 104, 96), (300, 1000, 520),
                (4096, 8192, 8576)]
MATMUL_TIME = [(4096, 8192, 8576), (4096, 4096, 4096), (8192, 8192, 8192)]


def time_ms(fn, iters=30):
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def in_turns(kernel, library):
    """Best of two each, timed kernel, library, library, kernel."""
    k0, l0, l1, k1 = (time_ms(f) for f in (kernel, library, library, kernel))
    return min(k0, k1), min(l0, l1)


def main():
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        sys.exit(1)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _lib_path, build_all, find_nvcc
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.padded_matmul import ops as mm

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    kernels = [fa.KERNELS["wgmma"], mm.KERNELS["wgmma"]]
    build_all(kernels)
    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    for k in kernels:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line or "arning" in line:
                print(f"[build] {k.source}: {line.strip()}")
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(_lib_path(k.source))], capture_output=True,
                              text=True, check=True, timeout=120).stdout
        print(f"[build] {k.source}: {sass.count('HGMMA')} HGMMA", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    bad = 0

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(bf)

    def close(got, want, atol):
        g, w = got.float(), want.float()
        return bool(((g - w).abs() <= atol + 5e-2 * w.abs()).all()), float(
            (g - w).abs().max())

    for (B, S, H, KV, hd) in FLASH_CHECK:
        for causal in (True, False):
            q, k, v = randn(B, S, H, hd), randn(B, S, KV, hd), randn(B, S, KV, hd)
            ok, err = close(fa.attention_cuda(q, k, v, causal),
                            fa.attention_ref(q, k, v, causal), 5e-2)
            bad += not ok
            print(f"[check] flash B{B} S{S} H{H} KV{KV} hd{hd} causal={causal}: "
                  f"max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}", flush=True)
    for (M, K, N) in MATMUL_CHECK:
        a, b = randn(M, K), randn(K, N)
        ok, err = close(mm.matmul_cuda(a, b), mm.matmul_ref(a, b),
                        max(5e-2, 2e-3 * K ** 0.5))
        bad += not ok
        print(f"[check] matmul M{M} K{K} N{N}: max_abs_err {err:.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)

    for (B, S, H, KV, hd) in FLASH_TIME:
        for causal in (True, False):
            q, k, v = randn(B, S, H, hd), randn(B, S, KV, hd), randn(B, S, KV, hd)
            qt = q.transpose(1, 2).contiguous()
            kt = k.repeat_interleave(H // KV, 2).transpose(1, 2).contiguous()
            vt = v.repeat_interleave(H // KV, 2).transpose(1, 2).contiguous()
            ms, lib = in_turns(
                lambda: fa.attention_cuda(q, k, v, causal),
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=causal))
            pairs = S * (S + 1) / 2 if causal else S * S
            flops = 4.0 * B * H * hd * pairs
            print(f"[time] flash B{B} S{S} H{H} KV{KV} hd{hd} causal={causal}: "
                  f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), SDPA "
                  f"{lib:.4f} ms ({flops / lib / 1e9:.1f} TFLOP/s)", flush=True)
            del q, k, v, qt, kt, vt
    for (M, K, N) in MATMUL_TIME:
        a, b = randn(M, K), randn(K, N)
        ms, lib = in_turns(lambda: mm.matmul_cuda(a, b), lambda: a @ b)
        flops = 2.0 * M * K * N
        print(f"[time] matmul M{M} K{K} N{N}: {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), torch.matmul {lib:.4f} ms "
              f"({flops / lib / 1e9:.1f} TFLOP/s)", flush=True)
        del a, b
    if bad:
        print(f"FAIL: {bad} checks outside tolerance")
        sys.exit(1)


if __name__ == "__main__":
    main()
