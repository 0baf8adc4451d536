#!/usr/bin/env python3
"""The port's redesigned kernels at more shapes than the smoke run.

    python3 tools/hopper_check.py [--only ssd,combine,flash,matmul,bwd,ssdbwd,f32flash,f32mm,f32ssd,f32ssdbwd]

On one CUDA card: builds the tensor-core kernels (flash attention, the
padded matmul, the SSD scan on both routes) and the ring combine; prints their ptxas lines and the HGMMA / HMMA counts of their
SASS; holds each against its plain version at a few shapes (bf16 5e-2,
fp32 3e-4; the matmul's atol at least 2e-3·√K; the combine bitwise),
then times each beside its yardstick, in turns (``chip_smoke.in_turns``:
kernel, yardstick, yardstick, kernel, best of two each):
  * flash attention against SDPA with the KV heads expanded beforehand,
    at long sequences and hd 128; the matmul against ``torch.matmul``;
  * the SSD scan's two routes against each other (bf16, and fp32 as split
    TF32, both on the tensor cores) at L 1024 and 4096, B 8, H 48;
  * the ring combine against ``torch.add`` at the ring's chunk, from
    device memory (inputs cycled past the 50 MB L2) and in L2;
  * (``bwd``) the flash forward's lse output on both routes, the flash
    backward on both routes (bf16 on the tensor cores, fp32 on them as
    split TF32; hd 64, 80 and 128, causal and full, ragged S) and the
    fused-norm backward (with and without dh) against their plain versions; each
    flash backward route timed at the training shape in turns with
    autograd of SDPA pinned to each backend that runs, with the device
    time of its three kernels (delta, dK/dV, dQ) from the profiler; the
    fused backward alone (device time), at the training rows and at
    mamba2's width;
  * (``ssdbwd``) the SSD backward on both routes (bf16 x/B/C, and fp32 as
    split TF32, both on the tensor cores; the HGMMA count of each) against its
    plain version at the training shape and its edges (N 64, ragged L,
    chunks 64 to 256, L 1, a final-state cotangent, an initial state;
    ``chip_smoke.ssd_bwd_case``), then each route timed at the training
    shape beside the plain version, with its bound, the device time of each
    of its kernels from the profiler, and two calls compared bitwise;
  * (``f32flash``) the fp32 route of flash attention, split TF32 on the
    tensor cores (``"tf32x3"``): the forward with its lse at
    ``FLASH_CHECK`` and the backward at ``BWD_CHECK``, causal and full,
    each call on its route by the launch counts, against the plain
    versions (3e-4), two backward calls compared bitwise; then forward
    and backward timed in turns with SDPA fp32 (the backward with each
    SDPA backend that runs) at the serving shape, the training shape and
    S 4096, with each kernel's device time from the profiler (pre-pass,
    main, dQ), the bound at the TF32 peak, the three passes' floor and
    the scratch bytes;
  * (``f32mm``) the fp32 route of the padded matmul, split TF32 on the
    tensor cores (``"tf32x3"``), at ``F32MM_CHECK`` (K or N off a multiple
    of 4, operands at an address off 16 bytes, the Case-2 shape; a split
    in the kernel or, 4 bytes off, by the pre-pass), each call on its
    route, two calls compared bitwise, against ``matmul_ref``
    (``matmul_tol``); then the Case-2 shape timed in turns with
    ``torch.matmul`` fp32 at N 8484, a split both ways (a 4 bytes off goes
    to the pre-pass), with the profiler's split (pre-pass, main),
    the bound at the TF32 peak, the three passes' floor and the scratch;
  * (``f32ssd``) the fp32 route of the SSD scan, split TF32 on the tensor
    cores, at ``F32SSD_CHECK`` (N 64 and 128, ragged L, initial states, every
    chunk), two calls compared bitwise, against ``ssd_ref``; then timed in
    turns with the bf16 route at L 1024 and 4096, with the profiler's split
    (pre-pass, main), the bound, the floor and the scratch;
  * (``f32ssdbwd``) the fp32 route of the SSD backward, split TF32 on the
    tensor cores, at ``F32SSDBWD_CHECK`` (``SSD_BWD_CHECK``, H 12 and 20,
    N 64 at the training shape), against ``ssd_bwd_ref``; then the
    training shape and N 64 timed, two calls compared bitwise, with the
    profiler's split (pre-pass, state, dx/dB, dC, finish, sums), the bound
    at the TF32 peak, the design floor and the scratch.
Exits non-zero on a mismatch or without a card.  A short first call for a
changed kernel: it builds in seconds and runs in about a minute.
"""
from __future__ import annotations

import argparse
import itertools
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

FLASH_CHECK = [(8, 1024, 32, 8, 64), (2, 1000, 16, 4, 128), (2, 1, 16, 4, 64),
               (2, 129, 16, 4, 128), (1, 2048, 8, 2, 128),
               (8, 1024, 32, 32, 80), (2, 129, 16, 4, 80), (2, 1, 4, 4, 80)]
FLASH_TIME = [(8, 1024, 32, 8, 64), (8, 4096, 32, 8, 64),
              (2, 4096, 32, 8, 128), (8, 1024, 32, 32, 80)]
MATMUL_CHECK = [(128, 128, 128), (64, 104, 96), (300, 1000, 520),
                (4096, 8192, 8576)]
MATMUL_TIME = [(4096, 8192, 8576), (4096, 4096, 4096), (8192, 8192, 8192)]
# (B, L, H, N, chunk, initial state): the serving shape, ragged L, short L,
# state 64 and the smaller chunks
SSD_CHECK = [(8, 1024, 48, 128, 256, False), (2, 1000, 48, 128, 256, True),
             (1, 320, 48, 128, 256, True), (2, 1, 8, 128, 256, True),
             (2, 100, 8, 128, 256, False), (2, 700, 8, 128, 192, True),
             (2, 300, 8, 64, 64, True), (1, 1000, 8, 64, 128, False)]
SSD_TIME = [(8, 1024), (8, 4096)]
# (B, L, H, N, chunk, final-state cotangent, initial state): the training
# shape, ragged L, L 1, state 64, every chunk
SSD_BWD_CHECK = [(8, 512, 48, 128, 256, False, False),
                 (2, 200, 8, 128, 256, True, False),
                 (2, 333, 8, 64, 128, True, True),
                 (1, 100, 4, 128, 64, False, True),
                 (2, 1, 4, 64, 64, True, True),
                 (1, 700, 4, 128, 192, True, False)]
# (B, S, H, KV, hd): the training shape, ragged S, hd 128, short S; hd 128
# at G 6 and 7 (dbrx's 48 over 8 and arctic's 56 over 8 heads), and at G 5,
# 8 and 16 (llama-20b-paper's 40, qwen2-72b's 64 and llama3-405b's 128 over
# 8)
BWD_CHECK = [(8, 512, 32, 8, 64), (2, 200, 16, 4, 64), (2, 129, 8, 2, 128),
             (1, 1, 4, 1, 64), (2, 77, 4, 4, 128), (8, 512, 32, 32, 80),
             (2, 77, 8, 2, 80), (1, 1, 4, 4, 80), (2, 256, 48, 8, 128),
             (2, 129, 56, 8, 128), (2, 256, 40, 8, 128),
             (2, 129, 64, 8, 128), (2, 200, 128, 8, 128)]
# (R, D) of the fused-norm backward's checks: the training rows, mamba2's
# width, a row off 16 bytes; the MoE widths 6144 and 7168, 8192, and 5000,
# a partial last pass of the 8192 instances; llama-20b-paper's 5120; the
# 1024-thread instance at llama3-405b's 16384, the widest, and at 12288
# and 9000, partial last passes
FUSED_BWD_CHECK = [(4096, 2048), (300, 1536), (7, 100), (4096, 6144),
                   (4096, 7168), (300, 8192), (33, 5000), (4096, 5120),
                   (4096, 16384), (300, 12288), (33, 9000)]


def check_backward():
    """The backward kernels and the forward's lse: checks, then times."""
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (BWD_BF16_SCALED, ptxas_usage, sass_mma,
                            sdpa_backward_fns, time_flash_bwd, time_ms)
    from chip_smoke import bound as work_bound
    from repro_torch.kernels import build_all
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.fused_norm import ops as fn

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    kernels = [*fa.KERNELS.values(), *fa.BWD_KERNELS.values(), fn.KERNEL,
               fn.BWD_KERNEL]
    build_all(kernels)
    for k in kernels:
        for line in k.build_log.splitlines():
            if any(w in line for w in ("arning", "rror", "wgmma",
                                       "Performance")):
                print(f"[build] {k.source}: {line.strip()}")
        for u in ptxas_usage(k.build_log):
            print(f"[build] {k.source}: {u['function'][:70]}: "
                  f"{u['registers']} registers, {u['spill_stores']}/"
                  f"{u['spill_loads']} bytes spilled")
        n = sass_mma(k)
        print(f"[build] {k.source}: {n['HGMMA']} HGMMA, {n['HMMA']} HMMA",
              flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def close(got, want, tol):
        g, w = got.float(), want.float()
        ok = bool(((g - w).abs() <= tol + tol * w.abs()).all()
                  and g.isfinite().all())
        return ok, float((g - w).abs().max())

    for (B, S, H, KV, hd) in BWD_CHECK:
        for dtype in (torch.bfloat16, torch.float32):
            tol = 5e-2 if dtype == torch.bfloat16 else 3e-4
            for causal in (True, False):
                q, k, v = (randn(B, S, H, hd, dtype=dtype),
                           randn(B, S, KV, hd, dtype=dtype),
                           randn(B, S, KV, hd, dtype=dtype))
                o, lse = fa.attention_cuda(q, k, v, causal, return_lse=True)
                o_r, lse_r = fa.attention_ref(q, k, v, causal,
                                              return_lse=True)
                do = randn(B, S, H, hd, dtype=dtype)
                route = fa.BWD_ROUTES[dtype]
                n0 = {r: kk.launches for r, kk in fa.BWD_KERNELS.items()}
                got = fa.attention_bwd_cuda(q, k, v, o, do, lse, causal)
                ran = {r: kk.launches - n0[r]
                       for r, kk in fa.BWD_KERNELS.items()}
                want = fa.attention_bwd_ref(q, k, v, o, do, lse, causal)
                torch.cuda.synchronize()
                res = [close(lse, lse_r, 3e-4), close(o, o_r, tol)] + [
                    close(g, w, tol) for g, w in zip(got, want)]
                # bf16: also within BWD_BF16_SCALED of each output's
                # largest magnitude (at least 1e-3: at S 1, dq and dk are
                # zero up to rounding)
                rel = [float((g.float() - w.float()).abs().max())
                       / max(float(w.float().abs().max()), 1e-3)
                       for g, w in zip(got, want)]
                ok = (all(r[0] for r in res)
                      and ran == {r: int(r == route) for r in ran}
                      and (dtype != torch.bfloat16
                           or max(rel) <= BWD_BF16_SCALED))
                bad += not ok
                print(f"[check] flash bwd [{route}] B{B} S{S} H{H} KV{KV} "
                      f"hd{hd} {dtype} causal={causal}: max_abs_err lse, o, "
                      f"dq, dk, dv {[f'{r[1]:.2e}' for r in res]}, of the "
                      f"largest magnitude {[f'{x:.1e}' for x in rel]} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
    for (R, D) in FUSED_BWD_CHECK:
        for dtype in (torch.bfloat16, torch.float32):
            tol = 5e-2 if dtype == torch.bfloat16 else 3e-4
            for with_dh in (True, False):
                x, r, dy = (randn(R, D, dtype=dtype) for _ in range(3))
                dh = randn(R, D, dtype=dtype) if with_dh else None
                s = randn(D, dtype=torch.float32)
                dx, ds = fn.fused_bwd_cuda(x, r, s, dy, dh)
                dxr, dsr = fn.fused_bwd_ref(x, r, s, dy, dh)
                torch.cuda.synchronize()
                ok1, e1 = close(dx, dxr, tol)
                # dscale sums R rows: fp32 sums in another order
                ok2, e2 = close(ds, dsr, 3e-4 * max(1.0, R ** 0.5))
                bad += not (ok1 and ok2)
                print(f"[check] fused bwd R{R} D{D} {dtype} dh={with_dh}: "
                      f"max_abs_err dx {e1:.2e}, dscale {e2:.2e} "
                      f"{'ok' if ok1 and ok2 else 'FAIL'}", flush=True)

    B, S, H, KV, hd = 8, 512, 32, 8, 64
    for dtype in (torch.bfloat16, torch.float32):
        route = fa.BWD_ROUTES[dtype]
        q, k, v = (randn(B, S, H, hd, dtype=dtype),
                   randn(B, S, KV, hd, dtype=dtype),
                   randn(B, S, KV, hd, dtype=dtype))
        fwd = time_ms(lambda: fa.attention_cuda(q, k, v, True), 20)
        fwd_lse = time_ms(lambda: fa.attention_cuda(q, k, v, True, True), 20)
        o, lse = fa.attention_cuda(q, k, v, True, True)
        do = randn(B, S, H, hd, dtype=dtype)
        bwd, sdpa = time_flash_bwd(fa, q, k, v, do, True, 50)
        flops = 2.5 * 4.0 * B * H * hd * S * (S + 1) / 2
        peak = 989e12 if route == "wgmma" else 494.7e12
        bound, by = work_bound(fa.work(B, S, H, KV, hd, True, q.element_size(),
                                     backward=True), peak)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fa.attention_bwd_cuda(q, k, v, o, do, lse)
            torch.cuda.synchronize()
        parts = {e.key: e.self_device_time_total / 5 / 1e3
                 for e in prof.key_averages()
                 if e.self_device_time_total > 0}
        # each SDPA backend's backward by the profiler too: device time of
        # all its kernels, ms a call
        for name, fn_ in sdpa_backward_fns(q, k, v, do, True).items():
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as p2:
                for _ in range(5):
                    fn_()
                torch.cuda.synchronize()
            parts[f"SDPA {name} (all kernels)"] = sum(
                e.self_device_time_total for e in p2.key_averages()) / 5e3
        print(f"[time] flash B{B} S{S} H{H} KV{KV} hd{hd} {dtype} causal: "
              f"forward {fwd:.4f} ms, with lse {fwd_lse:.4f}; backward "
              f"[{route}] {bwd:.4f} ms ({flops / bwd / 1e9:.1f} TFLOP/s of 5 "
              f"products; bound {bound:.4f} by {by}, {bound / bwd:.3f} of "
              f"it), in turns with SDPA backward by backend "
              + ", ".join(f"{n} {t:.4f}" for n, t in sdpa.items())
              + "; by kernel (profiler, ms a call) "
              + ", ".join(f"{n[:40]} {t:.4f}" for n, t in parts.items()),
              flush=True)
        del q, k, v, o, do
    # the training rows (llama), then mamba2's width at its prefill rows,
    # then the MoE training paths' widths (dbrx 6144, arctic 7168) and the
    # last dense ones' (llama-20b-paper 5120, qwen2-72b 8192, llama3-405b
    # 16384, the 1024-thread instance)
    for (R, D, dtype) in ((4096, 2048, torch.bfloat16),
                          (4096, 2048, torch.float32),
                          (8192, 1536, torch.bfloat16),
                          *((4096, D, dt)
                            for D in (6144, 7168, 5120, 8192, 16384)
                            for dt in (torch.bfloat16, torch.float32))):
        x, r, dy, dh = (randn(R, D, dtype=dtype) for _ in range(4))
        s = randn(D, dtype=torch.float32)
        # device time: behind a queued sleep, the wrapper's host cost per
        # call does not count
        ms = time_ms(lambda: fn.fused_bwd_cuda(x, r, s, dy, dh), 50,
                     behind_sleep=True)
        ms_nodh = time_ms(lambda: fn.fused_bwd_cuda(x, r, s, dy), 50,
                          behind_sleep=True)
        nbytes = 5 * R * D * x.element_size() + 2 * D * 4
        bound = nbytes / 3.35e12 * 1e3
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn.fused_bwd_cuda(x, r, s, dy, dh)
            torch.cuda.synchronize()
        parts = ", ".join(f"{e.key[:40]} {e.self_device_time_total / 5e3:.4f}"
                          for e in prof.key_averages()
                          if e.self_device_time_total > 0)
        print(f"[time] fused bwd R{R} D{D} {dtype}: {ms:.4f} ms with dh "
              f"({nbytes / ms / 1e6:.0f} GB/s of x, res, dy, dh, dx; bound "
              f"{bound:.4f} ms, {bound / ms:.3f} of it), {ms_nodh:.4f} "
              f"without; by kernel (profiler, ms a call) {parts}",
              flush=True)
    if bad:
        print(f"FAIL: {bad} checks outside tolerance")
        sys.exit(1)


def check_ssd_backward():
    """The SSD backward on both instances: checks, then times."""
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (PEAK_BF16_FLOPS, PEAK_TF32_FLOPS, ptxas_usage,
                            sass_mma, ssd_bwd_case, ssd_inputs, time_ms)
    from chip_smoke import bound as work_bound
    from repro_torch.kernels import build_all
    from repro_torch.kernels.ssd_scan import ops as ssd

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    build_all(list(ssd.BWD_KERNELS.values()))
    for route, k in ssd.BWD_KERNELS.items():
        for line in k.build_log.splitlines():
            if "arning" in line or "rror" in line:
                print(f"[build] {k.source}: {line.strip()}")
        for u in ptxas_usage(k.build_log):
            print(f"[build] {k.source}: {u['function'][:70]}: "
                  f"{u['registers']} registers, {u['spill_stores']}/"
                  f"{u['spill_loads']} bytes spilled")
        n = sass_mma(k)
        print(f"[build] {k.source} [{route}]: {n['HGMMA']} HGMMA, "
              f"{n['HMMA']} HMMA", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    for (B, L, H, N, chunk, final, init) in SSD_BWD_CHECK:
        for dtype in ("bfloat16", "float32"):
            try:
                case = ssd_bwd_case(gen, "cuda", B, L, H, N, chunk, dtype,
                                    final, init)
                res = "ok: max_abs_err " + ", ".join(
                    f"{n_} {e:.2e}" for n_, e in case["max_abs_err"].items())
            except AssertionError as e:
                bad += 1
                res = f"FAIL: {e}"
            print(f"[check] ssd bwd B{B} L{L} H{H} N{N} chunk {chunk} "
                  f"{dtype} final={final} init={init}: {res}", flush=True)
            torch.cuda.empty_cache()
    B, L, H, N, chunk = 8, 512, 48, 128, 256
    for dtype in ("bfloat16", "float32"):
        x, dt, A, Bm, Cm = ssd_inputs(gen, "cuda", B, L, H, N, dtype)
        dy = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
        args = (x, dt, A, Bm, Cm, dy, None, chunk)
        ms = time_ms(lambda: ssd.ssd_bwd_cuda(*args), 10, behind_sleep=True)
        plain = time_ms(lambda: ssd.ssd_bwd_ref(*args), 3, 1)
        peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_TF32_FLOPS
        w = ssd.work(B, L, H, 64, N, chunk, x.element_size(), backward=True)
        (bound, by), flops, nbytes = work_bound(w, peak), w["flops"], w["bytes"]
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                ssd.ssd_bwd_cuda(*args)
            torch.cuda.synchronize()
        parts = ", ".join(f"{e.key[:60]} {e.self_device_time_total / 5e3:.4f}"
                          for e in prof.key_averages()
                          if e.self_device_time_total > 0)
        runs = [ssd.ssd_bwd_cuda(*args) for _ in range(2)]
        same = all(torch.equal(a, b_) for a, b_ in zip(*runs))
        print(f"[time] ssd bwd B{B} L{L} H{H} N{N} chunk {chunk} {dtype}: "
              f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s of the work), "
              f"plain {plain:.4f} ms; bound {bound:.4f} by {by} "
              f"({bound / ms:.4f} of it); two calls bitwise equal: {same}; "
              f"by kernel (profiler, ms a call) {parts}", flush=True)
        bad += not same
        del x, dt, Bm, Cm, dy, args
    if bad:
        print(f"FAIL: {bad} checks outside tolerance")
        sys.exit(1)


# (B, S, H, KV, hd): the serving shape, the training shape, S 4096
F32_TIME = [(8, 1024, 32, 8, 64), (8, 512, 32, 8, 64), (8, 4096, 32, 8, 64)]


def check_f32flash():
    """The split-TF32 flash kernels: checks, then times."""
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (PEAK_BYTES, PEAK_FP32_FLOPS, PEAK_TF32_FLOPS,
                            in_turns, ptxas_usage, sass_mma,
                            time_flash_bwd)
    from chip_smoke import bound as work_bound
    from repro_torch.kernels import build_all
    from repro_torch.kernels.flash_attention import ops as fa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    kernels = [fa.KERNELS["tf32x3"], fa.BWD_KERNELS["tf32x3"]]
    build_all(kernels)
    for k in kernels:
        for line in k.build_log.splitlines():
            if any(w in line for w in ("arning", "rror", "wgmma",
                                       "Performance")):
                print(f"[build] {k.source}: {line.strip()}")
        for u in ptxas_usage(k.build_log):
            print(f"[build] {k.source}: {u['function'][:70]}: "
                  f"{u['registers']} registers, {u['spill_stores']}/"
                  f"{u['spill_loads']} bytes spilled")
        n = sass_mma(k)
        print(f"[build] {k.source}: {n['HGMMA']} HGMMA, {n['HMMA']} HMMA",
              flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    f32 = torch.float32
    bad = 0

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def close(got, want, tol=3e-4):
        g, w = got.float(), want.float()
        ok = bool(((g - w).abs() <= tol + tol * w.abs()).all()
                  and g.isfinite().all())
        return ok, float((g - w).abs().max())

    def launched(kernels, fn):
        n0 = {r: kk.launches for r, kk in kernels.items()}
        out = fn()
        ran = {r: kk.launches - n0[r] for r, kk in kernels.items()}
        return out, ran == {r: int(r == "tf32x3") for r in ran}

    for (B, S, H, KV, hd) in FLASH_CHECK:
        for causal in (True, False):
            q, k, v = randn(B, S, H, hd), randn(B, S, KV, hd), randn(
                B, S, KV, hd)
            (o, lse), on = launched(fa.KERNELS, lambda: fa.attention_cuda(
                q, k, v, causal, return_lse=True))
            o_r, lse_r = fa.attention_ref(q, k, v, causal, return_lse=True)
            torch.cuda.synchronize()
            (ok1, e1), (ok2, e2) = close(o, o_r), close(lse, lse_r)
            ok = ok1 and ok2 and on
            bad += not ok
            print(f"[check] flash fwd [tf32x3] B{B} S{S} H{H} KV{KV} hd{hd} "
                  f"causal={causal}: max_abs_err o {e1:.2e}, lse {e2:.2e}, "
                  f"one launch on the route: {on} {'ok' if ok else 'FAIL'}",
                  flush=True)
            del q, k, v, o, lse, o_r, lse_r
    for (B, S, H, KV, hd) in BWD_CHECK:
        for causal in (True, False):
            q, k, v, do = (randn(B, S, n, hd) for n in (H, KV, KV, H))
            o, lse = fa.attention_cuda(q, k, v, causal, return_lse=True)
            got, on = launched(fa.BWD_KERNELS, lambda: fa.attention_bwd_cuda(
                q, k, v, o, do, lse, causal))
            again = fa.attention_bwd_cuda(q, k, v, o, do, lse, causal)
            want = fa.attention_bwd_ref(q, k, v, o, do, lse, causal)
            torch.cuda.synchronize()
            res = [close(g, w) for g, w in zip(got, want)]
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            ok = all(r[0] for r in res) and on and same
            bad += not ok
            print(f"[check] flash bwd [tf32x3] B{B} S{S} H{H} KV{KV} hd{hd} "
                  f"causal={causal}: max_abs_err dq, dk, dv "
                  f"{[f'{r[1]:.2e}' for r in res]}, one launch on the route: "
                  f"{on}, two calls bitwise equal: {same} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            del q, k, v, do, o, lse, got, again, want

    def by_kernel(fn, calls=5):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return {e.key: e.self_device_time_total / calls / 1e3
                for e in prof.key_averages() if e.self_device_time_total > 0}

    for (B, S, H, KV, hd) in F32_TIME:
        q, k, v, do = (randn(B, S, n, hd) for n in (H, KV, KV, H))
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(H // KV, 2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(H // KV, 2).transpose(1, 2).contiguous()
        ms, lib = in_turns(
            {"flash": lambda: fa.attention_cuda(q, k, v, True),
             "sdpa": lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=True)}, 20).values()
        del qt, kt, vt
        flops = 4.0 * B * H * hd * S * (S + 1) / 2
        bound = max(flops / PEAK_TF32_FLOPS,
                    (2 * q.numel() + 2 * k.numel()) * 4 / PEAK_BYTES) * 1e3
        parts = by_kernel(lambda: fa.attention_cuda(q, k, v, True))
        scratch = fa.tf32_scratch_bytes(B, S, H, KV, hd, backward=False)
        print(f"[time] flash fwd [tf32x3] B{B} S{S} H{H} KV{KV} hd{hd} fp32 "
              f"causal: {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), SDPA "
              f"fp32 {lib:.4f} ms in turns ({ms / lib:.2f}x); bound "
              f"{bound:.4f} ms at the TF32 peak ({bound / ms:.3f} of it), "
              f"design floor {3 * flops / PEAK_TF32_FLOPS * 1e3:.4f} ms "
              f"({3 * flops / PEAK_TF32_FLOPS * 1e3 / ms:.3f} of it), "
              f"FP32-pipe bound {flops / PEAK_FP32_FLOPS * 1e3:.4f}; scratch "
              f"{scratch} bytes; by kernel (profiler, ms a call) "
              + ", ".join(f"{n[:50]} {t:.4f}" for n, t in parts.items()),
              flush=True)
        bwd, sdpa = time_flash_bwd(fa, q, k, v, do, True, 20)
        o, lse = fa.attention_cuda(q, k, v, True, return_lse=True)
        parts = by_kernel(lambda: fa.attention_bwd_cuda(q, k, v, o, do, lse))
        bflops = 2.5 * flops
        bound, by = work_bound(fa.work(B, S, H, KV, hd, True, 4, backward=True),
                             PEAK_TF32_FLOPS)
        floor = 3 * 1.4 * bflops / PEAK_TF32_FLOPS * 1e3
        scratch = fa.tf32_scratch_bytes(B, S, H, KV, hd, backward=True)
        print(f"[time] flash bwd [tf32x3] B{B} S{S} H{H} KV{KV} hd{hd} fp32 "
              f"causal: {bwd:.4f} ms ({bflops / bwd / 1e9:.1f} TFLOP/s of 5 "
              f"products), in turns with SDPA backward by backend "
              + ", ".join(f"{n} {t:.4f}" for n, t in sdpa.items())
              + f"; bound {bound:.4f} by {by} ({bound / bwd:.3f} of it), "
              f"design floor {floor:.4f} ({floor / bwd:.3f} of it); scratch "
              f"{scratch} bytes; by kernel (profiler, ms a call) "
              + ", ".join(f"{n[:50]} {t:.4f}" for n, t in parts.items()),
              flush=True)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    if bad:
        print(f"FAIL: {bad} checks outside tolerance")
        sys.exit(1)


# fp32 matmul_tiled shapes (each dimension a multiple of the 128 tile or
# below it): K or N off a multiple of 4, ragged M, the Case-2 shape padded
F32MM_CHECK = [(128, 128, 128), (64, 100, 96), (32, 101, 99), (96, 127, 7),
               (256, 384, 126), (256, 1024, 120),
               (4096, 8192, 8576)]
# (B, L, H, N, chunk, initial state) of the fp32 SSD checks: SSD_CHECK and
# the mamba2 fp32 prefill's L 320 at N 64
F32SSD_CHECK = SSD_CHECK + [(1, 320, 48, 64, 256, True)]


def _f32_setup(kernels):
    """Card, build, ptxas and HGMMA lines of ``kernels``; returns the
    profiler's per-kernel split helper."""
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from chip_smoke import ptxas_usage, sass_mma
    from repro_torch.kernels import build_all

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    build_all(kernels)
    for k in kernels:
        for line in k.build_log.splitlines():
            if any(w in line for w in ("arning", "rror", "wgmma",
                                       "Performance")):
                print(f"[build] {k.source}: {line.strip()}")
        for u in ptxas_usage(k.build_log):
            print(f"[build] {k.source}: {u['function'][:70]}: "
                  f"{u['registers']} registers, {u['spill_stores']}/"
                  f"{u['spill_loads']} bytes spilled")
        n = sass_mma(k)
        print(f"[build] {k.source}: {n['HGMMA']} HGMMA, {n['HMMA']} HMMA",
              flush=True)
        if not n["HGMMA"]:
            print(f"FAIL: {k.source}: no HGMMA in its SASS")
            sys.exit(1)

    def by_kernel(fn, calls=5):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return {e.key: e.self_device_time_total / calls / 1e3
                for e in prof.key_averages() if e.self_device_time_total > 0}
    return by_kernel


def check_f32mm():
    """The split-TF32 fp32 matmul: checks (both ways of splitting a), then
    the Case-2 shape timed in turns with torch.matmul fp32."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (CASE2, PEAK_BYTES, PEAK_FP32_FLOPS,
                            PEAK_TF32_FLOPS, in_turns, matmul_tol, max_err)
    from repro_torch.kernels.padded_matmul import ops as mm
    by_kernel = _f32_setup([mm.KERNELS["tf32x3"]])
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0

    def randn(*shape, offset=0):
        n = int(torch.tensor(shape).prod())
        return torch.randn(n + offset, generator=gen, device="cuda")[
            offset:].view(shape)

    def call(a, b):
        n0 = {r: k.launches for r, k in mm.KERNELS.items()}
        out = mm.matmul_tiled(a, b)
        ran = {r: k.launches - n0[r] for r, k in mm.KERNELS.items()}
        return out, ran == {r: int(r == "tf32x3") for r in ran}

    for (M, K, N) in F32MM_CHECK:
        for offset in (0, 1):
            a, b = randn(M, K, offset=offset), randn(K, N, offset=offset)
            want = mm.matmul_ref(a, b)
            got, on = call(a, b)
            again, _ = call(a, b)
            torch.cuda.synchronize()
            try:
                err, ok = max_err(got, want, "float32",
                                  matmul_tol("float32", K)), True
            except AssertionError as e:
                err, ok = str(e), False
            same = torch.equal(got, again)
            ok = ok and on and same
            bad += not ok
            print(f"[check] matmul_tiled [tf32x3] M{M} K{K} N{N} offset "
                  f"{offset} split_a_in_kernel="
                  f"{mm.tf32_split_a_in_kernel(a)}: max_abs_err {err}, one "
                  f"launch on the route: {on}, two calls bitwise equal: "
                  f"{same} {'ok' if ok else 'FAIL'}", flush=True)
            del a, b, want, got, again
    M, K, N = CASE2
    # a as it lies, split in the kernel, and a copy 4 bytes off, which the
    # pre-pass splits
    a, b = randn(M, K), randn(K, N)
    a_off = randn(M, K, offset=1)
    a_off.copy_(a)
    bp = mm._pad_to(b, mm.TILE, mm.TILE)
    Np = bp.shape[1]
    flops = 2.0 * M * K * N
    fns = {"in_kernel": lambda: mm.matmul_cuda(a, bp),
           "prepass": lambda: mm.matmul_cuda(a_off, bp),
           "torch": lambda: torch.matmul(a, b)}
    times = in_turns(fns, 5)
    t_ops = flops / PEAK_TF32_FLOPS * 1e3
    t_bytes = (M * K + K * N + M * N) * 4 / PEAK_BYTES * 1e3
    for variant, in_kernel in (("in_kernel", True), ("prepass", False)):
        parts = by_kernel(fns[variant])
        ms = times[variant]
        print(f"[time] matmul [tf32x3, a split "
              f"{'in the kernel' if in_kernel else 'by the pre-pass'}] "
              f"M{M} K{K} N{N} (padded N {Np}) fp32: {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s of the unpadded work), "
              f"torch.matmul fp32 at N {N} {times['torch']:.4f} ms in turns "
              f"({ms / times['torch']:.3f}x); bound {max(t_ops, t_bytes):.4f} "
              f"ms at the TF32 peak ({max(t_ops, t_bytes) / ms:.3f} of it), "
              f"design floor {3 * t_ops:.4f} ({3 * t_ops / ms:.3f} of it), "
              f"FP32-pipe bound {flops / PEAK_FP32_FLOPS * 1e3:.4f}; scratch "
              f"{mm.tf32_scratch_bytes(M, Np, K, in_kernel)} bytes; by "
              f"kernel (profiler, ms a call) "
              + ", ".join(f"{n[:60]} {t:.4f}" for n, t in parts.items()),
              flush=True)
    if bad:
        print(f"FAIL: {bad} checks outside tolerance")
        sys.exit(1)


def check_f32ssd():
    """The split-TF32 fp32 SSD scan: checks, then the serving shape timed
    in turns with the bf16 route."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (PEAK_BYTES, PEAK_FP32_FLOPS, PEAK_TF32_FLOPS,
                            in_turns, max_err, ssd_inputs)
    from repro_torch.kernels.ssd_scan import ops as ssd
    by_kernel = _f32_setup([ssd.KERNELS["tf32x3"], ssd.KERNELS["wgmma"]])
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    for (B, L, H, N, chunk, init) in F32SSD_CHECK:
        x, dt, A, Bm, Cm = ssd_inputs(gen, "cuda", B, L, H, N, "float32")
        s0 = (0.5 * torch.randn(B, H, 64, N, generator=gen, device="cuda")
              if init else None)
        n0 = {r: k.launches for r, k in ssd.KERNELS.items()}
        y, st = ssd.ssd_cuda(x, dt, A, Bm, Cm, chunk, s0)
        on = {r: k.launches - n0[r] for r, k in ssd.KERNELS.items()} == {
            "wgmma": 0, "tf32x3": 1}
        y2, st2 = ssd.ssd_cuda(x, dt, A, Bm, Cm, chunk, s0)
        yr, sr = ssd.ssd_ref(x, dt, A, Bm, Cm, chunk, s0)
        torch.cuda.synchronize()
        try:
            err, ok = (f"y {max_err(y, yr, 'float32'):.3e}, state "
                       f"{max_err(st, sr, 'float32'):.3e}"), True
        except AssertionError as e:
            err, ok = (f"y {float((y - yr).abs().max()):.3e}, state "
                       f"{float((st - sr).abs().max()):.3e}: {e}"), False
        same = torch.equal(y, y2) and torch.equal(st, st2)
        ok = ok and on and same
        bad += not ok
        print(f"[check] ssd_scan [tf32x3] B{B} L{L} H{H} N{N} chunk {chunk} "
              f"init={init}: max_abs_err {err}, one launch on the route: "
              f"{on}, two calls bitwise equal: {same} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        del x, dt, Bm, Cm, y, st, y2, st2, yr, sr
    H, chunk = 48, 256
    for (B, L, N) in [(B, L, 128) for B, L in SSD_TIME] + [(8, 1024, 64)]:
        xf = ssd_inputs(gen, "cuda", B, L, H, N, "float32")
        xb = [xf[0].bfloat16(), xf[1], xf[2], xf[3].bfloat16(),
              xf[4].bfloat16()]
        ms, bf16_ms = in_turns(
            {"tf32x3": lambda: ssd.ssd_cuda(*xf, chunk),
             "wgmma": lambda: ssd.ssd_cuda(*xb, chunk)}, 10).values()
        parts = by_kernel(lambda: ssd.ssd_cuda(*xf, chunk))
        flops = ssd.work(B, L, H, 64, N, chunk)["flops"]
        nbytes = (4 * (2 * xf[0].numel() + 2 * xf[3].numel() + xf[1].numel()
                       + H) + 4 * B * H * 64 * N)
        t_ops = flops / PEAK_TF32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        print(f"[time] ssd_scan [tf32x3] B{B} L{L} H{H} P64 N{N} chunk "
              f"{chunk} fp32: {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s "
              f"of the work), the bf16 route {bf16_ms:.4f} ms in turns; "
              f"bound {max(t_ops, t_bytes):.4f} ms "
              f"({'operations' if t_ops >= t_bytes else 'bytes'}; "
              f"{max(t_ops, t_bytes) / ms:.3f} of it), design floor "
              f"{max(3 * t_ops, t_bytes):.4f}, FP32-pipe bound "
              f"{flops / PEAK_FP32_FLOPS * 1e3:.4f}; scratch "
              f"{ssd.tf32_scratch_bytes(B, L, N)} bytes; by kernel (profiler, "
              f"ms a call) "
              + ", ".join(f"{n[:60]} {t:.4f}" for n, t in parts.items()),
              flush=True)
        del xf, xb
    if bad:
        print(f"FAIL: {bad} checks outside tolerance")
        sys.exit(1)


# (B, L, H, N, chunk, final-state cotangent, initial state) of the fp32 SSD
# backward checks: SSD_BWD_CHECK, a head group cut short (H 12 and 20 are
# not whole groups of 8) and the training shape at N 64
F32SSDBWD_CHECK = SSD_BWD_CHECK + [(2, 512, 12, 128, 256, False, False),
                                   (2, 333, 20, 64, 128, True, True),
                                   (8, 512, 48, 64, 256, False, False)]


def check_f32ssdbwd():
    """The split-TF32 fp32 SSD backward: checks, two calls bitwise, then
    the training shape and N 64 timed with the profiler's split."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (PEAK_FP32_FLOPS, PEAK_TF32_FLOPS,
                            ssd_bwd_case, ssd_bwd_design_flops, ssd_inputs,
                            time_ms)
    from chip_smoke import bound as work_bound
    from repro_torch.kernels.ssd_scan import ops as ssd
    by_kernel = _f32_setup([ssd.BWD_KERNELS["tf32x3"],
                            ssd.BWD_KERNELS["wgmma"]])
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    for (B, L, H, N, chunk, final, init) in F32SSDBWD_CHECK:
        try:
            case = ssd_bwd_case(gen, "cuda", B, L, H, N, chunk, "float32",
                                final, init)
            res = "ok: max_abs_err " + ", ".join(
                f"{n_} {e:.2e}" for n_, e in case["max_abs_err"].items())
        except AssertionError as e:
            bad += 1
            res = f"FAIL: {e}"
        print(f"[check] ssd bwd [tf32x3] B{B} L{L} H{H} N{N} chunk {chunk} "
              f"final={final} init={init}: {res}", flush=True)
        torch.cuda.empty_cache()
    for (B, L, H, N, chunk) in [(8, 512, 48, 128, 256),
                                (8, 512, 48, 64, 256)]:
        x, dt, A, Bm, Cm = ssd_inputs(gen, "cuda", B, L, H, N, "float32")
        dy = torch.randn(x.shape, generator=gen, device="cuda")
        args = (x, dt, A, Bm, Cm, dy, None, chunk)
        ms = time_ms(lambda: ssd.ssd_bwd_cuda(*args), 10, behind_sleep=True)
        runs = [ssd.ssd_bwd_cuda(*args) for _ in range(2)]
        same = all(torch.equal(a, b_) for a, b_ in zip(*runs))
        bad += not same
        del runs
        parts = by_kernel(lambda: ssd.ssd_bwd_cuda(*args))
        w = ssd.work(B, L, H, 64, N, chunk, 4, backward=True)
        (bound, by), flops, nbytes = (work_bound(w, PEAK_TF32_FLOPS),
                                      w["flops"], w["bytes"])
        design = ssd_bwd_design_flops(B, L, H, 64, N, chunk, "tf32x3")
        print(f"[time] ssd bwd [tf32x3] B{B} L{L} H{H} N{N} chunk {chunk} "
              f"fp32: {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s of the "
              f"work, {design / ms / 1e9:.1f} of the design's {design:.3e} "
              f"three-pass flops); bound {bound:.4f} by {by} "
              f"({bound / ms:.3f} of it), design floor {design / PEAK_TF32_FLOPS * 1e3:.4f}, FP32-pipe "
              f"bound {flops / PEAK_FP32_FLOPS * 1e3:.4f}; scratch "
              f"{ssd.tf32_bwd_scratch_bytes(B, L, H, N, chunk)} bytes; two "
              f"calls bitwise equal: {same}; by kernel (profiler, ms a call) "
              + ", ".join(f"{n[:60]} {t:.4f}" for n, t in parts.items()),
              flush=True)
        del x, dt, Bm, Cm, dy, args
        torch.cuda.empty_cache()
    if bad:
        print(f"FAIL: {bad} checks failed")
        sys.exit(1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="ssd,combine,flash,matmul",
                    help="comma-separated parts to run")
    cli = ap.parse_args()
    parts = set(cli.only.split(","))
    if "f32ssdbwd" in parts:
        check_f32ssdbwd()
        parts.discard("f32ssdbwd")
    for part, check in (("bwd", check_backward),
                        ("ssdbwd", check_ssd_backward),
                        ("f32flash", check_f32flash),
                        ("f32mm", check_f32mm), ("f32ssd", check_f32ssd)):
        if part in parts:
            check()
            parts.discard(part)
    if not parts:
        return
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (RING_CHUNK, RING_ODD_CHUNK, in_turns, ptxas_usage,
                            sass_mma, ssd_inputs)
    from repro_torch.kernels import build_all
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.padded_matmul import ops as mm
    from repro_torch.kernels.ring_reduce import ops as ring
    from repro_torch.kernels.ssd_scan import ops as ssd

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    kernels = {"flash": [fa.KERNELS["wgmma"]], "matmul": [mm.KERNELS["wgmma"]],
               "ssd": list(ssd.KERNELS.values()), "combine": [ring.KERNEL]}
    kernels = [k for part, ks in kernels.items() if part in parts for k in ks]
    build_all(kernels)
    for k in kernels:
        for line in k.build_log.splitlines():
            if "arning" in line or "rror" in line:
                print(f"[build] {k.source}: {line.strip()}")
        for u in ptxas_usage(k.build_log):
            print(f"[build] {k.source}: {u['function'][:60]}: "
                  f"{u['registers']} registers, {u['spill_stores']}/"
                  f"{u['spill_loads']} bytes spilled")
        n = sass_mma(k)
        print(f"[build] {k.source}: {n['HGMMA']} HGMMA, {n['HMMA']} HMMA",
              flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    bad = 0

    def randn(*shape, dtype=bf):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def close(got, want, atol, rtol=5e-2):
        g, w = got.float(), want.float()
        ok = bool(((g - w).abs() <= atol + rtol * w.abs()).all()
                  and g.isfinite().all())
        return ok, float((g - w).abs().max())

    if "ssd" in parts:
        for (B, L, H, N, chunk, init) in SSD_CHECK:
            for dtype in ("bfloat16", "float32"):
                x, dt, A, Bm, Cm = ssd_inputs(gen, "cuda", B, L, H, N, dtype)
                s0 = (0.5 * torch.randn(B, H, 64, N, generator=gen,
                                        device="cuda") if init else None)
                y, st = ssd.ssd_cuda(x, dt, A, Bm, Cm, chunk, s0)
                yr, sr = ssd.ssd_ref(x, dt, A, Bm, Cm, chunk, s0)
                tol = 5e-2 if dtype == "bfloat16" else 3e-4
                ok_y, err_y = close(y, yr, tol, tol)
                ok_s, err_s = close(st, sr, tol, tol)
                bad += not (ok_y and ok_s)
                print(f"[check] ssd_scan [{ssd.route(x.dtype)}] B{B} L{L} H{H} "
                      f"N{N} chunk {chunk} init={init}: max_abs_err y "
                      f"{err_y:.3e}, state {err_s:.3e} "
                      f"{'ok' if ok_y and ok_s else 'FAIL'}", flush=True)
    if "combine" in parts:
        for (C, block, offset) in [(4096, 512, 0), (RING_CHUNK, 1024, 0),
                                   (RING_ODD_CHUNK, 1024, 0),
                                   (3 * 1022, 1022, 0), (8192, 1024, 1)]:
            for dtype in (torch.float32, bf):
                a = randn(C + offset, dtype=dtype)[offset:]
                b = randn(C + offset, dtype=dtype)[offset:]
                out, prog = ring.ring_combine_cuda(a, b, block)
                torch.cuda.synchronize()
                ok = (torch.equal(out, a + b)
                      and torch.equal(prog, ring.progress_ref(C, block)))
                bad += not ok
                print(f"[check] ring_combine C{C} block {block} {dtype} "
                      f"offset {offset}: {'bitwise' if ok else 'FAIL'}",
                      flush=True)
    if "flash" in parts:
        for (B, S, H, KV, hd) in FLASH_CHECK:
            for causal in (True, False):
                q, k, v = randn(B, S, H, hd), randn(B, S, KV, hd), randn(
                    B, S, KV, hd)
                ok, err = close(fa.attention_cuda(q, k, v, causal),
                                fa.attention_ref(q, k, v, causal), 5e-2)
                bad += not ok
                print(f"[check] flash B{B} S{S} H{H} KV{KV} hd{hd} "
                      f"causal={causal}: max_abs_err {err:.3e} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
    if "matmul" in parts:
        for (M, K, N) in MATMUL_CHECK:
            a, b = randn(M, K), randn(K, N)
            ok, err = close(mm.matmul_cuda(a, b), mm.matmul_ref(a, b),
                            max(5e-2, 2e-3 * K ** 0.5))
            bad += not ok
            print(f"[check] matmul M{M} K{K} N{N}: max_abs_err {err:.3e} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)

    if "ssd" in parts:
        H, N, chunk = 48, 128, 256
        for (B, L) in SSD_TIME:
            xb = ssd_inputs(gen, "cuda", B, L, H, N, "bfloat16")
            xf = [t.float() for t in xb]
            ms, fp32_ms = in_turns(
                {"wgmma": lambda: ssd.ssd_cuda(*xb, chunk),
                 "tf32x3": lambda: ssd.ssd_cuda(*xf, chunk)}, 10).values()
            flops = ssd.work(B, L, H, 64, N, chunk)["flops"]
            print(f"[time] ssd_scan B{B} L{L} H{H} P64 N{N} chunk {chunk}: "
                  f"wgmma (bf16) {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s "
                  f"of the work), fp32 route (tf32x3) {fp32_ms:.4f} ms "
                  f"({flops / fp32_ms / 1e9:.1f}): {fp32_ms / ms:.1f}x",
                  flush=True)
            del xb, xf
    if "combine" in parts:
        C = RING_CHUNK
        pairs = [(randn(C, dtype=torch.float32), randn(C, dtype=torch.float32))
                 for _ in range(5)]
        for label, pick in (
                ("from device memory", lambda it=itertools.cycle(pairs): next(it)),
                ("in L2", lambda: pairs[0])):
            ms, add_ms = in_turns(
                {"combine": lambda: ring.ring_combine_cuda(*pick(), 1024),
                 "add": lambda: torch.add(*pick())}, 200,
                behind_sleep=True).values()
            print(f"[time] ring_combine C{C} fp32 {label}: {ms:.4f} ms, "
                  f"torch.add {add_ms:.4f} ms ({ms / add_ms:.2f}x); bound "
                  f"{3 * C * 4 / 3.35e12 * 1e3:.4f} ms", flush=True)
        del pairs
    if "flash" in parts:
        for (B, S, H, KV, hd) in FLASH_TIME:
            for causal in (True, False):
                q, k, v = randn(B, S, H, hd), randn(B, S, KV, hd), randn(
                    B, S, KV, hd)
                qt = q.transpose(1, 2).contiguous()
                kt = k.repeat_interleave(H // KV, 2).transpose(1, 2).contiguous()
                vt = v.repeat_interleave(H // KV, 2).transpose(1, 2).contiguous()
                ms, lib = in_turns(
                    {"flash": lambda: fa.attention_cuda(q, k, v, causal),
                     "sdpa": lambda: F.scaled_dot_product_attention(
                         qt, kt, vt, is_causal=causal)}, 30).values()
                pairs = S * (S + 1) / 2 if causal else S * S
                flops = 4.0 * B * H * hd * pairs
                print(f"[time] flash B{B} S{S} H{H} KV{KV} hd{hd} "
                      f"causal={causal}: {ms:.4f} ms "
                      f"({flops / ms / 1e9:.1f} TFLOP/s), SDPA {lib:.4f} ms "
                      f"({flops / lib / 1e9:.1f} TFLOP/s)", flush=True)
                del q, k, v, qt, kt, vt
    if "matmul" in parts:
        for (M, K, N) in MATMUL_TIME:
            a, b = randn(M, K), randn(K, N)
            ms, lib = in_turns({"matmul": lambda: mm.matmul_cuda(a, b),
                                "torch": lambda: a @ b}, 30).values()
            flops = 2.0 * M * K * N
            print(f"[time] matmul M{M} K{K} N{N}: {ms:.4f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s), torch.matmul {lib:.4f} "
                  f"ms ({flops / lib / 1e9:.1f} TFLOP/s)", flush=True)
            del a, b
    if bad:
        print(f"FAIL: {bad} checks outside tolerance")
        sys.exit(1)


if __name__ == "__main__":
    main()
