#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each printed on its own lines; any failure exits non-zero:
  1. device   — the card's name and power limit (nvidia-smi);
  2. build    — nvcc builds every kernel of the serving path from
                src/repro_torch/kernels/csrc/, one nvcc per source, together;
  3. kernels  — each kernel against its plain PyTorch version on the card,
                at the serving path's shapes (fp32 3e-4, bf16 5e-2), timed
                beside its plain version and a PyTorch library call;
  4. serve    — Server.generate for llama3.2-1b at full width (batch 8,
                1024-token prompts, 32 new tokens, random weights from
                --seed) with the FLARE daemon attached; the launch counts
                of that run; fp32 prefill logits on the card against the
                plain path on the CPU;
  5. trace    — the daemon's JSONL spill read back: step spans and kernel
                spans with device durations from CUDA events.
The trace and a details.json are written to smoke_out/.
The line before the last is the per-kernel JSON summary; the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "smoke_out"

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 pipes,
# HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
TOLS = {"float32": dict(rtol=3e-4, atol=3e-4),
        "bfloat16": dict(rtol=5e-2, atol=5e-2)}


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(phase: str, msg: str):
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of one call of ``fn`` over ``iters`` calls."""
    import torch
    for _ in range(warmup):
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


def max_err(got, want, dtype: str) -> float:
    """Max |got - want|; fails unless |got - want| <= atol + rtol*|want|."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    tol = TOLS[dtype]
    bad = diff > tol["atol"] + tol["rtol"] * w.abs()
    if not bool(g.isfinite().all()):
        raise AssertionError("kernel output is not finite")
    if bool(bad.any()):
        raise AssertionError(
            f"{int(bad.sum())} elements outside tolerance {tol}; "
            f"max abs err {float(diff.max()):.3e}")
    return float(diff.max())


# --------------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------- #
def check_flash(gen, device):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops

    cases = []
    for (B, S, H, KV, hd) in [(8, 1024, 32, 8, 64), (8, 1000, 32, 8, 64),
                              (2, 1000, 16, 4, 128)]:
        for dtype in ("bfloat16", "float32"):
            for causal in (True, False):
                dt = getattr(torch, dtype)
                q = torch.randn(B, S, H, hd, generator=gen, device=device).to(dt)
                k = torch.randn(B, S, KV, hd, generator=gen, device=device).to(dt)
                v = torch.randn(B, S, KV, hd, generator=gen, device=device).to(dt)
                got = ops.attention_cuda(q, k, v, causal)
                want = ops.attention_ref(q, k, v, causal)
                torch.cuda.synchronize()
                err = max_err(got, want, dtype)
                cases.append(dict(shape=[B, S, H, KV, hd], dtype=dtype,
                                  causal=causal, max_abs_err=err))
                log("kernels", f"flash_attention B{B} S{S} H{H} KV{KV} "
                    f"hd{hd} {dtype} causal={causal}: max_abs_err {err:.3e}")

    # the serving path's shape, timed
    B, S, H, KV, hd = 8, 1024, 32, 8, 64
    dt = torch.bfloat16
    q = torch.randn(B, S, H, hd, generator=gen, device=device).to(dt)
    k = torch.randn(B, S, KV, hd, generator=gen, device=device).to(dt)
    v = torch.randn(B, S, KV, hd, generator=gen, device=device).to(dt)
    err = max_err(ops.attention_cuda(q, k, v, True),
                  ops.attention_ref(q, k, v, True), "bfloat16")
    ms = time_ms(lambda: ops.attention_cuda(q, k, v, True), 20)
    plain_ms = time_ms(lambda: ops.attention_ref(q, k, v, True), 5)
    # library yardstick: SDPA on [B,H,S,hd] with the KV heads expanded
    # beforehand (outside the timed call)
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous()
    library_ms = time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 20)
    pairs = S * (S + 1) / 2                      # causal (query, key) pairs
    flops = 4.0 * B * H * hd * pairs
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    summary = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:61",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=library_ms,
        library_call="torch.nn.functional.scaled_dot_product_attention",
        shape=[B, S, H, KV, hd], dtype="bfloat16", causal=True)
    log("kernels", f"flash_attention timed at B{B} S{S} H{H} KV{KV} hd{hd} "
        f"bf16 causal: {ms:.4f} ms (plain {plain_ms:.4f}, SDPA "
        f"{library_ms:.4f}, bound {summary['bound_ms']:.4f} "
        f"by {summary['bound_by']})")
    return summary, cases


def check_fused(gen, device):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.fused_norm import ops

    cases, timed = [], {}
    D = 2048
    for R in (8192, 8):
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            x = torch.randn(R, D, generator=gen, device=device).to(dt)
            r = torch.randn(R, D, generator=gen, device=device).to(dt)
            s = torch.randn(D, generator=gen, device=device)
            y, h = ops.fused_cuda(x, r, s)
            yr, hr = ops.fused_ref(x, r, s)
            torch.cuda.synchronize()
            err = max(max_err(y, yr, dtype), max_err(h, hr, dtype))
            cases.append(dict(shape=[R, D], dtype=dtype, max_abs_err=err))
            log("kernels", f"fused_residual_rmsnorm R{R} D{D} {dtype}: "
                f"max_abs_err {err:.3e}")
            if dtype != "bfloat16":
                continue
            ms = time_ms(lambda: ops.fused_cuda(x, r, s), 100)
            plain_ms = time_ms(lambda: ops.fused_ref(x, r, s), 20)
            # library yardstick: the norm alone (F.rms_norm computes no
            # residual add, so it moves half the bytes)
            hh = x + r
            library_ms = time_ms(
                lambda: F.rms_norm(hh, (D,), s.to(dt), 1e-5), 100)
            nbytes = 4 * R * D * x.element_size() + D * 4
            t_bytes = nbytes / PEAK_BYTES * 1e3
            t_ops = 6.0 * R * D / PEAK_FP32_FLOPS * 1e3
            timed[R] = dict(
                name="fused_residual_rmsnorm", route="cuda",
                source="src/repro_torch/kernels/csrc/fused_norm.cu",
                replaces="src/repro/kernels/fused_norm/kernel.py:29",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_ops, t_bytes),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=library_ms,
                library_call="torch.nn.functional.rms_norm (norm only)",
                shape=[R, D], dtype="bfloat16")
            log("kernels", f"fused_residual_rmsnorm timed at R{R} D{D} "
                f"bf16: {ms:.4f} ms (plain {plain_ms:.4f}, F.rms_norm "
                f"{library_ms:.4f}, bound {timed[R]['bound_ms']:.4f} "
                f"by {timed[R]['bound_by']})")
    decode = dict(timed[8])
    decode["name"] = "fused_residual_rmsnorm@decode"
    return timed[8192], decode, cases


# --------------------------------------------------------------------------- #
# phase 4: serve
# --------------------------------------------------------------------------- #
def serve(seed: int, trace_path: Path):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.daemon import DaemonConfig, TracingDaemon
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.fused_norm import ops as fn
    from repro_torch.runtime.serve import ServeConfig, Server

    cfg = get_config("llama3.2-1b")
    B, S0, new = 8, 1024, 32
    server = Server(ServeConfig(model=cfg, batch=B, max_seq=2048, seed=seed,
                                log_path=str(trace_path)))
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S0)).astype(np.int32)
    fa.KERNEL.launches = 0
    fn.KERNEL.launches = 0
    t0 = time.perf_counter()
    out = server.generate(prompts, new_tokens=new)
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.KERNEL.launches,
                "fused_residual_rmsnorm": fn.KERNEL.launches}
    server.close()                      # detaches the daemon: final spill
    L = cfg.num_layers
    want = {"flash_attention": L, "fused_residual_rmsnorm": 2 * L * (1 + new)}
    log("serve", f"llama3.2-1b B{B} prompt {S0} new {new}: launches "
        f"{launches} (expected {want}); wall {wall:.3f} s")
    if launches != want:
        fail(f"launch counts {launches} != {want}")
    if out.shape != (B, S0 + new) or not np.array_equal(out[:, :S0], prompts):
        fail(f"generate returned {out.shape}, prompts not preserved")
    gen_toks = out[:, S0:]
    if gen_toks.min() < 0 or gen_toks.max() >= cfg.vocab_size:
        fail(f"token outside [0, {cfg.vocab_size})")

    # steady state, and the daemon's cost: the same server untraced and
    # with a daemon attached again (no spill), in turns
    def timed_generate():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.generate(prompts, new_tokens=new)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    walls = {"untraced": [], "traced": []}
    for mode in ("untraced", "traced", "traced", "untraced"):
        if mode == "traced":
            server.daemon = TracingDaemon(DaemonConfig(
                backend="dense-serve", hang_timeout=300.0)).attach()
        walls[mode].append(timed_generate())
        server.close()
    warm = min(walls["untraced"])
    # the same per launch: host time of one fused-norm call at the decode
    # shape, with and without a daemon attached, in turns
    x = torch.randn(B, cfg.d_model, device="cuda", dtype=torch.bfloat16)
    sc = torch.ones(cfg.d_model, device="cuda")
    per_call = {"untraced": [], "traced": []}
    for mode in ("untraced", "traced", "traced", "untraced"):
        d = (TracingDaemon(DaemonConfig(backend="dense-serve")).attach()
             if mode == "traced" else None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn.fused_residual_rmsnorm(x, x, sc)
        torch.cuda.synchronize()
        per_call[mode].append((time.perf_counter() - t0) / 2000 * 1e6)
        if d:
            d.detach()
    log("serve", f"fused_residual_rmsnorm call at R{B}, host us per call "
        f"(2000 calls): {per_call}")
    log("serve", f"second and later runs, generate wall s: {walls}; "
        f"tracing costs {min(walls['traced']) / warm - 1:+.2%} (best of 2 "
        f"each)")
    prof = {"prefill": profile(lambda: server.generate(prompts, 0)),
            "generate": profile(lambda: server.generate(prompts, new))}
    for part, p in prof.items():
        log("profile", f"{part}: wall {p['wall_s'] * 1e3:.3f} ms, device "
            f"busy {p['device_s'] * 1e3:.3f} ms, idle share "
            f"{p['idle_share']}")
        for k in p["top"]:
            log("profile", f"  {k['ms']:10.3f} ms {k['count']:6d}x "
                f"{k['name']}")
    del server
    torch.cuda.empty_cache()
    return dict(B=B, S0=S0, new=new, launches=launches, wall_s=wall,
                warm_wall_s=warm, walls=walls, per_call_us=per_call,
                profile=prof)


def profile(fn, top: int = 10) -> dict:
    """Device kernel time under torch.profiler beside the host wall time of
    one call; idle share = 1 - device busy / wall ("not measured" if the
    profiler saw no device time)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.autograd import DeviceType

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = []
    for item in prof.key_averages():
        if getattr(item, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(item, "self_device_time_total",
                     getattr(item, "self_cuda_time_total", 0.0))
        kernels.append(dict(name=item.key[:100], count=item.count,
                            ms=us / 1e3))
    kernels.sort(key=lambda k: -k["ms"])
    busy = sum(k["ms"] for k in kernels) / 1e3
    return dict(wall_s=wall, device_s=busy,
                idle_share=(1 - busy / wall) if busy > 0 else "not measured",
                top=kernels[:top])


def agreement(seed: int):
    """fp32 prefill logits: the kernel path on the card against the plain
    path on the CPU, same weights, B 1, S 64."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.fused_norm import ops as fn
    from repro_torch.models.layers import Policy
    from repro_torch.models.transformer import TransformerLM

    cfg = get_config("llama3.2-1b")
    pol = Policy(torch.float32)
    cpu = TransformerLM(cfg, pol, "cpu").init(
        torch.Generator().manual_seed(seed))
    gpu = TransformerLM(cfg, pol, "cuda").load_params(cpu.state_dict())
    toks = np.random.default_rng(seed + 1).integers(0, cfg.vocab_size, (1, 64))
    t = torch.as_tensor(toks, dtype=torch.long)
    n0 = (fa.KERNEL.launches, fn.KERNEL.launches)
    got = gpu.prefill(t.cuda(), gpu.init_cache(1, 64)).cpu()
    if (fa.KERNEL.launches, fn.KERNEL.launches) == n0:
        fail("fp32 agreement run did not launch the kernels")
    want = cpu.prefill(t, cpu.init_cache(1, 64))
    diff = (got - want).abs()
    err = float(diff.max())
    # the JAX package's model tests hold fp32 logits to rtol = atol = 2e-3
    ok = bool((diff <= 2e-3 + 2e-3 * want.abs()).all())
    same_argmax = bool((got.argmax(-1) == want.argmax(-1)).all())
    log("serve", f"fp32 prefill logits B1 S64, card kernels vs CPU plain: "
        f"max_abs_err {err:.3e} (|logits| max {float(want.abs().max()):.2f}, "
        f"rtol = atol = 2e-3: {ok}); argmax equal: {same_argmax}")
    if not (ok and same_argmax):
        fail("fp32 prefill logits disagree between card and CPU")
    del gpu, cpu
    torch.cuda.empty_cache()
    return err


# --------------------------------------------------------------------------- #
# phase 5: trace
# --------------------------------------------------------------------------- #
def check_trace(trace_path: Path, new: int):
    from collections import Counter
    from repro_torch.core.events import EventKind, load_jsonl

    events = load_jsonl(str(trace_path))
    kinds = Counter(e.kind.value for e in events)
    log("trace", f"{len(events)} events by kind: {dict(kinds)}")
    steps = {e.step: e for e in events if e.kind == EventKind.STEP}
    if sorted(steps) != list(range(new + 1)):
        fail(f"step spans {sorted(steps)} != 0..{new}")
    keys = {"flash_attention": {"flops", "shape"},
            "fused_residual_rmsnorm": {"flops", "bytes", "shape"}}
    comp = [e for e in events if e.kind == EventKind.KERNEL_COMPUTE]
    per_name = {}
    for name, want_keys in keys.items():
        evs = [e for e in comp if e.name == name]
        if not evs:
            fail(f"no k_comp span named {name}")
        if any(not want_keys <= set(e.meta) for e in evs):
            fail(f"{name} span lacks meta keys {want_keys}")
        if any(e.duration <= 0 for e in evs):
            fail(f"{name} span with device duration <= 0")
        if any(e.issue_latency < 0 for e in evs):
            fail(f"{name} span starts before its issue")
        if any(e.meta.get("parent") != f"step_{e.step}" for e in evs):
            fail(f"{name} span not nested under its step")
        per_name[name] = dict(n=len(evs),
                              device_s=sum(e.duration for e in evs))
    kern_s = sum(e.duration for e in comp)
    step_s = sum(e.duration for e in steps.values())
    log("trace", f"kernel spans {per_name}; kernels {kern_s:.6f} s of "
        f"{step_s:.6f} s step wall time")
    if kern_s > step_s:
        fail("kernel device time exceeds the steps' wall time")
    prefill = steps[0].duration
    decode = [steps[i].duration for i in range(1, new + 1)]
    return dict(prefill_s=prefill, decode_s=decode, per_name=per_name)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one card")
    # fp32 references in full fp32 (these are PyTorch's defaults for matmul)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the port's package is not at {src / 'repro_torch'}")
    sys.path.insert(0, str(src))
    from repro_torch.kernels import build_all
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.fused_norm import ops as fn

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    print(smi, flush=True)
    log("device", f"{torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    build_all([fa.KERNEL, fn.KERNEL])
    log("build", f"built {fa.KERNEL.source}, {fn.KERNEL.source} for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")
    for k in (fa.KERNEL, fn.KERNEL):
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"{k.source}: {line.strip()}")

    # 3. kernels
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    flash, flash_cases = check_flash(gen, "cuda")
    fused, fused_decode, fused_cases = check_fused(gen, "cuda")

    # 4. serve
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    trace_path = OUT_DIR / "serve_trace.jsonl"
    trace_path.unlink(missing_ok=True)
    run = serve(args.seed, trace_path)
    err = agreement(args.seed)

    # 5. trace
    tr = check_trace(trace_path, run["new"])
    B, new = run["B"], run["new"]
    dec = sorted(tr["decode_s"])
    dec_med = dec[len(dec) // 2] * 1e3
    log("serve", f"traced run: prefill step {tr['prefill_s'] * 1e3:.3f} ms "
        f"({B}x{run['S0']} tokens); decode step median {dec_med:.3f} ms, "
        f"min {dec[0] * 1e3:.3f}, max {dec[-1] * 1e3:.3f} over {len(dec)} "
        f"steps of {B} tokens ({B / dec_med * 1e3:.1f} tokens/s at the "
        f"median); generate wall {run['wall_s']:.3f} s traced (first run), "
        f"{run['warm_wall_s']:.3f} s untraced (best later run, "
        f"{B * new / run['warm_wall_s']:.1f} new tokens/s)")

    flash["launches"] = run["launches"]["flash_attention"]
    fused["launches"] = run["launches"]["fused_residual_rmsnorm"]
    fused_decode["launches"] = fused["launches"]
    details = dict(card=card, seed=args.seed, flash_cases=flash_cases,
                   fused_cases=fused_cases, fused_decode=fused_decode,
                   fp32_prefill_max_abs_err=err, serve=run,
                   trace=dict(prefill_s=tr["prefill_s"],
                              decode_s=tr["decode_s"],
                              per_name=tr["per_name"]))
    (OUT_DIR / "details.json").write_text(json.dumps(details, indent=1))
    print(json.dumps({"kernels": [flash, fused]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
