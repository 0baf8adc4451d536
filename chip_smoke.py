#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each printed on its own lines; any failure exits non-zero:
  1. device   — the card's name and power limit (nvidia-smi); whether
                zstandard imports (have_zstd); a FLARE daemon attached for
                the whole run (unpublished: the run's kernels do not report
                to it; no interceptor or gc callback), whose thread
                re-anchors its clock each loop on its own side stream, so
                every untraced wall of the run is taken beside its thread;
  2. build    — nvcc builds every kernel of the port from
                src/repro_torch/kernels/csrc/ (flash attention forward and
                backward, the SSD scan forward and the padded matmul, each
                a bf16 tensor-core kernel and an fp32 one in split TF32 on
                the tensor cores, "tf32x3"; the SSD backward the same; fused
                residual+RMSNorm and its backward, ring combine), one nvcc
                per source, all started together; registers and spills from
                ptxas, and the HGMMA / HMMA count of each library's SASS
                (the bf16 and tf32x3 routes must have HGMMA, and the
                fused-norm backward, which runs on the FP32 pipes, no
                tensor-core instruction, or the phase fails);
  3. kernels  — each kernel against its plain PyTorch version on the card,
                at its paths' shapes and, for the kernels with a bf16 and an
                fp32 route, on both routes and at the edges of the
                tensor-core kernels (fp32 3e-4, bf16 5e-2; the padded
                matmul's atol at least 2e-3·√K, and its fp32 route's error
                against an fp64 product at most half that of one TF32 pass;
                the ring combine bitwise,
                with its pinned progress counters read while a queued
                combine has not run), each call on the route of its dtype
                by the routes' launch counts, timed beside its plain version
                and a PyTorch library call where one computes the same
                function (the flash forward and backward in turns with it);
                a [kernels] line per tensor-core kernel (TFLOP/s, share of
                the bound, factor against the library, registers, spills,
                HGMMA / HMMA; the tf32x3 routes also their three passes'
                floor, their FP32-pipe bound and their scratch bytes, and two
                calls compared bitwise); flash forward and backward on both
                routes at head_dim 64, 80 (zamba2's) and 128 (the vlm's at
                G 4, dbrx's at G 6, arctic's at G 7, llama-20b-paper's at G
                5, qwen2-72b's at G 8, llama3-405b's at G 16), each timed at
                its serving and training shapes as lines of their own; the
                flash forward in fp32 at the edges and at group sizes 7 and
                1 too; the fused norm at D 2048, 1536, 2560, 896, 4096,
                6144, 7168, 5120, 8192 and 16384, its backward at the same
                widths but 1536 (the instances without the staging ring at
                D over 4096, the 1024-thread one at 16384), bf16 and fp32,
                the MoE and the last dense widths timed in both, the
                backward beside autograd of torch.add + F.rms_norm; the
                SSD scan and its
                backward
                at zamba2's shapes (H 80, N 64) too, timed
                (``at_zamba2``); the fp32 matmul in turns
                with torch.matmul fp32, at K or N off a multiple of 4 and on
                operands off 16 bytes; the SSD scan at N 64 on both routes;
                the flash backward
                on each route (the training shape in bf16 and fp32, the
                Case-3 drill's S 1024 in bf16, full attention, hd 128,
                ragged S, two fp32 calls compared bitwise) and the
                fused-norm backward (R 4096 D 2048, bf16 and fp32, and the
                Case-3 drill's R 8192 in bf16, with and without dh)
                against their plain
                versions, timed beside them; the flash backward of each
                route in turns with autograd of SDPA pinned to each backend
                that runs (flash, efficient, cuDNN; the fastest is the
                yardstick); the flash forward's time with its lse output
                beside its time without; the SSD backward on both routes
                (the training shape in bf16 and fp32, N 64, ragged L at
                chunk 256 and 128, a final-state cotangent, an initial
                state, H 12 and 20, which are not whole 8-head groups)
                against its plain version (``ssd_bwd_tol``), each timed at
                the training shape beside it, with the profiler's split by
                kernel and two calls compared bitwise, the tf32x3 route's
                [kernels] line with its three-pass design floor;
                the widths the JAX package runs beside the published ones
                (``check_widths``): its own kernel sweep shape for shape
                (flash, ``FLASH_REF_SWEEP``; the SSD scan in fp32 at 4e-4
                and in bf16; the fused norm forward and backward; the
                matmul's and the ring combine's in their checks above),
                flash forward and backward on both routes at head_dim 8,
                16 and 32 (the reduced configs' and the sweep's), the SSD
                forward and backward on both routes at head_dim 8 to 32
                and state 8 to 128 against the plain version at the
                requested chunk (16, 32, 48; the kernels run it at
                ``kernel_chunk``), the widths no kernel takes refused on
                CUDA tensors with nothing launched; flash at hd 8, 16 and
                32 timed at the serving and training shapes beside SDPA
                and cuDNN (hd 32's summary inside hd 16's, ``at_hd32``:
                no path runs it), and the SSD scan forward and backward at
                B 8, L 1024, H 48, P 16, N 16, each with its bound and the
                padded tiles' work factor;
  4. case2    — the Case-2 op as called: one traced padded_matmul at the
                paper's FFN shape (4096 x 8192 @ 8192 x 8484) in bf16 and
                one in fp32, each on its route by the launch counts, and
                their spans;
     ring     — 4 ranks on the card (launch/mesh.py, gloo through pinned
                host memory): a traced ring all-reduce of one 25 MB fp32
                bucket per rank, bitwise against the plain ring order, with
                its ring_combine launches and spans per rank; the hang
                drill (link f -> f+1 broken, f in 0, 2), whose live
                progress is read from the frozen combine counters; the
                all-reduce of a bucket of an odd size;
     diagnose — the port's diagnostic engine (``core/engine.py``, numpy)
                on traces the daemon took on the card, three drills of the
                paper, each printed with its anomaly report and the
                engine's host seconds (details.json ``diagnose``): the hang
                drills through ``on_hang`` (the published stacks and ring
                steps) and ``check_hangs`` (the ranks' spilled hang_suspect
                events), each a hang routed to operations naming link f ->
                f+1 with a unique minimum, then the supervisor's isolate and
                restart; Case 2, a traced ``ffn_matmul`` of 4096 x 8192 @
                8192 x N in bf16, 6 steps a job, the profile learned from a
                healthy job at N 8576 (steps 1-5), the drilled job at N
                8484 named a FLOPS regression routed to infrastructure with
                the layout advice 8484 -> 8512, the same product through
                padded_matmul printed; Case 3, llama3.2-1b through
                Trainer.train at B 8 x S 1024, 6 steps a job, healthy with
                the O(S) mask and prefetch, drilled with the O(S^2) mask and
                a synchronous loader, named a v_inter regression routed to
                algorithm; the phase fails only when a drill's anomaly is
                missing (or names another team or link); the drilled jobs
                of Case 2 and Case 3 also stream live into the fleet;
     fleet    — the port's fleet layer (``fleet/``, ``archive/``, numpy):
                Case 2's drilled and fixed jobs and Case 3's drilled job
                stream their daemons' drains live into one
                FleetMultiplexer (``attach_fleet``; watermark delay 1, the
                ``cross_job_failslow`` tier; the profiles the healthy jobs
                learned), spilling FCS into smoke_out/fleet/; each live
                job's anomalies equal to its batch engine's, field for
                field, with no late row; two more llama3.2-1b jobs at Case
                3's healthy setting, 12 steps each on one rack and switch,
                with a spawned co-runner process looping bf16 8192^3
                matmuls on the card before steps 7-10 (started and paused
                through a pipe): each job a fail_slow (throughput) at a
                step in 7-10 and none before, and the fleet tier's
                (fail_slow, cross_job_correlation, infrastructure) for both;
                the spill directory replayed serially, on 4 threads and on
                2 worker processes (``tools/fleet_replay.py`` in an
                interpreter of its own, no torch), each stream byte-equal
                to the live one; the trace archive's anomalies, per-step
                throughput (equal to the engines') and rollup sidecars
                (read back by a second archive), its fleet weather; each
                ring hang drill's four rank spills replayed as one 4-rank
                job, the hang declared once a majority reported and equal
                to ``on_hang`` on the same stacks; a [fleet] line per job
                (events, steps closed, anomalies, late rows, the fleet's
                host ms) and the daemons' widest anchor brackets;
     service  — the port's resident fleet service (``serve/``: FLW1
                socket plane, file tail, checkpoints, query plane), each
                service a spawned process that imports no torch, fed by two
                llama3.2-1b jobs (B 8 x S 1024) whose daemons' live sinks
                (``DaemonConfig.live_endpoint``) stream their drains:
                svc-a (Case 3 drilled, 6 steps) into L (2 process
                workers): L's stream equal to the replay of its spill,
                with the v_inter finding, one frame a spill segment, no
                drop, /jobs and /anomalies agreeing; svc-b (Case 3
                healthy, 16 steps) into R, SIGKILLed before step 3, and R'
                on R's port before step 5: drops and a reconnect counted,
                frames + drops = the spill's segments, R' re-HELLO'd and
                holding exactly the events sent after the reconnect; svc-b's
                spill tailed by T, checkpointed and SIGKILLed before step
                8, and T' restored past a garbage and a torn generation:
                every spill byte decoded once, the stitched stream equal to
                the replay; a [service] line a service and the phase's
                wall (details.json ``service``);
     simulate — the port's cluster simulator (``core/timeline.py``,
                ``core/injectors/``, ``scenarios/``: numpy, the H100's
                ceilings as ``program_from_config``'s defaults): the
                scenario matrix over qwen2-0.5b, llama3.2-1b, mamba2-780m
                and dbrx-132b at 32 ranks, held to the floors of
                ``benchmarks/scenarios.py`` (``SCENARIO_FLOORS``: every
                faulty cell caught with its team, culprit ranks and onset,
                healthy cells silent, micro precision >= 0.95, recall 1.0,
                6 scenarios and 8 fault kinds at least); the paper's scale,
                ``examples/torch_diagnose_cluster_sim.py``'s four jobs of
                llama-20b-paper at 1024 ranks (the underclocked rank 137,
                the misaligned FFN with its 8484 -> 8512 advice and the
                hang on link 611 -> 612 asserted; the GC-stall job printed
                only, as the reference misses it); and one process-mode
                service fed at once by four simulated 1024-rank jobs, one
                step a frame through a ``LiveClient`` from a thread (two
                with network jitter on rack0, an underclocked one and a
                healthy one on rack1), interleaved with svc-m, a traced
                llama3.2-1b job at Case 3's drilled setting on rack2
                streaming through its daemon's live sink: each job's
                stream equal to the replay of the five spills, the fleet
                tier's cross_job_correlation on rack0, rank 137's
                fail-slow, svc-m's v_inter, silence on the healthy job, no
                drop (details.json ``simulate``);
     parallel — the port's parallel plane (``launch/mesh.py``'s meshes,
                ``parallel/{sharding,pipeline}.py``, expert parallelism in
                ``models/moe.py``) on 4 ranks on the card (gloo through
                pinned host memory), each rank drawing the weights from
                --seed and keeping only its block (``Spec("stage")``,
                ``shard_experts``): llama3.2-1b's 16 blocks as a GPipe
                pipeline of 4 stages, 8 microbatches of [1, 1024] as the
                packed (h, x) pair, equal (torch.equal) to the blocks in
                order one microbatch at a time on this process; one
                dbrx-132b block through ``block_apply`` (B 2 x S 1024), its
                16 experts parallel on a (data 1, model 4) and a (data 2,
                model 2) mesh, the routing and kept slots identical to the
                local block's on each data shard and y within the bf16
                tolerance; walls beside the plain runs', the bubble share,
                the bytes a tick, the resident bytes a rank, and each
                path's launches of flash, the fused norm and the ring
                combine, by kernel counts and by the ranks' traced spans;
                llama3.2-1b whole, one prompt of 4096 tokens prefilled with
                ``attn_impl="cp"`` on a (data 1, model 4) mesh (1024 query
                rows a rank by ``chunked_attention``, the rows gathered by
                the ring all-gather: the fused norm and no flash launch a
                rank), its logits held to the one-process prefill's (the
                flash kernel) by ``SERVE_BF16_SCALED``; then, on the same
                ranks, llama3.2-1b whole through 2 steps of the mesh
                training step (``make_train_step(model, cfg, mesh=)``, its
                fp32 AdamW state ZeRO-sharded over a (data 2, model 2)
                mesh, B 8 x S 512, M 4), held to the one-process step on
                each rank in turn (``mesh_checks``: step 0's gradient and
                moments, step 1's update, each step's loss and grad_norm,
                each rank's resident optimizer bytes, its launches and its
                trace) (details.json ``parallel``);
  5. serve    — for each serving path (``PATHS``), llama3.2-1b (dense),
                mamba2-780m (ssm), zamba2-2.7b (hybrid), qwen2-0.5b (dense:
                qkv bias, tied head, G 7), musicgen-large (audio),
                llama-3.2-vision-11b (vlm), dbrx-132b and arctic-480b (moe:
                router top-k, sort-based dropping dispatch, the experts'
                SwiGLU in PyTorch), llama-20b-paper, qwen2-72b and
                llama3-405b (dense): Server.generate at full width, the
                depth cut where ``PATHS`` says (mamba2, musicgen and zamba2
                12 layers, the vlm 2 groups, dbrx 8 layers, arctic 2,
                qwen2-72b 5 and llama3-405b 2 (one card holds 30 and 8 of
                their layers' weights; cut further for time),
                llama-20b-paper 8 of 62) (batch 8,
                1024-token prompts, 32 new tokens, random weights from
                --seed; the vlm's gates opened to
                ``VLM_GATE`` and its vision embeddings a seeded draw) with
                the FLARE daemon attached (backend <family>-serve;
                llama3.2-1b's spilling FCS v2 with zlib named, rotated past
                4 KiB, an in-process sink and batch sink added before it
                attaches, and its traced generate's wall with each spill
                codec, in turns); the launch counts of that run (``forward_launches`` a prefill,
                the fused norms again a decode step: zamba2's cut flash 2,
                SSD scan 12, fused norm 16 x 33; qwen2 flash 24, fused 48 x
                33; musicgen's cut 12, 24 x 33; the vlm's cut 8, 20 x 33;
                dbrx's 8, 16 x 33; arctic's 2, 4 x 33; llama-20b-paper's cut
                8, 16 x 33; qwen2-72b's cut 5, 10 x 33; llama3-405b's cut
                2, 4 x 33); untraced and
                traced walls; a profiler breakdown; the vlm's prefill
                logits moving with its vision embeddings, and its prefill
                of one 4096-token prompt, S·T above 2^22, whose cross
                layers take ``chunked_attention`` (the first one's q/k/v
                also through ``direct_attention``, bf16 tolerance); fp32
                prefill
                logits on the card (the fp32 routes: flash and the SSD scan
                on tf32x3) against the plain path on the CPU (the vlm on
                its one-group cut, gates open; the moe paths on their
                training cuts, first the tokens whose expert ids or kept
                entries differ between card and CPU, with their top-k
                margins);
  6. train    — first one bf16 step of llama3.2-1b's training path under
                remat "none", "full" and "dots" (``remat_check``): the
                launches of each (remat runs each layer's forward kernels
                again) and whether loss and gradients are bitwise those of
                "none"; then for each training path (``TRAIN_PATHS``),
                llama3.2-1b,
                mamba2-780m, zamba2-2.7b, qwen2-0.5b, musicgen-large,
                llama-3.2-vision-11b cut to one group (4 self-attention
                layers and 1 cross layer), dbrx-132b cut to one layer,
                arctic-480b cut to one layer of 32 experts, and
                llama-20b-paper, qwen2-72b and llama3-405b cut (10, 6 and
                1 layers; one card holds 20, 6 and 1) on the JAX package's
                policy for them (fp32
                parameters and bf16 moments for the first, bf16 parameters
                for the others, remat "full" for all three; bf16 moments
                and a peak lr of 8e-5 for the two widest, where the
                policy's int8 moments diverge): Trainer.train at full
                width
                (B 8 x S 512, bf16 compute, the path's parameter and moment
                dtypes, remat and peak lr, fp32, "none" and 3e-4 where it
                names none, 12 traced steps, backend
                <family>-train): each step's loss, step time, tokens/s, MFU
                and the peak memory; the launch counts of every step (under
                remat the forward kernels twice)
                (llama: flash forward and backward 16, on the wgmma routes
                and none on tf32x3, fused forward and backward 32; mamba2
                cut to 24 of 48 layers for time: SSD forward and backward
                24 each on the wgmma routes, none on tf32x3, fused forward
                and backward 24; zamba2 cut to 12
                of 54 layers for time: flash forward and
                backward 2, SSD forward and backward 12, fused forward and
                backward 16; qwen2 24 and 48, musicgen cut to 24 of 48
                layers 24 and 48, the vlm cut 4 and 10; no plain version);
                the loss
                finite and falling; a profiler breakdown of one step; one
                fp32 step of the path's cut (llama, mamba2, qwen2 and
                musicgen 2 layers, zamba2 one group of 6 and its shared
                block, the vlm its one group with the gates open and seeded
                vision embeddings, the moe paths their training cuts with
                their routing compared first, llama-20b-paper 2 layers,
                qwen2-72b and llama3-405b 1, these three under remat
                "full"), card against CPU (loss,
                grad_norm, the
                path's gradients; the fp32 routes: flash and the SSD
                forward and backward on tf32x3; mamba2 and zamba2 at S 512,
                two chunks);
                on llama's path the spill in FCS v1, with an in-process sink
                and batch sink, and also 8 traced and 8 untraced steps in turn
                (the tracing overhead, with the steps' ranges) and a
                checkpoint saved and restored bitwise;
  7. trace    — each serving path's and each training run's spill read
                back (llama3.2-1b's FCS pieces through the port's store:
                ``log_paths`` all the pieces on disk, at least 3 in serving,
                their events the sink's, field for field and times bitwise,
                one segment a drain, each the batch sink's batch; the bytes
                per event of FCS v1, FCS v2 and JSONL for the same events;
                the others' JSONL): step spans and kernel spans with device
                durations from CUDA events (under remat the recompute's
                spans too); the training runs' dataloader and
                train_step_exec spans with their meta;
     daemon   — after the last training path, the daemon attached in phase
                1 traces 4 fused-norm calls: each span's issue latency >= 0
                and its duration its event pair's elapsed time; printed: the
                anchors its thread took during each training path, the
                widest anchor bracket, and the host time of an untraced
                fused-norm call with the daemon attached and after it
                detached;
  6b. reduced — every arch's reduced config, the JAX package's at its
                own widths (head_dim 16, 8 for qwen2-72b and llama3-405b;
                mamba2's and zamba2's SSD at P 16, N 16, chunk 16), on the
                card (``reduced_phase``): Server.generate (batch 2, prompt
                64, 8 new, traced, the trace read back), Trainer.train (3
                bf16 steps at B 2 x S 64, traced) and one fp32 step, each
                kernel launched as often as the run needs and no plain
                version called; fp32 prefill logits (S 64) against the
                port's CPU run (rtol = atol = 2e-3, argmax equal); then
                ``python -m repro_torch.launch.serve --reduced`` and
                ``... .train --reduced`` (zamba2-2.7b) in processes of
                their own (``tools/reduced_check.py`` runs the phase
                alone);
  8. dryrun   — ``repro_torch.launch.dryrun``'s cells, in a process of
                their own started before phase 3 (meta tensors, no device:
                it runs on the host's CPU beside the card's phases): every
                cell of ``configs.cells()`` on the 16 x 16 and the 2 x 16 x
                16 production meshes, an ``OK`` row each, printed here
                (any ``FAIL`` fails the phase; JSON in smoke_out/dryrun/);
                then its op analysis on one chip of
                llama3.2-1b's training step (B 8 x S 512) and prefill (8 x
                1024) against their medians timed on the card: the counted
                flops at 989 TFLOP/s may not exceed the measured time by
                more than 5 % (printed: compute term / measured, the counted
                MFU, and memory term / measured, not held)
                (details.json ``dryrun``; ``tools/dryrun_check.py`` runs
                the phase alone).
The wall time of each phase and of the whole run is printed ([wall]).
The traces and a details.json are written to smoke_out/.
The line before the last is the per-kernel JSON summary; the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import atexit
import functools
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "smoke_out"

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 and TF32 tensor cores,
# fp32 pipes, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
def terms(work: dict, peak: float) -> tuple:
    """(operations ms, bytes ms) of a kernel's ``work`` (its ``ops.py``'s
    ``work``, which the op analysis charges too): its products at
    ``peak`` (the route's tensor-core rate) plus its other arithmetic at
    the FP32 pipes' rate, and its bytes at the HBM rate."""
    return ((work["flops"] / peak + work["ops"] / PEAK_FP32_FLOPS) * 1e3,
            work["bytes"] / PEAK_BYTES * 1e3)


def bound(work: dict, peak: float) -> tuple:
    """(bound ms, by what) of a kernel's ``work``: the larger of
    ``terms``."""
    t_ops, t_bytes = terms(work, peak)
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


TOLS = {"float32": dict(rtol=3e-4, atol=3e-4),
        "bfloat16": dict(rtol=5e-2, atol=5e-2)}


def fail(msg: str):
    """Print the failure to stdout and to stderr (a caller that keeps only
    one stream's tail still sees why), and exit 1."""
    print(f"FAIL: {msg}", flush=True)
    print(f"chip_smoke.py FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(phase: str, msg: str):
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, iters: int, warmup: int = 3,
            behind_sleep: bool = False) -> float:
    """Mean device time of one call of ``fn`` over ``iters`` calls.  With
    ``behind_sleep``, for calls whose host cost exceeds their device time,
    a sleep queued first keeps the card busy while the host queues all the
    calls, which then run back to back between the two events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    if behind_sleep:
        torch.cuda._sleep(200_000_000)      # ~0.1 s at the card's clock
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def max_err(got, want, dtype: str, tol: dict | None = None) -> float:
    """Max |got - want|; fails unless |got - want| <= atol + rtol*|want|
    (``tol``, else the dtype's)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    tol = tol or TOLS[dtype]
    bad = diff > tol["atol"] + tol["rtol"] * w.abs()
    if not bool(g.isfinite().all()):
        raise AssertionError("kernel output is not finite")
    if bool(bad.any()):
        raise AssertionError(
            f"{int(bad.sum())} elements outside tolerance {tol}; "
            f"max abs err {float(diff.max()):.3e}")
    return float(diff.max())


def scaled_err(got, want, frac: float) -> float:
    """max|got - want| / max|want|; fails above ``frac``.  Holds a bf16
    output to its own scale, where the elementwise bf16 tolerance would
    pass an error of half a typical value."""
    diff = float((got.float() - want.float()).abs().max())
    rel = diff / max(float(want.float().abs().max()), 1e-30)
    if rel > frac:
        raise AssertionError(f"max abs err {diff:.3e} is {rel:.3e} of the "
                             f"largest magnitude, above {frac}")
    return rel


def ptxas_usage(build_log: str) -> list[dict]:
    """Registers and spill bytes per entry function, from the ``-Xptxas
    -v`` lines of a build log."""
    import re
    out = []
    for m in re.finditer(
            r"Compiling entry function '([^']+)'.*?"
            r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?"
            r"Used (\d+) registers", build_log, re.S):
        out.append(dict(function=m.group(1), spill_stores=int(m.group(2)),
                        spill_loads=int(m.group(3)),
                        registers=int(m.group(4))))
    return out


def sass_mma(kernel) -> dict:
    """How many tensor-core instructions ``cuobjdump -sass`` finds in the
    kernel's built library: HGMMA (wgmma) and HMMA (mma.sync)."""
    from repro_torch.kernels import _lib_path, find_nvcc
    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(_lib_path(kernel.source))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    return {op: sass.count(op) for op in ("HGMMA", "HMMA")}


def on_route(kernels: dict, route: str, fn):
    """Call ``fn``; fail unless it launched the kernel of ``route`` once and
    no other route's kernel."""
    before = {r: k.launches for r, k in kernels.items()}
    out = fn()
    ran = {r: k.launches - before[r] for r, k in kernels.items()}
    if ran != {r: int(r == route) for r in kernels}:
        fail(f"expected one launch on the {route} route, got {ran}")
    return out


def tensor_core_fields(summary: dict, kernel, flops: float,
                       route: str = "wgmma") -> dict:
    """The fields of a tensor-core kernel's [kernels] line: TFLOP/s, share of
    the bound (and of the design's floor, where the summary has one),
    factor against the library call (where there is one), ptxas registers
    and spills, HGMMA and HMMA in the SASS."""
    ms = summary["ms"]
    sass = sass_mma(kernel)
    lib = summary["library_ms"]
    fields = dict(tflops=flops / ms / 1e9,
                  bound_fraction=summary["bound_ms"] / ms,
                  library_factor=ms / lib if lib else None,
                  ptxas=ptxas_usage(kernel.build_log),
                  hgmma=sass["HGMMA"], hmma=sass["HMMA"])
    if not (fields["hgmma"] or fields["hmma"]):
        fail(f"{kernel.source}: no HGMMA or HMMA in its SASS, so its "
             f"{route} route does not run on the tensor cores")
    floor = ""
    if "design_floor_ms" in summary:
        fields["design_floor_fraction"] = summary["design_floor_ms"] / ms
        floor = (f", {fields['design_floor_fraction']:.3f} of the design's "
                 f"floor ({summary['design_floor_ms']:.4f} ms)")
    summary.update(fields)
    regs = ", ".join(f"{u['registers']} registers, {u['spill_stores']}/"
                     f"{u['spill_loads']} bytes spilled (stores/loads)"
                     for u in fields["ptxas"])
    versus = (f"{fields['library_factor']:.2f}x {summary['library_call']}"
              if lib else "no library call")
    log("kernels", f"{summary['name']} [{route}] "
        f"{ms:.4f} ms = {fields['tflops']:.1f} TFLOP/s, "
        f"{fields['bound_fraction']:.3f} of the bound "
        f"({summary['bound_ms']:.4f} ms){floor}, {versus}; ptxas: {regs}; "
        f"HGMMA / HMMA in the SASS: {fields['hgmma']} / {fields['hmma']}")
    return summary


# --------------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------- #
# flash attention at the paths' shapes (llama's hd 64, zamba2's hd 80 over
# 32 KV heads) and at the kernels' edges (S of 1, 63 and 129 around their
# tiles, hd 64, 80 and 128), both routes
FLASH_SHAPES = [(8, 1024, 32, 8, 64), (8, 1000, 32, 8, 64),
                (2, 1000, 16, 4, 128), (8, 1024, 32, 32, 80),
                (2, 1000, 32, 32, 80)]
# group sizes G = H/KV other than the paths' 4: 7 (qwen2's 14 over 2) and 1
# (musicgen's 32 over 32), head_dim 64; at head_dim 128, 6 (dbrx's 48 over
# 8), 7 (arctic's 56 over 8), 5 (llama-20b-paper's 40 over 8), 8
# (qwen2-72b's 64 over 8) and 16 (llama3-405b's 128 over 8)
FLASH_GROUPS = [(2, 512, 14, 2, 64), (2, 512, 32, 32, 64),
                (2, 512, 48, 8, 128), (2, 333, 56, 8, 128),
                (2, 512, 40, 8, 128), (2, 333, 64, 8, 128),
                (2, 200, 128, 8, 128)]
FLASH_EDGES = [(2, S, 16, 4, hd) for S in (1, 63, 129)
               for hd in (64, 80, 128)]
# the JAX package's own flash sweep (tests/test_kernels.py), shape for
# shape, and the narrow head_dims of its reduced configs (16; 8 for
# qwen2-72b and llama3-405b) at the sweep's shape, the reduced configs'
# shapes (G 4 and 2), ragged S and S 1, both routes
FLASH_REF_SWEEP = [(1, 256, 4, 2, 64), (2, 384, 6, 3, 32),
                   (1, 128, 2, 1, 128)]
FLASH_NARROW = [(2, 384, 6, 3, 8), (2, 384, 6, 3, 16), (2, 64, 4, 1, 16),
                (2, 64, 8, 2, 8), (2, 129, 4, 4, 16), (2, 1, 4, 2, 8),
                (2, 200, 16, 4, 32)]
# the serving paths' flash shapes, each timed on both routes: llama3.2-1b
# (hd 64; qwen2-0.5b and musicgen-large take hd 64 too, at G 7 and 1),
# zamba2-2.7b (hd 80), llama-3.2-vision-11b (hd 128, G 4), dbrx-132b (hd
# 128, G 6), arctic-480b (hd 128, G 7), llama-20b-paper (G 5), qwen2-72b
# (G 8) and llama3-405b (G 16); then the narrow head_dims at llama's
# serving shape: 8 and 16 (the reduced configs'; their launches are the
# ``reduced`` phase's) and 32 (the JAX sweep's, on no path: its timing
# rides in hd 16's summary as ``at_hd32``)
FLASH_TIMED = [(8, 1024, 32, 8, 64), (8, 1024, 32, 32, 80),
               (8, 1024, 32, 8, 128), (8, 1024, 48, 8, 128),
               (8, 1024, 56, 8, 128), (8, 1024, 40, 8, 128),
               (8, 1024, 64, 8, 128), (8, 1024, 128, 8, 128),
               (8, 1024, 32, 8, 8), (8, 1024, 32, 8, 16),
               (8, 1024, 32, 8, 32)]


def by_hd(name: str, hd: int, G: int | None = None) -> str:
    """A kernel's name in the summary line: hd 64's as it is, others with
    the head dim appended, and a group size G = H/KV when given."""
    name = name if hd == 64 else f"{name}_hd{hd}"
    return name if G is None else f"{name}_g{G}"


def flash_key(shapes: list, B, S, H, KV, hd) -> tuple:
    """The summary key (head_dim, G) of a timed flash shape, G None for
    the first shape of its head_dim; a path's launches go to the key of
    its (head_dim, G) if timed, else to its head_dim's first."""
    G = H // KV
    first = next(sh for sh in shapes if sh[4] == hd)
    return (hd, None if first[2] // first[3] == G else G)


def path_flash_key(keys, hd: int, G: int) -> tuple:
    return (hd, G) if (hd, G) in keys else (hd, None)


def check_flash(gen, device):
    """Every shape on the route of its dtype against ``attention_ref``; the
    serving shapes (``FLASH_TIMED``) timed on both routes (the fp32 one,
    split TF32, in turns with SDPA fp32).  Returns the summaries by (route,
    head_dim, G: None but where ``flash_key`` names one) and the cases."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops

    def qkv(B, S, H, KV, hd, dt):
        return (torch.randn(B, S, H, hd, generator=gen, device=device).to(dt),
                torch.randn(B, S, KV, hd, generator=gen, device=device).to(dt),
                torch.randn(B, S, KV, hd, generator=gen, device=device).to(dt))

    cases = []
    for (B, S, H, KV, hd), dtype in (
            (sh, d) for sh in (FLASH_SHAPES + FLASH_EDGES + FLASH_GROUPS
                               + FLASH_REF_SWEEP + FLASH_NARROW)
            for d in ("bfloat16", "float32")):
        for causal in (True, False):
            dt = getattr(torch, dtype)
            q, k, v = qkv(B, S, H, KV, hd, dt)
            route = ops.route(dt, hd)
            got = on_route(ops.KERNELS, route,
                           lambda: ops.attention_cuda(q, k, v, causal))
            want = ops.attention_ref(q, k, v, causal)
            torch.cuda.synchronize()
            err = max_err(got, want, dtype)
            cases.append(dict(shape=[B, S, H, KV, hd], dtype=dtype,
                              causal=causal, route=route, max_abs_err=err))
            log("kernels", f"flash_attention B{B} S{S} H{H} KV{KV} hd{hd} "
                f"{dtype} causal={causal} [{route}]: max_abs_err {err:.3e}")

    # the serving paths' shapes, timed on each route
    summaries = {}
    for (B, S, H, KV, hd), dtype in itertools.product(
            FLASH_TIMED, ("bfloat16", "float32")):
        key = flash_key(FLASH_TIMED, B, S, H, KV, hd)
        flops = ops.work(B, S, H, KV, hd, True)["flops"]
        dt = getattr(torch, dtype)
        q, k, v = qkv(B, S, H, KV, hd, dt)
        route = ops.route(dt, hd)
        err = max_err(ops.attention_cuda(q, k, v, True),
                      ops.attention_ref(q, k, v, True), dtype)
        plain_ms = time_ms(lambda: ops.attention_ref(q, k, v, True), 5)
        # library yardstick: SDPA on [B,H,S,hd] with the KV heads expanded
        # beforehand (outside the timed call)
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous()
        fns = {"kernel": lambda: ops.attention_cuda(q, k, v, True),
               "sdpa": lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True)}
        if route == "wgmma":
            ms, library_ms = (time_ms(fn, 20) for fn in fns.values())
        else:
            ms, library_ms = in_turns(fns, 20).values()
        peak = PEAK_BF16_FLOPS if route == "wgmma" else PEAK_TF32_FLOPS
        t_ops, t_bytes = terms(ops.work(B, S, H, KV, hd, True,
                                        q.element_size()), peak)
        summaries[(route, *key)] = summary = dict(
            name=by_hd("flash_attention"
                       + ("" if route == "wgmma" else "_" + route), *key),
            route="cuda",
            source=f"src/repro_torch/kernels/csrc/{ops.KERNELS[route].source}",
            replaces="src/repro/kernels/flash_attention/kernel.py:61",
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=library_ms,
            library_call="torch.nn.functional.scaled_dot_product_attention",
            shape=[B, S, H, KV, hd], dtype=dtype, causal=True, flops=flops,
            padded_work_factor=flash_padded_factor(route, hd, False))
        if route == "tf32x3":
            # three TF32 passes a product: the design's floor; and the bound
            # of the FP32 pipes that the earlier fp32 kernel ran on
            summary.update(
                design_floor_ms=max(3 * t_ops, t_bytes),
                fp32_pipe_bound_ms=flops / PEAK_FP32_FLOPS * 1e3,
                scratch_bytes=ops.tf32_scratch_bytes(B, S, H, KV, hd, False))
        log("kernels", f"flash_attention [{route}] timed at B{B} S{S} H{H} "
            f"KV{KV} hd{hd} {dtype} causal: {ms:.4f} ms (plain "
            f"{plain_ms:.4f}, SDPA {library_ms:.4f}"
            f"{'' if route == 'wgmma' else ' in turns'}, bound "
            f"{summary['bound_ms']:.4f} by {summary['bound_by']} at the "
            f"{'bf16' if route == 'wgmma' else 'TF32'} tensor-core peak"
            + (f"; scratch {summary['scratch_bytes']} bytes"
               if route == "tf32x3" else "") + ")")
        del q, k, v, qt, kt, vt
        tensor_core_fields(summary, ops.KERNELS[route], flops, route)
    fold_hd32(summaries)
    return summaries, cases


def fold_hd32(summaries: dict):
    """Move each route's hd 32 summary (the JAX sweep's width, on no
    path) into its hd 16 summary as ``at_hd32``, out of the kernels line."""
    for route in ("wgmma", "tf32x3"):
        summaries[route, 16, None]["at_hd32"] = summaries.pop(
            (route, 32, None))


# the paths' widths: llama3.2-1b and musicgen-large, mamba2-780m,
# zamba2-2.7b, qwen2-0.5b, llama-3.2-vision-11b, dbrx-132b, arctic-480b,
# llama-20b-paper, qwen2-72b, llama3-405b
FUSED_WIDTHS = (2048, 1536, 2560, 896, 4096, 6144, 7168, 5120, 8192, 16384)
# the widths timed in fp32 too (the MoE paths' and the last dense ones',
# whose fp32 agreement runs take the fp32 instances)
FUSED_FP32_TIMED = (6144, 7168, 5120, 8192, 16384)


def check_fused(gen, device):
    """Checked and timed at the serving paths' widths (``FUSED_WIDTHS``),
    prefill (R 8192) and decode (R 8) rows, bf16 (and fp32 at
    ``FUSED_FP32_TIMED``).  Returns the llama prefill summary and the
    others by "R<R> D<D>" (" fp32" appended for the fp32 ones)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.fused_norm import ops

    cases, timed = [], {}
    for D in FUSED_WIDTHS:
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
                if dtype != "bfloat16" and D not in FUSED_FP32_TIMED:
                    continue
                # at R 8 a launch costs more host time than the device
                # needs, so these times are the host's per-call cost
                ms = time_ms(lambda: ops.fused_cuda(x, r, s), 100)
                plain_ms = time_ms(lambda: ops.fused_ref(x, r, s), 20)
                # no single PyTorch call computes residual add + RMSNorm:
                # F.rms_norm alone is the norm (half the bytes), and
                # torch.add then F.rms_norm is the function in two calls
                hh = x + r
                sd = s.to(dt)
                norm_only_ms = time_ms(
                    lambda: F.rms_norm(hh, (D,), sd, 1e-5), 100)
                two_call_ms = time_ms(
                    lambda: F.rms_norm(torch.add(x, r), (D,), sd, 1e-5), 100)
                t_ops, t_bytes = terms(ops.work(R, D, x.element_size()),
                                       PEAK_BF16_FLOPS)
                timed[(R, D, dtype)] = t = dict(
                    name="fused_residual_rmsnorm", route="cuda",
                    source="src/repro_torch/kernels/csrc/fused_norm.cu",
                    replaces="src/repro/kernels/fused_norm/kernel.py:29",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=max(t_ops, t_bytes),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    library_ms=None, library_call=None,
                    norm_only_ms=norm_only_ms, two_call_ms=two_call_ms,
                    shape=[R, D], dtype=dtype)
                log("kernels", f"fused_residual_rmsnorm timed at R{R} D{D} "
                    f"{dtype}: {ms:.4f} ms (plain {plain_ms:.4f}; no single "
                    f"library call: F.rms_norm alone {norm_only_ms:.4f}, "
                    f"torch.add + F.rms_norm {two_call_ms:.4f}; bound "
                    f"{t['bound_ms']:.5f} by {t['bound_by']})")
    main = timed.pop((8192, 2048, "bfloat16"))
    return main, {f"R{R} D{D}" + ("" if d == "bfloat16" else " fp32"): t
                  for (R, D, d), t in timed.items()}, cases


TRAIN_B, TRAIN_S = 8, 512
CASE3_S = 1024           # the naive O(S^2) mask a third of a step or more
# the flash backward: the training shape (bf16, causal) and the same in
# fp32, the Case-3 drill's (S ``CASE3_S``, bf16), each route's masking (full attention, ragged S, hd 128), group sizes
# 7 and 1 (``FLASH_GROUPS``), zamba2's training shape (hd 80 over 32 KV
# heads) and hd 80 at ragged S; each with its forward's lse
FLASH_BWD_CASES = [((8, 512, 32, 8, 64), "bfloat16", True),
                   ((8, 512, 32, 8, 64), "float32", True),
                   ((TRAIN_B, CASE3_S, 32, 8, 64), "bfloat16", True),
                   ((2, 256, 16, 4, 64), "bfloat16", False),
                   ((2, 256, 16, 4, 64), "float32", True),
                   ((2, 256, 16, 4, 128), "bfloat16", True),
                   ((2, 256, 16, 4, 128), "float32", False),
                   ((2, 200, 16, 4, 64), "bfloat16", True),
                   ((2, 200, 16, 4, 64), "float32", False),
                   ((2, 77, 8, 2, 128), "bfloat16", False),
                   ((2, 333, 8, 2, 128), "bfloat16", True),
                   ((2, 256, 14, 2, 64), "bfloat16", True),
                   ((2, 256, 14, 2, 64), "float32", True),
                   ((2, 256, 32, 32, 64), "bfloat16", False),
                   ((2, 256, 32, 32, 64), "float32", False),
                   ((8, 512, 32, 32, 80), "bfloat16", True),
                   ((8, 512, 32, 32, 80), "float32", True),
                   ((2, 77, 8, 2, 80), "bfloat16", False),
                   ((2, 333, 8, 2, 80), "bfloat16", True),
                   ((2, 77, 8, 2, 80), "float32", True),
                   ((2, 333, 16, 4, 80), "float32", False),
                   ((2, 256, 48, 8, 128), "bfloat16", True),
                   ((2, 256, 48, 8, 128), "float32", True),
                   ((2, 333, 56, 8, 128), "bfloat16", True),
                   ((2, 200, 56, 8, 128), "float32", False),
                   ((2, 256, 40, 8, 128), "bfloat16", True),
                   ((2, 200, 40, 8, 128), "float32", True),
                   ((2, 333, 64, 8, 128), "bfloat16", True),
                   ((2, 256, 64, 8, 128), "float32", False),
                   ((2, 129, 128, 8, 128), "bfloat16", False),
                   ((2, 256, 128, 8, 128), "float32", True)]
# the flash backward at the JAX sweep's shapes (FLASH_REF_SWEEP) and at
# head_dim 8 and 16 on the sweep's shape, each dtype and causal value; the
# reduced configs' shapes and ragged S
FLASH_BWD_CASES += [(sh, d, c) for sh in FLASH_REF_SWEEP
                    + [(2, 384, 6, 3, 8), (2, 384, 6, 3, 16)]
                    for d in ("bfloat16", "float32") for c in (True, False)]
FLASH_BWD_CASES += [((2, 64, 4, 1, 16), "bfloat16", True),
                    ((2, 64, 4, 1, 16), "float32", True),
                    ((2, 64, 8, 2, 8), "bfloat16", True),
                    ((2, 64, 8, 2, 8), "float32", True),
                    ((2, 77, 4, 4, 16), "bfloat16", False),
                    ((2, 77, 4, 4, 16), "float32", True),
                    ((2, 200, 16, 4, 32), "float32", True)]
# the training paths' flash shapes, each timed on both routes: llama3.2-1b
# (hd 64), zamba2-2.7b (hd 80), llama-3.2-vision-11b (hd 128, G 4),
# dbrx-132b (hd 128, G 6), arctic-480b (hd 128, G 7), llama-20b-paper (G
# 5), qwen2-72b (G 8) and llama3-405b (G 16)
FLASH_BWD_TIMED = [(8, 512, 32, 8, 64), (8, 512, 32, 32, 80),
                   (8, 512, 32, 8, 128), (8, 512, 48, 8, 128),
                   (8, 512, 56, 8, 128), (8, 512, 40, 8, 128),
                   (8, 512, 64, 8, 128), (8, 512, 128, 8, 128),
                   (8, 512, 32, 8, 8), (8, 512, 32, 8, 16),
                   (8, 512, 32, 8, 32)]
# a bf16 backward output: at most this fraction of its largest magnitude
# off the plain version (one bf16 rounding of the largest is 2^-7 of it)
BWD_BF16_SCALED = 1e-2
# the SDPA backends timed as the flash backward's yardstick
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")


def in_turns(fns: dict, iters: int, **kw) -> dict:
    """Each callable's mean device time (``time_ms(fn, iters, **kw)``),
    best of two, timed in the order given and then reversed (a, b, c, c,
    b, a), so that a drift of the card's clock weighs on all alike."""
    names = list(fns)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(time_ms(fns[n], iters, **kw))
    return {n: min(t) for n, t in times.items()}


def sdpa_backward_fns(q, k, v, do, causal) -> dict:
    """For each SDPA backend of ``SDPA_BACKENDS`` that takes these inputs,
    a callable that computes the backward of attention: autograd of
    ``scaled_dot_product_attention`` pinned to the backend with
    ``sdpa_kernel``, the KV heads expanded and the forward run beforehand.
    A yardstick only: the port never calls SDPA."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    H, KV = q.shape[2], k.shape[2]
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k.repeat_interleave(H // KV, dim=2),
                            v.repeat_interleave(H // KV, dim=2)))
    dot = do.transpose(1, 2).contiguous()
    fns = {}
    for name in SDPA_BACKENDS:
        try:
            with sdpa_kernel(getattr(SDPBackend, name)):
                out = F.scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=causal)
            torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
        except RuntimeError:
            continue            # the backend does not take these inputs
        fns[name.lower()] = (lambda out=out: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True))
    return fns


def time_flash_bwd(ops, q, k, v, do, causal, iters):
    """The backward kernel of q's dtype and each SDPA backend's backward
    that runs, in turns, each behind a queued sleep (autograd's host cost
    per call exceeds the device time of SDPA's backward, so timed back to
    back its calls would measure the host); (kernel ms, {backend: ms})."""
    o, lse = ops.attention_cuda(q, k, v, causal, return_lse=True)
    fns = {"kernel": lambda: ops.attention_bwd_cuda(q, k, v, o, do, lse,
                                                    causal)}
    fns.update(sdpa_backward_fns(q, k, v, do, causal))
    times = in_turns(fns, iters, behind_sleep=True)
    return times.pop("kernel"), times


def check_flash_bwd(gen, device):
    """The flash backward against ``attention_bwd_ref`` and the forward's
    lse against ``attention_ref``'s, each call on the route of its dtype
    (one launch of that route's kernel, none of the other); each route
    timed at the training shapes (``FLASH_BWD_TIMED``) beside its plain
    version and, in turns (at least 50 iterations each), beside autograd of
    SDPA pinned to each backend that runs (the fastest is ``library_ms``);
    the forward's time with lse beside its time without, at llama's
    training and serving shapes.  Two fp32 (tf32x3) backward calls of each
    case must be bitwise equal.  Returns the summaries by (route,
    head_dim, G: as ``check_flash``'s) and the cases."""
    import torch
    from repro_torch.kernels.flash_attention import ops

    cases = []
    for (B, S, H, KV, hd), dtype, causal in FLASH_BWD_CASES:
        dt = getattr(torch, dtype)
        q, k, v, do = (torch.randn(B, S, n, hd, generator=gen,
                                   device=device).to(dt)
                       for n in (H, KV, KV, H))
        route = ops.route(dt, hd)
        o, lse = on_route(ops.KERNELS, route, lambda: ops.attention_cuda(
            q, k, v, causal, return_lse=True))
        got = on_route(ops.BWD_KERNELS, ops.BWD_ROUTES[dt],
                       lambda: ops.attention_bwd_cuda(q, k, v, o, do, lse,
                                                      causal))
        _, lse_ref = ops.attention_ref(q, k, v, causal, return_lse=True)
        want = ops.attention_bwd_ref(q, k, v, o, do, lse, causal)
        torch.cuda.synchronize()
        errs = [max_err(lse, lse_ref, "float32")] + [
            max_err(g, w, dtype) for g, w in zip(got, want)]
        case = dict(shape=[B, S, H, KV, hd], dtype=dtype, causal=causal,
                    route=ops.BWD_ROUTES[dt],
                    max_abs_err=dict(zip(("lse", "dq", "dk", "dv"), errs)))
        scaled = ""
        if dtype == "float32":
            again = ops.attention_bwd_cuda(q, k, v, o, do, lse, causal)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"two fp32 flash backward calls differ at B{B} S{S} "
                     f"H{H} KV{KV} hd{hd} causal={causal}")
            case["bitwise_repeat"] = True
            scaled = "; a second call bitwise equal"
            del again
        if dtype == "bfloat16":
            rel = [scaled_err(g, w, BWD_BF16_SCALED)
                   for g, w in zip(got, want)]
            case["scaled_err"] = dict(zip(("dq", "dk", "dv"), rel))
            scaled = (f"; of the largest magnitude dq {rel[0]:.2e}, dk "
                      f"{rel[1]:.2e}, dv {rel[2]:.2e} (at most "
                      f"{BWD_BF16_SCALED})")
        cases.append(case)
        log("kernels", f"flash_attention backward [{case['route']}] B{B} S{S}"
            f" H{H} KV{KV} hd{hd} {dtype} causal={causal}: max_abs_err lse "
            f"{errs[0]:.3e} (fwd [{route}]), dq {errs[1]:.3e}, dk "
            f"{errs[2]:.3e}, dv {errs[3]:.3e}{scaled}")
        del q, k, v, do, o, lse, got, want

    summaries = {}
    for (B, S, H, KV, hd), dtype in itertools.product(
            FLASH_BWD_TIMED, ("bfloat16", "float32")):
        key = flash_key(FLASH_BWD_TIMED, B, S, H, KV, hd)
        dt = getattr(torch, dtype)
        r = ops.BWD_ROUTES[dt]
        q, k, v, do = (torch.randn(B, S, n, hd, generator=gen,
                                   device=device).to(dt)
                       for n in (H, KV, KV, H))
        o, lse = ops.attention_cuda(q, k, v, True, return_lse=True)
        pairs = list(zip(ops.attention_bwd_cuda(q, k, v, o, do, lse, True),
                         ops.attention_bwd_ref(q, k, v, o, do, lse, True)))
        err = max(max_err(g, w, dtype) for g, w in pairs)
        if dtype == "bfloat16":
            for g, w in pairs:
                scaled_err(g, w, BWD_BF16_SCALED)
        del pairs
        ms, sdpa = time_flash_bwd(ops, q, k, v, do, True, 50)
        if not sdpa:
            fail(f"no SDPA backend computes the {dtype} backward")
        plain_ms = time_ms(lambda: ops.attention_bwd_ref(q, k, v, o, do, lse,
                                                         True), 3)
        fastest = min(sdpa, key=sdpa.get)
        peak = PEAK_BF16_FLOPS if r == "wgmma" else PEAK_TF32_FLOPS
        bound_ms, bound_by = bound(ops.work(B, S, H, KV, hd, True,
                                            q.element_size(), backward=True),
                                   peak)
        # the function's five products; both designs do seven (S and dP in
        # both of their kernels), whose floor is 1.4x the operations bound,
        # and tf32x3 three TF32 passes of each
        flops = ops.work(B, S, H, KV, hd, True, backward=True)["flops"]
        passes = 1 if r == "wgmma" else 3
        summaries[(r, *key)] = summary = dict(
            name=by_hd("flash_attention_bwd"
                       + ("" if r == "wgmma" else "_" + r), *key),
            route="cuda",
            source=f"src/repro_torch/kernels/csrc/{ops.BWD_KERNELS[r].source}",
            replaces="src/repro/models/attention.py:164 (XLA recompute "
            "backward; port-only: the reference's backward has no Pallas "
            "kernel)", max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=sdpa[fastest],
            library_call=f"autograd of torch.nn.functional."
            f"scaled_dot_product_attention pinned to the {fastest} backend "
            f"(KV heads expanded)", sdpa_backward_ms=sdpa,
            design_floor_ms=max(bound_ms, passes * 1.4 * flops / peak * 1e3),
            shape=[B, S, H, KV, hd], dtype=dtype, causal=True, flops=flops,
            padded_work_factor=flash_padded_factor(r, hd, True))
        if r == "tf32x3":
            summary.update(
                fp32_pipe_bound_ms=bound(ops.work(
                    B, S, H, KV, hd, True, 4, backward=True),
                    PEAK_FP32_FLOPS)[0],
                scratch_bytes=ops.tf32_scratch_bytes(B, S, H, KV, hd, True))
        log("kernels", f"flash_attention backward [{r}] timed at B{B} S{S} "
            f"H{H} KV{KV} hd{hd} {dtype} causal, in turns with SDPA: "
            f"{ms:.4f} ms (plain {plain_ms:.4f}; SDPA backward by backend "
            + ", ".join(f"{n} {t:.4f}" for n, t in sdpa.items())
            + f"; {ms / sdpa[fastest]:.2f}x the fastest, {fastest}; bound "
            f"{bound_ms:.4f} by {bound_by} at the "
            f"{'bf16' if r == 'wgmma' else 'TF32'} tensor-core peak, "
            f"{bound_ms / ms:.3f} of it"
            + (f"; scratch {summary['scratch_bytes']} bytes"
               if r == "tf32x3" else "") + ")")
        del q, k, v, do, o, lse
        tensor_core_fields(summary, ops.BWD_KERNELS[r], flops, r)
    # the forward with and without the lse output, on its route
    B, S, H, KV, hd = FLASH_BWD_TIMED[0]
    lse_times = {}
    for (B, S) in ((TRAIN_B, TRAIN_S), (8, 1024)):
        q, k, v = (torch.randn(B, S, n, hd, generator=gen,
                               device=device).to(torch.bfloat16)
                   for n in (H, KV, KV))
        plain_fwd = time_ms(lambda: ops.attention_cuda(q, k, v, True), 20)
        with_lse = time_ms(lambda: ops.attention_cuda(q, k, v, True, True),
                           20)
        lse_times[f"B{B} S{S}"] = dict(ms=plain_fwd, with_lse_ms=with_lse)
        log("kernels", f"flash_attention forward [wgmma] B{B} S{S} H{H} "
            f"KV{KV} hd{hd} bf16 causal: {plain_fwd:.4f} ms without lse, "
            f"{with_lse:.4f} ms with it")
    summaries["wgmma", 64, None]["forward_lse_ms"] = lse_times
    fold_hd32(summaries)
    return summaries, cases


def two_call_backward(x, r, s, dy, dh):
    """A callable that runs the backward of the fused norm's function as
    two library calls compute it, autograd of ``F.rms_norm(torch.add(x,
    r))`` (scale in x's dtype) from the cotangents of y and h, the forward
    run beforehand: a yardstick only, the port never calls it."""
    import torch
    import torch.nn.functional as F
    xs, rs, ss = (t.detach().clone().requires_grad_()
                  for t in (x, r, s.to(x.dtype)))
    h = torch.add(xs, rs)
    y = F.rms_norm(h, (x.shape[-1],), ss, 1e-5)
    return lambda: torch.autograd.grad((y, h), (xs, rs, ss), (dy, dh),
                                       retain_graph=True)


def check_fused_bwd(gen, device):
    """The fused-norm backward against ``fused_bwd_ref`` at the training
    rows (R 4096) of the training paths' widths (``FUSED_WIDTHS`` but
    mamba2's), bf16 and fp32, and at the Case-3 drill's rows (R 8192, S
    ``CASE3_S``) of D 2048 in bf16, with and without dh, one launch per
    call;
    timed in bf16 with dh beside the plain version (no single PyTorch call
    computes it), at D 2048 and at the others into ``at_zamba2`` (D 2560),
    ``at_qwen2`` (D 896), ``at_llama_vision`` (D 4096), ``at_dbrx`` (D
    6144), ``at_arctic`` (D 7168), ``at_llama_20b`` (D 5120),
    ``at_qwen2_72b`` (D 8192) and ``at_llama3_405b`` (D 16384, the
    1024-thread instance), the last five also in fp32 (``_fp32``
    appended): the kernel's instances without the staging ring; each of
    these beside the backward of ``torch.add`` + ``F.rms_norm`` by
    autograd (``two_call_backward``).
    dscale sums R rows in fp32 in another order than the plain version: its
    atol is 3e-4·√R."""
    import torch
    from repro_torch.kernels.fused_norm import ops

    bwd = {"bwd": ops.BWD_KERNEL}
    cases = []
    widths = [D for D in FUSED_WIDTHS if D != 1536]
    shapes = [(TRAIN_B * TRAIN_S, D, dtype) for D, dtype in itertools.product(
        widths, ("bfloat16", "float32"))] + [
        (TRAIN_B * CASE3_S, 2048, "bfloat16")]
    for R, D, dtype in shapes:
        dt = getattr(torch, dtype)
        for with_dh in (True, False):
            x, r, dy, dh = (torch.randn(R, D, generator=gen,
                                        device=device).to(dt)
                            for _ in range(4))
            dh = dh if with_dh else None
            s = torch.randn(D, generator=gen, device=device)
            dx, ds = on_route(bwd, "bwd",
                              lambda: ops.fused_bwd_cuda(x, r, s, dy, dh))
            dxr, dsr = ops.fused_bwd_ref(x, r, s, dy, dh)
            torch.cuda.synchronize()
            e_dx = max_err(dx, dxr, dtype)
            e_ds = max_err(ds, dsr, "float32",
                           dict(rtol=3e-4, atol=3e-4 * R ** 0.5))
            cases.append(dict(shape=[R, D], dtype=dtype, dh=with_dh,
                              max_abs_err=dict(dx=e_dx, dscale=e_ds)))
            log("kernels", f"fused_residual_rmsnorm backward R{R} D{D} "
                f"{dtype} dh={with_dh}: max_abs_err dx {e_dx:.3e}, dscale "
                f"{e_ds:.3e}")
    R, D, dt = TRAIN_B * TRAIN_S, 2048, torch.bfloat16
    x, r, dy, dh = (torch.randn(R, D, generator=gen, device=device).to(dt)
                    for _ in range(4))
    s = torch.randn(D, generator=gen, device=device)
    err = max_err(ops.fused_bwd_cuda(x, r, s, dy, dh)[0],
                  ops.fused_bwd_ref(x, r, s, dy, dh)[0], "bfloat16")
    # device time: behind a queued sleep, the wrapper's host cost per call
    # (allocations, the launch) does not count
    ms = time_ms(lambda: ops.fused_bwd_cuda(x, r, s, dy, dh), 50,
                 behind_sleep=True)
    no_dh_ms = time_ms(lambda: ops.fused_bwd_cuda(x, r, s, dy), 50,
                       behind_sleep=True)
    plain_ms = time_ms(lambda: ops.fused_bwd_ref(x, r, s, dy, dh), 10)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = ops.bwd_blocks(R, D, sms)
    # the function's bytes: x, res, dy, dh read, dx written; scale read,
    # dscale written.  The kernel's dscale partials (its two-pass design,
    # not the function) are printed apart.
    partial_bytes = 2 * blocks * D * 4
    t_ops, t_bytes = terms(ops.work(R, D, 2, backward=True),
                           PEAK_BF16_FLOPS)
    summary = dict(
        name="fused_residual_rmsnorm_bwd", route="cuda",
        source=f"src/repro_torch/kernels/csrc/{ops.BWD_KERNEL.source}",
        replaces="src/repro/kernels/fused_norm/ref.py:6 (autodiff of "
        "fused_ref; port-only: the reference's backward has no Pallas "
        "kernel)", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None, library_call=None, shape=[R, D], dtype="bfloat16",
        partial_bytes=partial_bytes,
        partial_ms=partial_bytes / PEAK_BYTES * 1e3, no_dh_ms=no_dh_ms,
        no_dh_bound_ms=(4 * R * D * 2 + 2 * D * 4) / PEAK_BYTES * 1e3,
        ptxas=ptxas_usage(ops.BWD_KERNEL.build_log))
    log("kernels", f"fused_residual_rmsnorm backward timed at R{R} D{D} bf16 "
        f"with dh: {ms:.4f} ms (plain {plain_ms:.4f}; no single library "
        f"call computes it; bound {summary['bound_ms']:.4f} by "
        f"{summary['bound_by']}, {summary['bound_ms'] / ms:.3f} of it; the "
        f"kernel's {blocks} dscale partial rows add {partial_bytes} bytes "
        f"written and read, {summary['partial_ms']:.4f} ms at the memory "
        f"rate); without dh {no_dh_ms:.4f} ms (bound "
        f"{summary['no_dh_bound_ms']:.4f}); ptxas: "
        + ", ".join(f"{u['registers']} registers, {u['spill_stores']}/"
                    f"{u['spill_loads']} bytes spilled"
                    for u in summary["ptxas"]))
    # the other training paths' widths, each beside the backward of the
    # function in two library calls (autograd of torch.add then F.rms_norm)
    keys = {2560: "at_zamba2", 896: "at_qwen2", 4096: "at_llama_vision",
            6144: "at_dbrx", 7168: "at_arctic", 5120: "at_llama_20b",
            8192: "at_qwen2_72b", 16384: "at_llama3_405b"}
    for D, dtype in [(D, "bfloat16") for D in widths[1:]] + [
            (D, "float32") for D in FUSED_FP32_TIMED]:
        dt = getattr(torch, dtype)
        x, r, dy, dh = (torch.randn(R, D, generator=gen,
                                    device=device).to(dt) for _ in range(4))
        s = torch.randn(D, generator=gen, device=device)
        err = max_err(ops.fused_bwd_cuda(x, r, s, dy, dh)[0],
                      ops.fused_bwd_ref(x, r, s, dy, dh)[0], dtype)
        ms = time_ms(lambda: ops.fused_bwd_cuda(x, r, s, dy, dh), 50,
                     behind_sleep=True)
        plain_ms = time_ms(lambda: ops.fused_bwd_ref(x, r, s, dy, dh), 10)
        two_call_ms = time_ms(two_call_backward(x, r, s, dy, dh), 50,
                              behind_sleep=True)
        t_ops, t_bytes = terms(ops.work(R, D, x.element_size(),
                                        backward=True), PEAK_BF16_FLOPS)
        key = keys[D] + ("" if dtype == "bfloat16" else "_fp32")
        summary[key] = w = dict(
            shape=[R, D], dtype=dtype, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            two_call_ms=two_call_ms)
        log("kernels", f"fused_residual_rmsnorm backward timed at R{R} D{D} "
            f"{dtype} with dh: {ms:.4f} ms (plain {plain_ms:.4f}; the "
            f"backward of torch.add + F.rms_norm {two_call_ms:.4f}; bound "
            f"{w['bound_ms']:.4f} by {w['bound_by']}, "
            f"{w['bound_ms'] / ms:.3f} of it)")
        del x, r, dy, dh
    return summary, cases


def ssd_inputs(gen, device, B, L, H, N, dtype, P: int = 64):
    """SSD-scan inputs as the model makes them: dt = softplus(u + dt_bias)
    with u a normal draw and dt_bias = log(expm1(linspace(1e-3, 1e-1, H))),
    A = -exp(log(linspace(1, 16, H))).  A chunk's decay exp(cum_last) then
    runs from ~0.6 (head 0) to underflow (head H-1), so the carried state
    reaches y and the final state.  x is [B, L, H, P]."""
    import torch
    import torch.nn.functional as F
    dt_ = getattr(torch, dtype)
    x = torch.randn(B, L, H, P, generator=gen, device=device).to(dt_)
    dt_bias = torch.log(torch.expm1(
        torch.linspace(1e-3, 1e-1, H, device=device)))
    dt = F.softplus(torch.randn(B, L, H, generator=gen, device=device)
                    + dt_bias)
    A = -torch.exp(torch.log(torch.linspace(1.0, 16.0, H, device=device)))
    Bm = torch.randn(B, L, N, generator=gen, device=device).to(dt_)
    Cm = torch.randn(B, L, N, generator=gen, device=device).to(dt_)
    return x, dt, A, Bm, Cm


def ssd_bwd_design_flops(B, L, H, P, N, chunk, route="wgmma",
                         share_g=True) -> float:
    """Flops the tensor-core SSD backward does at these shapes.  bf16
    (``ssd_scan_bwd_wgmma.cu``): per (b, h) and chunk of nt 64-row tiles,
    over the nt (nt + 1) / 2 causal tile pairs G^T, M^T, G and M and the
    dx, dB and dC products, those three doubled by their hi + lo operands;
    per tile five doubled products of 2·64·P·N (the two chunk-state sums,
    B·dS^T, x·dS, dy·S_prev); C·Bᵀ recomputed per head, in both kernels.
    tf32x3 (``ssd_scan_bwd_tf32.cu``): every product three times (hi·lo,
    lo·hi, hi·hi): per (b, h) and pair M^T, M, dx, dB and dC, per tile the
    five state products, and G^T and G per pair once for each group of
    ``BWD_HEAD_GROUP`` heads (``share_g``; per head otherwise)."""
    from repro_torch.kernels.ssd_scan.ops import BWD_HEAD_GROUP
    flops = 0.0
    for c0 in range(0, L, chunk):
        nt = -(-min(chunk, L - c0) // 64)
        pairs = nt * (nt + 1) / 2
        if route == "wgmma":
            flops += H * (pairs * 2 * 64 * 64 * (6 * N + 4 * P)
                          + nt * 10 * 2 * 64 * P * N)
            continue
        g = -(-H // BWD_HEAD_GROUP) if share_g else H
        flops += 3 * (H * (pairs * 2 * 64 * 64 * (3 * P + 2 * N)
                           + nt * 5 * 2 * 64 * P * N)
                      + g * pairs * 2 * 2 * 64 * 64 * N)
    return B * flops


# the SSD forward's cases: (B, L, H, N, initial state) at chunk 256:
# mamba2's serving shape (H 48, N 128), ragged L, the fp32 agreement
# prefill's L 320, N 64; zamba2's serving shape and agreement prefill (H 80,
# N 64)
SSD_CASES = [(8, 1024, 48, 128, False), (8, 1000, 48, 128, False),
             (2, 1000, 48, 128, True), (1, 320, 48, 128, True),
             (2, 1000, 48, 64, True), (1, 320, 48, 64, False),
             (8, 1024, 80, 64, False), (1, 320, 80, 64, True)]
# the serving paths' SSD shapes, each timed on both routes: (B, L, H, N) of
# mamba2-780m (the summary line's) and of zamba2-2.7b (its ``at_zamba2``)
SSD_TIMED = [(8, 1024, 48, 128), (8, 1024, 80, 64)]


def check_ssd(gen, device):
    """The cases (ragged L, initial states, N 64) on both routes, bf16 and
    fp32 (split TF32), both on the tensor cores, each call on the route of
    its dtype by the routes' launch counts, against ``ssd_ref``, two fp32
    calls compared bitwise; then the serving shape timed on each route
    beside the plain version, with the same work (``ops.work``) for
    both, the fp32 route's bound at the TF32 peak beside its three passes'
    floor, the FP32-pipe bound and its scratch; zamba2's serving shape the
    same, into each summary's ``at_zamba2``.  Returns the bf16 and the fp32
    (tf32x3) summaries and the cases."""
    import torch
    from repro_torch.kernels.ssd_scan import ops

    cases = []
    chunk = 256
    for (B, L, H, N, init) in SSD_CASES:
        for dtype in ("bfloat16", "float32"):
            x, dt, A, Bm, Cm = ssd_inputs(gen, device, B, L, H, N, dtype)
            s0 = (0.5 * torch.randn(B, H, 64, N, generator=gen, device=device)
                  if init else None)
            route = ops.route(x.dtype)
            y, st = on_route(ops.KERNELS, route, lambda: ops.ssd_cuda(
                x, dt, A, Bm, Cm, chunk, s0))
            yr, sr = ops.ssd_ref(x, dt, A, Bm, Cm, chunk, s0)
            torch.cuda.synchronize()
            err_y = max_err(y, yr, dtype)
            err_s = max_err(st, sr, dtype)
            case = dict(shape=[B, L, H, 64, N], chunk=chunk, dtype=dtype,
                        route=route, initial_state=init, max_abs_err_y=err_y,
                        max_abs_err_state=err_s)
            if route == "tf32x3":
                y2, st2 = ops.ssd_cuda(x, dt, A, Bm, Cm, chunk, s0)
                if not (torch.equal(y, y2) and torch.equal(st, st2)):
                    fail(f"ssd_scan B{B} L{L} N{N} [{route}]: two calls on "
                         f"the same inputs differ")
                case["bitwise_repeatable"] = True
                del y2, st2
            if init:
                # the check sees a kernel that drops the carried state only
                # if the initial state reaches the outputs by far more than
                # the tolerance
                y0, s0r = ops.ssd_ref(x, dt, A, Bm, Cm, chunk)
                case["initial_state_reach_y"] = float((yr - y0).abs().max())
                case["initial_state_reach_state"] = float(
                    (sr - s0r).abs().max())
                del y0, s0r
                if min(case["initial_state_reach_y"],
                       case["initial_state_reach_state"]) < 1e-1:
                    fail(f"ssd_scan B{B} L{L} {dtype}: the initial state "
                         f"barely reaches the outputs ({case}); the check "
                         f"cannot see the carried state")
            cases.append(case)
            log("kernels", f"ssd_scan B{B} L{L} H{H} P64 N{N} chunk {chunk} "
                f"{dtype} initial_state={init} [{route}]: max_abs_err y "
                f"{err_y:.3e}, final_state {err_s:.3e}" + (
                    f"; the initial state moves y by "
                    f"{case['initial_state_reach_y']:.3e} and the final "
                    f"state by {case['initial_state_reach_state']:.3e}"
                    if init else "")
                + ("; two calls bitwise equal" if route == "tf32x3" else ""))
            del x, dt, Bm, Cm, y, st, yr, sr

    # the serving paths' shapes, timed on each route
    summaries = {}
    for (B, L, H, N), dtype in itertools.product(
            SSD_TIMED, ("bfloat16", "float32")):
        x, dt, A, Bm, Cm = ssd_inputs(gen, device, B, L, H, N, dtype)
        w = ops.work(B, L, H, 64, N, chunk, x.element_size())
        flops, nbytes = w["flops"], w["bytes"]
        route = ops.route(x.dtype)
        y, st = ops.ssd_cuda(x, dt, A, Bm, Cm, chunk)
        yr, sr = ops.ssd_ref(x, dt, A, Bm, Cm, chunk)
        err = max(max_err(y, yr, dtype), max_err(st, sr, dtype))
        del yr, sr
        ms = time_ms(lambda: ops.ssd_cuda(x, dt, A, Bm, Cm, chunk), 20)
        plain_ms = time_ms(lambda: ops.ssd_ref(x, dt, A, Bm, Cm, chunk), 3, 1)
        peak = PEAK_BF16_FLOPS if route == "wgmma" else PEAK_TF32_FLOPS
        t_ops, t_bytes = terms(w, peak)
        summary = dict(
            name="ssd_scan" if route == "wgmma" else "ssd_scan_fp32",
            route="cuda",
            source=f"src/repro_torch/kernels/csrc/{ops.KERNELS[route].source}",
            replaces="src/repro/kernels/ssd_scan/kernel.py:53",
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=None, library_call=None, shape=[B, L, H, 64, N],
            chunk=chunk, dtype=dtype, flops=flops, bytes=nbytes)
        if route == "tf32x3":
            summary.update(
                design_floor_ms=max(3 * t_ops, t_bytes),
                fp32_pipe_bound_ms=flops / PEAK_FP32_FLOPS * 1e3,
                scratch_bytes=ops.tf32_scratch_bytes(B, L, N))
        log("kernels", f"ssd_scan [{route}] timed at B{B} L{L} H{H} P64 N{N} "
            f"chunk {chunk} {dtype}: {ms:.4f} ms (plain {plain_ms:.4f}, no "
            f"library call, bound {summary['bound_ms']:.4f} by "
            f"{summary['bound_by']}: {flops:.3e} flops = {t_ops:.4f} ms at "
            f"the {'bf16' if route == 'wgmma' else 'TF32'} tensor-core "
            f"peak, {nbytes:.3e} bytes = {t_bytes:.4f} ms"
            + (f"; FP32-pipe bound {summary['fp32_pipe_bound_ms']:.4f} ms; "
               f"scratch {summary['scratch_bytes']} bytes"
               if route == "tf32x3" else "") + ")")
        del x, dt, Bm, Cm, y, st
        torch.cuda.empty_cache()
        if (B, L, H, N) == SSD_TIMED[0]:
            summaries[route] = tensor_core_fields(
                summary, ops.KERNELS[route], flops, route)
        else:
            summaries[route]["at_zamba2"] = summary
    tc, tf = summaries["wgmma"], summaries["tf32x3"]
    tc["fp32_route_factor"] = tf["ms"] / tc["ms"]
    log("kernels", f"ssd_scan: the bf16 route is "
        f"{tc['fp32_route_factor']:.1f}x faster than the tf32x3 route")
    return tc, tf, cases


# the SSD backward: (B, L, H, N, chunk), dtype, with a final-state
# cotangent, with an initial state: the training shape on both instances,
# N 64, ragged L at chunk 256 and 128, H 12 and 20 (the last head group of
# 8 cut short) on both routes, zamba2's training shape (H 80, N 64) on both,
# and the fp32 route at N 64, chunk 64 over 16 chunks of L 1024, where the
# states carried across the chunks at |A| 1 reach ddt
# (tools/ssd_bwd_chunk_check.py holds both fp32 routes there to float64)
SSD_BWD_CASES = [((8, 512, 48, 128, 256), "bfloat16", False, False),
                 ((8, 512, 48, 128, 256), "float32", False, False),
                 ((2, 512, 16, 64, 256), "bfloat16", False, False),
                 ((2, 512, 16, 64, 256), "float32", True, False),
                 ((2, 200, 16, 128, 256), "bfloat16", True, False),
                 ((2, 200, 16, 128, 128), "float32", False, True),
                 ((2, 333, 16, 128, 128), "bfloat16", False, True),
                 ((2, 333, 16, 64, 256), "float32", True, False),
                 ((2, 512, 12, 128, 256), "float32", True, False),
                 ((2, 512, 12, 128, 256), "bfloat16", True, False),
                 ((2, 333, 20, 64, 128), "float32", True, True),
                 ((2, 333, 20, 64, 128), "bfloat16", False, True),
                 ((8, 512, 80, 64, 256), "bfloat16", False, False),
                 ((8, 512, 80, 64, 256), "float32", False, False),
                 ((8, 1024, 48, 64, 64), "float32", False, False)]
# the training paths' SSD shapes, each timed on both routes: (H, N) of
# mamba2-780m (the summary line's) and of zamba2-2.7b (its ``at_zamba2``)
SSD_BWD_TIMED = [(48, 128), (80, 64)]
SSD_BWD_NAMES = ("dx", "ddt", "dA", "dBm", "dCm")


def ssd_bwd_case(gen, device, B, L, H, N, chunk, dtype, final,
                 init=False, P: int = 64) -> dict:
    """One SSD backward call on the route of its dtype (one launch of that
    instance, none of the other) against ``ssd_bwd_ref`` on the same
    inputs (dt as the model draws it, dy a normal draw, the final-state
    cotangent and the initial state normal draws where given).  fp32
    within 3e-4; bf16 within the elementwise bf16 tolerance and
    ``BWD_BF16_SCALED`` of each output's largest magnitude; dA and ddt with
    the atol of ``ssd_bwd_tol``.  A given final-state cotangent must move
    dx, ddt and dBm (dCm does not depend on it) by far more than the
    tolerance.  x is [B, L, H, P].  Raises AssertionError on a mismatch."""
    import torch
    from repro_torch.kernels.ssd_scan import ops
    x, dt, A, Bm, Cm = ssd_inputs(gen, device, B, L, H, N, dtype, P)
    dy = torch.randn(x.shape, generator=gen, device=device).to(x.dtype)
    dS = (torch.randn(B, H, P, N, generator=gen, device=device)
          if final else None)
    s0 = (0.5 * torch.randn(B, H, P, N, generator=gen, device=device)
          if init else None)
    route = ops.BWD_ROUTES[x.dtype]
    got = on_route(ops.BWD_KERNELS, route, lambda: ops.ssd_bwd_cuda(
        x, dt, A, Bm, Cm, dy, dS, chunk, s0))
    want = ops.ssd_bwd_ref(x, dt, A, Bm, Cm, dy, dS, chunk, s0)
    torch.cuda.synchronize()
    case = dict(shape=[B, L, H, P, N], chunk=chunk, dtype=dtype,
                route=route, d_final_state=final, initial_state=init,
                max_abs_err={})
    for name, g, w in zip(SSD_BWD_NAMES, got, want):
        case["max_abs_err"][name] = max_err(g, w, dtype, ssd_bwd_tol(
            name, dtype, B, L, card_chunk(chunk)))
    if dtype == "bfloat16":
        case["scaled_err"] = {n: scaled_err(g, w, BWD_BF16_SCALED)
                              for n, g, w in zip(SSD_BWD_NAMES, got, want)}
    if final:
        # a kernel that dropped the cotangent would pass unless it moves
        # the outputs by far more than the tolerance
        plain = ops.ssd_bwd_ref(x, dt, A, Bm, Cm, dy, None, chunk, s0)
        case["d_final_state_reach"] = min(
            float((w.float() - p.float()).abs().max())
            for n, w, p in zip(SSD_BWD_NAMES, want, plain)
            if n in ("dx", "ddt", "dBm"))
        if case["d_final_state_reach"] < 1e-1:
            raise AssertionError(f"the final-state cotangent barely reaches "
                                 f"the outputs ({case})")
    return case


def card_chunk(chunk: int) -> int:
    """The longer of a requested chunk and the one the SSD kernels run it
    at (``kernel_chunk``): ddt's reverse cumsum spans it in one of the two
    runs compared.  On the card at B 8, L 1024, H 48, P 16, N 16 and a
    requested chunk 16, the fp32 route's ddt was 4.58e-3 off the plain
    version at chunk 16 and 4.52e-3 off it at the kernel's 64: the error
    is the kernel's sum over 64 rows (``tools/ssd_bwd_chunk_check.py``)."""
    from repro_torch.kernels.ssd_scan.ops import kernel_chunk
    return max(chunk, kernel_chunk(chunk))


def ssd_bwd_tol(name: str, dtype: str, B: int, L: int, chunk: int) -> dict:
    """The elementwise tolerance of one SSD-backward output: the dtype's
    (``TOLS``), but for the two outputs that sum the reverse cumsum da of
    the fp32 cotangents of the cumulative decay: dA sums B·L rows (atol
    3e-4·√(B·L), the precedent of the fused backward's dscale) and ddt_s
    takes A·da_s, a sum over up to a chunk's rows (atol 3e-4·√chunk).  At
    the training shape |ddt| reaches ~5e3, where one fp32 ulp is 4.9e-4:
    a plain 3e-4 would hold a sum in another order to less than the
    rounding of its own terms.  The card's checks pass ``card_chunk``: the
    longer of the chunk the kernel sums over and the plain version's."""
    tol = dict(TOLS[dtype])
    rows = {"dA": B * L, "ddt": min(chunk, L)}.get(name)
    if rows:
        tol["atol"] = max(tol["atol"], 3e-4 * rows ** 0.5)
    return tol


def check_ssd_bwd(gen, device):
    """The SSD backward (``SSD_BWD_CASES``, ``ssd_bwd_case``) on both
    routes, then each timed at the training shape behind a queued sleep
    beside its plain version, with its bound (no single PyTorch call
    computes it), its [kernels] line, the profiler's split of its kernels,
    and two calls compared bitwise (the design has no atomics); the tf32x3
    route's bound at the TF32 peak beside its three passes' design floor,
    the FP32-pipe bound and its scratch; zamba2's training shape the same,
    into each summary's ``at_zamba2``.  Returns the bf16 and the fp32
    (tf32x3) summaries and the cases."""
    import torch
    from repro_torch.kernels.ssd_scan import ops

    cases = []
    for (B, L, H, N, chunk), dtype, final, init in SSD_BWD_CASES:
        case = ssd_bwd_case(gen, device, B, L, H, N, chunk, dtype, final,
                            init)
        cases.append(case)
        errs = ", ".join(f"{n} {e:.3e}" for n, e in
                         case["max_abs_err"].items())
        scaled = ("; of the largest magnitude " + ", ".join(
            f"{n} {e:.2e}" for n, e in case["scaled_err"].items())
            if "scaled_err" in case else "")
        reach = (f"; the final-state cotangent moves them by at least "
                 f"{case['d_final_state_reach']:.3e}" if final else "")
        log("kernels", f"ssd_scan backward [{case['route']}] B{B} L{L} H{H} "
            f"P64 N{N} chunk {chunk} {dtype} d_final_state={final} "
            f"initial_state={init}: max_abs_err {errs}{scaled}{reach}")
        torch.cuda.empty_cache()

    B, L, chunk = TRAIN_B, TRAIN_S, 256
    summaries = {}
    for (H, N), dtype in itertools.product(SSD_BWD_TIMED,
                                           ("bfloat16", "float32")):
        x, dt, A, Bm, Cm = ssd_inputs(gen, device, B, L, H, N, dtype)
        dy = torch.randn(x.shape, generator=gen, device=device).to(x.dtype)
        r = ops.BWD_ROUTES[x.dtype]
        args = (x, dt, A, Bm, Cm, dy, None, chunk)
        err = max(max_err(g, w, dtype, ssd_bwd_tol(n, dtype, B, L, chunk))
                  for n, g, w in zip(SSD_BWD_NAMES, ops.ssd_bwd_cuda(*args),
                                     ops.ssd_bwd_ref(*args)))
        ms = time_ms(lambda: ops.ssd_bwd_cuda(*args), 10, behind_sleep=True)
        plain_ms = time_ms(lambda: ops.ssd_bwd_ref(*args), 3, 1)
        peak = PEAK_BF16_FLOPS if r == "wgmma" else PEAK_TF32_FLOPS
        w = ops.work(B, L, H, 64, N, chunk, x.element_size(), backward=True)
        bound_ms, bound_by = bound(w, peak)
        flops, nbytes = w["flops"], w["bytes"]
        summary = dict(
            name="ssd_scan_bwd" if r == "wgmma" else "ssd_scan_bwd_tf32x3",
            route="cuda",
            source=f"src/repro_torch/kernels/csrc/{ops.BWD_KERNELS[r].source}",
            replaces="src/repro/models/mamba2.py:22 (XLA autodiff of "
            "ssd_chunked; port-only: the reference's backward has no Pallas "
            "kernel)", max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            library_call=None, shape=[B, L, H, 64, N], chunk=chunk,
            dtype=dtype, flops=flops, bytes=nbytes,
            design_flops=ssd_bwd_design_flops(B, L, H, 64, N, chunk, r))
        if r == "tf32x3":
            summary.update(
                design_floor_ms=summary["design_flops"] / PEAK_TF32_FLOPS
                * 1e3,
                design_flops_g_per_head=ssd_bwd_design_flops(
                    B, L, H, 64, N, chunk, r, share_g=False),
                fp32_pipe_bound_ms=flops / PEAK_FP32_FLOPS * 1e3,
                scratch_bytes=ops.tf32_bwd_scratch_bytes(B, L, H, N, chunk))
        log("kernels", f"ssd_scan backward [{r}] timed at B{B} L{L} H{H} P64 "
            f"N{N} chunk {chunk} {dtype}: {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s of the work; plain "
            f"{plain_ms:.4f}; no library call; bound {bound_ms:.4f} by "
            f"{bound_by} at the {'bf16' if r == 'wgmma' else 'TF32'} peak: "
            f"{flops:.3e} flops, {nbytes:.3e} bytes; {bound_ms / ms:.4f} "
            f"of it" + (
                f"; three-pass design floor {summary['design_floor_ms']:.4f}"
                f" ms ({summary['design_flops']:.3e} flops, C·Bᵀ once a "
                f"head group; "
                f"{summary['design_flops_g_per_head']:.3e} were it per "
                f"head); FP32-pipe bound "
                f"{summary['fp32_pipe_bound_ms']:.4f} ms; scratch "
                f"{summary['scratch_bytes']} bytes" if r == "tf32x3"
                else "") + ")")
        runs = [ops.ssd_bwd_cuda(*args) for _ in range(2)]
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            fail(f"ssd_scan backward [{r}]: two calls on the same inputs "
                 f"differ")
        del runs
        prof = profile(lambda: [ops.ssd_bwd_cuda(*args) for _ in range(5)])
        summary["by_kernel_ms"] = {k["name"]: k["ms"] / 5
                                   for k in prof["port"]}
        log("kernels", f"ssd_scan backward [{r}]: two calls bitwise equal; "
            f"{summary['design_flops']:.3e} flops of its design = "
            f"{summary['design_flops'] / ms / 1e9:.1f} TFLOP/s; by kernel "
            f"(profiler, ms a call): " + ", ".join(
                f"{n.split('::')[-1][:40]} {t:.4f}"
                for n, t in summary["by_kernel_ms"].items()))
        del x, dt, Bm, Cm, dy, args
        torch.cuda.empty_cache()
        if (H, N) == SSD_BWD_TIMED[0]:
            summaries[r] = tensor_core_fields(summary, ops.BWD_KERNELS[r],
                                              flops, r)
        else:
            summaries[r]["at_zamba2"] = summary
    tc, tf = summaries["wgmma"], summaries["tf32x3"]
    tc["fp32_route_factor"] = tf["ms"] / tc["ms"]
    log("kernels", f"ssd_scan backward: the wgmma route is "
        f"{tc['fp32_route_factor']:.1f}x faster than the tf32x3 route")
    return tc, tf, cases


# --------------------------------------------------------------------------- #
# phase 3, continued: the widths of the JAX package's sweep and reduced zoo
# --------------------------------------------------------------------------- #
# the JAX package's own SSD-scan sweep (tests/test_kernels.py), shape for
# shape: (B, L, H, P, N), chunk 32 where it divides L, else L; its
# tolerance 4e-4 (fp32, the swept dtype; bf16 the bf16 one)
REF_SSD_SWEEP = [(1, 64, 2, 8, 8), (2, 128, 3, 16, 8), (1, 96, 1, 32, 16)]
REF_SSD_TOL = dict(rtol=4e-4, atol=4e-4)
# the fused norm's sweep (R, D), both dtypes; the ring combine's and the
# padded matmul's run in their own checks (``check_ring_combine``,
# ``MATMUL_SWEEP``)
REF_FUSED_SWEEP = [(256, 64), (512, 96), (128, 256)]
# the SSD scan at the reduced mamba2's and zamba2's widths (P 16, N 16,
# chunk 16, H 8: one whole head group), ragged L, initial states, a
# partial head group (H 3), P 32 N 32 at chunk 48, P 8 at N 128: (B, L, H,
# P, N, chunk, initial state)
SSD_NARROW = [(2, 64, 8, 16, 16, 16, True), (2, 200, 8, 16, 16, 16, False),
              (1, 333, 3, 16, 16, 16, True), (2, 130, 3, 32, 32, 48, True),
              (2, 100, 2, 8, 128, 16, False)]
# its backward: the sweep's shapes at its chunk, both dtypes, then the
# reduced widths with a final-state cotangent and an initial state: (B, L,
# H, P, N, chunk), dtype, final, initial
SSD_BWD_NARROW = [
    ((B, L, H, P, N, 32 if L % 32 == 0 else L), d, False, False)
    for (B, L, H, P, N) in REF_SSD_SWEEP for d in ("float32", "bfloat16")] + [
    ((2, 64, 8, 16, 16, 16), "float32", True, False),
    ((2, 64, 8, 16, 16, 16), "bfloat16", True, False),
    ((2, 200, 8, 16, 16, 16), "float32", True, True),
    ((2, 200, 8, 16, 16, 16), "bfloat16", False, True),
    ((1, 333, 3, 16, 16, 16), "float32", False, False),
    ((2, 130, 3, 32, 32, 48), "float32", True, True),
    ((2, 130, 3, 32, 32, 48), "bfloat16", True, False),
    ((2, 100, 2, 8, 128, 16), "float32", False, True)]
# the narrow SSD widths timed at a realistic size: mamba2's serving rows and
# heads (B 8, L 1024, H 48) at the reduced configs' P 16, N 16, chunk 16
SSD_NARROW_TIMED = (8, 1024, 48, 16, 16, 16)


def flash_padded_factor(route: str, hd: int, backward: bool) -> float:
    """The tensor-core work a route does at head_dim ``hd`` over the work
    of its products at the true hd: bf16 tiles are whole 64-column boxes
    (the products over hd take ceil(hd / 16) k16 steps, the products that
    run at N hd run at N padded to 64; forward Q·Kᵀ and P·V, backward S and
    dP in both kernels and dV, dK, dQ); tf32x3 takes the hd / 8 k8 steps
    and runs at N hd, exact."""
    if route != "wgmma":
        return 1.0
    k, n = -(-hd // 16) * 16, -(-hd // 64) * 64
    return (4 * k + 3 * n) / (7 * hd) if backward else (k + n) / (2 * hd)


def ssd_padded_factor(B, L, H, P, N, chunk, backward: bool) -> float:
    """The SSD kernels' products at their padded tiles (head_dim 64, state
    64 or 128) over the function's at the true widths (``ops.work``)."""
    from repro_torch.kernels.ssd_scan import ops
    c = ops.kernel_chunk(chunk)
    pad = ops.work(B, L, H, 64, ops.padded_state(N), c, backward=backward)
    return pad["flops"] / ops.work(B, L, H, P, N, c,
                                   backward=backward)["flops"]


def check_widths(gen, device):
    """The widths the JAX package runs beside the published ones: its own
    sweep of the SSD scan (fp32 at 4e-4, and bf16) and of the fused norm,
    forward and backward (the flash sweep and the narrow flash widths run
    in ``check_flash`` and ``check_flash_bwd``); the SSD scan forward
    (``SSD_NARROW``) and backward (``SSD_BWD_NARROW``) at head_dim 8 to 32
    and state 8 to 128 on both routes against the plain version at the
    requested chunk, which the kernels run at ``kernel_chunk`` (the chunk
    invariance the card relies on), each call on its route; the widths no
    kernel takes refused on CUDA tensors with nothing launched; then the
    SSD forward and backward timed on each route at ``SSD_NARROW_TIMED``
    beside the plain version, with its bound and the padded tiles' work
    factor.  Returns the summaries by (forward or backward, route) and the
    cases."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.fused_norm import ops as fn
    from repro_torch.kernels.ssd_scan import ops

    cases = []

    def ssd_case(B, L, H, P, N, chunk, init, dtype, tol):
        x, dt, A, Bm, Cm = ssd_inputs(gen, device, B, L, H, N, dtype, P)
        s0 = (0.5 * torch.randn(B, H, P, N, generator=gen, device=device)
              if init else None)
        route = ops.route(x.dtype)
        y, st = on_route(ops.KERNELS, route, lambda: ops.ssd_cuda(
            x, dt, A, Bm, Cm, chunk, s0))
        yr, sr = ops.ssd_ref(x, dt, A, Bm, Cm, chunk, s0)
        torch.cuda.synchronize()
        case = dict(shape=[B, L, H, P, N], chunk=chunk,
                    kernel_chunk=ops.kernel_chunk(chunk), dtype=dtype,
                    route=route, initial_state=init,
                    max_abs_err_y=max_err(y, yr, dtype, tol),
                    max_abs_err_state=max_err(st, sr, dtype, tol))
        cases.append(case)
        log("kernels", f"ssd_scan B{B} L{L} H{H} P{P} N{N} chunk {chunk} "
            f"(runs at {case['kernel_chunk']}) {dtype} initial_state={init} "
            f"[{route}]: max_abs_err y {case['max_abs_err_y']:.3e}, "
            f"final_state {case['max_abs_err_state']:.3e}")

    for (B, L, H, P, N) in REF_SSD_SWEEP:
        chunk = 32 if L % 32 == 0 else L
        ssd_case(B, L, H, P, N, chunk, False, "float32", REF_SSD_TOL)
        ssd_case(B, L, H, P, N, chunk, False, "bfloat16", None)
    for (B, L, H, P, N, chunk, init) in SSD_NARROW:
        for dtype in ("float32", "bfloat16"):
            ssd_case(B, L, H, P, N, chunk, init, dtype, None)
    for (B, L, H, P, N, chunk), dtype, final, init in SSD_BWD_NARROW:
        case = ssd_bwd_case(gen, device, B, L, H, N, chunk, dtype, final,
                            init, P)
        case["kernel_chunk"] = ops.kernel_chunk(chunk)
        cases.append(case)
        log("kernels", f"ssd_scan backward [{case['route']}] B{B} L{L} H{H} "
            f"P{P} N{N} chunk {chunk} (runs at {case['kernel_chunk']}) "
            f"{dtype} d_final_state={final} initial_state={init}: "
            f"max_abs_err " + ", ".join(f"{n} {e:.3e}" for n, e in
                                        case["max_abs_err"].items()))
    for (R, D) in REF_FUSED_SWEEP:
        for dtype in ("float32", "bfloat16"):
            dt_ = getattr(torch, dtype)
            x, r, dy, dh = (torch.randn(R, D, generator=gen,
                                        device=device).to(dt_)
                            for _ in range(4))
            s = torch.randn(D, generator=gen, device=device)
            got = on_route({"fwd": fn.KERNEL}, "fwd",
                           lambda: fn.fused_cuda(x, r, s))
            want = fn.fused_ref(x, r, s)
            gb = on_route({"bwd": fn.BWD_KERNEL}, "bwd",
                          lambda: fn.fused_bwd_cuda(x, r, s, dy, dh))
            wb = fn.fused_bwd_ref(x, r, s, dy, dh)
            torch.cuda.synchronize()
            err = max(max_err(g, w, dtype) for g, w in zip(got, want))
            # dscale sums R rows in another order: atol 3e-4·√R, as
            # ``check_fused_bwd``
            err_bwd = max(max_err(gb[0], wb[0], dtype), max_err(
                gb[1], wb[1], "float32", dict(rtol=3e-4,
                                              atol=3e-4 * R ** 0.5)))
            cases.append(dict(shape=[R, D], dtype=dtype, kernel="fused_norm",
                              max_abs_err=err, max_abs_err_bwd=err_bwd))
            log("kernels", f"fused_residual_rmsnorm R{R} D{D} {dtype} (the "
                f"JAX sweep): max_abs_err {err:.3e}; backward with dh "
                f"{err_bwd:.3e}")

    # what no kernel takes raises on CUDA tensors, launching nothing
    launched = {id(k): k.launches for k in (
        *fa.KERNELS.values(), *ops.KERNELS.values())}
    q = torch.zeros(1, 8, 2, 24, device=device)
    x = torch.zeros(1, 8, 2, 24, device=device)
    bm = torch.zeros(1, 8, 16, device=device)
    refusals = {}
    for name, call in (
            ("flash_attention head_dim 24",
             lambda: fa.attention_cuda(q, q, q)),
            ("ssd_scan head_dim 24", lambda: ops.ssd_cuda(
                x, torch.ones(1, 8, 2, device=device),
                -torch.ones(2, device=device), bm, bm, 16))):
        try:
            call()
        except ValueError as e:
            refusals[name] = str(e)
        else:
            fail(f"{name}: a CUDA call the kernels do not take ran")
    if {id(k): k.launches for k in (*fa.KERNELS.values(),
                                    *ops.KERNELS.values())} != launched:
        fail("a refused call launched a kernel")
    log("kernels", "refused on CUDA tensors, nothing launched: " + "; ".join(
        f"{n}: {m}" for n, m in refusals.items()))

    # the narrow SSD widths timed at a realistic size, each route
    B, L, H, P, N, chunk = SSD_NARROW_TIMED
    kc = ops.kernel_chunk(chunk)
    summaries = {}
    for backward, dtype in itertools.product((False, True),
                                             ("bfloat16", "float32")):
        x, dt, A, Bm, Cm = ssd_inputs(gen, device, B, L, H, N, dtype, P)
        kernels = ops.BWD_KERNELS if backward else ops.KERNELS
        r = (ops.BWD_ROUTES if backward else ops.ROUTES)[x.dtype]
        if backward:
            dy = torch.randn(x.shape, generator=gen, device=device).to(
                x.dtype)
            args = (x, dt, A, Bm, Cm, dy, None, chunk)
            fn_k, fn_p = ops.ssd_bwd_cuda, ops.ssd_bwd_ref
            err = max(max_err(g, w, dtype, ssd_bwd_tol(n, dtype, B, L,
                                                        card_chunk(chunk)))
                      for n, g, w in zip(SSD_BWD_NAMES, fn_k(*args),
                                         fn_p(*args)))
        else:
            args = (x, dt, A, Bm, Cm, chunk)
            fn_k, fn_p = ops.ssd_cuda, ops.ssd_ref
            err = max(max_err(g, w, dtype) for g, w in zip(fn_k(*args),
                                                           fn_p(*args)))
        ms = time_ms(lambda: fn_k(*args), 10, behind_sleep=backward)
        plain_ms = time_ms(lambda: fn_p(*args), 3, 1)
        peak = PEAK_BF16_FLOPS if r == "wgmma" else PEAK_TF32_FLOPS
        w = ops.work(B, L, H, P, N, kc, x.element_size(), backward=backward)
        bound_ms, bound_by = bound(w, peak)
        name = "ssd_scan" + ("_bwd" if backward else "") + (
            "" if r == "wgmma" else "_tf32x3") + f"_p{P}n{N}"
        summary = dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{kernels[r].source}",
            replaces=("src/repro/models/mamba2.py:22 (XLA autodiff of "
                      "ssd_chunked; port-only: the reference's backward has "
                      "no Pallas kernel)" if backward
                      else "src/repro/kernels/ssd_scan/kernel.py:53"),
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None, library_call=None,
            shape=[B, L, H, P, N], chunk=chunk, kernel_chunk=kc,
            dtype=dtype, flops=w["flops"], bytes=w["bytes"],
            padded_work_factor=ssd_padded_factor(B, L, H, P, N, chunk,
                                                 backward))
        if r == "tf32x3":
            summary["scratch_bytes"] = (
                ops.tf32_bwd_scratch_bytes(B, L, H, N, kc, P) if backward
                else ops.tf32_scratch_bytes(B, L, N))
        log("kernels", f"ssd_scan{' backward' if backward else ''} [{r}] "
            f"timed at B{B} L{L} H{H} P{P} N{N} chunk {chunk} (runs at "
            f"{kc}) {dtype}: {ms:.4f} ms (plain {plain_ms:.4f}; no library "
            f"call; bound {bound_ms:.4f} by {bound_by}, {bound_ms / ms:.4f} "
            f"of it; the padded tiles do "
            f"{summary['padded_work_factor']:.2f}x the function's products)")
        del x, dt, Bm, Cm, args
        torch.cuda.empty_cache()
        summaries["bwd" if backward else "fwd", r] = tensor_core_fields(
            summary, kernels[r], w["flops"], r)
    return summaries, cases


# the paper's Case-2 FFN weight (benchmarks/case2_matmul.py) against one
# 4096-token microbatch: N 8484 is padded to 8576
CASE2 = (4096, 8192, 8484)
MATMUL_SWEEP = [(128, 128, 128), (64, 100, 212), (256, 384, 212),
                (32, 848, 96)]
# shapes matmul_tiled takes unpadded: each dimension a multiple of the 128
# tile or below it, so the kernel's masked edges run
MATMUL_BELOW_TILE = [(64, 100, 96), (32, 768, 100), (256, 100, 384)]
# the fp32 route's edges: K or N off a multiple of 4 (the pre-pass pads K
# to 4 and splits a too), then operands 4 bytes past a 16-byte boundary
MATMUL_F32_EDGES = [(32, 101, 99), (96, 127, 7), (256, 384, 126)]
MATMUL_F32_UNALIGNED = [(64, 100, 96), (128, 256, 128)]


def matmul_tol(dtype: str, K: int) -> dict:
    """tests/test_kernels.py's padded-matmul tolerance: atol >= 2e-3·√K."""
    tol = dict(TOLS[dtype])
    tol["atol"] = max(tol["atol"], 2e-3 * K ** 0.5)
    return tol


def _offset_randn(gen, device, shape, offset):
    """A contiguous fp32 tensor of ``shape`` whose data starts ``offset``
    elements past an allocation (4 bytes each)."""
    import torch
    n = 1
    for d in shape:
        n *= d
    return torch.randn(n + offset, generator=gen, device=device)[
        offset:].view(shape)


def check_padded_matmul(gen, device):
    """The JAX sweep through the op (padded), and ``matmul_tiled`` on shapes
    with dimensions below the tile (masked edges; for bf16 K or N off the
    multiple of 8 that TMA needs; for fp32 K or N off a multiple of 4, and
    operands off 16 bytes), fp32 and bf16, each on the route of its dtype,
    against ``matmul_ref``, two fp32 calls compared bitwise; then the
    Case-2 shape, timed on each route: the kernel on the padded shape, the
    op with its pads and slice, the plain version, torch.matmul at N 8484
    (fp32: in turns with the kernel) and at the aligned 8576; the fp32
    route's error against an fp64 product, at most half that of one TF32
    pass (cuBLAS TF32, a yardstick only: matmul_tol's √K atol would admit
    one pass), beside torch.matmul fp32's.  Returns the bf16 (tensor-core)
    and the fp32 (tf32x3) summaries and the cases."""
    import torch
    from repro_torch.kernels.padded_matmul import ops

    cases = []
    runs = [(fn, shape, dtype, 0)
            for fn, shapes in ((ops.padded_matmul, MATMUL_SWEEP),
                               (ops.matmul_tiled, MATMUL_BELOW_TILE))
            for shape in shapes for dtype in ("float32", "bfloat16")]
    runs += [(ops.matmul_tiled, shape, "float32", 0)
             for shape in MATMUL_F32_EDGES]
    runs += [(ops.matmul_tiled, shape, "float32", 1)
             for shape in MATMUL_F32_UNALIGNED]
    for fn, (M, K, N), dtype, offset in runs:
        dt = getattr(torch, dtype)
        a = _offset_randn(gen, device, (M, K), offset).to(dt)
        b = _offset_randn(gen, device, (K, N), offset).to(dt)
        route = ops.route(dt)
        got = on_route(ops.KERNELS, route, lambda: fn(a, b))
        torch.cuda.synchronize()
        err = max_err(got, ops.matmul_ref(a, b), dtype, matmul_tol(dtype, K))
        case = dict(fn=fn.__name__, shape=[M, K, N], dtype=dtype,
                    route=route, offset_bytes=4 * offset, max_abs_err=err)
        if route == "tf32x3":
            if not torch.equal(got, fn(a, b)):
                fail(f"{fn.__name__} M{M} K{K} N{N} [{route}]: two calls on "
                     f"the same inputs differ")
            case["bitwise_repeatable"] = True
            case["split_a_in_kernel"] = ops.tf32_split_a_in_kernel(a)
        cases.append(case)
        log("kernels", f"{fn.__name__} M{M} K{K} N{N} {dtype}"
            + (f" at +{4 * offset} bytes" if offset else "")
            + f" [{route}]: max_abs_err {err:.3e}"
            + ("; two calls bitwise equal" if route == "tf32x3" else ""))

    M, K, N = CASE2
    flops = ops.work(M, K, N)["flops"]
    summaries = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        a = torch.randn(M, K, generator=gen, device=device).to(dt)
        b = torch.randn(K, N, generator=gen, device=device).to(dt)
        bp = ops._pad_to(b, ops.TILE, ops.TILE)
        Np = bp.shape[1]
        route = ops.route(dt)
        want = ops.matmul_ref(a, b)
        got = on_route(ops.KERNELS, route, lambda: ops.padded_matmul(a, b))
        err = max_err(got, want, dtype, matmul_tol(dtype, K))
        case = dict(fn="padded_matmul", shape=[M, K, N], dtype=dtype,
                    route=route, max_abs_err=err)
        if route == "tf32x3":
            if not torch.equal(got, ops.padded_matmul(a, b)):
                fail("padded_matmul at the Case-2 shape [tf32x3]: two calls "
                     "on the same inputs differ")
            # against an fp64 product: the kernel, torch.matmul fp32 and one
            # TF32 pass (cuBLAS TF32)
            exact = a.double() @ b.double()
            torch.backends.cuda.matmul.allow_tf32 = True
            one_pass = torch.matmul(a, b)
            torch.backends.cuda.matmul.allow_tf32 = False
            fp64 = {name: float((t.double() - exact).abs().max())
                    for name, t in (("kernel", got), ("torch_fp32", want),
                                    ("one_tf32_pass", one_pass))}
            del exact, one_pass
            case.update(bitwise_repeatable=True, fp64_max_abs_err=fp64)
            log("kernels", f"padded_matmul M{M} K{K} N{N} float32 [{route}]: "
                f"max abs err against an fp64 product {fp64['kernel']:.3e} "
                f"(torch.matmul fp32 {fp64['torch_fp32']:.3e}, one TF32 pass "
                f"{fp64['one_tf32_pass']:.3e}); two calls bitwise equal")
            if fp64["kernel"] > 0.5 * fp64["one_tf32_pass"]:
                fail(f"padded_matmul [{route}]: its error against an fp64 "
                     f"product is not below half that of one TF32 pass: "
                     f"{fp64}")
        cases.append(case)
        del got, want
        iters = 20 if route == "wgmma" else 5
        if route == "wgmma":
            ms = time_ms(lambda: ops.matmul_cuda(a, bp), iters, 1)
            lib_ms = time_ms(lambda: torch.matmul(a, b), 20)
        else:
            ms, lib_ms = in_turns(
                {"kernel": lambda: ops.matmul_cuda(a, bp),
                 "torch": lambda: torch.matmul(a, b)}, iters).values()
        op_ms = time_ms(lambda: ops.padded_matmul(a, b), iters, 1)
        plain_ms = time_ms(lambda: ops.matmul_ref(a, b), 5, 1)
        lib_aligned_ms = time_ms(lambda: torch.matmul(a, bp), 20)
        nbytes = ops.work(M, K, N, a.element_size())["bytes"]
        peak = PEAK_BF16_FLOPS if route == "wgmma" else PEAK_TF32_FLOPS
        t_ops, t_bytes = terms(ops.work(M, K, N, a.element_size()), peak)
        summaries[route] = summary = dict(
            name="padded_matmul" if route == "wgmma" else "padded_matmul_fp32",
            route="cuda",
            source=f"src/repro_torch/kernels/csrc/{ops.KERNELS[route].source}",
            replaces="src/repro/kernels/padded_matmul/kernel.py:39",
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            bytes_bound_ms=t_bytes, library_ms=lib_ms,
            library_call=f"torch.matmul {dtype} at N {N}",
            library_aligned_ms=lib_aligned_ms, op_ms=op_ms,
            shape=[M, K, N], padded_shape=[M, K, Np], dtype=dtype,
            flops=flops, bytes=nbytes)
        if route == "tf32x3":
            summary.update(
                design_floor_ms=max(3 * t_ops, t_bytes),
                fp32_pipe_bound_ms=flops / PEAK_FP32_FLOPS * 1e3,
                scratch_bytes=ops.tf32_scratch_bytes(
                    M, Np, K, ops.tf32_split_a_in_kernel(a)),
                fp64_max_abs_err=case["fp64_max_abs_err"])
        log("kernels", f"padded_matmul [{route}] timed at the Case-2 shape "
            f"M{M} K{K} N{N} {dtype}: kernel on the padded N {Np} "
            f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s of the unpadded "
            f"work), the op with pads and slice {op_ms:.4f} ms, plain (fp32 "
            f"product) {plain_ms:.4f} ms, torch.matmul at N {N} "
            f"{lib_ms:.4f} ms{'' if route == 'wgmma' else ' in turns'} and "
            f"at N {Np} {lib_aligned_ms:.4f} ms; bound "
            f"{summary['bound_ms']:.4f} ms by {summary['bound_by']} "
            f"({flops:.3e} flops = {t_ops:.4f} ms at the "
            f"{'bf16' if route == 'wgmma' else 'TF32'} tensor-core peak, "
            f"{nbytes:.3e} bytes = {t_bytes:.4f} ms)"
            + (f"; FP32-pipe bound {summary['fp32_pipe_bound_ms']:.4f} ms; "
               f"scratch {summary['scratch_bytes']} bytes"
               if route == "tf32x3" else ""))
        del a, b, bp
        torch.cuda.empty_cache()
    tc = tensor_core_fields(summaries["wgmma"], ops.KERNELS["wgmma"], flops)
    tc["library_aligned_factor"] = tc["ms"] / tc["library_aligned_ms"]
    log("kernels", f"padded_matmul [wgmma] against torch.matmul at the "
        f"aligned N {tc['padded_shape'][2]}: "
        f"{tc['library_aligned_factor']:.2f}x")
    tf = tensor_core_fields(summaries["tf32x3"], ops.KERNELS["tf32x3"], flops,
                            "tf32x3")
    return tc, tf, cases


# the ring path: one 25 MB fp32 bucket per rank (PyTorch DDP's default
# bucket_cap_mb), 4 ranks on the one card
RING_WORLD = 4
RING_NUMEL = 25 * 2 ** 20 // 4          # 6,553,600
RING_CHUNK = RING_NUMEL // RING_WORLD   # 1,638,400
# a bucket of any other size: its chunk, 1,638,401, is not a multiple of the
# 1024-element combine block, so it travels padded to 1,639,424 (1601 blocks)
RING_ODD_NUMEL = RING_NUMEL + 1
RING_ODD_CHUNK = 1601 * 1024
# host visibility: reads of the counters behind a sleep, each sleep twice
# the last (0.1 s to 1.6 s), until one read came before the sleep ended
VISIBILITY_TRIES = 5


def check_ring_combine(gen, device):
    """Bitwise against acc + incoming with progress 1..n at the JAX cases
    and the ring's chunk, fp32 and bf16; the counters written into rows of
    one caller's pinned buffer, as the collective passes them; the
    host-visibility check; a host poll of a large combine; timed at the
    ring's chunk."""
    import numpy as np
    import torch
    from repro_torch.kernels.ring_reduce import ops

    cases = []
    # the JAX cases, the ring's chunk, the odd bucket's padded chunk, a
    # block that is not a multiple of 16 bytes and inputs that do not start
    # on 16 bytes (both one element an access)
    for (C, block, offset) in [(4096, 512, 0), (2048, 1024, 0),
                               (1024, 1024, 0), (RING_CHUNK, 1024, 0),
                               (RING_ODD_CHUNK, 1024, 0), (3 * 1022, 1022, 0),
                               (8192, 1024, 1)]:
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            acc = torch.randn(C + offset, generator=gen,
                              device=device).to(dt)[offset:]
            inc = torch.randn(C + offset, generator=gen,
                              device=device).to(dt)[offset:]
            vec = ops.combine_vec(block, acc.element_size(), acc.data_ptr(),
                                  inc.data_ptr())
            out, prog = ops.ring_combine_cuda(acc, inc, block)
            torch.cuda.synchronize()
            want = ops.combine_ref(acc, inc)
            if not torch.equal(out, want):
                fail(f"ring_combine C{C} block {block} {dtype}: not bitwise "
                     f"equal to acc + incoming (max abs err "
                     f"{float((out.float() - want.float()).abs().max()):.3e})")
            if not torch.equal(prog, ops.progress_ref(C, block)):
                fail(f"ring_combine C{C} block {block} {dtype}: progress "
                     f"{prog[:8].tolist()}... != 1..{C // block}")
            cases.append(dict(C=C, block=block, dtype=dtype, vec=vec,
                              bitwise=True))
            log("kernels", f"ring_combine C{C} block {block} {dtype}, "
                f"{vec} element(s) an access: bitwise equal, progress "
                f"1..{C // block}")

    # the collective's counters: step s's combine writes row s of one
    # pinned buffer (parallel/collectives.combine_counters), through a
    # pointer inside the buffer's allocation
    nb = RING_CHUNK // 1024
    rows = torch.zeros((RING_WORLD - 1, nb), dtype=torch.int32,
                       pin_memory=True)
    for s in range(RING_WORLD - 1):
        acc = torch.randn(RING_CHUNK, generator=gen, device=device)
        inc = torch.randn(RING_CHUNK, generator=gen, device=device)
        out, prog = ops.ring_combine_cuda(acc, inc, 1024, progress=rows[s])
        torch.cuda.synchronize()
        if prog.data_ptr() != rows[s].data_ptr():
            fail("ring_combine: the caller's counters were not the ones "
                 "written")
        if not torch.equal(out, ops.combine_ref(acc, inc)):
            fail(f"ring_combine with the caller's counters, row {s}: not "
                 f"bitwise equal to acc + incoming")
        want = torch.zeros_like(rows)
        want[:s + 1] = ops.progress_ref(RING_CHUNK, 1024)
        if not torch.equal(rows, want):
            fail(f"ring_combine: after row {s}'s combine the caller's "
                 f"counters read {rows[:, :4].tolist()}...")
    log("kernels", f"ring_combine into rows of one pinned [{RING_WORLD - 1}, "
        f"{nb}] buffer (the collective's counters): each row 1..{nb} after "
        f"its combine, the later rows untouched")

    # host visibility: the combine queued behind a sleep on a side stream;
    # its pinned counters read without a synchronise are all zero, and
    # complete after it.  An event recorded between the sleep and the
    # combine, still pending after the read, proves that the read came
    # before the combine could run; a read that a stalled host made only
    # after the sleep proves nothing, and is made again behind a sleep
    # twice as long
    C = RING_CHUNK
    side = torch.cuda.Stream()
    for attempt in range(VISIBILITY_TRIES):
        acc = torch.randn(C, generator=gen, device=device)
        inc = torch.randn(C, generator=gen, device=device)
        slept = torch.cuda.Event()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            # ~0.1 s at the card's clock, doubled on each attempt
            torch.cuda._sleep(200_000_000 << attempt)
            slept.record()
            out, prog = ops.ring_combine_cuda(acc, inc, 1024)
        before = prog.numpy().copy()
        read_in_time = not slept.query()
        side.synchronize()
        after = prog.numpy().copy()
        if not (after == ops.progress_ref(C, 1024).numpy()).all():
            fail("ring_combine: counters incomplete after the stream "
                 "synchronised")
        if read_in_time:
            break
    else:
        fail(f"ring_combine: in {VISIBILITY_TRIES} tries the host never read "
             f"the counters before the sleep ahead of the combine ended")
    if before.any():
        fail(f"ring_combine: {int((before != 0).sum())} counters set before "
             f"the queued kernel could run")
    log("kernels", f"ring_combine host visibility: {C // 1024} pinned "
        f"counters read unsynchronised behind a sleep (still running after "
        f"the read; attempt {attempt + 1}): all 0; after the sync: "
        f"1..{C // 1024}")

    # a large combine polled from the host while it runs (printed, not held)
    Cbig = 64 * 2 ** 20
    big_a = torch.randn(Cbig, generator=gen, device=device)
    big_b = torch.randn(Cbig, generator=gen, device=device)
    nb = Cbig // 1024
    with torch.cuda.stream(side):
        torch.cuda._sleep(20_000_000)
        _, prog = ops.ring_combine_cuda(big_a, big_b, 1024)
    view = prog.numpy()
    seen, polls = set(), 0
    t_end = time.perf_counter() + 10.0
    while time.perf_counter() < t_end:
        done = int(np.count_nonzero(view))
        polls += 1
        if 0 < done < nb:
            seen.add(done)
        if done == nb:
            break
    side.synchronize()
    log("kernels", f"ring_combine C{Cbig} ({nb} blocks): a host poll saw "
        f"{len(seen)} intermediate counts in {polls} polls"
        + (f" (from {min(seen)} to {max(seen)} of {nb})" if seen else ""))
    del big_a, big_b

    # timed at the ring's chunk, fp32: device time per call with the
    # inputs cycled through 5 pairs (131 MB with the outputs, more than the
    # 50 MB L2), so each call reads them from device memory as the bound
    # counts; one pair left in L2 is timed too; and the wrapper's host cost
    # per call (launch and event, with fresh pinned counters or with the
    # caller's, as the collective passes them)
    pairs = [(acc, inc)] + [
        (torch.randn(C, generator=gen, device=device),
         torch.randn(C, generator=gen, device=device)) for _ in range(4)]

    def cold(fn):
        it = itertools.cycle(pairs)
        return time_ms(lambda: fn(*next(it)), 200, behind_sleep=True)

    ms = cold(lambda a, b: ops.ring_combine_cuda(a, b, 1024))
    plain_ms = cold(ops.combine_ref)
    library_ms = cold(torch.add)
    hot_ms = time_ms(lambda: ops.ring_combine_cuda(acc, inc, 1024), 200,
                     behind_sleep=True)
    hot_library_ms = time_ms(lambda: torch.add(acc, inc), 200,
                             behind_sleep=True)
    host_ms = time_ms(lambda: ops.ring_combine_cuda(acc, inc, 1024), 200)
    host_given_ms = time_ms(lambda: ops.ring_combine_cuda(
        acc, inc, 1024, progress=rows[0]), 200)
    nbytes = ops.work(C, acc.element_size())["bytes"]
    t_ops, t_bytes = terms(ops.work(C, acc.element_size()), PEAK_BF16_FLOPS)
    summary = dict(
        name="ring_combine", route="cuda",
        source="src/repro_torch/kernels/csrc/ring_combine.cu",
        replaces="src/repro/kernels/ring_reduce/kernel.py:26",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_ops, t_bytes),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=library_ms, library_call="torch.add",
        l2_resident_ms=hot_ms, l2_resident_library_ms=hot_library_ms,
        host_ms_per_call=host_ms, host_ms_per_call_given=host_given_ms,
        shape=[C], block=1024, dtype="float32", bytes=nbytes,
        host_poll=dict(C=Cbig, polls=polls, intermediate=len(seen)))
    log("kernels", f"ring_combine timed at the ring's chunk C{C} fp32: "
        f"{ms:.4f} ms of device time per call from device memory (plain "
        f"{plain_ms:.4f}, torch.add {library_ms:.4f}, bound "
        f"{summary['bound_ms']:.5f} by {summary['bound_by']}); with the "
        f"inputs in L2 {hot_ms:.4f} (torch.add {hot_library_ms:.4f}); "
        f"{host_ms:.4f} ms per call in a loop that waits on the host "
        f"(fresh pinned counters, launch, event), {host_given_ms:.4f} ms "
        f"with the caller's counters")
    del acc, inc, out, pairs
    torch.cuda.empty_cache()
    return summary, cases


# --------------------------------------------------------------------------- #
# phase 4: the Case-2 op and the ring path
# --------------------------------------------------------------------------- #
def case2_path(seed: int, trace_path: Path):
    """The Case-2 op as a user calls it: one traced ``padded_matmul`` at the
    Case-2 shape in bf16 (step 0) and one in fp32 (step 1), in daemon steps
    (the routes' launch counts set to 0 just before each, read just after:
    one launch on the route of its dtype), each result held to the plain
    version, their spans read back."""
    import torch
    from repro_torch.core.daemon import DaemonConfig, TracingDaemon
    from repro_torch.core.events import EventKind, load_jsonl
    from repro_torch.kernels.padded_matmul import ops

    trace_path.unlink(missing_ok=True)
    M, K, N = CASE2
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    daemon = TracingDaemon(DaemonConfig(backend="case2",
                                        log_path=str(trace_path))).attach()
    runs = {}
    try:
        for step, dtype in enumerate(("bfloat16", "float32")):
            dt = getattr(torch, dtype)
            a = torch.randn(M, K, generator=gen, device="cuda").to(dt)
            b = torch.randn(K, N, generator=gen, device="cuda").to(dt)
            daemon.step_begin(step)
            for k in ops.KERNELS.values():
                k.launches = 0
            out = ops.padded_matmul(a, b)
            launches = {r: k.launches for r, k in ops.KERNELS.items()}
            torch.cuda.synchronize()
            daemon.step_end()
            route = ops.route(dt)
            if launches != {r: int(r == route) for r in ops.KERNELS}:
                fail(f"case2: padded_matmul {dtype} launched {launches}, not "
                     f"once on the {route} route")
            if out.shape != (M, N):
                fail(f"case2: padded_matmul returned {tuple(out.shape)}")
            err = max_err(out, ops.matmul_ref(a, b), dtype,
                          matmul_tol(dtype, K))
            runs[dtype] = dict(route=route, launches=launches, max_abs_err=err)
            del a, b, out
    finally:
        daemon.detach()
    spans = [e for e in load_jsonl(str(trace_path))
             if e.kind == EventKind.KERNEL_COMPUTE]
    if (len(spans) != 2 or any(
            e.name != "padded_matmul" or e.meta.get("flops") != 2.0 * M * K * N
            or e.meta.get("shape") != [M, K, N]
            or e.meta.get("parent") != f"step_{e.step}" or e.duration <= 0
            for e in spans) or sorted(e.step for e in spans) != [0, 1]):
        fail(f"case2: trace holds {[(e.name, e.step, e.meta) for e in spans]}")
    for e in spans:
        dtype = ("bfloat16", "float32")[e.step]
        runs[dtype]["span_ms"] = e.duration * 1e3
        log("case2", f"padded_matmul M{M} K{K} N{N} {dtype}, traced: 1 launch "
            f"on the {runs[dtype]['route']} route, max_abs_err "
            f"{runs[dtype]['max_abs_err']:.3e} against the plain version; span "
            f"{e.duration * 1e3:.3f} ms of device time, flops "
            f"{e.meta['flops']:.4e}")
    torch.cuda.empty_cache()
    return runs


def ring_phase_rank(ctx, numel: int, odd_numel: int, seed: int):
    """One rank of the ring phase: the traced bucket all-reduce (step 0),
    the hang drill (steps 1 and 2), the odd bucket's all-reduce (step 3)."""
    from repro_torch.launch import mesh
    return dict(bucket=mesh.allreduce_rank(ctx, numel, seed),
                hang=mesh.hang_rank(ctx),
                odd=mesh.allreduce_rank(ctx, odd_numel, seed, step=3))


def ring_path(seed: int, trace_dir: Path):
    """4 ranks on the card, gloo, through launch/mesh.py: the bucket
    all-reduce checked bit for bit against the plain ring order, with n - 1
    ring_combine launches per rank (kernel counts and the ranks' traces);
    the hang drill, whose live progress, read from the frozen combine
    counters, the diagnose phase's engine turns into the broken link
    (``hang_drills``); and a bucket of an odd size, whose chunks travel
    padded to whole combine blocks."""
    from repro_torch.core.events import EventKind, load_jsonl
    from repro_torch.launch.mesh import (HANG_FAULTS, HANG_GROUP_TIMEOUT,
                                         run_ranks)

    n = RING_WORLD
    for old in trace_dir.glob("rank*.jsonl"):
        old.unlink()
    t0 = time.perf_counter()
    ranks = run_ranks(ring_phase_rank, n, RING_NUMEL, RING_ODD_NUMEL, seed,
                      device="cuda", timeout=300.0, log_dir=str(trace_dir))
    wall = time.perf_counter() - t0
    buckets = [r["bucket"] for r in ranks]
    odd = [r["odd"] for r in ranks]
    span_ms = []
    for step, runs, chunk in ((0, buckets, RING_CHUNK),
                              (3, odd, RING_ODD_CHUNK)):
        for b in runs:
            if not (b["bitwise_equal"] and b["finite"]):
                fail(f"ring: rank {b['rank']} all-reduce of {b['numel']} "
                     f"differs from the plain ring order (max abs err "
                     f"{b['max_abs_err']:.3e})")
            if b["progress"] != [1] * (2 * (n - 1)):
                fail(f"ring: rank {b['rank']} progress {b['progress']}")
            if b["launches"] != n - 1:
                fail(f"ring: rank {b['rank']} launched ring_combine "
                     f"{b['launches']} times, not {n - 1}")
        for r in range(n):
            evs = [e for e in load_jsonl(str(trace_dir / f"rank{r}.jsonl"))
                   if e.name == "ring_combine" and e.step == step]
            if (len(evs) != n - 1
                    or any(e.kind != EventKind.KERNEL_COMM for e in evs)
                    or any(e.meta.get("bytes") != 3 * chunk * 4
                           or e.meta.get("shape") != [chunk] for e in evs)
                    or any(e.duration <= 0 for e in evs)):
                fail(f"ring: rank {r} trace has {len(evs)} ring_combine "
                     f"spans in step {step}: "
                     f"{[(e.kind.value, e.meta) for e in evs]}")
            if step == 0:
                span_ms += [e.duration * 1e3 for e in evs]
    log("ring", f"{n} ranks, gloo through pinned host memory, one "
        f"{RING_NUMEL * 4 / 2 ** 20:.0f} MB fp32 bucket each: bitwise equal "
        f"to the plain ring order on every rank; progress all ones; "
        f"ring_combine launches {[b['launches'] for b in buckets]} (kernel "
        f"counts) and {n - 1} spans per rank with bytes "
        f"{3 * RING_CHUNK * 4} in the traces (device {min(span_ms):.4f}-"
        f"{max(span_ms):.4f} ms); all-reduce wall "
        f"{[round(b['wall_s'] * 1e3, 3) for b in buckets]} ms")
    log("ring", f"odd bucket, {RING_ODD_NUMEL} elements: chunks padded to "
        f"{RING_ODD_CHUNK} ({RING_ODD_CHUNK // 1024} whole combine blocks), "
        f"bitwise equal to the plain ring order on every rank, "
        f"{[b['launches'] for b in odd]} launches; all-reduce wall "
        f"{[round(b['wall_s'] * 1e3, 3) for b in odd]} ms")
    drills = []
    for i, fault in enumerate(HANG_FAULTS):
        ds = [r["hang"][i] for r in ranks]
        steps = [d["steps"] for d in ds]
        if any(s is None or d["error"] is None for s, d in zip(steps, ds)):
            fail(f"ring: hang drill {fault}: a rank saw no hang report or "
                 f"its collective did not end in the timeout: {ds}")
        stacks = [d["report"]["stack"] for d in ds]
        if any(s[-1] != "ring_all_reduce" for s in stacks):
            fail(f"ring: hang drill {fault}: stacks {stacks}")
        # the steps come from the frozen combine counters: each agrees with
        # the host's own count, and each row is whole or untouched
        for r, d in enumerate(ds):
            done = min(d["steps"], n - 1)
            rows = d["counters"]
            if (d["steps"] != d["host_steps"]
                    or any(row != [1] for row in rows[:done])
                    or any(row != [0] for row in rows[done:])):
                fail(f"ring: hang drill {fault}: rank {r} published "
                     f"{d['steps']} steps from the counters {rows}, the host "
                     f"counted {d['host_steps']}")
        # the link these steps name is the port's engine's to find, in the
        # diagnose phase (``hang_drills``)
        secs = max(d["seconds"] for d in ds)
        if secs > HANG_GROUP_TIMEOUT + 5.0:
            fail(f"ring: hang drill {fault} took {secs:.1f} s to tear down")
        drills.append(dict(fault=fault, steps=steps, stacks=stacks,
                           seconds=secs))
        log("ring", f"hang drill: link {fault}->{(fault + 1) % n} broken from "
            f"ring step 1: live progress {steps} (the frozen combine "
            f"counters, published from each rank's daemon hang callback); "
            f"torn down in {secs:.2f} s (group timeout "
            f"{HANG_GROUP_TIMEOUT} s)")
    log("ring", f"phase wall {wall:.1f} s (4 spawned ranks, CUDA start-up "
        f"included)")
    return dict(buckets=buckets, odd_buckets=odd, drills=drills,
                wall_s=wall, launches=sum(b["launches"] for b in buckets),
                odd_launches=sum(b["launches"] for b in odd))


# --------------------------------------------------------------------------- #
# phase 4b: diagnose — the port's engine on traces the daemon took here
# --------------------------------------------------------------------------- #
DRILL_STEPS = 6          # daemon steps a job; step 0 is the warm-up
CASE2_ALIGNED_N = 8576   # the healthy job's N: the port's 128-column tile


def engine_job(name: str, events: list, history, healthy: bool = False,
               **config) -> dict:
    """One job through the port's engine: its events ingested, a healthy
    job's profile learned from its steps after the warm-up, then
    ``evaluate_all``; the report and the engine's host seconds printed.
    Returns its anomalies, host seconds and per-step metrics."""
    from repro_torch.core.engine import DiagnosticEngine, EngineConfig
    from repro_torch.core.report import anomaly_report

    t0 = time.perf_counter()
    eng = DiagnosticEngine(EngineConfig(num_ranks=1, **config), history)
    eng.ingest(events)
    if healthy:
        eng.learn_healthy(steps=list(range(1, DRILL_STEPS)))
    found = eng.evaluate_all()
    secs = time.perf_counter() - t0
    log("diagnose", f"{name}: {len(events)} events, {len(found)} "
        f"anomalies, engine {secs * 1e3:.1f} ms of host time")
    for line in anomaly_report(found).splitlines():
        log("diagnose", f"  {line}")
    return dict(anomalies=found, engine_s=secs, metrics=eng.metrics)


def anomaly_rows(found: list) -> list:
    from repro_torch.core.report import anomalies_json
    return json.loads(anomalies_json(found))


def expect(what: str, found: list, kind: str, metric: str | None,
           team: str, phase: str = "diagnose"):
    """The drill's anomaly: the first of ``found`` with this kind, metric
    (any where None) and team; fails when there is none."""
    hit = [a for a in found if a.kind == kind and a.team.value == team
           and (metric is None or a.metric == metric)]
    if not hit:
        fail(f"{phase}: {what}: no ({kind!r}, {metric!r}, {team}) anomaly "
             f"among {[(a.kind, a.metric, a.team.value) for a in found]}")
    return hit[0]


def case2_drill(seed: int, fleet: "FleetLive") -> dict:
    """Case 2 (paper §7.3.2): a traced FFN product ``ffn_matmul``, 4096 x
    8192 @ 8192 x N in bf16, one a daemon step.  The healthy job runs
    ``torch.matmul`` at N 8576; the drilled one at the paper's N 8484, with
    the layout advisor told the weight's shape; the fixed one runs the same
    8484 product through ``padded_matmul``, whose verdict is printed.  The
    drilled and fixed jobs also stream live into ``fleet``."""
    import torch
    from repro_torch.core.daemon import DaemonConfig, TracingDaemon
    from repro_torch.core.events import EventKind
    from repro_torch.kernels.padded_matmul import ops

    M, K, N = CASE2
    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    a = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(K, CASE2_ALIGNED_N, generator=gen,
                    device="cuda").to(torch.bfloat16)
    w_mis = w[:, :N].contiguous()

    def meta(x, y):
        m, k, n = x.shape[0], x.shape[1], y.shape[1]
        return {"flops": 2.0 * m * k * n, "shape": [m, k, n]}

    history = fleet.history
    jobs = {f"healthy (torch.matmul, N {CASE2_ALIGNED_N})": (torch.matmul, w,
                                                            None),
            f"drilled (torch.matmul, N {N})": (torch.matmul, w_mis,
                                               "case2-drilled"),
            f"fixed (padded_matmul, N {N})": (ops.padded_matmul, w_mis,
                                             "case2-fixed")}
    out = {}
    for job, (fn, weight, fleet_job) in jobs.items():
        healthy = fleet_job is None
        shapes = {} if healthy else {"kernel_shapes": {"ffn_matmul": (K, N)}}
        events: list = []
        daemon = TracingDaemon(DaemonConfig(
            backend="case2-ffn",
            log_path=None if healthy else fleet.spill(fleet_job)))
        daemon.add_sink(events.extend)
        if not healthy:
            fleet.attach(fleet_job, daemon, backend="case2-ffn", **shapes)
        daemon.attach()
        ffn = daemon.register_kernel("ffn_matmul", EventKind.KERNEL_COMPUTE,
                                     meta_fn=meta)(fn)
        for k in ops.KERNELS.values():
            k.launches = 0
        try:
            for step in range(DRILL_STEPS):
                daemon.step_begin(step)
                y = ffn(a, weight)
                torch.cuda.synchronize()
                daemon.step_end()
                del y
        finally:
            daemon.detach()
        launches = {r: k.launches for r, k in ops.KERNELS.items()}
        res = engine_job(f"case2 {job}", events, history, healthy,
                         backend="case2-ffn", **shapes)
        if not healthy:
            fleet.done(fleet_job, res["anomalies"], events)
        prof = history.get("case2-ffn", 1)
        exp = prof.expected_flops["ffn_matmul"]
        got = [res["metrics"][s].flops["ffn_matmul"][0]
               for s in range(DRILL_STEPS)]
        ratio = sorted(g / exp for g in got[1:])[len(got[1:]) // 2]
        log("diagnose", f"case2 {job}: ffn_matmul {got[-1] / 1e12:.1f} "
            f"TFLOP/s at the last step, {ratio:.4f} of the healthy median "
            f"{exp / 1e12:.1f} (median of steps 1-{DRILL_STEPS - 1}; "
            f"FLOPS_REGRESSION_FRAC 0.75), step 0 {got[0] / exp:.4f}; "
            f"padded_matmul launches {launches}")
        out[job] = dict(anomalies=anomaly_rows(res["anomalies"]),
                        engine_s=res["engine_s"], flops=got,
                        expected_flops=exp, ratio=ratio, launches=launches,
                        found=res["anomalies"], fleet_job=fleet_job,
                        bracket_s=daemon.telemetry.value(
                            "daemon.anchor_bracket_max_s"))
    drilled, fixed = (out[j] for j in list(jobs)[1:])
    hit = expect("case2 drilled job", drilled["found"], "regression",
                 "flops", "infrastructure")
    adv = hit.evidence.get("layout_advice") or {}
    if adv.get("misaligned_dims") != [N] or adv.get("padded_dims") != [8512]:
        fail(f"diagnose: case2 layout advice {adv}, not {N} -> 8512")
    log("diagnose", f"case2: the engine names ({hit.kind}, {hit.metric}, "
        f"{hit.team.value}) from step {hit.step}: {hit.root_cause}; "
        f"suggestion {adv['suggestion']!r}")
    flagged = [a for a in fixed["found"] if a.metric == "flops"]
    log("diagnose", f"case2 fixed job (padded_matmul): ratio "
        f"{fixed['ratio']:.4f}, {'still' if flagged else 'not'} flagged as a "
        f"FLOPS regression ({len(flagged)} anomalies)")
    for job in out.values():
        job.pop("found")
    del a, w, w_mis
    torch.cuda.empty_cache()
    return dict(jobs=out, advice=adv, fixed_flagged=bool(flagged),
                launches=fixed["launches"])


def spans_outside_steps(events: list) -> tuple:
    """(device spans, those not inside their step's span, the widest
    excursion in s): the host and device clocks' agreement that v_inter
    reads."""
    from repro_torch.core.events import DEVICE_KINDS, EventKind
    steps = {e.step: e for e in events if e.kind == EventKind.STEP}
    dev = [e for e in events if e.kind in DEVICE_KINDS and e.step in steps]
    out = [max(steps[e.step].start_ts - e.start_ts,
               e.end_ts - steps[e.step].end_ts) for e in dev]
    bad = [x for x in out if x > 0]
    return len(dev), len(bad), max(bad, default=0.0)


def case3_drill(seed: int, fleet: "FleetLive") -> dict:
    """Case 3 (paper §7.3.3): llama3.2-1b at full width through
    ``Trainer.train``, B 8 x S ``CASE3_S``, ``DRILL_STEPS`` steps a job,
    the daemon's events to a sink.  Healthy: the O(S) mask, prefetch on;
    drilled: the O(S^2) mask, a synchronous dataloader, streaming live into
    ``fleet`` too."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.events import EventKind
    from repro_torch.core.report import ascii_timeline
    from repro_torch.runtime.train import RunConfig, Trainer

    arch = "llama3.2-1b"
    kernels = train_kernels(arch)
    history = fleet.history
    out = {}
    for job, mask, prefetch in (("healthy", "fast", True),
                                ("drilled", "naive", False)):
        fleet_job = "case3-drilled" if job == "drilled" else None
        run = RunConfig(model=get_config(arch), global_batch=TRAIN_B,
                        seq_len=CASE3_S, steps=DRILL_STEPS, warmup_steps=2,
                        seed=seed, mask_mode=mask, data_prefetch=prefetch,
                        flare_log=fleet_job and fleet.spill(fleet_job))
        trainer = Trainer(run)
        events: list = []
        trainer.daemon.add_sink(events.extend)
        if fleet_job:
            fleet.attach(fleet_job, trainer.daemon,
                         backend=trainer.daemon.cfg.backend)
        for k, _, _ in kernels.values():
            k.launches = 0
        hist = trainer.train()
        launches = {label: k.launches for label, (k, _, _) in kernels.items()}
        backend = trainer.daemon.cfg.backend
        bracket = trainer.daemon.telemetry.value("daemon.anchor_bracket_max_s")
        del trainer
        torch.cuda.empty_cache()
        n_dev, n_out, widest = spans_outside_steps(events)
        res = engine_job(f"case3 {job} (mask {mask}, prefetch "
                         f"{'on' if prefetch else 'off'})", events, history,
                         job == "healthy", backend=backend)
        if fleet_job:
            fleet.done(fleet_job, res["anomalies"], events)
        ms = res["metrics"]
        prof = history.get(backend, 1)
        dl = [e.duration for e in events
              if e.kind == EventKind.DATALOADER and e.step >= 1]
        step_s = sorted(r["step_time_s"] for r in hist[1:])
        log("diagnose", f"case3 {job}: v_inter by step "
            f"{[round(ms[s].v_inter, 4) for s in sorted(ms)]} (threshold "
            f"{prof.v_inter_threshold:.4f} = max(1.6 x the healthy maximum, "
            f"0.02)); v_minority "
            f"{[round(ms[s].v_minority, 4) for s in sorted(ms)]}"
            f" (threshold {prof.v_minority_threshold:.4f}); step "
            f"{step_s[len(step_s) // 2] * 1e3:.1f} ms median of steps 1-"
            f"{DRILL_STEPS - 1}, dataloader.next_batch {max(dl) * 1e3:.1f} ms "
            f"at most; device spans outside their step {n_out} of {n_dev} "
            f"(widest {widest * 1e6:.1f} us); launches {launches}")
        out[job] = dict(
            anomalies=anomaly_rows(res["anomalies"]), engine_s=res["engine_s"],
            v_inter=[ms[s].v_inter for s in sorted(ms)],
            v_minority=[ms[s].v_minority for s in sorted(ms)],
            v_inter_threshold=prof.v_inter_threshold,
            v_minority_threshold=prof.v_minority_threshold,
            step_s=[r["step_time_s"] for r in hist],
            dataloader_s=dl, spans=n_dev, spans_outside_step=n_out,
            widest_outside_s=widest, launches=launches, found=res["anomalies"],
            timeline=ascii_timeline(events, 0, 2) if job == "drilled" else "",
            fleet_job=fleet_job, bracket_s=bracket)
    healthy, drilled = out["healthy"], out["drilled"]
    naive = sorted(drilled["dataloader_s"])[len(drilled["dataloader_s"]) // 2]
    step = sorted(healthy["step_s"][1:])[len(healthy["step_s"][1:]) // 2]
    log("diagnose", f"case3: the naive mask's dataloader span "
        f"{naive * 1e3:.1f} ms (median) against the healthy step "
        f"{step * 1e3:.1f} ms: {naive / step:.3f} of it")
    hit = expect("case3 drilled job", drilled["found"], "regression",
                 "v_inter", "algorithm")
    log("diagnose", f"case3: the engine names ({hit.kind}, {hit.metric}, "
        f"{hit.team.value}) from step {hit.step}: v_inter "
        f"{hit.evidence['v_inter']:.4f} against "
        f"{hit.evidence['threshold']:.4f}")
    log("diagnose", "case3 drilled job, step 2:")
    for line in drilled["timeline"].splitlines():
        log("diagnose", f"  {line}")
    for job in out.values():
        job.pop("found")
    return dict(jobs=out, naive_over_step=naive / step, arch=arch,
                S=CASE3_S, B=TRAIN_B)


def hang_drills(ring_run: dict, trace_dir: Path) -> list:
    """The ring's hang drills (paper §5.3) through the port's engine:
    ``on_hang`` on each drill's published stacks and ring steps, and
    ``check_hangs`` on the hang_suspect events the four ranks spilled in the
    drill's step; each must give one hang anomaly routed to operations
    naming link f -> f+1 with a unique minimum; the supervisor's actions
    printed."""
    import numpy as np
    from repro_torch.core.engine import DiagnosticEngine, EngineConfig
    from repro_torch.core.events import EventKind, load_jsonl
    from repro_torch.core.report import anomaly_report
    from repro_torch.launch.mesh import HANG_FAULTS
    from repro_torch.runtime.supervisor import Supervisor

    n = RING_WORLD
    spilled = [load_jsonl(str(trace_dir / f"rank{r}.jsonl"))
               for r in range(n)]
    out = []
    for i, (fault, drill) in enumerate(zip(HANG_FAULTS, ring_run["drills"])):
        want = (fault, (fault + 1) % n)
        stacks = dict(enumerate(drill["stacks"]))
        progress = np.array(drill["steps"])
        t0 = time.perf_counter()
        live = DiagnosticEngine(EngineConfig(backend="ring", num_ranks=n))
        found_live = live.on_hang(stacks, progress)
        events = [e for evs in spilled for e in evs if e.step == 1 + i]
        suspects = {e.rank for e in events
                    if e.kind == EventKind.HANG_SUSPECT}
        eng = DiagnosticEngine(EngineConfig(backend="ring", num_ranks=n))
        eng.ingest(events)
        found = eng.check_hangs(progress)
        secs = time.perf_counter() - t0
        for what, got in (("on_hang", found_live), ("check_hangs", found)):
            hit = expect(f"hang drill {fault} ({what})", got, "hang", None,
                         "operations")
            link = tuple(hit.evidence.get("link") or ())
            if link != want or "confidence=high" not in hit.root_cause:
                fail(f"diagnose: hang drill {fault} ({what}): progress "
                     f"{drill['steps']} gives {hit.root_cause!r}, link "
                     f"{link}, not {want} with a unique minimum")
        actions = Supervisor().apply_diagnosis(found)
        log("diagnose", f"hang drill, link {want[0]}->{want[1]} broken: "
            f"on_hang, and check_hangs on the hang_suspect events of ranks "
            f"{sorted(suspects)}, name ({hit.kind}, {hit.metric}, "
            f"{hit.team.value}) "
            f"ranks {hit.ranks}: {hit.root_cause}; engine "
            f"{secs * 1e3:.1f} ms of host time; supervisor "
            f"{[(a.kind, a.ranks) for a in actions]}")
        for line in anomaly_report(found).splitlines():
            log("diagnose", f"  {line}")
        out.append(dict(fault=fault, link=list(link), steps=drill["steps"],
                        anomalies=anomaly_rows(found),
                        live_anomalies=anomaly_rows(found_live),
                        engine_s=secs,
                        actions=[dict(kind=a.kind, ranks=a.ranks,
                                      note=a.note) for a in actions]))
    return out


def diagnose_phase(seed: int, ring_run: dict, trace_dir: Path,
                   fleet: "FleetLive") -> dict:
    """The three drills through the port's engine (``hang_drills``,
    ``case2_drill``, ``case3_drill``), with the phase's wall; the drilled
    jobs stream into ``fleet`` as they run."""
    t0 = time.perf_counter()
    hang = hang_drills(ring_run, trace_dir)
    case2 = case2_drill(seed, fleet)
    case3 = case3_drill(seed, fleet)
    wall = time.perf_counter() - t0
    log("diagnose", f"phase wall {wall:.1f} s")
    return dict(case2=case2, case3=case3, hang=hang, wall_s=wall)


# --------------------------------------------------------------------------- #
# phase 4c: fleet — the port's fleet layer, fed live by the drills' daemons
# --------------------------------------------------------------------------- #
FLEET_DIR = OUT_DIR / "fleet"              # one FCS spill a live fleet job
FLEET_HISTORY = OUT_DIR / "fleet_history"  # the phase's profiles, as JSON
FLEET_SPEC = OUT_DIR / "fleet_spec.json"   # the fleet's and jobs' configs
FLEET_HANG_DIR = OUT_DIR / "fleet_hang"    # a hang drill's step, a rank
FLEET_DETECTORS = ["cross_job_failslow"]
FAILSLOW_JOBS = ("failslow-a", "failslow-b")
FAILSLOW_STEPS = 12
FAILSLOW_ON, FAILSLOW_OFF = 7, 11   # the co-runner runs before steps 7-10
FAILSLOW_RACK = {"rack": "rack-0", "switch": "switch-0"}
CORUNNER_N = 8192                   # the co-runner's bf16 N^3 product
CORUNNER_START_S = 180.0            # its start-up: interpreter, torch, CUDA
HANDSHAKE_S = 60.0                  # the longest wait for a reply
# the live jobs by engine config, one trace archive each: an archive
# replays its files with one EngineConfig
ARCHIVE_GROUPS = ("case2-", "case3-", "failslow-")


@functools.cache
def repo_script(rel: str):
    """A script of the checkout (``tools/*.py``, ``examples/*.py``) as a
    module, loaded once."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fleet_replay_tool():
    """``tools/fleet_replay.py`` as a module: its stream rows, spec file
    and in-process replay."""
    return repo_script("tools/fleet_replay.py")


class FleetLive:
    """The fleet phase's live side: one ``FleetMultiplexer`` (watermark
    delay 1, the ``cross_job_failslow`` tier) over the ``HistoryStore``
    that the drills' healthy jobs learn into; each live job's engine
    config, daemon and batch result; every poll of the stream."""

    def __init__(self):
        import shutil
        from repro_torch.core.history import HistoryStore
        from repro_torch.fleet import FleetConfig, FleetMultiplexer

        class TimedMultiplexer(FleetMultiplexer):
            """Sums each job's host seconds in ``ingest``: the batch
            sink's work on the daemon thread, with the diagnosis of the
            steps a drain closes."""

            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                self.host_s: dict = {}

            def ingest(self, job_id, events):
                t0 = time.perf_counter()
                try:
                    super().ingest(job_id, events)
                finally:
                    self.host_s[job_id] = (self.host_s.get(job_id, 0.0)
                                           + time.perf_counter() - t0)

        shutil.rmtree(FLEET_DIR, ignore_errors=True)
        FLEET_DIR.mkdir(parents=True)
        self.history = HistoryStore()
        self.cfg = FleetConfig(watermark_delay=1,
                               fleet_detectors=FLEET_DETECTORS)
        self.mux = TimedMultiplexer(self.cfg, history=self.history)
        self.jobs: dict = {}
        self.stream: list = []

    @staticmethod
    def spill(job: str) -> str:
        return str(FLEET_DIR / f"{job}.fcs")

    def attach(self, job: str, daemon, **config):
        """``daemon`` streams into the fleet as ``job``, diagnosed with
        ``EngineConfig(num_ranks=1, **config)``, as ``engine_job`` builds
        it.  Before the daemon's first event."""
        from repro_torch.core.engine import EngineConfig
        cfg = EngineConfig(num_ranks=1, **config)
        daemon.attach_fleet(self.mux, job, cfg)
        self.jobs[job] = dict(cfg=cfg, daemon=daemon)

    def done(self, job: str, batch_found: list, events: list):
        """``job``'s run ended and its daemon detached: the job leaves the
        fleet (its last step closed, its detectors finalized), and the
        stream is polled.  ``batch_found``: its batch engine's result."""
        from repro_torch.core.report import anomalies_json
        t0 = time.perf_counter()
        self.mux.retire_job(job)
        self.mux.host_s[job] = (self.mux.host_s.get(job, 0.0)
                                + time.perf_counter() - t0)
        self.stream.extend(self.mux.poll())
        self.jobs[job].update(batch=anomalies_json(batch_found),
                              events=len(events))

    def rows(self) -> list:
        """The live stream in one drain's order, ``(ts, job, seq)``."""
        fas = sorted(self.stream, key=lambda a: (a.ts, a.job_id, a.seq))
        return fleet_replay_tool().stream_rows(fas)


def corunner(conn, n: int):
    """The fail-slow drill's co-runner, a process of its own on the card:
    bf16 ``n``^3 products back to back, each waited on (so that a pause
    takes effect within one product), between a "start" and a "pause"
    from ``conn``.  Each command is answered with its name and the
    products run so far; "stop" ends the process."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(n, n, generator=gen, device="cuda", dtype=torch.bfloat16)
    b = torch.randn(n, n, generator=gen, device="cuda", dtype=torch.bfloat16)
    c = torch.matmul(a, b)
    torch.cuda.synchronize()
    conn.send(("ready", 0))
    running, products = False, 0
    while True:
        if running and not conn.poll():
            torch.matmul(a, b, out=c)
            torch.cuda.synchronize()
            products += 1
            continue
        msg = conn.recv()
        running = msg == "start"
        conn.send((msg, products))
        if msg == "stop":
            return


def handshake(conn, msg: str, timeout: float = HANDSHAKE_S) -> int:
    """Send ``msg`` to the co-runner and wait for its answer; returns its
    products so far."""
    conn.send(msg)
    if not conn.poll(timeout):
        fail(f"fleet: the co-runner did not answer {msg!r} in {timeout} s")
    reply, products = conn.recv()
    if reply != msg:
        fail(f"fleet: the co-runner answered {reply!r} to {msg!r}")
    return products


def failslow_drill(seed: int, fleet: FleetLive) -> dict:
    """Two llama3.2-1b jobs at Case 3's healthy setting (B 8 x S
    ``CASE3_S``, the O(S) mask, prefetch on), ``FAILSLOW_STEPS`` steps
    each through ``Trainer.train``, on one rack and switch, streaming into
    ``fleet``.  Each job's ``fault_hook`` starts a co-runner process on the
    card before step ``FAILSLOW_ON`` and pauses it before step
    ``FAILSLOW_OFF``.  Each job must have a fail_slow (throughput) at a
    step in between and none before, and the fleet tier must name both
    jobs' shared hardware."""
    import multiprocessing as mp
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.anomaly import Team
    from repro_torch.core.report import anomaly_report
    from repro_torch.runtime.train import RunConfig, Trainer

    arch = "llama3.2-1b"
    kernels = train_kernels(arch)
    ctx = mp.get_context("spawn")
    conn, child_end = ctx.Pipe()
    proc = ctx.Process(target=corunner, args=(child_end, CORUNNER_N),
                       name="flare-corunner", daemon=True)
    t0 = time.perf_counter()
    proc.start()
    child_end.close()
    out, products_run = {}, None
    try:
        if not conn.poll(CORUNNER_START_S):
            fail(f"fleet: the co-runner was not ready in {CORUNNER_START_S}"
                 " s")
        try:
            conn.recv()
        except EOFError:
            proc.join(HANDSHAKE_S)
            fail(f"fleet: the co-runner exited ({proc.exitcode}) before it "
                 "was ready")
        log("fleet", f"co-runner (spawned, pid {proc.pid}, bf16 "
            f"{CORUNNER_N}^3 torch.matmul) ready in "
            f"{time.perf_counter() - t0:.1f} s")
        for job in FAILSLOW_JOBS:
            fleet.mux.set_topology(job, **FAILSLOW_RACK)
            products: dict = {}

            def hook(step, products=products):
                if step == FAILSLOW_ON:
                    products["at start"] = handshake(conn, "start")
                elif step == FAILSLOW_OFF:
                    products["at pause"] = handshake(conn, "pause")

            run = RunConfig(model=get_config(arch), global_batch=TRAIN_B,
                            seq_len=CASE3_S, steps=FAILSLOW_STEPS,
                            warmup_steps=2, seed=seed, mask_mode="fast",
                            data_prefetch=True, flare_log=fleet.spill(job))
            trainer = Trainer(run, fault_hook=hook)
            events: list = []
            trainer.daemon.add_sink(events.extend)
            backend = trainer.daemon.cfg.backend
            fleet.attach(job, trainer.daemon, backend=backend)
            for k, _, _ in kernels.values():
                k.launches = 0
            hist = trainer.train()
            launches = {label: k.launches
                        for label, (k, _, _) in kernels.items()}
            del trainer
            torch.cuda.empty_cache()
            res = engine_job(f"fleet {job}", events, fleet.history,
                             backend=backend)
            fleet.done(job, res["anomalies"], events)
            ms = res["metrics"]
            thr = [ms[s].throughput for s in sorted(ms)]
            found = res["anomalies"]
            slow = [a for a in found if a.kind == "fail_slow"]
            hit = [a for a in slow if a.metric == "throughput"
                   and FAILSLOW_ON <= a.step < FAILSLOW_OFF]
            early = [a for a in slow if a.step < FAILSLOW_ON]
            log("fleet", f"{job}: tokens/s by step "
                f"{[round(x, 1) for x in thr]}; co-runner before steps "
                f"{FAILSLOW_ON}-{FAILSLOW_OFF - 1} ({products}); fail_slow "
                f"at steps {[a.step for a in slow]}")
            for line in anomaly_report(found).splitlines():
                log("fleet", f"  {line}")
            if not hit:
                fail(f"fleet: {job}: no fail_slow (throughput) at a step in "
                     f"{FAILSLOW_ON}-{FAILSLOW_OFF - 1}: "
                     f"{[(a.kind, a.metric, a.step) for a in found]}")
            if early:
                fail(f"fleet: {job}: fail_slow before step {FAILSLOW_ON}: "
                     f"{[(a.metric, a.step) for a in early]}")
            out[job] = dict(
                throughput=thr, step_s=[r["step_time_s"] for r in hist],
                loss=[r["loss"] for r in hist], launches=launches,
                anomalies=anomaly_rows(found), engine_s=res["engine_s"],
                fail_slow_steps=[a.step for a in slow],
                drop=[a.evidence.get("drop_frac") for a in hit],
                corunner_products=products)
    finally:
        try:
            conn.send("stop")
            if conn.poll(HANDSHAKE_S):
                products_run = conn.recv()[1]
        except (BrokenPipeError, EOFError):
            pass                # it ended already: joined below
        proc.join(HANDSHAKE_S)
        if proc.is_alive():
            proc.terminate()
            proc.join(HANDSHAKE_S)
        conn.close()
    cross = [fa for fa in fleet.stream if fa.origin == "fleet"]
    for job in FAILSLOW_JOBS:
        hits = [fa.anomaly for fa in cross if fa.job_id == job
                and fa.anomaly.kind == "fail_slow"
                and fa.anomaly.metric == "cross_job_correlation"
                and fa.anomaly.team is Team.INFRASTRUCTURE]
        if not hits or any(a.evidence["jobs"] != sorted(FAILSLOW_JOBS)
                           for a in hits):
            fail(f"fleet: {job}: no cross_job_correlation naming "
                 f"{list(FAILSLOW_JOBS)} from the fleet tier: "
                 f"{[(fa.job_id, str(fa.anomaly)) for fa in cross]}")
    for fa in cross:
        log("fleet", f"fleet tier: {fa}")
    return dict(jobs=out, cross_job=fleet_replay_tool().stream_rows(cross),
                corunner_products=products_run)


def check_live_jobs(fleet: FleetLive) -> dict:
    """Each live job's stream (its own engine's anomalies, in push order)
    against its batch ``engine_job`` result, byte for byte; no late rows
    and no forced closes.  A [fleet] line a job."""
    from repro_torch.core.report import anomalies_json
    out = {}
    for job, j in fleet.jobs.items():
        fj = fleet.mux.job(job)
        mine = sorted((fa for fa in fleet.stream if fa.job_id == job),
                      key=lambda fa: fa.seq)
        own = [fa.anomaly for fa in mine if fa.origin == "job"]
        if anomalies_json(own) != j["batch"]:
            fail(f"fleet: {job}: the live stream's anomalies "
                 f"{[str(a) for a in own]} are not the batch engine's "
                 f"{j['batch']}")
        late = fj.late_events
        forced = fleet.mux.telemetry.value("fleet.forced_closes", job=job)
        if late or forced:
            fail(f"fleet: {job}: {late} late rows, {forced} forced closes")
        bracket = j["daemon"].telemetry.value("daemon.anchor_bracket_max_s")
        host = fleet.mux.host_s.get(job, 0.0)
        log("fleet", f"{job}: {fj.store.events_total} events "
            f"({j['events']} in its sink), {len(fj.evaluated)} steps closed, "
            f"{len(own)} anomalies ({len(mine) - len(own)} more from the "
            f"fleet tier), late rows {late}, fleet host {host * 1e3:.1f} ms "
            f"(ingest, diagnosis, leave), widest anchor bracket "
            f"{bracket * 1e3:.3f} ms")
        out[job] = dict(events=fj.store.events_total, steps=len(fj.evaluated),
                        anomalies=len(own), fleet_anomalies=len(mine) - len(own),
                        late_rows=late, forced_closes=forced, host_s=host,
                        bracket_s=bracket)
    return out


def fleet_replays(fleet: FleetLive, live: str) -> dict:
    """The spill directory replayed serially, on 4 threads and on 2 worker
    processes (``tools/fleet_replay.py`` in an interpreter of its own:
    forking this one, with its CUDA context and threads, is not safe),
    each with the phase's profiles saved as JSON and each job added with
    its live engine config first; each stream byte-equal to ``live``, the
    stats alike, no late rows, no forced closes."""
    import dataclasses
    import shutil
    from repro_torch.core.history import HistoryStore
    tool = fleet_replay_tool()
    shutil.rmtree(FLEET_HISTORY, ignore_errors=True)
    saved = HistoryStore(str(FLEET_HISTORY))
    for prof in fleet.history.snapshot_profiles().values():
        saved.put(prof)
    tool.write_spec(FLEET_SPEC, {j: v["cfg"] for j, v in fleet.jobs.items()},
                    dataclasses.replace(fleet.cfg,
                                        topology=dict(fleet.mux.topology)))
    out = {}
    for what, workers in (("serial", 1), ("threads", 4)):
        t0 = time.perf_counter()
        out[what] = tool.replay(FLEET_DIR, FLEET_HISTORY, FLEET_SPEC,
                                workers, "thread")
        out[what]["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "fleet_replay.py"),
         str(FLEET_DIR), "--history", str(FLEET_HISTORY), "--spec",
         str(FLEET_SPEC), "--job-workers", "2", "--worker-kind", "process"],
        capture_output=True, text=True, timeout=600)
    if child.returncode:
        fail(f"fleet: the process replay exited {child.returncode}: "
             f"{child.stderr[-2000:]}")
    out["processes"] = json.loads(child.stdout.splitlines()[-1])
    out["processes"]["wall_s"] = time.perf_counter() - t0
    if out["processes"]["torch_imported"]:
        fail("fleet: the process replay's interpreter imported torch")
    n = len(fleet.jobs)         # a replay runs at most a worker a job
    want = {"serial": ("serial", 1), "threads": ("thread", min(4, n)),
            "processes": ("process", min(2, n))}
    for what, res in out.items():
        got = json.dumps(res["stream"])
        if got != live:
            fail(f"fleet: the {what} replay's stream is not the live one:\n"
                 f"{got[:2000]}\nlive:\n{live[:2000]}")
        if res["stats"] != out["serial"]["stats"]:
            fail(f"fleet: the {what} replay's stats {res['stats']} are not "
                 f"the serial one's {out['serial']['stats']}")
        if (res["worker_kind"], res["job_workers"]) != want[what]:
            fail(f"fleet: the {what} replay ran {res['job_workers']} "
                 f"{res['worker_kind']} workers")
        bad = {j: n for j, n in res["late_rows"].items() if n}
        bad.update({j: n for j, n in res["forced_closes"].items() if n})
        if bad:
            fail(f"fleet: the {what} replay's late rows or forced closes "
                 f"{bad}")
        log("fleet", f"replay, {what} ({res['job_workers']} "
            f"{res['worker_kind']}): {res['stats']['files']} files, "
            f"{res['stats']['events']} events, {len(res['stream'])} "
            f"anomalies byte-equal to the live stream, no late row; "
            f"{res['wall_s']:.2f} s")
    return {what: dict(stats=res["stats"], wall_s=res["wall_s"],
                       replay_s=res["seconds"])
            for what, res in out.items()}


def fleet_archive(fleet: FleetLive, live_rows: list) -> dict:
    """The trace archive over the spill directory, one archive a group of
    jobs with one engine config (``ARCHIVE_GROUPS``): ``query_anomalies``
    per job equal to the live stream, ``query_metrics`` throughput equal to
    the live engines' ``StepMetrics``, rollup sidecars written, and a
    second archive answering from them without decoding a trace; the
    fleet weather printed."""
    from repro_torch.archive import TraceArchive, format_fleet_weather
    from repro_torch.core.history import HistoryStore
    from repro_torch.fleet import FleetConfig
    from repro_torch.store import ROLLUP_SUFFIX
    tool = fleet_replay_tool()
    out = {}
    for prefix in ARCHIVE_GROUPS:
        jobs = sorted(j for j in fleet.jobs if j.startswith(prefix))
        cfgs = {repr(fleet.jobs[j]["cfg"]) for j in jobs}
        if len(cfgs) != 1:
            fail(f"fleet: archive group {prefix}* has engine configs {cfgs}")
        kw = dict(history=HistoryStore(str(FLEET_HISTORY)),
                  engine_config=fleet.jobs[jobs[0]]["cfg"],
                  fleet_config=FleetConfig(
                      watermark_delay=1, fleet_detectors=FLEET_DETECTORS,
                      topology=dict(fleet.mux.topology)),
                  pattern=f"{prefix}*.fcs")
        ar = TraceArchive(str(FLEET_DIR), **kw)
        if ar.jobs != jobs:
            fail(f"fleet: archive {prefix}* holds {ar.jobs}, not {jobs}")
        series = {}
        for job in jobs:
            got = json.dumps(tool.stream_rows(ar.query_anomalies(job=job)))
            want = json.dumps([r for r in live_rows if r["job"] == job])
            if got != want:
                fail(f"fleet: the archive's anomalies of {job} are not the "
                     f"live stream's:\n{got[:2000]}\nlive:\n{want[:2000]}")
            series[job] = ar.query_metrics(job, metric="throughput")
            engine = fleet.mux.job(job).engine.metrics
            want_series = [(s, engine[s].throughput) for s in sorted(engine)]
            if series[job] != want_series:
                fail(f"fleet: the archive's throughput of {job} "
                     f"{series[job]} is not its engine's {want_series}")
        sidecars = sorted(FLEET_DIR.glob(f"{prefix}*{ROLLUP_SUFFIX}"))
        if len(sidecars) < len(jobs):
            fail(f"fleet: archive {prefix}*: rollup sidecars {sidecars}")
        again = TraceArchive(str(FLEET_DIR), **kw)
        for job in jobs:
            if again.query_metrics(job, metric="throughput") != series[job]:
                fail(f"fleet: a second archive's throughput of {job} differs")
        hits = again.telemetry.value("archive.rollup_disk_hits")
        builds = again.telemetry.value("archive.rollup_builds")
        if not hits or builds:
            fail(f"fleet: the second archive {prefix}*: {hits} sidecar hits, "
                 f"{builds} rollups built")
        weather = ar.fleet_weather()
        log("fleet", f"archive {prefix}*: {len(jobs)} jobs, anomalies and "
            f"throughput equal to the live fleet's; {len(sidecars)} rollup "
            f"sidecars, read back by a second archive ({int(hits)} hits, "
            f"none built); its fleet weather:")
        for line in format_fleet_weather(weather).splitlines():
            log("fleet", f"  {line}")
        out[prefix] = dict(jobs=jobs, sidecars=len(sidecars),
                           disk_hits=hits, weather=weather)
    return out


def fleet_hang(trace_dir: Path) -> list:
    """Each ring hang drill through the fleet: the drill's step of each
    rank's spill as a file, replayed (``replay_file``) as one job of
    ``RING_WORLD`` ranks; the multiplexer declares the hang once a
    majority of ranks reported, one hang anomaly routed to operations,
    equal to a batch engine's ``on_hang`` on the same stacks (no ring
    progress: the fleet sees the spills only)."""
    import shutil
    import numpy as np
    from repro_torch import store
    from repro_torch.core.anomaly import Team
    from repro_torch.core.engine import DiagnosticEngine, EngineConfig
    from repro_torch.core.report import anomalies_json
    from repro_torch.fleet import (DEFAULT_ROUTES, FleetConfig,
                                   FleetMultiplexer, FleetReplayer)
    from repro_torch.launch.mesh import HANG_FAULTS

    n = RING_WORLD
    spills = [store.read_trace(str(trace_dir / f"rank{r}.jsonl"))
              for r in range(n)]
    shutil.rmtree(FLEET_HANG_DIR, ignore_errors=True)
    out = []
    for i, fault in enumerate(HANG_FAULTS):
        job = f"ring-hang-{fault}"
        paths = []
        for r, batch in enumerate(spills):
            path = FLEET_HANG_DIR / job / f"rank{r}.fcs"
            path.parent.mkdir(parents=True, exist_ok=True)
            store.write_trace(batch.take(np.flatnonzero(batch.step == 1 + i)),
                              str(path))
            paths.append(path)
        cfg = EngineConfig(backend="ring", num_ranks=n)
        t0 = time.perf_counter()
        mux = FleetMultiplexer(FleetConfig(watermark_delay=1))
        mux.add_job(job, cfg)
        replayer = FleetReplayer(mux)
        stacks, after = None, None
        for r, path in enumerate(paths):
            replayer.replay_file(job, str(path))
            if stacks is None and mux.job(job).hang_reported:
                stacks, after = dict(mux.job(job).store.hang_stacks), r
        found = mux.finalize()
        secs = time.perf_counter() - t0
        if stacks is None:
            fail(f"fleet: {job}: no hang declared from {n} ranks' spills")
        hangs = [fa for fa in found if fa.anomaly.kind == "hang"]
        want = anomalies_json(DiagnosticEngine(cfg).on_hang(stacks, None))
        if (len(hangs) != 1
                or hangs[0].route != DEFAULT_ROUTES[Team.OPERATIONS]
                or anomalies_json([hangs[0].anomaly]) != want):
            fail(f"fleet: {job}: {[str(fa) for fa in found]}, not one hang "
                 f"to operations equal to on_hang's {want}")
        log("fleet", f"{job}: hang declared after rank {after}'s spill "
            f"({len(stacks)} of {n} ranks reported), one anomaly: "
            f"{hangs[0]}; equal to on_hang on the same stacks; "
            f"{secs * 1e3:.1f} ms")
        out.append(dict(job=job, after_rank=after, ranks=sorted(stacks),
                        anomaly=json.loads(want), host_s=secs,
                        anomalies=len(found)))
    return out


def fleet_phase(seed: int, fleet: FleetLive, trace_dir: Path,
                diagnosis: dict) -> dict:
    """The fail-slow drill into the live fleet, then the fleet closed and
    its stream held to each job's batch result, to three replays, to the
    trace archive; the ring's hangs through the fleet; the phase's wall."""
    t0 = time.perf_counter()
    failslow = failslow_drill(seed, fleet)
    fleet.stream.extend(fleet.mux.close())   # stops each daemon again
    jobs = check_live_jobs(fleet)
    for what, key in (("case2-drilled", ("regression", "flops",
                                         "infrastructure")),
                      ("case3-drilled", ("regression", "v_inter",
                                         "algorithm"))):
        expect(f"fleet {what}", [fa.anomaly for fa in fleet.stream
                                 if fa.job_id == what], *key)
    rows = fleet.rows()
    replays = fleet_replays(fleet, json.dumps(rows))
    archive = fleet_archive(fleet, rows)
    hang = fleet_hang(trace_dir)
    healthy = {f"{case} {job}": run["bracket_s"]
               for case in ("case2", "case3")
               for job, run in diagnosis[case]["jobs"].items()
               if not run["fleet_job"]}
    log("fleet", "widest anchor bracket, ms: fleet jobs "
        f"{ {j: round(v['bracket_s'] * 1e3, 3) for j, v in jobs.items()} }, "
        "the diagnose phase's jobs outside the fleet "
        f"{ {j: round(v * 1e3, 3) for j, v in healthy.items()} }")
    wall = time.perf_counter() - t0
    log("fleet", f"phase wall {wall:.1f} s")
    return dict(failslow=failslow, jobs=jobs, stream=rows, replays=replays,
                archive=archive, hang=hang, brackets_outside_s=healthy,
                wall_s=wall)


# --------------------------------------------------------------------------- #
# phase 4d: service — the port's resident fleet service, fed by live daemons
# --------------------------------------------------------------------------- #
SERVICE_DIR = OUT_DIR / "service"
SERVICE_HISTORY = SERVICE_DIR / "history"  # the diagnose phase's profiles
SERVICE_TOPOLOGY = {"rack": "r-svc", "switch": "s-svc"}
SERVICE_ENGINE = dict(backend="dense-train", num_ranks=1)  # Case 3's daemons'
SVC_B_STEPS = 16
SVC_KILL_R, SVC_START_R2, SVC_KILL_T = 3, 5, 8   # svc-b's hook, before steps
SERVICE_START_S = 120.0   # a service process's start: interpreter, numpy
SERVICE_WAIT_S = 60.0     # the longest wait for a reply or a condition
SERVICE_POLL_S = 0.02


def service_proc(commands, events, spec: dict):
    """A ``FleetService`` in a process of its own, spawned from
    ``chip_smoke.py``: a fresh interpreter that imports the port's service
    plane and never torch, so that its process workers fork from a process
    with no CUDA context.  ``spec``: the ``ServiceConfig`` fields
    (``config``), the profiles' directory (``history``), whether to wait for
    a "start" (with more fields) before building the service (``wait``), and
    whether to ``restore()`` before ``start()`` (``restore``).

    Sends on ``events``: ("spawned", info); ("ready", info) once started
    (its ports, the restore's result and seconds); ("anomaly", fa) for each
    anomaly as it is delivered; and an answer to each command from
    ``commands``: "state" (tail stats, jobs, topology, counters), "settle"
    (a ``collect()``, then the count delivered), "checkpoint" (its meta),
    "finalize" (the final stats and counters, and the host CPU seconds
    of the service from its construction on, its reaped workers'
    included), after which it exits."""
    import os
    import signal
    import threading

    sys.path.insert(0, spec["src"])
    # SIGTERM (the phase's cleanup) exits through the interpreter, which
    # terminates the daemonic fleet workers
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.history import HistoryStore
    from repro_torch.fleet import FleetConfig, FleetMultiplexer
    from repro_torch.serve import FleetService, ServiceConfig

    lock = threading.Lock()

    def send(kind, body):
        with lock:
            events.send((kind, body))

    def tail_stats(svc):
        t = svc.tailer
        return None if t is None else dict(
            events=t.stats.events, bytes_decoded=t.stats.bytes_decoded,
            files=t.stats.files, corrupt_files=t.stats.corrupt_files,
            per_job=dict(t.stats.per_job))

    def counters(svc):
        return dict(svc.telemetry.snapshot().get("counters", {}))

    send("spawned", dict(pid=os.getpid(), torch="torch" in sys.modules))
    config = dict(spec["config"])
    if spec.get("wait"):
        cmd, more = commands.recv()
        assert cmd == "start", cmd
        config.update(more)
    t0, cpu0 = time.perf_counter(), os.times()
    svc = FleetService(
        FleetMultiplexer(FleetConfig(watermark_delay=1,
                                     fleet_detectors=FLEET_DETECTORS),
                         history=HistoryStore(spec["history"])),
        ServiceConfig(default_engine=EngineConfig(**SERVICE_ENGINE),
                      **config),
        on_anomaly=lambda fa, t: send("anomaly", fa))
    restored = svc.restore() if spec.get("restore") else None
    load_s = time.perf_counter() - t0
    svc.start()
    send("ready", dict(port=svc.port, query_port=svc.query_port,
                       restored=restored, load_s=load_s,
                       torch="torch" in sys.modules))
    while True:
        cmd, *_ = commands.recv()
        if cmd == "state":
            send("state", dict(tail=tail_stats(svc), jobs=svc.job_stats(),
                               topology=dict(svc.mux.topology),
                               per_job=dict(svc.stats.per_job),
                               counters=counters(svc)))
        elif cmd == "settle":
            svc.collect()
            send("settle", len(svc.snapshot_recent()))
        elif cmd == "checkpoint":
            send("checkpoint", svc.checkpoint())
        elif cmd == "finalize":
            svc.finalize()
            cpu = os.times()
            send("finalize", dict(
                tail=tail_stats(svc), per_job=dict(svc.stats.per_job),
                counters=counters(svc), errors=svc.errors,
                cpu_s=cpu.user + cpu.system - cpu0.user - cpu0.system
                + cpu.children_user + cpu.children_system,
                torch="torch" in sys.modules))
            return


class ServiceProc:
    """The chip_smoke side of a ``service_proc``: the spawned process, a
    command pipe, and a reader thread that keeps every anomaly as it is
    delivered and queues the replies."""

    def __init__(self, ctx, name: str, spec: dict):
        import queue
        import threading
        self.name, self.anomalies = name, []
        self.replies: queue.Queue = queue.Queue()
        cmd_r, self.commands = ctx.Pipe(duplex=False)
        self.events, ev_w = ctx.Pipe(duplex=False)
        self.t0, self.waiting = time.perf_counter(), spec.get("wait", False)
        self.proc = ctx.Process(
            target=service_proc, args=(cmd_r, ev_w, dict(
                spec, src=str(ROOT / "src"),
                history=str(spec.get("history", SERVICE_HISTORY)))),
            # not daemonic: a process-mode service has worker children;
            # ``close`` ends it
            name=f"flare-service-{name}", daemon=False)
        self.proc.start()
        cmd_r.close()
        ev_w.close()
        self.reader = threading.Thread(target=self._read, daemon=True,
                                       name=f"flare-service-{name}-reader")
        self.reader.start()
        self.info: dict = {}

    def _read(self):
        while True:
            try:
                kind, body = self.events.recv()
            except (EOFError, OSError):
                self.replies.put(("exited", None))
                return
            if kind == "anomaly":
                self.anomalies.append(body)
            else:
                self.replies.put((kind, body))

    def reply(self, want: str, timeout: float = SERVICE_WAIT_S):
        import queue
        try:
            kind, body = self.replies.get(timeout=timeout)
        except queue.Empty:
            fail(f"service: {self.name} sent no {want!r} in {timeout} s")
        if kind != want:
            fail(f"service: {self.name} sent {kind!r} ({body}), not {want!r}"
                 f" (exit code {self.proc.exitcode})")
        if isinstance(body, dict) and body.get("torch"):
            fail(f"service: {self.name}'s process imported torch")
        return body

    def call(self, cmd: str, *args):
        self.commands.send((cmd, *args))
        return self.reply(cmd)

    def ready(self, **more) -> dict:
        """Waits for the process to start its service ("start" with
        ``more`` first where it waits for one); returns its ready info."""
        if self.waiting:
            self.commands.send(("start", more))
        self.info.update(self.reply("ready", SERVICE_START_S))
        return self.info

    def spawned(self) -> dict:
        self.info.update(self.reply("spawned", SERVICE_START_S),
                         spawned_s=time.perf_counter() - self.t0)
        return self.info

    def until(self, what: str, pred) -> dict:
        """Polls "state" until ``pred(state)`` holds, under a deadline."""
        deadline = time.perf_counter() + SERVICE_WAIT_S
        while True:
            state = self.call("state")
            if pred(state):
                return state
            if time.perf_counter() > deadline:
                fail(f"service: {self.name}: {what} not reached in "
                     f"{SERVICE_WAIT_S} s: {state}")
            time.sleep(SERVICE_POLL_S)

    def kill(self):
        self.proc.kill()
        self.proc.join(SERVICE_WAIT_S)
        self.reader.join(SERVICE_WAIT_S)

    def close(self):
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(SERVICE_WAIT_S)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(SERVICE_WAIT_S)
        self.commands.close()


class LiveSinkTap:
    """Wraps a daemon's live sink (test code: the package is unchanged):
    for each call the daemon's step, the batch's events, whether it went
    out, and the sink's reconnects after the call."""

    def __init__(self, daemon):
        self.daemon, self.sink, self.calls = daemon, daemon._live, []
        i = daemon._batch_sinks.index(self.sink)
        daemon._batch_sinks[i] = self

    def __call__(self, batch):
        ok = self.sink(batch)
        self.calls.append((self.daemon._step, len(batch), ok,
                           self.sink._reconnects.value))
        return ok

    def sent_after_reconnect(self) -> list:
        return [c for c in self.calls if c[2] and c[3] >= 1]


def service_trainer(seed: int, job: str, endpoint: str, steps: int,
                    mask: str, prefetch: bool, hook=None,
                    topology: dict = SERVICE_TOPOLOGY,
                    spill_dir: Path | None = None):
    """llama3.2-1b at full width through ``Trainer``, B 8 x S ``CASE3_S``,
    spilling FCS into ``spill_dir`` (a directory of its own by default),
    its daemon replaced before ``train()`` by one with the same config, a
    live endpoint and ``topology``."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.daemon import TracingDaemon
    from repro_torch.runtime.train import RunConfig, Trainer
    spill = (spill_dir or SERVICE_DIR / job) / f"{job}.fcs"
    spill.parent.mkdir(parents=True, exist_ok=True)
    run = RunConfig(model=get_config("llama3.2-1b"), global_batch=TRAIN_B,
                    seq_len=CASE3_S, steps=steps, warmup_steps=2, seed=seed,
                    mask_mode=mask, data_prefetch=prefetch,
                    flare_log=str(spill))
    trainer = Trainer(run, fault_hook=hook)
    trainer.daemon = TracingDaemon(dataclasses.replace(
        trainer.daemon.cfg, live_endpoint=endpoint, live_job_id=job,
        live_topology=topology))
    return trainer, spill


def service_oracle(spill_dir: Path, job: str, topology: dict) -> list:
    """The job's spill replayed serially into a fresh multiplexer with the
    service's configuration and profiles, finalized: its stream rows."""
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.history import HistoryStore
    from repro_torch.fleet import FleetConfig, FleetMultiplexer, FleetReplayer
    mux = FleetMultiplexer(FleetConfig(watermark_delay=1,
                                       fleet_detectors=FLEET_DETECTORS,
                                       topology=topology),
                           history=HistoryStore(str(SERVICE_HISTORY)))
    mux.add_job(job, EngineConfig(**SERVICE_ENGINE))
    FleetReplayer(mux).replay_dir(str(spill_dir), job_workers=1)
    return service_rows(mux.finalize())


def service_rows(fas) -> list:
    return fleet_replay_tool().stream_rows(
        sorted(fas, key=lambda a: (a.ts, a.job_id, a.seq)))


def spill_facts(spill: Path) -> dict:
    """Segments, events, bytes, step spans and hang_suspects of a spill."""
    from repro_torch import store
    from repro_torch.core.events import EventKind
    from repro_torch.store.fcs import segment_stats
    events = store.read_trace(str(spill)).to_events()
    return dict(segments=len(list(segment_stats(str(spill)))),
                events=len(events), bytes=spill.stat().st_size,
                steps=sorted(e.step for e in events
                             if e.kind == EventKind.STEP),
                hang_suspects=sum(e.kind == EventKind.HANG_SUSPECT
                                  for e in events))


def same_rows(what: str, got: list, want: list):
    if json.dumps(got) != json.dumps(want):
        fail(f"service: {what}:\n{json.dumps(got)[:2000]}\nthe replay:\n"
             f"{json.dumps(want)[:2000]}")


def query(port: int, path: str):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=SERVICE_WAIT_S) as r:
        return json.load(r)


def service_phase(seed: int, fleet: FleetLive) -> dict:
    """The port's resident fleet service (``repro_torch.serve``), each
    service in a spawned process of its own, fed by the daemons of two
    traced llama3.2-1b jobs (B 8 x S ``CASE3_S``) through their live socket
    sinks, with the profiles the ``diagnose`` phase's healthy jobs learned:

    * svc-a, Case 3's drilled setting, ``DRILL_STEPS`` steps, into service
      L (socket plane, 2 process workers, the query plane): L's stream
      equal to the replay of the job's spill, row for row, with the
      drill's (regression, v_inter, algorithm); one frame a spill segment,
      no drop; ``/jobs`` and ``/anomalies`` agreeing;
    * svc-b, Case 3's healthy setting, ``SVC_B_STEPS`` steps, into service
      R (socket plane, inline), SIGKILLed before step ``SVC_KILL_R``;
      service R', spawned ahead and waiting, binds R's port before step
      ``SVC_START_R2``: drops and a reconnect counted, frames + drops =
      the spill's segments, R' re-HELLO'd and holding exactly the events
      sent after the reconnect, the spill whole and free of hang_suspects;
    * svc-b's spill tailed by service T (inline, checkpoints), which
      before step ``SVC_KILL_T`` checkpoints and is SIGKILLed; after the
      job, a garbage and a torn generation planted above the good one, and
      T', spawned ahead, restores past them and finishes the tail: every
      spill byte decoded once, the restored suffix strictly partial, and
      T's rows up to the checkpoint with T''s equal to the replay."""
    import multiprocessing as mp
    import shutil
    import torch
    from repro_torch.core.history import HistoryStore
    from repro_torch.core.report import _json_coerce
    from repro_torch.serve import fleet_anomaly_dict

    t_phase = time.perf_counter()
    shutil.rmtree(SERVICE_DIR, ignore_errors=True)
    SERVICE_DIR.mkdir(parents=True)
    saved = HistoryStore(str(SERVICE_HISTORY))
    for prof in fleet.history.snapshot_profiles().values():
        saved.put(prof)
    tail_dir, ckpt_dir = SERVICE_DIR / "svc-b", SERVICE_DIR / "ckpt-t"
    tail_dir.mkdir()
    kernels = train_kernels("llama3.2-1b")
    ctx = mp.get_context("spawn")
    t_cfg = dict(port=None, tail_dir=str(tail_dir), checkpoint_dir=str(
        ckpt_dir), checkpoint_on_finalize=False)
    procs = {
        "L": ServiceProc(ctx, "L", dict(config=dict(
            port=0, query_port=0, worker_kind="process", workers=2))),
        "R": ServiceProc(ctx, "R", dict(config=dict(port=0))),
        "R'": ServiceProc(ctx, "R'", dict(config={}, wait=True)),
        "T": ServiceProc(ctx, "T", dict(config=t_cfg)),
        "T'": ServiceProc(ctx, "T'", dict(config=t_cfg, wait=True,
                                          restore=True)),
    }
    out: dict = {}
    try:
        for p in procs.values():
            p.spawned()
        for name in ("L", "R", "T"):
            procs[name].ready()
        L, R, R2, T, T2 = (procs[k] for k in ("L", "R", "R'", "T", "T'"))
        log("service", "spawned L, R, R', T, T' (ready in "
            + ", ".join(f"{n} {p.info['spawned_s']:.1f} s"
                        for n, p in procs.items())
            + "); no service process imported torch")

        # svc-a into L
        t0 = time.perf_counter()
        trainer, spill_a = service_trainer(
            seed, "svc-a", f"127.0.0.1:{L.info['port']}", DRILL_STEPS,
            "naive", False)
        for k, _, _ in kernels.values():
            k.launches = 0
        trainer.train()
        launches_a = {lb: k.launches for lb, (k, _, _) in kernels.items()}
        da = trainer.daemon
        del trainer
        torch.cuda.empty_cache()
        job_s_a = time.perf_counter() - t0
        qport = L.info["query_port"]
        deadline = time.perf_counter() + SERVICE_WAIT_S
        while not query(qport, "/jobs")["jobs"].get("svc-a", {}).get(
                "departed"):
            if time.perf_counter() > deadline:
                fail("service: L: svc-a did not depart (BYE) in "
                     f"{SERVICE_WAIT_S} s")
            time.sleep(SERVICE_POLL_S)
        L.call("settle")
        jobs = query(qport, "/jobs")["jobs"]
        recent = query(qport, "/anomalies")["anomalies"]
        delivered = json.loads(json.dumps(
            [fleet_anomaly_dict(fa) for fa in L.anomalies],
            default=_json_coerce))
        fin_l = L.call("finalize")
        facts_a = spill_facts(spill_a)
        rows_l = service_rows(L.anomalies)
        same_rows("L's stream of svc-a", rows_l, service_oracle(
            spill_a.parent, "svc-a", {"svc-a": SERVICE_TOPOLOGY}))
        hit = expect("service L svc-a", [fa.anomaly for fa in L.anomalies],
                     "regression", "v_inter", "algorithm")
        live_a = {k: int(da.telemetry.value(f"daemon.live_{k}"))
                  for k in ("frames", "dropped", "reconnects", "bytes")}
        if (live_a["frames"] != facts_a["segments"] or live_a["dropped"]
                or live_a["reconnects"]):
            fail(f"service: svc-a's live sink {live_a}, its spill "
                 f"{facts_a['segments']} segments")
        if fin_l["counters"].get("serve.dropped_frames", 0):
            fail(f"service: L dropped frames: {fin_l['counters']}")
        if jobs["svc-a"]["events"] != facts_a["events"]:
            fail(f"service: L's /jobs gives svc-a {jobs['svc-a']['events']} "
                 f"events, its spill {facts_a['events']}")
        if sorted(recent, key=json.dumps) != sorted(delivered,
                                                    key=json.dumps):
            fail(f"service: L's /anomalies {recent[:3]} is not its stream "
                 f"{delivered[:3]}")
        if fin_l["errors"]:
            fail(f"service: L's workers failed: {fin_l['errors']}")
        bracket_a = da.telemetry.value("daemon.anchor_bracket_max_s")
        log("service", f"svc-a (Case 3 drilled, {DRILL_STEPS} steps, "
            f"{job_s_a:.1f} s) into L (2 process workers): "
            f"{len(rows_l)} anomalies equal to the replay of its spill, "
            f"({hit.kind}, {hit.metric}, {hit.team.value}) from step "
            f"{hit.step}; {live_a['frames']} frames = {facts_a['segments']} "
            f"spill segments, 0 dropped, 0 reconnects; /jobs "
            f"{jobs['svc-a']['events']} events = the spill's; /anomalies "
            f"{len(recent)} rows = the stream's; L's host CPU "
            f"{fin_l['cpu_s']:.2f} s (with its workers)")

        # svc-b into R, then R'; its spill tailed by T
        kill_at: dict = {}

        def hook(step):
            if step == SVC_KILL_R:
                R.kill()
                kill_at["R"], kill_at["calls"] = step, len(tap.calls)
            elif step == SVC_START_R2:
                R2.ready(port=R.info["port"])
                kill_at["R2"] = step
            elif step == SVC_KILL_T:
                T.until("a decoded segment",
                        lambda s: s["tail"]["bytes_decoded"] > 0)
                kill_at["checkpoint"] = T.call("checkpoint")
                T.kill()
                kill_at["T"] = step

        t0 = time.perf_counter()
        trainer, spill_b = service_trainer(
            seed, "svc-b", f"127.0.0.1:{R.info['port']}", SVC_B_STEPS, "fast",
            True, hook)
        tap = LiveSinkTap(trainer.daemon)
        for k, _, _ in kernels.values():
            k.launches = 0
        trainer.train()
        launches_b = {lb: k.launches for lb, (k, _, _) in kernels.items()}
        db = trainer.daemon
        del trainer
        torch.cuda.empty_cache()
        job_s_b = time.perf_counter() - t0
        facts_b = spill_facts(spill_b)
        if (facts_b["steps"] != list(range(SVC_B_STEPS))
                or facts_b["hang_suspects"]):
            fail(f"service: svc-b's spill holds steps {facts_b['steps']} and "
                 f"{facts_b['hang_suspects']} hang_suspects")
        live_b = {k: int(db.telemetry.value(f"daemon.live_{k}"))
                  for k in ("frames", "dropped", "reconnects", "bytes")}
        if live_b["dropped"] < 1 or live_b["reconnects"] < 1:
            fail(f"service: svc-b's live sink through R's death: {live_b}")
        if (live_b["frames"] + live_b["dropped"] != facts_b["segments"]
                or len(tap.calls) != facts_b["segments"]):
            fail(f"service: svc-b: {live_b} and {len(tap.calls)} sink calls "
                 f"for {facts_b['segments']} spill segments")
        st = R2.until("svc-b's BYE", lambda s: s["jobs"].get(
            "svc-b", {}).get("departed"))
        after = tap.sent_after_reconnect()
        if st["topology"].get("svc-b") != SERVICE_TOPOLOGY:
            fail(f"service: R' knows svc-b's topology as "
                 f"{st['topology']}, not {SERVICE_TOPOLOGY} (re-HELLO)")
        if st["per_job"] != {"svc-b": sum(c[1] for c in after)} or not after:
            fail(f"service: R' holds {st['per_job']} events, the sink sent "
                 f"{sum(c[1] for c in after)} after its reconnect")
        fin_r2 = R2.call("finalize")
        first_after = after[0][0]
        # went out after the kill, before the reconnect: into R's socket
        lost = [c for c in tap.calls[kill_at["calls"]:] if c[2] and not c[3]]
        log("service", f"svc-b (Case 3 healthy, {SVC_B_STEPS} steps, "
            f"{job_s_b:.1f} s) into R: R SIGKILLed before step "
            f"{kill_at['R']}, R' bound its port before step "
            f"{kill_at['R2']}, the sink's first frame to R' in step "
            f"{first_after} (R down for {kill_at['R2'] - kill_at['R']} "
            "steps); "
            f"{live_b['frames']} frames + {live_b['dropped']} dropped = "
            f"{facts_b['segments']} spill segments, {live_b['reconnects']} "
            f"reconnect(s); R' learned {st['topology']['svc-b']} from the "
            f"re-HELLO and holds {st['per_job']['svc-b']} events = the "
            f"{len(after)} batches sent after the reconnect ({len(lost)} "
            f"more went out into R's dead socket); the "
            f"spill holds steps 0-{SVC_B_STEPS - 1}, no hang_suspect; R' "
            f"host CPU {fin_r2['cpu_s']:.2f} s")

        # T' restores past two planted generations and finishes the tail
        meta = kill_at["checkpoint"]
        pre = T.anomalies[:meta["anomalies_emitted"]]
        if len(pre) != meta["anomalies_emitted"]:
            fail(f"service: T's checkpoint claims {meta['anomalies_emitted']}"
                 f" anomalies, {len(pre)} were delivered")
        good = Path(meta["path"]).read_bytes()
        planted = ["ckpt-99999990.flc", "ckpt-99999991.flc"]
        (ckpt_dir / planted[0]).write_bytes(
            b"\xde\xad\xbe\xef garbage, not a checkpoint " * 64)
        (ckpt_dir / planted[1]).write_bytes(good[:len(good) // 2])
        info = T2.ready()
        restored = info["restored"]
        if (restored is None or restored["generation"] != meta["generation"]
                or len(restored["skipped"]) != 2
                or not all(any(n in s for s in restored["skipped"])
                           for n in planted)):
            fail(f"service: T' restored {restored}, not generation "
                 f"{meta['generation']} past {planted}")
        T2.until("the spill's events", lambda s: s["tail"]["events"]
                 >= facts_b["events"])
        fin_t2 = T2.call("finalize")
        suffix = facts_b["bytes"] - meta["tail_bytes_decoded"]
        if fin_t2["tail"]["bytes_decoded"] != facts_b["bytes"]:
            fail(f"service: T and T' decoded {fin_t2['tail']} of the spill's "
                 f"{facts_b['bytes']} bytes")
        if not 0 < suffix < facts_b["bytes"]:
            fail(f"service: T' decoded a suffix of {suffix} of "
                 f"{facts_b['bytes']} bytes")
        rows_t = service_rows(pre + T2.anomalies)
        same_rows("T's rows to its checkpoint with T''s", rows_t,
                  service_oracle(tail_dir, "svc-b", {}))
        bracket_b = db.telemetry.value("daemon.anchor_bracket_max_s")
        log("service", f"T checkpointed generation {meta['generation']} "
            f"({meta['bytes']} B, {meta['anomalies_emitted']} anomalies, "
            f"{meta['tail_bytes_decoded']} spill bytes decoded) and was "
            f"SIGKILLed before step {kill_at['T']}; T' skipped both planted "
            f"generations, loaded generation {restored['generation']} in "
            f"{info['load_s'] * 1e3:.1f} ms, decoded the {suffix}-byte suffix "
            f"of {facts_b['bytes']}: every byte once; {len(rows_t)} stitched "
            f"rows equal to the replay; T' host CPU {fin_t2['cpu_s']:.2f} s")
        log("service", f"widest anchor bracket: svc-a "
            f"{bracket_a * 1e3:.3f} ms, svc-b {bracket_b * 1e3:.3f} ms")
        out = dict(
            svc_a=dict(job_s=job_s_a, spill=facts_a, live=live_a,
                       stream=rows_l, jobs=jobs["svc-a"],
                       anomalies_endpoint=len(recent), host_cpu_s=fin_l[
                           "cpu_s"], bracket_s=bracket_a, launches=launches_a,
                       finding=[hit.kind, hit.metric, hit.team.value,
                                hit.step]),
            svc_b=dict(job_s=job_s_b, spill={k: v for k, v in facts_b.items()
                                             if k != "steps"},
                       live=live_b, sink_calls=tap.calls, killed_before=dict(
                           R=kill_at["R"], T=kill_at["T"]),
                       r2_bound_before=kill_at["R2"],
                       sent_into_dead_socket=len(lost),
                       first_frame_to_r2_step=first_after,
                       r2_events=st["per_job"]["svc-b"],
                       r2_host_cpu_s=fin_r2["cpu_s"], bracket_s=bracket_b,
                       launches=launches_b),
            restore=dict(generation=restored["generation"],
                         skipped=len(restored["skipped"]),
                         load_s=info["load_s"], checkpoint_bytes=meta[
                             "bytes"], suffix_bytes=suffix,
                         spill_bytes=facts_b["bytes"], rows=len(rows_t),
                         t2_host_cpu_s=fin_t2["cpu_s"]),
            spawned_s={n: p.info["spawned_s"] for n, p in procs.items()},
            torch_in_services=False)
    finally:
        for p in procs.values():
            p.close()
    out["wall_s"] = time.perf_counter() - t_phase
    log("service", f"phase wall {out['wall_s']:.1f} s")
    return out


# --------------------------------------------------------------------------- #
# phase 4e: simulate — the port's cluster simulator at the H100's ceilings
# --------------------------------------------------------------------------- #
SIM_DIR = OUT_DIR / "simulate"
SIM_HISTORY = SIM_DIR / "history"  # svc-m's Case-3 profile, the 1024-rank one
SIM_SPILLS = SIM_DIR / "spills"    # one FCS spill a job of the service drill
# the scenario matrix's configs and floors, copied from the JAX package's
# benchmarks/scenarios.py (FULL_CONFIGS, assert_floors)
SCENARIO_CONFIGS = ("qwen2-0.5b", "llama3.2-1b", "mamba2-780m", "dbrx-132b")
SCENARIO_FLOORS = dict(precision=0.95, recall=1.0, scenarios=6,
                       fault_kinds=8)
SIM_RANKS = 1024
SIM_ENGINE = dict(backend="dense-train", num_ranks=SIM_RANKS)
# the service drill's simulated jobs (the cluster example's program, seed
# and steps): the injection's fields (None: healthy) and the placement
_JITTER = dict(kind="network_jitter", factor=3.0, start_step=3)
SIM_JOBS = {
    "sim-jitter-a": (_JITTER, {"rack": "rack0", "switch": "sw0"}),
    "sim-jitter-b": (_JITTER, {"rack": "rack0", "switch": "sw0"}),
    "sim-underclock": (dict(kind="underclock", ranks=(137,), factor=2.4,
                            start_step=3), {"rack": "rack1", "switch": "sw1"}),
    "sim-healthy": (None, {"rack": "rack1", "switch": "sw1"}),
}
SVC_M = "svc-m"                     # the traced llama3.2-1b job beside them
SVC_M_TOPOLOGY = {"rack": "rack2", "switch": "sw2"}


def cluster_example():
    """``examples/torch_diagnose_cluster_sim.py`` as a module: the
    program, profile, jobs and diagnosis the phase drives."""
    return repo_script("examples/torch_diagnose_cluster_sim.py")


def scenario_floor_violations(cells, scores, fault_kinds) -> list:
    """What of ``SCENARIO_FLOORS`` the graded cells break, a line each
    (none: the floors hold), as ``benchmarks/scenarios.py`` asserts
    them."""
    def ids(bad):
        return [f"{c.scenario}@{c.config}" for c in bad]
    faulty = [c for c in cells if not c.healthy]
    out = []
    if len({c.scenario for c in cells}) < SCENARIO_FLOORS["scenarios"]:
        out.append(f"matrix too small: {len(cells)} cells")
    if len([k for k in fault_kinds if k]) < SCENARIO_FLOORS["fault_kinds"]:
        out.append(f"fault taxonomy shrank: {fault_kinds}")
    for what, bad in (
            ("MISSED anomalies", [c for c in faulty if not c.caught]),
            ("wrong team routing",
             [c for c in faulty if c.caught and not c.team_ok]),
            ("culprit ranks not attributed",
             [c for c in faulty if c.caught and not c.ranks_ok]),
            ("fired before injection onset",
             [c for c in faulty if c.caught and not c.onset_ok]),
            ("healthy cells raised anomalies",
             [c for c in cells if c.healthy and c.anomalies])):
        if bad:
            out.append(f"{what}: {ids(bad)}")
    if scores["micro_precision"] < SCENARIO_FLOORS["precision"]:
        out.append(f"precision {scores['micro_precision']:.3f} < "
                   f"{SCENARIO_FLOORS['precision']} (false positives: "
                   f"{scores['false_positive_cells']})")
    if scores["micro_recall"] < SCENARIO_FLOORS["recall"]:
        out.append(f"recall {scores['micro_recall']:.3f} < "
                   f"{SCENARIO_FLOORS['recall']}")
    return out


def sim_matrix() -> dict:
    """The scenario matrix over ``SCENARIO_CONFIGS`` at
    ``DEFAULT_NUM_RANKS`` ranks, at ``program_from_config``'s defaults,
    held to ``SCENARIO_FLOORS``."""
    import dataclasses
    from repro_torch.core.timeline import program_from_config
    from repro_torch.scenarios import (DEFAULT_NUM_RANKS, FAULT_KINDS,
                                       SCENARIOS, run_matrix, score_matrix)

    ceilings = dict(program_from_config.__kwdefaults__)
    if (ceilings["chip_flops"], ceilings["link_bw"]) != (989e12, 5e10):
        fail(f"simulate: program_from_config's ceilings {ceilings} are not "
             "the H100's")
    per, cells = {}, []
    for config in SCENARIO_CONFIGS:
        t0 = time.perf_counter()
        got = run_matrix([config])
        secs = time.perf_counter() - t0
        s = score_matrix(got)
        cells += got
        per[config] = dict(cells=s["cells"],
                           caught=s["cells"] - len(s["missed"]),
                           micro_precision=s["micro_precision"],
                           micro_recall=s["micro_recall"], seconds=secs,
                           detectors=s["detectors"])
        log("simulate", f"matrix {config}: {s['cells']} cells at "
            f"{DEFAULT_NUM_RANKS} ranks, P {s['micro_precision']:.2f} R "
            f"{s['micro_recall']:.2f}, {secs:.2f} s")
    scores = score_matrix(cells)
    bad = scenario_floor_violations(cells, scores, FAULT_KINDS)
    if bad:
        fail("simulate: the scenario matrix breaks the floors of "
             "benchmarks/scenarios.py: " + "; ".join(bad))
    log("simulate", f"matrix: {scores['cells']} cells "
        f"({scores['faulty_cells']} faulty), {len(SCENARIOS)} scenarios, "
        f"{len(FAULT_KINDS)} fault kinds, P {scores['micro_precision']:.2f} "
        f"R {scores['micro_recall']:.2f}, nothing missed, misrouted or "
        f"noisy; chip_flops {ceilings['chip_flops']:.3g}, link_bw "
        f"{ceilings['link_bw']:.3g}, mfu {ceilings['mfu']}")
    return dict(configs=per, ceilings=ceilings,
                cells=[dataclasses.asdict(c) for c in cells],
                **{k: scores[k] for k in (
                    "detectors", "micro_precision", "micro_recall",
                    "faulty_cells", "missed", "misrouted",
                    "false_positive_cells")},
                scenarios=len(SCENARIOS), fault_kinds=list(FAULT_KINDS))


def sim_cluster(history) -> dict:
    """``examples/torch_diagnose_cluster_sim.py`` at ``SIM_RANKS`` ranks:
    the healthy profile learned into ``history``, then each job simulated
    and diagnosed, its report printed.  The underclocked rank, the
    misaligned FFN with its layout advice and the hung link are asserted;
    the GC-stall job is printed only (the reference misses it at this
    scale)."""
    from repro_torch.core.report import anomaly_report

    ex = cluster_example()
    N = SIM_RANKS
    prog = ex.program(N)
    t0 = time.perf_counter()
    prof = ex.learn_profile(prog, N, history)
    learn_s = time.perf_counter() - t0
    log("simulate", f"{ex.ARCH}, {ex.LAYER_GROUPS} layer groups, {N} ranks: "
        f"profile of {ex.PROFILE_RUNS} clean runs x {ex.PROFILE_STEPS} steps "
        f"in {learn_s:.2f} s (W1 threshold {prof.issue_w1_threshold:.4f}, "
        f"v_inter {prof.v_inter_threshold:.3f}, v_minority "
        f"{prof.v_minority_threshold:.3f})")
    jobs, found = {}, {}
    for name, inj in ex.jobs(N):
        t0 = time.perf_counter()
        sim, batch = ex.simulate_job(prog, N, inj)
        sim_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = [a for a in ex.diagnose_job(N, history, sim, batch)
               if a is not None]
        engine_s = time.perf_counter() - t0
        key = name.split(":")[0]
        found[key] = got
        log("simulate", f"{name}: {len(batch)} events simulated in "
            f"{sim_s:.3f} s ({len(batch) / sim_s:.0f} events/s), the engine "
            f"{engine_s:.3f} s, {len(got)} anomalies")
        # the routed diagnoses, without their evidence
        for line in anomaly_report(got).splitlines():
            if "->" in line or "no anomalies" in line:
                log("simulate", f"  {line.strip()}")
        jobs[key] = dict(name=name, events=len(batch), sim_s=sim_s,
                         engine_s=engine_s, anomalies=anomaly_rows(got),
                         truth_rank=sim.hang.truth_rank if sim.hang else None)
    what = f"simulate {N} ranks"
    hit = expect(f"{what} job-2", found["job-2"], "fail_slow", "throughput",
                 "operations", phase="simulate")
    if 137 not in hit.ranks:
        fail(f"simulate: job-2's fail-slow names ranks {hit.ranks}, not 137")
    advice = [a.evidence.get("layout_advice") or {} for a in found["job-3"]
              if (a.kind, a.metric, a.team.value)
              == ("regression", "flops", "infrastructure")]
    if not any(d.get("misaligned_dims") == [8484]
               and d.get("padded_dims") == [8512] for d in advice):
        fail(f"simulate: job-3 gives no FLOPS regression with the 8484 -> "
             f"8512 advice: {[(a.kind, a.metric) for a in found['job-3']]}")
    hang = expect(f"{what} job-4", found["job-4"], "hang", None,
                  "operations", phase="simulate")
    link = tuple(hang.evidence.get("link") or ())
    if link != (611, 612) or jobs["job-4"]["truth_rank"] != 611:
        fail(f"simulate: job-4's hang names link {link}, the simulator's "
             f"truth rank {jobs['job-4']['truth_rank']}")
    events = sum(j["events"] for j in jobs.values())
    sim_s = sum(j["sim_s"] for j in jobs.values())
    log("simulate", f"{N} ranks: job-2 fail_slow/throughput on ranks "
        f"{hit.ranks} -> operations; job-3 {len(advice)} regression/flops "
        f"-> infrastructure with the 8484 -> 8512 advice; job-4 hang on link "
        f"{link[0]} -> {link[1]} -> operations, truth rank 611; job-1 (GC "
        f"stalls, not asserted) {len(found['job-1'])} anomalies; the "
        f"simulator {events / sim_s:.0f} events/s, the engine "
        + ", ".join(f"{j['engine_s']:.3f}" for j in jobs.values())
        + " s a job")
    return dict(ranks=N, learn_s=learn_s, jobs=jobs,
                sim_events_per_s=events / sim_s)


def sim_service_jobs(ex, prog) -> dict:
    """Each simulated job of ``SIM_JOBS``: its batch one step a piece, the
    pieces written as an FCS spill of one segment a step."""
    from repro_torch import store
    from repro_torch.core.timeline import ClusterSimulator, Injection
    SIM_SPILLS.mkdir(parents=True)
    pieces = {}
    for job, (inj, _) in SIM_JOBS.items():
        batch = ClusterSimulator(
            SIM_RANKS, prog, seed=ex.JOB_SEED,
            injections=[Injection(**inj)] if inj else []).run_batch(
                ex.JOB_STEPS)
        order, steps, bounds = batch.step_index()
        pieces[job] = [batch.take(order[bounds[i]:bounds[i + 1]])
                       for i in range(steps.size)]
        writer = store.SegmentedTraceWriter(str(SIM_SPILLS / f"{job}.fcs"),
                                            codec="fcs")
        for piece in pieces[job]:
            writer.write(piece)
    return pieces


def sim_oracle() -> list:
    """The five spills of the service drill replayed serially into one
    fresh multiplexer with the service's configuration, placements and
    profiles, the jobs registered in the service's order: the rows."""
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.history import HistoryStore
    from repro_torch.fleet import FleetConfig, FleetMultiplexer, FleetReplayer
    topology = {job: topo for job, (_, topo) in SIM_JOBS.items()}
    topology[SVC_M] = SVC_M_TOPOLOGY
    mux = FleetMultiplexer(FleetConfig(watermark_delay=1,
                                       fleet_detectors=FLEET_DETECTORS,
                                       topology=topology),
                           history=HistoryStore(str(SIM_HISTORY)))
    for job in SIM_JOBS:
        mux.add_job(job, EngineConfig(**SIM_ENGINE))
    mux.add_job(SVC_M, EngineConfig(**SERVICE_ENGINE))
    FleetReplayer(mux).replay_dir(str(SIM_SPILLS), job_workers=1)
    return service_rows(mux.finalize())


def sim_service(seed: int, svc_a_bracket_s: float | None) -> dict:
    """One process-mode service (2 workers, the query plane) fed at once
    by the four simulated 1024-rank jobs of ``SIM_JOBS``, one step a frame
    through a ``LiveClient`` on a thread of its own, and by svc-m, a
    traced llama3.2-1b job at Case 3's drilled setting whose daemon's live
    sink streams its drains; the simulated jobs' step s goes out as svc-m
    starts its step s.  Each job's stream equal to the replay of the five
    spills, the expected findings on each, no drop."""
    import multiprocessing as mp
    import queue
    import threading
    import torch
    from repro_torch.serve import LiveClient

    ex = cluster_example()
    pieces = sim_service_jobs(ex, ex.program(SIM_RANKS))
    names = [*SIM_JOBS, SVC_M]
    kernels = train_kernels("llama3.2-1b")
    M = ServiceProc(mp.get_context("spawn"), "M", dict(
        config=dict(port=0, query_port=0, worker_kind="process", workers=2),
        history=str(SIM_HISTORY)))
    try:
        M.spawned()
        M.ready()
        port, qport = M.info["port"], M.info["query_port"]
        client = LiveClient("127.0.0.1", port)
        for job, (_, topo) in SIM_JOBS.items():
            client.hello(job, topo, SIM_ENGINE)
        go: queue.Queue = queue.Queue()
        sent: dict = {job: [] for job in SIM_JOBS}  # (step, events, bytes)
        feed: dict = dict(errors=[])

        def feeder():
            try:
                while (s := go.get()) is not None:
                    feed.setdefault("first", time.perf_counter())
                    for job, steps in pieces.items():
                        n = client.send_batch(job, steps[s])
                        sent[job].append((s, len(steps[s]), n))
                    feed["last"] = time.perf_counter()
                for job in pieces:
                    client.bye(job)
            except Exception as e:  # the phase fails on it after the join
                feed["errors"].append(repr(e))
            finally:
                client.close()

        thread = threading.Thread(target=feeder, daemon=True,
                                  name="simulate-feeder")
        thread.start()

        def hook(step):
            # the simulated jobs' step s as svc-m starts its step s: both
            # run 6 steps (DRILL_STEPS, the example's JOB_STEPS)
            go.put(step)

        t0 = time.perf_counter()
        trainer, spill_m = service_trainer(
            seed, SVC_M, f"127.0.0.1:{port}", DRILL_STEPS, "naive", False,
            hook, topology=SVC_M_TOPOLOGY, spill_dir=SIM_SPILLS)
        for k, _, _ in kernels.values():
            k.launches = 0
        trainer.train()
        launches = {lb: k.launches for lb, (k, _, _) in kernels.items()}
        dm = trainer.daemon
        del trainer
        torch.cuda.empty_cache()
        job_s = time.perf_counter() - t0
        go.put(None)
        thread.join(SERVICE_WAIT_S)
        if thread.is_alive() or feed["errors"]:
            state = "hangs" if thread.is_alive() else "failed"
            fail(f"simulate: the feeder thread {state}: {feed['errors']}")
        deadline = time.perf_counter() + SERVICE_WAIT_S
        while not all(query(qport, "/jobs")["jobs"].get(j, {}).get(
                "departed") for j in names):
            if time.perf_counter() > deadline:
                fail(f"simulate: M: not every job of {names} departed (BYE) "
                     f"in {SERVICE_WAIT_S} s")
            time.sleep(SERVICE_POLL_S)
        M.call("settle")
        settled = time.perf_counter()
        jobs = query(qport, "/jobs")["jobs"]
        fin = M.call("finalize")
    finally:
        M.close()

    rows = service_rows(M.anomalies)
    want = sim_oracle()
    for job in names:
        same_rows(f"M's stream of {job}", [r for r in rows if r["job"] == job],
                  [r for r in want if r["job"] == job])
    by_job = {job: [fa for fa in M.anomalies if fa.job_id == job]
              for job in names}

    def findings(job, origin, kind, metric, team):
        return [fa for fa in by_job[job] if fa.origin == origin
                and (fa.anomaly.kind, fa.anomaly.metric, fa.anomaly.team.value)
                == (kind, metric, team)]

    for job in ("sim-jitter-a", "sim-jitter-b"):
        if not [fa for fa in findings(job, "fleet", "fail_slow",
                                      "cross_job_correlation",
                                      "infrastructure")
                if fa.anomaly.evidence.get("rack") == "rack0"]:
            fail(f"simulate: {job}: no fleet-tier cross_job_correlation on "
                 f"rack0: {service_rows(by_job[job])}")
    slow = findings("sim-underclock", "job", "fail_slow", "throughput",
                    "operations")
    if not any(137 in fa.anomaly.ranks for fa in slow):
        fail(f"simulate: sim-underclock: no fail_slow/throughput on rank "
             f"137: {service_rows(by_job['sim-underclock'])}")
    if by_job["sim-healthy"]:
        fail(f"simulate: sim-healthy is not silent: "
             f"{service_rows(by_job['sim-healthy'])}")
    vinter = findings(SVC_M, "job", "regression", "v_inter", "algorithm")
    if not vinter or any(fa.origin == "fleet" for fa in by_job[SVC_M]):
        fail(f"simulate: {SVC_M}: {service_rows(by_job[SVC_M])}")

    facts_m = spill_facts(spill_m)
    live_m = {k: int(dm.telemetry.value(f"daemon.live_{k}"))
              for k in ("frames", "dropped", "reconnects", "bytes")}
    frames_sim = sum(len(v) for v in sent.values())
    counters = fin["counters"]
    if (live_m["frames"] != facts_m["segments"] or live_m["dropped"]
            or live_m["reconnects"]):
        fail(f"simulate: {SVC_M}'s live sink {live_m}, its spill "
             f"{facts_m['segments']} segments")
    if any([s for s, _, _ in v] != list(range(ex.JOB_STEPS))
           for v in sent.values()):
        fail(f"simulate: the feeder sent {[len(v) for v in sent.values()]} "
             f"frames a job, not {ex.JOB_STEPS}")
    if (counters.get("serve.frames") != frames_sim + live_m["frames"]
            or counters.get("serve.dropped_frames", 0)):
        fail(f"simulate: M took {counters.get('serve.frames')} frames "
             f"({counters.get('serve.dropped_frames', 0)} dropped), "
             f"{frames_sim} + {live_m['frames']} were sent")
    events = {job: sum(len(p) for p in pieces[job]) for job in SIM_JOBS}
    events[SVC_M] = facts_m["events"]
    if sorted(jobs) != sorted(names) or any(
            jobs[j]["events"] != n for j, n in events.items()):
        got = {j: v.get("events") for j, v in jobs.items()}
        fail(f"simulate: M's /jobs {got}, the spills {events}")
    if fin["errors"]:
        fail(f"simulate: M's workers failed: {fin['errors']}")
    bracket = dm.telemetry.value("daemon.anchor_bracket_max_s")
    total = sum(events.values())
    span_s = settled - feed["first"]
    for job in names:
        found = sorted({(fa.origin, fa.anomaly.kind, fa.anomaly.metric,
                         fa.anomaly.team.value) for fa in by_job[job]})
        rack = SIM_JOBS[job][1] if job in SIM_JOBS else SVC_M_TOPOLOGY
        log("simulate", f"M {job} ({rack['rack']}): {events[job]} events, "
            f"{len(by_job[job])} anomalies equal to the replay, "
            f"{found or 'none'}")
    log("simulate", f"M held {len(names)} jobs at once: {frames_sim} "
        f"simulated frames (step s of each as svc-m started its step s) + "
        f"{live_m['frames']} of svc-m's = {counters['serve.frames']}"
        f" taken, 0 dropped, 0 reconnects; /jobs lists "
        f"{', '.join(sorted(jobs))}; {total} events in {span_s:.2f} s from "
        f"the first frame to settled ({total / span_s:.0f} events/s), the "
        f"last simulated frame {settled - feed['last']:.2f} s before; M's "
        f"host CPU {fin['cpu_s']:.2f} s (with its 2 workers, "
        f"{total / fin['cpu_s']:.0f} events a CPU second); svc-m "
        f"{job_s:.1f} s, its widest anchor bracket {bracket * 1e3:.3f} ms"
        + ("" if svc_a_bracket_s is None else
           f" (svc-a's in the service phase {svc_a_bracket_s * 1e3:.3f} ms)"))
    return dict(jobs={job: dict(events=events[job], stream=[
        r for r in rows if r["job"] == job]) for job in names},
        frames_sim=frames_sim, sent=sent, live=live_m, spill=facts_m,
        counters=counters, host_cpu_s=fin["cpu_s"], events=total,
        span_s=span_s, events_per_s=total / span_s,
        events_per_cpu_s=total / fin["cpu_s"], job_s=job_s,
        bracket_s=bracket, launches=launches, spawned_s=M.info["spawned_s"],
        torch_in_service=False)


def simulate_phase(seed: int, fleet: FleetLive,
                   svc_a_bracket_s: float | None = None) -> dict:
    """The port's cluster simulator (``repro_torch.core.timeline``,
    ``core/injectors``, ``scenarios``) at the H100's ceilings: the scenario
    matrix (``sim_matrix``), the paper's 1024-rank drills
    (``sim_cluster``) and one service fed at once by simulated jobs and a
    traced job on the card (``sim_service``); the profiles of the
    ``diagnose`` phase's healthy jobs (``fleet.history``) beside the
    simulated jobs' in ``SIM_HISTORY``."""
    import shutil
    from repro_torch.core.history import HistoryStore

    t_phase = time.perf_counter()
    shutil.rmtree(SIM_DIR, ignore_errors=True)
    SIM_DIR.mkdir(parents=True)
    history = HistoryStore(str(SIM_HISTORY))
    for prof in fleet.history.snapshot_profiles().values():
        history.put(prof)
    walls = {}
    t0 = time.perf_counter()
    matrix = sim_matrix()
    walls["matrix"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cluster = sim_cluster(history)
    walls["cluster"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    service = sim_service(seed, svc_a_bracket_s)
    walls["service"] = time.perf_counter() - t0
    wall = time.perf_counter() - t_phase
    log("simulate", f"phase wall {wall:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in walls.items()) + ")")
    return dict(matrix=matrix, cluster=cluster, service=service,
                walls=walls, wall_s=wall)


# --------------------------------------------------------------------------- #
# phase 4f: parallel — the GPipe pipeline, expert and context parallelism
# and the mesh training step on ranks
# --------------------------------------------------------------------------- #
PAR_DIR = OUT_DIR / "parallel"    # the ranks' traces
PAR_WORLD = 4
PIPE_ARCH = "llama3.2-1b"
PIPE_STAGES, PIPE_M, PIPE_S = 4, 8, 1024     # stages, microbatches, tokens
EP_ARCH = "dbrx-132b"
EP_B, EP_S = 2, 1024
# the dbrx block's expert-parallel paths: tag -> ((data, model) mesh,
# capacity factor, None for the config's).  At the config's 1.25 the
# seeded router drops no entry, so the last path halves the capacity
# factor to hold the kept-slot check to dropped entries as well.
EP_CASES = {"ep (1, 4)": ((1, 4), None), "ep (2, 2)": ((2, 2), None),
            "ep (2, 2) cf 0.5": ((2, 2), 0.5)}
# context parallelism: llama3.2-1b whole, one prompt of CP_S tokens, its
# attention's query rows over a (data 1, model 4) mesh
CP_ARCH = "llama3.2-1b"
CP_B, CP_S = 1, 4096
CP_MESH = (1, PAR_WORLD)
# the CP prefill's logits against the one-process prefill's (the flash
# kernel), bf16 serving: max |got - want| at most this share of max |want|
SERVE_BF16_SCALED = 5e-2
# the mesh training step: llama3.2-1b whole on a (data, model) mesh, its
# AdamW state ZeRO-sharded (``mesh_phase``)
MESH_ARCH = "llama3.2-1b"
MESH_SHAPE = (2, 2)                 # (data, model)
MESH_B, MESH_S, MESH_STEPS = 8, 512, 2
MESH_DIR = PAR_DIR / "mesh"         # the mesh ranks' traces
MESH_LOSS_REL = 1e-2     # (d): loss and grad_norm against the oracle's
MESH_UPDATE_REL = 1e-6   # (c): the update against adamw_update's
MESH_TAGS = tuple(f"mesh step {s}" for s in range(MESH_STEPS))

# each path's traced daemon step, in the order they run: a forward path's
# step follows its warm-up's, and its backward's (no warm-up) follows it
PAR_STEPS = {"pipeline": 1, "pipeline bwd": 2, "ep (1, 4)": 4,
             "ep (1, 4) bwd": 5, "ep (2, 2)": 7, "ep (2, 2) bwd": 8,
             "ep (2, 2) cf 0.5": 10, "ep (2, 2) cf 0.5 bwd": 11, "cp": 13,
             "cp bwd": 14,
             **{tag: 16 + s for s, tag in enumerate(MESH_TAGS)}}
# each path's arch by the first word of its tag, for the kernels line
PAR_ARCHS = {"pipeline": PIPE_ARCH, "cp": CP_ARCH, "mesh": MESH_ARCH}
PAR_KERNELS = ("flash_attention[wgmma]", "fused_residual_rmsnorm",
               "ring_combine", "flash_attention_bwd[wgmma]",
               "fused_residual_rmsnorm_bwd")
# the traced spans of the first three (the backward kernels have none)
PAR_SPANS = ("flash_attention", "fused_residual_rmsnorm", "ring_combine")


def par_draw(shapes: dict, cfg, seed: int, device) -> dict:
    """Seeded bf16 weights of a block's parameters ({name: shape}, in
    order): normal draws at the JAX init's stddev (``init_std``), norm
    scales fp32 1 + 0.1·N(0, 1); the same in every process."""
    import torch
    from repro_torch.models.transformer import init_std
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape in shapes.items():
        if name.endswith("scale"):
            out[name] = 1 + 0.1 * torch.randn(shape, generator=gen,
                                              device=device)
            continue
        out[name] = torch.randn(shape, generator=gen, device=device,
                                dtype=torch.bfloat16).mul_(
                                    init_std(cfg, name))
    return out


def par_block_shapes(cfg, prefix: str = "") -> dict:
    import torch
    from repro_torch.models.transformer import Block
    blk = Block(cfg, torch.bfloat16, "meta")
    return {f"{prefix}{n}": tuple(p.shape) for n, p in blk.named_parameters()}


def pipe_inputs(seed: int, device):
    """llama3.2-1b's 16 blocks' weights and final norm ({port name:
    tensor}) and the M microbatches' (h, x) pairs [M, 2, 1, S, D] after the
    embedding (x a seeded draw, h its first norm)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.layers import rmsnorm
    cfg = get_config(PIPE_ARCH)
    shapes = {}
    for i in range(cfg.num_layers):
        shapes.update(par_block_shapes(cfg, f"layers.{i}."))
    shapes["final_norm.scale"] = (cfg.d_model,)
    state = par_draw(shapes, cfg, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    x = torch.randn((PIPE_M, 1, PIPE_S, cfg.d_model), generator=gen,
                    device=device, dtype=torch.bfloat16)
    h = rmsnorm(state["layers.0.ln1.scale"], x, cfg.norm_eps)
    return cfg, state, torch.stack([h, x], dim=1)


def ep_inputs(seed: int, device, capacity_factor=None):
    """One dbrx-132b block's config (its capacity factor replaced when one
    is given), weights ({name: tensor}, all 16 experts), the scale of the
    norm after it, and its input pair (h, x) [B, S, D]."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.layers import rmsnorm
    cfg = get_config(EP_ARCH)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    shapes = par_block_shapes(cfg)
    shapes["nxt.scale"] = (cfg.d_model,)
    state = par_draw(shapes, cfg, seed + 2, device)
    nxt = state.pop("nxt.scale")
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    x = torch.randn((EP_B, EP_S, cfg.d_model), generator=gen, device=device,
                    dtype=torch.bfloat16)
    return cfg, state, nxt, rmsnorm(state["ln1.scale"], x, cfg.norm_eps), x


class MoeSpy:
    """Keeps what the block's ``moe_apply`` computed: the routing that
    ``route`` returned (expert ids and weights [T, k]) and the kept
    entries that ``dispatch`` returned to ``expert_ff_local`` (True where
    this rank's experts took the entry within their capacity)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.orig = moe, (moe.route, moe.dispatch)
        self.routes, self.keeps = [], []

        def route(*args, **kwargs):
            out = self.orig[0](*args, **kwargs)
            self.routes.append(out[:2])
            return out

        def dispatch(*args, **kwargs):
            dest, keep = self.orig[1](*args, **kwargs)
            self.keeps.append(keep)
            return dest, keep
        moe.route, moe.dispatch = route, dispatch
        return self

    def __exit__(self, *exc):
        self.moe.route, self.moe.dispatch = self.orig

    def one(self) -> tuple:
        """(expert ids, weights, kept) [T, k] of the one ``moe_apply``."""
        if len(self.routes) != 1 or len(self.keeps) != 1:
            fail(f"parallel: {len(self.routes)} routings and "
                 f"{len(self.keeps)} dispatches, not one of each")
        eids, w = self.routes[0]
        return eids, w, self.keeps[0].view(eids.shape)


class CpSpy:
    """Keeps what ``context_parallel_attention`` did on this rank: the
    query rows, key rows and q_offset of each ``chunked_attention`` call,
    and the rows, result bytes and group size of each ring all-gather
    that met the ranks' rows."""

    def __enter__(self):
        from repro_torch.models import attention as attn_lib
        self.lib = attn_lib
        self.orig = (attn_lib.chunked_attention, attn_lib.ring_all_gather_local)
        self.calls, self.gathers = [], []

        def chunked(q, k, v, causal=True, q_offset=0, *a, **kw):
            self.calls.append((q.shape[1], k.shape[1], int(q_offset)))
            return self.orig[0](q, k, v, causal, q_offset, *a, **kw)

        def gather(x, group=None, *a, **kw):
            rows, progress = self.orig[1](x, group, *a, **kw)
            self.gathers.append((x.shape[0], rows.numel()
                                 * rows.element_size(), rows.shape[0]
                                 // x.shape[0]))
            return rows, progress
        attn_lib.chunked_attention = chunked
        attn_lib.ring_all_gather_local = gather
        return self

    def __exit__(self, *exc):
        (self.lib.chunked_attention,
         self.lib.ring_all_gather_local) = self.orig


def par_block(state: dict, cfg, shards: int = 1, prefix: str = ""):
    """The port's ``Block`` holding ``state``'s ``prefix`` entries
    (experts already cut to E / ``shards``)."""
    import torch
    from repro_torch.models.transformer import Block
    blk = Block(cfg, torch.bfloat16, "meta", torch.float32, shards)
    for name, p in list(blk.named_parameters()):
        mod, _, leaf = name.rpartition(".")
        setattr(blk.get_submodule(mod), leaf,
                torch.nn.Parameter(state[prefix + name], requires_grad=False))
    return blk


def bits(t):
    """A bf16 tensor as numpy int16 (its bits), to cross processes."""
    import torch
    return t.contiguous().view(torch.int16).cpu().numpy()


def from_bits(a):
    import torch
    return torch.from_numpy(a).view(torch.bfloat16)


def par_sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def par_launches(**counts) -> dict:
    """A path's expected launches a rank by ``PAR_KERNELS`` label, 0 where
    none is named (a keyword is its label with "[wgmma]" as "_wgmma")."""
    out = {k: counts.pop(k.replace("[", "_").rstrip("]"), 0)
           for k in PAR_KERNELS}
    if counts:
        fail(f"par_launches: no kernel {sorted(counts)}")
    return out


def par_counts(reset: bool = False) -> dict:
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.fused_norm import ops as fn
    from repro_torch.kernels.ring_reduce import ops as ring
    ks = dict(zip(PAR_KERNELS, (fa.KERNELS["wgmma"], fn.KERNEL,
                                ring.KERNEL, fa.BWD_KERNELS["wgmma"],
                                fn.BWD_KERNEL)))
    out = {label: k.launches for label, k in ks.items()}
    if reset:
        for k in ks.values():
            k.launches = 0
    return out


def par_cotangent(shape: tuple, seed: int, device):
    """A seeded bf16 output gradient of values k / 32, k in [-32, 32]: six
    significant bits at most, so that the ring's sum of S <= 4 copies of
    it scaled by 1 / S (the seeds of a loss replicated over S stages) is
    exact, and every stage takes exactly this gradient, as the oracle
    does."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-32, 33, shape, generator=gen, device=device).to(
        torch.bfloat16) / 32


def par_peak(device, reset: bool = False):
    """The card's peak allocated bytes since the last reset (None off the
    card)."""
    import torch
    if torch.device(device).type != "cuda":
        return None
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.max_memory_allocated(device)


# an oracle's daemon step: its path's plus this, so that the spans of the
# oracle's kernels never count as the path's
PAR_ORACLE_STEP = 100


def rank_turns(fn, daemon, step: int):
    """``fn()`` on each rank in turn, one at a time on the card, the world
    group's barrier between turns, so that an oracle's peak memory is one
    rank's; each turn in daemon step ``step``.  Returns this rank's
    result."""
    import torch
    import torch.distributed as dist
    out = None
    for r in range(dist.get_world_size()):
        if dist.get_rank() == r:
            daemon.step_begin(step)
            daemon.set_stack([f"step_{step}", "oracle"])
            out = fn()
            daemon.step_end()
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def grad_report(got, want) -> dict:
    """A gradient against its oracle, raising nothing: bitwise equality,
    the max abs error, the elements outside the bf16 tolerance at the
    gradient's own scale (``TOLS``' atol times the oracle's max |.|, plus
    its rtol times |want|: a bf16 gradient of magnitude 16-32 has an ulp
    of 0.125, and a replicated parameter's is a sum of bf16 shares, each
    rounded), the max abs error as a share of the oracle's max |.|, and
    whether it is finite."""
    import torch
    tol = TOLS["bfloat16"]
    got_f, want_f = got.reshape(-1), want.reshape(-1)
    top = float(want_f.abs().max())
    err, outside, finite = 0.0, 0, True
    step = 1 << 26       # elements at a time: the fp32 copies stay small
    for i in range(0, got_f.numel(), step):
        g, w = got_f[i:i + step].float(), want_f[i:i + step].float()
        diff = (g - w).abs()
        err = max(err, float(diff.max()))
        outside += int((diff > tol["atol"] * top
                        + tol["rtol"] * w.abs()).sum())
        finite = finite and bool(g.isfinite().all())
    return dict(equal=bool(torch.equal(got, want)), max_abs_err=err,
                outside_bf16=outside, scaled=err / max(top, 1e-30),
                finite=finite, shape=list(got.shape))


def pipe_grad_oracle(seed: int, device, stage: int, per: int, c) -> dict:
    """The pipeline's gradient for one stage, from llama3.2-1b's 16 blocks
    in order, one microbatch at a time (the port's ``Block`` modules
    through ``block_apply``, nothing of ``parallel/pipeline.py``), each
    microbatch's output gradient ``c[mb]``: every parameter of the stage's
    layers by its stacked name, [1, per, ...] (``nxt`` the next layer's
    first norm, or the final norm), and the microbatches'.  The
    microbatches' parameter gradients add up M - 1 first, as the
    pipeline's reverse schedule adds them."""
    import torch
    from repro_torch.models.transformer import block_apply
    cfg, state, a = pipe_inputs(seed, device)
    L = cfg.num_layers
    blocks = [par_block(state, cfg, prefix=f"layers.{i}.") for i in range(L)]
    nxts = [state[f"layers.{i + 1}.ln1.scale"] for i in range(L - 1)] + [
        state["final_norm.scale"]]
    mine = range(stage * per, (stage + 1) * per)
    leaves = {}
    for i in mine:
        for n, p in blocks[i].named_parameters():
            if n != "ln1.scale":       # the layer's input comes normed
                leaves[n, i] = p.requires_grad_()
        nxts[i] = leaves["nxt", i] = nxts[i].detach().requires_grad_()
    keys = list(leaves)
    sums = dict.fromkeys(keys)
    gx = torch.zeros_like(a)
    positions = torch.arange(PIPE_S, device=device)[None, :]
    for mb in reversed(range(PIPE_M)):
        am = a[mb].detach().requires_grad_()
        h, x = am[0], am[1]
        for i, blk in enumerate(blocks):
            h, x = block_apply(blk, h, x, positions, cfg, lambda w: w,
                               nxts[i], i)
        gs = torch.autograd.grad(torch.stack([h, x]),
                                 [leaves[k] for k in keys] + [am], c[mb])
        for k, g in zip(keys, gs):
            sums[k] = g if sums[k] is None else sums[k] + g
        gx[mb] = gs[-1]
    out = {n: torch.stack([sums[n, i] for i in mine])[None]
           for n in {k[0] for k in keys}}
    out["x"] = gx
    return out


def ep_cotangents(seed: int, device) -> tuple:
    """The EP block's output gradients (of h and x) [EP_B, EP_S, D]."""
    import torch
    from repro_torch.configs import get_config
    gen = torch.Generator(device=device).manual_seed(seed + 7)
    shape = (EP_B, EP_S, get_config(EP_ARCH).d_model)
    return tuple(torch.randn(shape, generator=gen, device=device,
                             dtype=torch.bfloat16) for _ in range(2))


def ep_spec(name: str):
    """How a rank of an EP path holds a block tensor: the experts' weights
    split over the model axis, every other parameter whole."""
    from repro_torch.models.moe import EXPERT_WEIGHTS
    from repro_torch.parallel.sharding import Spec
    mod, _, leaf = name.rpartition(".")
    return Spec("model") if (mod == "moe" and leaf in EXPERT_WEIGHTS) \
        else Spec()


def ep_grad_oracle(seed: int, device, cf, coords, e_loc: int,
                   dp: int) -> dict:
    """The EP block's gradient oracle for the rank at ``coords``: the local
    block, all 16 experts, on each data shard's tokens, with the shard's
    output gradients, its parameter gradients summed over the shards in
    order (its experts' block cut out) and the rank's shard's (h, x)
    gradients."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.transformer import block_apply
    cfg, state, nxt, h, x = ep_inputs(seed, device, cf)
    blk = par_block(state, cfg)
    for p in blk.parameters():
        p.requires_grad_()
    nxt.requires_grad_()
    ch, cx = ep_cotangents(seed, device)
    positions = torch.arange(EP_S, device=device)[None, :]
    rows = EP_B // dp
    d, m = coords
    out = {}
    for dd in range(dp):
        hs, xs = (t[dd * rows:(dd + 1) * rows].detach().requires_grad_()
                  for t in (h, x))
        yh, yx = block_apply(blk, hs, xs, positions, cfg, lambda w: w, nxt,
                             0)
        ((yh * ch[dd * rows:(dd + 1) * rows]).sum()
         + (yx * cx[dd * rows:(dd + 1) * rows]).sum()).backward()
        if dd == d:
            out["h"], out["x"] = hs.grad, xs.grad
    for n, p in blk.named_parameters():
        if p.grad is not None:
            leaf = n.rsplit(".", 1)[-1]
            out[n] = (p.grad[m * e_loc:(m + 1) * e_loc].clone()
                      if n.startswith("moe.") and leaf in moe.EXPERT_WEIGHTS
                      else p.grad)
    out["nxt"] = nxt.grad
    return out


CP_LOSS_ROWS = 512     # the CP loss's head and softmax, rows at a time


def cp_loss(model, tokens, labels):
    """``TransformerLM.loss`` of a dense model (the mean cross-entropy),
    with the head and its fp32 softmax a block of ``CP_LOSS_ROWS`` rows at
    a time, each recomputed in the backward (``torch.utils.checkpoint``):
    the four CP ranks' whole fp32 logits at S 4096 (2.1 GB each, and as
    much again for their gradient) would not fit the card beside the rest
    of their backward."""
    import torch
    from torch.utils.checkpoint import checkpoint
    from repro_torch.models import layers as L
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)[None, :]
    h = model._blocks(model._embed(tokens), positions)[0]

    def rows(h_rows, labels_rows):
        return L.cross_entropy(model._head(h_rows), labels_rows) \
            * labels_rows.numel()
    total = sum(checkpoint(rows, h[:, i:i + CP_LOSS_ROWS],
                           labels[:, i:i + CP_LOSS_ROWS], use_reentrant=False)
                for i in range(0, S, CP_LOSS_ROWS))
    return total / labels.numel()


def cp_grad_oracle(model, tokens, labels, grads: dict) -> dict:
    """The CP path's gradient against the one-process model's on the same
    weights (the model's attention on its default route, the flash
    kernel, no mesh): ``grad_report`` of each parameter; the model's own
    gradients are cleared after."""
    from repro_torch.models.transformer import AttnImpl
    saved = model.attn, model.mesh
    model.attn, model.mesh = AttnImpl(), None
    try:
        cp_loss(model, tokens, labels).backward()
    finally:
        model.attn, model.mesh = saved
    out = {n: grad_report(g, dict(model.named_parameters())[n].grad)
           for n, g in grads.items()}
    for p in model.parameters():
        p.grad = None
    return out


def cp_inputs(seed: int, device, mesh=None):
    """llama3.2-1b whole for the CP prefill: the serving model (bf16
    weights drawn from ``seed`` on ``device``, the same in every process),
    ``attn_impl="cp"`` over ``mesh`` when one is given (else the default
    route, the flash kernel), and its prompt [CP_B, CP_S]."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.layers import Policy
    from repro_torch.models.registry import build_model
    cfg = get_config(CP_ARCH)
    model = build_model(cfg, Policy(torch.bfloat16), device, mesh=mesh,
                        attn_impl="cp" if mesh is not None else "auto")
    model.init(torch.Generator(device=device).manual_seed(seed + 4))
    tokens = torch.as_tensor(np.random.default_rng(seed + 4).integers(
        0, cfg.vocab_size, (CP_B, CP_S)), device=device)
    return cfg, model, tokens


def cp_prefill(model, tokens):
    return model.prefill(tokens, model.init_cache(CP_B, CP_S))


def parallel_rank(ctx, seed: int) -> dict:
    """One rank of the parallel phase, in daemon steps (``PAR_STEPS``,
    each after a warm-up step of its own): the llama3.2-1b pipeline on a
    ("stage",) mesh of 4, then one dbrx-132b block through
    ``block_apply`` with its experts parallel on each path of ``EP_CASES``,
    then llama3.2-1b's context-parallel prefill on a (data 1, model 4)
    mesh.
    Each rank draws the full weights from the seed and keeps only its
    block: its stage's (``Spec("stage")``), its experts'
    (``shard_experts``).  The kernels' counts are set to 0 just before
    each path and read just after."""
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.models.transformer import block_apply
    from repro_torch.parallel import pipeline as pp
    from repro_torch.parallel.sharding import Spec, replicas, sum_replicated

    dev, daemon, out = ctx.device, ctx.daemon, {}
    # autograd's first call with an output gradient imports its shape
    # checks and starts the device's autograd thread: seconds on the card's
    # host, which the pipeline's reverse schedule would pay on each stage
    # in turn (on an H100's host its first backward took 20.7 s against
    # 0.9 s after, tools/pipeline_bwd_profile.py); every rank pays it here
    # at once
    w = torch.ones(1, device=dev, requires_grad=True)
    torch.autograd.grad(w * 2, w, torch.ones_like(w))
    pipe_mesh = make_mesh((PIPE_STAGES,), ("stage",))
    ep_meshes = {}
    for shape, _ in (*EP_CASES.values(), (CP_MESH, None)):
        if shape not in ep_meshes:
            ep_meshes[shape] = make_mesh(shape, ("data", "model"))

    def run(step: int, what: str, fn):
        par_sync(dev)
        dist.barrier()
        daemon.step_begin(step)
        daemon.set_stack([f"step_{step}", what])
        par_counts(reset=True)
        t0 = time.perf_counter()
        res = fn()
        par_sync(dev)
        wall = time.perf_counter() - t0
        counts = par_counts()
        daemon.step_end()
        return res, wall, counts

    # the pipeline
    mesh = pipe_mesh
    cfg, state, a = pipe_inputs(seed, dev)
    stacked = pp.stack_block_params(state, cfg, PIPE_STAGES)
    del state
    block = pp.stage_block(stacked, mesh)
    del stacked
    torch.cuda.empty_cache()
    positions = torch.arange(PIPE_S, device=dev)[None, :]
    fn = pp.block_stage(cfg, positions)
    step = PAR_STEPS["pipeline"]
    run(step - 1, "warm-up", lambda: fn({k: v[0] for k, v in block.items()},
                                        a[0]))
    outs, wall, counts = run(step, "pipeline_apply",
                             lambda: pp.pipeline_apply(fn, block, a, mesh))
    resident = sum(t.numel() * t.element_size() for t in block.values())
    out["pipeline"] = dict(
        wall_s=wall, launches=counts, resident_bytes=resident,
        tick_bytes=a[0].numel() * a.element_size(),
        sha=hashlib.sha256(bits(outs).tobytes()).hexdigest(),
        outs=bits(outs) if ctx.rank == 0 else None,
        finite=bool(outs.isfinite().all()))
    del outs

    # its backward: the stage's block and the microbatches as leaves, the
    # loss the same on every stage, so seeded with 1 / S
    for v in block.values():
        v.requires_grad_()
    a.requires_grad_()
    c = par_cotangent(tuple(a.shape), seed + 5, dev)

    def pipe_backward():
        o = pp.pipeline_apply(fn, block, a, mesh)
        ((o * c).sum() / replicas(Spec(), mesh)).backward()
        return sum_replicated(a.grad, Spec(), mesh)
    par_peak(dev, reset=True)
    ga, wall, counts = run(PAR_STEPS["pipeline bwd"], "pipeline_apply "
                           "backward", pipe_backward)
    peak = par_peak(dev)
    stage = mesh.axis_index("stage")
    grads = {k: v.grad for k, v in block.items()}
    grads["x"] = ga
    del pipe_backward, block, a, ga
    t0 = time.perf_counter()
    per = cfg.num_layers // PIPE_STAGES
    report = rank_turns(
        lambda: {k: grad_report(grads[k], w) for k, w in
                 pipe_grad_oracle(seed, dev, stage, per, c).items()},
        daemon, PAR_ORACLE_STEP + PAR_STEPS["pipeline bwd"])
    out["pipeline bwd"] = dict(
        wall_s=wall, launches=counts, grads=report, peak_bytes=peak,
        oracle_turns_s=time.perf_counter() - t0,
        grad_bytes=sum(g.numel() * g.element_size()
                       for k, g in grads.items() if k != "x"))
    del grads, c
    torch.cuda.empty_cache()

    # expert parallelism, one block, on each mesh
    for tag, (shape, cf) in EP_CASES.items():
        mesh = ep_meshes[shape]
        cfg, state, nxt, h, x = ep_inputs(seed, dev, cf)
        coords = mesh.coords(ctx.rank)
        d, m = coords
        n = mesh.shape["model"]
        state = moe.shard_experts(state, mesh, coords)
        torch.cuda.empty_cache()
        blk = par_block(state, cfg, n)
        rows = EP_B // mesh.shape["data"]
        h, x = (t[d * rows:(d + 1) * rows].contiguous() for t in (h, x))
        positions = torch.arange(EP_S, device=dev)[None, :]

        def apply():
            return block_apply(blk, h, x, positions, cfg, lambda w: w, nxt,
                               0, mesh=mesh)
        run(PAR_STEPS[tag] - 1, "warm-up", apply)
        with MoeSpy() as spy:
            (yh, yx), wall, counts = run(PAR_STEPS[tag], "block_apply", apply)
        e_loc = blk.moe.wi_gate.shape[0]
        eids, w, keep = spy.one()
        expert_bytes = sum(getattr(blk.moe, k).numel() * 2
                           for k in moe.EXPERT_WEIGHTS)
        out[tag] = dict(
            coords=coords, wall_s=wall, launches=counts,
            experts=e_loc, first_expert=m * e_loc, expert_bytes=expert_bytes,
            capacity=moe.capacity(rows * EP_S, cfg),
            capacity_factor=cfg.capacity_factor,
            eids=eids.cpu().numpy(), weights=bits(w), keep=keep.cpu().numpy(),
            sha=hashlib.sha256(bits(yx).tobytes() + bits(yh).tobytes())
            .hexdigest(),
            y=(bits(yh), bits(yx)) if m == 0 else None)
        del yh, yx

        # its backward: the block's parameters, the next norm's scale and
        # the shard's (h, x) as leaves; the shard's loss is held by its n
        # model ranks, so seeded with 1 / n
        for p in blk.parameters():
            p.requires_grad_()
        nxt.requires_grad_()
        h.requires_grad_()
        x.requires_grad_()
        ch, cx = (t[d * rows:(d + 1) * rows] for t in ep_cotangents(seed,
                                                                     dev))
        specs = {n: ep_spec(n) for n, _ in blk.named_parameters()}
        specs.update(nxt=Spec(), h=Spec("data"), x=Spec("data"))

        def ep_backward():
            yh, yx = block_apply(blk, h, x, positions, cfg, lambda w: w, nxt,
                                 0, mesh=mesh)
            (((yh * ch).sum() + (yx * cx).sum())
             / replicas(Spec("data"), mesh)).backward()
            held = {n: p.grad for n, p in blk.named_parameters()
                    if p.grad is not None}
            held.update(nxt=nxt.grad, h=h.grad, x=x.grad)
            return {n: sum_replicated(g, specs[n], mesh)
                    for n, g in held.items()}
        grads, wall, counts = run(PAR_STEPS[tag + " bwd"], "block_apply "
                                  "backward", ep_backward)
        del ep_backward, apply, blk, state, h, x, nxt
        t0 = time.perf_counter()
        report = rank_turns(lambda: {
            k: grad_report(grads[k], w) for k, w in ep_grad_oracle(
                seed, dev, cf, coords, e_loc, mesh.shape["data"]).items()},
            daemon, PAR_ORACLE_STEP + PAR_STEPS[tag + " bwd"])
        out[tag + " bwd"] = dict(
            coords=coords, wall_s=wall, launches=counts, grads=report,
            oracle_turns_s=time.perf_counter() - t0,
            sums=[(k, [mesh.shape[a] for a in mesh.axis_names
                       if a not in specs[k]]) for k in grads])
        del grads
        torch.cuda.empty_cache()

    # context parallelism: the whole model, its attention's rows over the
    # model axis
    mesh = ep_meshes[CP_MESH]
    _, model, tokens = cp_inputs(seed, dev, mesh)
    run(PAR_STEPS["cp"] - 1, "warm-up", lambda: cp_prefill(model, tokens))
    with CpSpy() as spy:
        logits, wall, counts = run(PAR_STEPS["cp"], "prefill",
                                   lambda: cp_prefill(model, tokens))
    out["cp"] = dict(
        coords=mesh.coords(ctx.rank), wall_s=wall, launches=counts,
        calls=spy.calls, gathers=spy.gathers,
        finite=bool(logits.isfinite().all()),
        sha=hashlib.sha256(bits(logits).tobytes()).hexdigest(),
        logits=bits(logits) if ctx.rank == 0 else None)
    del logits

    # its backward: the mean cross-entropy on seeded labels, the same on
    # the 4 model ranks, so seeded with 1/4; every parameter whole on each
    labels = torch.as_tensor(np.random.default_rng(seed + 6).integers(
        0, model.cfg.vocab_size, (CP_B, CP_S)), device=dev)

    def cp_backward():
        (cp_loss(model, tokens, labels) / replicas(Spec(), mesh)).backward()
        return {n: sum_replicated(p.grad, Spec(), mesh)
                for n, p in model.named_parameters() if p.grad is not None}
    par_peak(dev, reset=True)
    grads, wall, counts = run(PAR_STEPS["cp bwd"], "loss backward",
                              cp_backward)
    peak = par_peak(dev)
    del cp_backward
    for p in model.parameters():
        p.grad = None
    t0 = time.perf_counter()
    report = rank_turns(
        lambda: cp_grad_oracle(model, tokens, labels, grads), daemon,
        PAR_ORACLE_STEP + PAR_STEPS["cp bwd"])
    out["cp bwd"] = dict(
        coords=mesh.coords(ctx.rank), wall_s=wall, launches=counts,
        grads=report, peak_bytes=peak, params=len(grads),
        oracle_turns_s=time.perf_counter() - t0,
        grad_bytes=sum(g.numel() * g.element_size() for g in grads.values()))
    del model, grads
    torch.cuda.empty_cache()

    # the mesh training step: its own mesh, model and state
    out["mesh"] = mesh_rank(ctx, seed)
    return out


def parallel_oracles(seed: int, device: str = "cuda") -> dict:
    """The plain runs the phase holds the ranks to, on this process: the
    16 llama blocks applied in order, one microbatch at a time (the port's
    ``Block`` modules through ``block_apply``, nothing of
    ``parallel/pipeline.py``, at the pipeline's shapes), and for each EP
    path the dbrx block with all 16 experts on each data shard's tokens,
    with the routing and kept entries it computed; walls beside them."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.transformer import block_apply

    dev = torch.device(device)
    cfg, state, a = pipe_inputs(seed, dev)
    L = cfg.num_layers
    blocks = [par_block(state, cfg, prefix=f"layers.{i}.") for i in range(L)]
    nxts = [state[f"layers.{i + 1}.ln1.scale"] for i in range(L - 1)] + [
        state["final_norm.scale"]]
    positions = torch.arange(PIPE_S, device=dev)[None, :]

    def in_order(mb):
        h, x = mb[0], mb[1]
        for i, (blk, nxt) in enumerate(zip(blocks, nxts)):
            h, x = block_apply(blk, h, x, positions, cfg, lambda w: w, nxt,
                               i)
        return torch.stack([h, x])
    in_order(a[0])                                         # warm-up
    par_sync(dev)
    t0 = time.perf_counter()
    seq = torch.stack([in_order(mb) for mb in a])
    par_sync(dev)
    pipe = dict(wall_s=time.perf_counter() - t0, outs=seq.cpu(),
                weight_bytes=sum(t.numel() * t.element_size()
                                 for n, t in state.items()
                                 if n != "layers.0.ln1.scale"))
    del blocks, nxts, state, seq, a
    torch.cuda.empty_cache()

    positions = torch.arange(EP_S, device=dev)[None, :]
    ep = {}
    for tag, ((dp, _), cf) in EP_CASES.items():
        cfg, state, nxt, h, x = ep_inputs(seed, dev, cf)
        blk = par_block(state, cfg)
        rows = EP_B // dp
        shards = []
        for d in range(dp):
            hs, xs = (t[d * rows:(d + 1) * rows] for t in (h, x))
            block_apply(blk, hs, xs, positions, cfg, lambda w: w, nxt, 0)
            par_sync(dev)
            with MoeSpy() as spy:
                t0 = time.perf_counter()
                yh, yx = block_apply(blk, hs, xs, positions, cfg,
                                     lambda w: w, nxt, 0)
                par_sync(dev)
                wall = time.perf_counter() - t0
            eids, w, keep = spy.one()
            shards.append(dict(yh=yh.cpu(), yx=yx.cpu(), eids=eids.cpu(),
                               weights=w.cpu(), keep=keep.cpu(), wall_s=wall))
        ep[tag] = shards
        expert_bytes = sum(getattr(blk.moe, k).numel() * 2
                           for k in moe.EXPERT_WEIGHTS)
        del blk, state, h, x, nxt
        torch.cuda.empty_cache()

    # the CP prefill's oracle: the same weights and prompt in one process,
    # attention on the flash kernel
    _, model, tokens = cp_inputs(seed, dev)
    cp_prefill(model, tokens)                              # warm-up
    par_sync(dev)
    t0 = time.perf_counter()
    logits = cp_prefill(model, tokens)
    par_sync(dev)
    cp = dict(wall_s=time.perf_counter() - t0, logits=logits.cpu())
    del model, logits
    torch.cuda.empty_cache()
    return dict(pipeline=pipe, ep=ep, expert_bytes=expert_bytes, cp=cp)


def parallel_phase(seed: int, device: str = "cuda") -> dict:
    """The parallel plane on the card (``parallel/mesh.py``'s meshes over
    4 ranks on cuda:0, gloo through pinned host memory): the llama3.2-1b
    GPipe pipeline equal (``torch.equal``) to its blocks in order, one
    microbatch at a time, and one dbrx-132b block's expert parallelism on
    a (1, 4) and a (2, 2) mesh, and on the (2, 2) mesh again at a capacity
    factor that drops entries, with the routing and kept entries that the
    ranks' ``moe_apply`` computed equal to the local block's, y within the
    bf16 tolerance, and llama3.2-1b's context-parallel prefill; then each
    path's backward against its oracle (``parallel_backward_checks``);
    each path's launches of flash, the fused norm, their backwards and
    the ring combine (kernel counts, and the ranks' traced spans of the
    forward kernels); last, on the same ranks, the mesh training step
    (``mesh_rank``, ``mesh_checks``).  A failing rank fails the phase."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.events import load_jsonl
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.parallel.pipeline import bubble_share

    per_stage = get_config(PIPE_ARCH).num_layers // PIPE_STAGES
    t_phase = time.perf_counter()
    PAR_DIR.mkdir(parents=True, exist_ok=True)
    for old in PAR_DIR.glob("rank*.jsonl"):
        old.unlink()
    t0 = time.perf_counter()
    oracle = parallel_oracles(seed, device)
    oracle_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = run_ranks(parallel_rank, PAR_WORLD, seed, device=device,
                      timeout=600.0, log_dir=str(PAR_DIR))
    ranks_wall = time.perf_counter() - t0
    spans = []
    for r in range(PAR_WORLD):
        evs = load_jsonl(str(PAR_DIR / f"rank{r}.jsonl"))
        spans.append({tag: {name: sum(1 for e in evs if e.step == step
                                      and e.name == name)
                            for name in PAR_SPANS}
                      for tag, step in PAR_STEPS.items()
                      if tag not in MESH_TAGS})

    # the pipeline
    pipes = [r["pipeline"] for r in ranks]
    want = oracle["pipeline"]["outs"]
    got = from_bits(pipes[0]["outs"])
    if not all(p["finite"] for p in pipes):
        fail("parallel: the pipeline's outputs are not finite")
    if not torch.equal(got, want):
        diff = (got.float() - want.float()).abs().max()
        fail(f"parallel: the pipeline's outputs differ from the blocks in "
             f"order (max abs diff {float(diff):.3e})")
    if len({p["sha"] for p in pipes}) != 1:
        fail("parallel: the stages returned different outputs")
    launches = {"pipeline": {k: sum(p["launches"][k] for p in pipes)
                             for k in PAR_KERNELS}}
    want_l = par_launches(flash_attention_wgmma=PIPE_M * per_stage,
                          fused_residual_rmsnorm=2 * PIPE_M * per_stage,
                          ring_combine=PIPE_STAGES - 1)
    for r, p in enumerate(pipes):
        if p["launches"] != want_l:
            fail(f"parallel: pipeline rank {r} launched {p['launches']}, "
                 f"not {want_l}")
    bubble = bubble_share(PIPE_STAGES, PIPE_M)
    log("parallel", f"{PIPE_ARCH} GPipe, {PIPE_STAGES} stages of "
        f"{per_stage} layers on a "
        f"('stage',) mesh of {PAR_WORLD} ranks, M {PIPE_M} microbatches of "
        f"[1, {PIPE_S}] as the packed (h, x) pair: equal (torch.equal) to "
        f"the blocks in order one microbatch at a time on every stage; "
        f"wall {max(p['wall_s'] for p in pipes):.3f} s (ranks "
        f"{[round(p['wall_s'], 3) for p in pipes]}) against "
        f"{oracle['pipeline']['wall_s']:.3f} s sequential; bubble share "
        f"(S-1)/(M+S-1) = {bubble:.4f}; {pipes[0]['tick_bytes']} bytes "
        f"exchanged a tick a rank; resident parameter bytes a rank "
        f"{[p['resident_bytes'] for p in pipes]} (the oracle "
        f"{oracle['pipeline']['weight_bytes']}); launches a rank "
        f"{pipes[0]['launches']}, spans a rank "
        f"{[s['pipeline'] for s in spans]}")

    # expert parallelism
    eps = {}
    for tag, (shape, cf) in EP_CASES.items():
        res = [r[tag] for r in ranks]
        dp, n = shape
        shards = oracle["ep"][tag]
        errs, dropped = [], []
        for d, o in enumerate(shards):
            group = [x for x in res if x["coords"][0] == d]
            for x in group:
                if not (np.array_equal(x["eids"], o["eids"].numpy())
                        and torch.equal(from_bits(x["weights"]),
                                        o["weights"])):
                    fail(f"parallel: {tag} rank at {x['coords']}: routing "
                         f"differs from the local block's")
                first = x["first_expert"]
                mine = (x["eids"] >= first) & (x["eids"] < first
                                               + x["experts"])
                if (x["keep"] & ~mine).any():
                    fail(f"parallel: {tag} rank at {x['coords']} kept an "
                         f"entry of another rank's expert")
            # each rank's dispatch kept only its own experts' entries, so
            # their union is a partition of the ranks' kept entries
            kept = np.logical_or.reduce([x["keep"] for x in group])
            if not np.array_equal(kept, o["keep"].numpy()):
                fail(f"parallel: {tag} data shard {d}: kept slots differ "
                     f"from the local block's")
            if len({x["sha"] for x in group}) != 1:
                fail(f"parallel: {tag} data shard {d}: model ranks differ")
            yh, yx = next(x["y"] for x in group if x["y"] is not None)
            errs.append(max(max_err(from_bits(yx), o["yx"], "bfloat16"),
                            max_err(from_bits(yh), o["yh"], "bfloat16")))
            dropped.append(int((~o["keep"]).sum()))
        if cf is not None and not sum(dropped):
            fail(f"parallel: {tag} dropped no entry at capacity factor {cf}")
        want_l = par_launches(flash_attention_wgmma=1,
                              fused_residual_rmsnorm=2,
                              ring_combine=(n - 1) + (dp - 1))
        for x in res:
            if x["launches"] != want_l:
                fail(f"parallel: {tag} rank at {x['coords']} launched "
                     f"{x['launches']}, not {want_l}")
        launches[tag] = {k: sum(x["launches"][k] for x in res)
                         for k in PAR_KERNELS}
        eps[tag] = dict(max_abs_err=max(errs), capacity=res[0]["capacity"],
                        capacity_factor=res[0]["capacity_factor"],
                        experts=res[0]["experts"],
                        expert_bytes=[x["expert_bytes"] for x in res],
                        walls_s=[x["wall_s"] for x in res],
                        local_walls_s=[o["wall_s"] for o in shards],
                        dropped_entries=dropped)
        log("parallel", f"{EP_ARCH} block through block_apply, B {EP_B} x S "
            f"{EP_S}, experts parallel on a (data {dp}, model {n}) mesh, "
            f"capacity factor {res[0]['capacity_factor']}: "
            f"{res[0]['experts']} experts a rank, "
            f"{res[0]['expert_bytes']} expert bytes a rank (local block "
            f"{oracle['expert_bytes']}), C {res[0]['capacity']}, entries "
            f"dropped {dropped} a data shard; the routing that each rank "
            f"computed and the union of the entries its dispatch kept "
            f"identical to the local block's on each data shard, y max abs "
            f"err {max(errs):.3e} (bf16 tolerance "
            f"{TOLS['bfloat16']}); wall {max(x['wall_s'] for x in res):.4f}"
            f" s (ranks {[round(x['wall_s'], 4) for x in res]}) against the "
            f"local block's {[round(o['wall_s'], 4) for o in shards]} s; "
            f"launches a rank {res[0]['launches']}, spans a rank "
            f"{[s[tag] for s in spans]}")
    # context parallelism
    cps = [r["cp"] for r in ranks]
    if not all(c["finite"] for c in cps):
        fail("parallel: the CP prefill's logits are not finite")
    if len({c["sha"] for c in cps}) != 1:
        fail("parallel: the CP ranks returned different logits")
    cp_err = scaled_err(from_bits(cps[0]["logits"]), oracle["cp"]["logits"],
                        SERVE_BF16_SCALED)
    cp_cfg = get_config(CP_ARCH)
    want_l = par_launches(fused_residual_rmsnorm=2 * cp_cfg.num_layers)
    s_loc = CP_S // CP_MESH[1]
    o_bytes = CP_B * CP_S * cp_cfg.num_heads * cp_cfg.head_dim * 2
    for c in cps:
        if c["launches"] != want_l:
            fail(f"parallel: cp rank at {c['coords']} launched "
                 f"{c['launches']}, not {want_l}")
        # what the rank's attention did: its own rows against every key,
        # at its offset, and one all-gather of them a layer
        want_c = [(s_loc, CP_S, c["coords"][1] * s_loc)] * cp_cfg.num_layers
        if c["calls"] != want_c:
            fail(f"parallel: cp rank at {c['coords']} called "
                 f"chunked_attention with (q rows, k rows, q_offset) "
                 f"{sorted(set(c['calls']))} x {len(c['calls'])}, not "
                 f"{want_c[0]} x {len(want_c)}")
        want_g = [(s_loc, o_bytes, CP_MESH[1])] * cp_cfg.num_layers
        if c["gathers"] != want_g:
            fail(f"parallel: cp rank at {c['coords']} ran all-gathers of "
                 f"(rows, result bytes, ranks) {sorted(set(c['gathers']))} "
                 f"x {len(c['gathers'])}, not {want_g[0]} x {len(want_g)}")
    launches["cp"] = {k: sum(c["launches"][k] for c in cps)
                      for k in PAR_KERNELS}
    cp = dict(max_scaled_err=cp_err, walls_s=[c["wall_s"] for c in cps],
              oracle_wall_s=oracle["cp"]["wall_s"],
              calls={str(c["coords"]): sorted(set(c["calls"])) for c in cps},
              gathers={str(c["coords"]): sorted(set(c["gathers"]))
                       for c in cps},
              launches_a_rank=cps[0]["launches"])
    seen = "; ".join(
        f"model rank {c['coords'][1]}: {len(c['calls'])} chunked_attention "
        f"calls of (q rows, k rows, q_offset) {sorted(set(c['calls']))}, "
        f"{len(c['gathers'])} ring all-gathers of (rows, result bytes, "
        f"ranks) {sorted(set(c['gathers']))}" for c in cps)
    log("parallel", f"{CP_ARCH} whole, prefill of B {CP_B} x S {CP_S} with "
        f"attn_impl=\"cp\" on a (data {CP_MESH[0]}, model {CP_MESH[1]}) "
        f"mesh, seen in each rank's attention: {seen}; logits max abs err "
        f"{cp_err:.3e} of their largest magnitude against the one-process "
        f"prefill (the flash kernel; criterion <= {SERVE_BF16_SCALED}); "
        f"wall {max(cp['walls_s']):.3f} s (ranks "
        f"{[round(w, 3) for w in cp['walls_s']]}) against "
        f"{cp['oracle_wall_s']:.3f} s in one process; launches a rank "
        f"{cps[0]['launches']}, spans a rank {[s['cp'] for s in spans]}")
    bwd = parallel_backward_checks(ranks, spans, launches)
    for r, s in enumerate(spans):
        for tag, c in s.items():
            want_s = dict(zip(PAR_SPANS, (ranks[r][tag]["launches"][k]
                                          for k in PAR_KERNELS)))
            if c != want_s:
                fail(f"parallel: rank {r}'s trace of {tag} has spans {c}, "
                     f"not {want_s}")
    mesh = mesh_checks([r["mesh"] for r in ranks], PAR_DIR)
    launches.update(mesh["launches"])
    wall = time.perf_counter() - t_phase
    log("parallel", f"phase wall {wall:.1f} s (oracles {oracle_wall:.1f} s, "
        f"4 spawned ranks {ranks_wall:.1f} s, CUDA start-up included, of "
        f"which the mesh step's path {mesh['wall_s']:.1f} s)")
    return dict(pipeline=dict(walls_s=[p["wall_s"] for p in pipes],
                              sequential_wall_s=oracle["pipeline"]["wall_s"],
                              bubble_share=bubble,
                              tick_bytes=pipes[0]["tick_bytes"],
                              resident_bytes=[p["resident_bytes"]
                                              for p in pipes],
                              oracle_weight_bytes=oracle["pipeline"][
                                  "weight_bytes"]),
                ep=eps, cp=cp, backward=bwd, mesh=mesh, launches=launches,
                spans=spans,
                wall_s=wall, oracle_wall_s=oracle_wall,
                ranks_wall_s=ranks_wall)


def parallel_backward_checks(ranks: list, spans: list,
                             launches: dict) -> dict:
    """The parallel phase's backward paths against their oracles, each
    computed on its rank in turn: the pipeline's gradients equal
    (``torch.equal``) to the blocks' in order on every stage, the EP
    block's within the bf16 tolerance of the local block's on each of
    ``EP_CASES``, the CP model's within ``SERVE_BF16_SCALED`` of each
    gradient's largest magnitude in the one-process model (the flash
    kernel); each path's launches a rank (``launches`` gains each path's
    sum over the ranks).  Returns the summaries."""
    from repro_torch.configs import get_config

    def off(report: dict, bad) -> str:
        return ", ".join(f"{k} (max abs err {g['max_abs_err']:.3e}, "
                         f"{g['outside_bf16']} outside bf16, scaled "
                         f"{g['scaled']:.3e})" for k, g in report.items()
                         if bad(g))

    def counted(tag: str, res: list, want_l: dict):
        for x in res:
            if x["launches"] != want_l:
                fail(f"parallel: {tag} rank at {x.get('coords')} launched "
                     f"{x['launches']}, not {want_l}")
        launches[tag] = {k: sum(x["launches"][k] for x in res)
                         for k in PAR_KERNELS}

    out = {}
    per_stage = get_config(PIPE_ARCH).num_layers // PIPE_STAGES
    pb = [r["pipeline bwd"] for r in ranks]
    for r, p in enumerate(pb):
        bad = off(p["grads"], lambda g: not (g["equal"] and g["finite"]))
        if bad:
            fail(f"parallel: pipeline backward, stage {r}: gradients not "
                 f"equal to the blocks' in order: {bad}")
    n_mb = PIPE_M * per_stage
    counted("pipeline bwd", pb, par_launches(
        flash_attention_wgmma=n_mb, fused_residual_rmsnorm=2 * n_mb,
        flash_attention_bwd_wgmma=n_mb, fused_residual_rmsnorm_bwd=2 * n_mb,
        ring_combine=3 * (PIPE_STAGES - 1)))
    out["pipeline"] = dict(
        walls_s=[p["wall_s"] for p in pb],
        oracle_turns_s=pb[0]["oracle_turns_s"],
        peak_bytes=[p["peak_bytes"] for p in pb],
        grad_bytes=[p["grad_bytes"] for p in pb],
        tensors=len(pb[0]["grads"]))
    log("parallel", f"{PIPE_ARCH} GPipe backward, {PIPE_STAGES} stages, M "
        f"{PIPE_M} (the forward with autograd's graph kept a tick, then the "
        f"reverse schedule's {PIPE_M + PIPE_STAGES - 1} ticks; the loss "
        f"seeded with 1/{PIPE_STAGES} on each stage, the microbatches' "
        f"gradient summed over the stages): each stage's "
        f"{len(pb[0]['grads']) - 1} parameter gradients and the "
        f"microbatches' equal (torch.equal) to the blocks' in order one "
        f"microbatch at a time; wall {max(out['pipeline']['walls_s']):.3f} "
        f"s (ranks {[round(w, 3) for w in out['pipeline']['walls_s']]}); "
        f"peak memory a rank {out['pipeline']['peak_bytes']} B; gradient "
        f"bytes a stage {out['pipeline']['grad_bytes']}; the oracles in "
        f"turns {pb[0]['oracle_turns_s']:.1f} s; launches a rank "
        f"{pb[0]['launches']}, spans a rank "
        f"{[s['pipeline bwd'] for s in spans]}")
    for tag, ((dp, n), cf) in EP_CASES.items():
        rb = [r[tag + " bwd"] for r in ranks]
        for x in rb:
            bad = off(x["grads"], lambda g: g["outside_bf16"]
                      or not g["finite"])
            if bad:
                fail(f"parallel: {tag} backward, rank at {x['coords']}: "
                     f"gradients outside the bf16 tolerance at their scale "
                     f"of the local block's: {bad}")
        summed = sum(size - 1 for _, sizes in rb[0]["sums"]
                     for size in sizes)
        counted(tag + " bwd", rb, par_launches(
            flash_attention_wgmma=1, fused_residual_rmsnorm=2,
            flash_attention_bwd_wgmma=1, fused_residual_rmsnorm_bwd=2,
            ring_combine=(n - 1) + (dp - 1) + (n - 1) + summed))
        grads = [g for x in rb for g in x["grads"].values()]
        out[tag] = dict(
            max_abs_err=max(g["max_abs_err"] for g in grads),
            max_scaled=max(g["scaled"] for g in grads),
            walls_s=[x["wall_s"] for x in rb],
            oracle_turns_s=rb[0]["oracle_turns_s"],
            tensors=len(rb[0]["grads"]))
        cf_txt = "the config's" if cf is None else cf
        log("parallel", f"{EP_ARCH} block backward on the (data {dp}, model "
            f"{n}) mesh, capacity factor {cf_txt}: the "
            f"shard's loss seeded with 1/{n}, each rank's "
            f"{len(rb[0]['grads'])} gradients (its experts', the router's, "
            f"attention's, the norms', h's and x's) summed over the axes "
            f"they are replicated on, within the bf16 tolerance at their "
            f"scale of the local block's (|d| <= 5e-2 max|want| + 5e-2 "
            f"|want|) on each data shard: max abs err "
            f"{out[tag]['max_abs_err']:.3e}, at most "
            f"{out[tag]['max_scaled']:.3e} of a gradient's largest "
            f"magnitude; wall {max(out[tag]['walls_s']):.4f} s (ranks "
            f"{[round(w, 4) for w in out[tag]['walls_s']]}); the oracles in "
            f"turns {rb[0]['oracle_turns_s']:.1f} s; launches a rank "
            f"{rb[0]['launches']}, spans a rank "
            f"{[s[tag + ' bwd'] for s in spans]}")
    cb = [r["cp bwd"] for r in ranks]
    for c in cb:
        bad = off(c["grads"], lambda g: g["scaled"] > SERVE_BF16_SCALED
                  or not g["finite"])
        if bad:
            fail(f"parallel: cp backward, rank at {c['coords']}: gradients "
                 f"past {SERVE_BF16_SCALED} of the one-process model's "
                 f"largest magnitude: {bad}")
    cfg = get_config(CP_ARCH)
    L, m = cfg.num_layers, CP_MESH[1]
    counted("cp bwd", cb, par_launches(
        fused_residual_rmsnorm=2 * L, fused_residual_rmsnorm_bwd=2 * L,
        ring_combine=(m - 1) * (L + cb[0]["params"])))
    worst = max((g["scaled"], k) for k, g in cb[0]["grads"].items())
    out["cp"] = dict(
        max_scaled=max(g["scaled"] for c in cb for g in c["grads"].values()),
        worst=worst[1], walls_s=[c["wall_s"] for c in cb],
        peak_bytes=[c["peak_bytes"] for c in cb],
        grad_bytes=cb[0]["grad_bytes"], params=cb[0]["params"],
        oracle_turns_s=cb[0]["oracle_turns_s"])
    log("parallel", f"{CP_ARCH} whole, backward of the mean cross-entropy "
        f"of B {CP_B} x S {CP_S} on seeded labels with attn_impl=\"cp\" on "
        f"the (data {CP_MESH[0]}, model {m}) mesh (the loss seeded with "
        f"1/{m}; each rank's rows' output gradient by the all-gather's "
        f"backward reduce-scatter, then all {cb[0]['params']} parameter "
        f"gradients, {cb[0]['grad_bytes']} bytes, summed over the model "
        f"ranks): each within {out['cp']['max_scaled']:.3e} of its largest "
        f"magnitude in the one-process model (the flash kernel; worst "
        f"{worst[1]}; criterion <= {SERVE_BF16_SCALED}); wall "
        f"{max(out['cp']['walls_s']):.3f} s (ranks "
        f"{[round(w, 3) for w in out['cp']['walls_s']]}); peak memory a rank "
        f"{out['cp']['peak_bytes']} B; the oracles in turns "
        f"{cb[0]['oracle_turns_s']:.1f} s; launches a rank "
        f"{cb[0]['launches']}, spans a rank {[s['cp bwd'] for s in spans]}")
    return out


# --------------------------------------------------------------------------- #
# phase 4f (end): the mesh training step, ZeRO-sharded AdamW over the ring
# --------------------------------------------------------------------------- #


def mesh_run_config(device):
    """llama3.2-1b whole under the reference's ``dryrun_policy`` (fp32
    parameters and moments, 4 microbatches, remat none), bf16 compute, B
    8 x S 512, a warm-up of 1 step: step 0 updates the moments at lr 0,
    step 1 the parameters at the peak."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import dryrun_policy
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train import RunConfig
    pol = dryrun_policy(MESH_ARCH)
    return RunConfig(model=get_config(MESH_ARCH), global_batch=MESH_B,
                     seq_len=MESH_S, num_microbatches=pol.microbatches,
                     steps=MESH_STEPS, warmup_steps=1,
                     opt=AdamWConfig(state_dtype=pol.opt_dtype),
                     param_dtype=pol.param_dtype, compute_dtype="bfloat16",
                     remat=pol.remat, grad_accum_dtype=pol.grad_accum_dtype,
                     device=str(device))


def mesh_batches(seed: int, device) -> list:
    """The global batches of the mesh steps, the same on every rank."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    rng = np.random.default_rng(seed + 8)
    V = get_config(MESH_ARCH).vocab_size
    return [{k: torch.as_tensor(rng.integers(0, V, (MESH_B, MESH_S)),
                                device=device) for k in ("tokens", "labels")}
            for _ in range(MESH_STEPS)]


def mesh_state_bytes(run) -> int:
    """(e): a rank's optimizer bytes under the reference's specs, counted
    here from ``opt_state_specs(..., stacked=True)`` on the meta model: for
    each reference leaf, ``local_shape`` of its stacked shape (a layer-axis
    block counts the layers the rank owns), m and v."""
    import numpy as np
    import torch
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import opt_state_specs
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.mesh import Mesh
    mesh = Mesh(MESH_SHAPE, ("data", "model"))
    cfg = run.model
    shapes = sh._shapes(build_model(cfg, device="meta"))
    raw = sh.param_specs(shapes, cfg, stacked=True)
    stacked = {n: sh.stack_dims(n, cfg) + s for n, s in shapes.items()}
    pspecs = {n: sh.sanitize_spec(raw[n], stacked[n], mesh) for n in shapes}
    ospecs = opt_state_specs(pspecs, shapes, mesh, run.opt, model_cfg=cfg,
                             stacked=True)["mu_nu"]
    size = torch.empty((), dtype=getattr(torch, run.opt.state_dtype)
                       ).element_size()
    seen, total = set(), 0
    for n in shapes:
        leaf = sh.ref_leaf(n)
        if leaf in seen:
            continue
        seen.add(leaf)
        total += 2 * size * int(np.prod(sh.local_shape(
            stacked[n], ospecs[n]["m"], mesh)))
    return total


def mesh_oracle(model, run, batches, zero, opt, coords) -> dict:
    """The one-process step on the global batches, on this rank's own
    model (whose parameters step 0 left as they were: lr 0): step 0's
    loss, grad_norm, gradient and moments, step 1's loss and grad_norm
    (its gradient, without an update), and the card's peak allocated
    bytes over the oracle (``peak_bytes``).  The gradient and
    moments are held against this rank's blocks of them, each leaf stacked
    in the reference's order and cut by its spec (``grad_report``: the bf16
    tolerance scaled by each tensor's largest magnitude)."""
    import torch
    from repro_torch.optim.adamw import adamw_init, adamw_update, global_norm
    from repro_torch.parallel import sharding as sh
    from repro_torch.runtime.train import make_train_step

    params = dict(model.named_parameters())
    par_peak(model.device, reset=True)
    seen = {}

    def capture(g, st, p, c, lr):
        seen["g"] = g
        return adamw_update(g, st, p, c, lr)

    def norm_only(g, st, p, c, lr):
        return p, st, {"grad_norm": global_norm(g.values())}

    state = adamw_init(params, run.opt)
    step0 = make_train_step(model, run, update=capture)
    state, m0 = step0(state, batches[0], 0)
    out = dict(loss=[float(m0["loss"])], grad_norm=[float(m0["grad_norm"])])

    def stacked(leaf, get):
        t = torch.stack([get(n) for n in leaf.names])
        return sh.shard(t.reshape(leaf.shape), leaf.spec, zero.mesh, coords)

    grads, moments = {}, {}
    for leaf in zero.leaves:
        grads[leaf.name] = grad_report(
            zero.grads[leaf.name], stacked(leaf, lambda n: seen["g"][n]))
        for k in ("m", "v"):
            moments[f"{leaf.name}/{k}"] = grad_report(
                opt["mu_nu"][leaf.name][k],
                stacked(leaf, lambda n: state["mu_nu"][n][k]))
    del seen["g"], state
    torch.cuda.empty_cache()
    _, m1 = make_train_step(model, run, update=norm_only)(
        None, batches[1], 1)
    out["loss"].append(float(m1["loss"]))
    out["grad_norm"].append(float(m1["grad_norm"]))
    return dict(out, grads=grads, moments=moments,
                peak_bytes=par_peak(model.device))


def mesh_update_check(zero, opt, params, state0, blocks0, count0,
                      lr) -> dict:
    """(c): step 1's update against ``adamw_update`` applied to the mesh's
    own step-1 gradient blocks (``zero.grads``), from this rank's host
    copies of its step-0 moments and parameter blocks (``state0``,
    ``blocks0``), with the clip of the norm of the whole step-1 gradient
    (its blocks' squares summed over the world in float64, each block's
    once), a leaf at a time on the card.  Returns each tensor's max |got -
    want| over its max |want|."""
    import torch
    import torch.distributed as dist
    from repro_torch.optim.adamw import adamw_update
    from repro_torch.parallel.sharding import replicas
    sq = 0.0
    for leaf in zero.leaves:
        sq += float(torch.sum(torch.square(zero.grads[leaf.name].double()))
                    ) / replicas(leaf.spec, zero.mesh)
    total = torch.tensor([sq], dtype=torch.float64)
    dist.all_reduce(total)
    dev = count0.device
    gnorm = torch.tensor(float(total[0]) ** 0.5, dtype=torch.float32,
                         device=dev)

    def rel(got, w):
        return float((got.float() - w.float()).abs().max()
                     / w.float().abs().max().clamp_min(1e-30))
    out = {}
    for leaf in zero.leaves:
        k = leaf.name
        want_p = {k: blocks0[k].to(dev)}
        want_s = {k: {f: t.to(dev) for f, t in state0[k].items()}}
        adamw_update({k: zero.grads[k]}, {"mu_nu": want_s,
                                          "count": count0.clone()},
                     want_p, zero.cfg, lr, gnorm=gnorm)
        out[f"{k}/param"] = rel(zero.param_block(leaf, params), want_p[k])
        for f in ("m", "v"):
            out[f"{k}/{f}"] = rel(opt["mu_nu"][k][f], want_s[k][f])
    return out


def mesh_rank(ctx, seed: int) -> dict:
    """One rank of the mesh step: llama3.2-1b whole on a (data 2, model 2)
    mesh, ``make_train_step(model, cfg, mesh=)`` for ``MESH_STEPS`` steps
    on the same global batches on every rank, each in a daemon step of its
    own (``PAR_STEPS``) with a ``train_step_exec`` span, the kernels'
    counts set to 0 just before and read just after; between them the
    one-process oracle on this rank in turn (``mesh_oracle``) and the
    copies that step 1's update is held to (``mesh_update_check``)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.events import EventKind
    from repro_torch.models.registry import build_model
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.runtime.train import make_train_step

    t_body = time.perf_counter()
    dev, daemon = ctx.device, ctx.daemon
    w = torch.ones(1, device=dev, requires_grad=True)
    torch.autograd.grad(w * 2, w, torch.ones_like(w))
    mesh = make_mesh(MESH_SHAPE, ("data", "model"))
    coords = mesh.coords(ctx.rank)
    run = mesh_run_config(dev)
    cfg = run.model
    model = build_model(cfg, run.policy(), dev, run.remat, mesh=mesh)
    model.init(torch.Generator(device=dev).manual_seed(seed + 7))
    params = dict(model.named_parameters())
    step_fn = make_train_step(model, run, mesh=mesh)
    zero = step_fn.zero
    norm = zero.global_norm

    def keep(blocks):                # each update's gradient blocks
        zero.grads = blocks
        return norm(blocks)
    zero.global_norm = keep
    opt = zero.init()
    batches = mesh_batches(seed, dev)
    rows = MESH_B // MESH_SHAPE[0]
    flops = 6.0 * cfg.active_param_count() * rows * MESH_S
    transfer = coll._transfer
    gloo = {"s": 0.0}

    def timed(*args, **kwargs):      # the ring's messages through gloo
        t0 = time.perf_counter()
        try:
            return transfer(*args, **kwargs)
        finally:
            gloo["s"] += time.perf_counter() - t0

    steps = []

    def one(s: int):
        nonlocal opt
        tag = MESH_TAGS[s]
        par_sync(dev)
        dist.barrier()
        daemon.step_begin(PAR_STEPS[tag])
        daemon.set_stack([f"step_{PAR_STEPS[tag]}", "train_step"])
        par_counts(reset=True)
        par_peak(dev, reset=True)
        gloo["s"] = 0.0
        coll._transfer = timed
        try:
            t0 = time.perf_counter()
            opt, m = step_fn(opt, batches[s], s)
            loss = float(m["loss"])               # sync point
            t_done = time.perf_counter()
        finally:
            coll._transfer = transfer
        daemon.record_span(EventKind.KERNEL_COMPUTE, "train_step_exec", t0,
                           t_done, flops=flops)
        counts = par_counts()
        peak = par_peak(dev)
        daemon.step_end(tokens=rows * MESH_S, loss=loss)
        steps.append(dict(wall_s=t_done - t0, gloo_s=gloo["s"],
                          loss=loss, grad_norm=float(m["grad_norm"]),
                          lr=float(m["lr"]), launches=counts,
                          peak_bytes=peak))
        return m

    one(0)
    resident = zero.resident_bytes(opt)
    torch.cuda.empty_cache()        # every rank's, before the oracles
    t0 = time.perf_counter()
    oracle = rank_turns(lambda: mesh_oracle(model, run, batches, zero, opt,
                                            coords),
                        daemon, PAR_ORACLE_STEP + PAR_STEPS[MESH_TAGS[0]])
    oracle_s = time.perf_counter() - t0
    # step 1's inputs, kept in host memory for (c): the moments, the
    # parameter blocks
    state0 = {k: {f: t.to("cpu", copy=True) for f, t in v.items()}
              for k, v in opt["mu_nu"].items()}
    blocks0 = {leaf.name: zero.param_block(leaf, params).to("cpu",
                                                            copy=True)
               for leaf in zero.leaves}
    count0 = opt["count"].clone()
    zero.grads = None
    torch.cuda.empty_cache()
    m1 = one(1)
    update = mesh_update_check(zero, opt, params, state0, blocks0, count0,
                               m1["lr"])
    del state0, blocks0
    # the combines a step: each leaf's reduce-scatter, its sum over the
    # axes its moments are replicated on, the norm's sums, the loss's mean
    ring = sum(sum(mesh.shape[a] - 1 for a in sh_axes(leaf.rel, mesh))
               + sum(n - 1 for a, n in mesh.shape.items()
                     if a not in sh_axes(leaf.spec, mesh))
               for leaf in zero.leaves)
    ring += sum(sum(mesh.shape[a] - 1 for a in axes)
                for axes in {leaf.sharded for leaf in zero.leaves})
    ring += MESH_SHAPE[0] - 1                      # the loss's mean
    out = dict(coords=coords, steps=steps, oracle=oracle,
               oracle_turns_s=oracle_s, update=update,
               resident_bytes=resident,
               resident_end=zero.resident_bytes(opt),
               ring_combines=ring, leaves=len(zero.leaves),
               on_stack=sorted(leaf.name for leaf in zero.leaves
                               if len(leaf.stack) and leaf.spec[0]),
               finite=all(bool(p.isfinite().all()) for p in params.values()))
    del model, params, opt, zero, step_fn
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_body
    return out


def sh_axes(spec, mesh) -> list:
    """The axes of ``mesh`` of more than one rank that ``spec`` names, in
    its order."""
    return [a for e in spec if e is not None
            for a in (e if isinstance(e, tuple) else (e,))
            if mesh.shape[a] > 1]


def mesh_phase(seed: int, device: str = "cuda") -> dict:
    """The mesh training step alone (``tools/parallel_check.py --only
    mesh``; ``parallel_phase`` runs ``mesh_rank`` on its own ranks, after
    the other paths): llama3.2-1b at full width on a
    (data 2, model 2) mesh of 4 gloo ranks on cuda:0, 2 steps of
    ``make_train_step(model, cfg, mesh=)`` (ZeRO-sharded AdamW over the
    ring, ``optim/zero.py``), each rank traced by its own daemon.  Checks
    (a) step 0's gradient blocks against the one-process step's gradient
    and (b) the moments after step 0 against its moments, at the bf16
    tolerance scaled by each tensor's largest magnitude (``grad_report``);
    (c) step 1's parameters and moments within ``MESH_UPDATE_REL`` of
    ``adamw_update`` from the mesh's own step-1 gradient and step-0 state;
    (d) each step's loss and grad_norm within ``MESH_LOSS_REL`` of the
    oracle's; (e) each rank's resident optimizer bytes equal to the
    reference specs' count (``mesh_state_bytes``); (f) every rank's
    launches of the five kernels, none 0, and its trace: a
    ``train_step_exec`` span in each mesh step and every kernel span
    nested in its step.  A failing check fails the phase.  Returns the
    readings, ``launches`` by ``PAR_STEPS`` tag summed over the ranks."""
    from repro_torch.launch.mesh import run_ranks

    MESH_DIR.mkdir(parents=True, exist_ok=True)
    for old in MESH_DIR.glob("rank*.jsonl"):
        old.unlink()
    ranks = run_ranks(mesh_rank, PAR_WORLD, seed, device=device,
                      timeout=600.0, log_dir=str(MESH_DIR))
    return mesh_checks(ranks, MESH_DIR)


def mesh_checks(ranks: list, log_dir) -> dict:
    """``mesh_phase``'s checks of the ranks' ``mesh_rank`` results and of
    their traces (``log_dir/rank{r}.jsonl``)."""
    from repro_torch.core.events import load_jsonl

    run = mesh_run_config("cpu")
    want_bytes = mesh_state_bytes(run)
    L, M = run.model.num_layers, run.num_microbatches
    bad = []
    for r, x in enumerate(ranks):
        where = f"mesh rank {r} at {x['coords']}"
        if not x["finite"]:
            fail(f"parallel: {where}: parameters not finite")
        for k, g in {**x["oracle"]["grads"],
                     **x["oracle"]["moments"]}.items():
            if g["outside_bf16"] or not g["finite"]:
                bad.append(f"{where} {k} ({g['outside_bf16']} outside, "
                           f"scaled {g['scaled']:.3e})")
        for k, e in x["update"].items():
            if not e <= MESH_UPDATE_REL:
                bad.append(f"{where} step 1 update {k} {e:.3e}")
        for s, st in enumerate(x["steps"]):
            for key in ("loss", "grad_norm"):
                want = x["oracle"][key][s]
                if not abs(st[key] - want) <= MESH_LOSS_REL * abs(want):
                    bad.append(f"{where} step {s} {key} {st[key]} against "
                               f"the oracle's {want}")
            want_l = par_launches(
                flash_attention_wgmma=M * L, fused_residual_rmsnorm=2 * M * L,
                flash_attention_bwd_wgmma=M * L,
                fused_residual_rmsnorm_bwd=2 * M * L,
                ring_combine=x["ring_combines"])
            if st["launches"] != want_l or not all(want_l.values()):
                bad.append(f"{where} step {s} launched {st['launches']}, "
                           f"not {want_l}")
        if not x["resident_bytes"] == x["resident_end"] == want_bytes:
            bad.append(f"{where} holds {x['resident_bytes']} / "
                       f"{x['resident_end']} optimizer bytes, not the "
                       f"specs' {want_bytes}")
        evs = load_jsonl(str(Path(log_dir) / f"rank{r}.jsonl"))
        for tag in MESH_TAGS:
            step = PAR_STEPS[tag]
            mine = [e for e in evs if e.step == step]
            execs = [e for e in mine if e.name == "train_step_exec"]
            if len(execs) != 1:
                bad.append(f"{where} {tag}: {len(execs)} train_step_exec "
                           f"spans")
            s = MESH_TAGS.index(tag)
            for name, label in zip(PAR_SPANS, PAR_KERNELS):
                spans = [e for e in mine if e.name == name]
                if len(spans) != x["steps"][s]["launches"][label]:
                    bad.append(f"{where} {tag}: {len(spans)} {name} spans, "
                               f"{x['steps'][s]['launches'][label]} "
                               f"launches")
                if any(e.duration <= 0 or e.issue_latency < 0
                       or e.meta.get("parent") != f"step_{step}"
                       for e in spans):
                    bad.append(f"{where} {tag}: a {name} span without a "
                               f"device duration or outside its step")
    if bad:
        fail("parallel: mesh step: " + "; ".join(bad[:8]))
    steps = [[x["steps"][s] for x in ranks] for s in range(MESH_STEPS)]
    worst = max((g["scaled"], k) for x in ranks
                for k, g in x["oracle"]["grads"].items())
    worst_m = max((g["scaled"], k) for x in ranks
                  for k, g in x["oracle"]["moments"].items())
    worst_u = max((e, k) for x in ranks for k, e in x["update"].items())
    out = dict(
        walls_s=[[st["wall_s"] for st in s] for s in steps],
        gloo_s=[[st["gloo_s"] for st in s] for s in steps],
        peak_bytes=[[st["peak_bytes"] for st in s] for s in steps],
        loss=[s[0]["loss"] for s in steps],
        grad_norm=[s[0]["grad_norm"] for s in steps],
        oracle_loss=ranks[0]["oracle"]["loss"],
        oracle_grad_norm=ranks[0]["oracle"]["grad_norm"],
        grad_scaled=worst[0], grad_worst=worst[1],
        moment_scaled=worst_m[0], moment_worst=worst_m[1],
        update_rel=worst_u[0], update_worst=worst_u[1],
        resident_bytes=[x["resident_bytes"] for x in ranks],
        spec_bytes=want_bytes, on_stack=ranks[0]["on_stack"],
        launches={tag: {k: sum(st["launches"][k] for st in steps[i])
                        for k in PAR_KERNELS}
                  for i, tag in enumerate(MESH_TAGS)},
        oracle_turns_s=ranks[0]["oracle_turns_s"],
        oracle_peak_bytes=[x["oracle"]["peak_bytes"] for x in ranks],
        wall_s=max(x["wall_s"] for x in ranks))
    for s in range(MESH_STEPS):
        log("parallel", f"{MESH_ARCH} whole, mesh step {s} on a (data "
            f"{MESH_SHAPE[0]}, model {MESH_SHAPE[1]}) mesh, B {MESH_B} x S "
            f"{MESH_S}, M {M}, fp32 parameters and moments ZeRO-sharded: "
            f"loss {out['loss'][s]:.6f} (oracle {out['oracle_loss'][s]:.6f}),"
            f" grad_norm {out['grad_norm'][s]:.6f} (oracle "
            f"{out['oracle_grad_norm'][s]:.6f}), lr {steps[s][0]['lr']:.3e};"
            f" wall {max(out['walls_s'][s]):.3f} s (ranks "
            f"{[round(w, 3) for w in out['walls_s'][s]]}), of it in gloo "
            f"transfers {[round(g, 3) for g in out['gloo_s'][s]]} s; peak "
            f"memory a rank {out['peak_bytes'][s]} B; launches a rank "
            f"{steps[s][0]['launches']}")
    log("parallel", f"{MESH_ARCH} mesh step against the one-process step "
        f"(the oracles in turns {out['oracle_turns_s']:.1f} s, peak memory "
        f"a rank in its turn {out['oracle_peak_bytes']} B): step 0's "
        f"gradient blocks within {out['grad_scaled']:.3e} of each tensor's "
        f"largest magnitude (worst {out['grad_worst']}), the moments after "
        f"it within {out['moment_scaled']:.3e} (worst "
        f"{out['moment_worst']}), 0 outside the bf16 tolerance at their "
        f"scale; step 1's update within {out['update_rel']:.3e} relative "
        f"of adamw_update's (worst {out['update_worst']}; criterion <= "
        f"{MESH_UPDATE_REL}); resident optimizer bytes a rank "
        f"{out['resident_bytes']} = the specs' {want_bytes} (data on the "
        f"layer axis of {len(out['on_stack'])} leaves); the path's part "
        f"of the ranks' wall {out['wall_s']:.1f} s")
    return out


# --------------------------------------------------------------------------- #
# phase 5: serve
# --------------------------------------------------------------------------- #
def forward_launches(cfg) -> dict:
    """The port's kernel launches of one full-sequence forward of ``cfg``'s
    model, by traced-op name: the dense, moe and audio families' flash and
    2 fused norms a layer (the moe family's dispatch and expert products
    launch none of the port's kernels); the vlm family's flash a self-attention layer and
    2 fused norms a layer, its cross layers (``direct_attention``) included
    (llama-3.2-vision-11b: 32 and 80); the ssm family's SSD scan and 1
    fused norm a layer, the hybrid's SSD scan and 1 fused norm a Mamba
    layer, and flash and 2 fused norms an application of its shared block
    (zamba2-2.7b: 54, 9 and 72).  A decode step launches the fused norms
    alone."""
    L = cfg.num_layers
    if cfg.family in ("dense", "moe", "audio"):
        return {"flash_attention": L, "fused_residual_rmsnorm": 2 * L}
    if cfg.family == "vlm":
        return {"flash_attention": cfg.n_self,
                "fused_residual_rmsnorm": 2 * L}
    if cfg.family == "ssm":
        return {"ssd_scan": L, "fused_residual_rmsnorm": L}
    if cfg.family == "hybrid":
        g = L // cfg.attn_every
        return {"ssd_scan": L, "flash_attention": g,
                "fused_residual_rmsnorm": L + 2 * g}
    raise KeyError(cfg.family)


def path_kernels(arch: str) -> dict:
    """The kernels a serving path can launch, by label (the traced-op name,
    with the route for a kernel of two routes), as (traced-op name, route,
    kernel, launches of one bf16 generate of ``new`` tokens by ``cfg``'s
    model).  bf16 serving takes no fp32 route (tf32x3)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.fused_norm import ops as fn
    from repro_torch.kernels.ssd_scan import ops as ssd
    routed = {"flash_attention": fa.KERNELS, "ssd_scan": ssd.KERNELS}
    kernels = {}
    for op in forward_launches(get_config(arch)):
        if op not in routed:
            kernels[op] = (op, None, fn.KERNEL, lambda cfg, new, op=op:
                           forward_launches(cfg)[op] * (1 + new))
            continue
        for route, k in routed[op].items():
            kernels[f"{op}[{route}]"] = (
                op, route, k, lambda cfg, new, op=op, route=route:
                forward_launches(cfg)[op] if route == "wgmma" else 0)
    return kernels


# the vlm paths' cross-layer gates: the JAX init sets them to 0, which
# closes every cross layer (tanh(0) = 0), so a wrong cross path would pass
# every check; the serve and agreement runs open them after init
VLM_GATE = 0.5


def open_gates(model) -> int:
    """Sets every cross layer's ``attn.gate`` and ``gate_mlp`` to
    ``VLM_GATE``; returns the number of cross layers (0 but for the vlm
    family)."""
    import torch
    cross = getattr(model, "cross", ())
    with torch.no_grad():
        for c in cross:
            c.attn.gate.fill_(VLM_GATE)
            c.gate_mlp.fill_(VLM_GATE)
    return len(cross)


def vision_embeds(cfg, batch: int, seed: int, device, dtype):
    """A vlm path's vision embeddings [batch, vision_tokens, vision_d], a
    normal draw from ``seed`` (the frontend is a stub); None for the other
    families."""
    import torch
    if cfg.family != "vlm":
        return None
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(batch, cfg.vision_tokens, cfg.vision_d, generator=gen,
                       device=device).to(dtype)


VLM_LONG_S = 4096     # the vlm's long prompt: S·T = 4096 · 1600 > 2^22


def vlm_long_prefill(model, cfg, seed: int) -> dict:
    """The vlm path's prefill of one prompt of ``VLM_LONG_S`` tokens: S·T
    above 2^22, so its cross layers take ``chunked_attention``
    (``transformer.cross_impl``), seen by a spy that keeps the first cross
    layer's q, k and v; ``chunked_attention`` and ``direct_attention``
    agree on them within the bf16 serving criterion (``scaled_err`` at
    ``SERVE_BF16_SCALED`` of direct's largest magnitude; direct's fp32
    scores [1, KV, G, S, T], 0.84 GB at the published widths); the logits
    finite."""
    import numpy as np
    import torch
    from repro_torch.models import attention as attn_lib
    from repro_torch.models.transformer import cross_impl

    T = cfg.vision_tokens
    route = cross_impl(VLM_LONG_S, T)
    if route != "chunked":
        fail(f"vlm long prefill: S {VLM_LONG_S} x T {T} routes the cross "
             f"layers to {route}")
    seen, real = [], attn_lib.chunked_attention

    def spy(q, k, v, *a, **kw):
        if k.shape[1] == T and not seen:
            seen.append((q.clone(), k.clone(), v.clone()))
        return real(q, k, v, *a, **kw)

    toks = torch.as_tensor(np.random.default_rng(seed + 5).integers(
        0, cfg.vocab_size, (1, VLM_LONG_S)), device="cuda")
    vis = vision_embeds(cfg, 1, seed + 5, "cuda", torch.bfloat16)
    attn_lib.chunked_attention = spy
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = model.prefill(toks, model.init_cache(1, VLM_LONG_S), vis)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        attn_lib.chunked_attention = real
    if not seen:
        fail("vlm long prefill: no cross layer took chunked_attention")
    if not bool(logits.isfinite().all()):
        fail("vlm long prefill: logits are not finite")
    q, k, v = seen[0]
    with torch.no_grad():
        got = attn_lib.chunked_attention(q, k, v, causal=False)
        want = attn_lib.direct_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    rel = scaled_err(got, want, SERVE_BF16_SCALED)
    err = float((got.float() - want.float()).abs().max())
    res = dict(S=VLM_LONG_S, T=T, route=route, wall_s=wall,
               cross_calls=len(seen), max_abs_err=err, max_scaled_err=rel,
               want_max_abs=float(want.float().abs().max()),
               direct_scores_bytes=4 * q.shape[2] * VLM_LONG_S * T)
    log("serve", f"{cfg.name}{describe_cut(dict(num_layers=cfg.num_layers))}"
        f" long prefill B1 S{VLM_LONG_S} x {T} vision tokens "
        f"(S·T {VLM_LONG_S * T} > 2^22): cross layers on {route}, prefill "
        f"wall {wall:.3f} s, logits finite; the first cross layer's q/k/v: "
        f"chunked against direct max abs err {err:.3e}, {rel:.3e} of "
        f"direct's largest magnitude {res['want_max_abs']:.3e} (criterion "
        f"<= {SERVE_BF16_SCALED}); direct's scores "
        f"{res['direct_scores_bytes'] / 1e9:.2f} GB)")
    del got, want, q, k, v, logits, seen
    torch.cuda.empty_cache()
    return res


def serve(arch: str, cut: dict, seed: int, trace_path: Path,
          per_call: bool = False, tap: "SpillTap | None" = None):
    """Server.generate at full width and the path's depth (``cut``:
    ``configs.scale`` overrides), batch 8, 1024-token prompts, 32 new
    tokens, daemon attached with a JSONL spill (backend ``<family>-serve``;
    given ``tap``, a daemon of the same backend in the server's place,
    spilling ``SERVE_SPILL`` to ``trace_path`` with ``tap``'s sinks added
    before it attaches); launch counts of that run (counts set to 0 just
    before it); then untraced and traced walls in turns (``per_call``: two
    of each, ABBA, the daemon's host cost per launch, and traced walls
    with each spill codec in turns; else one of each, for the run's
    time), and a profiler breakdown of a prefill and of a generate of
    ``PROFILE_NEW`` tokens.  A vlm
    path opens its gates (``open_gates``), takes seeded vision embeddings,
    shows that its prefill logits move when they change, and runs one
    prefill above S·T = 2^22 (``vlm_long_prefill``)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, scale
    from repro_torch.core.daemon import DaemonConfig, TracingDaemon
    from repro_torch.kernels.fused_norm import ops as fn
    from repro_torch.runtime.serve import ServeConfig, Server

    cfg = scale(get_config(arch), **cut)
    backend = f"{cfg.family}-serve"
    kernels = path_kernels(arch)
    B, S0, new = 8, 1024, 32
    torch.cuda.reset_peak_memory_stats()
    t_init = time.perf_counter()
    server = Server(ServeConfig(model=cfg, batch=B, max_seq=2048, seed=seed,
                                log_path=None if tap else str(trace_path)))
    init_s = time.perf_counter() - t_init
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(p.numel() for p in server.model.parameters())
    vis = vision_embeds(cfg, B, seed + 2, "cuda", torch.bfloat16)
    if open_gates(server.model):
        log("serve", f"{arch}: the {len(server.model.cross)} cross layers' "
            f"gate and gate_mlp set to {VLM_GATE} after init (the JAX "
            f"init's 0 closes them); vision embeddings "
            f"{list(vis.shape)} a normal draw from seed {seed + 2}")
    log("serve", f"{arch}{describe_cut(cut)}: {n_params} parameters (bf16) "
        f"drawn in "
        f"{init_s:.1f} s; {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated, peak {init_peak_gb:.2f} GB during the init")
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S0)).astype(np.int32)
    seen_backend = server.daemon.cfg.backend
    if seen_backend != backend:
        fail(f"{arch}: the server's daemon has backend {seen_backend}, not "
             f"{backend}")
    if tap is not None:
        server.close()
        server.daemon = tap.add_to(TracingDaemon(DaemonConfig(
            backend=backend, hang_timeout=300.0, log_path=str(trace_path),
            **SERVE_SPILL))).attach()
    spill = server.daemon
    torch.cuda.reset_peak_memory_stats()
    for _, _, k, _ in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    out = server.generate(prompts, new_tokens=new, vision_embeds=vis)
    wall = time.perf_counter() - t0
    launches = {label: k.launches for label, (_, _, k, _) in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    server.close()                      # detaches the daemon: final spill
    spill = dict(log_paths=spill.log_paths, bytes_logged=spill.bytes_logged)
    want = {label: n(cfg, new) for label, (_, _, _, n) in kernels.items()}
    log("serve", f"{arch} B{B} prompt {S0} new {new}: launches {launches} "
        f"(expected {want}); wall {wall:.3f} s; peak memory {peak_gb:.2f} "
        f"GB (torch.cuda.max_memory_allocated)")
    if launches != want:
        fail(f"{arch}: launch counts {launches} != {want}")
    if out.shape != (B, S0 + new) or not np.array_equal(out[:, :S0], prompts):
        fail(f"{arch}: generate returned {out.shape}, prompts not preserved")
    gen_toks = out[:, S0:]
    if gen_toks.min() < 0 or gen_toks.max() >= cfg.vocab_size:
        fail(f"{arch}: token outside [0, {cfg.vocab_size})")

    # steady state, and the daemon's cost: the same server untraced and
    # with a daemon of the served family attached again (no spill), in turns
    def timed_generate():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.generate(prompts, new_tokens=new, vision_embeds=vis)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    walls = {"untraced": [], "traced": []}
    for mode in ("untraced", "traced", "traced", "untraced")[
            :4 if per_call else 2]:
        if mode == "traced":
            server.daemon = TracingDaemon(DaemonConfig(
                backend=backend, hang_timeout=300.0)).attach()
        walls[mode].append(timed_generate())
        server.close()
    warm = min(walls["untraced"])
    log("serve", f"{arch} second and later runs, generate wall s: {walls}; "
        f"tracing costs {min(walls['traced']) / warm - 1:+.2%} (best of "
        f"{len(walls['traced'])} each)")
    spill_walls = None
    if per_call:
        # the traced generate with each spill codec (one file, no
        # rotation; FCS v2 with zlib), in turns
        spill_walls = {"jsonl": [], "fcs": [], "fcs2": []}
        for ext in ("jsonl", "fcs", "fcs2", "fcs2", "fcs", "jsonl"):
            path = OUT_DIR / f"serve_walls_{arch}.{ext}"
            path.unlink(missing_ok=True)
            server.daemon = TracingDaemon(DaemonConfig(
                backend=backend, hang_timeout=300.0, log_path=str(path),
                log_compression="zlib" if ext == "fcs2" else None)).attach()
            spill_walls[ext].append(timed_generate())
            server.close()
            path.unlink(missing_ok=True)
        log("serve", f"{arch} traced generate wall s by spill, in turns: "
            f"{spill_walls}")
    calls = None
    if per_call:
        # the same per launch: host time of one fused-norm call at the
        # decode shape, with and without a daemon attached, in turns
        x = torch.randn(B, cfg.d_model, device="cuda", dtype=torch.bfloat16)
        sc = torch.ones(cfg.d_model, device="cuda")
        calls = {"untraced": [], "traced": []}
        for mode in ("untraced", "traced", "traced", "untraced"):
            d = (TracingDaemon(DaemonConfig(backend=backend)).attach()
                 if mode == "traced" else None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                fn.fused_residual_rmsnorm(x, x, sc)
            torch.cuda.synchronize()
            calls[mode].append((time.perf_counter() - t0) / 2000 * 1e6)
            if d:
                d.detach()
        log("serve", f"fused_residual_rmsnorm call at R{B}, host us per "
            f"call (2000 calls): {calls}")
    t_prof = time.perf_counter()
    prof = {"prefill": profile(lambda: server.generate(prompts, 0, vis)),
            "generate": profile(lambda: server.generate(prompts, PROFILE_NEW,
                                                        vis))}
    log("profile", f"{arch}: the two profiles took "
        f"{time.perf_counter() - t_prof:.1f} s")
    for part, p in prof.items():
        log("profile", f"{arch} {part}: wall {p['wall_s'] * 1e3:.3f} ms, "
            f"device busy {p['device_s'] * 1e3:.3f} ms, idle share "
            f"{p['idle_share']}")
        for k in p["top"]:
            log("profile", f"  {k['ms']:10.3f} ms {k['count']:6d}x "
                f"{k['name']}")
    moved = None
    if vis is not None:
        # the prefill logits with other vision embeddings
        other = vision_embeds(cfg, B, seed + 3, "cuda", torch.bfloat16)
        toks = torch.as_tensor(prompts, dtype=torch.long, device="cuda")
        la, lb = (server.model.prefill(toks, server.model.init_cache(B, S0),
                                       v).float() for v in (vis, other))
        moved = dict(max_abs_diff=float((la - lb).abs().max()),
                     max_abs=float(la.abs().max()),
                     argmax_changed=float(
                         (la.argmax(-1) != lb.argmax(-1)).float().mean()))
        log("serve", f"{arch}: prefill logits with another draw of vision "
            f"embeddings: max abs difference {moved['max_abs_diff']:.3e} "
            f"(|logits| max {moved['max_abs']:.2f}); argmax changed in "
            f"{moved['argmax_changed']:.3f} of the rows")
        if not moved["max_abs_diff"] > 1e-2 * moved["max_abs"]:
            fail(f"{arch}: the logits do not follow the vision embeddings")
        del la, lb, other
        torch.cuda.empty_cache()
        moved["long_prefill"] = vlm_long_prefill(server.model, cfg, seed)
    del server
    torch.cuda.empty_cache()
    return dict(arch=arch, cut=cut, layers=cfg.num_layers, B=B, S0=S0,
                new=new, launches=launches,
                wall_s=wall, warm_wall_s=warm, walls=walls,
                spill_walls=spill_walls, spill=spill, per_call_us=calls,
                profile=prof, backend=seen_backend,
                n_params=n_params, init_s=init_s, init_peak_gb=init_peak_gb,
                peak_memory_gb=peak_gb, vision_moved=moved)


# new tokens of the profiled generate: the profiler's processing grows with
# the events it records, and at 32 tokens llama-20b-paper's 62 layers of
# eager decode took ~90 s of the run's time
PROFILE_NEW = 8


# the port's own kernels, by a part of their device function names
PORT_KERNELS = ("flash_wgmma_kernel", "flash_tf32_kernel", "split_kernel",
                "dkdv_kernel", "dq_kernel", "delta_kernel",
                "fused_residual_rmsnorm_kernel", "rows_kernel",
                "wide_rows_kernel", "reduce_kernel", "ssd_wgmma_kernel",
                "ssd_tf32_kernel",
                "ssd_bwd_state_kernel", "ssd_bwd_dxdb_kernel",
                "ssd_bwd_dc_kernel", "ssd_bwd_tf32_state_kernel",
                "ssd_bwd_tf32_dxdb_kernel", "ssd_bwd_tf32_dc_kernel",
                "ssd_bwd_finish_kernel", "ssd_bwd_sum_kernel",
                "matmul_wgmma_kernel", "matmul_tf32_kernel",
                "split_transposed_kernel", "split_rows_kernel",
                "ring_combine_kernel")


def profile(fn, top: int = 10) -> dict:
    """Device kernel time under torch.profiler beside the host wall time of
    one call; idle share = 1 - device busy / wall ("not measured" if the
    profiler saw no device time).  Besides the ``top`` kernels, every
    kernel of the port (``PORT_KERNELS``) with its time."""
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
        kernels.append(dict(name=item.key[:120], count=item.count,
                            ms=us / 1e3))
    kernels.sort(key=lambda k: -k["ms"])
    busy = sum(k["ms"] for k in kernels) / 1e3
    return dict(wall_s=wall, device_s=busy,
                idle_share=(1 - busy / wall) if busy > 0 else "not measured",
                top=kernels[:top],
                port=[k for k in kernels if "at::native" not in k["name"]
                      and any(f"{ns}::{n}" in k["name"] for n in PORT_KERNELS
                              for ns in ("(anonymous namespace)",
                                         "flare::tf32x3"))])


def agreement(arch: str, seed: int, S: int, cut: dict, cfg=None):
    """fp32 prefill logits of the full-width model cut by ``cut``
    (``configs.scale`` overrides): the kernel path on the card against the
    plain path on the CPU, same weights (drawn on the card, copied to the
    CPU), B 1; a vlm path with its gates open and seeded vision
    embeddings.  The fp32 run takes every kernel of the path but the bf16
    ones (flash and the SSD scan their split-TF32 routes).  A moe path
    first reports the tokens whose routing (expert ids or kept entries)
    differs between the two runs, with the top-k margins
    (``RoutingLog``).  Returns the max abs error, the launches of the
    card's prefill and the routing report (None but for the moe
    family).  ``cfg``, given, is the model instead (a reduced config).
    """
    import numpy as np
    import torch
    from repro_torch.configs import get_config, scale
    from repro_torch.models.layers import Policy
    from repro_torch.models.registry import build_model

    cfg = cfg or scale(get_config(arch), **cut)
    kernels = {label: (op, route, k)
               for label, (op, route, k, _) in path_kernels(arch).items()}
    # an fp32 prefill: each routed op on tf32x3 as often as a forward runs
    # it, none on wgmma; the fused norm as a forward runs it
    per_fwd = forward_launches(cfg)
    want_launches = {label: 0 if route == "wgmma" else per_fwd[op]
                     for label, (op, route, _) in kernels.items()}
    pol = Policy(torch.float32)
    gpu = build_model(cfg, pol, "cuda").init(
        torch.Generator(device="cuda").manual_seed(seed))
    open_gates(gpu)
    cpu = build_model(cfg, pol, "cpu").load_params(gpu.state_dict())
    toks = np.random.default_rng(seed + 1).integers(0, cfg.vocab_size, (1, S))
    t = torch.as_tensor(toks, dtype=torch.long)
    vis = vision_embeds(cfg, 1, seed + 4, "cpu", torch.float32)
    kw_cpu = {} if vis is None else {"vision_embeds": vis}
    kw_gpu = {} if vis is None else {"vision_embeds": vis.cuda()}
    n0 = {label: k.launches for label, (_, _, k) in kernels.items()}
    with RoutingLog() as card_routes:
        got = gpu.prefill(t.cuda(), gpu.init_cache(1, S), **kw_gpu).cpu()
    launches = {label: k.launches - n0[label]
                for label, (_, _, k) in kernels.items()}
    if launches != want_launches:
        fail(f"{arch}: the fp32 agreement run launched {launches}, not "
             f"{want_launches}: each op of the path on its fp32 route "
             f"(tf32x3) as often as a forward runs it, none on wgmma")
    with RoutingLog() as cpu_routes:
        want = cpu.prefill(t, cpu.init_cache(1, S), **kw_cpu)
    routing = routing_report(arch, "fp32 prefill", card_routes, cpu_routes)
    diff = (got - want).abs()
    err = float(diff.max())
    # the JAX package's model tests hold fp32 logits to rtol = atol = 2e-3
    ok = bool((diff <= 2e-3 + 2e-3 * want.abs()).all())
    same_argmax = bool((got.argmax(-1) == want.argmax(-1)).all())
    gates = (f", gates {VLM_GATE}, seeded vision embeddings"
             if vis is not None else "")
    log("serve", f"{arch}{describe_cut(cut)} fp32 prefill logits B1 S{S}"
        f"{gates}, card "
        f"kernels vs CPU plain: max_abs_err {err:.3e} (|logits| max "
        f"{float(want.abs().max()):.2f}, rtol = atol = 2e-3: {ok}); argmax "
        f"equal: {same_argmax}")
    if not (ok and same_argmax):
        fail(f"{arch}: fp32 prefill logits disagree between card and CPU")
    del gpu, cpu
    torch.cuda.empty_cache()
    return err, launches, routing


def describe_cut(cut: dict) -> str:
    """A path's cut for a log line: "" for the published config."""
    if not cut:
        return ""
    names = {"num_layers": "layers", "num_experts": "experts"}
    return " (cut to " + ", ".join(f"{v} {names.get(k, k)}"
                                   for k, v in cut.items()) + ")"


class RoutingLog:
    """Records, while entered, each MoE layer's routing as the port computes
    it (``moe.route`` and ``moe.dispatch``, which ``moe_apply`` and
    ``expert_ff_local`` look up at each call): the expert ids [T, k], each
    token's top-k margin (its k-th largest router probability less its
    (k+1)-th, fp32) and which (token, choice) entries were kept.  Nothing
    is recorded for the other families."""

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self.layers = []
        self.mod = moe
        self.saved = route, dispatch = moe.route, moe.dispatch

        def logged_route(router, x_flat, cfg):
            eids, w, aux = route(router, x_flat, cfg)
            k = cfg.experts_per_token
            with torch.no_grad():
                top = torch.topk(torch.softmax((x_flat @ router).float(), -1),
                                 k + 1, dim=-1).values
            self.layers.append(dict(eids=eids.detach().cpu(),
                                    margin=(top[:, k - 1] - top[:, k]).cpu()))
            return eids, w, aux

        def logged_dispatch(key, experts, capacity):
            dest, keep = dispatch(key, experts, capacity)
            rec = self.layers[-1]
            rec["keep"] = keep.view(rec["eids"].shape).cpu()
            return dest, keep

        moe.route, moe.dispatch = logged_route, logged_dispatch
        return self

    def __exit__(self, *exc):
        self.mod.route, self.mod.dispatch = self.saved


def routing_report(arch: str, what: str, card: RoutingLog,
                   cpu: RoutingLog) -> dict | None:
    """Per MoE layer, the tokens whose expert ids or kept entries differ
    between the card's run and the CPU's (a flip moves a token's output
    grossly, so it is reported before the outputs are compared), the
    entries dropped, and the top-k margins: the smallest, and each flipped
    token's.  None when the runs routed nothing."""
    if not card.layers and not cpu.layers:
        return None
    if len(card.layers) != len(cpu.layers):
        fail(f"{arch} {what}: {len(card.layers)} MoE layers routed on the "
             f"card, {len(cpu.layers)} on the CPU")
    layers = []
    for i, (a, b) in enumerate(zip(card.layers, cpu.layers)):
        flip = ((a["eids"] != b["eids"]).any(1)
                | (a["keep"] != b["keep"]).any(1))
        rec = dict(tokens=int(flip.numel()), flipped=int(flip.sum()),
                   dropped_card=int((~a["keep"]).sum()),
                   dropped_cpu=int((~b["keep"]).sum()),
                   min_margin=float(b["margin"].min()),
                   flipped_margins=[float(m) for m in b["margin"][flip]])
        layers.append(rec)
        margins = (f" (their top-k margins {rec['flipped_margins']})"
                   if rec["flipped"] else "")
        log("serve" if "prefill" in what else "train",
            f"{arch} {what}, MoE layer {i}: {rec['flipped']} of "
            f"{rec['tokens']} tokens routed otherwise on the card than on "
            f"the CPU (expert ids or kept entries){margins}; entries "
            f"dropped: card {rec['dropped_card']}, CPU {rec['dropped_cpu']}; "
            f"smallest top-k margin {rec['min_margin']:.3e}")
    return dict(layers=layers, flipped=sum(r["flipped"] for r in layers))


# --------------------------------------------------------------------------- #
# phase 6: train
# --------------------------------------------------------------------------- #
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_OVERHEAD_PAIRS = 12, 4, 8
# per training path: the layers it trains (None: the full depth) and the
# fp32 card-vs-CPU step of its cut (layers kept,
# sequence length, gradients held).  mamba2's S 512 is two chunks, so the
# state carries between them.  Every path's bf16 step is one microbatch
# with fp32 moments (tools/train_memory.py on the H100): zamba2's peaks at
# 71.95 GB so (73.15 GB at two, which add an fp32 gradient accumulator);
# musicgen-large's at 66.50 GB (81.73 GB at two; bf16 moments 53.58 GB at
# one, 68.82 at two), so it keeps fp32 moments; the vlm cut's at 51.51 GB.
# zamba2's agreement cut is one group, 6 Mamba layers and one application
# of the shared block: a 2-layer cut of it would hold no attention, and so
# run neither flash kernel.  For time, since the mesh step joined the
# parallel phase, zamba2 trains 2 groups (was 4), mamba2 and musicgen 24
# of their 48 layers (were whole) and llama-20b-paper 10 (was 20).
# llama-3.2-vision-11b trains cut to one group (4 self-attention layers
# and 1 cross layer, full width): its 9.9 B
# parameters with fp32 gradients and moments would need ~159 GB; its fp32
# agreement step is the same cut, with the gates open.  The moe paths
# train one layer at full width (dbrx-132b all 16 experts, 4.49 B
# parameters; arctic-480b 32 of its 128 experts, top-2, d_ff and the dense
# residual kept, 4.03 B; ``experts`` cuts ``num_experts``), fp32 moments
# too: their steps peak at 76.17 and 68.99 GB so (58.20 and 52.88 GB with
# bf16 moments); their fp32 agreement steps are the same cuts.  The last
# three dense archs train on the JAX package's own policy for them
# (``src/repro/launch/dryrun.py``, its ``MID`` and ``BIG`` sets) as far as
# it trains, which a path names by ``param_dtype``, ``state_dtype``,
# ``remat`` and ``peak_lr`` (float32, float32, "none" and 3e-4 where it
# names none): llama-20b-paper fp32 parameters, bf16 moments, remat
# "full"; qwen2-72b and llama3-405b bf16 parameters and remat "full", but
# bf16 moments, not the policy's int8, and a peak lr of 8e-5 (llama3-405b's
# published peak, arXiv:2407.21783): 12 steps of these cuts on the card
# with this schedule (tools/train_memory.py --steps 12 --warmup 4; its
# logs in PERF.md) lose with the reference's int8 moments (ROADMAP.md §3:
# qwen2-72b 12.47 -> 38.94 at 8e-5, 127.60 at 3e-4 after 2285.68;
# llama3-405b 12.18 -> 67.77 and 303.55) and with bf16 moments at 3e-4
# (12.47 -> 12.84, 12.18 -> 25.57), and fall with bf16 moments at 8e-5
# (qwen2-72b 12.47 -> 9.38).  Each cut by tools/train_memory.py on the
# card (B 8 x S 512, one microbatch, the path's dtypes and remat):
# llama-20b-paper peaks at 72.88 GB with 20 layers (79.50 with 22, which
# would leave less room than any other path has, 66.26 with 18; it trains
# 10, for time), qwen2-72b
# at 72.09 GB with 6 (7 run out of memory; int8 moments would take 10 in
# 78.08 GB), llama3-405b at 76.00 GB with 1 (int8 61.46; 2 layers run out
# of memory with either).  Their fp32 agreement steps run remat "full" too,
# on cuts of 2, 1 and 1 layers.
TRAIN_PATHS = {
    "llama3.2-1b": dict(
        layers=None,
        agree_layers=2, agree_seq=128,
        agree_grads=("embed.embedding", "layers.0.attn.wq",
                     "layers.1.ln2.scale")),
    "mamba2-780m": dict(
        layers=24,        # half its 48, cut for time
        agree_layers=2, agree_seq=512,
        agree_grads=("embed.embedding", "layers.0.mamba.in_x",
                     "layers.1.mamba.A_log")),
    "zamba2-2.7b": dict(
        layers=12,        # 2 of its 9 groups, cut for time
        agree_layers=6, agree_seq=512,
        agree_grads=("embed.embedding", "layers.0.mamba.in_x",
                     "layers.5.mamba.A_log", "shared_attn.attn.wq",
                     "shared_attn.mlp.wo", "shared_attn.ln1.scale")),
    "qwen2-0.5b": dict(
        layers=None,
        agree_layers=2, agree_seq=128,
        agree_grads=("embed.embedding", "layers.0.attn.bq",
                     "layers.1.attn.wk", "layers.1.ln2.scale")),
    "musicgen-large": dict(
        layers=24,        # half its 48, cut for time
        agree_layers=2, agree_seq=128,
        agree_grads=("embed.embedding", "head.w", "layers.0.attn.wq",
                     "layers.1.mlp.wo")),
    "llama-3.2-vision-11b": dict(
        layers=5,
        agree_layers=5, agree_seq=64,
        agree_grads=("embed.embedding", "layers.0.attn.wq",
                     "cross.0.attn.gate", "cross.0.kv_proj",
                     "cross.0.gate_mlp", "cross.0.attn.wk")),
    "dbrx-132b": dict(
        layers=1,
        agree_layers=1, agree_seq=128,
        agree_grads=("embed.embedding", "head.w", "layers.0.attn.wq",
                     "layers.0.ln2.scale", "layers.0.moe.router",
                     "layers.0.moe.wi_gate", "layers.0.moe.wo")),
    "arctic-480b": dict(
        layers=1, experts=32,
        agree_layers=1, agree_seq=128,
        agree_grads=("embed.embedding", "layers.0.attn.wk",
                     "layers.0.moe.router", "layers.0.moe.wi_up",
                     "layers.0.moe.wo", "layers.0.mlp.wi_gate",
                     "layers.0.mlp.wo")),
    "llama-20b-paper": dict(
        layers=10,        # 20 fit one card; cut for time
        param_dtype="float32", state_dtype="bfloat16", remat="full",
        agree_layers=2, agree_seq=128,
        agree_grads=("embed.embedding", "head.w", "layers.0.attn.wq",
                     "layers.1.mlp.wo", "layers.1.ln2.scale")),
    "qwen2-72b": dict(
        layers=6,
        param_dtype="bfloat16", state_dtype="bfloat16", remat="full",
        peak_lr=8e-5,
        agree_layers=1, agree_seq=128,
        agree_grads=("embed.embedding", "head.w", "layers.0.attn.bq",
                     "layers.0.attn.wk", "layers.0.mlp.wi_up",
                     "layers.0.ln1.scale")),
    "llama3-405b": dict(
        layers=1,
        param_dtype="bfloat16", state_dtype="bfloat16", remat="full",
        peak_lr=8e-5,
        agree_layers=1, agree_seq=64,
        agree_grads=("embed.embedding", "head.w", "layers.0.attn.wq",
                     "layers.0.attn.wo", "layers.0.mlp.wo",
                     "layers.0.ln2.scale")),
}


def train_policy(arch: str) -> dict:
    """A training path's parameter and moment dtypes, remat and peak
    learning rate (``RunConfig``'s 3e-4 where it names none)."""
    path = TRAIN_PATHS[arch]
    return {k: path.get(k, d) for k, d in (
        ("param_dtype", "float32"), ("state_dtype", "float32"),
        ("remat", "none"), ("peak_lr", 3e-4))}


def train_cut(arch: str, layers_key: str = "layers") -> dict:
    """A training path's ``configs.scale`` overrides: its layers (by
    ``layers_key``: the trained run's, or ``agree_layers``, its fp32
    agreement step's) and its experts."""
    path = TRAIN_PATHS[arch]
    cut = {} if path[layers_key] is None else {"num_layers": path[layers_key]}
    if path.get("experts") is not None:
        cut["num_experts"] = path["experts"]
    return cut


def train_config(arch: str):
    """The config a training path trains: the arch's, cut to the path's
    ``layers`` and ``experts``."""
    from repro_torch.configs import get_config, scale
    return scale(get_config(arch), **train_cut(arch))


def train_kernels(arch: str) -> dict:
    """The kernels a training step of ``arch`` can launch, by label, as
    (kernel, the op whose forward launches it once, the compute dtype whose
    steps launch it, None for both): each op of the forward
    (``forward_launches``) on the route of the step's dtype, and its
    backward as often."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.fused_norm import ops as fn
    from repro_torch.kernels.ssd_scan import ops as ssd
    routed = {"flash_attention": (fa.KERNELS, fa.BWD_KERNELS),
              "ssd_scan": (ssd.KERNELS, ssd.BWD_KERNELS)}
    dtypes = {"wgmma": "bfloat16", "tf32x3": "float32"}
    kernels = {}
    for op in forward_launches(get_config(arch)):
        if op not in routed:
            kernels[op] = (fn.KERNEL, op, None)
            kernels[f"{op}_bwd"] = (fn.BWD_KERNEL, op, None)
            continue
        for route, d in dtypes.items():
            fwd, bwd = routed[op]
            kernels[f"{op}[{route}]"] = (fwd[route], op, d)
            kernels[f"{op}_bwd[{route}]"] = (bwd[route], op, d)
    return kernels


def expected_step_launches(arch: str, cfg, dtype: str,
                           remat: str = "none") -> dict:
    """A step's launches by label: each op's forward kernel as often as a
    forward runs it, twice under remat (the backward runs each layer's
    forward again), and its backward kernel once, on the route of
    ``dtype``."""
    per_fwd = forward_launches(cfg)
    runs = 1 if remat == "none" else 2
    return {label: per_fwd[op] * (1 if label.split("[")[0].endswith("_bwd")
                                  else runs) if d in (None, dtype) else 0
            for label, (_, op, d) in train_kernels(arch).items()}


class PlainCalls:
    """Counts the calls of the plain versions of a model family's training
    kernels while it is entered (the ops modules look them up at each
    call)."""
    FLASH = {"flash_attention": ("attention_ref", "attention_bwd_ref")}
    SSD = {"ssd_scan": ("ssd_ref", "ssd_bwd_ref")}
    NORM = {"fused_norm": ("fused_ref", "fused_bwd_ref")}
    NAMES = {"dense": {**FLASH, **NORM}, "moe": {**FLASH, **NORM},
             "audio": {**FLASH, **NORM},
             "vlm": {**FLASH, **NORM}, "ssm": {**SSD, **NORM},
             "hybrid": {**FLASH, **SSD, **NORM}}

    def __init__(self, family: str):
        self.family = family

    def __enter__(self):
        import importlib
        self.calls, self.saved = {}, []
        for mod_name, fns in self.NAMES[self.family].items():
            mod = importlib.import_module(
                f"repro_torch.kernels.{mod_name}.ops")
            for fn_name in fns:
                orig = getattr(mod, fn_name)
                self.calls[fn_name] = 0
                self.saved.append((mod, fn_name, orig))

                def counted(*a, _f=orig, _n=fn_name, **kw):
                    self.calls[_n] += 1
                    return _f(*a, **kw)
                setattr(mod, fn_name, counted)
        return self

    def __exit__(self, *exc):
        for mod, fn_name, orig in self.saved:
            setattr(mod, fn_name, orig)


def tracing_overhead(trainer, log_path: Path) -> dict:
    """The daemon's cost on the training step: 2·TRAIN_OVERHEAD_PAIRS
    steps that continue the trainer's run, traced and untraced in turn
    (ABBA order, so a drift over the run weighs on both alike), each timed
    from dispatch to the loss read, as ``train_step_exec``.  A traced step
    runs under a daemon attached just before it (spilling to
    ``log_path``) and detached just after, outside the timed window.  The
    difference of the medians is called unresolved when the traced median
    lies inside the untraced steps' range."""
    import time
    import torch
    from repro_torch.core.daemon import DaemonConfig, TracingDaemon

    _, opt_state = trainer.final_state
    loader = trainer._loader(TRAIN_STEPS)
    ms = {"traced": [], "untraced": []}
    for i in range(2 * TRAIN_OVERHEAD_PAIRS):
        step = TRAIN_STEPS + i
        traced = (i % 4) in (1, 2)
        batch = trainer._to_device(loader.next_batch())
        daemon = TracingDaemon(DaemonConfig(
            rank=0, backend=f"{trainer.cfg.model.family}-train",
            log_path=str(log_path),
            hang_timeout=300.0)).attach() if traced else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if daemon:
            daemon.step_begin(step)
        opt_state, metrics = trainer.step_fn(opt_state, batch, step)
        float(metrics["loss"])
        if daemon:
            daemon.step_end(tokens=TRAIN_B * TRAIN_S)
        ms["traced" if traced else "untraced"].append(
            (time.perf_counter() - t0) * 1e3)
        if daemon:
            daemon.detach()
    trainer.final_state = (trainer.final_state[0], opt_state)
    med = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
    lo, hi = min(ms["untraced"]), max(ms["untraced"])
    diff = med["traced"] / med["untraced"] - 1
    resolved = not lo <= med["traced"] <= hi
    log("train", f"tracing overhead, {TRAIN_OVERHEAD_PAIRS} traced and "
        f"{TRAIN_OVERHEAD_PAIRS} untraced steps in turn (ABBA): median "
        f"{med['traced']:.1f} ms traced (range {min(ms['traced']):.1f}-"
        f"{max(ms['traced']):.1f}), {med['untraced']:.1f} ms untraced (range "
        f"{lo:.1f}-{hi:.1f}): {diff:+.2%}"
        f"{'' if resolved else ', unresolved (inside the untraced range)'}")
    return dict(ms=ms, median_ms=med, overhead=diff, resolved=resolved)


def train(arch: str, seed: int, trace_path: Path,
          with_overhead: bool, tap: "SpillTap | None" = None) -> dict:
    """Trainer.train of ``arch`` at full width and the path's depth
    (``train_config``): B 8 x S 512 from the synthetic corpus, bf16
    compute, fp32 parameters and AdamW moments, 12 traced
    steps (4 warm-up steps in the schedule), the daemon spilling to
    ``trace_path`` (backend ``<family>-train``; its extension picks the
    codec), ``tap``'s sinks added before it attaches; the launch counts of
    that run and of each of its steps, no plain version called; then,
    ``with_overhead``, the tracing overhead (``tracing_overhead``), and a
    profiler breakdown of one step."""
    import math
    import numpy as np
    import torch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train import RunConfig, Trainer

    cfg = train_config(arch)
    kernels = train_kernels(arch)
    pol = train_policy(arch)
    run = RunConfig(model=cfg, global_batch=TRAIN_B, seq_len=TRAIN_S,
                    steps=TRAIN_STEPS, warmup_steps=TRAIN_WARMUP, seed=seed,
                    flare_log=str(trace_path), param_dtype=pol["param_dtype"],
                    remat=pol["remat"], peak_lr=pol["peak_lr"],
                    opt=AdamWConfig(state_dtype=pol["state_dtype"]))
    snaps = []
    trainer = Trainer(run, fault_hook=lambda step: snaps.append(
        {label: k.launches for label, (k, _, _) in kernels.items()}))
    if tap is not None:
        tap.add_to(trainer.daemon)
    for k, _, _ in kernels.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with PlainCalls(cfg.family) as plain:
        hist = trainer.train()
    launches = {label: k.launches for label, (k, _, _) in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    backend = trainer.daemon.cfg.backend
    spill = dict(log_paths=trainer.daemon.log_paths,
                 bytes_logged=trainer.daemon.bytes_logged)
    if backend != f"{cfg.family}-train":
        fail(f"{arch}: the trainer's daemon has backend {backend}")
    snaps.append(launches)
    per_step = [{label: b[label] - a[label] for label in launches}
                 for a, b in zip(snaps, snaps[1:])]
    want = expected_step_launches(arch, cfg, "bfloat16", pol["remat"])
    log("train", f"{arch}{describe_cut(train_cut(arch))} B{TRAIN_B} "
        f"S{TRAIN_S} bf16 compute, {pol['param_dtype']} parameters, "
        f"{pol['state_dtype']} moments, remat {pol['remat']}, peak lr "
        f"{pol['peak_lr']:g}, backend "
        f"{backend}: launches "
        f"of one step {per_step[0]} (expected {want}); plain versions "
        f"called {plain.calls}")
    if any(n != want for n in per_step) or len(per_step) != TRAIN_STEPS:
        fail(f"training launch counts per step {per_step} != {want}")
    if any(plain.calls.values()):
        fail(f"training called plain versions on the card: {plain.calls}")
    n_params = cfg.active_param_count()
    tokens = TRAIN_B * TRAIN_S
    for rec in hist:
        mfu = 6.0 * n_params * tokens / rec["step_time_s"] / PEAK_BF16_FLOPS
        rec["mfu"] = mfu
        log("train", f"step {rec['step']:2d}: loss {rec['loss']:.4f}, "
            f"grad_norm {rec['grad_norm']:.4f}, lr {rec['lr']:.3e}, step "
            f"{rec['step_time_s'] * 1e3:.1f} ms, {rec['tokens_per_s']:.0f} "
            f"tokens/s, MFU {mfu:.3f}")
    losses = [rec["loss"] for rec in hist]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"training loss not finite and falling: {losses}")
    traced_ms = sorted(r["step_time_s"] * 1e3 for r in hist[1:])
    med_t = traced_ms[len(traced_ms) // 2]
    overhead = tracing_overhead(trainer, trace_path.with_name(
        f"train_overhead_{arch}.jsonl")) if with_overhead else None
    log("train", f"step time median {med_t:.1f} ms traced (steps 1-"
        f"{TRAIN_STEPS - 1}); {tokens / med_t * 1e3:.0f} tokens/s and MFU "
        f"{6.0 * n_params * tokens / (med_t / 1e3) / PEAK_BF16_FLOPS:.3f}"
        f" traced; peak memory {peak_gb:.2f} GB "
        f"(torch.cuda.max_memory_allocated)")
    # one more step under the profiler
    _, opt_state = trainer.final_state
    step = TRAIN_STEPS + (2 * TRAIN_OVERHEAD_PAIRS if with_overhead else 0)
    batch = trainer._to_device(trainer._loader(step).next_batch())
    prof = profile(lambda: trainer.step_fn(opt_state, batch, step))
    log("profile", f"{arch} train step: wall {prof['wall_s'] * 1e3:.3f}"
        f" ms, device busy {prof['device_s'] * 1e3:.3f} ms, idle share "
        f"{prof['idle_share']}")
    for k in prof["top"]:
        log("profile", f"  {k['ms']:10.3f} ms {k['count']:6d}x {k['name']}")
    log("profile", f"{arch} train step, the port's kernels:")
    for k in prof["port"]:
        log("profile", f"  {k['ms']:10.3f} ms {k['count']:6d}x {k['name']}")
    del trainer, batch, opt_state
    torch.cuda.empty_cache()
    return dict(arch=arch, B=TRAIN_B, S=TRAIN_S, layers=cfg.num_layers,
                cut=train_cut(arch), policy=pol, backend=backend,
                spill=spill, history=hist,
                launches=launches, launches_per_step=per_step[0],
                plain_calls=plain.calls, peak_memory_gb=peak_gb,
                step_ms_traced=traced_ms, tracing_overhead=overhead,
                profile=prof,
                n_params=n_params, mfu_median=6.0 * n_params * tokens
                / (med_t / 1e3) / PEAK_BF16_FLOPS)


def train_agreement(arch: str, seed: int, ckpt_dir: Path | None) -> dict:
    """One fp32 training step of ``arch`` cut to the path's ``agree_layers``
    (widths kept), B 2 and its ``agree_seq``: loss and gradients on the
    card (the fp32 forward routes and the backward kernels) against the
    plain path on the CPU, same weights (drawn on the card, copied to the
    CPU; a vlm cut's gates open, ``open_gates``) and batch (a vlm's with
    seeded vision embeddings).  Loss, grad_norm and the gradients of the
    path's ``agree_grads`` each within 3e-4 of its largest magnitude.
    A moe path first reports the tokens routed otherwise on the card
    than on the CPU (``routing_report``).  Then, given ``ckpt_dir``, a
    checkpoint of the card's parameters and bf16 AdamW moments saved and
    restored bitwise."""
    import shutil
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, scale
    from repro_torch.data import DataConfig, ShardedLoader
    from repro_torch.models.layers import Policy
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import (AdamWConfig, adamw_init,
                                         adamw_update, global_norm)
    from repro_torch.runtime.train import loss_and_grads

    path = TRAIN_PATHS[arch]
    cfg = scale(get_config(arch), **train_cut(arch, "agree_layers"))
    S, names = path["agree_seq"], path["agree_grads"]
    pol = Policy(torch.float32, torch.float32)
    remat = train_policy(arch)["remat"]
    gpu = build_model(cfg, pol, "cuda", remat).init(
        torch.Generator(device="cuda").manual_seed(seed))
    open_gates(gpu)
    cpu = build_model(cfg, pol, "cpu", remat).load_params(gpu.state_dict())
    b = ShardedLoader(DataConfig(vocab_size=cfg.vocab_size, batch=2,
                                 seq_len=S, seed=seed)).next_batch()
    batch = {k: torch.as_tensor(b[k], dtype=torch.long)
             for k in ("tokens", "labels")}
    vis = vision_embeds(cfg, 2, seed + 5, "cpu", torch.float32)
    if vis is not None:
        batch["vision_embeds"] = vis
    kernels = train_kernels(arch)
    n0 = {label: k.launches for label, (k, _, _) in kernels.items()}
    with RoutingLog() as card_routes:
        loss_g, grads_g = loss_and_grads(
            gpu, {k: v.cuda() for k, v in batch.items()},
            dict(gpu.named_parameters()))
    torch.cuda.synchronize()
    launches = {label: k.launches - n0[label]
                for label, (k, _, _) in kernels.items()}
    want_launches = expected_step_launches(arch, cfg, "float32", remat)
    if launches != want_launches:
        fail(f"the fp32 training step launched {launches}, not "
             f"{want_launches}")
    with RoutingLog() as cpu_routes:
        loss_c, grads_c = loss_and_grads(cpu, batch,
                                         dict(cpu.named_parameters()))
    routing = routing_report(arch, "fp32 training step", card_routes,
                             cpu_routes)
    res = {}

    def pairs():
        """(name, card value, CPU value) one at a time, each gradient
        compared on the card: llama3-405b's embedding and head gradients
        are 8.4 GB each, beside 59 GB of the CPU model's weights and
        gradients in the host's 96 GiB"""
        yield "loss", loss_g.cpu(), loss_c
        yield ("grad_norm", global_norm(grads_g.values()).cpu(),
               global_norm(grads_c.values()))
        for n in names:
            yield n, grads_g[n], grads_c[n].to(grads_g[n].device)

    for name, got, want in pairs():
        scale = float(want.abs().max())
        err = float((got - want).abs_().max())
        del got, want
        res[name] = dict(max_abs_err=err, max_abs=scale)
        ok = err <= 3e-4 * max(scale, 1e-12)
        log("train", f"{arch} fp32 agreement, {cfg.num_layers} layers B2 "
            f"S{S} remat {remat}, card vs CPU: {name} max_abs_err {err:.3e} "
            f"(|max| "
            f"{scale:.3e}, 3e-4 of it: {ok})")
        if not ok:
            fail(f"fp32 training step disagrees between card and CPU: {name}")
    log("train", f"{arch} fp32 agreement step launched {launches} "
        f"(expected {want_launches})")
    if ckpt_dir is None:
        del cpu, gpu, grads_g, grads_c
        torch.cuda.empty_cache()
        return dict(errors=res, launches=launches, routing=routing,
                    remat=remat)

    # checkpoint: the card's parameters and bf16 moments after one update
    params = dict(gpu.named_parameters())
    opt_cfg = AdamWConfig(state_dtype="bfloat16")
    opt = adamw_init(params, opt_cfg)
    adamw_update(grads_g, opt, params, opt_cfg, 1e-4)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    mgr = CheckpointManager(str(ckpt_dir))
    t0 = time.perf_counter()
    mgr.save(0, {"params": params, "opt": opt}, {"loss": float(loss_g)})
    save_s = time.perf_counter() - t0
    fresh = build_model(cfg, pol, "cuda")
    fresh_opt = adamw_init(dict(fresh.named_parameters()), opt_cfg)
    t0 = time.perf_counter()
    mgr.restore({"params": dict(fresh.named_parameters()), "opt": fresh_opt})
    restore_s = time.perf_counter() - t0
    same = all(torch.equal(fresh.state_dict()[n], p) for n, p in
               params.items()) and all(
        torch.equal(fresh_opt["mu_nu"][n][m], opt["mu_nu"][n][m])
        for n in params for m in ("m", "v")) and torch.equal(
        fresh_opt["count"], opt["count"])
    log("train", f"checkpoint of the {cfg.num_layers}-layer cut (parameters "
        f"fp32, moments "
        f"bf16) to {ckpt_dir.relative_to(ROOT)}: saved in {save_s:.2f} s, "
        f"restored in {restore_s:.2f} s, bitwise equal: {same}")
    if not same:
        fail("checkpoint restore differs from what was saved")
    del cpu, gpu, fresh, grads_g, grads_c, opt, fresh_opt
    torch.cuda.empty_cache()
    return dict(errors=res, launches=launches, routing=routing,
                checkpoint_save_s=save_s, checkpoint_restore_s=restore_s)


def check_train_trace(arch: str, events: list, steps: int) -> dict:
    """The training trace read back (``events``): step spans 0..steps-1, a
    ``dataloader.next_batch`` span with ``tokens`` and a ``train_step_exec``
    span with ``flops`` = 6·N·tokens in each, and the forward's kernel
    spans (``forward_launches`` a step of the path's config: llama flash 16
    and fused 32, mamba2's cut SSD scan 24 and fused 24, zamba2's cut SSD
    scan 12, flash 2 and fused 16, the vlm cut flash 4 and fused 10) with
    CUDA-event durations, nested under their step."""
    from collections import Counter
    from repro_torch.core.events import EventKind

    cfg = train_config(arch)
    tokens = TRAIN_B * TRAIN_S
    flops = 6.0 * cfg.active_param_count() * tokens
    kinds = Counter(e.kind.value for e in events)
    log("trace", f"{arch} train: {len(events)} events by kind: "
        f"{dict(kinds)}")
    steps_seen = sorted(e.step for e in events if e.kind == EventKind.STEP)
    if steps_seen != list(range(steps)):
        fail(f"{arch} train: step spans {steps_seen} != 0..{steps - 1}")
    data = [e for e in events if e.kind == EventKind.DATALOADER]
    execs = [e for e in events if e.name == "train_step_exec"]
    if (sorted(e.step for e in data) != steps_seen
            or any(e.name != "dataloader.next_batch"
                   or e.meta.get("tokens") != tokens for e in data)):
        fail(f"{arch} train: a dataloader.next_batch span per step with "
             f"tokens")
    if (sorted(e.step for e in execs) != steps_seen
            or any(e.kind != EventKind.KERNEL_COMPUTE
                   or e.meta.get("flops") != flops for e in execs)):
        fail(f"{arch} train: a train_step_exec k_comp span per step with "
             f"flops {flops}")
    per_name = {}
    runs = 1 if train_policy(arch)["remat"] == "none" else 2
    for name, n in forward_launches(cfg).items():
        n *= runs                       # remat runs each forward again
        evs = [e for e in events if e.name == name]
        if len(evs) != n * steps or Counter(e.step for e in evs) != {
                s: n for s in range(steps)}:
            fail(f"{arch} train: {name} spans {len(evs)}, not {n} a step")
        bad = [e for e in evs if e.duration <= 0 or e.issue_latency < 0
               or e.meta.get("parent") != f"step_{e.step}"]
        if bad:
            e = bad[0]
            fail(f"{arch} train: {len(bad)} {name} spans without a device "
                 f"duration or outside their step; the first: step {e.step},"
                 f" duration {e.duration:.3e} s, issue latency "
                 f"{e.issue_latency:.3e} s, parent {e.meta.get('parent')}")
        per_name[name] = dict(n=len(evs),
                              device_s=sum(e.duration for e in evs))
    exec_s = sorted(e.duration for e in execs)
    log("trace", f"{arch} train: kernel spans {per_name}; train_step_exec "
        f"median {exec_s[len(exec_s) // 2] * 1e3:.1f} ms with flops "
        f"{flops:.4e}")
    return dict(kinds=dict(kinds), per_name=per_name,
                train_step_exec_s=exec_s)


REMAT_ARCH = "llama3.2-1b"


def remat_check(seed: int) -> dict:
    """One bf16 training step's loss and gradients of ``REMAT_ARCH``'s
    training path (full width, B 8 x S 512, fp32 parameters) under remat
    "none", "full" and "dots", same weights and batch: the launches of
    each (under remat the backward runs each layer's forward kernels
    again: the "dots" recompute must rerun them, not reuse the buffer the
    first forward wrote), and whether the loss and every gradient are
    bitwise those of "none" or else their largest difference, which must
    stay within ``BWD_BF16_SCALED`` of each gradient's largest magnitude
    (and the loss within 5e-2)."""
    import torch
    from repro_torch.data import DataConfig, ShardedLoader
    from repro_torch.models.layers import Policy
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.train import loss_and_grads

    cfg = train_config(REMAT_ARCH)
    kernels = train_kernels(REMAT_ARCH)
    b = ShardedLoader(DataConfig(vocab_size=cfg.vocab_size, batch=TRAIN_B,
                                 seq_len=TRAIN_S, seed=seed)).next_batch()
    batch = {k: torch.as_tensor(b[k], dtype=torch.long, device="cuda")
             for k in ("tokens", "labels")}
    out, base = {}, None
    for mode in ("none", "full", "dots"):
        model = build_model(cfg, Policy(torch.bfloat16, torch.float32),
                            "cuda", mode).init(
            torch.Generator(device="cuda").manual_seed(seed))
        n0 = {label: k.launches for label, (k, _, _) in kernels.items()}
        loss, grads = loss_and_grads(model, batch,
                                     dict(model.named_parameters()))
        torch.cuda.synchronize()
        launches = {label: k.launches - n0[label]
                    for label, (k, _, _) in kernels.items()}
        want = expected_step_launches(REMAT_ARCH, cfg, "bfloat16", mode)
        if launches != want:
            fail(f"remat {mode}: a step launched {launches}, not {want}")
        res = dict(loss=float(loss), launches=launches)
        if base is None:
            base = (loss, grads)
        else:
            same = torch.equal(loss, base[0]) and all(
                torch.equal(g, base[1][k]) for k, g in grads.items())
            diffs = {k: float((g.float() - base[1][k].float()).abs().max())
                     for k, g in grads.items()}
            worst = max(diffs, key=diffs.get)
            rel = max(diffs[k] / max(float(base[1][k].float().abs().max()),
                                     1e-12) for k in grads)
            res.update(bitwise=same, max_abs_diff=diffs[worst],
                       max_abs_diff_at=worst, max_scaled_diff=rel,
                       loss_diff=float((loss - base[0]).abs()))
            log("remat", f"{REMAT_ARCH} bf16 step, remat {mode} against "
                f"none: loss {float(loss):.6f} ({float(base[0]):.6f}), "
                f"launches {launches}; loss and gradients bitwise equal: "
                f"{same}" + ("" if same else
                             f"; largest gradient difference "
                             f"{diffs[worst]:.3e} at {worst}, "
                             f"{rel:.3e} of a gradient's largest magnitude"))
            if not same and (rel > BWD_BF16_SCALED
                             or res["loss_diff"] > 5e-2):
                fail(f"remat {mode}: the step's gradients differ from remat "
                     f"none by {rel:.3e} of their magnitude")
        out[mode] = res
        del model, loss, grads
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# the daemon: its spill held to its sinks, and its clock over a long attach
# --------------------------------------------------------------------------- #
# the path whose serving and training runs spill FCS: serving FCS v2 with
# zlib named (so that the run needs no zstandard package), rotated past
# 4 KiB (a generate's ~1100 events come in drains of ~2 KB), training FCS v1
SPILL_ARCH = "llama3.2-1b"
SERVE_SPILL = dict(log_compression="zlib", log_rotate_bytes=4096)
SERVE_SPILL_PIECES = 3
# fused-norm calls traced by the daemon attached for the whole run
LONG_ATTACH_CALLS = 4
BATCH_COLUMNS = ("kind", "name_id", "rank", "issue_ts", "start_ts", "end_ts",
                 "step", "flops", "nbytes", "tokens", "group_id")


class SpillTap:
    """An in-process sink and batch sink, added to a daemon before it
    attaches: the events and the batch of every drain, which its spill must
    hold."""

    def __init__(self):
        self.events, self.batches = [], []

    def add_to(self, daemon):
        daemon.add_sink(self.events.extend)
        daemon.add_batch_sink(self.batches.append)
        return daemon


def read_spill(paths) -> list:
    """A spill read back piece by piece, in order: FCS through the port's
    store, JSONL through ``load_jsonl``."""
    from repro_torch import store
    from repro_torch.core.events import load_jsonl
    return [e for p in paths for e in (
        load_jsonl(p) if p.endswith(".jsonl")
        else store.read_trace(p).to_events())]


def event_key(e) -> tuple:
    """An event's fields, its times as their float64 bits."""
    return (e.kind, e.name, e.rank, e.issue_ts.hex(), e.start_ts.hex(),
            e.end_ts.hex(), e.step, e.meta)


def same_batch(a, b) -> bool:
    """Two ``EventBatch``es column for column, bitwise, with the same
    interned names and groups and leftover meta."""
    return (all(getattr(a, c).dtype == getattr(b, c).dtype
                and getattr(a, c).tobytes() == getattr(b, c).tobytes()
                for c in BATCH_COLUMNS)
            and a.names == b.names and a.groups == b.groups
            and a.extra == b.extra)


def spill_sizes(events) -> dict:
    """Bytes per event of ``events`` as one FCS v1 segment, one FCS v2
    segment (zlib) and JSONL lines."""
    from repro_torch.core.columnar import EventBatch
    from repro_torch.store.fcs import encode_segment
    b = EventBatch.from_events(events)
    n = len(b)
    return {"fcs_v1": len(encode_segment(b, version=1)) / n,
            "fcs_v2_zlib": len(encode_segment(b, version=2,
                                              compression="zlib")) / n,
            "jsonl": sum(len(line) + 1 for line in b.to_jsonl_lines()) / n}


def check_spill(what: str, spill: dict, tap: SpillTap,
                pieces: int = 1) -> tuple[list, dict]:
    """A daemon's spill against its ``tap``: ``log_paths`` names every piece
    on disk, at least ``pieces``, and their bytes are ``bytes_logged``; read
    back in order, they hold the sink's events field for field, times
    bitwise; one FCS segment a drain, each the batch sink's batch, column
    for column.  Returns the events read back and the record."""
    from repro_torch.store.fcs import iter_segments
    paths = spill["log_paths"]
    base = Path(paths[0])
    on_disk = sorted(str(q) for q in base.parent.glob(
        f"{base.stem}*{base.suffix}"))
    size = sum(Path(q).stat().st_size for q in paths)
    if on_disk != sorted(paths) or len(paths) < pieces:
        fail(f"{what}: log_paths {paths} != the pieces on disk {on_disk}, "
             f"or fewer than {pieces}")
    if size != spill["bytes_logged"]:
        fail(f"{what}: {size} bytes on disk, bytes_logged "
             f"{spill['bytes_logged']}")
    events = read_spill(paths)
    want = [event_key(e) for e in tap.events]
    got = [event_key(e) for e in events]
    if got != want:
        diff = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                    min(len(got), len(want)))
        fail(f"{what}: the spill read back ({len(got)} events) differs from "
             f"the sink's ({len(want)}) from event {diff}: "
             f"{got[diff:diff + 1]} != {want[diff:diff + 1]}")
    segs = [b for p in paths for b in iter_segments(p)]
    if (len(segs) != len(tap.batches)
            or not all(same_batch(a, b) for a, b in zip(segs, tap.batches))):
        fail(f"{what}: {len(segs)} segments, {len(tap.batches)} drained "
             f"batches, not one segment each, column for column")
    sizes = spill_sizes(tap.events)
    log("daemon", f"{what}: {len(events)} events in {len(tap.batches)} "
        f"drains; the spill {size} bytes in {len(paths)} pieces, "
        f"{len(segs)} segments, {size / len(events):.2f} bytes/event; read "
        f"back equal to the sink's events (times bitwise) and a segment "
        f"equal to each drained batch; the same events in one piece: FCS v1 "
        f"{sizes['fcs_v1']:.2f}, FCS v2 (zlib) {sizes['fcs_v2_zlib']:.2f}, "
        f"JSONL {sizes['jsonl']:.2f} bytes/event")
    return events, dict(events=len(events), drains=len(tap.batches),
                        pieces=len(paths), segments=len(segs), bytes=size,
                        bytes_per_event=sizes)


def long_attach_daemon():
    """A daemon attached before the build phase and kept to the end of the
    run, unpublished (the run's kernels do not report to it), its events
    in a list; it keeps each span's event pair beside the times it mapped
    them to.  It needs only its thread's anchors: its interceptor and gc
    callback come off."""
    from repro_torch.core.daemon import DaemonConfig, TracingDaemon

    class PairDaemon(TracingDaemon):
        def _device_span(self, ev0, ev1):
            span = super()._device_span(ev0, ev1)
            self.pairs.append((ev0, ev1, span))
            return span

    d = PairDaemon(DaemonConfig(backend="long-attach", hang_timeout=3600.0))
    d.pairs, events = [], []
    d.add_sink(events.extend)
    d.attach(publish=False)
    d.interceptor.uninstall()
    return d, events, time.perf_counter()


def long_attach_check(d, events: list, t_attach: float,
                      anchors: dict) -> dict:
    """The long-attached daemon traces ``LONG_ATTACH_CALLS`` fused-norm
    calls (R8 D2048, bf16) in its step 0, then detaches: one launch each,
    and each span nested under step_0 with an issue latency >= 0 and its
    end its start plus its event pair's elapsed time, the pair it was
    mapped from.  ``anchors``: the anchors its thread took during each
    training path, printed.  Also the host time of an untraced fused-norm
    call (R8 D2048, 2000 calls) twice with the daemon attached and twice
    after it detached, for the record: the run's untraced walls are taken
    beside its thread."""
    import torch
    from repro_torch.core.events import EventKind
    from repro_torch.kernels.fused_norm import ops as fn

    traced = d.register_kernel("fused_residual_rmsnorm",
                               EventKind.KERNEL_COMPUTE)(
        fn.fused_residual_rmsnorm)
    x = torch.randn(8, 2048, device="cuda", dtype=torch.bfloat16)
    sc = torch.ones(2048, device="cuda")

    def host_us_per_call():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn.fused_residual_rmsnorm(x, x, sc)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 2000 * 1e6

    untraced = {"attached": [host_us_per_call() for _ in range(2)]}
    n0 = fn.KERNEL.launches
    d.step_begin(0)
    for _ in range(LONG_ATTACH_CALLS):
        traced(x, x, sc)
    torch.cuda.synchronize()
    d.step_end()
    launches = fn.KERNEL.launches - n0
    age = time.perf_counter() - t_attach
    d.detach()
    untraced["detached"] = [host_us_per_call() for _ in range(2)]
    n_anchors = d.telemetry.value("daemon.anchors")
    bracket = d.telemetry.value("daemon.anchor_bracket_max_s")
    spans = [e for e in events if e.name == "fused_residual_rmsnorm"]
    if not (launches == len(spans) == len(d.pairs) == LONG_ATTACH_CALLS):
        fail(f"long attach: {launches} launches, {len(spans)} spans, "
             f"{len(d.pairs)} mapped pairs, not {LONG_ATTACH_CALLS} each")
    for e, (ev0, ev1, (t0, t1)) in zip(spans, d.pairs):
        if (e.start_ts != t0 or e.end_ts != t1
                or e.end_ts != e.start_ts + ev0.elapsed_time(ev1) / 1e3
                or e.issue_latency < 0 or e.duration <= 0
                or e.meta.get("parent") != "step_0"):
            fail(f"long attach: span {e} (mapped {t0}, {t1}; its pair's "
                 f"elapsed time {ev0.elapsed_time(ev1)} ms)")
    lat = [e.issue_latency * 1e6 for e in spans]
    log("daemon", f"long attach: the daemon attached {age:.1f} s before "
        f"traces {LONG_ATTACH_CALLS} fused-norm calls: issue latency "
        f"{min(lat):.2f}-{max(lat):.2f} us (>= 0), each duration its event "
        f"pair's elapsed time; its thread took {n_anchors} anchors "
        f"({n_anchors / age:.1f} a second; during the training paths "
        f"{anchors}), the widest bracket {bracket * 1e6:.1f} us")
    log("daemon", f"untraced fused_residual_rmsnorm call at R8, host us per "
        f"call (2000 calls), with the long-attached daemon and after it "
        f"detached: {untraced}")
    return dict(age_s=age, issue_latency_us=lat, anchors=n_anchors,
                anchors_by_train_path=anchors, widest_bracket_s=bracket,
                events=len(events), untraced_call_us=untraced)


# --------------------------------------------------------------------------- #
# phase 8: dryrun — the dry-run's cells, and its count against the card
# --------------------------------------------------------------------------- #
DRYRUN_DIR = OUT_DIR / "dryrun"     # each cell's JSON
DRYRUN_ARCH = "llama3.2-1b"
DRYRUN_SLACK = 1.05     # a count may claim at most this of the measured
DRYRUN_TIMED = 5        # timed steps and prefills a median


# the dry-run's cells, in a process of their own: every cell of
# configs.cells() on both production meshes (each meta run once), each OK
# row or FAIL, into a JSON file
DRYRUN_CHILD = """
import json, os, sys, time
os.nice(19)     # the host's cores go to the card's phases first
from repro_torch.configs import cells
from repro_torch.launch import dryrun
out, t0, runs = {"rows": [], "fails": []}, time.perf_counter(), {}
for multi_pod in (False, True):
    for arch, shape, _ in cells():
        try:
            r = dryrun.run_cell(arch, shape, multi_pod, sys.argv[1],
                                runs=runs)
        except Exception as e:
            out["fails"].append(f"FAIL {arch:22s} {shape:12s}: {e!r}"[:240])
            continue
        out["rows"].append(dict(
            row=dryrun.row(r), key=f"{arch} {shape} {r['mesh']}",
            dominant=r["dominant"], roofline_s=r["roofline_s"],
            useful_flops_ratio=r["useful_flops_ratio"], memory=r["memory"],
            flops_per_device=r["flops_per_device"],
            bytes_per_device=r["bytes_per_device"],
            total_wire_bytes=r["total_wire_bytes"],
            analysis_s=r["analysis_s"]))
out["wall_s"] = time.perf_counter() - t0
with open(sys.argv[2], "w") as f:
    json.dump(out, f)
"""


def start_dryrun_cells():
    """Start the dry-run's cells (``DRYRUN_CHILD``) in a process of their
    own, on the host's CPU while the card runs the earlier phases, at the
    lowest scheduling priority: its meta runs touch no device.  Returns the process; ``dryrun_phase``
    waits for it."""
    import os
    DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    (DRYRUN_DIR / "cells.json").unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-c", DRYRUN_CHILD, str(DRYRUN_DIR),
         str(DRYRUN_DIR / "cells.json")], env=env, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # a run that fails before phase 8 leaves no process behind
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def dryrun_cells(proc) -> dict:
    """Waits for ``start_dryrun_cells``'s process and prints each cell's
    ``OK`` row; any ``FAIL`` row, or the process failing, fails the phase.
    Returns each cell's dominant term, roofline terms and useful ratio,
    and the process's wall."""
    try:
        text, _ = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail("dryrun: the cells' process ran past 600 s")
    if proc.returncode != 0:
        fail(f"dryrun: the cells' process exited {proc.returncode}: "
             f"{text[-2000:]}")
    res = json.loads((DRYRUN_DIR / "cells.json").read_text())
    for r in res["rows"]:
        log("dryrun", r["row"])
    for f in res["fails"]:
        log("dryrun", f)
    if res["fails"]:
        fail(f"dryrun: {len(res['fails'])} cells failed")
    return dict(wall_s=res["wall_s"], cells={r.pop("key"): r
                                             for r in res["rows"]})


def dryrun_card_check(seed: int) -> dict:
    """The op analysis on one chip against the card: ``DRYRUN_ARCH``'s
    training step (B 8 x S 512, bf16 compute, fp32 parameters and moments,
    one microbatch, as its training path) and its prefill (batch 8 x
    prompt 1024, bf16 weights, as its serving path), each counted on meta
    tensors and timed here (the median of ``DRYRUN_TIMED``, after a
    warm-up).  No card computes faster than its peak, so a count whose
    compute term (flops / 989 TFLOP/s) exceeds the measured time by more
    than ``DRYRUN_SLACK`` fails; compute term / measured is the counted
    MFU.  The memory term (eager traffic / 3.35 TB/s) is printed beside,
    not held: activations that stay in the 50 MB L2 beat it."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.op_analysis import analyze
    from repro_torch.models.layers import Policy
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime.train import RunConfig, make_train_step

    cfg = get_config(DRYRUN_ARCH)
    rng = np.random.default_rng(seed + 6)

    def timed(fn) -> list:
        fn()
        out = []
        for _ in range(DRYRUN_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return sorted(out)

    def train_step(device):
        run = RunConfig(model=cfg, global_batch=TRAIN_B, seq_len=TRAIN_S,
                        device=device)
        model = build_model(cfg, run.policy(), device)
        if device == "cuda":
            model.init(torch.Generator(device=device).manual_seed(seed + 6))
        opt = adamw_init(dict(model.named_parameters()), run.opt)
        step_fn = make_train_step(model, run)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (
            TRAIN_B, TRAIN_S)), device=device)
        batch = {"tokens": toks, "labels": toks}
        return lambda: step_fn(opt, batch, 4)[1]["loss"]

    def prefill(device):
        model = build_model(cfg, Policy(torch.bfloat16), device)
        if device == "cuda":
            model.init(torch.Generator(device=device).manual_seed(seed + 6))
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, 1024)),
                               device=device)
        return lambda: model.prefill(toks, model.init_cache(8, 1024))

    out = {}
    for what, make in (("train step", train_step), ("prefill", prefill)):
        st = analyze(make("meta"))
        fn = make("cuda")
        ms = timed(fn)
        del fn
        torch.cuda.empty_cache()
        med = ms[len(ms) // 2]
        t_c = st["flops"] / dryrun.CHIP_PEAK_FLOPS * 1e3
        t_m = st["traffic_bytes"] / dryrun.CHIP_HBM_BW * 1e3
        out[what] = dict(flops=st["flops"], traffic_bytes=st["traffic_bytes"],
                         kernels=st["kernels"], measured_ms=ms,
                         median_ms=med, compute_ms=t_c, memory_ms=t_m,
                         counted_mfu=t_c / med, memory_share=t_m / med)
        log("dryrun", f"{DRYRUN_ARCH} {what}, op analysis on 1 chip: "
            f"{st['flops']:.4e} flops, {st['traffic_bytes']:.4e} bytes "
            f"(eager); measured median {med:.2f} ms of {ms}; compute term "
            f"{t_c:.2f} ms = {t_c / med:.3f} of it (the counted MFU), memory "
            f"term {t_m:.2f} ms = {t_m / med:.3f} of it (not held: L2)")
        if t_c > DRYRUN_SLACK * med:
            fail(f"dryrun: the {what}'s counted flops take {t_c:.2f} ms at "
                 f"the peak, more than {DRYRUN_SLACK} x the measured "
                 f"{med:.2f} ms")
    return out


def dryrun_phase(seed: int, proc) -> dict:
    """The dry-run's cells (``dryrun_cells``, from the process that
    ``start_dryrun_cells`` started), then its count against the card
    (``dryrun_card_check``)."""
    t0 = time.perf_counter()
    cells = dryrun_cells(proc)
    waited = time.perf_counter() - t0
    doms = {}
    for key, r in cells["cells"].items():
        mesh = key.rsplit(" ", 1)[1]
        d = doms.setdefault(mesh, {})
        d[r["dominant"]] = d.get(r["dominant"], 0) + 1
    log("dryrun", f"{len(cells['cells'])} cells OK on both meshes in "
        f"{cells['wall_s']:.1f} s of their own process (waited "
        f"{waited:.1f} s for it here); dominant terms by mesh {doms}")
    card = dryrun_card_check(seed)
    return dict(cells=cells["cells"], cells_s=cells["wall_s"],
                waited_s=waited, dominant=doms, card=card,
                wall_s=time.perf_counter() - t0)


# --------------------------------------------------------------------------- #
# phase 7: trace
# --------------------------------------------------------------------------- #
META_KEYS = {"flash_attention": {"flops", "shape"},
             "ssd_scan": {"flops", "shape"},
             "fused_residual_rmsnorm": {"flops", "bytes", "shape"}}
PREFILL_ONLY = ("flash_attention", "ssd_scan")


def check_trace(arch: str, events: list, new: int):
    """A serving trace read back (``events``): step spans 0..new, each
    kernel of the path with its meta keys, a device duration, an issue
    latency >= 0, nested under its step (flash and the SSD scan in the
    prefill only)."""
    from collections import Counter
    from repro_torch.core.events import EventKind

    kinds = Counter(e.kind.value for e in events)
    log("trace", f"{arch}: {len(events)} events by kind: {dict(kinds)}")
    steps = {e.step: e for e in events if e.kind == EventKind.STEP}
    if sorted(steps) != list(range(new + 1)):
        fail(f"{arch}: step spans {sorted(steps)} != 0..{new}")
    comp = [e for e in events if e.kind == EventKind.KERNEL_COMPUTE]
    per_name = {}
    for name in sorted({op for op, *_ in path_kernels(arch).values()}):
        want_keys = META_KEYS[name]
        evs = [e for e in comp if e.name == name]
        if not evs:
            fail(f"{arch}: no k_comp span named {name}")
        if any(not want_keys <= set(e.meta) for e in evs):
            fail(f"{arch}: {name} span lacks meta keys {want_keys}")
        if any(e.duration <= 0 for e in evs):
            fail(f"{arch}: {name} span with device duration <= 0")
        if any(e.issue_latency < 0 for e in evs):
            fail(f"{arch}: {name} span starts before its issue")
        if any(e.meta.get("parent") != f"step_{e.step}" for e in evs):
            fail(f"{arch}: {name} span not nested under its step")
        if name in PREFILL_ONLY and any(e.step != 0 for e in evs):
            fail(f"{arch}: {name} span outside step_0 (the prefill)")
        per_name[name] = dict(n=len(evs),
                              device_s=sum(e.duration for e in evs))
    kern_s = sum(e.duration for e in comp)
    step_s = sum(e.duration for e in steps.values())
    log("trace", f"{arch}: kernel spans {per_name}; kernels {kern_s:.6f} s "
        f"of {step_s:.6f} s step wall time")
    if kern_s > step_s:
        fail(f"{arch}: kernel device time exceeds the steps' wall time")
    prefill = steps[0].duration
    decode = [steps[i].duration for i in range(1, new + 1)]
    dec = sorted(decode)
    dec_med = dec[len(dec) // 2] * 1e3
    log("serve", f"{arch} traced run: prefill step {prefill * 1e3:.3f} ms; "
        f"decode step median {dec_med:.3f} ms, min {dec[0] * 1e3:.3f}, max "
        f"{dec[-1] * 1e3:.3f} over {len(dec)} steps")
    return dict(prefill_s=prefill, decode_s=decode, per_name=per_name)


# --------------------------------------------------------------------------- #
# phase 5b: the reduced zoo on the card
# --------------------------------------------------------------------------- #
REDUCED_DIR = OUT_DIR / "reduced"
REDUCED_SERVE = (2, 64, 8)      # batch, prompt, new tokens
REDUCED_TRAIN = (2, 64, 3)      # batch, sequence, steps
REDUCED_AGREE_S = 64
# the launchers run once each as the user would, in processes of their own
REDUCED_CLI = (("serve", "zamba2-2.7b", ["--batch", "2", "--prompt-len",
                                         "64", "--new-tokens", "8"],
                "generated (2, 72) tokens"),
               ("train", "zamba2-2.7b", ["--steps", "3", "--batch", "2",
                                         "--seq", "64"], "final loss:"))
REDUCED_CLI_TIMEOUT_S = 300


def reduced_serve(arch: str, seed: int) -> dict:
    """The JAX package's reduced config of ``arch`` served on the card as
    it is (``REDUCED_SERVE``; the vlm's gates opened and seeded vision
    embeddings), the daemon spilling JSONL: each kernel of the path
    launched as often as the generate runs it, no plain version called,
    tokens in the vocabulary, and the trace read back (``check_trace``)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.runtime.serve import ServeConfig, Server

    cfg = get_reduced(arch)
    B, S0, new = REDUCED_SERVE
    kernels = path_kernels(arch)
    trace = REDUCED_DIR / f"serve_{arch}.jsonl"
    trace.unlink(missing_ok=True)
    server = Server(ServeConfig(model=cfg, batch=B, max_seq=S0 + new,
                                seed=seed, log_path=str(trace)))
    open_gates(server.model)
    vis = vision_embeds(cfg, B, seed + 2, "cuda", torch.bfloat16)
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S0)).astype(np.int32)
    for _, _, k, _ in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    with PlainCalls(cfg.family) as plain:
        out = server.generate(prompts, new_tokens=new, vision_embeds=vis)
    wall = time.perf_counter() - t0
    launches = {label: k.launches for label, (_, _, k, _) in kernels.items()}
    log_paths = server.daemon.log_paths
    server.close()
    want = {label: n(cfg, new) for label, (_, _, _, n) in kernels.items()}
    log("reduced", f"{arch} serve B{B} prompt {S0} new {new}: launches "
        f"{launches} (expected {want}); plain versions called "
        f"{plain.calls}; wall {wall:.3f} s")
    if launches != want:
        fail(f"{arch} reduced: launch counts {launches} != {want}")
    if any(plain.calls.values()):
        fail(f"{arch} reduced: serving called plain versions on the card: "
             f"{plain.calls}")
    if (out.shape != (B, S0 + new) or not np.array_equal(out[:, :S0], prompts)
            or out.min() < 0 or out.max() >= cfg.vocab_size):
        fail(f"{arch} reduced: generate returned {out.shape} or a token "
             f"outside [0, {cfg.vocab_size})")
    trace_check = check_trace(f"{arch}", read_spill(log_paths), new)
    return dict(launches=launches, plain_calls=plain.calls, wall_s=wall,
                trace=trace_check)


def reduced_train(arch: str, seed: int) -> dict:
    """``Trainer.train`` of the reduced config on the card
    (``REDUCED_TRAIN``, bf16 compute, fp32 parameters and moments, the
    daemon spilling JSONL): each kernel launched as often as the steps run
    it (``expected_step_launches``), no plain version called, the loss
    finite, and the trace's step and kernel spans, each of the forward's
    kernels a step with a device duration inside its step."""
    import math
    from collections import Counter
    from repro_torch.configs import get_reduced
    from repro_torch.core.events import EventKind
    from repro_torch.runtime.train import RunConfig, Trainer

    cfg = get_reduced(arch)
    B, S, steps = REDUCED_TRAIN
    kernels = train_kernels(arch)
    trace = REDUCED_DIR / f"train_{arch}.jsonl"
    trace.unlink(missing_ok=True)
    trainer = Trainer(RunConfig(model=cfg, global_batch=B, seq_len=S,
                                steps=steps, warmup_steps=1, seed=seed,
                                flare_log=str(trace)))
    for k, _, _ in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    with PlainCalls(cfg.family) as plain:
        hist = trainer.train()
    wall = time.perf_counter() - t0
    launches = {label: k.launches for label, (k, _, _) in kernels.items()}
    log_paths = trainer.daemon.log_paths
    want = {label: n * steps for label, n in
            expected_step_launches(arch, cfg, "bfloat16").items()}
    losses = [rec["loss"] for rec in hist]
    log("reduced", f"{arch} train B{B} S{S} {steps} steps: losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f"; launches {launches} (expected {want}); plain versions called "
        f"{plain.calls}; wall {wall:.3f} s")
    if launches != want:
        fail(f"{arch} reduced: training launch counts {launches} != {want}")
    if any(plain.calls.values()):
        fail(f"{arch} reduced: training called plain versions on the card: "
             f"{plain.calls}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        fail(f"{arch} reduced: training losses {losses}")
    events = read_spill(log_paths)
    seen = sorted(e.step for e in events if e.kind == EventKind.STEP)
    if seen != list(range(steps)):
        fail(f"{arch} reduced train: step spans {seen} != 0..{steps - 1}")
    for name, n in forward_launches(cfg).items():
        evs = [e for e in events if e.name == name]
        if Counter(e.step for e in evs) != {s: n for s in range(steps)} or any(
                e.duration <= 0 or e.meta.get("parent") != f"step_{e.step}"
                for e in evs):
            fail(f"{arch} reduced train: {len(evs)} {name} spans, not {n} a "
                 f"step, each with a device duration inside its step")
    # one step in fp32 compute: the fp32 routes (tf32x3) of each kernel
    fp32 = Trainer(RunConfig(model=cfg, global_batch=B, seq_len=S, steps=1,
                             warmup_steps=1, seed=seed, flare=False,
                             compute_dtype="float32"))
    for k, _, _ in kernels.values():
        k.launches = 0
    with PlainCalls(cfg.family) as plain32:
        loss32 = fp32.train()[0]["loss"]
    launches32 = {label: k.launches for label, (k, _, _) in kernels.items()}
    want32 = expected_step_launches(arch, cfg, "float32")
    log("reduced", f"{arch} one fp32 train step: loss {loss32:.4f}; launches "
        f"{launches32} (expected {want32})")
    if (launches32 != want32 or any(plain32.calls.values())
            or not math.isfinite(loss32)):
        fail(f"{arch} reduced fp32 step: launches {launches32} != {want32}, "
             f"plain calls {plain32.calls} or loss {loss32}")
    return dict(launches=launches, plain_calls=plain.calls, wall_s=wall,
                losses=losses, events=len(events), fp32_step_loss=loss32,
                fp32_step_launches=launches32)


def reduced_cli(seed: int) -> dict:
    """``python -m repro_torch.launch.serve`` and ``... .train`` with
    ``--reduced``, each in a process of its own as a user starts it (the
    card by default): exit 0 and the launcher's last line."""
    import os
    out = {}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for verb, arch, extra, done in REDUCED_CLI:
        cmd = [sys.executable, "-m", f"repro_torch.launch.{verb}", "--arch",
               arch, "--reduced", "--seed", str(seed), *extra]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=REDUCED_CLI_TIMEOUT_S)
        wall = time.perf_counter() - t0
        last = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
        log("reduced", f"{' '.join(cmd[1:])}: exit {p.returncode} in "
            f"{wall:.1f} s; last line: {last}")
        if p.returncode != 0 or done not in p.stdout:
            fail(f"{' '.join(cmd[1:])} exited {p.returncode}: "
                 f"{p.stderr[-2000:]}")
        out[verb] = dict(cmd=cmd[1:], rc=p.returncode, wall_s=wall,
                         last_line=last)
    return out


def reduced_phase(seed: int) -> dict:
    """Every arch's reduced config (the JAX package's, at its own widths:
    head_dim 16, 8 for qwen2-72b and llama3-405b; mamba2's and zamba2's
    SSD at P 16, N 16, chunk 16) on the card: served (``reduced_serve``),
    trained (``reduced_train``), its fp32 prefill logits against the
    port's CPU run (``agreement``, the fp32 routes), then the two
    launchers with ``--reduced`` (``reduced_cli``)."""
    from repro_torch.configs import get_reduced, list_archs
    REDUCED_DIR.mkdir(parents=True, exist_ok=True)
    runs = {}
    for arch in list_archs():
        t0 = time.perf_counter()
        cfg = get_reduced(arch)
        run = runs[arch] = dict(serve=reduced_serve(arch, seed),
                                train=reduced_train(arch, seed))
        err, launches, routing = agreement(arch, seed, REDUCED_AGREE_S, {},
                                           cfg=cfg)
        run["agreement"] = dict(max_abs_err=err, launches=launches,
                                routing=routing)
        run["wall_s"] = time.perf_counter() - t0
        widths = ([f"hd {cfg.head_dim}"] if cfg.family != "ssm" else []) + (
            [f"SSD P {cfg.ssm_head_dim} N {cfg.ssm_state} chunk "
             f"{cfg.ssm_chunk}"] if cfg.family in ("ssm", "hybrid") else [])
        log("reduced", f"{arch} ({', '.join(widths)}): served, trained, "
            f"fp32 prefill max_abs_err {err:.3e} "
            f"card vs CPU, {run['wall_s']:.1f} s")
    return dict(paths=runs, cli=reduced_cli(seed))


# (arch, the serving run's cut, agreement prompt length, the agreement's
# cut), each cut a dict of ``configs.scale`` overrides, {} for the
# published config; widths are never cut.  Depths cut to keep the run in
# its time: mamba2-780m and musicgen-large 12 of 48 layers, zamba2-2.7b 12
# of 54 (two applications of the shared block), llama-3.2-vision-11b 2 of
# its 8 groups; one card holds dbrx-132b's weights (bf16) for 8 of its 40
# layers (54.6 GB) and arctic-480b's for 2 of 35 (55.4 GB, all 128
# experts).  The agreements run the serving cut, but for the vlm's one
# group (5 layers) and the moe paths' training cuts (``train_cut``: one
# layer; arctic 32 experts).  mamba2's and zamba2's S 320 is one full
# chunk of 256 and a ragged one.  llama-20b-paper, whole on one card (34.8
# GB of bf16 weights), serves 8 of its 62 layers, and qwen2-72b and
# llama3-405b, which one card holds for 30 of 80 (57.6 GB) and 8 of 126
# layers (59.4 GB), serve 5 and 2, cut to keep the phases near 950 s
# with the width checks, the reduced phase and the mesh training step
# (16, 10 and 4 before it); their fp32
# agreements run cuts of 2, 2 and 1 layers (llama3-405b's one layer and
# its embedding and head are 29.6 GB of fp32 on the card and again on the
# CPU).
PATHS = (("llama3.2-1b", {}, 64, {}),
         ("mamba2-780m", dict(num_layers=12), 320, dict(num_layers=12)),
         ("zamba2-2.7b", dict(num_layers=12), 320, dict(num_layers=12)),
         ("qwen2-0.5b", {}, 64, {}),
         ("musicgen-large", dict(num_layers=12), 64, dict(num_layers=12)),
         ("llama-3.2-vision-11b", dict(num_layers=10), 64,
          dict(num_layers=5)),
         ("dbrx-132b", dict(num_layers=8), 64,
          dict(num_layers=1)),
         ("arctic-480b", dict(num_layers=2), 64,
          dict(num_layers=1, num_experts=32)),
         ("llama-20b-paper", dict(num_layers=8), 64, dict(num_layers=2)),
         ("qwen2-72b", dict(num_layers=5), 64, dict(num_layers=2)),
         ("llama3-405b", dict(num_layers=2), 64, dict(num_layers=1)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()
    walls = {}

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
    from repro_torch.kernels.padded_matmul import ops as mm
    from repro_torch.kernels.ring_reduce import ops as ring
    from repro_torch.kernels.ssd_scan import ops as ssd

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

    # the daemon's clock over a long attach: one daemon attached now, kept
    # until after the last training path (``long_attach_check``)
    from repro_torch.store import have_zstd
    long_daemon, long_events, t_long = long_attach_daemon()
    log("daemon", f"have_zstd() {have_zstd()}: FCS v2 spills name zlib; a "
        f"daemon attached for the whole run, unpublished")

    # 2. build
    t0 = time.perf_counter()
    all_kernels = (*fa.KERNELS.values(), fn.KERNEL, *ssd.KERNELS.values(),
                   *mm.KERNELS.values(), ring.KERNEL,
                   *fa.BWD_KERNELS.values(), fn.BWD_KERNEL,
                   *ssd.BWD_KERNELS.values())
    build_all(list(all_kernels))
    walls["build"] = time.perf_counter() - t0
    log("build", f"built {', '.join(sorted({k.source for k in all_kernels}))}"
        f" for sm_90a in {time.perf_counter() - t0:.1f} s")
    for k in all_kernels:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"{k.source}: {line.strip()}")
    # the tensor-core routes (the flash and SSD backwards' too, and the
    # split-TF32 fp32 routes) hold wgmma (HGMMA) in their SASS
    for routes in (fa.KERNELS, ssd.KERNELS, mm.KERNELS, fa.BWD_KERNELS,
                   ssd.BWD_KERNELS):
        for route, k in routes.items():
            n = sass_mma(k)
            log("build", f"{k.source} [{route}]: {n['HGMMA']} HGMMA, "
                f"{n['HMMA']} HMMA in the SASS")
            if route in ("wgmma", "tf32x3") and not n["HGMMA"]:
                fail(f"{k.source} [{route}]: no HGMMA in its SASS")
    # the fused-norm backward (memory-bound) runs on the FP32 pipes: no
    # tensor-core instruction
    n = sass_mma(fn.BWD_KERNEL)
    log("build", f"{fn.BWD_KERNEL.source}: {n['HGMMA']} HGMMA, {n['HMMA']} "
        f"HMMA in the SASS (on the FP32 pipes: none)")
    if n["HGMMA"] or n["HMMA"]:
        fail(f"{fn.BWD_KERNEL.source}: {n} tensor-core instructions")

    # the dry-run's cells start now, on the host's CPU, beside the card's
    # phases; phase 8 waits for them
    dry_proc = start_dryrun_cells()

    # 3. kernels
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    flash_sums, flash_cases = check_flash(gen, "cuda")
    fused, fused_rows, fused_cases = check_fused(gen, "cuda")
    scan, scan_fp32, ssd_cases = check_ssd(gen, "cuda")
    matmul, matmul_fp32, matmul_cases = check_padded_matmul(gen, "cuda")
    combine, combine_cases = check_ring_combine(gen, "cuda")
    flash_bwd_sums, flash_bwd_cases = check_flash_bwd(gen, "cuda")
    fused_bwd, fused_bwd_cases = check_fused_bwd(gen, "cuda")
    ssd_bwd, ssd_bwd_fp32, ssd_bwd_cases = check_ssd_bwd(gen, "cuda")
    narrow, width_cases = check_widths(gen, "cuda")
    walls["kernels"] = time.perf_counter() - t0
    log("wall", f"kernels {walls['kernels']:.1f} s, "
        f"{time.perf_counter() - t_start:.1f} s in all")

    # 4. the Case-2 op and the ring path, traced
    t0 = time.perf_counter()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    case2 = case2_path(args.seed, OUT_DIR / "case2_trace.jsonl")
    ring_run = ring_path(args.seed, OUT_DIR / "ring_traces")
    walls["case2 and ring"] = time.perf_counter() - t0

    # 4b. the port's diagnostic engine on the drills' traces, the drilled
    # jobs streaming live into the fleet
    t0 = time.perf_counter()
    fleet = FleetLive()
    diagnosis = diagnose_phase(args.seed, ring_run, OUT_DIR / "ring_traces",
                               fleet)
    walls["diagnose"] = time.perf_counter() - t0
    log("wall", f"diagnose {walls['diagnose']:.1f} s, "
        f"{time.perf_counter() - t_start:.1f} s in all")

    # 4c. the fleet: the fail-slow drill, replays, the archive, the hangs
    t0 = time.perf_counter()
    fleet_run = fleet_phase(args.seed, fleet, OUT_DIR / "ring_traces",
                            diagnosis)
    walls["fleet"] = time.perf_counter() - t0
    log("wall", f"fleet {walls['fleet']:.1f} s, "
        f"{time.perf_counter() - t_start:.1f} s in all")

    # 4d. the resident fleet service, fed by two jobs' live sinks
    t0 = time.perf_counter()
    service_run = service_phase(args.seed, fleet)
    walls["service"] = time.perf_counter() - t0
    log("wall", f"service {walls['service']:.1f} s, "
        f"{time.perf_counter() - t_start:.1f} s in all")

    # 4e. the cluster simulator: the scenario matrix, the 1024-rank drills,
    # and one service fed by simulated jobs beside a traced job
    t0 = time.perf_counter()
    sim_run = simulate_phase(args.seed, fleet,
                             service_run["svc_a"]["bracket_s"])
    walls["simulate"] = time.perf_counter() - t0
    log("wall", f"simulate {walls['simulate']:.1f} s, "
        f"{time.perf_counter() - t_start:.1f} s in all")

    # 4f. the parallel plane: the GPipe pipeline and expert parallelism
    t0 = time.perf_counter()
    par_run = parallel_phase(args.seed)
    walls["parallel"] = time.perf_counter() - t0
    log("wall", f"parallel {walls['parallel']:.1f} s, "
        f"{time.perf_counter() - t_start:.1f} s in all")

    # 5. serve, and 6. trace, for each serving path
    runs, traces, errs, fp32_launches, routing = {}, {}, {}, {}, {}
    spills = {}
    for arch, cut, agree_s, agree_cut in PATHS:
        t_path = time.perf_counter()
        tap = SpillTap() if arch == SPILL_ARCH else None
        ext = "fcs2" if tap else "jsonl"
        trace_path = OUT_DIR / f"serve_trace_{arch}.{ext}"
        for old in OUT_DIR.glob(f"serve_trace_{arch}*"):
            old.unlink()
        run = runs[arch] = serve(arch, cut, args.seed, trace_path,
                                 per_call=arch == "llama3.2-1b", tap=tap)
        t_agree = time.perf_counter()
        errs[arch], fp32_launches[arch], routing[arch] = agreement(
            arch, args.seed, agree_s, agree_cut)
        walls[f"agreement {arch}"] = time.perf_counter() - t_agree
        if tap:
            events, spills[f"{arch} serve"] = check_spill(
                f"{arch} serve, FCS v2 (zlib) rotated", run["spill"], tap,
                SERVE_SPILL_PIECES)
        else:
            events = read_spill(run["spill"]["log_paths"])
        traces[arch] = check_trace(arch, events, run["new"])
        walls[f"serve {arch}"] = time.perf_counter() - t_path
        log("wall", f"serve {arch} {walls[f'serve {arch}']:.1f} s (its "
            f"agreement {walls[f'agreement {arch}']:.1f} s), "
            f"{time.perf_counter() - t_start:.1f} s in all")
        B, new = run["B"], run["new"]
        dec = sorted(traces[arch]["decode_s"])
        dec_med = dec[len(dec) // 2]
        log("serve", f"{arch}: {B / dec_med:.1f} tokens/s at the median "
            f"decode step; generate wall {run['wall_s']:.3f} s traced "
            f"(first run), {run['warm_wall_s']:.3f} s untraced (best later "
            f"run, {B * new / run['warm_wall_s']:.1f} new tokens/s)")

    # 6. train, and 7. its trace, for each training path; the tracing
    # overhead and the checkpoint round trip on llama's; first one step of
    # llama's path under each remat
    t0 = time.perf_counter()
    remat = remat_check(args.seed)
    walls["remat"] = time.perf_counter() - t0
    train_runs, train_agree, train_traces, anchors = {}, {}, {}, {}
    for arch in TRAIN_PATHS:
        t_path = time.perf_counter()
        dense = arch == "llama3.2-1b"
        tap = SpillTap() if arch == SPILL_ARCH else None
        ext = "fcs" if tap else "jsonl"
        trace_path = OUT_DIR / f"train_trace_{arch}.{ext}"
        trace_path.unlink(missing_ok=True)
        n_anchors = long_daemon.telemetry.value("daemon.anchors")
        train_runs[arch] = train(arch, args.seed, trace_path,
                                 with_overhead=dense, tap=tap)
        anchors[arch] = (long_daemon.telemetry.value("daemon.anchors")
                         - n_anchors)
        train_agree[arch] = train_agreement(
            arch, args.seed, OUT_DIR / "ckpt" if dense else None)
        spill = train_runs[arch]["spill"]
        if tap:
            events, spills[f"{arch} train"] = check_spill(
                f"{arch} train, FCS v1", spill, tap)
        else:
            events = read_spill(spill["log_paths"])
        train_traces[arch] = check_train_trace(arch, events, TRAIN_STEPS)
        walls[f"train {arch}"] = time.perf_counter() - t_path
        log("wall", f"train {arch} {walls[f'train {arch}']:.1f} s, "
            f"{time.perf_counter() - t_start:.1f} s in all")

    long_attach = long_attach_check(long_daemon, long_events, t_long, anchors)

    # 6b. the reduced zoo: every arch's reduced config served and trained
    t0 = time.perf_counter()
    reduced = reduced_phase(args.seed)
    walls["reduced"] = time.perf_counter() - t0
    log("wall", f"reduced {walls['reduced']:.1f} s, "
        f"{time.perf_counter() - t_start:.1f} s in all")

    # 8. the dry-run: every cell on both production meshes, and its op
    # analysis against the card
    t0 = time.perf_counter()
    dry_run = dryrun_phase(args.seed, dry_proc)
    walls["dryrun"] = time.perf_counter() - t0
    log("wall", f"dryrun {walls['dryrun']:.1f} s, "
        f"{time.perf_counter() - t_start:.1f} s in all")

    # each summary's launches: the main path's runs of its kernel (for
    # flash, the paths of its head dim and group size: llama's, qwen2's and
    # musicgen's hd 64, zamba2's 80, the vlm's 128 at G 4, dbrx's at G 6,
    # arctic's at G 7; ``path_flash_key``)
    from repro_torch.configs import get_config, get_reduced
    cfgs = {arch: get_config(arch) for arch, *_ in PATHS}
    cfgs.update({f"reduced:{arch}": get_reduced(arch)
                 for arch in reduced["paths"]})
    red_serve = {f"reduced:{a} serve": r["serve"]["launches"]
                 for a, r in reduced["paths"].items()}
    red_train = {f"reduced:{a} train": r["train"]["launches"]
                 for a, r in reduced["paths"].items()}
    red_fp32 = {f"reduced:{a} fp32 prefill": r["agreement"]["launches"]
                for a, r in reduced["paths"].items()}
    red_fp32.update({f"reduced:{a} fp32 train step":
                     r["train"]["fp32_step_launches"]
                     for a, r in reduced["paths"].items()})
    by_path = {arch: run["launches"] for arch, run in runs.items()}
    by_path.update({f"{arch} train": run["launches"]
                    for arch, run in train_runs.items()})
    case3 = diagnosis["case3"]
    case3_jobs = {f"{case3['arch']} case3 {job} train": run["launches"]
                  for job, run in case3["jobs"].items()}
    case3_jobs.update({f"{case3['arch']} fleet {job} train": run["launches"]
                       for job, run in fleet_run["failslow"]["jobs"].items()})
    case3_jobs.update({f"{case3['arch']} service {job} train":
                       service_run[job.replace("-", "_")]["launches"]
                       for job in ("svc-a", "svc-b")})
    case3_jobs[f"{case3['arch']} simulate {SVC_M} train"] = \
        sim_run["service"]["launches"]
    by_path.update(case3_jobs)
    par_paths = {f"{PAR_ARCHS.get(tag.split()[0], EP_ARCH)} parallel "
                 f"{tag}, {PAR_WORLD} ranks": n
                 for tag, n in par_run["launches"].items()}
    by_path.update(par_paths)

    def count(summary, label, paths, key=None, keys=()):
        def of(p):
            c = cfgs[p.split()[0]]
            return path_flash_key(keys, c.head_dim,
                                  c.num_heads // max(c.num_kv_heads, 1))
        per = {p: n[label] for p, n in paths.items() if label in n
               and (key is None or of(p) == key)}
        summary["launches"] = sum(per.values())
        summary["launches_by_path"] = per

    for (route, *key), summary in flash_sums.items():
        keys = [tuple(k) for r, *k in flash_sums if r == route]
        if route == "wgmma":
            count(summary, "flash_attention[wgmma]",
                  {**by_path, **red_serve, **red_train}, tuple(key), keys)
        else:
            count(summary, "flash_attention[tf32x3]",
                  {**{f"{a} fp32 prefill": n
                      for a, n in fp32_launches.items()}, **red_fp32},
                  tuple(key), keys)
    count(fused, "fused_residual_rmsnorm",
          {**by_path, **red_serve, **red_train})
    count(scan, "ssd_scan[wgmma]", by_path)
    count(scan_fp32, "ssd_scan[tf32x3]",
          {f"{a} fp32 prefill": n for a, n in fp32_launches.items()})
    count(narrow["fwd", "wgmma"], "ssd_scan[wgmma]",
          {**red_serve, **red_train})
    count(narrow["fwd", "tf32x3"], "ssd_scan[tf32x3]", red_fp32)
    count(narrow["bwd", "wgmma"], "ssd_scan_bwd[wgmma]", red_train)
    count(narrow["bwd", "tf32x3"], "ssd_scan_bwd[tf32x3]", red_fp32)
    for summary, dtype, route in ((matmul, "bfloat16", "wgmma"),
                                  (matmul_fp32, "float32", "tf32x3")):
        n = case2[dtype]["launches"][route]
        summary["launches_by_path"] = {f"case2 padded_matmul {dtype}": n}
        if dtype == "bfloat16":
            summary["launches_by_path"]["diagnose case2 fixed job"] = \
                diagnosis["case2"]["launches"][route]
        summary["launches"] = sum(summary["launches_by_path"].values())
    agree = {f"{a} fp32 {TRAIN_PATHS[a]['agree_layers']}-layer agreement "
             f"step": r["launches"] for a, r in train_agree.items()}
    trains = {f"{a} train": r["launches"] for a, r in train_runs.items()}
    trains.update(case3_jobs)
    for (route, *key), summary in flash_bwd_sums.items():
        keys = [tuple(k) for r, *k in flash_bwd_sums if r == route]
        count(summary, f"flash_attention_bwd[{route}]",
              {**trains, **red_train, **par_paths} if route == "wgmma"
              else {**agree, **red_fp32}, tuple(key), keys)
    count(fused_bwd, "fused_residual_rmsnorm_bwd",
          {**trains, **red_train, **red_fp32, **par_paths})
    count(ssd_bwd, "ssd_scan_bwd[wgmma]", trains)
    count(ssd_bwd_fp32, "ssd_scan_bwd[tf32x3]", agree)
    combine["launches_by_path"] = {
        f"ring all-reduce, 25 MB bucket ({RING_WORLD} ranks)":
            ring_run["launches"],
        f"ring all-reduce, {RING_ODD_NUMEL}-element bucket":
            ring_run["odd_launches"],
        **{p: n["ring_combine"] for p, n in par_paths.items()}}
    combine["launches"] = sum(combine["launches_by_path"].values())
    details = dict(card=card, seed=args.seed, flash_cases=flash_cases,
                   fused_cases=fused_cases, fused_rows=fused_rows,
                   ssd_cases=ssd_cases, matmul_cases=matmul_cases,
                   combine_cases=combine_cases, case2=case2, ring=ring_run,
                   fp32_prefill_max_abs_err=errs,
                   fp32_prefill_launches=fp32_launches,
                   fp32_prefill_routing=routing, serve=runs,
                   trace=traces, flash_bwd_cases=flash_bwd_cases,
                   fused_bwd_cases=fused_bwd_cases,
                   ssd_bwd_cases=ssd_bwd_cases, train=train_runs,
                   train_agreement=train_agree, train_trace=train_traces,
                   remat=remat, spills=spills, long_attach=long_attach,
                   have_zstd=have_zstd(), diagnose=diagnosis,
                   width_cases=width_cases, narrow_ssd=list(narrow.values()),
                   reduced=reduced,
                   fleet=fleet_run, service=service_run, simulate=sim_run,
                   parallel=par_run, dryrun=dry_run)
    walls["total"] = details["wall_s"] = time.perf_counter() - t_start
    details["phase_wall_s"] = walls
    log("wall", "phases, s: " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in walls.items()))
    (OUT_DIR / "details.json").write_text(json.dumps(details, indent=1))
    print(json.dumps({"kernels": [
        *flash_sums.values(), fused, scan, scan_fp32, matmul, matmul_fp32,
        combine, *flash_bwd_sums.values(), fused_bwd, ssd_bwd,
        ssd_bwd_fp32, *narrow.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
