#!/usr/bin/env python3
"""Peak device memory of a training step at full width, by depth,
parameter and AdamW moment dtype, remat and microbatches.

    python3 tools/train_memory.py --arch zamba2-2.7b [--microbatches 1,2]
        [--state-dtype float32,bfloat16] [--param-dtype float32]
        [--remat none] [--layers N[,N...]] [--num-experts E]
        [--peak-lr 3e-4[,LR...]] [--warmup 1]
        [--batch 8] [--seq 512] [--steps 2]

On one CUDA card: for each combination of the comma-separated lists (layer
counts, parameter dtypes, remat modes, moment dtypes, peak learning
rates, microbatch counts),
a fresh ``Trainer`` of the arch's full config (cut to that many layers
and, for the moe family, ``--num-experts`` experts through
``configs.scale`` when given, widths and top-k kept; bf16 compute, no
tracing) takes ``--steps`` steps of ``--batch`` x ``--seq`` tokens, and
the line names the peak of ``torch.cuda.max_memory_allocated``, the
median step time and each step's loss, or the out-of-memory error the step
raised.  With ``--steps 12 --warmup 4`` the steps are those of a
``chip_smoke.py`` training path, so the losses show whether a policy
trains.  This is how
a training path chooses its cut, moment dtype and microbatches: the
deepest cut whose step fits, the fewest microbatches, fp32 moments where
they fit (or the JAX package's policy for the arch: ``--param-dtype
bfloat16 --state-dtype int8 --remat full`` for its largest models).
Prints the card's name and power limit first.  Exits non-zero without a
card.
"""
from __future__ import annotations

import argparse
import gc
import itertools
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--microbatches", default="1,2")
    ap.add_argument("--state-dtype", default="float32",
                    help="AdamW moment dtypes, comma-separated (float32, "
                    "bfloat16, int8)")
    ap.add_argument("--param-dtype", default="float32",
                    help="parameter dtypes, comma-separated (float32, "
                    "bfloat16)")
    ap.add_argument("--remat", default="none",
                    help="remat modes, comma-separated (none, dots, full)")
    ap.add_argument("--layers", default=None,
                    help="cut the config to this many layers, "
                    "comma-separated counts")
    ap.add_argument("--num-experts", type=int, default=None,
                    help="cut a moe config to this many experts")
    ap.add_argument("--peak-lr", default="3e-4",
                    help="peak learning rates, comma-separated")
    ap.add_argument("--warmup", type=int, default=1,
                    help="warmup steps of the schedule")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this measurement needs one card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config, scale
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train import RunConfig, Trainer

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    base = get_config(args.arch)
    if args.num_experts is not None:
        base = scale(base, num_experts=args.num_experts)
    depths = ([None] if args.layers is None
              else [int(n) for n in args.layers.split(",")])
    for n, pd, remat, sd, lr, m in itertools.product(
            depths, args.param_dtype.split(","), args.remat.split(","),
            args.state_dtype.split(","),
            [float(lr) for lr in args.peak_lr.split(",")],
            [int(m) for m in args.microbatches.split(",")]):
        cfg = base if n is None else scale(base, num_layers=n)
        run = RunConfig(model=cfg, global_batch=args.batch,
                        seq_len=args.seq, num_microbatches=m,
                        steps=args.steps, warmup_steps=args.warmup,
                        peak_lr=lr, flare=False, param_dtype=pd, remat=remat,
                        opt=AdamWConfig(state_dtype=sd))
        experts = (f", {cfg.num_experts} experts" if cfg.num_experts
                   else "")
        what = (f"{args.arch} ({cfg.num_layers} layers{experts}) "
                f"B{args.batch} S{args.seq} parameters {pd} remat {remat} "
                f"moments {sd} peak lr {lr:g} microbatches {m}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = None
        try:
            trainer = Trainer(run)
            hist = trainer.train()
            ms = sorted(r["step_time_s"] * 1e3 for r in hist)
            print(f"[memory] {what}: peak "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
                  f"(torch.cuda.max_memory_allocated), step median "
                  f"{ms[len(ms) // 2]:.1f} ms over {len(ms)} steps, losses "
                  f"{[round(r['loss'], 4) for r in hist]}", flush=True)
        except torch.cuda.OutOfMemoryError as e:
            print(f"[memory] {what}: out of memory after a peak of "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB: "
                  f"{str(e).splitlines()[0]}", flush=True)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
