#!/usr/bin/env python3
"""Peak device memory of a training step at full width, by microbatches
and AdamW moment dtype.

    python3 tools/train_memory.py --arch zamba2-2.7b [--microbatches 1,2]
        [--state-dtype float32,bfloat16] [--layers N] [--num-experts E]
        [--batch 8] [--seq 512] [--steps 2]

On one CUDA card: for each moment dtype and microbatch count, a fresh
``Trainer`` of the arch's full config (cut to ``--layers`` layers and, for
the moe family, ``--num-experts`` experts through ``configs.scale`` when
given, widths and top-k kept; bf16 compute, fp32 parameters,
no tracing) takes ``--steps`` steps of ``--batch`` x ``--seq`` tokens, and
the line names the peak of ``torch.cuda.max_memory_allocated`` and the
median step time, or the out-of-memory error the step raised.  This is how
a training path chooses its moment dtype and microbatches: the fewest
microbatches whose step fits, fp32 moments where they fit.  Prints the
card's name and power limit first.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import gc
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
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers")
    ap.add_argument("--num-experts", type=int, default=None,
                    help="cut a moe config to this many experts")
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
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = scale(cfg, num_layers=args.layers)
    if args.num_experts is not None:
        cfg = scale(cfg, num_experts=args.num_experts)
    for sd, m in ((sd, int(m)) for sd in args.state_dtype.split(",")
                  for m in args.microbatches.split(",")):
        run = RunConfig(model=cfg, global_batch=args.batch,
                        seq_len=args.seq, num_microbatches=m,
                        steps=args.steps, warmup_steps=1, flare=False,
                        opt=AdamWConfig(state_dtype=sd))
        experts = (f", {cfg.num_experts} experts" if cfg.num_experts
                   else "")
        what = (f"{args.arch} ({cfg.num_layers} layers{experts}) "
                f"B{args.batch} "
                f"S{args.seq} moments {sd} microbatches {m}")
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
