"""Training launcher CLI, on the CUDA card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --steps 20 --batch 8 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --reduced --device cpu --steps 30 --mask-mode naive   # Case-3
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \
        --steps 20 --batch 8 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \
        --steps 20 --batch 8 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --steps 20 --batch 8 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --arch musicgen-large \
        --steps 20 --batch 8 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch llama-3.2-vision-11b --reduced --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch dbrx-132b \
        --reduced --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch arctic-480b \
        --reduced --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama-20b-paper \
        --reduced --device cpu --steps 20 --remat full

The moe family's published configs, qwen2-72b and llama3-405b take the
card's kernels but not its memory: dbrx-132b's bf16 weights alone are
263 GB.  ``--remat full`` recomputes each layer's activations in the
backward, ``dots`` all but the matrix products' outputs.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.models.registry import kernel_refusal
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.train import RunConfig, Trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced config (the JAX package's, "
                    "on the card or with --device cpu)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--opt-dtype", default="float32",
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--compute-dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--remat", default="none",
                    choices=["none", "dots", "full"])
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--mask-mode", default="none",
                    choices=["none", "naive", "fast"])
    ap.add_argument("--no-flare", action="store_true")
    ap.add_argument("--flare-log", default=None,
                    help="the FLARE trace's spill; its extension picks the "
                    "codec: .jsonl, .fcs (FCS v1) or .fcs2 (FCS v2)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    refusal = kernel_refusal(cfg) if args.device != "cpu" else None
    if refusal:
        ap.error(f"{refusal}; train this config with --device cpu")
    run = RunConfig(
        model=cfg, global_batch=args.batch, seq_len=args.seq,
        steps=args.steps, peak_lr=args.lr,
        num_microbatches=args.microbatches,
        opt=AdamWConfig(lr=args.lr, state_dtype=args.opt_dtype),
        remat=args.remat, compute_dtype=args.compute_dtype, seed=args.seed,
        checkpoint_dir=args.checkpoint_dir, flare=not args.no_flare,
        flare_log=args.flare_log, mask_mode=args.mask_mode,
        device=args.device)
    hist = Trainer(run).train()
    for rec in hist[:: max(len(hist) // 10, 1)]:
        print(json.dumps(rec))
    print(f"final loss: {hist[-1]['loss']:.4f} "
          f"({hist[-1]['tokens_per_s']:.0f} tok/s)")


if __name__ == "__main__":
    main()
