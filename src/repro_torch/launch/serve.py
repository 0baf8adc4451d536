"""Serving launcher CLI (batched prefill + greedy decode) on the CUDA card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-large
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llama-3.2-vision-11b      # vision embeddings: ones (a stub)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch dbrx-132b \
        --reduced                        # the JAX package's reduced config
    PYTHONPATH=src python -m repro_torch.launch.serve --arch arctic-480b \
        --reduced --device cpu

The moe family's published configs take the card's kernels but not its
memory: dbrx-132b's bf16 weights alone are 263 GB.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.models.registry import kernel_refusal
from repro_torch.runtime.serve import ServeConfig, Server


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced config (the JAX package's, "
                    "on the card or with --device cpu)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128,
                    help="KV-cache length (every family with attention; "
                    "the SSM cache has no length)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-path", default=None,
                    help="the FLARE trace's spill; its extension picks the "
                    "codec: .jsonl, .fcs (FCS v1) or .fcs2 (FCS v2)")
    args = ap.parse_args()

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    refusal = kernel_refusal(cfg) if args.device != "cpu" else None
    if refusal:
        ap.error(f"{refusal}; serve this config with --device cpu")
    server = Server(ServeConfig(model=cfg, batch=args.batch,
                                max_seq=args.max_seq, seed=args.seed,
                                device=args.device, log_path=args.log_path))
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.perf_counter()
    out = server.generate(prompts, new_tokens=args.new_tokens)
    dt = time.perf_counter() - t0
    print(f"generated {out.shape} tokens in {dt:.3f}s; "
          f"sample row: {out[0, -8:]}")
    server.close()


if __name__ == "__main__":
    main()
