"""Serving launcher CLI (batched prefill + greedy decode) on the CUDA card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, get_reduced, list_archs
from repro_torch.kernels.flash_attention.ops import HEAD_DIMS
from repro_torch.kernels.ssd_scan.ops import kernel_takes
from repro_torch.runtime.serve import ServeConfig, Server


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced config; the reduced configs "
                    "run only with --device cpu, since the flash-attention "
                    "kernels take head_dim 64 or 128 and the SSD-scan "
                    "kernel head_dim 64, state 64 or 128 and chunk 64-256")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128,
                    help="KV-cache length (dense family; the SSM cache has "
                    "no length)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-path", default=None,
                    help="JSONL spill of the FLARE trace")
    args = ap.parse_args()

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if (cfg.family == "ssm" and args.device != "cpu" and not kernel_takes(
            cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk)):
        ap.error(f"the SSD-scan kernel has no instance for head_dim "
                 f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
                 f"{cfg.ssm_chunk}; serve this config with --device cpu")
    if (cfg.family == "dense" and args.device != "cpu"
            and cfg.head_dim not in HEAD_DIMS):
        ap.error(f"the flash-attention kernels take head_dim {HEAD_DIMS}, "
                 f"not {cfg.head_dim}; serve this config with --device cpu")
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
