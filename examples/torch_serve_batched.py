"""Batched serving with FLARE attached: prefill + greedy decode.

    PYTHONPATH=src python examples/torch_serve_batched.py --arch qwen2-0.5b

The port's counterpart of ``examples/serve_batched.py``: the same arguments
and output, importing nothing but ``repro_torch``.  It serves the JAX
package's reduced config of the arch, at its own widths, on the card
unless ``--device cpu`` is given.
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_reduced, list_archs
from repro_torch.runtime.serve import ServeConfig, Server


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch)
    server = Server(ServeConfig(model=cfg, batch=args.batch, max_seq=96,
                                device=args.device))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.perf_counter()
    out = server.generate(prompts, new_tokens=args.new_tokens)
    dt = time.perf_counter() - t0
    print(f"arch={args.arch} generated {out.shape[0]}x{args.new_tokens} "
          f"tokens in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s)")
    print("sample:", out[0, -10:])
    d = server.daemon
    print(f"FLARE events: {d.events_emitted}")
    server.close()


if __name__ == "__main__":
    main()
