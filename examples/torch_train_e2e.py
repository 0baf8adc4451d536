"""End-to-end training: a ~100M llama-family model, synthetic corpus,
FLARE daemon attached, checkpointing + fault-tolerant supervisor.

CPU-friendly default is the 10M scale for a few hundred steps; pass
--scale 100m for the full-size run (same code path):

    PYTHONPATH=src python examples/torch_train_e2e.py --steps 120
    PYTHONPATH=src python examples/torch_train_e2e.py --scale 100m --steps 300

The port's counterpart of ``examples/train_e2e.py``: the same arguments,
run and output, importing nothing but ``repro_torch``.  It trains on the
card (the 10m model at its head_dim 32) unless ``--device cpu`` is given.
"""
import argparse
import tempfile

import numpy as np

from repro_torch.configs import ModelConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.supervisor import SimulatedFault, Supervisor
from repro_torch.runtime.train import RunConfig, Trainer

SCALES = {
    "10m": ModelConfig(name="llama-10m", family="dense", num_layers=4,
                       d_model=256, num_heads=8, num_kv_heads=4, d_ff=1024,
                       vocab_size=4096, tie_embeddings=True),
    "100m": ModelConfig(name="llama-100m", family="dense", num_layers=12,
                        d_model=768, num_heads=12, num_kv_heads=4,
                        d_ff=3072, vocab_size=8192, tie_embeddings=True),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", default="10m", choices=sorted(SCALES))
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--inject-fault", action="store_true",
                    help="crash mid-run to demo checkpoint/restart")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = SCALES[args.scale]
    print(f"model: {cfg.name} ({cfg.param_count() / 1e6:.1f}M params)")
    crashed = {"done": False}

    def fault_hook(step):
        if args.inject_fault and step == args.steps // 2 \
                and not crashed["done"]:
            crashed["done"] = True
            raise SimulatedFault("injected node failure")

    with tempfile.TemporaryDirectory() as ckpt_dir:
        def make_trainer():
            run = RunConfig(
                model=cfg, global_batch=args.batch, seq_len=args.seq,
                steps=args.steps, peak_lr=3e-3,
                warmup_steps=max(args.steps // 10, 5),
                opt=AdamWConfig(lr=3e-3), flare=True,
                checkpoint_dir=ckpt_dir,
                checkpoint_every=max(args.steps // 6, 5),
                device=args.device)
            return Trainer(run, fault_hook=fault_hook)

        sup = Supervisor(max_restarts=2)
        hist = sup.run(make_trainer, steps=args.steps)

    losses = [h["loss"] for h in hist]
    for h in hist[:: max(len(hist) // 12, 1)]:
        print(f"  step {h['step']:4d}  loss {h['loss']:.4f}  "
              f"{h['tokens_per_s']:7.0f} tok/s")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"loss: {first:.3f} -> {last:.3f} "
          f"({'DECREASED' if last < first else 'NOT DECREASED'})")
    if sup.restarts:
        print(f"supervisor: {sup.restarts} restart(s) — "
              f"{[a.note for a in sup.actions]}")
    assert last < first, "training must make progress"


if __name__ == "__main__":
    main()
