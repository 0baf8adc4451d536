"""Quickstart: attach FLARE to a training run and read its diagnosis.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The port's counterpart of ``examples/quickstart.py``: the same run and
output, importing nothing but ``repro_torch``.  It trains the JAX
package's reduced llama3.2-1b (head_dim 16) on the card unless ``--device
cpu`` is given.
"""
import argparse
import os
import tempfile

from repro_torch.configs import get_reduced
from repro_torch.core.events import load_jsonl
from repro_torch.core.metrics import aggregate_step, steps_in
from repro_torch.core.report import ascii_timeline
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.train import RunConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    cfg = get_reduced("llama3.2-1b")
    with tempfile.TemporaryDirectory() as d:
        log = os.path.join(d, "trace.jsonl")
        run = RunConfig(model=cfg, global_batch=4, seq_len=64, steps=20,
                        peak_lr=3e-3, warmup_steps=5,
                        opt=AdamWConfig(lr=3e-3),
                        flare=True, flare_log=log, device=args.device)
        trainer = Trainer(run)
        hist = trainer.train()
        print(f"trained {len(hist)} steps: loss {hist[0]['loss']:.3f} -> "
              f"{hist[-1]['loss']:.3f} "
              f"({hist[-1]['tokens_per_s']:.0f} tok/s)")
        print(f"FLARE logged {trainer.daemon.bytes_logged / 1e3:.1f} KB "
              f"({trainer.daemon.events_emitted} events)")
        events = load_jsonl(log)
        by_rank = {0: events}
        step = steps_in(by_rank)[-2]
        m = aggregate_step(by_rank, step)
        print(f"step {step}: throughput={m.throughput:.0f} tok/s  "
              f"V_inter={m.v_inter:.3f}  V_minority={m.v_minority:.3f}")
        print(ascii_timeline(events, rank=0, step=step))


if __name__ == "__main__":
    main()
