"""Deterministic synthetic token corpus (no external data gate).
(The port's copy of the JAX package's ``data/synthetic.py``; numpy only,
so it gives the same batches bit for bit.)

A seeded Zipf-ish unigram stream with injected local structure (bigram
coupling) so that a ~100M model trained for a few hundred steps shows a
clearly decreasing loss — enough signal for the end-to-end example.
"""
from __future__ import annotations

import numpy as np


class SyntheticCorpus:
    def __init__(self, vocab_size: int, seed: int = 0, zipf_a: float = 1.1):
        self.vocab_size = vocab_size
        self.seed = seed
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = 1.0 / np.power(ranks, zipf_a)
        self.p = p / p.sum()

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        base = rng.choice(self.vocab_size, size=n, p=self.p)
        # bigram coupling: token[i] often determined by token[i-1]
        couple = rng.random(n) < 0.5
        shifted = (np.roll(base, 1) * 31 + 7) % self.vocab_size
        out = np.where(couple, shifted, base)
        return out.astype(np.int32)

    def batch_iter(self, batch: int, seq_len: int, shard: int = 0,
                   num_shards: int = 1, seed_offset: int = 0,
                   start_step: int = 0):
        """Yields {tokens [b,s], labels [b,s]} for this data shard forever,
        from batch ``start_step`` on (each batch has its own seed, so a
        resumed run sees the batches an uninterrupted one would)."""
        step = start_step
        while True:
            rng = np.random.default_rng(
                (self.seed + seed_offset, shard, step))
            toks = self.sample(rng, batch * (seq_len + 1))
            toks = toks.reshape(batch, seq_len + 1)
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            step += 1
