"""Sharded, prefetching dataloader with FLARE instrumentation seams.
(The port's copy of the JAX package's ``data/loader.py``; numpy only.)

``next_batch`` is the exact seam the paper instruments for metric ①
(training throughput) and where Case-3's quadratic mask generation lives
when ``mask_mode='naive'``.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from repro_torch.data import masks as mask_lib
from repro_torch.data.synthetic import SyntheticCorpus


@dataclass
class DataConfig:
    vocab_size: int
    batch: int  # per-host batch
    seq_len: int
    seed: int = 0
    shard: int = 0
    num_shards: int = 1
    prefetch: int = 2
    mask_mode: str = "none"  # none | naive | fast  (Case-3 reproduction)
    docs_per_seq: int = 4


class ShardedLoader:
    """Background-prefetching loader over the synthetic corpus.

    ``start_step`` > 0 begins at that batch, as an uninterrupted loader
    would have reached it (a resumed run): the corpus seeds each batch on
    its own, and the document lengths of the skipped batches are drawn and
    dropped."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.corpus = SyntheticCorpus(cfg.vocab_size, cfg.seed)
        self._iter = self.corpus.batch_iter(
            cfg.batch, cfg.seq_len, cfg.shard, cfg.num_shards,
            start_step=start_step)
        self._q: queue.Queue = queue.Queue(maxsize=max(cfg.prefetch, 1))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._rng = np.random.default_rng(cfg.seed + 1)
        if cfg.mask_mode != "none":
            for _ in range(start_step):
                self._doc_lengths(cfg.seq_len, cfg.docs_per_seq)

    # ------------------------------------------------------------------ #
    def _make_batch(self) -> dict:
        batch = next(self._iter)
        cfg = self.cfg
        if cfg.mask_mode != "none":
            L = cfg.seq_len
            lens = self._doc_lengths(L, cfg.docs_per_seq)
            seg = mask_lib.segment_ids_from_docs(lens, L)
            if cfg.mask_mode == "naive":
                batch["mask"] = mask_lib.mask_naive_quadratic(seg)
            else:
                batch["seg_starts"] = mask_lib.mask_fast_linear(seg)
        return batch

    def _doc_lengths(self, L: int, n: int) -> list[int]:
        cuts = np.sort(self._rng.choice(np.arange(1, L), n - 1, replace=False))
        edges = np.concatenate([[0], cuts, [L]])
        return list(np.diff(edges))

    # ------------------------------------------------------------------ #
    def start(self):
        if self._thread is not None:
            return
        def worker():
            while not self._stop.is_set():
                try:
                    self._q.put(self._make_batch(), timeout=0.2)
                except queue.Full:
                    continue
        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="flare-dataloader")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def next_batch(self) -> dict:
        """THE instrumented seam (FLARE metric ①: throughput; Case-3 V_inter)."""
        if self._thread is None:
            return self._make_batch()  # synchronous mode
        return self._q.get()

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()
