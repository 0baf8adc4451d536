"""Attention-mask generation — the paper's Case-3 dataloader regression.
(The port's copy of the JAX package's ``data/masks.py``; numpy only.)

The paper (§7.3.3): an algorithm team reused a 4k training script at 64k
sequence length; the dataloader's O(L^2) attention-mask generation became
the bottleneck (41% MFU drop, detected via V_inter).  We provide both the
naive quadratic generator (to reproduce the regression) and the O(L)
fixed version (what the routed team ships after FLARE's diagnosis).
"""
from __future__ import annotations

import numpy as np


def segment_ids_from_docs(doc_lengths: list[int], seq_len: int) -> np.ndarray:
    seg = np.zeros(seq_len, np.int32)
    pos = 0
    for i, ln in enumerate(doc_lengths):
        seg[pos:pos + ln] = i
        pos += ln
        if pos >= seq_len:
            break
    seg[pos:] = len(doc_lengths)
    return seg


def mask_naive_quadratic(segment_ids: np.ndarray) -> np.ndarray:
    """O(L^2) dense causal+segment mask — the regression-inducing path."""
    L = segment_ids.shape[0]
    mask = np.zeros((L, L), dtype=bool)
    for i in range(L):          # noqa: B007 — intentionally quadratic
        for j in range(i + 1):
            mask[i, j] = segment_ids[i] == segment_ids[j]
    return mask


def mask_fast_linear(segment_ids: np.ndarray) -> np.ndarray:
    """O(L) metadata: per-token segment start offset.  Equivalent mask is
    (j >= start[i]) & (j <= i); materialization is deferred to the kernel."""
    L = segment_ids.shape[0]
    start = np.zeros(L, np.int32)
    cur = 0
    for i in range(1, L):
        if segment_ids[i] != segment_ids[i - 1]:
            cur = i
        start[i] = cur
    return start


def materialize_from_starts(start: np.ndarray) -> np.ndarray:
    L = start.shape[0]
    j = np.arange(L)
    return (j[None, :] >= start[:, None]) & (j[None, :] <= np.arange(L)[:, None])
