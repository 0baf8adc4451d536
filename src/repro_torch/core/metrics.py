"""The five aggregated metrics of FLARE (paper §5.2, Fig 7).

  ① training throughput        (macro — fail-slow detection)
  ② compute-kernel FLOPS        (micro — underclock / layout regressions)
  ③ collective bandwidth        (micro — jitter / GDR regressions)
  ④ issue-latency distribution  (micro — kernel-issue stalls: GC, sync)
  ⑤ void percentage V_inter / V_minority (micro — uncovered operations)

All are computed per training step.  FLOPS of compute kernels that overlap
a communication kernel are flagged so they are not mistakenly treated as
regressed (§5.2.2, MoE overlap).

Two code paths produce identical StepMetrics:

  * the legacy per-event path (``aggregate_step`` on a rank -> event-list
    dict) — kept for hand-built timelines and as the equivalence oracle;
  * the columnar path (``aggregate_all`` on an ``EventBatch``) — a single
    vectorized sweep computing EVERY step's metrics with numpy group-bys,
    no per-step rescans.  This is what the engine uses at thousand-plus
    rank scale.

The port's copy of the JAX package's ``core/metrics.py``: numpy
only (no torch), with the reference's names, thresholds and arithmetic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.columnar import (KIND_TO_CODE, NO_INT, EventBatch,
                                       next_ge, prev_le)
from repro_torch.core.events import DEVICE_KINDS, EventKind, TraceEvent

_C_STEP = KIND_TO_CODE[EventKind.STEP]
_C_COMP = KIND_TO_CODE[EventKind.KERNEL_COMPUTE]
_C_COMM = KIND_TO_CODE[EventKind.KERNEL_COMM]
_C_DL = KIND_TO_CODE[EventKind.DATALOADER]
_C_PY = KIND_TO_CODE[EventKind.PY_API]
_C_GC = KIND_TO_CODE[EventKind.GC]
_C_SYNC = KIND_TO_CODE[EventKind.SYNC]


@dataclass
class StepMetrics:
    step: int
    t_step: float
    throughput: float                       # tokens / s   (①)
    flops: dict                             # name -> per-rank achieved FLOP/s (②)
    flops_overlapped: set                   # kernel names excluded from ② checks
    bandwidth: dict                         # (name) -> achieved B/s          (③)
    issue_latencies: np.ndarray             # comm-kernel issue latencies     (④)
    v_inter: float                          # ⑤
    v_minority: float                       # ⑤
    t_inter: float
    api_spans: dict                         # api name -> total host seconds
    num_ranks: int = 1


def _step_events(events: list[TraceEvent], step: int):
    return [e for e in events if e.step == step]


# ----------------------------------------------------------------------- #
# legacy per-event path (oracle; hand-built timelines)
# ----------------------------------------------------------------------- #
def aggregate_step(events_by_rank, step: int) -> Optional[StepMetrics]:
    """Aggregate one step.  Accepts either the legacy rank -> event-list
    dict or an ``EventBatch`` (routed to the columnar fast path)."""
    if isinstance(events_by_rank, EventBatch):
        return aggregate_all(events_by_rank, steps=[step]).get(step)
    return _aggregate_step_events(events_by_rank, step)


def _aggregate_step_events(events_by_rank: dict[int, list[TraceEvent]],
                           step: int) -> Optional[StepMetrics]:
    ranks = sorted(events_by_rank)
    per_rank = {r: _step_events(events_by_rank[r], step) for r in ranks}
    if not any(per_rank.values()):
        return None

    # ---- step span & throughput (①) ---------------------------------- #
    step_spans = [e for r in ranks for e in per_rank[r]
                  if e.kind == EventKind.STEP]
    if step_spans:
        t_step = float(np.mean([e.duration for e in step_spans]))
        tokens = sum(e.meta.get("tokens", 0) for e in step_spans)
    else:
        all_ev = [e for r in ranks for e in per_rank[r]]
        t0 = min(e.start_ts for e in all_ev)
        t1 = max(e.end_ts for e in all_ev)
        t_step = t1 - t0
        tokens = 0
    throughput = tokens / t_step if t_step > 0 else 0.0

    # ---- device kernels ------------------------------------------------ #
    flops: dict[str, dict[int, float]] = {}
    overlapped: set[str] = set()
    bandwidth: dict[str, float] = {}
    issue_lat: list[float] = []

    for r in ranks:
        comm_iv = [(e.start_ts, e.end_ts) for e in per_rank[r]
                   if e.kind == EventKind.KERNEL_COMM]
        for e in per_rank[r]:
            if e.kind == EventKind.KERNEL_COMPUTE and e.meta.get("flops"):
                f = e.meta["flops"] / max(e.duration, 1e-12)
                flops.setdefault(e.name, {})[r] = f
                # comp/comm overlap accounting (§5.2.2)
                for (s, t) in comm_iv:
                    inter = min(t, e.end_ts) - max(s, e.start_ts)
                    if inter > 0.5 * e.duration:
                        overlapped.add(e.name)
                        break
            elif e.kind == EventKind.KERNEL_COMM:
                issue_lat.append(e.issue_latency)

    # bandwidth (③): per comm-op instance, last-issuer start to end
    comm_by_name: dict[str, list[TraceEvent]] = {}
    for r in ranks:
        for e in per_rank[r]:
            if e.kind == EventKind.KERNEL_COMM:
                comm_by_name.setdefault(e.name, []).append(e)
    for name, evs in comm_by_name.items():
        start = max(e.start_ts for e in evs)
        end = max(e.end_ts for e in evs)
        nbytes = evs[0].meta.get("bytes", 0)
        if end > start and nbytes:
            bandwidth[name] = nbytes / (end - start)

    # ---- void percentages (⑤) ----------------------------------------- #
    v_inters, v_minors, t_inters = [], [], []
    for r in ranks:
        evs = per_rank[r]
        dl = [e for e in evs if e.kind == EventKind.DATALOADER]
        dev = sorted([e for e in evs if e.kind in DEVICE_KINDS],
                     key=lambda e: e.start_ts)
        sspan = next((e for e in evs if e.kind == EventKind.STEP), None)
        tstep_r = sspan.duration if sspan else t_step
        if not dev or tstep_r <= 0:
            continue
        # T_inter: last kernel before the dataloader to first kernel after
        t_inter = 0.0
        for d in dl:
            before = [e.end_ts for e in dev if e.end_ts <= d.start_ts]
            after = [e.start_ts for e in dev if e.start_ts >= d.end_ts]
            lo = max(before) if before else d.start_ts
            hi = min(after) if after else d.end_ts
            t_inter += max(hi - lo, 0.0)
        if not dl:  # no dataloader in step (serving) -> t_inter = 0
            t_inter = 0.0
        # V_minority: device gaps where the NEXT kernel was already issued
        # before the device went idle — i.e. the device was busy running
        # something outside FLARE's tracing (paper: "launched but remain
        # un-executed").  Gaps where the next kernel was issued late are
        # kernel-issue stalls (metric ④), not minority kernels.
        # gaps before COMM kernels are collective barrier waits (peer
        # stragglers), not minority kernels — bandwidth (③) covers those.
        gaps = 0.0
        for a, b in zip(dev[:-1], dev[1:]):
            gap = b.start_ts - a.end_ts
            if gap > 0.0 and b.issue_ts <= a.end_ts \
                    and b.kind == EventKind.KERNEL_COMPUTE:
                gaps += gap
        denom = max(tstep_r - t_inter, 1e-12)
        v_inters.append(min(t_inter / tstep_r, 1.0))
        v_minors.append(min(gaps / denom, 1.0))
        t_inters.append(t_inter)

    # ---- host API spans (root-cause narrowing) ------------------------- #
    api_spans: dict[str, float] = {}
    for r in ranks:
        for e in per_rank[r]:
            if e.kind in (EventKind.PY_API, EventKind.GC, EventKind.SYNC,
                          EventKind.DATALOADER):
                api_spans[e.name] = api_spans.get(e.name, 0.0) + e.duration

    flops_mean = {k: v for k, v in flops.items()}
    return StepMetrics(
        step=step, t_step=t_step, throughput=throughput,
        flops=flops_mean, flops_overlapped=overlapped, bandwidth=bandwidth,
        issue_latencies=np.asarray(issue_lat, np.float64),
        v_inter=float(np.mean(v_inters)) if v_inters else 0.0,
        v_minority=float(np.mean(v_minors)) if v_minors else 0.0,
        t_inter=float(np.mean(t_inters)) if t_inters else 0.0,
        api_spans=api_spans, num_ranks=len(ranks))


def steps_in(events_by_rank) -> list[int]:
    """Sorted distinct steps.  Accepts the legacy dict or an EventBatch."""
    if isinstance(events_by_rank, EventBatch):
        return events_by_rank.steps()
    s = {e.step for evs in events_by_rank.values() for e in evs if e.step >= 0}
    return sorted(s)


# ----------------------------------------------------------------------- #
# columnar path: every step's metrics in one vectorized sweep
# ----------------------------------------------------------------------- #
def aggregate_all(batch: EventBatch,
                  steps: Optional[list[int]] = None) -> dict[int, StepMetrics]:
    """Compute StepMetrics for every step of ``batch`` (or the requested
    subset) without re-filtering per-rank event lists per step.

    Numerically equivalent to ``aggregate_step`` on the converted events;
    float reduction order may differ at the 1-ulp level, and the order of
    ``issue_latencies`` is insertion order rather than rank-major (every
    consumer — W1 distance, medians, profile learning — is order-free).
    """
    if len(batch) == 0:
        return {}
    num_ranks = batch.num_distinct_ranks()
    order, uniq, bounds = batch.step_index()
    want = None if steps is None else set(steps)
    out: dict[int, StepMetrics] = {}
    for i, s in enumerate(uniq.tolist()):
        if s < 0 or (want is not None and s not in want):
            continue
        rows = order[bounds[i]:bounds[i + 1]]
        out[s] = _aggregate_rows(batch, rows, s, num_ranks)
    return out


def aggregate_slice(batch: EventBatch, step: int,
                    num_ranks: Optional[int] = None) -> Optional[StepMetrics]:
    """StepMetrics for a batch KNOWN to hold exactly one step's rows in
    insertion order (a fleet-store slice): skips the ``step_index``
    argsort/unique that ``aggregate_all`` would redo per call.  Identical
    result to ``aggregate_all(batch)[step]``."""
    if len(batch) == 0:
        return None
    if num_ranks is None:
        num_ranks = batch.num_distinct_ranks()
    return _aggregate_rows(batch, None, step, int(num_ranks))


def _group_bounds(keys: np.ndarray):
    """(order, unique_keys, bounds) for a stable group-by over ``keys``."""
    o = np.argsort(keys, kind="stable")
    sorted_keys = keys[o]
    u, starts = np.unique(sorted_keys, return_index=True)
    return o, u, np.append(starts, keys.size)


def _appearance_order(o: np.ndarray, bounds: np.ndarray) -> list[int]:
    """Group iteration order by FIRST APPEARANCE in the original rows (the
    stable sort puts each group's earliest row at its segment start).  Keys
    are interning ids, which the fleet shares across jobs — dict key order
    must not depend on which job interned a name first."""
    return np.argsort(o[bounds[:-1]], kind="stable").tolist()


def _aggregate_rows(b: EventBatch, rows: Optional[np.ndarray], step: int,
                    num_ranks: int) -> StepMetrics:
    names = b.names
    if rows is None:
        # whole-batch fast path (``aggregate_slice``): reference the
        # columns directly — a fancy-index with arange would copy every
        # column of every step slice on the fleet hot path
        k, rk, iss, st, en = b.kind, b.rank, b.issue_ts, b.start_ts, b.end_ts
        nid, fl, nb, tk = b.name_id, b.flops, b.nbytes, b.tokens
        rows = np.arange(len(b))       # only sparse lookups index this
    else:
        k = b.kind[rows]
        rk = b.rank[rows]
        iss = b.issue_ts[rows]
        st = b.start_ts[rows]
        en = b.end_ts[rows]
        nid = b.name_id[rows]
        fl = b.flops[rows]
        nb = b.nbytes[rows]
        tk = b.tokens[rows]

    # ---- step span & throughput (①) ---------------------------------- #
    ms = k == _C_STEP
    if ms.any():
        t_step = float(np.mean(en[ms] - st[ms]))
        tk_s = tk[ms]
        present = tk_s != NO_INT
        tokens = int(tk_s[present].sum())
        if b.extra and not present.all():
            # rare: non-int tokens live in the extra dicts
            for row in rows[ms][~present].tolist():
                v = (b.extra.get(row) or {}).get("tokens", 0)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    tokens += v
    else:
        t_step = float(en.max() - st.min())
        tokens = 0
    throughput = tokens / t_step if t_step > 0 else 0.0

    # ---- compute FLOPS (②) -------------------------------------------- #
    m_comp = k == _C_COMP
    m_comm = k == _C_COMM
    m_flop = m_comp & ~np.isnan(fl)
    flops: dict[str, dict[int, float]] = {}
    if m_flop.any():
        cn = nid[m_flop]
        cf = fl[m_flop] / np.maximum(en[m_flop] - st[m_flop], 1e-12)
        o, u, gb = _group_bounds(cn)
        cr_l = rk[m_flop][o].tolist()
        cf_l = cf[o].tolist()
        u_l = u.tolist()
        for j in _appearance_order(o, gb):
            lo, hi = gb[j], gb[j + 1]
            # dict(zip(...)) keeps last-wins semantics for duplicate ranks
            flops[names[u_l[j]]] = dict(zip(cr_l[lo:hi], cf_l[lo:hi]))

    # ---- comp/comm overlap flags (§5.2.2) ----------------------------- #
    overlapped: set[str] = set()
    if m_flop.any() and m_comm.any():
        kr, ks, ke, kn = rk[m_flop], st[m_flop], en[m_flop], nid[m_flop]
        cr, cs, ce = rk[m_comm], st[m_comm], en[m_comm]
        max_r = int(max(kr.max(), cr.max())) + 1
        c_cnt = np.bincount(cr, minlength=max_r)
        c_off = np.concatenate(([0], np.cumsum(c_cnt)[:-1]))
        co = np.argsort(cr, kind="stable")
        cs_s, ce_s = cs[co], ce[co]
        rep = c_cnt[kr]                    # comm partners per compute row
        total = int(rep.sum())
        if total:
            pk = np.repeat(np.arange(kr.size), rep)
            within = np.arange(total) - np.repeat(np.cumsum(rep) - rep, rep)
            pc = np.repeat(c_off[kr], rep) + within
            inter = np.minimum(ce_s[pc], ke[pk]) - np.maximum(cs_s[pc], ks[pk])
            hit = inter > 0.5 * (ke[pk] - ks[pk])
            for nm_id in np.unique(kn[pk[hit]]).tolist():
                overlapped.add(names[nm_id])

    # ---- issue latencies (④) + bandwidth (③) -------------------------- #
    issue_lat = (st - iss)[m_comm]
    bandwidth: dict[str, float] = {}
    if m_comm.any():
        o, u, gb = _group_bounds(nid[m_comm])
        st_s, en_s = st[m_comm][o], en[m_comm][o]
        nb_s = nb[m_comm][o]
        rows_comm = rows[m_comm][o]
        u_l = u.tolist()
        for j in _appearance_order(o, gb):
            nm_id = u_l[j]
            lo, hi = gb[j], gb[j + 1]
            start = float(st_s[lo:hi].max())
            end = float(en_s[lo:hi].max())
            first = int(nb_s[lo])
            if first == NO_INT:
                nbytes = (b.extra.get(int(rows_comm[lo])) or {}) \
                    .get("bytes", 0) if b.extra else 0
            else:
                nbytes = first
            if end > start and nbytes:
                bandwidth[names[nm_id]] = nbytes / (end - start)

    # ---- void percentages (⑤) ----------------------------------------- #
    v_inter = v_minority = t_inter = 0.0
    m_dev = m_comp | m_comm
    if m_dev.any():
        dr, ds, de = rk[m_dev], st[m_dev], en[m_dev]
        di, dk = iss[m_dev], k[m_dev]
        o = np.lexsort((ds, dr))           # stable (rank, start_ts) order
        dr_s, ds_s, de_s = dr[o], ds[o], de[o]
        di_s, dk_s = di[o], dk[o]
        ranks_dev = np.unique(dr_s)        # only ranks with device events

        # per-rank step span: first STEP event per rank, else global t_step
        tstep_r = np.full(ranks_dev.size, t_step)
        if ms.any():
            so, su, sgb = _group_bounds(rk[ms])
            first_rows = so[sgb[:-1]]      # first STEP row per rank
            dur = (en[ms] - st[ms])[first_rows]
            pos = np.searchsorted(ranks_dev, su)
            ok = (pos < ranks_dev.size)
            ok &= ranks_dev[np.minimum(pos, ranks_dev.size - 1)] == su
            tstep_r[pos[ok]] = dur[ok]

        # T_inter: dataloader windows widened to the surrounding kernels
        t_inter_r = np.zeros(ranks_dev.size)
        m_dl = k == _C_DL
        if m_dl.any():
            qs, qe, qr = st[m_dl], en[m_dl], rk[m_dl]
            pos = np.searchsorted(ranks_dev, qr)
            ok = (pos < ranks_dev.size)
            ok &= ranks_dev[np.minimum(pos, ranks_dev.size - 1)] == qr
            if ok.any():
                qs, qe, qr, pos = qs[ok], qe[ok], qr[ok], pos[ok]
                bi = prev_le(de_s, dr_s, qs, qr)
                lo_ = np.where(bi >= 0, de_s[np.maximum(bi, 0)], qs)
                ai = next_ge(ds_s, dr_s, qe, qr)
                hi_ = np.where(ai >= 0, ds_s[np.maximum(ai, 0)], qe)
                t_inter_r = np.bincount(
                    pos, weights=np.maximum(hi_ - lo_, 0.0),
                    minlength=ranks_dev.size)

        # V_minority: same-rank consecutive device gaps with an
        # already-issued next COMPUTE kernel
        gaps_r = np.zeros(ranks_dev.size)
        if dr_s.size > 1:
            same = dr_s[1:] == dr_s[:-1]
            gap = ds_s[1:] - de_s[:-1]
            cond = same & (gap > 0.0) & (di_s[1:] <= de_s[:-1]) \
                & (dk_s[1:] == _C_COMP)
            if cond.any():
                gaps_r = np.bincount(
                    np.searchsorted(ranks_dev, dr_s[1:][cond]),
                    weights=gap[cond], minlength=ranks_dev.size)

        keep = tstep_r > 0
        if keep.any():
            ti, ts_, g = t_inter_r[keep], tstep_r[keep], gaps_r[keep]
            v_inter = float(np.mean(np.minimum(ti / ts_, 1.0)))
            v_minority = float(np.mean(
                np.minimum(g / np.maximum(ts_ - ti, 1e-12), 1.0)))
            t_inter = float(np.mean(ti))

    # ---- host API spans ------------------------------------------------ #
    api_spans: dict[str, float] = {}
    m_api = (k == _C_PY) | (k == _C_GC) | (k == _C_SYNC) | (k == _C_DL)
    if m_api.any():
        an = nid[m_api]
        totals = np.bincount(an, weights=(en - st)[m_api],
                             minlength=len(names))
        o, u, gb = _group_bounds(an)
        u_l = u.tolist()
        for j in _appearance_order(o, gb):
            api_spans[names[u_l[j]]] = float(totals[u_l[j]])

    return StepMetrics(
        step=step, t_step=t_step, throughput=throughput,
        flops=flops, flops_overlapped=overlapped, bandwidth=bandwidth,
        issue_latencies=np.asarray(issue_lat, np.float64),
        v_inter=v_inter, v_minority=v_minority, t_inter=t_inter,
        api_spans=api_spans, num_ranks=num_ranks)
