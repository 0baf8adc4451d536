"""The port's trace storage (``repro_torch.core.columnar``,
``repro_torch.store``) against the JAX package's (``repro.core.columnar``,
``repro.store``), on the CPU.

The same events, drawn from a numpy seed, are built once as the port's and
once as the reference's ``TraceEvent``s:

* ``EventBatch.from_events`` gives the same columns and the same JSONL
  lines, bitwise;
* ``encode_segment`` gives the same bytes for FCS v1, v2 (zlib, and zstd
  where the ``zstandard`` package imports) and v3;
* each package's ``SegmentedTraceWriter`` spill, rotated into several
  files, reads back in the other package to the same events: bitwise for
  FCS; for JSONL, each time as the codec rounds it to 1e-6 s.
"""
import os

import numpy as np
import pytest

from repro import store as ref_store
from repro.core import columnar as ref_columnar
from repro.core import events as ref_events
from repro_torch import store as port_store
from repro_torch.core import columnar as port_columnar
from repro_torch.core import events as port_events

COLS = ("kind", "name_id", "rank", "issue_ts", "start_ts", "end_ts",
        "step", "flops", "nbytes", "tokens", "group_id")
NAMES = ("flash_attention", "fused_residual_rmsnorm", "ssd_scan",
         "ring_combine", "dataloader.next_batch", "train_step_exec")


def draw_events(seed: int, n: int, module):
    """``n`` events of every kind from ``seed`` as ``module.TraceEvent``s:
    times spread over a long run at full float64 precision, and meta with
    the columnar keys (flops, bytes, tokens, group), values that only the
    leftover dict holds (a zero flops, a float bytes, lists, a tuple, a
    nested dict) and the daemon's own (shape, parent, stack, loss)."""
    rng = np.random.default_rng(seed)
    kinds = list(module.EventKind)
    out = []
    for i in range(n):
        issue = float(rng.uniform(0, 5e4))
        start = issue + float(rng.exponential(1e-4))
        end = start + float(rng.exponential(1e-3))
        meta = {}
        r = rng.random(8)
        if r[0] < 0.6:
            meta["flops"] = float(rng.integers(1, 10)) * 1e9 if r[1] < 0.9 \
                else 0
        if r[2] < 0.5:
            meta["bytes"] = int(rng.integers(0, 1 << 40)) if r[3] < 0.9 \
                else float(rng.uniform(0, 1e6))
        if r[4] < 0.2:
            meta["tokens"] = int(rng.integers(1, 1 << 20))
        if r[5] < 0.2:
            meta["group"] = f"dp{int(rng.integers(0, 4))}"
        if r[6] < 0.5:
            meta["shape"] = [int(x) for x in rng.integers(1, 4096, 3)]
            meta["parent"] = f"step_{i % 7}"
        if r[7] < 0.1:
            meta.update(stack=[f"f{j}" for j in range(6)],
                        comm_group=(0, 1, 2, 3), loss=float(rng.normal()),
                        nested={"a": [1, 2.5], "b": None})
        out.append(module.TraceEvent(
            kinds[int(rng.integers(0, len(kinds)))],
            NAMES[int(rng.integers(0, len(NAMES)))], int(rng.integers(0, 8)),
            issue, start, end, step=int(rng.integers(-1, 12)), meta=meta))
    return out


def as_tuples(events):
    """Events as plain tuples (the two packages' TraceEvent classes never
    compare equal to each other)."""
    return [(e.kind.value, e.name, e.rank, e.issue_ts, e.start_ts, e.end_ts,
             e.step, e.meta) for e in events]


def jsonl_rounded(events):
    """What the JSONL codec keeps of ``events``: each time rounded to 1e-6
    s, and the last 4 frames of a stack."""
    return as_tuples(port_events.TraceEvent.from_json(e.to_json())
                     for e in events)


def batches(seed: int, n: int = 200):
    """The seed's events as a port and a reference ``EventBatch``."""
    return (port_columnar.EventBatch.from_events(
        draw_events(seed, n, port_events)),
        ref_columnar.EventBatch.from_events(
            draw_events(seed, n, ref_events)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_from_events_columns_and_jsonl_lines_equal_the_reference(seed):
    port, ref = batches(seed)
    for c in COLS:
        a, b = getattr(port, c), getattr(ref, c)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), c
    assert port.names == ref.names and port.groups == ref.groups
    assert port.extra == ref.extra
    assert list(port.to_jsonl_lines()) == list(ref.to_jsonl_lines())
    assert as_tuples(port.to_events()) == as_tuples(ref.to_events())


ENCODINGS = [(1, None, None), (2, "zlib", None), (2, "zlib", 9),
             (2, "zstd", None), (3, "zlib", None)]


@pytest.mark.parametrize("version,compression,level", ENCODINGS)
@pytest.mark.parametrize("seed", [0, 3])
def test_encode_segment_is_the_reference_byte_for_byte(seed, version,
                                                       compression, level):
    """One segment of the same events, bitwise; zstd cases need the
    ``zstandard`` package in both (one process, one library version)."""
    from repro.store.fcs import encode_segment as ref_encode
    from repro_torch.store.fcs import encode_segment as port_encode
    if compression == "zstd" and not port_store.have_zstd():
        pytest.skip("zstandard is not importable here")
    port, ref = batches(seed)
    kw = dict(version=version, compression=compression, level=level)
    got = port_encode(port, **kw)
    assert got == ref_encode(ref, **kw)
    back = port_store.decode_batch_bytes(got)
    assert as_tuples(back.to_events()) == as_tuples(port.to_events())


SPILLS = [("jsonl", ".jsonl"), ("fcs", ".fcs"), ("fcs2", ".fcs2")]


def write_rotated(module_store, batch_of, codec: str, path: str):
    """Six drains of 40 events each through ``module_store``'s
    ``SegmentedTraceWriter`` rotating past 2 KiB; returns the writer."""
    w = module_store.SegmentedTraceWriter(path, codec=codec,
                                          rotate_bytes=2048)
    for i in range(6):
        w.write(batch_of(i))
    return w


@pytest.mark.parametrize("codec,ext", SPILLS)
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_rotated_spill_reads_back_in_the_other_package(tmp_path, writer,
                                                      codec, ext):
    """A rotated spill written by one package: the other package's writer
    resumes after the same pieces, and its ``read_trace`` (and, for FCS,
    ``read_fcs`` segment by segment) gives back the drained events, in
    order."""
    mods = {"port": (port_store, port_columnar, port_events),
            "reference": (ref_store, ref_columnar, ref_events)}
    w_store, w_col, w_ev = mods[writer]
    r_store = ref_store if writer == "port" else port_store
    drains = [draw_events(100 + i, 40, w_ev) for i in range(6)]
    path = str(tmp_path / f"job{ext}")
    w = write_rotated(w_store, lambda i: w_col.EventBatch.from_events(
        drains[i]), codec, path)
    assert len(w.paths) >= 3 and all(os.path.exists(p) for p in w.paths)
    assert r_store.SegmentedTraceWriter(path).paths == w.paths
    got = [e for p in w.paths for e in r_store.read_trace(p).to_events()]
    want = [e for d in drains for e in d]
    if codec == "jsonl":
        assert as_tuples(got) == jsonl_rounded(want)
        return
    assert as_tuples(got) == as_tuples(want)
    segs = [b for p in w.paths for b in r_store.fcs.iter_segments(p)]
    assert [as_tuples(b.to_events()) for b in segs] == \
        [as_tuples(d) for d in drains]


def test_codec_registry_matches_the_reference():
    """The same codecs by name and extension, the same sniffing."""
    assert sorted(port_store.codecs()) == sorted(ref_store.codecs())
    for name, c in port_store.codecs().items():
        assert c.extensions == ref_store.get_codec(name).extensions
    for p in ("a.jsonl", "a.json", "a.fcs", "a.fcs2", "a.fcs3",
              "a.seg004.fcs2"):
        assert port_store.codec_for_path(p).name == \
            ref_store.codec_for_path(p).name
        assert port_store.job_id_for_path(p) == ref_store.job_id_for_path(p)
        assert port_store.seg_index(p) == ref_store.seg_index(p)
