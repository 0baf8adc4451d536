"""The port's resident fleet service (``repro_torch.serve``) against the JAX
package's (``repro.serve``), on the CPU.

``repro_torch.serve`` (``protocol``, ``client``, ``tail``, ``checkpoint``,
``service``, ``query``) is a stdlib and numpy copy of ``repro.serve``.  The
same inputs go through both packages: the JAX package's cluster simulator
makes a 4-rank world (as ``tests/test_serve.py`` builds it), whose batches
reach the port as FCS bytes, and the recorded directories are written by
the reference's writers and read by each package's store.  Every
comparison is exact, and no check reads a wall clock: waits poll a
condition under a deadline.

* each copy's syntax tree equals the reference's (docstrings and the
  package's name aside);
* FLW frames and the checkpoint container are byte-equal between the
  packages; torn and corrupt frames and checkpoints raise in both;
* a reference ``LiveClient`` into a port ``FleetService``, and a port
  client into a reference service, give equal rows;
* every case of ``tests/test_serve.py`` and ``tests/test_checkpoint.py``
  runs on both packages' services (``SERVICE_CASES``): the same rows, the
  same stats and the same telemetry counts, and each case's own checks
  hold in both.  The live sink's backoff is held by a fake ``clock=`` and
  a count of connect attempts, where the reference times a call;
* a port ``Trainer`` on the CPU (reduced llama) whose daemon streams live
  into a port service equals the replay of its spill; the same job with
  its service killed and restarted on the same port counts its drops,
  re-HELLOs its topology, raises nothing on the daemon thread and
  accounts for every drain once.
"""
import dataclasses
import importlib
import json
import os
import socket
import struct
import sys
import threading
import time
import urllib.error
import urllib.request
import zlib
from types import SimpleNamespace

import pytest

from repro import store as ref_store
from repro.configs import get_config
from repro.core.engine import DiagnosticEngine as RefEngine
from repro.core.engine import EngineConfig as RefConfig
from repro.core.history import HistoryStore as RefHistory
from repro.core.timeline import ClusterSimulator, Injection, program_from_config
from repro_torch import store
from repro_torch.configs import get_reduced
from repro_torch.core.daemon import TracingDaemon
from repro_torch.core.engine import DiagnosticEngine, EngineConfig
from repro_torch.core.history import HistoryStore
from repro_torch.fleet import FleetConfig, FleetMultiplexer
from repro_torch.runtime.train import RunConfig, Trainer
from repro_torch.serve import FleetService, ServiceConfig
from repro_torch.store.fcs import segment_stats
from test_torch_fleet import SlowSteps, to_port
from torch_ast import tree

N = 4           # ranks: small fleet, fast tests
STEPS = 8
SERVE_COPIES = ["serve/protocol.py", "serve/client.py", "serve/tail.py",
                "serve/checkpoint.py", "serve/service.py", "serve/query.py",
                "serve/__init__.py"]


def _pkg(root: str) -> SimpleNamespace:
    def mod(m):
        return importlib.import_module(f"{root}.{m}")
    return SimpleNamespace(
        name=root, serve=mod("serve"), tail=mod("serve.tail"),
        ckpt=mod("serve.checkpoint"), store=mod("store"), fleet=mod("fleet"),
        engine=mod("core.engine"), telemetry=mod("core.telemetry"),
        report=mod("core.report"), daemon=mod("core.daemon"),
        events=mod("core.events"), history=mod("core.history"),
        archive=mod("archive"))


PKGS = {"port": _pkg("repro_torch"), "ref": _pkg("repro")}


def wait_for(pred, what: str, timeout_s: float = 60.0) -> None:
    """Poll ``pred`` until it holds; fail naming ``what`` at the deadline."""
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"condition not reached: {what}")
        time.sleep(0.01)


def departed(svc, jobs) -> bool:
    """Every job of ``jobs`` known to the service's fleet and departed."""
    known = {j.job_id: j for j in svc.mux.jobs}
    return all(j in known and known[j].departed for j in jobs)


def rows(P, fas) -> list:
    """A stream in ``(ts, job, seq)`` order as plain rows: job, event
    time, origin, route and the anomaly as its package writes it."""
    fas = sorted(fas, key=lambda a: (a.ts, a.job_id, a.seq))
    found = json.loads(P.report.anomalies_json([fa.anomaly for fa in fas]))
    return [dict(job=fa.job_id, ts=fa.ts, origin=fa.origin, route=fa.route,
                 **a) for fa, a in zip(fas, found)]


def counters(tele) -> dict:
    snap = tele.snapshot()
    return dict(snap.get("counters", snap))


def signature(stats) -> dict:
    return dict(files=stats.files, events=stats.events,
                skipped_lines=stats.skipped_lines,
                corrupt_files=stats.corrupt_files,
                skipped_segments=stats.skipped_segments,
                bytes_decoded=stats.bytes_decoded,
                bytes_skipped=stats.bytes_skipped,
                per_job=dict(sorted(stats.per_job.items())))


@pytest.fixture(scope="module")
def world():
    """The simulator's 4-rank program and a healthy profile learned from
    the same three runs by each package's engine."""
    prog = program_from_config(get_config("llama-20b-paper"), num_chips=N)
    ref_hist, port_hist = RefHistory(), HistoryStore()
    ref_eng = RefEngine(RefConfig(backend="dense-train", num_ranks=N),
                        ref_hist)
    port_eng = DiagnosticEngine(EngineConfig(backend="dense-train",
                                             num_ranks=N), port_hist)
    for seed in range(3):
        b = ClusterSimulator(N, prog, seed=seed).run_batch(3)
        ref_eng.ingest_batch(b)
        port_eng.ingest_batch(to_port(b))
    ref_eng.learn_healthy()
    port_eng.learn_healthy()
    return prog, {"repro": ref_hist, "repro_torch": port_hist}


class Ctx:
    """One package's side of a case: its modules, its profile, its batch
    conversion and a directory of its own."""

    def __init__(self, P, world, d):
        self.P, self.prog, self.hist = P, world[0], world[1][P.name]
        self.d = str(d)
        os.makedirs(self.d, exist_ok=True)
        self.conv = to_port if P.name == "repro_torch" else (lambda b: b)

    def sim(self, seed: int, steps: int, inj=()):
        return self.conv(ClusterSimulator(N, self.prog, seed=seed,
                                          injections=list(inj))
                         .run_batch(steps))

    def ecfg(self):
        return self.P.engine.EngineConfig(backend="dense-train", num_ranks=N)

    def mux(self, topo=None, fleet_tier=True):
        if not fleet_tier:
            return self.P.fleet.FleetMultiplexer(self.P.fleet.FleetConfig(),
                                                 history=self.hist)
        return self.P.fleet.FleetMultiplexer(
            self.P.fleet.FleetConfig(watermark_delay=1,
                                     fleet_detectors=["cross_job_failslow"],
                                     topology=topo),
            history=self.hist)

    def service(self, scfg, topo=None, got=None, fleet_tier=True):
        S = self.P.serve
        return S.FleetService(
            self.mux(topo, fleet_tier), scfg,
            on_anomaly=None if got is None else
            (lambda fa, t: got.append(fa)))

    def rows(self, fas) -> list:
        return rows(self.P, fas)

    def oracle(self, logdir, topo, jobs):
        """Serial replay + finalize: (rows, stats)."""
        mux = self.mux(topo)
        for jid in jobs:
            mux.add_job(jid, self.ecfg())
        stats = self.P.fleet.FleetReplayer(mux).replay_dir(logdir,
                                                           job_workers=1)
        return self.rows(mux.finalize()), stats

    def stream_all(self, client, chunk_lists, logdir):
        """HELLO every job up front, stream each job's recorded chunks,
        then BYE (the reference's equivalence protocol)."""
        for jid in sorted(chunk_lists):
            client.hello(jid)
        for jid in sorted(chunk_lists):
            path = os.path.join(logdir, f"{jid}.fcs")
            for batch, _sk in self.P.store.iter_trace_chunks(path):
                client.send_batch(jid, batch)
        for jid in sorted(chunk_lists):
            client.bye(jid)


def mk_jobs(prog, jobs=4, steps=STEPS, prefix="lv"):
    """The reference's hang-free mixed fleet: the first half jitters on
    shared racks (the cross-job tier's trigger), the rest is healthy.
    Per-job step chunks (reference batches) and the topology."""
    chunk_lists, topo = {}, {}
    for i in range(jobs):
        inj = [Injection(kind="network_jitter", factor=3.0, start_step=3)] \
            if i < jobs // 2 else []
        batch = ClusterSimulator(N, prog, seed=100 + i,
                                 injections=inj).run_batch(steps)
        jid = f"{prefix}{i:02d}-{'jit' if i < jobs // 2 else 'ok'}"
        order, uniq, bounds = batch.step_index()
        chunk_lists[jid] = [batch.take(order[bounds[j]:bounds[j + 1]])
                            for j in range(uniq.size)]
        topo[jid] = {"rack": f"r{i // 2}", "switch": f"s{i // 4}"}
    return chunk_lists, topo


def write_logs(logdir, chunk_lists, codec="fcs"):
    """The recorded spills, written by the reference's store."""
    for jid, chunks in chunk_lists.items():
        path = os.path.join(logdir, f"{jid}.{codec}")
        for c in chunks:
            ref_store.write_trace(c, path, codec=codec)


def spill_bytes(logdir) -> int:
    return sum(os.path.getsize(os.path.join(logdir, f))
               for f in os.listdir(logdir) if f.endswith(".fcs"))


@pytest.mark.parametrize("rel", SERVE_COPIES)
def test_copied_module_is_the_reference_but_for_names_and_docstrings(rel):
    assert tree("repro_torch", rel) == tree("repro", rel)


# ---------------------------------------------------------------------- #
# wire protocol and checkpoint container                                 #
# ---------------------------------------------------------------------- #
PLAIN_STATE = {"a": [1, 2.5, "x"], "nested": {"b": (3, None)},
               "blob": b"\x00\xff" * 100, "gen": 7}


def test_frames_and_checkpoint_container_are_the_references(world,
                                                             tmp_path):
    """HELLO / BATCH / BYE frames, a raw ``encode_frame`` and the BATCH
    frame of one simulator batch, byte for byte; the ``write_checkpoint``
    container of one plain dict, byte for byte, read back by the other
    package."""
    prog = world[0]
    batch = ClusterSimulator(N, prog, seed=5).run_batch(2)
    got = {}
    for name, P in PKGS.items():
        S = P.serve
        blob = P.store.encode_batch_bytes(
            batch if name == "ref" else to_port(batch))
        path = str(tmp_path / f"{name}-ckpt-00000001.flc")
        n = P.ckpt.write_checkpoint(path, PLAIN_STATE)
        got[name] = dict(
            hello=S.hello_frame("job-x", topology={"rack": "r1"},
                                engine={"num_ranks": 4}),
            bare_hello=S.hello_frame("job-y"),
            batch=S.batch_frame("job-x", blob),
            bye=S.bye_frame("job-x"),
            raw=S.encode_frame(9, "j", b"\x01payload"),
            ckpt=open(path, "rb").read(), ckpt_n=n)
    assert got["port"] == got["ref"]
    for name, other in (("port", "ref"), ("ref", "port")):
        path = str(tmp_path / f"{other}-ckpt-00000001.flc")
        assert PKGS[name].ckpt.read_checkpoint(path) == PLAIN_STATE


@pytest.mark.parametrize("name", list(PKGS))
def test_protocol_roundtrip_and_clean_eof(name):
    S = PKGS[name].serve
    a, b = socket.socketpair()
    try:
        a.sendall(S.hello_frame("job-x", topology={"rack": "r1"}))
        a.sendall(S.batch_frame("job-x", b"\x01payload"))
        a.sendall(S.bye_frame("job-x"))
        a.close()
        ftype, jid, payload = S.read_frame(b)
        assert (ftype, jid) == (S.FRAME_HELLO, "job-x")
        assert S.parse_hello(payload)["topology"] == {"rack": "r1"}
        assert S.read_frame(b) == (S.FRAME_BATCH, "job-x", b"\x01payload")
        assert S.read_frame(b)[0] == S.FRAME_BYE
        assert S.read_frame(b) is None        # clean EOF at a boundary
    finally:
        b.close()


@pytest.mark.parametrize("name", list(PKGS))
@pytest.mark.parametrize("shape, match", [("torn", "torn"),
                                          ("magic", "magic"),
                                          ("crc", "CRC"), ("type", "type"),
                                          ("hello", None)])
def test_torn_and_corrupt_frames_raise(name, shape, match):
    S = PKGS[name].serve
    if shape == "hello":
        with pytest.raises(S.ProtocolError):
            S.parse_hello(b"not json")
        return
    wire = {"torn": S.batch_frame("j", b"x" * 64)[:20],
            "magic": b"NOPE" + S.batch_frame("j", b"x")[4:],
            "type": S.encode_frame(9, "j", b"")}.get(shape)
    if shape == "crc":
        frame = bytearray(S.batch_frame("j", b"hello"))
        frame[-1] ^= 0xFF
        wire = bytes(frame)
    a, b = socket.socketpair()
    a.sendall(wire)
    a.close()
    try:
        with pytest.raises(S.ProtocolError, match=match):
            S.read_frame(b)
    finally:
        b.close()


@pytest.mark.parametrize("name", list(PKGS))
def test_checkpoint_container_roundtrip_generations_and_refusals(name,
                                                                 tmp_path):
    """The container (atomic, identity inside one pickle), generations and
    pruning, an empty store, the CRC message naming the file and a newer
    format refusing, never skipped: ``tests/test_checkpoint.py``'s
    container cases, in each package."""
    C = PKGS[name].ckpt
    path = str(tmp_path / "ckpt-00000001.flc")
    n = C.write_checkpoint(path, PLAIN_STATE)
    assert os.path.getsize(path) == n
    assert C.read_checkpoint(path) == PLAIN_STATE
    assert not os.path.exists(path + ".tmp")
    shared = ["names"]
    p2 = str(tmp_path / "ckpt-00000002.flc")
    C.write_checkpoint(p2, {"interner": shared, "batch_ref": shared})
    back = C.read_checkpoint(p2)
    assert back["interner"] is back["batch_ref"]

    cs = C.CheckpointStore(str(tmp_path / "gens"), keep=2)
    for i in range(4):
        assert cs.save({"gen": i})[1] == i + 1
    assert cs.generations() == [3, 4]
    state, _, gen, skipped = cs.load_latest()
    assert (state["gen"], gen, skipped) == (3, 4, [])
    assert C.CheckpointStore(str(tmp_path / "empty")).load_latest() is None

    blob = bytearray(open(path, "rb").read())
    blob[-1] ^= 0x01
    with open(path, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(C.CheckpointError, match="CRC mismatch"):
        C.read_checkpoint(path)

    newer_dir = tmp_path / "newer"
    cs = C.CheckpointStore(str(newer_dir))
    cs.save({"gen": 1})
    payload = b"future-format bytes"
    newer = str(newer_dir / "ckpt-00000002.flc")
    with open(newer, "wb") as f:
        f.write(struct.pack("<4sHHQI", C.MAGIC, C.FORMAT_VERSION + 1, 0,
                            len(payload), zlib.crc32(payload)))
        f.write(payload)
    with pytest.raises(C.CheckpointVersionError, match="newer"):
        C.read_checkpoint(newer)
    with pytest.raises(C.CheckpointVersionError):
        cs.load_latest()


@pytest.mark.parametrize("name", list(PKGS))
@pytest.mark.parametrize("corrupt", ["truncate_header", "truncate_payload",
                                     "flip_payload", "bad_magic",
                                     "absurd_length"])
def test_torn_checkpoints_detected_and_skipped(name, corrupt, tmp_path):
    C = PKGS[name].ckpt
    cs = C.CheckpointStore(str(tmp_path))
    cs.save({"gen": 1, "payload": list(range(256))})
    path, _, _ = cs.save({"gen": 2, "payload": list(range(256))})
    blob = bytearray(open(path, "rb").read())
    if corrupt == "truncate_header":
        blob = blob[:10]
    elif corrupt == "truncate_payload":
        blob = blob[:len(blob) // 2]
    elif corrupt == "flip_payload":
        blob[-1] ^= 0xFF
    elif corrupt == "bad_magic":
        blob[:4] = b"NOPE"
    elif corrupt == "absurd_length":
        struct.pack_into("<Q", blob, 8, 1 << 40)
    with open(path, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(C.CheckpointError):
        C.read_checkpoint(path)
    state, _, gen, skipped = cs.load_latest()
    assert (state["gen"], gen) == (1, 1)
    assert len(skipped) == 1 and os.path.basename(path) in skipped[0]


# ---------------------------------------------------------------------- #
# clients across packages                                                #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("client, service", [("ref", "port"),
                                             ("port", "ref")])
def test_client_across_packages(world, tmp_path, client, service):
    """One package's ``LiveClient`` streaming a recorded fleet into the
    other's inline service: the rows of that package's own replay of the
    same files, and equal across the two directions' packages."""
    chunk_lists, topo = mk_jobs(world[0])
    logdir = str(tmp_path / "logs")
    os.makedirs(logdir)
    write_logs(logdir, chunk_lists)
    sv, cl = Ctx(PKGS[service], world, tmp_path / "s"), \
        Ctx(PKGS[client], world, tmp_path / "c")
    want, _ = sv.oracle(logdir, topo, chunk_lists)
    assert want == Ctx(PKGS[client], world, tmp_path / "o").oracle(
        logdir, topo, chunk_lists)[0]
    got = []
    svc = sv.service(sv.P.serve.ServiceConfig(port=0,
                                              default_engine=sv.ecfg()),
                     topo, got).start()
    try:
        c = cl.P.serve.LiveClient("127.0.0.1", svc.port)
        cl.stream_all(c, chunk_lists, logdir)
        c.close()
        wait_for(lambda: departed(svc, chunk_lists),
                 "every job left")
    finally:
        svc.finalize()
    assert sv.rows(got) == want
    assert any(r["origin"] == "fleet" for r in want)


# ---------------------------------------------------------------------- #
# the reference's service cases, on both packages                        #
# ---------------------------------------------------------------------- #
def case_socket_ingest(c, worker_kind):
    chunk_lists, topo = mk_jobs(c.prog)
    logdir = os.path.join(c.d, "logs")
    os.makedirs(logdir)
    write_logs(logdir, chunk_lists)
    oracle, ostats = c.oracle(logdir, topo, chunk_lists)
    assert oracle and any(r["origin"] == "fleet" for r in oracle)
    got = []
    S = c.P.serve
    svc = c.service(S.ServiceConfig(port=0, worker_kind=worker_kind,
                                    workers=2, default_engine=c.ecfg()),
                    topo, got).start()
    try:
        cl = S.LiveClient("127.0.0.1", svc.port)
        c.stream_all(cl, chunk_lists, logdir)
        cl.close()
        wait_for(lambda: departed(svc, chunk_lists),
                 "every job left")
    finally:
        svc.finalize()
    assert c.rows(got) == oracle
    assert svc.stats.events == ostats.events
    assert dict(sorted(svc.stats.per_job.items())) == ostats.per_job
    cnt = counters(svc.telemetry)
    assert cnt["serve.frames"] == sum(len(x) for x in chunk_lists.values())
    assert cnt["serve.bytes_in"] > 0
    assert cnt.get("serve.dropped_frames", 0) == 0
    return dict(rows=c.rows(got), events=svc.stats.events,
                per_job=dict(sorted(svc.stats.per_job.items())),
                counts={k: cnt.get(k, 0) for k in (
                    "serve.frames", "serve.bytes_in", "serve.dropped_frames",
                    "serve.connections")})


def case_join_leave(c):
    """A job leaves early; its frame after BYE is dropped and counted; the
    full stream equals a fleet that never saw it."""
    chunk_lists, topo = mk_jobs(c.prog)
    logdir = os.path.join(c.d, "logs")
    os.makedirs(logdir)
    write_logs(logdir, chunk_lists)
    leaver = sorted(chunk_lists)[0]
    oracle, _ = c.oracle(logdir, topo, chunk_lists)
    got = []
    S = c.P.serve
    svc = c.service(S.ServiceConfig(port=0, default_engine=c.ecfg()), topo,
                    got).start()
    try:
        cl = S.LiveClient("127.0.0.1", svc.port)
        for jid in sorted(chunk_lists):
            cl.hello(jid)
        chunks = {jid: [b for b, _ in c.P.store.iter_trace_chunks(
            os.path.join(logdir, f"{jid}.fcs"))] for jid in chunk_lists}
        for b in chunks[leaver]:
            cl.send_batch(leaver, b)
        cl.bye(leaver)
        straggler = chunks[leaver][-1]
        cl.send_batch(leaver, straggler)    # post-BYE: dropped, counted
        for jid in sorted(chunk_lists):
            if jid != leaver:
                for b in chunks[jid]:
                    cl.send_batch(jid, b)
                cl.bye(jid)
        cl.close()
        wait_for(lambda: departed(svc, chunk_lists),
                 "every job left")
    finally:
        svc.finalize()
    assert c.rows(got) == oracle
    key = f"fleet.departed_rows{{job={leaver}}}"
    assert counters(svc.telemetry)[key] == len(straggler)
    return dict(rows=c.rows(got), departed=counters(svc.telemetry)[key])


def case_torn_connection(c):
    """A connection torn mid-frame and one sending a corrupt BATCH cost
    two counted drops; the healthy connection's jobs are diagnosed as if
    they never happened."""
    chunk_lists, topo = mk_jobs(c.prog, jobs=2)
    logdir = os.path.join(c.d, "logs")
    os.makedirs(logdir)
    write_logs(logdir, chunk_lists)
    oracle, _ = c.oracle(logdir, topo, chunk_lists)
    got = []
    S = c.P.serve
    svc = c.service(S.ServiceConfig(port=0, default_engine=c.ecfg()), topo,
                    got).start()
    try:
        s = socket.create_connection(("127.0.0.1", svc.port))
        s.sendall(S.batch_frame("torn-job", b"x" * 256)[:30])
        s.close()
        s2 = socket.create_connection(("127.0.0.1", svc.port))
        s2.sendall(S.hello_frame("bad-job"))
        s2.sendall(S.batch_frame("bad-job", b"this is not FCS"))
        wait_for(lambda: svc.telemetry.value("serve.dropped_frames") == 2,
                 "both bad connections counted")
        s2.close()
        cl = S.LiveClient("127.0.0.1", svc.port)
        c.stream_all(cl, chunk_lists, logdir)
        cl.close()
        wait_for(lambda: departed(svc, chunk_lists),
                 "every job left")
    finally:
        svc.finalize()
    assert c.rows(got) == oracle
    assert svc.telemetry.value("serve.dropped_frames") == 2
    return dict(rows=c.rows(got),
                dropped=svc.telemetry.value("serve.dropped_frames"))


def case_tail_ingest(c):
    chunk_lists, topo = mk_jobs(c.prog)
    logdir = os.path.join(c.d, "logs")
    os.makedirs(logdir)
    write_logs(logdir, chunk_lists)
    oracle, ostats = c.oracle(logdir, topo, chunk_lists)
    got = []
    S = c.P.serve
    svc = c.service(S.ServiceConfig(port=None, tail_dir=logdir,
                                    default_engine=c.ecfg()),
                    topo, got).start()
    wait_for(lambda: svc.tailer.stats.events >= ostats.events,
             "the tailer reached the spills' events")
    svc.finalize()
    assert c.rows(got) == oracle
    assert signature(svc.tailer.stats) == signature(ostats)
    return dict(rows=c.rows(got), stats=signature(svc.tailer.stats))


def case_tail_growing(c):
    """A half-written segment is invisible; completing it delivers it;
    bytes are decoded once."""
    batch = c.sim(5, 3)
    full = os.path.join(c.d, "done.fcs")
    c.P.store.write_trace(batch, full, codec="fcs")
    blob = open(full, "rb").read()
    grow = os.path.join(c.d, "grow.fcs")
    sunk = []
    tailer = c.P.tail.FileTailer(c.d, lambda j, b: sunk.append((j, b)))
    with open(grow, "wb") as f:
        f.write(blob[:len(blob) // 2])
        f.flush()
        tailer.poll_once()
        assert [j for j, _ in sunk] == ["done"]
        f.write(blob[len(blob) // 2:])
    tailer.poll_once()
    assert sorted(j for j, _ in sunk) == ["done", "grow"]
    assert sum(len(b) for j, b in sunk if j == "grow") == len(batch)
    n = len(sunk)
    tailer.poll_once()
    assert len(sunk) == n
    return dict(sunk=[(j, len(b)) for j, b in sunk],
                stats=signature(tailer.stats))


def case_tail_corruption(c):
    """A torn tail and structural garbage land as ``corrupt_files`` with
    the intact leading segments delivered, as replay counts them."""
    batch = c.sim(5, 3)
    ok = os.path.join(c.d, "ok.fcs")
    c.P.store.write_trace(batch, ok, codec="fcs")
    blob = open(ok, "rb").read()
    with open(os.path.join(c.d, "torn.fcs"), "wb") as f:
        f.write(blob + blob[:len(blob) // 3])
    with open(os.path.join(c.d, "garbage.fcs"), "wb") as f:
        f.write(b"\x00garbage not a segment" * 8)
    sunk = []
    tailer = c.P.tail.FileTailer(c.d, lambda j, b: sunk.append((j, len(b))))
    tailer.poll_once()
    tailer.finish()
    rstats = c.P.fleet.FleetReplayer(c.mux(fleet_tier=False)).replay_dir(
        c.d, job_workers=1)
    assert tailer.stats.corrupt_files == rstats.corrupt_files == 2
    assert tailer.stats.events == rstats.events
    assert tailer.stats.files == rstats.files
    assert sum(n for j, n in sunk if j == "torn") == len(batch)
    with pytest.raises(c.P.store.CodecError):
        c.P.store.tail_complete_segments(os.path.join(c.d, "garbage.fcs"))
    return dict(sunk=sorted(sunk), stats=signature(tailer.stats))


def case_tail_jsonl(c):
    batch = c.sim(5, 2)
    path = os.path.join(c.d, "j1.jsonl")
    c.P.store.write_trace(batch, path, codec="jsonl")
    with open(path, "a") as f:
        f.write("{not valid json\n")
    sunk = []
    tailer = c.P.tail.FileTailer(c.d, lambda j, b: sunk.append(len(b)))
    tailer.poll_once()
    tailer.finish()
    assert sum(sunk) == len(batch)
    assert tailer.stats.skipped_lines == 1 and tailer.stats.files == 1
    return dict(sunk=sunk, stats=signature(tailer.stats))


def case_retire_job(c):
    """Retiring each job at its end of stream equals one terminal
    finalize; a retired job's stragglers are dropped and counted."""
    chunk_lists, topo = mk_jobs(c.prog)
    chunk_lists = {j: [c.conv(x) for x in cs]
                   for j, cs in chunk_lists.items()}

    def run(retire: bool):
        mux = c.mux(topo)
        for jid in chunk_lists:
            mux.add_job(jid, c.ecfg())
        out = []
        for jid in sorted(chunk_lists):
            for x in chunk_lists[jid]:
                mux.ingest(jid, x)
            if retire:
                mux.retire_job(jid)
                out.extend(mux.poll())
                mux.ingest(jid, chunk_lists[jid][-1])
        out.extend(mux.finalize())
        return mux, c.rows(out)

    _, plain = run(False)
    mux_b, retired = run(True)
    assert retired == plain and plain
    jid0 = sorted(chunk_lists)[0]
    key = f"fleet.departed_rows{{job={jid0}}}"
    assert counters(mux_b.telemetry)[key] == len(chunk_lists[jid0][-1])
    assert mux_b.job(jid0).departed
    return dict(rows=plain, departed=counters(mux_b.telemetry)[key])


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def case_sink_backoff(c, monkeypatch):
    """The live sink against a port nothing listens on: every call a
    counted drop, never an exception; a fake clock shows that calls inside
    the backoff make no connect attempt and that the backoff doubles."""
    attempts = []
    real = socket.create_connection

    def counted(*a, **kw):
        attempts.append(a[0])
        return real(*a, **kw)

    monkeypatch.setattr(socket, "create_connection", counted)
    now = [100.0]
    reg = c.P.telemetry.TelemetryRegistry()
    sink = c.P.serve.LiveBatchSink(f"127.0.0.1:{free_port()}", "j1",
                                   telemetry=reg, timeout=0.2,
                                   backoff_s=60.0, backoff_max_s=1000.0,
                                   clock=lambda: now[0])
    batch = c.sim(5, 1)
    trail = []
    for dt in (0.0, 0.0, 59.0, 1.0, 60.0, 60.0):
        now[0] += dt
        trail.append((sink(batch), len(attempts)))
    assert trail == [(False, 1), (False, 1), (False, 1), (False, 2),
                     (False, 2), (False, 3)]
    cnt = counters(reg)
    assert cnt["daemon.live_dropped"] == 6
    assert cnt.get("daemon.live_reconnects", 0) == 0
    sink.close()
    return dict(trail=trail, counts=cnt)


def case_daemon_live(c):
    """The daemon's ``live_endpoint``: its drains reach the service as the
    HELLO'd job with its topology, no drop, and BYE at detach."""
    S = c.P.serve
    svc = c.service(S.ServiceConfig(port=0, default_engine=c.ecfg()),
                    fleet_tier=False).start()
    try:
        D = c.P.daemon
        d = D.TracingDaemon(D.DaemonConfig(
            rank=0, drain_interval=0.01, hang_timeout=1e9,
            live_endpoint=f"127.0.0.1:{svc.port}", live_job_id="dj",
            live_topology={"rack": "r9"}))
        spans = []
        d.add_sink(spans.extend)
        d.attach()
        for s in range(3):
            d.step_begin(s)
            d.record_span(c.P.events.EventKind.KERNEL_COMPUTE, "mm",
                          1.0 + s, 1.0 + s + 1e-4)
            d.step_end()
        d.detach()
        wait_for(lambda: departed(svc, ["dj"]), "the job's BYE")
        events = svc.mux.job("dj").store.events_total
        topo = svc.mux.topology["dj"]
        cnt = counters(d.telemetry)
    finally:
        svc.finalize()
    assert events == len(spans)
    assert topo == {"rack": "r9"}
    assert cnt["daemon.live_frames"] > 0
    assert cnt.get("daemon.live_dropped", 0) == 0
    EK = c.P.events.EventKind
    traced = sorted((e.name, e.step) for e in spans
                    if e.kind in (EK.KERNEL_COMPUTE, EK.STEP))
    assert len(traced) == 6
    return dict(traced=traced, topo=topo,
                dropped=cnt.get("daemon.live_dropped", 0))


def case_max_connections(c):
    S = c.P.serve
    svc = c.service(S.ServiceConfig(port=0, max_connections=1,
                                    default_engine=c.ecfg()),
                    fleet_tier=False).start()
    try:
        cl = S.LiveClient("127.0.0.1", svc.port)
        cl.hello("j-keep")
        wait_for(lambda: svc.mux.jobs, "the first connection's job")
        s = socket.create_connection(("127.0.0.1", svc.port), timeout=5)
        s.settimeout(5)
        assert s.recv(1) == b""            # clean server-side close
        s.close()
        assert svc.telemetry.value("serve.rejected_connections") == 1
        batch = c.sim(5, 1)
        cl.send_batch("j-keep", c.P.store.encode_batch_bytes(batch))
        wait_for(lambda: svc.mux.job("j-keep").store.events_total
                 == len(batch), "the kept connection's frame")
        cl.close()
    finally:
        svc.finalize()
    assert svc.telemetry.value("serve.dropped_frames") == 0
    return dict(rejected=svc.telemetry.value("serve.rejected_connections"),
                events=svc.mux.job("j-keep").store.events_total)


def case_shedding(c):
    """Over the per-job inflight cap a frame is shed undecoded and
    counted; under it frames flow again."""
    S = c.P.serve
    svc = c.service(S.ServiceConfig(port=None, worker_kind="process",
                                    workers=1, max_inflight_frames=4,
                                    default_engine=c.ecfg()),
                    fleet_tier=False)
    svc.start()
    shed = []
    try:
        batch = c.sim(5, 1)
        payload = c.P.store.encode_batch_bytes(batch)
        svc.join_job("shed-j")
        with svc._reg_lock:
            svc._inflight["shed-j"] = 4
        for _ in range(2):
            svc.ingest_frame("shed-j", payload)
            shed.append(svc.telemetry.value("serve.shed_frames",
                                            job="shed-j"))
        with svc._reg_lock:
            svc._inflight["shed-j"] = 0
        svc.ingest_frame("shed-j", payload)
        shed.append(svc.telemetry.value("serve.shed_frames", job="shed-j"))
        wait_for(lambda: svc.telemetry.value("serve.inflight",
                                             job="shed-j") == 0,
                 "the accepted frame acknowledged")
    finally:
        svc.finalize()
    assert shed == [1, 2, 2]
    assert svc.stats.events == len(batch)
    return dict(shed=shed, events=svc.stats.events)


def case_rehello_restart(c):
    """A service killed mid-stream: the sink's calls are counted drops;
    on a restarted service on the same port its reconnect re-sends HELLO,
    and the fresh service learns the topology again."""
    S = c.P.serve
    svc1 = c.service(S.ServiceConfig(port=0, default_engine=c.ecfg()),
                     fleet_tier=False).start()
    port = svc1.port
    reg = c.P.telemetry.TelemetryRegistry()
    now = [0.0]
    sink = S.LiveBatchSink(f"127.0.0.1:{port}", "dj",
                           topology={"rack": "r9"}, telemetry=reg,
                           timeout=2.0, backoff_s=1.0, backoff_max_s=1.0,
                           clock=lambda: now[0])
    batch = c.sim(5, 1)
    try:
        assert sink(batch) is True
        wait_for(lambda: svc1.mux.topology.get("dj") == {"rack": "r9"},
                 "the first service's HELLO")
        svc1.kill()
        dropped = 0
        while not dropped:       # the first send may land in TCP's buffer
            dropped = int(sink(batch) is False)
        svc2 = c.service(S.ServiceConfig(port=port, default_engine=c.ecfg()),
                         fleet_tier=False).start()
        try:
            now[0] += 1.0                 # past the backoff
            assert sink(batch) is True
            wait_for(lambda: svc2.mux.topology.get("dj") == {"rack": "r9"}
                     and svc2.mux.job("dj").store.events_total == len(batch),
                     "the restarted service's HELLO and frame")
        finally:
            svc2.finalize()
        cnt = counters(reg)
        assert cnt["daemon.live_reconnects"] == 1
        assert cnt["daemon.live_dropped"] >= 1
    finally:
        sink.close()
    return dict(reconnects=cnt["daemon.live_reconnects"],
                events=svc2.mux.job("dj").store.events_total)


def case_worker_death(c):
    """A worker process killed mid-run: the service rewinds to its
    checkpoint, respawns the pool, replays the tail suffix and suppresses
    what it already delivered; the stream equals the uninterrupted one."""
    chunk_lists, topo = mk_jobs(c.prog)
    logdir = os.path.join(c.d, "logs")
    os.makedirs(logdir)
    first = {j: x[:len(x) // 2] for j, x in chunk_lists.items()}
    rest = {j: x[len(x) // 2:] for j, x in chunk_lists.items()}
    half = sum(len(x) for xs in first.values() for x in xs)
    total = sum(len(x) for xs in chunk_lists.values() for x in xs)
    write_logs(logdir, first)
    got = []
    S = c.P.serve
    svc = c.service(S.ServiceConfig(
        port=None, tail_dir=logdir, tail_poll_s=0.005, drain_interval_s=0.01,
        worker_kind="process", workers=2,
        checkpoint_dir=os.path.join(c.d, "ckpt"),
        checkpoint_on_finalize=False, default_engine=c.ecfg()),
        topo, got).start()
    try:
        wait_for(lambda: svc.tailer.stats.events >= half, "half the events")
        emitted = svc.checkpoint()["anomalies_emitted"]
        write_logs(logdir, rest)
        wait_for(lambda: len(got) > emitted, "a post-checkpoint delivery")
        svc._pool.kill_worker(svc._pool.worker_for(sorted(chunk_lists)[0]))
        wait_for(lambda: svc.telemetry.value("serve.worker_respawns") >= 1,
                 "the pool respawned")
        wait_for(lambda: svc.tailer.stats.events >= total, "all events")
    finally:
        svc.finalize()
    oracle, ostats = c.oracle(logdir, topo, chunk_lists)
    assert c.rows(got) == oracle
    assert svc.tailer.stats.events == ostats.events
    assert dict(sorted(svc.tailer.stats.per_job.items())) == ostats.per_job
    assert svc.telemetry.value("serve.deduped_anomalies") >= 1
    assert svc.telemetry.value("serve.recovery_dedup_mismatch") == 0
    assert svc.telemetry.value("serve.worker_deaths") >= 1
    return dict(rows=c.rows(got), events=svc.tailer.stats.events)


def case_archive_budgets(c):
    batches = [c.sim(20 + part, 3) for part in range(3)]
    for part, batch in enumerate(batches):
        c.P.store.write_trace(
            batch, c.P.store.seg_path(os.path.join(c.d, "big.fcs3"), part),
            codec="fcs3")
    arch = c.P.archive.TraceArchive(c.d)
    full, scan_full = arch.query_events("big", with_scan=True)
    assert not scan_full.truncated
    cut, scan_cut = arch.query_events("big", with_scan=True, max_bytes=1)
    assert scan_cut.truncated and 0 < len(cut) < len(full)
    assert len(arch.query_events("big", with_scan=True,
                                 max_bytes=1)[0]) == len(cut)
    series = arch.query_metrics("big")
    short, truncated = arch.query_metrics("big", max_bytes=1,
                                          with_truncation=True)
    assert truncated and 0 < len(short) <= len(series)
    assert arch.query_metrics("big", max_bytes=1,
                              with_truncation=True) == (short, True)
    cnt = counters(arch.telemetry)
    assert cnt["archive.truncated_queries{kind=events}"] == 2
    assert cnt["archive.truncated_queries{kind=metrics}"] == 2
    return dict(full=len(full), cut=len(cut), series=series, short=short)


def case_query_plane(c):
    chunk_lists, topo = mk_jobs(c.prog, jobs=2)
    logdir = os.path.join(c.d, "logs")
    os.makedirs(logdir)
    write_logs(logdir, chunk_lists)
    _, ostats = c.oracle(logdir, topo, chunk_lists)
    S = c.P.serve
    svc = c.service(S.ServiceConfig(port=0, query_port=0, tail_dir=logdir,
                                    archive_dir=logdir,
                                    archive_max_bytes=1 << 20,
                                    default_engine=c.ecfg()),
                    topo).start()
    try:
        wait_for(lambda: svc.tailer.stats.events >= ostats.events,
                 "the tailer reached the spills' events")
        svc.collect()
        base = f"http://127.0.0.1:{svc.query_port}"

        def get(p):
            with urllib.request.urlopen(base + p, timeout=10) as r:
                return json.load(r)

        jobs = get("/jobs")["jobs"]
        assert set(jobs) == set(chunk_lists)
        assert all(j["open"] for j in jobs.values())
        anoms = get("/anomalies")["anomalies"]
        assert anoms and {"job", "kind", "team", "origin"} <= set(anoms[0])
        assert len(get("/anomalies?n=5")["anomalies"]) == min(5, len(anoms))
        weather = get("/weather")
        assert weather["jobs_open"] == 2 and weather["anomalies_recent"] > 0
        tele = get("/telemetry")
        assert "serve.tail_segments" in tele["telemetry"].get(
            "counters", tele["telemetry"])
        assert "per_job" in tele["queues"]
        jid = sorted(chunk_lists)[0]
        ev = get(f"/archive/events?job={jid}&step_lo=0&step_hi=3&limit=5")
        assert ev["rows"] > 0 and len(ev["events"]) <= 5
        assert not ev["truncated"]
        assert get(f"/archive/events?job={jid}&max_bytes=1")["truncated"]
        met = get(f"/archive/metrics?job={jid}&metric=throughput")
        assert met["series"] and not met["truncated"]
        with pytest.raises(urllib.error.HTTPError):
            get("/nope")
    finally:
        svc.finalize()
    return dict(jobs=jobs, anomalies=anoms, weather=weather, events=ev,
                metrics=met)


def case_restore_none(c):
    """An empty checkpoint directory: ``restore()`` is None and the service
    replays cold, with unchanged results."""
    chunk_lists, topo = mk_jobs(c.prog, jobs=2, prefix="ck")
    logdir = os.path.join(c.d, "logs")
    os.makedirs(logdir)
    write_logs(logdir, chunk_lists)
    oracle, ostats = c.oracle(logdir, topo, chunk_lists)
    got = []
    S = c.P.serve
    svc = c.service(S.ServiceConfig(port=None, tail_dir=logdir,
                                    checkpoint_dir=os.path.join(c.d, "ckpt"),
                                    checkpoint_on_finalize=False,
                                    default_engine=c.ecfg()), topo, got)
    assert svc.restore() is None
    svc.start()
    wait_for(lambda: svc.tailer.stats.events >= ostats.events, "all events")
    svc.finalize()
    assert c.rows(got) == oracle
    assert svc.telemetry.value("serve.restore_fallbacks") == 1
    return dict(rows=c.rows(got))


def case_restore_kind_mismatch(c):
    C, S = c.P.ckpt, c.P.serve
    C.CheckpointStore(c.d).save({"worker_kind": "inline", "service": {},
                                 "fleet": {}, "jobs": {}, "telemetry": {},
                                 "tail": None})
    svc = S.FleetService(c.P.fleet.FleetMultiplexer(
        c.P.fleet.FleetConfig()), S.ServiceConfig(
            port=None, worker_kind="process", workers=1, checkpoint_dir=c.d))
    with pytest.raises(C.CheckpointError, match="worker_kind") as e:
        svc.restore()
    return dict(error=str(e.value).replace(c.d, "<dir>"))


def case_kill_restore(c):
    """Checkpoint mid-stream, kill, land the rest while dead, restore past
    a garbage and a torn generation: the stitched stream and stats equal
    an uninterrupted run's, and every spill byte is decoded once across
    the two incarnations."""
    chunk_lists, topo = mk_jobs(c.prog, prefix="ck")
    logdir = os.path.join(c.d, "logs")
    ckdir = os.path.join(c.d, "ckpt")
    os.makedirs(logdir)
    first = {j: x[:len(x) // 2] for j, x in chunk_lists.items()}
    rest = {j: x[len(x) // 2:] for j, x in chunk_lists.items()}
    half = sum(len(x) for xs in first.values() for x in xs)
    S = c.P.serve
    scfg = S.ServiceConfig(port=None, tail_dir=logdir, tail_poll_s=0.005,
                           drain_interval_s=0.01, checkpoint_dir=ckdir,
                           checkpoint_on_finalize=False,
                           default_engine=c.ecfg())
    write_logs(logdir, first)
    got1 = []
    svc1 = c.service(scfg, topo, got1).start()
    wait_for(lambda: svc1.tailer.stats.events >= half, "half the events")
    meta = svc1.checkpoint()
    svc1.kill()
    assert meta["generation"] == 1 and meta["tail_bytes_decoded"] > 0
    pre = got1[:meta["anomalies_emitted"]]
    assert len(pre) == meta["anomalies_emitted"]
    write_logs(logdir, rest)
    oracle, ostats = c.oracle(logdir, topo, chunk_lists)
    full = spill_bytes(logdir)
    good = open(meta["path"], "rb").read()
    with open(os.path.join(ckdir, "ckpt-99999990.flc"), "wb") as f:
        f.write(b"\xde\xad\xbe\xef garbage, not a checkpoint " * 64)
    with open(os.path.join(ckdir, "ckpt-99999991.flc"), "wb") as f:
        f.write(good[:len(good) // 2])
    got2 = []
    svc2 = c.service(scfg, topo, got2)
    meta2 = svc2.restore()
    assert meta2["generation"] == meta["generation"]
    assert len(meta2["skipped"]) == 2
    for planted in ("ckpt-99999990.flc", "ckpt-99999991.flc"):
        assert any(planted in s for s in meta2["skipped"])
    assert meta2["anomalies_emitted"] == meta["anomalies_emitted"]
    svc2.start()
    wait_for(lambda: svc2.tailer.stats.events >= ostats.events, "all events")
    svc2.finalize()
    assert c.rows(pre + got2) == oracle
    assert svc2.tailer.stats.events == ostats.events
    assert dict(sorted(svc2.tailer.stats.per_job.items())) == ostats.per_job
    assert svc2.tailer.stats.bytes_decoded == full
    assert 0 < full - meta["tail_bytes_decoded"] < full
    return dict(rows=c.rows(pre + got2), full=full,
                skipped=len(meta2["skipped"]),
                stats=signature(svc2.tailer.stats))


def case_finalize_checkpoint(c):
    chunk_lists, topo = mk_jobs(c.prog, jobs=2, prefix="ck")
    logdir = os.path.join(c.d, "logs")
    os.makedirs(logdir)
    write_logs(logdir, chunk_lists)
    ckdir = os.path.join(c.d, "ckpt")
    S = c.P.serve
    svc = c.service(S.ServiceConfig(port=None, tail_dir=logdir,
                                    checkpoint_dir=ckdir,
                                    default_engine=c.ecfg()), topo).start()
    wait_for(lambda: svc.tailer.stats.events > 0, "a tailed event")
    svc.finalize()
    gens = c.P.ckpt.CheckpointStore(ckdir).generations()
    assert gens == [1]
    assert svc.telemetry.value("serve.checkpoints") == 1
    return dict(gens=gens)


SERVICE_CASES = {
    "socket-inline": lambda c, mp: case_socket_ingest(c, "inline"),
    "socket-process": lambda c, mp: case_socket_ingest(c, "process"),
    "join-leave": lambda c, mp: case_join_leave(c),
    "torn-connection": lambda c, mp: case_torn_connection(c),
    "tail-ingest": lambda c, mp: case_tail_ingest(c),
    "tail-growing": lambda c, mp: case_tail_growing(c),
    "tail-corruption": lambda c, mp: case_tail_corruption(c),
    "tail-jsonl": lambda c, mp: case_tail_jsonl(c),
    "retire-job": lambda c, mp: case_retire_job(c),
    "sink-backoff": case_sink_backoff,
    "daemon-live": lambda c, mp: case_daemon_live(c),
    "max-connections": lambda c, mp: case_max_connections(c),
    "shedding": lambda c, mp: case_shedding(c),
    "rehello-restart": lambda c, mp: case_rehello_restart(c),
    "worker-death": lambda c, mp: case_worker_death(c),
    "archive-budgets": lambda c, mp: case_archive_budgets(c),
    "query-plane": lambda c, mp: case_query_plane(c),
    "restore-none": lambda c, mp: case_restore_none(c),
    "restore-kind-mismatch": lambda c, mp: case_restore_kind_mismatch(c),
    "kill-restore": lambda c, mp: case_kill_restore(c),
    "finalize-checkpoint": lambda c, mp: case_finalize_checkpoint(c),
}


@pytest.mark.parametrize("case", list(SERVICE_CASES))
def test_service_case_equals_the_reference(world, tmp_path, monkeypatch,
                                           case):
    """One case of the reference's service and checkpoint tests, run on
    each package with its own checks: the port's results (rows, stats,
    counts) are the reference's."""
    got = {name: SERVICE_CASES[case](Ctx(P, world, tmp_path / name),
                                      monkeypatch)
           for name, P in PKGS.items()}
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------- #
# a port trainer streaming live                                          #
# ---------------------------------------------------------------------- #
TOPOLOGY = {"rack": "r-cpu", "switch": "s-cpu"}
FLEET_TIER = ["cross_job_failslow"]


def _run(steps, log=None, hook=None) -> Trainer:
    return Trainer(RunConfig(model=get_reduced("llama3.2-1b"), global_batch=2,
                             seq_len=64, steps=steps, warmup_steps=2,
                             flare=True, mask_mode="fast", flare_log=log,
                             data_prefetch=True, device="cpu"),
                   fault_hook=hook)


def live_daemon(trainer: Trainer, endpoint: str, job: str) -> TracingDaemon:
    """The trainer's daemon replaced before ``train()`` by one with the
    same config and a live endpoint, as a user wires a live trainer."""
    trainer.daemon = TracingDaemon(dataclasses.replace(
        trainer.daemon.cfg, live_endpoint=endpoint, live_job_id=job,
        live_topology=TOPOLOGY))
    return trainer.daemon


@pytest.fixture(scope="module")
def cpu_history(tmp_path_factory):
    """A healthy profile of the CPU job, learned from a run of its own and
    saved as JSON for each package to read."""
    d = tmp_path_factory.mktemp("history")
    trainer = _run(6)
    events: list = []
    trainer.daemon.add_sink(events.extend)
    trainer.train()
    eng = DiagnosticEngine(EngineConfig(backend="dense-train"),
                           HistoryStore(str(d)))
    eng.ingest(events)
    eng.learn_healthy(steps=list(range(1, 6)))
    return str(d)


def _service(history, got=None, **kw) -> FleetService:
    return FleetService(
        FleetMultiplexer(FleetConfig(watermark_delay=1,
                                     fleet_detectors=FLEET_TIER),
                         history=HistoryStore(history)),
        ServiceConfig(default_engine=EngineConfig(backend="dense-train",
                                                  num_ranks=1), **kw),
        on_anomaly=None if got is None else (lambda fa, t: got.append(fa)))


def _replays(spill_dir, history, topo) -> tuple:
    """The job's spill replayed by the port and by the reference, each
    with the profile read back from JSON: (rows, rows)."""
    out = []
    for P in (PKGS["port"], PKGS["ref"]):
        mux = P.fleet.FleetMultiplexer(
            P.fleet.FleetConfig(watermark_delay=1, fleet_detectors=FLEET_TIER,
                                topology=topo),
            history=P.history.HistoryStore(history))
        for job in sorted(os.path.splitext(f)[0]
                          for f in os.listdir(spill_dir)):
            mux.add_job(job, P.engine.EngineConfig(backend="dense-train",
                                                   num_ranks=1))
        P.fleet.FleetReplayer(mux).replay_dir(spill_dir, job_workers=1)
        out.append(rows(P, mux.finalize()))
    return tuple(out)


def spill_segments(spill_dir) -> int:
    return sum(len(list(segment_stats(os.path.join(spill_dir, f))))
               for f in os.listdir(spill_dir))


@pytest.mark.parametrize("worker_kind", ["inline", "process"])
def test_live_trainer_equals_the_replay_of_its_spill(cpu_history, tmp_path,
                                                     worker_kind):
    """A reduced llama trained on the CPU, its daemon replaced by one with
    a live endpoint into a port service (two steps slowed by the fault
    hook): the service's stream after ``finalize`` names the fail-slow and
    equals the port's and the reference's replays of the daemon's spill;
    one frame a drain, none dropped, the job's topology from its HELLO,
    its events as in the spill, and its BYE at detach."""
    spill_dir = tmp_path / "spill"
    spill_dir.mkdir()
    got = []
    svc = _service(cpu_history, got, port=0, worker_kind=worker_kind,
                   workers=2).start()
    try:
        trainer = _run(10, str(spill_dir / "cpu-live.fcs"), SlowSteps())
        d = live_daemon(trainer, f"127.0.0.1:{svc.port}", "cpu-live")
        trainer.train()
        wait_for(lambda: departed(svc, ["cpu-live"]), "the job's BYE")
        topo = dict(svc.mux.topology)
    finally:
        svc.finalize()
    want, ref = _replays(str(spill_dir), cpu_history, topo)
    assert ref == want
    assert rows(PKGS["port"], got) == want
    assert any(r["kind"] == "fail_slow" and r["metric"] == "throughput"
               for r in want)
    assert topo == {"cpu-live": TOPOLOGY}
    cnt = counters(d.telemetry)
    assert cnt["daemon.live_frames"] == spill_segments(str(spill_dir))
    assert cnt.get("daemon.live_dropped", 0) == 0
    assert cnt.get("daemon.live_reconnects", 0) == 0
    events = len(store.read_trace(str(spill_dir / "cpu-live.fcs")))
    assert svc.stats.per_job == {"cpu-live": events}
    assert svc.telemetry.value("serve.dropped_frames") == 0


def test_live_trainer_through_a_service_restart(cpu_history, tmp_path,
                                                monkeypatch):
    """The same job with its service killed before step 3 and a fresh one
    started on the same port before step 5; the sink's clock is a fake
    one the hook moves a second a step, so its 0.5 s backoff doubling
    spans steps, not host time.  Drops are counted, the reconnect
    re-HELLOs the topology, the daemon thread raises nothing, every drain
    is a frame or a drop, the fresh service holds exactly the events sent
    after the reconnect, and the spill holds every step."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
    from chip_smoke import LiveSinkTap
    raised = []
    monkeypatch.setattr(threading, "excepthook", raised.append)
    spill_dir = tmp_path / "spill"
    spill_dir.mkdir()
    first = _service(cpu_history, port=0).start()
    port = first.port
    restarted = {}
    now = [0.0]

    def hook(step):
        now[0] = float(step)
        if step == 3:
            first.kill()
        elif step == 5:
            restarted["svc"] = _service(cpu_history, port=port).start()

    trainer = _run(12, str(spill_dir / "cpu-restart.fcs"), hook)
    d = live_daemon(trainer, f"127.0.0.1:{port}", "cpu-restart")
    d._live._clock = lambda: now[0]
    tap = LiveSinkTap(d)
    try:
        trainer.train()
        second = restarted["svc"]
        wait_for(lambda: departed(second, ["cpu-restart"]),
                 "the restarted service's BYE")
    finally:
        first.kill()
        if "svc" in restarted:
            restarted["svc"].finalize()
    assert not raised
    cnt = counters(d.telemetry)
    assert cnt["daemon.live_dropped"] >= 1
    assert cnt["daemon.live_reconnects"] >= 1
    assert cnt["daemon.live_frames"] + cnt["daemon.live_dropped"] == \
        spill_segments(str(spill_dir)) == len(tap.calls)
    assert second.mux.topology["cpu-restart"] == TOPOLOGY
    after = tap.sent_after_reconnect()
    assert after and second.stats.per_job == {
        "cpu-restart": sum(c[1] for c in after)}
    events = store.read_trace(str(spill_dir / "cpu-restart.fcs")).to_events()
    assert sorted({e.step for e in events if e.name.startswith("step_")}) \
        == list(range(12))
    assert not [e for e in events if e.name == "hang_suspect"]
