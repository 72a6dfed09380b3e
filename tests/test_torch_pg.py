"""The port's PG (``ceph_tpu_torch/osd/pg.py``) on its own, on the CPU.

- The two PG cases of ``tests/test_dencoder.py`` (``:245,283``): an old
  primary's v1 ``MECSubReadVec`` and ``MECSubRead`` blobs decode and
  serve through ``handle_sub_read_vec`` and ``handle_sub_read`` of a
  port PG built as ``test_recovery_pipeline.py``'s ``_stub_pg`` builds
  it; each reply is also held to the reference PG's bytes.
- The no-card rule: a PG whose codec was built without a device raises
  when there is no card, and never runs on the CPU on its own.
- The scrub and repair half on a clean PG: ``scrub``, ``repair``,
  ``repair_objects``, ``local_scrub_map``, ``scrub_engine().run`` and a
  read-only ``OP_CALL`` each complete, find nothing and leave the PG's
  log, info and store as they were but for the engine's stamps and
  cursor; with ``osd_scrub_auto_repair`` on, a read's checksum failure
  is served by reconstruction and its repair thread rebuilds the shard
  and takes ``scrub_errors`` back to 0; an ``OP_CALL`` on a staged
  object pulls its ``DeviceBuf`` back to host bytes, counted.
- F13 (ROADMAP queue 3): a replicated write whose ``MOSDRepOp`` a
  replica of a newer interval dropped commits once the laggard push
  brings that replica to the primary's head (the reference's waits);
  one whose entry a newer authoritative log rewound is dropped, never
  answered 0, however far the peers' heads have moved.
- F12 (ROADMAP queue 3): a resend of a write still in flight waits for
  its original and gets its result (the reference answers it EAGAIN).

Drive a port PG on the CPU like this: a ``device="cpu"`` codec and a
host (``torch_pg_harness.Net``, or the stub host of
``test_torch_recovery.py``).
"""

import binascii
import dataclasses
import os
import threading
import time

import pytest
import torch

import test_torch_recovery as tr
import torch_pg_harness as H

V1_CORPUS = os.path.join(os.path.dirname(__file__), "corpus_v1")
PROFILE = "plugin=isa k=4 m=2 technique=reed_sol_van"


def _v1_blob(name: str) -> bytes:
    with open(os.path.join(V1_CORPUS, name)) as f:
        return binascii.unhexlify(f.read().strip())


class _Conn:
    def __init__(self):
        self.sent = []

    def send(self, rep):
        self.sent.append(rep)


def _serving_pg(pkg, shards, chunk):
    """osd.1's PG of ``pkg`` with ``chunk`` stored as ``obj-a``'s
    ``shards``, each with its hinfo (``test_dencoder.py:262-272``)."""
    pg, osd = tr._stub_pg(pkg, PROFILE, acting=[0, 1, 2, 0, 1, 2], whoami=1,
                          kind="pg")
    M = pg.mods
    t = M["objectstore"].Transaction()
    for shard in shards:
        g = M["objectstore"].GHObject("obj-a", shard=shard)
        t.write(pg.coll, g, 0, chunk)
        t.setattrs(pg.coll, g, {"hinfo": M["backend"]._hinfo(
            chunk, 4 * len(chunk))})
    osd.store.queue_transaction(t)
    return pg


def test_legacy_mec_sub_read_vec_serves_through():
    """Mixed-version peers: an old primary's v1 MECSubReadVec (no runs
    tail) decodes on a port peer AND serves through
    handle_sub_read_vec — whole chunks come back with every served flag
    0 — in the reference PG's bytes."""
    from ceph_tpu_torch.msg.message import Message
    from ceph_tpu_torch.osd import messages as om

    blob = _v1_blob("MECSubReadVec_v1.hex")
    chunk = b"vec-served-chunk"
    replies = {}
    for pkg in tr.PKGS:
        msg = tr._mods(pkg)["message"].Message.from_bytes(blob)
        conn = _Conn()
        _serving_pg(pkg, (1, 4), chunk).handle_sub_read_vec(msg, conn)
        assert len(conn.sent) == 1
        replies[pkg] = conn.sent[0].to_bytes()
    msg = Message.from_bytes(blob)
    assert isinstance(msg, om.MECSubReadVec)
    rep = Message.from_bytes(replies["ceph_tpu_torch"])
    assert isinstance(rep, om.MECSubReadVecReply)
    assert rep.tid == msg.tid
    assert len(rep.rows) == len(msg.reads)
    assert rep.served == [0] * len(msg.reads)
    assert rep.rows[0][:4] == (1, "obj-a", chunk, 0)
    assert rep.rows[1][:4] == (4, "obj-a", chunk, 0)
    assert replies["ceph_tpu_torch"] == replies["ceph_tpu"]


def test_legacy_mec_sub_read_still_decodes_and_serves():
    """Mixed-version peers: an old primary's per-shard MECSubRead (the
    committed v1 blob) decodes on a port peer AND serves through
    handle_sub_read — the chunk and its meta in a scalar
    MECSubReadReply, in the reference PG's bytes."""
    from ceph_tpu_torch.msg.message import Message
    from ceph_tpu_torch.osd import messages as om

    blob = _v1_blob("MECSubRead_v1_serve.hex")
    chunk = b"served-chunk-bytes"
    replies = {}
    for pkg in tr.PKGS:
        msg = tr._mods(pkg)["message"].Message.from_bytes(blob)
        conn = _Conn()
        _serving_pg(pkg, (1,), chunk).handle_sub_read(msg, conn)
        assert len(conn.sent) == 1
        replies[pkg] = conn.sent[0].to_bytes()
    msg = Message.from_bytes(blob)
    assert isinstance(msg, om.MECSubRead)
    assert msg.pgid == (2, 5) and msg.shard == 1 and msg.oid == "obj-a"
    rep = Message.from_bytes(replies["ceph_tpu_torch"])
    assert isinstance(rep, om.MECSubReadReply)
    assert rep.tid == msg.tid and rep.result == 0
    assert rep.oid == "obj-a" and rep.shard == 1
    assert rep.data == chunk and "hinfo" in rep.attrs
    assert replies["ceph_tpu_torch"] == replies["ceph_tpu"]


def test_pg_without_a_device_raises_without_a_card(monkeypatch):
    """A codec built with no device means the card: without one it
    raises, and so does a PG over a codec that names no device — the PG
    never picks the CPU's plain versions on its own."""
    from ceph_tpu_torch.ec import codec_from_profile
    from ceph_tpu_torch.osd.osdmap import PGPool
    from ceph_tpu_torch.osd.pg import PG

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        codec_from_profile(PROFILE)
    codec = codec_from_profile(PROFILE, device="cpu")
    codec.device = None  # as a codec built with no device carries it
    osd = tr._StubOSD(tr._mods("ceph_tpu_torch"), 0, (1, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PG((3, 0), PGPool(pool_id=3, size=6), osd, codec)
    # the CPU is taken when asked for, and then the plain versions run
    pg = PG((3, 0), PGPool(pool_id=3, size=6), osd,
            codec_from_profile(PROFILE, device="cpu"))
    assert pg.backend.queue.device.type == "cpu"


SCRUB_ROWS = ("scrub_cursor", "scrub_stamps")


def _snapshot(net, meta_info: bool = True):
    """Every host's info, log, objects (with the PG meta's scrub cursor
    and stamps rows left out, and its persisted ``info`` unless
    ``meta_info``), state and missing set."""
    out = []
    for h in net.hosts:
        pg, st = h.pg, h.store
        objs = {}
        for o in st.collection_list(pg.coll):
            meta = o.name == "_pgmeta_"
            omap = {k: v for k, v in st.omap_get(pg.coll, o).items()
                    if not (meta and k in SCRUB_ROWS)}
            attrs = {k: v for k, v in st.getattrs(pg.coll, o).items()
                     if meta_info or not (meta and k == "info")}
            objs[(o.name, o.shard, o.snap)] = (
                bytes(st.read(pg.coll, o)), attrs, omap)
        out.append((str(pg.info.last_update), str(pg.info.committed_to),
                    [(str(e.version), e.oid) for e in pg.log.entries],
                    objs, pg.state, dict(pg.missing)))
    return out


def _scrub_rows(net):
    G = net.mods.os.GHObject
    return [{k: v for k, v in h.store.omap_get(h.pg.coll,
                                               G("_pgmeta_")).items()
             if k in SCRUB_ROWS} for h in net.hosts]


@pytest.fixture
def net():
    n = H.Net("ceph_tpu_torch", PROFILE, 6)
    try:
        yield n
    finally:
        n.stop()


@pytest.mark.parametrize("what", ["scrub", "repair", "repair_objects",
                                  "local_scrub_map", "scrub_engine",
                                  "op_call"])
def test_scrub_repair_and_cls_complete_on_a_clean_pg(net, what):
    """Each entry point of the scrub and repair half, the scrub engine
    and a read-only ``OP_CALL`` completes on a clean PG, finds nothing,
    and changes nothing but the scrub stamps and cursor (only the
    engine's pass writes those)."""
    from ceph_tpu_torch.osd import types as t

    assert net.op("o", [t.OSDOp(t.OP_WRITEFULL, data=b"x" * 5000)],
                  reqid="client.1:1").result == 0
    net.settle()
    pg = net.primary.pg
    # the engine's pass persists the PG meta with its stamps: the info
    # beside them is the PG's in-memory info, unchanged (checked below)
    meta_info = what != "scrub_engine"
    before = _snapshot(net, meta_info)
    rows = _scrub_rows(net)
    staged = pg.stage_snapshot()
    calls = {
        "scrub": pg.scrub,
        "repair": pg.repair,
        "repair_objects": lambda: pg.repair_objects(["o"]),
        "local_scrub_map": lambda: pg.local_scrub_map()[1],
        "scrub_engine": lambda: pg.scrub_engine().run(deep=True),
        "op_call": lambda: net.op(
            "o", [t.OSDOp(t.OP_CALL, name="version.get")]).result,
    }
    got = calls[what]()
    assert not got  # {} / None / no unreadable object / result 0
    if what == "local_scrub_map":
        assert sorted(pg.local_scrub_map()[0]) == ["o"]
    net.settle()
    assert _snapshot(net, meta_info) == before
    assert pg.stage_snapshot() == staged
    assert not pg._oid_pipes and not pg._inflight_reqids
    assert pg.scrub_errors == 0
    after = _scrub_rows(net)
    if what == "scrub_engine":
        assert after[0] != rows[0] and pg.last_deep_scrub > 0
        assert after[1:] == rows[1:]
        from ceph_tpu_torch.core.encoding import Encoder
        from ceph_tpu_torch.store.objectstore import GHObject

        e = Encoder()
        pg.info.encode(e)
        assert net.primary.store.getattr(
            pg.coll, GHObject("_pgmeta_"), "info") == e.bytes()
    else:
        assert after == rows


def test_read_verify_fail_with_auto_repair_rebuilds_the_shard():
    """``osd_scrub_auto_repair`` on: a READ that meets a rotten data
    shard is served by reconstruction, counted in ``scrub_errors``, and
    the repair thread rebuilds the shard (its bytes and ``_av`` as
    before the rot, its mark cleared) and takes the count back to 0."""
    from ceph_tpu_torch.osd import types as t
    from ceph_tpu_torch.store.objectstore import GHObject

    payload = bytes(range(256)) * 40
    net = H.Net("ceph_tpu_torch", PROFILE, 6,
                conf={"osd_scrub_auto_repair": True})
    try:
        assert net.op("o", [t.OSDOp(t.OP_WRITEFULL, data=payload)],
                      reqid="client.1:1").result == 0
        net.settle()
        pg = net.primary.pg
        store = net.hosts[1].store
        g = GHObject("o", shard=1)
        good = store.read(pg.coll, g)
        store.debug_data_err_enabled = True
        store.debug_inject_data_err(pg.coll, g)
        pg._obc_invalidate()
        rep = net.op("o", [t.OSDOp(t.OP_READ)])
        assert rep.result == 0 and bytes(rep.ops[0].out_data) == payload
        deadline = time.monotonic() + 30
        while ((pg.scrub_errors or "o" in pg._read_repair_pending
                or any(th.name.endswith("-readrepair")
                       for th in threading.enumerate()))
               and time.monotonic() < deadline):
            time.sleep(0.01)
        net.settle()
        assert pg.scrub_errors == 0 and "o" not in pg._read_repair_pending
        assert store.read(pg.coll, g) == good  # the mark is cleared
        assert store.getattr(pg.coll, g, "_av") == pg._av_for("o")
        assert any("at-rest checksum failure" in msg
                   for msg in net.primary.ctx.log.dump_recent())
        assert not any("read-repair of o failed" in msg
                       for _, msg in net.primary.logged)
        assert pg.scrub_engine().run(deep=True) == {}
    finally:
        net.stop()


def test_op_call_pulls_a_staged_object_back_counted():
    """A cls method sees the object as host bytes: each ``OP_CALL`` on an
    object whose cached state is a staged ``DeviceBuf`` pulls it back,
    counted as one ``payload_host_touch`` (the reference's sanctioned
    pull-back, on the method's copy of the state), and the cache keeps
    the staged handle."""
    from ceph_tpu_torch.gpu.staging import DeviceBuf
    from ceph_tpu_torch.osd import types as t

    net = H.Net("ceph_tpu_torch", PROFILE, 6)
    try:
        payload = bytes(range(256)) * 200
        assert net.op("o", [t.OSDOp(t.OP_WRITEFULL, data=payload)],
                      reqid="client.1:1").result == 0
        net.settle()
        pg = net.primary.pg
        assert pg.stage_snapshot() == {"staged": 1, "degraded": 0}
        stats = pg.backend.queue.stats
        touches = stats.snapshot()["payload_host_touches"]
        for n in (1, 2):
            rep = net.op("o", [t.OSDOp(t.OP_CALL, name="version.get")])
            assert rep.result == 0 and bytes(rep.ops[0].out_data) == b"0"
            assert stats.snapshot()["payload_host_touches"] == touches + n
            assert isinstance(pg._obc.get("o").data, DeviceBuf)
        pg._obc_invalidate()
        assert bytes(net.op("o", [t.OSDOp(t.OP_READ)]).ops[0].out_data) \
            == payload
    finally:
        net.stop()


@pytest.mark.parametrize("pkg", ["ceph_tpu_torch", "ceph_tpu"])
def test_a_rep_op_dropped_by_a_newer_interval_commits_after_the_push(pkg):
    """F13: a replica that detected a new interval first drops the old
    interval's ``MOSDRepOp`` unapplied and unanswered, so the primary's
    write waits on its ack.  Once the new interval's laggard push
    brings the replica to the primary's head, the port's primary counts
    it as acked and the write commits (reply 0, its reqid answered from
    then on); the reference's keeps waiting (the client times out)."""
    net = H.Net(pkg, None, 3)
    M = net.mods
    try:
        lag = net.hosts[2].pg
        lag.interval_epoch = net.epoch + 1   # it saw the next interval
        box = net.op("o", [M.t.OSDOp(M.t.OP_WRITEFULL, data=b"x" * 4096)],
                     reqid="client.1:1", wait=False)
        net.settle()
        prim = net.primary.pg
        assert box == [] and lag.info.last_update < prim.info.last_update
        assert [sorted(op.waiting_on) for op in
                prim.backend.in_flight.values()] == [[2]]
        prim._push_laggards({1: net.hosts[1].pg.info, 2: lag.info})
        net.settle()
        assert lag.info.last_update == prim.info.last_update
        if pkg == "ceph_tpu_torch":
            assert [r.result for r in box] == [0]
            assert not prim.backend.in_flight
            again = net.op("o", [M.t.OSDOp(M.t.OP_WRITEFULL,
                                          data=b"x" * 4096)],
                           reqid="client.1:1")
            assert again.result == 0
            assert len(prim.log.entries) == 1  # answered from the log
        else:
            assert box == [] and len(prim.backend.in_flight) == 1
    finally:
        net.stop()


@pytest.mark.parametrize("pkg", ["ceph_tpu_torch", "ceph_tpu"])
def test_a_rep_op_whose_entry_was_rewound_is_never_answered_0(pkg):
    """F13's repair acks a write for a peer only while the write's own
    entry is in the primary's log.  Here the primary's entry at (e, v)
    is rewound and a newer authoritative log's entry takes (e + 1, v);
    both peers hold that one, so their heads pass (e, v), yet the
    write is not in the log: its client is not answered 0.  The port
    drops the op and its reqid mark (the resend runs again); the
    reference keeps waiting."""
    net = H.Net(pkg, None, 3)
    M = net.mods
    try:
        lag = net.hosts[2].pg
        lag.interval_epoch = net.epoch + 1   # it saw the next interval
        box = net.op("o", [M.t.OSDOp(M.t.OP_WRITEFULL, data=b"x" * 4096)],
                     reqid="client.1:1", wait=False)
        net.settle()
        prim = net.primary.pg
        mine = prim.log.entries[-1]
        assert box == [] and mine.reqid == "client.1:1"
        prim._rollback_to(mine.prior_version)
        theirs = M.t.LogEntry(op=M.t.LOG_MODIFY, oid="p",
                              version=M.t.EVersion(net.epoch + 1,
                                                   mine.version.version),
                              prior_version=mine.prior_version)
        prim.log.append(theirs)
        prim.info.last_update = theirs.version
        assert theirs.version > mine.version
        infos = {o: dataclasses.replace(net.hosts[o].pg.info,
                                        last_update=theirs.version)
                 for o in (1, 2)}
        prim._push_laggards(infos)
        net.settle()
        assert all(r.result != 0 for r in box)
        if pkg == "ceph_tpu_torch":
            assert box == [] and not prim.backend.in_flight
            assert "client.1:1" not in prim._inflight_reqids
        else:
            assert box == [] and len(prim.backend.in_flight) == 1
    finally:
        net.stop()


@pytest.mark.parametrize("pkg", ["ceph_tpu_torch", "ceph_tpu"])
def test_a_resend_of_a_write_in_flight_gets_the_originals_result(pkg):
    """F12: the objecter resends an op unanswered for 1 s.  A resend
    of a write still in flight on its primary neither runs again nor
    is answered EAGAIN (which made the client retry it at once, and
    ran 4 MiB writes out of their sends): the port parks it on the
    original and answers it with the original's result and version.
    The reference answers it EAGAIN."""
    net = H.Net(pkg, None, 3)
    M = net.mods
    ops = [M.t.OSDOp(M.t.OP_WRITEFULL, data=b"y" * 4096)]
    try:
        lag = net.hosts[2].pg
        lag.interval_epoch = net.epoch + 1   # the original waits on it
        box = net.op("o", ops, reqid="client.1:7", wait=False)
        net.settle()
        again = net.op("o", ops, reqid="client.1:7", wait=False)
        net.settle()
        prim = net.primary.pg
        assert box == [] and len(prim.log.entries) == 1
        if pkg == "ceph_tpu":
            assert [r.result for r in again] == [M.pg.EAGAIN]
            return
        assert again == []
        prim._push_laggards({1: net.hosts[1].pg.info, 2: lag.info})
        net.settle()
        assert [r.result for r in box] == [r.result for r in again] == [0]
        assert box[0].version == again[0].version \
            == prim.log.entries[-1].version
        assert len(prim.log.entries) == 1 and not prim._reqid_waiters
    finally:
        net.stop()
