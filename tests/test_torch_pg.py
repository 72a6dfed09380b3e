"""The port's PG (``ceph_tpu_torch/osd/pg.py``) on its own, on the CPU.

- The two PG cases of ``tests/test_dencoder.py`` (``:245,283``): an old
  primary's v1 ``MECSubReadVec`` and ``MECSubRead`` blobs decode and
  serve through ``handle_sub_read_vec`` and ``handle_sub_read`` of a
  port PG built as ``test_recovery_pipeline.py``'s ``_stub_pg`` builds
  it; each reply is also held to the reference PG's bytes.
- The no-card rule: a PG whose codec was built without a device raises
  when there is no card, and never runs on the CPU on its own.
- What waits for ROADMAP item 1h: ``scrub``, ``repair``,
  ``repair_objects``, ``local_scrub_map``, ``scrub_engine()`` and a
  message holding an ``OP_CALL`` raise ``NotImplementedError`` naming
  1h, and leave the PG's log, info and store as they were; with
  ``osd_scrub_auto_repair`` on, a read's checksum failure meets the
  refusal on its repair thread, logs it and stays counted.

Drive a port PG on the CPU like this: a ``device="cpu"`` codec and a
host (``torch_pg_harness.Net``, or the stub host of
``test_torch_recovery.py``).
"""

import binascii
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


def _snapshot(net):
    out = []
    for h in net.hosts:
        pg, st = h.pg, h.store
        objs = {}
        for o in st.collection_list(pg.coll):
            objs[(o.name, o.shard, o.snap)] = (
                bytes(st.read(pg.coll, o)), dict(st.getattrs(pg.coll, o)),
                dict(st.omap_get(pg.coll, o)))
        out.append((str(pg.info.last_update), str(pg.info.committed_to),
                    [(str(e.version), e.oid) for e in pg.log.entries],
                    objs, pg.state, dict(pg.missing)))
    return out


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
def test_what_waits_for_1h_raises_and_changes_nothing(net, what):
    from ceph_tpu_torch.osd import types as t

    assert net.op("o", [t.OSDOp(t.OP_WRITEFULL, data=b"x" * 5000)],
                  reqid="client.1:1").result == 0
    net.settle()
    pg = net.primary.pg
    before = _snapshot(net)
    staged = pg.stage_snapshot()
    calls = {
        "scrub": pg.scrub,
        "repair": pg.repair,
        "repair_objects": lambda: pg.repair_objects(["o"]),
        "local_scrub_map": pg.local_scrub_map,
        "scrub_engine": pg.scrub_engine,
        "op_call": lambda: net.op(
            "o", [t.OSDOp(t.OP_WRITE, off=0, data=b"y"),
                  t.OSDOp(t.OP_CALL, name="lock.lock", data=b"{}")],
            reqid="client.1:2"),
    }
    with pytest.raises(NotImplementedError, match="1h"):
        calls[what]()
    net.settle()
    assert _snapshot(net) == before
    assert pg.stage_snapshot() == staged
    assert not pg._oid_pipes and not pg._inflight_reqids


def test_read_verify_fail_with_auto_repair_meets_1h_and_stays_counted():
    """``osd_scrub_auto_repair`` on: the repair thread meets
    ``repair_objects``'s refusal in the reference's own ``except``,
    logs it, and the object stays counted in ``scrub_errors``; a second
    report of the same object is deduplicated."""
    net = H.Net("ceph_tpu_torch", PROFILE, 6,
                conf={"osd_scrub_auto_repair": True})
    try:
        pg = net.primary.pg
        pg._note_read_verify_fail("o", [(1, 1)])
        deadline = time.monotonic() + 10
        while "o" in pg._read_repair_pending and time.monotonic() < deadline:
            time.sleep(0.01)
        assert "o" not in pg._read_repair_pending
        assert pg.scrub_errors == 1
        assert any("read-repair of o failed" in msg and "1h" in msg
                   for _, msg in net.primary.logged)
        assert not any(th.name.endswith("-readrepair")
                       for th in threading.enumerate())
    finally:
        net.stop()
