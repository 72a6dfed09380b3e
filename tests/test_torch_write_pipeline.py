"""``tests/test_write_pipeline.py`` mirrored on the port's
``VStartCluster`` (``ceph_tpu_torch/vstart.py``, ``device="cpu"``), case
for case: same-object appends land once each and in issue order on a
replicated and an EC pool (``:79``), and with every FileStore's commit
thread frozen a second write fans out while the first is uncommitted
(``:125``) and a same-object successor reads its predecessor's projected
state (``:176``).  Every wait polls with a deadline.
"""

import time

import pytest

from ceph_tpu_torch.client.rados import OSDOp
from ceph_tpu_torch.osd import types as t_
from ceph_tpu_torch.vstart import VStartCluster as _VStartCluster

TOKENS = [f"<{i:02d}>".encode() for i in range(12)]


def VStartCluster(*args, **kw):
    """The port's cluster on the CPU."""
    return _VStartCluster(*args, device="cpu", **kw)


def _pg_perf(c):
    """Summed osd.N.pg counters (+ max of the in-flight gauge)."""
    msgs = ops = jobs = 0
    hw = 0
    for svc in c.osds.values():
        d = svc.pg_perf.dump()
        msgs += d.get("subwrite_msgs", 0)
        ops += d.get("subwrite_ops", 0)
        jobs += d.get("encode_batch_jobs", 0)
        hw = max(hw, d.get("writes_inflight", 0))
    return {"msgs": msgs, "ops": ops, "jobs": jobs, "hw": hw}


def _append_burst_lands_in_order(io, oid):
    """Each token lands exactly once, and in issue order when no append
    was resent (a fresh object up to three times to get such a burst)."""
    for attempt in range(3):
        o = f"{oid}_{attempt}"
        pend = [io.aio_operate(o, [OSDOp(t_.OP_APPEND, data=tok)])
                for tok in TOKENS]
        for p in pend:
            rep = p.result(30.0)
            assert rep.result == 0, f"append failed rc={rep.result}"
        got = io.read(o)
        for tok in TOKENS:
            assert got.count(tok) == 1, (
                f"token {tok!r} appears {got.count(tok)}x (lost = two "
                f"writes shared a base; doubled = resend re-executed): "
                f"{got!r}")
        if all(p.attempts == 1 for p in pend):
            assert got == b"".join(TOKENS), (
                f"append burst reordered with no client resends: "
                f"{got!r}")
            return


def _settle(c):
    for svc in c.osds.values():
        assert svc.wait_pgs_settled(15.0)


def test_same_oid_appends_strictly_ordered():
    with VStartCluster(n_mons=1, n_osds=3) as c:
        rep_pool = c.create_pool("wp_rep", size=3)
        ec_pool = c.create_pool("wp_ec", size=3, pool_type="erasure",
                                ec_profile="k=2 m=1")
        _settle(c)
        cl = c.client()
        _append_burst_lands_in_order(cl.ioctx(rep_pool), "ordered_rep")
        _append_burst_lands_in_order(cl.ioctx(ec_pool), "ordered_ec")
        ioec = cl.ioctx(ec_pool)
        pend = [ioec.aio_operate(f"multi_{i}",
                                 [OSDOp(t_.OP_WRITEFULL,
                                        data=b"m" * 2048)])
                for i in range(16)]
        for p in pend:
            assert p.result(30.0).result == 0
        assert ioec.read("multi_7") == b"m" * 2048


@pytest.fixture
def frozen_cluster(tmp_path):
    """Three FileStore OSDs whose commit threads the test freezes:
    inside the window transactions apply but no commit callback, so no
    client ack, fires."""
    with VStartCluster(n_mons=1, n_osds=3, data_dir=str(tmp_path),
                       store_kind="filestore",
                       conf={"objectstore_wal_sync": True}) as c:
        yield c


def _wait(pred, timeout=10.0, what=""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def test_distinct_oids_overlap_in_flight(frozen_cluster):
    c = frozen_cluster
    pool = c.create_pool("ovl", size=3, pool_type="erasure",
                         ec_profile="k=2 m=1")
    io = c.client().ioctx(pool)
    try:
        rep = io.operate("warm", [OSDOp(t_.OP_WRITEFULL,
                                        data=b"w" * 512)], timeout=60.0)
    except TimeoutError:
        rep = io.operate("warm", [OSDOp(t_.OP_WRITEFULL,
                                        data=b"w" * 512)], timeout=60.0)
    assert rep.result == 0
    base = _pg_perf(c)
    for osd in c.osds.values():
        osd.store._pipeline.freeze()
    try:
        pa = io.aio_operate("ovl_a", [OSDOp(t_.OP_WRITEFULL,
                                            data=b"a" * 4096)])
        _wait(lambda: _pg_perf(c)["ops"] - base["ops"] >= 1,
              what="write A fan-out")
        assert not pa.event.is_set(), "A acked inside the freeze window"
        pb = io.aio_operate("ovl_b", [OSDOp(t_.OP_WRITEFULL,
                                            data=b"b" * 4096)])
        _wait(lambda: _pg_perf(c)["ops"] - base["ops"] >= 2,
              what="write B fan-out while A uncommitted")
        assert not pa.event.is_set() and not pb.event.is_set(), (
            "a client ack leaked out of the frozen commit window")
    finally:
        for osd in c.osds.values():
            osd.store._pipeline.thaw()
    assert pa.result(30.0).result == 0
    assert pb.result(30.0).result == 0
    assert io.read("ovl_a") == b"a" * 4096
    assert io.read("ovl_b") == b"b" * 4096
    after = _pg_perf(c)
    d_ops = after["ops"] - base["ops"]
    d_msgs = after["msgs"] - base["msgs"]
    # k=2 m=1 over 3 daemons: at most one message a live peer an op
    assert d_ops >= 2
    assert d_msgs <= 2 * d_ops, (d_msgs, d_ops)


def test_same_oid_pipelines_and_reads_projected_state(frozen_cluster):
    c = frozen_cluster
    pool = c.create_pool("proj", size=3, pool_type="erasure",
                         ec_profile="k=2 m=1")
    io = c.client().ioctx(pool)
    assert io.operate("warm2", [OSDOp(t_.OP_WRITEFULL,
                                      data=b"w" * 512)]).result == 0
    for osd in c.osds.values():
        osd.store._pipeline.freeze()
    try:
        p1 = io.aio_operate("proj_o", [OSDOp(t_.OP_WRITEFULL,
                                             data=b"v1" * 256)])
        p2 = io.aio_operate("proj_o", [OSDOp(t_.OP_APPEND,
                                             data=b"-tail")])
        _wait(lambda: _pg_perf(c)["hw"] >= 2,
              what="two same-oid writes in flight together")
        assert not p1.event.is_set() and not p2.event.is_set()
    finally:
        for osd in c.osds.values():
            osd.store._pipeline.thaw()
    assert p1.result(30.0).result == 0
    assert p2.result(30.0).result == 0
    assert io.read("proj_o") == b"v1" * 256 + b"-tail"
