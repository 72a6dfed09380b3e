"""The port's client library and daemons as one cluster on the CPU:
``tests/test_osd_cluster.py`` mirrored case for case.

``torch_daemon_harness.DaemonCluster("ceph_tpu_torch")`` is the port's
``MiniCluster`` (six ``OSDService``s over MemStores on one shared map,
``device="cpu"``), and ``torch_daemon_harness.LibClient`` its
``LibClient``: the port's ``RadosClient`` and ``Objecter`` place each op
by the port's CRUSH walk, send it to the acting primary and resend it on
a map change, on ``EAGAIN``/``ESTALE`` and on the resend timer.  The map
is the reference's (``test_osd_cluster.py:35-56``): a replicated pool
of size 3, isa k=2 m=1, isa k=2 m=2 and clay k=4 m=2, 8 PGs each.  Each case makes the reference case's
assertions on the port's objects; one more holds the two packages' maps
to the same encoded bytes.  One more is the port's own (F12): the
objecter's wait before a timer resend doubles with each send.
"""

import threading
import time

import pytest

import torch_daemon_harness as H
from ceph_tpu_torch.osd import messages as m
from ceph_tpu_torch.osd import types as t_
from ceph_tpu_torch.osd.backend import _hinfo
from ceph_tpu_torch.store.objectstore import Collection, GHObject, Transaction

N_OSDS = H.N_OSDS
REP_POOL, EC_POOL, EC22_POOL = H.REP_POOL, H.EC_POOL, H.EC22_POOL


def MiniCluster():
    return H.DaemonCluster("ceph_tpu_torch", device="cpu")


LibClient = H.LibClient


@pytest.fixture(scope="module")
def cluster():
    c = MiniCluster()
    yield c
    c.shutdown()


@pytest.fixture(scope="module")
def client(cluster):
    cl = LibClient(cluster)
    yield cl
    cl.shutdown()


def test_cluster_map_encodes_as_the_reference_map():
    """``build_map`` in both packages: one map, byte for byte."""
    import importlib

    maps = []
    for pkg in ("ceph_tpu", "ceph_tpu_torch"):
        M = H.mods(pkg)
        codec = importlib.import_module(f"{pkg}.osd.map_codec")
        dev = {"device": "cpu"} if pkg == "ceph_tpu_torch" else {}
        maps.append(codec.encode_osdmap(H.build_map(M, dev)))
    assert maps[0] == maps[1]
    assert len(maps[0]) > 100


def test_replicated_write_read(cluster, client):
    data = b"replicated-payload" * 100
    rep = client.put(REP_POOL, "robj1", data)
    assert rep.result == 0
    assert client.get(REP_POOL, "robj1") == data
    # the object exists on every acting osd
    pgid, acting, _ = cluster.primary_of(REP_POOL, "robj1")
    coll = Collection(t_.pgid_str(pgid) + "_head")
    for osd_id in acting:
        assert cluster.osds[osd_id].store.exists(coll, GHObject("robj1"))


def test_replicated_xattr_omap_ops(cluster, client):
    client.put(REP_POOL, "robj2", b"x")
    rep = client.op(REP_POOL, "robj2", [
        t_.OSDOp(t_.OP_SETXATTR, name="user.k", data=b"v"),
        t_.OSDOp(t_.OP_OMAP_SET, kv={"a": b"1", "b": b"2"}),
    ])
    assert rep.result == 0
    rep = client.op(REP_POOL, "robj2", [
        t_.OSDOp(t_.OP_GETXATTR, name="user.k"),
        t_.OSDOp(t_.OP_OMAP_GET),
    ])
    assert rep.result == 0
    assert rep.ops[0].out_data == b"v"
    assert rep.ops[1].out_kv == {"a": b"1", "b": b"2"}


def test_ec_write_spreads_shards(cluster, client):
    data = bytes(range(256)) * 64
    rep = client.put(EC_POOL, "eobj1", data)
    assert rep.result == 0
    assert client.get(EC_POOL, "eobj1") == data
    pgid, acting, _ = cluster.primary_of(EC_POOL, "eobj1")
    coll = Collection(t_.pgid_str(pgid) + "_head")
    live = [o for o in acting if 0 <= o < N_OSDS]
    assert len(live) == 3  # k+m
    for shard, osd_id in enumerate(acting):
        if not (0 <= osd_id < N_OSDS):
            continue
        g = GHObject("eobj1", shard=shard)
        assert cluster.osds[osd_id].store.exists(coll, g)
        # each shard holds a chunk, not the object
        assert cluster.osds[osd_id].store.stat(coll, g) < len(data)


def test_ec_degraded_read_reconstructs(cluster, client):
    data = b"degraded-read-me" * 512
    client.put(EC_POOL, "eobj2", data)
    pgid, acting, primary = cluster.primary_of(EC_POOL, "eobj2")
    victim = next(o for o in acting if o != primary and 0 <= o < N_OSDS)
    cluster.kill(victim)
    try:
        # placement changed: re-resolve the primary, read degraded
        got = client.get(EC_POOL, "eobj2")
        assert got == data
    finally:
        cluster.revive(victim)


def test_ec_recovery_after_revive(cluster, client):
    data1 = b"before-kill" * 300
    client.put(EC_POOL, "eobj3", data1)
    pgid, acting, primary = cluster.primary_of(EC_POOL, "eobj3")
    victim = next(o for o in acting if o != primary and 0 <= o < N_OSDS)
    cluster.kill(victim)
    data2 = b"while-down!" * 300
    client.put(EC_POOL, "eobj3", data2)  # degraded write
    cluster.revive(victim)
    time.sleep(0.5)
    assert client.get(EC_POOL, "eobj3") == data2


def test_replicated_recovery_after_revive(cluster, client):
    client.put(REP_POOL, "robj3", b"v1")
    pgid, acting, primary = cluster.primary_of(REP_POOL, "robj3")
    victim = next(o for o in acting if o != primary)
    cluster.kill(victim)
    client.put(REP_POOL, "robj3", b"v2-written-degraded")
    cluster.revive(victim)
    time.sleep(0.5)
    # the revived replica caught up via log-based recovery
    pgid2, acting2, _ = cluster.primary_of(REP_POOL, "robj3")
    coll = Collection(t_.pgid_str(pgid2) + "_head")
    if victim in acting2:
        deadline = time.time() + 10
        while time.time() < deadline:
            try:
                if (cluster.osds[victim].store.read(coll, GHObject("robj3"))
                        == b"v2-written-degraded"):
                    break
            except Exception:
                pass
            time.sleep(0.2)
        assert (cluster.osds[victim].store.read(coll, GHObject("robj3"))
                == b"v2-written-degraded")
    assert client.get(REP_POOL, "robj3") == b"v2-written-degraded"


def test_scrub_clean_and_detects_corruption(cluster, client):
    client.put(EC_POOL, "eobj4", b"scrub-me" * 1000)
    pgid, acting, primary = cluster.primary_of(EC_POOL, "eobj4")
    pg = cluster.osds[primary].pgs[pgid]
    assert pg.scrub().get("eobj4") is None  # clean
    # corrupt one shard's bytes behind the store's back
    coll = Collection(t_.pgid_str(pgid) + "_head")
    victim_shard = next(s for s, o in enumerate(acting)
                        if o != primary and 0 <= o < N_OSDS)
    victim = acting[victim_shard]
    t = Transaction()
    t.write(coll, GHObject("eobj4", shard=victim_shard), 0, b"\xff" * 8)
    cluster.osds[victim].store.queue_transaction(t)
    errors = pg.scrub()
    assert "eobj4" in errors
    assert any("crc" in e or "parity" in e for e in errors["eobj4"])


def test_repair_ec_rewrites_corrupt_shard(cluster, client):
    """``test_osd_cluster.py:256``: a byte-flipped EC shard is rebuilt by
    decode and rewritten in place; the next scrub is clean and the
    holder's store has the right bytes again."""
    payload = b"repair-me" * 1000
    client.put(EC_POOL, "eobj_rep", payload)
    pgid, acting, primary = cluster.primary_of(EC_POOL, "eobj_rep")
    pg = cluster.osds[primary].pgs[pgid]
    assert pg.scrub().get("eobj_rep") is None

    coll = Collection(t_.pgid_str(pgid) + "_head")
    victim_shard = next(s for s, o in enumerate(acting)
                        if o != primary and 0 <= o < N_OSDS)
    victim = acting[victim_shard]
    g = GHObject("eobj_rep", shard=victim_shard)
    good = cluster.osds[victim].store.read(coll, g)
    t = Transaction()
    t.write(coll, g, 0, b"\xff" * 8)
    cluster.osds[victim].store.queue_transaction(t)
    assert "eobj_rep" in pg.scrub()

    post = pg.repair()
    assert post.get("eobj_rep") is None, post
    assert cluster.osds[victim].store.read(coll, g) == good
    assert client.get(EC_POOL, "eobj_rep") == payload


def test_repair_ec_crc_valid_corruption_consensus(cluster, client):
    """``test_osd_cluster.py:287``: a shard corrupted with a forged
    matching hinfo passes the crc gate; repair's leave-one-out consensus
    still finds it and rewrites only it."""
    payload = b"consensus" * 1000
    client.put(EC22_POOL, "epoison", payload)
    pgid, acting, primary = cluster.primary_of(EC22_POOL, "epoison")
    pg = cluster.osds[primary].pgs[pgid]
    assert pg.scrub().get("epoison") is None

    coll = Collection(t_.pgid_str(pgid) + "_head")
    victim_shard = 0  # a DATA shard, inside the canonical decode set
    victim = acting[victim_shard]
    g = GHObject("epoison", shard=victim_shard)
    store = cluster.osds[victim].store
    good = store.read(coll, g)
    evil = bytes(b ^ 0x5A for b in good)
    t = Transaction()
    t.write(coll, g, 0, evil)
    t.setattrs(coll, g, {"hinfo": _hinfo(evil, len(payload))})
    store.queue_transaction(t)

    assert "epoison" in pg.scrub()
    post = pg.repair()
    assert post.get("epoison") is None, post
    assert store.read(coll, g) == good
    # the healthy shards were left alone and the object reads clean
    assert client.get(EC22_POOL, "epoison") == payload


def test_repair_ec_m1_parity_ambiguity_refuses(cluster, client):
    """``test_osd_cluster.py:324``: with m=1 a crc-valid corruption is
    ambiguous, and repair refuses to guess."""
    payload = b"ambiguous" * 900
    client.put(EC_POOL, "eambig", payload)
    pgid, acting, primary = cluster.primary_of(EC_POOL, "eambig")
    pg = cluster.osds[primary].pgs[pgid]
    coll = Collection(t_.pgid_str(pgid) + "_head")
    victim = acting[0]
    g = GHObject("eambig", shard=0)
    store = cluster.osds[victim].store
    good = store.read(coll, g)
    evil = bytes(b ^ 0x5A for b in good)
    t = Transaction()
    t.write(coll, g, 0, evil)
    t.setattrs(coll, g, {"hinfo": _hinfo(evil, len(payload))})
    store.queue_transaction(t)

    assert "eambig" in pg.scrub()
    post = pg.repair()
    assert "eambig" in post  # still inconsistent: refused, not guessed
    # no healthy shard was clobbered
    for s in (1, 2):
        holder = acting[s]
        chunk = cluster.osds[holder].pgs[pgid].backend.read_local_chunk(
            "eambig", s)
        assert chunk is not None
    # restore so later tests see a clean pool
    t = Transaction()
    t.write(coll, g, 0, good)
    t.setattrs(coll, g, {"hinfo": _hinfo(good, len(payload))})
    store.queue_transaction(t)
    assert pg.scrub().get("eambig") is None


def test_repair_replicated_majority_wins(cluster, client):
    """``test_osd_cluster.py:363``: a divergent replica is overwritten
    from the majority; a divergent primary heals itself from a peer."""
    payload = b"authoritative" * 500
    client.put(REP_POOL, "robj_rep", payload)
    pgid, acting, primary = cluster.primary_of(REP_POOL, "robj_rep")
    pg = cluster.osds[primary].pgs[pgid]
    coll = Collection(t_.pgid_str(pgid) + "_head")
    g = GHObject("robj_rep")

    replica = next(o for o in acting if o != primary and 0 <= o < N_OSDS)
    t = Transaction()
    t.write(coll, g, 0, b"ROT")
    cluster.osds[replica].store.queue_transaction(t)
    assert "robj_rep" in pg.scrub()
    assert pg.repair().get("robj_rep") is None
    assert cluster.osds[replica].store.read(coll, g) == payload

    # now corrupt the PRIMARY's copy: majority = the two replicas
    t = Transaction()
    t.write(coll, g, 0, b"BADPRIMARY")
    cluster.osds[primary].store.queue_transaction(t)
    assert "robj_rep" in pg.scrub()
    assert pg.repair().get("robj_rep") is None
    assert cluster.osds[primary].store.read(coll, g) == payload
    assert client.get(REP_POOL, "robj_rep") == payload


def test_delete_propagates(cluster, client):
    client.put(REP_POOL, "robj4", b"bye")
    assert client.delete(REP_POOL, "robj4").result == 0
    rep = client.op(REP_POOL, "robj4", [t_.OSDOp(t_.OP_READ)])
    assert rep.result == -2  # ENOENT


def test_backfill_removes_deleted_objects(cluster, client):
    """``test_osd_cluster.py:403``: an object deleted while a replica was
    down and beyond the log window is removed by backfill, not
    resurrected."""
    client.put(REP_POOL, "robj5", b"doomed" * 100)
    pgid, acting, primary = cluster.primary_of(REP_POOL, "robj5")
    victim = next(o for o in acting if o != primary and 0 <= o < N_OSDS)
    coll = Collection(t_.pgid_str(pgid) + "_head")
    assert cluster.osds[victim].store.exists(coll, GHObject("robj5"))

    cluster.kill(victim)
    assert client.delete(REP_POOL, "robj5").result == 0
    # trim the primary's pg log so the victim falls beyond the tail
    # (forces the backfill path instead of log-based catch-up)
    pgid2, _, primary2 = cluster.primary_of(REP_POOL, "robj5")
    cluster.osds[primary2].pgs[pgid2].log.trim_to(0)

    cluster.revive(victim)
    deadline = time.time() + 10
    store = cluster.osds[victim].store
    while time.time() < deadline:
        if not store.exists(coll, GHObject("robj5")):
            break
        time.sleep(0.2)
    assert not store.exists(coll, GHObject("robj5")), (
        "deleted object resurrected by backfill"
    )


def test_client_resends_to_new_primary_on_failover(cluster, client):
    """``test_osd_cluster.py:467``: the acting primary dies with a write
    in flight; the objecter retargets and resends to the new acting
    set."""
    data = b"failover-write" * 200
    client.put(REP_POOL, "fobj1", data)  # warm: pg active, target known
    pgid, acting, primary = cluster.primary_of(REP_POOL, "fobj1")

    ioctx = client.rc.ioctx(REP_POOL)
    op = ioctx.aio_operate(
        "fobj1", [t_.OSDOp(t_.OP_WRITEFULL, data=b"v2" * 500)],
        timeout=30.0)
    # the primary dies; kill() refreshes the map, which notifies the
    # objecter and triggers the retarget/resend scan
    cluster.kill(primary)
    try:
        rep = op.result(timeout=25.0)
        assert rep.result == 0, f"failover write failed: {rep.result}"
        _, _, new_primary = cluster.primary_of(REP_POOL, "fobj1")
        assert new_primary != primary
        assert client.get(REP_POOL, "fobj1") == b"v2" * 500
    finally:
        cluster.revive(primary)


def test_resend_is_exactly_once(cluster, client):
    """``test_osd_cluster.py:492``: a duplicate send of a committed write
    replays from the pg log (reqid dedup) instead of re-executing --
    APPEND would double without it."""
    client.put(REP_POOL, "dedup1", b"base-")
    ioctx = client.rc.ioctx(REP_POOL)
    op = ioctx.aio_operate(
        "dedup1", [t_.OSDOp(t_.OP_APPEND, data=b"tail")], timeout=15.0)
    rep = op.result(timeout=15.0)
    assert rep.result == 0
    # forge a byte-identical resend (same reqid/tid) straight into the
    # messenger, as if the reply had been lost and the ticker re-fired
    pgid, _, primary = cluster.primary_of(REP_POOL, "dedup1")
    msg = m.MOSDOp(pgid, cluster.osdmap.epoch, "dedup1",
                   [t_.OSDOp(t_.OP_APPEND, data=b"tail")])
    msg.tid = op.tid
    msg.reqid = op.reqid
    client.rc.msgr.send_message(msg, cluster.osds[primary].addr)
    time.sleep(1.0)
    assert client.get(REP_POOL, "dedup1") == b"base-tail", (
        "resend re-executed a committed op"
    )


def test_object_context_cache_serves_and_invalidates(cluster, client):
    """``test_osd_cluster.py:516``: the PG's object context cache
    (``PG._obc``, the port's too) serves repeated reads, follows writes,
    drops a deleted object and empties on an interval change."""
    io = client.rc.ioctx(REP_POOL)
    io.write_full("obc1", b"v1")
    pgid = cluster.osdmap.object_to_pg(REP_POOL, "obc1")
    _up, _upp, acting, primary = cluster.osdmap.pg_to_up_acting(pgid)
    pg = cluster.osds[primary].pgs[pgid]
    assert io.read("obc1") == b"v1"
    assert "obc1" in pg._obc  # cached after the write/read
    io.write_full("obc1", b"v2-longer")
    assert io.read("obc1") == b"v2-longer"  # read-your-writes
    io.remove("obc1")
    assert "obc1" not in pg._obc  # delete drops the context
    # interval change clears the cache wholesale
    io.write_full("obc2", b"x")
    io.read("obc2")
    gen_before = pg._obc.generation()
    pg.update_acting(pg.acting, pg.primary)
    assert len(pg._obc) == 0
    assert pg._obc.generation() > gen_before  # stale fills now refused


def test_scheduled_scrub_detects_corruption():
    """``test_osd_cluster.py:541``: the background scrub scheduler runs
    on its own and reports injected bitrot to the cluster log, on a
    cluster of its own."""
    c = MiniCluster()
    cl = LibClient(c)
    try:
        io = cl.rc.ioctx(REP_POOL)
        io.write_full("scrubme", b"pristine" * 100)
        pgid = c.osdmap.object_to_pg(REP_POOL, "scrubme")
        _u, _up, acting, primary = c.osdmap.pg_to_up_acting(pgid)
        # corrupt a replica copy behind the cluster's back
        replica = next(o for o in acting if o != primary)
        svc = c.osds[replica]
        pg_r = svc.pgs[pgid]
        t = Transaction()
        t.write(pg_r.coll, GHObject("scrubme"), 0, b"CORRUPTED")
        svc.store.queue_transaction(t)

        hits = []
        ev = threading.Event()
        psvc = c.osds[primary]
        psvc.ctx.log.cluster_cb = lambda lvl, msg: (
            hits.append((lvl, msg)), ev.set())
        psvc.start_scrub_scheduler(interval=0.2)
        psvc.start_scrub_scheduler(interval=0.2)  # idempotent
        assert ev.wait(timeout=15.0), "scrub scheduler never reported"
        lvl, msg = hits[0]
        assert lvl == "ERR" and "scrubme" in msg and str(pgid[1]) in msg
    finally:
        cl.shutdown()
        c.shutdown()


def test_homeless_op_sends_once_address_appears(cluster, client):
    """``test_osd_cluster.py:579``: an op submitted while its primary's
    address is unknown parks homeless, and goes out once the address is
    back, though its (pg, primary) target never changed."""
    ob = client.rc.objecter
    oid = "homeless_obj"
    pool = REP_POOL
    _pgid, primary = ob._calc_target(pool, oid)
    # simulate the addrbook lag: drop only the primary's address
    saved = dict(ob.addrbook)
    with ob._lock:
        ob.addrbook = {k: v for k, v in saved.items() if k != primary}
    op = ob.op_submit(pool, oid,
                      [t_.OSDOp(t_.OP_WRITEFULL, data=b"homeless")],
                      timeout=15.0)
    assert op.last_send == 0.0  # parked, never sent
    # address comes back; target (pg, primary) is UNCHANGED
    ob.handle_osdmap(cluster.osdmap, saved)
    rep = op.result(10.0)
    assert rep.result == 0
    assert client.get(pool, oid) == b"homeless"


def test_timer_resends_back_off(cluster):
    """F12 (ROADMAP queue 3): an op with no reply is sent again after
    ``resend_interval``, then after twice that, four times, up to
    ``RESEND_BACKOFF_MAX`` times; a constant 1 s resend sent every op
    that outlived it again each second (4 MiB frames, degraded reads run
    again), which slowed the ops behind it.  The gaps are checked from
    below only: a loaded host can only stretch them."""
    from ceph_tpu_torch.client.objecter import Objecter
    from ceph_tpu_torch.core.context import Context

    class Msgr:
        entity, nonce = "client.4999", 7

        def __init__(self) -> None:
            self.sent: list = []

        def add_dispatcher(self, d) -> None:
            pass

        def send_message(self, msg, addr) -> None:
            self.sent.append(time.monotonic())

    msgr = Msgr()
    ob = Objecter(Context("client.4999", {}), msgr, resend_interval=0.1)
    try:
        ob.handle_osdmap(cluster.osdmap,
                         {o: ("127.0.0.1", 1) for o in range(N_OSDS)})
        ob.op_submit(REP_POOL, "quiet", [t_.OSDOp(t_.OP_READ)],
                     timeout=60.0)
        deadline = time.monotonic() + 30.0
        while len(msgr.sent) < 7 and time.monotonic() < deadline:
            time.sleep(0.05)
        sent = list(msgr.sent)
        assert len(sent) >= 7, sent
        gaps = [b - a for a, b in zip(sent, sent[1:])]
        for i, gap in enumerate(gaps[:6]):
            assert gap >= 0.1 * min(1 << i, Objecter.RESEND_BACKOFF_MAX), \
                (i, gaps)
    finally:
        ob.shutdown()
