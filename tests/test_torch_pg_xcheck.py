"""The port's PG (``ceph_tpu_torch/osd/pg.py``) held against
``ceph_tpu``'s, bit for bit.

Each package's PGs run in the loopback harness of ``torch_pg_harness``:
one primary and its peers, each a PG of that package over its own
``ECBackend`` (or ``ReplicatedBackend``) and ``MemStore``, every message
through its bytes.  The same numpy-seeded ``MOSDOp`` sequence goes
through ``do_op`` on both: ``WRITEFULL``, a ranged ``WRITE`` (the
partial RMW), ``SETXATTR`` and ``OMAP_SET``, ``READ``/``STAT``/
``GETXATTRS``/``OMAP_GET``, a write and ``DELETE`` of a second object, a
resend of a committed reqid (exactly-once replay), a snapshot write and
``SNAPTRIM``, a watch and a notify over a fake connection, and a
degraded read with one peer down (the object-context cache emptied
first, so it gathers).  Then peering: a laggard peer is written past
while it is down, and ``activate()`` pushes it forward
(``_push_laggards`` -> ``handle_push``); for an EC pool, a higher peer
takes the primary role, writes with its sub-writes lost, and the next
``activate()`` rolls that divergent entry back on it
(``_resolve_divergent`` -> ``MPGRollback`` -> ``handle_rollback``, with
its ``ROLLBACK_EVENTS`` row).  Last, for an EC pool, the primary loses
its shards of two objects and ``recovery_engine().recover`` rebuilds
them.

What is compared, exactly: every ``MOSDOpReply``'s bytes, every message
each host received (type and bytes) from each source, in that
session's order, every store's
objects with their bytes, attributes and omap, each PG's encoded
``info`` and its log rows, the watcher's notify bytes, the rollback
rows, and the hosts' logged lines.  Both packages read ``time.time``
from one pinned clock (log entries' ``mtime`` and the rollback rows
carry it); nothing is left out of the comparison.

Profiles: isa k=2 m=1 (the cluster's ``EC_POOL``), isa k=8 m=4,
jerasure k=4 m=2 cauchy_good and a replicated pool of size 3.  On the
jerasure pool the reference's ranged write would take the partial path
that ROADMAP R5 records as wrong for bit-matrix codes; the port's codec
refuses it (``supports_partial_writes`` False), so the reference's
codec is told the same here and both take the full rewrite.  shec and
lrc pools wait on the reference's faults R2 and R4.
"""

import importlib
import time

import numpy as np
import pytest

import torch_pg_harness as H

PROFILES = {
    "isa_2_1": ("plugin=isa k=2 m=1 technique=reed_sol_van", 3),
    "isa_8_4": ("plugin=isa k=8 m=4 technique=reed_sol_van", 12),
    "jerasure_4_2": ("plugin=jerasure k=4 m=2 technique=cauchy_good", 6),
    "replicated_3": (None, 3),
}
CLOCK = 1_700_000_000.25


def _dump_store(host) -> list:
    st, coll = host.store, host.pg.coll
    out = []
    for o in sorted(st.collection_list(coll),
                    key=lambda g: (g.name, g.shard, g.snap)):
        out.append(((o.name, o.shard, o.snap), bytes(st.read(coll, o)),
                    dict(st.getattrs(coll, o)), dict(st.omap_get(coll, o))))
    return out


def _pg_state(net) -> list:
    enc = importlib.import_module(f"{net.mods.pkg}.core.encoding")
    out = []
    for h in net.hosts:
        pg = h.pg
        e = enc.Encoder()
        pg.info.encode(e)
        out.append((e.bytes(), pg.log.omap_additions(pg.log.entries),
                    dict(pg.missing), sorted(pg.stale_peers), pg.state))
    return out


def _by_source(received) -> dict:
    """A host's received messages, in order within each source (one
    session each, as the messenger orders them; replies from different
    peers race)."""
    out: dict = {}
    for src, name, blob in received:
        out.setdefault(src, []).append((name, blob))
    return out


def _until(cond, timeout: float = H.WAIT_S) -> bool:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def _sequence(pkg: str, profile, n_osds: int, seed: int,
              device: str = "cpu", then=None) -> dict:
    """The op sequence, the peering and (EC) a recovery window on one
    package's PGs, then ``then(net)`` when given (its result under
    ``"then"``); returns everything the comparison reads."""
    net = H.Net(pkg, profile, n_osds, device=device)
    M = net.mods
    t = M.t
    OSDOp = t.OSDOp
    if pkg == "ceph_tpu" and profile and "jerasure" in profile:
        # ROADMAP R5: the port's bit-matrix codec refuses partial writes
        net.primary.pg.backend.codec.supports_partial_writes = (
            lambda: False)
    rng = np.random.default_rng(seed)
    rb0 = len(M.pg.ROLLBACK_EVENTS)
    replies = []

    def op(oid, ops, **kw):
        rep = net.op(oid, ops, **kw)
        net.settle()
        replies.append(rep.blob)
        return rep

    def blob(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    try:
        a1 = blob(int(rng.integers(5000, 9000)))
        op("obj_a", [OSDOp(t.OP_WRITEFULL, data=a1)], reqid="client.1:1")
        patch = blob(300)
        op("obj_a", [OSDOp(t.OP_WRITE, off=100, data=patch)],
           reqid="client.1:2")
        op("obj_a", [OSDOp(t.OP_SETXATTR, name="user.k", data=blob(17)),
                     OSDOp(t.OP_OMAP_SET, kv={"k1": blob(9),
                                              "k2": blob(5)})],
           reqid="client.1:3")
        r = op("obj_a", [OSDOp(t.OP_READ), OSDOp(t.OP_STAT),
                         OSDOp(t.OP_GETXATTRS), OSDOp(t.OP_OMAP_GET)])
        want = bytearray(a1)
        want[100:400] = patch
        assert r.result == 0 and bytes(r.ops[0].out_data) == bytes(want)
        op("obj_b", [OSDOp(t.OP_WRITEFULL, data=blob(3000))],
           reqid="client.1:4")
        op("obj_b", [OSDOp(t.OP_DELETE)], reqid="client.1:5")
        assert op("obj_b", [OSDOp(t.OP_READ)]).result == -2
        # exactly-once: the resend of the first write replays its version
        r = op("obj_a", [OSDOp(t.OP_WRITEFULL, data=a1)],
               reqid="client.1:1")
        assert r.result == 0 and r.version.version == 1
        # a snapshot write, then the trim of that snap
        op("obj_a", [OSDOp(t.OP_WRITEFULL, data=blob(4000))],
           reqid="client.1:6", snap_seq=3, snaps=[3])
        op("obj_a", [OSDOp(t.OP_SNAPTRIM, off=3)], reqid="client.1:7")
        # watch, then notify: the watcher acks the one MWatchNotify
        conn = H.ClientConn()
        assert op("obj_a", [OSDOp(t.OP_WATCH, name="watch", off=42)],
                  conn=conn).result == 0
        box = net.op("obj_a", [OSDOp(t.OP_NOTIFY, data=b"ping",
                                     length=5000)], wait=False)
        assert len(conn.got) == 1
        net.notify_ack(0, conn.got[0], b"pong")
        assert _until(lambda: bool(box)), "notify never answered"
        replies.append(box[0].blob)
        # a degraded read: the last osd down, the context cache emptied
        last = n_osds - 1
        net.set_down(last)
        net.primary.pg._obc_invalidate()
        r = op("obj_a", [OSDOp(t.OP_READ), OSDOp(t.OP_GETXATTRS)])
        assert r.result == 0
        net.set_down(last, False)

        # peering 1: the last osd misses two writes, then is pushed
        # forward by activate()
        none = M.backend.CRUSH_ITEM_NONE
        deg = [none if o == last else o for o in net.acting]
        net.set_down(last)
        net.set_acting(deg, 0, hosts=net.hosts[:-1])
        net.primary.pg.state = M.pg.STATE_DEGRADED
        op("obj_c", [OSDOp(t.OP_WRITEFULL, data=blob(2500))],
           reqid="client.1:8")
        op("obj_a", [OSDOp(t.OP_WRITEFULL, data=blob(6100))],
           reqid="client.1:9")
        net.set_down(last, False)
        net.set_acting(net.acting, 0)
        net.primary.pg.activate()
        net.settle()
        assert net.primary.pg.state == M.pg.STATE_ACTIVE
        assert not net.primary.pg.stale_peers

        if profile is not None:
            # peering 2: osd.H (below the last) is primary for a write
            # whose sub-writes are all lost; the next activate() on
            # osd.0 rolls that divergent entry back on osd.H
            hi = last - 1
            net.set_acting(net.acting, hi)
            hp = net.hosts[hi].pg
            hp.state = M.pg.STATE_ACTIVE
            net.drop = lambda src, dst, msg: (
                src == hi and type(msg).__name__.startswith("MECSubWrite"))
            head = hp.log.head
            net.op("obj_a", [OSDOp(t.OP_WRITEFULL, data=blob(3300))],
                   reqid="client.1:10", to=hi, wait=False)
            assert _until(lambda: hp.log.head > head), \
                "the lone write never logged"
            # its fan-out runs after the encode: wait until every peer's
            # sub-write was lost
            assert _until(lambda: sum(
                d[0] == hi and d[2].startswith("MECSubWrite")
                for d in net.dropped) >= n_osds - 1), net.dropped
            net.settle()
            net.drop = None
            net.set_acting(net.acting, 0)
            net.primary.pg.activate()
            net.settle()
            assert hp.log.head == head, "divergent entry not rolled back"

            # the recovery engine: the primary loses its shards of two
            # objects in one transaction and the window rebuilds them
            pg0, st0 = net.primary.pg, net.primary.store
            G = M.os.GHObject
            lost = ("obj_a", "obj_c")
            mine = pg0.backend.local_shards(net.acting)
            t_ = M.os.Transaction()
            for oid in lost:
                for sh in mine:
                    t_.remove(pg0.coll, G(oid, shard=sh))
            st0.queue_transaction(t_)
            with pg0.lock:
                for oid in lost:
                    pg0.missing[oid] = pg0.log.latest_for(oid).version
                work = {oid: pg0.log.latest_for(oid) for oid in lost}
            pg0.recovery_engine().recover(work)
            net.settle()
            assert not pg0.missing and not pg0.unfound
            assert all(st0.exists(pg0.coll, G(oid, shard=sh))
                       for oid in lost for sh in mine)
        extra = then(net) if then is not None else None
        return {"replies": replies, "then": extra,
                "received": [_by_source(h.received) for h in net.hosts],
                "stores": [_dump_store(h) for h in net.hosts],
                "pgs": _pg_state(net), "notify": conn.got,
                "rollback": list(M.pg.ROLLBACK_EVENTS)[rb0:],
                "logged": [h.logged for h in net.hosts],
                "dropped": net.dropped}
    finally:
        net.stop()


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_pg_of_both_packages_answer_send_and_store_alike(name, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: CLOCK)
    profile, n_osds = PROFILES[name]
    ref = _sequence("ceph_tpu", profile, n_osds, seed=18)
    port = _sequence("ceph_tpu_torch", profile, n_osds, seed=18)
    for key in ref:
        assert port[key] == ref[key], key
    # the run did what it set out to: replies, peer traffic, a push, and
    # (EC) one rollback row naming the divergent holder
    assert len(port["replies"]) == 15
    assert any(n == "MPGPush" for rx in port["received"]
               for msgs in rx.values() for n, _ in msgs)
    if profile is not None:
        assert len(port["rollback"]) == 1
        assert port["rollback"][0]["osd"] == n_osds - 2
