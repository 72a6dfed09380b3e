"""The port's OSD daemon (``ceph_tpu_torch/osd/daemon.py``) held against
``ceph_tpu``'s, through one sequence on a six-daemon cluster of each.

``torch_daemon_harness.DaemonCluster`` runs each package's
``OSDService``s on the map of ``tests/test_osd_cluster.py``: every
client op enters ``ms_dispatch`` from a raw messenger,
rides the daemon's mclock workqueue into ``PG.do_op``, and every peer
message crosses a messenger.  The same numpy-seeded sequence goes
through both, on ``REP_POOL``, ``EC_POOL`` (isa k=2 m=1) and
``EC22_POOL`` (isa k=2 m=2), and again on ``CLAY_POOL`` (clay k=4 m=2):
writes, reads, a kill, degraded reads,
writes while the daemon is down, its revival on its old store, and the
settling that catches it up (the primary's recovery, ``pull_from_peer``
and the pushes).  After each step both clusters must agree on:

- every PG's up and acting sets, and every reply's bytes;
- every store: each object's bytes, xattrs and omap rows;
- every PG's log (each entry's encoded bytes), missing set and state;
- every daemon's ``pg_stats()`` rows, the scrub stamps left out;
- every daemon's ``dump_scrubs()`` rows, the stamps left out.

Both packages read ``time.time`` from one pinned clock (log entries'
``mtime`` carries it).

A second sequence drives each cluster through its own package's
``RadosClient`` (``torch_daemon_harness.LibClient``, reqids pinned to
``client.4200.0:<tid>``): puts to the three pools, a forged duplicate of
a committed ``APPEND`` (``test_osd_cluster.py:492``), a write in flight
to a primary that dies (``:467``; the primary swallows the op, so the
objecter's resend to the new primary is what executes it), degraded
gets, the revival and gets again, with the same agreement after each
step.  No object the dying daemon holds is rewritten while it is down.
"""

import importlib
import threading
import time

import numpy as np

import torch_daemon_harness as H

CLOCK = 1_700_000_000.25
POOLS = (H.REP_POOL, H.EC_POOL, H.EC22_POOL)
VICTIM = 2
SEED = 20


def _reply_bytes(rep) -> bytes:
    """A reply's bytes with the session's own fields zeroed (the
    messenger's sequence numbers, nonce and session id)."""
    rep.seq = rep.ack_seq = rep.nonce = rep.sid = 0
    return rep.to_bytes()


def _snapshot(c, replies) -> dict:
    c.quiesce()
    return {"acting": c.acting(), "replies": list(replies),
            "stores": c.dump_stores(), "logs": c.dump_logs(),
            "pg_stats": c.pg_stats(), "scrubs": c.dump_scrubs()}


def _every_pg(c, pool: int, prefix: str, write) -> None:
    """Write one new object, ``<prefix><i>``, into every PG of ``pool``
    (the first name of each PG in order)."""
    seen = set()
    for i in range(256):
        pgid = tuple(int(x) for x in c.primary_of(pool, f"{prefix}{i}")[0])
        if pgid not in seen:
            seen.add(pgid)
            write(pool, f"{prefix}{i}")


def _sequence(pkg: str, device: str = "cpu", pools=POOLS,
              rewrite: bool = True, store_factory=None) -> list:
    """The steps on ``pkg``'s cluster (the port's daemons on ``device``),
    writing to ``pools``: ``obj0`` is rewritten while the victim is
    down when ``rewrite``, else one new object lands in every PG while
    it is down and one more right after its revival; a snapshot after
    each.  With ``store_factory`` the daemons run on its stores and the
    victim revives on a new store mounted from its path."""
    rng = np.random.default_rng(SEED)
    c = H.DaemonCluster(pkg, device=device, store_factory=store_factory)
    snaps, replies, want = [], [], {}

    def blob() -> bytes:
        return rng.integers(0, 256, int(rng.integers(1000, 9000)),
                            dtype=np.uint8).tobytes()

    def write(pool, oid):
        data = blob()
        rep = c.put(pool, oid, data)
        assert rep.result == 0, (pkg, pool, oid, rep.result)
        want[(pool, oid)] = data
        replies.append(_reply_bytes(rep))

    def read_all():
        for (pool, oid), data in sorted(want.items()):
            rep = c.op(pool, oid, [c.M.t.OSDOp(c.M.t.OP_READ)])
            assert rep.result == 0 and bytes(rep.ops[0].out_data) == data, \
                (pkg, pool, oid, rep.result)
            replies.append(_reply_bytes(rep))

    try:
        for pool in pools:
            for i in range(4):
                write(pool, f"obj{i}")
        snaps.append(("write", _snapshot(c, replies)))
        c.kill(VICTIM)
        read_all()
        snaps.append(("degraded read", _snapshot(c, replies)))
        for pool in pools:
            if rewrite:
                write(pool, "obj0")
            write(pool, "fresh")
            if not rewrite:
                _every_pg(c, pool, "fresh", write)
        snaps.append(("write while down", _snapshot(c, replies)))
        c.revive(VICTIM, remount=store_factory is not None)
        if not rewrite:
            # one new object in every PG of the pools: the revived
            # member's commit watermark moves with the PG's next write
            for pool in pools:
                _every_pg(c, pool, "heal", write)
        snaps.append(("revive", _snapshot(c, replies)))
        read_all()
        snaps.append(("read after", _snapshot(c, replies)))
        return snaps
    finally:
        c.shutdown()


def test_daemon_clusters_of_both_packages_agree(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: CLOCK)
    ref = _sequence("ceph_tpu")
    port = _sequence("ceph_tpu_torch")
    assert [name for name, _ in port] == [name for name, _ in ref]
    for (name, p), (_, r) in zip(port, ref):
        for key in r:
            assert p[key] == r[key], (name, key)
    # the run did what it set out to: the victim held shards before the
    # kill, lagged while down and holds the late writes once revived
    last = dict(port)["read after"]
    held = [o for coll in last["stores"][VICTIM].values() for o in coll
            if o[0][0] == "fresh"]
    assert held, "the revived daemon holds none of the late writes"
    assert all(not miss for rows in last["logs"].values()
               for _ents, miss, _st in rows.values())


def test_daemon_clusters_on_blockstores_agree(monkeypatch, tmp_path):
    """The same steps with every daemon of each package on a BlockStore
    of its own package (``kv_kind="log"``, no ``O_SYNC``), the victim
    revived on a new BlockStore mounted from its directory."""
    monkeypatch.setattr(time, "time", lambda: CLOCK)
    runs = {}
    for pkg in ("ceph_tpu", "ceph_tpu_torch"):
        BS = importlib.import_module(pkg + ".store.blockstore").BlockStore
        base = tmp_path / pkg

        def factory(i, BS=BS, base=base):
            return BS(str(base / f"osd{i}"), o_sync=False, kv_kind="log")

        runs[pkg] = _sequence(pkg, store_factory=factory)
    ref, port = runs["ceph_tpu"], runs["ceph_tpu_torch"]
    assert [name for name, _ in port] == [name for name, _ in ref]
    for (name, p), (_, r) in zip(port, ref):
        for key in r:
            assert p[key] == r[key], (name, key)
    last = dict(port)["read after"]
    held = [o for coll in last["stores"][VICTIM].values() for o in coll
            if o[0][0] == "fresh"]
    assert held, "the revived daemon holds none of the late writes"


def test_clay_pool_of_both_packages_agrees(monkeypatch):
    """The same steps on ``CLAY_POOL`` (clay k=4 m=2 over all six
    daemons): writes, degraded reads with the victim's shard lost (the
    queue's cdec kind), new objects in every PG while it is down, and
    its revival: where it is the primary, its own missing shards are
    rebuilt from d helpers' repair layers (the sub-chunk plan, the
    queue's crep kind).  Every
    daemon holds a shard of every clay object, so nothing is rewritten
    while the victim is down, and each PG takes a write right after the
    revival: the revived member's ``committed_to`` otherwise stays
    behind until the PG's next write, in both packages (ROADMAP R6).
    Replies, stores, logs, missing sets
    and ``pg_stats`` agree after every step."""
    from ceph_tpu_torch.gpu.queue import StripeBatchQueue

    monkeypatch.setattr(time, "time", lambda: CLOCK)
    kinds = []
    real = StripeBatchQueue._array_batch

    def array_batch(self, batch):
        kinds.append(batch[0].kind)
        return real(self, batch)

    monkeypatch.setattr(StripeBatchQueue, "_array_batch", array_batch)
    ref = _sequence("ceph_tpu", pools=(H.CLAY_POOL,), rewrite=False)
    port = _sequence("ceph_tpu_torch", pools=(H.CLAY_POOL,), rewrite=False)
    assert [name for name, _ in port] == [name for name, _ in ref]
    for (name, p), (_, r) in zip(port, ref):
        for key in r:
            assert p[key] == r[key], (name, key)
    last = dict(port)["read after"]
    held = [o for coll in last["stores"][VICTIM].values() for o in coll
            if o[0][0] == "fresh"]
    assert held, "the revived daemon holds none of the late writes"
    assert {"encp", "cdec", "crep"} <= set(kinds), sorted(set(kinds))


LIB_CLIENT = 4200


def _swallow_ops(svc, oid: str) -> threading.Event:
    """Make ``svc`` drop every ``MOSDOp`` on ``oid`` unanswered, as a
    daemon that dies before acting on it; the event is set when one
    arrives."""
    seen = threading.Event()
    real = svc.ms_dispatch

    def dispatch(conn, msg):
        if type(msg).__name__ == "MOSDOp" and msg.oid == oid:
            seen.set()
            return True
        return real(conn, msg)

    svc.ms_dispatch = dispatch
    return seen


def _watch_replies(objecter) -> dict:
    """Record every ``MOSDOpReply`` the objecter is handed, by tid, the
    ones for ops already complete too."""
    got, cond = {}, threading.Condition()
    real = objecter.ms_dispatch

    def dispatch(conn, msg):
        if type(msg).__name__ == "MOSDOpReply":
            with cond:
                got.setdefault(msg.tid, []).append(msg.result)
                cond.notify_all()
        return real(conn, msg)

    objecter.ms_dispatch = dispatch
    return {"got": got, "cond": cond}


def _client_sequence(pkg: str, device: str = "cpu") -> list:
    """The objecter's steps on ``pkg``'s cluster; a snapshot after each."""
    rng = np.random.default_rng(SEED + 1)
    c = H.DaemonCluster(pkg, device=device)
    cl = H.LibClient(c, name=LIB_CLIENT, pinned=True)
    seen = _watch_replies(cl.rc.objecter)
    t = c.M.t
    snaps, replies, want = [], [], {}

    def blob() -> bytes:
        return rng.integers(0, 256, int(rng.integers(1000, 9000)),
                            dtype=np.uint8).tobytes()

    def done(rep, pool, oid):
        assert rep.result == 0, (pkg, pool, oid, rep.result)
        replies.append(_reply_bytes(rep))

    def get_all():
        for (pool, oid), data in sorted(want.items()):
            rep = cl.op(pool, oid, [t.OSDOp(t.OP_READ)])
            assert bytes(rep.ops[0].out_data) == data, (pkg, pool, oid)
            done(rep, pool, oid)

    try:
        for pool in POOLS:
            for i in range(4):
                want[(pool, f"cobj{i}")] = data = blob()
                done(cl.put(pool, f"cobj{i}", data), pool, f"cobj{i}")
        snaps.append(("put", _snapshot(c, replies)))

        done(cl.put(H.REP_POOL, "dedup", b"base-"), H.REP_POOL, "dedup")
        io = cl.rc.ioctx(H.REP_POOL)
        op = io.aio_operate("dedup", [t.OSDOp(t.OP_APPEND, data=b"tail")])
        done(op.result(15.0), H.REP_POOL, "dedup")
        pgid, _acting, primary = c.primary_of(H.REP_POOL, "dedup")
        dup = c.M.m.MOSDOp(pgid, c.osdmap.epoch, "dedup",
                           [t.OSDOp(t.OP_APPEND, data=b"tail")])
        dup.tid, dup.reqid = op.tid, op.reqid
        cl.rc.msgr.send_message(dup, c.osds[primary].addr)
        with seen["cond"]:  # the replayed answer of the duplicate
            assert seen["cond"].wait_for(
                lambda: len(seen["got"].get(op.tid, ())) == 2, H.WAIT_S)
        assert seen["got"][op.tid] == [0, 0]
        # replayed, not executed again: one log entry for its reqid
        log = c.osds[primary].pgs[pgid].log.entries
        assert sum(e.reqid == op.reqid for e in log) == 1
        want[(H.REP_POOL, "dedup")] = b"base-tail"
        snaps.append(("duplicate append", _snapshot(c, replies)))

        oid = "failover"
        victim = c.primary_of(H.REP_POOL, oid)[2]
        arrived = _swallow_ops(c.osds[victim], oid)
        want[(H.REP_POOL, oid)] = data = blob()
        op = io.aio_operate(oid, [t.OSDOp(t.OP_WRITEFULL, data=data)],
                            timeout=30.0)
        assert arrived.wait(H.WAIT_S)
        c.kill(victim)
        done(op.result(25.0), H.REP_POOL, oid)
        assert op.attempts >= 2  # sent to the dead primary, then resent
        pgid, _acting, primary = c.primary_of(H.REP_POOL, oid)
        assert primary != victim
        log = c.osds[primary].pgs[pgid].log.entries
        assert sum(e.reqid == op.reqid for e in log) == 1
        snaps.append(("failover", _snapshot(c, replies)))
        get_all()
        snaps.append(("degraded get", _snapshot(c, replies)))
        c.revive(victim)
        snaps.append(("revive", _snapshot(c, replies)))
        get_all()
        snaps.append(("get after", _snapshot(c, replies)))
        return snaps
    finally:
        cl.shutdown()
        c.shutdown()


def test_objecters_of_both_packages_agree(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: CLOCK)
    ref = _client_sequence("ceph_tpu")
    port = _client_sequence("ceph_tpu_torch")
    assert [name for name, _ in port] == [name for name, _ in ref]
    for (name, p), (_, r) in zip(port, ref):
        for key in r:
            assert p[key] == r[key], (name, key)
    # the pinned reqids reached the logs both packages agree on
    logs = dict(port)["get after"]["logs"]
    assert any(b"client.4200.0:" in ent for rows in logs.values()
               for ents, _miss, _st in rows.values() for ent in ents)
