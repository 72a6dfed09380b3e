"""The port's OSD daemon (``ceph_tpu_torch/osd/daemon.py``) held against
``ceph_tpu``'s, through one sequence on a six-daemon cluster of each.

``torch_daemon_harness.DaemonCluster`` runs each package's
``OSDService``s on the map of ``tests/test_osd_cluster.py`` (without the
clay pool): every client op enters ``ms_dispatch`` from a raw messenger,
rides the daemon's mclock workqueue into ``PG.do_op``, and every peer
message crosses a messenger.  The same numpy-seeded sequence goes
through both, on ``REP_POOL``, ``EC_POOL`` (isa k=2 m=1) and
``EC22_POOL`` (isa k=2 m=2): writes, reads, a kill, degraded reads,
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
"""

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


def _sequence(pkg: str, device: str = "cpu") -> list:
    """The steps on ``pkg``'s cluster (the port's daemons on ``device``);
    a snapshot after each."""
    rng = np.random.default_rng(SEED)
    c = H.DaemonCluster(pkg, device=device)
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
        for pool in POOLS:
            for i in range(4):
                write(pool, f"obj{i}")
        snaps.append(("write", _snapshot(c, replies)))
        c.kill(VICTIM)
        read_all()
        snaps.append(("degraded read", _snapshot(c, replies)))
        for pool in POOLS:
            write(pool, "obj0")
            write(pool, "fresh")
        snaps.append(("write while down", _snapshot(c, replies)))
        c.revive(VICTIM)
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
