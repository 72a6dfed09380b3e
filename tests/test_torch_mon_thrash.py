"""The port's monitors thrashed under live IO, on the CPU.

Mirrors ``tests/test_mon_thrash.py`` case for case (both), over the
port's quorum of ``tests/test_torch_mon_cluster.py`` (every mon, daemon
and client on ``device="cpu"``); a restarted mon is a new port
``Monitor`` over the old one's KV.  Where the reference sleeps a fixed
second for PG activation, the mirror waits, with a deadline, until every
up daemon's PGs have settled.  The reference's notes follow.

Mon thrashing under live IO — the qa/tasks/mon_thrash.py analog:
kill monitors (including the leader) while a client keeps writing,
assert the quorum re-forms, paxos state survives restarts, and every
write either completes or retries to completion (no lost acks, no
wedged cluster)."""

import pytest

from ceph_tpu_torch.mon.monitor import Monitor
from ceph_tpu_torch.osd import types as t_

from tests.test_torch_mon_cluster import DEV, Objecter, Tier3Cluster


def _mkpool(cluster, ob, name: str) -> int:
    code, out = ob.monc.command({"prefix": "osd pool create",
                                 "pool": name, "pg_num": 8})
    assert code == 0, out

    def visible():
        try:
            return ob.pool_id(name) is not None
        except KeyError:
            return False

    cluster.wait_for(visible, msg=f"pool {name} visible")
    cluster.settle()  # PG activation
    return ob.pool_id(name)


def _write(ob, pool, oid, data):
    rep = ob.op(pool, oid, [t_.OSDOp(t_.OP_WRITEFULL, data=data)],
                timeout=20.0)
    assert rep.result == 0, f"write {oid}: {rep.result}"


def _read(ob, pool, oid):
    rep = ob.op(pool, oid, [t_.OSDOp(t_.OP_READ)], timeout=20.0)
    assert rep.result == 0, f"read {oid}: {rep.result}"
    return rep.ops[0].out_data


@pytest.fixture()
def cluster():
    c = Tier3Cluster()
    c.wait_for(lambda: any(m.state == "leader" for m in c.mons),
               msg="initial quorum")
    yield c
    c.shutdown()


def _leader_rank(cluster):
    """Wait out any in-flight election and return the leader's rank.

    A bare next(... if m.state == "leader") races the re-election a
    just-restarted mon's probe can trigger after quorum was already
    observed once (StopIteration under full-suite load)."""
    found = []

    def _poll():
        found[:] = [m.rank for m in cluster.mons if m.state == "leader"]
        return bool(found)

    cluster.wait_for(_poll, msg="leader elected")
    return found[0]


def _restart_mon(cluster, rank):
    """Kill + re-create one mon rank over the SAME kv store (the
    durable restart path: paxos promises and committed state must
    survive)."""
    old = cluster.mons[rank]
    kv = old.kv
    old.shutdown()
    port = cluster.monmap.addrs[rank][1]
    mon = Monitor(cluster.ctx, rank, cluster.monmap, kv=kv,
                  initial_map=None, bind_port=port, device=DEV)
    mon.start()
    cluster.mons[rank] = mon
    return mon


def test_mon_thrash_under_io(cluster):
    ob = Objecter(cluster.ctx, cluster.monmap)
    try:
        pool = _mkpool(cluster, ob, "thrash")
        write = 0
        for round_no in range(3):
            # thrash: bounce a PEON, then the LEADER
            leader_rank = _leader_rank(cluster)
            peon_rank = next(m.rank for m in cluster.mons
                             if m.rank != leader_rank)
            for victim in (peon_rank, leader_rank):
                _restart_mon(cluster, victim)
                cluster.wait_for(
                    lambda: any(m.state == "leader"
                                for m in cluster.mons),
                    msg=f"quorum after bouncing mon.{victim}")
                # IO keeps flowing through the churn (the client
                # retries retargetable errors internally)
                for _ in range(5):
                    oid = f"obj{write}"
                    _write(ob, pool, oid, f"payload-{write}".encode())
                    write += 1
        # everything written is readable afterwards
        for i in range(write):
            assert _read(ob, pool, f"obj{i}") == f"payload-{i}".encode()
        # paxos state is consistent across the (restarted) quorum
        cluster.wait_for(
            lambda: len({m.last_committed for m in cluster.mons
                         if m.state in ("leader", "peon")}) == 1,
            msg="committed versions converge")
    finally:
        ob.shutdown()


def test_mon_restart_replays_committed_state(cluster):
    """A full-quorum cold restart over the same stores reloads maps
    and pools (MonitorDBStore durability)."""
    ob = Objecter(cluster.ctx, cluster.monmap)
    try:
        pool = _mkpool(cluster, ob, "durable")
        _write(ob, pool, "keep", b"survives")
        epoch_before = cluster.leader().osdmap.epoch
        for rank in range(len(cluster.mons)):
            _restart_mon(cluster, rank)
        def restored():
            try:
                lead = cluster.leader()
            except AssertionError:
                return False
            # a restarted peon can win the election with an older map
            # and catch up from peers' stores in the collect phase:
            # converged means the LEADER reached the pre-restart epoch
            return (lead.osdmap is not None
                    and lead.osdmap.epoch >= epoch_before)

        cluster.wait_for(restored, msg="osdmap restored after restart")
        lead = cluster.leader()
        names = {p.name for p in lead.osdmap.pools.values()}
        assert "durable" in names
        # data written before the restart still reads (OSDs kept runn.)
        assert _read(ob, pool, "keep") == b"survives"
    finally:
        ob.shutdown()
