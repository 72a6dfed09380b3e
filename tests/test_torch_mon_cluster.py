"""The port's monitor quorum with port OSDs over real sockets, on the CPU.

Mirrors ``tests/test_mon_cluster.py`` case for case (all six): three
port ``Monitor``s (``ceph_tpu_torch/mon/monitor.py``) elect a leader
whose Paxos commits the osdmap epochs, five port ``OSDService``s boot
through them, pools are created by command, a port ``RadosClient``
places its ops by the subscribed map, and heartbeat failure reports mark
a dead OSD down.  Every mon, daemon and client runs with
``device="cpu"`` (each kernel's plain version).  Where the reference
sleeps a fixed second for PG activation, the mirror waits, with a
deadline, until every up daemon's PGs have settled.
"""

import socket
import time

import pytest

from ceph_tpu_torch.core.context import Context
from ceph_tpu_torch.crush import map as cmap
from ceph_tpu_torch.ec import codec_from_profile
from ceph_tpu_torch.mon import MonClient, MonMap, Monitor
from ceph_tpu_torch.msg.message import EntityName
from ceph_tpu_torch.msg.messenger import Messenger
from ceph_tpu_torch.osd import types as t_
from ceph_tpu_torch.osd.daemon import OSDService
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.store.memstore import MemStore

N_MONS = 3
N_OSDS = 5
DEV = "cpu"
SETTLE_S = 30.0


def free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def seed_map() -> OSDMap:
    cm, root = cmap.build_flat_cluster(N_OSDS, hosts=N_OSDS)
    osdmap = OSDMap(cm, max_osd=N_OSDS, device=DEV)
    osdmap.osd_state_up[:] = False  # everyone boots through the mon
    return osdmap


class Tier3Cluster:
    def __init__(self) -> None:
        self.ctx = Context("mon.cluster", {
            "osd_heartbeat_interval": 0.5,
            "osd_heartbeat_grace": 2.0,
            "mon_tick_interval": 0.5,
        })
        ports = free_ports(N_MONS)
        self.monmap = MonMap([("127.0.0.1", p) for p in ports])
        self.mons = []
        self.osds = {}
        try:
            for rank in range(N_MONS):
                mon = Monitor(self.ctx, rank, self.monmap,
                              initial_map=seed_map(), bind_port=ports[rank],
                              device=DEV)
                mon.start()
                self.mons.append(mon)
            for i in range(N_OSDS):
                svc = OSDService(self.ctx, i, MemStore(), None,
                                 codec_from_profile, device=DEV)
                svc.store.mkfs()
                svc.init()
                svc.boot(self.monmap)
                svc.start_heartbeats()
                self.osds[i] = svc
        except BaseException:
            self.shutdown()
            raise

    def leader(self) -> Monitor:
        for mon in self.mons:
            if mon.state == "leader":
                return mon
        raise AssertionError("no leader")

    def wait_for(self, pred, timeout=20.0, msg="condition"):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if pred():
                return
            time.sleep(0.2)
        raise AssertionError(f"timeout waiting for {msg}")

    def settle(self) -> None:
        """Every up daemon's PGs active or settled (the reference's fixed
        one-second sleep, as a wait with a deadline)."""
        for o in self.osds.values():
            if o.up:
                assert o.wait_pgs_settled(SETTLE_S), \
                    f"osd.{o.whoami}'s PGs settled"

    def shutdown(self) -> None:
        for o in self.osds.values():
            if o.up:
                o.shutdown()
        for mon in self.mons:
            mon.shutdown()


class Objecter:
    """The port's client library (``RadosClient``: placement, map-change
    retarget and EAGAIN/ESTALE retries), with the thin pool_id/op surface
    these tests use."""

    def __init__(self, ctx, monmap) -> None:
        from ceph_tpu_torch.client import RadosClient

        self.rc = RadosClient(ctx, device=DEV)
        self.rc.connect(monmap)
        self.monc = self.rc.monc

    @property
    def osdmap(self):
        return self.rc.objecter.osdmap

    @property
    def msgr(self):
        return self.rc.msgr

    def pool_id(self, name: str) -> int:
        for pid, p in self.osdmap.pools.items():
            if p.name == name:
                return pid
        raise KeyError(name)

    def op(self, pool: int, oid: str, ops, timeout=15.0):
        return self.rc.ioctx(pool).operate(oid, ops, timeout=timeout)

    def shutdown(self) -> None:
        self.rc.shutdown()


@pytest.fixture(scope="module")
def cluster():
    c = Tier3Cluster()
    yield c
    c.shutdown()


@pytest.fixture(scope="module")
def objecter(cluster):
    o = Objecter(cluster.ctx, cluster.monmap)
    yield o
    o.shutdown()


def test_election_and_quorum(cluster):
    # a late-starting lower rank takes over from any interim winner, so
    # wait for convergence: exactly one leader and it is rank 0
    cluster.wait_for(
        lambda: [mo.rank for mo in cluster.mons
                 if mo.state == "leader"] == [0],
        msg="rank 0 is the single leader")


def test_osds_boot_through_mon(cluster):
    monc = MonClient(
        Messenger(cluster.ctx, EntityName("client", 8)), cluster.monmap,
        device=DEV)
    monc.msgr.start()
    try:
        def all_up():
            code, out = monc.command({"prefix": "osd dump"})
            return code == 0 and sum(
                1 for o in out["osds"] if o["up"]) == N_OSDS

        cluster.wait_for(all_up, msg="all osds up")
    finally:
        monc.msgr.shutdown()


def test_paxos_replicates_to_all_mons(cluster):
    cluster.wait_for(
        lambda: all(mo.last_committed >= 1 for mo in cluster.mons),
        msg="all mons committed")
    versions = {mo.last_committed for mo in cluster.mons}
    # peons track the leader within one commit
    assert max(versions) - min(versions) <= 1


def test_pool_create_and_io(cluster, objecter):
    monc = objecter.monc
    code, _ = monc.command({
        "prefix": "osd erasure-code-profile set", "name": "k2m1",
        "profile": "plugin=isa k=2 m=1 technique=reed_sol_van"})
    assert code == 0
    code, out = monc.command({"prefix": "osd pool create", "pool": "rbd",
                              "pg_num": 8})
    assert code == 0, out
    code, out = monc.command({
        "prefix": "osd pool create", "pool": "ecpool", "pg_num": 8,
        "pool_type": "erasure", "erasure_code_profile": "k2m1"})
    assert code == 0, out

    def pools_visible():
        return (objecter.osdmap is not None
                and any(p.name == "ecpool"
                        for p in objecter.osdmap.pools.values())
                and all(any(p.name == "ecpool"
                            for p in o.osdmap.pools.values())
                        for o in cluster.osds.values() if o.up
                        and o.osdmap is not None))

    cluster.wait_for(pools_visible, msg="pools in maps everywhere")
    cluster.settle()

    data = b"tier3-payload" * 200
    rep = objecter.op(objecter.pool_id("rbd"), "obj1",
                      [t_.OSDOp(t_.OP_WRITEFULL, data=data)])
    assert rep.result == 0
    rep = objecter.op(objecter.pool_id("rbd"), "obj1",
                      [t_.OSDOp(t_.OP_READ)])
    assert rep.result == 0 and rep.ops[0].out_data == data

    rep = objecter.op(objecter.pool_id("ecpool"), "eobj",
                      [t_.OSDOp(t_.OP_WRITEFULL, data=data)])
    assert rep.result == 0
    rep = objecter.op(objecter.pool_id("ecpool"), "eobj",
                      [t_.OSDOp(t_.OP_READ)])
    assert rep.result == 0 and rep.ops[0].out_data == data
    # the EC pool's codec runs where the daemons do
    pg = next(pg for o in cluster.osds.values()
              for pgid, pg in o.pgs.items()
              if pgid[0] == objecter.pool_id("ecpool"))
    assert pg.backend.codec.device.type == DEV


def test_failure_detection_marks_down(cluster, objecter):
    # pick a non-primary osd for the test object so IO keeps working
    pool = objecter.pool_id("ecpool")
    pgid = objecter.osdmap.object_to_pg(pool, "eobj")
    _, _, acting, primary = objecter.osdmap.pg_to_up_acting(pgid)
    victim = next(o for o in range(N_OSDS)
                  if o != primary and 0 <= o < N_OSDS)
    cluster.osds[victim].shutdown()

    def marked_down():
        leader = cluster.leader()
        return (leader.osdmap is not None
                and not leader.osdmap.is_up(victim))

    cluster.wait_for(marked_down, timeout=30,
                     msg=f"osd.{victim} marked down by failure reports")

    # the new epoch reaches the client and IO continues (degraded ok)
    cluster.wait_for(
        lambda: objecter.osdmap is not None
        and not objecter.osdmap.is_up(victim),
        msg="client sees the down osd")
    cluster.settle()
    data2 = b"post-failure" * 100
    rep = objecter.op(pool, "eobj2",
                      [t_.OSDOp(t_.OP_WRITEFULL, data=data2)])
    assert rep.result == 0
    rep = objecter.op(pool, "eobj2", [t_.OSDOp(t_.OP_READ)])
    assert rep.result == 0 and rep.ops[0].out_data == data2


def test_status_reflects_cluster(cluster, objecter):
    code, out = objecter.monc.command({"prefix": "status"})
    assert code == 0
    assert out["num_osds"] == N_OSDS
    assert out["num_up_osds"] == N_OSDS - 1  # one killed above
    assert "ecpool" in out["pools"]
