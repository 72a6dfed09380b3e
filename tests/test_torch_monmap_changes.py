"""The port's MonmapMonitor (``ceph_tpu_torch/mon/services.py``), on
the CPU.

Mirrors ``tests/test_monmap_changes.py`` case for case (both), with port
``Monitor``s on ``device="cpu"``.  The reference's notes follow.

MonmapMonitor tests: mon roster growth/shrink through paxos
(reference src/mon/MonmapMonitor.cc).  Real sockets; the grown-in mon
catches up through the ordinary collect/CATCHUP path.
"""

import socket
import time

import pytest

from ceph_tpu_torch.core.context import Context
from ceph_tpu_torch.crush import map as cmap
from ceph_tpu_torch.mon.monitor import MonMap, Monitor
from ceph_tpu_torch.osd.osdmap import OSDMap


def free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def seed_map() -> OSDMap:
    cm, _root = cmap.build_flat_cluster(3, hosts=3)
    m = OSDMap(cm, max_osd=3, device="cpu")
    m.osd_state_up[:] = False
    return m


def wait_for(pred, timeout=20.0, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.2)
    raise AssertionError(f"timeout: {what}")


def _ctx(name):
    return Context(name, {"mon_tick_interval": 0.5})


def leader_of(mons):
    for m in mons:
        if m.state == "leader":
            return m
    return None


def test_mon_add_grows_quorum_and_replicates():
    p0, p1 = free_ports(2)
    monmap = MonMap([("127.0.0.1", p0)])
    mon0 = Monitor(_ctx("t.m0"), 0, monmap, initial_map=seed_map(),
                   bind_port=p0, device="cpu")
    mon0.start()
    mons = [mon0]
    try:
        wait_for(lambda: mon0.state == "leader", what="solo leader")
        # commit something pre-growth so the new mon must catch up
        code, _ = mon0._do_command({"prefix": "config set",
                                    "who": "global", "name": "k",
                                    "value": "v"})
        assert code == 0
        pre_commits = mon0.last_committed

        code, out = mon0._do_command({"prefix": "mon add",
                                      "addr": ["127.0.0.1", p1]})
        assert code == 0 and out["rank"] == 1
        wait_for(lambda: mon0.monmap.size == 2, what="roster growth")
        assert mon0.monmap.quorum() == 2

        # start the new mon with the grown map; it elects + catches up
        mon1 = Monitor(_ctx("t.m1"), 1,
                       MonMap.from_dict(mon0.monmap.to_dict()),
                       initial_map=seed_map(), bind_port=p1, device="cpu")
        mon1.start()
        mons.append(mon1)
        wait_for(lambda: leader_of(mons) is not None
                 and {m.state for m in mons} == {"leader", "peon"},
                 what="2-mon quorum")
        wait_for(lambda: mon1.last_committed >= pre_commits,
                 what="new mon catch-up")
        assert mon1.monmap.size == 2
        # the pre-growth service state replicated to the new mon
        assert mon1.services["config"].db.get("global", {}).get("k") == "v"

        # post-growth commits need BOTH mons (quorum 2) and reach both
        ld = leader_of(mons)
        code, _ = ld._do_command({"prefix": "config set", "who": "global",
                                  "name": "k2", "value": "v2"})
        assert code == 0
        wait_for(lambda: all(
            m.services["config"].db.get("global", {}).get("k2") == "v2"
            for m in mons), what="2-mon replication")
    finally:
        for m in mons:
            m.shutdown()


def test_mon_rm_leaves_hole_and_keeps_quorum():
    ports = free_ports(3)
    monmap = MonMap([("127.0.0.1", p) for p in ports])
    ctx = _ctx("t.rm")
    mons = [Monitor(ctx, r, MonMap.from_dict(monmap.to_dict()),
                    initial_map=seed_map(), bind_port=ports[r], device="cpu")
            for r in range(3)]
    for m in mons:
        m.start()
    try:
        wait_for(lambda: leader_of(mons) is not None, what="leader")
        ld = leader_of(mons)
        victim = next(r for r in (2, 1, 0) if r != ld.rank)
        code, _ = ld._do_command({"prefix": "mon rm", "rank": victim})
        assert code == 0
        survivors = [m for m in mons if m.rank != victim]
        wait_for(lambda: all(m.monmap.addrs[victim] is None
                             for m in survivors), what="hole applied")
        assert all(m.monmap.quorum() == 2 for m in survivors)
        mons[victim].shutdown()
        # the surviving pair still commits (quorum 2 of 2 live)
        code, _ = ld._do_command({"prefix": "config set", "who": "global",
                                  "name": "after", "value": "rm"})
        assert code == 0
        wait_for(lambda: all(
            m.services["config"].db.get("global", {}).get("after") == "rm"
            for m in survivors), what="post-rm replication")
        # removing the stale rank again is refused cleanly
        code, _ = ld._do_command({"prefix": "mon rm", "rank": victim})
        assert code == -2
        code, out = ld._do_command({"prefix": "mon dump"})
        assert code == 0 and out["monmap"]["addrs"][victim] is None
    finally:
        for m in mons:
            m.shutdown()
