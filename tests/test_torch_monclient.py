"""The port's ``MonClient`` and ``MonMap`` (``ceph_tpu_torch/mon/``)
against the reference's monitors and the port's.

The port's client is held first to the reference's monitor: a quorum
of three ``ceph_tpu.mon.monitor.Monitor``s built as
``tests/test_mon_cluster.py:40-75`` builds it.  Five port
``OSDService``s (``device="cpu"``) boot through it over the wire
(``boot`` -> ``MonClient.subscribe_osdmap`` and ``send_boot``), as
``test_mon_cluster.py:151`` has the reference's do: every port OSD is
marked up in the mon's map, and the port daemons adopt, decoded by the
port's map codec and incrementals, the map a pool create commits, and
create their PGs from it.  The commands go through the port's
``MonClient``.  ``MonMap``'s dict form and roster edits equal the
reference's.

The same two cases then run through a quorum of three port ``Monitor``s
(``ceph_tpu_torch/mon/monitor.py``, ``device="cpu"``): the port's
daemons boot through the port's mons, and adopt the maps those commit.
"""

import socket
import time

import pytest

from ceph_tpu.core.context import Context as RefContext
from ceph_tpu.crush import map as ref_cmap
from ceph_tpu.mon import MonMap as RefMonMap
from ceph_tpu.mon import Monitor
from ceph_tpu.osd.osdmap import OSDMap as RefOSDMap
from ceph_tpu_torch.core.context import Context
from ceph_tpu_torch.ec import codec_from_profile
from ceph_tpu_torch.crush import map as port_cmap
from ceph_tpu_torch.mon import MonClient, MonMap
from ceph_tpu_torch.mon import Monitor as PortMonitor
from ceph_tpu_torch.msg.message import EntityName
from ceph_tpu_torch.msg.messenger import Messenger
from ceph_tpu_torch.osd.daemon import OSDService
from ceph_tpu_torch.osd.osdmap import OSDMap as PortOSDMap
from ceph_tpu_torch.store.memstore import MemStore

N_MONS = 3
N_OSDS = 5
PG_NUM = 8  # the reference's pools (test_mon_cluster.py)


def free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def seed_map():
    cm, root = ref_cmap.build_flat_cluster(N_OSDS, hosts=N_OSDS)
    osdmap = RefOSDMap(cm, max_osd=N_OSDS)
    osdmap.osd_state_up[:] = False  # everyone boots through the mon
    return osdmap


def port_seed_map():
    cm, root = port_cmap.build_flat_cluster(N_OSDS, hosts=N_OSDS)
    osdmap = PortOSDMap(cm, max_osd=N_OSDS, device="cpu")
    osdmap.osd_state_up[:] = False
    return osdmap


def wait_for(pred, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.2)
    raise AssertionError(f"timeout waiting for {msg}")


def _cluster(make_mon):
    # the reference's tier-3 conf; the grace is the default 20 s, since
    # the port's CRUSH walk on the CPU is its plain version (about 20 ms
    # a PG, much more while five daemons walk at once)
    conf = {"osd_heartbeat_interval": 0.5, "mon_tick_interval": 0.5}
    ports = free_ports(N_MONS)
    addrs = [("127.0.0.1", p) for p in ports]
    mons, osds = [], {}
    ctx = Context("osd.cluster", dict(conf))
    monc = None
    try:
        for rank in range(N_MONS):
            mon = make_mon(conf, rank, addrs, ports[rank])
            mon.start()
            mons.append(mon)
        monmap = MonMap(addrs)
        for i in range(N_OSDS):
            svc = OSDService(ctx, i, MemStore(), None, codec_from_profile,
                             device="cpu")
            svc.store.mkfs()
            svc.init()
            svc.boot(monmap)
            svc.start_heartbeats()
            osds[i] = svc
        monc = MonClient(Messenger(ctx, EntityName("client", 8)), monmap,
                         device="cpu")
        monc.msgr.start()
        yield mons, osds, monc
    finally:
        if monc is not None:
            monc.close()
            monc.msgr.shutdown()
        for o in osds.values():
            if o.up:
                o.shutdown()
        for o in osds.values():
            # a map the daemon was adopting when it went down finishes
            # under its map lock: wait for it, so no walk outlives the
            # test (a down daemon takes no new map: ms_dispatch refuses)
            lock = getattr(o, "_map_lock", None)
            if lock is not None:
                with lock:
                    pass
        for mon in mons:
            mon.shutdown()


def _ref_mon(conf, rank, addrs, port):
    return Monitor(RefContext("mon.cluster", conf), rank, RefMonMap(addrs),
                   initial_map=seed_map(), bind_port=port)


def _port_mon(conf, rank, addrs, port):
    return PortMonitor(Context("mon.cluster", dict(conf)), rank,
                       MonMap(addrs), initial_map=port_seed_map(),
                       bind_port=port, device="cpu")


@pytest.fixture(scope="module")
def cluster():
    yield from _cluster(_ref_mon)


@pytest.fixture(scope="module")
def port_cluster():
    yield from _cluster(_port_mon)


def test_port_osds_boot_through_the_reference_mon(cluster):
    _boot_checks(*cluster)


def test_port_daemons_adopt_the_pool_create_map(cluster):
    _pool_checks(*cluster)


def test_port_osds_boot_through_the_port_mon(port_cluster):
    mons, osds, monc = port_cluster
    _boot_checks(mons, osds, monc)
    assert all(m.device.type == "cpu" and m.osdmap.device.type == "cpu"
               for m in mons)


def test_port_daemons_adopt_the_port_mon_pool_create_map(port_cluster):
    _pool_checks(*port_cluster)


def _boot_checks(mons, osds, monc):
    def all_up():
        code, out = monc.command({"prefix": "osd dump"})
        return code == 0 and sum(1 for o in out["osds"]
                                 if o["up"]) == N_OSDS

    wait_for(all_up, msg="every port osd up in the mon's map")
    # each daemon adopted a map of the mon's that says so, on the CPU
    wait_for(lambda: all(o.osdmap is not None and all(
        o.osdmap.is_up(i) for i in range(N_OSDS)) for o in osds.values()),
        msg="every port daemon holds a map with all osds up")
    assert all(o.osdmap.device.type == "cpu" for o in osds.values())
    for i, o in osds.items():
        assert tuple(o.osdmap.osd_addrs[i]) == tuple(o.addr)


def _pool_checks(mons, osds, monc):
    code, _ = monc.command({
        "prefix": "osd erasure-code-profile set", "name": "k2m1",
        "profile": "plugin=isa k=2 m=1 technique=reed_sol_van"})
    assert code == 0
    code, out = monc.command({"prefix": "osd pool create", "pool": "rbd",
                              "pg_num": PG_NUM})
    assert code == 0, out
    code, out = monc.command({
        "prefix": "osd pool create", "pool": "ecpool", "pg_num": PG_NUM,
        "pool_type": "erasure", "erasure_code_profile": "k2m1"})
    assert code == 0, out

    def adopted():
        return all(o.osdmap is not None
                   and {p.name for p in o.osdmap.pools.values()}
                   >= {"rbd", "ecpool"} for o in osds.values())

    wait_for(adopted, msg="the pools in every port daemon's map")
    epochs = {o.epoch() for o in osds.values()}
    leader = next(mo for mo in mons if mo.state == "leader")
    assert max(epochs) <= leader.osdmap.epoch
    # the daemons created the PGs the map gives them: every PG of both
    # pools has its acting set's members holding it
    om = next(iter(osds.values())).osdmap
    for pid, pool in om.pools.items():
        for seed in range(pool.pg_num):
            _u, _up, acting, _ap = om.pg_to_up_acting((pid, seed))
            for o in acting:
                if 0 <= o < N_OSDS:
                    wait_for(lambda o=o, pgid=(pid, seed):
                             pgid in osds[o].pgs,
                             msg=f"pg {pid}.{seed} on osd.{o}")
    ec = [p for p in om.pools.values() if p.name == "ecpool"][0]
    pg = next(pg for o in osds.values() for pgid, pg in o.pgs.items()
              if pgid[0] == ec.pool_id)
    assert pg.backend.codec.device.type == "cpu"


@pytest.mark.parametrize("addrs", [
    [("127.0.0.1", 6789)],
    [("127.0.0.1", 6789), ("10.0.0.2", 6790), ("10.0.0.3", 6791)],
])
def test_monmap_dict_and_roster_equal_the_reference(addrs):
    mine, ref = MonMap(addrs, epoch=4), RefMonMap(addrs, epoch=4)
    assert mine.to_dict() == ref.to_dict()
    assert MonMap.from_dict(ref.to_dict()).to_dict() == ref.to_dict()
    for edit in (lambda mm: mm.with_added(("10.0.0.9", 6800)),
                 lambda mm: mm.with_removed(0)):
        a, b = edit(mine), edit(ref)
        assert a.to_dict() == b.to_dict()
        assert (a.size, a.live_ranks(), a.quorum()) == \
            (b.size, b.live_ranks(), b.quorum())
