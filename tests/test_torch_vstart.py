"""The port's ``VStartCluster`` (``ceph_tpu_torch/vstart.py``) on the CPU.

Mirrors the cases of ``tests/test_vstart_rados_cli.py`` that need only a
``VStartCluster`` (``:23``, ``:49``, ``:72``, ``:175``, ``:215``,
``:247``, ``:282``) and ``tests/test_pg_repair_cmd.py:12``, each with
``device="cpu"``: mons, daemons and clients of the port, each kernel's
plain version.  The CLI cases of ``test_vstart_rados_cli.py`` ``:87``,
``:107`` and ``:136`` (the rados and ceph tools) are in
``test_torch_cli_tools.py``; ``:154`` (rbd) waits for ROADMAP queue 1
item 6c, ``:196`` (the cephfs shell) for 6d.  The mgr
(``start_mgr``) is held in ``test_torch_mgr.py``.  Every wait polls
with a deadline.  Also here: the guard that a ``VStartCluster`` or
``Monitor`` with no device raises on a machine with no card, before a
socket or a thread exists, and the MDS entry points that raise until
item 6d is ported.
"""

import threading
import time

import pytest
import torch

from ceph_tpu_torch.osd import types as t_
from ceph_tpu_torch.store.objectstore import Collection, GHObject, Transaction
from ceph_tpu_torch.vstart import VStartCluster as _VStartCluster

DEV = "cpu"


def VStartCluster(*args, **kw):
    """The port's cluster on the CPU."""
    return _VStartCluster(*args, device=DEV, **kw)


def test_vstart_pool_io_and_listing():
    with VStartCluster(n_mons=1, n_osds=3) as c:
        pool = c.create_pool("data", size=2)
        io_ = c.client().ioctx(pool)
        io_.write_full("alpha", b"A" * 1000)
        io_.write_full("beta", b"B" * 10)
        assert io_.read("alpha") == b"A" * 1000
        assert io_.list_objects() == ["alpha", "beta"]
        io_.remove("beta")
        assert io_.list_objects() == ["alpha"]
        # under heavy host load an OSD can transiently miss its 3s
        # heartbeat grace and be reported down; health converges back
        # once scheduling recovers — poll instead of a one-shot assert
        deadline = time.time() + 20
        while True:
            code, out = c.command({"prefix": "health"})
            if code == 0 and out["status"] == "HEALTH_OK":
                break
            assert time.time() < deadline, f"health never OK: {out}"
            time.sleep(0.5)


def test_vstart_survives_osd_kill():
    with VStartCluster(n_mons=1, n_osds=4) as c:
        pool = c.create_pool("r3", size=3)
        io_ = c.client().ioctx(pool)
        io_.write_full("obj", b"payload" * 100)
        victim = None
        m = c.leader().osdmap
        pgid = m.object_to_pg(pool, "obj")
        _up, _upp, acting, _ap = m.pg_to_up_acting(pgid)
        victim = acting[0]
        c.kill_osd(victim)

        def remapped():
            mm = c.leader().osdmap
            _u, _up2, act, _a = mm.pg_to_up_acting(pgid)
            return victim not in act and all(a >= 0 for a in act[:2])

        c.wait_for(remapped, what="remap after kill")
        assert io_.read("obj") == b"payload" * 100


def test_vstart_durable_dir_remount(tmp_path):
    d = str(tmp_path / "cluster")
    with VStartCluster(n_mons=1, n_osds=2, data_dir=d) as c:
        pool = c.create_pool("keep", size=2)
        c.client().ioctx(pool).write_full("persist", b"still here")
    # fresh cluster over the same stores: object data survives (mon
    # state is fresh, so recreate the pool with the same id ordering)
    with VStartCluster(n_mons=1, n_osds=2, data_dir=d) as c2:
        pool2 = c2.create_pool("keep", size=2)
        io2 = c2.client().ioctx(pool2)
        assert io2.read("persist") == b"still here"


def test_vstart_blockstore_backed_cluster(tmp_path):
    """The BlueStore-role BlockStore under the FULL daemon stack:
    writes through mons+osds, durable across cluster restart, fsck
    clean."""
    d = str(tmp_path / "bs-cluster")
    with VStartCluster(n_mons=1, n_osds=2, data_dir=d,
                       store_kind="blockstore") as c:
        pool = c.create_pool("bs", size=2)
        io_ = c.client().ioctx(pool)
        io_.write_full("obj", b"block-backed" * 500)
    with VStartCluster(n_mons=1, n_osds=2, data_dir=d,
                       store_kind="blockstore") as c2:
        pool2 = c2.create_pool("bs", size=2)
        io2 = c2.client().ioctx(pool2)
        assert io2.read("obj") == b"block-backed" * 500
        for o in c2.osds.values():
            assert o.store.fsck() == []


def test_pg_dump_and_pg_health():
    """MPGStats feed: `pg dump` shows every PG active with object
    counts; killing an OSD surfaces PG_DEGRADED in health."""
    with VStartCluster(n_mons=1, n_osds=3,
                       conf={"osd_pg_stats_interval": 0.5}) as c:
        pool = c.create_pool("stats", size=3, pg_num=4)
        io = c.client().ioctx(pool)
        for i in range(8):
            io.write_full(f"s{i}", b"x" * 100)

        def dumped():
            code, out = c.command({"prefix": "pg dump"})
            if code != 0 or out["num_pg_stats"] < 4:
                return False
            rows = [r for r in out["pg_stats"]
                    if r["pgid"].startswith(f"{pool}.")]
            return (len(rows) == 4
                    and all(r["state"] == "active" for r in rows)
                    and sum(r["num_objects"] for r in rows) == 8)

        c.wait_for(dumped, what="pg dump active + counts")
        c.kill_osd(2)

        def degraded():
            code, out = c.command({"prefix": "health"})
            return code == 0 and "PG_DEGRADED" in out["checks"]

        c.wait_for(degraded, timeout=30.0, what="PG_DEGRADED")


def test_osd_fullness_health():
    """ObjectStore::statfs feeds OSD_NEARFULL/OSD_FULL health via the
    MPGStats reports (reference nearfull/full ratios)."""
    with VStartCluster(n_mons=1, n_osds=2,
                       conf={"osd_pg_stats_interval": 0.3}) as c:
        pool = c.create_pool("full", size=2)
        io = c.client().ioctx(pool)
        io.write_full("x", b"d" * 4096)

        def reported():
            ld = c.leader()
            return (len(ld.osd_fullness) == 2
                    and all(t > 0 for _u, t in ld.osd_fullness.values()))

        c.wait_for(reported, what="fullness reports")
        code, out = c.command({"prefix": "health"})
        assert code == 0
        assert "OSD_NEARFULL" not in out["checks"]  # MemStore ~empty
        # inject a near-full report directly (the wire path is proven
        # above; the ratio->check logic is what's under test here).
        # Stop the daemons first so live reports can't overwrite it.
        for i in list(c.osds):
            c.kill_osd(i)
        ld = c.leader()
        with ld.lock:
            ld.osd_fullness[0] = (90 << 20, 100 << 20)  # 90%
            ld.osd_fullness[1] = (96 << 20, 100 << 20)  # 96%
        code, out = c.command({"prefix": "health"})
        assert "OSD_NEARFULL" in out["checks"]
        assert "OSD_FULL" in out["checks"]
        assert out["status"] == "HEALTH_ERR"


def test_osd_df_and_status_pg_states():
    with VStartCluster(n_mons=1, n_osds=2,
                       conf={"osd_pg_stats_interval": 0.3}) as c:
        pool = c.create_pool("dfp", size=2, pg_num=4)
        io = c.client().ioctx(pool)
        io.write_full("a", b"z" * 1000)

        def ready():
            code, out = c.command({"prefix": "osd df"})
            if code != 0 or len(out["nodes"]) != 2:
                return False
            code, st = c.command({"prefix": "status"})
            return (code == 0
                    and st["pg_states"].get("active", 0) >= 4)

        c.wait_for(ready, what="osd df + pg states")
        code, out = c.command({"prefix": "osd df"})
        assert all(n["total_bytes"] > 0 for n in out["nodes"])


def test_pg_repair_command_roundtrip():
    with VStartCluster(n_mons=1, n_osds=4) as c:
        pool = c.create_pool("r3", size=3)
        io_ = c.client().ioctx(pool)
        payload = b"fix-me-via-cli" * 200
        io_.write_full("obj", payload)

        m = c.leader().osdmap
        pgid = m.object_to_pg(pool, "obj")
        _u, _upp, acting, primary = m.pg_to_up_acting(pgid)
        replica = next(o for o in acting if o != primary)
        coll = Collection(t_.pgid_str(pgid) + "_head")
        g = GHObject("obj")
        t = Transaction()
        t.write(coll, g, 0, b"ROT")
        c.osds[replica].store.queue_transaction(t)

        pg = c.osds[primary].pgs[pgid]
        assert "obj" in pg.scrub()

        code, out = c.command({"prefix": "pg repair",
                               "pgid": f"{pgid[0]}.{pgid[1]}"})
        assert code == 0 and out["instructed"] == f"osd.{primary}"

        deadline = time.time() + 15
        while time.time() < deadline:
            if c.osds[replica].store.read(coll, g) == payload:
                break
            time.sleep(0.2)
        assert c.osds[replica].store.read(coll, g) == payload
        assert pg.scrub().get("obj") is None

        # bad pgid is a clean error, not a crash
        code, _ = c.command({"prefix": "pg repair", "pgid": "bogus"})
        assert code == -22


def test_vstart_and_monitor_without_a_device_raise_without_a_card(
        monkeypatch):
    from ceph_tpu_torch.core.context import Context
    from ceph_tpu_torch.mon import MonMap, Monitor

    before = {t.ident for t in threading.enumerate()}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    made = []
    real_socket = __import__("socket").socket

    def no_socket(*a, **kw):
        made.append(a)
        return real_socket(*a, **kw)

    monkeypatch.setattr("socket.socket", no_socket)
    with pytest.raises(RuntimeError, match="CUDA"):
        _VStartCluster(n_mons=1, n_osds=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        Monitor(Context("mon.nodev"), 0, MonMap([("127.0.0.1", 1)]))
    with pytest.raises(RuntimeError, match="CUDA"):
        Monitor(Context("mon.nodev"), 0, MonMap([("127.0.0.1", 1)]),
                device="cuda")
    assert made == []
    assert [t for t in threading.enumerate() if t.ident not in before] == []
    # naming the CPU is the one way to run there; nothing started
    mon = Monitor(Context("mon.cpu"), 0, MonMap([("127.0.0.1", 1)]),
                  device="cpu")
    assert mon.device.type == "cpu" and mon.state == "electing"


@pytest.mark.parametrize("call", ["start_mds", "fs_status", "mount"])
def test_mgr_and_mds_wait_for_their_items(call):
    with VStartCluster(n_mons=1, n_osds=1, wait=False) as c:
        with pytest.raises(NotImplementedError, match="item 6d"):
            getattr(c, call)()
