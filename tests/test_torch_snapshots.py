"""``tests/test_snapshots.py`` mirrored on the port's cluster:
self-managed object snapshots through the port's client (``IoCtx``'s
snap calls; the snap ids come from the ``rados.snapmeta`` counter
class, so no monitor is needed): clone on write and snap reads, per
object, the clones on every replica, trim, failover, a delete keeping
its snapshots as a whiteout, the pool-wide trim through the snap
mapper, and a shared clone outliving a newer snap's trim.

The cluster is ``torch_daemon_harness.DaemonCluster("ceph_tpu_torch")``
(six port daemons, the reference's map,
``device="cpu"``), the client ``torch_daemon_harness.LibClient``.  The
snap rows through a PG split (``:179``) run on the port's
``VStartCluster`` (``ceph_tpu_torch/vstart.py``, ``device="cpu"``), its
waits polled with a deadline.
"""

import pytest

import torch_daemon_harness as H
from ceph_tpu_torch.osd import types as t_

REP_POOL = H.REP_POOL
LibClient = H.LibClient


def MiniCluster():
    return H.DaemonCluster("ceph_tpu_torch", device="cpu")


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


def test_snapshot_clone_on_write_and_read(cluster, client):
    io = client.rc.ioctx(REP_POOL)
    io.write_full("snapobj", b"version-1")
    s1 = io.selfmanaged_snap_create()
    io.write_full("snapobj", b"version-2")  # clones v1 under s1
    s2 = io.selfmanaged_snap_create()
    io.write_full("snapobj", b"version-3")  # clones v2 under s2

    assert io.read("snapobj") == b"version-3"
    assert io.snap_read("snapobj", s1) == b"version-1"
    assert io.snap_read("snapobj", s2) == b"version-2"
    # a snap taken but never followed by a write reads as head
    s3 = io.selfmanaged_snap_create()
    assert io.snap_read("snapobj", s3) == b"version-3"


def test_snapshot_isolated_per_object(cluster, client):
    io = client.rc.ioctx(REP_POOL)
    io.write_full("sa", b"a1")
    io.write_full("sb", b"b1")
    s = io.selfmanaged_snap_create()
    io.write_full("sa", b"a2")
    # sb unchanged since the snap: snap read serves head
    assert io.snap_read("sa", s) == b"a1"
    assert io.snap_read("sb", s) == b"b1"
    assert io.read("sa") == b"a2"


def test_snapshot_clones_replicate(cluster, client):
    """The clone rides the same replicated transaction: every acting
    OSD holds it."""
    from ceph_tpu_torch.store.objectstore import Collection, GHObject

    io = client.rc.ioctx(REP_POOL)
    io.write_full("repsnap", b"old")
    s = io.selfmanaged_snap_create()
    io.write_full("repsnap", b"new")
    pgid, acting, _ = cluster.primary_of(REP_POOL, "repsnap")
    coll = Collection(t_.pgid_str(pgid) + "_head")
    for osd_id in acting:
        store = cluster.osds[osd_id].store
        assert store.exists(coll, GHObject("repsnap", snap=s))
        assert store.read(coll, GHObject("repsnap", snap=s)) == b"old"


def test_snap_trim(cluster, client):
    from ceph_tpu_torch.store.objectstore import Collection, GHObject

    io = client.rc.ioctx(REP_POOL)
    io.write_full("trimme", b"t1")
    s = io.selfmanaged_snap_create()
    io.write_full("trimme", b"t2")
    assert io.snap_read("trimme", s) == b"t1"
    io.snap_trim("trimme", s)
    io.selfmanaged_snap_remove(s)
    # the clone is gone everywhere; snap read now falls back to head
    pgid, acting, _ = cluster.primary_of(REP_POOL, "trimme")
    coll = Collection(t_.pgid_str(pgid) + "_head")
    for osd_id in acting:
        assert not cluster.osds[osd_id].store.exists(
            coll, GHObject("trimme", snap=s))
    assert io.snap_read("trimme", s) == b"t2"
    assert io.read("trimme") == b"t2"


def test_snapshot_survives_failover(cluster, client):
    io = client.rc.ioctx(REP_POOL)
    io.write_full("fsnap", b"keep-me")
    s = io.selfmanaged_snap_create()
    io.write_full("fsnap", b"changed")
    _, acting, primary = cluster.primary_of(REP_POOL, "fsnap")
    cluster.kill(primary)
    try:
        assert io.snap_read("fsnap", s) == b"keep-me"
        assert io.read("fsnap") == b"changed"
    finally:
        cluster.revive(primary)


def test_delete_preserves_snapshots_via_whiteout(cluster, client):
    """Deleting a head with clones leaves a whiteout carrying the
    SnapSet (the reference's snapdir): snap reads still work, head
    reads ENOENT, and a recreate never re-clones over the preserved
    snapshot."""
    from ceph_tpu_torch.client.rados import RadosError

    io = client.rc.ioctx(REP_POOL)
    io.write_full("wh", b"precious")
    s = io.selfmanaged_snap_create()
    io.write_full("wh", b"newer")  # clone 'precious' under s
    io.remove("wh")
    # head is gone...
    with pytest.raises(RadosError):
        io.read("wh")
    # ...but the snapshot still reads
    assert io.snap_read("wh", s) == b"precious"
    # recreate with the SAME snap context: must NOT overwrite clone s
    io.write_full("wh", b"reborn")
    assert io.read("wh") == b"reborn"
    assert io.snap_read("wh", s) == b"precious"
    # a NEW snap then write behaves normally again
    s2 = io.selfmanaged_snap_create()
    io.write_full("wh", b"after-s2")
    assert io.snap_read("wh", s2) == b"reborn"
    assert io.snap_read("wh", s) == b"precious"


def test_snapmapper_pool_wide_trim(client):
    """SnapMapper-fed trim (reference SnapMapper.h:101 + the snap
    trimmer): one call trims every clone of the snap across the pool,
    and the index rows vanish with the clones."""
    io = client.rc.ioctx(REP_POOL)
    names = [f"sm{i}" for i in range(12)]
    for n in names:
        io.write_full(n, b"v1-" + n.encode())
    snap = io.selfmanaged_snap_create()
    for n in names:
        io.write_full(n, b"v2-" + n.encode())  # clones v1 under `snap`
    # clones readable via the snap
    for n in names[:3]:
        assert io.snap_read(n, snap) == b"v1-" + n.encode()
    got = io.selfmanaged_snap_trim(snap)
    assert got["trimmed"] == len(names)
    assert got["failed"] == 0
    # clones gone: snap reads now serve head
    for n in names[:3]:
        assert io.snap_read(n, snap) == b"v2-" + n.encode()
    # idempotent: nothing left to trim
    again = io.selfmanaged_snap_trim(snap)
    assert again["trimmed"] == 0 and again["failed"] == 0



def test_shared_clone_survives_newer_snap_trim(client):
    """One clone can cover several live snaps (reference
    SnapSet::clone_snaps): trimming the newer snap must NOT destroy
    the data an older snap still needs."""
    io = client.rc.ioctx(REP_POOL)
    io.write_full("shared", b"v1")
    s1 = io.selfmanaged_snap_create()
    s2 = io.selfmanaged_snap_create()  # no write between: s1,s2 share
    io.write_full("shared", b"v2")     # ONE clone covering {s1, s2}
    assert io.snap_read("shared", s1) == b"v1"
    assert io.snap_read("shared", s2) == b"v1"
    got = io.selfmanaged_snap_trim(s2)
    assert got["trimmed"] == 1 and got["failed"] == 0, (s1, s2, got)
    # s1 still serves v1 — the clone survived the s2 trim
    assert io.snap_read("shared", s1) == b"v1"
    got = io.selfmanaged_snap_trim(s1)
    assert got["trimmed"] == 1
    assert io.snap_read("shared", s1) == b"v2"  # clone gone -> head


def test_snap_rows_follow_objects_through_pg_split():
    """SnapMapper rows migrate with their objects on pg_num growth, so
    clones in child PGs stay trimmable."""
    from ceph_tpu_torch.vstart import VStartCluster

    with VStartCluster(n_mons=1, n_osds=3, device="cpu") as c:
        pool = c.create_pool("snapsplit", size=2, pg_num=4)
        io = c.client().ioctx(pool)
        names = [f"ss{i}" for i in range(20)]
        for n in names:
            io.write_full(n, b"v1")
        snap = io.selfmanaged_snap_create()
        for n in names:
            io.write_full(n, b"v2")  # one clone per object
        code, _ = c.command({"prefix": "osd pool set",
                             "pool": "snapsplit", "var": "pg_num",
                             "val": 8})
        assert code == 0
        # the client's map must show the split too: the trim fans out
        # one op a PG of the client's pg_num
        c.wait_for(lambda: (c.leader().osdmap.pools[pool].pg_num == 8
                            and io.client.objecter.osdmap
                            .pools[pool].pg_num == 8),
                   what="split visible to client")
        got = io.selfmanaged_snap_trim(snap)
        assert got["trimmed"] == len(names), got
        assert got["failed"] == 0
        for n in names:
            assert io.snap_read(n, snap) == b"v2"  # clones gone
