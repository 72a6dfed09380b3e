"""The cluster cases of ``tests/test_recovery_pipeline.py`` (``:385``,
``:451``) mirrored on the port's cluster: the windowed EC pull end to
end, and recover-on-read, through the port's client.

Each case builds its own six-daemon port cluster
(``torch_daemon_harness.DaemonCluster("ceph_tpu_torch")``, the
reference's map, ``device="cpu"``) and drives it
through the port's ``RadosClient`` (``torch_daemon_harness.LibClient``).
The stub-PG cases of that file are mirrored in
``tests/test_torch_recovery.py``.

The recover-on-read case does not inherit the reference's timing race
(red under a loaded ``-n 6`` run): once the read is out and its
object's recovery round served, the later rounds' answers are held
back until the read is answered, so the pull is still outstanding when
it comes whatever the load; ``recover_on_read_hits`` is awaited with a deadline, not read
once, and no step waits on a fixed sleep.
"""

import threading
import time

import torch_daemon_harness as H
from ceph_tpu_torch.osd import messages as m
from ceph_tpu_torch.osd import types as t_
from ceph_tpu_torch.osd.backend import _av_stamp
from ceph_tpu_torch.osd.pg import STATE_PEERING
from ceph_tpu_torch.store.objectstore import GHObject

EC_POOL = H.EC_POOL


def MiniCluster():
    return H.DaemonCluster("ceph_tpu_torch", device="cpu")


LibClient = H.LibClient


def _same_pg_oids(c, n, prefix):
    """n object names all landing in one EC pg; returns (pgid, oids)."""
    target = c.osdmap.object_to_pg(EC_POOL, f"{prefix}0")
    oids = []
    i = 0
    while len(oids) < n:
        oid = f"{prefix}{i}"
        if c.osdmap.object_to_pg(EC_POOL, oid) == target:
            oids.append(oid)
        i += 1
        assert i < 2000, "could not find same-pg names"
    return target, oids


def _revive_hooked(c, osd_id, pre_activate=None):
    """The harness's revive with a hook between the daemon's
    construction and its activation (to wrap ``send_to_osd``), and no
    settle wait."""
    svc = c._service(osd_id, c.osds[osd_id].store)
    svc.init()
    c.osds[osd_id] = svc
    if pre_activate is not None:
        pre_activate(svc)
    c.refresh()  # the new address first, as the harness's revive
    c.osdmap.set_osd_up(osd_id)
    c.refresh()
    for o in c.osds.values():
        if o.up:
            o.activate_pgs()
    return svc


def test_windowed_pull_end_to_end():
    """``test_recovery_pipeline.py:385``: the revived primary recovers
    every object written while it was down through the windowed engine:
    aggregated vec sub-reads, the right bytes and ``_av`` stamps, an
    empty missing set and a ``recovery_active`` high-water above 1."""
    c = MiniCluster()
    cl = LibClient(c)
    try:
        pgid, oids = _same_pg_oids(c, 8, "wp")
        _pg, acting, primary = c.primary_of(EC_POOL, oids[0])
        for oid in oids:
            assert cl.put(EC_POOL, oid,
                          f"{oid}-v1".encode() * 100).result == 0
        c.kill(primary)
        for oid in oids:
            assert cl.put(EC_POOL, oid,
                          f"{oid}-v2".encode() * 100).result == 0

        vec_msgs = []

        def hook(svc):
            orig = svc.send_to_osd

            def spy(osd_id, msg):
                if isinstance(msg, m.MECSubReadVec) \
                        and msg.pgid == pgid:
                    vec_msgs.append((osd_id, msg))
                orig(osd_id, msg)

            svc.send_to_osd = spy

        svc = _revive_hooked(c, primary, pre_activate=hook)
        for o in c.osds.values():
            if o.up:
                o.wait_pgs_settled(20.0)
        pg = svc.pgs[pgid]
        with pg.lock:
            assert not pg.missing, f"pull left missing: {pg.missing}"
        for oid in oids:
            assert cl.get(EC_POOL, oid) == f"{oid}-v2".encode() * 100
        assert vec_msgs, "pull never used vec sub-reads"
        # aggregation: 8 objects over 2 peers at W=3 is <= 6 vecs;
        # one message per (object, peer) would be 16
        assert len(vec_msgs) <= 8, (
            f"{len(vec_msgs)} vec messages for 8 objects — "
            "window aggregation is not happening")
        perf = svc.pg_perf.dump()
        assert perf.get("recovery_active", 0) >= 2, perf
        assert perf.get("subread_ops", 0) >= 8, perf
        # recovered shards carry the newest entry's _av stamp
        n = pg.backend.k + pg.backend.m
        my_shards = pg.backend.local_shards(pg.acting[:n])
        for oid in oids:
            en = pg.log.latest_for(oid)
            for shard in my_shards:
                got = svc.store.getattr(pg.coll,
                                        GHObject(oid, shard=shard),
                                        "_av")
                assert got == _av_stamp(en.version), \
                    f"{oid} shard {shard}: stale recovery stamp"
    finally:
        cl.shutdown()
        c.shutdown()


def test_recover_on_read_serves_before_full_pull():
    """``test_recovery_pipeline.py:451``: with a slow 16-object pull at
    window W=1, a read of the object last in the queue promotes it and
    is served by its own recovery round while most of the pull is still
    outstanding (``recover_on_read_hits`` proves recovery woke the
    parked read)."""
    c = MiniCluster()
    cl = LibClient(c)
    c.ctx.conf.set_val("osd_recovery_max_active", 1, force=True)
    try:
        pgid, oids = _same_pg_oids(c, 16, "rr")
        _pg, acting, primary = c.primary_of(EC_POOL, oids[0])
        for oid in oids:
            assert cl.put(EC_POOL, oid,
                          f"{oid}|A".encode() * 64).result == 0
        c.kill(primary)
        for oid in oids:
            assert cl.put(EC_POOL, oid,
                          f"{oid}|B".encode() * 64).result == 0
        # slow every surviving peer's vec answer: ~0.15s per window
        # round makes the 16-round pull take seconds; once the read is
        # out and its object's round served, the later rounds' answers
        # are held back (off the peer's dispatch thread, within the
        # engine's 10 s read timeout) until the read is answered, so
        # "most of the pull is still outstanding" holds however loaded
        # the host is
        target = sorted(oids)[-1]  # recovered LAST in queue order
        hold, served, answered = (threading.Event(), threading.Event(),
                                  threading.Event())
        held = []
        for o in c.osds.values():
            if not o.up or pgid not in o.pgs:
                continue
            opg = o.pgs[pgid]
            orig = opg.handle_sub_read_vec

            def slow(msg, conn, _orig=orig):
                time.sleep(0.15)
                mine = any(r[1] == target for r in msg.reads)
                if (hold.is_set() and served.is_set() and not mine
                        and not answered.is_set()):
                    def later():
                        answered.wait(8.0)
                        _orig(msg, conn)

                    th = threading.Thread(target=later, daemon=True)
                    held.append(th)
                    th.start()
                    return
                _orig(msg, conn)
                if mine and hold.is_set():
                    served.set()

            opg.handle_sub_read_vec = slow
        svc = _revive_hooked(c, primary)  # no settle wait
        pg = svc.pgs[pgid]
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            with pg.lock:
                started = (pg.state != STATE_PEERING
                           and target in pg.missing
                           and len(pg.missing) > 8)
            if started:
                break
            time.sleep(0.05)
        assert started, "pull drained before the read could race it"
        hold.set()
        try:
            rep = cl.op(EC_POOL, target, [t_.OSDOp(t_.OP_READ)],
                        timeout=15.0)
            with pg.lock:
                left = len(pg.missing)
        finally:
            answered.set()
        for th in held:
            th.join(10.0)
            assert not th.is_alive()
        assert rep.result == 0, f"promoted read failed: {rep.result}"
        assert rep.ops[0].out_data == f"{target}|B".encode() * 64
        assert left > 0, (
            "read only completed after the full pull — promotion "
            "did not shortcut the window")
        deadline = time.monotonic() + 10.0
        while (svc.pg_perf.dump().get("recover_on_read_hits", 0) < 1
               and time.monotonic() < deadline):
            time.sleep(0.01)
        hits = svc.pg_perf.dump().get("recover_on_read_hits", 0)
        assert hits >= 1, "no parked read was woken by recovery"
        for o in c.osds.values():
            if o.up:
                o.wait_pgs_settled(30.0)
        for oid in oids:
            assert cl.get(EC_POOL, oid) == f"{oid}|B".encode() * 64
    finally:
        c.ctx.conf.set_val("osd_recovery_max_active", 3, force=True)
        cl.shutdown()
        c.shutdown()
