"""The mon's scrub health checks of ``tests/test_scrub_engine.py`` on the
port's ``VStartCluster`` (``ceph_tpu_torch/vstart.py``,
``device="cpu"``), case for case: seeded rot that ``pg scrub`` misses and
``pg deep-scrub`` finds, ``PG_DAMAGED`` raised and cleared by
auto-repair with its cluster-log edges (``:337``), and
``PG_NOT_DEEP_SCRUBBED`` raised and cleared (``:432``).  The commands go
through the port's ``ceph`` dispatch (``tools/ceph.py``) where the
reference's go through ``VStartCluster.command``: one dispatch line a
command, as a user types it.  Every wait polls with a deadline.

The engine-level cases of the reference file are
``tests/test_torch_scrub.py``'s.
"""

from ceph_tpu_torch.osd import types as t_
from ceph_tpu_torch.osd.types import OSDOp
from ceph_tpu_torch.store.objectstore import Collection, GHObject
from ceph_tpu_torch.tools import ceph as ceph_cli
from ceph_tpu_torch.vstart import VStartCluster as _VStartCluster


def VStartCluster(*args, **kw):
    """The port's cluster on the CPU."""
    return _VStartCluster(*args, device="cpu", **kw)


def _ceph(c, line: str):
    """One ``ceph`` line through the port's dispatch: (code, out)."""
    code, out, _text = ceph_cli.dispatch(c, line.split())
    return code, out


def test_pg_damaged_health_raises_and_clears_via_cli():
    conf = {
        "osd_pg_stats_interval": 0.25,
        "mon_pg_stats_stale_s": 10.0,
        "mon_tick_interval": 0.25,
        "store_debug_inject_data_err": True,
    }
    with VStartCluster(n_mons=1, n_osds=3, conf=conf) as c:
        pool = c.create_pool("scrubec", size=3, pool_type="erasure",
                             ec_profile="k=2 m=1", pg_num=4)
        io = c.client().ioctx(pool)
        payload = b"damaged-pg" * 400
        io.aio_operate("dmg0", [OSDOp(t_.OP_WRITEFULL,
                                      data=payload)]).result(30.0)
        mm = c.leader().osdmap
        pgid = mm.object_to_pg(pool, "dmg0")
        _u, _up, acting, primary = mm.pg_to_up_acting(pgid)
        shard, victim = next((s, o) for s, o in enumerate(acting)
                             if o != primary)
        coll = Collection(t_.pgid_str(pgid) + "_head")
        c.osds[victim].store.debug_inject_data_err(
            coll, GHObject("dmg0", shard=shard))
        ps = f"{pgid[0]}.{pgid[1]}"

        def health():
            code, out = _ceph(c, "health")
            assert code == 0
            return out

        # the shallow scrub reads no bytes: no damage reported
        code, out = _ceph(c, f"pg scrub {ps}")
        assert code == 0 and out["action"] == "scrub"
        pg = c.osds[primary].pgs[pgid]
        c.wait_for(lambda: pg.last_scrub > 0, timeout=30.0,
                   what="shallow scrub completion")
        assert pg.scrub_errors == 0
        assert "PG_DAMAGED" not in health()["checks"]

        # the deep scrub reads them
        code, out = _ceph(c, f"pg deep-scrub {ps}")
        assert code == 0 and out["action"] == "deep-scrub"
        c.wait_for(lambda: pg.scrub_errors > 0, timeout=30.0,
                   what="deep scrub error detection")
        c.wait_for(lambda: "PG_DAMAGED" in health()["checks"],
                   timeout=30.0, what="PG_DAMAGED raised")
        hc = health()
        assert hc["status"] == "HEALTH_ERR"
        assert "scrub errors" in hc["checks"]["PG_DAMAGED"]["summary"]

        def _logged(needle):
            def check():
                code, log = _ceph(c, "log last")
                assert code == 0
                return any(needle in line["msg"]
                           for line in log["lines"])
            return check

        c.wait_for(_logged("PG_DAMAGED raised"), timeout=30.0,
                   what="PG_DAMAGED raised cluster-log edge")

        # auto-repair on a re-issued deep scrub rebuilds the shard with
        # the right _av, and the check clears
        c.ctx.conf.set_val("osd_scrub_auto_repair", True)
        try:
            code, _ = _ceph(c, f"pg deep-scrub {ps}")
            assert code == 0
            c.wait_for(lambda: pg.scrub_errors == 0, timeout=30.0,
                       what="auto-repair clearing scrub_errors")
            g = GHObject("dmg0", shard=shard)
            assert c.osds[victim].store.getattr(coll, g, "_av") == \
                pg._av_for("dmg0")
            c.wait_for(
                lambda: "PG_DAMAGED" not in health()["checks"],
                timeout=30.0, what="PG_DAMAGED cleared")
            c.wait_for(_logged("PG_DAMAGED cleared"), timeout=30.0,
                       what="PG_DAMAGED cleared cluster-log edge")
            assert pg.scrub_engine().run(deep=True) == {}
        finally:
            c.ctx.conf.set_val("osd_scrub_auto_repair", False)


def test_pg_not_deep_scrubbed_health_check():
    conf = {
        "osd_pg_stats_interval": 0.25,
        "mon_pg_stats_stale_s": 10.0,
        "mon_tick_interval": 0.25,
    }
    with VStartCluster(n_mons=1, n_osds=3, conf=conf) as c:
        pool = c.create_pool("nds", size=3, pg_num=2)
        io = c.client().ioctx(pool)
        io.aio_operate("o1", [OSDOp(t_.OP_WRITEFULL,
                                    data=b"x" * 512)]).result(30.0)

        def checks():
            code, out = _ceph(c, "health")
            assert code == 0
            return out["checks"]

        # off by default: never-scrubbed PGs raise nothing
        assert "PG_NOT_DEEP_SCRUBBED" not in checks()
        c.ctx.conf.set_val("mon_warn_not_deep_scrubbed_s", 3600.0)
        c.wait_for(lambda: "PG_NOT_DEEP_SCRUBBED" in checks(),
                   timeout=30.0, what="not-deep-scrubbed warning")
        # deep scrub every PG of the pool: the check clears
        mm = c.leader().osdmap
        for ps in range(2):
            _u, _up, _a, prim = mm.pg_to_up_acting((pool, ps))
            pg = c.osds[prim].pgs[(pool, ps)]
            assert pg.scrub_engine().run(deep=True) == {}
        c.wait_for(lambda: "PG_NOT_DEEP_SCRUBBED" not in checks(),
                   timeout=30.0, what="warning cleared after deep scrubs")
