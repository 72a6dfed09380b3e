"""The ``VStartCluster`` cases of ``tests/test_pg_split.py`` on the port
(``ceph_tpu_torch/vstart.py``, ``device="cpu"``), case for case:
``osd pool set pg_num`` through the mon, the incremental map, the local
split on every daemon and client IO across it (``:100``), then
``pgp_num`` growth migrating the children of a replicated (``:132``) and
an EC pool (``:183``).  Every wait polls with a deadline.

The reference file's MiniCluster cases (``:45``, ``:58``, ``:83``: the
local split with the map grown by hand, ``_grow_pg_num``) have no mirror
yet; they wait with the other client mirrors (ROADMAP queue 1 item 1k).
"""

from ceph_tpu_torch.vstart import VStartCluster as _VStartCluster


def VStartCluster(*args, **kw):
    """The port's cluster on the CPU."""
    return _VStartCluster(*args, device="cpu", **kw)


def test_pool_set_pg_num_end_to_end():
    with VStartCluster(n_mons=1, n_osds=3) as c:
        pool = c.create_pool("grow", size=2, pg_num=4)
        io = c.client().ioctx(pool)
        names = [f"g{i}" for i in range(30)]
        for n in names:
            io.write_full(n, (n * 20).encode())
        code, out = c.command({"prefix": "osd pool set", "pool": "grow",
                               "var": "pg_num", "val": 8})
        assert code == 0 and out["pg_num"] == 8

        def split_done():
            m = c.leader().osdmap
            return m is not None and m.pools[pool].pg_num == 8

        c.wait_for(split_done, what="pg_num growth")
        for n in names:
            assert io.read(n) == (n * 20).encode()
        io.write_full("after", b"ok")
        assert io.read("after") == b"ok"
        assert sorted(io.list_objects()) == sorted(names + ["after"])
        # shrinking is refused
        code, _ = c.command({"prefix": "osd pool set", "pool": "grow",
                             "var": "pg_num", "val": 4})
        assert code == -22


def test_pgp_num_growth_migrates_children():
    with VStartCluster(n_mons=1, n_osds=4) as c:
        pool = c.create_pool("mig", size=2, pg_num=4)
        io = c.client().ioctx(pool)
        names = [f"m{i}" for i in range(24)]
        for n in names:
            io.write_full(n, (n * 31).encode())
        code, _ = c.command({"prefix": "osd pool set", "pool": "mig",
                             "var": "pg_num", "val": 8})
        assert code == 0
        c.wait_for(lambda: c.leader().osdmap.pools[pool].pg_num == 8,
                   what="pg_num growth")
        code, _ = c.command({"prefix": "osd pool set", "pool": "mig",
                             "var": "pgp_num", "val": 8})
        assert code == 0
        c.wait_for(lambda: c.leader().osdmap.pools[pool].pgp_num == 8,
                   what="pgp_num growth")

        def children_replaced():
            m = c.leader().osdmap
            # at least one child now places differently from its parent
            for child in range(4, 8):
                up_c, _1, _2, _3 = m.pg_to_up_acting((pool, child))
                up_p, _4, _5, _6 = m.pg_to_up_acting((pool, child - 4))
                if up_c != up_p:
                    return True
            return False

        assert children_replaced(), "pgp bump should re-place children"

        def all_readable():
            for n in names:
                try:
                    if io.read(n) != (n * 31).encode():
                        return False
                except Exception:
                    return False
            return True

        c.wait_for(all_readable, timeout=60.0, what="post-migration reads")
        io.write_full("post-mig", b"ok")
        assert io.read("post-mig") == b"ok"


def test_pgp_num_growth_migrates_ec_children():
    with VStartCluster(n_mons=1, n_osds=5) as c:
        pool = c.create_pool(
            "ecmig", size=3, pool_type="erasure", pg_num=4,
            ec_profile="plugin=isa k=2 m=1 technique=reed_sol_van")
        io = c.client().ioctx(pool)
        names = [f"e{i}" for i in range(16)]
        for n in names:
            io.write_full(n, (n * 41).encode())
        for var, val in (("pg_num", 8), ("pgp_num", 8)):
            code, _ = c.command({"prefix": "osd pool set",
                                 "pool": "ecmig", "var": var,
                                 "val": val})
            assert code == 0
        c.wait_for(lambda: c.leader().osdmap.pools[pool].pgp_num == 8,
                   what="pgp growth")

        def all_readable():
            try:
                return all(io.read(n) == (n * 41).encode()
                           for n in names)
            except Exception:
                return False

        c.wait_for(all_readable, timeout=90.0,
                   what="post-migration EC reads")
        io.write_full("ec-post", b"ok")
        assert io.read("ec-post") == b"ok"
