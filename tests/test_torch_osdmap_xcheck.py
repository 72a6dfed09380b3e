"""Placement on the host, the port against ceph_tpu on the CPU, bit for
bit: the same seeded maps built in both packages give equal ``map_pgs``
rows (the port's plain walk against the reference's jitted program),
equal ``pg_to_up_acting`` results (against the reference's
``_native.do_rule``) on healthy, short-host and out-host maps, equal
bytes from ``encode_osdmap``, ``Incremental.encode``,
``encode_full_value`` and the OSD types, equal balancer moves and
resulting maps, and equal ``osdmaptool`` JSON."""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest

from ceph_tpu.core.encoding import Encoder as RefEncoder
from ceph_tpu.crush import map as ref_cmap
from ceph_tpu.mgr import balancer as ref_balancer
from ceph_tpu.osd import map_codec as ref_codec
from ceph_tpu.osd import map_inc as ref_inc
from ceph_tpu.osd import osdmap as ref_osdmap
from ceph_tpu.osd import types as ref_types
from ceph_tpu_torch.core.encoding import Encoder
from ceph_tpu_torch.crush import map as cmap
from ceph_tpu_torch.mgr import balancer
from ceph_tpu_torch.osd import map_codec, map_inc, osdmap, types
from ceph_tpu_torch.tools import osdmaptool

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
sys.path.insert(0, os.path.abspath(TOOLS))

import osdmaptool as ref_osdmaptool  # noqa: E402

NONE = osdmap.CRUSH_ITEM_NONE


def _both(fn):
    """fn(crush map module, osdmap module, OSDMap kwargs) in each package:
    (reference map, port map)."""
    return (fn(ref_cmap, ref_osdmap, {}),
            fn(cmap, osdmap, {"device": "cpu"}))


def _flat_map(n_osds, hosts, pools):
    """A build_flat_cluster map with pools [(pool_id, type, size,
    pg_num)], each on a chooseleaf rule over hosts."""
    def build(cm_mod, om_mod, kw):
        cm, root = cm_mod.build_flat_cluster(n_osds, hosts=hosts)
        m = om_mod.OSDMap(cm, max_osd=n_osds, **kw)
        for pid, ptype, size, pg_num in pools:
            mode = "firstn" if ptype == om_mod.POOL_REPLICATED else "indep"
            rid = cm.add_simple_rule(f"r{pid}", root, 1, mode=mode,
                                     num=size)
            m.add_pool(om_mod.PGPool(pid, ptype, size=size,
                                     min_size=size - 1, pg_num=pg_num,
                                     pgp_num=pg_num, crush_rule=rid,
                                     name=f"pool{pid}"))
        return m
    return _both(build)


def _racks_map():
    """Two racks of two hosts of three OSDs, with a two-level firstn rule
    and a two-level indep rule (choose 2 racks, then a leaf in 2 hosts
    of each)."""
    def build(cm_mod, om_mod, kw):
        cm = cm_mod.CrushMap()
        cm.type_names.update({1: "host", 2: "rack", 10: "root"})
        hosts = [cm.add_bucket(cm_mod.ALG_STRAW2, 1, list(range(h * 3,
                                                               h * 3 + 3)),
                               [0x10000] * 3) for h in range(4)]
        racks = [cm.add_bucket(cm_mod.ALG_STRAW2, 2, hosts[r * 2:r * 2 + 2],
                               [0x30000] * 2) for r in range(2)]
        root = cm.add_bucket(cm_mod.ALG_STRAW2, 10, racks, [0x60000] * 2)
        for name, c1, c2, typ in (("f", cm_mod.OP_CHOOSE_FIRSTN,
                                   cm_mod.OP_CHOOSELEAF_FIRSTN, 1),
                                  ("i", cm_mod.OP_CHOOSE_INDEP,
                                   cm_mod.OP_CHOOSELEAF_INDEP, 3)):
            cm.add_rule(cm_mod.Rule(name, [(cm_mod.OP_TAKE, root, 0),
                                           (c1, 2, 2), (c2, 2, 1),
                                           (cm_mod.OP_EMIT, 0, 0)],
                                    type=typ))
        m = om_mod.OSDMap(cm, max_osd=12, **kw)
        m.add_pool(om_mod.PGPool(1, om_mod.POOL_REPLICATED, size=4,
                                 pg_num=32, pgp_num=32, crush_rule=0))
        m.add_pool(om_mod.PGPool(2, om_mod.POOL_ERASURE, size=5,
                                 pg_num=32, pgp_num=32, crush_rule=1))
        return m
    return _both(build)


def _mutate(m, seed):
    """The same state changes on either package's map."""
    rng = np.random.default_rng(seed)
    n = m.max_osd
    m.set_osd_down(int(rng.integers(0, n)))
    m.set_osd_out(int(rng.integers(0, n)))
    m.reweight_osd(int(rng.integers(0, n)), 0x8000)
    for osd in rng.choice(n, 3, replace=False):
        m.set_primary_affinity(int(osd), int(rng.integers(0, 0x10000)))
    for pid, pool in m.pools.items():
        pg = lambda: int(rng.integers(0, pool.pg_num))  # noqa: E731
        m.pg_upmap[(pid, pg())] = [int(o) for o in rng.choice(
            n, pool.size, replace=False)]
        m.pg_upmap_items[(pid, pg())] = [(0, 1), (2, 3)]
        m.pg_temp[(pid, pg())] = [int(o) for o in rng.choice(
            n, pool.size, replace=False)]
        m.primary_temp[(pid, pg())] = int(rng.integers(0, n))
    m.osd_addrs[0] = ("10.0.0.1", 6800)
    m.osd_hb_addrs[0] = ("10.0.0.1", 6801)
    m.bump_epoch()


def _host_out(m, host, per):
    for osd in range(host * per, (host + 1) * per):
        m.set_osd_down(osd)
        m.set_osd_out(osd)


def _assert_same_placement(ref, port, scalar_pgs):
    assert ref_codec.encode_osdmap(ref) == map_codec.encode_osdmap(port)
    for pid, pool in ref.pools.items():
        want, got = ref.map_pgs(pid), port.map_pgs(pid)
        assert sorted(want) == sorted(got)
        for k in want:
            assert got[k].dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for ps in (p for p in scalar_pgs if p < pool.pg_num):
            assert port.pg_to_up_acting((pid, ps)) == \
                ref.pg_to_up_acting((pid, ps)), (pid, ps)


@pytest.mark.parametrize("case", [
    "healthy", "mutated", "short_hosts", "host_out", "racks"])
def test_placement_equals_reference(case):
    if case == "short_hosts":
        # more replicas than hosts: firstn rows come up short, indep rows
        # keep holes
        ref, port = _flat_map(8, 2, [(1, 1, 3, 32), (2, 3, 4, 32)])
        scalar = range(0, 32, 3)
    elif case == "racks":
        ref, port = _racks_map()
        scalar = range(0, 32, 4)
    else:
        ref, port = _flat_map(32, 8, [(1, 1, 3, 64), (2, 3, 6, 64)])
        scalar = range(0, 64, 5)
    for m in (ref, port):
        if case == "mutated":
            _mutate(m, 7)
        elif case in ("host_out", "racks"):
            _host_out(m, 2, 4 if case == "host_out" else 3)
    _assert_same_placement(ref, port, scalar)


def test_scalar_rows_keep_holes_and_trim_padding():
    """At N=1 the walk's row is padded to the pool size: a short firstn
    row loses its padding, a short indep row keeps its holes."""
    ref, port = _flat_map(8, 2, [(1, 1, 3, 16), (2, 3, 4, 16)])
    rep, ec = port.pools[1], port.pools[2]
    for ps in range(16):
        r = port._crush_raw(rep, rep.raw_pg_to_pps(ps))
        assert len(r) == 2 and NONE not in r
        assert r == ref._crush_raw(ref.pools[1], rep.raw_pg_to_pps(ps))
        e = port._crush_raw(ec, ec.raw_pg_to_pps(ps))
        assert len(e) == 4 and e.count(NONE) == 2
        assert e == ref._crush_raw(ref.pools[2], ec.raw_pg_to_pps(ps))
    steps = [(cmap.OP_TAKE, -1, 0), (cmap.OP_CHOOSE_INDEP, 2, 2),
             (cmap.OP_CHOOSELEAF_INDEP, 0, 1), (cmap.OP_EMIT, 0, 0)]
    assert osdmap.rule_result_len(steps, 5) == 5
    assert osdmap.rule_result_len(steps[:1] + steps[2:], 3) == 3
    assert osdmap.rule_result_len([(cmap.OP_TAKE, 3, 0)] + steps[1:], 4) == 0
    assert osdmap.rule_result_len([(cmap.OP_TAKE, -1, 0),
                                   (cmap.OP_CHOOSELEAF_FIRSTN, 0, 1),
                                   (cmap.OP_EMIT, 0, 0)], 3) is None


def test_seeds_wider_than_int32_pass_as_their_bits():
    pps = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
                   dtype=np.uint32)
    ids = osdmap.seeds_as_ids(pps)
    assert ids.dtype == np.int32
    assert ids.tolist() == [0, 1, 0x7FFFFFFF, -(1 << 31), -1]
    ref, port = _flat_map(16, 4, [(1, 1, 3, 8)])
    pool = port.pools[1]
    rows = port._walk(pool, pps)
    for i, x in enumerate(pps.tolist()):
        want = ref._crush_raw(ref.pools[1], x)
        assert [int(v) for v in rows[i]] == want, x


def test_pool_seeds_and_hashes_equal_reference():
    for pg_num, pgp_num, flags in ((64, 64, 1), (12, 12, 1), (100, 60, 1),
                                   (12, 7, 0)):
        rp = ref_osdmap.PGPool(3, pg_num=pg_num, pgp_num=pgp_num,
                               flags=flags)
        pp = osdmap.PGPool(3, pg_num=pg_num, pgp_num=pgp_num, flags=flags)
        ps = np.arange(4 * pg_num)
        np.testing.assert_array_equal(pp.pps_vector(ps), rp.pps_vector(ps))
        for x in range(0, 4 * pg_num, 7):
            assert pp.raw_pg_to_pps(x) == rp.raw_pg_to_pps(x)
            assert pp.raw_pg_to_pg_ps(x) == rp.raw_pg_to_pg_ps(x)
        for key, ns in (("obj", ""), ("rbd_data.1", "ns1"), (b"\xff", b"a")):
            assert pp.hash_key(key, ns) == rp.hash_key(key, ns)


def _rich_pair():
    ref, port = _flat_map(32, 8, [(1, 1, 3, 64), (2, 3, 6, 32)])
    for m in (ref, port):
        _mutate(m, 11)
        m.crush.bucket_names = {b: f"b{-b}" for b in m.crush.buckets}
        m.crush.choose_args["-1"] = {
            b: [w + 16 * i for i, w in enumerate(bk.weights)]
            for b, bk in m.crush.buckets.items()}
        m.pools[1].hit_set_count, m.pools[1].hit_set_period = 4, 1.5
        m.bump_epoch()
    return ref, port


def test_map_and_incremental_bytes_equal_reference():
    ref, port = _rich_pair()
    full = ref_codec.encode_osdmap(ref)
    assert map_codec.encode_osdmap(port) == full
    assert map_inc.encode_full_value(port) == ref_inc.encode_full_value(ref)
    assert map_inc.crush_bytes(port) == ref_inc.crush_bytes(ref)
    # the reference's bytes decode in the port, and back
    back = map_codec.decode_osdmap(full, device="cpu")
    assert map_codec.encode_osdmap(back) == full
    assert ref_codec.encode_osdmap(ref_codec.decode_osdmap(
        map_codec.encode_osdmap(port))) == full
    # one delta of each kind, diffed, encoded and applied in both
    rprev, pprev = ref_inc.clone_map(ref), map_inc.clone_map(port)
    for m in (ref, port):
        m.set_osd_down(5)
        m.reweight_osd(6, 0x4000)
        m.set_primary_affinity(7, 0x2000)
        m.osd_addrs[3] = ("10.0.0.3", 6900)
        m.osd_addrs.pop(0)
        m.crush.reweight_item(-1, 0, 0x18000)
        m.pools[2].min_size = 4
        del m.pg_temp[next(k for k in m.pg_temp if k[0] == 1)]
        m.pg_upmap_items[(1, 9)] = [(4, 5)]
        m.bump_epoch()
    rinc, pinc = ref_inc.diff_maps(rprev, ref), map_inc.diff_maps(pprev, port)
    assert pinc.encode() == rinc.encode() and pinc.crush
    assert map_inc.encode_inc_value(pinc) == ref_inc.encode_inc_value(rinc)
    got = map_inc.Incremental.decode(rinc.encode()).apply(pprev)
    assert map_codec.encode_osdmap(got) == ref_codec.encode_osdmap(ref)
    _assert_same_placement(ref, got, scalar_pgs=range(0, 64, 9))
    # a resize (the incremental grows the arrays)
    rinc.new_max_osd = pinc.new_max_osd = 40
    assert pinc.encode() == rinc.encode()
    assert map_codec.encode_osdmap(pinc.apply(pprev)) == \
        ref_codec.encode_osdmap(rinc.apply(rprev))


def test_types_bytes_equal_reference():
    def enc(obj, mod_encoder):
        e = mod_encoder()
        obj.encode(e)
        return e.bytes()

    for mod, E in ((ref_types, RefEncoder), (types, Encoder)):
        v = mod.EVersion(4, 17)
        objs = [
            v,
            mod.LogEntry(mod.LOG_MODIFY, "obj-a", v, mod.EVersion(4, 16),
                         mtime=1.25, payload=b"\x01\x02", reqid="c.1:7"),
            mod.PGInfo((2, 5), v, mod.EVersion(4, 15), mod.EVersion(1, 1),
                       7, mod.EVersion(4, 12)),
            mod.PGStat((2, 5), "active+clean", True, 42, 4096, 9, 1, 2, 3,
                       v, 5, 6, 7, 8, 9, 10, 1.5, 2.5, 1),
            mod.OSDOp(mod.OP_WRITEFULL, 0, 3, b"abc", "x", {"k": b"v"},
                      ["a"], b"out", {"o": b"p"}, -2),
        ]
        blobs = [enc(o, E) for o in objs]
        e = E()
        objs[-1].encode_reply(e)
        blobs.append(e.bytes())
        if mod is ref_types:
            want = blobs
    assert blobs == want
    assert types.pgid_str((3, 255)) == ref_types.pgid_str((3, 255))
    assert types.WRITE_OPS == ref_types.WRITE_OPS


def _move_pair():
    ref, port = _flat_map(48, 12, [(1, 1, 3, 256), (2, 3, 6, 64)])
    for m in (ref, port):
        for osd in range(4):
            m.reweight_osd(osd, 0x18000)
    return ref, port


def test_upmap_balancer_moves_equal_reference():
    ref, port = _move_pair()
    rr = ref_balancer.UpmapBalancer(ref, max_deviation=0.5, max_moves=16)
    pr = balancer.UpmapBalancer(port, max_deviation=0.5, max_moves=16)
    assert pr.domain_of == rr.domain_of
    want, got = rr.optimize(), pr.optimize()
    assert [r.moves for r in got] == [r.moves for r in want]
    assert any(r.moves for r in got)
    assert [(r.pool_id, r.before_stddev, r.after_stddev) for r in got] == \
        [(r.pool_id, r.before_stddev, r.after_stddev) for r in want]
    assert map_codec.encode_osdmap(port) == ref_codec.encode_osdmap(ref)


def test_crush_compat_weights_equal_reference():
    ref, port = _flat_map(16, 4, [(1, 1, 3, 64)])
    want = ref_balancer.CrushCompatBalancer(
        ref, step=0.3, max_iterations=2).optimize([1])
    got = balancer.CrushCompatBalancer(
        port, step=0.3, max_iterations=2).optimize([1])
    assert (got.before_stddev, got.after_stddev, got.moves) == \
        (want.before_stddev, want.after_stddev, want.moves)
    assert port.crush.choose_args == ref.crush.choose_args
    assert map_codec.encode_osdmap(port) == ref_codec.encode_osdmap(ref)


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = fn(argv)
    return rc, buf.getvalue()


def test_osdmaptool_json_equals_reference(tmp_path):
    pf, rf = str(tmp_path / "port.bin"), str(tmp_path / "ref.bin")
    rc, _ = _run(osdmaptool.main, ["--createsimple", "24", "--pg_num", "128",
                                   "-o", pf, "--device", "cpu"])
    rrc, _ = _run(ref_osdmaptool.main, ["--createsimple", "24", "--pg_num",
                                        "128", "-o", rf])
    assert rc == rrc == 0
    assert open(pf, "rb").read() == open(rf, "rb").read()
    for extra in (["--test-map-pgs"], ["--test-map-pgs", "--pool", "1"],
                  ["--upmap", "--upmap-max", "16", "--upmap-deviation",
                   "0.5"]):
        rc, text = _run(osdmaptool.main, [pf] + extra + ["--device", "cpu"])
        rrc, rtext = _run(ref_osdmaptool.main, [rf] + extra)
        assert rc == rrc == 0
        assert json.loads(text) == json.loads(rtext), extra
