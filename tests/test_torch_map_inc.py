"""The port's OSDMap incremental deltas on the CPU: the five cases of
tests/test_map_inc.py, case for case — diff/apply round trips, O(delta)
bytes, inc-vs-full consistency (reference OSDMap::Incremental,
src/osd/OSDMap.h; OSDMonitor pending_inc discipline) — plus the device
an applied or cloned map keeps."""

import numpy as np
import pytest

from ceph_tpu_torch.crush import map as cmap
from ceph_tpu_torch.osd import map_codec, map_inc
from ceph_tpu_torch.osd.osdmap import OSDMap, PGPool, POOL_REPLICATED


def build(n=64):
    cm, root = cmap.build_flat_cluster(n, hosts=8)
    cm.add_simple_rule("r", root, 1, mode="firstn")
    m = OSDMap(cm, max_osd=n, device="cpu")
    m.add_pool(PGPool(1, POOL_REPLICATED, size=3, min_size=2,
                      pg_num=64, pgp_num=64, crush_rule=0))
    for i in range(n):
        m.osd_addrs[i] = ("127.0.0.1", 7000 + i)
    return m


def assert_maps_equal(a: OSDMap, b: OSDMap, msg=""):
    assert map_codec.encode_osdmap(a) == map_codec.encode_osdmap(b), msg


def test_diff_apply_identity_on_mutations():
    m = build()
    rng = np.random.default_rng(0)
    cur = m
    for trial in range(12):
        prev = map_inc.clone_map(cur)
        kind = trial % 6
        if kind == 0:
            cur.set_osd_down(int(rng.integers(0, 64)))
        elif kind == 1:
            osd = int(rng.integers(0, 64))
            cur.set_osd_up(osd)
            cur.osd_addrs[osd] = ("127.0.0.1", 8000 + trial)
            cur.bump_epoch()
        elif kind == 2:
            cur.reweight_osd(int(rng.integers(0, 64)), 0x8000)
        elif kind == 3:
            cur.set_primary_affinity(int(rng.integers(0, 64)), 0x4000)
        elif kind == 4:
            cur.pg_upmap_items[(1, int(rng.integers(0, 64)))] = [(1, 2)]
            cur.bump_epoch()
        else:
            cur.pg_temp[(1, int(rng.integers(0, 64)))] = [3, 2, 1]
            cur.bump_epoch()
        inc = map_inc.diff_maps(prev, cur)
        applied = inc.apply(prev)
        assert_maps_equal(applied, cur, f"trial {trial} kind {kind}")
        # O(delta): each single mutation encodes to a tiny fraction of
        # the full map
        full = len(map_codec.encode_osdmap(cur))
        assert len(inc.encode()) < full // 4, (
            f"inc {len(inc.encode())}B vs full {full}B"
        )


def test_inc_chain_and_tags():
    m = build()
    e0 = map_inc.clone_map(m)
    m.set_osd_down(3)
    i1 = map_inc.diff_maps(e0, m)
    e1 = map_inc.clone_map(m)
    m.set_osd_out(3)
    m.reweight_osd(7, 0x2000)
    i2 = map_inc.diff_maps(e1, m)

    # committed-value framing
    v_full = map_inc.encode_full_value(e0)
    got = map_inc.decode_value(v_full, None, device="cpu")
    assert_maps_equal(got, e0)
    got = map_inc.decode_value(map_inc.encode_inc_value(i1), got)
    assert_maps_equal(got, e1)
    got = map_inc.decode_value(map_inc.encode_inc_value(i2), got)
    assert_maps_equal(got, m)

    # wrong base refuses
    with pytest.raises(map_inc.NeedFullMap):
        map_inc.decode_value(map_inc.encode_inc_value(i2), e0)


def test_crush_change_carries_crush_blob():
    m = build()
    prev = map_inc.clone_map(m)
    m.crush.reweight_item(list(m.crush.buckets)[0], 0, 0x20000)
    m.bump_epoch()
    inc = map_inc.diff_maps(prev, m)
    assert inc.crush, "crush change must ship the crush blob"
    applied = inc.apply(prev)
    assert_maps_equal(applied, m)
    # placement identical through the applied map
    pg = applied.object_to_pg(1, "obj")
    assert applied.pg_to_up_acting(pg) == m.pg_to_up_acting(pg)


def test_pool_and_removal_deltas():
    m = build()
    prev = map_inc.clone_map(m)
    m.add_pool(PGPool(2, POOL_REPLICATED, size=2, min_size=1,
                      pg_num=8, pgp_num=8, crush_rule=0))
    inc = map_inc.diff_maps(prev, m)
    assert 2 in inc.new_pools and not inc.removed_pools
    applied = inc.apply(prev)
    assert_maps_equal(applied, m)

    prev2 = map_inc.clone_map(m)
    del m.pools[2]
    m.bump_epoch()
    inc2 = map_inc.diff_maps(prev2, m)
    assert inc2.removed_pools == [2]
    assert_maps_equal(inc2.apply(prev2), m)


def test_entry_removal_roundtrip():
    m = build()
    m.pg_temp[(1, 5)] = [4, 5, 6]
    m.bump_epoch()
    prev = map_inc.clone_map(m)
    del m.pg_temp[(1, 5)]
    m.bump_epoch()
    inc = map_inc.diff_maps(prev, m)
    assert inc.new_pg_temp[(1, 5)] == []
    assert_maps_equal(inc.apply(prev), m)


def test_derived_maps_keep_their_base_device():
    m = build(16)
    prev = map_inc.clone_map(m)
    assert prev.device.type == "cpu"
    m.set_osd_down(2)
    applied = map_inc.diff_maps(prev, m).apply(prev)
    assert applied.device == prev.device
    got = map_inc.decode_value(map_inc.encode_inc_value(
        map_inc.diff_maps(prev, m)), prev)
    assert got.device == prev.device
    assert map_codec.decode_osdmap(map_codec.encode_osdmap(m),
                                   device="cpu").device.type == "cpu"
