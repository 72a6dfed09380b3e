"""The port's balancers on the CPU (``device="cpu"``): the six cases of
tests/test_balancer.py, case for case — upmap full-sweep deviation
optimization with entries riding the real OSDMap pipeline (reference:
src/pybind/mgr/balancer/module.py:644, src/osd/OSDMap.cc:2228) and the
crush-compat weight set.  The reference marks two cases slow for their
JAX compiles; the port's plain walk compiles nothing, and they run in
seconds here, so neither is marked.  Bit-equality of the moves with
ceph_tpu is held in tests/test_torch_osdmap_xcheck.py."""


from ceph_tpu_torch.crush import map as cmap
from ceph_tpu_torch.mgr import UpmapBalancer
from ceph_tpu_torch.mgr.balancer import CrushCompatBalancer
from ceph_tpu_torch.osd import map_codec
from ceph_tpu_torch.osd.osdmap import (
    CRUSH_ITEM_NONE,
    OSDMap,
    PGPool,
    POOL_REPLICATED,
)


def build_map(n_osds=64, hosts=16, pg_num=256):
    cm, root = cmap.build_flat_cluster(n_osds, hosts=hosts)
    cm.add_simple_rule("r", root, 1, mode="firstn")
    m = OSDMap(cm, max_osd=n_osds, device="cpu")
    m.add_pool(PGPool(1, POOL_REPLICATED, size=3, min_size=2,
                      pg_num=pg_num, pgp_num=pg_num, crush_rule=0))
    return m


def test_balancer_reduces_stddev():
    m = build_map()
    bal = UpmapBalancer(m, max_deviation=0.5, max_moves=48)
    (rep,) = bal.optimize([1])
    assert rep.moves, "natural CRUSH variance should yield moves"
    assert rep.after_stddev < rep.before_stddev, (
        f"stddev {rep.before_stddev:.2f} -> {rep.after_stddev:.2f}"
    )


def test_moves_respect_failure_domain():
    m = build_map()
    bal = UpmapBalancer(m, max_deviation=0.5, max_moves=32)
    (rep,) = bal.optimize([1])
    assert rep.moves
    for pgid, _pairs in rep.moves:
        _, _, acting, _ = m.pg_to_up_acting(pgid)
        osds = [o for o in acting if o >= 0 and o != CRUSH_ITEM_NONE]
        doms = [bal.domain_of[o] for o in osds]
        assert len(set(doms)) == len(doms), (
            f"pg {pgid}: two replicas share a host ({osds})"
        )


def test_upmap_entries_roundtrip_through_pipeline():
    m = build_map()
    bal = UpmapBalancer(m, max_deviation=0.5, max_moves=16)
    (rep,) = bal.optimize([1])
    assert rep.moves
    pgid, pairs = rep.moves[0]
    # scalar pipeline honors the entry
    _, _, acting, _ = m.pg_to_up_acting(pgid)
    for frm, to in pairs:
        assert frm not in acting and to in acting
    # vectorized sweep agrees with the scalar path
    sweep = m.map_pgs(1)
    row = [o for o in sweep["up"][pgid[1]] if o != CRUSH_ITEM_NONE]
    assert row == [o for o in acting if o != CRUSH_ITEM_NONE]
    # survives the map codec (mon distribution)
    m2 = map_codec.decode_osdmap(map_codec.encode_osdmap(m), device="cpu")
    assert m2.pg_upmap_items[pgid] == m.pg_upmap_items[pgid]
    assert m2.pg_to_up_acting(pgid) == m.pg_to_up_acting(pgid)


def test_balancer_large_skewed_map():
    """The VERDICT target shape: a skewed 1024-OSD map improves in one
    optimizer run driven by the device sweep."""
    m = build_map(n_osds=1024, hosts=64, pg_num=1024)
    # skew: one host's osds carry double weight
    for osd in range(16):
        m.reweight_osd(osd, 0x20000)
    bal = UpmapBalancer(m, max_deviation=1.0, max_moves=32)
    (rep,) = bal.optimize([1])
    assert rep.after_stddev <= rep.before_stddev
    assert rep.moves


def test_crush_compat_reduces_stddev_via_choose_args_only():
    """crush-compat mode (reference balancer module.py:17,68): the
    COMPAT weight-set alone evens PG counts — no upmap entries, no
    client-visible weight changes."""
    m = build_map()
    before_weights = {bid: list(b.weights)
                      for bid, b in m.crush.buckets.items()}
    bal = CrushCompatBalancer(m, step=0.3, max_iterations=10)
    rep = bal.optimize([1])
    assert rep.after_stddev < rep.before_stddev, (
        f"stddev {rep.before_stddev:.2f} -> {rep.after_stddev:.2f}")
    # ONLY choose_args changed
    assert not m.pg_upmap_items and not m.pg_upmap
    assert "-1" in m.crush.choose_args
    for bid, b in m.crush.buckets.items():
        assert list(b.weights) == before_weights[bid]


def test_crush_compat_scalar_and_sweep_agree():
    """The compat weight-set must flow through BOTH placement paths
    (the _flatten substitution feeds the native oracle and the
    vmapped sweep alike)."""
    m = build_map(n_osds=16, hosts=4, pg_num=64)
    CrushCompatBalancer(m, step=0.3, max_iterations=6).optimize([1])
    assert "-1" in m.crush.choose_args
    sweep = m.map_pgs(1)
    for pg in range(0, 64, 7):
        up, up_primary, _, _ = m.pg_to_up_acting((1, pg))
        row = [o for o in sweep["up"][pg]
               if o != CRUSH_ITEM_NONE]
        assert row == [o for o in up if o != CRUSH_ITEM_NONE], pg
