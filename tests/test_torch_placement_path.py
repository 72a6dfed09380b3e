"""The ``placement`` phase of chip_smoke.py (``run_placement``) on the
CPU at a small size: every step of the phase — both pools swept and held
against a decoded copy, the scalar path against the sweep, a host down
and out by an Incremental, both balancers and the tools — on the plain
walk, with its results held against ceph_tpu's placement of the same
map."""

import numpy as np
import torch

import chip_smoke
from ceph_tpu.crush import map as ref_cmap
from ceph_tpu.osd import map_codec as ref_codec
from ceph_tpu.osd import osdmap as ref_osdmap
from ceph_tpu_torch.osd import map_codec

SMALL = dict(n_osds=48, hosts=16, pools=(
    (1, "rbd", 1, 3, 2, 128, ""),
    (2, "ec84", 3, 12, 9, 32, "plugin=isa k=8 m=4 technique=reed_sol_van")),
    scalar=8, moves=6, compat_iters=2, tool_osds=16, tool_pg_num=64, reps=1)


def test_placement_phase_runs_on_the_plain_walk():
    res = chip_smoke.run_placement(torch, "cpu", **SMALL)
    assert res["launches"] == 0  # the plain walk launches no kernel
    assert set(res["sweep_ms"]) == {1, 2} and res["max_abs_err"] == 0
    assert 0 < res["moved_share"] < 1 and res["scalar_calls_per_s"] > 0
    for k in ("upmap_1", "upmap_2", "crush_compat_1"):
        b = res["balance"][k]
        assert b["after"] <= b["before"]
    assert res["balance"]["upmap_1"]["moves"] > 0
    assert res["tool"]["upmaps"] > 0


def test_placement_map_equals_reference_map():
    """The phase's map, built in both packages: the same bytes and the
    same rows for both pools."""
    port = chip_smoke.placement_map("cpu", 48, 16, SMALL["pools"])
    cm, root = ref_cmap.build_flat_cluster(48, hosts=16)
    ref = ref_osdmap.OSDMap(cm, max_osd=48)
    for pid, name, ptype, size, min_size, pg_num, profile in SMALL["pools"]:
        firstn = ptype == ref_osdmap.POOL_REPLICATED
        rid = cm.add_simple_rule(name, root, 1,
                                 mode="firstn" if firstn else "indep",
                                 num=0 if firstn else size)
        ref.add_pool(ref_osdmap.PGPool(
            pid, ptype, size=size, min_size=min_size, pg_num=pg_num,
            pgp_num=pg_num, crush_rule=rid, erasure_code_profile=profile,
            name=name))
    assert map_codec.encode_osdmap(port) == ref_codec.encode_osdmap(ref)
    for pid in (1, 2):
        got, want = port.map_pgs(pid), ref.map_pgs(pid)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
