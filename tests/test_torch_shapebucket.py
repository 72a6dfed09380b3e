"""``tests/test_shapebucket.py`` mirrored on the port's shape-bucket ABI
(``ceph_tpu_torch/gpu/shapebucket.py``) and device watch, case for case,
on the CPU: covering buckets, the declared/rogue grammar, the compile
classification of first launches (warmup, bucketed-cold, rogue), the
tight rogue storm threshold, ``DeviceWarmup`` (budgeted, resumable,
waiting for its codec), the warmed write path under the steady-state
guard, bucketed batches bit for bit, and a ``VStartCluster`` with the
boot warmup raising no storm and writing and reading under the guard.

The reference's ``instrumented_jit`` families are functions launched
through the port's ``devwatch.instrumented_launch``.  Stand-ins:
``:82`` holds the buckets the queue produces against the K1 family the
port declares (``gf256_matmul``; the reference's ``gf256_swar``), and
``:270`` holds ``setup_compile_cache`` to the port's contract (it
records the directory and answers False: there is no XLA cache, the
kernel build in ``ceph_tpu_torch/_build/`` is its counterpart).  The
``slow`` cross-process cache case (``:294``) is not mirrored.

An autouse fixture fails a test that leaves the port's
``GUARD_VIOLATIONS`` non-empty (the reference conftest's check).
"""

import numpy as np
import pytest
import torch

from ceph_tpu_torch.gpu import shapebucket
from ceph_tpu_torch.gpu.devwatch import GUARD_VIOLATIONS, signature, watch
from ceph_tpu_torch.gpu.shapebucket import (
    BucketSpec, DeviceWarmup, covering, odd_part, round_up_pow2,
)

from test_torch_devwatch import (StubLog, _guard, _launcher,  # noqa: F401
                                 _queue, dw)


@pytest.fixture
def fam_registry():
    """Temporarily extend the family registry; restore on exit."""
    saved = dict(shapebucket._REGISTRY)
    yield shapebucket._REGISTRY
    shapebucket._REGISTRY.clear()
    shapebucket._REGISTRY.update(saved)


def _codec(profile="plugin=isa k=2 m=1 technique=reed_sol_van"):
    from ceph_tpu_torch.ec import codec_from_profile

    return codec_from_profile(profile, device="cpu")


# -- covering bucket math ----------------------------------------------------

def test_covering_properties():
    assert round_up_pow2(1) == 1
    assert round_up_pow2(5) == 8
    assert odd_part(0) == 0
    assert odd_part(96) == 3
    for n in (1, 2, 3, 63, 64, 65, 1000, 4096, 4097, 99999):
        for gran in (1, 3, 8):
            c = covering(n, gran)
            assert c >= n and c % gran == 0
            assert c == covering(c, gran), "covering must be idempotent"
            assert BucketSpec("x").dim_declared(c) or c > (1 << 26)
    assert covering(3, 1, floor=64) == 64
    assert covering(4097, 8) == 8 * 1024


def test_sig_declared_grammar(fam_registry):
    shapebucket.declare("t_gram", free_args=(1,))
    ok = signature((torch.zeros((2, 4096), dtype=torch.uint8),), {})
    assert shapebucket.sig_declared("t_gram", ok)
    assert shapebucket.sig_declared(
        "t_gram", signature((torch.zeros((8, 64), dtype=torch.uint8),),
                            {}))
    rogue = signature((torch.zeros((2, 4097), dtype=torch.uint8),), {})
    assert not shapebucket.sig_declared("t_gram", rogue)
    # free_args positions are map-scoped: any dim passes there
    free = signature((torch.zeros(128, dtype=torch.int32),
                      np.zeros(1237, np.uint32)), {})
    assert shapebucket.sig_declared("t_gram", free)
    # ...but only at the declared position
    swapped = signature((np.zeros(1237, np.uint32),), {})
    assert not shapebucket.sig_declared("t_gram", swapped)
    assert not shapebucket.sig_declared("t_unknown_fam", ok)


def test_every_queue_bucket_is_declared():
    """The widths the queue pads its batches to lie inside K1's declared
    surface (stands in for the reference's ``gf256_swar`` spec)."""
    spec = shapebucket.get_spec("gf256_matmul")
    for n in range(1, 300000, 7919):
        for gran in (1, 2, 8):
            assert spec.dim_declared(covering(n, gran))
    for fam in ("gf256_matmul", "gf256_interleaved", "crc32c_rows",
                "crush_rule", "gf2_matmul", "gf2_xor", "mesh_digest",
                "kernel_build"):
        assert shapebucket.get_spec(fam) is not None, fam


# -- devwatch classification -------------------------------------------------

def test_compile_classification_warmup_cold_rogue(dw, fam_registry):  # noqa: F811
    shapebucket.declare("t_klass")
    f = _launcher("t_klass", lambda x: x * 2)
    base = dw.family_stats("t_klass")
    with dw.warmup_scope():
        f(torch.zeros(128, dtype=torch.int32))   # declared, in warmup
    f(torch.zeros(256, dtype=torch.int32))       # declared, cold
    f(torch.zeros(257, dtype=torch.int32))       # 257: odd > 63, rogue
    st = dw.family_stats("t_klass")
    assert st["warmup"] - base["warmup"] == 1
    assert st["cold"] - base["cold"] == 1
    assert st["rogue"] - base["rogue"] == 1
    assert dw.perf.value("rogue_compiles") >= 1
    tot = dw.compile_totals()
    assert {"compiles", "compile_seconds", "rogue", "warmup",
            "persist_hits"} <= set(tot)
    fams = dw.dump()["families"]["t_klass"]
    assert fams["rogue"] == st["rogue"]


def test_steady_guard_names_the_class(dw, fam_registry):  # noqa: F811
    shapebucket.declare("t_guard_cls")
    f = _launcher("t_guard_cls", lambda x: x + 1)
    with dw.steady_state():
        f(torch.zeros(515, dtype=torch.int32))  # rogue AND in-steady
    assert len(GUARD_VIOLATIONS) == 1
    assert "class=rogue" in GUARD_VIOLATIONS[0]
    GUARD_VIOLATIONS.clear()


# -- storm thresholds: rogue trips tight, declared ladders don't -------------

def test_rogue_storm_trips_at_tight_threshold(dw):  # noqa: F811
    log = StubLog()
    dw.attach_log(log)
    f = _launcher("t_rogue_storm", lambda x: x - 1)
    for n in (70, 74, 78):  # undeclared family: every sig is rogue
        f(torch.zeros(n, dtype=torch.int32))
    warns = [m for _l, m in log.cluster_msgs if "RECOMPILE_STORM" in m]
    assert warns and "undeclared (rogue)" in warns[0]
    storm = dw.dump()["storms"][-1]
    assert storm["family"] == "t_rogue_storm"
    assert storm["kind"] == "rogue"
    assert storm["rogue_signatures"] == 3


def test_declared_cold_ladder_is_not_a_storm(dw, fam_registry):  # noqa: F811
    shapebucket.declare("t_ladder")
    log = StubLog()
    dw.attach_log(log)
    f = _launcher("t_ladder", lambda x: x ^ 3)
    for n in (128, 256, 512, 1024):  # a declared ladder
        f(torch.zeros(n, dtype=torch.int32))
    assert not [m for _l, m in log.cluster_msgs if "t_ladder" in m]


# -- DeviceWarmup: budget, resume, steady-state handoff ----------------------

def test_warmup_budget_exhaustion_resumes_on_demand(dw):  # noqa: F811
    w = DeviceWarmup(_codec(), cols=(4096,))
    st = w.run(budget_s=0.0)  # budget gone before the first item
    assert st["pending"] > 0 and not st["done"]
    assert any("(budget)" in s for s in st["skipped"])
    st2 = w.run(budget_s=60.0)  # the admin-command resume
    assert st2["done"] and st2["pending"] == 0
    assert st2["runs"] == 2
    assert "crc32c_rows" in st2["families_warmed"]
    assert watch().warmup_stats["done"]


def test_warmup_codec_items_wait_for_provider(dw):  # noqa: F811
    holder = {"codec": None}
    w = DeviceWarmup(codec_fn=lambda: holder["codec"], cols=(4096,),
                     device="cpu")
    st = w.run(budget_s=60.0)
    assert st["pending"] > 0 and not st["done"]
    assert any("not ready" in s for s in st["skipped"])
    holder["codec"] = _codec()
    st2 = w.run(budget_s=60.0)
    assert st2["done"], st2
    assert any(s.startswith("enc") for s in st2["warmed"])


def test_warmed_write_path_is_steady(dw):  # noqa: F811
    codec = _codec()
    w = DeviceWarmup(codec, cols=(4096,))
    st = w.run(budget_s=120.0)
    assert st["done"], st
    q = _queue()
    try:
        rng = np.random.default_rng(7)
        planes = rng.integers(0, 256, (2, 4096), np.uint8)
        with dw.steady_state():
            q.encode(codec, planes)
            q.encode_crc_async(codec, planes, size=8192).result(30.0)
            coding = q.encode(codec, planes)
            avail = {1: planes[1], 2: coding[0]}
            q.decode_data(codec, avail)
        assert not GUARD_VIOLATIONS, GUARD_VIOLATIONS
    finally:
        q.stop()


# -- bucketed dispatch is bit-identical --------------------------------------

def test_bucketed_batch_bit_identical_to_unpadded():
    from ceph_tpu_torch.core.crc import crc32c

    codec = _codec()
    rng = np.random.default_rng(17)
    q = _queue()
    try:
        for width in (100, 1337, 5000):
            planes = rng.integers(0, 256, (codec.k, width), np.uint8)
            want = np.asarray(codec.encode_array(planes.copy()))
            got = q.encode(codec, planes)
            assert got.shape == want.shape
            assert np.array_equal(got, want), f"width={width}"
            coding2, crcs = q.encode_crc_async(
                codec, planes, size=planes.nbytes).result(30.0)
            assert np.array_equal(coding2, want)
            shards = np.concatenate([planes, want], axis=0)
            host = [crc32c(bytes(shards[s])) for s in
                    range(codec.k + codec.m)]
            assert list(map(int, crcs)) == host, f"width={width}"
            avail = {1: planes[1], codec.k: want[0]}
            data = q.decode_data(codec, avail)
            assert np.array_equal(data, planes), f"width={width}"
    finally:
        q.stop()


# -- vstart boot warmup: zero storms, steady cluster ops ---------------------

def test_vstart_boot_warmup_no_storms_and_steady_ops(dw, tmp_path):  # noqa: F811
    from ceph_tpu_torch.vstart import VStartCluster

    log = StubLog()
    dw.attach_log(log)
    storms0 = len(dw.dump()["storms"])
    with VStartCluster(n_mons=1, n_osds=3, warmup=True,
                       conf={"tpu_warmup_budget_s": 120.0},
                       device="cpu") as c:
        # the daemons attached their own log; the stub goes back on
        dw.attach_log(log)
        pool = c.create_pool("wb", size=3, pool_type="erasure",
                             ec_profile="plugin=isa k=2 m=1 "
                                        "technique=reed_sol_van")
        for o in c.osds.values():
            assert o._warmup is not None, "boot warmup never ran"
        io = c.client().ioctx(pool)
        payload = bytes(range(256)) * 32  # 8 KiB
        with dw.steady_state():
            io.write_full("warmed", payload)
            assert io.read("warmed") == payload
        assert not GUARD_VIOLATIONS, GUARD_VIOLATIONS
    assert len(dw.dump()["storms"]) == storms0, dw.dump()["storms"]
    warns = [m for _l, m in log.cluster_msgs if "RECOMPILE_STORM" in m]
    assert not warns, warns


# -- the reference's persistent compile cache --------------------------------

def test_setup_compile_cache_idempotent(tmp_path):
    """The port's contract: the directory is recorded, no cache is set
    up (False), an empty path clears it."""
    d = str(tmp_path / "xc")
    assert not shapebucket.setup_compile_cache(d)
    assert shapebucket.compile_cache_dir() == d
    assert not shapebucket.setup_compile_cache(d)  # second call: the same
    assert shapebucket.compile_cache_dir() == d
    assert not shapebucket.setup_compile_cache("")  # empty clears it
    assert shapebucket.compile_cache_dir() is None
