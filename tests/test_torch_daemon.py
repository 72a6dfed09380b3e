"""The port's OSD daemon (``ceph_tpu_torch/osd/daemon.py``) on the CPU,
case for case against the reference's daemon cases:

- ``test_core.py:315`` (the ``osd.N bench`` admin command);
- ``test_failpoints.py:177`` (``_apply_fault_conf``'s conf hooks);
- ``test_scrub_engine.py:297`` (the scrub as a qos tenant of the
  daemon's workqueue) and ``:309`` (the scrub scheduler finds silent rot
  with a deep pass), over ``torch_daemon_harness.DaemonCluster``;
- ``test_recovery_resume.py:81`` (a chunked recovery push interrupted
  mid-object resumes from its persisted progress);

and the port's own rules: ``OSDService`` without ``device=`` raises
when there is no card, its admin commands answer, and the standalone
mclock scheduler, the scrub's cost unit and the boot warmup are the
ported modules.
"""

import threading
import time

import numpy as np
import pytest
import torch

import torch_daemon_harness as H
from ceph_tpu_torch.core.admin_socket import admin_command
from ceph_tpu_torch.core.context import Context
from ceph_tpu_torch.ec import codec_from_profile
from ceph_tpu_torch.gpu import shapebucket as sb
from ceph_tpu_torch.osd import messages as m
from ceph_tpu_torch.osd import types as t_
from ceph_tpu_torch.osd.daemon import OSDService
from ceph_tpu_torch.store.memstore import MemStore
from ceph_tpu_torch.store.objectstore import Collection, GHObject

PORT = "ceph_tpu_torch"


def test_osd_bench_admin_command(tmp_path):
    """`ceph daemon osd.N bench` role (reference OSD::bench): raw
    objectstore write throughput over the admin socket."""
    sock = str(tmp_path / "osd.asok")
    ctx = Context("osd.7", {"admin_socket": sock})
    svc = OSDService(ctx, 7, MemStore(), None, codec_from_profile,
                     device="cpu")
    svc.store.mkfs()
    svc.init()
    try:
        out = admin_command(sock, "osd.7 bench",
                            count=1 << 20, bsize=1 << 16)
        assert out["bytes_written"] == 1 << 20
        assert out["blocksize"] == 1 << 16
        assert out["bytes_per_sec"] > 0
        helped = admin_command(sock, "help")
        for cmd in ("bench", "dump_ops_in_flight", "dump_historic_ops",
                    "dump_historic_slow_ops", "qos status", "dump_scrubs",
                    "device warmup"):
            assert f"osd.7 {cmd}" in helped, cmd
        st = admin_command(sock, "osd.7 qos status")
        assert st["scheduler"] == "mclock" and "client" in st["classes"]
        # no map yet: every warmup item waits for one (the CRC's shard
        # count and the codec come from the map's EC pool)
        wu = admin_command(sock, "osd.7 device warmup", budget=5)
        assert wu["families_warmed"] == [] and wu["buckets_warmed"] == 0
        assert wu["pending"] == 3 * len(sb.WARM_COLS) + 1
        assert not wu["done"]
        perf = admin_command(sock, "perf dump")
        assert "launches_gf256_matmul" in perf["osd.7.xla"]
        assert perf["osd.7.tpu"]["h2d_bytes"] >= 0
    finally:
        svc.shutdown()
        if ctx.admin is not None:
            ctx.admin.stop()


def test_filestore_conf_plumbs_to_store():
    """OSDService.init applies filestore_debug_inject_read_err to its
    store and observes runtime toggles."""
    ctx = Context("osd.fptest",
                  overrides={"filestore_debug_inject_read_err": True})
    svc = OSDService.__new__(OSDService)  # only the conf hook matters

    class _St:
        debug_read_err_enabled = False

    svc.ctx = ctx
    svc.store = _St()
    svc._log = lambda lvl, msg: None
    svc._apply_fault_conf()
    assert svc.store.debug_read_err_enabled is True
    ctx.conf.set_val("filestore_debug_inject_read_err", False)
    assert svc.store.debug_read_err_enabled is False
    ctx.conf.set_val("store_debug_inject_data_err", True)
    assert svc.store.debug_data_err_enabled is True


def test_daemon_without_a_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ctx = Context("osd.nodev")
    with pytest.raises(RuntimeError, match="CUDA"):
        OSDService(ctx, 0, MemStore(), None, codec_from_profile)
    with pytest.raises(RuntimeError, match="CUDA"):
        OSDService(ctx, 0, MemStore(), None, codec_from_profile,
                   device="cuda")
    # naming the CPU is the one way to run there; nothing started
    svc = OSDService(ctx, 0, MemStore(), None, codec_from_profile,
                     device="cpu")
    assert svc.device.type == "cpu" and svc._dq.device.type == "cpu"
    assert not svc.up


def test_boot_warmup_launches_every_bucket_before_serving():
    """tpu_boot_warmup: init runs DeviceWarmup over the map's EC codec
    and every pool's rule before the messenger starts, on the daemon's
    device (the plain versions on the CPU)."""
    from ceph_tpu_torch.gpu import shapebucket as sb
    from ceph_tpu_torch.ops import _build

    M = H.mods(PORT)
    osdmap = H.build_map(M, {"device": "cpu"})
    ctx = Context("osd.warm", {"tpu_boot_warmup": True})
    svc = OSDService(ctx, 0, MemStore(), osdmap, codec_from_profile,
                     device="cpu")
    svc.store.mkfs()
    before = {c.name: c.value for c in _build.COUNTS}
    started = []
    real_start = svc.msgr.start
    svc.msgr.start = lambda: (started.append(svc._warmup.stats()),
                              real_start())
    svc.init()
    try:
        st = started[0]
        assert st["done"] and not st["skipped"], st
        assert st["families_warmed"] == ["crc32c_rows", "crush_rule",
                                         "dec", "enc"]
        assert st["buckets_warmed"] == 3 * len(sb.WARM_COLS) + 1
        after = {c.name: c.value for c in _build.COUNTS}
        # the CPU runs each kernel's plain version: the counts move only
        # on the card (tests/test_torch_cuda.py -k daemon)
        assert after == before
        assert set(sb.declared_families()) >= {"enc", "encp", "dec",
                                               "crc32c_rows", "crush_rule"}
    finally:
        svc.shutdown()


# -- the scrub engine under the daemon (test_scrub_engine.py) --------------

def _pg_of(c, pool, oid):
    pgid, acting, primary = c.primary_of(pool, oid)
    return pgid, acting, primary, c.osds[primary].pgs[pgid]


@pytest.fixture(scope="module")
def cluster():
    c = H.DaemonCluster(PORT)
    yield c
    c.shutdown()


def test_scrub_is_a_qos_tenant(cluster):
    """Scrub chunk reads are charged to the mclock scrub class
    (cost-tagged admission through the shard workqueue)."""
    assert cluster.put(H.EC_POOL, "qos_scrub", b"q" * 4096).result == 0
    _pgid, _a, primary, pg = _pg_of(cluster, H.EC_POOL, "qos_scrub")
    qd0 = cluster.osds[primary].qos.perf.dump()
    assert pg.scrub_engine().run(deep=True) == {}
    qd = cluster.osds[primary].qos.perf.dump()
    assert qd.get("admitted_scrub", 0) > qd0.get("admitted_scrub", 0)
    assert isinstance(qd.get("wait_us_scrub"), dict)
    # the client write before it rode the client class on the primary
    assert qd.get("admitted_client", 0) >= 1


def test_scheduled_scrub_runs_deep_first():
    """The always-on scheduler: a never-deep-scrubbed PG runs the
    byte-verifying deep pass first (osd_deep_scrub_interval), catching
    silent data rot."""
    c = H.DaemonCluster(PORT)
    try:
        assert c.put(H.EC_POOL, "sched_rot", b"fresh" * 400).result == 0
        pgid, acting, primary, pg = _pg_of(c, H.EC_POOL, "sched_rot")
        shard = next(s for s, o in enumerate(acting)
                     if o != primary and 0 <= o < H.N_OSDS)
        victim = acting[shard]
        c.ctx.conf.set_val("store_debug_inject_data_err", True)
        c.osds[victim].store.debug_inject_data_err(
            Collection(t_.pgid_str(pgid) + "_head"),
            GHObject("sched_rot", shard=shard))
        hits = []
        ev = threading.Event()
        psvc = c.osds[primary]
        psvc.ctx.log.cluster_cb = lambda lvl, msg: (
            hits.append((lvl, msg)),
            ev.set() if "sched_rot" in msg else None)
        psvc.start_scrub_scheduler(interval=0.2)
        assert ev.wait(timeout=30.0), "deep scrub never found the rot"
        assert any(lvl == "ERR" and "deep-scrub" in msg
                   for lvl, msg in hits), hits
        assert pg.scrub_errors >= 1
        assert psvc.dump_scrubs()["scrubs"]
    finally:
        c.ctx.conf.set_val("store_debug_inject_data_err", False)
        c.shutdown()


# -- chunked recovery resume (test_recovery_resume.py:81) -------------------

CHUNK = 4096


def _small_map(M, dev, n_osds):
    P = M.osdmap
    cm, root = M.cmap.build_flat_cluster(n_osds, hosts=n_osds)
    cm.add_simple_rule("replicated", root, 1, mode="firstn")
    osdmap = P.OSDMap(cm, max_osd=n_osds, **dev)
    osdmap.add_pool(P.PGPool(1, P.POOL_REPLICATED, size=2, min_size=1,
                             pg_num=4, pgp_num=4, crush_rule=0))
    return osdmap


def test_chunked_push_and_resume():
    """Interrupt a multi-chunk recovery push mid-object; the retry
    resumes from persisted progress instead of byte 0."""
    cluster = H.DaemonCluster(PORT, {"osd_recovery_chunk_size": CHUNK,
                                     "osd_recovery_max_active": 1},
                              n_osds=3, map_fn=_small_map)
    try:
        rng = np.random.default_rng(0)
        data = rng.integers(0, 256, size=10 * CHUNK,
                            dtype=np.uint8).tobytes()
        assert cluster.put(1, "big", data).result == 0
        pgid, acting, primary = cluster.primary_of(1, "big")
        victim = next(o for o in acting if o != primary)

        cluster.kill(victim)
        data2 = rng.integers(0, 256, size=10 * CHUNK,
                             dtype=np.uint8).tobytes()
        assert cluster.put(1, "big", data2).result == 0  # victim lags

        osd = cluster.osds[primary]
        orig_rpc = osd.rpc
        pushed = {"n": 0, "bytes": 0}

        def flaky_rpc(peers_msgs, timeout=10.0):
            kept = []
            for osd_id, msg in peers_msgs:
                if isinstance(msg, m.MPGPush) and not msg.deleted:
                    if pushed["n"] >= 3:
                        continue  # dropped: peer "died" mid-recovery
                    pushed["n"] += 1
                    pushed["bytes"] += len(msg.data)
                kept.append((osd_id, msg))
            return orig_rpc(kept, timeout=min(timeout, 3.0)) if kept else []

        osd.rpc = flaky_rpc
        try:
            cluster.revive(victim)  # recovery starts, gets interrupted
            time.sleep(0.5)
        finally:
            osd.rpc = orig_rpc

        coll = Collection(t_.pgid_str(pgid) + "_head")
        vstore = cluster.osds[victim].store
        blob = vstore.getattr(coll, GHObject("big"), "_rprogress")
        assert blob, "no persisted recovery progress"
        assert vstore.read(coll, GHObject("big")) != data2

        resumed = {"offs": [], "bytes": 0}

        def spy_rpc(peers_msgs, timeout=10.0):
            for osd_id, msg in peers_msgs:
                if isinstance(msg, m.MPGPush) and not msg.deleted:
                    resumed["offs"].append(msg.off)
                    resumed["bytes"] += len(msg.data)
            return orig_rpc(peers_msgs, timeout)

        osd.rpc = spy_rpc
        cluster.refresh()
        cluster.activate()
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            if vstore.read(coll, GHObject("big")) == data2:
                break
            time.sleep(0.2)
        assert vstore.read(coll, GHObject("big")) == data2
        assert resumed["offs"] and min(resumed["offs"]) > 0, \
            f"resume restarted from 0 (offs={resumed['offs'][:5]})"
        assert resumed["bytes"] < len(data2), "resume re-sent the whole"
        try:
            left = vstore.getattr(coll, GHObject("big"), "_rprogress")
        except Exception:
            left = None
        assert not left
    finally:
        cluster.shutdown()


# -- the shape-bucket declarations against ceph_tpu -------------------------

@pytest.mark.parametrize("kw", [{}, {"small_max": 8, "odd_max": 3},
                                {"free_args": (1,), "ceiling": 1 << 12}])
def test_bucket_grammar_matches_the_reference(kw):
    """BucketSpec's declared surface (the dims and signatures it admits)
    equals the reference's for the same parameters, and an undeclared
    family declares nothing in either."""
    from ceph_tpu.tpu import shapebucket as ref_sb
    from ceph_tpu_torch.gpu import shapebucket as sb

    mine, ref = sb.BucketSpec("x", **kw), ref_sb.BucketSpec("x", **kw)
    for d in [0, 1, 3, 7, 8, 9, 63, 64, 65, 96, 127, 128, 192, 4096, 4097,
              5 * 1024, 63 << 10, 65 << 10, 1 << 12, (1 << 12) + 1,
              1 << 26, (1 << 26) + 2]:
        assert mine.dim_declared(d) == ref.dim_declared(d), d
    sigs = [(("arr", "uint8", (8, 4096)),),
            (("arr", "uint8", (8, 4097)), ("arr", "int32", (1000,))),
            (("arr", "int32", (3,)), ("arr", "uint32", (997,))),
            (("tile", (("arr", "uint8", (12, 65 << 10)),)),),
            (("static", 5), ("arr", "uint8", None)),
            (("arr", "uint8", (8, 1 << 16)), ("k", ("arr", "u8", (99,))))]
    for sig in sigs:
        assert mine.sig_declared(sig) == ref.sig_declared(sig), sig
    assert not sb.sig_declared("no-such-family", sigs[0])
    assert not ref_sb.sig_declared("no-such-family", sigs[0])
    assert sb.covering(5000, 3, 64) == ref_sb.covering(5000, 3, 64)
