"""The port's whole slice — stripe geometry, stripe-batch queue, staging,
counters, and the write and degraded-read round trips of isa, jerasure
cauchy_good and shec — held against ceph_tpu on the CPU, plus the port's
guards: it imports neither JAX nor ceph_tpu, and without CUDA an entry
point given no device raises instead of running on the CPU."""

import ast
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from ceph_tpu.core import perf as ref_perf
from ceph_tpu.core.crc import crc32c as ref_crc32c
from ceph_tpu.ec import codec_from_profile as ref_codec_from_profile
from ceph_tpu.osd.ecutil import StripeInfo as RefStripeInfo
from ceph_tpu.tpu import shapebucket as ref_shapebucket
from ceph_tpu.tpu.queue import StripeBatchQueue as RefQueue
from ceph_tpu_torch.core import perf
from ceph_tpu_torch.ec import codec_from_profile
from ceph_tpu_torch.gpu import shapebucket
from ceph_tpu_torch.gpu.queue import StripeBatchQueue
from ceph_tpu_torch.gpu.staging import DevPathStats, StagingPool
from ceph_tpu_torch.osd.ecutil import StripeInfo

REPO = Path(__file__).resolve().parent.parent
PROFILE = "plugin=isa k=4 m=2 technique=reed_sol_van"


def _objects(seed, count, chunk):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(1, 3 * 4 * chunk)),
                         dtype=np.uint8).tobytes() for _ in range(count)]


def _submit_all(fn, items, threads=4):
    """fn(item) from several threads at once, results in item order."""
    out = [None] * len(items)
    barrier = threading.Barrier(threads)

    def worker(t):
        barrier.wait(timeout=30)
        futs = [(i, fn(items[i])) for i in range(t, len(items), threads)]
        for i, f in futs:
            out[i] = f.result(timeout=60)

    ths = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in ths)
    return out


def test_write_and_degraded_read_match_reference_queue():
    chunk = 256
    port_codec = codec_from_profile(PROFILE, device="cpu")
    ref_codec = ref_codec_from_profile(PROFILE)
    si, rsi = StripeInfo(4, chunk), RefStripeInfo(4, chunk)
    objs = _objects(21, 24, chunk)
    planes = [si.interleave(o)[0] for o in objs]
    for o, p in zip(objs, planes):
        assert np.array_equal(p, rsi.interleave(o)[0])

    q = StripeBatchQueue(device="cpu", window_s=0.05)
    rq = RefQueue()
    try:
        got = _submit_all(lambda p: q.encode_crc_async(port_codec, p),
                          planes)
        want = [rq.encode_crc_async(ref_codec, p).result(timeout=60)
                for p in planes]
        for (c, crc), (rc, rcrc) in zip(got, want):
            assert np.array_equal(c, np.asarray(rc))
            assert crc.dtype == np.uint32 and np.array_equal(crc, rcrc)
        # concurrent submits coalesced into wider batches
        assert max(q.batch_jobs) > 1, q.batch_jobs
        assert q.jobs == len(objs)
        assert q.stats.snapshot()["h2d_bytes"] == sum(p.nbytes
                                                      for p in planes)

        survivors = [0, 2, 4, 5]  # two data shards lost
        avails = [{s: p[s] if s < 4 else c[s - 4] for s in survivors}
                  for p, (c, _) in zip(planes, got)]
        dec = _submit_all(lambda a: q.decode_data_async(port_codec, a),
                          avails)
        for o, a, d in zip(objs, avails, dec):
            rd = rq.decode_data_async(ref_codec, a).result(timeout=60)
            assert np.array_equal(d, np.asarray(rd))
            assert si.deinterleave(d, len(o)) == o
        assert max(q.dec_batch_jobs) > 1, q.dec_batch_jobs
        enc = q.encode_async(port_codec, planes[0]).result(timeout=60)
        assert np.array_equal(enc, got[0][0])
    finally:
        q.stop()
        rq.stop()


@pytest.mark.parametrize("widths", [[3072, 1536, 3072, 4608],
                                    [8 * 3001, 8 * 517, 8 * 12347]])
def test_bitmatrix_queue_codes_each_job_as_it_alone(widths):
    """Coalesced cauchy_good writes of non-power-of-two widths: each
    job's coding equals the reference BitmatrixCodec.encode_array of that
    job alone, and each CRC the reference crc32c of the stored shard."""
    prof = "plugin=jerasure k=4 m=2 technique=cauchy_good"
    port_codec = codec_from_profile(prof, device="cpu")
    ref_codec = ref_codec_from_profile(prof)
    rng = np.random.default_rng(len(widths))
    planes = [rng.integers(0, 256, (4, w), dtype=np.uint8) for w in widths]
    q = StripeBatchQueue(device="cpu", window_s=0.05)
    try:
        got = _submit_all(lambda p: q.encode_crc_async(port_codec, p),
                          planes, threads=len(planes))
        assert max(q.batch_jobs) > 1, q.batch_jobs
        for p, (coding, crcs) in zip(planes, got):
            want = np.asarray(ref_codec.encode_array(p))
            assert np.array_equal(coding, want)
            shards = list(p) + list(want)
            assert crcs.dtype == np.uint32
            assert list(crcs) == [ref_crc32c(s) for s in shards]
        enc = q.encode_async(port_codec, planes[1]).result(timeout=60)
        assert np.array_equal(enc, got[1][0])
        with pytest.raises(TypeError, match="codec.decode"):
            q.decode_data_async(port_codec, {i: planes[0][i]
                                             for i in range(4)})
    finally:
        q.stop()


@pytest.mark.parametrize("profile,lost", [
    ("plugin=jerasure k=4 m=2 technique=cauchy_good", (1, 4)),
    ("plugin=jerasure k=4 m=2 technique=cauchy_good", (0, 3)),
    ("plugin=shec k=8 m=4 c=3", (0, 1, 2)),
    ("plugin=shec k=4 m=3 c=2", (1, 5)),
])
def test_bitmatrix_and_shec_write_and_degraded_read(profile, lost):
    """The slice's new paths end to end at a small size: write through the
    queue (encode + CRC), read back degraded through codec.decode_array,
    both against the reference package."""
    port_codec = codec_from_profile(profile, device="cpu")
    ref_codec = ref_codec_from_profile(profile)
    k, m = port_codec.k, port_codec.m
    chunk = port_codec.get_chunk_size(k * 1024)
    assert chunk == ref_codec.get_chunk_size(k * 1024)
    si, rsi = StripeInfo(k, chunk), RefStripeInfo(k, chunk)
    objs = _objects(len(profile), 6, chunk)
    planes = [si.interleave(o)[0] for o in objs]
    q = StripeBatchQueue(device="cpu", window_s=0.05)
    rq = RefQueue()
    try:
        got = _submit_all(lambda p: q.encode_crc_async(port_codec, p),
                          planes, threads=3)
        for o, p, (c, crc) in zip(objs, planes, got):
            assert np.array_equal(p, rsi.interleave(o)[0])
            assert np.array_equal(c, np.asarray(ref_codec.encode_array(p)))
            assert list(crc) == [ref_crc32c(s) for s in list(p) + list(c)]
            if "shec" in profile:  # flat code: the reference queue agrees
                rc, rcrc = rq.encode_crc_async(ref_codec, p).result(60)
                assert np.array_equal(c, np.asarray(rc))
                assert np.array_equal(crc, rcrc)
            avail = {s: p[s] if s < k else c[s - k]
                     for s in range(k + m) if s not in lost}
            dec = port_codec.decode_array(avail, list(range(k)), p.shape[1])
            rdec = ref_codec.decode_array(avail, list(range(k)), p.shape[1])
            data = np.stack([dec[s] for s in range(k)])
            assert np.array_equal(data, np.stack(
                [np.asarray(rdec[s]) for s in range(k)]))
            assert si.deinterleave(data, len(o)) == o
    finally:
        q.stop()
        rq.stop()


def test_queue_batches_keep_codecs_and_signatures_apart():
    a = codec_from_profile(PROFILE, device="cpu")
    b = codec_from_profile("plugin=isa k=4 m=2 technique=cauchy",
                           device="cpu")
    rng = np.random.default_rng(22)
    planes = [rng.integers(0, 256, (4, 96), dtype=np.uint8)
              for _ in range(8)]
    q = StripeBatchQueue(device="cpu", window_s=0.05)
    try:
        futs = [q.encode_async(a if i % 2 else b, p)
                for i, p in enumerate(planes)]
        for i, (f, p) in enumerate(zip(futs, planes)):
            codec = a if i % 2 else b
            assert np.array_equal(f.result(timeout=60),
                                  codec.encode_array(p))
        with pytest.raises(ValueError):
            q.decode_data_async(a, {0: planes[0][0], 1: planes[0][1]})
    finally:
        q.stop()


def test_queue_failure_reaches_every_future(monkeypatch):
    codec = codec_from_profile(PROFILE, device="cpu")
    avail = {i: np.zeros(64, np.uint8) for i in range(4)}
    q = StripeBatchQueue(device="cpu", window_s=0.05)
    try:
        got = q.decode_data_async(codec, avail).result(timeout=60)
        assert np.array_equal(got, np.zeros((4, 64), np.uint8))

        def boom(survivors):
            raise RuntimeError("recovery matrix failed")

        monkeypatch.setattr(codec, "recovery_matrix", boom)
        futs = [q.decode_data_async(codec, avail) for _ in range(3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="recovery matrix"):
                f.result(timeout=60)
    finally:
        q.stop()


@pytest.mark.parametrize("size", [0, 1, 4095, 4096, 4097, 3 * 4096 + 5])
def test_stripe_info_matches_reference(size):
    si, rsi = StripeInfo(4, 1024), RefStripeInfo(4, 1024)
    data = np.random.default_rng(size).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    p, s = si.interleave(data)
    rp, rs = rsi.interleave(data)
    assert s == rs and np.array_equal(p, rp)
    assert si.deinterleave(p, size) == rsi.deinterleave(rp, size) == data
    for off in (0, 1, 4096, 5000):
        assert si.offset_len_to_stripe_bounds(off, size) == \
            rsi.offset_len_to_stripe_bounds(off, size)
        assert si.logical_to_prev_chunk_offset(off) == \
            rsi.logical_to_prev_chunk_offset(off)
        assert si.logical_to_next_chunk_offset(off) == \
            rsi.logical_to_next_chunk_offset(off)
    assert si.object_stripes(size) == rsi.object_stripes(size)
    assert si.chunk_extent(1, 3) == rsi.chunk_extent(1, 3)


def test_covering_grammar_matches_reference():
    for n in list(range(0, 130)) + [1000, 4097, (1 << 20) + 1]:
        assert shapebucket.round_up_pow2(n) == ref_shapebucket.round_up_pow2(n)
        assert shapebucket.odd_part(n) == ref_shapebucket.odd_part(n)
        for gran in (1, 3, 8):
            for floor in (1, 64):
                assert shapebucket.covering(n, gran, floor) == \
                    ref_shapebucket.covering(n, gran, floor)


def test_perf_counters_and_ring_match_reference():
    a, b = perf.PerfCounters("q"), ref_perf.PerfCounters("q")
    for pc in (a, b):
        pc.add_histogram("lat", "x")
        pc.add_u64_gauge("depth")
        pc.add_u64_counter("ops")
        for v in (0.5, 1, 3, 1000, 1e9):
            pc.hinc("lat", v)
        pc.set("depth", 7)
        pc.inc("ops", 3)
    assert a.dump() == b.dump()
    assert a.value("depth") == b.value("depth") == 7
    ra, rb = perf.SnapshotRing(8), ref_perf.SnapshotRing(8)
    for r in (ra, rb):
        for t in range(10):
            r.push({"x": t * t}, stamp=float(t))
    for w in (1.0, 3.0, 100.0):
        assert ra.rate("x", w) == rb.rate("x", w)
        assert ra.delta("x", w, now=9.5) == rb.delta("x", w, now=9.5)
    assert ra.rate("x", 1.0, now=20.0) == 0.0


def test_staging_pool_backpressure_blocks_then_releases():
    stats = DevPathStats()
    pool = StagingPool(slot_bytes=4096, slots=2, stats=stats)
    a = pool.acquire(1000)
    b = pool.acquire(4096)
    assert a.arr.dtype == torch.uint8 and a.arr.numel() == 1000
    assert pool.occupancy == 2
    assert pool.acquire(16, timeout=0.05) is None
    got = []
    th = threading.Thread(target=lambda: got.append(pool.acquire(512, 30.0)))
    th.start()
    th.join(timeout=0.2)
    assert th.is_alive()
    pool.release(a)
    th.join(timeout=10.0)
    assert not th.is_alive() and got and got[0] is not None
    assert stats.snapshot()["pool_occupancy_hw"] == 2
    big = pool.acquire(1 << 16)  # oversize: a buffer of its own
    assert big.index == -1 and big.arr.numel() == 1 << 16
    for s in (b, got[0], big):
        pool.release(s)
    assert pool.occupancy == 0


ROOT_SCRIPTS = ("chip_smoke.py", "wire_trace.py")


def _port_files():
    files = sorted((REPO / "ceph_tpu_torch").rglob("*.py"))
    return files + [REPO / name for name in ROOT_SCRIPTS]


def test_port_sources_import_neither_jax_nor_the_reference():
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "ceph_tpu"), \
                    f"{path.relative_to(REPO)} imports {name}"


def test_the_monitor_and_vstart_are_among_the_scanned_sources():
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    assert {"ceph_tpu_torch/mon/monitor.py", "ceph_tpu_torch/mon/services.py",
            "ceph_tpu_torch/mon/pgmap.py",
            "ceph_tpu_torch/vstart.py"} <= names
    # the mgr and the admin and offline tools
    assert {"ceph_tpu_torch/mgr/manager.py", "ceph_tpu_torch/mgr/dashboard.py",
            *(f"ceph_tpu_torch/tools/{t}.py" for t in (
                "rados_bench", "rados", "ceph", "objectstore_tool",
                "monstore_tool", "cephtop"))} <= names


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    mods = sorted({".".join(p.relative_to(REPO).with_suffix("").parts)
                   .removesuffix(".__init__")
                   for p in _port_files() if p.name not in ROOT_SCRIPTS})
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "import chip_smoke\nimport wire_trace\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ceph_tpu'))\n"
            "assert not bad, bad\n"
            "assert 'ceph_tpu_torch.gpu.queue' in sys.modules\n"
            "assert 'ceph_tpu_torch.crush.mapper' in sys.modules\n"
            "assert 'ceph_tpu_torch.tools.crushtool' in sys.modules\n"
            "assert 'ceph_tpu_torch.msg.messenger' in sys.modules\n"
            "assert 'ceph_tpu_torch.auth.cephx' in sys.modules\n"
            "assert 'ceph_tpu_torch.store.memstore' in sys.modules\n"
            "assert 'ceph_tpu_torch.osd.map_inc' in sys.modules\n"
            "assert 'ceph_tpu_torch.mgr.balancer' in sys.modules\n"
            "assert 'ceph_tpu_torch.tools.osdmaptool' in sys.modules\n"
            "assert 'ceph_tpu_torch.osd.messages' in sys.modules\n"
            "assert 'ceph_tpu_torch.osd.pglog' in sys.modules\n"
            "assert 'ceph_tpu_torch.mon.messages' in sys.modules\n"
            "assert 'ceph_tpu_torch.tools.dencoder' in sys.modules\n"
            "assert 'ceph_tpu_torch.osd.backend' in sys.modules\n"
            "assert 'ceph_tpu_torch.osd.recovery' in sys.modules\n"
            "assert 'ceph_tpu_torch.osd.pg' in sys.modules\n"
            "assert 'ceph_tpu_torch.osd.hitset' in sys.modules\n"
            "assert 'ceph_tpu_torch.osd.scrub' in sys.modules\n"
            "assert 'ceph_tpu_torch.osd.daemon' in sys.modules\n"
            "assert 'ceph_tpu_torch.osd.qos' in sys.modules\n"
            "assert 'ceph_tpu_torch.osd.mclock' in sys.modules\n"
            "assert 'ceph_tpu_torch.mon.client' in sys.modules\n"
            "assert 'ceph_tpu_torch.mon.monitor' in sys.modules\n"
            "for m in ('mon.services', 'mon.pgmap', 'vstart', 'mgr.manager',\n"
            "          'mgr.dashboard', 'tools.rados_bench', 'tools.rados',\n"
            "          'tools.ceph', 'tools.objectstore_tool',\n"
            "          'tools.monstore_tool', 'tools.cephtop'):\n"
            "    assert 'ceph_tpu_torch.' + m in sys.modules, m\n"
            "assert 'ceph_tpu_torch.ec.clay' in sys.modules\n"
            "for m in ('compress', 'compress.plugins', 'store.kv', "
            "'store.lsm', 'store.filestore', 'store.blockstore'):\n"
            "    assert 'ceph_tpu_torch.' + m in sys.modules, m\n"
            "from ceph_tpu_torch.store import create\n"
            "from ceph_tpu_torch.store.blockstore import BlockStore\n"
            "from ceph_tpu_torch.store.filestore import FileStore\n"
            "from ceph_tpu_torch.store.lsm import LSMStore\n"
            "import tempfile\n"
            "with tempfile.TemporaryDirectory() as d:\n"
            "    for kind in ('filestore', 'blockstore'):\n"
            "        st = create(kind, d + '/' + kind)\n"
            "        st.mkfs(); st.mount(); st.umount()\n"
            "    db = LSMStore(d + '/lsm'); db.open(); db.close()\n"
            "    bs = BlockStore(d + '/bs', compression='zlib', "
            "kv_kind='lsm')\n"
            "    bs.mkfs(); bs.mount(); bs.umount()\n"
            "from ceph_tpu_torch.ec.clay import ClayCodec, ErasureCodeClay\n"
            "for m in ('__init__', 'objecter', 'rados', 'striper', "
            "'cache_tier'):\n"
            "    assert ('ceph_tpu_torch.client.' + m).removesuffix("
            "'.__init__') in sys.modules, m\n"
            "from ceph_tpu_torch.client import (IoCtx, Objecter, "
            "RadosClient, RadosError)\n"
            "from ceph_tpu_torch.client.striper import RadosStriper\n"
            "from ceph_tpu_torch.client.cache_tier import CacheTier\n"
            "from ceph_tpu_torch.osd.daemon import OSDService\n"
            "from ceph_tpu_torch.mon import MonClient, MonMap\n"
            "from ceph_tpu_torch.gpu.shapebucket import DeviceWarmup\n"
            "from ceph_tpu_torch.gpu.queue import default_queue\n"
            "from ceph_tpu_torch.osd.backend import ECBackend, hinfo_decode\n"
            "from ceph_tpu_torch.osd.recovery import ECRecoveryEngine\n"
            "from ceph_tpu_torch.osd.pg import PG, READ_RETRY, "
            "ROLLBACK_EVENTS\n"
            "from ceph_tpu_torch.osd.hitset import BloomHitSet, "
            "HitSetHistory\n"
            "from ceph_tpu_torch.osd.scrub import decode_stamps, "
            "encode_stamps\n"
            "from ceph_tpu_torch.gpu.staging import (DeviceBuf, "
            "StagingPool, devpath_enabled)\n"
            "assert StagingPool.configure and DeviceBuf.seal\n"
            "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


def _monclient_takes_a_map(MonClient, MonMap, m):
    """A subscribed ``MonClient`` given no device decodes a mon's push of
    the whole map ``m`` (on the card: it raises without one)."""
    from ceph_tpu_torch.mon import messages as mm
    from ceph_tpu_torch.msg.message import EntityName
    from ceph_tpu_torch.msg.messenger import Messenger
    from ceph_tpu_torch.osd import map_codec

    monc = MonClient(Messenger(None, EntityName("client", 1)), MonMap([]))
    monc.on_osdmap = lambda newmap: None
    monc.ms_dispatch(None, mm.MOSDMapMsg(m.epoch + 1,
                                         map_codec.encode_osdmap(m)))


def test_no_device_without_cuda_raises(monkeypatch):
    from ceph_tpu_torch import resolve_device
    from ceph_tpu_torch.crush import map as cmap
    from ceph_tpu_torch.crush import mapper
    from ceph_tpu_torch.ec import instance
    from ceph_tpu_torch.ops.crc32c_device import crc32c_dev
    from types import SimpleNamespace

    from ceph_tpu_torch.gpu.queue import default_queue
    from ceph_tpu_torch.osd import backend, map_codec, map_inc, osdmap
    from ceph_tpu_torch.osd import hitset, pg, scrub
    from ceph_tpu_torch.core.context import Context
    from ceph_tpu_torch.gpu.shapebucket import DeviceWarmup
    from ceph_tpu_torch.mon import MonClient, MonMap
    from ceph_tpu_torch.osd.daemon import OSDService
    from ceph_tpu_torch.client import RadosClient
    from ceph_tpu_torch.store.memstore import MemStore
    from ceph_tpu_torch.store.objectstore import Collection
    from ceph_tpu_torch.tools import crushtool, osdmaptool

    m, root = cmap.build_flat_cluster(4)
    cpu_map = osdmap.OSDMap(m, device="cpu")
    flat = m.flatten()
    steps = [(cmap.OP_TAKE, root, 0), (cmap.OP_CHOOSE_FIRSTN, 2, 0),
             (cmap.OP_EMIT, 0, 0)]
    # a codec with no device: the backend takes the card's queue
    no_dev = SimpleNamespace(device=None, get_sub_chunk_count=lambda: 1)
    # the PG's host: whoami, epoch, store, send (pg.py:177-247)
    pg_host = SimpleNamespace(whoami=0, epoch=lambda: 1, store=MemStore(),
                              send_to_osd=None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: resolve_device(),
                 lambda: resolve_device("cuda"),
                 lambda: codec_from_profile(PROFILE),
                 lambda: instance().factory("isa", {"k": "4", "m": "2"}),
                 lambda: StripeBatchQueue(),
                 lambda: crc32c_dev(b"abc"),
                 lambda: mapper.compile_rule(flat, steps, 2),
                 lambda: mapper.sweep_device(flat, steps, 2, [0], [1 << 16]),
                 lambda: crushtool.main(["--build", "--num_osds", "4",
                                         "root", "straw2", "0", "--test"]),
                 lambda: osdmap.OSDMap(m),
                 lambda: map_codec.decode_osdmap(
                     map_codec.encode_osdmap(cpu_map)),
                 lambda: map_inc.decode_value(
                     map_inc.encode_full_value(cpu_map), None),
                 lambda: osdmaptool.main(["--createsimple", "8",
                                          "--test-map-pgs"]),
                 lambda: default_queue(),
                 lambda: backend.ECBackend((1, 0), Collection("1.0_head"),
                                           MemStore(), 0, None, None,
                                           no_dev),
                 lambda: pg.PG((1, 0), osdmap.PGPool(pool_id=1), pg_host,
                               no_dev),
                 lambda: OSDService(Context("osd.0"), 0, MemStore(),
                                    cpu_map, codec_from_profile),
                 lambda: DeviceWarmup(),
                 lambda: _monclient_takes_a_map(MonClient, MonMap, cpu_map),
                 lambda: RadosClient(),
                 lambda: RadosClient(Context("client.9"))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # the client raised before its messenger or its objecter's ticker
    # started a thread
    names = {t.name for t in threading.enumerate()}
    assert not any(n.startswith(("msgr-client", "objecter"))
                   for n in names), names
    # naming the CPU is the one way to run there; the host-side
    # modules of the PG (its hit sets and scrub stamps) need no device
    assert codec_from_profile(PROFILE, device="cpu").device.type == "cpu"
    assert pg.PG((1, 0), osdmap.PGPool(pool_id=1), pg_host,
                 codec_from_profile(PROFILE, device="cpu")
                 ).backend.queue.device.type == "cpu"
    assert hitset.BloomHitSet(target_size=8).nbits >= 64
    assert scrub.decode_stamps(scrub.encode_stamps(1.5, 2.5, 3)) == (
        1.5, 2.5, 3)
    assert default_queue("cpu").device.type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
