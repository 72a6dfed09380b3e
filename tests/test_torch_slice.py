"""The port's whole slice — stripe geometry, stripe-batch queue, staging,
counters — held against ceph_tpu on the CPU, plus the port's guards: it
imports neither JAX nor ceph_tpu, and without CUDA an entry point given
no device raises instead of running on the CPU."""

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


def _port_files():
    files = sorted((REPO / "ceph_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


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


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    mods = sorted({".".join(p.relative_to(REPO).with_suffix("").parts)
                   .removesuffix(".__init__")
                   for p in _port_files() if p.name != "chip_smoke.py"})
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ceph_tpu'))\n"
            "assert not bad, bad\n"
            "assert 'ceph_tpu_torch.gpu.queue' in sys.modules\n"
            "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


def test_no_device_without_cuda_raises(monkeypatch):
    from ceph_tpu_torch import resolve_device
    from ceph_tpu_torch.ec import instance
    from ceph_tpu_torch.ops.crc32c_device import crc32c_dev

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: resolve_device(),
                 lambda: resolve_device("cuda"),
                 lambda: codec_from_profile(PROFILE),
                 lambda: instance().factory("isa", {"k": "4", "m": "2"}),
                 lambda: StripeBatchQueue(),
                 lambda: crc32c_dev(b"abc")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # naming the CPU is the one way to run there
    assert codec_from_profile(PROFILE, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
