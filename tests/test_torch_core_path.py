"""The core layer on the port's device path, on the CPU: the stripe-batch
queue under lockdep, the ``queue.batch.dispatch`` failpoint, and the
device watch's batch and launch counts, with the admin socket's
``device compile dump``.  The card's twins of the first two are in
``tests/test_torch_cuda.py``."""

import threading

import numpy as np
import pytest

from ceph_tpu.core.crc import crc32c as ref_crc32c
from ceph_tpu.ec import codec_from_profile as ref_codec_from_profile
from ceph_tpu_torch.core import failpoint as fp
from ceph_tpu_torch.core import lockdep
from ceph_tpu_torch.core.admin_socket import admin_command
from ceph_tpu_torch.core.context import Context
from ceph_tpu_torch.ec import codec_from_profile
from ceph_tpu_torch.gpu import devwatch
from ceph_tpu_torch.gpu.queue import StripeBatchQueue
from ceph_tpu_torch.ops import _build

PROFILE = "plugin=isa k=8 m=4 technique=reed_sol_van"
LOST = (6, 7, 10, 11)
K, M = 8, 4


@pytest.fixture
def armed_lockdep():
    was = lockdep.enabled()
    lockdep.reset()
    lockdep.enable(True)
    yield
    lockdep.enable(was)
    lockdep.reset()


@pytest.fixture(autouse=True)
def _clean_failpoints():
    fp.disarm_all()
    yield
    fp.disarm_all()


def _planes(seed, count, width):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (K, width), dtype=np.uint8)
            for _ in range(count)]


def _concurrently(fn, n, threads=4):
    """fn(i) for i < n from several threads at once; the outcomes
    (result or exception) in order."""
    out = [None] * n
    barrier = threading.Barrier(threads)

    def worker(t):
        barrier.wait(timeout=30)
        futs = [(i, fn(i)) for i in range(t, n, threads)]
        for i, f in futs:
            try:
                out[i] = f.result(timeout=60)
            except Exception as e:  # noqa: BLE001 — the outcome is kept
                out[i] = e

    ths = [threading.Thread(target=worker, args=(t,)) for t in range(threads)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in ths)
    return out


def test_write_and_degraded_read_under_lockdep(armed_lockdep):
    """The queue built with lockdep armed takes checked locks, and a
    write plus a degraded read through it record edges and raise no
    LockOrderError; bytes and CRCs equal the reference's."""
    codec = codec_from_profile(PROFILE, device="cpu")
    ref = ref_codec_from_profile(PROFILE)
    q = StripeBatchQueue(device="cpu")
    assert isinstance(q.pool._cond._lock, lockdep.DMutex)
    assert isinstance(q.stats._lock, lockdep.DMutex)
    planes = _planes(1, 8, 3072)
    try:
        wrote = _concurrently(
            lambda i: q.encode_crc_async(codec, planes[i]), len(planes))
        survivors = [s for s in range(K + M) if s not in LOST]

        def read(i):
            coding = wrote[i][0]
            avail = {s: planes[i][s] if s < K else coding[s - K]
                     for s in survivors}
            return q.decode_data_async(codec, avail)

        read_back = _concurrently(read, len(planes))
    finally:
        q.stop()
    for i, p in enumerate(planes):
        coding, crcs = wrote[i]
        assert np.array_equal(coding, ref.encode_array(p))
        shards = list(p) + list(coding)
        assert [int(c) for c in crcs] == [ref_crc32c(s) for s in shards]
        assert np.array_equal(read_back[i], p)
    g = lockdep.edge_graph()
    assert "staging.stats" in g.get("staging.pool", {}), g


def test_dispatch_failpoint_fails_one_batch_and_the_next_succeed():
    """An error armed once at queue.batch.dispatch reaches exactly the
    jobs of the batch it fired on; the worker serves on, and the next
    writes complete with their CRCs."""
    codec = codec_from_profile(PROFILE, device="cpu")
    ref = ref_codec_from_profile(PROFILE)
    seen = []

    def fail(ctx):
        seen.append(ctx["jobs"])
        fp.error()(ctx)

    q = StripeBatchQueue(device="cpu")
    planes = _planes(2, 8, 2048)
    try:
        fp.arm("queue.batch.dispatch", fail, once=True)
        first = _concurrently(
            lambda i: q.encode_crc_async(codec, planes[i]), len(planes))
        failed = [r for r in first if isinstance(r, fp.FailpointError)]
        assert fp.hits("queue.batch.dispatch") == 1
        assert fp.fired("queue.batch.dispatch") == 1
        assert seen and len(failed) == seen[0]
        assert all(isinstance(r, (tuple, fp.FailpointError))
                   for r in first)
        assert q.jobs == len(planes) - len(failed)
        after = [q.encode_crc_async(codec, p).result(timeout=60)
                 for p in planes]
    finally:
        q.stop()
        fp.disarm_all()
    for p, (coding, crcs) in zip(planes, after):
        assert np.array_equal(coding, ref.encode_array(p))
        assert [int(c) for c in crcs] == \
            [ref_crc32c(s) for s in list(p) + list(coding)]


def test_devwatch_counts_batches_and_launches(tmp_path):
    """The device watch notes every completed batch of the queue and
    reads every kernel's launch count; the admin socket's ``device
    compile dump`` answers the same."""
    dw = devwatch.watch()
    before = dw.batches
    codec = codec_from_profile(PROFILE, device="cpu")
    q = StripeBatchQueue(device="cpu")
    dw.attach_queue(q)
    try:
        for p in _planes(3, 5, 1024):
            q.encode_crc_async(codec, p).result(timeout=60)
        state = dw.device_state()
    finally:
        dw.attach_queue(None)
        q.stop()
    assert dw.batches - before == q.batches == 5
    assert state["queue_depth"] == 0 and "staging" in state
    last = state["last_batches"][-1]
    assert last["kind"] == "encp" and last["jobs"] == 1
    assert last["shapes"] == [[K, 1024]]
    names = {"gf256_matmul", "crc32c_rows", "gf2_matmul", "gf2_xor",
             "gf256_interleaved", "crush_rule", "mesh_digest"}
    assert set(dw.launches()) == names
    # on the CPU the plain versions run: no kernel was launched
    assert dw.launches() == {c.name: c.value for c in _build.COUNTS}

    sock = str(tmp_path / "asok")
    ctx = Context("osd.0", {"admin_socket": sock})
    try:
        out = admin_command(sock, "device compile dump")
    finally:
        ctx.shutdown()
    assert out["launches"] == dw.launches()
    assert out["batches"]["total"] == dw.batches
    assert out["build"]["sources"] == list(_build.SOURCES)
    assert "compiles" not in out  # the port keeps no compile table


def test_crash_report_carries_the_device_section(tmp_path):
    """CrashArchive's device section is the port's device_state(): the
    kernel build, the launches and the queue's last batches."""
    from ceph_tpu_torch.core.crash import CrashArchive
    from ceph_tpu_torch.core.log import Log

    codec = codec_from_profile(PROFILE, device="cpu")
    q = StripeBatchQueue(device="cpu")
    dw = devwatch.watch()
    dw.attach_queue(q)
    try:
        q.encode_async(codec, _planes(4, 1, 512)[0]).result(timeout=60)
        arch = CrashArchive(str(tmp_path / "crash"), entity="osd.3",
                            log=Log(name="osd.3"))
        try:
            raise RuntimeError("device worker died")
        except RuntimeError as e:
            cid = arch.record(e)
    finally:
        dw.attach_queue(None)
        q.stop()
    report = arch.info(cid)
    assert report["entity_name"] == "osd.3"
    assert "device worker died" in report["exception"]
    dev = report["device"]
    assert dev["queue_depth"] == 0 and dev["staging_slots_used"] == 0
    assert dev["launches"] == dw.launches()
    assert dev["last_batches"][-1]["kind"] == "enc"
    assert [c["crash_id"] for c in arch.ls()] == [cid]
