"""The port's staging layer (``ceph_tpu_torch/gpu/staging.py``) and its
sinks, against ``ceph_tpu.tpu.staging``.

Case for case with ``tests/test_device_datapath.py`` lines 139 (the
timeout), 150 (the ``DeviceBuf`` lifecycle and accounting) and 175 (seal
without planes), then: ``configure`` on an idle and a busy pool;
``discard`` and ``__del__`` returning a slot; the ``staging.seal``
failpoint; the counters held to the reference's over one scripted call
sequence; handles around torch tensors; ``Transaction.write`` keeping a
handle until ``op_payload`` or ``Op.encode`` reads it; a handle framed by
the messenger and counted once; and the queue's payload pool apart from
its upload buffer, so that staging every slot cannot starve a batch.
The card's twins are in ``tests/test_torch_cuda.py``.
"""


import numpy as np
import pytest
import torch

from ceph_tpu.tpu import staging as ref_staging
from ceph_tpu_torch.core import failpoint as fp
from ceph_tpu_torch.gpu import staging
from ceph_tpu_torch.gpu.staging import DeviceBuf, DevPathStats, StagingPool

PAYLOAD = bytes(range(256)) * 16  # 4096


@pytest.fixture(autouse=True)
def _disarm():
    fp.disarm_all()
    yield
    fp.disarm_all()


def _planes(payload: bytes, k: int, unit: int) -> np.ndarray:
    S = len(payload) // (k * unit)
    return np.frombuffer(payload, np.uint8).reshape(S, k, unit).transpose(
        1, 0, 2).reshape(k, S * unit).copy()


def test_staging_pool_timeout_degrades_not_wedges():
    pool = StagingPool(slot_bytes=1024, slots=1)
    s = pool.acquire(10)
    assert pool.acquire(10, timeout=0.05) is None  # degrade, don't hang
    pool.release(s)
    big = pool.acquire(4096)  # oversize payloads bypass the pool
    assert big is not None and big.index == -1
    assert pool.occupancy == 0


def test_devicebuf_lifecycle_and_accounting():
    stats = DevPathStats()
    pool = StagingPool(slot_bytes=8192, slots=4, stats=stats)
    buf = DeviceBuf.stage(pool, PAYLOAD)
    assert len(buf) == 4096 and pool.occupancy == 1
    assert bytes(buf.wire_view()) == PAYLOAD  # host-staged: uncounted
    assert stats.snapshot()["d2h_bytes"] == 0
    assert stats.snapshot()["payload_host_touches"] == 0
    buf.attach_planes(_planes(PAYLOAD, 2, 2048), k=2, unit=2048)
    buf.seal()
    assert pool.occupancy == 0
    assert buf[0:4096] == PAYLOAD  # from the planes, counted
    assert stats.snapshot()["d2h_bytes"] == 4096
    assert stats.snapshot()["payload_host_touches"] == 0
    assert buf.tobytes() == PAYLOAD
    assert stats.snapshot()["payload_host_touches"] == 1


def test_devicebuf_seal_without_planes_keeps_bytes():
    pool = StagingPool(slot_bytes=1024, slots=1)
    buf = DeviceBuf.stage(pool, b"hello world")
    buf.seal()
    assert pool.occupancy == 0
    assert buf.tobytes() == b"hello world"


def test_pool_geometry_defaults_and_environment(monkeypatch):
    pool = StagingPool()
    assert (pool.slot_bytes, pool.nslots) == (128 << 10, 64)
    monkeypatch.setenv("CEPH_TPU_TPU_STAGING_SLOT_KIB", "4")
    monkeypatch.setenv("CEPH_TPU_TPU_STAGING_SLOTS", "3")
    pool, ref = StagingPool(), ref_staging.StagingPool()
    assert (pool.slot_bytes, pool.nslots) == (ref.slot_bytes, ref.nslots) \
        == (4096, 3)


def test_configure_resizes_an_idle_pool_only():
    stats = DevPathStats()
    pool = StagingPool(slot_bytes=1024, slots=2, stats=stats)
    held = pool.acquire(100)
    assert pool.configure(4096, 8) is False  # busy: nothing changes
    assert (pool.slot_bytes, pool.nslots) == (1024, 2)
    pool.release(held)
    assert pool.configure(1024, 2) is True  # same geometry
    assert pool.configure(4096, 8) is True
    assert (pool.slot_bytes, pool.nslots) == (4096, 8)
    slots = [pool.acquire(4096) for _ in range(8)]
    assert all(s.index >= 0 and s.arr.numel() == 4096 for s in slots)
    assert len({s.index for s in slots}) == 8 and pool.occupancy == 8
    assert stats.pool_occupancy_hw == 8
    for s in slots:
        pool.release(s)
    ref = ref_staging.StagingPool(slot_bytes=1024, slots=2)
    held = ref.acquire(100)
    assert ref.configure(4096, 8) is False
    ref.release(held)
    assert ref.configure(4096, 8) is True


def test_discard_and_collection_return_the_slot():
    pool = StagingPool(slot_bytes=1024, slots=2)
    buf = DeviceBuf.stage(pool, b"dropped")
    buf.discard()
    assert pool.occupancy == 0 and len(buf) == 0 and buf[0:4] == b""
    buf = DeviceBuf.stage(pool, b"leaked")
    assert pool.occupancy == 1
    del buf  # a handle dropped without seal() gives its slot back
    assert pool.occupancy == 0
    buf = DeviceBuf.stage(pool, b"planned")
    buf.attach_planes(np.frombuffer(b"planned", np.uint8).reshape(1, 7), 1, 7)
    buf.discard()  # with planes attached the handle keeps them
    assert pool.occupancy == 0 and buf.tobytes() == b"planned"


def test_seal_passes_its_failpoint():
    pool = StagingPool(slot_bytes=1024, slots=1)
    buf = DeviceBuf.stage(pool, b"x" * 100)
    seen = []
    fp.arm("staging.seal", seen.append)
    buf.seal()
    assert fp.hits("staging.seal") == 1
    assert seen == [{"_name": "staging.seal", "size": 100}]
    assert pool.occupancy == 0
    buf = DeviceBuf.stage(pool, b"y" * 10)
    fp.arm("staging.seal", fp.error(), once=True)
    with pytest.raises(fp.FailpointError):
        buf.seal()
    assert pool.occupancy == 1  # the error fired before the release
    buf.seal()
    assert pool.occupancy == 0


def _script(mod, pool_cls, stats):
    """One call sequence over either package: stage, sinks, planes,
    seal, late reads, device handles, discard."""
    pool = pool_cls(slot_bytes=8192, slots=4, stats=stats)
    out = []
    a = mod.DeviceBuf.stage(pool, PAYLOAD)
    b = mod.DeviceBuf.stage(pool, PAYLOAD[:3000])
    out.append(bytes(a.wire_view()))
    out.append(a.np1d().tobytes())
    a.attach_planes(_planes(PAYLOAD, 4, 512), 4, 512)
    a.seal()
    out += [a[100:300], bytes(a.wire_view()), a.np1d().tobytes(),
            a.tobytes()]
    parity = np.arange(2048, dtype=np.uint8).reshape(2, 1024)
    d = mod.DeviceBuf.wrap_device(parity, stats)
    out += [bytes(d.wire_view()), d[5:9], d.np1d().tobytes(), bytes(d)]
    h = mod.DeviceBuf.wrap_host(_planes(PAYLOAD, 4, 512)[1], stats)
    out += [bytes(h.wire_view()), h[0:16]]
    b.discard()
    out.append(b.tobytes())
    c = mod.DeviceBuf.stage(pool, PAYLOAD[:10])
    c.seal()
    out += [c.tobytes(), c[2:5], repr(c).split(",")[0]]
    return out, pool.occupancy


def test_counters_equal_the_reference_for_one_call_sequence():
    stats, ref_stats = DevPathStats(), ref_staging.DevPathStats()
    got, occ = _script(staging, StagingPool, stats)
    want, ref_occ = _script(ref_staging, ref_staging.StagingPool, ref_stats)
    assert got == want and occ == ref_occ == 0
    assert stats.snapshot() == ref_stats.snapshot()
    assert stats.snapshot()["d2h_bytes"] > 0
    view = stats.perf_view("osd.3.tpu")
    assert view.name == "osd.3.tpu" and view.dump() == stats.snapshot()


def test_handles_around_torch_tensors_count_as_numpy_ones():
    """A ``"dev"`` handle of a uint8 tensor and planes held as a tensor:
    the same bytes and the same counters as numpy payloads."""
    parity = np.arange(4096, dtype=np.uint8).reshape(4, 1024)
    planes = _planes(PAYLOAD, 4, 512)
    results = []
    for make in (np.asarray, torch.from_numpy):
        stats = DevPathStats()
        pool = StagingPool(slot_bytes=8192, slots=1, stats=stats)
        d = DeviceBuf.wrap_device(make(parity), stats)
        buf = DeviceBuf.stage(pool, PAYLOAD)
        buf.attach_planes(make(planes), 4, 512)
        buf.seal()
        results.append(([bytes(d.wire_view()), d[1000:1010], bytes(d),
                         bytes(buf.wire_view()), buf[7:99], buf.tobytes()],
                        stats.snapshot()))
    assert results[0] == results[1]
    assert results[0][0][0] == parity.tobytes()
    assert results[0][0][3] == PAYLOAD


def test_devpath_switch(monkeypatch):
    from ceph_tpu_torch.core.config import Config

    monkeypatch.delenv("CEPH_TPU_TPU_DEVPATH", raising=False)
    assert staging.devpath_enabled() is True
    for off in ("0", "false", "no", "off"):
        monkeypatch.setenv("CEPH_TPU_TPU_DEVPATH", off)
        assert staging.devpath_enabled() is False
        assert ref_staging.devpath_enabled() is False
    conf = Config({"tpu_devpath": True})
    assert staging.devpath_enabled(conf) is True  # conf wins over env

    class NoOption:
        def get(self, name):
            raise KeyError(name)

    assert staging.devpath_enabled(NoOption()) is False


def test_transaction_keeps_the_handle_until_a_sink():
    """``Transaction.write`` keeps a DeviceBuf; ``op_payload`` reads it
    at apply (a view, or bytes with ``copy``), ``Op.encode`` on the wire;
    the bytes equal a plain-bytes transaction's and the reference's, and
    MemStore applies through ``op_payload``."""
    from ceph_tpu.store.objectstore import Transaction as RefTransaction
    from ceph_tpu.store.objectstore import Collection as RC, GHObject as RG
    from ceph_tpu_torch.store.memstore import MemStore
    from ceph_tpu_torch.store.objectstore import (Collection, GHObject,
                                                  Transaction, op_payload)

    cid, oid = Collection("2.5_head"), GHObject("obj-a", shard=4)
    stats = DevPathStats()
    parity = np.arange(3000, dtype=np.uint8) * 7
    d = DeviceBuf.wrap_device(parity, stats)
    t = Transaction()
    t.write(cid, oid, 64, d)
    assert t.ops[0].data is d and t.ops[0].length == 3000
    assert stats.d2h_bytes == 0
    assert bytes(op_payload(t.ops[0])) == parity.tobytes()
    assert stats.d2h_bytes == 3000
    assert isinstance(op_payload(t.ops[0], copy=True), bytes)
    assert stats.d2h_bytes == 6000
    wire = t.to_bytes()
    assert stats.d2h_bytes == 9000
    plain = Transaction()
    plain.write(cid, oid, 64, parity.tobytes())
    ref = RefTransaction()
    ref.write(RC("2.5_head"), RG("obj-a", shard=4), 64, parity.tobytes())
    assert wire == plain.to_bytes() == ref.to_bytes()
    assert op_payload(plain.ops[0]) == parity.tobytes()

    store = MemStore()
    store.mkfs()
    store.mount()
    t0 = Transaction()
    t0.create_collection(cid)
    store.queue_transaction(t0)
    store.queue_transaction(t)
    assert stats.d2h_bytes == 12000  # the apply's one counted view
    assert store.read(cid, oid, 64, 3000) == parity.tobytes()
    assert stats.payload_host_touches == 0


def test_messenger_frame_reads_a_devicebuf_once():
    """A message whose payload is a DeviceBuf frames to the same bytes as
    with host bytes (``Messenger._frame_of``), and the frame is the sink
    that counts the handle's fetch, once."""
    from ceph_tpu_torch.msg.message import EntityName, Message
    from ceph_tpu_torch.msg.messenger import Messenger
    from ceph_tpu_torch.osd import messages as om

    stats = DevPathStats()
    chunk = (np.arange(5000, dtype=np.uint32) * 2654435761 % 251).astype(
        np.uint8)
    msgr = Messenger(None, EntityName("osd", 1))
    msgr.start()
    try:
        framed = []
        for data in (DeviceBuf.wrap_device(chunk, stats), chunk.tobytes()):
            msg = om.MECSubReadReply((2, 5), 33, 4, "obj-a", data, 0,
                                     {"crc": b"\0\1\2\3"})
            msg.tid = 9
            framed.append(bytes(msgr._frame_of(msg)))
            assert stats.d2h_bytes == 5000
        assert framed[0] == framed[1]
        back = Message.from_bytes(framed[0][8:])
        assert back.data == chunk.tobytes() and back.tid == 9
    finally:
        msgr.shutdown()
    assert stats.payload_host_touches == 0


def test_queue_pools_are_apart():
    """The queue's ``pool`` is the payload staging pool (64 x 128 KiB by
    default) sharing the queue's stats; the upload buffer is its own."""
    from ceph_tpu_torch.gpu.queue import StripeBatchQueue

    q = StripeBatchQueue(device="cpu")
    try:
        assert (q.pool.slot_bytes, q.pool.nslots) == (128 << 10, 64)
        assert q.pool.stats is q.stats and q.pool.pin is False
        assert q._upload_pool is not q.pool
        assert q._upload_pool.stats is not q.stats
    finally:
        q.stop()


def test_staged_slots_do_not_starve_the_queue():
    """Every slot of ``q.pool`` staged and held, then an encode (with
    CRCs) and a decode through the queue: both finish within a bounded
    wait, and the slots are released only afterwards."""
    from ceph_tpu.ec import codec_from_profile as ref_codec_from_profile
    from ceph_tpu_torch.ec import codec_from_profile
    from ceph_tpu_torch.gpu.queue import StripeBatchQueue

    profile = "plugin=isa k=4 m=2 technique=reed_sol_van"
    codec = codec_from_profile(profile, device="cpu")
    q = StripeBatchQueue(device="cpu")
    rng = np.random.default_rng(0)
    try:
        assert q.pool.configure(4096, 4)
        held = [DeviceBuf.stage(q.pool, rng.integers(
            0, 256, 4096, dtype=np.uint8).tobytes(), timeout=1.0)
            for _ in range(4)]
        assert all(held) and q.pool.occupancy == 4
        assert DeviceBuf.stage(q.pool, b"z", timeout=0.05) is None
        planes = rng.integers(0, 256, (4, 4096), dtype=np.uint8)
        coding, crcs = q.encode_crc_async(codec, planes).result(timeout=60)
        avail = {s: planes[s] if s < 4 else coding[s - 4]
                 for s in (0, 2, 4, 5)}
        data = q.decode_data_async(codec, avail).result(timeout=60)
        assert q.pool.occupancy == 4  # still held: nothing sealed them
        for b in held:
            b.seal()
        assert q.pool.occupancy == 0
        assert np.array_equal(coding, ref_codec_from_profile(
            profile).encode_array(planes))
        assert np.array_equal(data, planes) and len(crcs) == 6
        assert q.stats.pool_occupancy_hw == 4
    finally:
        q.stop()
