"""The port's BlockStore (``ceph_tpu_torch/store/blockstore.py``), case
for case against ``tests/test_blockstore.py``: allocator reuse, checksums
at rest, copy-on-write clones, compression, crash atomicity, fsck.
``test_torch_store_xcheck.py`` holds its block and KV files to the
reference's.
"""

import os

import pytest

from ceph_tpu_torch.store.blockstore import (
    BLOCK,
    BitmapAllocator,
    BlockStore,
    ChecksumError,
)
from ceph_tpu_torch.store.objectstore import Collection, GHObject, Transaction

CID = Collection("1.0_head")
OID = GHObject("obj1")


@pytest.fixture
def store(tmp_path):
    s = BlockStore(str(tmp_path / "bs"))
    s.mkfs()
    s.mount()
    t = Transaction()
    t.create_collection(CID)
    s.queue_transaction(t)
    yield s
    if s._mounted:
        s.umount()


def _write(store, oid, off, data):
    t = Transaction()
    t.write(CID, oid, off, data)
    store.queue_transaction(t)


def test_allocator_next_fit_and_release():
    a = BitmapAllocator(16)
    p1 = a.allocate(4)
    p2 = a.allocate(4)
    assert sum(n for _, n in p1) == 4 and sum(n for _, n in p2) == 4
    # no overlap
    used = set()
    for blk, n in p1 + p2:
        for i in range(blk, blk + n):
            assert i not in used
            used.add(i)
    a.release(p1)
    p3 = a.allocate(10)  # must span the freed hole + tail
    assert p3 is not None and sum(n for _, n in p3) == 10
    assert a.allocate(3) is None  # 16 - 4 - 10 = 2 left


def test_overwrite_frees_old_blocks(store):
    _write(store, OID, 0, b"a" * (8 * BLOCK))
    used_before = sum(store._alloc.bits)
    for _ in range(5):  # full overwrites must not leak blocks
        _write(store, OID, 0, b"b" * (8 * BLOCK))
    assert sum(store._alloc.bits) == used_before
    assert store.fsck() == []


def test_partial_overwrite_splits_extents(store):
    _write(store, OID, 0, b"A" * (4 * BLOCK))
    _write(store, OID, BLOCK, b"B" * BLOCK)  # middle overwrite
    got = store.read(CID, OID)
    want = (b"A" * BLOCK) + (b"B" * BLOCK) + (b"A" * (2 * BLOCK))
    assert got == want
    # three logical extents now; the split halves share one blob
    on = store._onode("1.0_head/obj1/-2/-1")
    assert len(on.extents) == 3
    assert store.fsck() == []


def test_clone_shares_blocks_then_cow(store):
    data = os.urandom(8 * BLOCK)
    _write(store, OID, 0, data)
    used_single = sum(store._alloc.bits)
    dst = GHObject("obj2")
    t = Transaction()
    t.clone(CID, OID, dst)
    store.queue_transaction(t)
    # clone shares every block: usage unchanged
    assert sum(store._alloc.bits) == used_single
    assert store.read(CID, dst) == data
    # overwriting the clone allocates fresh blocks, original intact
    _write(store, dst, 0, b"x" * BLOCK)
    assert store.read(CID, OID) == data
    assert store.read(CID, dst, 0, BLOCK) == b"x" * BLOCK
    assert store.fsck() == []


def test_checksum_at_rest_detects_bitrot(store):
    _write(store, OID, 0, b"payload" * 1000)
    on = store._onode("1.0_head/obj1/-2/-1")
    blob = store._blob(on.extents[0][2])
    blk = blob.pextents[0][0]
    # flip a byte on the raw device behind the store's back
    with open(store._dev_path, "r+b") as f:
        f.seek(blk * BLOCK + 17)
        orig = f.read(1)
        f.seek(blk * BLOCK + 17)
        f.write(bytes([orig[0] ^ 0xFF]))
    with pytest.raises(ChecksumError):
        store.read(CID, OID)
    assert any("crc mismatch" in e for e in store.fsck())


def test_compression_roundtrip_and_saving(tmp_path):
    s = BlockStore(str(tmp_path / "bsz"), compression="zlib")
    s.mkfs()
    s.mount()
    t = Transaction()
    t.create_collection(CID)
    s.queue_transaction(t)
    data = b"z" * (64 * BLOCK)  # highly compressible
    _write(s, OID, 0, data)
    assert s.read(CID, OID) == data
    on = s._onode("1.0_head/obj1/-2/-1")
    blob = s._blob(on.extents[0][2])
    assert blob.comp == "zlib"
    assert blob.nblocks() < 64  # actually saved space
    assert s.fsck() == []
    s.umount()


def test_remount_preserves_state_and_allocator(tmp_path):
    s = BlockStore(str(tmp_path / "bs"))
    s.mkfs()
    s.mount()
    t = Transaction()
    t.create_collection(CID)
    t.write(CID, OID, 0, b"persist" * 600)
    t.setattrs(CID, OID, {"a": b"1"})
    t.omap_setkeys(CID, OID, {"k": b"v"})
    s.queue_transaction(t)
    used = sum(s._alloc.bits)
    s.umount()

    s2 = BlockStore(str(tmp_path / "bs"))
    s2.mount()
    assert s2.read(CID, OID) == b"persist" * 600
    assert s2.getattr(CID, OID, "a") == b"1"
    assert s2.omap_get(CID, OID) == {"k": b"v"}
    assert sum(s2._alloc.bits) == used  # allocator rebuilt exactly
    assert s2.fsck() == []
    s2.umount()


def test_crash_before_kv_commit_keeps_old_state(tmp_path):
    """COW discipline: a transaction whose data hit the device but whose
    KV batch never committed must be invisible after remount."""
    s = BlockStore(str(tmp_path / "bs"))
    s.mkfs()
    s.mount()
    t = Transaction()
    t.create_collection(CID)
    t.write(CID, OID, 0, b"old" * 2000)
    s.queue_transaction(t)
    old_kv = open(os.path.join(str(tmp_path / "bs"), "meta.kv"), "rb").read()
    _write(s, OID, 0, b"new" * 2000)
    # simulate the crash: device retains the new blocks, KV rolls back
    s.umount()
    with open(os.path.join(str(tmp_path / "bs"), "meta.kv"), "wb") as f:
        f.write(old_kv)
    s2 = BlockStore(str(tmp_path / "bs"))
    s2.mount()
    assert s2.read(CID, OID) == b"old" * 2000
    assert s2.fsck() == []
    s2.umount()


def test_zero_and_truncate_are_hole_punches(store):
    _write(store, OID, 0, b"q" * (4 * BLOCK))
    used = sum(store._alloc.bits)
    t = Transaction()
    t.zero(CID, OID, 0, 4 * BLOCK)
    store.queue_transaction(t)
    assert store.read(CID, OID) == b"\0" * (4 * BLOCK)
    assert sum(store._alloc.bits) < used  # blocks actually freed
    # sparse write far out: no blocks for the hole
    _write(store, OID, 100 * BLOCK, b"tail")
    assert store.stat(CID, OID) == 100 * BLOCK + 4
    assert store.read(CID, OID, 50 * BLOCK, 8) == b"\0" * 8
    assert store.fsck() == []


def test_device_grows_on_demand(tmp_path):
    s = BlockStore(str(tmp_path / "small"), device_blocks=8)
    s.mkfs()
    s.mount()
    t = Transaction()
    t.create_collection(CID)
    s.queue_transaction(t)
    big = os.urandom(64 * BLOCK)
    _write(s, OID, 0, big)
    assert s.read(CID, OID) == big
    assert s._alloc.nblocks() >= 64
    assert s.fsck() == []
    s.umount()
