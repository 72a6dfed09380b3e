"""The port's LSMStore (``ceph_tpu_torch/store/lsm.py``), case for case
against ``tests/test_lsm.py``: a dataset larger than the memtable bound,
restart replay, tombstones, merge iteration, compaction, the torn WAL
tail, BlockStore on the LSM, the bloom filter and a v1 table without
one.  ``test_torch_store_xcheck.py`` holds its files to the
reference's."""

import os

import pytest

from ceph_tpu_torch.store.kv import WriteBatch
from ceph_tpu_torch.store.lsm import LSMStore


@pytest.fixture()
def db(tmp_path):
    d = LSMStore(str(tmp_path / "lsm"), memtable_bytes=16 << 10,
                 compact_tables=4)
    d.open()
    yield d
    d.close()


def _put(db, prefix, key, val):
    b = WriteBatch()
    b.set(prefix, key, val)
    db.submit(b)


def test_dataset_exceeds_memtable_and_survives_restart(tmp_path):
    """The VERDICT-r3 'done' scenario: dataset >> memtable bound, with
    RAM holding only the active memtable + sparse indexes; restart
    reopens tables from MANIFEST and replays the WAL tail."""
    path = str(tmp_path / "big")
    db = LSMStore(path, memtable_bytes=8 << 10, compact_tables=100)
    db.open()
    n = 2000  # ~2000 * (9 + 64) bytes >> 8 KiB memtable
    for i in range(n):
        _put(db, "P", f"k{i:06d}", f"v{i}".encode() * 16)
    st = db.stats()
    assert st["tables"] >= 2, st  # it spilled
    assert st["memtable_bytes"] <= 8 << 10
    db.close()

    db2 = LSMStore(path, memtable_bytes=8 << 10)
    db2.open()
    for i in (0, 1, 777, n - 1):
        assert db2.get("P", f"k{i:06d}") == f"v{i}".encode() * 16
    keys = [k for k, _ in db2.iterate("P")]
    assert len(keys) == n and keys == sorted(keys)
    db2.close()


def test_tombstones_shadow_older_tables(db):
    _put(db, "A", "x", b"first")
    db.flush()  # value now lives in a table
    b = WriteBatch()
    b.rmkey("A", "x")
    db.submit(b)
    assert db.get("A", "x") is None  # memtable tombstone shadows table
    db.flush()
    assert db.get("A", "x") is None  # tombstone table shadows value table
    assert list(db.iterate("A")) == []


def test_newest_table_wins(db):
    _put(db, "A", "k", b"old")
    db.flush()
    _put(db, "A", "k", b"new")
    db.flush()
    assert db.get("A", "k") == b"new"
    assert list(db.iterate("A")) == [("k", b"new")]


def test_compaction_collapses_tables_and_drops_tombstones(db):
    for i in range(8):
        _put(db, "C", f"k{i}", b"v%d" % i)
        db.flush()
    b = WriteBatch()
    b.rmkey("C", "k3")
    db.submit(b)
    db.compact()
    assert db.stats()["tables"] == 1
    assert db.get("C", "k3") is None
    assert [k for k, _ in db.iterate("C")] == [
        f"k{i}" for i in range(8) if i != 3]
    # tombstone physically gone: the single table has 7 records
    t = db._tables[0]
    assert sum(1 for _ in t.iterate()) == 7


def test_wal_torn_tail_truncated(tmp_path):
    path = str(tmp_path / "torn")
    db = LSMStore(path)
    db.open()
    _put(db, "T", "good", b"ok")
    db.close()
    with open(os.path.join(path, "wal.log"), "ab") as f:
        f.write(b"\x40\x00\x00\x00garbage-torn-tail")
    db2 = LSMStore(path)
    db2.open()
    assert db2.get("T", "good") == b"ok"
    _put(db2, "T", "after", b"fine")  # log still appendable
    db2.close()


def test_snapshot_stable_against_flush_and_writes(db):
    _put(db, "S", "a", b"1")
    snap = db.snapshot()
    _put(db, "S", "a", b"2")
    _put(db, "S", "b", b"3")
    db.flush()
    assert snap.get("S", "a") == b"1"
    assert [k for k, _ in snap.iterate("S")] == ["a"]
    assert db.get("S", "a") == b"2"


def test_seekable_iterator(db):
    for k in ("aa", "bb", "cc", "dd"):
        _put(db, "I", k, k.encode())
    db.flush()
    it = db.get_iterator("I")
    it.lower_bound("bb")
    assert it.valid() and it.key() == "bb"
    it.next()
    assert it.key() == "cc"


def test_blockstore_on_lsm(tmp_path):
    """BlockStore metadata over the LSM store: object write/read
    roundtrip + remount (the BlueStore-over-RocksDB pairing)."""
    from ceph_tpu_torch.store.blockstore import BlockStore
    from ceph_tpu_torch.store.objectstore import Collection, GHObject, Transaction

    bs = BlockStore(str(tmp_path / "bs"), kv_kind="lsm")
    bs.mkfs()
    bs.mount()
    coll = Collection("1.0_head")
    t = Transaction()
    t.create_collection(coll)
    t.touch(coll, GHObject("o1"))
    t.write(coll, GHObject("o1"), 0, b"lsm-backed" * 100)
    bs.queue_transaction(t)
    assert bs.read(coll, GHObject("o1")) == b"lsm-backed" * 100
    bs.umount()
    bs2 = BlockStore(str(tmp_path / "bs"), kv_kind="lsm")
    bs2.mount()
    assert bs2.read(coll, GHObject("o1")) == b"lsm-backed" * 100
    assert bs2.fsck() == []
    bs2.umount()


def test_bloom_filter_skips_absent_keys(tmp_path):
    """v2 SSTables carry a bloom filter: point misses answer without a
    data-file scan (the RocksDB BloomFilterPolicy role)."""
    from ceph_tpu_torch.store.lsm import LSMStore, SSTable

    db = LSMStore(str(tmp_path / "bloomdb"), memtable_bytes=1024)
    db.open()
    b = WriteBatch()
    for i in range(500):
        b.set("P", f"key{i:04d}", f"val{i}".encode())
    db.submit(b)
    db.flush()
    assert db._tables, "flush should have produced an sstable"
    t = db._tables[0]
    base = t.data_scans
    # hits scan
    found, v = t.get("P\x00key0123")
    assert found and v == b"val123"
    assert t.data_scans == base + 1
    # misses: ~1% FP rate means 200 absent keys trigger at most a few
    scans_before = t.data_scans
    for i in range(200):
        found, _ = t.get(f"P\x00nope{i:04d}")
        assert not found
    assert t.data_scans - scans_before <= 8
    db.close()

    # restart reloads the filter from disk
    db2 = LSMStore(str(tmp_path / "bloomdb"), memtable_bytes=1024)
    db2.open()
    t2 = db2._tables[0]
    assert t2._bloom_bits > 0
    for i in range(50):
        assert not t2.get(f"P\x00nada{i}")[0]
    assert t2.data_scans <= 3
    assert db2.get("P", "key0001") == b"val1"
    db2.close()


def test_v1_sstable_without_bloom_still_loads(tmp_path):
    """Back-compat: a pre-bloom (v1-footer) table loads and serves."""
    import struct as _s

    from ceph_tpu_torch.store import lsm as L

    path = str(tmp_path / "v1.sst")
    # hand-write a v1 table: records + sparse index + v1 footer
    items = [(f"k{i:03d}", f"v{i}".encode()) for i in range(100)]
    index = []
    with open(path, "wb") as f:
        for i, (k, v) in enumerate(items):
            if i % L.SSTable.SPARSE == 0:
                index.append((k, f.tell()))
            kb = k.encode()
            f.write(L._REC.pack(len(kb), len(v)) + kb + v)
        idx_off = f.tell()
        parts = []
        for k, off in index:
            kb = k.encode()
            parts += [_s.pack("<I", len(kb)), kb, _s.pack("<Q", off)]
        blob = b"".join(parts)
        f.write(blob)
        from ceph_tpu_torch.core.crc import crc32c
        f.write(L._FOOTER.pack(idx_off, len(index), crc32c(blob),
                               L._MAGIC))
    t = L.SSTable(path)
    assert t._bloom_bits == 0
    assert t.get("k042") == (True, b"v42")
    assert t.get("zzz")[0] is False
    assert sorted(k for k, _ in t.iterate())[0] == "k000"
