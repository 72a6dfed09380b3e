"""The port's object store (``ceph_tpu_torch/store/``), case for case
against ``tests/test_store.py`` (its fixture cases over ``memstore``,
``filestore`` and ``blockstore``; the FileStore remount and WAL replay;
the KV cases over ``LogKV`` and ``MemDB``), and
``tests/test_dencoder.py::test_v1_extent_seals_decodes_and_reencodes_byte_stable``,
which reads the committed corpus blob in place.
"""

import binascii
import os

import pytest

from ceph_tpu_torch.core.crc import crc32c
from ceph_tpu_torch.store import create
from ceph_tpu_torch.store.kv import LogKV, MemDB, WriteBatch
from ceph_tpu_torch.store.objectstore import (
    Collection,
    ExtentSeals,
    GHObject,
    NoSuchCollection,
    NoSuchObject,
    StoreError,
    Transaction,
)

CID = Collection("1.0_head")
OID = GHObject("obj1")
V1_CORPUS = os.path.join(os.path.dirname(__file__), "corpus_v1")


@pytest.fixture(params=["memstore", "filestore", "blockstore"])
def store(request, tmp_path):
    s = create(request.param, path=str(tmp_path / "store"))
    s.mkfs()
    s.mount()
    yield s
    s.umount()


def _mkcoll(store, cid=CID):
    t = Transaction()
    t.create_collection(cid)
    store.queue_transaction(t)


def test_write_read_roundtrip(store):
    _mkcoll(store)
    t = Transaction()
    t.write(CID, OID, 0, b"hello world")
    store.queue_transaction(t)
    assert store.read(CID, OID) == b"hello world"
    assert store.stat(CID, OID) == 11
    assert store.read(CID, OID, 6, 5) == b"world"
    # sparse write extends with zeros
    t = Transaction()
    t.write(CID, OID, 20, b"XY")
    store.queue_transaction(t)
    assert store.read(CID, OID) == b"hello world" + b"\0" * 9 + b"XY"


def test_zero_truncate_remove(store):
    _mkcoll(store)
    t = Transaction()
    t.write(CID, OID, 0, b"A" * 16)
    t.zero(CID, OID, 4, 8)
    t.truncate(CID, OID, 10)
    store.queue_transaction(t)
    assert store.read(CID, OID) == b"AAAA" + b"\0" * 6
    t = Transaction()
    t.remove(CID, OID)
    store.queue_transaction(t)
    assert not store.exists(CID, OID)
    with pytest.raises(NoSuchObject):
        store.read(CID, OID)


def test_xattr_omap(store):
    _mkcoll(store)
    t = Transaction()
    t.touch(CID, OID)
    t.setattrs(CID, OID, {"_": b"oi", "snapset": b"ss"})
    t.omap_setkeys(CID, OID, {"k1": b"v1", "k2": b"v2"})
    store.queue_transaction(t)
    assert store.getattr(CID, OID, "_") == b"oi"
    assert store.getattrs(CID, OID) == {"_": b"oi", "snapset": b"ss"}
    assert store.omap_get(CID, OID) == {"k1": b"v1", "k2": b"v2"}
    assert store.omap_get_values(CID, OID, ["k2", "nope"]) == {"k2": b"v2"}
    t = Transaction()
    t.rmattr(CID, OID, "snapset")
    t.omap_rmkeys(CID, OID, ["k1"])
    store.queue_transaction(t)
    assert store.getattrs(CID, OID) == {"_": b"oi"}
    assert store.omap_get(CID, OID) == {"k2": b"v2"}
    t = Transaction()
    t.omap_clear(CID, OID)
    store.queue_transaction(t)
    assert store.omap_get(CID, OID) == {}


def test_clone_and_move(store):
    _mkcoll(store)
    dst_cid = Collection("1.0_temp")
    _mkcoll(store, dst_cid)
    t = Transaction()
    t.write(CID, OID, 0, b"payload")
    t.setattrs(CID, OID, {"a": b"1"})
    t.omap_setkeys(CID, OID, {"m": b"2"})
    store.queue_transaction(t)

    clone = GHObject("obj1", snap=4)
    t = Transaction()
    t.clone(CID, OID, clone)
    store.queue_transaction(t)
    assert store.read(CID, clone) == b"payload"
    assert store.getattrs(CID, clone) == {"a": b"1"}
    # clone is independent
    t = Transaction()
    t.write(CID, OID, 0, b"PAYLOAD")
    store.queue_transaction(t)
    assert store.read(CID, clone) == b"payload"

    t = Transaction()
    t.coll_move_rename(CID, clone, dst_cid, GHObject("moved"))
    store.queue_transaction(t)
    assert not store.exists(CID, clone)
    assert store.read(dst_cid, GHObject("moved")) == b"payload"
    assert store.omap_get(dst_cid, GHObject("moved")) == {"m": b"2"}


def test_collections(store):
    _mkcoll(store)
    assert store.collection_exists(CID)
    assert CID in store.list_collections()
    t = Transaction()
    t.touch(CID, GHObject("a"))
    t.touch(CID, GHObject("b", shard=2))
    store.queue_transaction(t)
    objs = store.collection_list(CID)
    assert GHObject("a") in objs and GHObject("b", shard=2) in objs
    with pytest.raises(NoSuchCollection):
        store.collection_list(Collection("nope"))
    with pytest.raises(StoreError):
        _mkcoll(store)  # duplicate create


def test_transaction_encode_roundtrip():
    t = Transaction()
    t.create_collection(CID)
    t.write(CID, OID, 8, b"\x01\x02")
    t.setattrs(CID, OID, {"k": b"v"})
    t.omap_rmkeys(CID, OID, ["x", "y"])
    t.clone(CID, OID, GHObject("c", snap=1, shard=3))
    t2 = Transaction.from_bytes(t.to_bytes())
    assert len(t2) == len(t)
    for a, b in zip(t.ops, t2.ops):
        assert (a.op, a.cid, a.oid, a.off, a.length, a.data, a.attrs,
                a.keys, a.dest_cid, a.dest_oid) == (
               b.op, b.cid, b.oid, b.off, b.length, b.data, b.attrs,
               b.keys, b.dest_cid, b.dest_oid)


# -- durability -------------------------------------------------------------


def test_filestore_survives_remount(tmp_path):
    path = str(tmp_path / "fs")
    s = create("filestore", path=path)
    s.mkfs()
    s.mount()
    _mkcoll(s)
    t = Transaction()
    t.write(CID, OID, 0, b"durable")
    t.setattrs(CID, OID, {"a": b"b"})
    s.queue_transaction(t)
    s.umount()

    s2 = create("filestore", path=path)
    s2.mount()
    assert s2.read(CID, OID) == b"durable"
    assert s2.getattr(CID, OID, "a") == b"b"
    s2.umount()


def test_filestore_wal_replay_after_crash(tmp_path):
    """Kill without umount: WAL newer than applied_seq replays on mount."""
    path = str(tmp_path / "fs")
    s = create("filestore", path=path)
    s.mkfs()
    s.mount()
    _mkcoll(s)
    t = Transaction()
    t.write(CID, OID, 0, b"committed")
    s.queue_transaction(t)
    # simulate crash: forcibly roll the KV back by rewriting applied_seq,
    # as if the metadata batch never hit the KV (the WAL survives)
    b = WriteBatch()
    b.set("S", "applied_seq", b"0")
    s._kv.submit(b)
    s._kv.close()
    s._wal_fh.close()

    s2 = create("filestore", path=path)
    s2.mount()
    assert s2.read(CID, OID) == b"committed"
    s2.umount()


def test_logkv_torn_tail_discarded(tmp_path):
    path = str(tmp_path / "kv.log")
    kv = LogKV(path)
    kv.open()
    b = WriteBatch()
    b.set("p", "good", b"1")
    kv.submit(b)
    kv.close()
    # append garbage (torn write)
    with open(path, "ab") as f:
        f.write(b"\xde\xad\xbe\xef-torn")
    kv2 = LogKV(path)
    kv2.open()
    assert kv2.get("p", "good") == b"1"
    # log usable after truncating the torn tail
    b = WriteBatch()
    b.set("p", "more", b"2")
    kv2.submit(b)
    kv2.close()
    kv3 = LogKV(path)
    kv3.open()
    assert kv3.get("p", "more") == b"2"
    kv3.close()


def test_logkv_compaction_preserves_state(tmp_path):
    kv = LogKV(str(tmp_path / "kv.log"))
    kv.open()
    for i in range(10):
        b = WriteBatch()
        b.set("p", f"k{i}", str(i).encode())
        if i % 2:
            b.rmkey("p", f"k{i - 1}")
        kv.submit(b)
    kv.compact()
    assert dict(kv.iterate("p")) == {
        f"k{i}": str(i).encode() for i in (1, 3, 5, 7, 9)
    }
    kv.close()
    kv2 = LogKV(str(tmp_path / "kv.log"))
    kv2.open()
    assert kv2.get("p", "k9") == b"9"
    kv2.close()


def test_memdb_batch():
    db = MemDB()
    db.open()
    b = WriteBatch()
    b.set("a", "x", b"1")
    b.set("b", "x", b"2")
    b.rmkey("a", "nope")
    db.submit(b)
    assert db.get("a", "x") == b"1"
    assert db.get("b", "x") == b"2"
    assert list(db.iterate("a")) == [("x", b"1")]


def test_transaction_atomicity_all_or_nothing(store):
    """A failing op mid-transaction must leave NO partial effects."""
    _mkcoll(store)
    t = Transaction()
    t.write(CID, OID, 0, b"partial")
    t.remove(CID, GHObject("does-not-exist"))
    with pytest.raises(NoSuchObject):
        store.queue_transaction(t)
    assert not store.exists(CID, OID)  # the write did not land


def test_rmcoll_nonempty_refused(store):
    _mkcoll(store)
    t = Transaction()
    t.touch(CID, OID)
    store.queue_transaction(t)
    t = Transaction()
    t.remove_collection(CID)
    with pytest.raises(StoreError):
        store.queue_transaction(t)
    assert store.collection_exists(CID)


def test_same_txn_setattr_then_clone(store):
    """Metadata written earlier in a txn is visible to clone later in it."""
    _mkcoll(store)
    t = Transaction()
    t.write(CID, OID, 0, b"d")
    t.setattrs(CID, OID, {"hinfo": b"\x01"})
    t.omap_setkeys(CID, OID, {"k": b"v"})
    t.clone(CID, OID, GHObject("obj1", snap=7))
    store.queue_transaction(t)
    assert store.getattrs(CID, GHObject("obj1", snap=7)) == {"hinfo": b"\x01"}
    assert store.omap_get(CID, GHObject("obj1", snap=7)) == {"k": b"v"}


def test_same_txn_setattr_then_remove_no_resurrect(store):
    _mkcoll(store)
    t = Transaction()
    t.touch(CID, OID)
    store.queue_transaction(t)
    t = Transaction()
    t.setattrs(CID, OID, {"ghost": b"1"})
    t.remove(CID, OID)
    store.queue_transaction(t)
    t = Transaction()
    t.touch(CID, OID)  # re-create same name
    store.queue_transaction(t)
    assert store.getattrs(CID, OID) == {}  # no stale attr resurrects



def test_create_refuses_unknown_kind():
    with pytest.raises(ValueError, match="unknown objectstore"):
        create("nosuchstore")


def test_v1_extent_seals_decodes_and_reencodes_byte_stable():
    """The at-rest per-extent checksum record: the golden v1 blob
    (extent_size 16, three crc32c seals: two full extents and a 2-byte
    tail) decodes with exact content and re-encodes byte for byte."""
    with open(os.path.join(V1_CORPUS, "ExtentSeals_v1.hex")) as f:
        blob = binascii.unhexlify(f.read().strip())
    seals = ExtentSeals.from_bytes(blob)
    assert seals.extent_size == 16
    assert seals.crcs == [crc32c(b"A" * 16), crc32c(b"B" * 16),
                          crc32c(b"CC")]
    assert seals.to_bytes() == blob, "seal re-encode is not byte-stable"


def test_commit_pipeline_batches_in_order_like_the_reference():
    """The group-commit thread the durable backends share: while frozen,
    submissions pile up; on thaw one sync serves the whole batch and the
    completions fire in submission order, in both packages; the batch
    passes the store.commit_batch.sync failpoint; a submit after stop
    commits inline."""
    import threading

    from ceph_tpu.store.objectstore import CommitPipeline as RefPipeline
    from ceph_tpu_torch.core import failpoint as fp
    from ceph_tpu_torch.core.perf import PerfCounters
    from ceph_tpu_torch.store.objectstore import CommitPipeline

    def run(cls, perf=None):
        syncs, order = [], []
        pipe = cls(lambda: syncs.append(len(order)), perf=perf)
        pipe.start()
        pipe.freeze()
        for seq in range(8):
            pipe.submit(seq, lambda s=seq: order.append(s))
        done = threading.Event()
        pipe.submit(8, done.set)
        assert order == [] and not done.is_set()
        pipe.thaw()
        assert done.wait(10)
        pipe.flush()
        pipe.stop()
        pipe.submit(9, lambda: order.append(9))  # after stop: inline
        return syncs, order

    pc = PerfCounters("store")
    pc.add_histogram("commit_batch")
    pc.add_time_avg("commit_lat")
    fp.disarm_all()
    fp.arm("store.commit_batch.sync", fp.sleep_ms(0))
    try:
        got = run(CommitPipeline, pc)
        assert fp.hits("store.commit_batch.sync") == 2  # the batch, the flush
    finally:
        fp.disarm_all()
    assert got == run(RefPipeline)
    assert got == ([0, 8, 8], [0, 1, 2, 3, 4, 5, 6, 7, 9])
    assert pc.dump()["commit_batch"]["sum"] == 10  # 9 + the flush marker


def test_kv_iterator_seek_surface():
    db = MemDB()
    db.open()
    b = WriteBatch()
    for k in ("a", "b", "d", "e"):
        b.set("P", k, k.encode())
    db.submit(b)
    it = db.get_iterator("P")
    it.seek_to_first()
    assert it.valid() and it.key() == "a"
    it.lower_bound("c")
    assert it.key() == "d"
    it.upper_bound("d")
    assert it.key() == "e"
    it.next()
    assert not it.valid()
    it.seek_to_last()
    assert it.key() == "e"
    it.prev()
    assert it.key() == "d"
    # iterators are stable views: later writes don't appear
    b2 = WriteBatch()
    b2.set("P", "c", b"c")
    db.submit(b2)
    it.seek_to_first()
    keys = []
    while it.valid():
        keys.append(it.key())
        it.next()
    assert keys == ["a", "b", "d", "e"]  # no "c" in the old view
    it2 = db.get_iterator("P")
    it2.lower_bound("c")
    assert it2.key() == "c"


def test_kv_snapshot_isolated_from_writes(tmp_path):
    db = LogKV(str(tmp_path / "kv.log"))
    db.open()
    b = WriteBatch()
    b.set("P", "x", b"1")
    db.submit(b)
    snap = db.snapshot()
    b2 = WriteBatch()
    b2.set("P", "x", b"2")
    b2.set("P", "y", b"3")
    db.submit(b2)
    assert snap.get("P", "x") == b"1"
    assert snap.get("P", "y") is None
    assert dict(snap.iterate("P")) == {"x": b"1"}
    assert db.get("P", "x") == b"2"
    it = snap.get_iterator("P")
    it.seek_to_first()
    assert it.key() == "x" and it.value() == b"1"
    db.close()
