"""The port's group-commit pipeline over FileStore and BlockStore, case
for case against ``tests/test_store_groupcommit.py``: async
``queue_transaction``, batched WAL fsyncs, crash safety across the
append-to-fsync window, BlockStore's deferred frees.

``test_vstart_write_burst_async_commit_smoke`` (``:281``) runs on the
port's ``VStartCluster`` (``ceph_tpu_torch/vstart.py``, ``device="cpu"``)
over three FileStore daemons.
"""

import os
import struct
import threading
import time

import pytest

from ceph_tpu_torch.core.crc import crc32c
from ceph_tpu_torch.store.blockstore import BlockStore
from ceph_tpu_torch.store.filestore import FileStore, _WAL_HDR
from ceph_tpu_torch.store.objectstore import Collection, GHObject, Transaction

COLL = Collection("gc_test")


def _mk_store(tmp_path, **kw):
    s = FileStore(str(tmp_path / "fs"), **kw)
    s.mkfs()
    s.mount()
    t = Transaction()
    t.create_collection(COLL)
    s.queue_transaction(t)
    return s


def _write_txn(i: int, payload: bytes) -> Transaction:
    t = Transaction()
    g = GHObject(f"obj_{i}")
    t.touch(COLL, g)
    t.write(COLL, g, 0, payload)
    t.setattrs(COLL, g, {"tag": str(i).encode()})
    return t


# ---------------------------------------------------------------------------
# async completion semantics
# ---------------------------------------------------------------------------


def test_on_commit_fires_and_read_your_writes(tmp_path):
    s = _mk_store(tmp_path)
    fired = threading.Event()
    s.queue_transaction(_write_txn(0, b"x" * 100), on_commit=fired.set)
    # apply is synchronous: the write is readable immediately, even
    # before the commit callback has fired
    assert s.read(COLL, GHObject("obj_0")) == b"x" * 100
    assert fired.wait(5.0)
    s.umount()


def test_sync_caller_blocks_until_commit(tmp_path):
    s = _mk_store(tmp_path, wal_sync=True)
    seq = s.queue_transaction(_write_txn(0, b"y"))
    assert isinstance(seq, int)
    # the blocking call rode the pipeline: its batch was fsynced
    assert s.perf.dump()["wal_fsyncs"] >= 1
    s.umount()


def test_concurrent_commits_exactly_once_in_wal_order(tmp_path):
    """N threads submitting transactions each get on_commit exactly
    once, and completions fire in WAL (seq) order."""
    s = _mk_store(tmp_path, wal_sync=True)
    n_threads, per_thread = 6, 15
    fired = []  # oids in completion order
    flock = threading.Lock()
    seq_of = {}  # oid -> wal seq
    slock = threading.Lock()

    def worker(t_id: int) -> None:
        for j in range(per_thread):
            oid = f"{t_id}_{j}"
            t = Transaction()
            g = GHObject(oid)
            t.touch(COLL, g)
            t.write(COLL, g, 0, oid.encode())
            seq = s.queue_transaction(
                t, on_commit=lambda o=oid: _note(o))
            with slock:
                seq_of[oid] = seq

    def _note(oid: str) -> None:
        with flock:
            fired.append(oid)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    s._pipeline.flush()
    total = n_threads * per_thread
    assert len(fired) == total              # every completion fired
    assert len(set(fired)) == total         # ... exactly once
    seqs = [seq_of[o] for o in fired]
    assert seqs == sorted(seqs)             # ... in WAL order
    s.umount()


def test_one_fsync_serves_many_transactions(tmp_path):
    """The group-commit acceptance shape: freeze the commit thread,
    pile up async transactions, thaw — ONE WAL fsync commits them all
    (shown by the commit-batch histogram / fsync counter)."""
    s = _mk_store(tmp_path, wal_sync=True)
    s._pipeline.flush()
    base = s.perf.dump()["wal_fsyncs"]
    s._pipeline.freeze()
    done = []
    for i in range(24):
        s.queue_transaction(_write_txn(i, b"z" * 512),
                            on_commit=lambda i=i: done.append(i))
    assert done == []  # nothing commits inside the freeze window
    s._pipeline.thaw()
    s._pipeline.flush()
    assert sorted(done) == list(range(24))
    d = s.perf.dump()
    assert d["wal_fsyncs"] - base <= 2  # 24 txns, ~1 batch (+flush)
    hist = d["commit_batch"]
    assert hist["count"] >= 1 and hist["sum"] >= 24
    s.umount()


# ---------------------------------------------------------------------------
# crash safety: kill between WAL append and the batched fsync
# ---------------------------------------------------------------------------


def _append_raw_wal(path: str, seq: int, body: bytes) -> None:
    """Simulate a crash mid-apply: the WAL record landed, the apply
    (KV/data pages) did not — exactly the on-disk state replay heals."""
    with open(path, "ab") as f:
        f.write(_WAL_HDR.pack(seq, len(body), crc32c(body)) + body)


def test_crash_mid_batch_replays_acked_and_tolerates_torn_tail(tmp_path):
    """Kill the store between WAL append and the batched fsync:
    remount must (a) keep every acked write, (b) replay appended-but-
    unapplied records whole (per-transaction atomicity inside the
    batch), (c) stop cleanly at a torn record — no error, no partial
    transaction."""
    s = _mk_store(tmp_path, wal_sync=True)
    acked = []
    for i in range(4):
        s.queue_transaction(_write_txn(i, b"A" * 256),
                            on_commit=lambda i=i: acked.append(i))
    s._pipeline.flush()
    assert sorted(acked) == [0, 1, 2, 3]

    # freeze = the kill window: these records append but never fsync
    # and never ack
    s._pipeline.freeze()
    wal_path = s._wal_path
    last_seq = s._seq

    # a record that appended but whose apply was lost (crash mid-apply)
    t_unapplied = _write_txn(100, b"B" * 128)
    _append_raw_wal(wal_path, last_seq + 1, t_unapplied.to_bytes())
    # a torn record: the crash cut the batch mid-write
    t_torn = _write_txn(101, b"C" * 128)
    raw = t_torn.to_bytes()
    with open(wal_path, "ab") as f:
        f.write(_WAL_HDR.pack(last_seq + 2, len(raw), crc32c(raw)))
        f.write(raw[: len(raw) // 2])  # torn mid-body

    # "kill": abandon the mounted store object entirely (no umount —
    # umount would drain and sync), then remount the directory fresh
    s2 = FileStore(str(tmp_path / "fs"), wal_sync=True)
    s2.mount()
    # (a) every acked write survived
    for i in range(4):
        assert s2.read(COLL, GHObject(f"obj_{i}")) == b"A" * 256
        assert s2.getattr(COLL, GHObject(f"obj_{i}"), "tag") == \
            str(i).encode()
    # (b) the whole appended-but-unapplied transaction replayed
    assert s2.read(COLL, GHObject("obj_100")) == b"B" * 128
    assert s2.getattr(COLL, GHObject("obj_100"), "tag") == b"100"
    # (c) the torn transaction left NO trace (atomic: all or nothing)
    assert not s2.exists(COLL, GHObject("obj_101"))
    # and the store keeps working after replay
    s2.queue_transaction(_write_txn(200, b"D"))
    assert s2.read(COLL, GHObject("obj_200")) == b"D"
    s2.umount()


def test_unacked_tail_may_survive_but_never_tears(tmp_path):
    """Writes submitted in the kill window (appended, not fsynced, not
    acked) may or may not survive a crash — but each survives WHOLE or
    not at all."""
    s = _mk_store(tmp_path, wal_sync=True)
    s._pipeline.freeze()
    done = []
    th = threading.Thread(
        target=lambda: s.queue_transaction(_write_txn(7, b"E" * 64),
                                           on_commit=lambda: done.append(7)))
    th.start()
    th.join(1.0)
    assert done == []  # never acked inside the window
    s2 = FileStore(str(tmp_path / "fs"), wal_sync=True)
    s2.mount()
    if s2.exists(COLL, GHObject("obj_7")):
        # survived: then it must be complete (data AND attrs)
        assert s2.read(COLL, GHObject("obj_7")) == b"E" * 64
        assert s2.getattr(COLL, GHObject("obj_7"), "tag") == b"7"
    s2.umount()


# ---------------------------------------------------------------------------
# BlockStore: kv_sync_thread analog
# ---------------------------------------------------------------------------


def test_blockstore_async_commit_and_deferred_free(tmp_path):
    bs = BlockStore(str(tmp_path / "bs"), o_sync=True)
    bs.mkfs()
    bs.mount()
    t = Transaction()
    t.create_collection(COLL)
    bs.queue_transaction(t)
    fired = []
    for i in range(8):
        t = Transaction()
        g = GHObject(f"b_{i}")
        t.touch(COLL, g)
        t.write(COLL, g, 0, bytes([i]) * 5000)
        bs.queue_transaction(t, on_commit=lambda i=i: fired.append(i))
    # overwrite frees the old blobs -> deferred frees release at commit
    for i in range(8):
        t = Transaction()
        t.write(COLL, GHObject(f"b_{i}"), 0, bytes([i + 100]) * 5000)
        bs.queue_transaction(t, on_commit=lambda i=i: fired.append(100 + i))
    bs._pipeline.flush()
    assert sorted(fired) == sorted(list(range(8))
                                   + [100 + i for i in range(8)])
    for i in range(8):
        assert bs.read(COLL, GHObject(f"b_{i}")) == bytes([i + 100]) * 5000
    assert bs.fsck() == []  # allocator vs refs consistent post-release
    d = bs.perf.dump()
    assert d["queued_txns"] >= 17
    assert d["dev_fsyncs"] <= d["queued_txns"]
    bs.umount()


def test_blockstore_survives_reopen_after_async_burst(tmp_path):
    bs = BlockStore(str(tmp_path / "bs2"), o_sync=True)
    bs.mkfs()
    bs.mount()
    t = Transaction()
    t.create_collection(COLL)
    bs.queue_transaction(t)
    acked = threading.Event()
    t = Transaction()
    t.touch(COLL, GHObject("persist"))
    t.write(COLL, GHObject("persist"), 0, b"durable" * 100)
    bs.queue_transaction(t, on_commit=acked.set)
    assert acked.wait(5.0)
    bs.umount()
    bs2 = BlockStore(str(tmp_path / "bs2"), o_sync=True)
    bs2.mount()
    assert bs2.read(COLL, GHObject("persist")) == b"durable" * 100
    assert bs2.fsck() == []
    bs2.umount()


# ---------------------------------------------------------------------------
# 3-OSD vstart smoke: a write burst through the async commit path
# ---------------------------------------------------------------------------


def test_vstart_write_burst_async_commit_smoke(tmp_path):
    """A three-daemon durable-store cluster absorbs a 24-deep write burst
    through the async commit pipeline; the stores' counters show group
    commit (fewer WAL fsyncs than transactions)."""
    from ceph_tpu_torch.client.rados import OSDOp
    from ceph_tpu_torch.osd import types as t_
    from ceph_tpu_torch.vstart import VStartCluster

    payload = b"w" * 8192
    with VStartCluster(n_mons=1, n_osds=3, data_dir=str(tmp_path),
                       store_kind="filestore",
                       conf={"objectstore_wal_sync": True},
                       device="cpu") as c:
        pool = c.create_pool("smoke", size=2)
        io = c.client().ioctx(pool)
        # freeze every store's commit thread, pile a burst into the
        # window, thaw: acks only after the batched fsync
        before = {i: o.store.perf.dump() for i, o in c.osds.items()}
        for osd in c.osds.values():
            osd.store._pipeline.freeze()
        pend = [io.aio_operate(f"s_{i}",
                               [OSDOp(t_.OP_WRITEFULL, data=payload)])
                for i in range(24)]
        time.sleep(0.4)
        assert not any(p.event.is_set() for p in pend[:4]), \
            "acks leaked out of the frozen commit window"
        for osd in c.osds.values():
            osd.store._pipeline.thaw()
        for p in pend:
            rep = p.result(20.0)
            assert rep.result == 0
        assert io.read("s_0") == payload
        # group commit across the burst (counters diffed against the
        # pre-freeze ones): fsyncs < txns, and some batch held >= 2
        d_txns = d_fsyncs = 0
        multi_batches = 0
        for i, o in c.osds.items():
            now = o.store.perf.dump()
            d_txns += now["queued_txns"] - before[i]["queued_txns"]
            d_fsyncs += now["wal_fsyncs"] - before[i]["wal_fsyncs"]
            nb = now["commit_batch"]["buckets"]
            ob = before[i]["commit_batch"]["buckets"]
            # log2 buckets: index >= 2 means the batch held >= 2 txns
            multi_batches += sum(nb[2:]) - sum(ob[2:])
        assert d_txns >= 24
        assert d_fsyncs < d_txns, (d_fsyncs, d_txns)
        assert multi_batches >= 1, "no commit batch carried >1 txn"
