"""FileStore — durable file-backed ObjectStore with a write-ahead log.

Plays the reference's FileStore/BlueStore role (src/os/filestore/,
src/os/bluestore/) with the BlueStore split: object *data* lives in
flat files (one per object, the "block device"), object *metadata*
(existence, xattrs, omap, collection membership) lives in a LogKV
(the RocksDB role).  Atomicity follows the FileJournal discipline
(src/os/filestore/FileJournal.cc): every Transaction is appended to a
WAL with seq + crc before any apply; on mount, WAL entries newer than
the KV's `applied_seq` are replayed (apply is replay-tolerant), then
the WAL is trimmed.

Port of ``ceph_tpu/store/filestore.py``: the WAL, the data files, the
extent seals and the KV log are the reference's byte for byte.  A
``gpu.staging.DeviceBuf`` payload reaches a data file through
``op_payload``, which counts its one fetch.
"""

from __future__ import annotations

import hashlib
import os
import struct
import threading
from typing import Dict, List, Optional

from ceph_tpu_torch.core.crc import crc32c
from ceph_tpu_torch.core.failpoint import enabled as fp_enabled, failpoint
from ceph_tpu_torch.core.lockdep import make_lock
from ceph_tpu_torch.core.encoding import Decoder, Encoder
from ceph_tpu_torch.core.perf import PerfCounters
from ceph_tpu_torch.store import objectstore as os_
from ceph_tpu_torch.store.kv import LogKV, WriteBatch
from ceph_tpu_torch.store.objectstore import (
    Collection,
    CommitPipeline,
    GHObject,
    NoSuchCollection,
    NoSuchObject,
    ObjectStore,
    StoreError,
    Transaction,
    validate_op,
)

# KV prefixes
P_COLL = "C"    # coll name -> b"1"
P_OBJ = "O"     # objkey -> b"1" (existence)
P_XATTR = "X"   # objkey/attr -> value
P_OMAP = "M"    # objkey/key -> value
P_META = "S"    # store metadata (applied_seq)
P_SEAL = "K"    # objkey -> encoded ExtentSeals (at-rest extent crcs)

_WAL_HDR = struct.Struct("<QII")  # seq, body_len, crc


def _objkey(cid: Collection, oid: GHObject) -> str:
    return f"{cid.name}/{oid.name}/{oid.snap}/{oid.shard}"


_COMP_MAGIC = b"CPRS"  # compressed-file header magic


def _has_magic(data) -> bool:
    """data may be bytes OR a zero-copy buffer view (memoryview/numpy
    from a DeviceBuf store sink) — startswith without materializing."""
    return bytes(data[:len(_COMP_MAGIC)]) == _COMP_MAGIC


class FileStore(ObjectStore):
    def __init__(self, path: str, wal_sync: bool = False,
                 compression: str | None = None) -> None:
        self.path = path
        self.wal_sync = wal_sync
        # filestore_debug_inject_read_err wiring (reference
        # 'injectdataerr' admin hook): when the conf enables the
        # mechanism, reads of objects marked bad raise EIO — and the
        # generic store.filestore.read failpoint can inject without
        # any marking at all (match(oid=...) in the arming spec)
        self.debug_read_err_enabled = False
        self._read_err_objs: set = set()
        self._kv = LogKV(os.path.join(path, "meta.kv"))
        self._wal_path = os.path.join(path, "wal.log")
        self._wal_fh = None
        self._seq = 0
        self._lock = make_lock("filestore")
        self._mounted = False
        # inline object-data compression (the BlueStore-compression
        # role, reference src/compressor/ + BlueStore blob compression):
        # whole-file writes compress when they save >= 1/8 (the
        # reference's required_ratio); extent updates decompress once
        # and store raw until the next full rewrite
        self._comp = None
        if compression and compression != "none":
            from ceph_tpu_torch.compress import instance as _comp_registry

            self._comp = _comp_registry().factory(compression)
        # group-commit instrumentation (reference PerfCounters over the
        # FileJournal: journal_wr batching, commit latency) — daemons
        # register this set into their context's collection
        pc = PerfCounters("filestore")
        pc.add_u64_counter("queued_txns", "transactions submitted")
        pc.add_u64_counter("wal_fsyncs", "batched WAL fsyncs issued")
        pc.add_histogram("commit_batch", "transactions per commit batch")
        pc.add_time_avg("commit_lat", "batched sync+completion seconds")
        pc.add_u64_counter("read_verify_fail",
                           "reads failing at-rest extent verification")
        self.perf = pc
        self._pipeline = CommitPipeline(self._commit_sync, perf=pc)

    # -- layout -----------------------------------------------------------
    def _datafile(self, cid: Collection, oid: GHObject) -> str:
        h = hashlib.sha1(_objkey(cid, oid).encode()).hexdigest()
        return os.path.join(self.path, "objects", h[:2], h)

    # -- lifecycle --------------------------------------------------------
    def mkfs(self) -> None:
        os.makedirs(os.path.join(self.path, "objects"), exist_ok=True)
        open(self._wal_path, "wb").close()
        self._kv.open()
        b = WriteBatch()
        b.set(P_META, "applied_seq", b"0")
        self._kv.submit(b, sync=True)
        self._kv.close()

    def mount(self) -> None:
        with self._lock:
            self._kv.open()
            applied = int(self._kv.get(P_META, "applied_seq") or b"0")
            self._seq = applied
            self._replay_wal(applied)
            self._sync_state()
            self._trim_wal()  # replay is fully applied + state synced
            self._wal_fh = open(self._wal_path, "ab")
            self._mounted = True
        self._pipeline.start()

    def umount(self) -> None:
        # drain the commit pipeline FIRST: every submitted completion
        # fires (with its batched fsync) before the WAL handle closes
        self._pipeline.stop()
        with self._lock:
            if self._wal_fh:
                self._wal_fh.close()
                self._wal_fh = None
            self._sync_state()
            self._trim_wal()
            self._kv.close()
            self._mounted = False

    def _replay_wal(self, applied: int) -> None:
        if not os.path.exists(self._wal_path):
            return
        with open(self._wal_path, "rb") as f:
            raw = f.read()
        off = 0
        while off + _WAL_HDR.size <= len(raw):
            seq, blen, want = _WAL_HDR.unpack_from(raw, off)
            body = raw[off + _WAL_HDR.size: off + _WAL_HDR.size + blen]
            if len(body) < blen or crc32c(body) != want:
                break  # torn tail
            if seq > applied:
                t = Transaction.from_bytes(body)
                self._apply(t, seq, replay=True)
            self._seq = max(self._seq, seq)
            off += _WAL_HDR.size + blen

    def _trim_wal(self) -> None:
        open(self._wal_path, "wb").close()

    # -- transaction apply ------------------------------------------------
    def queue_transaction(self, t: Transaction, on_commit=None) -> int:
        """All-or-nothing: validate against lazy KV-backed overlays
        BEFORE the WAL append, so a failing op neither logs nor mutates
        anything; the mutation pass then cannot fail (crash mid-apply is
        healed by full WAL replay on the next mount).

        Group commit (the FileJournal discipline): the submitter
        appends the WAL record and applies — reads see the write on
        return — but durability is the commit thread's: it fsyncs the
        WAL once for every record appended since the last batch, then
        fires the batch's `on_commit` callbacks in WAL order.  With no
        callback the call blocks on its own completion, still sharing
        the batched fsync with concurrent submitters."""
        done = None
        inline = False
        with self._lock:
            assert self._mounted, "not mounted"
            self._validate(t)
            self._seq += 1
            seq = self._seq
            body = t.to_bytes()
            self._wal_fh.write(_WAL_HDR.pack(seq, len(body), crc32c(body)))
            self._wal_fh.write(body)
            self._wal_fh.flush()
            self._apply(t, seq, replay=False)
            self.perf.inc("queued_txns")
            # submit INSIDE the lock: pending order must equal WAL seq
            # order or completions could fire out of order
            if on_commit is None:
                if self._pipeline.in_commit_thread():
                    # a commit callback re-entering the store
                    # synchronously must not wait on its own thread
                    inline = True
                else:
                    done = threading.Event()
                    self._pipeline.submit(seq, done.set)
            else:
                self._pipeline.submit(seq, on_commit)
        if inline:
            self._commit_sync()
        elif done is not None:
            done.wait()
        return seq

    def _commit_sync(self) -> None:
        """One batched durability point (commit-thread only): a single
        WAL fsync covers every record appended since the last batch."""
        with self._lock:
            if self._wal_fh is None:
                return
            self._wal_fh.flush()
            if self.wal_sync:
                os.fsync(self._wal_fh.fileno())
                self.perf.inc("wal_fsyncs")
            # everything through the newest appended seq is applied, so
            # the log before here is dead weight — but the WAL is the
            # ONLY durable copy of unsynced KV/data pages, so make them
            # durable before discarding it (else a post-trim power loss
            # loses fsynced commits the journal was paid to protect)
            if self._wal_fh.tell() > (64 << 20):
                self._sync_state()
                self._wal_fh.close()
                self._trim_wal()
                self._wal_fh = open(self._wal_path, "ab")

    def _sync_state(self) -> None:
        if self._kv._fh is not None:
            self._kv._fh.flush()
            os.fsync(self._kv._fh.fileno())
        if self.wal_sync and hasattr(os, "sync"):
            os.sync()  # data files aren't individually tracked; flush all

    def _validate(self, t: Transaction) -> None:
        kv = self._kv

        class Overlay(os_.ValidationOverlay):
            def _base_coll(self, name):
                return kv.get(P_COLL, name) is not None

            def _base_obj(self, name, oid):
                return kv.get(
                    P_OBJ, _objkey(Collection(name), oid)) is not None

            def _base_count(self, name):
                # paid only when the txn contains an RMCOLL
                pre = name + "/"
                return sum(
                    1 for k, _ in kv.iterate(P_OBJ) if k.startswith(pre)
                )

        ov = Overlay()
        for op in t.ops:
            validate_op(op, ov)

    def _apply(self, t: Transaction, seq: int, replay: bool) -> None:
        # extent-seal plan reads PRE-apply sizes; the seal rows land in
        # the same final batch as applied_seq, so a torn apply replays
        # the whole txn — data AND seals — from the WAL
        plan = self._seal_plan(t, self._size_locked)
        # one KV submit per op: later ops in the same transaction (clone,
        # remove, rename) must see metadata written by earlier ones
        for op in t.ops:
            b = WriteBatch()
            self._apply_op(op, b, replay)
            if b.ops:
                self._kv.submit(b)
        b = WriteBatch()
        self._reseal(plan, b, full=replay)
        b.set(P_META, "applied_seq", str(seq).encode())
        self._kv.submit(b)

    def _reseal(self, plan, b: WriteBatch, full: bool) -> None:
        """Post-apply half of the seal transaction.  On WAL replay the
        pre-state the plan saw may itself be a torn partial apply, so
        every planned object reseals in FULL from its actual bytes —
        replay converges seals to file content no matter where the
        crash landed."""
        for (cid, oid), mark in plan.items():
            key = _objkey(cid, oid)
            size = self._size_locked(cid, oid)
            if mark.drop or size is None:
                b.rmkey(P_SEAL, key)
                continue
            if full:
                mark.full = True
            path = self._datafile(cid, oid)
            if self._file_compressed(path):
                content = self._load_file(path)

                def read_fn(s, ln, c=content):
                    return c[s:s + ln]
            else:
                def read_fn(s, ln, p=path):
                    if not os.path.exists(p):
                        return b""
                    with open(p, "rb") as f:
                        f.seek(s)
                        return f.read(ln)
            old = (None if (mark.full or mark.fresh)
                   else self._kv.get(P_SEAL, key))
            b.set(P_SEAL, key,
                  self._seal_rebuild(mark, size, read_fn, old))

    def _coll_exists(self, cid: Collection) -> bool:
        return self._kv.get(P_COLL, cid.name) is not None

    def _exists_kv(self, cid: Collection, oid: GHObject) -> bool:
        return self._kv.get(P_OBJ, _objkey(cid, oid)) is not None

    def _require(self, cid: Collection, oid: GHObject, replay: bool) -> bool:
        """True if present; on replay missing objects are tolerated.
        Non-replay misses can't happen (validated), but raise anyway."""
        if not self._coll_exists(cid):
            if replay:
                return False
            raise NoSuchCollection(cid.name)
        if not self._exists_kv(cid, oid):
            if replay:
                return False
            raise NoSuchObject(f"{cid.name}/{oid.name}")
        return True

    def _apply_op(self, op: os_.Op, b: WriteBatch, replay: bool) -> None:
        code = op.op
        key = _objkey(op.cid, op.oid) if op.oid else ""
        if code == os_.OP_NOP:
            return
        if code == os_.OP_MKCOLL:
            if self._coll_exists(op.cid) and not replay:
                raise StoreError(f"collection exists: {op.cid.name}")
            b.set(P_COLL, op.cid.name, b"1")
            return
        if code == os_.OP_RMCOLL:
            # emptiness enforced by _validate (parity with MemStore)
            b.rmkey(P_COLL, op.cid.name)
            return
        if code in (os_.OP_TOUCH, os_.OP_WRITE, os_.OP_ZERO, os_.OP_TRUNCATE,
                    os_.OP_SETATTRS, os_.OP_OMAP_SETKEYS):
            if not self._coll_exists(op.cid):
                if replay:
                    return
                raise NoSuchCollection(op.cid.name)
            b.set(P_OBJ, key, b"1")
        if code == os_.OP_TOUCH:
            self._data_write(op.cid, op.oid, 0, b"")
            return
        if code == os_.OP_WRITE:
            self._data_write(op.cid, op.oid, op.off, os_.op_payload(op))
            self._note_data_write(op.cid, op.oid)
            return
        if code == os_.OP_ZERO:
            self._data_write(op.cid, op.oid, op.off, b"\0" * op.length)
            return
        if code == os_.OP_TRUNCATE:
            path = self._datafile(op.cid, op.oid)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            size = op.off
            if self._file_compressed(path):
                content = self._load_file(path)
                content = (content[:size] if len(content) >= size
                           else content + b"\0" * (size - len(content)))
                self._store_file(path, content, try_compress=False)
                return
            with open(path, "ab") as f:
                pass
            with open(path, "r+b") as f:
                f.truncate(size)
            return
        if code in (os_.OP_REMOVE, os_.OP_TRY_REMOVE):
            if code == os_.OP_TRY_REMOVE:
                if not self._coll_exists(op.cid) or not self._exists_kv(
                        op.cid, op.oid):
                    return
            elif not self._require(op.cid, op.oid, replay):
                return
            b.rmkey(P_OBJ, key)
            for k, _ in list(self._kv.iterate_prefix(P_XATTR, key + "/")):
                b.rmkey(P_XATTR, k)
            for k, _ in list(self._kv.iterate_prefix(P_OMAP, key + "/")):
                b.rmkey(P_OMAP, k)
            try:
                os.unlink(self._datafile(op.cid, op.oid))
            except FileNotFoundError:
                pass
            self._note_data_write(op.cid, op.oid)
            return
        if code == os_.OP_SETATTRS:
            for name, val in op.attrs.items():
                b.set(P_XATTR, f"{key}/{name}", val)
            return
        if code == os_.OP_RMATTR:
            if not self._require(op.cid, op.oid, replay):
                return
            b.rmkey(P_XATTR, f"{key}/{op.keys[0]}")
            return
        if code == os_.OP_CLONE:
            if not self._require(op.cid, op.oid, replay):
                return
            dkey = _objkey(op.cid, op.dest_oid)
            b.set(P_OBJ, dkey, b"1")
            src_file = self._datafile(op.cid, op.oid)
            dst_file = self._datafile(op.cid, op.dest_oid)
            os.makedirs(os.path.dirname(dst_file), exist_ok=True)
            data = b""
            if os.path.exists(src_file):
                with open(src_file, "rb") as f:
                    data = f.read()
            with open(dst_file, "wb") as f:
                f.write(data)
            for k, v in list(self._kv.iterate_prefix(P_XATTR, key + "/")):
                b.set(P_XATTR, dkey + k[len(key):], v)
            for k, v in list(self._kv.iterate_prefix(P_OMAP, key + "/")):
                b.set(P_OMAP, dkey + k[len(key):], v)
            return
        if code == os_.OP_OMAP_SETKEYS:
            for name, val in op.attrs.items():
                b.set(P_OMAP, f"{key}/{name}", val)
            return
        if code == os_.OP_OMAP_RMKEYS:
            if not self._require(op.cid, op.oid, replay):
                return
            for name in op.keys:
                b.rmkey(P_OMAP, f"{key}/{name}")
            return
        if code == os_.OP_OMAP_CLEAR:
            if not self._require(op.cid, op.oid, replay):
                return
            for k, _ in list(self._kv.iterate_prefix(P_OMAP, key + "/")):
                b.rmkey(P_OMAP, k)
            return
        if code == os_.OP_COLL_MOVE_RENAME:
            if not self._require(op.cid, op.oid, replay):
                return
            dkey = _objkey(op.dest_cid, op.dest_oid)
            b.rmkey(P_OBJ, key)
            b.set(P_OBJ, dkey, b"1")
            src_file = self._datafile(op.cid, op.oid)
            dst_file = self._datafile(op.dest_cid, op.dest_oid)
            os.makedirs(os.path.dirname(dst_file), exist_ok=True)
            if os.path.exists(src_file):
                os.replace(src_file, dst_file)
            for k, v in list(self._kv.iterate_prefix(P_XATTR, key + "/")):
                b.set(P_XATTR, dkey + k[len(key):], v)
                b.rmkey(P_XATTR, k)
            for k, v in list(self._kv.iterate_prefix(P_OMAP, key + "/")):
                b.set(P_OMAP, dkey + k[len(key):], v)
                b.rmkey(P_OMAP, k)
            return
        raise StoreError(f"unknown op {code}")

    # -- compressed-file plumbing -----------------------------------------
    def _file_compressed(self, path: str) -> bool:
        try:
            with open(path, "rb") as f:
                return f.read(4) == _COMP_MAGIC
        except OSError:
            return False

    def _load_file(self, path: str) -> bytes:
        """Logical file content, transparently decompressed."""
        if not os.path.exists(path):
            return b""
        with open(path, "rb") as f:
            raw = f.read()
        if not raw.startswith(_COMP_MAGIC):
            return raw
        alg_len = raw[4]
        alg = raw[5: 5 + alg_len].decode()
        body = raw[5 + alg_len + 8:]
        if alg == "none":
            return body
        from ceph_tpu_torch.compress import instance as _reg

        return _reg().factory(alg).decompress(body)

    def _store_file(self, path: str, data: bytes,
                    try_compress: bool) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if not isinstance(data, (bytes, bytearray)):
            data = bytes(data)  # compressor/magic paths need bytes
        payload = data
        if self._comp is not None and try_compress and len(data) >= 4096:
            comp = self._comp.compress(data)
            hdr = 4 + 1 + len(self._comp.name) + 8
            if hdr + len(comp) <= len(data) * 7 // 8:  # required_ratio
                payload = (_COMP_MAGIC
                           + bytes([len(self._comp.name)])
                           + self._comp.name.encode()
                           + len(data).to_bytes(8, "little") + comp)
                with open(path, "wb") as f:
                    f.write(payload)
                return
        if _has_magic(data):
            # escape raw content that collides with the header magic
            payload = (_COMP_MAGIC + bytes([4]) + b"none"
                       + len(data).to_bytes(8, "little") + data)
        with open(path, "wb") as f:
            f.write(payload)

    def _data_write(self, cid: Collection, oid: GHObject, off: int,
                    data: bytes) -> None:
        path = self._datafile(cid, oid)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # the RMW path is taken only when it can matter: the file is
        # already compressed, or this is an off=0 write that could
        # become compressed / needs the magic escape.  Plain extent
        # writes to raw files keep the O(extent) direct path (a chunked
        # recovery of a big object must not turn O(n^2))
        if (self._file_compressed(path)
                or (off == 0 and (self._comp is not None
                                  or _has_magic(data)))):
            old = self._load_file(path)
            buf = bytearray(old)
            if len(buf) < off:
                buf.extend(b"\0" * (off - len(buf)))
            buf[off: off + len(data)] = data
            # compress only full rewrites; extent updates store raw
            full = off == 0 and len(data) >= len(old)
            self._store_file(path, bytes(buf), try_compress=full)
            return
        with open(path, "ab"):
            pass
        with open(path, "r+b") as f:
            f.seek(0, 2)
            size = f.tell()
            if size < off:
                f.write(b"\0" * (off - size))
            f.seek(off)
            f.write(data)

    # -- reads ------------------------------------------------------------
    def _check(self, cid: Collection, oid: GHObject) -> None:
        if self._kv.get(P_COLL, cid.name) is None:
            raise NoSuchCollection(cid.name)
        if not self._exists_kv(cid, oid):
            raise NoSuchObject(f"{cid.name}/{oid.name}")

    def exists(self, cid: Collection, oid: GHObject) -> bool:
        with self._lock:
            return (self._kv.get(P_COLL, cid.name) is not None
                    and self._exists_kv(cid, oid))

    def debug_inject_read_err(self, cid: Collection, oid: GHObject) -> None:
        """Mark one object bad: its reads raise EIO while the
        filestore_debug_inject_read_err conf is on."""
        self._read_err_objs.add((cid.name, oid.name, oid.shard))

    def debug_clear_read_err(self) -> None:
        self._read_err_objs.clear()

    def _read_span(self, cid: Collection, oid: GHObject, off: int = 0,
                   length: int = 0):
        # hot path (every chunk read crosses here): pack no ctx while
        # disarmed — the enabled() guard is the whole disarmed cost
        if fp_enabled("store.filestore.read"):
            failpoint("store.filestore.read", oid=oid.name,
                      coll=cid.name)
        if (self.debug_read_err_enabled
                and (cid.name, oid.name, oid.shard) in self._read_err_objs):
            raise StoreError(
                f"EIO (injected): {cid.name}/{oid.name} shard "
                f"{oid.shard}")
        # base-class read() routes this snapshot through the corruption
        # seam + extent verification outside the lock
        with self._lock:
            self._check(cid, oid)
            seals = self._kv.get(P_SEAL, _objkey(cid, oid))
            path = self._datafile(cid, oid)
            if not os.path.exists(path):
                return b"", 0, seals
            if self._file_compressed(path):
                content = self._load_file(path)
                size = len(content)
                end = size if length == 0 else off + length
                data = content[off:end]
            else:
                with open(path, "rb") as f:
                    f.seek(0, 2)
                    size = f.tell()
                    f.seek(off)
                    data = f.read() if length == 0 else f.read(length)
            return data, size, seals

    def _size_locked(self, cid: Collection, oid: GHObject):
        """Logical object size without the lock (callers hold it), or
        None when the object is absent."""
        if (self._kv.get(P_COLL, cid.name) is None
                or not self._exists_kv(cid, oid)):
            return None
        path = self._datafile(cid, oid)
        if not os.path.exists(path):
            return 0
        if self._file_compressed(path):
            with open(path, "rb") as f:
                raw = f.read(4 + 1 + 255 + 8)
            alg_len = raw[4]
            return int.from_bytes(
                raw[5 + alg_len: 5 + alg_len + 8], "little")
        return os.path.getsize(path)

    def stat(self, cid: Collection, oid: GHObject) -> int:
        with self._lock:
            self._check(cid, oid)
            return self._size_locked(cid, oid) or 0

    def getattr(self, cid: Collection, oid: GHObject, name: str) -> bytes:
        with self._lock:
            self._check(cid, oid)
            v = self._kv.get(P_XATTR, f"{_objkey(cid, oid)}/{name}")
            if v is None:
                raise StoreError(f"no attr {name!r} on {oid.name}")
        return self._attr_filter(v, cid, oid, name)

    def getattrs(self, cid: Collection, oid: GHObject) -> Dict[str, bytes]:
        with self._lock:
            self._check(cid, oid)
            key = _objkey(cid, oid) + "/"
            return {
                k[len(key):]: v
                for k, v in self._kv.iterate(P_XATTR)
                if k.startswith(key)
            }

    def omap_get(self, cid: Collection, oid: GHObject) -> Dict[str, bytes]:
        with self._lock:
            self._check(cid, oid)
            key = _objkey(cid, oid) + "/"
            return {
                k[len(key):]: v
                for k, v in self._kv.iterate(P_OMAP)
                if k.startswith(key)
            }

    def statfs(self):
        """used = bytes under the store dir; total = the filesystem's
        (reference FileStore::statfs via ::statfs)."""
        used = 0
        for dirpath, _dn, files in os.walk(self.path):
            for fn in files:
                try:
                    used += os.path.getsize(os.path.join(dirpath, fn))
                except OSError:
                    pass
        try:
            st = os.statvfs(self.path)
            total = st.f_frsize * st.f_blocks
        except OSError:
            total = 1 << 30
        return used, total

    def list_collections(self) -> List[Collection]:
        with self._lock:
            return [Collection(k) for k, _ in self._kv.iterate(P_COLL)]

    def collection_exists(self, cid: Collection) -> bool:
        with self._lock:
            return self._kv.get(P_COLL, cid.name) is not None

    def collection_list(self, cid: Collection) -> List[GHObject]:
        with self._lock:
            if self._kv.get(P_COLL, cid.name) is None:
                raise NoSuchCollection(cid.name)
            out = []
            pre = cid.name + "/"
            for k, _ in self._kv.iterate(P_OBJ):
                if k.startswith(pre):
                    name, snap, shard = k[len(pre):].rsplit("/", 2)
                    out.append(GHObject(name, int(snap), int(shard)))
            return sorted(out)
