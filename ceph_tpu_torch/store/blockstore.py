"""BlockStore — raw-block ObjectStore: allocator + checksums + COW blobs.

Plays the reference BlueStore role (src/os/bluestore/BlueStore.cc,
src/os/bluestore/Allocator.h): object data lives on ONE flat block
"device" (a file) carved into fixed min_alloc blocks by a bitmap
allocator; object metadata (onodes with logical->physical extent maps,
ref-counted blobs with per-block crc32c checksums, xattrs, omap) lives
in the KV (the RocksDB role).

Durability discipline is BlueStore's, not FileStore's: there is NO data
WAL.  Every write is copy-on-write into freshly allocated blocks, data
is flushed to the device BEFORE the metadata commit, and the whole
transaction's metadata lands in ONE atomic KV batch — so a crash at any
point either shows the complete new state or the complete old state.
Blocks freed by a transaction re-enter the allocator only AFTER its KV
commit (the deferred-release rule that keeps old versions readable if
the commit never lands).

Checksums are verified on every read (csum_type crc32c, one u32 per
min_alloc block of stored bytes — BlueStore's blob csum_data); a
mismatch raises ChecksumError, which is the checksum-at-rest story the
scrub path builds on.  Compression (src/compressor/ plugged in via
ceph_tpu_torch.compress) happens per blob at write time when it saves >= 1/8
(the reference's required_ratio); compressed blobs decompress whole on
read, exactly the reference's behavior.

Clones share blobs by refcount (real COW): cloning an object copies its
extent map and increments blob refs; physical blocks are shared until
either side is overwritten.

`fsck()` re-walks everything (onode->blob references, refcounts,
allocator consistency, every checksum) and returns a list of errors —
the BlueStore fsck role.

Port of ``ceph_tpu/store/blockstore.py``: the block file, the onodes,
blobs and allocator records are the reference's byte for byte.  A
``gpu.staging.DeviceBuf`` payload is fetched once, copied, through
``op_payload(op, copy=True)``.  A blob's per-block checksums are
computed, and a read's verified, in one pass over its blocks
(``core.crc.crc32c_blocks``), not one host CRC call a 4 KiB block.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ceph_tpu_torch.core.crc import crc32c_blocks
from ceph_tpu_torch.core.lockdep import make_lock
from ceph_tpu_torch.core.encoding import Decoder, Encoder
from ceph_tpu_torch.core.perf import PerfCounters
from ceph_tpu_torch.store import objectstore as os_
from ceph_tpu_torch.store.kv import LogKV, WriteBatch
from ceph_tpu_torch.store.objectstore import (
    ChecksumError,
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

BLOCK = 4096  # min_alloc / csum block

# KV prefixes
P_COLL = "C"
P_ONODE = "N"
P_BLOB = "B"
P_XATTR = "X"
P_OMAP = "M"
P_META = "S"
P_SEAL = "K"  # objkey -> encoded ExtentSeals (logical-extent crcs)


def _objkey(cid: Collection, oid: GHObject) -> str:
    return f"{cid.name}/{oid.name}/{oid.snap}/{oid.shard}"


class Blob:
    """Ref-counted physical allocation (BlueStore bluestore_blob_t)."""

    __slots__ = ("refs", "raw_len", "stored_len", "comp", "pextents",
                 "csums")

    def __init__(self, refs: int, raw_len: int, stored_len: int, comp: str,
                 pextents: List[Tuple[int, int]], csums: List[int]) -> None:
        self.refs = refs
        self.raw_len = raw_len          # uncompressed bytes this blob holds
        self.stored_len = stored_len    # bytes on the device (pre-padding)
        self.comp = comp                # "" = raw
        self.pextents = pextents        # [(block, nblocks)]
        self.csums = csums              # crc32c per stored BLOCK

    def nblocks(self) -> int:
        return sum(n for _, n in self.pextents)

    def encode(self) -> bytes:
        e = Encoder()
        e.start(1, 1)
        e.u32(self.refs).u64(self.raw_len).u64(self.stored_len)
        e.string(self.comp)
        e.seq(self.pextents,
              lambda enc, p: enc.u64(p[0]).u64(p[1]))
        e.seq(self.csums, lambda enc, c: enc.u32(c))
        e.finish()
        return e.bytes()

    @classmethod
    def decode(cls, raw: bytes) -> "Blob":
        d = Decoder(raw)
        d.start(1)
        out = cls(
            refs=d.u32(), raw_len=d.u64(), stored_len=d.u64(),
            comp=d.string(),
            pextents=d.seq(lambda dd: (dd.u64(), dd.u64())),
            csums=d.seq(lambda dd: dd.u32()),
        )
        d.end()
        return out


class Onode:
    """Per-object metadata: size + logical->blob extent map
    (BlueStore bluestore_onode_t + ExtentMap)."""

    __slots__ = ("size", "extents")

    def __init__(self, size: int = 0,
                 extents: Optional[List[Tuple[int, int, int, int]]] = None
                 ) -> None:
        self.size = size
        # sorted (loff, length, blob_id, blob_off-in-raw-space)
        self.extents = extents if extents is not None else []

    def encode(self) -> bytes:
        e = Encoder()
        e.start(1, 1)
        e.u64(self.size)
        e.seq(self.extents,
              lambda enc, x: enc.u64(x[0]).u64(x[1]).u64(x[2]).u64(x[3]))
        e.finish()
        return e.bytes()

    @classmethod
    def decode(cls, raw: bytes) -> "Onode":
        d = Decoder(raw)
        d.start(1)
        out = cls(d.u64(),
                  d.seq(lambda dd: (dd.u64(), dd.u64(), dd.u64(), dd.u64())))
        d.end()
        return out

    def copy(self) -> "Onode":
        return Onode(self.size, list(self.extents))


class BitmapAllocator:
    """Next-fit bitmap allocator over fixed blocks (reference
    src/os/bluestore/BitmapAllocator... role; StupidAllocator's
    next-fit scan shape)."""

    def __init__(self, nblocks: int) -> None:
        self.bits = bytearray(nblocks)  # 0 = free
        self.hint = 0

    def nblocks(self) -> int:
        return len(self.bits)

    def grow(self, nblocks: int) -> None:
        if nblocks > len(self.bits):
            self.bits.extend(b"\0" * (nblocks - len(self.bits)))

    def mark_used(self, block: int, n: int) -> None:
        for i in range(block, block + n):
            self.bits[i] = 1

    def release(self, pextents: List[Tuple[int, int]]) -> None:
        for blk, n in pextents:
            for i in range(blk, blk + n):
                self.bits[i] = 0

    def allocate(self, want: int) -> Optional[List[Tuple[int, int]]]:
        """Up to `want` blocks as few extents; None if space short.
        Next-fit from the hint, wrapping once."""
        bits = self.bits
        n = len(bits)
        free_total = n - sum(bits)
        if free_total < want:
            return None
        out: List[Tuple[int, int]] = []
        got = 0
        i = self.hint % n if n else 0
        scanned = 0
        while got < want and scanned < 2 * n:
            if bits[i] == 0:
                start = i
                run = 0
                while i < n and bits[i] == 0 and got + run < want:
                    run += 1
                    i += 1
                    scanned += 1
                out.append((start, run))
                got += run
            else:
                i += 1
                scanned += 1
            if i >= n:
                i = 0
        if got < want:  # fragmentation race; caller grows
            return None
        for blk, cnt in out:
            self.mark_used(blk, cnt)
        self.hint = (out[-1][0] + out[-1][1]) % n
        return out


class BlockStore(ObjectStore):
    # every read re-verifies the per-block crc32c (ChecksumError on
    # mismatch): ranged readers need no whole-object re-verify pass
    checksums_at_rest = True

    def __init__(self, path: str, compression: str | None = None,
                 device_blocks: int = 1024, o_sync: bool = False,
                 kv_kind: str = "log") -> None:
        self.path = path
        # o_sync=True gives BlueStore's full fsync discipline (data
        # durably on media before the KV commit that references it —
        # survives OS crash/power loss).  The default False only
        # flushes userspace buffers: data-before-metadata ordering
        # holds across PROCESS crash but not power loss.
        self._o_sync = o_sync
        if kv_kind == "lsm":
            # spill-to-disk metadata: onode/blob tables can exceed RAM
            # (the BlueStore-over-RocksDB pairing)
            from ceph_tpu_torch.store.lsm import LSMStore

            self._kv = LSMStore(os.path.join(path, "meta.lsm"))
        else:
            self._kv = LogKV(os.path.join(path, "meta.kv"))
        self._dev_path = os.path.join(path, "block")
        self._dev_fh = None
        self._lock = make_lock("blockstore")
        self._mounted = False
        self._alloc = BitmapAllocator(0)
        self._init_blocks = device_blocks
        self._next_blob = 1
        self._onodes: Dict[str, Optional[Onode]] = {}  # lazy cache
        self._blobs: Dict[int, Optional[Blob]] = {}
        self._comp = None
        if compression and compression != "none":
            from ceph_tpu_torch.compress import instance as _reg

            self._comp = _reg().factory(compression)
        self._seq = 0
        # kv_sync_thread analog (reference BlueStore._kv_sync_thread):
        # submitters apply + stage metadata, ONE device fsync + ONE KV
        # sync then commits the whole batch
        pc = PerfCounters("blockstore")
        pc.add_u64_counter("queued_txns", "transactions submitted")
        pc.add_u64_counter("dev_fsyncs", "batched device fsyncs issued")
        pc.add_histogram("commit_batch", "transactions per commit batch")
        pc.add_time_avg("commit_lat", "batched sync+completion seconds")
        pc.add_u64_counter("read_verify_fail",
                           "reads failing at-rest extent verification")
        self.perf = pc
        self._pipeline = CommitPipeline(self._commit_sync, perf=pc)

    # -- lifecycle --------------------------------------------------------
    def mkfs(self) -> None:
        os.makedirs(self.path, exist_ok=True)
        with open(self._dev_path, "wb") as f:
            f.truncate(self._init_blocks * BLOCK)
        self._kv.open()
        b = WriteBatch()
        b.set(P_META, "next_blob", b"1")
        b.set(P_META, "blocks", str(self._init_blocks).encode())
        self._kv.submit(b, sync=True)
        self._kv.close()

    def mount(self) -> None:
        with self._lock:
            self._kv.open()
            self._next_blob = int(self._kv.get(P_META, "next_blob") or b"1")
            nblocks = int(self._kv.get(P_META, "blocks")
                          or str(self._init_blocks).encode())
            self._alloc = BitmapAllocator(nblocks)
            # the allocator is rebuilt from the blob table every mount
            # (the fsck-on-mount shape; the reference persists a freelist
            # in the same KV — rebuilding from the authoritative extent
            # refs can never disagree with it)
            for _k, raw in self._kv.iterate(P_BLOB):
                blob = Blob.decode(raw)
                for blk, cnt in blob.pextents:
                    self._alloc.mark_used(blk, cnt)
            self._dev_fh = open(self._dev_path, "r+b")
            self._onodes.clear()
            self._blobs.clear()
            self._mounted = True
        self._pipeline.start()

    def umount(self) -> None:
        self._pipeline.stop()  # drain completions before handles close
        with self._lock:
            if self._dev_fh:
                self._dev_fh.flush()
                os.fsync(self._dev_fh.fileno())
                self._dev_fh.close()
                self._dev_fh = None
            self._kv.close()
            self._mounted = False
            self._onodes.clear()
            self._blobs.clear()

    # -- metadata cache ----------------------------------------------------
    def _onode(self, key: str) -> Optional[Onode]:
        if key not in self._onodes:
            raw = self._kv.get(P_ONODE, key)
            self._onodes[key] = Onode.decode(raw) if raw is not None else None
        return self._onodes[key]

    def _blob(self, bid: int) -> Blob:
        if bid not in self._blobs:
            raw = self._kv.get(P_BLOB, str(bid))
            if raw is None:
                raise StoreError(f"dangling blob ref {bid}")
            self._blobs[bid] = Blob.decode(raw)
        blob = self._blobs[bid]
        if blob is None:
            raise StoreError(f"dangling blob ref {bid}")
        return blob

    # -- device IO ---------------------------------------------------------
    def _grow_device(self, need_blocks: int) -> None:
        cur = self._alloc.nblocks()
        new = max(cur * 2, cur + need_blocks, self._init_blocks)
        self._dev_fh.truncate(new * BLOCK)
        self._alloc.grow(new)

    def _dev_write(self, pextents: List[Tuple[int, int]],
                   data: bytes) -> None:
        """Lay `data` across the extents, zero-padding the last block."""
        off = 0
        for blk, cnt in pextents:
            chunk = data[off: off + cnt * BLOCK]
            if len(chunk) < cnt * BLOCK:
                chunk = chunk + b"\0" * (cnt * BLOCK - len(chunk))
            self._dev_fh.seek(blk * BLOCK)
            self._dev_fh.write(chunk)
            off += cnt * BLOCK

    def _dev_read_blocks(self, pextents: List[Tuple[int, int]],
                         first: int, last: int) -> bytes:
        """Read stored blocks #first..#last (inclusive) of a blob, one
        device read a physical run."""
        out = bytearray()
        at = 0
        for blk, cnt in pextents:
            lo, hi = max(first, at), min(last, at + cnt - 1)
            if lo <= hi:
                self._dev_fh.seek((blk + lo - at) * BLOCK)
                out += self._dev_fh.read((hi - lo + 1) * BLOCK)
            at += cnt
        if len(out) != (last - first + 1) * BLOCK:
            raise StoreError(f"block index {last} out of blob range")
        return bytes(out)

    def _bad_blocks(self, blob: Blob, first: int, stored: bytes):
        """Indices of the blocks of ``stored`` (the blob's blocks from
        #first) whose crc32c is not the recorded one."""
        got = crc32c_blocks(stored, BLOCK)
        want = np.asarray(blob.csums[first:first + len(got)],
                          dtype=np.uint32)
        return [first + int(i) for i in np.nonzero(got != want)[0]]

    def _blob_read(self, bid: int, raw_off: int, length: int) -> bytes:
        """Bytes [raw_off, raw_off+length) of the blob's raw
        (uncompressed) space, csum-verified."""
        blob = self._blob(bid)
        if blob.comp:
            # compressed blobs read + verify + decompress whole
            stored = self._dev_read_blocks(blob.pextents, 0,
                                           len(blob.csums) - 1)
            bad = self._bad_blocks(blob, 0, stored)
            if bad:
                raise ChecksumError(
                    f"blob {bid} block {bad[0]}: crc mismatch")
            from ceph_tpu_torch.compress import instance as _reg

            raw = _reg().factory(blob.comp).decompress(
                bytes(stored[: blob.stored_len]))
            if len(raw) != blob.raw_len:
                raise ChecksumError(
                    f"blob {bid}: decompressed {len(raw)} != {blob.raw_len}")
            return raw[raw_off: raw_off + length]
        first = raw_off // BLOCK
        last = (raw_off + length - 1) // BLOCK if length else first
        out = self._dev_read_blocks(blob.pextents, first, last)
        bad = self._bad_blocks(blob, first, out)
        if bad:
            raise ChecksumError(f"blob {bid} block {bad[0]}: crc mismatch")
        base = first * BLOCK
        return bytes(out[raw_off - base: raw_off - base + length])

    # -- txn machinery -----------------------------------------------------
    def queue_transaction(self, t: Transaction, on_commit=None) -> int:
        """Apply + stage metadata synchronously (read-your-writes on
        return), commit asynchronously: the pipeline's commit thread
        runs one device fsync + one KV sync for every transaction
        staged since the last batch (the BlueStore kv_sync_thread
        shape), then fires completions and releases each transaction's
        deferred frees — freed blocks rejoin the allocator only once
        the commit that stopped referencing them is durable."""
        with self._lock:
            assert self._mounted, "not mounted"
            self._validate(t)
            plan = self._seal_plan(t, self._size_locked)
            batch = WriteBatch()
            ctx = _TxnCtx()
            try:
                for op in t.ops:
                    self._apply_op(op, batch, ctx)
            except Exception:
                # validated ops cannot fail; if one does anyway, drop
                # every cached state the partial apply touched
                self._onodes.clear()
                self._blobs.clear()
                self._alloc_rollback(ctx)
                raise
            # BlueStore commit order: data pages reach the device before
            # the metadata batch that references them (fsync batched in
            # the commit thread under o_sync — see __init__)
            self._dev_fh.flush()
            # extent seals join the SAME atomic KV batch as the onode
            # and blob rows they describe: a commit either lands data,
            # metadata, and seals together or none of them
            self._reseal(plan, batch)
            for key in ctx.dirty_onodes:
                on = self._onodes.get(key)
                if on is None:
                    batch.rmkey(P_ONODE, key)
                else:
                    batch.set(P_ONODE, key, on.encode())
            for bid in ctx.dirty_blobs:
                blob = self._blobs.get(bid)
                if blob is None or blob.refs <= 0:
                    batch.rmkey(P_BLOB, str(bid))
                    self._blobs[bid] = None
                else:
                    batch.set(P_BLOB, str(bid), blob.encode())
            batch.set(P_META, "next_blob", str(self._next_blob).encode())
            batch.set(P_META, "blocks",
                      str(self._alloc.nblocks()).encode())
            self._kv.submit(batch)
            self._seq += 1
            seq = self._seq
            deferred = ctx.deferred_free
            self.perf.inc("queued_txns")

            def complete(cb=on_commit, deferred=deferred):
                if deferred:
                    with self._lock:
                        self._alloc.release(deferred)
                if cb is not None:
                    cb()

            # submit INSIDE the lock: pending order must equal commit
            # seq order or completions could fire out of order
            done = None
            inline = False
            if on_commit is None:
                if self._pipeline.in_commit_thread():
                    inline = True
                else:
                    done = threading.Event()
                    self._pipeline.submit(
                        seq, lambda: (complete(cb=None), done.set()))
            else:
                self._pipeline.submit(seq, complete)
        if inline:
            self._commit_sync()
            complete(cb=None)
        elif done is not None:
            done.wait()
        return seq

    def _commit_sync(self) -> None:
        """Batched durability point (commit-thread only): one device
        fsync, then one KV sync, covering every transaction staged
        since the previous batch.  BOTH run under the store lock so no
        transaction can apply between them — its metadata must never
        become durable ahead of the device fsync that covers its data
        (the data-before-metadata invariant, at batch granularity)."""
        if not self._o_sync:
            return  # no-fsync mode: apply is the commit point
        with self._lock:
            if self._dev_fh is None:
                return
            self._dev_fh.flush()
            os.fsync(self._dev_fh.fileno())
            self.perf.inc("dev_fsyncs")
            self._kv.sync()

    def _alloc_rollback(self, ctx: "_TxnCtx") -> None:
        self._alloc.release(ctx.fresh_allocs)

    # -- extent seals ------------------------------------------------------
    def _size_locked(self, cid: Collection, oid: GHObject):
        on = self._onode(_objkey(cid, oid))
        return None if on is None else on.size

    def _reseal(self, plan, batch: WriteBatch) -> None:
        """Post-apply half of the seal transaction: recompute each
        planned object's dirty extents from post-apply blob content
        (device pages flushed above; onode/blob caches hold the new
        state) and stage the rows into the txn's atomic batch."""
        for (cid, oid), mark in plan.items():
            key = _objkey(cid, oid)
            on = self._onodes.get(key)
            if mark.drop or on is None:
                batch.rmkey(P_SEAL, key)
                continue
            old = (None if (mark.full or mark.fresh)
                   else self._kv.get(P_SEAL, key))
            batch.set(P_SEAL, key, self._seal_rebuild(
                mark, on.size,
                lambda s, ln, o=on: self._onode_pread(o, s, ln),
                old))

    def _validate(self, t: Transaction) -> None:
        kv, self_ = self._kv, self

        class Overlay(os_.ValidationOverlay):
            def _base_coll(self, name):
                return kv.get(P_COLL, name) is not None

            def _base_obj(self, name, oid):
                return self_._onode(_objkey(Collection(name), oid)) \
                    is not None

            def _base_count(self, name):
                pre = name + "/"
                return sum(1 for k, _ in kv.iterate(P_ONODE)
                           if k.startswith(pre))

        ov = Overlay()
        for op in t.ops:
            validate_op(op, ov)

    # -- the write path ----------------------------------------------------
    def _new_blob_for(self, data: bytes, ctx: "_TxnCtx") -> int:
        """Allocate + device-write one blob holding `data`; returns id."""
        payload, comp = data, ""
        if self._comp is not None and len(data) >= BLOCK:
            c = self._comp.compress(data)
            if len(c) <= len(data) * 7 // 8:  # required_ratio
                payload, comp = c, self._comp.name
        nblk = max(1, (len(payload) + BLOCK - 1) // BLOCK)
        pex = self._alloc.allocate(nblk)
        if pex is None:
            self._grow_device(nblk)
            pex = self._alloc.allocate(nblk)
            if pex is None:
                raise StoreError("allocator failed after grow")
        ctx.fresh_allocs.extend(pex)
        self._dev_write(pex, payload)
        padded = payload + b"\0" * (nblk * BLOCK - len(payload))
        csums = crc32c_blocks(padded, BLOCK).tolist()
        bid = self._next_blob
        self._next_blob += 1
        self._blobs[bid] = Blob(1, len(data), len(payload), comp, pex, csums)
        ctx.dirty_blobs.add(bid)
        return bid

    def _blob_decref(self, bid: int, ctx: "_TxnCtx") -> None:
        blob = self._blob(bid)
        blob.refs -= 1
        ctx.dirty_blobs.add(bid)
        if blob.refs <= 0:
            ctx.deferred_free.extend(blob.pextents)

    def _punch(self, on: Onode, off: int, length: int,
               ctx: "_TxnCtx") -> None:
        """Remove logical [off, off+length) from the extent map, splitting
        boundary extents (split halves share the blob -> refs go up)."""
        if length <= 0:
            return
        end = off + length
        out: List[Tuple[int, int, int, int]] = []
        for loff, ln, bid, boff in on.extents:
            lend = loff + ln
            if lend <= off or loff >= end:
                out.append((loff, ln, bid, boff))
                continue
            kept = 0
            if loff < off:  # left remnant
                out.append((loff, off - loff, bid, boff))
                kept += 1
            if lend > end:  # right remnant
                out.append((end, lend - end, bid, boff + (end - loff)))
                kept += 1
            if kept == 0:
                self._blob_decref(bid, ctx)
            elif kept == 2:
                self._blob(bid).refs += 1
                ctx.dirty_blobs.add(bid)
        out.sort()
        on.extents = out

    def _write(self, key: str, off: int, data: bytes,
               ctx: "_TxnCtx") -> None:
        on = self._onode(key) or Onode()
        self._onodes[key] = on
        ctx.dirty_onodes.add(key)
        if data:
            self._punch(on, off, len(data), ctx)
            bid = self._new_blob_for(data, ctx)
            on.extents.append((off, len(data), bid, 0))
            on.extents.sort()
            on.size = max(on.size, off + len(data))

    def _apply_op(self, op: os_.Op, b: WriteBatch, ctx: "_TxnCtx") -> None:
        code = op.op
        key = _objkey(op.cid, op.oid) if op.oid else ""
        if code == os_.OP_NOP:
            return
        if code == os_.OP_MKCOLL:
            b.set(P_COLL, op.cid.name, b"1")
            return
        if code == os_.OP_RMCOLL:
            b.rmkey(P_COLL, op.cid.name)
            return
        if code == os_.OP_TOUCH:
            self._write(key, 0, b"", ctx)
            return
        if code == os_.OP_WRITE:
            # copy=True: blob extents RETAIN the buffer — a view into
            # a staging slot must not outlive the slot's release
            self._write(key, op.off, os_.op_payload(op, copy=True), ctx)
            self._note_data_write(op.cid, op.oid)
            return
        if code == os_.OP_ZERO:
            on = self._onode(key) or Onode()
            self._onodes[key] = on
            ctx.dirty_onodes.add(key)
            self._punch(on, op.off, op.length, ctx)  # holes read as zeros
            on.size = max(on.size, op.off + op.length)
            return
        if code == os_.OP_TRUNCATE:
            on = self._onode(key) or Onode()
            self._onodes[key] = on
            ctx.dirty_onodes.add(key)
            if op.off < on.size:
                self._punch(on, op.off, on.size - op.off, ctx)
            on.size = op.off
            return
        if code in (os_.OP_REMOVE, os_.OP_TRY_REMOVE):
            on = self._onode(key)
            if on is None:
                return  # TRY_REMOVE tolerance; REMOVE was validated
            for _loff, _ln, bid, _boff in on.extents:
                self._blob_decref(bid, ctx)
            self._onodes[key] = None
            ctx.dirty_onodes.add(key)
            for space in (P_XATTR, P_OMAP):
                for k, _ in self._iter_prefix_overlay(ctx, space, key + "/"):
                    self._kv_rm(ctx, b, space, k)
            self._note_data_write(op.cid, op.oid)
            return
        if code == os_.OP_SETATTRS:
            self._write(key, 0, b"", ctx)  # ensure onode
            for name, val in op.attrs.items():
                self._kv_set(ctx, b, P_XATTR, f"{key}/{name}", val)
            return
        if code == os_.OP_RMATTR:
            self._kv_rm(ctx, b, P_XATTR, f"{key}/{op.keys[0]}")
            return
        if code == os_.OP_CLONE:
            src = self._onode(key)
            if src is None:
                return
            dkey = _objkey(op.cid, op.dest_oid)
            old = self._onode(dkey)
            if old is not None:
                for _loff, _ln, bid, _boff in old.extents:
                    self._blob_decref(bid, ctx)
            dst = src.copy()
            for _loff, _ln, bid, _boff in dst.extents:
                self._blob(bid).refs += 1
                ctx.dirty_blobs.add(bid)
            self._onodes[dkey] = dst
            ctx.dirty_onodes.add(dkey)
            self._copy_kv_rows(ctx, b, key, dkey, move=False)
            return
        if code == os_.OP_OMAP_SETKEYS:
            self._write(key, 0, b"", ctx)
            for name, val in op.attrs.items():
                self._kv_set(ctx, b, P_OMAP, f"{key}/{name}", val)
            return
        if code == os_.OP_OMAP_RMKEYS:
            for name in op.keys:
                self._kv_rm(ctx, b, P_OMAP, f"{key}/{name}")
            return
        if code == os_.OP_OMAP_CLEAR:
            for k, _ in self._iter_prefix_overlay(ctx, P_OMAP, key + "/"):
                self._kv_rm(ctx, b, P_OMAP, k)
            return
        if code == os_.OP_COLL_MOVE_RENAME:
            src = self._onode(key)
            if src is None:
                return
            dkey = _objkey(op.dest_cid, op.dest_oid)
            old = self._onode(dkey)
            if old is not None:
                for _loff, _ln, bid, _boff in old.extents:
                    self._blob_decref(bid, ctx)
            self._onodes[dkey] = src
            self._onodes[key] = None
            ctx.dirty_onodes.update((key, dkey))
            self._copy_kv_rows(ctx, b, key, dkey, move=True)
            return
        raise StoreError(f"unknown op {code}")

    def _copy_kv_rows(self, ctx: "_TxnCtx", b: WriteBatch, key: str,
                      dkey: str, move: bool) -> None:
        for space in (P_XATTR, P_OMAP):
            for k, v in self._iter_prefix_overlay(ctx, space, key + "/"):
                self._kv_set(ctx, b, space, dkey + k[len(key):], v)
                if move:
                    self._kv_rm(ctx, b, space, k)

    # -- txn-local KV overlay ---------------------------------------------
    # The whole transaction commits as ONE KV batch, so later ops in the
    # same transaction (setattr -> clone, remove -> recreate) must read
    # their own uncommitted writes through this overlay.
    def _kv_set(self, ctx: "_TxnCtx", b: WriteBatch, space: str, key: str,
                val: bytes) -> None:
        b.set(space, key, val)
        ctx.kv_overlay[(space, key)] = val

    def _kv_rm(self, ctx: "_TxnCtx", b: WriteBatch, space: str,
               key: str) -> None:
        b.rmkey(space, key)
        ctx.kv_overlay[(space, key)] = None

    def _iter_prefix_overlay(self, ctx: "_TxnCtx", space: str,
                             prefix: str) -> List[Tuple[str, bytes]]:
        merged: Dict[str, Optional[bytes]] = dict(
            self._kv.iterate_prefix(space, prefix))
        for (sp, k), v in ctx.kv_overlay.items():
            if sp == space and k.startswith(prefix):
                merged[k] = v
        return sorted((k, v) for k, v in merged.items() if v is not None)

    # -- reads ------------------------------------------------------------
    def _check(self, cid: Collection, oid: GHObject) -> Onode:
        if self._kv.get(P_COLL, cid.name) is None:
            raise NoSuchCollection(cid.name)
        on = self._onode(_objkey(cid, oid))
        if on is None:
            raise NoSuchObject(f"{cid.name}/{oid.name}")
        return on

    def exists(self, cid: Collection, oid: GHObject) -> bool:
        with self._lock:
            return (self._kv.get(P_COLL, cid.name) is not None
                    and self._onode(_objkey(cid, oid)) is not None)

    def _onode_pread(self, on: Onode, off: int, length: int) -> bytes:
        """Extent-map walk (lock held): bytes [off, off+length) of the
        object, clipped to EOF; length==0 reads to end.  Each blob read
        re-verifies the per-block device crc (ChecksumError)."""
        if off >= on.size:
            return b""
        if length == 0 or off + length > on.size:
            length = on.size - off
        buf = bytearray(length)
        end = off + length
        for loff, ln, bid, boff in on.extents:
            lend = loff + ln
            if lend <= off or loff >= end:
                continue
            s = max(off, loff)
            e = min(end, lend)
            chunk = self._blob_read(bid, boff + (s - loff), e - s)
            buf[s - off: e - off] = chunk
        return bytes(buf)

    def _read_span(self, cid: Collection, oid: GHObject, off: int = 0,
                   length: int = 0):
        # the base-class read() gate runs the corruption seam AFTER the
        # per-block device crc above, then verifies the logical extent
        # seals — catching exactly the rot the device crc cannot see
        with self._lock:
            on = self._check(cid, oid)
            seals = self._kv.get(P_SEAL, _objkey(cid, oid))
            return self._onode_pread(on, off, length), on.size, seals

    def stat(self, cid: Collection, oid: GHObject) -> int:
        with self._lock:
            return self._check(cid, oid).size

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
            return {k[len(key):]: v
                    for k, v in self._kv.iterate_prefix(P_XATTR, key)}

    def omap_get(self, cid: Collection, oid: GHObject) -> Dict[str, bytes]:
        with self._lock:
            self._check(cid, oid)
            key = _objkey(cid, oid) + "/"
            return {k[len(key):]: v
                    for k, v in self._kv.iterate_prefix(P_OMAP, key)}

    def statfs(self):
        """used = allocated blocks; total = the device size (the
        BlueStore statfs shape: allocator-accurate)."""
        with self._lock:
            used = sum(self._alloc.bits) * BLOCK
            total = self._alloc.nblocks() * BLOCK
        return used, max(total, 1)

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
            for k, _ in self._kv.iterate(P_ONODE):
                if k.startswith(pre):
                    name, snap, shard = k[len(pre):].rsplit("/", 2)
                    out.append(GHObject(name, int(snap), int(shard)))
            return sorted(out)

    # -- fsck -------------------------------------------------------------
    def fsck(self) -> List[str]:
        """Full consistency walk (BlueStore fsck role): extent->blob
        references, refcounts, physical-extent overlap, allocator
        agreement, every stored checksum."""
        with self._lock:
            errors: List[str] = []
            blob_refs: Dict[int, int] = {}
            blobs: Dict[int, Blob] = {}
            for k, raw in self._kv.iterate(P_BLOB):
                blobs[int(k)] = Blob.decode(raw)
            for key, raw in self._kv.iterate(P_ONODE):
                on = Onode.decode(raw)
                for loff, ln, bid, boff in on.extents:
                    if bid not in blobs:
                        errors.append(f"{key}: extent -> missing blob {bid}")
                        continue
                    blob_refs[bid] = blob_refs.get(bid, 0) + 1
                    if boff + ln > blobs[bid].raw_len:
                        errors.append(
                            f"{key}: extent past blob {bid} raw_len")
                    if loff + ln > on.size:
                        errors.append(f"{key}: extent past object size")
            used = bytearray(self._alloc.nblocks())
            for bid, blob in blobs.items():
                want = blob_refs.get(bid, 0)
                if blob.refs != want:
                    errors.append(
                        f"blob {bid}: refs {blob.refs} != actual {want}")
                for blk, cnt in blob.pextents:
                    for i in range(blk, blk + cnt):
                        if i >= len(used):
                            errors.append(f"blob {bid}: block {i} past device")
                        elif used[i]:
                            errors.append(f"blob {bid}: block {i} double-used")
                        else:
                            used[i] = 1
                stored = self._dev_read_blocks(blob.pextents, 0,
                                               len(blob.csums) - 1)
                for i in self._bad_blocks(blob, 0, stored):
                    errors.append(f"blob {bid}: block {i} crc mismatch")
            if bytes(used) != bytes(self._alloc.bits):
                errors.append("allocator bitmap != blob extent refs")
            return errors


class _TxnCtx:
    """Per-transaction bookkeeping for the COW commit discipline."""

    __slots__ = ("dirty_onodes", "dirty_blobs", "deferred_free",
                 "fresh_allocs", "kv_overlay")

    def __init__(self) -> None:
        self.dirty_onodes: set = set()
        self.dirty_blobs: set = set()
        self.deferred_free: List[Tuple[int, int]] = []
        self.fresh_allocs: List[Tuple[int, int]] = []
        self.kv_overlay: Dict[Tuple[str, str], Optional[bytes]] = {}
