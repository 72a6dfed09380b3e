"""ObjectStore — the abstract transactional object API.

Reference: src/os/ObjectStore.h + src/os/Transaction.cc. The contract
the OSD's PG engine is written against: named collections (one per PG)
holding objects with byte extents, xattrs, and an omap; all mutations
batched into atomic, ordered Transactions; reads are unordered.

A Transaction is an encodable op list (the reference's op codes at
src/os/ObjectStore.h Transaction::OP_*) so the same bytes can be
carried inside replication messages (the EC sub-write payload) and
replayed from the journal — exactly how the reference ships
transactions to replica shards.

Port of ``ceph_tpu/store/objectstore.py``, name for name: a
Transaction's bytes and an ExtentSeals record are the reference's byte
for byte.  A write payload is host bytes (anything ``bytes()`` takes) or
a ``gpu.staging.DeviceBuf`` handle, which the op list carries
un-materialized until a sink reads it: ``Op.encode`` (through
``Encoder.blob``) or the store's apply (``op_payload``).  The seals and
their verification use the host CRC-32C (``core.crc``).
"""

from __future__ import annotations

import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ceph_tpu_torch.core import failpoint as fp
from ceph_tpu_torch.core.crc import crc32c
from ceph_tpu_torch.core.encoding import Decoder, Encoder


class StoreError(Exception):
    pass


class NoSuchObject(StoreError):
    pass


class NoSuchCollection(StoreError):
    pass


class ChecksumError(StoreError):
    """Bytes a read would serve failed at-rest checksum verification.

    Raised by the base-class read gate (per-extent seals, any backend)
    and by BlockStore's per-block device crc.  Consumers must treat the
    local copy as LOST — reconstruct/repair, never serve or EIO the
    flipped bytes upward."""


@dataclass(frozen=True, order=True)
class GHObject:
    """Object id within a collection (hobject_t/ghobject_t analog:
    reference src/common/hobject.h — name + key hash + snap + shard)."""

    name: str
    snap: int = -2  # -2 = head (CEPH_NOSNAP analog)
    shard: int = -1  # -1 = no shard (replicated); >=0 = EC shard id

    def encode(self, e: Encoder) -> None:
        e.string(self.name).s64(self.snap).s32(self.shard)

    @classmethod
    def decode(cls, d: Decoder) -> "GHObject":
        return cls(d.string(), d.s64(), d.s32())


@dataclass(frozen=True, order=True)
class Collection:
    """Collection id — one per PG (+ metadata col), e.g. '2.1f_head'."""

    name: str

    def encode(self, e: Encoder) -> None:
        e.string(self.name)

    @classmethod
    def decode(cls, d: Decoder) -> "Collection":
        return cls(d.string())


META_COLL = Collection("meta")

# Transaction op codes (subset of reference OP_* that the PG engine uses)
OP_NOP = 0
OP_TOUCH = 1
OP_WRITE = 2
OP_ZERO = 3
OP_TRUNCATE = 4
OP_REMOVE = 5
OP_SETATTRS = 6
OP_RMATTR = 7
OP_CLONE = 8
OP_MKCOLL = 9
OP_RMCOLL = 10
OP_OMAP_SETKEYS = 11
OP_OMAP_RMKEYS = 12
OP_OMAP_CLEAR = 13
OP_COLL_MOVE_RENAME = 14
OP_TRY_REMOVE = 15  # remove tolerating absence (for replica-shipped txns)


@dataclass
class Op:
    op: int
    cid: Collection
    oid: Optional[GHObject] = None
    off: int = 0
    length: int = 0
    data: bytes = b""
    attrs: Dict[str, bytes] = field(default_factory=dict)
    keys: List[str] = field(default_factory=list)
    dest_cid: Optional[Collection] = None
    dest_oid: Optional[GHObject] = None

    def encode(self, e: Encoder) -> None:
        e.start(1, 1)
        e.u8(self.op)
        self.cid.encode(e)
        e.optional(self.oid, lambda enc, o: o.encode(enc))
        e.u64(self.off).u64(self.length).blob(self.data)
        e.mapping(self.attrs, lambda enc, k: enc.string(k),
                  lambda enc, v: enc.blob(v))
        e.seq(self.keys, lambda enc, k: enc.string(k))
        e.optional(self.dest_cid, lambda enc, c: c.encode(enc))
        e.optional(self.dest_oid, lambda enc, o: o.encode(enc))
        e.finish()

    @classmethod
    def decode(cls, d: Decoder) -> "Op":
        d.start(1)
        out = cls(
            op=d.u8(),
            cid=Collection.decode(d),
            oid=d.optional(GHObject.decode),
            off=d.u64(),
            length=d.u64(),
            data=d.blob(),
            attrs=d.mapping(lambda dd: dd.string(), lambda dd: dd.blob()),
            keys=d.seq(lambda dd: dd.string()),
            dest_cid=d.optional(Collection.decode),
            dest_oid=d.optional(GHObject.decode),
        )
        d.end()
        return out


class Transaction:
    """Atomic batch of mutations; encodable for journal + replication."""

    def __init__(self) -> None:
        self.ops: List[Op] = []

    def __len__(self) -> int:
        return len(self.ops)

    def append(self, other: "Transaction") -> None:
        self.ops.extend(other.ops)

    # -- op constructors --------------------------------------------------
    def touch(self, cid: Collection, oid: GHObject) -> None:
        self.ops.append(Op(OP_TOUCH, cid, oid))

    def write(self, cid: Collection, oid: GHObject, off: int, data) -> None:
        """`data` is anything ``bytes()`` takes, or a DeviceBuf payload
        handle: the handle rides the op list un-materialized and becomes
        host bytes only at a sink (``op_payload`` at apply, ``Op.encode``
        on the wire)."""
        if hasattr(data, "wire_view"):  # DeviceBuf: keep the handle
            self.ops.append(Op(OP_WRITE, cid, oid, off=off,
                               length=len(data), data=data))
            return
        data = bytes(data)
        self.ops.append(Op(OP_WRITE, cid, oid, off=off, length=len(data),
                           data=data))

    def zero(self, cid: Collection, oid: GHObject, off: int, length: int) -> None:
        self.ops.append(Op(OP_ZERO, cid, oid, off=off, length=length))

    def truncate(self, cid: Collection, oid: GHObject, size: int) -> None:
        self.ops.append(Op(OP_TRUNCATE, cid, oid, off=size))

    def remove(self, cid: Collection, oid: GHObject) -> None:
        self.ops.append(Op(OP_REMOVE, cid, oid))

    def try_remove(self, cid: Collection, oid: GHObject) -> None:
        """Remove if present; no-op otherwise.  Replication ships
        primary-built transactions to replicas whose local existence may
        lag, so deletes must tolerate absence."""
        self.ops.append(Op(OP_TRY_REMOVE, cid, oid))

    def setattrs(self, cid: Collection, oid: GHObject, attrs: Dict[str, bytes]) -> None:
        self.ops.append(Op(OP_SETATTRS, cid, oid, attrs=dict(attrs)))

    def rmattr(self, cid: Collection, oid: GHObject, name: str) -> None:
        self.ops.append(Op(OP_RMATTR, cid, oid, keys=[name]))

    def clone(self, cid: Collection, src: GHObject, dst: GHObject) -> None:
        self.ops.append(Op(OP_CLONE, cid, src, dest_oid=dst))

    def create_collection(self, cid: Collection) -> None:
        self.ops.append(Op(OP_MKCOLL, cid))

    def remove_collection(self, cid: Collection) -> None:
        self.ops.append(Op(OP_RMCOLL, cid))

    def omap_setkeys(self, cid: Collection, oid: GHObject,
                     kv: Dict[str, bytes]) -> None:
        self.ops.append(Op(OP_OMAP_SETKEYS, cid, oid, attrs=dict(kv)))

    def omap_rmkeys(self, cid: Collection, oid: GHObject, keys: List[str]) -> None:
        self.ops.append(Op(OP_OMAP_RMKEYS, cid, oid, keys=list(keys)))

    def omap_clear(self, cid: Collection, oid: GHObject) -> None:
        self.ops.append(Op(OP_OMAP_CLEAR, cid, oid))

    def coll_move_rename(self, src_cid: Collection, src: GHObject,
                         dst_cid: Collection, dst: GHObject) -> None:
        self.ops.append(Op(OP_COLL_MOVE_RENAME, src_cid, src,
                           dest_cid=dst_cid, dest_oid=dst))

    # -- wire -------------------------------------------------------------
    def encode(self, e: Encoder) -> None:
        e.start(1, 1)
        e.seq(self.ops, lambda enc, op: op.encode(enc))
        e.finish()

    @classmethod
    def decode(cls, d: Decoder) -> "Transaction":
        d.start(1)
        t = cls()
        t.ops = d.seq(Op.decode)
        d.end()
        return t

    def to_bytes(self) -> bytes:
        e = Encoder()
        self.encode(e)
        return e.bytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "Transaction":
        return cls.decode(Decoder(data))


def op_payload(op: Op, copy: bool = False):
    """A write op's payload as a host buffer for the store's apply: the
    one sanctioned sink at apply for a DeviceBuf (which counts its own
    fetch).  ``copy=True`` for a store that keeps the buffer: a view
    into a staging slot must not outlive the slot's release."""
    d = op.data
    if hasattr(d, "wire_view"):
        v = d.wire_view()
        return bytes(v) if copy else v
    return d


class ValidationOverlay:
    """Lazy existence overlay for validate-then-apply transactions.

    Subclasses provide base-state lookups (`_base_coll`, `_base_obj`,
    `_base_count`); the overlay layers this transaction's pending
    effects on top WITHOUT materializing the store (each op validates in
    O(1); only RMCOLL's emptiness check pays a per-collection count, and
    only when an RMCOLL actually appears in the transaction)."""

    def __init__(self) -> None:
        self._colls: Dict[str, bool] = {}
        self._objs: Dict[Tuple[str, GHObject], bool] = {}
        self._count_delta: Dict[str, int] = {}
        self._fresh: Dict[str, bool] = {}  # created in this txn => base 0

    # -- base state hooks --------------------------------------------------
    def _base_coll(self, name: str) -> bool:
        raise NotImplementedError

    def _base_obj(self, name: str, oid: GHObject) -> bool:
        raise NotImplementedError

    def _base_count(self, name: str) -> int:
        raise NotImplementedError

    # -- overlay queries ---------------------------------------------------
    def coll_exists(self, name: str) -> bool:
        if name in self._colls:
            return self._colls[name]
        return self._base_coll(name)

    def obj_exists(self, name: str, oid: GHObject) -> bool:
        key = (name, oid)
        if key in self._objs:
            return self._objs[key]
        return self._base_obj(name, oid)

    def coll_empty(self, name: str) -> bool:
        base = 0 if self._fresh.get(name) else self._base_count(name)
        return base + self._count_delta.get(name, 0) <= 0

    # -- overlay mutations -------------------------------------------------
    def add_coll(self, name: str) -> None:
        self._colls[name] = True
        self._fresh[name] = True
        self._count_delta[name] = 0

    def rm_coll(self, name: str) -> None:
        self._colls[name] = False

    def create_obj(self, name: str, oid: GHObject) -> None:
        if not self.obj_exists(name, oid):
            self._objs[(name, oid)] = True
            self._count_delta[name] = self._count_delta.get(name, 0) + 1

    def rm_obj(self, name: str, oid: GHObject) -> None:
        if self.obj_exists(name, oid):
            self._objs[(name, oid)] = False
            self._count_delta[name] = self._count_delta.get(name, 0) - 1


def validate_op(op: Op, ov: ValidationOverlay) -> None:
    """Shared validation pass giving queue_transaction all-or-nothing
    semantics: raise exactly the errors apply would, before any backend
    mutates."""
    code = op.op
    cname = op.cid.name

    def need_coll():
        if not ov.coll_exists(cname):
            raise NoSuchCollection(cname)

    def need_obj():
        need_coll()
        if not ov.obj_exists(cname, op.oid):
            raise NoSuchObject(f"{cname}/{op.oid.name}")

    if code == OP_NOP:
        return
    if code == OP_MKCOLL:
        if ov.coll_exists(cname):
            raise StoreError(f"collection exists: {cname}")
        ov.add_coll(cname)
        return
    if code == OP_RMCOLL:
        need_coll()
        if not ov.coll_empty(cname):
            raise StoreError(f"collection not empty: {cname}")
        ov.rm_coll(cname)
        return
    if code in (OP_TOUCH, OP_WRITE, OP_ZERO, OP_TRUNCATE, OP_SETATTRS,
                OP_OMAP_SETKEYS):
        need_coll()
        ov.create_obj(cname, op.oid)
        return
    if code in (OP_REMOVE,):
        need_obj()
        ov.rm_obj(cname, op.oid)
        return
    if code == OP_TRY_REMOVE:
        need_coll()
        ov.rm_obj(cname, op.oid)
        return
    if code in (OP_RMATTR, OP_OMAP_RMKEYS, OP_OMAP_CLEAR):
        need_obj()
        return
    if code == OP_CLONE:
        need_obj()
        ov.create_obj(cname, op.dest_oid)
        return
    if code == OP_COLL_MOVE_RENAME:
        need_obj()
        if not ov.coll_exists(op.dest_cid.name):
            raise NoSuchCollection(op.dest_cid.name)
        ov.rm_obj(cname, op.oid)
        ov.create_obj(op.dest_cid.name, op.dest_oid)
        return
    raise StoreError(f"unknown op {code}")


class CommitPipeline:
    """Group-commit thread shared by the durable backends — the
    FileJournal group-commit / BlueStore `_kv_sync_thread` role.

    Submitters append their completion to the in-memory pending batch
    and return; the commit thread swaps the whole batch out (double
    buffering: batch N+1 collects while batch N syncs), runs the
    store's `sync_fn` ONCE for everything in it, then fires the
    completions in submission (WAL-seq) order.  A 16-deep writer queue
    therefore pays one fsync per BATCH, not one per transaction, and
    callers with no callback block on an event submitted through the
    same pipeline — so concurrent synchronous writers share fsyncs too.

    `freeze()`/`thaw()` hold the commit thread between WAL append and
    the batched sync: the crash-safety tests use the window to model a
    kill mid-batch (records appended, nothing fsynced, no completion
    fired).
    """

    def __init__(self, sync_fn: Callable[[], None],
                 perf=None, log: Optional[Callable[[str], None]] = None
                 ) -> None:
        self._sync_fn = sync_fn
        self._perf = perf  # PerfCounters with commit_batch/commit_lat
        self._log = log or (lambda s: print(f"store-commit: {s}",
                                            file=sys.stderr))
        self._cond = threading.Condition()
        self._pending: List[Tuple[int, Callable[[], None]]] = []
        self._frozen = False
        self._stopping = False
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        with self._cond:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stopping = False
            self._thread = threading.Thread(
                target=self._run, name="store-commit", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        """Drain every pending completion (final sync included), then
        join the thread — the umount path."""
        with self._cond:
            if self._thread is None:
                return
            self._frozen = False
            self._stopping = True
            self._cond.notify_all()
        self._thread.join(timeout=10)
        self._thread = None

    def in_commit_thread(self) -> bool:
        return threading.current_thread() is self._thread

    # -- crash-window test hook -------------------------------------------
    def freeze(self) -> None:
        with self._cond:
            self._frozen = True

    def thaw(self) -> None:
        with self._cond:
            self._frozen = False
            self._cond.notify_all()

    # -- submission -------------------------------------------------------
    def submit(self, seq: int, on_commit: Callable[[], None]) -> None:
        """Stage a completion.  Callers submit while still holding the
        store lock that ordered their WAL append, so the pending list
        order IS WAL order.  A submit racing stop() (writer vs umount)
        commits inline rather than stranding the completion forever."""
        with self._cond:
            if self._thread is not None and not self._stopping:
                self._pending.append((seq, on_commit))
                self._cond.notify_all()
                return
        try:
            self._sync_fn()
        except Exception as e:
            self._log(f"inline sync during stop failed: {e!r}")
        on_commit()

    def flush(self) -> None:
        """Block until everything submitted so far has committed."""
        done = threading.Event()
        self.submit(-1, done.set)
        done.wait()

    # -- the commit thread ------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cond:
                self._cond.wait_for(
                    lambda: (self._pending and not self._frozen)
                    or self._stopping)
                if self._stopping and (not self._pending or self._frozen):
                    return
                batch, self._pending = self._pending, []
            # the WAL-appended-nothing-synced kill window: a schedule
            # can hold/kill here to model a crash mid-batch
            fp.failpoint("store.commit_batch.sync", n=len(batch))
            t0 = time.perf_counter()
            try:
                self._sync_fn()
            except Exception as e:
                # a failing sync must not strand submitters (there is
                # no error channel on on_commit); the store's state is
                # applied, durability degrades to wal_sync=False level
                # — but degraded durability must be LOUD
                self._log(f"batch sync failed: {e!r} (completions "
                          "fire; durability degraded this batch)")
            for _seq, cb in batch:
                try:
                    cb()
                except Exception as e:
                    # one completion's bug must not starve the rest
                    self._log(f"on_commit callback raised: {e!r}")
            if self._perf is not None:
                self._perf.hinc("commit_batch", len(batch))
                self._perf.tinc("commit_lat", time.perf_counter() - t0)


# extent-seal granularity (conf store_csum_extent_kib): the BlueStore
# csum_order analog — one crc32c per DEFAULT_EXTENT_SIZE bytes of
# logical object space, sealed at write time, verified at read time
DEFAULT_EXTENT_SIZE = 64 * 1024


class ExtentSeals:
    """Per-extent at-rest checksum record for one object.

    Extent i covers logical bytes [i*E, min((i+1)*E, size)) — the tail
    extent seals only the bytes that exist, so the record pins the
    object's extent count (and thereby its size class) as well as its
    content.  Versioned encoding per the dencoder discipline: a v2 may
    append fields; v1 decoders skip the unknown tail."""

    __slots__ = ("extent_size", "crcs")

    def __init__(self, extent_size: int = DEFAULT_EXTENT_SIZE,
                 crcs: Optional[List[int]] = None) -> None:
        self.extent_size = extent_size
        self.crcs: List[int] = list(crcs) if crcs else []

    def encode(self, e: Encoder) -> None:
        e.start(1, 1)
        e.u32(self.extent_size)
        e.seq(self.crcs, lambda enc, c: enc.u32(c))
        e.finish()

    @classmethod
    def decode(cls, d: Decoder) -> "ExtentSeals":
        d.start(1)
        s = cls(d.u32(), d.seq(lambda dd: dd.u32()))
        d.end()
        return s

    def to_bytes(self) -> bytes:
        e = Encoder()
        self.encode(e)
        return e.bytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "ExtentSeals":
        return cls.decode(Decoder(data))


class _SealMark:
    """Seal work one Transaction implies for one object: the union of
    dirtied logical byte ranges, or a whole-record verdict (full
    recompute / record drop)."""

    __slots__ = ("lo", "hi", "full", "drop", "fresh")

    def __init__(self) -> None:
        self.lo: Optional[int] = None
        self.hi = 0
        self.full = False   # recompute every extent from current bytes
        self.drop = False   # object removed: delete the seal record
        self.fresh = False  # pre-txn record is dead (remove+recreate)

    def dirty(self, lo: int, hi: int) -> None:
        if self.drop:
            # removed then recreated within the txn: the old record
            # describes a dead object — recompute from scratch
            self.drop = False
            self.fresh = True
            self.full = True
        self.lo = lo if self.lo is None else min(self.lo, lo)
        self.hi = max(self.hi, hi)

    def wipe(self) -> None:
        self.lo = None
        self.hi = 0
        self.full = False
        self.fresh = False
        self.drop = True


class ObjectStore:
    """Abstract backend. Writes go through queue_transaction; reads are
    direct.  `queue_transaction(t, on_commit)` validates and applies
    synchronously (read-your-writes holds on return) but DEFERS
    durability: `on_commit` fires from the backend's commit thread once
    the transaction is on stable storage, and many transactions ride
    one sync (group commit).  With no callback the call blocks until
    commit — the pre-async semantics — while still sharing the batched
    sync with concurrent writers.  Returns the transaction's WAL/commit
    sequence number."""

    # True on backends that ADDITIONALLY verify stored pages against
    # device-level checksums inside _read_span (BlockStore: crc32c per
    # 4KiB block — the disk-ECC analog).  Every backend now verifies
    # the bytes it SERVES against per-extent seals in the base read()
    # gate below, so this flag only records the extra device layer.
    checksums_at_rest = False

    # -- per-extent at-rest checksums (the BlueStore csum discipline) ----
    # Writes seal crc32c per csum_extent_size bytes of logical object
    # space into object metadata WITHIN the writing transaction
    # (partial overwrites re-seal only touched extents); every read
    # verifies exactly the extents it serves and raises ChecksumError
    # on mismatch.  Both knobs are daemon-wired from conf
    # (store_csum_extent_kib / store_verify_read).
    csum_extent_size = DEFAULT_EXTENT_SIZE
    verify_reads = True

    # -- silent-corruption injection (the scrub/repair test seam) ---------
    # Two routes corrupt the bytes a read SERVES without touching what
    # is stored (silent at-rest rot, invisible to everything but a
    # byte-reading deep scrub):
    #   - the store.corrupt_chunk / store.corrupt_xattr failpoints
    #     (seeded, match-scoped — the chaos-schedule route), and
    #   - debug_inject_data_err marks (conf store_debug_inject_data_err
    #     enables the mechanism, like the read-err hook) — the
    #     deterministic single-object route.  A REWRITE of a marked
    #     object clears its mark (the bad media got overwritten), so
    #     corrupt -> deep-scrub detect -> auto-repair -> clean re-scrub
    #     is a closed deterministic loop.
    debug_data_err_enabled = False

    def debug_inject_data_err(self, cid: Collection, oid: GHObject) -> None:
        if not hasattr(self, "_data_err_objs"):
            self._data_err_objs: set = set()
        self._data_err_objs.add((cid.name, oid.name, oid.shard))

    def debug_clear_data_err(self) -> None:
        if hasattr(self, "_data_err_objs"):
            self._data_err_objs.clear()

    def _note_data_write(self, cid: Collection, oid: GHObject) -> None:
        """Called by backends when an object's DATA is rewritten or the
        object removed: overwriting the media drops its data-err mark."""
        marks = getattr(self, "_data_err_objs", None)
        if marks:
            marks.discard((cid.name, oid.name, oid.shard))

    def _read_filter(self, data, cid: Collection, oid: GHObject):
        """The read-boundary corruption seam: every backend routes its
        read() return through here.  Disarmed cost is one enabled()
        check + one class-attr load."""
        if fp.enabled("store.corrupt_chunk") and fp.failpoint(
                "store.corrupt_chunk", oid=oid.name, coll=cid.name,
                shard=str(oid.shard)) is fp.CORRUPT:
            data = fp.corrupt_bytes(
                data, f"{cid.name}/{oid.name}/{oid.shard}")
        if self.debug_data_err_enabled:
            marks = getattr(self, "_data_err_objs", None)
            if marks and (cid.name, oid.name, oid.shard) in marks:
                data = fp.corrupt_bytes(
                    data, f"err/{cid.name}/{oid.name}/{oid.shard}")
        return data

    def _attr_filter(self, val, cid: Collection, oid: GHObject,
                     name: str):
        """getattr() twin of _read_filter (store.corrupt_xattr)."""
        if fp.enabled("store.corrupt_xattr") and fp.failpoint(
                "store.corrupt_xattr", oid=oid.name, coll=cid.name,
                shard=str(oid.shard), attr=name) is fp.CORRUPT:
            val = fp.corrupt_bytes(
                val, f"{cid.name}/{oid.name}/{oid.shard}/{name}")
        return val

    # -- lifecycle --------------------------------------------------------
    def mkfs(self) -> None:
        raise NotImplementedError

    def mount(self) -> None:
        raise NotImplementedError

    def umount(self) -> None:
        raise NotImplementedError

    # -- writes -----------------------------------------------------------
    def queue_transaction(self, t: Transaction,
                          on_commit: Optional[Callable[[], None]] = None
                          ) -> int:
        raise NotImplementedError

    def statfs(self) -> Tuple[int, int]:
        """(used_bytes, total_bytes) — the reference ObjectStore::statfs.
        Backends without a fixed device report a nominal capacity."""
        raise NotImplementedError

    # -- reads ------------------------------------------------------------
    def exists(self, cid: Collection, oid: GHObject) -> bool:
        raise NotImplementedError

    def read(self, cid: Collection, oid: GHObject, off: int = 0,
             length: int = 0) -> bytes:
        """length==0 → read to end.

        Concrete: THE verified-read gate.  Backends implement
        `_read_span` (one atomic snapshot of bytes + size + seal
        record); this method widens the request to extent-aligned
        coverage, routes the covering bytes through `_read_filter`
        (the injection seam sits BEFORE verification, so injected rot
        is caught here, at read time), verifies each covered extent
        against its seal, and only then slices out the requested
        range.  A mismatch bumps the store's `read_verify_fail`
        counter and raises ChecksumError — flipped bytes never leave
        the store."""
        E = self.csum_extent_size
        if not self.verify_reads:
            data, _size, _blob = self._read_span(cid, oid, off, length)
            return bytes(self._read_filter(data, cid, oid))
        cov_lo = (off // E) * E
        cov_len = (0 if length == 0
                   else ((off + length + E - 1) // E) * E - cov_lo)
        data, size, blob = self._read_span(cid, oid, cov_lo, cov_len)
        data = self._read_filter(data, cid, oid)
        if blob is not None:
            try:
                seals = ExtentSeals.from_bytes(blob)
            except Exception:
                self._verify_fail(cid, oid, "undecodable extent seals")
            if seals.extent_size != E:
                # sealed at a different granularity (extent-size conf
                # changed since the last write): verify whole-object at
                # the sealed granularity — rare, O(object) once
                data, size, _ = self._read_span(cid, oid, 0, 0)
                data = self._read_filter(data, cid, oid)
                self._verify_extents(data, 0, size, seals, cid, oid)
                end = size if length == 0 else min(size, off + length)
                return bytes(data[off:end])
            self._verify_extents(data, cov_lo, size, seals, cid, oid)
        lo = off - cov_lo
        if lo >= len(data):
            return b""
        return bytes(data[lo:] if length == 0 else data[lo:lo + length])

    def _read_span(self, cid: Collection, oid: GHObject, off: int,
                   length: int) -> Tuple[bytes, int, Optional[bytes]]:
        """One atomic snapshot serving the read gate: (bytes of
        [off, off+length) clipped to EOF — length==0 reads to end —,
        object size, encoded seal record or None).  Unfiltered and
        unverified; backends take their lock ONCE here so the bytes,
        the size, and the seals can never be torn against each other."""
        raise NotImplementedError

    def _verify_extents(self, data, base: int, size: int,
                        seals: ExtentSeals, cid: Collection,
                        oid: GHObject) -> None:
        """Verify the extents `data` (object bytes starting at logical
        offset `base`, extent-aligned) covers against their seals."""
        E = seals.extent_size
        n = len(seals.crcs)
        expect = (size + E - 1) // E
        if n != expect:
            self._verify_fail(
                cid, oid, f"seal count {n} != {expect} for size {size}")
        mv = memoryview(data) if not isinstance(data, memoryview) else data
        i0 = base // E
        covered = (len(data) + E - 1) // E
        for j in range(covered):
            i = i0 + j
            if i >= n:
                break
            if crc32c(mv[j * E:(j + 1) * E]) != seals.crcs[i]:
                self._verify_fail(cid, oid, f"extent {i} crc mismatch")

    def _verify_fail(self, cid: Collection, oid: GHObject,
                     why: str) -> None:
        pc = getattr(self, "perf", None)
        if pc is not None:
            pc.inc("read_verify_fail")
        raise ChecksumError(
            f"{cid.name}/{oid.name} shard {oid.shard}: {why}")

    # -- seal maintenance (called by backends inside txn apply) ----------
    def _seal_plan(self, t: Transaction, size_fn
                   ) -> Dict[Tuple[Collection, GHObject], _SealMark]:
        """Scan a validated Transaction for the seal work it implies.
        `size_fn(cid, oid) -> Optional[int]` reports PRE-apply sizes
        (None = absent); op-by-op size simulation keeps each dirty
        range tight — a partial overwrite re-seals only the extents it
        touches.  Backends call this BEFORE applying ops, apply, then
        feed each mark to `_seal_rebuild` with post-apply bytes —
        inside the same atomic scope as the data mutation."""
        marks: Dict[Tuple[Collection, GHObject], _SealMark] = {}
        sizes: Dict[Tuple[Collection, GHObject], int] = {}

        def size_of(cid, oid):
            k = (cid, oid)
            if k not in sizes:
                s = size_fn(cid, oid)
                sizes[k] = 0 if s is None else s
            return sizes[k]

        def mk(cid, oid):
            return marks.setdefault((cid, oid), _SealMark())

        for op in t.ops:
            code = op.op
            if code in (OP_WRITE, OP_ZERO):
                s = size_of(op.cid, op.oid)
                end = op.off + op.length
                # a write past EOF zero-fills the gap from old EOF
                mk(op.cid, op.oid).dirty(min(op.off, s), end)
                sizes[(op.cid, op.oid)] = max(s, end)
            elif code == OP_TRUNCATE:
                s = size_of(op.cid, op.oid)
                mk(op.cid, op.oid).dirty(min(op.off, s), max(op.off, s))
                sizes[(op.cid, op.oid)] = op.off
            elif code in (OP_REMOVE, OP_TRY_REMOVE):
                mk(op.cid, op.oid).wipe()
                sizes[(op.cid, op.oid)] = 0
            elif code == OP_CLONE:
                m = mk(op.cid, op.dest_oid)
                m.drop = False
                m.fresh = True
                m.full = True
                sizes[(op.cid, op.dest_oid)] = size_of(op.cid, op.oid)
            elif code == OP_COLL_MOVE_RENAME:
                mk(op.cid, op.oid).wipe()
                m = mk(op.dest_cid, op.dest_oid)
                m.drop = False
                m.fresh = True
                m.full = True
                sizes[(op.dest_cid, op.dest_oid)] = size_of(op.cid, op.oid)
                sizes[(op.cid, op.oid)] = 0
        return marks

    def _seal_rebuild(self, mark: _SealMark, size: Optional[int],
                      read_fn, old_blob: Optional[bytes]
                      ) -> Optional[bytes]:
        """New encoded seal record for one planned object, reading
        post-apply bytes via `read_fn(off, length)`.  None => the
        object is gone; delete its record.  Only extents intersecting
        the dirty range (plus coverage-change casualties: the tail
        extent when the size class moved, everything on a granularity
        change) are recomputed."""
        if mark.drop or size is None:
            return None
        E = self.csum_extent_size
        old = None
        if old_blob is not None and not mark.fresh and not mark.full:
            try:
                old = ExtentSeals.from_bytes(old_blob)
            except Exception:
                old = None
            if old is not None and old.extent_size != E:
                old = None  # granularity changed: full reseal
        n = (size + E - 1) // E
        old_n = len(old.crcs) if old is not None else 0
        crcs = list(old.crcs[:n]) if old is not None else []
        while len(crcs) < n:
            crcs.append(0)
        if old is None or mark.full or mark.lo is None:
            redo = list(range(n))
        else:
            lo = min(mark.lo, size)
            hi = min(mark.hi, size)
            todo = set(range(lo // E, min(n, (hi + E - 1) // E)))
            # the tail extent's coverage follows the object size: any
            # size-class change re-seals it, and extent indexes the old
            # record lacked are always computed fresh
            if n and old_n != n:
                todo.add(n - 1)
            todo.update(range(old_n, n))
            redo = sorted(todo)
        for i in redo:
            s = i * E
            crcs[i] = crc32c(read_fn(s, min(size, s + E) - s))
        return ExtentSeals(E, crcs).to_bytes()

    def stat(self, cid: Collection, oid: GHObject) -> int:
        """Returns size; raises NoSuchObject."""
        raise NotImplementedError

    def getattr(self, cid: Collection, oid: GHObject, name: str) -> bytes:
        raise NotImplementedError

    def getattrs(self, cid: Collection, oid: GHObject) -> Dict[str, bytes]:
        raise NotImplementedError

    def omap_get(self, cid: Collection, oid: GHObject) -> Dict[str, bytes]:
        raise NotImplementedError

    def omap_get_values(self, cid: Collection, oid: GHObject,
                        keys: List[str]) -> Dict[str, bytes]:
        omap = self.omap_get(cid, oid)
        return {k: omap[k] for k in keys if k in omap}

    def list_collections(self) -> List[Collection]:
        raise NotImplementedError

    def collection_exists(self, cid: Collection) -> bool:
        raise NotImplementedError

    def collection_list(self, cid: Collection) -> List[GHObject]:
        raise NotImplementedError
