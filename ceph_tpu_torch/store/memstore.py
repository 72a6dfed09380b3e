"""MemStore — the in-RAM ObjectStore for tests and in-process clusters.

Reference: src/os/memstore/ (SURVEY.md §2.1 "MemStore = in-RAM fake
backend used by tests"); same role here, plus it is the default backend
of the tier-2 in-process mini-cluster.  Transactions apply atomically
under one lock with all-or-nothing semantics (ops are validated before
any mutation).

Port of ``ceph_tpu/store/memstore.py``: the lock is the port's lockdep
``memstore``, the counters the port's ``PerfCounters``.
"""

from __future__ import annotations

from typing import Dict, List

from ceph_tpu_torch.core.lockdep import make_lock
from ceph_tpu_torch.core.perf import PerfCounters
from ceph_tpu_torch.store import objectstore as os_
from ceph_tpu_torch.store.objectstore import (
    Collection,
    GHObject,
    NoSuchCollection,
    NoSuchObject,
    ObjectStore,
    StoreError,
    Transaction,
    validate_op,
)


class _Obj:
    __slots__ = ("data", "xattrs", "omap", "seals")

    def __init__(self) -> None:
        self.data = bytearray()
        self.xattrs: Dict[str, bytes] = {}
        self.omap: Dict[str, bytes] = {}
        self.seals: bytes | None = None  # encoded ExtentSeals

    def clone(self) -> "_Obj":
        o = _Obj()
        o.data = bytearray(self.data)
        o.xattrs = dict(self.xattrs)
        o.omap = dict(self.omap)
        o.seals = self.seals
        return o


class MemStore(ObjectStore):
    def __init__(self) -> None:
        self._colls: Dict[Collection, Dict[GHObject, _Obj]] = {}
        self._lock = make_lock("memstore")
        self._mounted = False
        self._seq = 0
        # RAM can't rot, but the read gate still verifies: the
        # injection seam (corrupt_chunk / data-err marks) models media
        # rot on every backend, and the counter feeds osd.N.store
        pc = PerfCounters("memstore")
        pc.add_u64_counter("read_verify_fail",
                           "reads failing at-rest extent verification")
        self.perf = pc

    # -- lifecycle --------------------------------------------------------
    def mkfs(self) -> None:
        with self._lock:
            self._colls = {}

    def mount(self) -> None:
        self._mounted = True

    def umount(self) -> None:
        self._mounted = False

    # -- transaction apply ------------------------------------------------
    def queue_transaction(self, t: Transaction, on_commit=None) -> int:
        """All-or-nothing: a validation pass over an existence overlay
        raises before any mutation, so a failing op leaves no partial
        effects (the mutation pass itself cannot fail).  RAM is the
        durability point, so `on_commit` fires inline on apply."""
        with self._lock:
            self._validate(t)
            plan = self._seal_plan(t, self._size_locked)
            for op in t.ops:
                self._apply(op)
            self._reseal(plan)
            self._seq += 1
            seq = self._seq
        if on_commit is not None:
            on_commit()
        return seq

    def _validate(self, t: Transaction) -> None:
        store = self

        class Overlay(os_.ValidationOverlay):
            def _base_coll(self, name):
                return Collection(name) in store._colls

            def _base_obj(self, name, oid):
                c = store._colls.get(Collection(name))
                return c is not None and oid in c

            def _base_count(self, name):
                c = store._colls.get(Collection(name))
                return len(c) if c is not None else 0

        ov = Overlay()
        for op in t.ops:
            validate_op(op, ov)

    def _coll(self, cid: Collection) -> Dict[GHObject, _Obj]:
        c = self._colls.get(cid)
        if c is None:
            raise NoSuchCollection(str(cid))
        return c

    def _obj(self, cid: Collection, oid: GHObject, create: bool = False) -> _Obj:
        c = self._coll(cid)
        o = c.get(oid)
        if o is None:
            if not create:
                raise NoSuchObject(f"{cid.name}/{oid.name}")
            o = c[oid] = _Obj()
        return o

    def _apply(self, op: os_.Op) -> None:
        code = op.op
        if code == os_.OP_NOP:
            return
        if code == os_.OP_MKCOLL:
            if op.cid in self._colls:
                raise StoreError(f"collection exists: {op.cid.name}")
            self._colls[op.cid] = {}
            return
        if code == os_.OP_RMCOLL:
            c = self._coll(op.cid)
            if c:
                raise StoreError(f"collection not empty: {op.cid.name}")
            del self._colls[op.cid]
            return
        if code == os_.OP_TOUCH:
            self._obj(op.cid, op.oid, create=True)
            return
        if code == os_.OP_WRITE:
            o = self._obj(op.cid, op.oid, create=True)
            end = op.off + len(op.data)
            if len(o.data) < end:
                o.data.extend(b"\0" * (end - len(o.data)))
            # op_payload: a DeviceBuf lands here through its one
            # sanctioned view; the slice assignment copies it in
            o.data[op.off:end] = os_.op_payload(op)
            self._note_data_write(op.cid, op.oid)
            return
        if code == os_.OP_ZERO:
            o = self._obj(op.cid, op.oid, create=True)
            end = op.off + op.length
            if len(o.data) < end:
                o.data.extend(b"\0" * (end - len(o.data)))
            o.data[op.off:end] = b"\0" * op.length
            return
        if code == os_.OP_TRUNCATE:
            o = self._obj(op.cid, op.oid, create=True)
            size = op.off
            if len(o.data) > size:
                del o.data[size:]
            else:
                o.data.extend(b"\0" * (size - len(o.data)))
            return
        if code == os_.OP_REMOVE:
            c = self._coll(op.cid)
            if op.oid not in c:
                raise NoSuchObject(op.oid.name)
            del c[op.oid]
            self._note_data_write(op.cid, op.oid)
            return
        if code == os_.OP_TRY_REMOVE:
            self._coll(op.cid).pop(op.oid, None)
            self._note_data_write(op.cid, op.oid)
            return
        if code == os_.OP_SETATTRS:
            self._obj(op.cid, op.oid, create=True).xattrs.update(op.attrs)
            return
        if code == os_.OP_RMATTR:
            self._obj(op.cid, op.oid).xattrs.pop(op.keys[0], None)
            return
        if code == os_.OP_CLONE:
            src = self._obj(op.cid, op.oid)
            self._coll(op.cid)[op.dest_oid] = src.clone()
            return
        if code == os_.OP_OMAP_SETKEYS:
            self._obj(op.cid, op.oid, create=True).omap.update(op.attrs)
            return
        if code == os_.OP_OMAP_RMKEYS:
            o = self._obj(op.cid, op.oid)
            for k in op.keys:
                o.omap.pop(k, None)
            return
        if code == os_.OP_OMAP_CLEAR:
            self._obj(op.cid, op.oid).omap.clear()
            return
        if code == os_.OP_COLL_MOVE_RENAME:
            src_c = self._coll(op.cid)
            if op.oid not in src_c:
                raise NoSuchObject(op.oid.name)
            dst_c = self._coll(op.dest_cid)
            dst_c[op.dest_oid] = src_c.pop(op.oid)
            return
        raise StoreError(f"unknown op {code}")

    # -- extent seals ------------------------------------------------------
    def _size_locked(self, cid: Collection, oid: GHObject):
        c = self._colls.get(cid)
        o = c.get(oid) if c is not None else None
        return None if o is None else len(o.data)

    def _reseal(self, plan) -> None:
        """Post-apply half of the seal transaction (same lock as the
        data mutation): recompute each planned object's dirty extents
        from its now-current bytes."""
        for (cid, oid), mark in plan.items():
            c = self._colls.get(cid)
            o = c.get(oid) if c is not None else None
            if o is None:
                continue  # removed: the record dies with the object
            o.seals = self._seal_rebuild(
                mark, len(o.data),
                lambda s, ln, d=o.data: bytes(d[s:s + ln]),
                o.seals)

    # -- reads ------------------------------------------------------------
    def exists(self, cid: Collection, oid: GHObject) -> bool:
        with self._lock:
            c = self._colls.get(cid)
            return c is not None and oid in c

    def _read_span(self, cid: Collection, oid: GHObject, off: int = 0,
                   length: int = 0):
        # base-class read() routes this snapshot through the corruption
        # seam + extent verification outside the lock
        with self._lock:
            o = self._obj(cid, oid)
            if length == 0:
                data = bytes(o.data[off:])
            else:
                data = bytes(o.data[off:off + length])
            return data, len(o.data), o.seals

    def stat(self, cid: Collection, oid: GHObject) -> int:
        with self._lock:
            return len(self._obj(cid, oid).data)

    def getattr(self, cid: Collection, oid: GHObject, name: str) -> bytes:
        with self._lock:
            o = self._obj(cid, oid)
            if name not in o.xattrs:
                raise StoreError(f"no attr {name!r} on {oid.name}")
            val = o.xattrs[name]
        return self._attr_filter(val, cid, oid, name)

    def getattrs(self, cid: Collection, oid: GHObject) -> Dict[str, bytes]:
        with self._lock:
            return dict(self._obj(cid, oid).xattrs)

    def omap_get(self, cid: Collection, oid: GHObject) -> Dict[str, bytes]:
        with self._lock:
            return dict(self._obj(cid, oid).omap)

    def statfs(self):
        """Nominal 1 GiB device; used = logical bytes held."""
        with self._lock:
            used = sum(len(o.data) for coll in self._colls.values()
                       for o in coll.values())
        return used, 1 << 30

    def list_collections(self) -> List[Collection]:
        with self._lock:
            return sorted(self._colls.keys())

    def collection_exists(self, cid: Collection) -> bool:
        with self._lock:
            return cid in self._colls

    def collection_list(self, cid: Collection) -> List[GHObject]:
        with self._lock:
            return sorted(self._coll(cid).keys())
