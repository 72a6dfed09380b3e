"""librados-equivalent client facade: RadosClient + IoCtx.

The app-facing API (reference: src/librados/librados.cc:1517
IoCtx::operate and friends): a RadosClient owns the messenger, the
Objecter, and (for mon-backed clusters) a MonClient subscription that
feeds maps to the Objecter; an IoCtx scopes ops to one pool and exposes
sync + async object operations that all funnel through
``Objecter.op_submit``.

Port of ``ceph_tpu/client/rados.py``, all of it.  One difference:
``RadosClient`` takes ``device``, where a map it decodes from the
monitors walks its rules (the ``MonClient`` it builds gets it).  None
means the card, and raises without one before any messenger or thread
starts; ``device="cpu"`` walks the plain version.  An injected map
walks where it was built.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

from ceph_tpu_torch.client.objecter import Objecter, ObjecterOp
from ceph_tpu_torch.core.context import Context
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.msg.message import EntityName
from ceph_tpu_torch.msg.messenger import Messenger
from ceph_tpu_torch.osd import types as t_
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.osd.types import OSDOp


class RadosError(OSError):
    def __init__(self, rc: int, what: str = "") -> None:
        super().__init__(rc, what or f"rados op failed: {rc}")
        self.rc = rc


class RadosClient:
    """Connection owner (reference librados::RadosClient).

    Two bootstrap modes:
    - ``connect(monmap)``: subscribe to osdmaps through the mon cluster
      (the production path, reference MonClient subscriptions);
    - ``inject_osdmap(map, addrbook)``: direct map injection for
      single-process clusters/tests (the reference's librados-with-
      preloaded-map test harnesses).
    """

    def __init__(self, ctx: Optional[Context] = None,
                 name: Optional[EntityName] = None, device=None) -> None:
        # before any messenger or thread: no card and no device named
        # raises here
        self.device = resolve_device(device)
        self.ctx = ctx or Context("client")
        self.name = name or EntityName("client", random.getrandbits(31))
        self.msgr = Messenger(self.ctx, self.name)
        self.msgr.start()
        self.objecter = Objecter(self.ctx, self.msgr)
        self.monc = None

    # -- bootstrap ---------------------------------------------------------
    def connect(self, monmap, timeout: float = 10.0,
                auth=None) -> "RadosClient":
        """auth: optional (entity_name, secret) pair for cephx — the
        handshake yields the ticket every OSD session presents."""
        from ceph_tpu_torch.mon.client import MonClient

        self.monc = MonClient(self.msgr, monmap, device=self.device)
        if auth is not None:
            import threading
            import time as _time

            self._cephx = self.monc.authenticate(auth[0], auth[1],
                                                 timeout=timeout)
            self.msgr.set_auth(
                provider=lambda target="": self._cephx.build_authorizer(
                    target))

            def _renew() -> None:
                # refresh the ticket before expiry; sessions opened
                # after expiry would be rejected by every daemon
                while self.monc is not None:
                    left = self._cephx.expires - _time.time()
                    _time.sleep(max(30.0, left - 600))
                    try:
                        self._cephx = self.monc.authenticate(
                            auth[0], auth[1], timeout=timeout)
                    except Exception:
                        _time.sleep(30.0)

            threading.Thread(target=_renew, daemon=True,
                             name="cephx-renew").start()
        self.monc.subscribe_osdmap(
            lambda osdmap: self.objecter.handle_osdmap(osdmap))
        self.objecter.wait_for_map(timeout)
        return self

    def inject_osdmap(self, osdmap: OSDMap,
                      addrbook: Optional[Dict] = None) -> "RadosClient":
        self.objecter.handle_osdmap(osdmap, addrbook)
        return self

    def mon_command(self, cmd: dict, timeout: float = 10.0):
        if self.monc is None:
            raise RuntimeError("not connected to a mon cluster")
        return self.monc.command(cmd, timeout=timeout)

    def ioctx(self, pool_id: int) -> "IoCtx":
        return IoCtx(self, pool_id)

    def shutdown(self) -> None:
        if self.monc is not None:
            self.monc.close()  # wake command retries first
        self.objecter.shutdown()
        self.msgr.shutdown()


class IoCtx:
    """Pool-scoped object operations (reference librados::IoCtx)."""

    def __init__(self, client: RadosClient, pool_id: int) -> None:
        self.client = client
        self.pool = pool_id
        # self-managed snapshot context (reference SnapContext /
        # rados_ioctx_selfmanaged_snap_set_write_ctx): writes carry it
        # so the PG can clone-on-write
        self.snap_seq = 0
        self.snaps: List[int] = []

    # -- async core --------------------------------------------------------
    def aio_operate(self, oid: str, ops: List[OSDOp],
                    timeout: float = 30.0, snapid: int = 0) -> ObjecterOp:
        # cls calls (OP_CALL) may mutate server-side, so they carry the
        # snap context too — the PG decides writeness there
        snapc = ((self.snap_seq, self.snaps)
                 if self.snap_seq and any(
                     o.is_write() or o.op == t_.OP_CALL for o in ops)
                 else None)
        return self.client.objecter.op_submit(
            self.pool, oid, ops, timeout=timeout, snapc=snapc,
            snapid=snapid)

    def operate(self, oid: str, ops: List[OSDOp],
                timeout: float = 30.0, snapid: int = 0):
        rep = self.aio_operate(oid, ops, timeout=timeout,
                               snapid=snapid).result(timeout)
        return rep

    # -- self-managed snapshots -------------------------------------------
    def selfmanaged_snap_create(self) -> int:
        """Allocate a snap id (atomic cls counter — the mon snap-seq
        allocator role) and fold it into this ioctx's write context.
        The allocation itself runs OUTSIDE the snap context: the mon
        allocator never snapshots its own bookkeeping, and cloning the
        counter object would pollute the SnapMapper index."""
        saved_seq, saved_snaps = self.snap_seq, list(self.snaps)
        self.snap_seq, self.snaps = 0, []
        try:
            snapid = int(self.call("rados.snapmeta", "counter", "alloc",
                                   b"snapseq"))
        finally:
            self.snap_seq, self.snaps = saved_seq, saved_snaps
        self.set_snap_context(snapid, [snapid] + saved_snaps)
        return snapid

    def set_snap_context(self, seq: int, snaps: List[int]) -> None:
        self.snap_seq = seq
        self.snaps = list(snaps)

    def snap_read(self, oid: str, snapid: int, length: int = 0,
                  off: int = 0) -> bytes:
        rep = self.operate(
            oid, [OSDOp(t_.OP_READ, off=off, length=length)],
            snapid=snapid)
        self._check(rep)
        return rep.ops[0].out_data

    def snap_trim(self, oid: str, snapid: int) -> None:
        """Drop one object's clone for `snapid` (per-object trimmer;
        a background pool-wide trimmer is future work)."""
        self._check(self.operate(
            oid, [OSDOp(t_.OP_SNAPTRIM, off=snapid)]))

    def selfmanaged_snap_remove(self, snapid: int) -> None:
        self.snaps = [s for s in self.snaps if s != snapid]
        if self.snap_seq == snapid:
            self.snap_seq = max(self.snaps, default=0)

    def selfmanaged_snap_trim(self, snapid: int, timeout: float = 60.0,
                              batch: int = 16) -> dict:
        """Pool-wide snap trim: chunked SNAPTRIMPG per PG, looping on
        `remaining` (the reference snap-trimmer, queued per PG).
        Raises on an unreachable PG instead of under-counting."""
        import json

        osdmap = self.client.objecter.osdmap
        pool = osdmap.pools[self.pool]
        total = {"trimmed": 0, "failed": 0, "stale_dropped": 0}
        for ps in range(pool.pg_num):
            while True:
                rep = self.client.objecter.op_submit(
                    self.pool, "",
                    [OSDOp(t_.OP_SNAPTRIMPG, off=snapid, length=batch)],
                    timeout=timeout, pgid=(self.pool, ps)).result(timeout)
                self._check(rep)
                got = json.loads(rep.ops[0].out_data.decode())
                for k in ("trimmed", "failed", "stale_dropped"):
                    total[k] += got.get(k, 0)
                progressed = got.get("trimmed", 0) + got.get(
                    "stale_dropped", 0)
                if not got.get("remaining", 0) or not progressed:
                    break  # done, or stuck (failures repeat: don't spin)
        return total

    def _check(self, rep) -> None:
        if rep.result < 0:
            raise RadosError(rep.result, f"{rep.oid}")

    # -- sync convenience surface (librados.cc:1517 family) ---------------
    def write_full(self, oid: str, data: bytes) -> None:
        self._check(self.operate(
            oid, [OSDOp(t_.OP_WRITEFULL, data=data)]))

    def write(self, oid: str, data: bytes, off: int = 0) -> None:
        self._check(self.operate(
            oid, [OSDOp(t_.OP_WRITE, off=off, data=data)]))

    def append(self, oid: str, data: bytes) -> None:
        self._check(self.operate(oid, [OSDOp(t_.OP_APPEND, data=data)]))

    def read(self, oid: str, length: int = 0, off: int = 0) -> bytes:
        rep = self.operate(
            oid, [OSDOp(t_.OP_READ, off=off, length=length)])
        self._check(rep)
        return rep.ops[0].out_data

    def remove(self, oid: str) -> None:
        self._check(self.operate(oid, [OSDOp(t_.OP_DELETE)]))

    def stat(self, oid: str) -> int:
        from ceph_tpu_torch.core.encoding import Decoder

        rep = self.operate(oid, [OSDOp(t_.OP_STAT)])
        self._check(rep)
        return Decoder(rep.ops[0].out_data).u64()

    def truncate(self, oid: str, size: int) -> None:
        self._check(self.operate(oid, [OSDOp(t_.OP_TRUNCATE, off=size)]))

    def setxattr(self, oid: str, name: str, value: bytes) -> None:
        self._check(self.operate(
            oid, [OSDOp(t_.OP_SETXATTR, name=name, data=value)]))

    def getxattrs(self, oid: str) -> Dict[str, bytes]:
        """All xattrs of one object (rados_getxattrs role)."""
        rep = self.operate(oid, [OSDOp(t_.OP_GETXATTRS)])
        self._check(rep)
        return dict(rep.ops[0].out_kv)

    def getxattr(self, oid: str, name: str) -> bytes:
        rep = self.operate(oid, [OSDOp(t_.OP_GETXATTR, name=name)])
        self._check(rep)
        return rep.ops[0].out_data

    def list_objects(self, timeout: float = 30.0) -> List[str]:
        """Pool-wide object listing: one PGLS per PG, merged (reference
        librados nobjects_begin over CEPH_OSD_OP_PGLS)."""
        import json

        osdmap = self.client.objecter.osdmap
        pool = osdmap.pools[self.pool]
        names: set = set()
        for ps in range(pool.pg_num):
            rep = self.client.objecter.op_submit(
                self.pool, "", [OSDOp(t_.OP_PGLS)], timeout=timeout,
                pgid=(self.pool, ps)).result(timeout)
            if rep.result == 0 and rep.ops[0].out_data:
                names.update(json.loads(rep.ops[0].out_data.decode()))
        return sorted(names)

    def call(self, oid: str, cls: str, method: str,
             indata: bytes = b"") -> bytes:
        """Execute an object-class method server-side (reference
        IoCtx::exec over OP_CALL / src/cls/)."""
        rep = self.operate(
            oid, [OSDOp(t_.OP_CALL, name=f"{cls}.{method}", data=indata)])
        self._check(rep)
        return rep.ops[0].out_data

    # -- watch/notify (reference rados_watch/rados_notify) ----------------
    def watch(self, oid: str, callback) -> int:
        """callback(notify_id, payload) -> ack bytes; returns cookie."""
        return self.client.objecter.watch(self.pool, oid, callback)

    def unwatch(self, cookie: int) -> None:
        self.client.objecter.unwatch(cookie)

    def notify(self, oid: str, payload: bytes = b"",
               timeout_ms: int = 5000):
        """Returns ({watcher key: ack bytes}, [watcher keys that never
        acked]).  Watcher keys are "<entity>.<nonce>:<cookie>" strings
        (two clients may legally share a cookie); match your own watch
        with key.endswith(f":{cookie}")."""
        rep = self.operate(
            oid, [OSDOp(t_.OP_NOTIFY, data=payload, length=timeout_ms)])
        self._check(rep)
        missed = [c for c in rep.ops[0].out_data.decode().split(",") if c]
        return rep.ops[0].out_kv, missed

    def omap_set(self, oid: str, kv: Dict[str, bytes]) -> None:
        self._check(self.operate(oid, [OSDOp(t_.OP_OMAP_SET, kv=kv)]))

    def omap_get(self, oid: str,
                 keys: Optional[List[str]] = None) -> Dict[str, bytes]:
        rep = self.operate(
            oid, [OSDOp(t_.OP_OMAP_GET, keys=keys or [])])
        self._check(rep)
        return rep.ops[0].out_kv

    def omap_rm(self, oid: str, keys: List[str]) -> None:
        self._check(self.operate(oid, [OSDOp(t_.OP_OMAP_RM, keys=keys)]))
