"""Objecter — client-side op submission with CRUSH placement and
map-change resend.

The client library's engine (reference: src/osdc/Objecter.cc): every op
computes its own target from the client's OSDMap (`_calc_target`,
reference Objecter.cc:2794 — object -> PG -> up/acting primary, no
lookup server), sends to the primary, and tracks the op until a final
reply:

- map epoch change -> every in-flight op is re-targeted; ops whose
  acting primary moved are resent to the new one (reference
  Objecter.cc:2264-2380 _op_submit + handle_osd_map scan).
- retryable replies (EAGAIN from a write whose shard acks were lost to
  an interval change, ESTALE from a non-primary target) -> backoff +
  resend; real op errors (EPERM, ENOENT, ...) surface immediately.
- ops with no live primary (acting set empty / pool offline) park as
  "homeless" and resume on the next map (reference op_target_t::paused).
- timed-out sends resend to the current target; the PG's reqid dedup
  (client name + nonce + tid, mirroring osd_reqid_t) makes resends
  exactly-once even across primary failover.  The wait before such a
  resend doubles with each send of the op, up to ``RESEND_BACKOFF_MAX``
  times ``resend_interval`` (F12: on the card an op that outlived the
  1 s wait was sent again every second, and the copies, each a 4 MiB
  frame or a degraded read run again, slowed every op behind them).

Every op carries the submission-time epoch; replies carry the OSD's
epoch, which (being newer) flags that the client's map is stale —
mon-subscribed clients pick the new map up via their subscription.

Port of ``ceph_tpu/client/objecter.py``, all of it, with the reference's
lockdep name (``objecter``), reqid form (``"{entity}.{nonce}:{tid}"``)
and resend discipline.  The placement runs where the client's map walks
its rules: ``_calc_target`` is one ``OSDMap.pg_to_up_acting``, on the
card one launch of the rule walk (K6) and a copy back, made under the
objecter lock when ``_send_op`` targets an op.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ceph_tpu_torch.core.context import Context
from ceph_tpu_torch.core.lockdep import make_lock
from ceph_tpu_torch.msg.messenger import Dispatcher, Messenger
from ceph_tpu_torch.osd import messages as m
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.osd import types as t_
from ceph_tpu_torch.osd.types import OSDOp

EAGAIN = -11
ESTALE = -116  # target wasn't primary (stale client map) — retryable
ETIMEDOUT = -110


class ObjecterOp:
    """One tracked client op (reference Objecter::Op)."""

    __slots__ = ("tid", "pool", "oid", "ops", "reqid", "reply", "event",
                 "attempts", "last_send", "retry_at", "target",
                 "on_complete", "timeout_at", "snap_seq", "snaps",
                 "snapid", "pgid_override", "span")

    def __init__(self, tid: int, pool: int, oid: str, ops: List[OSDOp],
                 reqid: str, timeout: float,
                 on_complete: Optional[Callable] = None) -> None:
        self.tid = tid
        self.pool = pool
        self.oid = oid
        self.ops = ops
        self.reqid = reqid
        self.reply: Optional[m.MOSDOpReply] = None
        self.event = threading.Event()
        self.attempts = 0
        self.last_send = 0.0
        self.retry_at = 0.0  # backoff gate; 0 = send immediately
        self.target: Tuple[Tuple[int, int], int] = ((0, 0), -1)
        self.on_complete = on_complete
        self.timeout_at = time.monotonic() + timeout
        self.snap_seq = 0
        self.snaps: List[int] = []
        self.snapid = 0
        self.pgid_override = None
        self.span = None  # client root span when tracing is on

    # future-like surface
    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.event.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> m.MOSDOpReply:
        if not self.event.wait(timeout):
            raise TimeoutError(f"op tid={self.tid} oid={self.oid!r}")
        assert self.reply is not None
        return self.reply


class Objecter(Dispatcher):
    MAX_ATTEMPTS = 60
    RESEND_BACKOFF_MAX = 8

    def __init__(self, ctx: Context, msgr: Messenger,
                 resend_interval: float = 1.0,
                 backoff: float = 0.1) -> None:
        self.ctx = ctx
        self.msgr = msgr
        self.resend_interval = resend_interval
        self.backoff = backoff
        self.osdmap: Optional[OSDMap] = None
        self._map_event = threading.Event()  # set on first osdmap
        self.addrbook: Dict[int, object] = {}
        self.ops: Dict[int, ObjecterOp] = {}
        # linger (watch) registrations: cookie -> dict(pool, oid, cb,
        # primary) — re-sent to the new primary on failover (reference
        # Objecter::LingerOp / _linger_submit)
        self.lingers: Dict[int, Dict] = {}
        self._tid = 0
        self._lock = make_lock("objecter")
        self._stop = threading.Event()
        # client incarnation for exactly-once reqids (osd_reqid_t name +
        # the messenger nonce so a restarted client never collides)
        self._name = f"{msgr.entity}.{msgr.nonce & 0xFFFFFFFF}"
        msgr.add_dispatcher(self)
        self._ticker = threading.Thread(
            target=self._tick_loop, daemon=True, name="objecter-tick")
        self._ticker.start()

    # -- map handling ------------------------------------------------------
    def handle_osdmap(self, osdmap: OSDMap,
                      addrbook: Optional[Dict] = None) -> None:
        """Adopt a newer map and re-target every in-flight op
        (reference Objecter::handle_osd_map -> _scan_requests)."""
        with self._lock:
            # equal epochs re-scan: single-process harnesses mutate one
            # shared map object in place, and a re-notify must retarget
            if self.osdmap is not None and osdmap.epoch < self.osdmap.epoch:
                return
            self.osdmap = osdmap
            book = addrbook if addrbook is not None else dict(
                getattr(osdmap, "osd_addrs", {}) or {})
            if book:
                self.addrbook = book
            pending = list(self.ops.values())
        self._map_event.set()
        for op in pending:
            tgt = self._calc_target(op.pool, op.oid)
            # also kick never-sent ops: one born while the primary's
            # address was unknown parks homeless, and if the SAME
            # (pg, primary) later becomes reachable the target
            # comparison alone would never fire (thrash-hunt find: a
            # 30 s client stall with the whole cluster healthy)
            if tgt != op.target or op.target[1] < 0 or not op.last_send:
                self._send_op(op)
        # re-register watches whose primary moved (linger resend)
        with self._lock:
            lingers = list(self.lingers.items())
        for cookie, lg in lingers:
            _, primary = self._calc_target(lg["pool"], lg["oid"])
            if primary >= 0 and primary != lg.get("primary"):
                self._send_watch(cookie, lg)

    def wait_for_map(self, timeout: float = 10.0) -> None:
        # event-driven (handle_osdmap sets it): no 20 ms poll loop
        if not self._map_event.wait(timeout) or self.osdmap is None:
            raise TimeoutError("no osdmap received")

    # -- submission --------------------------------------------------------
    def _calc_target(self, pool: int, oid: str):
        """object -> pg -> acting primary (reference Objecter.cc:2794
        _calc_target over OSDMap.cc:2149,2417)."""
        # ONE reference read: the resend timer races handle_osdmap's
        # swap, and dereferencing self.osdmap twice could compute the
        # pgid from epoch N but the primary from epoch N+1.  OSDMap
        # objects are immutable once published, so a single snapshot
        # is coherent without the lock.
        # cephlint: disable=unguarded-shared-state — single GIL-atomic
        # reference read of an immutable-once-published map
        omap = self.osdmap
        assert omap is not None
        pgid = omap.object_to_pg(pool, oid)
        _up, _up_p, _acting, primary = omap.pg_to_up_acting(pgid)
        return pgid, primary

    def op_submit(self, pool: int, oid: str, ops: List[OSDOp],
                  timeout: float = 30.0,
                  on_complete: Optional[Callable] = None,
                  snapc: Optional[Tuple[int, List[int]]] = None,
                  snapid: int = 0, pgid=None) -> ObjecterOp:
        if self.osdmap is None:
            raise RuntimeError("objecter has no osdmap yet")
        with self._lock:
            self._tid += 1
            tid = self._tid
            op = ObjecterOp(tid, pool, oid, ops,
                            reqid=f"{self._name}:{tid}",
                            timeout=timeout, on_complete=on_complete)
            if snapc is not None:
                op.snap_seq, op.snaps = snapc[0], list(snapc[1])
            op.snapid = snapid
            # explicit PG targeting (pgls and other per-PG ops; the
            # reference's base_pgid path in Objecter::_calc_target)
            op.pgid_override = pgid
            tr = getattr(self.ctx, "trace", None)
            if tr is not None and tr.enabled:
                # the root of the cross-daemon tree: the context rides
                # the MOSDOp wire tail, so the primary's do_op span —
                # and every peer child under it — parents back here
                op.span = tr.start_span("client.op")
                op.span.annotate(f"sent pool={pool} oid={oid} "
                                 f"reqid={op.reqid}")
            self.ops[tid] = op
        self._send_op(op)
        return op

    def _send_op(self, op: ObjecterOp) -> None:
        with self._lock:
            if self.osdmap is None or op.tid not in self.ops:
                return
            override = getattr(op, "pgid_override", None)
            if override is not None:
                pgid = override
                _up, _up_p, _acting, primary = \
                    self.osdmap.pg_to_up_acting(pgid)
            else:
                pgid, primary = self._calc_target(op.pool, op.oid)
            op.target = (pgid, primary)
            addr = self.addrbook.get(primary)
            if primary < 0 or addr is None:
                # homeless: no live primary — parked until the next map
                return
            epoch = self.osdmap.epoch
            op.attempts += 1
            op.last_send = time.monotonic()
        msg = m.MOSDOp(pgid, epoch, op.oid, op.ops)
        msg.tid = op.tid
        msg.reqid = op.reqid
        msg.snap_seq, msg.snaps, msg.snapid = (op.snap_seq, op.snaps,
                                               op.snapid)
        if op.span is not None:
            msg.set_trace(op.span.context())  # wire-propagated context
        self.msgr.send_message(msg, addr)

    # -- watch/notify ------------------------------------------------------
    def watch(self, pool: int, oid: str, callback,
              timeout: float = 15.0) -> int:
        """Register a watch; callback(notify_id, payload) -> ack bytes.
        Returns the cookie (reference Objecter linger + OP_WATCH)."""
        with self._lock:
            self._tid += 1
            cookie = self._tid
            lg = {"pool": pool, "oid": oid, "cb": callback,
                  "primary": -1}
            self.lingers[cookie] = lg
        rep = self._send_watch(cookie, lg, wait=timeout)
        if rep is None or rep.result < 0:
            with self._lock:
                self.lingers.pop(cookie, None)
            raise RuntimeError(
                f"watch {oid!r} failed: "
                f"{rep.result if rep else 'timeout'}")
        return cookie

    def unwatch(self, cookie: int, timeout: float = 15.0) -> None:
        with self._lock:
            lg = self.lingers.pop(cookie, None)
        if lg is None:
            return
        op = self.op_submit(lg["pool"], lg["oid"],
                            [OSDOp(t_.OP_WATCH, off=cookie, name="unwatch")],
                            timeout=timeout)
        op.result(timeout)

    def _send_watch(self, cookie: int, lg: Dict,
                    wait: Optional[float] = None):
        _, primary = self._calc_target(lg["pool"], lg["oid"])
        lg["primary"] = primary
        op = self.op_submit(lg["pool"], lg["oid"],
                            [OSDOp(t_.OP_WATCH, off=cookie, name="watch")],
                            timeout=wait or 15.0)
        if wait is not None:
            try:
                return op.result(wait)
            except TimeoutError:
                return None
        return None

    # -- replies -----------------------------------------------------------
    def ms_can_fast_dispatch(self, msg) -> bool:
        # op replies finish inline on the client loop: completion is an
        # event set (+ an optional lightweight on_complete); skipping
        # the thread-pool hop halves the wakeups per op round trip
        return isinstance(msg, m.MOSDOpReply)

    def ms_dispatch(self, conn, msg) -> bool:
        if isinstance(msg, m.MWatchNotify):
            # cephlint: disable=no-blocking-on-loop — leaf lock,
            # microsecond hold, never held across an RPC/store op
            with self._lock:
                lg = self.lingers.get(msg.cookie)
            blob = b""
            if lg is not None:
                try:
                    blob = lg["cb"](msg.notify_id, msg.payload) or b""
                except Exception:
                    blob = b""
            ack = m.MWatchNotifyAck(msg.pgid, 0, msg.oid, msg.notify_id,
                                    msg.cookie, blob)
            conn.send(ack)
            return True
        if not isinstance(msg, m.MOSDOpReply):
            return False
        # cephlint: disable=no-blocking-on-loop — leaf lock (op table),
        # microsecond hold, never held across an RPC/store op
        with self._lock:
            op = self.ops.get(msg.tid)
            if op is None:
                return True  # dup reply of a completed op
            if msg.result in (EAGAIN, ESTALE) and (
                op.attempts < self.MAX_ATTEMPTS
                and time.monotonic() < op.timeout_at
            ):
                # retryable: EAGAIN = write interrupted by interval
                # change; ESTALE = target wasn't primary (stale map).
                # Backoff, then resend via the ticker.
                op.retry_at = time.monotonic() + self.backoff * min(
                    op.attempts, 10)
                return True
            del self.ops[op.tid]
        if op.span is not None:
            op.span.annotate(f"reply result={msg.result}")
            op.span.finish()
        op.reply = msg
        op.event.set()
        if op.on_complete is not None:
            op.on_complete(op)
        return True

    # -- resend/timeout ticker --------------------------------------------
    def _tick_loop(self) -> None:
        while not self._stop.wait(0.05):
            now = time.monotonic()
            with self._lock:
                pending = list(self.ops.values())
            for op in pending:
                if now > op.timeout_at:
                    with self._lock:
                        if self.ops.pop(op.tid, None) is None:
                            continue
                    if op.span is not None:
                        op.span.annotate(f"reply result={ETIMEDOUT}")
                        op.span.finish()
                    op.reply = m.MOSDOpReply(
                        op.target[0], 0, op.oid, op.ops, result=ETIMEDOUT)
                    op.event.set()
                    if op.on_complete is not None:
                        op.on_complete(op)
                elif op.retry_at and now >= op.retry_at:
                    op.retry_at = 0.0
                    self._send_op(op)
                elif not op.last_send:
                    # never sent: the op parked homeless at submit (no
                    # address for its primary) — keep re-attempting;
                    # _send_op parks it again harmlessly while the
                    # address is still unknown
                    self._send_op(op)
                elif now - op.last_send > self.resend_interval * min(
                        1 << max(op.attempts - 1, 0),
                        self.RESEND_BACKOFF_MAX):
                    # no reply: primary may have died before the map
                    # noticed; resend to the current target (reqid dedup
                    # makes this safe)
                    self._send_op(op)

    def shutdown(self) -> None:
        self._stop.set()
        self._ticker.join(timeout=5)
        with self._lock:
            pending = list(self.ops.values())
            self.ops.clear()
        for op in pending:
            if op.span is not None:
                op.span.finish()
            op.reply = m.MOSDOpReply(op.target[0], 0, op.oid, op.ops,
                                     result=ETIMEDOUT)
            op.event.set()
