"""MonClient — commands, subscriptions, boot/failure reporting.

Reference: src/mon/MonClient.{h,cc}: daemons and clients find the
quorum via the monmap, send commands (retrying toward the leader on
redirect), subscribe to map updates, and (for OSDs) report boot and
peer failures.

Port of ``ceph_tpu/mon/client.py``, all of it.  It speaks the
reference's wire (``mon/messages.py``, the map codec and incrementals),
so it joins the reference's monitors as well as a port's.  One
difference: a full map it decodes walks its rules on the client's
``device`` (None: the card, and raises without one), and an applied
incremental keeps its base's, as ``osd/map_inc.py`` does.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ceph_tpu_torch.msg.message import EntityName, Message
from ceph_tpu_torch.core.lockdep import make_lock
from ceph_tpu_torch.msg.messenger import Connection, Dispatcher, Messenger
from ceph_tpu_torch.mon import messages as mm
from ceph_tpu_torch.mon.monitor import MonMap
from ceph_tpu_torch.osd import map_codec, map_inc

Addr = Tuple[str, int]


class MonClient(Dispatcher):
    """Attaches to an existing Messenger (daemons share one)."""

    def __init__(self, msgr: Messenger, monmap: MonMap,
                 device=None) -> None:
        self.msgr = msgr
        self.monmap = monmap
        self.device = device  # where a decoded full map walks its rules
        self._tid = 0
        self._lock = make_lock("monclient")
        self._closed = threading.Event()
        self._waiters: Dict[int, list] = {}
        self.on_osdmap: Optional[Callable] = None
        self.osdmap = None  # the client's current map (inc base)
        self._last_epoch = 0
        msgr.add_dispatcher(self)

    def close(self) -> None:
        """Wake any in-flight command retry loop immediately — both
        the redirect backoff and the per-RPC reply waits; the owning
        daemon shuts the shared messenger itself."""
        self._closed.set()
        with self._lock:
            waiters = list(self._waiters.values())
        for w in waiters:
            w[0].set()  # reply stays None; callers see closed and bail

    # -- dispatch ---------------------------------------------------------
    def ms_dispatch(self, conn: Connection, msg: Message) -> bool:
        if isinstance(msg, (mm.MMonCommandReply, mm.MAuthReply)):
            with self._lock:
                w = self._waiters.get(msg.tid)
            if w is not None:
                w[1] = msg
                w[0].set()
            return True
        if isinstance(msg, mm.MOSDMapMsg):
            # pushes arrive concurrently from every subscribed mon:
            # compare-and-set under the lock so an older epoch can never
            # be delivered after a newer one
            newmap = None
            resub = False
            with self._lock:
                if msg.epoch > self._last_epoch and self.on_osdmap:
                    if msg.data:
                        newmap = map_codec.decode_osdmap(
                            msg.data, device=self.device)
                    elif msg.incs and self.osdmap is not None:
                        try:
                            newmap = self.osdmap
                            for blob in msg.incs:
                                inc = map_inc.Incremental.decode(blob)
                                if inc.epoch <= newmap.epoch:
                                    continue  # another mon's push
                                    # already covered this prefix
                                newmap = inc.apply(newmap)
                        except Exception:
                            newmap = None
                        if newmap is not None \
                                and newmap.epoch <= self._last_epoch:
                            return True  # chain was entirely stale
                    if newmap is not None:
                        self._last_epoch = newmap.epoch
                        self.osdmap = newmap
                    else:
                        # inc chain didn't apply: ask for a full map
                        resub = True
            if newmap is not None:
                self.on_osdmap(newmap)
            elif resub:
                self._resubscribe(since=0)
            return True
        return False

    def _resubscribe(self, since: int) -> None:
        ip, port = self.msgr.addr
        for rank in self.monmap.live_ranks():
            self.msgr.send_message(
                mm.MMonSubscribe(f"osdmap:{ip}:{port}", since),
                self.monmap.addrs[rank])

    # -- commands ---------------------------------------------------------
    def command(self, cmd: dict, timeout: float = 10.0) -> Tuple[int, dict]:
        """Send to rank 0; follow 'not leader' redirects."""
        tries = 0
        rank = 0
        while tries < 2 * self.monmap.size:
            if self._closed.is_set():
                return -108, {"error": "mon client shut down"}
            rep = self._command_to(rank, cmd, timeout / 2)
            if rep is None:
                rank = (rank + 1) % self.monmap.size
                tries += 1
                continue
            if rep.code == -11 and "leader" in rep.out:
                leader = rep.out["leader"]
                rank = leader if leader >= 0 else (
                    (rank + 1) % self.monmap.size)
                tries += 1
                # election settling; interruptible so an owner tearing
                # the messenger down doesn't strand a command retry
                if self._closed.wait(0.2):
                    return -108, {"error": "mon client shut down"}
                continue
            return rep.code, rep.out
        return -110, {"error": "mon command timed out"}

    def _command_to(self, rank: int, cmd: dict,
                    timeout: float) -> Optional[mm.MMonCommandReply]:
        return self._rpc_to(rank, mm.MMonCommand(cmd), timeout)

    # -- authentication ---------------------------------------------------
    def authenticate(self, name: str, secret: bytes,
                     timeout: float = 10.0):
        """Cephx handshake: challenge -> proof -> ticket.  Returns a
        CephxClient whose build_authorizer() feeds Messenger.set_auth
        (reference MonClient's auth phase + CephxClientHandler)."""
        import secrets as _secrets

        from ceph_tpu_torch.auth import AuthError, CephxClient

        cx = CephxClient(name, secret)
        last = "no mon answered"
        for rank in self.monmap.live_ranks():
            rep = self._rpc_to(rank, mm.MAuth(
                mm.MAuth.GET_CHALLENGE, name), timeout / 2)
            if rep is None or rep.result != 0:
                last = f"mon.{rank}: challenge refused"
                continue
            cc = _secrets.token_bytes(16)
            proof = cx.make_proof(rep.challenge, cc)
            rep2 = self._rpc_to(rank, mm.MAuth(
                mm.MAuth.REQUEST, name, cc, proof), timeout / 2)
            if rep2 is None or rep2.result != 0:
                last = f"mon.{rank}: proof rejected"
                continue
            cx.accept_reply(rep2.sealed_client, rep2.ticket_blob)
            return cx
        raise AuthError(f"authentication failed for {name!r}: {last}")

    def _rpc_to(self, rank: int, msg: Message, timeout: float):
        with self._lock:
            self._tid += 1
            tid = self._tid
            ev = threading.Event()
            self._waiters[tid] = [ev, None]
        msg.tid = tid
        self.msgr.send_message(msg, self.monmap.addrs[rank])
        ok = ev.wait(timeout)
        with self._lock:
            w = self._waiters.pop(tid, None)
        return w[1] if ok and w else None

    # -- subscriptions ----------------------------------------------------
    def subscribe_osdmap(self, cb: Callable, since: int = 0,
                         base=None) -> None:
        """cb(OSDMap) fires on every newer committed map.  `base` (the
        caller's current map) seeds the incremental-apply chain so
        pushes after `since` arrive as O(delta) incs."""
        self.on_osdmap = cb
        if base is not None:
            self.osdmap = base
            self._last_epoch = base.epoch
        self._resubscribe(since)

    # -- osd daemon hooks -------------------------------------------------
    def send_boot(self, osd_id: int,
                  hb_addr: Optional[Addr] = None) -> None:
        ip, port = self.msgr.addr
        hb_ip, hb_port = hb_addr if hb_addr else ("", 0)
        for rank in self.monmap.live_ranks():
            self.msgr.send_message(
                mm.MOSDBoot(osd_id, ip, port, hb_ip, hb_port),
                self.monmap.addrs[rank])

    def report_failure(self, target: int, failed_for: float = 0.0) -> None:
        for rank in self.monmap.live_ranks():
            self.msgr.send_message(mm.MOSDFailure(target, failed_for),
                                   self.monmap.addrs[rank])

    def send_pg_stats(self, osd_id: int, epoch: int, pgs: list,
                      used_bytes: int = 0, total_bytes: int = 0,
                      slow_ops: int = 0,
                      heartbeat_misses: int = 0) -> None:
        """MPGStats feed (every mon keeps a transient mgr-style copy).

        ``pgs`` may be rich PGStat rows (osd/types.py) or legacy
        7-tuples; rich rows also populate the legacy field so old
        consumers keep reading the thin shape."""
        stats = [p for p in pgs if hasattr(p, "as_legacy")]
        legacy = [p.as_legacy() if hasattr(p, "as_legacy") else p
                  for p in pgs]
        for rank in self.monmap.live_ranks():
            self.msgr.send_message(
                mm.MPGStats(osd_id, epoch, legacy, used_bytes,
                            total_bytes, stats=stats, slow_ops=slow_ops,
                            heartbeat_misses=heartbeat_misses),
                self.monmap.addrs[rank])
