"""A loopback cluster of PGs in one process, for either package.

``Net(pkg, profile, n_osds)`` holds ``n_osds`` hosts, each the duck-typed
PG host of ``ceph_tpu.osd.daemon`` (``chip_smoke.PhaseOSD``, with the
daemon's ``collect_pg_infos`` and notify registry) with one PG of that
package on its own MemStore.  It has the same shape for
``ceph_tpu`` and ``ceph_tpu_torch``, so a test drives both with the same
calls and compares what they did.

Every message goes through its bytes: the sender's ``to_bytes()`` is
recorded on the receiver (``Host.received``) and decoded anew there
with the source stamped, as a messenger delivers it.  Each host
dispatches what it receives on a thread of its own, in arrival order,
with the daemon's routing (``daemon.py:1249-1530``): replica applies
and reads inline, replies to the backend, the read callbacks and the
RPC waiters.  So a blocking ``rpc`` from a thread that holds a PG lock
is answered by the peers' threads, never its own.  Client ops enter
through ``Net.op``, which encodes the ``MOSDOp``, decodes it, calls
``pg.do_op`` on the caller's thread and waits for the one reply.

A down host (``Net.down``) is marked down in the shared map, its
address leaves the book, and nothing is delivered to or from it.
Scrub and repair take ``PhaseOSD``'s ``collect_scrub_maps``,
``fetch_remote_chunk_full`` and ``list_peer_objects``, and its replica
side: ``MScrub`` answered from ``local_scrub_map`` and ``MPGPull`` on a
thread of its own.  ``pull_from_peer`` is the daemon's
(``ceph_tpu_torch/osd/daemon.py``, driven in ``torch_daemon_harness``);
here it raises, as no case reaches it.
"""

from __future__ import annotations

import importlib
import queue
import threading
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Tuple

import chip_smoke

WAIT_S = 30.0
CLIENT = ("client", 4100)
CLIENT_NONCE = 0x5EED


def mods(pkg: str) -> SimpleNamespace:
    names = {"context": "core.context", "ec": "ec", "message": "msg.message",
             "m": "osd.messages", "t": "osd.types", "backend": "osd.backend",
             "pglog": "osd.pglog", "pg": "osd.pg", "osdmap": "osd.osdmap",
             "memstore": "store.memstore", "os": "store.objectstore"}
    return SimpleNamespace(pkg=pkg, **{k: importlib.import_module(
        f"{pkg}.{v}") for k, v in names.items()})


class Conn:
    """The connection a handler answers on: back to ``dst``."""

    def __init__(self, net: "Net", src: int, dst: int) -> None:
        self.net, self.src, self.dst = net, src, dst

    def send(self, msg) -> None:
        self.net.deliver(self.src, self.dst, msg)


class ClientConn:
    """A watcher's session: records what the primary sends it."""

    def __init__(self) -> None:
        self.got: List[bytes] = []

    def send(self, msg) -> None:
        self.got.append(msg.to_bytes())


class Host(chip_smoke.PhaseOSD):
    """osd.N: the PG's duck-typed host over the loopback: the phase
    host of ``chip_smoke.py`` (``new_tid``, ``track_reads``, reply
    routing, ``rpc``) with ``send_to_osd`` through the net, and the
    daemon's ``collect_pg_infos`` and notify registry."""

    def __init__(self, net: "Net", whoami: int, conf: dict) -> None:
        M = net.mods
        store = M.memstore.MemStore()
        store.mkfs()
        store.mount()
        super().__init__(M.context.Context(f"osd.{whoami}", dict(conf)),
                         whoami, store, net.map, net.epoch)
        self.net = net
        self.addr_book = net.addr_book
        self.received: List[Tuple[int, str, bytes]] = []
        self._notify_cbs: Dict[int, Callable] = {}
        self._q: "queue.Queue" = queue.Queue()
        self._idle = threading.Event()
        self._idle.set()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"loopback-osd{whoami}")
        self._thread.start()
        self.pg = None

    def send_to_osd(self, osd_id: int, msg) -> None:
        self.net.deliver(self.whoami, osd_id, msg)

    def collect_pg_infos(self, pg, peers, timeout: float = 10.0) -> dict:
        M = self.net.mods
        if not peers:
            return {}
        reps = self.rpc([(p, M.m.MPGQuery(pg.pgid, self.epoch(),
                                          M.t.EVersion())) for p in peers],
                        timeout=timeout)
        return {rep.src.num: rep.info for rep in reps
                if isinstance(rep, M.m.MPGInfo)}

    def register_notify(self, notify_id: int, cb) -> None:
        self._notify_cbs[notify_id] = cb

    def unregister_notify(self, notify_id: int) -> None:
        self._notify_cbs.pop(notify_id, None)

    # -- dispatch (daemon.py:1249-1530) -----------------------------------
    def post(self, src: int, msg) -> None:
        self._idle.clear()
        self._q.put((src, msg))

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                self.dispatch(*item)
            except Exception as e:  # noqa: BLE001 — recorded, never silent
                self.net.errors.append((self.whoami, repr(e)))
            finally:
                if self._q.empty():
                    self._idle.set()

    def dispatch(self, src: int, msg) -> None:
        m, pg = self.net.mods.m, self.pg
        conn = Conn(self.net, self.whoami, src)
        if isinstance(msg, (m.MOSDRepOpReply, m.MECSubWriteReply,
                            m.MECSubWriteVecReply)):
            who = ((msg.shard, src) if isinstance(msg, m.MECSubWriteReply)
                   else src)
            pg.backend.handle_reply(msg.tid, who)
        elif isinstance(msg, m.MECCommitNoteAck):
            pg.handle_commit_note_ack(msg)
        elif isinstance(msg, (m.MECSubReadReply, m.MECSubReadVecReply,
                              m.MPGInfo, m.MPGPushReply,
                              m.MPGRecoveryProbeReply, m.MScrubMap)):
            self.route_reply(msg)
        elif isinstance(msg, m.MOSDRepOp):
            pg.handle_rep_op(msg, conn)
        elif isinstance(msg, m.MECSubWrite):
            pg.handle_sub_write(msg, conn)
        elif isinstance(msg, m.MECSubWriteVec):
            pg.handle_sub_write_vec(msg, conn)
        elif isinstance(msg, m.MECSubRead):
            pg.handle_sub_read(msg, conn)
        elif isinstance(msg, m.MECSubReadVec):
            pg.handle_sub_read_vec(msg, conn)
        elif isinstance(msg, m.MPGRecoveryProbe):
            pg.handle_recovery_probe(msg, conn)
        elif isinstance(msg, m.MPGRollback):
            pg.handle_rollback(msg, conn)
        elif isinstance(msg, m.MECCommitNote):
            pg.handle_commit_note(msg, conn)
        elif isinstance(msg, m.MPGQuery):
            pg.handle_query(msg, conn)
        elif isinstance(msg, m.MPGPush):
            pg.handle_push(msg, conn)
        elif isinstance(msg, m.MPGPull):
            self.serve_pull(pg, msg, conn)
        elif isinstance(msg, m.MScrub):
            self.serve_scrub(pg, msg, conn)
        else:
            raise TypeError(f"loopback: no route for {type(msg).__name__}")

    def stop(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=10.0)


class Net:
    """``n_osds`` hosts with one PG each; shard s (EC) on osd
    ``s % n_osds``, a replicated pool on osds ``0 .. size-1``."""

    def __init__(self, pkg: str, profile: Optional[str], n_osds: int,
                 pgid=(2, 0), epoch: int = 7, conf: Optional[dict] = None,
                 device: str = "cpu", size: int = 3) -> None:
        self.mods = M = mods(pkg)
        self.epoch = epoch
        self.map = chip_smoke.PhaseMap()
        self.addr_book: Dict[int, tuple] = {o: ("loopback", o)
                                            for o in range(n_osds)}
        self.errors: List[tuple] = []
        self.dropped: List[Tuple[int, int, str]] = []
        self.drop: Optional[Callable[[int, int, object], bool]] = None
        self.hosts = [Host(self, o, conf or {}) for o in range(n_osds)]
        if profile is None:
            self.acting = list(range(size))
            pool = M.osdmap.PGPool(pool_id=pgid[0], size=size)
            codec = None
        else:
            kw = {"device": device} if pkg == "ceph_tpu_torch" else {}
            codec = M.ec.codec_from_profile(profile, **kw)
            n = codec.get_chunk_count()
            self.acting = [s % n_osds for s in range(n)]
            pool = M.osdmap.PGPool(pool_id=pgid[0], size=n,
                                   pool_type=3)
        for h in self.hosts:
            h.pg = M.pg.PG(pgid, pool, h, codec)
            h.pg.create_onstore()
        self.set_acting(self.acting, 0)
        self.primary.pg.state = M.pg.STATE_ACTIVE

    @property
    def primary(self) -> Host:
        return self.hosts[0]

    def set_acting(self, acting, primary: int, hosts=None) -> None:
        for h in hosts if hosts is not None else self.hosts:
            h.pg.update_acting(acting, primary)

    # -- delivery ---------------------------------------------------------
    def deliver(self, src: int, dst: int, msg) -> None:
        blob = msg.to_bytes()
        name = type(msg).__name__
        if (src in self.map.down or dst in self.map.down
                or (self.drop is not None and self.drop(src, dst, msg))):
            self.dropped.append((src, dst, name))
            return
        host = self.hosts[dst]
        host.received.append((src, name, blob))
        got = self.mods.message.Message.from_bytes(blob)
        got.src = self.mods.message.EntityName("osd", src)
        host.post(src, got)

    def set_down(self, osd: int, down: bool = True) -> None:
        if down:
            self.map.down.add(osd)
            self.addr_book.pop(osd, None)
        else:
            self.map.down.discard(osd)
            self.addr_book[osd] = ("loopback", osd)

    def settle(self, timeout: float = WAIT_S) -> None:
        """Wait until every PG's admission FIFOs are released (a write's
        fan-out ran) and every host has dispatched all it was sent,
        twice in a row (a dispatch may send more)."""
        deadline = time.monotonic() + timeout
        while any(h.pg._oid_pipes for h in self.hosts):
            assert time.monotonic() < deadline, "a write never fanned out"
            time.sleep(0.005)
        for _ in range(2):
            for h in self.hosts:
                assert h._idle.wait(timeout), f"osd.{h.whoami} busy"

    # -- client ops -------------------------------------------------------
    def op(self, oid: str, ops, reqid: str = "", snap_seq: int = 0,
           snaps=(), snapid: int = 0, conn=None, to: int = 0,
           wait: bool = True):
        """One ``MOSDOp`` through its bytes into osd ``to``'s
        ``do_op``; returns the reply (its bytes in ``reply.blob``), or
        the reply box when ``wait`` is False."""
        M = self.mods
        msg = M.m.MOSDOp(self.hosts[to].pg.pgid, self.epoch, oid,
                         list(ops))
        msg.reqid = reqid
        msg.snap_seq, msg.snaps, msg.snapid = snap_seq, list(snaps), snapid
        got = M.message.Message.from_bytes(msg.to_bytes())
        got.src = M.message.EntityName(*CLIENT)
        got.nonce = CLIENT_NONCE
        box: list = []
        ev = threading.Event()

        def reply(rep) -> None:
            rep.blob = rep.to_bytes()
            box.append(rep)
            ev.set()

        self.hosts[to].pg.do_op(got, reply, conn)
        if not wait:
            return box
        assert ev.wait(WAIT_S), f"no reply to {oid} {[o.op for o in ops]}"
        return box[0]

    def notify_ack(self, host: int, note_blob: bytes, reply: bytes) -> None:
        """The watcher's ack of one ``MWatchNotify`` (the daemon routes
        ``MWatchNotifyAck`` to the registered callback)."""
        M = self.mods
        note = M.message.Message.from_bytes(note_blob)
        cb = self.hosts[host]._notify_cbs.get(note.notify_id)
        assert cb is not None, "notify not registered"
        cb(M.message.EntityName(*CLIENT), CLIENT_NONCE, note.cookie, reply)

    def stop(self) -> None:
        for h in self.hosts:
            h.stop()
        assert not self.errors, self.errors
