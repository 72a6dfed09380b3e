"""Monitor: leader election, multi-instance Paxos and the OSDMonitor
service, with ``MonMap``, the versioned roster of monitors.

Port of ``ceph_tpu/mon/monitor.py``, all of it (reference:
src/mon/Monitor.{h,cc}, Elector.cc for the rank-deference election,
Paxos.cc for the leader-driven collect/begin/accept/commit with unique
proposal numbers, OSDMonitor.cc for the map mutations: boot, failure
reports with min-reporter counting per prepare_failure :2643 /
check_failure :2537, down->out aging, pool and EC-profile commands,
MonitorDBStore.h for the paxos log in a local KV, MonMap.h).

The elected leader serializes every map mutation through Paxos; a
committed version is an incremental delta of the OSDMap (a full map
every ``FULL_EVERY`` epochs as a replay anchor) or a tagged service
payload (``mon/services.py``); every mon pushes committed maps to its
subscribers, so clients may subscribe anywhere while only the leader
accepts mutations.  The names, constants, lock names, KV keys and the
JSON a command answers are the reference's, and a committed value is
the same bytes, so a port mon and a reference mon form one quorum and a
mon's store directory mounts under either package.

Two differences.  ``Monitor`` takes ``device``: the ``OSDMap``s it
decodes, clones and proposes walk their CRUSH rules there (None: the
card, raising before any socket or thread exists when there is none;
``"cpu"``: the plain walk), so the one place the monitor walks CRUSH,
the ``pg scrub``/``deep-scrub``/``repair`` relay's
``pg_to_up_acting``, is a K6 launch on the card.  And a mon that learns
a version past a gap also asks for the full map (``_learn``), where the
reference asks only for the services' state and can keep a stale map.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.msg.message import EntityName, Message
from ceph_tpu_torch.msg.messenger import Connection, Dispatcher, Messenger
from ceph_tpu_torch.mon import messages as mm
from ceph_tpu_torch.osd import map_codec, map_inc
from ceph_tpu_torch.osd.osdmap import (OSDMap, PGPool, POOL_ERASURE,
                                       POOL_REPLICATED)
from ceph_tpu_torch.store.kv import MemDB, WriteBatch

Addr = Tuple[str, int]

# commit a full map (not a delta) every Nth epoch: a replay anchor that
# bounds incremental chains (reference: OSDMonitor's periodic full_X)
FULL_EVERY = 32

STATE_ELECTING = "electing"
STATE_LEADER = "leader"
STATE_PEON = "peon"


class MonMap:
    """Versioned mon roster: rank -> address (reference MonMap).
    Mutations go through the MonmapMonitor paxos service, which
    REPLACES a monitor's monmap rather than mutating a (possibly
    shared) instance."""

    def __init__(self, addrs: List[Optional[Addr]], epoch: int = 1) -> None:
        # a removed rank leaves a None HOLE: ranks are identity (baked
        # into entity names and running sessions), so they never shift
        self.addrs = [tuple(a) if a is not None else None for a in addrs]
        self.epoch = epoch

    @property
    def size(self) -> int:
        return len(self.addrs)  # rank slots, incl. holes

    def live_ranks(self) -> List[int]:
        return [r for r, a in enumerate(self.addrs) if a is not None]

    def quorum(self) -> int:
        return len(self.live_ranks()) // 2 + 1

    def to_dict(self) -> dict:
        return {"epoch": self.epoch,
                "addrs": [list(a) if a is not None else None
                          for a in self.addrs]}

    @classmethod
    def from_dict(cls, d: dict) -> "MonMap":
        return cls([tuple(a) if a is not None else None
                    for a in d["addrs"]], epoch=d["epoch"])

    def with_added(self, addr: Addr) -> "MonMap":
        return MonMap(self.addrs + [tuple(addr)], epoch=self.epoch + 1)

    def with_removed(self, rank: int) -> "MonMap":
        addrs = list(self.addrs)
        addrs[rank] = None
        return MonMap(addrs, epoch=self.epoch + 1)


class Monitor(Dispatcher):
    def __init__(self, ctx, rank: int, monmap: MonMap,
                 kv=None, initial_map: Optional[OSDMap] = None,
                 bind_port: int = 0, keyring=None, device=None) -> None:
        # resolved first: without a card, device=None raises here,
        # before a messenger or a thread exists
        self.device = resolve_device(device)
        self.ctx = ctx
        self.rank = rank
        self.monmap = monmap
        # cephx auth service (reference AuthMonitor/CephxServiceHandler):
        # active when a keyring is provided; the MAuth exchange itself
        # rides unauthenticated mon connections (as in the reference's
        # connection-negotiation phase)
        self.auth_server = None
        if keyring is not None:
            from ceph_tpu_torch.auth import CephxServer

            self.auth_server = CephxServer(keyring)
        self.kv = kv if kv is not None else MemDB()
        self.msgr = Messenger(ctx, EntityName("mon", rank),
                              bind_port=bind_port)
        self.msgr.add_dispatcher(self)
        if self.auth_server is not None:
            # the mon's own dial-backs (map pushes to daemons/clients)
            # carry a self-minted ticket verifiable by the service key
            self.msgr.set_auth(
                provider=lambda target="": self.auth_server.mint_authorizer(
                    f"mon.{rank}", target=target))
        self._log = ctx.log.dout("mon")
        self._plog = ctx.log.dout("paxos")
        from ceph_tpu_torch.core.lockdep import make_lock

        self.lock = make_lock(f"mon{rank}")

        # election state
        self.state = STATE_ELECTING
        self.election_epoch = 0
        self.leader = -1
        self._acks: Set[int] = set()
        self._last_lease = time.monotonic()

        # paxos state (persisted)
        self.last_pn = 0
        self.accepted_pn = 0
        self.last_committed = 0
        self.uncommitted: Optional[Tuple[int, int, bytes]] = None
        self._accept_votes: Dict[int, Set[int]] = {}
        self._collect_acks: Dict[int, mm.MMonPaxos] = {}  # peon rank -> LAST
        self._collect_pn = 0          # pn of the in-flight collect round
        self._collect_complete = True  # no collect in flight
        self._proposing = False
        self._propose_queue: List[bytes] = []

        # osdmonitor state
        self.osdmap = initial_map
        # transient per-OSD PG stats (mgr-style, NOT paxos-committed;
        # reference: the MPGStats feed behind `ceph pg dump`)
        self.pg_stats: Dict[int, Tuple[float, list]] = {}
        self.osd_fullness: Dict[int, Tuple[int, int]] = {}
        # the PGMap digest (reference PGMap/MgrStatMonitor role):
        # aggregates the rich PGStat rows into per-pool df, pg-state
        # counts, degraded totals, and rate-derived io numbers —
        # transient like pg_stats, re-learned from the next reports
        from ceph_tpu_torch.mon.pgmap import PGMapService

        def _pool_size(pid: int) -> Optional[int]:
            m = self.osdmap
            p = m.pools.get(pid) if m is not None else None
            return p.size if p is not None else None

        def _osd_up(osd: int) -> bool:
            m = self.osdmap
            return bool(m is not None and 0 <= osd < m.max_osd
                        and m.is_up(osd))

        self.pgmap = PGMapService(ctx.conf, pool_size_fn=_pool_size,
                                  osd_up_fn=_osd_up)
        self.failure_reports: Dict[int, Dict[int, float]] = {}
        self.down_stamp: Dict[int, float] = {}
        self.subscribers: Dict[Addr, int] = {}  # addr -> last epoch sent
        # epoch -> (prev_epoch, inc bytes): the window subscribers can be
        # caught up from with O(delta) pushes
        self._recent_incs: Dict[int, Tuple[int, bytes]] = {}
        self.ec_profiles: Dict[str, str] = {
            "default": "plugin=isa k=2 m=1 technique=reed_sol_van",
        }

        # PaxosService family (reference src/mon/PaxosService.h):
        # Config/Log/Health/Auth monitors multiplexed onto this paxos
        from ceph_tpu_torch.mon import services as mon_services

        self.services = mon_services.build_services(self)

        # mutations accumulate into ONE pending map (the reference's
        # pending_inc): concurrent boots/failures/commands each cloning
        # the committed map would otherwise clobber each other
        self._pending_map: Optional[OSDMap] = None
        self._pending_crush: bytes = b""  # cached crush encoding
        self._stop = threading.Event()
        self._tick_thread: Optional[threading.Thread] = None

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        self.kv.open()
        # boot load holds the mon lock: the paxos counters it seeds
        # are guarded state everywhere else, and the tick/election
        # threads start a few lines down
        with self.lock:
            self._load()
        self.msgr.start()
        self._tick_thread = threading.Thread(
            target=self._tick_loop, daemon=True, name=f"mon{self.rank}-tick")
        self._tick_thread.start()
        if self.ctx.admin is not None:
            # cluster pane for tools/cephtop.py --cluster: the `ceph
            # -s` digest + health over the admin socket, per-rank
            # prefixed like the per-daemon osd.N commands
            self.ctx.admin.register(
                f"mon.{self.rank} status", self._admin_status,
                "health + PGMap digest (the `ceph -s` payload)")
        self.start_election()

    def _admin_status(self, cmd: dict) -> dict:
        status, checks = self.services["health"].gather()
        return {"health": status,
                "checks": {k: v.get("summary", "") for k, v in
                           sorted(checks.items())},
                "digest": self.pgmap.digest()}

    def shutdown(self) -> None:
        self._stop.set()
        if self._tick_thread:
            self._tick_thread.join(timeout=5)
        self.msgr.shutdown()
        self.kv.close()

    @property
    def stopped(self) -> bool:
        """True once ``shutdown`` began.  A mon shut down keeps its last
        ``state``, so a leader lost keeps reading ``leader``."""
        return self._stop.is_set()

    @property
    def addr(self) -> Addr:
        return self.msgr.addr

    def _peers(self) -> List[int]:
        return [r for r in self.monmap.live_ranks() if r != self.rank]

    def _send_mon(self, rank: int, msg: Message) -> None:
        addr = (self.monmap.addrs[rank]
                if rank < self.monmap.size else None)
        if addr is None:
            return  # removed rank (monmap hole)
        self.msgr.send_message(msg, addr)

    # -- persistence ------------------------------------------------------
    def _load(self) -> None:
        pn = self.kv.get("paxos", "last_pn")
        self.last_pn = int(pn) if pn else 0
        ap = self.kv.get("paxos", "accepted_pn")
        self.accepted_pn = int(ap) if ap else 0
        lc = self.kv.get("paxos", "last_committed")
        self.last_committed = int(lc) if lc else 0
        if self.last_committed:
            # latest_full is only written at FULL anchors (writing the
            # O(cluster) image every commit would defeat the O(delta)
            # commit path); boot = anchor + replay of the committed
            # incrementals since it
            full = self.kv.get("mon", "latest_full")
            fv = self.kv.get("mon", "latest_full_v")
            if full:
                self.osdmap = map_codec.decode_osdmap(
                    full, device=self.device)
            start = int(fv) if fv else 0
            from ceph_tpu_torch.mon.services import SVC_TAG

            # track how far replay actually got: the boot anchor below
            # must never claim versions it did not fold in
            self._replayed_v = start
            for v in range(start + 1, self.last_committed + 1):
                data = self.kv.get("paxos_values", str(v))
                if not data:
                    self._replayed_v = v
                    continue
                if data[0] == SVC_TAG:
                    self._replayed_v = v
                    continue  # service state reloads from its own kv rows
                try:
                    newmap = map_inc.decode_value(data, self.osdmap,
                                                  device=self.device)
                    if (self.osdmap is None
                            or newmap.epoch > self.osdmap.epoch):
                        self.osdmap = newmap
                    self._replayed_v = v
                except map_inc.NeedFullMap:
                    # stale base: catch up from peers once live (F11:
                    # the tick loop asks until a map this new is
                    # adopted; the reference only comments on it)
                    if self._peers():
                        self._catchup_want = self.last_committed
                    break
                except Exception:
                    self._replayed_v = v
                    continue  # pre-framing legacy value
        # restore an accepted-but-uncommitted proposal: our promise must
        # survive restart or a new leader's collect can miss a value the
        # old leader already committed elsewhere (Paxos.cc handle_collect
        # sharing uncommitted state)
        upn = self.kv.get("paxos", "uncommitted_pn")
        uv = self.kv.get("paxos", "uncommitted_v")
        uval = self.kv.get("paxos", "uncommitted_value")
        if upn and uv and uval is not None and int(uv) > self.last_committed:
            self.uncommitted = (int(upn), int(uv), uval)
        prof = self.kv.get("mon", "ec_profiles")
        if prof:
            self.ec_profiles = json.loads(prof.decode())
        for svc in self.services.values():
            svc.load()
        if self.osdmap is not None and not self.kv.get("mon",
                                                       "latest_full"):
            # anchor the boot image: every later commit may be an
            # incremental, and incrementals replay on top of an anchor
            # — without this a FULL-quorum restart of a cluster that
            # only ever committed deltas loses the osdmap entirely
            # (no peer has a base to serve CATCHUP from).  Stamped
            # with the version replay actually REACHED (stamping
            # last_committed after a partial replay would permanently
            # skip the unapplied tail on every later boot).
            b = WriteBatch()
            b.set("mon", "latest_full", map_codec.encode_osdmap(
                self.osdmap))
            b.set("mon", "latest_full_v",
                  str(getattr(self, "_replayed_v", 0)).encode())
            self.kv.submit(b)

    def _persist(self, **kv_updates) -> None:
        b = WriteBatch()
        for key, val in kv_updates.items():
            if isinstance(val, bytes):
                b.set("paxos", key, val)
            else:
                b.set("paxos", key, str(val).encode())
        self.kv.submit(b)

    def _persist_value(self, version: int, value: bytes,
                       clear_uncommitted: bool = True,
                       extra: Optional[WriteBatch] = None) -> None:
        b = WriteBatch()
        if extra is not None:
            b.ops.extend(extra.ops)
        b.set("paxos_values", str(version), value)
        b.set("paxos", "last_committed", str(version).encode())
        if clear_uncommitted:
            # the promise is fulfilled; drop it so a restart doesn't
            # resurrect it
            b.rmkey("paxos", "uncommitted_pn")
            b.rmkey("paxos", "uncommitted_v")
            b.rmkey("paxos", "uncommitted_value")
        self.kv.submit(b)

    # -- election (Elector.cc shape) --------------------------------------
    def start_election(self) -> None:
        with self.lock:
            self.state = STATE_ELECTING
            self.election_epoch += 1
            self.leader = -1
            self._acks = {self.rank}
            epoch = self.election_epoch
        for r in self._peers():
            self._send_mon(r, mm.MMonElection(
                mm.MMonElection.PROPOSE, epoch, self.rank))
        # single-mon cluster wins immediately
        self._maybe_win()
        self._timer(1.0, self._election_timeout, epoch)

    def _timer(self, delay: float, fn, *args) -> None:
        t = threading.Timer(delay, fn, args=args)
        t.daemon = True  # never pin the process on a pending retry
        t.start()

    def _election_timeout(self, epoch: int) -> None:
        with self.lock:
            if (self.state == STATE_ELECTING
                    and self.election_epoch == epoch
                    and not self._stop.is_set()):
                pass  # retry
            else:
                return
        self._maybe_win(force_retry=True)

    def _maybe_win(self, force_retry: bool = False) -> None:
        with self.lock:
            if self.state != STATE_ELECTING:
                return
            if len(self._acks) >= self.monmap.quorum():
                self.state = STATE_LEADER
                self.leader = self.rank
                epoch = self.election_epoch
            elif force_retry:
                self.lock.release()
                try:
                    self.start_election()
                finally:
                    self.lock.acquire()
                return
            else:
                return
        self._log(1, f"mon.{self.rank} won election e{epoch}")
        for r in self._peers():
            self._send_mon(r, mm.MMonElection(
                mm.MMonElection.VICTORY, epoch, self.rank))
        self._leader_collect()

    def _handle_election(self, conn: Connection, msg: mm.MMonElection) -> None:
        restart = False
        with self.lock:
            if msg.op == mm.MMonElection.PROPOSE:
                if msg.rank < self.rank:
                    # deference: lower rank outranks us
                    if msg.epoch > self.election_epoch:
                        self.election_epoch = msg.epoch
                    self.state = STATE_ELECTING
                    ack = mm.MMonElection(mm.MMonElection.ACK,
                                          msg.epoch, self.rank)
                    self._send_mon(msg.rank, ack)
                else:
                    # we outrank the proposer: assert ourselves with a
                    # fresher epoch (reference Elector nag)
                    if self.state != STATE_ELECTING or (
                        msg.epoch >= self.election_epoch
                    ):
                        self.election_epoch = max(self.election_epoch,
                                                  msg.epoch)
                        restart = True
                if restart:
                    pass
            elif msg.op == mm.MMonElection.ACK:
                win = False
                if (self.state == STATE_ELECTING
                        and msg.epoch == self.election_epoch):
                    self._acks.add(msg.rank)
                    win = len(self._acks) >= self.monmap.quorum()
                if win:
                    self.lock.release()
                    try:
                        self._maybe_win()
                    finally:
                        self.lock.acquire()
                return
            elif msg.op == mm.MMonElection.VICTORY:
                if msg.rank > self.rank:
                    # refuse a worse leader: crossed victories in the
                    # first round otherwise leave the cluster split on
                    # a higher-ranked winner — re-assert with a newer
                    # epoch so the usurper stands down and acks us
                    self.election_epoch = max(self.election_epoch,
                                              msg.epoch)
                    restart = True
                else:
                    self.state = STATE_PEON
                    self.leader = msg.rank
                    self.election_epoch = max(self.election_epoch, msg.epoch)
                    self._last_lease = time.monotonic()
                    self._proposing = False
                    self._accept_votes.clear()
                    self._propose_queue.clear()
        if restart:
            self.start_election()

    # -- paxos ------------------------------------------------------------
    def _new_pn(self) -> int:
        self.last_pn = ((self.last_pn // 100) + 1) * 100 + self.rank
        self._persist(last_pn=self.last_pn)
        return self.last_pn

    def _leader_collect(self) -> None:
        """Phase 1 after winning: learn peons' state, recover in-flight
        proposals (Paxos.cc collect).  Phase 2 is gated on LAST acks from
        a full quorum (counting self) — proceeding with fewer can propose
        over a value an unreached peon already accepted (Paxos.cc
        handle_last's num_last accounting)."""
        with self.lock:
            if self.state != STATE_LEADER:
                return
            pn = self._new_pn()
            self.accepted_pn = pn
            self._persist(accepted_pn=pn)
            self._collect_acks = {}
            self._collect_pn = pn
            self._collect_complete = False
            # a proposal in flight when the election interrupted us is
            # dead; recovery happens via the collect phase (uncommitted
            # re-propose), so reset the pipeline or it wedges forever
            self._proposing = False
            self._accept_votes.clear()
            msg = mm.MMonPaxos(mm.MMonPaxos.COLLECT, pn,
                               last_committed=self.last_committed)
        for r in self._peers():
            self._send_mon(r, msg)
        # a single-mon quorum (just us) proceeds immediately
        self._maybe_collect_done()
        self._timer(1.0, self._collect_timeout, pn)

    def _collect_timeout(self, pn: int) -> None:
        with self.lock:
            if (self.state != STATE_LEADER or self._collect_complete
                    or self._collect_pn != pn or self._stop.is_set()):
                return
        self._plog(1, "collect quorum timeout; retrying with fresh pn")
        self._leader_collect()

    def _maybe_collect_done(self) -> None:
        with self.lock:
            if self.state != STATE_LEADER or self._collect_complete:
                return
            acks = list(self._collect_acks.values())
            # NACK: a peon promised a higher pn than ours — re-collect
            # with a fresh pn above it
            top = max((a.pn for a in acks), default=0)
            if top > self.accepted_pn:
                self.last_pn = max(self.last_pn, top)
                self._persist(last_pn=self.last_pn)
                self._collect_complete = True
                retry = True
            elif len(acks) + 1 >= self.monmap.quorum():
                self._collect_complete = True
                retry = False
            else:
                return  # keep waiting for more LASTs
        if retry:
            self._leader_collect()
            return
        with self.lock:
            # adopt the newest uncommitted value from the quorum
            best = None
            for a in acks:
                if a.uncommitted_v and a.uncommitted_v > self.last_committed:
                    if best is None or a.uncommitted_pn > best.uncommitted_pn:
                        best = a
            if self.uncommitted and (
                self.uncommitted[1] > self.last_committed
            ) and (best is None
                   or self.uncommitted[0] >= best.uncommitted_pn):
                redo = self.uncommitted[2]
            elif best is not None:
                redo = best.uncommitted_value
            else:
                redo = None
        if redo is not None:
            self._log(1, "re-proposing uncommitted value after election")
            self.propose(redo)
        else:
            self._pump_proposals()

    def _handle_paxos(self, conn: Connection, msg: mm.MMonPaxos) -> None:
        op = msg.op
        if op == mm.MMonPaxos.COLLECT:
            with self.lock:
                if msg.pn > self.accepted_pn:
                    self.accepted_pn = msg.pn
                    self._persist(accepted_pn=msg.pn)
                # remember the highest pn ever seen so a future election
                # on THIS mon starts above it (else a new leader's pn can
                # undercut the old one's and every BEGIN is ignored)
                if msg.pn > self.last_pn:
                    self.last_pn = msg.pn
                    self._persist(last_pn=self.last_pn)
                # reply carries OUR accepted_pn: if it exceeds msg.pn the
                # collector learns its pn is stale (classic NACK)
                rep = mm.MMonPaxos(
                    mm.MMonPaxos.LAST, self.accepted_pn,
                    last_committed=self.last_committed)
                if self.uncommitted:
                    rep.uncommitted_pn = self.uncommitted[0]
                    rep.uncommitted_v = self.uncommitted[1]
                    rep.uncommitted_value = self.uncommitted[2]
                # help a behind leader catch up
                if msg.last_committed < self.last_committed:
                    data = self.kv.get("paxos_values",
                                       str(self.last_committed))
                    rep.version = self.last_committed
                    rep.value = data or b""
            conn.send(rep)
            return
        if op == mm.MMonPaxos.LAST:
            with self.lock:
                if self.state != STATE_LEADER or self._collect_complete:
                    return  # stale ack from a finished/abandoned round
                if msg.version > self.last_committed and msg.value:
                    self._learn(msg.version, msg.value)
                # ignore leftovers of an older collect (their pn is below
                # the round's); key by rank so resends don't double-count
                if msg.pn >= self._collect_pn:
                    rank = msg.src.num if msg.src else -1
                    self._collect_acks[rank] = msg
            self._maybe_collect_done()
            return
        if op == mm.MMonPaxos.BEGIN:
            with self.lock:
                if msg.pn > self.last_pn:
                    self.last_pn = msg.pn
                    self._persist(last_pn=self.last_pn)
                if msg.pn < self.accepted_pn:
                    return  # stale proposer
                self.uncommitted = (msg.pn, msg.version, msg.value)
                self._persist(uncommitted_pn=msg.pn,
                              uncommitted_v=msg.version,
                              uncommitted_value=msg.value)
                rep = mm.MMonPaxos(mm.MMonPaxos.ACCEPT, msg.pn,
                                   version=msg.version)
            conn.send(rep)
            return
        if op == mm.MMonPaxos.ACCEPT:
            fire = False
            with self.lock:
                votes = self._accept_votes.get(msg.version)
                if votes is not None:
                    votes.add(msg.src.num if msg.src else -1)
                    if len(votes) >= self.monmap.quorum():
                        del self._accept_votes[msg.version]
                        fire = True
            if fire:
                self._commit(msg.version)
            return
        if op == mm.MMonPaxos.COMMIT:
            with self.lock:
                if msg.version > self.last_committed:
                    self._learn(msg.version, msg.value)
            self._push_maps()
            return
        if op == mm.MMonPaxos.LEASE:
            with self.lock:
                self._last_lease = time.monotonic()
                if msg.version > self.last_committed and msg.value:
                    self._learn(msg.version, msg.value)
            return
        if op == mm.MMonPaxos.CATCHUP_REQ:
            # a peer learned an incremental it has no base for: hand it
            # the full current map (the reference's store-sync role)
            with self.lock:
                if self.osdmap is None:
                    return
                rep = mm.MMonPaxos(
                    mm.MMonPaxos.CATCHUP, self.accepted_pn,
                    version=self.last_committed,
                    value=map_inc.encode_full_value(self.osdmap))
            conn.send(rep)
            return
        if op == mm.MMonPaxos.CATCHUP:
            with self.lock:
                if msg.value:
                    try:
                        newmap = map_inc.decode_value(
                            msg.value, None, device=self.device)
                    except Exception:
                        return
                    if (self.osdmap is None
                            or newmap.epoch > self.osdmap.epoch):
                        self._adopt_map(newmap, msg.value, msg.version)
                    elif (getattr(self, "_catchup_want", 0)
                          and msg.version >= self._catchup_want):
                        # a peer at the wanted version holds no newer
                        # map: ours is current, and becomes the boot
                        # anchor past the versions this mon skipped
                        # (their values are not in its store) (F11)
                        self._catchup_want = 0
                        b = WriteBatch()
                        b.set("mon", "latest_full",
                              map_codec.encode_osdmap(self.osdmap))
                        b.set("mon", "latest_full_v",
                              str(self.last_committed).encode())
                        self.kv.submit(b)
            self._push_maps()
            return
        if op == mm.MMonPaxos.SYNC_REQ:
            # full-store-sync role (reference Monitor::sync_*): a mon
            # that jumped a paxos gap pulls every service's state
            with self.lock:
                snap = {name: s for name, s in (
                    (n, svc.snapshot())
                    for n, svc in self.services.items()) if s is not None}
                rep = mm.MMonPaxos(mm.MMonPaxos.SYNC, self.accepted_pn,
                                   version=self.last_committed,
                                   value=json.dumps(snap).encode())
            conn.send(rep)
            return
        if op == mm.MMonPaxos.SYNC:
            with self.lock:
                # only adopt a snapshot at least as new as our paxos head
                if msg.version < self.last_committed or not msg.value:
                    return
                try:
                    snap = json.loads(msg.value.decode())
                except ValueError:
                    return
                batch = WriteBatch()
                for name, s in snap.items():
                    svc = self.services.get(name)
                    if svc is not None:
                        try:
                            svc.restore(s, batch)
                        except Exception as e:  # pragma: no cover
                            self._plog(0, f"sync restore {name}: {e}")
                if batch.ops:
                    self.kv.submit(batch)
            return

    def _learn(self, version: int, value: bytes) -> None:
        # a promise for a HIGHER version than what we just learned is
        # still live (e.g. we accepted v6, then catch up on v5 during a
        # collect): wiping it could erase the only surviving copy of a
        # value the old leader already committed
        keep = (self.uncommitted is not None
                and self.uncommitted[1] > version)
        if version > self.last_committed + 1:
            # we are JUMPING a gap: the skipped versions may carry
            # PaxosService values we'll never see — pull a full service
            # snapshot from whoever is ahead (reference store sync)
            req = mm.MMonPaxos(mm.MMonPaxos.SYNC_REQ, self.accepted_pn,
                               version=self.last_committed)
            targets = ([self.leader]
                       if self.leader >= 0 and self.leader != self.rank
                       else self._peers())
            for r in targets:
                self._send_mon(r, req)
            # ... and map incrementals, which the map misses: ask for the
            # full map as well, until one at least this new is adopted
            # (F11: the reference asks only when the value learned is an
            # incremental its map cannot take, so a gap that ends in a
            # service value left a restarted leader's map stale for good)
            self._catchup_want = max(
                getattr(self, "_catchup_want", 0), version)
            self._send_catchup_req()
        from ceph_tpu_torch.mon import services as mon_services

        if value and value[0] == mon_services.SVC_TAG:
            # PaxosService payload: the service's state rows land in the
            # SAME KV batch as the paxos value, so a crash can never
            # leave a committed value unapplied (the reference applies
            # service state in the paxos transaction,
            # PaxosService::propose_pending)
            batch = WriteBatch()
            try:
                payload = mon_services.decode_payload(value)
                svc = self.services.get(payload.get("svc", ""))
                if svc is not None:
                    svc.apply(payload, batch)
            except Exception as e:  # pragma: no cover
                self._plog(0, f"failed to apply service value: {e}")
            self._persist_value(version, value, clear_uncommitted=not keep,
                                extra=batch)
            self.last_committed = version
            if not keep:
                self.uncommitted = None
            return
        self._persist_value(version, value, clear_uncommitted=not keep)
        self.last_committed = version
        if not keep:
            self.uncommitted = None
        try:
            newmap = map_inc.decode_value(value, self.osdmap,
                                          device=self.device)
        except map_inc.NeedFullMap:
            # incremental with no matching base (we skipped commits):
            # fetch the full map — from the leader when we're a peon,
            # from every peer when we ARE the (freshly elected, stale)
            # leader; any mon with a newer map answers CATCHUP.  The
            # request is retried from the tick loop until a map at
            # least this new is adopted: a one-shot send is silently
            # dropped by a peer that is itself mid-restart (osdmap
            # still None), which stalled full-quorum recovery forever.
            self._catchup_want = max(
                getattr(self, "_catchup_want", 0), version)
            self._send_catchup_req()
            return
        except Exception as e:  # pragma: no cover
            self._plog(0, f"failed to decode committed map: {e}")
            return
        self._adopt_map(newmap, value, version)

    def _send_catchup_req(self) -> None:
        req = mm.MMonPaxos(mm.MMonPaxos.CATCHUP_REQ, self.accepted_pn,
                           version=self.last_committed)
        if self.leader >= 0 and self.leader != self.rank:
            self._send_mon(self.leader, req)
        else:
            for r in self._peers():
                self._send_mon(r, req)

    def _adopt_map(self, newmap: OSDMap, value: bytes,
                   version: int) -> None:
        self.osdmap = newmap
        if version >= getattr(self, "_catchup_want", 0):
            self._catchup_want = 0
        if value and value[0] == map_inc.INC_TAG:
            inc = map_inc.Incremental.decode(value[1:])
            self._recent_incs[inc.epoch] = (inc.prev_epoch, value[1:])
            while len(self._recent_incs) > 1024:
                del self._recent_incs[min(self._recent_incs)]
        else:
            # FULL anchor: persist the boot image + the version it
            # corresponds to (boot replays later incs on top of it)
            b = WriteBatch()
            b.set("mon", "latest_full", value[1:] if value
                  else map_codec.encode_osdmap(newmap))
            b.set("mon", "latest_full_v", str(version).encode())
            self.kv.submit(b)
        if (self._pending_map is not None
                and self.osdmap.epoch >= self._pending_map.epoch):
            self._pending_map = None  # fully caught up

    def propose(self, value: bytes) -> None:
        """Leader-only: serialize one value through phase 2."""
        with self.lock:
            if self.state != STATE_LEADER:
                return
            if self._proposing or not self._collect_complete:
                # queue until phase 1 has heard a quorum of LASTs —
                # proposing earlier can overwrite a value an unreached
                # peon already accepted for this version
                self._propose_queue.append(value)
                return
            self._proposing = True
            version = self.last_committed + 1
            pn = self.accepted_pn
            self.uncommitted = (pn, version, value)
            # the leader is an acceptor too: its own accept must survive
            # restart just like a peon's (ADVICE: promise lost on restart)
            self._persist(uncommitted_pn=pn, uncommitted_v=version,
                          uncommitted_value=value)
            self._accept_votes[version] = {self.rank}
            msg = mm.MMonPaxos(mm.MMonPaxos.BEGIN, pn, version, value)
        for r in self._peers():
            self._send_mon(r, msg)
        if len(self.monmap.live_ranks()) == 1:
            self._commit(version)

    def _commit(self, version: int) -> None:
        with self.lock:
            if not self.uncommitted or self.uncommitted[1] != version:
                self._proposing = False
                return
            value = self.uncommitted[2]
            self._learn(version, value)
            self._proposing = False
            msg = mm.MMonPaxos(mm.MMonPaxos.COMMIT, self.accepted_pn,
                               version, value)
        for r in self._peers():
            self._send_mon(r, msg)
        self._push_maps()
        self._pump_proposals()

    def _pump_proposals(self) -> None:
        with self.lock:
            if self._propose_queue and not self._proposing:
                nxt = self._propose_queue.pop(0)
            else:
                return
        self.propose(nxt)

    # -- ticks: leases, failure aging -------------------------------------
    def _tick_loop(self) -> None:
        iv = self.ctx.conf.get("mon_tick_interval")
        lease = self.ctx.conf.get("mon_lease")
        while not self._stop.wait(iv):
            with self.lock:
                state = self.state
            with self.lock:
                if getattr(self, "_catchup_want", 0):
                    # still missing a map base: keep asking (see _learn)
                    self._send_catchup_req()
            if state == STATE_LEADER:
                # snapshot pn/version/value under ONE lock hold: the
                # old code read last_committed once for the header and
                # again for the kv fetch, so a commit landing between
                # the two sent a lease whose value belonged to a
                # different version than its header claimed
                with self.lock:
                    pn = self.accepted_pn
                    ver = self.last_committed
                    data = self.kv.get("paxos_values", str(ver))
                msg = mm.MMonPaxos(mm.MMonPaxos.LEASE, pn, version=ver)
                msg.value = data or b""
                for r in self._peers():
                    self._send_mon(r, msg)
                self._osd_tick()
                try:
                    # health transition edges -> cluster log (leader
                    # only: peons would double-log through paxos)
                    self.services["health"].tick()
                except Exception as e:
                    self._log(1, f"health tick failed: {e!r}")
            elif state == STATE_PEON:
                with self.lock:
                    expired = (time.monotonic() - self._last_lease
                               > 2 * lease)
                if expired:
                    self._log(1, f"mon.{self.rank}: leader lease expired")
                    self.start_election()

    def _osd_tick(self) -> None:
        """down -> out aging (reference tick_osds / down_out_interval)."""
        interval = self.ctx.conf.get("mon_osd_down_out_interval")
        now = time.time()
        with self.lock:
            if self.osdmap is None:
                return
            stale = [osd for osd, stamp in self.down_stamp.items()
                     if (not self.osdmap.is_up(osd)
                         and self.osdmap.osd_weight[osd] != 0
                         and now - stamp > interval)]
            if stale:
                def mut(nm: OSDMap) -> None:
                    for osd in stale:
                        nm.set_osd_out(osd)

                self._mutate_map(mut)

    # -- osdmonitor -------------------------------------------------------
    def _clone_map(self) -> OSDMap:
        assert self.osdmap is not None
        # the reference's encode/decode round trip, onto the map's own
        # device: the map's state is host arrays, and its CRUSH map's
        # device copy is shared by content, so no tensor is copied
        return map_inc.clone_map(self.osdmap)

    def _mutate_map(self, fn) -> bool:
        """Apply `fn(pending_map)` and propose the result as an
        INCREMENTAL delta (full map every FULL_EVERY epochs as a replay
        anchor).  Must be called with self.lock held; returns False if
        there is no map."""
        if self.osdmap is None:
            return False
        if (self._pending_map is not None
                and self._pending_map.epoch != self.osdmap.epoch
                and self._pipeline_idle()):
            # nothing in flight or queued, yet the pending map is ahead
            # of the committed one: a value built on it was dropped (the
            # queue cleared on stepping down, a propose refused outside
            # leadership), and no later delta against it would carry
            # that change again (F15): start over from the committed map
            self._pending_map = None
        if self._pending_map is None:
            self._pending_map = self._clone_map()
            self._pending_map.epoch = self.osdmap.epoch
            self._pending_crush = map_inc.crush_bytes(self._pending_map)
        prev = map_inc.clone_map(self._pending_map)
        prev_crush = self._pending_crush
        fn(self._pending_map)
        self._pending_map.epoch += 1
        new_crush = map_inc.crush_bytes(self._pending_map)
        self._pending_crush = new_crush
        if self._pending_map.epoch % FULL_EVERY == 0:
            value = map_inc.encode_full_value(self._pending_map)
        else:
            value = map_inc.encode_inc_value(map_inc.diff_maps(
                prev, self._pending_map,
                old_crush=prev_crush, new_crush=new_crush))
        self.propose(value)
        return True

    def _pipeline_idle(self) -> bool:
        """Under the lock: no value in flight, queued, waiting on a
        collect, or left uncommitted for the collect to propose again."""
        return (not self._proposing and not self._propose_queue
                and self._collect_complete
                and not (self.uncommitted
                         and self.uncommitted[1] > self.last_committed))

    def _propose_map(self, newmap: OSDMap) -> None:
        # legacy single-shot path (commands built on _mutate_map now)
        with self.lock:
            newmap.epoch = (self.osdmap.epoch if self.osdmap else 0) + 1
        self.propose(map_inc.encode_full_value(newmap))

    def _handle_boot(self, msg: mm.MOSDBoot) -> None:
        with self.lock:
            if self.state != STATE_LEADER or self.osdmap is None:
                return
            if (self.osdmap.is_up(msg.osd_id)
                    and self.osdmap.osd_addrs.get(msg.osd_id)
                    == (msg.ip, msg.port)
                    and self.osdmap.osd_hb_addrs.get(msg.osd_id)
                    == (msg.hb_ip, msg.hb_port)):
                return  # duplicate boot retry; already reflected
            if not (0 <= msg.osd_id < self.osdmap.max_osd):
                return

            def mut(nm: OSDMap) -> None:
                nm.set_osd_up(msg.osd_id)
                if nm.osd_weight[msg.osd_id] == 0:
                    nm.set_osd_in(msg.osd_id)
                nm.osd_addrs[msg.osd_id] = (msg.ip, msg.port)
                if msg.hb_port:
                    nm.osd_hb_addrs[msg.osd_id] = (msg.hb_ip, msg.hb_port)

            self.failure_reports.pop(msg.osd_id, None)
            self.down_stamp.pop(msg.osd_id, None)
            self._log(1, f"osd.{msg.osd_id} booted at {msg.ip}:{msg.port}")
            self._mutate_map(mut)

    def _handle_failure(self, msg: mm.MOSDFailure) -> None:
        """prepare_failure: require min distinct reporters within grace
        accounting (OSDMonitor.cc:2643/:2537)."""
        reporter = msg.src.num if msg.src else -1
        with self.lock:
            if self.state != STATE_LEADER or self.osdmap is None:
                return
            if not self.osdmap.is_up(msg.target):
                return  # already down
            reports = self.failure_reports.setdefault(msg.target, {})
            reports[reporter] = time.time()
            need = self.ctx.conf.get("mon_osd_min_down_reporters")
            if len(reports) < need:
                return
            self.down_stamp[msg.target] = time.time()
            del self.failure_reports[msg.target]
            self._log(1, f"marking osd.{msg.target} down "
                      f"({len(reports)} reporters)")
            self._mutate_map(lambda nm: nm.set_osd_down(msg.target))

    # -- subscriptions ----------------------------------------------------
    def _inc_chain(self, last: int, epoch: int) -> Optional[List[bytes]]:
        """Incrementals taking a subscriber from `last` to `epoch`, or
        None if the window doesn't reach (send full instead)."""
        if last <= 0:
            return None
        chain: List[bytes] = []
        e = epoch
        while e > last:
            got = self._recent_incs.get(e)
            if got is None:
                return None
            prev, blob = got
            chain.append(blob)
            e = prev
        return list(reversed(chain)) if e == last else None

    def _push_maps(self) -> None:
        """Subscribers get O(delta) incremental pushes; the full map
        only on first subscribe or when they fell out of the window
        (reference OSDMonitor::send_incremental)."""
        sends: List[Tuple[Addr, mm.MOSDMapMsg]] = []
        with self.lock:
            if self.osdmap is None:
                return
            epoch = self.osdmap.epoch
            full = None
            for a, last in list(self.subscribers.items()):
                if last >= epoch:
                    continue
                chain = self._inc_chain(last, epoch)
                if chain is None:
                    if full is None:
                        full = map_codec.encode_osdmap(self.osdmap)
                    msg = mm.MOSDMapMsg(epoch, full)
                else:
                    msg = mm.MOSDMapMsg(epoch, b"")
                    msg.incs = chain
                sends.append((a, msg))
                self.subscribers[a] = epoch
        for a, msg in sends:
            self.msgr.send_message(msg, a)

    # -- commands ---------------------------------------------------------
    def _handle_command(self, conn: Connection,
                        msg: mm.MMonCommand) -> None:
        with self.lock:
            if self.state != STATE_LEADER:
                rep = mm.MMonCommandReply(-11, {"error": "not leader",
                                                "leader": self.leader})
                rep.tid = msg.tid
                conn.send(rep)
                return
        code, out = self._do_command(msg.cmd)
        rep = mm.MMonCommandReply(code, out)
        rep.tid = msg.tid
        conn.send(rep)

    def _do_command(self, cmd: dict) -> Tuple[int, dict]:
        prefix = cmd.get("prefix", "")
        if prefix == "status":
            # `ceph -s`: map summary + health + the PGMap digest
            # (pg states, degraded totals, client/recovery io rates)
            digest = self.pgmap.digest()
            status, _checks = self.services["health"].gather()
            with self.lock:
                m = self.osdmap
                n_up = int(m.osd_state_up.sum()) if m is not None else 0
                return 0, {
                    "health": status,
                    "quorum_leader": self.leader,
                    "election_epoch": self.election_epoch,
                    "osdmap_epoch": m.epoch if m else 0,
                    "num_osds": m.max_osd if m else 0,
                    "num_up_osds": n_up,
                    "pg_states": digest["pg_states"],
                    "num_pgs": digest["num_pgs"],
                    "degraded_objects": digest["degraded_objects"],
                    "degraded_ratio": digest["degraded_ratio"],
                    "misplaced_objects": digest["misplaced_objects"],
                    "unfound_objects": digest["unfound_objects"],
                    "io": digest["io"],
                    "pools": {p.name or str(pid): pid
                              for pid, p in (m.pools if m else {}).items()},
                }
        if prefix == "osd dump":
            with self.lock:
                m = self.osdmap
                if m is None:
                    return -2, {"error": "no osdmap"}
                return 0, {
                    "epoch": m.epoch,
                    "max_osd": m.max_osd,
                    "osds": [
                        {"osd": i, "up": bool(m.osd_state_up[i]),
                         "in": int(m.osd_weight[i]) > 0,
                         "weight": int(m.osd_weight[i]) / 0x10000,
                         "addr": list(m.osd_addrs.get(i, ("", 0)))}
                        for i in range(m.max_osd)
                    ],
                    "pools": [
                        {"pool": pid, "name": p.name,
                         "type": p.pool_type, "size": p.size,
                         "pg_num": p.pg_num,
                         "erasure_code_profile": p.erasure_code_profile}
                        for pid, p in m.pools.items()
                    ],
                }
        if prefix == "osd erasure-code-profile set":
            name = cmd["name"]
            profile = cmd["profile"]
            with self.lock:
                self.ec_profiles[name] = profile
                b = WriteBatch()
                b.set("mon", "ec_profiles",
                      json.dumps(self.ec_profiles).encode())
                self.kv.submit(b)
            return 0, {}
        if prefix == "osd erasure-code-profile ls":
            with self.lock:
                return 0, {"profiles": dict(self.ec_profiles)}
        if prefix == "osd pool create":
            return self._cmd_pool_create(cmd)
        if prefix in ("osd out", "osd in", "osd down"):
            osd = int(cmd["id"])
            with self.lock:
                if self.osdmap is None:
                    return -2, {"error": "no osdmap"}

                def mut(nm: OSDMap) -> None:
                    if prefix == "osd out":
                        nm.set_osd_out(osd)
                    elif prefix == "osd in":
                        nm.set_osd_in(osd)
                    else:
                        nm.set_osd_down(osd)

                if prefix == "osd down":
                    self.down_stamp[osd] = time.time()
                self._mutate_map(mut)
            return 0, {}
        if prefix == "osd df":
            with self.lock:
                rows = []
                for osd in sorted(self.osd_fullness):
                    used, total = self.osd_fullness[osd]
                    rows.append({
                        "osd": osd, "used_bytes": used,
                        "total_bytes": total,
                        "utilization": round(used / total, 4)
                        if total else 0.0})
                return 0, {"nodes": rows}
        if prefix == "df":
            # cluster + per-pool usage (the `ceph df` surface) from
            # the PGMap digest: objects AND stored bytes per pool,
            # degraded/unfound carried so `df` shows damage too
            digest = self.pgmap.digest()
            with self.lock:
                used = sum(u for u, _ in self.osd_fullness.values())
                total = sum(t for _, t in self.osd_fullness.values())
                pools = []
                if self.osdmap is not None:
                    for pid, p in sorted(self.osdmap.pools.items()):
                        row = digest["pools"].get(
                            pid, {"objects": 0, "bytes": 0,
                                  "degraded": 0, "misplaced": 0,
                                  "unfound": 0, "pgs": 0})
                        pools.append({"name": p.name, "id": pid,
                                      "objects": row["objects"],
                                      "stored_bytes": row["bytes"],
                                      "degraded": row["degraded"],
                                      "unfound": row["unfound"],
                                      "pgs": row["pgs"]})
                return 0, {"total_bytes": total, "used_bytes": used,
                           "avail_bytes": max(0, total - used),
                           "pools": pools}
        if prefix in ("pg scrub", "pg deep-scrub", "pg repair"):
            # relay to the PG's primary OSD (the reference mon builds an
            # MOSDScrub for `ceph pg repair`, src/mon/MonCmds.h) — the
            # actual scrub/repair runs there asynchronously
            try:
                pool_id, ps = (int(x) for x in str(cmd["pgid"]).split("."))
            except (KeyError, ValueError):
                return -22, {"error": "need pgid as <pool>.<ps>"}
            with self.lock:
                if self.osdmap is None:
                    return -2, {"error": "no osdmap"}
                _, _, _, primary = self.osdmap.pg_to_up_acting(
                    (pool_id, ps))
                addr = self.osdmap.osd_addrs.get(primary)
            if primary < 0 or not addr:
                return -11, {"error": "pg has no live primary"}
            # distinct actions for all THREE prefixes: `pg deep-scrub`
            # used to collapse to a shallow scrub here (the only
            # byte-reading verification an operator could reach was a
            # full repair) — the primary now receives the deep action
            # and runs the chunked byte-verifying scrub
            action = {"pg repair": "repair",
                      "pg deep-scrub": "deep-scrub"}.get(prefix, "scrub")
            from ceph_tpu_torch.osd import messages as om
            self.msgr.send_message(
                om.MPGCommand((pool_id, ps), 0, action), tuple(addr))
            return 0, {"instructed": f"osd.{primary}", "action": action}
        if prefix == "pg dump":
            # rich rows straight off the PGMap (primary-reported rows
            # win; replicas fill gaps — the ingest rule)
            rows = self.pgmap.pg_rows()
            return 0, {"num_pg_stats": len(rows), "pg_stats": rows}
        if prefix == "osd pool set":
            var, val = cmd["var"], int(cmd["val"])
            if var not in ("pg_num", "pgp_num", "size", "min_size"):
                return -22, {"error": f"cannot set {var!r}"}
            with self.lock:
                if self.osdmap is None:
                    return -2, {"error": "no osdmap"}
                name_or_id = cmd["pool"]
                by_name = {p.name: pid
                           for pid, p in self.osdmap.pools.items()}
                pid = by_name.get(name_or_id,
                                  int(name_or_id)
                                  if str(name_or_id).isdigit() else -1)
                pool = self.osdmap.pools.get(pid)
                if pool is None:
                    return -2, {"error": f"no pool {name_or_id!r}"}
                if var == "pg_num" and val < pool.pg_num:
                    return -22, {"error": "pg_num may only grow"}
                if var == "pgp_num" and val > pool.pg_num:
                    return -22, {"error": "pgp_num cannot exceed pg_num"}

                def mut(nm: OSDMap) -> None:
                    setattr(nm.pools[pid], var, val)

                self._mutate_map(mut)
            return 0, {"pool_id": pid, var: val}
        if prefix == "osd reweight":
            osd = int(cmd["id"])
            weight = float(cmd["weight"])
            with self.lock:
                self._mutate_map(
                    lambda nm: nm.reweight_osd(osd, int(weight * 0x10000)))
            return 0, {}
        for svc in self.services.values():
            got = svc.command(cmd)
            if got is not None:
                return got
        return -22, {"error": f"unknown command {prefix!r}"}

    def _cmd_pool_create(self, cmd: dict) -> Tuple[int, dict]:
        name = cmd["pool"]
        pg_num = int(cmd.get("pg_num",
                             self.ctx.conf.get("osd_pool_default_pg_num")))
        kind = cmd.get("pool_type", "replicated")
        box: Dict[str, object] = {}
        with self.lock:
            if self.osdmap is None:
                return -2, {"error": "no osdmap"}
            base = self._pending_map or self.osdmap
            for pid, p in base.pools.items():
                if p.name == name:
                    # reference behavior: creating an existing pool is
                    # SUCCESS (matters for re-runs over durable mon
                    # state: "pool already exists")
                    return 0, {"pool_id": pid, "existed": True}
            if kind == "erasure":
                profile_name = cmd.get("erasure_code_profile", "default")
                profile = self.ec_profiles.get(profile_name)
                if profile is None:
                    return -2, {"error": f"no profile {profile_name!r}"}
            else:
                profile = ""

            def mut(nm: OSDMap) -> None:
                pool_id = max(nm.pools, default=0) + 1
                referenced = {i for b in nm.crush.buckets.values()
                              for i in b.items if i < 0}
                roots = [bid for bid in nm.crush.buckets
                         if bid not in referenced]
                root = roots[0] if roots else max(nm.crush.buckets)
                if kind == "erasure":
                    kd = dict(part.split("=", 1)
                              for part in profile.split() if "=" in part)
                    size = int(kd.get("k", 2)) + int(kd.get("m", 1))
                    rule = nm.crush.add_simple_rule(
                        f"{name}_rule", root, 1, mode="indep")
                    pool = PGPool(pool_id, POOL_ERASURE, size=size,
                                  min_size=int(kd.get("k", 2)),
                                  pg_num=pg_num, pgp_num=pg_num,
                                  crush_rule=rule,
                                  erasure_code_profile=profile)
                else:
                    size = int(cmd.get(
                        "size", self.ctx.conf.get("osd_pool_default_size")))
                    rule = nm.crush.add_simple_rule(
                        f"{name}_rule", root, 1, mode="firstn")
                    pool = PGPool(pool_id, POOL_REPLICATED, size=size,
                                  min_size=max(1, size - size // 2),
                                  pg_num=pg_num, pgp_num=pg_num,
                                  crush_rule=rule)
                pool.name = name
                nm.pools[pool_id] = pool
                box["pool_id"] = pool_id

            self._mutate_map(mut)
        return 0, {"pool_id": box.get("pool_id")}

    # -- dispatch ---------------------------------------------------------
    def ms_dispatch(self, conn: Connection, msg: Message) -> bool:
        if isinstance(msg, mm.MMonElection):
            self._handle_election(conn, msg)
            return True
        if isinstance(msg, mm.MMonPaxos):
            self._handle_paxos(conn, msg)
            return True
        if isinstance(msg, mm.MMonCommand):
            self._handle_command(conn, msg)
            return True
        if isinstance(msg, mm.MMonSubscribe):
            return self._handle_subscribe(conn, msg)
        if isinstance(msg, mm.MOSDBoot):
            self._handle_boot(msg)
            return True
        if isinstance(msg, mm.MMDSBoot):
            # FSMap feed (reference MMDSBeacon -> MDSMonitor)
            with self.lock:
                if self.state == STATE_LEADER:
                    self.services["mdsmap"].handle_boot(
                        msg.rank, (msg.ip, msg.port),
                        getattr(msg, "boot_nonce", 0))
            return True
        if isinstance(msg, mm.MPGStats):
            with self.lock:
                self.pg_stats[msg.osd] = (time.time(), msg.pgs)
                self.osd_fullness[msg.osd] = (msg.used_bytes,
                                              msg.total_bytes)
            stats = msg.stats
            if not stats and msg.pgs:
                # legacy thin report (a pre-telemetry daemon): rows
                # synthesize with zeroed io/degraded fields so the
                # digest still counts its pg states
                from ceph_tpu_torch.osd.types import EVersion, PGStat

                stats = [PGStat(pgid=(p[0], p[1]), state=p[2],
                                primary=p[6], num_objects=p[3],
                                last_update=EVersion(p[4], p[5]))
                         for p in msg.pgs]
            self.pgmap.ingest(msg.osd, msg.epoch, stats,
                              msg.used_bytes, msg.total_bytes,
                              slow_ops=msg.slow_ops,
                              heartbeat_misses=msg.heartbeat_misses)
            return True
        if isinstance(msg, mm.MOSDFailure):
            self._handle_failure(msg)
            return True
        if isinstance(msg, mm.MAuth):
            self._handle_auth(conn, msg)
            return True
        return False

    def _handle_auth(self, conn: Connection, msg: mm.MAuth) -> None:
        from ceph_tpu_torch.auth import AuthError

        rep = mm.MAuthReply(result=-1)
        if self.auth_server is not None:
            try:
                if msg.op == mm.MAuth.GET_CHALLENGE:
                    rep = mm.MAuthReply(
                        result=0,
                        challenge=self.auth_server.get_challenge(msg.name))
                elif msg.op == mm.MAuth.REQUEST:
                    sealed, ticket = self.auth_server.handle_request(
                        msg.name, msg.client_challenge, msg.proof)
                    rep = mm.MAuthReply(result=0, sealed_client=sealed,
                                        ticket_blob=ticket)
            except AuthError as e:
                self._log(1, f"auth denied for {msg.name!r}: {e}")
                rep = mm.MAuthReply(result=-13)  # EACCES
        rep.tid = msg.tid
        conn.send(rep)

    def _handle_subscribe(self, conn: Connection,
                          msg: mm.MMonSubscribe) -> bool:
        # subscribers are identified by their LISTENING address, carried
        # in `what` as "osdmap:<ip>:<port>" (the accepted socket's
        # ephemeral port is useless for dialing back)
        parts = msg.what.split(":")
        if len(parts) == 3 and parts[0] == "osdmap":
            addr = (parts[1], int(parts[2]))
            with self.lock:
                self.subscribers[addr] = msg.since
            self._push_maps()
            return True
        return True
