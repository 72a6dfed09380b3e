"""PG — log-based per-placement-group consistency engine.

Reference: PG/PrimaryLogPG (src/osd/PG.{h,cc}, PrimaryLogPG.{h,cc}).
The shape kept here:

- op execution on the primary: decode guards -> opcode interpreter
  (do_osd_ops, PrimaryLogPG.cc:5651) -> full-object RMW state ->
  backend fan-out with the pg-log entry in the same transaction
  (prepare_transaction :8329 + issue_repop :10382)
- peering (a deliberately linearized RecoveryMachine, PG.h:1955): on
  activation the primary queries peer infos+logs, picks the
  authoritative log (highest last_update), pulls what it's missing,
  then pushes laggards forward; log-based catch-up when the peer's
  last_update is inside our log window, full backfill otherwise
- scrub (PG.cc:4839): primary gathers per-shard digests and compares;
  EC shards verify stored HashInfo crcs (ECBackend handle_sub_read)

Writes run through a pipelined per-object engine (the reference's
start_rmw/check_ops in-flight pipeline, ECBackend.cc:2098): each oid
has an admission FIFO — same-object writes stay strictly ordered, with
the successor's state read served from the predecessor's projected
(applied-not-yet-committed) state — while writes to different objects
in one PG overlap in flight; nothing blocks a workqueue shard waiting
for shard acks.  Reads execute on the primary.

Port of ``ceph_tpu/osd/pg.py``, all of it.  The names, the lockdep names, the
failpoints, and every message, transaction and omap row are the
reference's, byte for byte.  What the port does its own way:

- the backend is built from the pool's codec as the reference builds it,
  so a codec built with ``device="cpu"`` runs the plain versions and one
  built with no device runs on the card (and could not be built without
  one);
- ``OP_CALL`` runs the port's own ``ClassHandler`` (``osd/cls.py``) and
  ``scrub_engine()`` the port's ``ScrubEngine`` (``osd/scrub.py``);
- ``_do_write`` counts each all-``WRITEFULL`` payload it staged as a
  ``DeviceBuf``, and each one whose pool acquire timed out and took the
  reference's host-bytes path (``stage_snapshot()``).

The host (``self.osd``) is duck-typed: ``epoch``, ``store``, ``whoami``,
``ctx``, ``_log``, ``osdmap``, ``send_to_osd``, ``new_tid``,
``track_reads``, ``rpc``, ``collect_pg_infos``, ``pull_from_peer``,
``list_peer_objects``, ``fetch_remote_chunk_full``,
``collect_scrub_maps``, ``register_notify``/``unregister_notify``, and
``pg_perf``, ``op_perf`` and the scrub engine's ``scrub_perf``, ``qos``
and ``wq`` through ``getattr``.  The port's daemon
(``osd/daemon.py``, ``OSDService``) supplies all of it.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ceph_tpu_torch.core.crc import crc32c
from ceph_tpu_torch.core import failpoint as fp
from ceph_tpu_torch.core.lockdep import make_lock
from ceph_tpu_torch.core.encoding import DecodeError, Decoder, Encoder
from ceph_tpu_torch.osd import messages as m
from ceph_tpu_torch.osd import types as t_
from ceph_tpu_torch.osd.backend import (
    CRUSH_ITEM_NONE,
    ECRC,
    ECBackend,
    ObjectState,
    PGBackend,
    ReplicatedBackend,
    pg_meta_txn,
)
from ceph_tpu_torch.osd.pglog import PGLog
from ceph_tpu_torch.osd.recovery import (READ_RETRY, ChunkGather,
                                         ECRecoveryEngine)
from ceph_tpu_torch.gpu.staging import DeviceBuf, devpath_enabled
from ceph_tpu_torch.osd.types import EVersion, LogEntry, OSDOp, PGId, PGInfo
from ceph_tpu_torch.store.objectstore import (ChecksumError, Collection,
                                              GHObject, StoreError,
                                              Transaction)

EPERM, ENOENT, EIO, EAGAIN, EINVAL = -1, -2, -5, -11, -22
# READ_RETRY (defined in osd/recovery.py, re-exported here): EC reads
# that could not assemble k CURRENT chunks before the watchdog fired
# answer with that sentinel — "retry later", never "doesn't exist"
# (mixing a prior-interval chunk into a fresh decode produced garbage;
# claiming ENOENT lost reads of live objects)

# sentinel digest in merged scrub maps: the object exists on that osd
# but its store refused the read (at-rest corruption) — votes "exists"
# for repair auth selection, can never be authoritative (real crc32c
# digests are u32 >= 0, so -1 cannot collide)
SCRUB_UNREADABLE = -1
# "I'm not the primary" — a *retryable* mistargeting signal, distinct
# from EPERM op failures (e.g. exclusive create) the client must surface
ESTALE = -116

STATE_PEERING = "peering"
STATE_ACTIVE = "active"
STATE_DEGRADED = "active+degraded"

# a client write whose commit never arrives (a live-but-silent shard
# holder the map never resolves) answers retryable after this long —
# the async replacement for the old block-with-timeout (overridable
# via conf osd_client_write_timeout; tests shrink it)
WRITE_TIMEOUT_S = 30.0

# process-wide divergent-rollback event ring: the acked-durability
# oracle (tests/test_rados_model.py) joins a lost granule to the
# rollback that destroyed it, turning "m2: xattr x1" into a report
# naming the rewind.  Forensics-only — never read by the data path.
ROLLBACK_EVENTS: "collections.deque" = collections.deque(maxlen=256)


class _NoteGate:
    """Durable-ack gate of one DEGRADED EC commit: the client reply is
    held until every surviving acked co-holder has PERSISTED the
    committed_to watermark (MECCommitNote with tid -> MECCommitNoteAck).

    This is the 0xd403 fix: a degraded write used to ack the client
    the moment its k-wide commit landed, with the watermark broadcast
    fire-and-forget — so the primary dying inside that window left the
    acked entry's watermark nowhere durable, and the next whole-set
    arbitration counted < k holders and rewound an acknowledged write
    (xattr loss / byte divergence / missing object, always right after
    a `rolled back 1 divergent entries` line).  With the gate, a
    client that holds an ack implies a durable witness beyond the
    primary.

    Peers that die mid-gate are pruned: if a persisted witness already
    acked, the gate fires (durability holds); if none did, the gate
    drops SILENTLY — the deadline sweep answers EAGAIN and the resend
    re-runs the gate against the live set.  An ack without a witness
    is exactly the bug."""

    __slots__ = ("waiting", "got", "lus", "complete", "lock",
                 "expires")

    def __init__(self, waiting: set, complete: Callable[[], None],
                 expires: float = 0.0):
        self.waiting = set(waiting)
        self.got: set = set()
        self.lus: Dict[int, EVersion] = {}  # acker -> its log head
        self.complete = complete
        self.lock = make_lock("pg.note_gate")
        # monotonic expiry: a gated note lost to a LIVE peer (dropped
        # frame, wedged dispatch) would otherwise pin this gate — and
        # the client reply closure with its MOSDOp payload — forever;
        # the deadline sweep discards expired gates (the client got
        # its EAGAIN from the write deadline, the resend re-gates)
        self.expires = expires

    def ack(self, who: int, last_update: Optional[EVersion] = None
            ) -> None:
        with self.lock:
            if who not in self.waiting:
                return
            self.waiting.discard(who)
            self.got.add(who)
            if last_update is not None:
                self.lus[who] = last_update
            fire = not self.waiting
        if fire:
            self.complete()

    def holders_at(self, version: EVersion) -> int:
        """Ackers whose log head reaches `version` (pg logs are
        contiguous, so last_update >= v implies they hold the v
        entry) — the replay gate's k-durability evidence."""
        with self.lock:
            return sum(1 for lu in self.lus.values() if lu >= version)

    def prune_dead(self, alive: set) -> bool:
        """Remove peers not in `alive`; returns True when the gate
        should be discarded WITHOUT firing (no witness persisted)."""
        with self.lock:
            dead = {w for w in self.waiting if w not in alive}
            if not dead:
                return False
            self.waiting -= dead
            if self.waiting:
                return False
            fire = bool(self.got)
        if fire:
            self.complete()
            return False
        return True


class _OidPipe:
    """One object's write-admission FIFO (the obc ordering role): the
    head write owns the object until its transactions have fanned out
    (on_submitted); queued successors then read its projected state."""

    __slots__ = ("queue", "busy")

    def __init__(self) -> None:
        self.queue: "collections.deque" = collections.deque()
        self.busy = False


class PG:
    def __init__(self, pgid: PGId, pool, osd, codec=None) -> None:
        self.pgid = pgid
        self.pool = pool
        self.osd = osd  # duck-typed host daemon (whoami, send, store, log)
        self.coll = Collection(t_.pgid_str(pgid) + "_head")
        self.state = STATE_PEERING
        self.info = PGInfo(pgid=pgid, epoch_created=osd.epoch())
        self.log = PGLog()
        self.acting: List[int] = []
        self.prior_acting: List[int] = []  # past_intervals role
        self.primary: int = -1

        self.lock = make_lock(
            f"osd{osd.whoami}.pg{t_.pgid_str(pgid)}")
        # serializes operator scrub/repair (the reference's scrub
        # reservation role): acquired non-blocking by MPGCommand
        # cephlint: disable=named-locks — acquired on the dispatch
        # thread, released by the maintenance worker thread; the
        # RLock backing a DMutex forbids cross-thread release
        self.maintenance_guard = threading.Lock()
        self.missing: Dict[str, EVersion] = {}  # objects this osd lacks
        # map epoch at which the current interval began (the reference's
        # same_interval_since): replica-op messages from older epochs
        # are DROPPED, not applied
        self.interval_epoch = 0
        # async-activation plumbing (round-5 liveness fix): activation
        # runs on its own thread, never in the map-refresh caller, and
        # a request arriving while one is in flight queues ONE re-run
        self._activating = False
        self._activate_again = False
        self._peering_since = time.monotonic()
        self.peer_info: Dict[int, PGInfo] = {}
        # reqid -> committed version: completed-op replay so client
        # resends are exactly-once across primary failover (the
        # reference's pg log osd_reqid_t dedup)
        self._reqids: Dict[str, EVersion] = {}
        # watch/notify (reference src/osd/Watch.cc): oid -> cookie ->
        # the watcher's connection; notifies fan out over these and the
        # client's linger re-registers across failover
        self.watchers: Dict[str, Dict[int, object]] = {}
        # peers whose log is behind ours: their shards are stale and must
        # not serve reads until recovery pushes complete (the reference's
        # peer_missing discipline)
        self.stale_peers: set = set()
        # hit-set tracking (reference PrimaryLogPG hit_set_* over
        # src/osd/HitSet.h): enabled when the pool sets hit_set_count
        self.hit_set = None
        self.hit_set_start = 0.0
        from ceph_tpu_torch.osd.hitset import HitSetHistory

        self.hit_set_history = HitSetHistory(
            count=getattr(pool, "hit_set_count", 0) or 4)
        # object-context cache (reference object_contexts SharedLRU)
        from ceph_tpu_torch.core.lru import LRUCache

        self._obc = LRUCache(capacity=128)
        if codec is not None:
            self.backend: PGBackend = ECBackend(
                pgid, self.coll, osd.store, osd.whoami, osd.send_to_osd,
                osd.epoch, codec)
        else:
            self.backend = ReplicatedBackend(
                pgid, self.coll, osd.store, osd.whoami, osd.send_to_osd,
                osd.epoch)
        # roll-forward watermark rides EC sub-writes (divergent-entry
        # rollback must never rewind past an acked write)
        self.backend.committed_fn = lambda: self.info.committed_to
        # a deferred fan-out asks, under the lock _rollback_to holds,
        # whether its entry is still in the log (ROADMAP R7)
        self.backend.log_fence = self.lock
        self.backend.in_log = self._in_log
        self.backend.log = getattr(osd, "_log", self.backend.log)
        self.backend.perf = getattr(osd, "pg_perf", None)
        # osd.N.op stage histograms (per-peer fan-out RTT lands there)
        self.backend.op_perf = getattr(osd, "op_perf", None)
        # -- pipelined write engine state -----------------------------
        # per-object admission FIFOs + the in-flight bookkeeping that
        # replaced the old block-until-commit wait (leaf lock: taken
        # under the pg lock, never around it)
        self._pipe_lock = make_lock("pg.write_pipe")
        self._oid_pipes: Dict[str, _OidPipe] = {}
        # reqid -> expiry of writes submitted but not yet committed: a
        # client resend racing its own in-flight original never
        # re-executes (exactly-once); entries expire so a wedged
        # original can't livelock the resend forever
        self._inflight_reqids: Dict[str, float] = {}
        # reqid -> the resends of a marked write whose original has not
        # replied yet: each is answered with the original's result when
        # it replies (the reference's waiting_for_ondisk), never staged,
        # queued or answered EAGAIN meanwhile (F12)
        self._reqid_waiters: Dict[str, list] = {}
        # (deadline, replied-flag, fire) rows for in-flight client
        # writes, swept by the osd watchdog: a shard that never acks
        # becomes a retryable EAGAIN instead of silence; replied rows
        # are pruned each tick so committed writes don't pin payloads
        self._write_deadlines: List[
            Tuple[float, List[bool], Callable[[], None]]] = []
        # peering-watchdog backoff state (exponential per PG)
        self._wd_backoff = 0.0
        self._wd_next = 0.0
        # laggards a push left stale, by osd, with the info they
        # answered at activation: the watchdog pushes them forward again
        # (laggards_due) until every push lands or the interval moves
        self._laggard_retry: Dict[int, PGInfo] = {}
        self._lag_backoff = 0.0
        self._lag_next = 0.0
        # leaf lock for the roll-forward watermark CAS (commit
        # callbacks race it from shard-ack threads); _ct_dirty marks a
        # healthy-path watermark advance whose broadcast was absorbed
        # into the next sub-write's piggyback (flush_commit_note)
        self._ct_lock = make_lock("pg.committed_to")
        self._ct_dirty = False
        # durable-ack bookkeeping: _ct_covered is the newest version
        # whose watermark provably outlives this primary (full-width
        # commit, or a completed note gate); replays of reqids above
        # it re-run the gate before answering result=0.  _note_gates
        # holds the in-flight gates keyed by note tid.
        self._ct_covered = EVersion()
        self._note_gates: Dict[int, _NoteGate] = {}
        # windowed EC recovery engine (osd/recovery.py), created lazily
        # on the first pull/parked read
        self._recovery: Optional[ECRecoveryEngine] = None
        # per-PG cumulative io accounting (the PGStat telemetry feed):
        # client read/write ops+bytes from the reply path, recovered
        # objects+bytes from the recovery engine / push handler.  A
        # leaf lock of its own — reply closures and recovery commit
        # threads race it and must never wait behind the pg lock.
        self._iostat_lock = make_lock("pg.iostat")
        self._iostat = {"cl_wr_ops": 0, "cl_wr_bytes": 0,
                        "cl_rd_ops": 0, "cl_rd_bytes": 0,
                        "rec_ops": 0, "rec_bytes": 0}
        # all-WRITEFULL payloads staged as a DeviceBuf, and those whose
        # pool acquire timed out into the host-bytes path (same lock)
        self._stage = {"staged": 0, "degraded": 0}
        # objects recovery proved sourceless (every reachable holder
        # answered "no chunk" and no holder is unaccounted-for): the
        # PGStat unfound count.  Entries clear when a later round
        # recovers the object or a delete supersedes it.
        self.unfound: set = set()
        # scrub attribution (the PGStat v2 tail feeding PG_DAMAGED /
        # PG_NOT_DEEP_SCRUBBED): wall stamps of the last completed
        # scrub passes + the unrepaired inconsistency count of the
        # latest one.  Persisted in the pg meta by the ScrubEngine.
        self.last_scrub = 0.0
        self.last_deep_scrub = 0.0
        self.scrub_errors = 0
        self._scrub_engine = None
        # objects whose read-time verify failure is already counted
        # and queued for auto-repair (dedup: a hot object re-read
        # before the repair lands must not re-bump scrub_errors or
        # stack repair threads).  Guarded by self.lock.
        self._read_repair_pending: set = set()

    # -- identity ---------------------------------------------------------
    def is_primary(self) -> bool:
        # cephlint: disable=unguarded-shared-state — advisory
        # GIL-atomic snapshot: callers on the dispatch path use this
        # as a fast pre-check; a stale answer is re-judged under
        # pg.lock by peering/requeue before any state changes
        return self.primary == self.osd.whoami

    def is_ec(self) -> bool:
        return isinstance(self.backend, ECBackend)

    # -- telemetry accounting ---------------------------------------------
    def note_client_io(self, is_write: bool, nbytes: int) -> None:
        """Reply-path hook: one completed client op's size lands in
        the cumulative per-PG counters the PGStat report differences."""
        with self._iostat_lock:
            if is_write:
                self._iostat["cl_wr_ops"] += 1
                self._iostat["cl_wr_bytes"] += nbytes
            else:
                self._iostat["cl_rd_ops"] += 1
                self._iostat["cl_rd_bytes"] += nbytes

    def note_recovery_io(self, objects: int, nbytes: int) -> None:
        """Recovery landing hook (windowed engine commits, incoming
        pushes): feeds the digest's recovery objects/s and B/s."""
        with self._iostat_lock:
            self._iostat["rec_ops"] += objects
            self._iostat["rec_bytes"] += nbytes

    def iostat_snapshot(self) -> Dict[str, int]:
        with self._iostat_lock:
            return dict(self._iostat)

    def stage_snapshot(self) -> Dict[str, int]:
        """Writes staged as a ``DeviceBuf`` by ``_do_write``, and those
        degraded to host bytes by a timed-out pool acquire."""
        with self._iostat_lock:
            return dict(self._stage)

    # -- lifecycle --------------------------------------------------------
    def create_onstore(self) -> None:
        with self.lock:
            if not self.osd.store.collection_exists(self.coll):
                t = Transaction()
                t.create_collection(self.coll)
                self.osd.store.queue_transaction(t)
            self._persist_meta()

    def load_from_store(self) -> None:
        # boot load holds the pg lock: info/log/scrub stamps are
        # lock-guarded state everywhere else, and a heartbeat-driven
        # peering round can reach this PG before load completes
        with self.lock:
            self._load_from_store_locked()

    def _load_from_store_locked(self) -> None:
        g = GHObject("_pgmeta_")
        if self.osd.store.exists(self.coll, g):
            try:
                blob = self.osd.store.getattr(self.coll, g, "info")
                self.info = PGInfo.decode(Decoder(blob))
            except Exception as e:
                # a meta object without/with a torn info attr: peering
                # rebuilds it, but a decode regression must be seen
                self.osd._log(1, f"pg {self.pgid}: pgmeta info "
                                 f"unreadable: {e!r}")
            om = self.osd.store.omap_get(self.coll, g)
            self.log = PGLog.from_omap(om)
            if self.log.head > self.info.last_update:
                # data+log landed but info didn't: log wins (replay)
                self.info.last_update = self.log.head
            self._reindex_reqids()
            # scrub stamps/errors survive daemon restarts (the
            # PG_DAMAGED check must not clear because a daemon bounced)
            from ceph_tpu_torch.osd import scrub as _scrub

            blob = om.get(_scrub.STAMPS_KEY)
            if blob:
                try:
                    (self.last_scrub, self.last_deep_scrub,
                     self.scrub_errors) = _scrub.decode_stamps(blob)
                except DecodeError:
                    # torn stamp blob: the next scrub rewrites it
                    self.osd._log(1, f"pg {self.pgid}: scrub stamps "
                                     f"unreadable, resetting")

    def _persist_meta(self, extra_omap: Optional[Dict[str, bytes]] = None):
        e = Encoder()
        self.info.encode(e)
        txn = pg_meta_txn(self.coll, extra_omap or {}, e.bytes())
        self.osd.store.queue_transaction(txn)

    def update_acting(self, acting: Sequence[int], primary: int,
                      prior: Optional[Sequence[int]] = None) -> None:
        with self.lock:
            if (list(acting) != self.acting
                    or primary != self.primary):
                # interval change: this PG must re-peer before serving
                # ops again (the do_op peering gate keys off this).
                # interval_epoch gates replica ops: a sub-write minted
                # in an older interval (e.g. replayed by a lossless
                # session onto a revived/recycled peer) must NOT apply
                # over recovered data (reference: ops are discarded
                # when msg epoch < same_interval_since).  Known
                # approximation: this is the DETECTION epoch, which
                # can overshoot the true interval start when maps
                # arrive batched — a same-interval primary one epoch
                # behind then has its sub-write dropped and the client
                # retries after it catches up (bounded by map
                # propagation).  Deriving same_interval_since from map
                # history would remove the overshoot (round-5 item).
                self.state = STATE_PEERING
                self._peering_since = time.monotonic()
                self.interval_epoch = self.osd.epoch()
                # fresh interval, fresh watchdog fuse
                self._wd_backoff = 0.0
                self._wd_next = 0.0
            if prior is not None:
                # prior-interval holders (the past_intervals role): when
                # placement moves wholesale (pgp_num change, crush
                # edits), the data lives on these strays until peering
                # pulls it over
                self.prior_acting = [o for o in prior
                                     if o >= 0 and o != CRUSH_ITEM_NONE]
            elif list(acting) != self.acting and self.acting:
                self.prior_acting = [o for o in self.acting
                                     if o >= 0 and o != CRUSH_ITEM_NONE]
            self.acting = list(acting)
            self.primary = primary
        # recovery/peering may rewrite local objects outside the op
        # path: contexts cached in the old interval are suspect
        self._obc_invalidate()
        # in-flight writes waiting on OSDs the new interval dropped can
        # never be acked — re-resolve them against the live set
        alive = {o for o in acting if o >= 0 and o != CRUSH_ITEM_NONE}
        alive.add(self.osd.whoami)
        self.backend.on_peer_change(alive)
        # durable-ack gates waiting on dropped peers re-resolve too: a
        # gate with a persisted witness fires, one with none drops
        # silently (deadline EAGAIN; the resend re-runs the gate)
        self._sweep_note_gates(alive)

    def _sweep_note_gates(self, alive: set) -> None:
        with self._ct_lock:
            gates = list(self._note_gates.items())
        for tid, g in gates:
            if g.prune_dead(alive):
                with self._ct_lock:
                    self._note_gates.pop(tid, None)

    # -- op execution (primary) -------------------------------------------
    @staticmethod
    def _op_stage(msg, stage: str, detail: str = "") -> None:
        """Mark one pipeline stage on the op's timeline (TrackedOp —
        feeds the stage's osd.N.op latency histogram) and, when the op
        is traced, annotate its span.  Stage names are literals from
        tracing.STAGES (cephlint span-discipline enforces it)."""
        trop = getattr(msg, "trop", None)
        if trop is not None:
            # cephlint: disable=span-discipline — the forwarding
            # helper itself; callers pass registry literals and the
            # check validates THEM (the _op_stage arg rule)
            trop.mark_event(stage, detail)
        span = getattr(msg, "span", None)
        if span is not None:
            span.annotate(f"{stage} {detail}" if detail else stage)

    def do_op(self, msg: m.MOSDOp, reply: Callable[[m.MOSDOpReply], None],
              conn=None):
        tr = getattr(self.osd.ctx, "trace", None)
        if tr is not None and tr.enabled:
            # cross-daemon causality: prefer the client's wire context
            # (MOSDOp trace tail) so this span is a CHILD of the
            # client's root span; untraced clients fall back to the
            # reqid-derived correlator (blkin role: every daemon
            # touching the op derives the same trace id)
            from ceph_tpu_torch.core.tracing import trace_id_of

            parent = msg.trace_ctx() if hasattr(msg, "trace_ctx") else None
            if parent is None:
                reqid = getattr(msg, "reqid", "") or f"anon:{msg.tid}"
                parent = (trace_id_of(reqid), 0)
            span = tr.start_span(
                f"pg{t_.pgid_str(self.pgid)}.do_op", parent=parent)
            span.annotate(f"oid={msg.oid} ops={[o.op for o in msg.ops]}")
            # downstream stages annotate it, and the backend fan-out
            # inherits its context onto the peer messages
            msg.span = span
            trop = getattr(msg, "trop", None)
            if trop is not None:
                trop.trace_ctx = span.context()
            inner_reply = reply

            def reply(rep, _span=span, _inner=inner_reply):  # noqa: F811
                _span.annotate(f"reply result={rep.result}")
                _span.finish()
                _inner(rep)

        with self.lock:
            if not self.is_primary():
                rep = m.MOSDOpReply(self.pgid, self.osd.epoch(), msg.oid,
                                    msg.ops, result=ESTALE)
                reply(rep)
                return
            if self.state == STATE_PEERING:
                # the peering gate (reference: ops wait on the
                # RecoveryMachine reaching Active): a freshly-remapped
                # primary serving ops BEFORE converging on the
                # authoritative log returns stale reads/listings and
                # forks write history — answer retryable, the client
                # waits out activation (found by model-under-thrash)
                rep = m.MOSDOpReply(self.pgid, self.osd.epoch(), msg.oid,
                                    msg.ops, result=EAGAIN)
                reply(rep)
                return
            if len(msg.ops) == 1 and msg.ops[0].op == t_.OP_WATCH:
                self._do_watch(msg, reply, conn)
                return
        if len(msg.ops) == 1 and msg.ops[0].op == t_.OP_NOTIFY:
            self._do_notify(msg, reply)
            return
        if len(msg.ops) == 1 and msg.ops[0].op == t_.OP_SNAPTRIM:
            # snaptrim RMWs the head's SnapSet: it rides the same
            # per-object admission FIFO as pipelined client writes so
            # the two can never interleave on one object
            self._oid_admit(msg.oid,
                            lambda: self._snaptrim_job(msg, reply))
            return
        if len(msg.ops) == 1 and msg.ops[0].op == t_.OP_SNAPTRIMPG:
            self._do_snaptrim_pg(msg, reply)
            return
        with self.lock:
            writes = any(o.is_write() or self._call_is_write(o)
                         for o in msg.ops)
        # _do_write manages the lock itself: writes pipeline through
        # the per-object admission FIFO and never hold the lock (or
        # this workqueue shard) across their commit waits
        if writes:
            self._do_write(msg, reply)
        else:
            with self.lock:
                self._do_read(msg, reply)

    # -- watch/notify (reference src/osd/Watch.cc + the do_osd_ops
    # CEPH_OSD_OP_WATCH / NOTIFY handling) --------------------------------
    @staticmethod
    def _watcher_key(src, nonce, cookie: int) -> str:
        # watchers are identified by (entity incarnation, cookie) like
        # the reference's (entity_name, cookie) — client-chosen cookies
        # alone collide across clients
        return f"{src}.{nonce & 0xFFFFFFFF}:{cookie}"

    def _do_watch(self, msg, reply, conn) -> None:
        """Register/unregister a watcher (op.name: watch|unwatch,
        op.off: the client's cookie).  Called with self.lock held."""
        op = msg.ops[0]
        key = self._watcher_key(msg.src, msg.nonce, int(op.off))
        if op.name == "unwatch":
            self.watchers.get(msg.oid, {}).pop(key, None)
        else:
            if conn is None:
                reply(m.MOSDOpReply(self.pgid, self.osd.epoch(), msg.oid,
                                    msg.ops, result=EINVAL))
                return
            self.watchers.setdefault(msg.oid, {})[key] = (
                int(op.off), conn)
        reply(m.MOSDOpReply(self.pgid, self.osd.epoch(), msg.oid,
                            msg.ops, result=0))

    def _do_notify(self, msg, reply) -> None:
        """Fan the payload out to every watcher, gather acks until all
        answered or the timeout (op.length ms, default 5000) passes,
        reply with {watcher key: ack blob} (reference Notify/
        complete_watcher discipline).  The wait runs on its OWN thread:
        an unresponsive watcher must never pin a shard worker for the
        whole timeout (the reference's notifies are likewise async to
        the op pipeline)."""
        op = msg.ops[0]
        with self.lock:
            targets = list(self.watchers.get(msg.oid, {}).items())
        timeout = (op.length / 1000.0) if op.length else 5.0
        notify_id = self.osd.new_tid()
        ev = threading.Event()
        acks: Dict[str, bytes] = {}

        def on_ack(src, nonce, cookie: int, blob: bytes) -> None:
            acks[self._watcher_key(src, nonce, cookie)] = blob
            if len(acks) >= len(targets):
                ev.set()

        self.osd.register_notify(notify_id, on_ack)
        for key, (cookie, wconn) in targets:
            note = m.MWatchNotify(self.pgid, self.osd.epoch(),
                                  msg.oid, notify_id, cookie, op.data)
            try:
                wconn.send(note)
            except (ConnectionError, OSError, RuntimeError):
                pass  # dead watcher: the timeout covers it

        def finish() -> None:
            try:
                if targets:
                    ev.wait(timeout)
            finally:
                self.osd.unregister_notify(notify_id)
            op.out_kv = dict(acks)
            # watchers that never acked (reference timed-out watchers)
            missed = [key for key, _ in targets if key not in acks]
            op.out_data = (",".join(missed)).encode()
            reply(m.MOSDOpReply(self.pgid, self.osd.epoch(), msg.oid,
                                msg.ops, result=0))

        threading.Thread(target=finish, daemon=True,
                         name="notify-wait").start()

    def prune_watchers(self, conn) -> None:
        """Drop watchers whose session died (daemon ms_handle_reset)."""
        with self.lock:
            for oid in list(self.watchers):
                self.watchers[oid] = {
                    k: (c, w) for k, (c, w) in self.watchers[oid].items()
                    if w is not conn
                }
                if not self.watchers[oid]:
                    del self.watchers[oid]

    def _get_state(self, oid: str,
                   done: Callable[[Optional[ObjectState]], None]) -> None:
        """Fetch current full object state (degraded-aware for EC),
        served from the object-context cache when warm (the reference's
        object_contexts LRU, PrimaryLogPG::get_object_context):
        per-object write ordering publishes each write's projected
        state here BEFORE its successor is admitted, so the cached
        copy is read-your-writes even with commits still in flight."""
        # the copy happens INSIDE the lru lock; `done` runs without it
        # (it may execute ops and send replies — never under a mutex)
        # cephlint: disable=unguarded-shared-state — ObcCache is
        # internally locked; the generation tag below rejects stale
        # reinsertions, so no pg.lock is needed around cache traffic
        cached = self._obc.get(oid, copy=lambda s: ObjectState(
            s.data, dict(s.xattrs), dict(s.omap)))
        if cached is not None:
            done(cached)
            return
        # generation tag: an EC read completing on a network/timer
        # thread AFTER an invalidation must not reinsert stale state
        # cephlint: disable=unguarded-shared-state — see above
        gen = self._obc.generation()

        def fill(state: Optional[ObjectState]) -> None:
            # READ_RETRY is a sentinel, not a state: caching it crashed
            # the EC read-timeout timer thread (hunt find), wedging the
            # op — pass it through for the caller's retry logic only
            if state is not None and state is not READ_RETRY:
                self._obc_put(oid, state, gen=gen)
            done(state)

        if self.is_ec():
            self._ec_read_object(oid, fill)
        else:
            try:
                # cephlint: disable=unguarded-shared-state — acting is
                # swapped wholesale under pg.lock; this single
                # reference read targets a coherent (possibly stale)
                # set, and a stale read times out into client retry
                self.backend.read_object(oid, self.acting, fill)
            except ChecksumError:
                # the primary's own replica failed read verification:
                # never the flipped bytes, never a bare EIO — the
                # client retries (EAGAIN) while targeted repair pulls
                # the authoritative copy from a healthy replica
                self._note_read_verify_fail(
                    oid, [(0, self.osd.whoami)])
                fill(READ_RETRY)

    # -- object-context cache ---------------------------------------------
    def _obc_put(self, oid: str, state: Optional[ObjectState],
                 gen: Optional[int] = None) -> None:
        if state is None:
            self._obc.pop(oid)
            return
        self._obc.put(oid, ObjectState(state.data, dict(state.xattrs),
                                       dict(state.omap)), gen=gen)

    def _obc_invalidate(self, oid: Optional[str] = None) -> None:
        # ObcCache is internally locked and clear/pop bump its
        # generation, so racing fills from other lanes are rejected
        # on reinsert — no pg.lock needed around cache traffic
        if oid is None:
            self._obc.clear()  # cephlint: disable=unguarded-shared-state
        else:
            self._obc.pop(oid)  # cephlint: disable=unguarded-shared-state

    # -- hit-set tracking --------------------------------------------------
    def record_hit(self, oid: str) -> None:
        """Track one access in the current hit set; rotate on period or
        fullness (PrimaryLogPG::hit_set_create/persist roles).  Archived
        sets persist in the PG meta omap so the history survives
        restart."""
        count = getattr(self.pool, "hit_set_count", 0)
        if not count:
            return
        from ceph_tpu_torch.osd.hitset import BloomHitSet

        now = time.time()
        if self.hit_set is None:
            self.hit_set = BloomHitSet(
                target_size=getattr(self.pool, "hit_set_target_size", 1000),
                fpp=getattr(self.pool, "hit_set_fpp", 0.01))
            self.hit_set_start = now
        self.hit_set.insert(oid)
        period = getattr(self.pool, "hit_set_period", 0.0)
        if self.hit_set.is_full() or (period and
                                      now - self.hit_set_start >= period):
            self._rotate_hit_set(now)

    def _rotate_hit_set(self, now: float) -> None:
        self.hit_set_history.count = self.pool.hit_set_count
        self.hit_set_history.add(self.hit_set_start, now, self.hit_set)
        e = Encoder()
        self.hit_set.encode(e)
        key = f"hitset_{now:.6f}"
        self._persist_meta(extra_omap={key: e.bytes()})
        # trim aged archives beyond the kept ring in the same meta
        # object (reference hit_set_trim) so PG meta omap stays bounded
        # on hot pools
        g = GHObject("_pgmeta_")
        if self.osd.store.exists(self.coll, g):
            rows = sorted(k for k in self.osd.store.omap_get(self.coll, g)
                          if k.startswith("hitset_"))
            stale = rows[:-self.pool.hit_set_count] \
                if len(rows) > self.pool.hit_set_count else []
            if stale:
                t = Transaction()
                t.omap_rmkeys(self.coll, g, stale)
                self.osd.store.queue_transaction(t)
        self.hit_set = None

    def load_hit_set_history(self) -> None:
        """Rebuild the archive ring from PG meta omap (newest last)."""
        from ceph_tpu_torch.osd.hitset import decode_hitset

        g = GHObject("_pgmeta_")
        if not self.osd.store.exists(self.coll, g):
            return
        omap = self.osd.store.omap_get(self.coll, g)
        for k in sorted(k for k in omap if k.startswith("hitset_")):
            try:
                hs = decode_hitset(Decoder(omap[k]))
                stamp = float(k[len("hitset_"):])
                self.hit_set_history.add(stamp, stamp, hs)
            except Exception:
                continue

    def recovery_engine(self) -> ECRecoveryEngine:
        """This PG's windowed recovery engine (EC; lazily created)."""
        with self.lock:
            if self._recovery is None:
                self._recovery = ECRecoveryEngine(self)
            return self._recovery

    def scrub_engine(self):
        """This PG's chunked scrub engine (osd/scrub.py; lazily
        created — the recovery-engine shape)."""
        from ceph_tpu_torch.osd.scrub import ScrubEngine

        with self.lock:
            if self._scrub_engine is None:
                self._scrub_engine = ScrubEngine(self)
            return self._scrub_engine

    def note_peers_down(self, dead: set) -> None:
        """Map marked peers down: an in-flight recovery window must
        degrade to the survivors instead of waiting out its read
        timeout per object (the daemon calls this alongside failing
        RPC waiters)."""
        # cephlint: disable=unguarded-shared-state — GIL-atomic
        # reference snapshot, None-checked; an engine created after
        # the snapshot starts from the new map and needs no nudge
        eng = self._recovery
        if eng is not None:
            eng.peer_down(dead)

    def _park_missing_read(self, msg, reply) -> bool:
        """Recover-on-read (reference PrimaryLogPG::maybe_kick_recovery
        + the recovery-blocked op waitlist): a read of an object in
        pg.missing no longer EAGAINs blindly — the object is promoted
        to the FRONT of the recovery window and the read parks on its
        recovery completion (bounded wait, then EAGAIN exactly as
        before), so a hot object's read latency is one recovery round,
        not the whole pull.  Client-visible ordering is unchanged: the
        woken read re-executes the normal degraded-aware path."""
        if not self.is_ec() or not self.is_primary() \
                or self.state == STATE_PEERING:
            return False

        def wake(ok: bool, msg=msg, reply=reply) -> None:
            if not ok:
                reply(m.MOSDOpReply(self.pgid, self.osd.epoch(),
                                    msg.oid, msg.ops, result=EAGAIN))
                return
            perf = getattr(self.osd, "pg_perf", None)
            if perf is not None:
                perf.inc("recover_on_read_hits")
            with self.lock:
                self._do_read(msg, reply)

        parked = self.recovery_engine().park_read(msg.oid, wake)
        if parked:
            # timeline evidence for slow-op forensics: this read's
            # latency is a recovery promotion, not pipeline time
            self._op_stage(msg, "parked", f"oid={msg.oid}")
        return parked

    def _do_read(self, msg, reply):
        with self.lock:
            if msg.oid in self.missing:
                # known-newer object we haven't recovered yet: serving
                # local state would be STALE, "not found" would be a
                # lie.  An EC primary parks the read on a promoted
                # recovery of exactly this object; otherwise (or when
                # the object just left pg.missing under our feet)
                # retryable, the client waits out recovery
                if self._park_missing_read(msg, reply):
                    return
                reply(m.MOSDOpReply(self.pgid, self.osd.epoch(),
                                    msg.oid, msg.ops, result=EAGAIN))
                return
        if len(msg.ops) == 1 and msg.ops[0].op == t_.OP_PGLS:
            # PG-scoped listing (reference do_pg_op / CEPH_OSD_OP_PGLS):
            # head objects only, meta excluded.  Objects this (possibly
            # freshly-recovered) primary KNOWS about but has not pulled
            # yet (pg.missing) exist logically and must list — found by
            # the model-under-thrash hunt: listing only the local
            # collection made just-written objects vanish from ls while
            # recovery was still catching up.  Deletions the log says
            # happened but the local store hasn't applied are excluded.
            import json

            with self.lock:
                names = set(self.backend.object_names())
                for oid, _v in self.missing.items():
                    en = self.log.latest_for(oid)
                    if en is not None and en.op == t_.LOG_DELETE:
                        names.discard(oid)
                    else:
                        names.add(oid)
            names = sorted(names)
            msg.ops[0].out_data = json.dumps(names).encode()
            reply(m.MOSDOpReply(self.pgid, self.osd.epoch(), msg.oid,
                                msg.ops, result=0,
                                version=self.info.last_update))
            return
        self.record_hit(msg.oid)

        def finish(state: Optional[ObjectState]) -> None:
            if state is READ_RETRY:
                reply(m.MOSDOpReply(self.pgid, self.osd.epoch(),
                                    msg.oid, msg.ops, result=EAGAIN))
                return
            st = state
            if getattr(msg, "snapid", 0) and not self.is_ec():
                try:
                    st = self._resolve_snap(msg.oid, msg.snapid, state)
                except ChecksumError:
                    # a rotted snap clone: same no-flipped-bytes /
                    # no-bare-EIO rule as the head read
                    self._note_read_verify_fail(
                        msg.oid, [(0, self.osd.whoami)])
                    reply(m.MOSDOpReply(self.pgid, self.osd.epoch(),
                                        msg.oid, msg.ops,
                                        result=EAGAIN))
                    return
            if st is not None and st.xattrs.get("whiteout") == b"1":
                # whiteouts (deleted head / deleted-as-of-snap clone)
                # read as nonexistent
                st = None
            result = 0
            for op in msg.ops:
                result = self._exec_read_op(op, st)
                if result < 0:
                    break
            reply(m.MOSDOpReply(self.pgid, self.osd.epoch(), msg.oid,
                                msg.ops, result=result,
                                version=self.info.last_update))

        self._get_state(msg.oid, finish)

    # -- snapshots (reference SnapSet/SnapMapper, src/osd/SnapMapper.h,
    # osd_types.h SnapSet; clone-on-write in make_writeable) -------------
    def _snapset_of(self, state: Optional[ObjectState]) -> Dict:
        import json

        if state is not None and "snapset" in state.xattrs:
            try:
                return json.loads(state.xattrs["snapset"].decode())
            except (ValueError, UnicodeDecodeError):
                # unparsable snapset xattr == no snapset; scrub owns
                # flagging the corruption
                pass
        return {"seq": 0, "clones": []}

    def _resolve_snap(self, oid: str, snapid: int,
                      head: Optional[ObjectState]) -> Optional[ObjectState]:
        """Snap read resolution: the OLDEST clone with snap >= snapid
        holds the state as of `snapid`; no such clone means the object
        hasn't changed since — serve head (reference SnapSet clone
        lookup in PrimaryLogPG::find_object_context)."""
        ss = self._snapset_of(head)
        cands = sorted(c for c in ss.get("clones", []) if c >= snapid)
        if not cands:
            return head
        g = GHObject(oid, snap=cands[0])
        if not self.osd.store.exists(self.coll, g):
            return head
        return ObjectState(
            self.osd.store.read(self.coll, g),
            self.osd.store.getattrs(self.coll, g),
            self.osd.store.omap_get(self.coll, g),
        )

    def _do_snaptrim(self, msg, reply) -> None:
        """Drop one clone (op.off = snap id) and prune it from the
        head's SnapSet — the snap-trimmer role (reference
        PrimaryLogPG::trim_object), as an explicit per-object op."""
        import json

        snapid = int(msg.ops[0].off)
        state = self._read_state_sync(msg.oid, raw_retry=True)
        if state is READ_RETRY:
            reply(m.MOSDOpReply(self.pgid, self.osd.epoch(), msg.oid,
                                msg.ops, result=EAGAIN))
            return
        if state is None or self.is_ec():
            reply(m.MOSDOpReply(self.pgid, self.osd.epoch(), msg.oid,
                                msg.ops, result=ENOENT))
            return
        ss = self._snapset_of(state)
        cs = ss.setdefault("clone_snaps", {})
        # the clone covering `snapid`: a clone with no coverage entry is
        # legacy and covers exactly its own id
        clone = None
        for c in sorted(ss.get("clones", [])):
            snaps = cs.get(str(c), [c])
            if snapid in snaps:
                clone = c
                remaining = [s for s in snaps if s != snapid]
                break
        if clone is None:
            reply(m.MOSDOpReply(self.pgid, self.osd.epoch(), msg.oid,
                                msg.ops, result=ENOENT))
            return
        pre = Transaction()
        # the SnapMapper row for THIS snap goes regardless; the clone
        # itself only goes when no other live snap still needs it
        # (reference trim_object: clone removed when snaps empties)
        pre.omap_rmkeys(self.coll, GHObject("_pgmeta_"),
                        [self._snap_key(snapid, msg.oid)])
        if remaining:
            cs[str(clone)] = remaining
        else:
            ss["clones"] = [c for c in ss["clones"] if c != clone]
            cs.pop(str(clone), None)
            pre.try_remove(self.coll, GHObject(msg.oid, snap=clone))
        state.xattrs["snapset"] = json.dumps(ss).encode()
        committed = threading.Event()
        _replied = [False]
        _rlock = make_lock("pg.reply_once")

        def reply_once(rep) -> None:
            with _rlock:
                if _replied[0]:
                    return
                _replied[0] = True
            reply(rep)

        with self.lock:
            self._commit_write(msg, state, False, reply_once, committed,
                               pre_txn=pre)
        if not committed.wait(timeout=30.0):
            # same retryable discipline as stalled writes
            reply_once(m.MOSDOpReply(self.pgid, self.osd.epoch(),
                                     msg.oid, msg.ops, result=EAGAIN))

    def _snaptrim_job(self, msg, reply,
                      done: Optional[threading.Event] = None) -> None:
        """Admission-FIFO wrapper for one snaptrim: unlike client
        writes it holds the object until its commit wait resolves
        (_do_snaptrim blocks internally) — trim correctness beats
        pipelining here."""
        try:
            self._do_snaptrim(msg, reply)
        finally:
            if done is not None:
                done.set()
            self._oid_release(msg.oid)

    def _do_snaptrim_pg(self, msg, reply) -> None:
        """Trim clones of one snap in this PG, fed by the SnapMapper
        index (the reference snap-trimmer work queue:
        PrimaryLogPG::AwaitAsyncWork over get_next_objects_to_trim).

        CHUNKED: at most op.length objects per call (the caller loops
        on `remaining`) so one op never monopolizes the PG's queue
        shard for minutes.  Always replies result=0 with the counts in
        the payload — EAGAIN here would make the objecter silently
        retry the whole sweep.  Dangling index rows (object gone, snap
        not in its set) are dropped, not failed (reference SnapMapper
        tolerates stale mappings)."""
        import json
        from types import SimpleNamespace

        snapid = int(msg.ops[0].off)
        batch = int(msg.ops[0].length) or 16
        oids = self.snap_objects(snapid)
        trimmed, failed, stale = 0, 0, 0
        # snaptrim is a QoS tenant: each trimmed object charges the
        # snaptrim class's token bucket and the sweep paces itself to
        # the class limit (bounded per object, so the shard is never
        # held longer than batch x the cap)
        qos = getattr(self.osd, "qos", None)
        pacer = threading.Event()
        for oid in oids[:batch]:
            if qos is not None:
                pause = min(0.1, qos.background_pause("snaptrim"))
                if pause > 0:
                    pacer.wait(pause)
            shim = SimpleNamespace(
                oid=oid, ops=[OSDOp(t_.OP_SNAPTRIM, off=snapid)],
                reqid=f"{getattr(msg, 'reqid', 'snaptrim')}/{oid}",
                snap_seq=0, snaps=[], snapid=0)
            box: List = []
            ev = threading.Event()
            # admission-ordered against pipelined client writes; the
            # job may defer behind an in-flight write, so wait for it
            self._oid_admit(oid, lambda s=shim: self._snaptrim_job(
                s, box.append, done=ev))
            ev.wait(timeout=2 * WRITE_TIMEOUT_S)
            rc = box[0].result if box else EAGAIN
            if rc == 0:
                trimmed += 1
            elif rc == ENOENT:
                # dangling mapping: drop the row so it can't poison
                # every future sweep (local drop; a failed-over primary
                # converges the same way on its next sweep)
                t = Transaction()
                t.omap_rmkeys(self.coll, GHObject("_pgmeta_"),
                              [self._snap_key(snapid, oid)])
                try:
                    self.osd.store.queue_transaction(t)
                except Exception as e:
                    self.osd._log(1, f"pg {self.pgid}: dangling snap "
                                     f"row drop failed: {e!r}")
                stale += 1
            else:
                failed += 1
        done_now = trimmed + failed + stale
        msg.ops[0].out_data = json.dumps(
            {"trimmed": trimmed, "failed": failed,
             "stale_dropped": stale,
             "remaining": max(0, len(oids) - done_now)}).encode()
        reply(m.MOSDOpReply(self.pgid, self.osd.epoch(), msg.oid,
                            msg.ops, result=0,
                            version=self.info.last_update))

    def _snap_pre_txn(self, msg, state: Optional[ObjectState],
                      work: ObjectState):
        """Clone-on-write: first write after a new snap clones the head
        BEFORE mutating it, in the same transaction (the reference's
        make_writeable clone step)."""
        snap_seq = getattr(msg, "snap_seq", 0)
        if not snap_seq or state is None or self.is_ec():
            return None
        ss = self._snapset_of(state)
        if ss["seq"] >= snap_seq:
            return None
        pre = Transaction()
        pre.clone(self.coll, GHObject(msg.oid),
                  GHObject(msg.oid, snap=snap_seq))
        # the ONE clone covers every live snap newer than the previous
        # seq (reference SnapSet::clone_snaps): trimming any one of
        # them must not destroy the clone while others still need it
        covered = sorted({s for s in [snap_seq, *getattr(msg, "snaps", [])]
                          if s > ss["seq"]})
        # SnapMapper index (reference src/osd/SnapMapper.h:101 — the
        # snap -> objects omap rows the trimmer walks): same txn as the
        # clone, so index and clone can never diverge; one row per
        # covered snap
        pre.touch(self.coll, GHObject("_pgmeta_"))
        pre.omap_setkeys(self.coll, GHObject("_pgmeta_"),
                         {self._snap_key(s, msg.oid): b"1"
                          for s in covered})
        ss["clones"] = sorted(set(ss["clones"]) | {snap_seq})
        ss.setdefault("clone_snaps", {})[str(snap_seq)] = covered
        ss["seq"] = snap_seq
        import json

        work.xattrs["snapset"] = json.dumps(ss).encode()
        return pre

    # -- SnapMapper (snap -> objects index) --------------------------------
    @staticmethod
    def _snap_key(snapid: int, oid: str) -> str:
        return f"snap_{snapid:016x}/{oid}"

    def snap_objects(self, snapid: int) -> List[str]:
        """Objects holding a clone of `snapid` (SnapMapper get_next_
        objects_to_trim role)."""
        g = GHObject("_pgmeta_")
        if not self.osd.store.exists(self.coll, g):
            return []
        pre = f"snap_{snapid:016x}/"
        omap = self.osd.store.omap_get(self.coll, g)
        return sorted(k[len(pre):] for k in omap if k.startswith(pre))

    # -- cls object classes (reference ClassHandler / do_osd_ops
    # CEPH_OSD_OP_CALL, PrimaryLogPG.cc:5651) --------------------------
    @staticmethod
    def _call_is_write(op: OSDOp) -> bool:
        if op.op != t_.OP_CALL:
            return False
        from ceph_tpu_torch.osd.cls import ClassHandler

        return ClassHandler.instance().is_write(op.name)

    def _exec_call(self, op: OSDOp, state, exists: bool,
                   writable: bool) -> Tuple[int, bool]:
        from ceph_tpu_torch.osd.cls import ClassHandler, ClsError, MethodContext

        got = ClassHandler.instance().get(op.name)
        if got is None:
            op.rval = EINVAL
            return EINVAL, False
        flags, fn = got
        if isinstance(state.data, DeviceBuf):
            # cls methods treat data as plain bytes: sanctioned
            # pull-back, counted (never on the WRITEFULL happy path)
            state.data = state.data.tobytes()
        ctx = MethodContext(state, exists, writable)
        try:
            op.out_data = fn(ctx, op.data) or b""
        except ClsError as e:
            op.rval = e.errno
            return e.errno, False
        except Exception:
            # a buggy method (bad input types, etc.) must FAIL the op,
            # not escape into the PG worker and leave the client
            # waiting forever (reference: unexpected cls failures come
            # back as -EIO, they never kill the op)
            op.rval = -5  # EIO
            return -5, False
        return 0, ctx.delete_object

    def _exec_read_op(self, op: OSDOp, state: Optional[ObjectState]) -> int:
        if op.op == t_.OP_CALL:
            exists = state is not None
            rc, _ = self._exec_call(op, state or ObjectState(), exists,
                                    writable=False)
            return rc
        if state is None:
            if op.op in (t_.OP_STAT, t_.OP_READ, t_.OP_GETXATTR,
                         t_.OP_GETXATTRS, t_.OP_OMAP_GET):
                op.rval = ENOENT
                return ENOENT
            return EINVAL
        if op.op == t_.OP_READ:
            end = op.off + (op.length or len(state.data))
            op.out_data = state.data[op.off:end]
        elif op.op == t_.OP_STAT:
            e = Encoder()
            e.u64(len(state.data))
            op.out_data = e.bytes()
        elif op.op == t_.OP_GETXATTR:
            if op.name not in state.xattrs:
                op.rval = ENOENT
                return ENOENT
            op.out_data = state.xattrs[op.name]
        elif op.op == t_.OP_GETXATTRS:
            op.out_kv = dict(state.xattrs)
        elif op.op == t_.OP_OMAP_GET:
            if op.keys:
                op.out_kv = {k: state.omap[k] for k in op.keys
                             if k in state.omap}
            else:
                op.out_kv = dict(state.omap)
        else:
            op.rval = EINVAL
            return EINVAL
        return 0

    # -- pipelined write admission (per-object ordering) -------------------
    def _oid_admit(self, oid: str, job: Callable[[], None]) -> None:
        """Admit a write job into `oid`'s FIFO: runs now when the
        object is idle, else queues behind the in-flight head.  Jobs
        must call _oid_release(oid) exactly once, when their submit
        phase (state read -> exec -> fan-out queued) has finished —
        NOT at commit: that is what lets same-object writes pipeline
        while staying strictly ordered."""
        with self._pipe_lock:
            pipe = self._oid_pipes.get(oid)
            if pipe is None:
                pipe = self._oid_pipes[oid] = _OidPipe()
            if pipe.busy:
                pipe.queue.append(job)
                return
            pipe.busy = True
        job()

    def _oid_release(self, oid: str) -> None:
        """Head write's submit phase done: admit the successor.  It
        runs on a fresh thread — release can fire under the pg lock
        (synchronous replicated fan-out) or on the fan-out lane (async
        EC encode), and the successor both takes the pg lock and may
        BLOCK for seconds on a remote state read (obc miss), so it
        must not ride a shared single-worker lane where it would
        head-of-line-block every other write's fan-out.  The spawn
        (~0.1 ms) only happens when same-object writes actually
        overlap."""
        with self._pipe_lock:
            pipe = self._oid_pipes.get(oid)
            if pipe is None:
                return
            if not pipe.queue:
                pipe.busy = False
                del self._oid_pipes[oid]  # holds only active oids
                return
            job = pipe.queue.popleft()
        threading.Thread(target=job, daemon=True,
                         name="pg-write-pipe").start()

    def _write_timeout_s(self) -> float:
        try:
            return float(self.osd.ctx.conf.get("osd_client_write_timeout"))
        except Exception:
            return WRITE_TIMEOUT_S  # bare-stub osds in unit tests

    def _arm_write_deadline(self, replied: List[bool],
                            fire: Callable[[], None],
                            timeout: Optional[float] = None) -> None:
        """`replied` is the write's reply-once flag: the sweep drops
        rows whose reply already went out (commit or error), so a
        committed write's closure — which pins the whole MOSDOp and
        its payload — lives ~one watchdog tick, not the full 30 s."""
        if timeout is None:
            timeout = self._write_timeout_s()
        with self._pipe_lock:
            self._write_deadlines.append((time.monotonic() + timeout,
                                          replied, fire))

    def sweep_write_timeouts(self) -> None:
        """Answer retryably for in-flight writes whose commit never
        came (a shard never acked and no map change resolved it) —
        called periodically by the osd watchdog loop.  Also prunes
        rows already replied (committed) and expired in-flight reqid
        marks."""
        now = time.monotonic()
        # expired durable-ack gates go too: a gated note lost to a
        # live peer never resolves, and the gate must not pin its
        # client-reply closure past the write deadline (the client
        # already got EAGAIN; its resend re-gates)
        with self._ct_lock:
            stale_gates = [t for t, g in self._note_gates.items()
                           if g.expires and g.expires <= now]
            for t in stale_gates:
                del self._note_gates[t]
        due: List[Callable[[], None]] = []
        with self._pipe_lock:
            if not self._write_deadlines and not self._inflight_reqids:
                return
            keep = []
            for row in self._write_deadlines:
                if row[1][0]:
                    continue  # replied (committed/errored): drop
                (due if row[0] <= now else keep).append(row)
            self._write_deadlines = keep
            stale = [r for r, t in self._inflight_reqids.items()
                     if t <= now]
            for r in stale:
                del self._inflight_reqids[r]
        for row in due:
            row[2]()
        for r in stale:
            self._release_waiters(r)

    def _note_inflight(self, delta: int) -> None:
        note = getattr(self.osd, "note_write_inflight", None)
        if note is not None:
            note(delta)

    def _replay_reply(self, msg, reply, done_v: EVersion) -> None:
        """Answer a resend of an already-committed write.  result=0 IS
        an ack: if this version's durable-ack coverage never completed
        (the original degraded commit EAGAINed at the gate, or this is
        a freshly-failed-over primary), the replay must re-run the
        watermark gate against the live acting peers first — answering
        from the log alone would re-open the 0xd403 window through the
        resend door."""
        def fire() -> None:
            reply(m.MOSDOpReply(self.pgid, self.osd.epoch(), msg.oid,
                                msg.ops, result=0, version=done_v))

        with self._ct_lock:
            covered = done_v <= self._ct_covered
        if covered or not self.is_ec() or self.primary != self.osd.whoami:
            fire()
            return
        omap_ = self.osd.osdmap
        n = self.backend.k + self.backend.m
        peers = sorted({o for o in self.acting[:n]
                        if o >= 0 and o != CRUSH_ITEM_NONE
                        and o != self.osd.whoami
                        and (omap_ is None or omap_.is_up(o))})
        if not peers:
            fire()
            return
        replied = [False]
        rlock = make_lock("pg.reply_once")

        def fire_once() -> None:
            with rlock:
                if replied[0]:
                    return
                replied[0] = True
            fire()

        def timeout_eagain() -> None:
            with rlock:
                if replied[0]:
                    return
                replied[0] = True
            reply(m.MOSDOpReply(self.pgid, self.osd.epoch(), msg.oid,
                                msg.ops, result=EAGAIN))

        self._gate_on_notes(done_v, peers, fire_once,
                            need_holders_at=done_v)
        self._arm_write_deadline(replied, timeout_eagain)

    def _do_write(self, msg, reply):
        self.record_hit(msg.oid)
        # completed-op replay fast path: a resend of an already-
        # committed write answers from the log without queueing (the
        # authoritative re-check runs again after admission)
        reqid = getattr(msg, "reqid", "")
        if reqid:
            with self._pipe_lock:
                done_v = self._reqids.get(reqid)
                waiting = self._wait_on_original(reqid, done_v, msg, reply)
            if done_v is not None:
                self._replay_reply(msg, reply, done_v)
                return
            if waiting:
                self._op_stage(msg, "waiting_for_original")
                return
        # device-resident small-object path: an all-WRITEFULL payload
        # is staged ONCE into the pinned pool owned by the stripe
        # batch queue (the messenger decoded it as a zero-copy frame
        # view); from here through encode/crc to store apply it flows
        # as a DeviceBuf handle and only metadata crosses back to
        # host.  Pool exhaustion BLOCKS here (workqueue thread, never
        # the messenger loop) — backpressure, not drops; a timed-out
        # acquire degrades to the host path.
        if (self.is_ec() and msg.ops
                and all(o.op == t_.OP_WRITEFULL for o in msg.ops)
                and devpath_enabled(self.osd.ctx.conf)):
            last = msg.ops[-1]  # earlier WRITEFULLs are dead stores
            if (not isinstance(last.data, DeviceBuf) and last.data is not None
                    and len(last.data)):
                staged = DeviceBuf.stage(self.backend.queue.pool, last.data)
                with self._iostat_lock:
                    self._stage["degraded" if staged is None
                                else "staged"] += 1
                if staged is not None:
                    last.data = staged
                    # pool-acquire wait is the stage's latency (delta
                    # since the previous timeline event)
                    self._op_stage(msg, "staged", f"{len(staged)}B")
        # per-object admission (pipelined write engine): same-object
        # writes stay strictly ordered — the successor runs only after
        # the predecessor's transactions fanned out, so its state read
        # sees the projected (applied-not-yet-committed) state — while
        # writes to different objects proceed concurrently.  Nothing
        # blocks this workqueue shard waiting for shard acks anymore.
        self._oid_admit(msg.oid, lambda: self._execute_write(msg, reply))

    def _wait_on_original(self, reqid: str, done_v, msg, reply) -> bool:
        """Under ``_pipe_lock``: park a resend of a write whose original
        is marked here and has not replied yet; True when parked."""
        if done_v is not None or reqid not in self._inflight_reqids:
            return False
        waiters = self._reqid_waiters.get(reqid)
        if waiters is None:
            return False
        waiters.append((msg, reply))
        return True

    def _answering_waiters(self, reqid: str, reply):
        """The original's ``reply``, which also answers each resend
        parked on it with the same result and version."""
        def answer(rep) -> None:
            try:
                reply(rep)
            finally:
                with self._pipe_lock:
                    waiters = self._reqid_waiters.pop(reqid, [])
                for wmsg, wreply in waiters:
                    wreply(m.MOSDOpReply(self.pgid, rep.epoch, wmsg.oid,
                                         wmsg.ops, result=rep.result,
                                         version=rep.version))
        return answer

    def _release_waiters(self, reqid: str) -> None:
        """Answer EAGAIN to the resends parked on an original that left
        without replying (an early bail that raised, an expired mark):
        the client's retry runs the write again."""
        with self._pipe_lock:
            if reqid in self._inflight_reqids:
                return  # marked again meanwhile: its reply answers them
            waiters = self._reqid_waiters.pop(reqid, [])
        for wmsg, wreply in waiters:
            wreply(m.MOSDOpReply(self.pgid, self.osd.epoch(), wmsg.oid,
                                 wmsg.ops, result=EAGAIN))

    def _execute_write(self, msg, reply):
        """Head of `msg.oid`'s admission FIFO: state read -> op exec ->
        submit.  Releases the FIFO when the backend reports the fan-out
        queued (on_submitted) or on any early-bail reply; the commit
        callback replies to the client later, off this thread."""
        released = [False]
        # head of the admission FIFO: the delta since the previous
        # timeline event is the _OidPipe queue wait
        self._op_stage(msg, "admitted")

        def release(submitted_ok: bool = True) -> None:
            if released[0]:
                return
            released[0] = True
            if submitted_ok:
                # fan-out queued (state read + exec + encode handed
                # off): the admission FIFO opens for the successor
                self._op_stage(msg, "submitted")
            self._oid_release(msg.oid)

        reqid = getattr(msg, "reqid", "")
        req_marked = False
        submitted = False
        try:
            with self.lock:
                # admission may long postdate do_op's gate (queued
                # behind an in-flight head): re-check so a queued
                # write never executes against a stale interval —
                # both answers are retryable, semantics unchanged
                if not self.is_primary():
                    reply(m.MOSDOpReply(self.pgid, self.osd.epoch(),
                                        msg.oid, msg.ops, result=ESTALE))
                    return
                if self.state == STATE_PEERING:
                    reply(m.MOSDOpReply(self.pgid, self.osd.epoch(),
                                        msg.oid, msg.ops, result=EAGAIN))
                    return
            if reqid:
                # replay check, in-flight dup check, and the mark are
                # ONE atomic step against on_commit's register+unmark
                # (reading them under different locks left a window —
                # original commits between the two reads — where a
                # resend re-executed and an append landed twice)
                with self._pipe_lock:
                    done_v = self._reqids.get(reqid)
                    dup = (done_v is None
                           and reqid in self._inflight_reqids)
                    waiting = self._wait_on_original(reqid, done_v, msg,
                                                     reply)
                    if done_v is None and not dup:
                        self._inflight_reqids[reqid] = (
                            time.monotonic()
                            + 2 * self._write_timeout_s())
                        self._reqid_waiters.setdefault(reqid, [])
                        req_marked = True
                if done_v is not None:
                    self._replay_reply(msg, reply, done_v)
                    return
                if waiting:
                    # resend racing its own in-flight original: never
                    # re-execute (exactly-once); the original's reply
                    # answers it
                    return
                if dup:
                    # the original already answered (EAGAIN at its
                    # deadline) and its mark holds until it expires
                    reply(m.MOSDOpReply(self.pgid, self.osd.epoch(),
                                        msg.oid, msg.ops, result=EAGAIN))
                    return
                reply = self._answering_waiters(reqid, reply)
            # partial-stripe EC overwrite fast path: a single ranged
            # write inside the object moves only the touched stripes
            # (reference start_rmw, ECBackend.cc:1791) instead of
            # re-encoding the whole object
            if (self.is_ec() and len(msg.ops) == 1
                    and msg.ops[0].op == t_.OP_WRITE and msg.ops[0].data
                    and self._try_partial_write(msg, reply,
                                                on_submitted=release)):
                submitted = True
                return
            submitted = self._execute_full_write(msg, reply, release)
        finally:
            if not submitted:
                if req_marked:
                    with self._pipe_lock:
                        self._inflight_reqids.pop(reqid, None)
                    self._release_waiters(reqid)
                # early bail (ESTALE/EAGAIN/op error): the staged
                # payload never reached the backend — return its slot
                # without seal()'s defensive copy (nothing reads it)
                for o in msg.ops:
                    if isinstance(o.data, DeviceBuf):
                        o.data.discard()
                release(submitted_ok=False)  # early bail: no fan-out

    def _writefull_fast_state(self, oid: str):
        """Local-only RMW base for all-WRITEFULL ops on a clean PG:
        the data is replaced wholesale, so only existence + xattrs +
        omap matter — and the primary's OWN copy answers those without
        the read phase (EC: no sub-read round, no decode — every shard
        object carries the full xattrs/omap; replicated: no 64KiB data
        read of bytes about to be discarded).  The reference's
        full-object writes likewise skip the read side of the RMW.
        Returns a 1-tuple (state-or-None) when the local answer is
        authoritative, else None (degraded/stale-local: take the
        degraded-aware read path).  Ordering: runs as the head of the
        oid's admission FIFO, so the projected-state cache is checked
        first like any other state read."""
        from ceph_tpu_torch.osd.backend import _av_stamp

        cached = self._obc.get(oid, copy=lambda s: ObjectState(
            s.data, dict(s.xattrs), dict(s.omap)))
        if cached is not None:
            return (cached,)
        with self.lock:
            if self.state != STATE_ACTIVE or oid in self.missing:
                return None  # degraded: testimony may live elsewhere
            en = self.log.latest_for(oid)
            acting = list(self.acting)
        if en is not None and en.op == t_.LOG_DELETE:
            return (None,)  # the log's newest word: deleted
        if not self.is_ec():
            g = GHObject(oid)
            if not self.osd.store.exists(self.coll, g):
                return (None,) if en is None else None
            return (ObjectState(
                b"", dict(self.osd.store.getattrs(self.coll, g)),
                dict(self.osd.store.omap_get(self.coll, g))),)
        shards = self.backend.local_shards(acting)
        if not shards:
            return None
        attrs, omap = self.backend.shard_meta(oid, shards[0])
        if not attrs and not omap:
            if en is not None:
                # log says live but our shard is gone: let the
                # degraded-aware read path arbitrate
                return None
            return (None,)  # clean PG, no shard, no entry: absent
        if en is not None and attrs.get("_av") != _av_stamp(en.version):
            return None  # stale local shard (e.g. mid-recovery)
        xa = {k: v for k, v in attrs.items()
              if k not in ("hinfo", "_av")}
        # data is a placeholder: every op in the message replaces it
        return (ObjectState(b"", xa, dict(omap)),)

    def _execute_full_write(self, msg, reply, on_submitted) -> bool:
        """The RMW body: returns True once the write was handed to the
        backend (on_submitted then owns the FIFO release)."""
        # the state read is ordered by admission, not by blocking: the
        # predecessor's projected state is already in the object-
        # context cache, so same-object writes never read the same base
        fast = None
        if (msg.ops
                and all(op.op == t_.OP_WRITEFULL for op in msg.ops)):
            fast = self._writefull_fast_state(msg.oid)
        if fast is not None:
            state = fast[0]
        else:
            state = self._read_state_sync(msg.oid, raw_retry=True)
        supersede = False
        if state is READ_RETRY:
            if (self.is_ec() and msg.ops
                    and all(op.op == t_.OP_WRITEFULL for op in msg.ops)):
                # the current generation is unreconstructable (fresh
                # shards behind down/stale holders) but every op here
                # REPLACES the object wholesale — prior bytes are
                # irrelevant.  EAGAIN would wedge the client until the
                # dead holder returns (the sweep-seed starvation):
                # proceed from absent instead.  The commit mints a
                # NEWER generation on the live shards and the _av
                # stamp fences the old chunks when their holder
                # revives.  Ops that read-modify or need existence
                # (ranged write, delete) still wait out recovery.
                state, supersede = None, True
                # WRITEFULL replaces DATA but keeps xattrs/omap —
                # forking from fully-absent silently wiped them
                # (model-thrash omap-loss find).  Carry the meta with
                # the freshest _av stamp among LOCAL shards AND the
                # reachable acting holders: an acked setxattr/omap may
                # live only on a peer's shard (this primary took over
                # mid-churn, or a rollback stripped its local copy),
                # and superseding from local-only testimony laundered
                # PRE-ACK meta forward under a fresh stamp — the
                # second 0xd403 loss mechanic.
                best = self._supersede_meta(msg.oid)
                if best is not None:
                    xa = {k: v for k, v in best[0].items()
                          if k not in ("hinfo", "_av")}
                    state = ObjectState(b"", xa, best[1])
            else:
                # ambiguous base state (shards unreachable mid-churn):
                # a write built on "absent" would fork history —
                # retryable
                reply(m.MOSDOpReply(self.pgid, self.osd.epoch(),
                                    msg.oid, msg.ops, result=EAGAIN))
                return False
        # exactly one reply per op, whether commit or timeout wins
        _replied = [False]
        _rlock = make_lock("pg.reply_once")

        def reply_once(rep) -> None:
            with _rlock:
                if _replied[0]:
                    return
                _replied[0] = True
            reply(rep)

        whiteout = (state is not None
                    and state.xattrs.get("whiteout") == b"1")
        with self.lock:
            # a whiteout head is logically ABSENT for client ops but its
            # SnapSet must flow into any recreated head (clone-seq
            # protection: a stale snap_seq must never re-clone over a
            # preserved snapshot)
            exists = state is not None and not whiteout
            work = state if exists else ObjectState()
            if whiteout and "snapset" in state.xattrs:
                work.xattrs["snapset"] = state.xattrs["snapset"]
            delete = False
            result = 0
            for op in msg.ops:
                if op.is_write() or self._call_is_write(op):
                    result, delete2 = self._exec_write_op(op, work, exists)
                    if result == 0:
                        if delete2:
                            # deletion is CURRENT state, not sticky: a
                            # later op in the same message may recreate
                            # the object from scratch
                            delete = True
                            exists = False
                            work = ObjectState()
                        else:
                            exists = True
                            delete = False
                else:
                    result = self._exec_read_op(
                        op, None if not exists else work)
                if result < 0:
                    break
            if result < 0:
                reply_once(m.MOSDOpReply(self.pgid, self.osd.epoch(),
                                         msg.oid, msg.ops, result=result))
                return False
            pre = self._snap_pre_txn(msg, state, work)
            commit_state = None if delete else work
            if delete:
                # deleting a head that has snapshot clones keeps a
                # WHITEOUT carrying the SnapSet (the reference's
                # snapdir object): without it the clones become
                # unreachable and a recreate could re-clone over them
                ss = self._snapset_of(work)
                if not ss.get("clones"):
                    ss = self._snapset_of(state)
                if ss.get("clones"):
                    import json

                    commit_state = ObjectState(
                        b"", {"snapset": json.dumps(ss).encode(),
                              "whiteout": b"1"}, {})
                    delete = False
            self._commit_write(msg, commit_state, delete,
                               reply_once, pre_txn=pre,
                               on_submitted=on_submitted)
            if supersede:
                # the full rewrite just queued supersedes the
                # unrecovered generation — the missing marker (if any)
                # refers to history this write replaced, and leaving it
                # would EAGAIN every read of the now-current object;
                # the unfound verdict dies with it (every clear path
                # checks missing first, so a stale entry would report
                # OBJECT_UNFOUND HEALTH_ERR forever)
                self.missing.pop(msg.oid, None)
                self.unfound.discard(msg.oid)
        # no commit wait: the commit callback replies; the watchdog
        # sweep answers retryably if no shard ack ever resolves it
        # (the reference requeues; the client's resend retries EAGAIN)
        self._arm_write_deadline(_replied, lambda: reply_once(
            m.MOSDOpReply(self.pgid, self.osd.epoch(), msg.oid,
                          msg.ops, result=EAGAIN)))
        return True

    def _supersede_meta(self, oid: str):
        """Freshest (attrs, omap) testimony reachable for a superseding
        WRITEFULL's meta carry-forward: local shards first, then one
        short sub-read round to the live acting peers (cheap 1-byte
        extents; the meta rides every sub-read reply).  Ranked by
        ChunkGather's meta discipline — highest _av stamp wins, valid
        hinfo breaks ties.  Returns None when nobody has anything."""
        box: List = [None]
        for shard in self.backend.local_shards(self.acting):
            attrs, omap = self.backend.shard_meta(oid, shard)
            if attrs or omap:
                ChunkGather._better_meta(box, attrs, omap)
        omap_ = self.osd.osdmap
        n = self.backend.k + self.backend.m
        acting = list(self.acting[:n])
        remote = [
            (o, m.MECSubRead(self.pgid, self.osd.epoch(), s, oid, 0, 1))
            for s, o in enumerate(acting)
            if o not in (self.osd.whoami, CRUSH_ITEM_NONE) and o >= 0
            and (omap_ is None or omap_.is_up(o))
        ]
        if remote:
            for rep in self.osd.rpc(remote, timeout=5.0):
                if (isinstance(rep, m.MECSubReadReply)
                        and rep.oid == oid
                        and (rep.attrs or rep.omap)):
                    ChunkGather._better_meta(box, rep.attrs, rep.omap)
        if box[0] is None:
            return None
        return (dict(box[0][0]), dict(box[0][1]))

    def _exec_write_op(self, op: OSDOp, st: ObjectState,
                       exists: bool) -> Tuple[int, bool]:
        o = op.op
        if o in (t_.OP_WRITE, t_.OP_APPEND, t_.OP_TRUNCATE, t_.OP_ZERO):
            if isinstance(st.data, DeviceBuf):
                # read-modify over a device-resident payload: the ONE
                # sanctioned pull-back, and it is counted — mixed-op
                # workloads pay it, the pure-WRITEFULL happy path
                # never reaches here
                st.data = st.data.tobytes()
            elif isinstance(st.data, memoryview):
                st.data = bytes(st.data)  # zero-copy frame view: pin
        if o == t_.OP_CALL:
            return self._exec_call(op, st, exists, writable=True)
        if o == t_.OP_WRITE:
            end = op.off + len(op.data)
            buf = bytearray(st.data)
            if len(buf) < end:
                buf.extend(b"\0" * (end - len(buf)))
            buf[op.off:end] = op.data
            st.data = bytes(buf)
        elif o == t_.OP_WRITEFULL:
            if isinstance(op.data, memoryview):
                # the zero-copy frame view's ONE copy-out: the obc
                # cache retains this state long-term, and pinning the
                # whole receive frame (or handing cls methods a
                # memoryview) is worse than one payload copy
                st.data = bytes(op.data)
            else:
                st.data = op.data  # bytes, or a staged DeviceBuf
        elif o == t_.OP_APPEND:
            st.data = st.data + op.data
        elif o == t_.OP_CREATE:
            if exists and op.length:  # length!=0 => exclusive
                op.rval = EPERM
                return EPERM, False
        elif o == t_.OP_DELETE:
            if not exists:
                op.rval = ENOENT
                return ENOENT, False
            return 0, True
        elif o == t_.OP_TRUNCATE:
            size = op.off
            st.data = (st.data[:size] if len(st.data) >= size
                       else st.data + b"\0" * (size - len(st.data)))
        elif o == t_.OP_ZERO:
            end = op.off + op.length
            buf = bytearray(st.data)
            if len(buf) < end:
                buf.extend(b"\0" * (end - len(buf)))
            buf[op.off:end] = b"\0" * op.length
            st.data = bytes(buf)
        elif o == t_.OP_SETXATTR:
            st.xattrs[op.name] = op.data
        elif o == t_.OP_RMXATTR:
            st.xattrs.pop(op.name, None)
        elif o == t_.OP_OMAP_SET:
            st.omap.update(op.kv)
        elif o == t_.OP_OMAP_RM:
            for k in op.keys:
                st.omap.pop(k, None)
        else:
            op.rval = EINVAL
            return EINVAL, False
        return 0, False

    def _next_version(self) -> EVersion:
        cur = self.info.last_update
        return EVersion(self.osd.epoch(), cur.version + 1)

    # -- partial-stripe EC overwrite (RMW) --------------------------------
    def _ec_read_stripes(self, oid: str, s0: int, s1: int):
        """Old content of stripes [s0, s1): local shard extents first,
        then ranged sub-reads; decodes when data shards are missing
        (reference try_state_to_reads, ECBackend.cc:1817)."""
        from ceph_tpu_torch.osd.backend import _av_stamp

        be: ECBackend = self.backend  # type: ignore[assignment]
        n = be.k + be.m
        acting = list(self.acting[:n]) + [CRUSH_ITEM_NONE] * (
            n - len(self.acting))
        off, length = be.sinfo.chunk_extent(s0, s1)
        # version discipline (thrash-hunt divergence class): per-PG
        # write ordering means every live shard of this object carries
        # the _av stamp of its newest log entry — an extent with any
        # OTHER stamp is stale (degraded-skipped write, not-yet-applied
        # recovery push, zombie store) and must not enter the RMW base.
        # Objects predating the stamp (or with no log entry) fall back
        # to the full write path, which reads degraded-aware.
        with self.lock:
            en = self.log.latest_for(oid)
            local_stale = oid in self.missing
        if en is None or en.op == t_.LOG_DELETE:
            return None
        want_av = _av_stamp(en.version)
        extents: Dict[int, bytes] = {}
        if not local_stale:
            # a primary that hasn't recovered this object yet must not
            # feed its own stale chunk into the RMW base (the full-read
            # path has the same guard; its absence HERE was the
            # thrash-hunt divergence: a partial write rebuilt a shard
            # from a pre-takeover image)
            for shard in be.local_shards(acting):
                attrs, _omap = be.shard_meta(oid, shard)
                if attrs.get("_av") != want_av:
                    continue
                c = be.read_local_chunk(oid, shard)
                if c is not None and len(c) >= off + length:
                    extents[shard] = c[off: off + length]
        if not set(range(be.k)) <= set(extents):
            omap_ = self.osd.osdmap
            remote = [
                (acting[s], m.MECSubRead(self.pgid, self.osd.epoch(), s,
                                         oid, off, length))
                for s in range(n)
                if s not in extents
                and acting[s] not in (self.osd.whoami, CRUSH_ITEM_NONE)
                # cephlint: disable=unguarded-shared-state — advisory
                # membership probe: a racing activate() only shrinks
                # the set, and a wasted sub-read times out into retry
                and acting[s] >= 0 and acting[s] not in self.stale_peers
                and (omap_ is None or omap_.is_up(acting[s]))  # down:
            ]   # can never answer — don't burn the read window on it
            if remote:
                for rep in self.osd.rpc(remote, timeout=10.0):
                    if (isinstance(rep, m.MECSubReadReply)
                            and rep.result == 0
                            and len(rep.data) == length
                            and rep.attrs.get("_av") == want_av):
                        extents[rep.shard] = rep.data
        return be.assemble_range(extents, s0, s1)

    def _try_partial_write(self, msg, reply, on_submitted=None) -> bool:
        """Returns True when the write was handled as per-shard extent
        writes of only the touched stripes; `on_submitted` (the
        admission-FIFO release) then fires once the extent transactions
        have fanned out."""
        wop = msg.ops[0]
        be: ECBackend = self.backend  # type: ignore[assignment]
        # version-checked preconditions (0x1EC thrash byte-mismatch
        # forensics): a primary whose own shards are stale — oid in
        # pg.missing, or a local shard carrying an older _av — must
        # not size the write's hinfo from them.  The stale size would
        # be re-stamped with the NEW write's _av, and meta ranking,
        # reads, and recovery all trust a current-stamped hinfo; the
        # full path reads its base degraded-aware instead.
        from ceph_tpu_torch.osd.backend import _av_stamp

        with self.lock:
            if msg.oid in self.missing:
                return False
            en = self.log.latest_for(msg.oid)
        want_av = (_av_stamp(en.version)
                   if en is not None and en.op != t_.LOG_DELETE
                   else None)
        if not be.can_partial(msg.oid, wop.off, len(wop.data), want_av):
            return False
        width = be.stripe_width
        s0, s1 = be.sinfo.stripe_range(wop.off, len(wop.data))
        _replied = [False]
        _rlock = make_lock("pg.reply_once")

        def reply_once(rep) -> None:
            with _rlock:
                if _replied[0]:
                    return
                _replied[0] = True
            reply(rep)

        # READ: recently-written stripes come from the extent cache
        # (no shard reads), the rest from shard extents
        stripes, missing = be.read_cached_stripes(msg.oid, s0, s1)
        if missing:
            lo, hi = min(missing), max(missing) + 1
            old = self._ec_read_stripes(msg.oid, lo, hi)
            if old is None:
                return False
            for s in range(lo, hi):
                stripes.setdefault(s, bytearray(
                    old[(s - lo) * width: (s - lo + 1) * width]))
        # MODIFY: splice the new bytes into the touched stripes
        end = wop.off + len(wop.data)
        for s in range(s0, s1):
            base = s * width
            d0, d1 = max(wop.off, base), min(end, base + width)
            stripes[s][d0 - base: d1 - base] = (
                wop.data[d0 - wop.off: d1 - wop.off])
        size = be.local_size(msg.oid, want_av)
        if size is None:
            return False  # current-stamped shard vanished mid-check
        with self.lock:
            version = self._next_version()
            entry = LogEntry(
                op=t_.LOG_MODIFY, oid=msg.oid, version=version,
                prior_version=self.info.last_update,
                mtime=time.time(), reqid=getattr(msg, "reqid", ""))
            self.log.append(entry)
            self.info.last_update = version
            self.info.last_complete = version
            log_omap = self.log.omap_additions([entry])
            log_rm = self.log.omap_removals(self.log.trim_to())

            def on_commit(acked=None, dropped=None) -> None:
                # register + unmark atomically (see _commit_write)
                if entry.reqid:
                    with self._pipe_lock:
                        self._note_reqid(entry)
                        self._inflight_reqids.pop(entry.reqid, None)
                self._note_inflight(-1)
                self._op_stage(msg, "commit")
                self._durable_ack(
                    version, acked, dropped,
                    lambda: reply_once(m.MOSDOpReply(
                        self.pgid, self.osd.epoch(), msg.oid, msg.ops,
                        result=0, version=version)),
                    msg=msg)

            on_commit.wants_acked = True

            # WRITE: per-shard extents of the touched stripes only
            self._obc_invalidate(msg.oid)  # extents bypass full state
            self._note_inflight(1)
            be.submit_partial(msg.oid, s0, stripes, size, [entry],
                              log_omap, self.acting, on_commit,
                              log_rm=log_rm, on_submitted=on_submitted,
                              on_error=self._write_unwind_fn(
                                  msg.oid, entry),
                              trop=getattr(msg, "trop", None))
        self._arm_write_deadline(_replied, lambda: reply_once(
            m.MOSDOpReply(self.pgid, self.osd.epoch(), msg.oid,
                          msg.ops, result=EAGAIN)))
        return True

    def _commit_write(self, msg, state: Optional[ObjectState],
                      delete: bool, reply,
                      committed: Optional[threading.Event] = None,
                      pre_txn=None, on_submitted=None) -> None:
        version = self._next_version()
        entry = LogEntry(
            op=t_.LOG_DELETE if delete else t_.LOG_MODIFY,
            oid=msg.oid,
            version=version,
            prior_version=self.info.last_update,
            mtime=time.time(),
            reqid=getattr(msg, "reqid", ""),
        )
        self.log.append(entry)
        self.info.last_update = version
        self.info.last_complete = version
        log_omap = self.log.omap_additions([entry])
        # bound the log (reference osd_max_pg_log_entries trim)
        trimmed = self.log.trim_to()
        log_rm = self.log.omap_removals(trimmed)

        def on_commit(acked=None, dropped=None) -> None:
            # replay registration happens at COMMIT, not append: a write
            # that never reached quorum (EAGAIN to client) must not be
            # answered as done on resend.  Registration and the
            # in-flight-mark removal are one atomic step under
            # _pipe_lock: a resend's dup check must see either the
            # mark or the registered reqid, never neither
            if entry.reqid:
                with self._pipe_lock:
                    self._note_reqid(entry)
                    self._inflight_reqids.pop(entry.reqid, None)
            self._note_inflight(-1)
            self._op_stage(msg, "commit",
                           f"dropped={sorted(dropped)}" if dropped else "")

            def fire() -> None:
                reply(m.MOSDOpReply(self.pgid, self.osd.epoch(),
                                    msg.oid, msg.ops, result=0,
                                    version=version))
                if committed is not None:
                    committed.set()

            # degraded EC commits hold the reply until the watermark
            # is durable beyond this primary (the 0xd403 fix)
            self._durable_ack(version, acked, dropped, fire, msg=msg)

        on_commit.wants_acked = True

        kw = {"log_rm": log_rm}
        if pre_txn is not None:
            kw["pre_txn"] = pre_txn
        if on_submitted is not None:
            kw["on_submitted"] = on_submitted
        if self.is_ec():
            kw["on_error"] = self._write_unwind_fn(msg.oid, entry)
        span = getattr(msg, "span", None)
        if span is not None:
            # peer sub-writes inherit this op's span context on the
            # wire, so each peer's store-commit batch opens a child
            kw["trace"] = span.context()
        # the tracked op rides to the encode queue so a kernel build
        # overlapping the batch gets blamed on ITS timeline
        # (compile_wait annotation + lat_compile_wait_us)
        kw["trop"] = getattr(msg, "trop", None)
        # the queued write IS the newest state (published BEFORE the
        # backend submit, so a same-object successor admitted at
        # on_submitted reads its predecessor's projected state):
        # read-your-writes from the context cache
        self._obc_put(msg.oid, None if delete else state)
        self._note_inflight(1)
        self.backend.submit(msg.oid, state, [entry], log_omap,
                            self.acting, on_commit, **kw)

    def _write_unwind_fn(self, oid: str, entry: LogEntry):
        """Unwind for a write whose device encode failed (nothing was
        stored or sent anywhere): un-publish the projected state and
        drop the in-flight bookkeeping so the client's retry can
        re-execute.  The log entry stays, like any write whose shards
        never ack; readers version-check _av and answer retryably
        until the retry re-mints the head."""
        def unwind() -> None:
            self._obc_invalidate(oid)
            self._note_inflight(-1)
            if entry.reqid:
                with self._pipe_lock:
                    self._inflight_reqids.pop(entry.reqid, None)
        return unwind

    # -- replica apply ----------------------------------------------------
    # Sub-write acks fire from the STORE's commit callback, not inline:
    # the dispatch thread applies (in-memory state + WAL append) and
    # moves on, while the commit thread batches one fsync across every
    # replica write in flight and then sends the replies — the replica
    # half of the group-commit pipeline (a 16-deep primary queue lands
    # 16 sub-writes in one fsync here instead of 16).
    def handle_rep_op(self, msg: m.MOSDRepOp, conn) -> None:
        def _ack() -> None:
            rep = m.MOSDRepOpReply(self.pgid, self.osd.epoch(), 0)
            rep.tid = msg.tid
            conn.send(rep)

        with self.lock:
            if msg.epoch < self.interval_epoch:
                return  # old-interval replica op: see handle_sub_write
            self.backend.apply_rep_op(msg.txn, on_commit=_ack)
            self._note_entries(msg.entries)

    def handle_sub_write(self, msg: m.MECSubWrite, conn) -> None:
        def _ack() -> None:
            rep = m.MECSubWriteReply(self.pgid, self.osd.epoch(),
                                     msg.shard, 0)
            rep.tid = msg.tid
            conn.send(rep)

        with self.lock:
            if msg.epoch < self.interval_epoch:
                # minted in an OLDER interval (a lossless session can
                # replay unacked sub-writes onto a revived peer —
                # potentially onto a RECYCLED port): applying it would
                # overwrite recovered data with the past.  Drop; the
                # primary's interval change already restarted or
                # re-resolved the repop (thrash-hunt divergence find).
                return
            self.backend.apply_sub_write(msg, on_commit=_ack)
            self._note_entries(msg.entries)
            with self._ct_lock:
                if msg.committed_to > self.info.committed_to:
                    # the primary's roll-forward watermark: entries at
                    # or below it are acked and beyond divergent
                    # rollback
                    self.info.committed_to = msg.committed_to

    def handle_sub_write_vec(self, msg: m.MECSubWriteVec, conn) -> None:
        """Peer side of the aggregated sub-write: ONE merged store
        transaction for every shard this peer holds of the op (one
        rollback-capture pass, one WAL append), ONE commit ack.  Same
        interval gating and watermark merge as handle_sub_write."""
        tr = self.osd.ctx.trace
        span = None
        if tr.enabled and msg.trace_ctx() is not None:
            # cross-daemon child: the primary op span's context rode
            # the wire; this peer's store-commit batch hangs off it
            span = tr.start_span(f"osd{self.osd.whoami}.sub_write",
                                 parent=msg.trace_ctx())
            span.annotate(f"sub_write_recv oid={msg.oid} "
                          f"shards={[r[0] for r in msg.rb]}")

        def _ack() -> None:
            rep = m.MECSubWriteVecReply(self.pgid, self.osd.epoch(), 0)
            rep.tid = msg.tid
            conn.send(rep)
            if span is not None:
                # fires from the store's commit thread: the annotation
                # stamps when THIS peer's merged transaction went
                # durable (its fsync batch)
                span.annotate("store_commit")
                span.finish()

        try:
            with self.lock:
                if msg.epoch < self.interval_epoch:
                    # minted in an OLDER interval: applying it would
                    # overwrite recovered data with the past (see
                    # handle_sub_write) — drop, the primary's interval
                    # change already re-resolved the repop
                    if span is not None:
                        span.annotate(f"dropped: stale interval "
                                      f"(epoch {msg.epoch} < "
                                      f"{self.interval_epoch})")
                        span.finish()
                    return
                self.backend.apply_sub_write_vec(msg, on_commit=_ack)
                self._note_entries(msg.entries)
                with self._ct_lock:
                    if msg.committed_to > self.info.committed_to:
                        self.info.committed_to = msg.committed_to
        except BaseException as e:
            # the happy path finishes the span from the store's commit
            # thread (_ack); a store/apply failure must not leak it —
            # an unarchived span is a silently missing trace subtree
            if span is not None:
                span.annotate(f"exception: {e!r}")
                span.finish()
            raise

    def _note_entries(self, entries: List[LogEntry]) -> None:
        for en in entries:
            if en.version > self.log.head:
                self.log.append(en)
                self._note_reqid(en)
        self.log.trim_to()  # replicas bound memory like the primary
        if self.log.head > self.info.last_update:
            self.info.last_update = self.log.head
            self.info.last_complete = self.log.head

    def _durable_ack(self, version: EVersion, acked, dropped,
                     fire: Callable[[], None], msg=None) -> None:
        """Advance the roll-forward watermark and release the client
        reply — the op at `version` got its last shard ack, so
        divergent-entry rollback must never rewind past it (the
        reference's roll_forward_to).

        Called from commit callbacks with and without the pg lock held
        (some inline on the messenger loop): the watermark check-then-
        set runs under a dedicated leaf lock, and the pg lock is never
        taken here.

        Reply policy — the 0xd403 fix: a HEALTHY full-width commit
        fires immediately with its broadcast ABSORBED into the next
        sub-write's committed_to piggyback (the >=k-holders
        roll-forward rule already protects it through any single death,
        and eager notes cost two messages + two peer pg-meta persists
        per write at depth 16).  A DEGRADED commit — some acting member
        dropped dead mid-write, acked on as few as k shards — must NOT
        ack the client until the watermark provably outlives this
        primary: the round-6 loss traces were exactly an acked entry
        whose watermark lived solely in the dead primary's memory (the
        old eager broadcast was fire-and-forget, and the 2x-CPU-load
        window between client ack and note delivery spanned the thrash
        kill), so the next whole-set arbitration counted < k holders,
        floored below the entry, and rewound acknowledged state.  The
        gate sends tid-carrying notes to every surviving acked
        co-holder and fires only when each has PERSISTED the watermark
        (MECCommitNoteAck); a commit that never reached k members at
        all is not EC-durable and is left to the deadline sweep's
        EAGAIN."""
        with self._ct_lock:
            if version > self.info.committed_to:
                self.info.committed_to = version
        if not self.is_ec() or self.primary != self.osd.whoami:
            fire()
            return
        # read without the pg lock: a racing interval change only
        # widens toward the gated (safe) side
        n = self.backend.k + self.backend.m
        slots = list(self.acting[:n])
        full = (acked is not None and not dropped
                and len(slots) == n
                and all(o >= 0 and o != CRUSH_ITEM_NONE for o in slots)
                and all(o in acked for o in set(slots))
                # cephlint: disable=unguarded-shared-state — see the
                # docstring: read without the pg lock, a racing
                # interval change only widens toward the gated side
                and self.state == STATE_ACTIVE)
        if full:
            with self._ct_lock:
                self._ct_dirty = True
                if version > self._ct_covered:
                    self._ct_covered = version
            fire()
            return
        members = set(acked or ())
        if len(members) < self.backend.k:
            # fewer than k members persisted the entry: not durable at
            # EC strength — never tell the client it is.  The deadline
            # sweep answers EAGAIN; the resend re-runs the gate.
            self.osd._log(1, f"pg {t_.pgid_str(self.pgid)}: commit of "
                             f"{version} on {sorted(members)} is below "
                             f"k={self.backend.k}; withholding ack")
            return
        peers = sorted(members - {self.osd.whoami})
        if not peers:
            # every persisted shard is local: our own durable log IS
            # the whole testimony — nothing remote to wait for
            fire()
            return
        # gate-wait attribution: how long the degraded commit's reply
        # was held for watermark witnesses (lat_ack_gate_us + the op
        # timeline's ack_gated stage)
        t_gate = time.monotonic()

        def fire_gated() -> None:
            trop = getattr(msg, "trop", None) if msg is not None else None
            if trop is None:
                # no tracked op to feed the stage delta (forged/test
                # messages): hinc the gate histogram directly
                op_perf = getattr(self.osd, "op_perf", None)
                if op_perf is not None:
                    op_perf.hinc("lat_ack_gate_us",
                                 (time.monotonic() - t_gate) * 1e6)
            if msg is not None:
                # tracked ops feed lat_ack_gate_us ONCE through the
                # stage delta (previous timeline event is the commit,
                # marked just before _durable_ack)
                self._op_stage(msg, "ack_gated")
            fire()

        span = getattr(msg, "span", None) if msg is not None else None
        self._gate_on_notes(version, peers, fire_gated,
                            trace=None if span is None
                            else span.context())

    def _gate_on_notes(self, version: EVersion, peers: List[int],
                       fire: Callable[[], None],
                       need_holders_at: Optional[EVersion] = None,
                       trace=None) -> None:
        """Hold `fire` until every peer persists the watermark at
        `version`.  Note sends + the local meta persist hop to the
        fan-out lane — this may run inline on the messenger loop.

        `need_holders_at` (the REPLAY gate): additionally require that
        self plus the ackers whose log heads reach that version make
        up k members — a commit-path gate's peers acked the sub-write
        itself so they hold the entry by construction, but a replayed
        reqid may belong to a write whose data never reached k shards
        (both peers died mid-write); persisting the watermark alone
        would answer result=0 for unreconstructable data."""
        tid = self.osd.new_tid()
        gate_box: List[_NoteGate] = []

        def complete() -> None:
            with self._ct_lock:
                self._note_gates.pop(tid, None)
            if need_holders_at is not None:
                held = 1 + gate_box[0].holders_at(need_holders_at)
                if held < self.backend.k:
                    # the entry's data is below k shards: not
                    # EC-durable — stay silent, the deadline sweep
                    # answers EAGAIN and the object heals via
                    # recovery or a superseding write first
                    self.osd._log(
                        1, f"pg {t_.pgid_str(self.pgid)}: replay of "
                           f"{need_holders_at} held by {held} < "
                           f"k={self.backend.k}; withholding ack")
                    return
            with self._ct_lock:
                if version > self._ct_covered:
                    self._ct_covered = version
            fp.failpoint("pg.commit.client_reply", version=str(version))
            fire()

        gate = _NoteGate(set(peers), complete,
                         expires=time.monotonic()
                         + 2 * self._write_timeout_s())
        gate_box.append(gate)
        with self._ct_lock:
            self._note_gates[tid] = gate

        def send_notes() -> None:
            fp.failpoint("pg.commit_note.broadcast",
                         version=str(version), gated=True)
            # the primary's own watermark goes durable alongside: a
            # revived primary then testifies the floor from its info.
            # Under the pg lock like every other persist site — an
            # unlocked encode could snapshot a concurrent write's
            # last_update BEFORE that write's entry reaches the WAL,
            # and a kill between the two records leaves persisted
            # info claiming an entry the log can't produce (breaking
            # the contiguity the holder counts rely on)
            with self.lock:
                self._persist_meta()
            epoch = self.osd.epoch()
            for osd_id in peers:
                note = m.MECCommitNote(self.pgid, epoch, version)
                note.tid = tid
                note.set_trace(trace)  # gated op's span context
                self.osd.send_to_osd(osd_id, note)

        from ceph_tpu_torch.osd.backend import _fanout_executor

        _fanout_executor().submit(send_notes)

    def _broadcast_commit_note(self, version: EVersion) -> None:
        """Advisory (tid-less, fire-and-forget) watermark broadcast —
        the healthy-path tail flush.  Durability-bearing broadcasts go
        through _gate_on_notes instead."""
        fp.failpoint("pg.commit_note.broadcast", version=str(version),
                     gated=False)
        for osd_id in self.acting:
            if osd_id in (self.osd.whoami, CRUSH_ITEM_NONE) or osd_id < 0:
                continue
            note = m.MECCommitNote(self.pgid, self.osd.epoch(), version)
            self.osd.send_to_osd(osd_id, note)

    def flush_commit_note(self) -> None:
        """Tail flush for absorbed healthy-path watermark advances:
        called by the osd watchdog tick (and the sweep), so shards
        persist the newest watermark within ~a second of the last
        commit even with no further writes to piggyback on."""
        with self._ct_lock:
            if not self._ct_dirty:
                return
            self._ct_dirty = False
            version = self.info.committed_to
        if self.is_ec() and self.primary == self.osd.whoami:
            self._broadcast_commit_note(version)

    def handle_commit_note(self, msg: m.MECCommitNote, conn) -> None:
        """Shard side of the roll-forward watermark: merge and PERSIST
        it (a revived shard must still refuse to rewind acked
        entries).  A tid-less note is advisory (no reply; losing one
        only defers protection to the next piggyback); a tid-carrying
        note is one leg of a degraded commit's durable-ack gate — the
        persist is unconditional (the in-memory watermark may be ahead
        of the durable one via sub-write piggybacks) and the ack goes
        back only once it is on stable storage."""
        if fp.enabled("pg.commit_note.persist") and fp.failpoint(
                "pg.commit_note.persist", osd=self.osd.whoami,
                v=str(msg.committed_to)) is fp.DROP:
            return  # modeled loss: the note dies with its sender
        tr = self.osd.ctx.trace
        span = None
        if tr.enabled and msg.trace_ctx() is not None:
            # gated notes carry the held op's span context: this child
            # records the witness persist leg of the durable-ack gate
            span = tr.start_span(f"osd{self.osd.whoami}.commit_note",
                                 parent=msg.trace_ctx())
        try:
            with self.lock:
                with self._ct_lock:
                    newer = msg.committed_to > self.info.committed_to
                    if newer:
                        self.info.committed_to = msg.committed_to
                if not newer and not msg.tid:
                    return
                self._persist_meta()
            if span is not None:
                span.annotate("note_persisted")
            if not msg.tid:
                return
            if fp.enabled("pg.commit_note.ack") and fp.failpoint(
                    "pg.commit_note.ack", osd=self.osd.whoami) is fp.DROP:
                return
            rep = m.MECCommitNoteAck(self.pgid, self.osd.epoch(),
                                     msg.committed_to,
                                     last_update=self.info.last_update)
            rep.tid = msg.tid
            rep.set_trace(msg.trace_ctx())  # correlate the witness ack
            conn.send(rep)
        finally:
            if span is not None:
                span.finish()

    def handle_commit_note_ack(self, msg: m.MECCommitNoteAck,
                               conn=None) -> None:
        """Primary side of the durable-ack gate: one surviving
        co-holder has the watermark on stable storage (its log head
        rides along for the replay gate's holder count)."""
        src = msg.src.num if msg.src else -1
        with self._ct_lock:
            gate = self._note_gates.get(msg.tid)
        if gate is not None and src >= 0:
            gate.ack(src, getattr(msg, "last_update", None))

    # -- reqid replay (exactly-once resends) ------------------------------
    def _note_reqid(self, en: LogEntry) -> None:
        if not en.reqid:
            return
        self._reqids[en.reqid] = en.version
        if len(self._reqids) > 2 * len(self.log.entries) + 512:
            self._reindex_reqids()

    def _reindex_reqids(self) -> None:
        self._reqids = {
            en.reqid: en.version for en in self.log.entries if en.reqid
        }

    def handle_sub_read(self, msg: m.MECSubRead, conn) -> None:
        assert isinstance(self.backend, ECBackend)
        if msg.length:
            # ranged sub-read (RMW old-stripe fetch): served without
            # materializing the whole chunk where the store's read
            # path verifies the extent; elsewhere the whole-chunk crc
            # verify + slice is unchanged
            data, code = self.backend.read_local_chunk_extent2(
                msg.oid, msg.shard, msg.off, msg.length)
        else:
            data, code = self.backend.read_local_chunk2(msg.oid, msg.shard)
        attrs, omap = self.backend.shard_meta(msg.oid, msg.shard)
        # an ECRC verdict travels to the primary: "I HAVE the shard but
        # its bytes failed verification" — the primary decodes around
        # it and queues the object for repair (a plain EIO would read
        # as an ordinary missing shard and lose the attribution)
        rep = m.MECSubReadReply(
            self.pgid, self.osd.epoch(), msg.shard, msg.oid,
            data if data is not None else b"",
            0 if data is not None else code,
            attrs, omap)
        rep.tid = msg.tid
        conn.send(rep)

    def handle_sub_read_vec(self, msg: m.MECSubReadVec, conn) -> None:
        """Peer side of the aggregated sub-read: ONE message carries
        every (oid, shard, extent) this peer serves for a recovery
        window or read burst; ONE reply answers every row with its
        chunk + per-shard meta.  Chunk and meta fetches are deduped
        per (oid, shard) so repeated extents of one chunk cost a
        single store pass.  Rows this peer can't serve answer EIO
        instead of going silent — the sender's gather accounting
        needs every row."""
        assert isinstance(self.backend, ECBackend)
        tr = self.osd.ctx.trace
        span = None
        if tr.enabled and msg.trace_ctx() is not None:
            # child of the sender's recovery-round span: which peer
            # served which rows, and how long the store pass took
            span = tr.start_span(f"osd{self.osd.whoami}.sub_read",
                                 parent=msg.trace_ctx())
        try:
            be = self.backend
            chunks: Dict[Tuple[str, int], Tuple[Optional[bytes], int]] = {}
            metas: Dict[Tuple[str, int], Tuple] = {}
            rows = []
            served: List[int] = []
            run_plans = (msg.runs if len(msg.runs) == len(msg.reads)
                         else [[] for _ in msg.reads])
            for (shard, oid, off, length), rr in zip(msg.reads,
                                                     run_plans):
                key = (oid, shard)
                sv = 0
                if rr and not length:
                    # sub-chunk run plan (clay repair): serve only the
                    # requested repair layers through the extent-sealed
                    # read path; an unmappable plan falls back to the
                    # whole chunk, exactly like a legacy peer would
                    data, code, sv = be.read_local_chunk_runs2(
                        oid, shard, rr)
                if sv:
                    pass
                elif length:
                    data, code = be.read_local_chunk_extent2(
                        oid, shard, off, length)
                else:
                    if key not in chunks:
                        chunks[key] = be.read_local_chunk2(oid, shard)
                    data, code = chunks[key]
                if key not in metas:
                    metas[key] = be.shard_meta(oid, shard)
                attrs, omap = metas[key]
                rows.append((shard, oid,
                             data if data is not None else b"",
                             0 if data is not None else code, attrs, omap))
                served.append(sv)
            rep = m.MECSubReadVecReply(self.pgid, self.osd.epoch(), rows,
                                       served=served)
            rep.tid = msg.tid
            conn.send(rep)
            if span is not None:
                span.annotate(f"sub_read_served rows={len(rows)}")
        finally:
            # a store-pass failure must not leak the span (finish is
            # idempotent: the happy path's annotate already ran)
            if span is not None:
                span.finish()

    # -- EC read path (primary) -------------------------------------------
    def _ec_read_object(self, oid: str,
                        done: Callable[[Optional[ObjectState]], None]):
        """Gather >=k chunks and one (attrs, omap) meta, then decode.

        The gather discipline lives in recovery.ChunkGather, shared
        with the windowed recovery engine: source PRIORITY (a
        prior-interval holder may hold a STALE shard, so its answer
        must never beat the CURRENT acting holder's), the _av version
        check (mixed shard generations must never co-decode), and the
        retryable-vs-absent verdict.  The decode itself routes through
        backend.reconstruct_async, so concurrent degraded reads
        sharing a survivor pattern coalesce into one device matmul."""
        be: ECBackend = self.backend  # type: ignore[assignment]
        g = ChunkGather(self, oid)

        def conclude(timed_out: bool = False) -> None:
            if g.crc_failed:
                # shards whose bytes exist but failed verification:
                # the decode routes around them; attribution + repair
                # happen regardless of this read's own verdict
                self._note_read_verify_fail(oid, g.crc_failed)
            avail, meta, retry = g.resolve(timed_out)
            if retry:
                # a current holder never answered / was down / was
                # version-rejected: the chunks exist and recovery will
                # bring them forward — retryable, not gone
                done(READ_RETRY)
                return
            if not avail:
                done(None)
                return
            be.reconstruct_async(oid, avail, meta, done)

        if not g.remote or len(g.cur_avail) >= be.k:
            conclude()
            return
        lock = make_lock("pg.ec_read_gather")
        fired = [False]

        def finish(timed_out: bool = False) -> None:
            with lock:
                if fired[0]:
                    return
                fired[0] = True
            timer.cancel()
            conclude(timed_out)

        def on_reply(rep: m.MECSubReadReply) -> None:
            with lock:
                late = fired[0]
                if not late:
                    src = rep.src.num if rep.src else -1
                    ready = g.feed(rep.shard, src, rep.result, rep.oid,
                                   rep.data, rep.attrs, rep.omap)
            if late:
                # the gather already resolved (>=k fast shards won the
                # race or the timer fired) — but an ECRC verdict in a
                # straggler reply is still evidence of at-rest rot on
                # that holder.  Dropping it here silently un-detects
                # remote corruption; count it and feed the same dedup'd
                # attribution/repair path conclude() uses.
                if rep.result == ECRC and rep.oid == oid:
                    perf = getattr(self.osd, "pg_perf", None)
                    if perf is not None:
                        perf.inc("read_verify_late")
                    src = rep.src.num if rep.src else -1
                    self._note_read_verify_fail(oid, [(rep.shard, src)])
                return
            if ready:
                finish()

        timer = threading.Timer(10.0, lambda: finish(timed_out=True))
        timer.daemon = True
        timer.start()
        tid = self.osd.track_reads(self.pgid, on_reply, len(g.remote))
        for shard, osd, _is_cur in g.remote:
            rd = m.MECSubRead(self.pgid, self.osd.epoch(), shard, oid, 0, 0)
            rd.tid = tid
            self.osd.send_to_osd(osd, rd)

    # -- peering + recovery (primary, linearized) -------------------------
    def activate_async(self) -> None:
        """Kick activation WITHOUT blocking the caller (round-5
        liveness fix: synchronous activation in the map-refresh path
        serialized every PG behind one blocked peer RPC — a peer that
        died mid-peering could hold the whole cluster's convergence,
        and a stale activation losing the interval race left PEERING
        with no retrigger).  At most one activation runs per PG; a kick
        during one queues exactly one re-run so the final run always
        sees the newest interval."""
        with self.lock:
            if self._activating:
                self._activate_again = True
                return
            self._activating = True
        threading.Thread(target=self._activate_loop, daemon=True,
                         name=f"pg{t_.pgid_str(self.pgid)}-act").start()

    def _activate_loop(self, first=None) -> None:
        try:
            while True:
                try:
                    (first or self.activate)()
                except Exception as e:  # noqa: BLE001 — must not die wedged
                    self.osd._log(1, f"pg {self.pgid}: activation failed: "
                                     f"{e!r}")
                first = None
                with self.lock:
                    if self._activate_again:
                        self._activate_again = False
                        continue
                    self._activating = False
                    return
        finally:
            # wake wait_pgs_settled sleepers (event-driven settle wait;
            # osd is duck-typed, so tolerate hosts without the hook)
            note = getattr(self.osd, "note_pg_settled", None)
            if note is not None:
                note()

    def peering_stuck(self, threshold_s: float = 3.0) -> bool:
        """Watchdog predicate: in PEERING past the threshold with no
        activation in flight (a lost peer reply or a discarded stale
        activation would otherwise wedge the gate forever).

        Each True ARMS an exponentially longer per-PG fuse (1s, 2s,
        4s, ... capped at 30s) before the next trip: the round-5
        regression was a fixed 1s tick re-kicking activation runs that
        each lost the interval race, so the gate never opened and
        admitted ops starved behind an EAGAIN storm.  The fuse resets
        on an interval change and on reaching Active."""
        with self.lock:
            if self.state != STATE_PEERING or self._activating:
                return False
            now = time.monotonic()
            if now - self._peering_since <= threshold_s:
                return False
            if now < self._wd_next:
                return False
            self._wd_backoff = min(max(2 * self._wd_backoff, 1.0), 30.0)
            self._wd_next = now + self._wd_backoff
            return True

    def laggards_due(self) -> bool:
        """Watchdog predicate: a primary with no activation in flight
        holds a laggard that a failed push left stale (a push lost to a
        kill window or timed out behind a slow store), and its fuse has
        burnt.  Each True arms an exponentially longer fuse (1s, 2s, 4s,
        ... capped at 30s), as ``peering_stuck`` does; an interval change
        resets it."""
        with self.lock:
            if (not self._laggard_retry or self._activating
                    or not self.is_primary()):
                return False
            now = time.monotonic()
            if now < self._lag_next:
                return False
            self._lag_backoff = min(max(2 * self._lag_backoff, 1.0), 30.0)
            self._lag_next = now + self._lag_backoff
            return True

    def retry_laggards_async(self) -> None:
        """Push the stale laggards forward again on the activation
        thread (one at a time with activations: an activation kicked
        meanwhile runs after it, and recomputes the laggards)."""
        with self.lock:
            if self._activating:
                return
            self._activating = True
        threading.Thread(target=self._activate_loop,
                         args=(self._retry_laggards,), daemon=True,
                         name=f"pg{t_.pgid_str(self.pgid)}-lag").start()

    def _retry_laggards(self) -> None:
        with self.lock:
            infos = dict(self._laggard_retry) if self.is_primary() else {}
            self._laggard_retry.clear()
        perf = getattr(self.osd, "pg_perf", None)
        if infos and perf is not None:
            perf.inc("laggard_retries", len(infos))
        self._push_laggards(infos)

    def activate(self) -> None:
        """Collect peer infos+logs, converge, then go active.

        The blocking phases (pull RPC, recovery pushes) run WITHOUT the
        pg lock: applying the resulting MPGPush messages takes it, so
        holding it across the round-trips would self-deadlock."""
        with self.lock:
            if not self.is_primary():
                self.state = STATE_ACTIVE  # replicas follow the primary
                return
            # interval token: a concurrent activation for a NEWER map
            # must win — a stale activate() finishing late would open
            # the peering gate with the old interval's peer view
            interval = (tuple(self.acting), self.primary)
            # query prior-interval holders too: a wholesale remap
            # (pgp_num bump, crush edit) can leave every byte on strays
            omap = self.osd.osdmap
            all_peers = [o for o in {*self.acting, *self.prior_acting}
                         if o not in (self.osd.whoami, CRUSH_ITEM_NONE)
                         and o >= 0]
            up_peers = [o for o in all_peers
                        if omap is None or omap.is_up(o)]
            down_peers = [o for o in all_peers if o not in up_peers]
        # UP peers get the normal window.  Marked-DOWN peers are still
        # probed — a spuriously-marked-down peer may hold the
        # authoritative log (acked writes!), and skipping it would let
        # this PG go active on stale data — but with a SHORT window so
        # genuinely dead peers can't pin the PG in PEERING long enough
        # for client ops to starve on the gate (10s x PGs did).
        infos = self.osd.collect_pg_infos(self, up_peers)
        if down_peers:
            infos.update(self.osd.collect_pg_infos(
                self, down_peers, timeout=1.0))
        # EC divergent-entry arbitration BEFORE authoritative-log
        # selection: a member whose head only it (or < k members)
        # committed holds an un-acked leftover of a partially-committed
        # write — it rolls BACK from its persisted rollback records;
        # picking it as "best" instead would wedge recovery asking for
        # k fresh chunks that never existed (EAGAIN storm)
        if self.is_ec():
            infos = self._resolve_divergent(infos)
        with self.lock:
            self.peer_info = infos
            # authoritative log: highest last_update among self + peers
            best_osd, best = self.osd.whoami, self.info
            for osd_id, info in infos.items():
                if (info.last_update, -osd_id) > (best.last_update, -best_osd):
                    best_osd, best = osd_id, info
        deferred = None
        if best_osd != self.osd.whoami:
            # EC: the pull adopts the log and fences pg.missing, but
            # the recovery window drains AFTER the gate opens below —
            # reads of missing objects then park on a promoted
            # recovery (recover-on-read) instead of EAGAINing behind
            # the whole pull
            deferred = self.osd.pull_from_peer(
                self, best_osd, since=self.info.last_update,
                defer_recovery=self.is_ec())
        with self.lock:
            # anyone behind our (now-authoritative) log serves no reads
            # until pushed forward
            self.stale_peers = {
                osd_id for osd_id, info in infos.items()
                if info.last_update < self.info.last_update
            }
            self._laggard_retry = {}
            self._lag_backoff = self._lag_next = 0.0
            # "Active accepts ops while recovery proceeds" (reference
            # PG.h:1955): with peer infos converged, the authoritative
            # log pulled, and behind peers fenced from reads, the
            # peering gate opens NOW — laggard pushes and EC
            # self-recovery run with the PG serving (degraded) ops.
            # Holding PEERING through the whole recovery phase was the
            # round-5 regression: admitted ops starved in EAGAIN storms
            # behind slow pushes.
            if (tuple(self.acting), self.primary) != interval:
                self._activate_again = True  # newer interval re-runs
                return
            degraded = (any(o == CRUSH_ITEM_NONE or o < 0
                            for o in self.acting)
                        or len(self.acting) < self._want_size()
                        or bool(self.missing) or bool(self.stale_peers))
            self.state = STATE_DEGRADED if degraded else STATE_ACTIVE
            self._wd_backoff = 0.0
            self._wd_next = 0.0
        if deferred:
            # gate is open: drain the windowed pull while (degraded)
            # ops are admitted, then make the adopted log durable —
            # the persist-after-recovery discipline, moved with the
            # recovery it fences (a crash mid-window re-peers from the
            # OLD durable state)
            self.recovery_engine().recover(deferred)
            with self.lock:
                self._persist_meta(self.log.omap_additions(
                    self.log.entries))
        self._push_laggards(infos)
        # objects still missing from an EARLIER interval (recovery was
        # short of fresh shards then): retry now — a peer holding them
        # may have returned with this interval.  Windowed like the
        # pull-time recovery (one vec sub-read per peer per round).
        with self.lock:
            retry = dict(self.missing) if self.is_ec() else {}
        if retry:
            self.recovery_engine().recover({
                oid: LogEntry(op=t_.LOG_MODIFY, oid=oid, version=ver,
                              prior_version=ver)
                for oid, ver in retry.items()})
        with self.lock:
            if (tuple(self.acting), self.primary) != interval:
                return  # interval moved on: the newer activation owns state
            degraded = any(o == CRUSH_ITEM_NONE or o < 0
                           for o in self.acting) or (
                len(self.acting) < self._want_size()) or bool(self.missing)
            self.state = STATE_DEGRADED if degraded else STATE_ACTIVE

    def _want_size(self) -> int:
        return self.pool.size

    # -- EC divergent-entry rollback (reference ECBackend
    # trim_to/roll_forward_to, ECBackend.cc:1443-1444, + PGLog.cc
    # divergent-entry handling) ------------------------------------------
    def _resolve_divergent(self, infos: Dict[int, PGInfo]
                           ) -> Dict[int, PGInfo]:
        """Arbitrate roll-forward vs roll-back across the acting set.

        The authoritative head is the newest version that can actually
        be SERVED: one at least k acting members committed (k distinct
        shards exist — those entries roll forward through normal
        log-based recovery), or one at/below the cluster's
        committed_to watermark (acked writes are never rewound, even
        when deaths leave < k reachable holders — the data may return
        with a revived peer).  Heads beyond that are un-acked leftovers
        of a partially-committed write: every holder (self included)
        rewinds them via its persisted rollback records, replacing the
        old convergence path (mark-missing + EAGAIN until
        re-replication) that the thrash hunt kept tripping over.
        Returns the peer-info map with rolled-back peers' refreshed
        infos merged in."""
        with self.lock:
            acting = {o for o in self.acting
                      if o >= 0 and o != CRUSH_ITEM_NONE}
            width = len(self.acting)
            lus = {self.osd.whoami: self.info.last_update}
            committed = self.info.committed_to
            for osd_id, info in infos.items():
                if osd_id in acting:
                    lus[osd_id] = info.last_update
                if info.committed_to > committed:
                    committed = info.committed_to
            k = self.backend.k
            m_ = self.backend.m
        if len(acting) < min(width, k + m_):
            # the acting set has a hole: a DEAD member may hold — and
            # may have completed the ack of — the very entries a
            # rewind would drop.  A degraded EC write commits on
            # exactly k live shards, and its commit-note watermark
            # broadcast races the primary's death: counting holders
            # without the dead member's testimony rolled back an ACKED
            # write (model-thrash data-loss find, 382B of zeros where
            # the acked 1271B image should be).  No rollback until the
            # set is whole again; until then unreconstructable heads
            # serve EAGAIN, which is transient and honest.
            return infos
        heads = sorted(set(lus.values()), reverse=True)
        auth = None
        for v in heads:
            if v <= committed:
                # FLOOR at the watermark itself, not this head: when
                # the newest head at/below committed sits strictly
                # below it (the acked entries' holders died or were
                # remapped out), rewinding to that head would destroy
                # the acked entries on the one member still carrying
                # them — the exact writes committed_to promises never
                # to rewind
                auth = committed
                break
            if sum(1 for lu in lus.values() if lu >= v) >= k:
                auth = v
                break
        if auth is None or auth >= heads[0]:
            return infos  # nothing divergent / nothing safely rewindable
        fp.failpoint("pg.resolve_divergent", auth=str(auth),
                     head=str(heads[0]), committed=str(committed))
        if any(o not in lus for o in acting):
            # an acting member never answered: it may hold (and its ack
            # may have completed) the very entries a rewind would drop
            # — rollback needs the WHOLE acting set's testimony.  Fall
            # back to the old convergence path: the newest head stays
            # authoritative and its objects serve EAGAIN until the
            # holder returns (correct, merely slow).
            return infos
        if self.info.last_update > auth:
            self._rollback_to(auth)
        divergent_peers = [o for o, lu in lus.items()
                           if o != self.osd.whoami and lu > auth]
        if divergent_peers:
            reps = self.osd.rpc(
                [(o, m.MPGRollback(self.pgid, self.osd.epoch(), auth))
                 for o in divergent_peers], timeout=10.0)
            for rep in reps:
                if isinstance(rep, m.MPGInfo):
                    src = rep.src.num if rep.src else -1
                    if src >= 0:
                        infos[src] = rep.info
        return infos

    def _in_log(self, entry: LogEntry) -> bool:
        """Whether this very entry is still in the log (or trimmed below
        its tail, which only an entry that stayed can be); after a
        rewind its version may have been minted again for another."""
        v = entry.version
        if v <= self.log.tail:
            return True
        for en in reversed(self.log.entries):
            if en.version <= v:
                return en is entry
        return False

    def _rollback_to(self, target: EVersion) -> None:
        """Rewind the local log above `target`, undoing each divergent
        entry's shard mutations from its persisted rollback records
        (newest first, so the final image is the pre-divergence one).
        An entry with no usable record falls back to the old
        convergence path: its object is marked missing and recovery
        re-replicates it."""
        from ceph_tpu_torch.osd.pglog import _logkey, rollback_prefix

        with self.lock:
            divergent = self.log.rewind_to(target)
            if self.info.last_update > target:
                self.info.last_update = target
            if self.info.last_complete > self.info.last_update:
                self.info.last_complete = self.info.last_update
            if not divergent:
                self._persist_meta()
                return
            n = (self.backend.k + self.backend.m if self.is_ec()
                 else len(self.acting))
            meta_omap = None
            if self.is_ec():
                from ceph_tpu_torch.osd.backend import _meta_oid

                # one fetch for the whole rewind: per-entry re-reads
                # of the full pg-meta omap made a multi-entry rollback
                # O(entries x log size) right when the PG is peering
                meta_omap = self.backend.store.omap_get(
                    self.backend.coll, _meta_oid())
            fallback_rm: List[str] = []
            for en in divergent:  # newest first
                fp.failpoint("pg.rollback.entry", oid=en.oid,
                             version=str(en.version))
                if not self.backend.roll_back_entry(en, meta_omap):
                    # no record: local state for this object is suspect
                    # — recovery must re-replicate it
                    self.missing.setdefault(en.oid, target)
                    fallback_rm.append(_logkey(en.version))
                    fallback_rm += [rollback_prefix(en.version) + str(s)
                                    for s in range(n)]
            if fallback_rm:
                t = Transaction()
                t.omap_rmkeys(self.coll, GHObject("_pgmeta_"),
                              fallback_rm)
                self.osd.store.queue_transaction(t)
            self._persist_meta()
            self._reindex_reqids()
            # forensic channel: the acked-durability oracle joins a
            # lost granule to the rewind that destroyed it
            ROLLBACK_EVENTS.append({
                "time": time.time(), "osd": self.osd.whoami,
                "pg": t_.pgid_str(self.pgid), "target": str(target),
                "entries": [(en.oid, str(en.version), en.op)
                            for en in divergent],
            })
            self.osd._log(1, f"pg {t_.pgid_str(self.pgid)}: rolled back "
                             f"{len(divergent)} divergent entries to "
                             f"{target}")
        # rolled-back objects must not serve from the context cache
        self._obc_invalidate()

    def handle_rollback(self, msg: m.MPGRollback, conn) -> None:
        """Peer side of divergent-entry rollback: the primary's
        authoritative log never saw our newest entries.  Replies with
        our post-rollback info so the primary's peer view refreshes
        without a second query round."""
        with self.lock:
            stale = msg.epoch < self.interval_epoch
        if not stale:
            self._rollback_to(msg.to_version)
        rep = m.MPGInfo(self.pgid, self.osd.epoch(), self.info, [])
        rep.tid = msg.tid
        conn.send(rep)

    def _ack_caught_up(self, reached: Dict[int, EVersion]) -> None:
        """A replicated write in flight across an interval change waits
        for good on an ack that never comes: a replica that detected
        the new interval first drops the old interval's MOSDRepOp
        unapplied and unanswered (``handle_rep_op``), and the new
        interval's laggard push is what brings it the entry (F13).
        ``reached`` is the version each acting peer is known to hold
        (the info it answered, or the head a push brought it to): count
        it as having acked every write at or below that version whose
        entry is still in this log.  A write whose entry a newer
        authoritative log rewound is dropped unanswered, as the EC
        fan-out drops one (``_rewound``): its version may have been
        minted again for another write, which is what the peers hold.
        Its reqid mark goes with it, so the client's resend runs."""
        if self.is_ec() or not self.is_primary():
            return
        with self.lock:
            acting = set(self.acting)
        for tid, op in list(self.backend.in_flight.items()):
            if op.entry is None:
                continue
            if not self._in_log(op.entry):
                self.backend.in_flight.pop(tid, None)
                if op.entry.reqid:
                    with self._pipe_lock:
                        self._inflight_reqids.pop(op.entry.reqid, None)
                self.osd._log(1, f"pg {t_.pgid_str(self.pgid)}: in-flight "
                                 f"write of rewound entry "
                                 f"{op.entry.version} dropped")
                continue
            for who in set(op.waiting_on) & acting:
                if who in reached and reached[who] >= op.entry.version:
                    op.ack(who)

    def _push_laggards(self, infos: Dict[int, PGInfo]) -> None:
        reached: Dict[int, EVersion] = {}  # what each peer now holds
        for osd_id, info in infos.items():
            if osd_id not in self.acting:
                continue  # strays are not pushed forward (they drain)
            head = self.info.last_update
            if info.last_update >= head:
                reached[osd_id] = info.last_update
                continue
            changed = self.log.objects_changed_after(info.last_update)
            names = (self.backend.object_names() if changed is None
                     else list(changed))
            ok = True
            if changed is None:
                # the laggard fell beyond our log window: it may hold
                # objects deleted outside the window — push explicit
                # deletions or backfill resurrects them (the reference's
                # backfill removes objects absent from the authoritative
                # set)
                peer_names = self.osd.list_peer_objects(self, osd_id)
                if peer_names is None:
                    ok = False  # couldn't list: keep the peer stale
                else:
                    for oid in sorted(peer_names - set(names)):
                        ok = self.push_delete(oid, osd_id) and ok
            # every object push takes a recovery slot: concurrent PG
            # recoveries on this OSD are throttled, not unbounded
            # (reference AsyncReserver + osd_recovery_max_active).  A
            # reservation timeout just leaves the peer stale for this
            # round (retried on the next map/activate) — it must never
            # unwind activation of the remaining PGs
            reserver = getattr(self.osd, "recovery_reserver", None)
            for oid in names:
                if reserver is not None:
                    if not reserver.reserve(timeout=30.0):
                        ok = False
                        continue
                    try:
                        ok = self.push_object(oid, osd_id) and ok
                    finally:
                        reserver.release()
                else:
                    ok = self.push_object(oid, osd_id) and ok
            with self.lock:
                if ok:
                    self.stale_peers.discard(osd_id)
                    reached[osd_id] = head
                elif osd_id in self.stale_peers:
                    # retried from the info it answered: a push that
                    # landed meanwhile may have moved its last_update
                    # past an object that did not
                    self._laggard_retry[osd_id] = info
        self._ack_caught_up(reached)

    def _push_timeout_s(self) -> float:
        try:
            return float(
                self.osd.ctx.conf.get("osd_recovery_push_timeout"))
        except Exception:
            return 30.0  # bare-stub osds in unit tests

    def push_delete(self, oid: str, to_osd: int) -> bool:
        msg = m.MPGPush(self.pgid, self.osd.epoch(), oid, self.log.head,
                        deleted=True, shard=-1)
        reps = self.osd.rpc([(to_osd, msg)],
                            timeout=self._push_timeout_s())
        return any(isinstance(r, m.MPGPushReply) for r in reps)

    def push_object(self, oid: str, to_osd: int) -> bool:
        """Push the authoritative copy of one object to a peer in
        resumable chunks; True once the peer acked every chunk (reads
        may then trust its shards again).

        Before sending, the peer is probed for prior progress at this
        version (an interrupted recovery resumes mid-object instead of
        restarting — reference ObjectRecoveryProgress.data_recovered_to,
        ECBackend.cc:590-620)."""
        whole = self._build_pushes(oid, to_osd)
        if not whole:
            return False
        chunk = int(self.osd.ctx.conf.get("osd_recovery_chunk_size"))
        msgs: List[m.MPGPush] = []
        for msg in whole:
            if msg.deleted or len(msg.data) <= chunk:
                msgs.append(msg)
                continue
            start = 0
            probes = self.osd.rpc(
                [(to_osd, m.MPGRecoveryProbe(
                    self.pgid, self.osd.epoch(), oid, msg.version,
                    msg.shard))], timeout=10.0)
            for rep in probes:
                if isinstance(rep, m.MPGRecoveryProbeReply):
                    start = min(rep.recovered_to, len(msg.data))
            total = len(msg.data)
            offs = list(range(start, total, chunk)) or [start]
            for off in offs:
                part = msg.data[off: off + chunk]
                msgs.append(m.MPGPush(
                    self.pgid, self.osd.epoch(), oid, msg.version,
                    part, dict(msg.attrs) if off == 0 else {},
                    dict(msg.omap) if off == 0 else {},
                    shard=msg.shard, off=off, total=total,
                    more=off + len(part) < total))
        reps = self.osd.rpc([(to_osd, msg) for msg in msgs],
                            timeout=self._push_timeout_s())
        return sum(1 for r in reps
                   if isinstance(r, m.MPGPushReply)) >= len(msgs)

    def _build_pushes(self, oid: str, to_osd: int) -> List[m.MPGPush]:
        state = self._read_state_sync(oid)
        if state is None and not self._known_deleted(oid):
            # "couldn't read it right now" is NOT "it doesn't exist":
            # pushing a deletion here destroyed the SURVIVING shards of
            # objects that were merely unreconstructable mid-churn
            # (< k chunks reachable) — found by the EC thrash hunt.
            # Push nothing; recovery retries when more shards return.
            return []
        if not self.is_ec():
            return [self._push_msg(oid, state, shard=-1)]
        n = self.backend.k + self.backend.m
        acting = list(self.acting[:n])
        shards = [i for i, o in enumerate(acting) if o == to_osd]
        if not shards:
            return []
        if state is None:
            return [self._push_msg(oid, None, shard=shards[0])]
        chunks, _ = self.backend._encode_object(state.data)
        out = []
        for shard in shards:
            attrs = dict(state.xattrs)
            attrs["_size_hint"] = len(state.data).to_bytes(8, "little")
            attrs["_av"] = self._av_for(oid)
            out.append(m.MPGPush(
                self.pgid, self.osd.epoch(), oid, self.log.head,
                chunks[shard], attrs, dict(state.omap), shard=shard))
        return out

    def _av_for(self, oid: str) -> bytes:
        """Attr-version stamp for recovery-written shards: recovered
        attrs are as new as the object's latest log version (without
        this, every recovered shard is unstamped and the _av meta
        ranking stops protecting attrs after any recovery)."""
        from ceph_tpu_torch.osd.backend import _av_stamp

        with self.lock:
            en = self.log.latest_for(oid)
            return _av_stamp(en.version if en is not None
                             else self.log.head)

    def _known_deleted(self, oid: str) -> bool:
        """True only when the log's newest word on `oid` is a DELETE —
        the sole justification for propagating a deletion push."""
        with self.lock:
            en = self.log.latest_for(oid)
            return en is not None and en.op == t_.LOG_DELETE

    def _read_state_sync(self, oid: str, timeout: float = 30.0,
                         raw_retry: bool = False
                         ) -> Optional[ObjectState]:
        """raw_retry=True returns the READ_RETRY sentinel for
        ambiguous reads (current holders unresponsive, or wait
        timeout) instead of None — "couldn't read right now" must
        never masquerade as "doesn't exist" on a path that acts on
        absence (the RMW write base state; the open thrash-hunt
        divergence is the suspected consequence)."""
        done = threading.Event()
        box: List[Optional[ObjectState]] = [None]

        def got(st):
            box[0] = st
            done.set()

        self._get_state(oid, got)
        ok = done.wait(timeout)
        st = box[0]
        if st is READ_RETRY or not ok:
            return READ_RETRY if raw_retry else None
        return st

    def _push_msg(self, oid: str, state: Optional[ObjectState],
                  shard: int) -> m.MPGPush:
        if state is None:
            return m.MPGPush(self.pgid, self.osd.epoch(), oid,
                             self.log.head, deleted=True, shard=shard)
        return m.MPGPush(self.pgid, self.osd.epoch(), oid,
                         self.log.head, state.data,
                         dict(state.xattrs), dict(state.omap), shard=shard)

    def handle_push(self, msg: m.MPGPush, conn) -> None:
        """Apply a recovery push (replica or recovering primary)."""
        # the push rewrites this object outside the op path: any cached
        # context (incl. one an in-flight read is about to insert) is
        # suspect
        self._obc_invalidate(msg.oid)
        with self.lock:
            t = Transaction()
            g = GHObject(msg.oid, shard=msg.shard)
            if msg.deleted:
                # remove every form this name can take locally: the
                # replica object, the pushed shard, and (for EC) every
                # shard id — a shard=-1 deletion push must clear EC
                # shard objects too
                t.try_remove(self.coll, GHObject(msg.oid))
                if msg.shard >= 0:
                    t.try_remove(self.coll, g)
                if self.is_ec():
                    n = self.backend.k + self.backend.m
                    for s in range(n):
                        t.try_remove(self.coll, GHObject(msg.oid, shard=s))
            else:
                final = not msg.more
                if msg.off == 0:
                    # replace semantics: stale xattrs must not survive
                    # the recovered copy (setattrs merges)
                    t.try_remove(self.coll, g)
                t.write(self.coll, g, msg.off, msg.data)
                if msg.off == 0:
                    attrs = dict(msg.attrs)
                    size = attrs.pop("_size_hint", None)
                    if size is not None:
                        # kept as a real xattr until the final chunk
                        # (the EC hinfo needs it then)
                        attrs["_size_hint"] = size
                    t.setattrs(self.coll, g, attrs)
                    # no omap_clear: the try_remove above already
                    # dropped every old key
                    if msg.omap:
                        t.omap_setkeys(self.coll, g, msg.omap)
                if not final:
                    # persisted resumable progress (survives our restart)
                    e = Encoder()
                    msg.version.encode(e)
                    e.u64(msg.off + len(msg.data))
                    t.setattrs(self.coll, g, {"_rprogress": e.bytes()})
                else:
                    t.rmattr(self.coll, g, "_rprogress")
            self.osd.store.queue_transaction(t)
            if not msg.deleted and not msg.more and msg.shard >= 0 \
                    and self.is_ec():
                # final chunk of an EC shard: hinfo crc over the WHOLE
                # chunk now on disk
                from ceph_tpu_torch.osd.backend import _hinfo

                full = self.osd.store.read(self.coll, g)
                try:
                    size_b = self.osd.store.getattr(
                        self.coll, g, "_size_hint")
                    obj_size = int.from_bytes(size_b, "little")
                except Exception:
                    obj_size = len(full) * self.backend.k
                t2 = Transaction()
                t2.setattrs(self.coll, g, {"hinfo": _hinfo(full, obj_size)})
                t2.rmattr(self.coll, g, "_size_hint")
                self.osd.store.queue_transaction(t2)
            if msg.deleted or not msg.more:
                # object fully recovered (partial chunks keep it missing)
                if msg.version > self.info.last_update:
                    self.info.last_update = msg.version
                    self.info.last_complete = msg.version
                self.missing.pop(msg.oid, None)
                self.unfound.discard(msg.oid)
                self._persist_meta()
            if not msg.deleted:
                self.note_recovery_io(0 if msg.more else 1,
                                      len(msg.data))
        rep = m.MPGPushReply(self.pgid, self.osd.epoch(), msg.oid, 0)
        rep.tid = msg.tid
        conn.send(rep)

    def handle_recovery_probe(self, msg: m.MPGRecoveryProbe, conn) -> None:
        """Answer with persisted partial-push progress for (oid, version)
        — zero when there is none or the version moved on."""
        recovered_to = 0
        g = GHObject(msg.oid, shard=msg.shard)
        try:
            blob = self.osd.store.getattr(self.coll, g, "_rprogress")
            d = Decoder(blob)
            ver = EVersion.decode(d)
            if ver == msg.version:
                recovered_to = d.u64()
        except (StoreError, DecodeError):
            pass  # no/garbled progress marker: recovery starts at 0
        rep = m.MPGRecoveryProbeReply(self.pgid, self.osd.epoch(),
                                      msg.oid, recovered_to)
        rep.tid = msg.tid
        conn.send(rep)

    def handle_query(self, msg: m.MPGQuery, conn) -> None:
        with self.lock:
            ents = self.log.entries_after(msg.since) or []
            rep = m.MPGInfo(self.pgid, self.osd.epoch(), self.info, ents)
            rep.tid = msg.tid
        conn.send(rep)

    # -- scrub ------------------------------------------------------------
    def scrub(self) -> Dict[str, List[str]]:
        """Compare object digests across the acting set; returns
        {oid: [error descriptions]} (empty = clean)."""
        with self.lock:
            assert self.is_primary(), "scrub runs on the primary"
            errors: Dict[str, List[str]] = {}
            if self.is_ec():
                self._scrub_ec(errors)
            else:
                self._scrub_replicated(errors)
            return errors

    def _scrub_replicated(self, errors) -> None:
        maps = self.osd.collect_scrub_maps(self)  # {osd: {oid: digest}}
        all_oids = set()
        for dm in maps.values():
            all_oids |= set(dm)
        for oid in sorted(all_oids):
            digests = {o: dm.get(oid) for o, dm in maps.items()}
            vals = set(digests.values())
            # every copy unreadable is the WORST case, not a clean one
            if len(vals) > 1 or vals == {SCRUB_UNREADABLE}:
                errors[oid] = [
                    f"osd.{o}: digest "
                    + ("missing" if d is None
                       else "unreadable" if d == SCRUB_UNREADABLE
                       else hex(d))
                    for o, d in sorted(digests.items())
                ]

    def _ec_gather(self, oid: str, rpc_timeout: Optional[float] = None):
        """(avail chunks, per-shard (attrs, omap) metas, lost shards)
        across the acting set; remote shard metadata rides the read
        replies, so nothing here depends on the primary holding a
        local shard.  `rpc_timeout` bounds each remote fetch (the
        scrub engine shrinks it: a gather under the pg lock must not
        pin client writes for a dead peer's full RPC window)."""
        be: ECBackend = self.backend  # type: ignore[assignment]
        n = be.k + be.m
        acting = list(self.acting[:n])
        avail: Dict[int, bytes] = {}
        metas: Dict[int, Tuple[Dict[str, bytes], Dict[str, bytes]]] = {}
        lost: List[int] = []
        omap_ = self.osd.osdmap
        for shard, osd_id in enumerate(acting):
            if osd_id in (CRUSH_ITEM_NONE, -1):
                continue
            if (osd_id != self.osd.whoami and omap_ is not None
                    and not omap_.is_up(osd_id)):
                # a down holder can never answer: count the shard lost
                # NOW instead of burning the RPC window per shard (the
                # scrub engine holds the pg lock across this gather)
                lost.append(shard)
                continue
            if osd_id == self.osd.whoami:
                c = be.read_local_chunk(oid, shard)
                if c is None:
                    lost.append(shard)
                else:
                    avail[shard] = c
                    metas[shard] = be.shard_meta(oid, shard)
            else:
                full = self.osd.fetch_remote_chunk_full(
                    self, osd_id, shard, oid, timeout=rpc_timeout)
                if full is None:
                    lost.append(shard)
                else:
                    avail[shard] = full[0]
                    metas[shard] = (full[1], full[2])
        return avail, metas, lost

    def _scrub_ec(self, errors) -> None:
        be: ECBackend = self.backend  # type: ignore[assignment]
        n = be.k + be.m
        acting = list(self.acting[:n])
        for oid in be.object_names():
            avail, metas, lost = self._ec_gather(oid)
            bad = [f"shard {s} (osd.{acting[s]}): missing or crc mismatch"
                   for s in lost]
            # deep-scrub analog: decode from k and re-encode to verify
            # parity consistency
            if len(avail) >= be.k and not bad:
                st = be.reconstruct(oid, avail,
                                    meta=metas[min(avail)])
                if st is not None:
                    chunks, _ = be._encode_object(st.data)
                    for shard, have in avail.items():
                        if chunks[shard][: len(have)] != have:
                            bad.append(f"shard {shard}: parity mismatch")
            if bad:
                errors[oid] = bad

    # -- scrub repair (reference repair/auto_repair scrub mode,
    # src/osd/PG.cc:5042, PG.h:1586,1591) -------------------------------
    def repair(self) -> Dict[str, List[str]]:
        """Scrub, rewrite divergent replicas/shards from the
        authoritative copy, re-scrub to verify.  Returns the POST-repair
        scrub errors (empty = everything repaired clean)."""
        with self.lock:
            assert self.is_primary(), "repair runs on the primary"
        if self.is_ec():
            self._repair_ec()
        else:
            self._repair_replicated()
        return self.scrub()

    def _note_read_verify_fail(self, oid: str, where) -> None:
        """A read-path at-rest checksum failure (store extent seals or
        hinfo crc) was decoded around: count it, attribute it to
        health, and queue the object for targeted auto-repair.
        `where` lists the (shard, holder-osd) pairs that answered
        ECRC.  Runs on the primary's read path — the client already
        got correct bytes via reconstruction; everything here is
        attribution + healing.  Dedup per object: a hot object re-read
        before the repair (or the next scrub) lands must not re-bump
        scrub_errors or stack repair threads."""
        with self.lock:
            if oid in self._read_repair_pending:
                return
            self._read_repair_pending.add(oid)
            # feeds the PGStat tail -> mon PG_DAMAGED, exactly like a
            # deep-scrub finding; a successful auto-repair below (or
            # the next scrub's ground-truth recount) takes it back down
            self.scrub_errors += 1
        who = ", ".join(f"shard {s} (osd.{o})" for s, o in sorted(set(where)))
        self.osd.ctx.log.cluster(
            "ERR", f"pg {self.pgid} read of {oid}: at-rest checksum "
                   f"failure on {who}; served via reconstruction, "
                   f"queued for repair")
        if not bool(self.osd.ctx.conf.get("osd_scrub_auto_repair")):
            # operator-driven repair policy: the object stays counted
            # (PG_DAMAGED raised) until a repair or scrub settles it
            return

        def _run() -> None:
            ok = False
            got_guard = self.maintenance_guard.acquire(timeout=30.0)
            if not got_guard:
                # a scrub/repair pass owns the window: it will see the
                # damage itself; stay counted, clear pending so a later
                # read can retry the repair
                with self.lock:
                    self._read_repair_pending.discard(oid)
                return
            try:
                self.repair_objects([oid], rpc_timeout=5.0)
                ok = True
            except Exception as e:  # noqa: BLE001 — healing is best-
                # effort; the scrub pipeline remains the backstop
                self.osd._log(1, f"pg {self.pgid}: read-repair of "
                                 f"{oid} failed: {e!r}")
            finally:
                self.maintenance_guard.release()
                with self.lock:
                    self._read_repair_pending.discard(oid)
                    if ok and self.scrub_errors > 0:
                        self.scrub_errors -= 1

        threading.Thread(
            target=_run, daemon=True,
            name=f"pg{t_.pgid_str(self.pgid)}-readrepair").start()

    def repair_objects(self, oids: List[str],
                       rpc_timeout: float = 30.0) -> None:
        """Targeted repair of a known-inconsistent object list (the
        ScrubEngine auto-repair entry): same consensus + replace-
        semantics write-back as repair(), without re-walking the whole
        PG.  Verification is the caller's job.  `rpc_timeout` bounds
        each repair push (the scrub engine shrinks it: a push to a
        peer that died after the gather must not pin the pg lock for
        the full RPC window — the chaos-matrix client-op-timeout
        class)."""
        with self.lock:
            assert self.is_primary(), "repair runs on the primary"
        if self.is_ec():
            self._repair_ec(oids, rpc_timeout=rpc_timeout)
        else:
            self._repair_replicated(oids)

    def _repair_replicated(self,
                           only: Optional[List[str]] = None) -> None:
        """Authoritative state = majority vote over every copy's
        observation — a real digest, "absent" (None: a missed delete is
        a legitimate winner; resurrecting deleted objects from one
        stale copy is the classic repair bug), or "unreadable"
        (SCRUB_UNREADABLE: votes exists, never wins).  Digest ties
        prefer the primary's copy; a tie between "absent" and a digest
        is ambiguous and skipped.  The primary repairs itself first
        (pull from an authoritative peer), then pushes to every
        divergent peer (reference auth-selection + repair shape,
        PrimaryLogPG::_scrub / PG.cc:5042)."""
        from collections import Counter

        maps = self.osd.collect_scrub_maps(self)
        all_oids = set()
        for dm in maps.values():
            all_oids |= set(dm)
        if only is not None:
            all_oids &= set(only)
        for oid in sorted(all_oids):
            digests = {o: dm.get(oid) for o, dm in maps.items()}
            if len(set(digests.values())) <= 1:
                continue
            # candidates: real digests and "absent"; unreadable copies
            # vote for repair-needed but can never be authoritative
            counts = Counter(d for d in digests.values()
                             if d != SCRUB_UNREADABLE)
            if not counts:
                continue  # unreadable everywhere: unrepairable
            top = counts.most_common(1)[0][1]
            tied = [d for d, c in counts.items() if c == top]
            if None in tied:
                if len(tied) > 1:
                    continue  # absent vs digest dead heat: refuse
                auth_digest = None
            else:
                mine = digests.get(self.osd.whoami)
                auth_digest = (mine if mine in tied
                               else sorted(tied)[0])
            divergent = sorted(o for o, d in digests.items()
                               if d != auth_digest)
            if auth_digest is None:
                self._repair_to_deleted(oid, divergent, digests)
                continue
            auth_osds = sorted(o for o, d in digests.items()
                               if d == auth_digest)
            if self.osd.whoami in divergent:
                # heal the primary first: ask an authoritative peer to
                # push its copy to us (the MPGPull recovery channel) —
                # UNLOCKED, our own handle_push needs the PG lock
                self._obc_invalidate(oid)
                self.osd.rpc([(auth_osds[0], m.MPGPull(
                    self.pgid, self.osd.epoch(), [oid]))], timeout=30.0)
            with self.lock:
                # serialize write-back against the client op path
                # (reference write_blocked_by_scrub): a client write
                # since the scrub maps were collected changes the local
                # digest -> skip, the next scrub re-judges
                if self._local_object_digest(oid) != auth_digest:
                    continue
                for osd_id in divergent:
                    if osd_id != self.osd.whoami:
                        self.push_object(oid, osd_id)

    def _repair_to_deleted(self, oid: str, holders: List[int],
                           observed: Dict[int, Optional[int]]) -> None:
        """Majority says the object does not exist: remove the stale
        copies (the anti-resurrection half of repair)."""
        with self.lock:
            # all client writes route through this primary: if OUR state
            # moved since the scrub maps were collected, a write/create
            # raced the repair and the deletion vote is stale
            if self._local_object_digest(oid) != \
                    observed.get(self.osd.whoami):
                return
            for osd_id in holders:
                if osd_id == self.osd.whoami:
                    self._obc_invalidate(oid)
                    t = Transaction()
                    t.try_remove(self.coll, GHObject(oid))
                    self.osd.store.queue_transaction(t)
                else:
                    self.osd.rpc([(osd_id, m.MPGPush(
                        self.pgid, self.osd.epoch(), oid, self.log.head,
                        deleted=True, shard=-1))], timeout=30.0)

    def _repair_ec(self, only: Optional[List[str]] = None,
                   rpc_timeout: float = 30.0) -> None:
        be: ECBackend = self.backend  # type: ignore[assignment]
        n = be.k + be.m
        oids = be.object_names() if only is None else \
            [o for o in be.object_names() if o in set(only)]
        for oid in oids:
            # the whole per-object gather->consensus->write-back runs
            # under the PG lock so client writes (which take it in
            # _do_write) cannot interleave and leave a mixed-generation
            # stripe (reference write_blocked_by_scrub; peers answer
            # sub-reads/pushes without taking THEIR primary-side lock,
            # so holding ours across the RPCs cannot deadlock — scrub
            # already relies on this)
            with self.lock:
                acting = list(self.acting[:n])
                avail, metas, lost = self._ec_gather(
                    oid, rpc_timeout=rpc_timeout)
                state, inconsistent = self._ec_consensus(oid, avail, metas)
                if state is None:
                    continue  # clean PG has nothing in `lost` either
                bad = sorted(set(lost) | inconsistent)
                if not bad:
                    continue
                chunks, _ = be._encode_object(state.data)
                for shard in bad:
                    osd_id = acting[shard]
                    if osd_id in (CRUSH_ITEM_NONE, -1):
                        continue
                    self._write_repaired_shard(oid, shard, osd_id,
                                               chunks[shard], state,
                                               rpc_timeout=rpc_timeout)

    def _ec_consensus(self, oid: str, avail: Dict[int, bytes],
                      metas: Dict[int, Tuple[Dict[str, bytes],
                                             Dict[str, bytes]]]
                      ) -> Tuple[Optional[ObjectState], set]:
        """Decode + re-encode to find shards inconsistent with the
        consensus content.

        A corrupt-but-crc-valid shard inside the decode set poisons the
        decode: the re-encode then reproduces the corrupt inputs
        exactly and mismatches the HEALTHY shards instead, so the raw
        mismatch set of any single decode cannot be trusted.  Instead
        every leave-one-out decode proposes an explanation, and the one
        consistent with the MOST shards wins (for one bad shard, the
        true explanation keeps len-1 shards consistent; every poisoned
        one keeps <= len-m).  Ambiguity — tied explanations, as with
        m=1 parity where content alone cannot say which side is wrong —
        refuses rather than guesses."""
        be: ECBackend = self.backend  # type: ignore[assignment]
        ids = sorted(avail)
        if len(ids) < be.k:
            return None, set()

        def check(subset):
            # meta (size/attrs) from a shard inside the hypothesis's
            # trusted subset, NOT the primary's local shard
            st = be.reconstruct(oid, {i: avail[i] for i in subset},
                                meta=metas[subset[0]])
            if st is None:
                return None, set()
            enc, _ = be._encode_object(st.data)
            return st, {s for s in ids if enc[s][: len(avail[s])]
                        != avail[s]}

        st, mism = check(ids[: be.k])
        if st is not None and not mism:
            return st, set()
        best = None  # (n_consistent, state, bad_set)
        ambiguous = False
        seen_subsets = {tuple(ids[: be.k])}
        if st is not None and len(mism) <= be.m:
            best = (len(ids) - len(mism), st, mism)
        for x in ids:
            rest = tuple([i for i in ids if i != x][: be.k])
            if rest in seen_subsets:
                continue  # x beyond the first k re-derives ids[:k]
            seen_subsets.add(rest)
            st2, mism2 = check(rest)
            if st2 is None or len(mism2) > be.m:
                continue
            score = len(ids) - len(mism2)
            if best is None or score > best[0]:
                best = (score, st2, mism2)
                ambiguous = False
            elif score == best[0] and mism2 != best[2]:
                ambiguous = True
        if best is None or ambiguous:
            return None, set()
        return best[1], best[2]

    def _write_repaired_shard(self, oid: str, shard: int, osd_id: int,
                              chunk: bytes, state: ObjectState,
                              rpc_timeout: float = 30.0) -> None:
        from ceph_tpu_torch.osd.backend import _hinfo

        omap_ = self.osd.osdmap
        if (osd_id != self.osd.whoami and omap_ is not None
                and not omap_.is_up(osd_id)):
            # the holder died after the gather: recovery owns its
            # catch-up; a push RPC would only burn the timeout window
            return
        self._obc_invalidate(oid)
        if osd_id == self.osd.whoami:
            g = GHObject(oid, shard=shard)
            t = Transaction()
            t.try_remove(self.coll, g)
            t.touch(self.coll, g)
            t.write(self.coll, g, 0, chunk)
            attrs = dict(state.xattrs)
            attrs["hinfo"] = _hinfo(chunk, len(state.data))
            attrs["_av"] = self._av_for(oid)
            t.setattrs(self.coll, g, attrs)
            if state.omap:
                t.omap_setkeys(self.coll, g, state.omap)
            self.osd.store.queue_transaction(t)
            return
        attrs = dict(state.xattrs)
        attrs["_size_hint"] = len(state.data).to_bytes(8, "little")
        attrs["_av"] = self._av_for(oid)
        self.osd.rpc([(osd_id, m.MPGPush(
            self.pgid, self.osd.epoch(), oid, self.log.head,
            chunk, attrs, dict(state.omap), shard=shard))],
            timeout=rpc_timeout)

    def _local_object_digest(self, oid,
                             deep: bool = True) -> Optional[int]:
        """Digest of one local object; None when absent,
        SCRUB_UNREADABLE when the store refuses the read.

        deep=True digests (data, xattrs, omap) — the byte-reading map.
        deep=False digests METADATA only — logical size, the ``_av``
        attr-version stamp, user attrs and omap, with NO data read and
        the per-shard fields (hinfo crc, recovery progress markers)
        excluded so every shard/replica of one healthy object
        fingerprints identically.  Silent data rot passes the shallow
        digest by construction; that is deep scrub's job."""
        g = oid if isinstance(oid, GHObject) else GHObject(oid)
        if not self.osd.store.exists(self.coll, g):
            return None
        if deep:
            try:
                data = self.osd.store.read(self.coll, g)
            except Exception:
                return SCRUB_UNREADABLE
            d = crc32c(data)
        else:
            # logical size: from hinfo for EC shards (the shard's stat
            # is chunk-sized), from stat for replicas — no data read
            try:
                attrs0 = self.osd.store.getattrs(self.coll, g)
            except Exception:
                return SCRUB_UNREADABLE
            size = None
            if "hinfo" in attrs0:
                from ceph_tpu_torch.osd.backend import hinfo_decode

                try:
                    size, _, _ = hinfo_decode(attrs0["hinfo"])
                except Exception:
                    return SCRUB_UNREADABLE
            if size is None:
                try:
                    size = self.osd.store.stat(self.coll, g)
                except Exception:
                    return SCRUB_UNREADABLE
            d = crc32c(size.to_bytes(8, "little"))
        skip = () if deep else ("hinfo", "_size_hint", "_rprogress")
        for k in sorted(self.osd.store.getattrs(self.coll, g)):
            if k in skip:
                continue
            d = crc32c(k.encode(), d)
            d = crc32c(self.osd.store.getattr(self.coll, g, k), d)
        om = self.osd.store.omap_get(self.coll, g)
        for k in sorted(om):
            d = crc32c(k.encode(), d)
            d = crc32c(om[k], d)
        return d

    def local_scrub_map(self, deep: bool = True
                        ) -> Tuple[Dict[str, int], List[str]]:
        """(oid -> digest, [unreadable oids]) — deep maps digest data
        + metadata, shallow maps metadata only (see
        _local_object_digest).  An object the store itself refuses to
        read (at-rest csum failure) lands in the unreadable list: it
        still votes "exists" during repair auth selection but can
        never be authoritative — and a PG where EVERY copy is
        unreadable scrubs inconsistent, not clean."""
        out: Dict[str, int] = {}
        unreadable: List[str] = []
        for o in self.osd.store.collection_list(self.coll):
            if o.name == "_pgmeta_":
                continue
            d = self._local_object_digest(o, deep=deep)
            if d == SCRUB_UNREADABLE:
                unreadable.append(o.name)
            elif d is not None:
                out[o.name] = d
        return out, unreadable
