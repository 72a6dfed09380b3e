"""PGBackend family: primary-copy replication and EC stripe fan-out.

Port of ``ceph_tpu/osd/backend.py``.  The names, the bytes on the wire
and in the store, the lockdep names and the failpoints are the
reference's.  What the port does its own way:

- the queue is ``default_queue(codec.device)``: a codec built with
  ``device="cpu"`` runs the plain versions, one built with no device
  runs on the card (and could not be built without one);
- a degraded read rides the queue's ``dec`` kind only when the codec's
  recovery is one MDS matrix product (``codec.mds_recovery``: the RS
  codecs); a bit-matrix code and shec decode through ``codec.decode``
  (the reference tests ``recovery_matrix`` at backend.py:1227,1325,
  which sends shec to a batch it cannot run: ROADMAP R2);
- a write rides the queue only when the codec has ``encode_planes``;
  lrc encodes through ``codec.encode_array`` on the fan-out executor
  (the reference sends every codec to the queue, and the port's queue
  refuses lrc: ROADMAP R4), and its shards follow its chunk mapping
  (``data_ids``);
- clay, the one codec with sub-chunks (an array codec), pads its planes
  to whole sub-chunks, writes through the queue's ``encp`` kind laid
  along the sub-chunk byte axis, degraded-reads through ``cdec`` and
  repairs one lost shard from its helpers' repair layers through
  ``crep`` (``repair_chunk_async``); ``assemble_range`` refuses its
  extents (a chunk extent has no sub-chunk structure).

On the device write path the queue's ``encp`` batch computes the coding
planes and every shard's CRC-32C together, each shard's ``hinfo`` takes
that CRC, and the primary's own shards land in its store through
``op_payload`` before the payload's ``seal()``.

Reference seams: PGBackend (src/osd/PGBackend.h), ReplicatedBackend
(src/osd/ReplicatedBackend.{h,cc}) and ECBackend
(src/osd/ECBackend.{h,cc}).  The PG hands a backend the *full new
object state* per write (an RMW discipline: the reference's EC pipeline
likewise reads stripe remnants before encoding, ECBackend.cc:1817
try_state_to_reads); the backend owns distribution:

- ReplicatedBackend: one ObjectStore transaction carrying the object
  state + pg log entries, applied locally and shipped verbatim to every
  replica (MOSDRepOp; reference submit_transaction ->
  issue_op -> sub_op_modify).
- ECBackend: the object buffer is padded and split into k data chunks,
  coding chunks come back from the stripe-batch queue ASYNCHRONOUSLY
  (encode_async: N concurrent writes' planes coalesce into ONE device
  matmul — the point of the StripeBatchQueue), and the fan-out runs in
  the future's callback: each PEER gets one MECSubWriteVec carrying a
  single merged transaction for ALL of its shards (chunk payloads +
  per-shard HashInfo crc xattrs, reference ECUtil.h:101) — one
  message, one rollback-capture pass, one WAL append, one commit ack
  per peer per write (ECBackend.cc:1997-2035 fan-out, :880
  handle_sub_write).  A per-PG fan-out sequencer keeps dispatch in
  version order even when some writes skip the encode (deletes), so
  per-connection FIFO delivery preserves the replica-log ordering the
  old synchronous path got for free.

Completion: an op commits when every PEER (not every shard) acked
(all_commit discipline of try_finish_rmw, ECBackend.cc:2050).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ceph_tpu_torch.core.crc import crc32c
from ceph_tpu_torch.core.encoding import Decoder, Encoder
from ceph_tpu_torch.core import failpoint as fp
from ceph_tpu_torch.core.lockdep import make_lock
from ceph_tpu_torch.osd import messages as m
from ceph_tpu_torch.osd.types import EVersion, LogEntry, PGId
from ceph_tpu_torch.store.objectstore import (
    ChecksumError,
    Collection,
    GHObject,
    Transaction,
)
from ceph_tpu_torch.gpu.queue import default_queue
from ceph_tpu_torch.gpu.staging import DeviceBuf

CRUSH_ITEM_NONE = 0x7FFFFFFF

# Local-read verdicts (read_local_chunk2 / read_local_chunk_extent2).
# ECRC (EILSEQ) distinguishes "the bytes are HERE but failed at-rest
# checksum verification" from a plain missing shard: both reconstruct
# from peers, but a crc failure is silent corruption caught at read
# time and must be counted, health-attributed and queued for repair.
ECRC = -84
EIO_MISSING = -5  # shard absent / unreadable (plain missing, no blame)


# Process-wide fan-out lane: encode futures hand their fan-out
# closures here so the StripeBatchQueue's device worker gets straight
# back to coalescing the next batch.  One worker, FIFO — combined with
# the per-PG sequencer tickets this preserves version-ordered dispatch;
# the closures only queue store transactions (return after apply) and
# stage messenger sends, so nothing here blocks on network round-trips.
# Submitted fns never raise (_fan_run contains its own failures), so
# the swallowed-into-Future exception behavior is moot.
_fanout_exec = None
_fanout_exec_lock = make_lock("backend.fanout_exec_init")


def _fanout_executor():
    global _fanout_exec
    with _fanout_exec_lock:
        if _fanout_exec is None:
            from concurrent.futures import ThreadPoolExecutor

            _fanout_exec = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="pg-fanout")
        return _fanout_exec


class ObjectState:
    """Full logical object content (the RMW working copy)."""

    __slots__ = ("data", "xattrs", "omap")

    def __init__(self, data: bytes = b"",
                 xattrs: Optional[Dict[str, bytes]] = None,
                 omap: Optional[Dict[str, bytes]] = None) -> None:
        self.data = data
        self.xattrs = xattrs or {}
        self.omap = omap or {}


class InFlightOp:
    """One replicated/EC write waiting on shard acks.

    `acked` / `dropped` record HOW the op completed: a completion with
    `dropped` non-empty is a DEGRADED commit — some acting member never
    persisted the entry — and the PG's durable-ack gate must make the
    committed_to watermark outlive this primary before the client may
    learn the write happened (the 0xd403 acked-loss class)."""

    __slots__ = ("waiting_on", "on_commit", "lock", "acked", "dropped",
                 "sent_at", "entry")

    def __init__(self, waiting_on: set, on_commit: Callable[[], None]):
        self.waiting_on = waiting_on
        self.on_commit = on_commit
        self.lock = make_lock("backend.inflight")
        self.acked: set = set()
        self.dropped: set = set()
        # per-peer send stamps (fan-out RTT attribution): filled by
        # the fan-out just before each peer send
        self.sent_at: Dict = {}
        # the write's log entry (replicated writes): a peer holds it
        # once peering has pushed it to the primary's head, while the
        # entry itself is still in the primary's log
        self.entry = None

    def ack(self, who) -> None:
        fire = False
        with self.lock:
            if who in self.waiting_on:  # a late ack from a peer that
                self.waiting_on.discard(who)  # drop_missing already
                self.acked.add(who)           # removed must not re-fire
                fire = not self.waiting_on
        if fire:
            self.on_commit()

    def drop_missing(self, is_alive: Callable[[object], bool]) -> None:
        """Stop waiting on peers the map no longer lists as alive — a
        dead replica can never ack, and its copy is recovered by peering
        when it returns (the reference requeues in-flight ops on
        interval change; completing with the surviving set is the
        all_commit outcome of that requeue)."""
        fire = False
        with self.lock:
            dead = {w for w in self.waiting_on if not is_alive(w)}
            if dead:
                self.waiting_on -= dead
                self.dropped |= dead
                fire = not self.waiting_on
        if fire:
            self.on_commit()


def _fire_commit(cb: Callable, op: InFlightOp) -> None:
    """Completion trampoline: a callback marked ``wants_acked = True``
    receives the op's completion evidence (who acked, who was dropped
    dead) so the PG can gate degraded acks on watermark durability;
    plain callbacks (tests, tools, replica acks) fire unchanged."""
    if getattr(cb, "wants_acked", False):
        cb(acked=set(op.acked), dropped=set(op.dropped))
    else:
        cb()


class PGBackend:
    """Distribution policy under one PG.

    `osd_send(osd_id, msg)` delivers a message to a peer OSD;
    `whoami` is this OSD's id; `coll` the PG's collection.
    """

    def __init__(self, pgid: PGId, coll: Collection, store, whoami: int,
                 osd_send: Callable[[int, object], None], epoch_fn) -> None:
        self.pgid = pgid
        self.coll = coll
        self.store = store
        self.whoami = whoami
        self.osd_send = osd_send
        self.epoch_fn = epoch_fn
        self.tids = 0
        self.in_flight: Dict[int, InFlightOp] = {}
        self._lock = make_lock("backend.inflight_table")
        # roll-forward watermark provider, bound by the PG to its
        # info.committed_to (rides EC sub-writes so shards learn which
        # entries are beyond divergent rollback)
        self.committed_fn: Callable[[], EVersion] = EVersion
        # the divergent-rewind fence, bound by the PG: `log_fence` is
        # the lock its rewind (_rollback_to) holds, `in_log(entry)` says
        # whether that very entry is still in its log (a version may be
        # minted again after a rewind).  A deferred fan-out asks under
        # the fence before it applies or sends anything: an entry
        # rewound while its encode was queued fans out nowhere (Ceph's
        # ECBackend::on_change drops such writes; the client resends)
        self.log_fence = contextlib.nullcontext()
        self.in_log: Callable[[LogEntry], bool] = lambda entry: True
        # entries this primary minted whose write has stored nothing
        # anywhere yet, by id: submitted, their fan-out not yet past the
        # fence (or their encode failed).  Rewinding one undoes nothing
        self._unfanned: Dict[int, LogEntry] = {}
        # optional perf sinks (the daemon's osd.N.pg counter set, and
        # osd.N.op for the per-peer fan-out RTT histogram) and log
        # hook, all bound by the host PG; no-ops stand alone so unit
        # tests can drive a bare backend
        self.perf = None
        self.op_perf = None
        self.log: Callable[[int, str], None] = lambda lvl, msg: None
        # fan-out sequencer: async encodes complete off-thread, and a
        # write that SKIPS the encode (delete) must not overtake one
        # that is still waiting on the device — per-peer FIFO delivery
        # in version order is what lets replicas keep appending log
        # entries in order (PGLog.append asserts monotonicity)
        self._fan_lock = make_lock("backend.fanout_seq")
        self._fan_tickets = 0
        self._fan_next = 0
        self._fan_pending: Dict[int, Callable[[], None]] = {}

    def roll_back_entry(self, entry: LogEntry,
                        meta_omap: Optional[Dict[str, bytes]] = None
                        ) -> bool:
        """Undo one divergent entry's local mutations from its
        persisted rollback record; False = no record (the caller falls
        back to re-replication).  `meta_omap` lets a multi-entry
        rewind fetch the pg-meta omap once instead of per entry.
        Replicated PGs converge by log/push alone, so only ECBackend
        implements this."""
        return False

    # -- common helpers ---------------------------------------------------
    def _new_tid(self) -> int:
        with self._lock:
            self.tids += 1
            return self.tids

    def handle_reply(self, tid: int, who) -> None:
        op = self.in_flight.get(tid)
        if op is not None:
            if fp.enabled("backend.commit.ack"):
                fp.failpoint("backend.commit.ack", tid=tid, who=who)
            t0 = op.sent_at.get(who)
            if t0 is not None and self.op_perf is not None:
                # per-peer sub-write RTT: send -> commit ack (includes
                # the peer's store commit batch)
                self.op_perf.hinc("lat_fanout_rtt_us",
                                  (time.monotonic() - t0) * 1e6)
            op.ack(who)

    def on_peer_change(self, alive: set) -> None:
        """Re-resolve every in-flight op against the new acting set:
        acks expected from OSDs no longer alive are dropped (ADVICE:
        an op stuck on a dead peer otherwise hangs forever)."""

        def is_alive(who) -> bool:
            osd = who[1] if isinstance(who, tuple) else who
            return osd in alive

        for op in list(self.in_flight.values()):
            op.drop_missing(is_alive)

    def _done(self, tid: int) -> None:
        self.in_flight.pop(tid, None)

    def _note_unfanned(self, entries: List[LogEntry]) -> None:
        if entries:
            with self._lock:
                self._unfanned[id(entries[-1])] = entries[-1]

    def _fanned(self, entries: List[LogEntry]) -> None:
        """This write's entry leaves `_unfanned`: its fan-out ran (or
        failed), or its encode failed.  After a failed encode nothing is
        stored anywhere, and a rewind of the entry marks the object
        missing at a version every shard still holds."""
        if entries:
            with self._lock:
                self._unfanned.pop(id(entries[-1]), None)

    def _rewound(self, entries: List[LogEntry], tid: int) -> bool:
        """Under `log_fence`: True when this write's entry left the PG's
        log before its deferred fan-out ran.  The op leaves `in_flight`
        uncommitted: nothing is stored or sent, and the client, never
        answered, resends."""
        if not entries:
            return False
        entry = entries[-1]
        self._fanned(entries)
        if self.in_log(entry):
            return False
        self.in_flight.pop(tid, None)
        self.log(1, f"pg {self.pgid}: fan-out of rewound entry "
                    f"{entry.version} dropped")
        return True

    def _apply_local(self, entries: List[LogEntry], tid: int, op,
                     txns, capture) -> bool:
        """A deferred fan-out's local half, in one step against a rewind
        (under `log_fence`, so a later rollback finds its record): unless
        the entry was rewound, ``capture(txn, shards)`` adds the rollback
        records and this OSD's transaction is queued.  False when the
        write was dropped as rewound."""
        with self.log_fence:
            if self._rewound(entries, tid):
                return False
            for osd, shards, txn in txns:
                if osd == self.whoami:
                    capture(txn, shards)
                    self.store.queue_transaction(
                        txn, on_commit=lambda o=osd: op.ack(o))
        return True

    # -- fan-out sequencer -------------------------------------------------
    def _fan_ticket(self) -> int:
        """Taken in version order (callers hold the pg lock through
        submit), consumed by _fan_run in the same order."""
        with self._fan_lock:
            t = self._fan_tickets
            self._fan_tickets += 1
            return t

    def _encode_then_fanout(self, planes, fanout, on_error,
                            fused: bool = False, size: int = 0,
                            trop=None) -> None:
        """Shared async-encode scaffold: queue the planes, then run
        `fanout(coding)` through the per-PG sequencer on the fan-out
        executor — NOT on the StripeBatchQueue's device worker, which
        must get back to coalescing the next batch (fan-out does store
        applies and message sends; running it on the worker serialized
        every write's fan-out behind the device thread and kept batch
        width pinned near 1).  `on_error` runs if the encode itself
        fails: nothing was fanned out anywhere, so the caller unwinds
        its bookkeeping (in-flight op, gauge, projected state).
        `fused=True` rides encode_crc_async (device-resident path):
        fanout receives `(coding, crcs)` — per-shard crc32c computed
        in the same device batch as the matmul."""
        ticket = self._fan_ticket()
        if self.perf is not None:
            self.perf.inc("encode_batch_jobs")
        if not hasattr(self.codec, "encode_planes"):
            # codec route (lrc): the queue has no batch for it, so the
            # fan-out executor encodes it and fans out in ticket order
            def encode_then_fan() -> None:
                try:
                    coding = self.codec.encode_array(planes)
                except Exception as e:  # noqa: BLE001 — codec error
                    self.log(0, f"pg {self.pgid}: encode failed: {e!r}")
                    on_error()
                    return
                fanout(coding)

            _fanout_executor().submit(
                lambda: self._fan_run(ticket, encode_then_fan))
            return
        try:
            # trop rides the job so the queue can blame the kernel
            # build for this op's wait (compile_wait annotation)
            fut = (self.queue.encode_crc_async(self.codec, planes,
                                               size=size, trop=trop)
                   if fused else
                   self.queue.encode_async(self.codec, planes,
                                           trop=trop))
        except BaseException:
            self._fan_run(ticket, lambda: None)  # never park the line
            raise

        def finish(f) -> None:
            try:
                coding = f.result()
            except Exception as e:  # noqa: BLE001 — device/codec error
                self.log(0, f"pg {self.pgid}: encode failed: {e!r}")
                on_error()
                return
            fanout(coding)

        fut.add_done_callback(lambda f: _fanout_executor().submit(
            lambda: self._fan_run(ticket, lambda: finish(f))))

    def _fan_run(self, ticket: int, fn: Callable[[], None]) -> None:
        """Run `fn` once every earlier ticket's fn has run; an earlier
        completion drains any later fns already parked.  Encodes ride a
        FIFO queue so in practice completions arrive in ticket order
        and nothing parks — the sequencer only pays off when an
        encode-less write (delete) would otherwise jump the line."""
        ready: List[Callable[[], None]] = []
        with self._fan_lock:
            self._fan_pending[ticket] = fn
            while self._fan_next in self._fan_pending:
                ready.append(self._fan_pending.pop(self._fan_next))
                self._fan_next += 1
        for f in ready:
            try:
                f()
            except Exception as e:  # noqa: BLE001 — one write's fan-out
                # failure must not wedge every later write behind it
                self.log(0, f"pg {self.pgid}: write fan-out failed: "
                            f"{e!r}")

    # -- interface --------------------------------------------------------
    def submit(self, oid: str, state: Optional[ObjectState],
               entries: List[LogEntry], log_omap: Dict[str, bytes],
               acting: Sequence[int], on_commit: Callable[[], None],
               log_rm: Optional[List[str]] = None,
               on_submitted: Optional[Callable[[], None]] = None) -> None:
        """state=None means delete. `log_omap`/`log_rm` are pg-log omap
        updates/trims persisted in the same transaction (crash = replay
        consistency).  `on_submitted` fires once the write's
        transactions have been queued locally and fanned out to every
        peer (possibly on another thread — the EC encode is async):
        the PG's per-object admission gate releases there, NOT at
        commit, which is what lets same-object successors read the
        projected state while this write's acks are still in flight."""
        raise NotImplementedError

    def read_object(self, oid: str, acting: Sequence[int],
                    done: Callable[[Optional[ObjectState]], None]) -> None:
        raise NotImplementedError

    def object_names(self) -> List[str]:
        raise NotImplementedError


def _meta_oid() -> GHObject:
    return GHObject("_pgmeta_")


def pg_meta_txn(coll: Collection, entries_omap: Dict[str, bytes],
                info_blob: bytes) -> Transaction:
    t = Transaction()
    t.touch(coll, _meta_oid())
    if entries_omap:
        t.omap_setkeys(coll, _meta_oid(), entries_omap)
    t.setattrs(coll, _meta_oid(), {"info": info_blob})
    return t


# ---------------------------------------------------------------------------
# Replicated
# ---------------------------------------------------------------------------


class ReplicatedBackend(PGBackend):
    def _object_txn(self, oid: str, state: Optional[ObjectState],
                    log_omap: Dict[str, bytes],
                    log_rm: Optional[List[str]] = None) -> Transaction:
        t = Transaction()
        g = GHObject(oid)
        if state is None:
            t.try_remove(self.coll, g)
        else:
            # full-state REPLACE: drop-and-recreate so removed xattrs
            # stay removed (setattrs merges; cls rmxattr would resurrect)
            t.try_remove(self.coll, g)
            t.write(self.coll, g, 0, state.data)
            t.setattrs(self.coll, g, state.xattrs)
            if state.omap:
                t.omap_setkeys(self.coll, g, state.omap)
        if log_omap:
            t.touch(self.coll, _meta_oid())
            t.omap_setkeys(self.coll, _meta_oid(), log_omap)
        if log_rm:
            t.omap_rmkeys(self.coll, _meta_oid(), log_rm)
        return t

    def submit(self, oid, state, entries, log_omap, acting, on_commit,
               log_rm=None, pre_txn=None, on_submitted=None,
               trace=None, trop=None):
        txn = self._object_txn(oid, state, log_omap, log_rm)
        if pre_txn is not None:
            # snapshot clone-on-write rides the SAME transaction: the
            # clone of the pre-write head and the new head land
            # atomically, on the primary and every replica
            pre_txn.append(txn)
            txn = pre_txn
        peers = [o for o in acting
                 if o != self.whoami and o != CRUSH_ITEM_NONE and o >= 0]
        tid = self._new_tid()
        op = InFlightOp(set(peers) | {self.whoami}, lambda: None)
        op.on_commit = lambda: (self._done(tid),
                                _fire_commit(on_commit, op))
        if entries:
            op.entry = entries[-1]
        self.in_flight[tid] = op
        body = txn.to_bytes()
        for peer in peers:
            if (fp.enabled("backend.subwrite.fanout")
                    and fp.failpoint("backend.subwrite.fanout",
                                     peer=peer, oid=oid) is fp.DROP):
                continue  # modeled kill-boundary loss: never sent
            msg = m.MOSDRepOp(self.pgid, self.epoch_fn(), body, entries)
            msg.tid = tid
            op.sent_at[peer] = time.monotonic()  # fan-out RTT stamp
            self.osd_send(peer, msg)
        # local apply last: the store raises on real corruption, and
        # the self-ack fires from the store's COMMIT callback (not
        # inline) so the local fsync batches with every other write in
        # flight — the op completes when peers and the commit thread
        # have all answered
        self.store.queue_transaction(
            txn, on_commit=lambda: op.ack(self.whoami))
        # replicated fan-out is synchronous and the caller holds the pg
        # lock, so sends already leave in version order: submitted now
        if on_submitted is not None:
            on_submitted()

    def apply_rep_op(self, txn_bytes: bytes, on_commit=None) -> None:
        """Replica side of MOSDRepOp (sub_op_modify); the sub-write ack
        rides `on_commit` so replicas answer from the commit thread."""
        self.store.queue_transaction(Transaction.from_bytes(txn_bytes),
                                     on_commit=on_commit)

    def read_object(self, oid, acting, done):
        g = GHObject(oid)
        if not self.store.exists(self.coll, g):
            done(None)
            return
        done(ObjectState(
            self.store.read(self.coll, g),
            self.store.getattrs(self.coll, g),
            self.store.omap_get(self.coll, g),
        ))

    def object_names(self) -> List[str]:
        return [o.name for o in self.store.collection_list(self.coll)
                if o.name != "_pgmeta_" and o.snap == -2]


# ---------------------------------------------------------------------------
# Erasure-coded
# ---------------------------------------------------------------------------


def _av_stamp(v) -> bytes:
    """Lexicographically-ordered encoding of an EVersion for the _av
    attr (big-endian fixed width: byte compare == version compare)."""
    import struct as _struct

    return _struct.pack(">IQ", int(v.epoch), int(v.version))


def _hinfo(chunk: bytes, total_size: int, crc_valid: bool = True,
           crc: Optional[int] = None) -> bytes:
    """Per-shard HashInfo xattr: (object logical size, chunk crc32c)
    (reference ECUtil::HashInfo, src/osd/ECUtil.h:101-122).

    `crc` supplies a digest already computed — the device path fuses
    crc32c into the encode batch and hands the 4-byte result here, so
    building hinfo never pulls payload bytes back to host.

    Partial-stripe overwrites cannot maintain the whole-chunk crc
    without re-reading the chunk, so they mark it invalid — scrub then
    relies on the decode+re-encode parity check instead (the reference's
    ec_overwrites pools likewise drop the running HashInfo crc and lean
    on store checksums / deep scrub)."""
    e = Encoder()
    if not crc_valid:
        crc = 0
    elif crc is None:
        crc = crc32c(chunk)
    e.u64(total_size).u32(crc)
    e.u8(1 if crc_valid else 0)
    return e.bytes()


def hinfo_decode(blob: bytes) -> Tuple[int, int, bool]:
    d = Decoder(blob)
    size, crc = d.u64(), d.u32()
    valid = bool(d.u8()) if d.remaining_in_frame() else True
    return size, crc, valid


# -- EC write rollback records ----------------------------------------------
# The src/osd/ECTransaction.h rollback-extents discipline: every EC
# shard write snapshots the state it overwrites into a rollback record
# persisted in the SAME store transaction (keyed by the entry's version
# in the pg meta omap, see pglog.rollback_key).  Peering's divergent-
# entry handling consumes the records: a shard that committed a stripe
# the authoritative log never saw restores its pre-write extents
# instead of being re-replicated wholesale (pg._rollback_to).  Records
# trim with their log entries.

RB_FULL = 1    # whole-shard replace (full-object write / delete)
RB_EXTENT = 2  # ranged chunk-extent overwrite (partial-stripe RMW)
# a shard state too large to snapshot is not captured: rollback of
# that entry falls back to the re-replication convergence path
RB_MAX_CAPTURE = 1 << 20


class ExtentCache:
    """Overwrite pipeline cache (reference: ExtentCache.h role).

    A bounded write-through LRU of (oid, stripe) -> merged data-plane
    bytes for stripes this primary recently wrote.  The next RMW that
    overlaps them skips its whole read phase (no shard reads, no
    decode) — the way overlapping/back-to-back overwrites pipeline in
    a strictly-ordered per-PG write path.  Invalidation: full-object
    writes/deletes drop the object; interval changes clear everything
    (a new primary must not trust another primary's cache)."""

    def __init__(self, max_stripes: int = 1024) -> None:
        import collections

        self.max_stripes = max_stripes
        self._lru: "collections.OrderedDict[Tuple[str, int], bytes]" = (
            collections.OrderedDict())
        self._lock = make_lock("backend.stripe_cache")
        self.hits = 0
        self.misses = 0

    def put(self, oid: str, stripe: int, data: bytes) -> None:
        with self._lock:
            key = (oid, stripe)
            self._lru[key] = bytes(data)
            self._lru.move_to_end(key)
            while len(self._lru) > self.max_stripes:
                self._lru.popitem(last=False)

    def get(self, oid: str, stripe: int) -> Optional[bytes]:
        with self._lock:
            got = self._lru.get((oid, stripe))
            if got is None:
                self.misses += 1
            else:
                self._lru.move_to_end((oid, stripe))
                self.hits += 1
            return got

    def invalidate(self, oid: str) -> None:
        with self._lock:
            for key in [k for k in self._lru if k[0] == oid]:
                del self._lru[key]

    def clear(self) -> None:
        with self._lock:
            self._lru.clear()


class ECBackend(PGBackend):
    """EC distribution: shard i of the acting set stores chunk i.

    Layout is STRIPED with a fixed stripe_unit (the reference's
    stripe_info_t, ECUtil.h:27-71): logical bytes
    [s*k*unit + i*unit, ...) live at offset s*unit of shard i's chunk
    file.  Fixed geometry is what makes partial-stripe overwrite
    possible: a ranged write touches only stripes
    [off//width, ceil(end/width)) and each shard's extent
    [s0*unit, s1*unit)."""

    def __init__(self, pgid, coll, store, whoami, osd_send, epoch_fn,
                 codec) -> None:
        super().__init__(pgid, coll, store, whoami, osd_send, epoch_fn)
        self.codec = codec
        # the codec's device picks the queue: "cpu" runs the plain
        # versions, the card its kernels; no device means the card and
        # raises without one
        self.queue = default_queue(getattr(codec, "device", None))
        prof = getattr(codec, "profile", {}) or {}
        self.unit = int(prof.get("stripe_unit", 4096))
        self.cache = ExtentCache()
        self._sinfo = None  # lazy StripeInfo (ecutil.py)

    @property
    def k(self) -> int:
        return self.codec.k

    @property
    def m(self) -> int:
        return self.codec.m

    @property
    def sinfo(self):
        """The shared offset algebra (ECUtil stripe_info_t role)."""
        from ceph_tpu_torch.osd.ecutil import StripeInfo

        si = self._sinfo
        if si is None or si.k != self.k or si.chunk_size != self.unit:
            si = self._sinfo = StripeInfo(self.k, self.unit)
        return si

    @property
    def stripe_width(self) -> int:
        return self.sinfo.stripe_width

    def _interleave(self, data: bytes) -> Tuple[np.ndarray, int]:
        return self.sinfo.interleave(data)

    def _deinterleave(self, planes: np.ndarray, size: int) -> bytes:
        return self.sinfo.deinterleave(planes, size)

    def _prep_planes(self, data) -> np.ndarray:
        """Object buffer -> padded uint8 [k, cols] data planes (the
        host-side half of the encode, shared by the sync and async
        paths).  Accepts bytes, memoryview, or a staged DeviceBuf —
        the interleave reads the staging slot directly (part of the
        single sanctioned upload, not a crossing)."""
        if isinstance(data, DeviceBuf):
            data = data.np1d()
        planes, S = self._interleave(data)
        cols = S * self.unit
        # array codecs (clay) need columns divisible by sub_chunk_count
        D = self.codec.get_sub_chunk_count()
        if cols % D:
            planes = np.concatenate(
                [planes,
                 np.zeros((self.k, D - cols % D), dtype=np.uint8)], axis=1)
        return planes

    @property
    def data_ids(self) -> List[int]:
        """The shards that hold the data planes, in data order: the
        codec's chunk mapping (lrc places its data between its local
        parities), 0..k-1 for every other codec.  The reference takes
        0..k-1 for all: its lrc cannot be written (ROADMAP R4)."""
        return [self.codec.chunk_index(i) for i in range(self.k)]

    def _shard_rows(self, planes: np.ndarray, coding) -> List:
        """The k+m chunk rows in shard order: the data planes at
        ``data_ids``, the coding rows, in order, at the other shards."""
        rows: List = [None] * (self.k + self.m)
        for i, s in enumerate(self.data_ids):
            rows[s] = planes[i]
        it = iter(coding)
        for s in range(self.k + self.m):
            if rows[s] is None:
                rows[s] = next(it)
        return rows

    def _chunks_of(self, planes: np.ndarray, coding) -> List[bytes]:
        return [np.asarray(r).tobytes()
                for r in self._shard_rows(planes, coding)]

    def _encode_object(self, data: bytes) -> Tuple[List[bytes], int]:
        """Object buffer -> k+m chunk payloads, BLOCKING on the batch
        queue — recovery/scrub/tools path.  The client write path uses
        encode_async inside submit() instead, so concurrent writes'
        planes coalesce into one device matmul.  A codec the queue
        cannot batch (lrc) encodes through ``encode_array``."""
        planes = self._prep_planes(data)
        if hasattr(self.codec, "encode_planes"):
            coding = self.queue.encode(self.codec, planes)
        else:
            coding = self.codec.encode_array(planes)
        return self._chunks_of(planes, coding), planes.shape[1]

    def _shard_txn(self, oid: str, shard: int, chunk,
                   state: Optional[ObjectState],
                   log_omap: Dict[str, bytes],
                   log_rm: Optional[List[str]] = None,
                   av: Optional[bytes] = None,
                   chunk_crc: Optional[int] = None) -> Transaction:
        """`chunk` may be bytes or a DeviceBuf handle (device path);
        `chunk_crc` is the fused on-device crc32c when available, so
        hinfo never re-reads payload bytes on host."""
        t = Transaction()
        g = GHObject(oid, shard=shard)
        if state is None:
            t.try_remove(self.coll, g)
        else:
            # full-state REPLACE (see ReplicatedBackend._object_txn)
            t.try_remove(self.coll, g)
            t.write(self.coll, g, 0, chunk or b"")
            attrs = dict(state.xattrs)
            attrs["hinfo"] = _hinfo(chunk or b"", len(state.data),
                                    crc=chunk_crc)
            if av is not None:
                # attr-version stamp: RMW extent writes may CREATE an
                # attr-poor shard on a behind holder (they carry no
                # xattrs by design) — the read path must rank metas so
                # such a shard can never supply the object's attrs
                # while any properly-stamped shard answers
                attrs["_av"] = av
            t.setattrs(self.coll, g, attrs)
            if state.omap:
                t.omap_setkeys(self.coll, g, state.omap)
        if log_omap:
            t.touch(self.coll, _meta_oid())
            t.omap_setkeys(self.coll, _meta_oid(), log_omap)
        if log_rm:
            t.omap_rmkeys(self.coll, _meta_oid(),
                          list(log_rm) + self._rb_trim_keys(log_rm))
        return t

    def _rb_trim_keys(self, log_rm: Sequence[str]) -> List[str]:
        """Rollback-record keys trimmed alongside their log entries
        (an entry beyond the log window can't be rolled back anyway —
        the trim_to/roll_forward_to horizon)."""
        n = self.k + self.m
        return [f"rb_{key}.{s}" for key in log_rm for s in range(n)]

    def rb_capture(self, txn: Transaction, oid: str, shard: int,
                   kind: int, off: int, length: int, version) -> None:
        """Snapshot the local shard state `txn` is about to overwrite
        into a rollback record carried by the SAME transaction (crash
        atomicity: record and mutation land together).  Called right
        before queue_transaction, while the store still holds the
        pre-write image."""
        from ceph_tpu_torch.osd.pglog import rollback_key

        g = GHObject(oid, shard=shard)
        e = Encoder()
        e.start(1, 1)
        e.u8(kind)
        exists = self.store.exists(self.coll, g)
        e.u8(1 if exists else 0)
        if exists:
            try:
                data = self.store.read(self.coll, g)
                attrs = dict(self.store.getattrs(self.coll, g))
            except Exception:
                return  # unreadable shard: no record, rollback falls back
            if kind == RB_EXTENT:
                old = data[off: off + length]
                if len(old) > RB_MAX_CAPTURE:
                    return
                e.u64(off).blob(old).u64(len(data))
                # only the attrs an extent write touches; an attr
                # absent before is recorded empty and removed on restore
                e.mapping({k: attrs.get(k, b"")
                           for k in ("hinfo", "_av")},
                          lambda enc, k: enc.string(k),
                          lambda enc, v: enc.blob(v))
            else:
                if len(data) > RB_MAX_CAPTURE:
                    return
                omap = dict(self.store.omap_get(self.coll, g))
                e.blob(data)
                e.mapping(attrs, lambda enc, k: enc.string(k),
                          lambda enc, v: enc.blob(v))
                e.mapping(omap, lambda enc, k: enc.string(k),
                          lambda enc, v: enc.blob(v))
        e.finish()
        txn.touch(self.coll, _meta_oid())
        txn.omap_setkeys(self.coll, _meta_oid(),
                         {rollback_key(version, shard): e.bytes()})

    def roll_back_entry(self, entry: LogEntry,
                        meta_omap: Optional[Dict[str, bytes]] = None
                        ) -> bool:
        """Undo one divergent entry: restore every local shard's
        pre-write state from the records persisted with it, and drop
        the entry's log row.  An entry this primary minted whose write
        stored nothing yet needs no undo (True).  False when no record
        exists (pre-machinery entry, capture skipped, or applied
        elsewhere) — the caller falls back to marking the object
        missing."""
        from ceph_tpu_torch.osd.pglog import _logkey, rollback_prefix

        with self._lock:
            unfanned = self._unfanned.get(id(entry)) is entry
        if unfanned:
            # its fan-out has not passed the fence: nothing of this
            # write is stored here or anywhere, and the fan-out, finding
            # its entry gone, stores nothing (ROADMAP R7)
            self.cache.invalidate(entry.oid)
            return True
        omap = (meta_omap if meta_omap is not None
                else self.store.omap_get(self.coll, _meta_oid()))
        pre = rollback_prefix(entry.version)
        keys = sorted(k for k in omap if k.startswith(pre))
        if not keys:
            return False
        t = Transaction()
        for key in keys:
            try:
                shard = int(key[len(pre):])
                self._rb_restore(t, entry.oid, shard, omap[key])
            except Exception:
                return False  # undecodable record: fall back whole-entry
        t.omap_rmkeys(self.coll, _meta_oid(),
                      keys + [_logkey(entry.version)])
        self.store.queue_transaction(t)
        self.cache.invalidate(entry.oid)
        return True

    def _rb_restore(self, t: Transaction, oid: str, shard: int,
                    blob: bytes) -> None:
        d = Decoder(blob)
        d.start(1)
        kind = d.u8()
        existed = bool(d.u8())
        g = GHObject(oid, shard=shard)
        if not existed:
            # the write CREATED this shard object: rollback removes it
            t.try_remove(self.coll, g)
            d.end()
            return
        if kind == RB_EXTENT:
            off = d.u64()
            old = d.blob()
            old_len = d.u64()
            attrs = d.mapping(lambda dd: dd.string(),
                              lambda dd: dd.blob())
            t.truncate(self.coll, g, old_len)
            if old:
                t.write(self.coll, g, off, old)
            live = {k: v for k, v in attrs.items() if v}
            if live:
                t.setattrs(self.coll, g, live)
            for k, v in attrs.items():
                if not v:  # captured-absent attr must not survive
                    t.rmattr(self.coll, g, k)
        else:
            data = d.blob()
            attrs = d.mapping(lambda dd: dd.string(),
                              lambda dd: dd.blob())
            omap = d.mapping(lambda dd: dd.string(),
                             lambda dd: dd.blob())
            t.try_remove(self.coll, g)
            t.write(self.coll, g, 0, data)
            if attrs:
                t.setattrs(self.coll, g, attrs)
            if omap:
                t.omap_setkeys(self.coll, g, omap)
        d.end()

    def on_peer_change(self, alive: set) -> None:
        # an interval change invalidates the overwrite cache: a new
        # primary must never trust stripes another primary merged
        self.cache.clear()
        super().on_peer_change(alive)

    def _peer_map(self, shard_osds: Sequence[int]) -> Dict[int, List[int]]:
        """osd -> the shards it holds; degraded (absent) shards skipped.
        One wait key, one message, one merged transaction per PEER."""
        peer_shards: Dict[int, List[int]] = {}
        for shard, osd in enumerate(shard_osds):
            if osd == CRUSH_ITEM_NONE or osd < 0:
                continue  # degraded write: missing shard skipped
            peer_shards.setdefault(osd, []).append(shard)
        return peer_shards

    def _note_fanout(self, msgs: int) -> None:
        if self.perf is not None:
            self.perf.inc("subwrite_ops")
            self.perf.inc("subwrite_msgs", msgs)

    def submit(self, oid, state, entries, log_omap, acting, on_commit,
               log_rm=None, on_submitted=None, on_error=None,
               trace=None, trop=None):
        # full-object rewrite/delete supersedes any cached stripes
        self.cache.invalidate(oid)
        n = self.k + self.m
        shard_osds = list(acting[:n]) + [CRUSH_ITEM_NONE] * (n - len(acting))
        peer_shards = self._peer_map(shard_osds)
        tid = self._new_tid()
        op = InFlightOp(set(peer_shards), lambda: None)
        op.on_commit = lambda: (self._done(tid),
                                _fire_commit(on_commit, op))
        self.in_flight[tid] = op
        version = entries[-1].version if entries else None
        av = _av_stamp(version) if version is not None else None
        rb_kind = RB_FULL if version is not None else 0
        self._note_unfanned(entries)
        # epoch + watermark are minted NOW, under the pg lock — the
        # fan-out closure may run after an interval change, and a
        # stale sub-write stamped with the NEW epoch would evade the
        # peer's interval_epoch drop-gate and apply over recovered
        # data (the thrash-hunt divergence class the gate exists for)
        epoch = self.epoch_fn()
        committed_to = self.committed_fn()

        def fanout(chunks: List, crcs=None) -> None:
            rewound = False
            try:
                txns = []
                for osd, shards in sorted(peer_shards.items()):
                    txn = Transaction()
                    for i, shard in enumerate(shards):
                        # pg-log rows ride the merged transaction ONCE
                        # per peer, not once per shard
                        txn.append(self._shard_txn(
                            oid, shard,
                            chunks[shard] if state is not None else None,
                            state, log_omap if i == 0 else {},
                            log_rm if i == 0 else None, av=av,
                            chunk_crc=(int(crcs[shard])
                                       if crcs is not None else None)))
                    txns.append((osd, shards, txn))
                def capture(txn, shards) -> None:
                    # one rollback-capture pass + one WAL append for
                    # every local shard of this write
                    if rb_kind:
                        for shard in shards:
                            self.rb_capture(txn, oid, shard, rb_kind,
                                            0, 0, version)

                rewound = not self._apply_local(entries, tid, op, txns,
                                                capture)
                if rewound:
                    return
                msgs = 0
                for osd, shards, txn in txns:
                    if osd == self.whoami:
                        continue
                    if (fp.enabled("backend.subwrite.fanout")
                            and fp.failpoint(
                                "backend.subwrite.fanout",
                                peer=osd, oid=oid) is fp.DROP):
                        continue  # modeled loss: never sent
                    msg = m.MECSubWriteVec(
                        self.pgid, epoch, oid,
                        txn.to_bytes(), entries,
                        rb=[(shard, rb_kind, 0, 0)
                            for shard in shards],
                        committed_to=committed_to)
                    msg.tid = tid
                    # the client op's span context rides the wire;
                    # the peer opens its store-commit child off it
                    msg.set_trace(trace)
                    op.sent_at[osd] = time.monotonic()
                    self.osd_send(osd, msg)
                    msgs += 1
                self._note_fanout(msgs)
            finally:
                self._fanned(entries)
                if rewound and on_error is not None:
                    on_error()
                if state is not None and isinstance(state.data, DeviceBuf):
                    # every host sink (local store apply, wire frames)
                    # has read the staged slot: return it to the pool.
                    # The handle's truth is the device planes now —
                    # late readers (projected-state cache) fetch d2h.
                    state.data.seal()
                if on_submitted is not None:
                    on_submitted()

        if state is None:
            # deletes skip the device entirely; the sequencer keeps
            # them from overtaking an encode still on the queue
            self._fan_run(self._fan_ticket(), lambda: fanout([None] * n))
            return
        planes = self._prep_planes(state.data)
        if (isinstance(state.data, DeviceBuf)
                and hasattr(self.codec, "encode_planes")):
            # device-resident path: the staged payload's planes ride
            # ONE coalesced upload; encode AND per-shard crc32c run in
            # that batch; the fan-out ships DeviceBuf chunk handles so
            # no intermediate bytes copy ever materializes
            state.data.attach_planes(planes, self.k, self.unit)
            self._encode_then_fanout(
                planes,
                lambda res: fanout(self._chunks_dev(planes, res[0]),
                                   crcs=res[1]),
                self._encode_error_fn(tid, on_submitted, on_error,
                                      entries, state),
                fused=True, size=len(state.data), trop=trop)
            return
        self._encode_then_fanout(
            planes,
            lambda coding: fanout(
                self._chunks_of(planes, coding)),
            self._encode_error_fn(tid, on_submitted, on_error, entries),
            trop=trop)

    def _chunks_dev(self, planes: np.ndarray, coding) -> List[DeviceBuf]:
        """k+m chunk payload HANDLES for the fan-out: data chunks view
        the staged planes (host-pinned, zero-copy to every sink),
        coding chunks wrap the device-born parity rows (a sink reading
        them is the one d2h the write pays — and it is counted)."""
        stats = self.queue.stats
        data = set(self.data_ids)
        # the queue hands the parity back as host numpy; the fetch is
        # accounted at the chunk handles' wire_view sinks
        return [DeviceBuf.wrap_host(row, stats) if s in data
                else DeviceBuf.wrap_device(row, stats)
                for s, row in enumerate(
                    self._shard_rows(planes, np.asarray(coding)))]

    def _encode_error_fn(self, tid, on_submitted, on_error, entries,
                         state=None):
        """Unwind for a failed device encode: nothing was written or
        sent anywhere, so drop the in-flight op (a later peer-change
        must not complete it as success) and the entry from
        `_unfanned`, let the PG roll back its projected bookkeeping, and
        release the admission FIFO; the client's write times out
        retryable."""
        def unwind() -> None:
            self.in_flight.pop(tid, None)
            self._fanned(entries)
            try:
                if state is not None and isinstance(state.data, DeviceBuf):
                    state.data.seal()  # release the staging slot
                if on_error is not None:
                    on_error()
            finally:
                if on_submitted is not None:
                    on_submitted()
        return unwind

    def apply_sub_write_vec(self, msg, on_commit=None) -> None:
        """Peer side of MECSubWriteVec: ONE merged transaction covering
        every local shard this write touches, with each overwritten
        shard state snapshotted into the entry's rollback records first
        — same crash atomicity as the per-shard path, at one WAL append
        and one commit ack per write."""
        txn = Transaction.from_bytes(msg.txn)
        if msg.entries:
            version = msg.entries[-1].version
            for shard, kind, off, length in msg.rb:
                if kind:
                    self.rb_capture(txn, msg.oid, shard, kind, off,
                                    length, version)
        self.store.queue_transaction(txn, on_commit=on_commit)

    def apply_sub_write(self, msg, on_commit=None) -> None:
        """Shard side of MECSubWrite (handle_sub_write,
        ECBackend.cc:880): log + data in ONE transaction — with the
        overwritten state snapshotted into the entry's rollback record
        first, so the same transaction also makes the entry undoable.
        The shard ack rides `on_commit` (fired from the store's commit
        thread once the transaction is durable).  Accepts raw txn bytes
        for rollback-less applies (recovery tooling, legacy tests)."""
        if isinstance(msg, (bytes, bytearray)):
            self.store.queue_transaction(Transaction.from_bytes(msg),
                                         on_commit=on_commit)
            return
        txn = Transaction.from_bytes(msg.txn)
        if msg.rb_kind and msg.entries:
            self.rb_capture(txn, msg.oid, msg.shard, msg.rb_kind,
                            msg.rb_off, msg.rb_len,
                            msg.entries[-1].version)
        self.store.queue_transaction(txn, on_commit=on_commit)

    # -- reads ------------------------------------------------------------
    def read_local_chunk2(self, oid: str,
                          shard: int) -> Tuple[Optional[bytes], int]:
        """Whole local shard chunk with a verdict: (data, 0) on success,
        (None, ECRC) when bytes exist but fail checksum verification
        (store extent seals or hinfo crc), (None, EIO_MISSING) when the
        shard is absent/unreadable for any other reason."""
        g = GHObject(oid, shard=shard)
        if not self.store.exists(self.coll, g):
            return None, EIO_MISSING
        try:
            data = self.store.read(self.coll, g)
        except ChecksumError:
            # at-rest corruption caught by the store's read-verify gate
            # (per-extent seals / BlockStore device crc): the shard
            # reads as missing AND the failure is attributable
            return None, ECRC
        except Exception:
            return None, EIO_MISSING
        # verify the stored crc before serving (handle_sub_read's
        # HashInfo check, ECBackend.cc:955); overwritten chunks carry an
        # invalidated crc and are vetted by scrub's parity check instead
        try:
            _, want, valid = hinfo_decode(
                self.store.getattr(self.coll, g, "hinfo"))
        except Exception:
            return None, EIO_MISSING
        if valid and crc32c(data) != want:
            return None, ECRC  # corrupt shard -> reconstruct + repair
        return data, 0

    def read_local_chunk(self, oid: str, shard: int) -> Optional[bytes]:
        return self.read_local_chunk2(oid, shard)[0]

    def read_local_chunk_extent2(self, oid: str, shard: int, off: int,
                                 length: int) -> Tuple[Optional[bytes], int]:
        """Extent [off, off+length) of a shard chunk (ranged sub-reads:
        the RMW old-stripe fetch, vec extent rows), with the same
        verdict contract as read_local_chunk2.

        On stores whose read path verifies the bytes it serves — the
        base ObjectStore per-extent seal gate (verify_reads) or
        BlockStore's own per-block device crc (checksums_at_rest) — the
        extent is read directly: every byte the store returns is
        already crc-verified at rest, so materializing the WHOLE chunk
        just to re-verify the hinfo crc adds a copy without adding
        protection for the bytes served.  Other stores keep the
        whole-chunk read + hinfo crc verification and slice — the
        semantics are unchanged either way: corrupt data is never
        served (it reads as missing and is reconstructed from peers).
        """
        if not (getattr(self.store, "checksums_at_rest", False)
                or getattr(self.store, "verify_reads", False)):
            if self.perf is not None:
                self.perf.inc("extent_reads_whole_chunk")
            data, code = self.read_local_chunk2(oid, shard)
            return (None, code) if data is None else (
                data[off: off + length], 0)
        if self.perf is not None:
            self.perf.inc("extent_reads_at_rest")
        g = GHObject(oid, shard=shard)
        if not self.store.exists(self.coll, g):
            return None, EIO_MISSING
        try:
            # the hinfo attr must still parse (same "no/garbled hinfo
            # reads as missing" answer as the whole-chunk path)
            hinfo_decode(self.store.getattr(self.coll, g, "hinfo"))
        except Exception:
            return None, EIO_MISSING
        try:
            return self.store.read(self.coll, g, off, length), 0
        except ChecksumError:
            return None, ECRC  # extent failed verification at read time
        except Exception:
            return None, EIO_MISSING

    def read_local_chunk_extent(self, oid: str, shard: int, off: int,
                                length: int) -> Optional[bytes]:
        return self.read_local_chunk_extent2(oid, shard, off, length)[0]

    def read_local_chunk_runs2(
            self, oid: str, shard: int,
            runs: Sequence[Tuple[int, int]]
    ) -> Tuple[Optional[bytes], int, int]:
        """Sub-chunk runs of a local shard chunk for the clay repair
        plan: (data, code, served).  served=1 -> `data` is the
        requested runs' bytes concatenated in run order, read through
        the extent-sealed read_local_chunk_extent2 path (runs arrive
        in SUB-CHUNK units — the primary does not know this peer's
        chunk size, so the scaling by the stored chunk length happens
        here).  served=0 -> the runs could not be mapped onto the
        stored chunk (absent shard, geometry that does not divide into
        sub-chunks, out-of-range runs): the caller serves the whole
        chunk instead, exactly like a legacy peer.  A mapped extent
        that fails to read returns (None, code, 1) with the usual
        ECRC/EIO verdict contract."""
        Z = int(self.codec.get_sub_chunk_count())
        if Z <= 1 or not runs:
            return None, 0, 0
        g = GHObject(oid, shard=shard)
        try:
            clen = self.store.stat(self.coll, g)
        except Exception:
            return None, 0, 0  # absent: whole-chunk path answers EIO
        if clen <= 0 or clen % Z:
            return None, 0, 0
        sub = clen // Z
        if any(so < 0 or cnt <= 0 or so + cnt > Z for so, cnt in runs):
            return None, 0, 0
        parts: List[bytes] = []
        for so, cnt in runs:
            data, code = self.read_local_chunk_extent2(
                oid, shard, so * sub, cnt * sub)
            if data is None:
                return None, code, 1
            if len(data) != cnt * sub:
                return None, 0, 0  # short read: geometry lied
            parts.append(data)
        return b"".join(parts), 0, 1

    def local_size(self, oid: str,
                   want_av: Optional[bytes] = None) -> Optional[int]:
        """Logical object size from a local shard's HashInfo.  With
        `want_av`, only a shard carrying that attr-version stamp may
        answer: a stale local shard (pre-takeover zombie, mid-recovery
        image) otherwise supplies a stale SIZE that the partial-write
        path would then re-stamp with the NEW write's _av — laundering
        the wrong size into a fresh-looking hinfo that meta ranking
        and recovery trust (the 0x1EC thrash byte-mismatch class:
        same-_av shards disagreeing on hinfo size)."""
        for shard in range(self.k + self.m):
            g = GHObject(oid, shard=shard)
            if self.store.exists(self.coll, g):
                try:
                    if want_av is not None and self.store.getattr(
                            self.coll, g, "_av") != want_av:
                        continue
                    size, _, _ = hinfo_decode(
                        self.store.getattr(self.coll, g, "hinfo"))
                    return size
                except Exception:
                    continue
        return None

    def local_shards(self, acting: Sequence[int]) -> List[int]:
        return [i for i, o in enumerate(acting[: self.k + self.m])
                if o == self.whoami]

    def shard_meta(self, oid: str,
                   shard: int) -> Tuple[Dict[str, bytes], Dict[str, bytes]]:
        """A local shard's (attrs incl. hinfo, omap), for read replies."""
        g = GHObject(oid, shard=shard)
        if not self.store.exists(self.coll, g):
            return {}, {}
        return (dict(self.store.getattrs(self.coll, g)),
                dict(self.store.omap_get(self.coll, g)))

    def _state_from_planes(self, oid: str, planes: np.ndarray,
                           avail: Dict[int, bytes],
                           meta) -> Optional[ObjectState]:
        """Decoded data planes + shard meta -> the logical object
        (shared tail of the sync and async reconstruct paths)."""
        if meta is None:
            meta = self.shard_meta(oid, next(iter(avail)))
        attrs, omap = dict(meta[0]), dict(meta[1])
        size = None
        if "hinfo" in attrs:
            size, _, _ = hinfo_decode(attrs["hinfo"])
        attrs.pop("hinfo", None)
        attrs.pop("_av", None)  # internal attr-version stamp
        if size is None:
            return None  # no shard metadata reached us: can't size it
        return ObjectState(self._deinterleave(planes, size), attrs, omap)

    def _decode_arrs(self, avail: Dict[int, bytes]
                     ) -> Optional[Dict[int, np.ndarray]]:
        if not avail:
            return None
        n = len(next(iter(avail.values())))
        arrs = {i: np.frombuffer(c, dtype=np.uint8)
                for i, c in avail.items() if len(c) == n}
        return arrs if len(arrs) >= self.k else None

    def reconstruct(self, oid: str, avail: Dict[int, bytes],
                    meta: Optional[Tuple[Dict[str, bytes],
                                         Dict[str, bytes]]] = None,
                    ) -> Optional[ObjectState]:
        """Decode the object from >=k chunk payloads, BLOCKING —
        scrub/repair/tools path.  `meta` is the (attrs, omap) of ANY
        shard — supplied by the read path from whichever shard
        answered (possibly remote), so reconstruction never depends on
        this OSD holding a healthy local shard.  The data path
        (degraded client reads, the recovery window) uses
        reconstruct_async so concurrent decodes coalesce on the
        StripeBatchQueue."""
        arrs = self._decode_arrs(avail)
        if arrs is None:
            return None
        n = len(next(iter(arrs.values())))
        want = self.data_ids
        data_chunks = self.codec.decode(want, arrs, n)
        planes = np.stack([np.asarray(data_chunks[i]) for i in want])
        return self._state_from_planes(oid, planes, avail, meta)

    def _note_decode_job(self) -> None:
        if self.perf is not None:
            self.perf.inc("decode_batch_jobs")

    def reconstruct_async(self, oid: str, avail: Dict[int, bytes], meta,
                          done: Callable[[Optional[ObjectState]], None]
                          ) -> None:
        """reconstruct, off the caller's thread: when data shards are
        missing and the codec exposes a flat recovery matrix, the
        decode rides StripeBatchQueue.decode_data_async so concurrent
        degraded reads / recovery reconstructs sharing a survivor
        signature coalesce into ONE device matmul (the decode twin of
        the write path's encode_async).  `done(state)` always runs on
        a fresh thread — neither the device worker (which must get
        back to coalescing) nor the caller's network/timer thread
        executes completions that may take the pg lock."""
        def spawn(fn) -> None:
            threading.Thread(target=fn, daemon=True,
                             name="ec-decode-done").start()

        arrs = self._decode_arrs(avail)
        if arrs is None:
            spawn(lambda: done(None))
            return
        data_ids = self.data_ids
        if all(i in arrs for i in data_ids):
            # systematic fast path: every data shard answered — no
            # decode at all, just stack and deinterleave
            def assemble() -> None:
                planes = np.stack([arrs[i] for i in data_ids])
                done(self._state_from_planes(oid, planes, avail, meta))

            spawn(assemble)
            return
        self._note_decode_job()
        if self.codec.is_array:
            # array codec (clay): the batched coupled-layer decode kind,
            # coalesced by survivor signature like dec
            fut = self.queue.clay_decode_async(self.codec, arrs)
        elif getattr(self.codec, "mds_recovery", False):
            fut = self.queue.decode_data_async(self.codec, arrs)
        else:
            # no single recovery matrix (a bit-matrix code, shec): the
            # codec's own decode, off the caller's thread
            spawn(lambda: done(self.reconstruct(oid, avail, meta)))
            return

        def finish(f) -> None:
            def complete() -> None:
                try:
                    data = np.asarray(f.result())
                except Exception as e:  # noqa: BLE001 — device/codec
                    self.log(0, f"pg {self.pgid}: decode of {oid} "
                                f"failed: {e!r}")
                    done(None)
                    return
                # the queue's data planes, in data order
                planes = np.stack([data[i] for i in range(self.k)])
                done(self._state_from_planes(oid, planes, avail, meta))

            spawn(complete)

        fut.add_done_callback(finish)

    def repair_chunk_async(self, oid: str, lost: int,
                           layers: Dict[int, bytes],
                           done: Callable[[Optional[bytes]], None]) -> None:
        """Clay single-shard repair from layers-only helper bytes: each
        ``layers[h]`` holds helper h's repair-layer sub-chunks
        concatenated in layer order (the sub-chunk read plan's wire
        payload, d/(k*q) of a whole-chunk gather).  Rides the queue's
        ``crep`` kind, so concurrent repairs sharing a (lost, helpers)
        signature coalesce into one batched repair; `done(chunk_bytes)`
        runs on a fresh thread like reconstruct_async's completions."""
        def spawn(fn) -> None:
            threading.Thread(target=fn, daemon=True,
                             name="ec-repair-done").start()

        codec = self.codec
        helpers = sorted(layers)
        L = len(codec.repair_layers(lost))
        width = len(layers[helpers[0]]) if helpers else 0
        if (L == 0 or width == 0 or width % L
                or any(len(layers[h]) != width for h in helpers)):
            spawn(lambda: done(None))
            return
        s = width // L
        planes = np.stack([
            np.frombuffer(layers[h], dtype=np.uint8).reshape(L, s)
            for h in helpers])
        self._note_decode_job()
        fut = self.queue.clay_repair_async(codec, lost, helpers, planes)

        def finish(f) -> None:
            def complete() -> None:
                try:
                    out = np.asarray(f.result())
                except Exception as e:  # noqa: BLE001 — device/codec
                    self.log(0, f"pg {self.pgid}: clay repair of {oid} "
                                f"shard {lost} failed: {e!r}")
                    done(None)
                    return
                done(out.tobytes())

            spawn(complete)

        fut.add_done_callback(finish)

    def object_names(self) -> List[str]:
        return sorted({o.name for o in self.store.collection_list(self.coll)
                       if o.name != "_pgmeta_" and o.snap == -2})

    # -- partial-stripe overwrite (RMW, reference ECBackend.cc:1791) ------
    def assemble_range(self, extents: Dict[int, bytes], s0: int,
                       s1: int) -> Optional[bytes]:
        """Shard extent payloads [s0*unit, s1*unit) -> logical bytes of
        stripes [s0, s1); decodes when data shards are missing."""
        L = (s1 - s0) * self.unit
        arrs = {i: np.frombuffer(c, dtype=np.uint8)
                for i, c in extents.items() if len(c) == L}
        data_ids = self.data_ids
        if not all(i in arrs for i in data_ids):
            if len(arrs) < self.k:
                return None
            if self.codec.is_array:
                # array codecs (clay): a chunk EXTENT has no standalone
                # sub-chunk structure, so survivors' extents cannot be
                # decoded; the caller falls back to the whole-chunk
                # reconstruct (unreachable while clay answers
                # supports_partial_writes() False)
                return None
            if getattr(self.codec, "mds_recovery", False):
                # batched recovery matmul: concurrent degraded reads
                # sharing a survivor signature coalesce into one device
                # dispatch (decode twin of the write-path batching)
                self._note_decode_job()
                data = self.queue.decode_data(self.codec, arrs)
                arrs.update({s: data[i] for i, s in enumerate(data_ids)})
            else:  # no single recovery matrix (bit-matrix, shec)
                decoded = self.codec.decode(data_ids, arrs, L)
                arrs.update({i: np.asarray(decoded[i]) for i in data_ids})
        planes = np.stack([arrs[i] for i in data_ids])
        S = s1 - s0
        return planes.reshape(self.k, S, self.unit).transpose(
            1, 0, 2).tobytes()

    def can_partial(self, oid: str, off: int, length: int,
                    want_av: Optional[bytes] = None) -> bool:
        """Partial-stripe fast path precondition: a codec whose parity
        admits extent-local updates (a CODEC capability: the port's
        bit-matrix codes answer no, their packets span the chunk;
        ROADMAP R5), locally known size — from a CURRENT-stamped shard
        when `want_av` is given — and no size change."""
        if not self.codec.supports_partial_writes():
            return False
        size = self.local_size(oid, want_av)
        return size is not None and off + length <= size

    def read_cached_stripes(self, oid: str, s0: int,
                            s1: int) -> Tuple[Dict[int, bytearray],
                                              List[int]]:
        stripes: Dict[int, bytearray] = {}
        missing: List[int] = []
        for s in range(s0, s1):
            c = self.cache.get(oid, s)
            if c is not None:
                stripes[s] = bytearray(c)
            else:
                missing.append(s)
        return stripes, missing

    def submit_partial(self, oid: str, s0: int,
                       stripes: Dict[int, bytearray], size: int,
                       entries: List[LogEntry],
                       log_omap: Dict[str, bytes],
                       acting: Sequence[int],
                       on_commit: Callable[[], None],
                       log_rm: Optional[List[str]] = None,
                       on_submitted: Optional[Callable[[], None]] = None,
                       on_error: Optional[Callable[[], None]] = None,
                       trop=None) -> None:
        """Write merged stripes [s0, s0+len) as per-shard EXTENTS — only
        the touched stripes move (reference three-stage RMW,
        ECBackend.cc:1791 start_rmw / :1892 try_reads_to_commit).

        The caller has merged the new bytes into `stripes`, which must
        be contiguous from s0; the merged content feeds the extent
        cache so the next overlapping RMW skips its read phase.  Like
        submit(), the parity encode is async (coalesces with every
        other write in flight) and each peer gets ONE merged extent
        transaction for all its shards.
        """
        S = len(stripes)
        buf = b"".join(bytes(stripes[s]) for s in range(s0, s0 + S))
        planes = np.frombuffer(buf, dtype=np.uint8).reshape(
            S, self.k, self.unit).transpose(1, 0, 2)
        planes = np.ascontiguousarray(planes.reshape(self.k, S * self.unit))
        for s in range(s0, s0 + S):
            self.cache.put(oid, s, bytes(stripes[s]))

        n = self.k + self.m
        shard_osds = list(acting[:n]) + [CRUSH_ITEM_NONE] * (n - len(acting))
        peer_shards = self._peer_map(shard_osds)
        tid = self._new_tid()
        op = InFlightOp(set(peer_shards), lambda: None)
        op.on_commit = lambda: (self._done(tid),
                                _fire_commit(on_commit, op))
        self.in_flight[tid] = op
        ext_off, ext_len = self.sinfo.chunk_extent(s0, s0 + S)
        version = entries[-1].version if entries else None
        self._note_unfanned(entries)
        # minted under the pg lock, NOT in the deferred closure (see
        # submit: a post-interval-change epoch would evade the peer's
        # interval_epoch drop-gate)
        epoch = self.epoch_fn()
        committed_to = self.committed_fn()

        def fanout(coding: np.ndarray) -> None:
            rows = self._shard_rows(planes, coding)
            rewound = False
            try:
                txns = []
                for osd, shards in sorted(peer_shards.items()):
                    txn = Transaction()
                    for i, shard in enumerate(shards):
                        payload = rows[shard].tobytes()
                        g = GHObject(oid, shard=shard)
                        txn.write(self.coll, g, ext_off, payload)
                        # whole-chunk crc can't survive an extent write
                        # (see _hinfo).  _av: partial writes stamp the
                        # shard version like full writes do, so the
                        # NEXT RMW base read can version-check its
                        # extents (a stale shard — degraded-skipped or
                        # not-yet-recovered — carries an older stamp
                        # and is excluded instead of corrupting the
                        # base)
                        attrs = {"hinfo": _hinfo(b"", size, False)}
                        if version is not None:
                            attrs["_av"] = _av_stamp(version)
                        txn.setattrs(self.coll, g, attrs)
                        if i == 0:
                            if log_omap:
                                txn.touch(self.coll, _meta_oid())
                                txn.omap_setkeys(self.coll, _meta_oid(),
                                                 log_omap)
                            if log_rm:
                                txn.omap_rmkeys(
                                    self.coll, _meta_oid(),
                                    list(log_rm)
                                    + self._rb_trim_keys(log_rm))
                    txns.append((osd, shards, txn))
                def capture(txn, shards) -> None:
                    if version is not None:
                        for shard in shards:
                            self.rb_capture(txn, oid, shard, RB_EXTENT,
                                            ext_off, ext_len, version)

                rewound = not self._apply_local(entries, tid, op, txns,
                                                capture)
                if rewound:
                    return
                msgs = 0
                for osd, shards, txn in txns:
                    if osd == self.whoami:
                        continue
                    if (fp.enabled("backend.subwrite.fanout")
                            and fp.failpoint(
                                "backend.subwrite.fanout",
                                peer=osd, oid=oid) is fp.DROP):
                        continue  # modeled loss: never sent
                    msg = m.MECSubWriteVec(
                        self.pgid, epoch, oid,
                        txn.to_bytes(), entries,
                        rb=[(shard, RB_EXTENT, ext_off, ext_len)
                            for shard in shards],
                        committed_to=committed_to)
                    msg.tid = tid
                    self.osd_send(osd, msg)
                    msgs += 1
                self._note_fanout(msgs)
            finally:
                self._fanned(entries)
                if rewound:
                    unwind_with_cache()
                elif on_submitted is not None:
                    on_submitted()

        unwind = self._encode_error_fn(tid, on_submitted, on_error,
                                       entries)

        def unwind_with_cache() -> None:
            # the merged stripes were cached optimistically above, but
            # the encode failed before anything landed: a later RMW
            # must not read them as committed content
            self.cache.invalidate(oid)
            unwind()

        self._encode_then_fanout(
            planes, lambda coding: fanout(np.asarray(coding)),
            unwind_with_cache, trop=trop)
