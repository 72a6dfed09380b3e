"""Windowed EC recovery engine + the shared chunk-gather discipline.

Port of ``ceph_tpu/osd/recovery.py``: the same gather, the same rounds
and the same messages, over the port's backend, whose
``reconstruct_async`` rides the queue's ``dec`` kind (K1 on the card)
for the RS codecs and ``cdec`` for clay.  The engine runs over any PG that has the
attributes it reads (``lock``, ``pgid``, ``coll``, ``acting``,
``prior_acting``, ``missing``, ``unfound``, ``log``, ``backend``,
``osd``, ``stale_peers``, ``_obc_invalidate``, ``_av_for``,
``note_recovery_io``, ``_note_read_verify_fail``), and of ``pg.osd``:
``send_to_osd``, ``track_reads``/``untrack_reads``, ``epoch``,
``osdmap``, ``addr_book``, ``store``, ``ctx``, ``perf`` and ``_log``.
The sub-chunk repair plan is the reference's: a clay PG missing one
shard of an object reads only the repair layers of d helpers and
rebuilds it through the backend's ``repair_chunk_async`` (the queue's
``crep`` kind).

Reference seams: the async-recovery window of PrimaryLogPG
(osd_recovery_max_active over AsyncReserver slots), recover-on-read
(PrimaryLogPG::maybe_kick_recovery promoting an object a blocked op
needs), and ECBackend's per-object read gather (get_min_avail_to_read
-> handle_sub_read replies, ECBackend.cc:955).

Two pieces live here:

- ChunkGather: ONE object's EC chunk-gather state machine, extracted
  from PG._ec_read_object so the client read path and the recovery
  window share a single correctness discipline — source priority
  (current acting holders beat prior-interval holders), the _av
  attr-version check (mixed shard generations must never co-decode),
  and the retryable-vs-absent verdict (down/stale/hung current holders
  make a short gather RETRYABLE, never "gone").

- ECRecoveryEngine: the read-side twin of the PR-4 pipelined write
  engine.  pull_from_peer's old shape recovered one object per RPC
  round in a serial loop; the engine takes the missing set through a
  bounded in-flight window (W = osd_recovery_max_active): one
  MECSubReadVec per PEER per round carries every (oid, shard) the
  round wants from it, objects reconstruct the moment their gather is
  ready (out of order, decode coalesced on the StripeBatchQueue), and
  each completed object leaves pg.missing INDIVIDUALLY so parked
  recover-on-read waiters wake before the pull finishes.  Peers that
  never answer a vec get one legacy per-shard MECSubRead retry and are
  remembered as legacy-only (mixed-version clusters keep recovering —
  a slow peer misclassified as legacy merely loses aggregation, never
  correctness).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from ceph_tpu_torch.core.failpoint import failpoint
from ceph_tpu_torch.core.lockdep import make_lock
from ceph_tpu_torch.osd import messages as m
from ceph_tpu_torch.osd import types as t_
from ceph_tpu_torch.osd.backend import CRUSH_ITEM_NONE, ECRC, _av_stamp

# EC reads that could not assemble k CURRENT chunks answer with this
# sentinel: "retry later", never "doesn't exist" (mixing a
# prior-interval chunk into a fresh decode produced garbage; claiming
# ENOENT lost reads of live objects).  Defined here (pg.py re-exports)
# so the engine can consume it without a circular import.
READ_RETRY = object()


class ChunkGather:
    """One object's EC chunk-gather state (see module docstring).

    Built under no caller lock (the local pre-scan does store reads);
    feed()/fail_peer()/resolve() run under the OWNER's lock — the read
    path's per-read gather lock or the engine's round lock."""

    def __init__(self, pg, oid: str, plan_repair: bool = False) -> None:
        be = pg.backend
        self.oid = oid
        self.k = be.k
        n = be.k + be.m
        acting = list(pg.acting[:n]) + [CRUSH_ITEM_NONE] * (
            n - len(pg.acting))
        with pg.lock:
            local_stale = oid in pg.missing
            en = pg.log.latest_for(oid)
            stale_peers = set(pg.stale_peers)
            prior = list(pg.prior_acting[:n])
        # version discipline: when the log still holds this object's
        # newest entry, every usable chunk must carry that entry's _av
        # stamp — assembling MIXED shard versions returns silently
        # wrong bytes for systematic reads (thrash-hunt divergence).
        self.want_av: Optional[bytes] = None
        # the generation this gather reconstructs (recovery stamps ITS
        # OWN generation, never whatever the log head moved to while
        # the decode was in flight)
        self.av_version = None
        if en is not None and en.op != t_.LOG_DELETE:
            self.want_av = _av_stamp(en.version)
            self.av_version = en.version
        self.cur_avail: Dict[int, bytes] = {}    # from current holders
        self.prior_avail: Dict[int, bytes] = {}  # prior-interval holders
        self.cur_meta: List = [None]
        self.prior_meta: List = [None]
        # any chunk version-rejected (local pre-scan or a reply)
        self.av_reject = False
        # (shard, holder-osd) pairs whose bytes EXIST but failed at-rest
        # checksum verification (ECRC verdicts): the decode treats them
        # as missing, the pg layer counts/attributes/repairs them
        self.crc_failed: List[Tuple[int, int]] = []
        if not local_stale:
            # a holder that hasn't recovered this object yet must not
            # feed its own stale chunk into the decode
            for shard in be.local_shards(acting):
                attrs, omap = be.shard_meta(oid, shard)
                if not self._av_ok(attrs):
                    self.av_reject = True
                    continue
                c, code = be.read_local_chunk2(oid, shard)
                if c is not None:
                    self.cur_avail[shard] = c
                    self._better_meta(self.cur_meta, attrs, omap)
                elif code == ECRC:
                    self.crc_failed.append((shard, pg.osd.whoami))
        omap_ = pg.osd.osdmap

        def _up(o: int) -> bool:
            return omap_ is None or omap_.is_up(o)

        whoami = pg.osd.whoami
        remote = [(s, o, True) for s, o in enumerate(acting)
                  if o not in (whoami, CRUSH_ITEM_NONE) and o >= 0
                  and o not in stale_peers and _up(o)]
        # a DOWN current holder can never answer: skip it, but its
        # shard may hold the freshest extent, so a short gather must
        # stay RETRYABLE, never report absence
        self.down_cur = any(o not in (whoami, CRUSH_ITEM_NONE)
                            and o >= 0 and o not in stale_peers
                            and not _up(o)
                            for o in acting)
        # wholesale remap: a freshly-placed member has nothing yet —
        # ask the prior-interval holder of each shard too (fallback)
        for s in range(min(n, len(prior))):
            o = prior[s]
            if (o not in (whoami, CRUSH_ITEM_NONE) and o >= 0
                    and _up(o) and s not in self.cur_avail
                    and (s, o, True) not in remote):
                remote.append((s, o, False))
        self.remote: List[Tuple[int, int, bool]] = remote
        # sub-chunk read plan (clay MSR single-shard repair): when the
        # codec plans fractional reads and exactly our one local shard
        # is missing, the gather asks only the d helper shards for
        # their repair-layer sub-chunks — d/(k*q) of a whole-chunk
        # gather's bytes.  None = whole-chunk gather (flat codecs,
        # multi-shard damage, replan attempts).
        self.sub_plan: Optional[Tuple[int, Tuple[int, ...],
                                      List[Tuple[int, int]], int]] = None
        self.sub_avail: Dict[int, bytes] = {}  # helper -> layer bytes
        self.sub_count = int(be.codec.get_sub_chunk_count()) \
            if hasattr(be, "codec") else 1
        self.wire_bytes = 0  # chunk payload bytes received from peers
        if plan_repair and not self.av_reject:
            self._plan_sub_reads(be, acting)
        # outstanding CURRENT-holder requests per shard: a prior
        # holder's data for s is usable only when this drops to 0
        self.pending_cur: Dict[int, int] = {}
        self.pending_any: Dict[int, int] = {}
        self.holder_of: Dict[Tuple[int, int], bool] = {}
        self._open: Set[Tuple[int, int]] = set()
        for s, o, is_cur in self.remote:
            self.holder_of[(s, o)] = is_cur
            self._open.add((s, o))
            self.pending_any[s] = self.pending_any.get(s, 0) + 1
            if is_cur:
                self.pending_cur[s] = self.pending_cur.get(s, 0) + 1

    def _plan_sub_reads(self, be, acting) -> None:
        """Install the clay sub-chunk repair plan when it applies:
        sub-chunked codec, exactly ONE local shard to rebuild, and the
        codec's minimum_to_decode names a strict-subset run plan over
        enough CURRENT holders.  The plan trims the remote ask to the
        helper shards; any failure mode (helper EIO / hung / version-
        rejected) resolves retryable and the engine's replan attempt
        rebuilds with a whole-chunk gather, so planning can only save
        bytes, never lose an object."""
        codec = getattr(be, "codec", None)
        if (codec is None or self.sub_count <= 1
                or not hasattr(codec, "repair_layers")):
            return
        mine = [s for s in be.local_shards(acting)
                if s not in self.cur_avail]
        if len(mine) != 1:
            return
        lost = mine[0]
        cur_remote = {s for s, _o, is_cur in self.remote if is_cur}
        plan = codec.minimum_to_decode(
            [lost], sorted(set(self.cur_avail) | cur_remote))
        helpers = tuple(sorted(plan))
        if not helpers or lost in helpers:
            return
        runs = [(int(a), int(b)) for a, b in plan[helpers[0]]]
        layer_cnt = sum(c for _o, c in runs)
        if (layer_cnt <= 0 or layer_cnt >= self.sub_count
                or any(list(plan[h]) != list(plan[helpers[0]])
                       for h in helpers)):
            return  # whole-chunk (or degenerate) plan: no savings
        if not all(h in self.cur_avail or h in cur_remote
                   for h in helpers):
            return  # a helper only a prior-interval holder has: the
            #         version discipline wants the whole-chunk gather
        self.sub_plan = (lost, helpers, runs, layer_cnt)
        # ask ONLY the helpers, each for its repair layers; drop the
        # prior-holder fallback rows (plan helpers are all current)
        self.remote = [(s, o, is_cur) for s, o, is_cur in self.remote
                       if is_cur and s in set(helpers)
                       and s not in self.cur_avail]

    def repair_ready(self) -> bool:
        """Every planned helper's repair layers (or its whole chunk,
        for helpers served by legacy peers) arrived."""
        sp = self.sub_plan
        if sp is None:
            return False
        return all(h in self.sub_avail or h in self.cur_avail
                   for h in sp[1])

    def repair_layer_bytes(self) -> Optional[Dict[int, bytes]]:
        """helper -> repair-layer bytes for the planned single-shard
        rebuild; whole chunks from legacy peers are sliced down to the
        planned runs host-side.  None when widths disagree (mixed
        chunk generations never co-repair — the _av check already
        screened, this is the belt)."""
        sp = self.sub_plan
        if sp is None:
            return None
        _lost, helpers, runs, layer_cnt = sp
        out: Dict[int, bytes] = {}
        for h in helpers:
            if h in self.sub_avail:
                out[h] = self.sub_avail[h]
            elif h in self.cur_avail:
                c = self.cur_avail[h]
                if len(c) % self.sub_count:
                    return None
                sub = len(c) // self.sub_count
                out[h] = b"".join(c[so * sub: (so + cnt) * sub]
                                  for so, cnt in runs)
            else:
                return None
        widths = {len(b) for b in out.values()}
        if len(widths) != 1 or 0 in widths:
            return None
        (w,) = widths
        if w % layer_cnt:
            return None
        return out

    def _av_ok(self, attrs) -> bool:
        return self.want_av is None or attrs.get("_av") == self.want_av

    @staticmethod
    def _meta_rank(attrs) -> tuple:
        """(_av stamp, hinfo-crc-valid): the highest stamp wins (an
        RMW-recreated shard carries hinfo but no user attrs and no
        stamp, and must never supply the object's attrs while a
        properly-stamped shard answers); on EQUAL stamps a valid-crc
        hinfo (full write / recovery output) outranks a partial-write
        one, whose recorded size is advisory (0x1EC forensics: a
        stale-sized invalid hinfo winning the tie mis-sized the
        reconstruction)."""
        valid = 0
        try:
            from ceph_tpu_torch.osd.backend import hinfo_decode

            if hinfo_decode(attrs["hinfo"])[2]:
                valid = 1
        except Exception:
            valid = 0
        return (attrs.get("_av", b""), valid)

    @classmethod
    def _better_meta(cls, box, attrs, omap) -> None:
        if box[0] is None or cls._meta_rank(attrs) > cls._meta_rank(
                box[0][0]):
            box[0] = (dict(attrs), dict(omap))

    def _merged(self) -> Dict[int, bytes]:
        out = dict(self.cur_avail)
        for s, c in self.prior_avail.items():
            if s not in out and self.pending_cur.get(s, 0) <= 0:
                out[s] = c
        return out

    def _settle(self, shard: int, src: int) -> bool:
        """Bookkeeping for one answered/failed (shard, src) request;
        False when it was already settled (late/duplicate reply)."""
        key = (shard, src)
        if key not in self._open:
            return False
        self._open.discard(key)
        if self.holder_of.get(key, False):
            self.pending_cur[shard] = self.pending_cur.get(shard, 1) - 1
        self.pending_any[shard] = self.pending_any.get(shard, 1) - 1
        if self.pending_any.get(shard, 0) <= 0:
            self.pending_any.pop(shard, None)
        return True

    def feed(self, shard: int, src: int, result: int, oid: str,
             data: bytes, attrs, omap, served: int = 0) -> bool:
        """Account one sub-read answer; returns True when the gather
        became ready to resolve.  `served` mirrors the vec reply's
        per-row flag: 1 = `data` is the requested sub-chunk runs
        concatenated in run order (NOT a whole chunk), 0 = whole chunk
        (every legacy reply)."""
        is_cur = self.holder_of.get((shard, src), False)
        good = result == 0 and oid == self.oid
        if good:
            self.wire_bytes += len(data)
        if result == ECRC and oid == self.oid:
            # the peer HAS the shard but its bytes failed verification:
            # decode around it, and let the pg layer attribute/repair
            self.crc_failed.append((shard, src))
        if good and not self._av_ok(attrs):
            # version-mismatched chunk: a failed answer for the
            # pending bookkeeping, and the read must end RETRYABLE
            # (the shard exists, recovery will bring it forward)
            self.av_reject = True
        if good and self._av_ok(attrs):
            sp = self.sub_plan
            if served and sp is not None and shard in sp[1] and is_cur:
                # layers-only payload: usable ONLY by the repair plan —
                # it must never enter cur_avail, where the whole-chunk
                # decode/merge logic would treat it as a full chunk
                self.sub_avail[shard] = data
                if "hinfo" in attrs:
                    self._better_meta(self.cur_meta, attrs, omap)
            elif not served:
                if is_cur:
                    self.cur_avail[shard] = data
                    if "hinfo" in attrs:
                        self._better_meta(self.cur_meta, attrs, omap)
                else:
                    self.prior_avail.setdefault(shard, data)
                    if "hinfo" in attrs:
                        self._better_meta(self.prior_meta, attrs, omap)
            # served payload with no matching plan: settle the request
            # without feeding either pool (can't be interpreted safely)
        self._settle(shard, src)
        return self.ready()

    def fail_peer(self, osd: int) -> bool:
        """A peer died (or was unsendable) mid-gather: its replies can
        never come.  Returns True when the gather became ready."""
        for (s, o) in [k for k in self._open if k[1] == osd]:
            if self.holder_of.get((s, o), False):
                # a lost CURRENT holder may hold the freshest extent:
                # the verdict must stay retryable, like a holder the
                # map already showed down at build time
                self.down_cur = True
            self._settle(s, o)
        return self.ready()

    def ready(self) -> bool:
        return (not self.pending_any or self.repair_ready()
                or len(self.cur_avail) >= self.k
                or (len(self._merged()) >= self.k
                    and not any(v > 0 for v in self.pending_cur.values())))

    def resolve(self, timed_out: bool = False):
        """Final verdict: (avail, meta, retryable).  retryable=True
        means the caller answers READ_RETRY — a current holder never
        answered / died / version-rejected, so the chunks exist and
        recovery (or the next attempt) will serve them; substituting a
        prior holder's chunk or claiming absence would be wrong."""
        av = self._merged()
        meta = self.cur_meta[0] or self.prior_meta[0]
        hung_cur = any(v > 0 for v in self.pending_cur.values())
        if len(av) < self.k:
            if ((timed_out and hung_cur) or self.av_reject
                    or self.down_cur):
                return None, None, True
            if self.want_av is not None:
                # the log's newest word says this object is LIVE at
                # this generation, yet k current chunks are not
                # reachable (holders answered "no chunk" — e.g.
                # laggards that haven't recovered it themselves):
                # "cannot serve right now", never "does not exist".
                # An absent verdict here let a ranged write fork a
                # zero-filled object over live data (0x1EC thrash
                # capture: 1833 B of zeros superseding 1827 B, every
                # shard identically re-stamped).  Deleted / unknown /
                # log-trimmed objects still resolve absent below.
                return None, None, True
        return av, meta, False


class _Round:
    """One recovery window's in-flight state."""

    def __init__(self, oids: List[str]) -> None:
        self.oids = oids
        self.span = None  # recovery-round trace span (when tracing)
        self.lock = make_lock("pg.recovery_round")
        self.gathers: Dict[str, ChunkGather] = {}
        self.unresolved: Set[str] = set(oids)
        self.concluded: Set[str] = set()
        self.replied: Set[int] = set()   # peers that answered anything
        self.vec_sent: Set[int] = set()  # peers sent a vec this round
        self.rows: Dict[int, List[Tuple[int, str]]] = {}  # osd->(shard,oid)
        self.done = threading.Event()


class ECRecoveryEngine:
    """Windowed parallel self-recovery for an EC primary (see module
    docstring).  One engine per PG, created lazily; recover() is
    re-entered serially (activation passes are serialized per PG) while
    park_read() may race it from read workers."""

    MAX_ATTEMPTS = 2  # per oid per drain: one replan after peer churn

    def __init__(self, pg) -> None:
        self.pg = pg
        self.osd = pg.osd
        self._cond = threading.Condition(make_lock("pg.recovery_engine"))
        self._pending: "collections.deque[str]" = collections.deque()
        self._pending_set: Set[str] = set()
        self._parked: Dict[str, List] = {}  # oid -> [(wake, timer)]
        self._attempts: Dict[str, int] = {}
        self._no_vec: Set[int] = set()  # peers that never answered a vec
        self._round: Optional[_Round] = None
        self._drainers = 0

    # -- public entry points ----------------------------------------------
    def recover(self, latest: Dict[str, t_.LogEntry]) -> None:
        """Blocking: drain `latest` through the window.  Deletes apply
        immediately (no reads); returns when every object is resolved —
        recovered, deleted, or left in pg.missing for the next
        interval's retry (a peer holding fresh shards may return)."""
        for oid in sorted(latest):
            en = latest[oid]
            if en.op == t_.LOG_DELETE:
                self._apply_delete(oid)
            else:
                self._enqueue(oid)
        self._drain()

    def park_read(self, oid: str, wake: Callable[[bool], None],
                  wait_s: Optional[float] = None) -> bool:
        """Recover-on-read: promote `oid` to the FRONT of the pending
        queue and park `wake` on its recovery resolution — wake(True)
        once the object left pg.missing (the caller re-runs the read),
        wake(False) on the bounded-wait timeout or a failed attempt
        (the caller answers EAGAIN, exactly as before).  Returns False
        when the object is no longer missing (caller re-checks)."""
        with self.pg.lock:
            if oid not in self.pg.missing:
                return False
        if wait_s is None:
            # one recovery round (sub-read window + decode), with slack
            wait_s = 1.5 * float(
                self.osd.ctx.conf.get("osd_recovery_read_timeout"))
        timer = threading.Timer(
            wait_s, lambda: self._park_timeout(oid, wake))
        timer.daemon = True
        kick = False
        with self._cond:
            self._parked.setdefault(oid, []).append(
                (wake, timer, time.monotonic()))
            rnd = self._round
            inflight = rnd is not None and oid in rnd.unresolved
            if not inflight:
                if oid in self._pending_set:
                    # already queued: move to the front
                    try:
                        self._pending.remove(oid)
                    except ValueError:
                        pass
                    self._pending.appendleft(oid)
                else:
                    self._pending.appendleft(oid)
                    self._pending_set.add(oid)
            # no drain running anywhere: this read is the kick that
            # starts one (maybe_kick_recovery role)
            kick = self._drainers == 0
        timer.start()
        if kick:
            threading.Thread(target=self._drain, daemon=True,
                             name="pg-recover-on-read").start()
        return True

    def peer_down(self, dead: Set[int]) -> None:
        """Map marked peers down mid-window: their vec replies can
        never come — fail their outstanding per-object requests so the
        window degrades to the surviving peers immediately instead of
        burning the whole read timeout per object."""
        with self._cond:
            rnd = self._round
        if rnd is None:
            return
        ready: List[str] = []
        with rnd.lock:
            for oid, g in rnd.gathers.items():
                if oid in rnd.concluded:
                    continue
                hit = False
                for o in dead:
                    hit = g.fail_peer(o) or hit
                if hit and g.ready():
                    rnd.concluded.add(oid)
                    ready.append(oid)
        for oid in ready:
            self._conclude_oid(rnd, oid, timed_out=False)

    # -- queueing ----------------------------------------------------------
    def _enqueue(self, oid: str, front: bool = False) -> None:
        with self._cond:
            rnd = self._round
            if oid in self._pending_set or (
                    rnd is not None and oid in rnd.unresolved):
                return
            (self._pending.appendleft if front
             else self._pending.append)(oid)
            self._pending_set.add(oid)

    def _drain(self) -> None:
        with self._cond:
            self._drainers += 1
        try:
            while True:
                with self._cond:
                    while self._round is not None:
                        self._cond.wait(1.0)
                    if not self._pending:
                        # exit decision + drainer retirement are ONE
                        # critical section: park_read enqueues its oid
                        # and checks _drainers under this lock, so it
                        # either hands the oid to a drainer that will
                        # see it, or sees 0 and kicks its own (review
                        # find: the split let a promoted oid strand in
                        # _pending until the bounded-wait EAGAIN)
                        self._drainers -= 1
                        return
                    # recovery is a QoS tenant: the round width comes
                    # from the feedback controller — widened while
                    # clients are idle, clamped under client pressure,
                    # the conf window when no scheduler is wired
                    base = max(1, int(self.osd.ctx.conf.get(
                        "osd_recovery_max_active")))
                    qos = getattr(self.osd, "qos", None)
                    w = (qos.recovery_window(base)
                         if qos is not None else base)
                    batch: List[str] = []
                    while self._pending and len(batch) < w:
                        oid = self._pending.popleft()
                        self._pending_set.discard(oid)
                        batch.append(oid)
                    if qos is not None:
                        qos.note_recovery_grant(len(batch))
                    rnd = self._round = _Round(batch)
                t_round = time.monotonic()
                tr = getattr(self.osd.ctx, "trace", None)
                if tr is not None and tr.enabled:
                    # one span per window round: the recovery twin of
                    # the write path's op spans — peer sub-read
                    # children hang off it via the vec wire context
                    rnd.span = tr.start_span(
                        f"pg{t_.pgid_str(self.pg.pgid)}.recovery.round")
                    rnd.span.annotate(f"window={len(rnd.oids)}")
                try:
                    self._run_round(rnd)
                finally:
                    with self._cond:
                        self._round = None
                        self._cond.notify_all()
                    op_perf = getattr(self.osd, "op_perf", None)
                    if op_perf is not None:
                        op_perf.hinc(
                            "lat_recovery_round_us",
                            (time.monotonic() - t_round) * 1e6)
                    if rnd.span is not None:
                        rnd.span.annotate(
                            f"concluded={len(rnd.concluded)}"
                            f"/{len(rnd.oids)}")
                        rnd.span.finish()
        except BaseException:
            with self._cond:
                self._drainers -= 1
            raise

    # -- one window --------------------------------------------------------
    def _run_round(self, rnd: _Round) -> None:
        pg = self.pg
        note = getattr(self.osd, "note_recovery_active", None)
        if note is not None:
            note(len(rnd.oids))
        timeout = float(
            self.osd.ctx.conf.get("osd_recovery_read_timeout"))
        ready_now: List[str] = []
        for oid in rnd.oids:
            with pg.lock:
                en = pg.log.latest_for(oid)
                still_missing = oid in pg.missing
            if not still_missing:
                # a push / superseding write landed since enqueue
                self._oid_resolved(rnd, oid, ok=True)
                continue
            if en is not None and en.op == t_.LOG_DELETE:
                self._apply_delete(oid)
                self._oid_resolved(rnd, oid, ok=True)
                continue
            pg._obc_invalidate(oid)  # local shards rewritten on success
            self._attempts[oid] = self._attempts.get(oid, 0) + 1
            # first attempt plans sub-chunk reads (clay: d helpers x
            # repair layers only); the replan attempt after any
            # failure falls back to the whole-chunk gather
            g = ChunkGather(pg, oid,
                            plan_repair=self._attempts[oid] == 1)
            with rnd.lock:
                rnd.gathers[oid] = g
                if not g.remote:
                    rnd.concluded.add(oid)
                    ready_now.append(oid)
                    continue
                for s, o, _is_cur in g.remote:
                    rnd.rows.setdefault(o, []).append((s, oid))
        for oid in ready_now:
            self._conclude_oid(rnd, oid, timed_out=False)
        if not rnd.rows:
            rnd.done.wait(30.0)  # reconstructs (if any) finish
            return

        def on_reply(rep) -> None:
            src = rep.src.num if rep.src else -1
            if isinstance(rep, m.MECSubReadVecReply):
                rows = rep.rows
                served = (rep.served
                          if len(rep.served) == len(rows)
                          else [0] * len(rows))
            elif isinstance(rep, m.MECSubReadReply):
                rows = [(rep.shard, rep.oid, rep.data, rep.result,
                         rep.attrs, rep.omap)]
                served = [0]
            else:
                return
            fresh: List[str] = []
            with rnd.lock:
                rnd.replied.add(src)
                for (shard, oid, data, result, attrs, omap), sv in zip(
                        rows, served):
                    g = rnd.gathers.get(oid)
                    if g is None or oid in rnd.concluded:
                        continue
                    if g.feed(shard, src, result, oid, data, attrs,
                              omap, served=sv):
                        rnd.concluded.add(oid)
                        fresh.append(oid)
            for oid in fresh:
                self._conclude_oid(rnd, oid, timed_out=False)

        tid = self.osd.track_reads(pg.pgid, on_reply)
        try:
            self._send_round(rnd, tid, legacy_only=False)
            rnd.done.wait(timeout)
            silent = self._silent_vec_peers(rnd)
            if silent:
                # mixed-version fallback: a peer that never answered
                # the vec may simply not speak it — ONE legacy
                # per-shard retry, and it is remembered as legacy-only
                # (a slow peer misclassified here loses aggregation,
                # not correctness)
                with self._cond:
                    self._no_vec |= silent
                self._send_round(rnd, tid, legacy_only=True,
                                 only_peers=silent)
                rnd.done.wait(timeout)
            # stragglers: conclude with the timeout verdict (retryable
            # when a current holder hung — recovery retries later)
            late: List[str] = []
            with rnd.lock:
                for oid in list(rnd.unresolved):
                    if oid in rnd.gathers and oid not in rnd.concluded:
                        rnd.concluded.add(oid)
                        late.append(oid)
            for oid in late:
                self._conclude_oid(rnd, oid, timed_out=True)
            rnd.done.wait(30.0)  # in-flight reconstruct/commit tail
        finally:
            self.osd.untrack_reads(tid)

    def _silent_vec_peers(self, rnd: _Round) -> Set[int]:
        omap_ = self.osd.osdmap
        with rnd.lock:
            if not rnd.unresolved:
                return set()
            return {o for o in rnd.vec_sent
                    if o not in rnd.replied
                    and (omap_ is None or omap_.is_up(o))}

    def _send_round(self, rnd: _Round, tid: int, legacy_only: bool,
                    only_peers: Optional[Set[int]] = None) -> None:
        pg = self.pg
        perf = getattr(self.osd, "pg_perf", None)
        epoch = self.osd.epoch()
        with self._cond:
            no_vec = set(self._no_vec)
        n_objs = 0
        with rnd.lock:
            peer_rows = {o: list(rows) for o, rows in rnd.rows.items()
                         if only_peers is None or o in only_peers}
            if not legacy_only:
                n_objs = len(rnd.gathers)
        unsendable: List[int] = []
        msgs = 0
        for osd_id, rows in sorted(peer_rows.items()):
            if legacy_only:
                # re-ask only for objects still unresolved
                with rnd.lock:
                    rows = [(s, oid) for s, oid in rows
                            if oid in rnd.unresolved
                            and oid not in rnd.concluded]
                if not rows:
                    continue
            if self.osd.addr_book.get(osd_id) is None:
                unsendable.append(osd_id)
                continue
            if legacy_only or osd_id in no_vec:
                for shard, oid in rows:
                    rd = m.MECSubRead(pg.pgid, epoch, shard, oid, 0, 0)
                    rd.tid = tid
                    self.osd.send_to_osd(osd_id, rd)
                    msgs += 1
            else:
                # per-row sub-chunk run plans (clay repair): runs from
                # the object's gather when this shard is one of its
                # planned helpers, else [] (whole chunk).  Rows keep
                # (off=0, len=0) so a legacy peer ignoring the v2 tail
                # still serves the whole chunk — its reply's served
                # flag tells feed() which layout came back.
                runs: List[List[Tuple[int, int]]] = []
                with rnd.lock:
                    for shard, oid in rows:
                        g = rnd.gathers.get(oid)
                        sp = g.sub_plan if g is not None else None
                        runs.append(list(sp[2])
                                    if sp is not None and shard in sp[1]
                                    else [])
                vec = m.MECSubReadVec(
                    pg.pgid, epoch,
                    [(shard, oid, 0, 0) for shard, oid in rows],
                    runs=runs)
                vec.tid = tid
                if rnd.span is not None:
                    # the peer opens its sub_read child off this round
                    vec.set_trace(rnd.span.context())
                self.osd.send_to_osd(osd_id, vec)
                with rnd.lock:
                    rnd.vec_sent.add(osd_id)
                msgs += 1
        if perf is not None:
            if msgs:
                perf.inc("subread_msgs", msgs)
            if n_objs:
                perf.inc("subread_ops", n_objs)
        if unsendable:
            ready: List[str] = []
            with rnd.lock:
                for oid, g in rnd.gathers.items():
                    if oid in rnd.concluded:
                        continue
                    hit = False
                    for o in unsendable:
                        hit = g.fail_peer(o) or hit
                    if hit and g.ready():
                        rnd.concluded.add(oid)
                        ready.append(oid)
            for oid in ready:
                self._conclude_oid(rnd, oid, timed_out=False)

    def _conclude_oid(self, rnd: _Round, oid: str,
                      timed_out: bool) -> None:
        g = rnd.gathers[oid]
        with rnd.lock:
            lay = (g.repair_layer_bytes() if g.repair_ready() else None)
            meta_r = g.cur_meta[0]
            if lay is not None and meta_r is not None \
                    and "hinfo" in meta_r[0]:
                # sub-chunk repair plan satisfied: rebuild the ONE lost
                # chunk from the helpers' repair layers on the batched
                # coupled-layer kernel — no full decode, no re-encode
                lost = g.sub_plan[0]
            else:
                lay = None
                avail, meta, retry = g.resolve(timed_out)
        if g.crc_failed:
            # recovery decoded around a checksum-failed holder: same
            # attribution + targeted-repair path as a client read
            self.pg._note_read_verify_fail(oid, g.crc_failed)
        if lay is not None:
            self.pg.backend.repair_chunk_async(
                oid, lost, lay,
                lambda chunk: self._commit_repaired(
                    rnd, oid, lost, chunk, meta_r, g.av_version,
                    g.wire_bytes))
            return
        if retry:
            self._oid_resolved(rnd, oid, ok=False, retry=True)
            return
        if not avail:
            # nothing anywhere and no holder unaccounted-for: there is
            # no data to rebuild — leave the missing marker for the
            # log's word (a delete adopted later clears it), and count
            # the object UNFOUND for the PGStat feed until a source
            # returns or the delete lands
            with self.pg.lock:
                if oid in self.pg.missing:
                    self.pg.unfound.add(oid)
            self._oid_resolved(rnd, oid, ok=False)
            return
        chunk_len = len(next(iter(avail.values())))
        wire = g.wire_bytes
        self.pg.backend.reconstruct_async(
            oid, avail, meta,
            lambda state: self._commit_recovered(rnd, oid, state,
                                                 g.av_version,
                                                 wire, chunk_len))

    def _commit_recovered(self, rnd: _Round, oid: str, state,
                          av_version, wire_bytes: int = 0,
                          chunk_len: int = 0) -> None:
        """Decode done (runs on a decode-completion thread): persist
        the rebuilt local shard(s) with the recovery stamp discipline
        and drop the object from pg.missing — individually, so reads
        (and parked recover-on-read waiters) unblock NOW."""
        if state is None or state is READ_RETRY:
            self._oid_resolved(rnd, oid, ok=False,
                               retry=state is READ_RETRY)
            return
        try:
            self._store_recovered(oid, state, av_version)
        except Exception as e:  # noqa: BLE001 — one object's failure
            # must not wedge the window; it stays missing and retries
            self.osd._log(1, f"pg {self.pg.pgid}: recovery commit of "
                             f"{oid} failed: {e!r}")
            self._oid_resolved(rnd, oid, ok=False)
            return
        self._note_repair_frac(wire_bytes, chunk_len)
        self._oid_resolved(rnd, oid, ok=True)

    def _commit_repaired(self, rnd: _Round, oid: str, lost: int,
                         chunk: Optional[bytes], meta, av_version,
                         wire_bytes: int) -> None:
        """Sub-chunk repair kernel done: land the ONE rebuilt chunk.
        A kernel/width failure resolves retryable — the engine's
        replan attempt re-gathers whole chunks, so the plan can only
        save bytes, never lose the object."""
        if not chunk:
            self._oid_resolved(rnd, oid, ok=False, retry=True)
            return
        try:
            self._store_repaired(oid, lost, chunk, meta, av_version)
        except Exception as e:  # noqa: BLE001 — same non-wedging
            # contract as _commit_recovered
            self.osd._log(1, f"pg {self.pg.pgid}: repair commit of "
                             f"{oid} failed: {e!r}")
            self._oid_resolved(rnd, oid, ok=False)
            return
        self._note_repair_frac(wire_bytes, len(chunk))
        self._oid_resolved(rnd, oid, ok=True)

    def _note_repair_frac(self, wire_bytes: int, chunk_len: int) -> None:
        """Recovery read-amplification accounting: numerator = chunk
        payload bytes this object's gather pulled over the wire,
        denominator = the k whole chunks a flat-RS rebuild reads.  The
        repair_read_frac gauge publishes the running ratio in PERMILLE
        (integer counters): clay sub-chunk plans land ~d*1000/(k*q)."""
        perf = getattr(self.osd, "pg_perf", None)
        if perf is None or chunk_len <= 0:
            return
        perf.inc("subread_bytes", wire_bytes)
        perf.inc("subread_full_bytes", self.pg.backend.k * chunk_len)
        full = perf.value("subread_full_bytes")
        if full > 0:
            perf.set("repair_read_frac",
                     perf.value("subread_bytes") * 1000 // full)

    def _store_repaired(self, oid: str, shard: int, chunk: bytes,
                        meta, av_version) -> None:
        """Persist ONE repaired chunk (the sub-chunk plan's landing):
        same REPLACE + recovery-stamp + _av-fence discipline as
        _store_recovered, but the payload is the repaired chunk itself
        — no object decode, no re-encode of k+m chunks."""
        from ceph_tpu_torch.osd.backend import _av_stamp, _hinfo, hinfo_decode
        from ceph_tpu_torch.store.objectstore import GHObject, Transaction

        pg = self.pg
        pg._obc_invalidate(oid)
        attrs_src, omap = meta
        size, _, _ = hinfo_decode(attrs_src["hinfo"])
        av = (_av_stamp(av_version) if av_version is not None
              else pg._av_for(oid))
        # same schedulable seam as the full-decode landing: thrash
        # tooling that races superseding writes hooks both paths
        failpoint("recovery.store_recovered", oid=oid,
                  av=str(av_version))
        t = Transaction()
        g = GHObject(oid, shard=shard)
        t.try_remove(pg.coll, g)
        t.write(pg.coll, g, 0, chunk)
        attrs = {k: v for k, v in attrs_src.items()
                 if k not in ("hinfo", "_av")}
        attrs["hinfo"] = _hinfo(chunk, size)
        attrs["_av"] = av
        t.setattrs(pg.coll, g, attrs)
        if omap:
            t.omap_setkeys(pg.coll, g, dict(omap))
        with pg.lock:
            if oid not in pg.missing:
                # a superseding write (or a push) resolved this object
                # mid-repair: its shards are NEWER than our chunk
                return
            if (av_version is not None
                    and pg.missing[oid] != av_version):
                # the fence moved while we repaired (same rule as
                # _store_recovered): the newer round owns the object
                return
            self.osd.store.queue_transaction(t)
            pg.missing.pop(oid, None)
            pg.unfound.discard(oid)
        self.osd.perf.inc("recovery_pushes")
        pg.note_recovery_io(1, len(chunk))

    def _store_recovered(self, oid: str, state, av_version) -> None:
        from ceph_tpu_torch.osd.backend import ECBackend, _av_stamp, _hinfo
        from ceph_tpu_torch.store.objectstore import GHObject, Transaction

        pg = self.pg
        be: ECBackend = pg.backend  # type: ignore[assignment]
        pg._obc_invalidate(oid)
        my_shards = be.local_shards(pg.acting)
        # stamp the generation this gather actually reconstructed —
        # NOT the log head at commit time: with the gate open during
        # the window, a superseding client write can land while the
        # decode is in flight, and stamping its version onto the OLD
        # image would launder stale bytes as current
        av = (_av_stamp(av_version) if av_version is not None
              else pg._av_for(oid))
        # schedulable seam between decode completion and the landing
        # txn: the window where a superseding write can race the
        # rebuilt image (the _av fence below is what must hold)
        failpoint("recovery.store_recovered", oid=oid,
                  av=str(av_version))
        # sync encode: concurrent window completions coalesce on the
        # StripeBatchQueue exactly like concurrent writes do
        chunks, _ = be._encode_object(state.data)
        t = Transaction()
        for shard in my_shards:
            g = GHObject(oid, shard=shard)
            # REPLACE semantics (handle_push discipline): setattrs
            # merges, so landing the rebuilt image over a stale shard
            # object resurrected the stale generation's xattrs — one
            # shard then carried ghost attrs its peers lacked, and
            # meta-ranked reads served rewound state as live (the
            # 0xd403 forensics' shard-attr disagreement)
            t.try_remove(pg.coll, g)
            t.write(pg.coll, g, 0, chunks[shard])
            attrs = dict(state.xattrs)
            attrs["hinfo"] = _hinfo(chunks[shard], len(state.data))
            attrs["_av"] = av
            t.setattrs(pg.coll, g, attrs)
            if state.omap:
                t.omap_setkeys(pg.coll, g, state.omap)
        with pg.lock:
            if oid not in pg.missing:
                # a superseding write (or a push) resolved this object
                # mid-decode: its shards are NEWER than our image —
                # landing ours would roll the object back
                return
            if (av_version is not None
                    and pg.missing[oid] != av_version):
                # the fence moved while we decoded: a newer interval's
                # pull re-marked this oid at a NEWER version — landing
                # our old image and popping THAT fence would leave a
                # permanently stale unfenced shard (review find); the
                # newer round owns the object now
                return
            self.osd.store.queue_transaction(t)
            pg.missing.pop(oid, None)
            pg.unfound.discard(oid)
        self.osd.perf.inc("recovery_pushes")
        pg.note_recovery_io(1, len(state.data))

    def _apply_delete(self, oid: str) -> None:
        from ceph_tpu_torch.osd.backend import ECBackend
        from ceph_tpu_torch.store.objectstore import GHObject, Transaction

        pg = self.pg
        be: ECBackend = pg.backend  # type: ignore[assignment]
        pg._obc_invalidate(oid)
        t = Transaction()
        for shard in be.local_shards(pg.acting):
            t.try_remove(pg.coll, GHObject(oid, shard=shard))
        self.osd.store.queue_transaction(t)
        with pg.lock:
            pg.missing.pop(oid, None)
            pg.unfound.discard(oid)
        # a parked read re-runs and reads the deletion honestly
        self._wake_parked(oid, ok=True)

    # -- resolution plumbing ----------------------------------------------
    def _oid_resolved(self, rnd: _Round, oid: str, ok: bool,
                      retry: bool = False) -> None:
        with rnd.lock:
            if oid not in rnd.unresolved:
                return
            rnd.unresolved.discard(oid)
            if not rnd.unresolved:
                rnd.done.set()
        requeued = False
        if not ok and retry and self._attempts.get(oid, 0) \
                < self.MAX_ATTEMPTS:
            # a peer died or hung mid-gather: one replan against the
            # current peer set (the window must not lose the slot)
            self._enqueue(oid, front=True)
            requeued = True
        if ok:
            self._attempts.pop(oid, None)
            self._wake_parked(oid, ok=True)
        elif not requeued:
            self._attempts.pop(oid, None)
            self._wake_parked(oid, ok=False)
        # requeued: parked waiters stay parked — their bounded-wait
        # timer still answers EAGAIN if the retry loses too

    def _note_park_wait(self, t0: float) -> None:
        op_perf = getattr(self.osd, "op_perf", None)
        if op_perf is not None:
            op_perf.hinc("lat_parked_read_us",
                         (time.monotonic() - t0) * 1e6)

    def _wake_parked(self, oid: str, ok: bool) -> None:
        with self._cond:
            waiters = self._parked.pop(oid, [])
        if not waiters:
            return
        for _wake, timer, t0 in waiters:
            timer.cancel()
            self._note_park_wait(t0)

        def fire() -> None:
            for wake, _timer, _t0 in waiters:
                try:
                    wake(ok)
                except Exception as e:  # noqa: BLE001 — one waiter's
                    # reply path must not kill the others
                    self.osd._log(1, f"pg {self.pg.pgid}: parked-read "
                                     f"wakeup failed: {e!r}")

        # fresh thread: wake re-runs the read under the pg lock, which
        # may be held across peer RPCs elsewhere — never block the
        # engine's commit/timer threads on it
        threading.Thread(target=fire, daemon=True,
                         name="pg-read-wake").start()

    def _park_timeout(self, oid: str, wake) -> None:
        with self._cond:
            rows = self._parked.get(oid, [])
            kept = [r for r in rows if r[0] is not wake]
            if len(kept) == len(rows):
                return  # already woken
            mine = next(r for r in rows if r[0] is wake)
            if kept:
                self._parked[oid] = kept
            else:
                self._parked.pop(oid, None)
        self._note_park_wait(mine[2])
        try:
            wake(False)  # bounded wait elapsed: EAGAIN as before
        except Exception as e:  # noqa: BLE001 — timer thread must survive
            self.osd._log(1, f"pg {self.pg.pgid}: parked-read timeout "
                             f"reply failed: {e!r}")
