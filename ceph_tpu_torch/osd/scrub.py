"""ScrubEngine — always-on chunked deep scrub with auto-repair.

Reference seams: the PG scrubber state machine (src/osd/scrubber/,
PG::chunky_scrub's chunked walk with preemption), ``osd_scrub_*`` conf
family (auto_repair, chunk_max, scrub scheduling), and the scrub class
of the mClock scheduler.  The shape kept here:

- **Chunked deep scrub.**  The engine walks a PG's objects in sorted
  order, ``osd_scrub_chunk_max`` objects per chunk.  EC chunks verify
  by *decode-and-reverify*: every shard is gathered (store reads are
  hinfo-crc vetted, so silently rotten bytes surface as
  missing-or-crc-mismatch), the object is decoded from a
  parity-preferring survivor signature through
  ``StripeBatchQueue.decode_data_async`` — all of a chunk's decodes are
  submitted before any is awaited, so they coalesce into wide device
  matmuls (the recovery path's decode discipline applied to
  verification) — and the re-encoded codeword is compared against
  every stored shard.  Replicated deep scrub keeps the cross-replica
  full-data digest compare.  **Shallow scrub** is metadata-only: one
  digest per object over (size, attr-version, user attrs, omap) with
  no data read, so it costs nothing on bytes — and misses exactly the
  silent data rot deep scrub exists to catch.

- **QoS tenant.**  Each deep chunk is admitted through the daemon's
  sharded workqueue under the mclock ``scrub`` class with a
  payload-byte cost tag, so dmClock arbitrates scrub reads against
  client io at admission; between chunks the engine yields — it pauses
  for the scrub-class token bucket (the class limit) and PREEMPTS
  (bounded wait) while the client-IOPS signal reads busy.

- **Resumable cursor.**  After every verified chunk the engine
  persists (mode, cursor) into the pg meta; a daemon kill or an
  interval change mid-scrub resumes from the cursor instead of
  restarting the walk.  The ``scrub.chunk`` failpoint sits at the top
  of each chunk — a barrier there is the deterministic
  kill-mid-scrub/resume seam.

- **Auto-repair.**  With ``osd_scrub_auto_repair`` (bounded by
  ``osd_scrub_auto_repair_num_errors``), inconsistent objects found by
  a deep scrub are repaired in place — EC content consensus picks the
  authoritative codeword and the bad shard is rebuilt with REPLACE
  semantics and the object's correct ``_av`` stamp
  (``PG._write_repaired_shard``); the repaired objects re-verify in
  the same run, and only what stays broken lands in
  ``pg.scrub_errors`` (the PG_DAMAGED feed).

Port of ``ceph_tpu/osd/scrub.py``: the same walk, messages, omap rows,
log lines and counters, with two differences, each named where it
sits:

(a) a chunk's decode rides the queue's ``dec`` kind when the codec has
    ``mds_recovery`` (the port's routing rule, as in
    ``ECBackend.reconstruct_async``), not when it merely has a
    ``recovery_matrix``: shec has one but no MDS recovery (an array
    codec, clay, rides the queue's ``cdec`` kind, as in the reference);
(b) ``_admit_chunk`` and ``_yield_between_chunks`` keep their
    ``getattr(osd, "wq"/"qos", None)`` seams: under the port's daemon
    (``osd/daemon.py``) each chunk is admitted through its workqueue
    under the ``scrub`` class and paced by its ``qos``; with no daemon
    behind the PG the chunk runs inline, the reference's own path
    without a ``qos``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ceph_tpu_torch.core import failpoint as fp
from ceph_tpu_torch.core.encoding import Decoder, Encoder
from ceph_tpu_torch.core.lockdep import make_lock
from ceph_tpu_torch.osd import types as t_

# pg-meta omap keys (ride _persist_meta's extra_omap)
CURSOR_KEY = "scrub_cursor"
STAMPS_KEY = "scrub_stamps"

# per-shard gather RPC timeout and the CHUNK's total verify budget:
# chunk verification holds the pg lock (write_blocked_by_scrub) and a
# workqueue shard, so its worst case must stay well inside the client
# op timeout — one dead-but-not-yet-marked-down peer costs at most
# GATHER_RPC_S per shard, and a chunk that exhausts its budget aborts
# WITHOUT advancing the cursor (the resume re-verifies it; found as a
# chaos-matrix op-timeout: 12 gathers x 3s behind one kill starved a
# client delete past its deadline)
GATHER_RPC_S = 3.0
CHUNK_BUDGET_S = 5.0


class _ChunkBudgetExceeded(Exception):
    """Raised between a chunk's object gathers when the verify budget
    is gone; the run aborts resumably (cursor NOT advanced)."""


def encode_stamps(last_scrub: float, last_deep: float,
                  errors: int) -> bytes:
    e = Encoder()
    e.f64(last_scrub).f64(last_deep).u64(errors)
    return e.bytes()


def decode_stamps(blob: bytes) -> Tuple[float, float, int]:
    d = Decoder(blob)
    return d.f64(), d.f64(), d.u64()


class ScrubEngine:
    """One per PG, lazily created on the primary (the recovery-engine
    shape).  run() is serialized by the PG's maintenance guard at the
    command/scheduler layer; the engine itself also refuses to nest."""

    def __init__(self, pg) -> None:
        self.pg = pg
        self.osd = pg.osd
        self._lock = make_lock(
            f"pg{t_.pgid_str(pg.pgid)}.scrub_engine")
        self._stop_ev = threading.Event()  # interruptible waits
        self.running = False
        self.deep = False
        self.cursor = ""          # last fully-verified object name
        self.preemptions = 0      # lifetime, for dump_scrubs
        self.last_errors: Dict[str, List[str]] = {}
        self.last_objects = 0     # objects verified by the last run

    # -- persistence -------------------------------------------------------
    def _load_cursor(self) -> Tuple[bool, str]:
        """(deep, cursor) persisted by an interrupted run, or
        (False, "")."""
        from ceph_tpu_torch.store.objectstore import GHObject

        try:
            om = self.osd.store.omap_get(self.pg.coll,
                                         GHObject("_pgmeta_"))
            blob = om.get(CURSOR_KEY)
            if not blob:
                return False, ""
            d = Decoder(blob)
            return bool(d.u8()), d.string()
        except Exception:
            return False, ""

    def _save_cursor(self, deep: bool, cursor: str) -> None:
        e = Encoder()
        e.u8(1 if deep else 0).string(cursor)
        self.pg._persist_meta(extra_omap={CURSOR_KEY: e.bytes()})

    def _clear_cursor_and_stamp(self, deep: bool, n_errors: int) -> None:
        """A COMPLETE pass: stamps + error count become durable, the
        cursor resets (the next scrub starts fresh)."""
        pg = self.pg
        now = time.time()
        with pg.lock:
            pg.last_scrub = now
            if deep:
                pg.last_deep_scrub = now
            pg.scrub_errors = n_errors
            # the scrub just recounted ground truth: read-time verify
            # attributions are folded into n_errors (or healed), so
            # future failures on the same objects count afresh
            pg._read_repair_pending.clear()
            stamps = encode_stamps(pg.last_scrub, pg.last_deep_scrub,
                                   pg.scrub_errors)
        e = Encoder()
        e.u8(0).string("")
        pg._persist_meta(extra_omap={CURSOR_KEY: e.bytes(),
                                     STAMPS_KEY: stamps})

    # -- QoS seams ---------------------------------------------------------
    def _perf(self, name: str, by: int = 1) -> None:
        pc = getattr(self.osd, "scrub_perf", None)
        if pc is not None:
            pc.inc(name, by)

    def _yield_between_chunks(self, cost_units: float) -> None:
        """The scrub tenant's pacing: charge the chunk to the scrub
        class token bucket (class limit) and preempt — bounded wait —
        while client IOPS read busy.  (b): no ``qos`` on the host, no
        pacing."""
        qos = getattr(self.osd, "qos", None)
        if qos is None:
            return
        pause = qos.background_pause("scrub", cost_units)
        if pause > 0:
            self._stop_ev.wait(min(pause, 1.0))
        conf = self.osd.ctx.conf
        busy = float(conf.get("osd_scrub_busy_client_iops"))
        if busy <= 0 or qos.client_iops() < busy:
            return
        self.preemptions += 1
        self._perf("preemptions")
        deadline = time.monotonic() + float(
            conf.get("osd_scrub_preempt_max_wait"))
        while (time.monotonic() < deadline
               and not self._stop_ev.is_set()
               and qos.client_iops() >= busy):
            self._stop_ev.wait(0.05)

    def _admit_chunk(self, fn, cost_units: float) -> None:
        """Run one chunk's verification THROUGH the daemon workqueue
        under the mclock scrub class (cost-tagged admission): dmClock
        decides when scrub reads go, clients never queue behind a
        whole scrub — only behind one bounded chunk.  (b): without a
        daemon's ``wq`` and ``qos`` the chunk runs inline."""
        qos = getattr(self.osd, "qos", None)
        wq = getattr(self.osd, "wq", None)
        if wq is None or qos is None:
            fn()
            return
        qos.note_admit("scrub", cost_units)
        done = threading.Event()
        err: List[BaseException] = []

        def job() -> None:
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                err.append(e)
            finally:
                done.set()

        wq.queue(self.pg.pgid, job, priority=1, qos_class="scrub",
                 qos_cost=cost_units, on_admit=qos.note_dequeue)
        done.wait()
        if err:
            raise err[0]

    # -- entry -------------------------------------------------------------
    def run(self, deep: bool,
            auto_repair: Optional[bool] = None) -> Dict[str, List[str]]:
        """One scrub pass; returns {oid: [error strings]} (empty =
        clean).  Deep passes are chunked/resumable; shallow passes are
        one metadata-only digest sweep.  A pass interrupted by an
        interval change returns its partial findings WITHOUT stamping
        (the resume finishes the walk and stamps)."""
        pg = self.pg
        with self._lock:
            if self.running:
                return dict(self.last_errors)
            self.running = True
            self.deep = deep
            self._stop_ev.clear()
        try:
            if deep:
                errors, complete = self._run_deep()
            else:
                errors = self._run_shallow()
                complete = True
            self._perf("errors_found", len(errors))
            auto = (bool(self.osd.ctx.conf.get("osd_scrub_auto_repair"))
                    if auto_repair is None else bool(auto_repair))
            cap = int(self.osd.ctx.conf.get(
                "osd_scrub_auto_repair_num_errors"))
            if errors and deep and auto and len(errors) <= cap:
                errors = self._auto_repair(errors)
            self.last_errors = errors
            if complete:
                self._clear_cursor_and_stamp(deep, len(errors))
                self._perf("deep_done" if deep else "shallow_done")
                self._log_outcome(deep, errors)
            return errors
        finally:
            with self._lock:
                self.running = False

    def abort(self) -> None:
        """Wake any pacing wait; the current chunk finishes, the
        cursor stays persisted (daemon shutdown path)."""
        self._stop_ev.set()

    def _log_outcome(self, deep: bool, errors: Dict[str, List[str]]
                     ) -> None:
        mode = "deep-scrub" if deep else "scrub"
        if errors:
            self.osd.ctx.log.cluster(
                "ERR", f"pg {self.pg.pgid} {mode}: {len(errors)} "
                       f"inconsistent objects: {sorted(errors)[:5]}")
        else:
            # clean passes stay off the cluster log (a scheduler
            # sweeping every PG would drown it); health clearing is
            # the PG_DAMAGED check's job via the PGStat feed
            self.osd._log(2, f"pg {self.pg.pgid} {mode}: clean")

    # -- shallow (metadata-only) ------------------------------------------
    def _run_shallow(self) -> Dict[str, List[str]]:
        """Cross-member metadata digest compare — shared by replicated
        and EC pools (the EC shallow fingerprint excludes per-shard
        fields like the hinfo crc, so healthy shards agree)."""
        errors: Dict[str, List[str]] = {}
        pg = self.pg
        with pg.lock:
            assert pg.is_primary(), "scrub runs on the primary"
        from ceph_tpu_torch.osd.pg import SCRUB_UNREADABLE

        maps = self.osd.collect_scrub_maps(pg, deep=False,
                                           rpc_timeout=GATHER_RPC_S)
        self._perf("objects", sum(len(m) for m in maps.values()))
        all_oids = set()
        for dm in maps.values():
            all_oids |= set(dm)
        for oid in sorted(all_oids):
            digests = {o: dm.get(oid) for o, dm in maps.items()}
            vals = set(digests.values())
            if len(vals) > 1 or vals == {SCRUB_UNREADABLE}:
                errors[oid] = [
                    f"osd.{o}: meta digest "
                    + ("missing" if dg is None
                       else "unreadable" if dg == SCRUB_UNREADABLE
                       else hex(dg))
                    for o, dg in sorted(digests.items())
                ]
        return errors

    # -- deep --------------------------------------------------------------
    def _run_deep(self) -> Tuple[Dict[str, List[str]], bool]:
        """Chunked byte-verifying walk.  Returns (errors, complete):
        complete=False when an interval change/abort stopped the walk
        with the cursor persisted for the resume."""
        pg = self.pg
        with pg.lock:
            assert pg.is_primary(), "scrub runs on the primary"
            start_interval = pg.interval_epoch
        saved_deep, saved_cursor = self._load_cursor()
        cursor = saved_cursor if saved_deep else ""
        if cursor:
            self._perf("resumes")
        chunk_max = max(1, int(self.osd.ctx.conf.get(
            "osd_scrub_chunk_max")))
        if not pg.is_ec():
            # replicated deep verification compares whole-PG scrub
            # maps (one RPC round per member) — chunking would refetch
            # the full maps per chunk for nothing
            chunk_max = 1 << 30
        errors: Dict[str, List[str]] = {}
        while True:
            names = [n for n in sorted(pg.backend.object_names())
                     if n > cursor]
            if not names:
                break
            chunk = names[:chunk_max]
            if fp.enabled("scrub.chunk"):
                fp.failpoint("scrub.chunk", pg=t_.pgid_str(pg.pgid),
                             first=chunk[0])
            cost = self._chunk_cost(chunk)
            box: Dict[str, List[str]] = {}

            def verify(c=chunk, b=box) -> None:
                # the whole per-chunk gather->decode->compare runs
                # under the PG lock so client writes cannot interleave
                # and read as phantom inconsistencies (the reference's
                # write_blocked_by_scrub, bounded to ONE chunk; peers
                # answer sub-reads without their primary-side lock, so
                # holding ours across the RPCs cannot deadlock — the
                # repair path already relies on this)
                with pg.lock:
                    if pg.is_ec():
                        b.update(self._verify_ec_chunk(c))
                    else:
                        b.update(self._verify_replicated_chunk(c))

            try:
                self._admit_chunk(verify, cost)
            except _ChunkBudgetExceeded:
                # the chunk burned its verify budget (dead peers mid
                # kill window): abort WITHOUT advancing the cursor —
                # the next pass re-verifies this chunk; what already
                # verified stays reported
                errors.update(box)
                self._save_cursor(True, cursor)
                return errors, False
            errors.update(box)
            cursor = chunk[-1]
            self.cursor = cursor
            self._perf("chunks")
            self._perf("objects", len(chunk))
            with pg.lock:
                interval_moved = (pg.interval_epoch != start_interval
                                  or not pg.is_primary())
            self._save_cursor(True, cursor)
            if interval_moved or self._stop_ev.is_set():
                # the walk stops HERE with the cursor durable: the
                # next run (same daemon or the revived one) resumes
                return errors, False
            self._yield_between_chunks(cost)
        self.cursor = ""
        return errors, True

    def _chunk_cost(self, oids: List[str]) -> float:
        """Scheduler cost units for one chunk: local stored bytes over
        the qos cost unit (cheap — store.stat reads no data)."""
        from ceph_tpu_torch.osd.qos import COST_UNIT_BYTES
        from ceph_tpu_torch.store.objectstore import GHObject, StoreError

        pg = self.pg
        nbytes = 0
        shards = (pg.backend.local_shards(pg.acting) if pg.is_ec()
                  else [-2])
        for oid in oids:
            for shard in shards:
                g = GHObject(oid) if shard == -2 else \
                    GHObject(oid, shard=shard)
                try:
                    nbytes += self.osd.store.stat(pg.coll, g)
                except StoreError:
                    pass  # absent local shard: it just costs nothing
        return max(1.0, nbytes / float(COST_UNIT_BYTES))

    def _verify_replicated_chunk(self, oids: List[str]
                                 ) -> Dict[str, List[str]]:
        """Replicated deep verify: the cross-replica full-data digest
        compare, restricted to this chunk's oids."""
        from ceph_tpu_torch.osd.pg import SCRUB_UNREADABLE

        errors: Dict[str, List[str]] = {}
        maps = self.osd.collect_scrub_maps(self.pg, deep=True,
                                           rpc_timeout=GATHER_RPC_S)
        want = set(oids)
        all_oids = set()
        for dm in maps.values():
            all_oids |= set(dm) & want
        for oid in sorted(all_oids):
            digests = {o: dm.get(oid) for o, dm in maps.items()}
            vals = set(digests.values())
            if len(vals) > 1 or vals == {SCRUB_UNREADABLE}:
                errors[oid] = [
                    f"osd.{o}: digest "
                    + ("missing" if dg is None
                       else "unreadable" if dg == SCRUB_UNREADABLE
                       else hex(dg))
                    for o, dg in sorted(digests.items())
                ]
        return errors

    def _verify_ec_chunk(self, oids: List[str]) -> Dict[str, List[str]]:
        """EC decode-and-reverify with device-coalesced decodes: every
        object's gather runs first, every decode is submitted to the
        StripeBatchQueue before any is awaited (same survivor
        signature -> one wide recovery matmul), then each object's
        re-encoded codeword is compared against its stored shards."""
        pg = self.pg
        be = pg.backend
        k = be.k
        n = k + be.m
        errors: Dict[str, List[str]] = {}
        queue = getattr(be, "queue", None)
        with pg.lock:
            missing = set(pg.missing)
        with pg._pipe_lock:
            # objects with a client write admitted or mid-pipeline:
            # their shards legitimately span two generations until the
            # fan-out lands everywhere
            busy = {o for o, p in pg._oid_pipes.items()
                    if p.busy or p.queue}
        # phase 1: gather every object's shards (the slow RPC part),
        # under a TOTAL chunk budget — the per-RPC timeout bounds one
        # fetch, the budget bounds the chunk
        t_chunk = time.monotonic()
        gathered = []  # (oid, avail, metas, pre_errors, sig)
        for oid in oids:
            if oid in missing or oid in busy:
                # recovering / write-in-flight: not scrubbable state —
                # skip silently, the next pass re-judges (reporting it
                # would be a phantom error, and auto-REPAIRING a
                # mid-flight stripe can destroy an acked write)
                continue
            if time.monotonic() - t_chunk > CHUNK_BUDGET_S:
                raise _ChunkBudgetExceeded()
            with pg.lock:
                acting = list(pg.acting[:n])
            # short gather timeout: the chunk verify holds the pg lock
            # (write_blocked_by_scrub), and a peer dying mid-gather
            # must cost seconds, not the full 10s RPC window per shard
            # — client writes to this PG are waiting behind us
            avail, metas, lost = pg._ec_gather(
                oid, rpc_timeout=GATHER_RPC_S)
            # generation gate: the pipelined write engine fans shard
            # applies out asynchronously, so a concurrent write leaves
            # shards briefly on TWO _av stamps.  A mixed-generation
            # gather must be skipped, never judged: decoding it
            # produces garbage that reads as damage, and auto-repair
            # would then rewrite healthy shards from the poisoned
            # decode (the chaos-matrix acked-append loss, seed 0xc408).
            stamps = {metas[s][0].get("_av") for s in avail
                      if metas.get(s) is not None}
            if len(stamps) > 1:
                continue
            errs = [f"shard {s} (osd.{acting[s] if s < len(acting) else '?'})"
                    f": missing or crc mismatch" for s in lost]
            sig: Tuple[int, ...] = ()
            if len(avail) >= k:
                # parity-preferring signature: verification is a TRUE
                # decode (the systematic identity map verifies nothing)
                sig = tuple(sorted(avail)[-k:])
            gathered.append((oid, avail, metas, errs, sig))
        # phase 2: submit every decode in a tight loop so jobs sharing
        # a survivor signature coalesce into ONE device matmul (the
        # whole point of streaming the PG through decode_data_async —
        # submitting inside the gather loop would hand the worker one
        # job per RPC round-trip and the batching engine would idle)
        jobs = []
        for oid, avail, metas, errs, sig in gathered:
            fut = None
            if sig:
                widths = {len(avail[i]) for i in sig}
                # (a) the queue's dec kind takes MDS codecs only
                flat = bool(getattr(be.codec, "mds_recovery", False))
                clay = be.codec.is_array
                if (queue is not None and len(widths) == 1
                        and (flat or clay)
                        and sig != tuple(range(k))):
                    arrs = {i: np.frombuffer(avail[i], dtype=np.uint8)
                            for i in sig}
                    be._note_decode_job()
                    if flat:
                        fut = queue.decode_data_async(be.codec, arrs)
                    else:
                        # array codec (clay): the batched coupled-layer
                        # decode kind; the parity-preferring k-survivor
                        # signature makes it a true decode, and objects
                        # sharing a signature coalesce into one pass
                        fut = queue.clay_decode_async(be.codec, arrs)
            jobs.append((oid, avail, metas, errs, sig, fut))
        for oid, avail, metas, errs, sig, fut in jobs:
            bad = list(errs)
            if len(avail) >= be.k:
                st = self._resolve_state(oid, avail, metas, sig, fut)
                if st is None:
                    bad.append("decode failed")
                else:
                    enc, _ = be._encode_object(st.data)
                    for shard, have in sorted(avail.items()):
                        if enc[shard][: len(have)] != have:
                            bad.append(f"shard {shard}: parity mismatch")
                    if not bad:
                        # clean decode + parity compare: the scrub just
                        # PROVED every stored chunk byte — local shards
                        # whose hinfo crc a partial overwrite
                        # invalidated get re-sealed, restoring the
                        # whole-chunk crc for future reads
                        self._reseal_hinfo(oid, avail, len(st.data))
            if bad:
                errors[oid] = bad
        return errors

    def _reseal_hinfo(self, oid: str, avail, obj_size: int) -> None:
        """Re-stamp a VALID hinfo crc on local shards carrying an
        invalidated one (partial-overwrite leftovers), from chunk bytes
        a clean decode-and-reverify just vouched for.  hinfo-only
        setattrs merge: data, _av and user attrs stay untouched, so
        this is safe under the chunk's pg-lock window (the busy /
        missing / mixed-stamp gates already excluded in-flight
        objects)."""
        from ceph_tpu_torch.osd.backend import _hinfo, hinfo_decode
        from ceph_tpu_torch.store.objectstore import GHObject, Transaction

        pg = self.pg
        be = pg.backend
        t = None
        for shard in be.local_shards(pg.acting):
            if shard not in avail:
                continue
            g = GHObject(oid, shard=shard)
            try:
                _, _, valid = hinfo_decode(
                    self.osd.store.getattr(pg.coll, g, "hinfo"))
            except Exception:
                continue  # absent/garbled hinfo: repair's job, not ours
            if valid:
                continue
            if t is None:
                t = Transaction()
            t.setattrs(pg.coll, g,
                       {"hinfo": _hinfo(avail[shard], obj_size)})
            self._perf("hinfo_reseals")
        if t is not None:
            self.osd.store.queue_transaction(t)

    def _resolve_state(self, oid: str, avail, metas, sig, fut):
        be = self.pg.backend
        meta = metas.get(min(avail)) if avail else None
        if fut is not None:
            try:
                data = fut.result(timeout=30.0)
                # the port's queue answers host arrays; a tensor (on
                # the card or not) comes to the host here
                data = (data.cpu().numpy() if torch.is_tensor(data)
                        else np.asarray(data))
            except Exception:
                return be.reconstruct(oid, avail, meta=meta)
            planes = np.stack([data[i] for i in range(be.k)])
            return be._state_from_planes(oid, planes, avail, meta)
        return be.reconstruct(oid, avail, meta=meta)

    # -- auto-repair -------------------------------------------------------
    def _auto_repair(self, errors: Dict[str, List[str]]
                     ) -> Dict[str, List[str]]:
        """Repair the found inconsistencies in place and RE-VERIFY the
        repaired objects; returns what is still broken."""
        pg = self.pg
        oids = sorted(errors)
        try:
            pg.repair_objects(oids, rpc_timeout=5.0)
        except Exception as e:  # noqa: BLE001 — a wedged repair must
            # not kill the scrub pass; the errors stay reported
            self.osd._log(1, f"pg {pg.pgid}: auto-repair failed: {e!r}")
            return errors
        try:
            with pg.lock:  # re-verify serialized vs client writes too
                if pg.is_ec():
                    still = self._verify_ec_chunk(oids)
                else:
                    still = self._verify_replicated_chunk(oids)
        except _ChunkBudgetExceeded:
            # couldn't prove the repair inside the budget: keep the
            # errors reported, the next scrub pass re-judges
            return errors
        repaired = [o for o in oids if o not in still]
        self._perf("errors_repaired", len(repaired))
        if repaired:
            self.osd.ctx.log.cluster(
                "INF", f"pg {pg.pgid} auto-repair: "
                       f"{len(repaired)} objects repaired"
                       f"{', ' + str(len(still)) + ' remain' if still else ''}")
        return still

    # -- evidence ----------------------------------------------------------
    def dump(self) -> dict:
        pg = self.pg
        with self._lock:
            return {
                "pgid": t_.pgid_str(pg.pgid),
                "running": self.running,
                "deep": self.deep,
                "cursor": self.cursor,
                "last_scrub": pg.last_scrub,
                "last_deep_scrub": pg.last_deep_scrub,
                "scrub_errors": pg.scrub_errors,
                "preemptions": self.preemptions,
                "last_run_errors": len(self.last_errors),
            }
