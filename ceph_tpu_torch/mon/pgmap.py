"""PGMapService — the mon's transient cluster-telemetry digest.

Port of ``ceph_tpu/mon/pgmap.py``, all of it, on the host: the same
rows, digest and JSON for the same reports (timestamps aside), which
``tests/test_torch_mon_xcheck.py`` holds equal to the reference's.

Reference: src/mon/PGMap.{h,cc} + the mgr's MgrStatMonitor role — the
per-OSD MPGStats feed is aggregated into ONE cluster view: per-pool
``df``, pg-state counts, degraded/misplaced/unfound object totals, and
rate-derived client IOPS/BW + recovery objects/s.  Like the reference
PGMap (and unlike every PaxosService), nothing here is paxos-committed:
every mon keeps its own copy fed by the same reports, and a mon restart
simply re-learns the digest from the next report interval.

Rates come from a shared ``core.perf.SnapshotRing`` of cumulative
cluster totals: each ingested report folds its windowed deltas into the
cumulative counters and pushes a snapshot, and ``digest()`` differences
ring endpoints over ``mon_stats_rate_window`` — so `ceph -s`, cephtop's
cluster pane, and the bench telemetry aux (which all read this digest)
agree by construction.  The mgr ProgressModule's ETA deliberately does
NOT use this windowed ring: it divides an event's cumulative recovered
count by elapsed-since-start (a smoother estimator for a monotone
clamp), so its implied rate can differ from the digest's windowed one
during non-constant-rate recovery.

Stuck-PG tracking: every per-PG row carries ``state_since`` — the stamp
of the last observed state CHANGE (not the last report), so
``stuck_pgs()`` can answer "state unchanged past mon_pg_stuck_threshold"
with honest stuck-since evidence.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.core.lockdep import make_lock
from ceph_tpu_torch.core.perf import SnapshotRing
from ceph_tpu_torch.osd.types import PGId, PGStat

# cumulative cluster counters the rate ring tracks: client io folds
# from primary rows only (replica rows describe the same logical io),
# recovery io from EVERY row (it lands on whichever osd did the work —
# pull-based self-recovery or push receipt — and per-osd counters are
# disjoint, so a recovering replica's rate must not be dropped)
_CLIENT_KEYS = ("cl_wr_ops", "cl_wr_bytes", "cl_rd_ops", "cl_rd_bytes")
_REC_KEYS = ("rec_ops", "rec_bytes")
_RATE_KEYS = _CLIENT_KEYS + _REC_KEYS


class _OsdReport:
    """Latest report from one OSD (stamp + rich rows + health signals)."""

    __slots__ = ("stamp", "epoch", "stats", "used", "total", "slow_ops",
                 "heartbeat_misses", "prev_heartbeat_misses")

    def __init__(self) -> None:
        self.stamp = 0.0
        self.epoch = 0
        self.stats: List[PGStat] = []
        self.used = 0
        self.total = 0
        self.slow_ops = 0
        self.heartbeat_misses = 0
        self.prev_heartbeat_misses = 0


class PGMapService:
    """Aggregates MPGStats reports; serves the `ceph -s`/`df`/health
    digest.  Thread-safe: ingest runs on the mon's dispatch path,
    digest() on command threads."""

    def __init__(self, conf, now_fn=time.time, pool_size_fn=None,
                 osd_up_fn=None) -> None:
        self.conf = conf
        self._now = now_fn
        # pool_id -> replica width (replicated size / EC k+m), from the
        # owning mon's pool table: degraded counts missing COPIES, so
        # the ratio's denominator must be objects x width, not objects
        self._pool_size = pool_size_fn
        # osd -> is the map's view of it UP?  A down-marked osd's last
        # report stays "fresh" for up to stale_s, but its testimony is
        # void: its own missing-set became acting-set holes the primary
        # now counts, and summing both would double-count the debt for
        # the whole staleness window
        self._osd_up = osd_up_fn
        self._lock = make_lock("mon.pgmap")
        self.reports: Dict[int, _OsdReport] = {}
        # pgid -> {stat, reported_by, stamp, state_since}: the
        # primary's row wins; replicas only fill gaps
        self.pg: Dict[PGId, dict] = {}
        # cumulative cluster io totals + the rate ring over them
        self._totals = {k: 0 for k in _RATE_KEYS}
        self.ring = SnapshotRing(capacity=256)

    # -- feed -------------------------------------------------------------
    def ingest(self, osd: int, epoch: int, stats: List[PGStat],
               used: int, total: int, slow_ops: int = 0,
               heartbeat_misses: int = 0,
               stamp: Optional[float] = None) -> None:
        now = self._now() if stamp is None else stamp
        with self._lock:
            rep = self.reports.get(osd)
            if rep is None:
                rep = self.reports[osd] = _OsdReport()
                # first report: the cumulative counter's history is not
                # growth — a mon restart/failover must not read every
                # past miss as a live OSD_SLOW_HEARTBEAT
                rep.heartbeat_misses = heartbeat_misses
            rep.prev_heartbeat_misses = rep.heartbeat_misses
            rep.stamp = now
            rep.epoch = epoch
            rep.stats = list(stats)
            rep.used, rep.total = used, total
            rep.slow_ops = slow_ops
            rep.heartbeat_misses = heartbeat_misses
            for s in stats:
                row = self.pg.get(s.pgid)
                if row is None or s.primary or (
                        not row["stat"].primary
                        and row["reported_by"] == osd):
                    since = now
                    if row is not None and row["stat"].state == s.state:
                        since = row["state_since"]
                    self.pg[s.pgid] = {"stat": s, "reported_by": osd,
                                       "stamp": now,
                                       "state_since": since}
                if s.primary:
                    for k in _CLIENT_KEYS:
                        self._totals[k] += getattr(s, k)
                for k in _REC_KEYS:
                    self._totals[k] += getattr(s, k)
            self.ring.push(dict(self._totals), stamp=now)

    # -- views ------------------------------------------------------------
    def _up(self, osd: int) -> bool:
        """The map's view of a reporter; True when no osd_up_fn is
        wired (standalone/test construction keeps old semantics)."""
        if self._osd_up is None:
            return True
        try:
            return bool(self._osd_up(osd))
        except Exception:
            return True

    def _fresh_rows(self, now: float, stale_s: float) -> List[dict]:
        return [row for row in self.pg.values()
                if now - row["stamp"] <= stale_s]

    def digest(self) -> dict:
        """The PGMap digest behind `ceph -s` / `ceph df` / the
        Prometheus cluster gauges."""
        now = self._now()
        stale_s = float(self.conf.get("mon_pg_stats_stale_s"))
        window = float(self.conf.get("mon_stats_rate_window"))
        with self._lock:
            rows = self._fresh_rows(now, stale_s)
            pg_states: Dict[str, int] = {}
            pools: Dict[int, dict] = {}
            tot = {"objects": 0, "bytes": 0, "degraded": 0,
                   "misplaced": 0, "unfound": 0, "log_entries": 0,
                   "scrub_errors": 0}
            damaged_pgs = 0
            for row in rows:
                s: PGStat = row["stat"]
                if not s.primary:
                    continue
                if s.scrub_errors:
                    tot["scrub_errors"] += s.scrub_errors
                    damaged_pgs += 1
                pg_states[s.state] = pg_states.get(s.state, 0) + 1
                pool = pools.setdefault(
                    s.pgid[0], {"objects": 0, "bytes": 0, "degraded": 0,
                                "misplaced": 0, "unfound": 0, "pgs": 0})
                pool["objects"] += s.num_objects
                pool["bytes"] += s.num_bytes
                pool["misplaced"] += s.misplaced
                pool["unfound"] += s.unfound
                pool["pgs"] += 1
                tot["objects"] += s.num_objects
                tot["bytes"] += s.num_bytes
                tot["misplaced"] += s.misplaced
                tot["unfound"] += s.unfound
                tot["log_entries"] += s.log_size
            # degraded sums over EVERY fresh live reporter's rows, NOT
            # the primary-wins map: after a revive the missing copies
            # live in the recovering REPLICA's own pg.missing, which
            # only its non-primary row carries (the primary reads
            # holes=0 the moment the peer is back up).  The osd-side
            # formula keeps live rows disjoint — only the primary
            # counts acting-set holes, every row counts only its OWN
            # missing — and down-marked reporters are skipped (their
            # missing became the holes the primary already counts).
            for osd, r in self.reports.items():
                if now - r.stamp > stale_s or not self._up(osd):
                    continue
                for s in r.stats:
                    if s.degraded:
                        tot["degraded"] += s.degraded
                        pools.setdefault(
                            s.pgid[0],
                            {"objects": 0, "bytes": 0, "degraded": 0,
                             "misplaced": 0, "unfound": 0, "pgs": 0}
                        )["degraded"] += s.degraded
            # fullness from fresh live reporters only: a dead osd's
            # capacity is gone, and its last statfs must not inflate
            # cluster totals for the whole staleness window (let alone
            # forever — reports are never pruned)
            used = sum(r.used for osd, r in self.reports.items()
                       if now - r.stamp <= stale_s and self._up(osd))
            total = sum(r.total for osd, r in self.reports.items()
                        if now - r.stamp <= stale_s and self._up(osd))
            slow = {osd: r.slow_ops for osd, r in self.reports.items()
                    if r.slow_ops and now - r.stamp <= stale_s}
        # degraded counts missing COPIES (n*holes per PG), so the ratio
        # denominator is objects x pool width; without a pool table the
        # width defaults to 1 and the ratio clamps at 1.0 rather than
        # report >100% damage
        copies = 0
        for pid, pool in pools.items():
            width = 1
            if self._pool_size is not None:
                width = self._pool_size(pid) or 1
            copies += pool["objects"] * width
        return {
            "pg_states": dict(sorted(pg_states.items())),
            "num_pgs": sum(pg_states.values()),
            "pools": pools,
            "objects": tot["objects"],
            "bytes": tot["bytes"],
            "pg_log_entries": tot["log_entries"],
            "degraded_objects": tot["degraded"],
            "total_copies": copies,
            "degraded_ratio": round(
                min(1.0, tot["degraded"] / (copies or 1)), 4),
            "misplaced_objects": tot["misplaced"],
            "unfound_objects": tot["unfound"],
            # scrub damage attribution (primary rows): inconsistent
            # objects the latest scrubs left unrepaired -> PG_DAMAGED
            "scrub_errors": tot["scrub_errors"],
            "damaged_pgs": damaged_pgs,
            "used_bytes": used,
            "total_bytes": total,
            "slow_ops": slow,
            "io": {
                "client_read_ops_per_s": round(
                    self.ring.rate("cl_rd_ops", window, now=now), 2),
                "client_write_ops_per_s": round(
                    self.ring.rate("cl_wr_ops", window, now=now), 2),
                "client_read_bytes_per_s": round(
                    self.ring.rate("cl_rd_bytes", window, now=now), 1),
                "client_write_bytes_per_s": round(
                    self.ring.rate("cl_wr_bytes", window, now=now), 1),
                "recovery_objects_per_s": round(
                    self.ring.rate("rec_ops", window, now=now), 2),
                "recovery_bytes_per_s": round(
                    self.ring.rate("rec_bytes", window, now=now), 1),
            },
        }

    def pg_rows(self, fresh_only: bool = False) -> List[dict]:
        """Rich `pg dump` rows (primary-reported rows win).  With
        ``fresh_only`` rows past mon_pg_stats_stale_s are dropped — the
        same filter digest() applies, so health-check DETAIL built from
        these rows names the same PG set the summaries count.

        A row's ``degraded`` is the CROSS-REPORT sum for that pg (same
        disjoint-rows derivation as digest()): the winning primary row
        reads holes=0 the moment a dead peer is marked up, while the
        revived replica's catch-up debt lives in its own non-primary
        row — a consumer watching one row (the mgr ProgressModule's
        recovery events, `pg dump`) must not see the debt vanish at
        revive and declare recovery complete while objects are still
        being pulled."""
        now = self._now()
        stale_s = float(self.conf.get("mon_pg_stats_stale_s"))
        with self._lock:
            deg_by_pg: Dict[PGId, int] = {}
            for osd, r in self.reports.items():
                if now - r.stamp > stale_s or not self._up(osd):
                    continue
                for s in r.stats:
                    deg_by_pg[s.pgid] = \
                        deg_by_pg.get(s.pgid, 0) + s.degraded
            out = []
            for pgid in sorted(self.pg):
                row = self.pg[pgid]
                if fresh_only and now - row["stamp"] > stale_s:
                    continue
                s: PGStat = row["stat"]
                out.append({
                    "pgid": f"{pgid[0]}.{pgid[1]}",
                    "state": s.state,
                    "num_objects": s.num_objects,
                    "num_bytes": s.num_bytes,
                    "log_size": s.log_size,
                    # cross-report sum; the winning row's own value
                    # only when every reporter went stale/down
                    "degraded": deg_by_pg.get(pgid, s.degraded),
                    "misplaced": s.misplaced,
                    "unfound": s.unfound,
                    "last_update": [s.last_update.epoch,
                                    s.last_update.version],
                    "reported_by": row["reported_by"],
                    "primary": s.primary,
                    "state_since": row["state_since"],
                    "scrub_errors": s.scrub_errors,
                    "last_scrub": s.last_scrub,
                    "last_deep_scrub": s.last_deep_scrub,
                })
            return out

    def not_deep_scrubbed(self, warn_age_s: Optional[float] = None
                          ) -> List[dict]:
        """Primary PGs whose last deep scrub is older than the warn
        age (never-deep-scrubbed stamps read as infinitely old).
        Empty when the check is disabled (warn age <= 0, the conf
        default) — always-on deep scrub is the OSD scheduler's job;
        this is the mon-side evidence it actually ran."""
        if warn_age_s is None:
            warn_age_s = float(self.conf.get(
                "mon_warn_not_deep_scrubbed_s"))
        if warn_age_s <= 0:
            return []
        now = self._now()
        stale_s = float(self.conf.get("mon_pg_stats_stale_s"))
        with self._lock:
            out = []
            for pgid in sorted(self.pg):
                row = self.pg[pgid]
                s: PGStat = row["stat"]
                if not s.primary or now - row["stamp"] > stale_s:
                    continue
                if now - s.last_deep_scrub >= warn_age_s:
                    out.append({
                        "pgid": f"{pgid[0]}.{pgid[1]}",
                        "last_deep_scrub": s.last_deep_scrub,
                        "age_s": round(
                            now - s.last_deep_scrub, 1)
                        if s.last_deep_scrub else None,
                    })
            return out

    def stuck_pgs(self, threshold_s: Optional[float] = None) -> List[dict]:
        """PGs sitting in a non-active state past the stuck threshold,
        with honest stuck-since stamps (state-CHANGE tracked, not
        last-report)."""
        if threshold_s is None:
            threshold_s = float(self.conf.get("mon_pg_stuck_threshold"))
        now = self._now()
        stale_s = float(self.conf.get("mon_pg_stats_stale_s"))
        with self._lock:
            out = []
            for pgid in sorted(self.pg):
                row = self.pg[pgid]
                s: PGStat = row["stat"]
                if now - row["stamp"] > stale_s:
                    continue  # stale reporters get MON_STALE_PG_REPORTS
                if s.state.startswith("active"):
                    # active+degraded/+recovering serve client io — a
                    # long recovery is PG_DEGRADED/OBJECT_DEGRADED's
                    # story, not "stuck in a non-active state"
                    continue
                stuck_for = now - row["state_since"]
                if stuck_for >= threshold_s:
                    out.append({"pgid": f"{pgid[0]}.{pgid[1]}",
                                "state": s.state,
                                "stuck_for_s": round(stuck_for, 1)})
            return out

    def stale_osds(self, live_osds, stale_s: Optional[float] = None
                   ) -> List[Tuple[int, float]]:
        """Up OSDs whose reports went stale: (osd, seconds since the
        last report).  An osd that NEVER reported doesn't count — it
        may still be booting; the map's down-marking owns that case."""
        if stale_s is None:
            stale_s = float(self.conf.get("mon_pg_stats_stale_s"))
        now = self._now()
        with self._lock:
            out = []
            for osd in live_osds:
                rep = self.reports.get(osd)
                if rep is not None and rep.stamp and \
                        now - rep.stamp > stale_s:
                    out.append((osd, round(now - rep.stamp, 1)))
            return out

    def slow_heartbeat_osds(self) -> List[int]:
        """OSDs whose heartbeat-miss counter grew between their two
        most recent reports (the PR-7 heartbeat_misses feed): live
        evidence of peers starving heartbeats right now, not a stale
        historical total."""
        now = self._now()
        stale_s = float(self.conf.get("mon_pg_stats_stale_s"))
        with self._lock:
            return sorted(
                osd for osd, r in self.reports.items()
                if now - r.stamp <= stale_s
                and r.heartbeat_misses > r.prev_heartbeat_misses)
