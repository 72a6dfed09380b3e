"""PaxosService family: Config/Log/Health/Auth monitors.

Port of ``ceph_tpu/mon/services.py``, all of it (``MDSMonitor`` too:
its paxos state answers ``fs status`` and feeds ``health`` before the
port has an MDS daemon).  ``encode_payload`` gives the reference's bytes
and every KV row is the reference's, so the services of a port mon and
a reference mon commit and apply the same values.

Reference: src/mon/PaxosService.{h,cc} — each cluster service keeps its
own versioned state machine, but ALL of them serialize their commits
through the monitor's single Paxos instance.  Same inversion here: a
service mutation is proposed as a tagged value (SVC_TAG + JSON payload)
on the same paxos stream that carries OSDMap commits; every mon —
leader and peons alike — applies it in `_learn`, so service state is
exactly as replicated and exactly as durable as the map itself.

Services (each cites its reference counterpart):
- ConfigMonitor  (src/mon/ConfigMonitor.cc): centralized config db,
  `config set/rm/get/dump`, applied to the local daemon config when the
  section matches (the reference pushes config to subscribed daemons;
  here daemons read it via `config get` / the mon applies it locally).
- LogMonitor    (src/mon/LogMonitor.cc): the cluster log — `log` adds
  an entry through paxos, `log last` reads the tail; bounded retention.
- HealthMonitor (src/mon/HealthMonitor.cc): health checks derived from
  the osdmap (down/out OSDs) plus persisted mutes; `health` returns
  HEALTH_OK/WARN + the check list.
- AuthMonitor   (src/mon/AuthMonitor.cc): entity key db on top of the
  cephx keyring — `auth get-or-create/get/ls/rm`; new keys replicate
  through paxos so every mon's CephxServer can validate them.

Commit semantics: mutating commands return after the value is QUEUED on
the leader's paxos (on a single-mon cluster that is synchronous commit,
matching the tests; on multi-mon the commit lands one accept round
later) — the same asynchrony the map-mutation path already has.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.store.kv import WriteBatch

# paxos-value tag for service payloads; map values use 0/1
# (ceph_tpu/osd/map_inc.py FULL_TAG/INC_TAG)
SVC_TAG = 0xD5


def encode_payload(svc: str, payload: dict) -> bytes:
    return bytes([SVC_TAG]) + json.dumps(
        {"svc": svc, **payload}, sort_keys=True).encode()


def decode_payload(value: bytes) -> dict:
    return json.loads(value[1:].decode())


class PaxosService:
    """One service state machine multiplexed onto the mon's Paxos."""

    name = ""

    def __init__(self, mon) -> None:
        self.mon = mon
        self.kv = mon.kv

    def load(self) -> None:
        """Restore committed state from the mon's KV."""

    def apply(self, payload: dict, batch: WriteBatch) -> None:
        """Apply one committed payload — runs on EVERY mon.  All KV
        persistence goes into `batch`, which the monitor submits
        atomically WITH the paxos value (a crash can never separate a
        committed value from its effect)."""

    def command(self, cmd: dict) -> Optional[Tuple[int, dict]]:
        """Handle a mon command; None = not mine."""
        return None

    def health_checks(self) -> Dict[str, dict]:
        """Contribution to `health` output."""
        return {}

    def snapshot(self) -> Optional[dict]:
        """JSON-serializable committed state for mon store sync (the
        reference's full-store-sync role: a mon that jumped a paxos
        version gap pulls every service's state wholesale)."""
        return None

    def restore(self, snap: dict, batch: WriteBatch) -> None:
        """Adopt a snapshot (persistence into `batch`)."""

    def propose(self, payload: dict) -> None:
        self.mon.propose(encode_payload(self.name, payload))


class ConfigMonitor(PaxosService):
    name = "config"

    def __init__(self, mon) -> None:
        super().__init__(mon)
        self.db: Dict[str, Dict[str, str]] = {}  # section -> key -> value

    def load(self) -> None:
        raw = self.kv.get("svc_config", "db")
        self.db = json.loads(raw.decode()) if raw else {}

    def apply(self, payload: dict, batch: WriteBatch) -> None:
        op = payload["op"]
        who, key = payload["who"], payload.get("key", "")
        if op == "set":
            self.db.setdefault(who, {})[key] = payload["value"]
        elif op == "rm":
            self.db.get(who, {}).pop(key, None)
        batch.set("svc_config", "db", json.dumps(self.db).encode())
        # hot-apply to this mon's own runtime config when addressed
        # (reference: daemons apply pushed config via md_config_t)
        if who in ("global", "mon", f"mon.{self.mon.rank}"):
            try:
                if op == "set":
                    self.mon.ctx.conf.set_val(key, payload["value"])
            except Exception:
                pass  # unknown/invalid key stays db-only

    def snapshot(self) -> Optional[dict]:
        return {"db": self.db}

    def restore(self, snap: dict, batch: WriteBatch) -> None:
        self.db = {k: dict(v) for k, v in snap["db"].items()}
        batch.set("svc_config", "db", json.dumps(self.db).encode())

    def get_effective(self, who: str) -> Dict[str, str]:
        """global < type < type.id precedence (ConfigMonitor.cc
        get_config shape)."""
        out: Dict[str, str] = dict(self.db.get("global", {}))
        if "." in who:
            kind = who.split(".", 1)[0]
            out.update(self.db.get(kind, {}))
        out.update(self.db.get(who, {}))
        return out

    def command(self, cmd: dict) -> Optional[Tuple[int, dict]]:
        prefix = cmd.get("prefix", "")
        if prefix == "config set":
            self.propose({"op": "set", "who": cmd["who"],
                          "key": cmd["name"], "value": str(cmd["value"])})
            return 0, {}
        if prefix == "config rm":
            self.propose({"op": "rm", "who": cmd["who"], "key": cmd["name"]})
            return 0, {}
        if prefix == "config get":
            return 0, {"config": self.get_effective(cmd["who"])}
        if prefix == "config dump":
            return 0, {"config": {k: dict(v) for k, v in self.db.items()}}
        return None


class LogMonitor(PaxosService):
    name = "logm"
    KEEP = 500

    def __init__(self, mon) -> None:
        super().__init__(mon)
        self.entries: List[dict] = []  # {stamp, who, level, msg}

    def load(self) -> None:
        raw = self.kv.get("svc_log", "entries")
        self.entries = json.loads(raw.decode()) if raw else []

    def apply(self, payload: dict, batch: WriteBatch) -> None:
        self.entries.append({
            "stamp": payload.get("stamp", 0.0),
            "who": payload.get("who", "?"),
            "level": payload.get("level", "info"),
            "msg": payload.get("msg", ""),
        })
        del self.entries[:-self.KEEP]
        batch.set("svc_log", "entries", json.dumps(self.entries).encode())

    def snapshot(self) -> Optional[dict]:
        return {"entries": self.entries}

    def restore(self, snap: dict, batch: WriteBatch) -> None:
        self.entries = list(snap["entries"])[-self.KEEP:]
        batch.set("svc_log", "entries", json.dumps(self.entries).encode())

    def log(self, who: str, msg: str, level: str = "info") -> None:
        """Daemon-facing API (the reference's LogClient -> MLog path)."""
        self.propose({"who": who, "msg": msg, "level": level,
                      "stamp": time.time()})

    def command(self, cmd: dict) -> Optional[Tuple[int, dict]]:
        prefix = cmd.get("prefix", "")
        if prefix == "log":
            self.propose({"who": cmd.get("who", "client"),
                          "msg": str(cmd.get("logtext", "")),
                          "level": cmd.get("level", "info"),
                          "stamp": time.time()})
            return 0, {}
        if prefix == "log last":
            n = int(cmd.get("num", 20))
            return 0, {"lines": self.entries[-n:]}
        return None


class HealthMonitor(PaxosService):
    name = "health"

    def __init__(self, mon) -> None:
        super().__init__(mon)
        self.muted: Dict[str, bool] = {}
        # transition tracking (tick(), leader-side): previous overall
        # status + live check set, so HEALTH_OK <-> WARN <-> ERR edges
        # and check appear/clear events land in the cluster log
        self._last_status = "HEALTH_OK"
        self._last_checks: set = set()

    def load(self) -> None:
        raw = self.kv.get("svc_health", "muted")
        self.muted = json.loads(raw.decode()) if raw else {}

    def apply(self, payload: dict, batch: WriteBatch) -> None:
        if payload["op"] == "mute":
            self.muted[payload["check"]] = True
        elif payload["op"] == "unmute":
            self.muted.pop(payload["check"], None)
        batch.set("svc_health", "muted", json.dumps(self.muted).encode())

    def snapshot(self) -> Optional[dict]:
        return {"muted": self.muted}

    def restore(self, snap: dict, batch: WriteBatch) -> None:
        self.muted = dict(snap["muted"])
        batch.set("svc_health", "muted", json.dumps(self.muted).encode())

    def gather(self) -> Tuple[str, Dict[str, dict]]:
        """HEALTH_OK/HEALTH_WARN + checks, derived live from the map +
        every service's contributions (HealthMonitor.cc check shape)."""
        checks: Dict[str, dict] = {}
        m = self.mon.osdmap
        if m is not None:
            down = [i for i in range(m.max_osd)
                    if not bool(m.osd_state_up[i])]
            if down:
                checks["OSD_DOWN"] = {
                    "severity": "HEALTH_WARN",
                    "summary": f"{len(down)} osds down",
                    "detail": [f"osd.{i} is down" for i in down],
                }
            out = [i for i in range(m.max_osd)
                   if int(m.osd_weight[i]) == 0]
            if out:
                checks["OSD_OUT"] = {
                    "severity": "HEALTH_WARN",
                    "summary": f"{len(out)} osds out",
                    "detail": [f"osd.{i} is out" for i in out],
                }
        # PG states from the PGMap digest (primary-reported rows;
        # stale reports — conf mon_pg_stats_stale_s, not a hardcoded
        # cutoff — are EXCLUDED here and surfaced as their own check
        # below instead of silently vanishing)
        pgmap = self.mon.pgmap
        digest = pgmap.digest()
        degraded, peering, damaged = [], [], []
        # fresh_only: the detail must name the same staleness-filtered
        # PG set the digest summaries count — a dead reporter's stale
        # rows belong to MON_STALE_PG_REPORTS, not these lists
        for row in pgmap.pg_rows(fresh_only=True):
            if not row["primary"]:
                continue
            if row.get("scrub_errors"):
                damaged.append(f"{row['pgid']} ({row['scrub_errors']} "
                               f"scrub errors)")
            if "degraded" in row["state"]:
                degraded.append(f"{row['pgid']} ({row['degraded']} "
                                f"objects degraded)")
            elif row["state"] == "peering":
                peering.append(row["pgid"])
        n_deg_pgs = sum(n for s, n in digest["pg_states"].items()
                        if "degraded" in s)
        if n_deg_pgs:
            checks["PG_DEGRADED"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{n_deg_pgs} pgs degraded",
                "detail": sorted(degraded)[:10],
            }
        if digest["pg_states"].get("peering"):
            checks["PG_PEERING"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{digest['pg_states']['peering']} pgs peering",
                "detail": sorted(peering)[:10],
            }
        if digest["degraded_objects"]:
            pct = digest["degraded_ratio"] * 100.0
            checks["OBJECT_DEGRADED"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{digest['degraded_objects']}/"
                           f"{digest['total_copies']} object copies "
                           f"degraded ({pct:.1f}%)",
                "detail": [f"recovery rate "
                           f"{digest['io']['recovery_objects_per_s']} "
                           f"objects/s"],
            }
        if digest["unfound_objects"]:
            checks["OBJECT_UNFOUND"] = {
                "severity": "HEALTH_ERR",
                "summary": f"{digest['unfound_objects']} objects "
                           f"unfound (no live source)",
                "detail": [],
            }
        if digest.get("scrub_errors"):
            # scrub found damage repair has not cleared: possible data
            # corruption (the reference's PG_DAMAGED / OSD_SCRUB_ERRORS)
            checks["PG_DAMAGED"] = {
                "severity": "HEALTH_ERR",
                "summary": f"{digest['scrub_errors']} scrub errors on "
                           f"{digest['damaged_pgs']} pgs — possible "
                           f"data damage",
                "detail": sorted(damaged)[:10],
            }
        not_deep = pgmap.not_deep_scrubbed()
        if not_deep:
            checks["PG_NOT_DEEP_SCRUBBED"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{len(not_deep)} pgs not deep-scrubbed "
                           f"in time",
                "detail": [
                    f"pg {r['pgid']} last deep-scrubbed "
                    + (f"{r['age_s']}s ago" if r["age_s"] is not None
                       else "never") for r in not_deep[:10]],
            }
        stuck = pgmap.stuck_pgs()
        if stuck:
            checks["PG_STUCK"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{len(stuck)} pgs stuck in non-active "
                           f"states",
                "detail": [f"pg {r['pgid']} stuck {r['state']} for "
                           f"{r['stuck_for_s']}s" for r in stuck[:10]],
            }
        if digest["slow_ops"]:
            n_slow = sum(digest["slow_ops"].values())
            checks["SLOW_OPS"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{n_slow} slow ops on "
                           f"{len(digest['slow_ops'])} daemons",
                "detail": [f"osd.{osd}: {n} slow ops"
                           for osd, n in sorted(
                               digest["slow_ops"].items())],
            }
        slow_hb = pgmap.slow_heartbeat_osds()
        if slow_hb:
            checks["OSD_SLOW_HEARTBEAT"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{len(slow_hb)} osds observing heartbeat "
                           f"grace overruns",
                "detail": [f"osd.{o} reported fresh heartbeat misses"
                           for o in slow_hb],
            }
        if m is not None:
            live = [i for i in range(m.max_osd)
                    if bool(m.osd_state_up[i])]
            stale_reps = pgmap.stale_osds(live)
            if stale_reps:
                checks["MON_STALE_PG_REPORTS"] = {
                    "severity": "HEALTH_WARN",
                    "summary": f"{len(stale_reps)} up osds have stale "
                               f"pg stats (degraded pgs may be "
                               f"invisible)",
                    "detail": [f"osd.{o}: last report {age}s ago"
                               for o, age in stale_reps],
                }
        # store fullness (reference OSDMap full/nearfull flags)
        nearfull, full = [], []
        for osd, (used, total) in self.mon.osd_fullness.items():
            if not total:
                continue
            ratio = used / total
            if ratio >= 0.95:
                full.append(f"osd.{osd} ({ratio:.0%})")
            elif ratio >= 0.85:
                nearfull.append(f"osd.{osd} ({ratio:.0%})")
        if full:
            checks["OSD_FULL"] = {
                "severity": "HEALTH_ERR",
                "summary": f"{len(full)} osds full",
                "detail": sorted(full),
            }
        if nearfull:
            checks["OSD_NEARFULL"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{len(nearfull)} osds nearfull",
                "detail": sorted(nearfull),
            }
        for svc in self.mon.services.values():
            if svc is not self:
                checks.update(svc.health_checks())
        live = {k: v for k, v in checks.items() if k not in self.muted}
        rank = {"HEALTH_OK": 0, "HEALTH_WARN": 1, "HEALTH_ERR": 2}
        status = "HEALTH_OK"
        for c in live.values():
            if rank.get(c["severity"], 0) > rank[status]:
                status = c["severity"]
        return status, checks

    def tick(self) -> None:
        """Leader-side transition detector (called from the mon tick):
        HEALTH_OK <-> WARN <-> ERR edges and individual check
        appear/clear events land in the LogMonitor cluster log, so
        `log last` reconstructs the health history of an incident —
        muted checks don't log (that is what mute is for)."""
        status, checks = self.gather()
        live = {k for k in checks if k not in self.muted}
        logm = self.mon.services.get("logm")
        if logm is None:
            return
        if status != self._last_status:
            changed = sorted((live ^ self._last_checks) & live)
            why = ""
            if changed:
                why = " (" + "; ".join(
                    f"{k}: {checks[k]['summary']}" for k in changed) + ")"
            logm.log(f"mon.{self.mon.rank}",
                     f"cluster health {self._last_status} -> "
                     f"{status}{why}",
                     level="warn" if status != "HEALTH_OK" else "info")
        for k in sorted(live - self._last_checks):
            logm.log(f"mon.{self.mon.rank}",
                     f"health check {k} raised: "
                     f"{checks[k]['summary']}", level="warn")
        for k in sorted(self._last_checks - live):
            logm.log(f"mon.{self.mon.rank}",
                     f"health check {k} cleared", level="info")
        self._last_status = status
        self._last_checks = live

    def command(self, cmd: dict) -> Optional[Tuple[int, dict]]:
        prefix = cmd.get("prefix", "")
        if prefix == "health":
            status, checks = self.gather()
            return 0, {"status": status, "checks": checks,
                       "muted": sorted(self.muted)}
        if prefix == "health detail":
            # every check with full detail; muted checks stay LISTED
            # (flagged) but never count toward the overall status
            status, checks = self.gather()
            out = {}
            for k, v in sorted(checks.items()):
                row = dict(v)
                row["muted"] = k in self.muted
                out[k] = row
            return 0, {"status": status, "checks": out,
                       "muted": sorted(self.muted)}
        if prefix == "health mute":
            self.propose({"op": "mute", "check": cmd["check"]})
            return 0, {}
        if prefix == "health unmute":
            self.propose({"op": "unmute", "check": cmd["check"]})
            return 0, {}
        return None


class AuthMonitor(PaxosService):
    name = "auth"

    def snapshot(self) -> Optional[dict]:
        if self.mon.auth_server is None:
            return None
        return {"keyring": self.mon.auth_server.keyring.dump()}

    def restore(self, snap: dict, batch: WriteBatch) -> None:
        if self.mon.auth_server is None:
            return
        from ceph_tpu_torch.auth.keyring import Keyring

        stored = Keyring.loads(snap["keyring"])
        kr = self.mon.auth_server.keyring
        for name in stored.names():
            kr.add(name, stored.get(name))
        batch.set("svc_auth", "keyring", kr.dump().encode())

    def load(self) -> None:
        raw = self.kv.get("svc_auth", "keyring")
        if raw and self.mon.auth_server is not None:
            from ceph_tpu_torch.auth.keyring import Keyring

            stored = Keyring.loads(raw.decode())
            kr = self.mon.auth_server.keyring
            for name in stored.names():
                kr.add(name, stored.get(name))

    def apply(self, payload: dict, batch: WriteBatch) -> None:
        if self.mon.auth_server is None:
            return
        kr = self.mon.auth_server.keyring
        if payload["op"] == "add":
            kr.add(payload["entity"], bytes.fromhex(payload["secret"]))
        elif payload["op"] == "rm" and payload["entity"] in list(kr.names()):
            kr._keys.pop(payload["entity"], None)
        batch.set("svc_auth", "keyring", kr.dump().encode())

    def command(self, cmd: dict) -> Optional[Tuple[int, dict]]:
        prefix = cmd.get("prefix", "")
        if prefix not in ("auth get-or-create", "auth get", "auth ls",
                          "auth rm"):
            return None
        if self.mon.auth_server is None:
            return -95, {"error": "auth disabled (no keyring)"}
        kr = self.mon.auth_server.keyring
        if prefix == "auth get-or-create":
            entity = cmd["entity"]
            secret = kr.get(entity)
            if secret is None:
                from ceph_tpu_torch.auth.keyring import generate_secret

                secret = generate_secret()
                self.propose({"op": "add", "entity": entity,
                              "secret": secret.hex()})
            return 0, {"entity": entity, "key": secret.hex()}
        if prefix == "auth get":
            secret = kr.get(cmd["entity"])
            if secret is None:
                return -2, {"error": f"no key for {cmd['entity']}"}
            return 0, {"entity": cmd["entity"], "key": secret.hex()}
        if prefix == "auth ls":
            return 0, {"entities": sorted(kr.names())}
        if prefix == "auth rm":
            self.propose({"op": "rm", "entity": cmd["entity"]})
            return 0, {}
        return None





class MonmapMonitor(PaxosService):
    """Mon-roster changes through paxos (src/mon/MonmapMonitor.cc).

    `mon add` appends a rank; `mon rm` leaves a None hole (ranks are
    identity — see MonMap).  Every mon applies the new roster on
    commit, so quorum math changes cluster-wide in one paxos round; a
    NEWLY added mon is then started by the operator with the new map
    and catches up through the ordinary collect/CATCHUP path.
    """

    name = "monmap"

    def load(self) -> None:
        raw = self.kv.get("svc_monmap", "map")
        if raw:
            from ceph_tpu_torch.mon.monitor import MonMap

            stored = MonMap.from_dict(json.loads(raw.decode()))
            if stored.epoch > self.mon.monmap.epoch:
                self.mon.monmap = stored

    def apply(self, payload: dict, batch: WriteBatch) -> None:
        from ceph_tpu_torch.mon.monitor import MonMap

        new = MonMap.from_dict(payload["monmap"])
        if new.epoch > self.mon.monmap.epoch:
            self.mon.monmap = new
        batch.set("svc_monmap", "map",
                  json.dumps(payload["monmap"]).encode())

    def snapshot(self) -> Optional[dict]:
        return {"monmap": self.mon.monmap.to_dict()}

    def restore(self, snap: dict, batch: WriteBatch) -> None:
        from ceph_tpu_torch.mon.monitor import MonMap

        new = MonMap.from_dict(snap["monmap"])
        if new.epoch > self.mon.monmap.epoch:
            self.mon.monmap = new
        batch.set("svc_monmap", "map",
                  json.dumps(snap["monmap"]).encode())

    def command(self, cmd: dict) -> Optional[Tuple[int, dict]]:
        prefix = cmd.get("prefix", "")
        if prefix == "mon dump":
            return 0, {"monmap": self.mon.monmap.to_dict(),
                       "leader": self.mon.leader}
        if prefix == "mon add":
            addr = (cmd["addr"][0], int(cmd["addr"][1]))
            new = self.mon.monmap.with_added(addr)
            self.propose({"monmap": new.to_dict()})
            return 0, {"rank": new.size - 1, "epoch": new.epoch}
        if prefix == "mon rm":
            rank = int(cmd["rank"])
            if rank >= self.mon.monmap.size or \
                    self.mon.monmap.addrs[rank] is None:
                return -2, {"error": f"no mon rank {rank}"}
            live = len(self.mon.monmap.live_ranks())
            if live <= 1:
                return -22, {"error": "refusing to remove the last mon"}
            new = self.mon.monmap.with_removed(rank)
            self.propose({"monmap": new.to_dict()})
            return 0, {"epoch": new.epoch}
        return None


class MDSMonitor(PaxosService):
    """The FSMap role (reference src/mon/MDSMonitor.cc + FSMap): a
    paxos-committed roster of MDS ranks and their addresses.  MDS
    daemons boot through the mon (MMDSBoot), clients discover the
    rank->addr table with `fs status`, and `mds fail` marks a rank
    down (its clients fail over when a replacement boots)."""

    name = "mdsmap"

    def __init__(self, mon) -> None:
        super().__init__(mon)
        self.epoch = 0
        self.ranks: Dict[str, dict] = {}  # str(rank) -> {addr, up}

    def load(self) -> None:
        raw = self.kv.get("svc_mdsmap", "db")
        if raw:
            got = json.loads(raw.decode())
            self.epoch = got["epoch"]
            self.ranks = got["ranks"]

    def _persist(self, batch: WriteBatch) -> None:
        batch.set("svc_mdsmap", "db", json.dumps(
            {"epoch": self.epoch, "ranks": self.ranks}).encode())

    def apply(self, payload: dict, batch: WriteBatch) -> None:
        op = payload["op"]
        rank = str(payload["rank"])
        if op == "boot":
            self.ranks[rank] = {"addr": payload["addr"], "up": True,
                                "nonce": payload.get("nonce", 0)}
        elif op == "fail":
            if rank in self.ranks:
                self.ranks[rank]["up"] = False
        self.epoch += 1
        self._persist(batch)

    def snapshot(self) -> Optional[dict]:
        return {"epoch": self.epoch, "ranks": self.ranks}

    def restore(self, snap: dict, batch: WriteBatch) -> None:
        self.epoch = snap["epoch"]
        self.ranks = {k: dict(v) for k, v in snap["ranks"].items()}
        self._persist(batch)

    def handle_boot(self, rank: int, addr, nonce: int = 0) -> None:
        cur = self.ranks.get(str(rank))
        if cur and cur.get("up") and tuple(cur["addr"]) == tuple(addr):
            # duplicate boot retry — but only for the SAME incarnation.
            # An MDS that restarted on the same address carries a fresh
            # nonce and must re-register it: suppressing it would leave
            # the OLD nonce stored, so a later `mds fail` could be
            # undone by the new incarnation's retried beacons (their
            # nonce wouldn't match the stored one and the replay guard
            # below wouldn't hold them back)
            if not nonce or cur.get("nonce") == nonce:
                return
        if (cur and not cur.get("up") and nonce
                and cur.get("nonce") == nonce):
            # a REPLAYED/resent beacon of the very incarnation that was
            # failed (beacons are resent until committed and ride
            # lossless sessions): it must not resurrect the rank — only
            # a NEW boot incarnation (fresh nonce) re-registers
            return
        self.propose({"op": "boot", "rank": rank, "addr": list(addr),
                      "nonce": nonce})

    def command(self, cmd: dict) -> Optional[Tuple[int, dict]]:
        prefix = cmd.get("prefix", "")
        if prefix == "fs status":
            return 0, {"epoch": self.epoch,
                       "ranks": {r: dict(v)
                                 for r, v in sorted(self.ranks.items())}}
        if prefix == "mds fail":
            rank = str(cmd["rank"])
            if rank not in self.ranks:
                return -2, {"error": f"no mds rank {rank}"}
            self.propose({"op": "fail", "rank": int(rank)})
            return 0, {}
        return None

    def health_checks(self) -> Dict[str, dict]:
        down = [r for r, v in self.ranks.items() if not v.get("up")]
        if down:
            return {"MDS_RANK_DOWN": {
                "severity": "HEALTH_WARN",
                "summary": f"mds ranks down: {sorted(down)}"}}
        return {}


def build_services(mon) -> Dict[str, PaxosService]:
    svcs = [ConfigMonitor(mon), LogMonitor(mon), HealthMonitor(mon),
            AuthMonitor(mon), MonmapMonitor(mon), MDSMonitor(mon)]
    return {s.name: s for s in svcs}
