"""Manager daemon: perf aggregation, module registry, metrics export.

Reference: ceph-mgr (src/mgr/) — daemons report their PerfCounters to
the mgr (MMgrReport via DaemonServer.cc), python modules consume the
aggregated state (src/pybind/mgr/mgr_module.py), and the prometheus
module exports it in text exposition format
(src/pybind/mgr/prometheus/module.py).

Port of ``ceph_tpu/mgr/manager.py``: the same modules, commands and
exposition text, over the port's ``core`` (perf, lockdep), ``osd.qos``,
``mgr.balancer`` and ``gpu.devwatch``.  ``device compile dump`` is the
port's device watch's ``dump()`` (the compile table of first launches
and the kernel build, storms, then the build, launches per kernel and
the queue's batches), and the Prometheus export carries its
family-labeled ``ceph_xla_*`` lines
(``PrometheusModule._export_devwatch``).

In-process inversion: instead of MMgrReport messages, registered
daemons hand the mgr their Context (whose PerfCountersCollection is
already thread-safe), and `collect()` polls them — the same data the
reference ships over the wire, without re-encoding it.  Modules follow
the MgrModule shape: `serve()`-less objects with `handle_command`.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple


class MgrModule:
    """mgr_module.MgrModule shape: named, command-handling plugin."""

    name = ""

    def __init__(self, mgr: "MgrDaemon") -> None:
        self.mgr = mgr

    def handle_command(self, cmd: dict) -> Optional[Tuple[int, dict]]:
        return None


class StatusModule(MgrModule):
    name = "status"

    def handle_command(self, cmd):
        if cmd.get("prefix") != "mgr status":
            return None
        return 0, {
            "daemons": sorted(self.mgr.daemons),
            "modules": sorted(self.mgr.modules),
            "last_collect": self.mgr.last_collect,
        }


class PrometheusModule(MgrModule):
    """Text exposition format over the aggregated counters
    (src/pybind/mgr/prometheus/module.py role)."""

    name = "prometheus"

    def _export_cluster(self, lines: List[str]) -> None:
        """Cluster-level gauges (health, pg states, per-pool df, io
        rates) when the mgr is wired to a mon's health/PGMap feeds —
        the reference prometheus module's ceph_health_status /
        ceph_pg_* / ceph_pool_* family."""
        mgr = self.mgr
        if mgr.health_fn is not None:
            status, checks = mgr.health_fn()
            rank = {"HEALTH_OK": 0, "HEALTH_WARN": 1, "HEALTH_ERR": 2}
            lines.append("# TYPE ceph_health_status gauge")
            lines.append(f"ceph_health_status {rank.get(status, 2)}")
            if checks:
                lines.append("# TYPE ceph_health_check gauge")
                for name, c in sorted(checks.items()):
                    lines.append(
                        f'ceph_health_check{{check="{name}",'
                        f'severity="{c.get("severity", "")}"}} 1')
        if mgr.pgmap_digest_fn is None:
            return
        digest = mgr.pgmap_digest_fn()
        lines.append("# TYPE ceph_pg_state gauge")
        for state, n in sorted(digest["pg_states"].items()):
            lines.append(f'ceph_pg_state{{state="{state}"}} {n}')
        lines.append(f'ceph_pg_state{{state="total"}} '
                     f'{digest["num_pgs"]}')
        for key in ("degraded_objects", "misplaced_objects",
                    "unfound_objects", "used_bytes", "total_bytes"):
            metric = f"ceph_cluster_{key}"
            lines.append(f"# TYPE {metric} gauge")
            lines.append(f"{metric} {digest[key]}")
        lines.append("# TYPE ceph_cluster_io_rate gauge")
        for key, v in sorted(digest["io"].items()):
            lines.append(f'ceph_cluster_io_rate{{kind="{key}"}} {v}')
        for metric, field in (("ceph_pool_objects", "objects"),
                              ("ceph_pool_stored_bytes", "bytes"),
                              ("ceph_pool_degraded_objects", "degraded")):
            lines.append(f"# TYPE {metric} gauge")
            for pool, row in sorted(digest["pools"].items()):
                lines.append(f'{metric}{{pool="{pool}"}} {row[field]}')

    def _export_qos(self, lines: List[str]) -> None:
        """ceph_qos_* gauges from every registered daemon's QoS
        scheduler: per-class queue depth + admitted totals,
        dequeue-phase counters, recovery feedback window, and the
        per-connection edge-throttle stall count."""
        rows = []
        for name, svc in sorted(self.mgr.services.items()):
            qos = getattr(svc, "qos", None)
            if qos is None:
                continue
            msgr = getattr(svc, "msgr", None)
            rows.append((name, qos.status(
                msgr_perf=getattr(msgr, "perf", None))))
        if not rows:
            return
        lines.append("# TYPE ceph_qos_queue_depth gauge")
        lines.append("# TYPE ceph_qos_admitted_total counter")
        for name, st in rows:
            for cls, row in sorted(st["classes"].items()):
                lines.append(
                    f'ceph_qos_queue_depth{{daemon="{name}",'
                    f'class="{cls}"}} {row.get("depth", 0)}')
                if "admitted" in row:
                    lines.append(
                        f'ceph_qos_admitted_total{{daemon="{name}",'
                        f'class="{cls}"}} {row["admitted"]}')
        lines.append("# TYPE ceph_qos_dequeue_total counter")
        for name, st in rows:
            for phase, n in sorted(st["dequeue_phases"].items()):
                lines.append(
                    f'ceph_qos_dequeue_total{{daemon="{name}",'
                    f'phase="{phase}"}} {n}')
        lines.append("# TYPE ceph_qos_recovery_window gauge")
        lines.append("# TYPE ceph_qos_throttle_stalls counter")
        for name, st in rows:
            lines.append(
                f'ceph_qos_recovery_window{{daemon="{name}"}} '
                f'{st["recovery"]["effective_window"]}')
            thr = st.get("throttle") or {}
            lines.append(
                f'ceph_qos_throttle_stalls{{daemon="{name}"}} '
                f'{thr.get("stalls", 0)}')

    def _export_devwatch(self, lines: List[str]) -> None:
        """Family-labeled device-runtime metrics (``ceph_xla_*``): first
        launches and builds, their seconds, distinct signatures, launches
        at a seen signature and their dispatch-wall histograms with the
        terminal ``le="+Inf"`` bucket.  Process-wide (one device runtime
        a process), so the watch exports itself rather than riding a
        daemon label."""
        from ceph_tpu_torch.gpu.devwatch import watch

        watch().export_prometheus(lines)

    def export(self) -> str:
        metrics = self.mgr.collect()
        lines: List[str] = []
        self._export_cluster(lines)
        self._export_qos(lines)
        self._export_devwatch(lines)
        seen_help = set()
        for daemon, subsystems in sorted(metrics.items()):
            for subsys, counters in sorted(subsystems.items()):
                for cname, val in sorted(counters.items()):
                    # exposition metric names admit [a-zA-Z0-9_:] only:
                    # subsystem dots (osd.0.op) flatten to underscores
                    metric = f"ceph_{subsys}_{cname}".replace(
                        "-", "_").replace(".", "_")
                    label = f'{{daemon="{daemon}"}}'
                    if isinstance(val, dict):
                        if "avgcount" in val:
                            if metric not in seen_help:
                                lines.append(f"# TYPE {metric} summary")
                                seen_help.add(metric)
                            lines.append(
                                f"{metric}_count{label} {val['avgcount']}")
                            lines.append(f"{metric}_sum{label} {val['sum']}")
                        elif "buckets" in val:
                            if metric not in seen_help:
                                lines.append(f"# TYPE {metric} histogram")
                                seen_help.add(metric)
                            # perf histograms are log2-bucketed in
                            # MICROSECONDS for the lat_* families:
                            # bucket i holds values < 2^i us, so its
                            # cumulative upper bound le IS 2^i (us)
                            acc = 0
                            for i, b in enumerate(val["buckets"]):
                                acc += b
                                lines.append(
                                    f'{metric}_bucket{{daemon="{daemon}",'
                                    f'le="{1 << i}"}} {acc}')
                            # the exposition format REQUIRES a
                            # terminal le="+Inf" bucket equal to
                            # _count; scrapers reject a histogram
                            # that stops at the last finite bucket
                            lines.append(
                                f'{metric}_bucket{{daemon="{daemon}",'
                                f'le="+Inf"}} {val["count"]}')
                            lines.append(
                                f"{metric}_count{label} {val['count']}")
                            lines.append(f"{metric}_sum{label} {val['sum']}")
                    else:
                        if metric not in seen_help:
                            lines.append(f"# TYPE {metric} counter")
                            seen_help.add(metric)
                        lines.append(f"{metric}{label} {val}")
        return "\n".join(lines) + "\n"

    def handle_command(self, cmd):
        if cmd.get("prefix") != "prometheus export":
            return None
        return 0, {"body": self.export()}


class CrashModule(MgrModule):
    """crash ls / crash info over a CrashArchive
    (src/pybind/mgr/crash/module.py role)."""

    name = "crash"

    def __init__(self, mgr: "MgrDaemon") -> None:
        super().__init__(mgr)
        self.archives: List[object] = []

    def add_archive(self, archive) -> None:
        self.archives.append(archive)

    def handle_command(self, cmd):
        prefix = cmd.get("prefix", "")
        if prefix == "crash ls":
            out: List[dict] = []
            for a in self.archives:
                out.extend(a.ls())
            return 0, {"crashes": sorted(out,
                                         key=lambda c: c["crash_id"])}
        if prefix == "crash info":
            for a in self.archives:
                r = a.info(cmd["id"])
                if r is not None:
                    return 0, r
            return -2, {"error": f"no crash {cmd['id']!r}"}
        return None


class DeviceModule(MgrModule):
    """`device compile dump`: the process-wide device watch's dump (the
    compile table per kernel family, recent storms, the event-ring tail,
    the kernel build, launches per kernel, the queue's batches) — the
    mgr face of ``ceph_tpu_torch.gpu.devwatch``, mirroring the
    per-daemon admin-socket command of the same name."""

    name = "device"

    def handle_command(self, cmd):
        if cmd.get("prefix") != "device compile dump":
            return None
        from ceph_tpu_torch.gpu.devwatch import watch

        return 0, watch().dump()


class BalancerModule(MgrModule):
    """Command surface over the upmap optimizer (the balancer module
    role, src/pybind/mgr/balancer/module.py:644)."""

    name = "balancer"

    def handle_command(self, cmd):
        if cmd.get("prefix") != "balancer optimize":
            return None
        if self.mgr.osdmap is None:
            return -2, {"error": "mgr has no osdmap"}
        from ceph_tpu_torch.mgr.balancer import UpmapBalancer

        b = UpmapBalancer(self.mgr.osdmap,
                          max_moves=int(cmd.get("max_moves", 16)))
        report = b.optimize_pool(int(cmd["pool"]))
        return 0, {
            "pool": report.pool_id,
            "before_stddev": report.before_stddev,
            "after_stddev": report.after_stddev,
            "moves": [
                [list(pg), [list(m) for m in moves]]
                for pg, moves in report.moves
            ],
        }


class TelemetryModule(MgrModule):
    """`telemetry show`: the anonymized cluster report (reference
    src/pybind/mgr/telemetry/module.py role, local-only — nothing is
    ever sent anywhere)."""

    name = "telemetry"

    def report(self) -> dict:
        import hashlib

        mgr = self.mgr
        counters = mgr.collect()
        n_counters = sum(len(c) for subs in counters.values()
                         for c in subs.values())
        osdmap = mgr.osdmap
        pools = []
        osds = {"count": 0, "up": 0}
        if osdmap is not None:
            for pid, p in sorted(getattr(osdmap, "pools", {}).items()):
                pools.append({
                    "id": pid,
                    "type": "erasure" if getattr(p, "pool_type", 1) == 3
                    else "replicated",
                    "pg_num": getattr(p, "pg_num", 0),
                    "size": getattr(p, "size", 0)})
            ups = getattr(osdmap, "osd_state_up", None)
            if ups is not None:
                osds = {"count": int(len(ups)),
                        "up": int(sum(bool(u) for u in ups))}
        # cluster id is a HASH of the daemon roster: stable for one
        # cluster, reveals nothing (the reference hashes the fsid)
        ident = hashlib.sha1(",".join(
            sorted(mgr.daemons)).encode()).hexdigest()[:16]
        return {
            "report_id": ident,
            "daemons": {"registered": sorted(mgr.daemons)},
            "osds": osds,
            "pools": pools,
            "perf_counter_count": n_counters,
            "last_collect": mgr.last_collect,
            "channel": "local-only (never transmitted)",
        }

    def handle_command(self, cmd):
        if cmd.get("prefix") != "telemetry show":
            return None
        return 0, self.report()


class ProgressModule(MgrModule):
    """Per-PG recovery/backfill progress events with rate-derived ETAs
    (the reference mgr progress module role, src/pybind/mgr/progress).

    An event opens when a primary-reported PG shows degraded object
    copies, tracks the recovered count against the event's high-water
    baseline, and derives its ETA from the CUMULATIVE recovery rate
    since the event started (remaining / rate).  The published ETA is
    clamped monotonically non-increasing — a convergence-from-above
    estimator: early samples over a small recovered count undershoot
    the rate (overshoot the ETA), and as recovery proceeds the
    estimate tightens toward the true completion time, so the dashboard
    never promises a finish and then pushes it later.  Completed
    events keep their measured duration (the ground truth of an ETA's
    error)."""

    name = "progress"
    KEEP_COMPLETED = 32

    def __init__(self, mgr: "MgrDaemon") -> None:
        super().__init__(mgr)
        from ceph_tpu_torch.core.lockdep import make_lock

        self._lock = make_lock("mgr.progress")
        self.events: Dict[str, dict] = {}
        self.completed: List[dict] = []
        self._now = time.monotonic  # injectable clock (deterministic tests)

    def refresh(self) -> None:
        """Fold the current PGMap rows into the event set; called on
        every `progress` command (polling cadence = refresh cadence)
        and by whoever drives the mgr's poll loop."""
        rows_fn = self.mgr.pg_rows_fn
        if rows_fn is None:
            return
        now = self._now()
        degraded_now: Dict[str, int] = {}
        damaged_now: Dict[str, int] = {}
        for row in rows_fn():
            if row["primary"] and row["degraded"] > 0:
                degraded_now[row["pgid"]] = row["degraded"]
            if row["primary"] and row.get("scrub_errors", 0) > 0:
                # scrub found damage repair hasn't cleared: a repair
                # event tracks the PG until its report reads clean
                # (auto-repair or operator `pg repair`/deep-scrub)
                damaged_now[row["pgid"]] = row["scrub_errors"]
        with self._lock:
            for pgid, cur in sorted(damaged_now.items()):
                ev_id = f"repair-{pgid}"
                ev = self.events.get(ev_id)
                if ev is None:
                    ev = self.events[ev_id] = {
                        "id": ev_id, "pgid": pgid,
                        "message": f"Repairing pg {pgid} "
                                   f"({cur} scrub errors)",
                        "started": now, "baseline": cur,
                        "progress": 0.0, "eta_s": None,
                    }
                ev["baseline"] = max(ev["baseline"], cur)
                ev["progress"] = round(
                    (ev["baseline"] - cur) / ev["baseline"], 4)
            for ev_id in [e for e in self.events
                          if e.startswith("repair-")
                          and self.events[e]["pgid"] not in damaged_now]:
                ev = self.events.pop(ev_id)
                ev["progress"] = 1.0
                ev["duration_s"] = round(now - ev["started"], 2)
                ev["eta_s"] = 0.0
                self.completed.append(ev)
                del self.completed[:-self.KEEP_COMPLETED]
            for pgid, cur in sorted(degraded_now.items()):
                ev_id = f"recovery-{pgid}"
                ev = self.events.get(ev_id)
                if ev is None:
                    ev = self.events[ev_id] = {
                        "id": ev_id, "pgid": pgid,
                        "message": f"Recovering pg {pgid}",
                        "started": now, "baseline": cur,
                        "progress": 0.0, "eta_s": None,
                    }
                ev["baseline"] = max(ev["baseline"], cur)
                recovered = ev["baseline"] - cur
                ev["progress"] = round(recovered / ev["baseline"], 4)
                elapsed = now - ev["started"]
                if recovered > 0 and elapsed > 0:
                    rate = recovered / elapsed
                    eta = cur / rate
                    prev = ev["eta_s"]
                    ev["eta_s"] = round(
                        eta if prev is None else min(prev, eta), 2)
            for ev_id in [e for e in self.events
                          if e.startswith("recovery-")
                          and self.events[e]["pgid"] not in degraded_now]:
                ev = self.events.pop(ev_id)
                ev["progress"] = 1.0
                ev["duration_s"] = round(now - ev["started"], 2)
                ev["eta_s"] = 0.0
                self.completed.append(ev)
                del self.completed[:-self.KEEP_COMPLETED]

    def handle_command(self, cmd):
        if cmd.get("prefix") != "progress":
            return None
        self.refresh()
        with self._lock:
            return 0, {
                "events": [dict(e) for _, e in sorted(
                    self.events.items())],
                "completed": [dict(e) for e in self.completed],
            }


class QosModule(MgrModule):
    """Cluster-wide QoS surface: `qos status` merges every
    registered OSD's scheduler evidence; `qos set <target> <r> <w> <l>`
    retunes at runtime THROUGH the conf observer — the new triple is
    folded into each daemon context's ``osd_qos_profiles`` value, whose
    observer reloads the live schedulers, so the conf stays the single
    durable source of truth (the ConfigMonitor discipline)."""

    name = "qos"

    def _qos_services(self):
        for name, svc in sorted(self.mgr.services.items()):
            qos = getattr(svc, "qos", None)
            if qos is not None:
                yield name, svc, qos

    def status(self) -> dict:
        out = {}
        for name, svc, qos in self._qos_services():
            msgr = getattr(svc, "msgr", None)
            out[name] = qos.status(
                msgr_perf=getattr(msgr, "perf", None))
        return {"daemons": out}

    def set_qos(self, target: str, reservation: float, weight: float,
                limit: float) -> dict:
        from ceph_tpu_torch.osd.qos import merge_profile_spec

        applied = []
        seen = set()
        for name, svc, _qos in self._qos_services():
            conf = svc.ctx.conf
            if id(conf) in seen:
                continue  # vstart daemons share one Context/conf
            seen.add(id(conf))
            spec = merge_profile_spec(
                str(conf.get("osd_qos_profiles") or ""),
                target, reservation, weight, limit)
            conf.set_val("osd_qos_profiles", spec)
            applied.append(name)
        return {"target": target,
                "reservation": reservation, "weight": weight,
                "limit": limit, "applied_via": applied}

    def handle_command(self, cmd):
        prefix = cmd.get("prefix", "")
        if prefix == "qos status":
            return 0, self.status()
        if prefix == "qos set":
            try:
                return 0, self.set_qos(
                    str(cmd["class"]), float(cmd["reservation"]),
                    float(cmd["weight"]), float(cmd["limit"]))
            except (KeyError, ValueError) as e:
                return -22, {"error": f"qos set: {e}"}
        return None


class OpsModule(MgrModule):
    """Cluster-wide op observability: merges every registered
    daemon's slow-op/in-flight rings and per-stage latency histograms
    into one surface — the aggregation the reference spreads across
    `ceph daemon <osd> dump_historic_slow_ops` polling and the mgr's
    perf queries.  ``ceph_tpu_torch/tools/cephtop.py`` renders the same shapes from
    admin sockets when no mgr is running."""

    name = "ops"

    def _tracked(self):
        for name, svc in sorted(self.mgr.services.items()):
            trk = getattr(svc, "op_tracker", None)
            if trk is not None:
                yield name, trk

    def _merged(self, method: str) -> dict:
        ops: List[dict] = []
        for name, trk in self._tracked():
            for o in getattr(trk, method)()["ops"]:
                o["daemon"] = name
                ops.append(o)
        ops.sort(key=lambda o: -o.get("age", 0.0))
        return {"num_ops": len(ops), "ops": ops}

    def dump_slow_ops(self) -> dict:
        return self._merged("dump_slow")

    def dump_ops_in_flight(self) -> dict:
        return self._merged("dump_in_flight")

    def latency(self) -> dict:
        """Per-stage p50/p99 merged across every daemon's osd.N.op
        (and the process-wide osd.N.tpuq) histogram sets."""
        from ceph_tpu_torch.core.perf import hist_summary, merge_stage_hists

        # every registered daemon shares this mgr's process: collapse
        # the repeated named sets (daemons sharing one Context dump
        # them all) into ONE payload, then the shared merge applies
        # its tpuq-exactly-once rule
        combined: Dict[str, dict] = {}
        for subs in self.mgr.collect().values():
            combined.update(subs)
        return {stage: hist_summary(v)
                for stage, v in sorted(merge_stage_hists([combined]).items())}

    def handle_command(self, cmd):
        prefix = cmd.get("prefix", "")
        if prefix == "ops dump_slow":
            return 0, self.dump_slow_ops()
        if prefix == "ops dump_in_flight":
            return 0, self.dump_ops_in_flight()
        if prefix == "ops latency":
            return 0, self.latency()
        return None


class MgrDaemon:
    """The aggregation point: daemons register, modules serve."""

    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self.daemons: Dict[str, object] = {}  # name -> Context
        # name -> daemon service object (OSDService etc): the op
        # tracker lives on the service, not the shared Context
        self.services: Dict[str, object] = {}
        self.modules: Dict[str, MgrModule] = {}
        self.osdmap = None  # fed by whoever owns the map (mon/tests)
        # mon telemetry feeds (wired by vstart/tests to the live
        # leader): health_fn() -> (status, checks);
        # pgmap_digest_fn() -> the PGMap digest; pg_rows_fn() -> rich
        # per-PG rows.  The MgrStatMonitor inversion: instead of the
        # mon pushing stats to the mgr, the in-process mgr pulls them.
        self.health_fn: Optional[Callable] = None
        self.pgmap_digest_fn: Optional[Callable] = None
        self.pg_rows_fn: Optional[Callable] = None
        self.last_collect = 0.0
        self._lock = threading.Lock()
        from ceph_tpu_torch.mgr.dashboard import DashboardModule

        for m in (StatusModule(self), PrometheusModule(self),
                  CrashModule(self), BalancerModule(self),
                  DashboardModule(self), TelemetryModule(self),
                  OpsModule(self), ProgressModule(self),
                  DeviceModule(self), QosModule(self)):
            self.modules[m.name] = m

    def register_daemon(self, name: str, ctx, service=None) -> None:
        """The MMgrReport-session role: this daemon's counters become
        visible to every module; with `service`, its op tracker joins
        the cluster-wide slow-op/in-flight merge too."""
        with self._lock:
            self.daemons[name] = ctx
            if service is not None:
                self.services[name] = service

    def register_service(self, name: str, service) -> None:
        """Attach a daemon service's op tracker to the cluster-wide
        slow-op/in-flight merge WITHOUT re-registering its Context —
        vstart daemons share one Context (counters dedup by identity)
        but each service owns a distinct tracker."""
        with self._lock:
            self.services[name] = service

    def unregister_daemon(self, name: str) -> None:
        with self._lock:
            self.daemons.pop(name, None)
            self.services.pop(name, None)

    def collect(self) -> Dict[str, Dict[str, Dict[str, object]]]:
        """daemon -> subsystem -> counter -> value."""
        with self._lock:
            daemons = list(self.daemons.items())
        self.last_collect = time.time()
        return {name: ctx.perf.dump() for name, ctx in daemons}

    def handle_command(self, cmd: dict) -> Tuple[int, dict]:
        for m in self.modules.values():
            got = m.handle_command(cmd)
            if got is not None:
                return got
        return -22, {"error": f"unknown mgr command {cmd.get('prefix')!r}"}
