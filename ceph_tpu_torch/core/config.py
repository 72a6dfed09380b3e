"""Typed config schema + runtime config with observers and hot reload.

Mirrors the reference's option system (reference: src/common/options.cc
— typed schema with levels/defaults/min-max/enum/runtime-updatability —
and md_config_t at src/common/config.h:66 with md_config_obs_t
observers applied via apply_changes).  The monitor's centralized config
service (src/mon/ConfigMonitor.cc) maps to MonService config commands
layered on top of this.

Port of ``ceph_tpu/core/config.py``: :data:`SCHEMA` holds every option
under the reference's name, type and default, so a conf that parses on
one package parses on the other.  The options that steer only XLA say
in their help text that the port has no counterpart yet, and which
queue item brings one.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

LEVEL_BASIC = "basic"
LEVEL_ADVANCED = "advanced"
LEVEL_DEV = "dev"


@dataclass
class Option:
    name: str
    type: type  # int, float, str, bool
    default: Any
    desc: str = ""
    level: str = LEVEL_ADVANCED
    minval: Optional[float] = None
    maxval: Optional[float] = None
    enum: Optional[Sequence[str]] = None
    runtime: bool = True  # updatable without restart

    def validate(self, value: Any) -> Any:
        if self.type is bool and isinstance(value, str):
            low = value.lower()
            if low in ("true", "yes", "1", "on"):
                value = True
            elif low in ("false", "no", "0", "off"):
                value = False
            else:
                raise ValueError(f"{self.name}: {value!r} is not a boolean")
        try:
            value = self.type(value)
        except (TypeError, ValueError) as e:
            raise ValueError(f"{self.name}: cannot cast {value!r}: {e}")
        if self.minval is not None and value < self.minval:
            raise ValueError(f"{self.name}: {value} < min {self.minval}")
        if self.maxval is not None and value > self.maxval:
            raise ValueError(f"{self.name}: {value} > max {self.maxval}")
        if self.enum is not None and value not in self.enum:
            raise ValueError(f"{self.name}: {value!r} not in {self.enum}")
        return value


def _opts() -> List[Option]:
    O = Option
    return [
        # -- global ---------------------------------------------------------
        O("name", str, "client.admin", "entity name", LEVEL_BASIC, runtime=False),
        O("fsid", str, "", "cluster id", LEVEL_BASIC, runtime=False),
        O("log_level", int, 1, "default log verbosity", LEVEL_BASIC),
        O("log_file", str, "", "log output path ('' = stderr)"),
        O("log_ring_size", int, 10000, "crash-dump ring entries"),
        O("tracing", bool, False, "record blkin-style trace spans"),
        O("admin_socket", str, "", "admin socket path ('' = disabled)"),
        O("heartbeat_interval", float, 5.0, "internal liveness check period"),
        O("failpoint_inject", str, "",
          "arm fault-injection points (core/failpoint.py DSL: "
          "name=action[:modifier...],... — see failpoint.POINTS)"),
        # -- messenger ------------------------------------------------------
        O("ms_bind_ip", str, "127.0.0.1", "listen address", runtime=False),
        O("ms_connect_timeout", float, 10.0, "dial timeout seconds"),
        O("ms_retry_interval", float, 0.2, "session reconnect backoff"),
        O("ms_dispatch_throttle_bytes", int, 100 << 20,
          "max bytes of queued undispatched messages"),
        O("ms_crc_data", bool, True, "checksum message payloads"),
        O("ms_ack_delay", float, 0.005,
          "seconds to hold a dispatch ack hoping it piggybacks on "
          "outgoing data before a dedicated ack frame is sent"),
        O("ms_loop_stall_ms", float, 0.0,
          "loop-stall sanitizer: record a fast-dispatched handler that "
          "holds the messenger event loop longer than this many "
          "milliseconds (0 = off; the test suite arms it via "
          "CEPH_TPU_LOOP_STALL_MS)"),
        # -- monitor --------------------------------------------------------
        O("mon_lease", float, 5.0, "paxos lease seconds"),
        O("mon_tick_interval", float, 1.0, "monitor tick period"),
        O("mon_osd_down_out_interval", float, 600.0,
          "seconds down before auto-out"),
        O("mon_osd_min_down_reporters", int, 2,
          "distinct failure reporters required to mark an osd down"),
        O("mon_osd_adjust_heartbeat_grace", bool, True,
          "scale grace by reporter history"),
        O("mon_pg_stats_stale_s", float, 30.0,
          "seconds after which an OSD's MPGStats report stops feeding "
          "PG health checks; a LIVE osd whose reports go stale past "
          "this raises MON_STALE_PG_REPORTS instead of silently "
          "vanishing from the digest"),
        O("mon_pg_stuck_threshold", float, 300.0,
          "seconds a PG may sit in a non-active state before the "
          "PG_STUCK health check fires (stuck-since stamps come from "
          "the PGMap's state-transition tracking)"),
        O("mon_stats_rate_window", float, 10.0,
          "window (seconds) over which the PGMap digest derives "
          "client IOPS/BW and recovery rates from report deltas"),
        O("mon_warn_not_deep_scrubbed_s", float, 0.0,
          "raise PG_NOT_DEEP_SCRUBBED for primary PGs whose last deep "
          "scrub is older than this many seconds (0 = check disabled; "
          "a PG never deep-scrubbed counts as infinitely old)"),
        O("osd_heartbeat_grace", float, 20.0,
          "seconds without a ping before reporting failure"),
        O("osd_heartbeat_interval", float, 2.0, "osd peer ping period"),
        O("osd_heartbeat_grace_load_stretch", bool, True,
          "stretch the heartbeat grace by the host's load factor "
          "(loadavg per cpu, capped 3x) so a CPU-saturated box does "
          "not mark live-but-starved peers down (ROUND6 bench note)"),
        # -- osd ------------------------------------------------------------
        O("osd_op_num_shards", int, 4, "sharded op queue shards", runtime=False),
        O("osd_op_queue", str, "mclock",
          "op scheduler: mclock (dmClock QoS, default) or fifo "
          "(priority heap; wpq is the legacy spelling)",
          enum=("mclock", "fifo", "wpq"), runtime=False),
        O("osd_qos_profiles", str, "",
          "QoS profile overrides (osd/qos.py DSL): "
          "'<target>=<r>:<w>:<l>;...' where target is a base class "
          "(client, recovery, scrub, snaptrim, ...), tenant:<entity>, "
          "or pool:<id>; runtime-updatable (qos set retunes through "
          "the conf observer)"),
        O("osd_qos_client_rate_window", float, 5.0,
          "window (seconds) over which the QoS scheduler derives the "
          "client-IOPS pressure signal for the recovery feedback "
          "controller"),
        O("osd_recovery_feedback", bool, True,
          "close the recovery-vs-client loop: widen the recovery "
          "window when client IOPS are idle, clamp it under client "
          "pressure (off = the fixed osd_recovery_max_active window)"),
        O("osd_recovery_idle_client_iops", float, 2.0,
          "client ops/s below which clients count as idle and the "
          "recovery window widens"),
        O("osd_recovery_busy_client_iops", float, 50.0,
          "client ops/s at which the recovery window clamps to half"),
        O("osd_recovery_feedback_widen", int, 4,
          "multiplier applied to osd_recovery_max_active while "
          "clients are idle", minval=1),
        O("osd_client_message_cap", int, 256,
          "per-client-connection in-flight op cap at the messenger "
          "(0 = uncapped); an abusive tenant queues at ITS socket, "
          "not in the shared workqueue (reference Throttle role)"),
        O("osd_client_message_size_cap", int, 64 << 20,
          "per-client-connection in-flight payload-byte cap at the "
          "messenger (0 = uncapped)"),
        O("osd_op_complaint_time", float, 30.0,
          "seconds after which an op counts as slow (OpTracker: drives "
          "the dump_historic_slow_ops ring admission; runtime-updatable "
          "so operators can shrink it to catch a live stall)"),
        O("osd_op_history_size", int, 20,
          "completed ops kept for dump_historic_ops", runtime=False),
        O("osd_op_history_slow_size", int, 20,
          "slow ops kept for dump_historic_slow_ops", runtime=False),
        O("osd_slow_op_report_window", float, 30.0,
          "seconds a completed slow op keeps counting toward the "
          "slow-op depth reported to the mon (MPGStats); the SLOW_OPS "
          "health check clears once the ring entries age past this"),
        O("osd_client_write_timeout", float, 30.0,
          "seconds before an in-flight client write whose commit (or "
          "durable-ack gate) never resolves answers retryable EAGAIN"),
        O("osd_max_write_size", int, 90 << 20, "largest single write"),
        O("osd_pool_default_size", int, 3, "replica count"),
        O("osd_pool_default_min_size", int, 0, "0 = size - size/2"),
        O("osd_pool_default_pg_num", int, 32, "pgs per new pool"),
        O("osd_pool_default_erasure_code_profile", str,
          "plugin=isa k=8 m=4 technique=reed_sol_van",
          "default EC profile"),
        O("osd_recovery_max_active", int, 3, "concurrent recovery ops"),
        O("osd_recovery_read_timeout", float, 10.0,
          "seconds to wait for a recovery window's sub-read replies "
          "before the legacy fallback / retryable verdict"),
        O("osd_recovery_chunk_size", int, 8 << 20,
          "bytes per recovery push chunk (resumable progress unit)"),
        O("osd_recovery_push_timeout", float, 30.0,
          "seconds to wait for a recovery push's ack before leaving "
          "the peer stale for this round"),
        O("osd_scrub_interval", float, 86400.0, "seconds between scrubs"),
        O("osd_deep_scrub_interval", float, 604800.0,
          "seconds between DEEP scrubs of one PG: the scheduler runs a "
          "byte-reading deep scrub when a PG's last deep scrub is older "
          "than this (a never-deep-scrubbed PG deep-scrubs first)"),
        O("osd_scrub_chunk_max", int, 16,
          "objects per deep-scrub chunk: the engine verifies (and "
          "persists its resume cursor) one chunk at a time, yielding "
          "to client io between chunks", minval=1),
        O("osd_scrub_auto_repair", bool, False,
          "repair inconsistencies found by deep scrub automatically "
          "(EC consensus rebuild with replace semantics), bounded by "
          "osd_scrub_auto_repair_num_errors"),
        O("osd_scrub_auto_repair_num_errors", int, 5,
          "auto-repair only when deep scrub found at most this many "
          "inconsistent objects (mass damage wants an operator)"),
        O("osd_scrub_busy_client_iops", float, 50.0,
          "client ops/s at which a running deep scrub preempts "
          "between chunks (waits for the pressure to drain)"),
        O("osd_scrub_preempt_max_wait", float, 5.0,
          "longest a preempted deep scrub waits for client pressure "
          "to drain before taking its next chunk anyway"),
        O("osd_pg_stats_interval", float, 2.0,
          "seconds between MPGStats reports to the mon"),
        O("osd_client_op_priority", int, 63, "client op priority"),
        O("osd_recovery_op_priority", int, 3, "recovery op priority"),
        # -- erasure code / device -----------------------------------------
        O("erasure_code_batch_cols", int, 1 << 20,
          "stripe-batch queue target columns per device dispatch"),
        O("erasure_code_tile_n", int, 2048,
          "Pallas column tile of the reference's XLA kernels; the "
          "port's kernels take no such tile and read none yet (queue 1 "
          "item 4, the bench, brings the interleaved kernel's tile)"),
        O("tpu_stripe_queue_depth", int, 4, "in-flight device batches"),
        O("tpu_devpath", bool, True,
          "device-resident small-object data path: stage EC WRITEFULL "
          "payloads into the pinned pool, fuse crc32c into the encode "
          "batch, ship DeviceBuf handles end-to-end (off = legacy "
          "host-bytes path)"),
        O("tpu_staging_slots", int, 64,
          "pinned staging pool slots (exhaustion backpressures the "
          "write path)", runtime=False),
        O("tpu_staging_slot_kib", int, 128,
          "pinned staging slot size; larger payloads bypass the pool",
          runtime=False),
        # the options below steer the reference's XLA compiles; in the
        # port they steer its device watch over first launches and the
        # kernel build (gpu/devwatch.py), or nothing
        O("tpu_recompile_storm_window", float, 60.0,
          "sliding window (seconds) of the device watcher's "
          "recompile-storm detection; the port's watch counts first "
          "launches of a kernel at new signatures and kernel builds "
          "(queue 1 item 4c)"),
        O("tpu_recompile_storm_min_sigs", int, 8,
          "distinct compile signatures of one kernel family inside "
          "the storm window that raise the RECOMPILE_STORM WARN; in the "
          "port, first launches at distinct signatures (queue 1 item 4c)"),
        O("tpu_recompile_storm_min_rogue_sigs", int, 3,
          "distinct rogue (undeclared by the shape-bucket ABI) compile "
          "signatures of one family inside the storm window that raise "
          "the RECOMPILE_STORM WARN; in the port, first launches at "
          "undeclared signatures (queue 1 item 4c)"),
        O("tpu_compile_cache_dir", str, "",
          "persistent on-disk XLA compilation cache directory; the "
          "port has none: its kernels are built once per checkout "
          "into ceph_tpu_torch/_build/, which a later process loads "
          "(the device watch's persist hit, queue 1 item 4c)",
          runtime=False),
        O("tpu_warmup_budget_s", float, 30.0,
          "wall-clock budget for the boot-time DeviceWarmup pass that "
          "builds the port's kernels and launches each declared shape "
          "bucket once before the daemon answers ops; buckets the "
          "budget cuts off stay pending and resume via `device warmup`"),
        O("tpu_boot_warmup", bool, False,
          "run the DeviceWarmup pass at OSD init (before the messenger "
          "serves ops), so the first client op pays neither the "
          "kernel build nor a first launch; off by default",
          runtime=False),
        # -- objectstore ----------------------------------------------------
        O("objectstore", str, "memstore", "backend", enum=("memstore", "filestore")),
        O("objectstore_path", str, "", "data directory for filestore"),
        O("objectstore_wal_sync", bool, False, "fsync the WAL per txn"),
        O("filestore_debug_inject_read_err", bool, False,
          "fault injection: EIO on reads marked bad"),
        O("store_debug_inject_data_err", bool, False,
          "fault injection: reads of objects marked via "
          "debug_inject_data_err serve seeded bit-flipped bytes "
          "(silent corruption, injected BEFORE the read-verify gate — "
          "with store_verify_read on the store catches it at read "
          "time; a rewrite of the object clears its mark)"),
        O("store_csum_extent_kib", int, 64,
          "at-rest checksum granularity: one crc32c seal per this many "
          "KiB of logical object space, sealed in the writing "
          "transaction (BlueStore csum_order analog)"),
        O("store_verify_read", bool, True,
          "verify per-extent at-rest seals on every read; a mismatch "
          "raises instead of serving flipped bytes (off = bench "
          "comparison mode — the corruption seam still applies)"),
        # -- client ---------------------------------------------------------
        O("objecter_timeout", float, 30.0, "op resend timeout"),
        O("objecter_inflight_ops", int, 1024, "op throttle"),
        O("rados_osd_op_timeout", float, 0.0, "0 = no timeout"),
    ]


SCHEMA: Dict[str, Option] = {o.name: o for o in _opts()}


class Config:
    """md_config_t equivalent: values + observers + apply_changes."""

    def __init__(self, overrides: Optional[Dict[str, Any]] = None) -> None:
        self._lock = threading.Lock()
        self._started = False  # until startup_done(), non-runtime opts settable
        self._values: Dict[str, Any] = {
            n: o.default for n, o in SCHEMA.items()
        }
        self._observers: List[Tuple[Sequence[str], Callable]] = []
        self._dirty: List[str] = []
        for key, val in os.environ.items():
            if key.startswith("CEPH_TPU_"):
                name = key[len("CEPH_TPU_"):].lower()
                if name in SCHEMA:
                    self._values[name] = SCHEMA[name].validate(val)
        if overrides:
            for k, v in overrides.items():
                self.set_val(k, v, apply=False)
            self._dirty.clear()

    def startup_done(self) -> None:
        """After this, options with runtime=False refuse set_val."""
        self._started = True

    def get(self, name: str) -> Any:
        with self._lock:
            return self._values[name]

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self.get(name)
        except KeyError:
            raise AttributeError(name)

    def set_val(self, name: str, value: Any, apply: bool = True,
                force: bool = False) -> None:
        """force=True bypasses the runtime-updatability guard (startup
        parsing); admin-path callers leave it False so non-runtime
        options reject instead of silently not taking effect."""
        opt = SCHEMA.get(name)
        if opt is None:
            raise KeyError(f"unknown option {name!r}")
        if not opt.runtime and not force and self._started:
            raise ValueError(
                f"{name} is not updatable at runtime (restart required)"
            )
        value = opt.validate(value)
        with self._lock:
            if self._values[name] != value:
                self._values[name] = value
                self._dirty.append(name)
        if apply:
            self.apply_changes()

    def add_observer(
        self, keys: Sequence[str], fn: Callable[[str, Any], None]
    ) -> Callable[[str, Any], None]:
        """fn(name, new_value) fires on apply_changes for watched keys.
        Returns fn as the handle for remove_observer."""
        self._observers.append((tuple(keys), fn))
        return fn

    def remove_observer(self, fn: Callable[[str, Any], None]) -> None:
        """Unhook an observer (by the handle add_observer returned).
        Daemons that die on a shared long-lived Context must remove
        their observers, or every kill/revive cycle pins the dead
        daemon's state for the Context's lifetime."""
        self._observers = [(k, f) for k, f in self._observers
                           if f is not fn]

    def apply_changes(self) -> None:
        with self._lock:
            dirty, self._dirty = self._dirty, []
            values = dict(self._values)
        for name in dirty:
            for keys, fn in self._observers:
                if name in keys:
                    fn(name, values[name])

    def parse_argv(self, argv: Sequence[str]) -> List[str]:
        """Consume --conf-<name>=<v> / --conf-<name> <v>; returns the rest."""
        rest: List[str] = []
        i = 0
        while i < len(argv):
            a = argv[i]
            if a.startswith("--conf-"):
                body = a[len("--conf-"):]
                if "=" in body:
                    name, val = body.split("=", 1)
                else:
                    name = body
                    i += 1
                    if i >= len(argv):
                        raise ValueError(f"missing value for --conf-{name}")
                    val = argv[i]
                self.set_val(name.replace("-", "_"), val, apply=False)
            else:
                rest.append(a)
            i += 1
        self.apply_changes()
        return rest

    def diff(self) -> Dict[str, Any]:
        """Options changed from schema defaults (admin `config diff`)."""
        with self._lock:
            return {
                n: v
                for n, v in self._values.items()
                if v != SCHEMA[n].default
            }

    def dump(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._values)
