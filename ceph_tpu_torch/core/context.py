"""Context — the per-process service bundle (CephContext equivalent).

Reference: CephContext/g_ceph_context (src/common/ceph_context.h) as
created by global_init (src/global/global_init.h:34): owns the config,
the log, the perf-counter collection, the admin socket, and the
heartbeat map, and hands them to every subsystem.

Port of ``ceph_tpu/core/context.py``.  The admin command ``device
compile dump`` keeps its name and answers from the port's device watch
(``gpu/devwatch.py``): the kernel build and launches, not XLA compiles.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ceph_tpu_torch.core.admin_socket import AdminSocket
from ceph_tpu_torch.core.config import Config
from ceph_tpu_torch.core.heartbeat import HeartbeatMap
from ceph_tpu_torch.core.log import Log
from ceph_tpu_torch.core.perf import PerfCountersCollection


class Context:
    def __init__(
        self,
        name: str = "client.admin",
        overrides: Optional[Dict[str, Any]] = None,
    ) -> None:
        overrides = dict(overrides or {})
        overrides.setdefault("name", name)
        self.conf = Config(overrides)
        self.name = self.conf.get("name")
        self.log = Log(
            default_level=self.conf.get("log_level"),
            ring_size=self.conf.get("log_ring_size"),
            name=self.name,
        )
        self.perf = PerfCountersCollection()
        self.heartbeat = HeartbeatMap()
        from ceph_tpu_torch.core.tracing import Tracer

        self.trace = Tracer(self.name,
                            enabled=bool(self.conf.get("tracing")))
        self.admin: Optional[AdminSocket] = None
        path = self.conf.get("admin_socket")
        if path:
            self._start_admin(path)
        self.conf.add_observer(
            ("log_level",),
            lambda _n, v: [self.log.set_level(s, v) for s in self.log._levels],
        )

    def _start_admin(self, path: str) -> None:
        a = AdminSocket(path)
        a.register("perf dump", lambda c: self.perf.dump(),
                   "dump perf counters")
        a.register("config get",
                   lambda c: {c["key"]: self.conf.get(c["key"])},
                   "get one config value")
        a.register("config set",
                   lambda c: (self.conf.set_val(c["key"], c["value"]),
                              {"success": True})[1],
                   "set a config value at runtime")
        a.register("config diff", lambda c: self.conf.diff(),
                   "non-default config values")
        a.register("log dump", lambda c: self.log.dump_recent(
            int(c.get("count", 1000))), "recent in-memory log events")
        a.register("health", lambda c: {
            "healthy": self.heartbeat.is_healthy(),
            "unhealthy_workers": self.heartbeat.unhealthy_workers(),
        }, "thread liveness")
        def _dump_trace(c):
            if "trace_id" in c:
                return self.trace.dump(int(str(c["trace_id"]), 16))
            return self.trace.recent(int(c.get("count", 100)))

        a.register("dump_tracing", _dump_trace,
                   "archived trace spans (blkin role)")
        a.register("dump_trace", _dump_trace,
                   "spans of one trace: dump_trace trace_id=<hex> "
                   "(without trace_id: the ring tail)")

        def _device_dump(c):
            # process-wide like the StripeBatchQueue: one device
            # runtime per process, one kernel build
            from ceph_tpu_torch.gpu.devwatch import watch

            return watch().dump()

        a.register("device compile dump", _device_dump,
                   "the device runtime: the kernel build, launches per "
                   "kernel, and the stripe-batch queue's recent batches")
        a.start()
        self.admin = a

    def shutdown(self) -> None:
        if self.admin is not None:
            self.admin.stop()
            self.admin = None


def global_init(
    name: str, overrides: Optional[Dict[str, Any]] = None, argv=None
):
    """Config-parse + context construction (global_init equivalent)."""
    ctx = Context(name, overrides)
    rest = ctx.conf.parse_argv(argv) if argv else []
    ctx.conf.startup_done()  # non-runtime options frozen from here on
    return ctx, rest
