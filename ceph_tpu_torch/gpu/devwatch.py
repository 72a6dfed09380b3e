"""DeviceWatch — process-wide observability of the port's device runtime.

The counterpart of the part of ``ceph_tpu/tpu/devwatch.py`` that
``core`` and the stripe-batch queue reach: :func:`watch` (``:735``),
:meth:`DeviceWatch.note_batch` (``:440``), :meth:`DeviceWatch.dump`
(``:588``, the ``device compile dump`` admin command) and
:meth:`DeviceWatch.device_state` (``:642``, the crash report's device
section).

The reference watches XLA: compiles per kernel family, signatures,
storms.  The port compiles no XLA program.  Its kernels are built once
per process from ``csrc/`` (``ops/_build.py``), and each wrapper counts
its launches (``_build.LaunchCount``).  So this watch reports what the
port has:

- the kernel build: whether it ran, its wall seconds, its directory,
  and its [start, end] stamps, which :meth:`DeviceWatch.compile_overlap_s`
  reads to blame a queue job that waited on it (``:537``);
- launches per kernel, read from every ``LaunchCount``;
- the queue's batches: a total, their device seconds, and a bounded
  ring of the recent ones (kind, jobs, shapes, seconds).

It keeps no compile table and invents no numbers for one.  A daemon
registers :attr:`DeviceWatch.perf` under its ``osd.N.xla`` counter set
(``ceph_tpu/osd/daemon.py:305-310``) and points :meth:`DeviceWatch.attach_log` at its context's
log, which then gathers a line a batch (subsys ``tpu``).
"""

from __future__ import annotations

import collections
import time
from typing import Any, Deque, Dict, List, Tuple

from ceph_tpu_torch.core.lockdep import make_lock
from ceph_tpu_torch.ops import _build
# the kernel wrappers: importing them creates their launch counts
from ceph_tpu_torch.ops import (crc32c_device, crush_rule,  # noqa: F401
                                gf2_matmul, gf256, gf256_planes,
                                mesh_digest)

_BATCH_RING = 256        # recent batches kept for dumps
_DUMP_BATCHES = 50       # listed by dump()
_STATE_BATCHES = 10      # listed by device_state()


class DeviceWatch:
    """Process-wide device-runtime watcher; see the module docstring."""

    def __init__(self) -> None:
        self._lock = make_lock("devwatch")
        # (t_mono, kind, jobs, shapes, seconds) of each noted batch
        self._batches: Deque[Tuple[float, str, int, List, float]] = \
            collections.deque(maxlen=_BATCH_RING)
        self.batches = 0          # batches noted since the process began
        self.batch_seconds = 0.0  # their summed device seconds
        self._queue = None        # the queue device_state() reports
        self._log = None          # core.log.Log that gathers batch lines
        self.perf = _PerfView(self)

    def attach_log(self, log) -> None:
        """Gather a line a noted batch into ``log``'s ring (subsys
        ``tpu``, level 15).  The latest attach wins: daemons of one
        process share the watch, and a revived daemon re-attaches."""
        self._log = log

    def attach_queue(self, queue) -> None:
        """The queue whose depth and staging :meth:`device_state`
        reports (None detaches)."""
        self._queue = queue

    def note_batch(self, kind: str, jobs: int, shapes: List[Tuple],
                   dur_s: float) -> None:
        """One stripe-batch queue dispatch that completed: its kind,
        job count, per-job plane shapes and upload + compute + download
        seconds."""
        with self._lock:
            self._batches.append((time.monotonic(), kind, int(jobs),
                                  [list(s) for s in shapes], float(dur_s)))
            self.batches += 1
            self.batch_seconds += float(dur_s)
        log = self._log
        if log is not None:
            log.log("tpu", 15, f"devwatch batch queue: kind={kind} "
                               f"jobs={jobs} shapes={shapes} "
                               f"dur_ms={dur_s * 1e3:.1f}")

    @staticmethod
    def compile_activity_since(t0: float) -> bool:
        """Cheap pre-check of the queue's blame loop (``:530``): False
        means the kernel build is not running and did not end after
        ``t0``, so no overlap query over [t0, now] can be nonzero."""
        b0, b1 = _build.build_t0, _build.build_t1
        return b0 is not None and (b1 is None or b1 > t0)

    @staticmethod
    def compile_overlap_s(t0: float, t1: float) -> float:
        """Seconds of [t0, t1] (monotonic) that the kernel build
        overlapped, a build still running counting up to now: the
        port's one compile, which every kernel launch waits on."""
        b0, b1 = _build.build_t0, _build.build_t1
        if b0 is None or t1 <= t0:
            return 0.0
        if b1 is None:
            b1 = time.monotonic()
        return max(0.0, min(t1, b1) - max(t0, b0))

    @staticmethod
    def launches() -> Dict[str, int]:
        """Launches per kernel since each count was last reset."""
        return {c.name: c.value for c in _build.COUNTS}

    @staticmethod
    def build() -> Dict[str, Any]:
        return {"built": _build.build_seconds is not None,
                "seconds": _build.build_seconds,
                "live": (_build.build_t0 is not None
                         and _build.build_t1 is None),
                "dir": str(_build.BUILD_DIR),
                "sources": list(_build.SOURCES)}

    def _recent(self, now: float, n: int) -> List[Dict[str, Any]]:
        # callers hold self._lock
        return [{"age_s": round(now - t, 3), "kind": kind, "jobs": jobs,
                 "shapes": shapes, "seconds": round(dur, 6)}
                for t, kind, jobs, shapes, dur in list(self._batches)[-n:]]

    def dump(self) -> Dict[str, Any]:
        """The ``device compile dump`` payload: the kernel build,
        launches per kernel, and the queue's batches."""
        now = time.monotonic()
        launches = self.launches()
        with self._lock:
            return {
                "build": self.build(),
                "launches": launches,
                "batches": {"total": self.batches,
                            "seconds": round(self.batch_seconds, 6),
                            "recent": self._recent(now, _DUMP_BATCHES)},
            }

    def device_state(self) -> Dict[str, Any]:
        """The crash-report device section: the queue's depth, staging
        occupancy and the batch on its worker now (``in_flight_batch``,
        ``:662``), the kernel build, the launches and the last
        batches."""
        now = time.monotonic()
        out: Dict[str, Any] = {}
        q = self._queue
        if q is not None:
            try:
                out["queue_depth"] = q._q.qsize()
                out["staging_slots_used"] = q.pool.occupancy
                out["staging"] = q.stats.snapshot()
                out["in_flight_batch"] = q.inflight_batch()
            except Exception as e:  # a torn queue must not kill the
                out["queue_error"] = repr(e)  # crash report itself
        out["build"] = self.build()
        out["launches"] = self.launches()
        with self._lock:
            out["last_batches"] = self._recent(now, _STATE_BATCHES)
        return out


class _PerfView:
    """A read-only ``PerfCounters``-like view (``name``, ``dump()``) of
    the watch, for ``ctx.perf.register("osd.N.xla", ...)``: the kernel
    build's seconds, launches per kernel and the queue's batches."""

    name = "gpu.devwatch"

    def __init__(self, watch: DeviceWatch) -> None:
        self._watch = watch

    def dump(self) -> Dict[str, Any]:
        w = self._watch
        out: Dict[str, Any] = {
            "build_seconds": _build.build_seconds or 0.0}
        out.update({f"launches_{k}": v for k, v in w.launches().items()})
        with w._lock:
            out["batches"] = w.batches
            out["batch_seconds"] = round(w.batch_seconds, 6)
        return out


_WATCH = DeviceWatch()


def watch() -> DeviceWatch:
    """The process-wide watcher: one device runtime per process."""
    return _WATCH
