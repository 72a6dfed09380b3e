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

- the kernel build: whether it ran, its wall seconds, its directory;
- launches per kernel, read from every ``LaunchCount``;
- the queue's batches: a total, their device seconds, and a bounded
  ring of the recent ones (kind, jobs, shapes, seconds).

It keeps no compile table and invents no numbers for one.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Deque, Dict, List, Tuple

from ceph_tpu_torch.core.lockdep import make_lock
from ceph_tpu_torch.ops import _build
# the kernel wrappers: importing them creates their launch counts
from ceph_tpu_torch.ops import (crc32c_device, crush_rule,  # noqa: F401
                                gf2_matmul, gf256, gf256_planes)

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

    @staticmethod
    def launches() -> Dict[str, int]:
        """Launches per kernel since each count was last reset."""
        return {c.name: c.value for c in _build.COUNTS}

    @staticmethod
    def build() -> Dict[str, Any]:
        return {"built": _build.build_seconds is not None,
                "seconds": _build.build_seconds,
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
        """The crash-report device section: the queue's depth and
        staging occupancy, the kernel build, the launches and the last
        batches."""
        now = time.monotonic()
        out: Dict[str, Any] = {}
        q = self._queue
        if q is not None:
            try:
                out["queue_depth"] = q._q.qsize()
                out["staging_slots_used"] = q.pool.occupancy
                out["staging"] = q.stats.snapshot()
            except Exception as e:  # a torn queue must not kill the
                out["queue_error"] = repr(e)  # crash report itself
        out["build"] = self.build()
        out["launches"] = self.launches()
        with self._lock:
            out["last_batches"] = self._recent(now, _STATE_BATCHES)
        return out


_WATCH = DeviceWatch()


def watch() -> DeviceWatch:
    """The process-wide watcher: one device runtime per process."""
    return _WATCH
