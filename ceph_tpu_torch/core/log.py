"""Leveled subsystem logging with an in-memory crash ring.

Reference roles: `dout` over per-subsystem levels (src/common/dout.h,
src/common/subsys.h), the async flusher and most-recent-events ring
dumped on crash (src/log/Log.cc), and the cluster log channel
(src/common/LogClient.h) which here is the `cluster_cb` hook daemons
point at their mon session.

Port of ``ceph_tpu/core/log.py``, name for name.
"""

from __future__ import annotations

import collections
import sys
import threading
import time
import traceback
from typing import Callable, Deque, Dict, List, Optional, TextIO, Tuple

SUBSYS = (
    "ms", "mon", "paxos", "osd", "pg", "ec", "crush", "store", "journal",
    "client", "objecter", "bench", "admin", "heartbeat", "tpu", "rbd",
    "compressor", "scrub", "recovery", "test",
)

# ring entry shape: (unix_ts, context_name, subsys, level, message)


class Log:
    """Per-context logger; gather() gives a `dout`-style callable."""

    def __init__(
        self,
        default_level: int = 1,
        ring_size: int = 10000,
        stream: Optional[TextIO] = None,
        name: str = "",
    ) -> None:
        self._levels: Dict[str, int] = {s: default_level for s in SUBSYS}
        self._ring: Deque[Tuple[float, str, str, int, str]] = (
            collections.deque(maxlen=ring_size)
        )
        # ring always records up to this level even when not emitted,
        # mirroring the reference's gather_level > log_level crash ring
        self._gather_level = 20
        self._lock = threading.Lock()
        self._stream = stream if stream is not None else sys.stderr
        self.name = name
        self.cluster_cb: Optional[Callable[[str, str], None]] = None

    def set_level(self, subsys: str, level: int) -> None:
        self._levels[subsys] = level

    def would_emit(self, subsys: str, level: int) -> bool:
        return level <= self._levels.get(subsys, 1)

    def log(self, subsys: str, level: int, msg: str) -> None:
        now = time.time()
        with self._lock:
            if level <= self._gather_level:
                self._ring.append((now, self.name, subsys, level, msg))
            if level <= self._levels.get(subsys, 1):
                ts = time.strftime("%H:%M:%S", time.localtime(now))
                print(
                    f"{ts}.{int(now * 1000) % 1000:03d} {self.name} "
                    f"{level:2d} {subsys}: {msg}",
                    file=self._stream,
                )

    def dout(self, subsys: str) -> Callable[[int, str], None]:
        def emit(level: int, msg: str) -> None:
            self.log(subsys, level, msg)

        return emit

    def cluster(self, level: str, msg: str) -> None:
        """Cluster-log channel (INF/WRN/ERR) routed to the mon when wired."""
        self.log("mon", 0, f"cluster [{level}] {msg}")
        if self.cluster_cb:
            self.cluster_cb(level, msg)

    def dump_recent(self, n: int = 1000) -> List[str]:
        with self._lock:
            items = list(self._ring)[-n:]
        return [
            f"{ts:.6f} {name} {lvl:2d} {sub}: {msg}"
            for ts, name, sub, lvl, msg in items
        ]

    def dump_on_crash(self, exc: BaseException) -> str:
        lines = ["--- begin crash dump ---"]
        lines += traceback.format_exception(type(exc), exc, exc.__traceback__)
        lines += ["--- recent events ---"]
        lines += self.dump_recent()
        lines += ["--- end crash dump ---"]
        text = "\n".join(lines)
        print(text, file=self._stream)
        return text
