"""Internal thread-liveness map with grace/suicide timeouts.

Reference: HeartbeatMap (src/common/HeartbeatMap.h:54) — worker threads
touch a handle inside their loop; a checker flags handles past their
grace (unhealthy → daemon reports itself) or suicide timeout (reference
aborts; here we raise via callback so tests can assert on it).

Port of ``ceph_tpu/core/heartbeat.py``, name for name.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional


class Handle:
    __slots__ = ("name", "grace", "suicide_grace", "last_touch", "suicided")

    def __init__(self, name: str, grace: float, suicide_grace: float) -> None:
        self.name = name
        self.grace = grace
        self.suicide_grace = suicide_grace
        self.last_touch = time.monotonic()
        self.suicided = False

    def touch(self) -> None:
        self.last_touch = time.monotonic()
        self.suicided = False


class HeartbeatMap:
    def __init__(
        self, on_suicide: Optional[Callable[[str], None]] = None
    ) -> None:
        self._lock = threading.Lock()
        self._handles: Dict[str, Handle] = {}
        self.on_suicide = on_suicide

    def add_worker(
        self, name: str, grace: float = 15.0, suicide_grace: float = 150.0
    ) -> Handle:
        h = Handle(name, grace, suicide_grace)
        with self._lock:
            self._handles[name] = h
        return h

    def remove_worker(self, name: str) -> None:
        with self._lock:
            self._handles.pop(name, None)

    def is_healthy(self) -> bool:
        return not self.unhealthy_workers()

    def unhealthy_workers(self) -> List[str]:
        now = time.monotonic()
        bad: List[str] = []
        to_fire: List[str] = []
        with self._lock:
            for h in self._handles.values():
                age = now - h.last_touch
                # latch under the lock: the abort callback fires once per
                # stall even with concurrent health queries (touch()
                # re-arms after recovery); only latch when a callback is
                # installed so one registered later still sees the stall
                if (age > h.suicide_grace and not h.suicided
                        and self.on_suicide is not None):
                    h.suicided = True
                    to_fire.append(h.name)
                if age > h.grace:
                    bad.append(h.name)
        if self.on_suicide:
            for name in to_fire:
                self.on_suicide(name)
        return bad
