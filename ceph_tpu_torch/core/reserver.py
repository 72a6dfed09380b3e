"""AsyncReserver — bounded-concurrency reservations for recovery.

Reference role: src/common/AsyncReserver.h (recovery/backfill slots are
reserved before any data moves; the reservation count throttles how
many recoveries run at once per OSD).  This is the synchronous
equivalent for the threaded runtime: reserve() blocks until a slot
frees (or times out), release() hands the slot to the next waiter;
`in_use`/`high_water` expose the throttle to tests and perf counters.

Port of ``ceph_tpu/core/reserver.py``, name for name.
"""

from __future__ import annotations

import threading


class AsyncReserver:
    def __init__(self, max_allowed: int) -> None:
        self.max_allowed = max(1, int(max_allowed))
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self.in_use = 0
        self.high_water = 0  # max concurrent grants ever observed

    def reserve(self, timeout: float = 30.0) -> bool:
        deadline = (threading.TIMEOUT_MAX if timeout is None
                    else timeout)
        with self._cv:
            ok = self._cv.wait_for(
                lambda: self.in_use < self.max_allowed, timeout=deadline)
            if not ok:
                return False
            self.in_use += 1
            self.high_water = max(self.high_water, self.in_use)
            return True

    def release(self) -> None:
        with self._cv:
            if self.in_use > 0:
                self.in_use -= 1
            self._cv.notify()

    def __enter__(self) -> "AsyncReserver":
        if not self.reserve():
            raise TimeoutError("recovery reservation timed out")
        return self

    def __exit__(self, *exc) -> None:
        self.release()
