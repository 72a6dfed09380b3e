"""Byte/op throttles — flow control for messengers, objecter, recovery.

Reference: src/common/Throttle.{h,cc} (blocking `get` against a max,
`get_or_fail`, dynamic resize waking waiters) used by the messenger's
dispatch throttle and the Objecter's in-flight op budget.

Port of ``ceph_tpu/core/throttle.py``, name for name.
"""

from __future__ import annotations

import threading


class Throttle:
    def __init__(self, name: str, maximum: int) -> None:
        self.name = name
        self._max = maximum
        self._current = 0
        self._cond = threading.Condition()

    @property
    def current(self) -> int:
        return self._current

    @property
    def maximum(self) -> int:
        return self._max

    def reset_max(self, maximum: int) -> None:
        with self._cond:
            self._max = maximum
            self._cond.notify_all()

    def _should_wait(self, count: int) -> bool:
        if self._max <= 0:
            return False
        # always let a single oversized request through an empty throttle
        return (
            self._current + count > self._max
            and not (self._current == 0 and count > self._max)
        )

    def get(self, count: int = 1, timeout: float | None = None) -> bool:
        """Block until `count` fits; False on timeout."""
        with self._cond:
            ok = self._cond.wait_for(
                lambda: not self._should_wait(count), timeout
            )
            if not ok:
                return False
            self._current += count
            return True

    def get_or_fail(self, count: int = 1) -> bool:
        with self._cond:
            if self._should_wait(count):
                return False
            self._current += count
            return True

    def put(self, count: int = 1) -> None:
        with self._cond:
            self._current -= count
            assert self._current >= 0, f"throttle {self.name} underflow"
            self._cond.notify_all()

    def __repr__(self) -> str:
        return f"Throttle({self.name}, {self._current}/{self._max})"
