"""Perf counters: u64 counters, gauges and log2 histograms, plus the
snapshot ring that turns cumulative counters into windowed rates.

Port of the part of ``ceph_tpu/core/perf.py`` the stripe-batch queue
uses (reference role: PerfCounters, src/common/perf_counters.h:59-99).
Histogram bucket b holds values in [2^(b-1), 2^b); bucket 0 holds
values below 1.
"""

from __future__ import annotations

import collections
import math
import threading
import time
from typing import Dict, List, Optional

TYPE_U64 = "u64"          # monotonically increasing counter
TYPE_GAUGE = "gauge"      # settable level
TYPE_HIST = "histogram"   # log2-bucketed values


class _Counter:
    __slots__ = ("name", "type", "desc", "value", "count", "sum", "buckets")

    def __init__(self, name: str, type_: str, desc: str) -> None:
        self.name = name
        self.type = type_
        self.desc = desc
        self.value = 0
        self.count = 0
        self.sum = 0.0
        self.buckets: List[int] = [0] * 64 if type_ == TYPE_HIST else []


class PerfCounters:
    """One subsystem's counter set."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._counters: Dict[str, _Counter] = {}

    # adds are idempotent: a shared set must not re-zero live counters
    def add_u64_counter(self, name: str, desc: str = "") -> None:
        self._counters.setdefault(name, _Counter(name, TYPE_U64, desc))

    def add_u64_gauge(self, name: str, desc: str = "") -> None:
        self._counters.setdefault(name, _Counter(name, TYPE_GAUGE, desc))

    def add_histogram(self, name: str, desc: str = "") -> None:
        self._counters.setdefault(name, _Counter(name, TYPE_HIST, desc))

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counters[name].value += by

    def set(self, name: str, v: int) -> None:
        with self._lock:
            self._counters[name].value = v

    def hinc(self, name: str, value: float) -> None:
        with self._lock:
            c = self._counters[name]
            b = 0 if value < 1 else min(63, int(math.log2(value)) + 1)
            c.buckets[b] += 1
            c.count += 1
            c.sum += value

    def value(self, name: str, default: int = 0) -> int:
        with self._lock:
            c = self._counters.get(name)
            if c is None or c.type not in (TYPE_U64, TYPE_GAUGE):
                return default
            return c.value

    def dump(self) -> Dict[str, object]:
        out: Dict[str, object] = {}
        with self._lock:
            for n, c in self._counters.items():
                if c.type in (TYPE_U64, TYPE_GAUGE):
                    out[n] = c.value
                else:
                    top = max(
                        (i for i, v in enumerate(c.buckets) if v), default=-1)
                    out[n] = {"count": c.count, "sum": c.sum,
                              "buckets": c.buckets[: top + 1]}
        return out


class SnapshotRing:
    """Bounded ring of (stamp, {key: cumulative value}) snapshots;
    ``rate()`` differences the newest sample against the oldest one
    inside the window, so a lost sample costs resolution, never
    correctness."""

    def __init__(self, capacity: int = 128) -> None:
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()

    def push(self, values: Dict[str, float],
             stamp: Optional[float] = None) -> None:
        if stamp is None:
            stamp = time.monotonic()
        with self._lock:
            self._ring.append((stamp, dict(values)))

    def latest(self, key: str, default: float = 0.0) -> float:
        with self._lock:
            if not self._ring:
                return default
            return float(self._ring[-1][1].get(key, default))

    def _endpoints(self, window_s: float, now: Optional[float]):
        """(t0, v0, t1, v1) of the window; None with fewer than two
        samples in it, or when the newest sample already left it (a
        feed that stopped pushing decays to zero)."""
        with self._lock:
            samples = list(self._ring)
        if len(samples) < 2:
            return None
        t1, v1 = samples[-1]
        if now is None:
            now = t1
        if now - t1 > window_s:
            return None
        t0, v0 = samples[0]
        for t, v in samples:
            if now - t <= window_s:
                t0, v0 = t, v
                break
        if t1 <= t0:
            return None
        return t0, v0, t1, v1

    def rate(self, key: str, window_s: float = 10.0,
             now: Optional[float] = None) -> float:
        ep = self._endpoints(window_s, now)
        if ep is None:
            return 0.0
        t0, v0, t1, v1 = ep
        return (float(v1.get(key, 0.0)) - float(v0.get(key, 0.0))) \
            / (t1 - t0)

    def delta(self, key: str, window_s: float = 10.0,
              now: Optional[float] = None) -> float:
        ep = self._endpoints(window_s, now)
        if ep is None:
            return 0.0
        _t0, v0, _t1, v1 = ep
        return float(v1.get(key, 0.0)) - float(v0.get(key, 0.0))
