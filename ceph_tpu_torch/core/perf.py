"""Perf counters: counter / gauge / long-run-avg / histogram.

Reference: PerfCounters (src/common/perf_counters.h:59-99 — u64
counters, gauges, avgcount+sum pairs, power-of-2 histograms) built via
PerfCountersBuilder, registered in a per-context collection, and dumped
over the admin socket (`perf dump`).  Daemons push these to the mgr
(src/mgr/DaemonServer.cc); here the mgr service polls `dump()`.

Port of ``ceph_tpu/core/perf.py``, name for name: the counter sets,
the snapshot ring behind windowed rates, the histogram math every
latency surface shares, and the per-context collection.  Histogram
bucket b holds values in [2^(b-1), 2^b); bucket 0 holds values below 1.
"""

from __future__ import annotations

import collections
import math
import threading
import time
from typing import Dict, List, Optional

TYPE_U64 = "u64"          # monotonically increasing counter
TYPE_GAUGE = "gauge"      # settable level
TYPE_AVG = "avg"          # (count, sum) pair, e.g. latencies
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
    """One subsystem's counter set (e.g. 'osd', 'ec', 'msgr')."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._counters: Dict[str, _Counter] = {}

    # -- builder ----------------------------------------------------------
    # adds are idempotent: two daemons sharing one counter set (an
    # osd's data + heartbeat messengers) must not re-zero live counters
    def add_u64_counter(self, name: str, desc: str = "") -> None:
        self._counters.setdefault(name, _Counter(name, TYPE_U64, desc))

    def add_u64_gauge(self, name: str, desc: str = "") -> None:
        self._counters.setdefault(name, _Counter(name, TYPE_GAUGE, desc))

    def add_time_avg(self, name: str, desc: str = "") -> None:
        self._counters.setdefault(name, _Counter(name, TYPE_AVG, desc))

    def add_histogram(self, name: str, desc: str = "") -> None:
        self._counters.setdefault(name, _Counter(name, TYPE_HIST, desc))

    # -- updates ----------------------------------------------------------
    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counters[name].value += by

    def dec(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counters[name].value -= by

    def set(self, name: str, v: int) -> None:
        with self._lock:
            self._counters[name].value = v

    def tinc(self, name: str, seconds: float) -> None:
        with self._lock:
            c = self._counters[name]
            c.count += 1
            c.sum += seconds

    def hinc(self, name: str, value: float) -> None:
        with self._lock:
            c = self._counters[name]
            b = 0 if value < 1 else min(63, int(math.log2(value)) + 1)
            c.buckets[b] += 1
            c.count += 1
            c.sum += value

    # -- output -----------------------------------------------------------
    def value(self, name: str, default: int = 0) -> int:
        """One scalar counter/gauge, without serializing the whole set
        (dump() walks every counter incl. histogram bucket lists — too
        heavy for per-tick single-value reads like the stats report's
        heartbeat_misses)."""
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
                elif c.type == TYPE_AVG:
                    out[n] = {
                        "avgcount": c.count,
                        "sum": c.sum,
                        "avgtime": c.sum / c.count if c.count else 0.0,
                    }
                else:
                    top = max(
                        (i for i, v in enumerate(c.buckets) if v), default=-1
                    )
                    out[n] = {
                        "count": c.count,
                        "sum": c.sum,
                        "buckets": c.buckets[: top + 1],
                    }
        return out


class SnapshotRing:
    """Bounded ring of (stamp, {key: cumulative value}) snapshots with
    windowed rate derivation — the shared primitive behind the
    windowed "per-second" numbers this repo shows (the mon PGMap's
    client IOPS/BW and recovery objects/s, the StripeBatchQueue's
    device-busy fraction).  The mgr ProgressModule's ETA rate is NOT
    ring-derived: it is a cumulative since-event-start average, the
    smoother input its monotone clamp wants.

    Values pushed are CUMULATIVE counters; ``rate()`` differences the
    newest sample against the oldest sample inside the window, so a
    lost intermediate sample costs resolution, never correctness.
    One implementation so the mon digest, the progress ETAs, and the
    bench telemetry aux derive rates identically."""

    def __init__(self, capacity: int = 128) -> None:
        from ceph_tpu_torch.core.lockdep import make_lock

        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = make_lock("perf.snapring")

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
        """Window endpoints (t0, v0, t1, v1) shared by rate()/delta();
        None when fewer than two samples span the window (no invented
        numbers) or — with `now` supplied — when the NEWEST sample
        already fell out of the window: a feed that stopped pushing
        (every reporter died) must decay to zero, not serve its last
        value forever."""
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
        """(newest - oldest-in-window) / elapsed, per second."""
        ep = self._endpoints(window_s, now)
        if ep is None:
            return 0.0
        t0, v0, t1, v1 = ep
        return (float(v1.get(key, 0.0)) - float(v0.get(key, 0.0))) \
            / (t1 - t0)

    def delta(self, key: str, window_s: float = 10.0,
              now: Optional[float] = None) -> float:
        """Windowed increase of a cumulative counter (identical sample
        selection and decay semantics to rate(), minus the time
        division)."""
        ep = self._endpoints(window_s, now)
        if ep is None:
            return 0.0
        _t0, v0, _t1, v1 = ep
        return float(v1.get(key, 0.0)) - float(v0.get(key, 0.0))


def hist_quantile(hist: Dict[str, object], q: float) -> float:
    """Approximate quantile of a dumped TYPE_HIST counter.

    Bucket b of hinc() holds values in [2^(b-1), 2^b) (b=0 holds
    values < 1), so the true quantile is known to within one power of
    two; interpolating linearly inside the winning bucket gives a
    stable point estimate — the same derivation `cephtop`, the mgr
    merge, and the bench latency-attribution aux all use, so p50/p99
    agree everywhere they are shown."""
    count = int(hist.get("count", 0) or 0)
    buckets = list(hist.get("buckets", []) or [])
    if count <= 0 or not buckets:
        return 0.0
    target = max(1.0, q * count)
    acc = 0.0
    for b, n in enumerate(buckets):
        if not n:
            continue
        if acc + n >= target:
            lo = 0.0 if b == 0 else float(1 << (b - 1))
            hi = 1.0 if b == 0 else float(1 << b)
            return lo + (target - acc) / n * (hi - lo)
        acc += n
    return float(1 << (len(buckets) - 1))


def hist_merge(into: Dict[str, object], val: Dict[str, object]) -> None:
    """Accumulate one dumped histogram into a merge accumulator
    ({count, sum, buckets}) — the cluster-wide aggregation primitive
    shared by the mgr poll and cephtop."""
    into["count"] = int(into.get("count", 0)) + int(val.get("count", 0))
    into["sum"] = float(into.get("sum", 0.0)) + float(val.get("sum", 0.0))
    b = into.setdefault("buckets", [])
    for i, n in enumerate(val.get("buckets", []) or []):
        if i < len(b):
            b[i] += n
        else:
            b.append(n)


def merge_stage_hists(payloads) -> Dict[str, Dict[str, object]]:
    """{counter: merged-histogram} over perf-dump payloads — ONE
    ``{subsys: counters}`` payload per PROCESS.  Only the op/queue
    stage sets (``*.op`` / ``*.tpuq``) participate, and a payload's
    ``.tpuq`` sets merge exactly once: every daemon's ``.tpuq`` is a
    view of that process's ONE StripeBatchQueue, while the ``.op``
    sets are genuinely per-daemon.  The single home of the merge rules
    so mgr `ops latency`, cephtop, and the bench attribution aux
    cannot drift apart."""
    merged: Dict[str, Dict[str, object]] = {}
    for dump in payloads:
        tpuq_done = False
        for subsys, counters in sorted(dump.items()):
            is_q = subsys.endswith(".tpuq")
            if not (subsys.endswith(".op") or is_q):
                continue
            if is_q:
                if tpuq_done:
                    continue
                tpuq_done = True
            for cname, val in counters.items():
                if isinstance(val, dict) and "buckets" in val:
                    hist_merge(merged.setdefault(cname, {}), val)
    return merged


def hist_summary(hist: Dict[str, object]) -> Dict[str, object]:
    """The {count, p50_us, p99_us, mean_us} row every latency surface
    renders (mgr `ops latency`, cephtop, the bench attribution aux) —
    ONE implementation so their numbers agree by construction."""
    count = int(hist.get("count", 0) or 0)
    return {
        "count": count,
        "p50_us": round(hist_quantile(hist, 0.50), 1),
        "p99_us": round(hist_quantile(hist, 0.99), 1),
        "mean_us": round(float(hist.get("sum", 0.0)) / count, 1)
        if count else 0.0,
    }


def hist_delta(after: Dict[str, object],
               before: Dict[str, object]) -> Dict[str, object]:
    """after - before of two dumped histograms (bench phase windows)."""
    ab = list(after.get("buckets", []) or [])
    bb = list(before.get("buckets", []) or [])
    bb += [0] * (len(ab) - len(bb))
    return {
        "count": int(after.get("count", 0)) - int(before.get("count", 0)),
        "sum": float(after.get("sum", 0.0)) - float(before.get("sum", 0.0)),
        "buckets": [a - b for a, b in zip(ab, bb)],
    }


class PerfCountersCollection:
    """All counter sets of one context; admin `perf dump` target."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._loggers: Dict[str, PerfCounters] = {}

    def create(self, name: str) -> PerfCounters:
        with self._lock:
            pc = self._loggers.get(name)
            if pc is None:
                pc = self._loggers[name] = PerfCounters(name)
            return pc

    def register(self, name: str, pc: PerfCounters) -> None:
        """Adopt an externally-built counter set (e.g. an ObjectStore's
        own counters) so `perf dump` covers it without the owner
        needing a Context at construction time."""
        with self._lock:
            self._loggers[name] = pc

    def get(self, name: str) -> Optional[PerfCounters]:
        with self._lock:
            return self._loggers.get(name)

    def dump(self) -> Dict[str, Dict[str, object]]:
        with self._lock:
            loggers = list(self._loggers.items())
        return {n: pc.dump() for n, pc in loggers}
