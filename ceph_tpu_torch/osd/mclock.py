"""dmClock op scheduling — reservation / weight / limit QoS.

Reference role: src/dmclock/ (the mClock algorithm) behind the OSD's
mClockOpClassQueue (src/osd/mClockOpClassQueue.cc): each op class
(client, osd-subop, recovery, scrub, ...) gets a QoS triple

    reservation r  — the IOPS floor the class is guaranteed,
    weight w       — how surplus capacity is shared,
    limit l        — the IOPS ceiling the class may not exceed
                     (0 = unlimited),

and every enqueued op receives tags R/P/L advanced by cost/r, cost/w,
cost/l from its class's previous op — `cost` in scheduler units (the
QoS subsystem charges payload bytes, so a 64 KiB write advances the
tags 16x a 4 KiB one).  Dequeue runs the two dmClock phases: first any
op whose reservation tag is due (smallest R wins — floors are honored
before anything else), otherwise the smallest proportional-share tag P
among classes whose limit tag is not in the future.  A work-conserving
fallback serves the smallest P when every class is limit-throttled
(the device should never idle while ops wait).

Tag anchoring: every tag is ``max(prev + cost/rate, now)``.  The max
is the whole idle discipline — a class returning from an idle gap has
stale tags, and the anchor means its FIRST op is due exactly AT `now`
(not now + 1/r: that would dock the class one slot per idle restart)
while every successor chains from >= now (the gap is never replayed
as accumulated credit: N ops after a 10 s idle earn ONE instantly-due
reservation grant, not N).

The clock is injectable (constructor arg or the ``clock`` attribute)
so scheduler-conformance tests run on a deterministic fake clock —
the SnapshotRing/ProgressModule testability discipline.

Port of ``ceph_tpu/osd/mclock.py``, all of it (pure Python): under one
clock and one sequence of enqueues it dequeues what the reference does.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Any, Callable, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ClientInfo:
    """QoS triple for one op class (reference dmc::ClientInfo)."""

    reservation: float = 0.0  # ops/sec floor (0 = none)
    weight: float = 1.0       # proportional share
    limit: float = 0.0        # ops/sec ceiling (0 = unlimited)


# the reference's default class profile (mClockOpClassQueue shape);
# the QoS profile registry (osd/qos.py) layers tenant/pool overrides
# on top of these base classes
DEFAULT_CLASSES: Dict[str, ClientInfo] = {
    "client": ClientInfo(reservation=100.0, weight=100.0, limit=0.0),
    "osd_subop": ClientInfo(reservation=100.0, weight=80.0, limit=0.0),
    "recovery": ClientInfo(reservation=20.0, weight=10.0, limit=200.0),
    "scrub": ClientInfo(reservation=5.0, weight=5.0, limit=100.0),
    "snaptrim": ClientInfo(reservation=2.0, weight=2.0, limit=50.0),
    "best_effort": ClientInfo(reservation=0.0, weight=1.0, limit=0.0),
}

# dequeue phases (the dmClock two-phase verdict + the work-conserving
# fallback): recorded per dequeue as scheduler evidence (osd.N.qos)
PHASE_RESERVATION = "reservation"
PHASE_PRIORITY = "priority"
PHASE_FALLBACK = "fallback"


class _ClassState:
    __slots__ = ("info", "r_tag", "p_tag", "l_tag", "queue")

    def __init__(self, info: ClientInfo) -> None:
        self.info = info
        self.r_tag = 0.0
        self.p_tag = 0.0
        self.l_tag = 0.0
        # strict FIFO per class: deque for O(1) popleft on the hot path
        self.queue: "collections.deque" = collections.deque()


class MClockQueue:
    """Single-lock dmClock queue: enqueue(cls, item, cost) / dequeue().

    `resolver(name) -> ClientInfo` supplies triples for classes first
    seen at enqueue time (the QoS registry's tenant/pool classes);
    without one, unknown classes ride the best_effort triple.
    """

    def __init__(self, classes: Optional[Dict[str, ClientInfo]] = None,
                 clock=time.monotonic,
                 resolver: Optional[Callable[[str], ClientInfo]] = None
                 ) -> None:
        self.clock = clock
        self.resolver = resolver
        self._classes: Dict[str, _ClassState] = {}
        for name, info in (classes or DEFAULT_CLASSES).items():
            self._classes[name] = _ClassState(info)
        self._seq = itertools.count()
        self._size = 0
        # phase of the most recent dequeue(), valid under the caller's
        # lock (the sharded workqueue holds its shard lock across the
        # dequeue + the read)
        self.last_phase = ""

    def add_class(self, name: str, info: ClientInfo) -> None:
        self._classes[name] = _ClassState(info)

    def set_class(self, name: str, info: ClientInfo) -> None:
        """Runtime retune: future tags advance at the new rates; the
        tags already assigned keep their admission order (dmclock's
        update_client_info role)."""
        st = self._classes.get(name)
        if st is None:
            self.add_class(name, info)
        else:
            st.info = info

    def __len__(self) -> int:
        return self._size

    def enqueue(self, cls: str, item: Any, cost: float = 1.0) -> None:
        st = self._classes.get(cls)
        if st is None:
            info = None
            if self.resolver is not None:
                info = self.resolver(cls)
            if info is None:
                info = DEFAULT_CLASSES["best_effort"]
            st = self._classes[cls] = _ClassState(info)
        now = self.clock()
        info = st.info
        cost = max(cost, 1e-9)
        # max(prev + delta, now) IS the idle re-anchor (module
        # docstring): first-after-idle lands due AT now, successors
        # chain from >= now, the gap never becomes credit
        if info.reservation > 0:
            st.r_tag = max(st.r_tag + cost / info.reservation, now)
        else:
            st.r_tag = float("inf")
        st.p_tag = max(st.p_tag + cost / max(info.weight, 1e-9), now)
        if info.limit > 0:
            st.l_tag = max(st.l_tag + cost / info.limit, now)
        else:
            st.l_tag = now
        st.queue.append((next(self._seq), item, st.r_tag, st.p_tag,
                         st.l_tag))
        self._size += 1

    def dequeue(self) -> Optional[Tuple[str, Any]]:
        if self._size == 0:
            return None
        now = self.clock()
        # phase 1: due reservations, smallest R first (floors always win)
        best = None
        phase = PHASE_RESERVATION
        for name, st in self._classes.items():
            if not st.queue:
                continue
            r = st.queue[0][2]
            if r <= now and (best is None or r < best[0]):
                best = (r, name)
        if best is None:
            # phase 2: proportional share among limit-eligible classes
            phase = PHASE_PRIORITY
            for name, st in self._classes.items():
                if not st.queue:
                    continue
                if st.queue[0][4] > now:
                    continue  # limit tag in the future: throttled
                p = st.queue[0][3]
                if best is None or p < best[0]:
                    best = (p, name)
        if best is None:
            # all throttled: work-conserving fallback on smallest P
            phase = PHASE_FALLBACK
            for name, st in self._classes.items():
                if not st.queue:
                    continue
                p = st.queue[0][3]
                if best is None or p < best[0]:
                    best = (p, name)
        assert best is not None
        name = best[1]
        st = self._classes[name]
        _, item, *_ = st.queue.popleft()
        self._size -= 1
        self.last_phase = phase
        return name, item

    def stats(self) -> Dict[str, int]:
        return {name: len(st.queue)
                for name, st in self._classes.items() if st.queue}

    def class_info(self) -> Dict[str, ClientInfo]:
        """Current triples of every class this queue has seen."""
        return {name: st.info for name, st in self._classes.items()}
