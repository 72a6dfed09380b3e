"""Sharded work queues — ordered parallel dispatch for the OSD op path.

Reference: ThreadPool/WorkQueue (src/common/WorkQueue.h:28,266) and the
OSD's sharded op queue (src/osd/OSD.cc:2030 op_shardedwq, OSDShard at
:2065): items hash to a shard by ordering token (pg id), each shard is
a thread draining a priority queue, so per-PG ordering is preserved
while PGs run in parallel.

Two schedulers drain a shard (conf ``osd_op_queue``):

- ``mclock`` (default): a dmClock reservation/weight/limit queue per
  shard.  With a ``qos`` scheduler attached (osd/qos.py) the shard
  queues come from it — tenant-resolved classes, cost-aware tags,
  conf-driven profiles; standalone, a bare MClockQueue over the
  reference class defaults.
- ``fifo`` (alias ``wpq``): the legacy (priority, seq) heap — the A/B
  arm QoS measurements compare against.

``queue()`` accepts an ``on_admit(cls, phase, wait_s)`` callback fired
on the worker the moment the item is dequeued, BEFORE it runs: the
daemon marks the op's ``qos_admitted`` stage and feeds the per-class
wait histograms from it, under either scheduler (the fifo arm reports
phase ``fifo`` so A/B p99s come from the same stage histograms).

Port of ``ceph_tpu/core/workqueue.py``; the standalone ``mclock``
scheduler is the port's ``osd/mclock.py``.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Any, Callable, Hashable, List, Optional, Tuple


def _prio_to_class(priority: int) -> str:
    """WPQ priority -> mClock op class (the mClockOpClassQueue mapping
    role: client ops at high priority, sub-ops mid, recovery/scrub low)."""
    if priority >= 60:
        return "client"
    if priority >= 10:
        return "osd_subop"
    if priority >= 3:
        return "recovery"
    return "scrub"


class ShardedWorkQueue:
    def __init__(
        self,
        name: str,
        num_shards: int,
        process: Callable[[Any], None],
        on_error: Optional[Callable[[Any, BaseException], None]] = None,
        scheduler: str = "wpq",
        qos=None,
    ) -> None:
        self.name = name
        self.process = process
        self.on_error = on_error
        self.scheduler = scheduler
        self.qos = qos
        if scheduler == "mclock":
            if qos is not None:
                self._mclock: Optional[List] = [
                    qos.make_shard_queue() for _ in range(num_shards)
                ]
            else:
                from ceph_tpu_torch.osd.mclock import MClockQueue

                self._mclock = [MClockQueue() for _ in range(num_shards)]
        else:
            self._mclock = None
        self._shards: List[List[Tuple[int, int, Any]]] = [
            [] for _ in range(num_shards)
        ]
        self._conds = [threading.Condition() for _ in range(num_shards)]
        self._seq = itertools.count()
        self._stop = False
        self._threads = [
            threading.Thread(
                target=self._worker, args=(i,), name=f"{name}-{i}", daemon=True
            )
            for i in range(num_shards)
        ]
        self._inflight = 0
        self._drain_cond = threading.Condition()

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def queue(self, token: Hashable, item: Any, priority: int = 63,
              qos_class: Optional[str] = None, qos_cost: float = 1.0,
              on_admit: Optional[Callable[[str, str, float], None]] = None
              ) -> None:
        """Higher priority dispatches first; same token stays ordered.
        Under the mclock scheduler, `qos_class` (or the priority
        mapping) selects the dmClock class and `qos_cost` advances its
        tags (payload-byte charging).  `on_admit` fires at dequeue."""
        if self._stop:
            raise RuntimeError(f"work queue {self.name} is stopped")
        shard = hash(token) % len(self._shards)
        cls = qos_class or _prio_to_class(priority)
        entry = (item, on_admit, time.monotonic(), cls)
        with self._drain_cond:
            self._inflight += 1
        with self._conds[shard]:
            if self._mclock is not None:
                self._mclock[shard].enqueue(cls, entry, cost=qos_cost)
            else:
                heapq.heappush(
                    self._shards[shard], (-priority, next(self._seq), entry)
                )
            self._conds[shard].notify()

    def _worker(self, i: int) -> None:
        cond = self._conds[i]
        q = self._shards[i]
        mq = self._mclock[i] if self._mclock is not None else None
        while True:
            with cond:
                if mq is not None:
                    cond.wait_for(lambda: len(mq) or self._stop)
                    if self._stop and not len(mq):
                        return
                    cls, entry = mq.dequeue()
                    phase = mq.last_phase
                else:
                    cond.wait_for(lambda: q or self._stop)
                    if self._stop and not q:
                        return
                    _, _, entry = heapq.heappop(q)
                    cls, phase = entry[3], "fifo"
            item, on_admit, t0, _cls = entry
            if on_admit is not None:
                try:
                    on_admit(cls, phase, time.monotonic() - t0)
                # QoS accounting is advisory; a broken callback must
                # never stop the item itself from dispatching
                except Exception:
                    pass
            try:
                self.process(item)
            except BaseException as e:  # noqa: BLE001 — worker must survive
                if self.on_error:
                    self.on_error(item, e)
            finally:
                with self._drain_cond:
                    self._inflight -= 1
                    if self._inflight == 0:
                        self._drain_cond.notify_all()

    def drain(self, timeout: float | None = None) -> bool:
        with self._drain_cond:
            return self._drain_cond.wait_for(
                lambda: self._inflight == 0, timeout
            )

    def stop(self) -> None:
        self._stop = True
        for c in self._conds:
            with c:
                c.notify_all()
        for t in self._threads:
            t.join(timeout=5)
