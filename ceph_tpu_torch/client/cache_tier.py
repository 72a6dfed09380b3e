"""Cache-tier dataplane: promote / proxy / writeback / flush / evict.

Reference: PrimaryLogPG's cache-mode writeback machinery
(maybe_handle_cache_detail: promote on recency, proxy reads for cold
objects, agent_work flush/evict) — composed here from the same parts
this framework already ships: HitSetHistory temperatures + TierAgent
decisions (osd/hitset.py) over two pools of one cluster.

The reference runs this inside the OSD with the PG's hit sets; the
inversion here is a tier PROXY at the client library layer (the
librados "cache pool" user surface), with its own access history.
Semantics kept:
- reads hit the cache tier; a miss either PROXIES to the base (cold
  object: no pollution) or PROMOTES (copy up) when the object was hit
  in enough recent hit sets
- writes land in the cache, marked dirty (writeback mode)
- `agent_work()` is the tier agent: flushes the coldest dirty objects
  back to base and evicts the coldest clean ones when fullness
  exceeds the targets; flush clears dirty, evict drops the cached copy

Port of ``ceph_tpu/client/cache_tier.py``, all of it, over the port's
``osd/hitset.py``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.client.rados import IoCtx, RadosError
from ceph_tpu_torch.osd.hitset import BloomHitSet, HitSetHistory, TierAgent

DIRTY_XATTR = "cache-dirty"


class CacheTier:
    def __init__(self, cache: IoCtx, base: IoCtx,
                 hit_set_period: float = 1.0,
                 hit_set_count: int = 4,
                 hit_set_target_size: int = 1000,
                 min_recency_for_promote: int = 2,
                 target_dirty_ratio: float = 0.4,
                 target_full_ratio: float = 0.8,
                 capacity_objects: int = 1024) -> None:
        self.cache = cache
        self.base = base
        self.history = HitSetHistory(count=hit_set_count)
        self.agent = TierAgent(
            self.history,
            target_dirty_ratio=target_dirty_ratio,
            target_full_ratio=target_full_ratio,
            min_recency_for_promote=min_recency_for_promote)
        self.hit_set = BloomHitSet(target_size=hit_set_target_size)
        self.hit_set_period = hit_set_period
        self._hit_set_start = time.time()
        self.capacity_objects = capacity_objects
        self.promotes = 0
        self.proxied = 0

    # -- hit tracking ------------------------------------------------------
    def _record(self, oid: str) -> None:
        now = time.time()
        if (self.hit_set.is_full()
                or now - self._hit_set_start >= self.hit_set_period):
            self.history.add(self._hit_set_start, now, self.hit_set)
            self.hit_set = BloomHitSet(
                target_size=self.hit_set.target_size)
            self._hit_set_start = now
        self.hit_set.insert(oid)

    def _recent_enough(self, oid: str) -> bool:
        hits = self.history.hit_count(oid)
        if self.hit_set.contains(oid):
            hits += 1
        return hits >= self.agent.min_recency_for_promote

    # -- data path ---------------------------------------------------------
    def read(self, oid: str, length: int = 0, off: int = 0) -> bytes:
        self._record(oid)
        try:
            return self.cache.read(oid, length, off)
        except RadosError as e:
            if e.rc != -2:
                raise
        if self._recent_enough(oid):
            self._promote(oid)
            return self.cache.read(oid, length, off)
        # cold object: proxy the read, do not pollute the cache
        self.proxied += 1
        return self.base.read(oid, length, off)

    def write_full(self, oid: str, data: bytes) -> None:
        """Writeback mode: the cache absorbs the write; the base sees
        it at flush time."""
        self._record(oid)
        self.cache.write_full(oid, data)
        self.cache.setxattr(oid, DIRTY_XATTR, b"1")

    def remove(self, oid: str) -> None:
        try:
            self.cache.remove(oid)
        except RadosError as e:
            if e.rc != -2:
                raise
        try:
            self.base.remove(oid)
        except RadosError as e:
            if e.rc != -2:
                raise

    def _promote(self, oid: str) -> None:
        data = self.base.read(oid)
        self.cache.write_full(oid, data)  # promoted copy is CLEAN
        self.promotes += 1

    # -- the agent ---------------------------------------------------------
    def _cache_objects(self) -> Dict[str, bool]:
        out: Dict[str, bool] = {}
        for oid in self.cache.list_objects():
            try:
                dirty = self.cache.getxattr(oid, DIRTY_XATTR) == b"1"
            except RadosError:
                dirty = False
            out[oid] = dirty
        return out

    def flush(self, oid: str) -> None:
        """Write the dirty cached copy back to base; it stays cached,
        clean (the reference's flush, not evict)."""
        data = self.cache.read(oid)
        self.base.write_full(oid, data)
        self.cache.setxattr(oid, DIRTY_XATTR, b"0")

    def evict(self, oid: str) -> None:
        """Drop a CLEAN cached copy (dirty objects must flush first).
        A missing dirty xattr means clean: read-promoted copies never
        get the xattr set."""
        try:
            dirty = self.cache.getxattr(oid, DIRTY_XATTR) == b"1"
        except RadosError as e:
            if e.rc != -2:
                raise
            dirty = False
        if dirty:
            raise RadosError(-16, f"{oid} is dirty")  # EBUSY
        self.cache.remove(oid)

    def agent_work(self, max_ops: int = 16) -> Dict[str, List[str]]:
        """One agent pass (PrimaryLogPG::agent_work role): flush the
        coldest dirty, evict the coldest clean, driven by fullness."""
        objs = self._cache_objects()
        n = len(objs)
        dirty = sum(1 for d in objs.values() if d)
        used_ratio = n / self.capacity_objects
        dirty_ratio = dirty / self.capacity_objects
        to_flush, to_evict = self.agent.plan(objs, used_ratio,
                                             dirty_ratio, max_ops)
        for oid in to_flush:
            self.flush(oid)
        # an evict candidate that was just flushed is now clean
        for oid in to_evict:
            try:
                self.evict(oid)
            except RadosError:
                pass
        return {"flushed": to_flush, "evicted": to_evict}

    def flush_all(self) -> int:
        """Flush every dirty object (cache-flush before tier removal)."""
        n = 0
        for oid, dirty in self._cache_objects().items():
            if dirty:
                self.flush(oid)
                n += 1
        return n
