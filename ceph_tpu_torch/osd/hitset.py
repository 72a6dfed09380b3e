"""HitSet family + tier-agent decision logic (cache tiering core).

Port of ``ceph_tpu/osd/hitset.py``: the same sets, the same hashes and
the same encodings, byte for byte; ``contains_batch`` stays numpy, as in
the reference.

Reference: src/osd/HitSet.h — per-PG sets of recently-accessed objects
(bloom or explicit), rotated on a period, archived as a history ring;
PrimaryLogPG consults the recent sets to decide promotion
(maybe_promote) and the tier agent walks temperatures to pick
flush/evict victims (src/osd/TierAgentState.h, agent_work in
PrimaryLogPG.cc).

The bloom variant is a plain double-hashing Bloom filter sized from a
target false-positive probability — same parameterization as the
reference's compressible_bloom_filter (insert count + fpp), minus the
compression (membership tests over a BATCH of objects are one
vectorized gather, `contains_batch`).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ceph_tpu_torch.core.crc import crc32c
from ceph_tpu_torch.core.encoding import Decoder, Encoder


def _hash2(name: str) -> Tuple[int, int]:
    b = name.encode()
    h1 = crc32c(b)
    h2 = crc32c(b, 0xDEADBEEF) | 1  # odd => full-period double hashing
    return h1, h2


class BloomHitSet:
    """HitSet::Params TYPE_BLOOM (reference HitSet.h:106)."""

    kind = "bloom"

    def __init__(self, target_size: int = 10000, fpp: float = 0.01,
                 _bits: Optional[np.ndarray] = None,
                 _nhash: Optional[int] = None) -> None:
        self.target_size = target_size
        self.fpp = fpp
        if _bits is not None:
            self.bits = _bits
            self.nhash = int(_nhash)
        else:
            nbits = max(64, int(-target_size * math.log(fpp)
                                / (math.log(2) ** 2)))
            nbits = -(-nbits // 64) * 64
            self.bits = np.zeros(nbits // 8, dtype=np.uint8)
            self.nhash = max(1, int(round(nbits / target_size
                                          * math.log(2))))
        self.inserts = 0

    @property
    def nbits(self) -> int:
        return self.bits.size * 8

    def _positions(self, name: str) -> np.ndarray:
        h1, h2 = _hash2(name)
        ks = np.arange(self.nhash, dtype=np.uint64)
        return (np.uint64(h1) + ks * np.uint64(h2)) % np.uint64(self.nbits)

    def insert(self, name: str) -> None:
        pos = self._positions(name)
        np.bitwise_or.at(self.bits, (pos // 8).astype(np.int64),
                         (1 << (pos % 8)).astype(np.uint8))
        self.inserts += 1

    def contains(self, name: str) -> bool:
        pos = self._positions(name)
        return bool(np.all(
            (self.bits[(pos // 8).astype(np.int64)]
             >> (pos % 8).astype(np.uint8)) & 1))

    def contains_batch(self, names: Sequence[str]) -> np.ndarray:
        """Vectorized membership for a batch (one gather per hash)."""
        if not names:
            return np.zeros(0, dtype=bool)
        h = np.array([_hash2(n) for n in names], dtype=np.uint64)
        ks = np.arange(self.nhash, dtype=np.uint64)
        pos = (h[:, 0:1] + ks[None, :] * h[:, 1:2]) % np.uint64(self.nbits)
        got = (self.bits[(pos // 8).astype(np.int64)]
               >> (pos % 8).astype(np.uint8)) & 1
        return np.all(got.astype(bool), axis=1)

    def is_full(self) -> bool:
        return self.inserts >= self.target_size

    def encode(self, e: Encoder) -> None:
        e.start(1, 1)
        e.string(self.kind)
        e.u32(self.target_size).u32(self.nhash).u32(self.inserts)
        e.blob(self.bits.tobytes())
        e.finish()

    @classmethod
    def decode(cls, d: Decoder) -> "BloomHitSet":
        d.start(1)
        kind = d.string()
        assert kind == cls.kind
        target, nhash, inserts = d.u32(), d.u32(), d.u32()
        bits = np.frombuffer(d.blob(), dtype=np.uint8).copy()
        d.end()
        hs = cls(target_size=target, _bits=bits, _nhash=nhash)
        hs.inserts = inserts
        return hs


class ExplicitHitSet:
    """HitSet::Params TYPE_EXPLICIT_HASH (exact, unbounded)."""

    kind = "explicit"

    def __init__(self, target_size: int = 10000) -> None:
        self.target_size = target_size
        self.names: set = set()

    @property
    def inserts(self) -> int:
        return len(self.names)

    def insert(self, name: str) -> None:
        self.names.add(name)

    def contains(self, name: str) -> bool:
        return name in self.names

    def contains_batch(self, names: Sequence[str]) -> np.ndarray:
        return np.array([n in self.names for n in names], dtype=bool)

    def is_full(self) -> bool:
        return len(self.names) >= self.target_size

    def encode(self, e: Encoder) -> None:
        e.start(1, 1)
        e.string(self.kind)
        e.u32(self.target_size)
        e.seq(sorted(self.names), lambda en, n: en.string(n))
        e.finish()

    @classmethod
    def decode(cls, d: Decoder) -> "ExplicitHitSet":
        d.start(1)
        kind = d.string()
        assert kind == cls.kind
        hs = cls(target_size=d.u32())
        hs.names = set(d.seq(lambda dd: dd.string()))
        d.end()
        return hs


def decode_hitset(d: Decoder):
    # peek the kind string inside the frame
    save = d.off
    d.start(1)
    kind = d.string()
    d.off = save
    d._ends.pop()
    if kind == BloomHitSet.kind:
        return BloomHitSet.decode(d)
    return ExplicitHitSet.decode(d)


class HitSetHistory:
    """Archived hitsets, newest last (the PG's hit_set ring; reference
    pg_hit_set_history_t)."""

    def __init__(self, count: int = 4) -> None:
        self.count = count
        self.archive: List[Tuple[float, float, object]] = []  # (b, e, hs)

    def add(self, begin: float, end: float, hs) -> None:
        self.archive.append((begin, end, hs))
        del self.archive[: -self.count]

    def hit_count(self, name: str, last_n: Optional[int] = None) -> int:
        sets = self.archive[-(last_n or self.count):]
        return sum(1 for _b, _e, hs in sets if hs.contains(name))

    def temperature_batch(self, names: Sequence[str]) -> np.ndarray:
        """Per-object hit counts over the ring — one vectorized pass per
        archived set (the agent's temperature input)."""
        t = np.zeros(len(names), dtype=np.int32)
        for _b, _e, hs in self.archive:
            t += hs.contains_batch(names).astype(np.int32)
        return t


class TierAgent:
    """Flush/evict decision logic (TierAgentState roles: the agent picks
    cold dirty objects to flush and cold clean objects to evict, driven
    by fullness vs the pool's target ratios)."""

    def __init__(self, history: HitSetHistory,
                 target_dirty_ratio: float = 0.4,
                 target_full_ratio: float = 0.8,
                 min_recency_for_promote: int = 2) -> None:
        self.history = history
        self.target_dirty_ratio = target_dirty_ratio
        self.target_full_ratio = target_full_ratio
        self.min_recency_for_promote = min_recency_for_promote

    def should_promote(self, name: str) -> bool:
        """An object is promoted into the cache tier when it was hit in
        >= min_recency recent hitsets (maybe_promote recency check)."""
        return (self.history.hit_count(name)
                >= self.min_recency_for_promote)

    def plan(self, objects: Dict[str, bool], used_ratio: float,
             dirty_ratio: float, max_ops: int = 16
             ) -> Tuple[List[str], List[str]]:
        """(flush list, evict list): coldest dirty objects flush when
        dirty_ratio exceeds target; coldest clean objects evict when
        used_ratio exceeds target."""
        names = sorted(objects)
        temps = self.history.temperature_batch(names)
        order = np.argsort(temps, kind="stable")  # coldest first
        flush: List[str] = []
        evict: List[str] = []
        if dirty_ratio > self.target_dirty_ratio:
            flush = [names[i] for i in order
                     if objects[names[i]]][:max_ops]
        if used_ratio > self.target_full_ratio:
            evict = [names[i] for i in order
                     if not objects[names[i]]][:max_ops]
        return flush, evict
