"""Small thread-safe bounded LRU (reference SharedLRU role).

One implementation for the caches that need capacity-bounded
most-recently-used retention (PG object contexts, and any future
cache); generation tagging lets racing async fills be refused after a
wholesale invalidation (an insert carrying a stale generation is
dropped instead of poisoning the cache).

Port of ``ceph_tpu/core/lru.py``, name for name.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, Iterator, Optional, Tuple, TypeVar

V = TypeVar("V")


class LRUCache:
    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self._d: "collections.OrderedDict" = collections.OrderedDict()
        self._lock = threading.Lock()
        self._gen = 0

    def generation(self) -> int:
        with self._lock:
            return self._gen

    def get(self, key, copy: Optional[Callable[[V], V]] = None):
        """Returns a hit (optionally deep-copied INSIDE the lock so the
        caller can use it lock-free) or None."""
        with self._lock:
            got = self._d.get(key)
            if got is None:
                return None
            self._d.move_to_end(key)
            return copy(got) if copy is not None else got

    def put(self, key, value, gen: Optional[int] = None) -> bool:
        """Insert; refused (False) when `gen` is stale — an async fill
        racing a wholesale invalidation must not reinsert old state."""
        with self._lock:
            if gen is not None and gen != self._gen:
                return False
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)
            return True

    def pop(self, key) -> None:
        with self._lock:
            self._d.pop(key, None)
            self._gen += 1  # in-flight fills for ANY key are now suspect

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
            self._gen += 1

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._d

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)
