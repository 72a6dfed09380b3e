"""Pinned staging pool and data-path accounting.

Port of ``DevPathStats`` (``ceph_tpu/tpu/staging.py:68``) and
``StagingPool`` (``:128``).  A slot is a view into one preallocated
``torch.uint8`` host slab, page-locked when the pool serves a CUDA
device, so a coalesced batch crosses host -> device in one DMA from it.
``acquire`` blocks while every slot is in use (backpressure, never
drops); a payload larger than a slot gets a buffer of its own.
Both take lockdep-named locks, the reference's names
(``staging.stats``, ``staging.pool``).  (``DeviceBuf``, the payload
handle of the OSD write pipeline, and its ``staging.seal`` failpoint
site come with slice 1e.)
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

from ceph_tpu_torch.core.lockdep import make_lock

DEFAULT_SLOT_BYTES = 128 << 10
DEFAULT_SLOTS = 64


class DevPathStats:
    """h2d/d2h accounting: "metadata-only host crossing" as a measured
    invariant."""

    def __init__(self) -> None:
        self._lock = make_lock("staging.stats")
        self.h2d_bytes = 0           # payload bytes uploaded (batch build)
        self.d2h_bytes = 0           # payload bytes fetched back to host
        self.staged_batches = 0      # coalesced device batches uploaded
        self.payload_host_touches = 0  # unsanctioned host materializations
        self.pool_occupancy_hw = 0   # staging slots in use, high-water

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + by)

    def note_occupancy(self, occ: int) -> None:
        with self._lock:
            if occ > self.pool_occupancy_hw:
                self.pool_occupancy_hw = occ

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "h2d_bytes": self.h2d_bytes,
                "d2h_bytes": self.d2h_bytes,
                "staged_batches": self.staged_batches,
                "payload_host_touches": self.payload_host_touches,
                "pool_occupancy_hw": self.pool_occupancy_hw,
            }


class StagingSlot:
    """One staging region: ``arr`` is a uint8 host tensor of ``nbytes``."""

    __slots__ = ("index", "arr", "nbytes")

    def __init__(self, index: int, arr: torch.Tensor, nbytes: int) -> None:
        self.index = index      # -1 = oversize (not pool-backed)
        self.arr = arr
        self.nbytes = nbytes


class StagingPool:
    """Bounded staging slots over one host slab, pinned when ``pin``.
    The slab is allocated at the first ``acquire``."""

    def __init__(self, slot_bytes: int = DEFAULT_SLOT_BYTES,
                 slots: int = DEFAULT_SLOTS, pin: bool = False,
                 stats: Optional[DevPathStats] = None) -> None:
        self.slot_bytes = int(slot_bytes)
        self.nslots = int(slots)
        self.pin = bool(pin)
        self.stats = stats or DevPathStats()
        self._slab: Optional[torch.Tensor] = None
        self._free = list(range(self.nslots - 1, -1, -1))
        self._cond = threading.Condition(make_lock("staging.pool"))

    @property
    def occupancy(self) -> int:
        with self._cond:
            return self.nslots - len(self._free)

    def _host(self, nbytes: int) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.pin)

    def acquire(self, nbytes: int,
                timeout: Optional[float] = None) -> Optional[StagingSlot]:
        """A slot holding ``nbytes``; blocks while the pool is exhausted.
        Returns None if ``timeout`` runs out first."""
        if nbytes > self.slot_bytes:
            return StagingSlot(-1, self._host(nbytes), nbytes)
        with self._cond:
            if not self._free and not self._cond.wait_for(
                    lambda: bool(self._free), timeout=timeout):
                return None
            idx = self._free.pop()
            if self._slab is None:
                self._slab = self._host(self.slot_bytes * self.nslots)
            slab = self._slab
            self.stats.note_occupancy(self.nslots - len(self._free))
        base = idx * self.slot_bytes
        return StagingSlot(idx, slab[base:base + nbytes], nbytes)

    def release(self, slot: StagingSlot) -> None:
        if slot.index < 0:
            return  # oversize: plain GC
        with self._cond:
            self._free.append(slot.index)
            self._cond.notify()
