"""Pinned staging pool, data-path accounting and ``DeviceBuf`` payload
handles.

Port of ``ceph_tpu/tpu/staging.py``.  A client write's payload lands in
a staging slot once (``DeviceBuf.stage``), rides to the device with its
coalesced batch, and after that only metadata (CRCs, oids, versions,
extents) needs to cross back to the host.  A ``DeviceBuf`` is the
payload's handle through the write pipeline: messenger dispatch ->
object state -> EC backend -> ``Transaction`` -> store apply or wire
frame.

A slot is a view into one preallocated ``torch.uint8`` host slab,
page-locked when the pool serves a CUDA device; ``acquire`` blocks
while every slot is in use (backpressure, never drops) and a payload
larger than a slot gets a buffer of its own.  The locks are
lockdep-named as the reference's (``staging.stats``, ``staging.pool``,
``staging.devbuf``).

Who may materialize host bytes, and how it is counted in
``DevPathStats``:

- ``stage()``            the one receive-side copy (frame -> slot);
- the queue's batch      the one host -> device upload (``h2d_bytes``);
- ``wire_view()``        the sanctioned sinks (store apply, messenger
                         frame): zero-copy while the payload is on the
                         host; once the handle's truth is on the device
                         (sealed data planes, device-born parity) a
                         fetch counted in ``d2h_bytes``;
- ``tobytes()``          unsanctioned on the write path: every call
                         counts ``payload_host_touches``.

A ``"dev"`` or ``"planes"`` handle holds its payload as given: a numpy
array or a uint8 torch tensor, possibly on the card.  At a sink a
tensor on the card comes to the host in one device-to-host copy, and
that copy is what ``d2h_bytes`` counts; for a host array the counters
move as the reference's do for the same calls.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ceph_tpu_torch.core import failpoint as fp
from ceph_tpu_torch.core.lockdep import make_lock

# staging pool geometry (conf tpu_staging_* / env CEPH_TPU_TPU_STAGING_*)
DEFAULT_SLOT_BYTES = 128 << 10
DEFAULT_SLOTS = 64


def devpath_enabled(conf=None) -> bool:
    """Device-resident small-object data path kill switch."""
    if conf is not None:
        try:
            return bool(conf.get("tpu_devpath"))
        except KeyError:  # a Config without the option
            pass
    return os.environ.get("CEPH_TPU_TPU_DEVPATH", "1") not in (
        "0", "false", "no", "off")


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

    def perf_view(self, name: str):
        """A read-only ``PerfCounters``-like view (``name``, ``dump()``)
        for ``ctx.perf.register(f"osd.N.tpu", ...)``: it dumps the live
        snapshot."""
        stats = self

        class _View:
            def __init__(self) -> None:
                self.name = name

            def dump(self) -> Dict[str, int]:
                return stats.snapshot()

        return _View()


class StagingSlot:
    """One staging region: ``arr`` is a uint8 host tensor of ``nbytes``."""

    __slots__ = ("index", "arr", "nbytes")

    def __init__(self, index: int, arr: torch.Tensor, nbytes: int) -> None:
        self.index = index      # -1 = oversize (not pool-backed)
        self.arr = arr
        self.nbytes = nbytes


class StagingPool:
    """Bounded staging slots over one host slab, pinned when ``pin``.
    The geometry defaults to ``CEPH_TPU_TPU_STAGING_SLOT_KIB`` and
    ``CEPH_TPU_TPU_STAGING_SLOTS`` (128 KiB x 64); the slab is allocated
    at the first ``acquire``."""

    def __init__(self, slot_bytes: Optional[int] = None,
                 slots: Optional[int] = None, pin: bool = False,
                 stats: Optional[DevPathStats] = None) -> None:
        if slot_bytes is None:
            slot_bytes = int(os.environ.get(
                "CEPH_TPU_TPU_STAGING_SLOT_KIB", DEFAULT_SLOT_BYTES >> 10
            )) << 10
        if slots is None:
            slots = int(os.environ.get(
                "CEPH_TPU_TPU_STAGING_SLOTS", DEFAULT_SLOTS))
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

    def configure(self, slot_bytes: int, slots: int) -> bool:
        """Resize an idle pool (a daemon's tpu_staging_* conf, applied at
        its init).  Returns False, and changes nothing, while any slot is
        in use."""
        with self._cond:
            if self.nslots - len(self._free) > 0:
                return False
            if (slot_bytes, slots) == (self.slot_bytes, self.nslots):
                return True
            self.slot_bytes = int(slot_bytes)
            self.nslots = int(slots)
            self._slab = None
            self._free = list(range(self.nslots - 1, -1, -1))
            return True

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


def _on_card(a) -> bool:
    return isinstance(a, torch.Tensor) and a.device.type != "cpu"


def _host_np(a) -> np.ndarray:
    """``a`` (numpy or a uint8 tensor) as host numpy: zero-copy on the
    host, one device-to-host copy for a tensor on the card."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy() if _on_card(a) else a.numpy()
    return a


class DeviceBuf:
    """Payload handle that flows through the write pipeline without
    intermediate ``bytes`` copies.

    ``stage()`` binds it to a staging slot; the backend attaches the
    interleaved data planes at submit; once every sink (store apply,
    wire frames) has read the slot, ``seal()`` returns it to the pool
    and the planes become the handle's truth (a late reader fetches
    them, counted).  ``wrap_device()`` makes handles for device-born
    payloads (parity), ``wrap_host()`` for host views (data plane
    rows)."""

    __slots__ = ("_kind", "_arr", "_planes", "_size", "_k", "_unit",
                 "_slot", "_pool", "_stats", "_lock")

    def __init__(self, kind: str, arr, stats: DevPathStats,
                 slot: Optional[StagingSlot] = None,
                 pool: Optional[StagingPool] = None) -> None:
        self._kind = kind          # "host" | "planes" | "dev" | "bytes"
        self._arr = arr            # host: numpy [n]; dev: numpy or tensor
        self._planes = None        # [k, cols] planes, numpy or tensor
        self._size = len(arr) if arr is not None else 0
        self._k = 0
        self._unit = 0
        self._slot = slot
        self._pool = pool
        self._stats = stats
        # seal() on the fan-out thread races late readers
        self._lock = make_lock("staging.devbuf")

    # -- constructors -----------------------------------------------------
    @classmethod
    def stage(cls, pool: StagingPool, data,
              timeout: Optional[float] = 30.0) -> Optional["DeviceBuf"]:
        """The receive-side copy: payload -> staging slot.  Returns None
        when the pool stays exhausted past ``timeout`` (the caller keeps
        the host-bytes path)."""
        src = np.frombuffer(data, dtype=np.uint8)
        slot = pool.acquire(src.size, timeout=timeout)
        if slot is None:
            return None
        arr = slot.arr.numpy()
        np.copyto(arr, src)
        return cls("host", arr, pool.stats, slot=slot, pool=pool)

    @classmethod
    def wrap_device(cls, arr, stats: DevPathStats) -> "DeviceBuf":
        """Device-born payload (an encode's parity): a numpy array, or a
        uint8 tensor kept where it lies."""
        if isinstance(arr, torch.Tensor):
            return cls("dev", arr.reshape(-1), stats)
        return cls("dev", np.ascontiguousarray(arr).reshape(-1), stats)

    @classmethod
    def wrap_host(cls, arr, stats: DevPathStats) -> "DeviceBuf":
        """Host payload view (a staged data plane row): sinks read it
        zero-copy, nothing crosses."""
        if _on_card(arr):
            raise ValueError("wrap_host takes a host array; a tensor on "
                             "the card goes through wrap_device")
        a = _host_np(arr)
        return cls("host", a if a.ndim == 1 else a.reshape(-1), stats)

    # -- sizing -----------------------------------------------------------
    def __len__(self) -> int:
        return self._size

    @property
    def nbytes(self) -> int:
        return self._size

    # -- pipeline hooks ---------------------------------------------------
    def np1d(self) -> np.ndarray:
        """Host uint8 view for the interleave / encode input build (part
        of the one upload, not a crossing while on the host).  A sealed
        handle fetches its planes, counted; so does a ``"dev"`` handle
        whose tensor is on the card."""
        with self._lock:
            if self._kind == "host":
                return self._arr
            if self._kind == "bytes":
                return np.frombuffer(self._arr, dtype=np.uint8)
            if self._kind == "dev":
                if _on_card(self._arr):
                    self._stats.inc("d2h_bytes", self._size)
                return _host_np(self._arr)
            self._stats.inc("d2h_bytes", self._size)
            return _host_np(self._deinterleave())

    def attach_planes(self, planes, k: int, unit: int) -> None:
        """Bind the interleaved data planes this payload became; after
        seal() they are the handle's truth."""
        with self._lock:
            self._planes = planes
            self._k = k
            self._unit = unit

    def seal(self) -> None:
        """Fan-out done: every sink has read the staged slot, so return
        it to the pool.  With planes attached the handle lives on in
        them; without (an early bail) it keeps a host copy so late
        readers still see the bytes."""
        if fp.enabled("staging.seal"):
            fp.failpoint("staging.seal", size=self._size)
        with self._lock:
            if self._slot is not None:
                if self._planes is not None:
                    self._arr = None
                    self._kind = "planes"
                else:
                    self._arr = self._arr.tobytes()
                    self._kind = "bytes"
                self._pool.release(self._slot)
                self._slot = None
            elif self._planes is not None and self._kind != "planes":
                self._arr = None
                self._kind = "planes"

    def discard(self) -> None:
        """Early-bail release (an op answered without executing): return
        the slot without seal()'s host copy; a stray late read sees an
        empty buffer, never a reused slot."""
        with self._lock:
            if self._slot is not None:
                self._pool.release(self._slot)
                self._slot = None
            if self._planes is None and self._kind == "host":
                self._arr = b""
                self._kind = "bytes"
                self._size = 0

    # -- sinks ------------------------------------------------------------
    def _device_side(self) -> bool:
        return self._kind in ("planes", "dev")

    def _deinterleave(self):
        """The payload's bytes from its planes, where the planes lie."""
        p = self._planes
        S = p.shape[1] // self._unit if self._unit else 0
        p = p[:, :S * self._unit].reshape(self._k, S, self._unit)
        if isinstance(p, torch.Tensor):
            flat = p.transpose(0, 1).reshape(-1)
        else:
            flat = p.transpose(1, 0, 2).reshape(-1)
        return flat[:self._size]

    def _flat(self):
        """The flat payload where it lies (host numpy or a tensor)."""
        if self._kind == "planes":
            return self._deinterleave()
        if self._kind == "bytes":
            return np.frombuffer(self._arr, dtype=np.uint8)
        return self._arr

    def wire_view(self):
        """Sanctioned materialization at a sink (store apply, messenger
        frame).  Zero-copy while on the host; a fetch, counted, once the
        payload is device-side."""
        with self._lock:
            if self._device_side():
                self._stats.inc("d2h_bytes", self._size)
            a = _host_np(self._flat())
            return a if a.base is None else memoryview(a)

    def tobytes(self) -> bytes:
        """Unsanctioned host materialization: every call is a
        payload_host_touch."""
        self._stats.inc("payload_host_touches")
        with self._lock:
            if self._device_side():
                self._stats.inc("d2h_bytes", self._size)
            if self._kind == "bytes":
                return self._arr
            return _host_np(self._flat()).tobytes()

    def __bytes__(self) -> bytes:
        return self.tobytes()

    def __getitem__(self, key) -> bytes:
        """Read-path slicing: a fetch of the slice when device-side
        (counted), but not a write-path touch."""
        if isinstance(key, slice):
            with self._lock:
                if self._kind == "bytes":
                    return self._arr[key]
                sub = self._flat()[key]
                if self._device_side():
                    self._stats.inc("d2h_bytes", len(sub))
                return _host_np(sub).tobytes()
        raise TypeError("DeviceBuf supports slice reads only")

    def __del__(self) -> None:
        # a handle dropped without seal() must not keep its slot; no
        # other reference exists at collection, so no lock is needed
        slot = getattr(self, "_slot", None)
        pool = getattr(self, "_pool", None)
        if slot is not None and pool is not None:
            self._slot = None
            pool.release(slot)

    def __repr__(self) -> str:
        return (f"DeviceBuf({self._kind}, {self._size}B"
                f"{', slot' if self._slot is not None else ''})")
