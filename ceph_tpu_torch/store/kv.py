"""KeyValueDB — pluggable KV with batched writes and prefix iteration.

Reference: src/kv/KeyValueDB.h (the abstraction), MemDB (src/kv/),
and the RocksDB role (src/kv/RocksDBStore.cc) filled by LogKV: an
append-only crc-guarded record log with an in-memory index and
compaction — durable without a vendored LSM tree.  Keys are namespaced
`prefix + "\\x00" + key`, matching the reference's (prefix, key) pairs.

Port of ``ceph_tpu/store/kv.py``: LogKV's record log is the
reference's byte for byte (the framing's CRC-32C is ``core.crc``), so
either package replays the other's log.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Dict, Iterator, List, Optional, Tuple

from ceph_tpu_torch.core.crc import crc32c
from ceph_tpu_torch.core.lockdep import make_lock

_SEP = "\x00"


class WriteBatch:
    """Reference KeyValueDB::Transaction: buffered set/rmkey ops."""

    def __init__(self) -> None:
        self.ops: List[Tuple[bool, str, bytes]] = []  # (is_set, key, val)

    def set(self, prefix: str, key: str, value: bytes) -> None:
        self.ops.append((True, prefix + _SEP + key, bytes(value)))

    def rmkey(self, prefix: str, key: str) -> None:
        self.ops.append((False, prefix + _SEP + key, b""))


class KVIterator:
    """Seekable ordered iterator over one prefix space — the reference
    KeyValueDB::IteratorImpl surface (src/kv/KeyValueDB.h: seek_to_first,
    lower_bound, upper_bound, valid, next, prev, key, value).  Operates
    on a stable point-in-time view, like a RocksDB iterator."""

    def __init__(self, items: List[Tuple[str, bytes]]) -> None:
        self._items = items  # sorted
        self._keys = [k for k, _ in items]
        self._pos = 0

    def seek_to_first(self) -> "KVIterator":
        self._pos = 0
        return self

    def seek_to_last(self) -> "KVIterator":
        self._pos = len(self._items) - 1
        return self

    def lower_bound(self, key: str) -> "KVIterator":
        import bisect

        self._pos = bisect.bisect_left(self._keys, key)
        return self

    def upper_bound(self, key: str) -> "KVIterator":
        import bisect

        self._pos = bisect.bisect_right(self._keys, key)
        return self

    def valid(self) -> bool:
        return 0 <= self._pos < len(self._items)

    def next(self) -> None:
        self._pos += 1

    def prev(self) -> None:
        self._pos -= 1

    def key(self) -> str:
        return self._items[self._pos][0]

    def value(self) -> bytes:
        return self._items[self._pos][1]


class KVSnapshot:
    """Read-only point-in-time view (the RocksDB GetSnapshot role):
    reads are stable against later submits."""

    def __init__(self, data: Dict[str, bytes]) -> None:
        self._data = data

    def get(self, prefix: str, key: str) -> Optional[bytes]:
        return self._data.get(prefix + _SEP + key)

    def iterate(self, prefix: str) -> Iterator[Tuple[str, bytes]]:
        pat = prefix + _SEP
        return iter(sorted((k[len(pat):], v) for k, v in self._data.items()
                           if k.startswith(pat)))

    def get_iterator(self, prefix: str) -> KVIterator:
        return KVIterator(list(self.iterate(prefix)))


class KeyValueDB:
    def open(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def submit(self, batch: WriteBatch, sync: bool = False) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        """Make every submitted batch durable (one fsync for all of
        them) — the group-commit hook: submit(sync=False) many times,
        sync() once from a commit thread."""

    def get(self, prefix: str, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def iterate(self, prefix: str) -> Iterator[Tuple[str, bytes]]:
        """Sorted (key, value) pairs under prefix."""
        raise NotImplementedError

    def iterate_prefix(self, space: str,
                       key_prefix: str) -> Iterator[Tuple[str, bytes]]:
        """Sorted (key, value) pairs in `space` whose key starts with
        key_prefix — the ranged-iterator shape RocksDB serves with a
        seek (reference KeyValueDB::IteratorImpl::lower_bound); scan
        stores filter, ordered stores may seek."""
        for k, v in self.iterate(space):
            if k.startswith(key_prefix):
                yield k, v

    def get_iterator(self, prefix: str) -> KVIterator:
        """Seekable iterator over `prefix` (KeyValueDB::get_iterator)."""
        return KVIterator(list(self.iterate(prefix)))

    def snapshot(self) -> KVSnapshot:
        """Stable read view (RocksDB GetSnapshot role)."""
        raise NotImplementedError


class MemDB(KeyValueDB):
    def __init__(self) -> None:
        self._data: Dict[str, bytes] = {}
        self._lock = make_lock("kv.memdb")

    def open(self) -> None:
        pass

    def submit(self, batch: WriteBatch, sync: bool = False) -> None:
        with self._lock:
            for is_set, key, val in batch.ops:
                if is_set:
                    self._data[key] = val
                else:
                    self._data.pop(key, None)

    def get(self, prefix: str, key: str) -> Optional[bytes]:
        with self._lock:
            return self._data.get(prefix + _SEP + key)

    def iterate(self, prefix: str) -> Iterator[Tuple[str, bytes]]:
        pat = prefix + _SEP
        with self._lock:
            items = sorted(
                (k[len(pat):], v)
                for k, v in self._data.items()
                if k.startswith(pat)
            )
        return iter(items)

    def snapshot(self) -> KVSnapshot:
        with self._lock:
            return KVSnapshot(dict(self._data))


class LogKV(KeyValueDB):
    """Append-only record log + in-memory index.

    Record: [u32 body_len][u32 crc32c(body)][body] where body =
    [u8 is_set][u32 klen][key][u32 vlen][val].  A torn tail (bad crc or
    short read) ends replay — the WAL discipline of the reference's
    FileJournal (src/os/filestore/FileJournal.cc role).
    """

    _HDR = struct.Struct("<II")

    def __init__(self, path: str) -> None:
        self.path = path
        self._data: Dict[str, bytes] = {}
        self._lock = make_lock("kv.logkv")
        self._fh = None
        self._dirty_bytes = 0

    def open(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        if os.path.exists(self.path):
            self._replay()
        self._fh = open(self.path, "ab")

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def _replay(self) -> None:
        with open(self.path, "rb") as f:
            raw = f.read()
        off = 0
        good_end = 0
        while off + self._HDR.size <= len(raw):
            blen, want_crc = self._HDR.unpack_from(raw, off)
            body = raw[off + self._HDR.size: off + self._HDR.size + blen]
            if len(body) < blen or crc32c(body) != want_crc:
                break  # torn tail
            self._apply_body(body)
            off += self._HDR.size + blen
            good_end = off
        if good_end < len(raw):  # truncate the torn tail
            with open(self.path, "r+b") as f:
                f.truncate(good_end)

    def _apply_body(self, body: bytes) -> None:
        off = 0
        while off < len(body):
            is_set = body[off]
            off += 1
            (klen,) = struct.unpack_from("<I", body, off)
            off += 4
            key = body[off:off + klen].decode("utf-8")
            off += klen
            (vlen,) = struct.unpack_from("<I", body, off)
            off += 4
            val = body[off:off + vlen]
            off += vlen
            if is_set:
                self._data[key] = val
            else:
                self._data.pop(key, None)

    def submit(self, batch: WriteBatch, sync: bool = False) -> None:
        parts = []
        for is_set, key, val in batch.ops:
            kb = key.encode("utf-8")
            parts.append(bytes([1 if is_set else 0]))
            parts.append(struct.pack("<I", len(kb)))
            parts.append(kb)
            parts.append(struct.pack("<I", len(val)))
            parts.append(val)
        body = b"".join(parts)
        rec = self._HDR.pack(len(body), crc32c(body)) + body
        with self._lock:
            assert self._fh is not None, "LogKV not open"
            self._fh.write(rec)
            self._fh.flush()
            if sync:
                os.fsync(self._fh.fileno())
            self._apply_body(body)
            self._dirty_bytes += len(rec)
            if self._dirty_bytes > (64 << 20):
                self._compact_locked()

    def _compact_locked(self) -> None:
        tmp = self.path + ".compact"
        batch = WriteBatch()
        batch.ops = [(True, k, v) for k, v in sorted(self._data.items())]
        parts = []
        for is_set, key, val in batch.ops:
            kb = key.encode("utf-8")
            parts += [bytes([1]), struct.pack("<I", len(kb)), kb,
                      struct.pack("<I", len(val)), val]
        body = b"".join(parts)
        with open(tmp, "wb") as f:
            f.write(self._HDR.pack(len(body), crc32c(body)) + body)
            f.flush()
            os.fsync(f.fileno())
        self._fh.close()
        os.replace(tmp, self.path)
        self._fh = open(self.path, "ab")
        self._dirty_bytes = 0

    def compact(self) -> None:
        with self._lock:
            self._compact_locked()

    def sync(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                os.fsync(self._fh.fileno())

    def get(self, prefix: str, key: str) -> Optional[bytes]:
        with self._lock:
            return self._data.get(prefix + _SEP + key)

    def iterate(self, prefix: str) -> Iterator[Tuple[str, bytes]]:
        pat = prefix + _SEP
        with self._lock:
            items = sorted(
                (k[len(pat):], v)
                for k, v in self._data.items()
                if k.startswith(pat)
            )
        return iter(items)

    def snapshot(self) -> KVSnapshot:
        with self._lock:
            return KVSnapshot(dict(self._data))
