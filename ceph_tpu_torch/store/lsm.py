"""LSMStore — spill-to-disk ordered KV behind the KeyValueDB API.

Reference role: src/kv/RocksDBStore.cc (the LSM store under BlueStore
and the mon).  The shape is the classic LSM tree, sized down:

- writes land in a crc-guarded WAL, then a sorted in-RAM memtable;
- when the memtable exceeds `memtable_bytes` it flushes to an
  immutable SSTable (sorted records + sparse index + crc'd footer)
  and the WAL is truncated — RAM holds only the active memtable and
  each table's sparse index, never the dataset;
- point reads check memtable, then tables newest -> oldest, stopping
  at the first hit (tombstones shadow older values);
- ranged reads stream a heap-merge of the memtable and every table's
  file iterator — nothing is materialized;
- when tables pile up past `compact_tables`, a full merge rewrites
  them into one (dropping shadowed values and tombstones).

Restart = replay WAL into a fresh memtable + reopen the table set
listed in MANIFEST (the RocksDB MANIFEST role, rewritten atomically).

Port of ``ceph_tpu/store/lsm.py``: the WAL, the tables (bloom filter
included) and the MANIFEST are the reference's byte for byte.
"""

from __future__ import annotations

import heapq
import os
import struct
import threading
from typing import Dict, Iterator, List, Optional, Tuple

from ceph_tpu_torch.core.crc import crc32c
from ceph_tpu_torch.core.lockdep import make_lock
from ceph_tpu_torch.store.kv import KeyValueDB, KVIterator, WriteBatch

_SEP = "\x00"
_TOMBSTONE = 0xFFFFFFFF
_FOOTER = struct.Struct("<QIIQ")  # index_off, n_index, index_crc, magic
_MAGIC = 0x53535442_4C534D31  # "SSTB"/"LSM1"
# v2 footer adds a per-table bloom filter (the RocksDB
# BloomFilterPolicy role): index_off, n_index, bloom_off, bloom_bits,
# crc(index+bloom), magic2.  v1 tables (no bloom) still load.
_FOOTER2 = struct.Struct("<QIQIIQ")
_MAGIC2 = 0x53535442_4C534D32  # "SSTB"/"LSM2"
_BLOOM_K = 7           # hash probes (~1% FP at 10 bits/key)
_BLOOM_BITS_PER_KEY = 10
_REC = struct.Struct("<II")  # klen, vlen (or _TOMBSTONE)
_WAL_HDR = struct.Struct("<II")  # body_len, crc


def _bloom_probes(key: str, nbits: int) -> Iterator[int]:
    """k deterministic bit positions for `key` (double hashing over a
    blake2b digest — stable across processes/restarts)."""
    import hashlib

    h = hashlib.blake2b(key.encode("utf-8"), digest_size=16).digest()
    a = int.from_bytes(h[:8], "little")
    b = int.from_bytes(h[8:], "little") | 1
    for i in range(_BLOOM_K):
        yield (a + i * b) % nbits


class SSTable:
    """One immutable sorted table.  Only the sparse index (every
    `sparse`-th key + offset) lives in RAM."""

    SPARSE = 64

    def __init__(self, path: str) -> None:
        self.path = path
        self._index: List[Tuple[str, int]] = []
        self._data_end = 0
        self._bloom: Optional[bytes] = None
        self._bloom_bits = 0
        self.data_scans = 0  # observability: file scans get() performed
        self._load_index()

    def _load_index(self) -> None:
        with open(self.path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            if size < _FOOTER.size:
                raise IOError(f"truncated sstable {self.path}")
            f.seek(size - 8)
            (magic,) = struct.unpack("<Q", f.read(8))
            bloom_off = bloom_bits = 0
            if magic == _MAGIC2:
                f.seek(size - _FOOTER2.size)
                (idx_off, n, bloom_off, bloom_bits, want,
                 magic) = _FOOTER2.unpack(f.read(_FOOTER2.size))
                footer_size = _FOOTER2.size
            elif magic == _MAGIC:
                f.seek(size - _FOOTER.size)
                idx_off, n, want, magic = _FOOTER.unpack(
                    f.read(_FOOTER.size))
                footer_size = _FOOTER.size
            else:
                raise IOError(f"bad sstable magic in {self.path}")
            f.seek(idx_off)
            blob = f.read(size - footer_size - idx_off)
            if crc32c(blob) != want:
                raise IOError(f"corrupt sstable index in {self.path}")
            if bloom_bits:
                boff = bloom_off - idx_off
                self._bloom = blob[boff: boff + (bloom_bits + 7) // 8]
                self._bloom_bits = bloom_bits
                blob = blob[:boff]
            off = 0
            for _ in range(n):
                (klen,) = struct.unpack_from("<I", blob, off)
                off += 4
                key = blob[off:off + klen].decode("utf-8")
                off += klen
                (rec_off,) = struct.unpack_from("<Q", blob, off)
                off += 8
                self._index.append((key, rec_off))
            self._data_end = idx_off

    def _maybe_has(self, key: str) -> bool:
        if not self._bloom_bits:
            return True  # v1 table: no filter
        for bit in _bloom_probes(key, self._bloom_bits):
            if not (self._bloom[bit >> 3] >> (bit & 7)) & 1:
                return False
        return True

    @staticmethod
    def write(path: str, items: Iterator[Tuple[str, Optional[bytes]]]
              ) -> "SSTable":
        """Write sorted (key, value|None=tombstone) records + index."""
        tmp = path + ".tmp"
        index: List[Tuple[str, int]] = []
        keys: List[str] = []
        with open(tmp, "wb") as f:
            i = 0
            for key, val in items:
                if i % SSTable.SPARSE == 0:
                    index.append((key, f.tell()))
                keys.append(key)
                kb = key.encode("utf-8")
                if val is None:
                    f.write(_REC.pack(len(kb), _TOMBSTONE) + kb)
                else:
                    f.write(_REC.pack(len(kb), len(val)) + kb + val)
                i += 1
            idx_off = f.tell()
            parts = []
            for key, off in index:
                kb = key.encode("utf-8")
                parts += [struct.pack("<I", len(kb)), kb,
                          struct.pack("<Q", off)]
            iblob = b"".join(parts)
            f.write(iblob)
            # bloom filter over EVERY key (tombstones too: a filter
            # miss must prove "this table says nothing about key")
            nbits = max(1024, len(keys) * _BLOOM_BITS_PER_KEY)
            bloom = bytearray((nbits + 7) // 8)
            for key in keys:
                for bit in _bloom_probes(key, nbits):
                    bloom[bit >> 3] |= 1 << (bit & 7)
            bloom_off = idx_off + len(iblob)
            f.write(bloom)
            f.write(_FOOTER2.pack(idx_off, len(index), bloom_off,
                                  nbits, crc32c(iblob + bytes(bloom)),
                                  _MAGIC2))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return SSTable(path)

    def _scan_from(self, f, off: int, end: int
                   ) -> Iterator[Tuple[str, Optional[bytes]]]:
        f.seek(off)
        pos = off
        while pos < end:
            hdr = f.read(_REC.size)
            if len(hdr) < _REC.size:
                break
            klen, vlen = _REC.unpack(hdr)
            key = f.read(klen).decode("utf-8")
            if vlen == _TOMBSTONE:
                val: Optional[bytes] = None
            else:
                val = f.read(vlen)
            pos = f.tell()
            yield key, val

    def get(self, key: str) -> Tuple[bool, Optional[bytes]]:
        """(found, value|None-for-tombstone): bloom filter first (a
        miss answers without touching the file), then sparse-index
        binary search + a bounded scan of at most SPARSE records."""
        import bisect

        if not self._maybe_has(key):
            return False, None
        if not self._index or key < self._index[0][0]:
            return False, None
        self.data_scans += 1
        i = bisect.bisect_right([k for k, _ in self._index], key) - 1
        start = self._index[i][1]
        end = (self._index[i + 1][1] if i + 1 < len(self._index)
               else self._data_end)
        with open(self.path, "rb") as f:
            for k, v in self._scan_from(f, start, end):
                if k == key:
                    return True, v
                if k > key:
                    break
        return False, None

    def iterate(self, start: str = ""
                ) -> Iterator[Tuple[str, Optional[bytes]]]:
        """Stream records with key >= start, in order."""
        import bisect

        off = 0
        if start and self._index:
            i = bisect.bisect_right([k for k, _ in self._index], start) - 1
            off = self._index[i][1] if i >= 0 else 0
        with open(self.path, "rb") as f:
            for k, v in self._scan_from(f, off, self._data_end):
                if k >= start:
                    yield k, v


class _LSMView:
    """Stable read view over a frozen (memtable copy, table list) pair
    — the snapshot role.  Tables are immutable, so sharing them is
    free; only the memtable is copied."""

    def __init__(self, mem: Dict[str, Optional[bytes]],
                 tables: List[SSTable]) -> None:
        self._mem = mem
        self._tables = tables  # newest first

    def _get_raw(self, full_key: str) -> Tuple[bool, Optional[bytes]]:
        if full_key in self._mem:
            return True, self._mem[full_key]
        for t in self._tables:
            found, val = t.get(full_key)
            if found:
                return True, val
        return False, None

    def get(self, prefix: str, key: str) -> Optional[bytes]:
        found, val = self._get_raw(prefix + _SEP + key)
        return val if found else None

    def _merged(self, start: str) -> Iterator[Tuple[str, Optional[bytes]]]:
        """Heap-merge of memtable + every table, newest source wins per
        key, streaming in key order."""
        sources: List[Iterator] = []
        mem_items = iter(sorted((k, v) for k, v in self._mem.items()
                                if k >= start))
        sources.append(mem_items)
        sources.extend(t.iterate(start) for t in self._tables)
        # decorate with source rank so ties pop newest-first (a real
        # function, not a nested genexp: genexp loop vars late-bind and
        # every source would see the final rank)
        def _decorate(src, rank):
            for k, v in src:
                yield k, rank, v

        decorated = [_decorate(src, rank)
                     for rank, src in enumerate(sources)]
        last = None
        for k, _rank, v in heapq.merge(*decorated):
            if k == last:
                continue  # older shadow of a key we already emitted
            last = k
            yield k, v

    def iterate(self, prefix: str) -> Iterator[Tuple[str, bytes]]:
        pat = prefix + _SEP
        for k, v in self._merged(pat):
            if not k.startswith(pat):
                break
            if v is not None:
                yield k[len(pat):], v

    def get_iterator(self, prefix: str) -> KVIterator:
        return KVIterator(list(self.iterate(prefix)))


class LSMStore(KeyValueDB):
    def __init__(self, path: str, memtable_bytes: int = 4 << 20,
                 compact_tables: int = 6) -> None:
        self.path = path
        self.memtable_bytes = memtable_bytes
        self.compact_tables = compact_tables
        self._mem: Dict[str, Optional[bytes]] = {}
        self._mem_bytes = 0
        self._tables: List[SSTable] = []  # newest first
        self._next_table = 0
        self._wal = None
        self._lock = make_lock("lsm")

    # -- lifecycle ---------------------------------------------------------
    def _wal_path(self) -> str:
        return os.path.join(self.path, "wal.log")

    def _manifest_path(self) -> str:
        return os.path.join(self.path, "MANIFEST")

    def open(self) -> None:
        os.makedirs(self.path, exist_ok=True)
        mf = self._manifest_path()
        names: List[str] = []
        if os.path.exists(mf):
            with open(mf) as f:
                names = [ln.strip() for ln in f if ln.strip()]
        self._tables = []
        for name in names:  # manifest lists newest first
            p = os.path.join(self.path, name)
            if os.path.exists(p):
                self._tables.append(SSTable(p))
                num = int(name.split(".")[0].split("-")[1])
                self._next_table = max(self._next_table, num + 1)
        self._replay_wal()
        self._wal = open(self._wal_path(), "ab")

    def close(self) -> None:
        with self._lock:
            if self._wal:
                self._wal.close()
                self._wal = None

    def _replay_wal(self) -> None:
        p = self._wal_path()
        if not os.path.exists(p):
            return
        with open(p, "rb") as f:
            raw = f.read()
        off = good = 0
        while off + _WAL_HDR.size <= len(raw):
            blen, want = _WAL_HDR.unpack_from(raw, off)
            body = raw[off + _WAL_HDR.size: off + _WAL_HDR.size + blen]
            if len(body) < blen or crc32c(body) != want:
                break  # torn tail
            self._apply_wal_body(body)
            off += _WAL_HDR.size + blen
            good = off
        if good < len(raw):
            with open(p, "r+b") as f:
                f.truncate(good)

    def _apply_wal_body(self, body: bytes) -> None:
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
            self._mem_put(key, bytes(val) if is_set else None)

    def _mem_put(self, key: str, val: Optional[bytes]) -> None:
        old = self._mem.get(key)
        self._mem[key] = val
        self._mem_bytes += len(key) + (len(val) if val else 0)
        if old:
            self._mem_bytes -= len(old)

    # -- writes ------------------------------------------------------------
    def submit(self, batch: WriteBatch, sync: bool = False) -> None:
        parts = []
        for is_set, key, val in batch.ops:
            kb = key.encode("utf-8")
            parts += [bytes([1 if is_set else 0]),
                      struct.pack("<I", len(kb)), kb,
                      struct.pack("<I", len(val)), val]
        body = b"".join(parts)
        with self._lock:
            assert self._wal is not None, "LSMStore not open"
            self._wal.write(_WAL_HDR.pack(len(body), crc32c(body)) + body)
            self._wal.flush()
            if sync:
                os.fsync(self._wal.fileno())
            self._apply_wal_body(body)
            if self._mem_bytes >= self.memtable_bytes:
                self._flush_locked()

    def _write_manifest(self) -> None:
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "w") as f:
            f.write("".join(os.path.basename(t.path) + "\n"
                            for t in self._tables))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path())

    def _flush_locked(self) -> None:
        if not self._mem:
            return
        name = f"sst-{self._next_table:06d}.sst"
        self._next_table += 1
        table = SSTable.write(os.path.join(self.path, name),
                              iter(sorted(self._mem.items())))
        self._tables.insert(0, table)
        self._write_manifest()
        # WAL contents are now durable in the table: truncate it
        self._wal.close()
        self._wal = open(self._wal_path(), "wb")
        self._mem = {}
        self._mem_bytes = 0
        if len(self._tables) > self.compact_tables:
            self._compact_locked()

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def sync(self) -> None:
        with self._lock:
            if self._wal is not None:
                self._wal.flush()
                os.fsync(self._wal.fileno())

    def _compact_locked(self) -> None:
        """Merge every table into one, dropping shadowed values and
        tombstones (nothing older exists to resurrect)."""
        view = _LSMView({}, list(self._tables))
        name = f"sst-{self._next_table:06d}.sst"
        self._next_table += 1
        merged = ((k, v) for k, v in view._merged("") if v is not None)
        table = SSTable.write(os.path.join(self.path, name), merged)
        old = self._tables
        self._tables = [table]
        self._write_manifest()
        for t in old:
            try:
                os.remove(t.path)
            except OSError:
                pass

    def compact(self) -> None:
        with self._lock:
            self._flush_locked()
            if len(self._tables) > 1:
                self._compact_locked()

    # -- reads -------------------------------------------------------------
    def _view(self) -> _LSMView:
        with self._lock:
            return _LSMView(dict(self._mem), list(self._tables))

    def get(self, prefix: str, key: str) -> Optional[bytes]:
        with self._lock:
            full = prefix + _SEP + key
            if full in self._mem:
                return self._mem[full]
            tables = list(self._tables)
        for t in tables:
            found, val = t.get(full)
            if found:
                return val
        return None

    def iterate(self, prefix: str) -> Iterator[Tuple[str, bytes]]:
        return self._view().iterate(prefix)

    def snapshot(self) -> _LSMView:
        return self._view()

    # diagnostics ----------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"memtable_bytes": self._mem_bytes,
                    "memtable_keys": len(self._mem),
                    "tables": len(self._tables),
                    "table_bytes": sum(os.path.getsize(t.path)
                                       for t in self._tables)}
