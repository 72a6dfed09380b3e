"""CRC-32C (Castagnoli) on the host — message footers, store checksums,
scrub digests, trace ids.

Port of ``ceph_tpu/core/crc.py``: ``crc32c(data, crc=0) -> int`` over
any buffer-protocol object, chained by passing the previous value.
Reference role: src/common/crc32c.h (messenger footer crcs, BlueStore
csums, ECUtil HashInfo per-shard running crc at
src/osd/ECUtil.h:101-122).

This is host code on purpose: its callers hash host bytes (a frame, a
store extent, a request id), so shipping them to the card would cost
more than the hash.  The CRCs of device-resident batches are
``ops/crc32c_device.py`` (``crc32c_rows``, ``crc32c_dev``).

The reference calls C through ``ceph_tpu._native``; the port keeps its
own, in numpy.  A buffer of ``n`` bytes (``n >= SMALL``) is cut into
``S = ceil(n / L)`` segments of ``L`` bytes, zero-padded at the FRONT.
From the zero state, leading zero bytes leave the state at zero, so the
padding changes nothing; the running state ``crc ^ ~0`` is folded into
the first four data bytes (the CRC's first step XORs the state into the
first word, so that is the same thing).  All segments then run a
slicing-by-8 table walk side by side, one vectorised step per 8-byte
word (four 16-bit tables, each the XOR of two of slicing-by-8's byte
tables), and the segment states are joined pairwise by the CRC combine
(``ops/crc32c_device.py``'s ``crc32c_zeros``), one level per doubling of
the run length.  Each level shifts every left value by the same power
of ``x``, which is linear over GF(2); so a level is two lookups in a
pair of 16-bit tables per value, built once per run length and kept.

Buffers below ``SMALL`` bytes take the same slicing-by-8 walk one word
at a time in Python: at that size the numpy calls' fixed cost is larger
than the work.  :func:`crc32c_bytewise` is the textbook byte loop; it is
the tests' slow path, never a route of :func:`crc32c`.
"""

from __future__ import annotations

import array
from typing import Dict, Tuple

import numpy as np

_POLY = 0x82F63B78
_MASK = 0xFFFFFFFF
SMALL = 512          # bytes: below this the Python word walk is faster
_SEG_MIN = 8         # segment length bounds (bytes, powers of two)
_SEG_MAX = 64


def _byte_tables() -> np.ndarray:
    """Slicing-by-8 tables: T[0] is the byte table; T[k+1][i] advances
    T[k][i] by one more zero byte."""
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(_POLY), t >> 1)
    out = np.empty((8, 256), dtype=np.uint32)
    out[0] = t
    for k in range(1, 8):
        prev = out[k - 1]
        out[k] = t[prev & 0xFF] ^ (prev >> np.uint32(8))
    return out


_T8 = _byte_tables()
_I16 = np.arange(1 << 16, dtype=np.uint32)
# word tables: byte j of an 8-byte block (after the state is XORed into
# its first four) goes through T[7 - j]; two bytes share a 16-bit table
_W16 = np.stack([_T8[7 - 2 * h][_I16 & 0xFF] ^ _T8[6 - 2 * h][_I16 >> 8]
                 for h in range(4)])
_W16_PY = tuple(array.array("I", w.tobytes()) for w in _W16)
_T0_PY = array.array("I", _T8[0].tobytes())

_shift: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}


def _shift_tables(run: int) -> Tuple[np.ndarray, np.ndarray]:
    """(lo, hi) with Z_run(v) = lo[v & 0xFFFF] ^ hi[v >> 16]: a state
    advanced through ``run`` zero bytes, by halves.  Built on first use
    from the combine algebra and kept (runs are powers of two)."""
    t = _shift.get(run)
    if t is None:
        from ceph_tpu_torch.ops.crc32c_device import crc32c_zeros

        lo = np.asarray(crc32c_zeros(_I16, run), dtype=np.uint32)
        hi = np.asarray(crc32c_zeros(_I16 << np.uint32(16), run),
                        dtype=np.uint32)
        t = _shift.setdefault(run, (lo, hi))  # a racing build is equal
    return t


def _as_bytes(data) -> np.ndarray:
    """A flat uint8 view of any buffer-protocol object, without a copy
    where the buffer is contiguous."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    try:
        return np.frombuffer(data, dtype=np.uint8)
    except (TypeError, ValueError, BufferError):  # non-contiguous
        return np.frombuffer(bytes(data), dtype=np.uint8)


def _segment_length(n: int) -> int:
    """Power of two in [_SEG_MIN, _SEG_MAX], growing with ``n``: short
    segments keep the sequential walk short, long ones keep the count of
    segments (and of combine levels) down."""
    seg = _SEG_MIN
    while seg < _SEG_MAX and seg * seg * 64 < n:
        seg *= 2
    return seg


def _crc_small(buf: np.ndarray, s: int) -> int:
    """The raw state ``s`` advanced through ``buf``, a word at a time."""
    b = buf.tobytes()
    n = len(b)
    w0, w1, w2, w3 = _W16_PY
    for o in range(0, n - 7, 8):
        lo = int.from_bytes(b[o:o + 4], "little") ^ s
        hi = int.from_bytes(b[o + 4:o + 8], "little")
        s = w0[lo & 0xFFFF] ^ w1[lo >> 16] ^ w2[hi & 0xFFFF] ^ w3[hi >> 16]
    for o in range(n & ~7, n):
        s = _T0_PY[(s ^ b[o]) & 0xFF] ^ (s >> 8)
    return s


def _crc_segments(buf: np.ndarray, s: int) -> int:
    """The raw state ``s`` advanced through ``buf`` (>= 4 bytes), every
    segment at once, then joined by the combine."""
    n = int(buf.size)
    seg = _segment_length(n)
    S = -(-n // seg)
    pad = S * seg - n
    padded = np.zeros(S * seg, dtype=np.uint8)
    padded[pad:] = buf
    padded[pad:pad + 4] ^= np.frombuffer(s.to_bytes(4, "little"), np.uint8)
    # word w of every segment on one row: each step reads a row
    words = np.ascontiguousarray(padded.view("<u4").reshape(S, seg // 4).T)
    halves = words.view("<u2").reshape(seg // 4, S, 2)
    w0, w1, w2, w3 = _W16
    take = np.take
    v = np.zeros(S, dtype=np.uint32)
    for w in range(0, seg // 4, 2):
        x = v ^ words[w]
        hi = halves[w + 1]
        v = (take(w0, x & 0xFFFF) ^ take(w1, x >> 16)
             ^ take(w2, hi[:, 0]) ^ take(w3, hi[:, 1]))
    run = seg
    while v.size > 1:
        if v.size & 1:
            # a zero state in front: a zero run, which changes nothing
            v = np.concatenate([np.zeros(1, dtype=np.uint32), v])
        left, right = v[0::2], v[1::2]
        lo, hi = _shift_tables(run)
        v = take(lo, left & 0xFFFF) ^ take(hi, left >> 16) ^ right
        run *= 2
    return int(v[0])


def crc32c(data, crc: int = 0) -> int:
    """Running crc32c; chain by passing the previous value as ``crc``.
    Accepts bytes, bytearray, memoryview, numpy arrays — any
    buffer-protocol object."""
    buf = _as_bytes(data)
    s = (int(crc) & _MASK) ^ _MASK
    if buf.size < SMALL:
        s = _crc_small(buf, s)
    else:
        s = _crc_segments(buf, s)
    return s ^ _MASK


def crc32c_bytewise(data, crc: int = 0) -> int:
    """The byte-at-a-time definition (the tests' slow path)."""
    s = (int(crc) & _MASK) ^ _MASK
    for b in _as_bytes(data).tobytes():
        s = _T0_PY[(s ^ b) & 0xFF] ^ (s >> 8)
    return s ^ _MASK
