"""ECUtil — the logical <-> stripe <-> chunk offset algebra.

Port of ``ceph_tpu/osd/ecutil.py`` (reference: src/osd/ECUtil.h:27-71
``stripe_info_t``).  An object's bytes are cut into stripes of
``stripe_width = k * chunk_size``; stripe s puts its j-th ``chunk_size``
unit on shard j at chunk offset s*chunk_size.  ``interleave`` and
``deinterleave`` move between object bytes and the [k, S*chunk_size]
data planes the codecs and the stripe-batch queue take.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class StripeInfo:
    def __init__(self, k: int, chunk_size: int) -> None:
        if k < 1 or chunk_size < 1:
            raise ValueError("StripeInfo needs k >= 1 and chunk_size >= 1")
        self.k = int(k)
        self.chunk_size = int(chunk_size)
        self.stripe_width = self.k * self.chunk_size

    def logical_to_prev_stripe_offset(self, off: int) -> int:
        return off - off % self.stripe_width

    def logical_to_next_stripe_offset(self, off: int) -> int:
        return -(-off // self.stripe_width) * self.stripe_width

    def logical_to_prev_chunk_offset(self, off: int) -> int:
        return (off // self.stripe_width) * self.chunk_size

    def logical_to_next_chunk_offset(self, off: int) -> int:
        return -(-off // self.stripe_width) * self.chunk_size

    def aligned_logical_offset_to_chunk_offset(self, off: int) -> int:
        if off % self.stripe_width:
            raise ValueError(f"offset {off} is not stripe-aligned "
                             f"({self.stripe_width})")
        return off // self.k

    def aligned_chunk_offset_to_logical_offset(self, off: int) -> int:
        if off % self.chunk_size:
            raise ValueError(f"offset {off} is not chunk-aligned "
                             f"({self.chunk_size})")
        return off * self.k

    def aligned_offset_len_to_chunk(self, off: int,
                                    length: int) -> Tuple[int, int]:
        return (self.aligned_logical_offset_to_chunk_offset(off),
                self.aligned_logical_offset_to_chunk_offset(length))

    def offset_len_to_stripe_bounds(self, off: int,
                                    length: int) -> Tuple[int, int]:
        """Smallest stripe-aligned (offset, length) covering the range."""
        start = self.logical_to_prev_stripe_offset(off)
        end = self.logical_to_next_stripe_offset(off + length)
        return start, end - start

    def stripe_range(self, off: int, length: int) -> Tuple[int, int]:
        """(first stripe, one-past-last stripe) covering the range."""
        s0 = off // self.stripe_width
        if length <= 0:
            return s0, s0
        return s0, -(-(off + length) // self.stripe_width)

    def object_stripes(self, size: int) -> int:
        return max(1, -(-size // self.stripe_width))

    def chunk_extent(self, s0: int, s1: int) -> Tuple[int, int]:
        """Per-shard (offset, length) holding stripes [s0, s1)."""
        return s0 * self.chunk_size, (s1 - s0) * self.chunk_size

    def interleave(self, data: bytes) -> Tuple[np.ndarray, int]:
        """Object bytes -> data planes [k, S*chunk_size] (zero-padded);
        returns (planes, S)."""
        S = self.object_stripes(len(data))
        buf = np.zeros(S * self.stripe_width, dtype=np.uint8)
        raw = np.frombuffer(data, dtype=np.uint8)
        buf[: len(raw)] = raw
        planes = buf.reshape(S, self.k, self.chunk_size).transpose(1, 0, 2)
        return (np.ascontiguousarray(
            planes.reshape(self.k, S * self.chunk_size)), S)

    def deinterleave(self, planes: np.ndarray, size: int) -> bytes:
        """Data planes [k, >=S*chunk_size] -> object bytes[:size]."""
        S = self.object_stripes(size)
        p = np.asarray(planes)[:, : S * self.chunk_size].reshape(
            self.k, S, self.chunk_size)
        return p.transpose(1, 0, 2).tobytes()[:size]
