"""ErasureCodeInterface — the plugin ABI.

Port of ``ceph_tpu/ec/interface.py`` (reference contract:
src/erasure-code/ErasureCodeInterface.h:170-470 and ErasureCode.{h,cc}):

- systematic codes over k data + m coding chunks; an object buffer is
  striped into k chunks padded to an aligned chunk size (encode_prepare,
  reference ErasureCode.cc:138-173);
- ``minimum_to_decode`` and its cost variant;
- the optional D/C ``chunk_mapping`` remap;
- ``decode_concat``.

Chunk payloads at this surface are host numpy uint8 arrays, as in the
reference package.  Each codec holds the torch device its products run
on; ``encode_array``/``decode_array`` move the [k, n] planes there and
back.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

import numpy as np

ErasureCodeProfile = Dict[str, str]

SIMD_ALIGN = 32  # reference: src/erasure-code/ErasureCode.cc:29


class ErasureCodeError(Exception):
    pass


def to_int(profile: ErasureCodeProfile, name: str, default: int) -> int:
    v = profile.get(name, "")
    if v == "":
        profile[name] = str(default)
        return default
    try:
        return int(v)
    except ValueError as e:
        raise ErasureCodeError(f"could not convert {name}={v!r} to int: {e}")


def to_bool(profile: ErasureCodeProfile, name: str, default: bool) -> bool:
    v = profile.get(name, "")
    if v == "":
        profile[name] = "true" if default else "false"
        return default
    return v in ("yes", "true", "1")


class ErasureCode:
    """Base codec: chunk algebra + host byte API over array products."""

    def __init__(self) -> None:
        self.profile: ErasureCodeProfile = {}
        self.chunk_mapping: List[int] = []

    @property
    def k(self) -> int:
        raise NotImplementedError

    @property
    def m(self) -> int:
        raise NotImplementedError

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_coding_chunk_count(self) -> int:
        return self.m

    def get_sub_chunk_count(self) -> int:
        return 1

    @property
    def is_array(self) -> bool:
        """Whether a chunk is an array of sub-chunks (clay): the one test
        the queue, the backend, scrub and the warmup route an array
        codec on (``crep``, ``cdec`` and the sub-chunk byte axis)."""
        return self.get_sub_chunk_count() > 1

    def supports_partial_writes(self) -> bool:
        """Whether a parity byte depends only on the same byte offset of
        each data chunk, so a chunk extent can be re-encoded alone (the
        partial-stripe RMW precondition, interface.py:85)."""
        return not self.is_array

    def get_alignment(self) -> int:
        return SIMD_ALIGN

    def get_chunk_size(self, object_size: int) -> int:
        """Aligned object_size / k (reference: ErasureCodeJerasure.cc:
        73-90)."""
        alignment = self.get_alignment()
        tail = object_size % alignment
        padded = object_size + (alignment - tail if tail else 0)
        if padded % self.k:
            padded += self.k * alignment - (padded % (self.k * alignment))
        return padded // self.k

    # -- profile ----------------------------------------------------------
    def init(self, profile: ErasureCodeProfile) -> None:
        self.profile = profile
        self.parse(profile)
        self.prepare()

    def parse(self, profile: ErasureCodeProfile) -> None:
        """Read the profile (codecs with options of their own, lrc and
        shec, override and call up)."""
        self._parse_mapping(profile)

    def prepare(self) -> None:
        """Build what parse decided (a hook; nothing by default)."""

    def _parse_mapping(self, profile: ErasureCodeProfile) -> None:
        mapping = profile.get("mapping")
        if not mapping:
            return
        data_pos = [i for i, c in enumerate(mapping) if c == "D"]
        coding_pos = [i for i, c in enumerate(mapping) if c != "D"]
        self.chunk_mapping = data_pos + coding_pos

    def chunk_index(self, i: int) -> int:
        return self.chunk_mapping[i] if i < len(self.chunk_mapping) else i

    # -- decode planning --------------------------------------------------
    def _minimum_to_decode(self, want_to_read: Iterable[int],
                           available: Iterable[int]) -> List[int]:
        want = sorted(set(want_to_read))
        avail = sorted(set(available))
        if set(want) <= set(avail):
            return want
        if len(avail) < self.k:
            raise ErasureCodeError("not enough available chunks to decode")
        return avail[: self.k]

    def minimum_to_decode(self, want_to_read: Iterable[int],
                          available: Iterable[int]
                          ) -> Dict[int, List[Tuple[int, int]]]:
        """chunk -> [(sub_chunk_offset, count)]; flat codes read all."""
        ids = self._minimum_to_decode(want_to_read, available)
        return {i: [(0, self.get_sub_chunk_count())] for i in ids}

    def minimum_to_decode_with_cost(self, want_to_read: Iterable[int],
                                    available: Mapping[int, int]
                                    ) -> List[int]:
        return self._minimum_to_decode(want_to_read, available.keys())

    # -- array products (subclass responsibility) -------------------------
    def encode_array(self, data: np.ndarray) -> np.ndarray:
        """uint8 [k, n] data planes -> [m, n] coding planes."""
        raise NotImplementedError

    def decode_array(self, available: Mapping[int, np.ndarray],
                     want: Sequence[int], n: int) -> Dict[int, np.ndarray]:
        """Rebuild the wanted chunk planes from >= k available planes."""
        raise NotImplementedError

    # -- host byte API ----------------------------------------------------
    def encode_prepare(self, data: bytes) -> Tuple[np.ndarray, int]:
        """Split and pad an object buffer into uint8 [k, chunk] planes."""
        blocksize = self.get_chunk_size(len(data))
        out = np.zeros((self.k, blocksize), dtype=np.uint8)
        raw = np.frombuffer(data, dtype=np.uint8)
        out.reshape(-1)[: len(raw)] = raw
        return out, blocksize

    def encode(self, want_to_encode: Iterable[int],
               data: bytes) -> Dict[int, np.ndarray]:
        planes, _ = self.encode_prepare(data)
        coding = self.encode_array(planes)
        return {i: planes[i] if i < self.k else coding[i - self.k]
                for i in want_to_encode}

    def decode(self, want_to_read: Iterable[int],
               chunks: Mapping[int, np.ndarray],
               chunk_size: int | None = None) -> Dict[int, np.ndarray]:
        want = sorted(set(want_to_read))
        if set(want) <= set(chunks.keys()):
            return {i: np.asarray(chunks[i]) for i in want}
        n = len(next(iter(chunks.values())))
        return self.decode_array(chunks, want, n)

    def decode_concat(self, chunks: Mapping[int, np.ndarray]) -> bytes:
        want = [self.chunk_index(i) for i in range(self.k)]
        decoded = self.decode(want, chunks)
        return b"".join(np.asarray(decoded[i]).tobytes() for i in want)
