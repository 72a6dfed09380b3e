"""Compressor implementations + registry (reference: src/compressor/).

Each plugin is a tiny stateless codec with ``compress``/``decompress``
over bytes; the registry resolves names exactly like the EC plugin
registry (ceph_tpu_torch.ec.registry) so daemons can preload and operators
can select per-pool/per-store algorithms by name.
"""

from __future__ import annotations

import bz2
import lzma
import threading
import zlib
from typing import Callable, Dict

import numpy as np


class CompressorError(Exception):
    pass


class Compressor:
    """Base codec (reference Compressor.h)."""

    name = "none"

    def compress(self, data: bytes) -> bytes:
        return data

    def decompress(self, data: bytes) -> bytes:
        return data


class ZlibCompressor(Compressor):
    name = "zlib"

    def __init__(self, level: int = 5) -> None:
        self.level = level

    def compress(self, data: bytes) -> bytes:
        return zlib.compress(data, self.level)

    def decompress(self, data: bytes) -> bytes:
        try:
            return zlib.decompress(data)
        except zlib.error as e:
            raise CompressorError(f"zlib: {e}") from e


class Bz2Compressor(Compressor):
    name = "bz2"

    def compress(self, data: bytes) -> bytes:
        return bz2.compress(data)

    def decompress(self, data: bytes) -> bytes:
        try:
            return bz2.decompress(data)
        except OSError as e:
            raise CompressorError(f"bz2: {e}") from e


class LzmaCompressor(Compressor):
    name = "lzma"

    def compress(self, data: bytes) -> bytes:
        return lzma.compress(data, preset=1)

    def decompress(self, data: bytes) -> bytes:
        try:
            return lzma.decompress(data)
        except lzma.LZMAError as e:
            raise CompressorError(f"lzma: {e}") from e


class ZeroRleCompressor(Compressor):
    """Zero-run-length codec: vectorized numpy scan for the zero runs
    that dominate freshly-provisioned storage (sparse chunks, padded
    stripes).  Frame: sequence of [u8 tag][u32 len] where tag 0 = a run
    of zeros (no payload), tag 1 = literal bytes (payload follows)."""

    name = "zero_rle"

    def compress(self, data: bytes) -> bytes:
        arr = np.frombuffer(data, dtype=np.uint8)
        out = bytearray()
        if len(arr) == 0:
            return bytes(out)
        zero = arr == 0
        # run boundaries
        edges = np.nonzero(np.diff(zero))[0] + 1
        starts = np.concatenate([[0], edges])
        ends = np.concatenate([edges, [len(arr)]])
        for s, e in zip(starts, ends):
            if zero[s]:
                out += b"\x00" + int(e - s).to_bytes(4, "little")
            else:
                out += b"\x01" + int(e - s).to_bytes(4, "little")
                out += data[s:e]
        return bytes(out)

    def decompress(self, data: bytes) -> bytes:
        out = bytearray()
        i = 0
        try:
            while i < len(data):
                tag = data[i]
                n = int.from_bytes(data[i + 1: i + 5], "little")
                i += 5
                if tag == 0:
                    out += b"\x00" * n
                elif tag == 1:
                    out += data[i: i + n]
                    if i + n > len(data):
                        raise CompressorError("zero_rle: truncated")
                    i += n
                else:
                    raise CompressorError(f"zero_rle: bad tag {tag}")
        except IndexError as e:
            raise CompressorError("zero_rle: truncated") from e
        return bytes(out)


class CompressorRegistry:
    """Name -> factory, mirroring ErasureCodePluginRegistry."""

    _instance: "CompressorRegistry | None" = None
    _lock = threading.Lock()

    def __init__(self) -> None:
        self._factories: Dict[str, Callable[[], Compressor]] = {
            "none": Compressor,
            "zlib": ZlibCompressor,
            "bz2": Bz2Compressor,
            "lzma": LzmaCompressor,
            "zero_rle": ZeroRleCompressor,
        }

    @classmethod
    def instance(cls) -> "CompressorRegistry":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def add(self, name: str, factory: Callable[[], Compressor]) -> None:
        if name in self._factories:
            raise CompressorError(f"compressor {name!r} already registered")
        self._factories[name] = factory

    def names(self):
        return sorted(self._factories)

    def factory(self, name: str) -> Compressor:
        if name not in self._factories:
            raise CompressorError(f"unknown compressor {name!r}")
        return self._factories[name]()


def instance() -> CompressorRegistry:
    return CompressorRegistry.instance()
