"""Versioned binary encoding — the wire/disk format substrate.

Mirrors the reference's encoding strategy (reference:
src/include/encoding.h — ENCODE_START/ENCODE_FINISH write
`[version u8][compat u8][length u32]` framing so decoders can skip
unknown trailing fields of newer encodings; DECODE_START enforces
compat). Everything that crosses a process or device boundary —
messages, ObjectStore transactions, maps, pg log entries — encodes
through this module, and the dencoder tool (tools/dencoder.py) checks
decode(encode(x)) == x over a pinned corpus the way
src/tools/ceph-dencoder/ does against ceph-object-corpus.

All integers are little-endian fixed-width (the reference's choice for
x86-friendly zero-swap decoding).

Port of ``ceph_tpu/core/encoding.py``, name for name.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple


class DecodeError(Exception):
    pass


class Encoder:
    """Append-only byte sink with ceph-style struct framing."""

    __slots__ = ("buf", "_frames")

    def __init__(self) -> None:
        self.buf = bytearray()
        self._frames: List[int] = []

    # -- primitives -------------------------------------------------------
    def u8(self, v: int) -> "Encoder":
        self.buf.append(v & 0xFF)
        return self

    def u16(self, v: int) -> "Encoder":
        self.buf += struct.pack("<H", v & 0xFFFF)
        return self

    def u32(self, v: int) -> "Encoder":
        self.buf += struct.pack("<I", v & 0xFFFFFFFF)
        return self

    def u64(self, v: int) -> "Encoder":
        self.buf += struct.pack("<Q", v & 0xFFFFFFFFFFFFFFFF)
        return self

    def s32(self, v: int) -> "Encoder":
        self.buf += struct.pack("<i", v)
        return self

    def s64(self, v: int) -> "Encoder":
        self.buf += struct.pack("<q", v)
        return self

    def f64(self, v: float) -> "Encoder":
        self.buf += struct.pack("<d", v)
        return self

    def boolean(self, v: bool) -> "Encoder":
        return self.u8(1 if v else 0)

    def blob(self, v) -> "Encoder":
        """u32-length-prefixed byte string (reference bufferlist
        encode).  Accepts any bytes-like object zero-copy — and a
        DeviceBuf payload handle, materialized through its sanctioned
        (accounted) wire view."""
        if hasattr(v, "wire_view"):  # DeviceBuf duck-type
            v = v.wire_view()
        self.u32(len(v))
        self.buf += v
        return self

    def string(self, v: str) -> "Encoder":
        return self.blob(v.encode("utf-8"))

    def raw(self, v: bytes) -> "Encoder":
        self.buf += v
        return self

    # -- containers -------------------------------------------------------
    def seq(self, items: Iterable[Any], enc_item: Callable[["Encoder", Any], Any]) -> "Encoder":
        items = list(items)
        self.u32(len(items))
        for it in items:
            enc_item(self, it)
        return self

    def mapping(
        self,
        d: Dict[Any, Any],
        enc_k: Callable[["Encoder", Any], Any],
        enc_v: Callable[["Encoder", Any], Any],
    ) -> "Encoder":
        self.u32(len(d))
        for k in sorted(d):
            enc_k(self, k)
            enc_v(self, d[k])
        return self

    def optional(self, v: Any, enc_v: Callable[["Encoder", Any], Any]) -> "Encoder":
        if v is None:
            return self.boolean(False)
        self.boolean(True)
        enc_v(self, v)
        return self

    # -- versioned struct framing -----------------------------------------
    def start(self, version: int, compat: int) -> "Encoder":
        """ENCODE_START: [version][compat][u32 len placeholder]."""
        self.u8(version).u8(compat)
        self._frames.append(len(self.buf))
        self.u32(0)
        return self

    def finish(self) -> "Encoder":
        """ENCODE_FINISH: backpatch the payload length."""
        at = self._frames.pop()
        struct.pack_into("<I", self.buf, at, len(self.buf) - at - 4)
        return self

    def bytes(self) -> bytes:
        assert not self._frames, "unbalanced start/finish"
        return bytes(self.buf)


class Decoder:
    """Cursor over an encoded buffer with framing-aware skip."""

    __slots__ = ("buf", "off", "_ends")

    def __init__(self, buf: bytes, off: int = 0) -> None:
        self.buf = buf
        self.off = off
        self._ends: List[int] = []

    def _need(self, n: int) -> None:
        if self.off + n > len(self.buf):
            raise DecodeError(
                f"buffer underrun: need {n} at {self.off}/{len(self.buf)}"
            )

    # -- primitives -------------------------------------------------------
    def u8(self) -> int:
        self._need(1)
        v = self.buf[self.off]
        self.off += 1
        return v

    def _unpack(self, fmt: str, n: int):
        self._need(n)
        v = struct.unpack_from(fmt, self.buf, self.off)[0]
        self.off += n
        return v

    def u16(self) -> int:
        return self._unpack("<H", 2)

    def u32(self) -> int:
        return self._unpack("<I", 4)

    def u64(self) -> int:
        return self._unpack("<Q", 8)

    def s32(self) -> int:
        return self._unpack("<i", 4)

    def s64(self) -> int:
        return self._unpack("<q", 8)

    def f64(self) -> float:
        return self._unpack("<d", 8)

    def boolean(self) -> bool:
        return self.u8() != 0

    def blob(self) -> bytes:
        n = self.u32()
        self._need(n)
        v = self.buf[self.off : self.off + n]
        self.off += n
        return bytes(v)

    def blob_view(self) -> memoryview:
        """Zero-copy blob: a memoryview into the frame buffer instead
        of a materialized bytes copy — the bufferlist discipline for
        large payload fields (a 64 KiB write body decoded with blob()
        pays a full copy before the op path even sees it).  The view
        pins the whole frame buffer; callers that retain it long-term
        (staging pools) copy out of it exactly once."""
        n = self.u32()
        self._need(n)
        v = memoryview(self.buf)[self.off : self.off + n]
        self.off += n
        return v

    def string(self) -> str:
        return self.blob().decode("utf-8")

    def raw(self, n: int) -> bytes:
        self._need(n)
        v = self.buf[self.off : self.off + n]
        self.off += n
        return bytes(v)

    # -- containers -------------------------------------------------------
    def seq(self, dec_item: Callable[["Decoder"], Any]) -> List[Any]:
        return [dec_item(self) for _ in range(self.u32())]

    def mapping(
        self, dec_k: Callable[["Decoder"], Any], dec_v: Callable[["Decoder"], Any]
    ) -> Dict[Any, Any]:
        n = self.u32()
        out = {}
        for _ in range(n):
            k = dec_k(self)
            out[k] = dec_v(self)
        return out

    def optional(self, dec_v: Callable[["Decoder"], Any]) -> Optional[Any]:
        return dec_v(self) if self.boolean() else None

    # -- versioned struct framing -----------------------------------------
    def start(self, compat_supported: int) -> int:
        """DECODE_START: returns struct version; raises if we're too old."""
        v = self.u8()
        compat = self.u8()
        length = self.u32()
        if compat > compat_supported:
            raise DecodeError(
                f"struct compat {compat} > supported {compat_supported}"
            )
        self._ends.append(self.off + length)
        return v

    def end(self) -> None:
        """DECODE_FINISH: skip unknown trailing fields of newer versions."""
        end = self._ends.pop()
        if self.off > end:
            raise DecodeError("overran struct frame")
        self.off = end

    def remaining_in_frame(self) -> int:
        return self._ends[-1] - self.off if self._ends else len(self.buf) - self.off


# ---------------------------------------------------------------------------
# dencoder registry (reference: src/tools/ceph-dencoder/ strategy)
# ---------------------------------------------------------------------------

DENC_REGISTRY: Dict[str, type] = {}


def denc(cls: type) -> type:
    """Class decorator: register an encodable type for the dencoder tool.

    The class must provide `encode(self, enc)` and classmethod
    `decode(cls, dec)`, plus `example()` producing a representative
    instance for corpus generation.
    """
    DENC_REGISTRY[cls.__name__] = cls
    return cls


def encode_obj(obj: Any) -> bytes:
    e = Encoder()
    obj.encode(e)
    return e.bytes()


def decode_obj(cls: type, data: bytes) -> Any:
    return cls.decode(Decoder(data))
