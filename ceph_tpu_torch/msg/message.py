"""Typed messages with versioned encode/decode and a type registry.

Reference: src/msg/Message.h (header: type/seq/tid/priority/src;
footer crc; decode_message dispatch by header.type over ~200 types in
src/messages/).  Subclasses register a type code and implement
encode_payload/decode_payload via core.encoding; the messenger
frames them with length + crc32c (the reference footer's data crc,
gated by ms_crc_data).

Port of ``ceph_tpu/msg/message.py``, name for name and byte for byte:
a message of either package decodes in the other, type ids included.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Type

from ceph_tpu_torch.core.encoding import Decoder, Encoder


@dataclass(frozen=True)
class EntityName:
    """osd.3 / mon.0 / client.4123 (reference entity_name_t)."""

    kind: str
    num: int

    def __str__(self) -> str:
        return f"{self.kind}.{self.num}"

    @classmethod
    def parse(cls, s: str) -> "EntityName":
        kind, num = s.rsplit(".", 1)
        return cls(kind, int(num))

    def encode(self, e: Encoder) -> None:
        e.string(self.kind).s64(self.num)

    @classmethod
    def decode(cls, d: Decoder) -> "EntityName":
        return cls(d.string(), d.s64())


MSG_REGISTRY: Dict[int, Type["Message"]] = {}


def register(cls: Type["Message"]) -> Type["Message"]:
    code = cls.TYPE
    assert code not in MSG_REGISTRY, f"duplicate message type {code}"
    MSG_REGISTRY[code] = cls
    return cls


class Message:
    """Base message. Subclasses: TYPE (int), VERSION/COMPAT, payload codec."""

    TYPE = 0
    VERSION = 1
    COMPAT = 1

    def __init__(self) -> None:
        self.seq = 0          # per-session ordering, set by the connection
        self.tid = 0          # transaction id, set by the sender
        self.priority = 63
        self.src: Optional[EntityName] = None
        self.ack_seq = 0      # piggybacked cumulative ack
        self.nonce = 0        # sender incarnation (reference addr nonce)
        self.sid = 0          # sender session (one per Connection object):
                              # seq spaces are per-session, so receivers key
                              # dup-suppression by (src, nonce, sid) — a
                              # restarted peer or a parallel connection gets
                              # a fresh space, while reconnects of the SAME
                              # logical session (same Connection) keep theirs

    @property
    def struct_v(self) -> int:
        """Encoded struct version seen on decode (from_bytes sets it):
        lets a decode_payload key OPTIONAL tails on the SENDER's
        version instead of frame remainder — required once a message
        carries BOTH a versioned tail and the bare trace tail
        (_enc_trace), which are ambiguous under remaining_in_frame
        gating.  Encoder-side instances answer their own VERSION; a
        property (not an __init__ field) so the roundtrip harness's
        mutate-every-scalar sweep doesn't treat decode metadata as a
        wire field."""
        return getattr(self, "_struct_v", self.VERSION)

    @struct_v.setter
    def struct_v(self, v: int) -> None:
        self._struct_v = int(v)

    # -- subclass hooks ---------------------------------------------------
    def encode_payload(self, e: Encoder) -> None:
        pass

    def decode_payload(self, d: Decoder) -> None:
        pass

    # -- framing ----------------------------------------------------------
    def encode_into(self, e: Encoder) -> None:
        """Encode into an existing sink — the messenger appends the
        body straight after its frame header in ONE buffer (no
        body-then-concat copy per send; see Messenger._frame_of)."""
        e.u16(self.TYPE)
        e.start(self.VERSION, self.COMPAT)
        e.u64(self.seq).u64(self.tid).u8(self.priority).u64(self.ack_seq)
        e.u64(self.nonce).u64(self.sid)
        e.optional(self.src, lambda enc, s: s.encode(enc))
        self.encode_payload(e)
        e.finish()

    def to_bytes(self) -> bytes:
        e = Encoder()
        self.encode_into(e)
        return e.bytes()

    @staticmethod
    def from_bytes(data: bytes) -> "Message":
        d = Decoder(data)
        code = d.u16()
        cls = MSG_REGISTRY.get(code)
        if cls is None:
            raise ValueError(f"unknown message type {code}")
        msg = cls.__new__(cls)
        Message.__init__(msg)
        # we understand encodings up to our VERSION; the SENDER's
        # struct version is kept for decode_payload tail gating
        msg.struct_v = d.start(cls.VERSION)
        msg.seq = d.u64()
        msg.tid = d.u64()
        msg.priority = d.u8()
        msg.ack_seq = d.u64()
        msg.nonce = d.u64()
        msg.sid = d.u64()
        msg.src = d.optional(EntityName.decode)
        msg.decode_payload(d)
        d.end()
        return msg

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(seq={self.seq} tid={self.tid} "
                f"src={self.src})")


@register
class MPing(Message):
    """Liveness probe (reference: src/messages/MPing.h)."""

    TYPE = 1


@register
class MAck(Message):
    """Explicit ack carrier when there's no reverse traffic to piggyback
    on (reference: the ack tag in the wire protocol).  Doubles as the
    session announce, optionally carrying a cephx authorizer blob the
    acceptor verifies before attaching the session (reference: the
    connect message's authorizer payload)."""

    TYPE = 2

    def __init__(self) -> None:
        super().__init__()
        self.auth_blob = b""

    def encode_payload(self, e: Encoder) -> None:
        e.blob(self.auth_blob)

    def decode_payload(self, d: Decoder) -> None:
        self.auth_blob = d.blob() if d.remaining_in_frame() else b""
