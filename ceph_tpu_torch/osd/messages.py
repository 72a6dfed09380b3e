"""OSD wire messages (the src/messages/ family the OSD needs).

Port of ``ceph_tpu/osd/messages.py``, type for type and byte for byte:
each message's TYPE, VERSION and COMPAT, its tails (``remaining_in_frame``
for the v2 tail of MECSubWrite, ``struct_v`` for MECSubReadVec and its
reply) and the optional trace tail of ``_PGMessage``.  Reference types:
MOSDOp/MOSDOpReply (client I/O), MOSDRepOp/Reply (replicated fan-out,
src/messages/MOSDRepOp.h), MOSDECSubOpWrite/Read and replies (EC shard
fan-out, src/messages/MOSDECSubOpWrite.h), MOSDPGQuery/Log/Info
(peering), MOSDPGPush/PushReply (recovery), MOSDPing (heartbeats).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.core.encoding import Decoder, Encoder
from ceph_tpu_torch.msg.message import Message, register
from ceph_tpu_torch.osd.types import EVersion, LogEntry, OSDOp, PGId, PGInfo


def _enc_pgid(e: Encoder, pgid: PGId) -> None:
    e.s64(pgid[0]).u32(pgid[1])


def _dec_pgid(d: Decoder) -> PGId:
    return (d.s64(), d.u32())


class _PGMessage(Message):
    """Common pgid + map epoch header.

    Wire-propagated trace context (the blkin trace/span ids): every PG
    message CAN carry ``(trace_id, span_id)`` as an optional payload
    tail — the carriers that actually propagate it (MOSDOp,
    MECSubWriteVec, MECSubReadVec, MECCommitNote/Ack) call
    ``_enc_trace``/``_dec_trace`` around their own tails.  The tail is
    written only when a context is set, so tracing-off encodings (and
    the committed golden corpus) stay byte-for-byte stable, and a v1
    blob decodes with the context defaulted to (0, 0)."""

    def __init__(self, pgid: PGId = (0, 0), epoch: int = 0) -> None:
        super().__init__()
        self.pgid = pgid
        self.epoch = epoch

    # trace helpers are defined here, but ONLY the carrier messages
    # own the attributes (set in their __init__ via _init_trace and in
    # decode via _dec_trace) — a non-carrier must not grow fields its
    # codec drops (the round-trip contract: every field survives)
    def _init_trace(self) -> None:
        self.trace_id = 0
        self.span_id = 0

    def set_trace(self, ctx) -> None:
        """Adopt a (trace_id, span_id) context for the wire (None ok)."""
        if ctx is not None:
            self.trace_id, self.span_id = ctx

    def trace_ctx(self):
        """The carried context, or None when the sender wasn't tracing."""
        return (self.trace_id, self.span_id) if self.trace_id else None

    def _enc_head(self, e: Encoder) -> None:
        _enc_pgid(e, self.pgid)
        e.u32(self.epoch)

    def _dec_head(self, d: Decoder) -> None:
        self.pgid = _dec_pgid(d)
        self.epoch = d.u32()

    def _enc_trace(self, e: Encoder) -> None:
        if self.trace_id:
            e.u64(self.trace_id).u64(self.span_id)

    def _dec_trace(self, d: Decoder) -> None:
        if d.remaining_in_frame():
            self.trace_id = d.u64()
            self.span_id = d.u64()
        else:
            self.trace_id = self.span_id = 0


@register
class MOSDOp(_PGMessage):
    """Client -> primary: ops on one object (src/messages/MOSDOp.h)."""

    TYPE = 10

    def __init__(self, pgid=(0, 0), epoch=0, oid: str = "",
                 ops: Optional[List[OSDOp]] = None) -> None:
        super().__init__(pgid, epoch)
        self.oid = oid
        self.ops: List[OSDOp] = ops or []
        # client-unique request id (osd_reqid_t role): lets the PG make
        # resends exactly-once across primary failover
        self.reqid = ""
        # snapshot context (reference SnapContext): writes carry the
        # latest snap seq + existing snap ids so the PG can
        # clone-on-write; reads may target a snap id (0 = head)
        self.snap_seq = 0
        self.snaps: List[int] = []
        self.snapid = 0
        self._init_trace()

    def encode_payload(self, e: Encoder) -> None:
        self._enc_head(e)
        e.string(self.oid)
        e.seq(self.ops, lambda enc, o: o.encode(enc))
        e.string(self.reqid)
        e.u64(self.snap_seq).u64(self.snapid)
        e.seq(self.snaps, lambda enc, s: enc.u64(s))
        # trace context rides last (written only when tracing set one:
        # untraced encodings stay byte-identical to the prior format)
        self._enc_trace(e)

    def decode_payload(self, d: Decoder) -> None:
        self._dec_head(d)
        self.oid = d.string()
        self.ops = d.seq(OSDOp.decode)
        self.reqid = d.string() if d.remaining_in_frame() else ""
        if d.remaining_in_frame():
            self.snap_seq = d.u64()
            self.snapid = d.u64()
            self.snaps = d.seq(lambda dd: dd.u64())
        else:
            self.snap_seq, self.snapid, self.snaps = 0, 0, []
        self._dec_trace(d)


@register
class MOSDOpReply(_PGMessage):
    TYPE = 11

    def __init__(self, pgid=(0, 0), epoch=0, oid: str = "",
                 ops: Optional[List[OSDOp]] = None, result: int = 0,
                 version: EVersion = EVersion()) -> None:
        super().__init__(pgid, epoch)
        self.oid = oid
        self.ops: List[OSDOp] = ops or []
        self.result = result
        self.version = version

    def encode_payload(self, e: Encoder) -> None:
        self._enc_head(e)
        e.string(self.oid).s32(self.result)
        self.version.encode(e)
        # compact reply form: outputs only, never the request payload
        e.seq(self.ops, lambda enc, o: o.encode_reply(enc))

    def decode_payload(self, d: Decoder) -> None:
        self._dec_head(d)
        self.oid = d.string()
        self.result = d.s32()
        self.version = EVersion.decode(d)
        self.ops = d.seq(OSDOp.decode_reply)


@register
class MOSDRepOp(_PGMessage):
    """Primary -> replica: apply this transaction + log entries
    (src/messages/MOSDRepOp.h)."""

    TYPE = 12

    def __init__(self, pgid=(0, 0), epoch=0, txn: bytes = b"",
                 entries: Optional[List[LogEntry]] = None) -> None:
        super().__init__(pgid, epoch)
        self.txn = txn
        self.entries = entries or []

    def encode_payload(self, e: Encoder) -> None:
        self._enc_head(e)
        e.blob(self.txn)
        e.seq(self.entries, lambda enc, en: en.encode(enc))

    def decode_payload(self, d: Decoder) -> None:
        self._dec_head(d)
        self.txn = d.blob()
        self.entries = d.seq(LogEntry.decode)


@register
class MOSDRepOpReply(_PGMessage):
    TYPE = 13

    def __init__(self, pgid=(0, 0), epoch=0, result: int = 0) -> None:
        super().__init__(pgid, epoch)
        self.result = result

    def encode_payload(self, e: Encoder) -> None:
        self._enc_head(e)
        e.s32(self.result)

    def decode_payload(self, d: Decoder) -> None:
        self._dec_head(d)
        self.result = d.s32()


@register
class MECSubWrite(_PGMessage):
    """Primary -> EC shard: shard-local transaction + log entries
    (src/messages/MOSDECSubOpWrite.h; handled at ECBackend.cc:880).

    `oid` + the rb_* fields describe what the transaction mutates so
    the RECEIVING shard can snapshot the overwritten state into a
    rollback record in the same store transaction (the ECTransaction
    rollback-extents discipline): rb_kind selects full-replace vs
    extent overwrite (RB_* in osd/backend.py), rb_off/rb_len bound the
    extent.  `committed_to` piggybacks the primary's roll-forward
    watermark so shards learn which entries are beyond rollback.

    v2 appended oid/rb_*/committed_to; COMPAT stays 1 — a v1 blob
    (committed golden corpus, a not-yet-upgraded peer) decodes with
    the tail defaulted, costing only this write's rollback record."""

    TYPE = 14
    VERSION = 2

    def __init__(self, pgid=(0, 0), epoch=0, shard: int = -1,
                 txn: bytes = b"",
                 entries: Optional[List[LogEntry]] = None,
                 oid: str = "", rb_kind: int = 0,
                 rb_off: int = 0, rb_len: int = 0,
                 committed_to: Optional[EVersion] = None) -> None:
        super().__init__(pgid, epoch)
        self.shard = shard
        self.txn = txn
        self.entries = entries or []
        self.oid = oid
        self.rb_kind = rb_kind
        self.rb_off = rb_off
        self.rb_len = rb_len
        self.committed_to = committed_to or EVersion()

    def encode_payload(self, e: Encoder) -> None:
        self._enc_head(e)
        e.s32(self.shard).blob(self.txn)
        e.seq(self.entries, lambda enc, en: en.encode(enc))
        e.string(self.oid).u8(self.rb_kind)
        e.u64(self.rb_off).u64(self.rb_len)
        self.committed_to.encode(e)

    def decode_payload(self, d: Decoder) -> None:
        self._dec_head(d)
        self.shard = d.s32()
        self.txn = d.blob()
        self.entries = d.seq(LogEntry.decode)
        if d.remaining_in_frame():  # v2 tail
            self.oid = d.string()
            self.rb_kind = d.u8()
            self.rb_off = d.u64()
            self.rb_len = d.u64()
            self.committed_to = EVersion.decode(d)
        else:
            self.oid, self.rb_kind = "", 0
            self.rb_off = self.rb_len = 0
            self.committed_to = EVersion()


@register
class MECSubWriteVec(_PGMessage):
    """Primary -> EC peer: ALL of the peer's shard transactions for one
    write, merged into a single store transaction (the per-peer
    aggregation of the pipelined write engine).  On a k=8,m=4 pool over
    3 OSDs the per-(shard,peer) MECSubWrite fan-out cost ~11 messages
    and ~11 store transactions per write; this carries one message and
    ONE merged transaction per peer — one rollback-capture pass, one
    WAL append, one commit ack.

    `rb` holds one (shard, rb_kind, rb_off, rb_len) descriptor per
    shard the transaction mutates, so the receiver can snapshot every
    overwritten shard state into the entry's rollback records inside
    the SAME transaction (the MECSubWrite v2 discipline, vectorized).
    `committed_to` piggybacks the primary's roll-forward watermark.

    The scalar MECSubWrite stays registered and applied for
    mixed-version peers: an old primary's per-shard sub-writes must
    keep decoding and applying byte-for-byte."""

    TYPE = 48
    VERSION = 1

    def __init__(self, pgid=(0, 0), epoch=0, oid: str = "",
                 txn: bytes = b"",
                 entries: Optional[List[LogEntry]] = None,
                 rb: Optional[List[Tuple[int, int, int, int]]] = None,
                 committed_to: Optional[EVersion] = None) -> None:
        super().__init__(pgid, epoch)
        self.oid = oid
        self.txn = txn
        self.entries = entries or []
        self.rb = rb or []  # [(shard, rb_kind, rb_off, rb_len), ...]
        self.committed_to = committed_to or EVersion()
        self._init_trace()

    def encode_payload(self, e: Encoder) -> None:
        self._enc_head(e)
        e.string(self.oid).blob(self.txn)
        e.seq(self.entries, lambda enc, en: en.encode(enc))
        e.seq(self.rb, lambda enc, r: enc.s32(r[0]).u8(r[1])
              .u64(r[2]).u64(r[3]))
        self.committed_to.encode(e)
        self._enc_trace(e)  # inherited from the client op when tracing

    def decode_payload(self, d: Decoder) -> None:
        self._dec_head(d)
        self.oid = d.string()
        self.txn = d.blob()
        self.entries = d.seq(LogEntry.decode)
        self.rb = d.seq(lambda dd: (dd.s32(), dd.u8(), dd.u64(),
                                    dd.u64()))
        self.committed_to = EVersion.decode(d)
        self._dec_trace(d)


@register
class MECSubWriteVecReply(_PGMessage):
    """One commit ack per peer per write (the vec twin of
    MECSubWriteReply; no shard field — the whole merged transaction
    committed or nothing did)."""

    TYPE = 49

    def __init__(self, pgid=(0, 0), epoch=0, result: int = 0) -> None:
        super().__init__(pgid, epoch)
        self.result = result

    def encode_payload(self, e: Encoder) -> None:
        self._enc_head(e)
        e.s32(self.result)

    def decode_payload(self, d: Decoder) -> None:
        self._dec_head(d)
        self.result = d.s32()


@register
class MECSubWriteReply(_PGMessage):
    TYPE = 15

    def __init__(self, pgid=(0, 0), epoch=0, shard: int = -1,
                 result: int = 0) -> None:
        super().__init__(pgid, epoch)
        self.shard = shard
        self.result = result

    def encode_payload(self, e: Encoder) -> None:
        self._enc_head(e)
        e.s32(self.shard).s32(self.result)

    def decode_payload(self, d: Decoder) -> None:
        self._dec_head(d)
        self.shard = d.s32()
        self.result = d.s32()


@register
class MECSubRead(_PGMessage):
    """Primary -> EC shard: read shard chunk extents
    (src/messages/MOSDECSubOpRead.h; handled at ECBackend.cc:955)."""

    TYPE = 16

    def __init__(self, pgid=(0, 0), epoch=0, shard: int = -1,
                 oid: str = "", off: int = 0, length: int = 0) -> None:
        super().__init__(pgid, epoch)
        self.shard = shard
        self.oid = oid
        self.off = off
        self.length = length

    def encode_payload(self, e: Encoder) -> None:
        self._enc_head(e)
        e.s32(self.shard).string(self.oid).u64(self.off).u64(self.length)

    def decode_payload(self, d: Decoder) -> None:
        self._dec_head(d)
        self.shard = d.s32()
        self.oid = d.string()
        self.off = d.u64()
        self.length = d.u64()


@register
class MECSubReadVec(_PGMessage):
    """Primary -> EC peer: ALL of this peer's (shard, oid, extent)
    sub-reads for a recovery window or a multi-op read burst, in ONE
    message (the read twin of MECSubWriteVec).  A W-object recovery
    round over a k=4,m=2 pool used to cost one MECSubRead per (shard,
    object) — ~2W messages per peer; this carries one message per peer
    per round, and the receiver answers with one reply (and one store
    pass) covering every row.

    `reads` rows are (shard, oid, off, length); length==0 means the
    whole chunk.  The scalar MECSubRead stays registered and served
    for mixed-version peers: an old primary's per-shard sub-reads must
    keep decoding and answering byte-for-byte.

    v2 appends per-row SUB-CHUNK runs (`runs[i]` = [(sub_off, count)]
    in sub-chunk units — the primary does not know the peer's chunk
    size, so the peer scales by its local hinfo): the clay MSR repair
    plan, where a single-shard rebuild reads only the d/(k*q) repair
    layers of each helper.  An empty run list means the whole chunk
    (every v1 row, and every flat-codec row).  The tail is keyed on
    struct_v, NOT remaining_in_frame: this message also carries the
    bare trace tail, and a frame-remainder gate could not tell a runs
    tail from a trace context.  Rows keep (off=0, len=0), so a legacy
    peer that ignores the tail still serves the whole chunk — its
    reply's served flag (v1 default 0) tells the primary which layout
    came back."""

    TYPE = 50
    VERSION = 2

    def __init__(self, pgid=(0, 0), epoch=0,
                 reads: Optional[List[Tuple[int, str, int, int]]] = None,
                 runs: Optional[List[List[Tuple[int, int]]]] = None
                 ) -> None:
        super().__init__(pgid, epoch)
        self.reads = reads or []  # [(shard, oid, off, length), ...]
        # per-row [(sub_chunk_off, count)] runs; [] = whole chunk
        self.runs = runs if runs is not None else [
            [] for _ in self.reads]
        self._init_trace()

    def encode_payload(self, e: Encoder) -> None:
        self._enc_head(e)
        e.seq(self.reads, lambda enc, r: enc.s32(r[0]).string(r[1])
              .u64(r[2]).u64(r[3]))
        runs = self.runs if len(self.runs) == len(self.reads) else [
            [] for _ in self.reads]
        e.seq(runs, lambda enc, rr: enc.seq(
            rr, lambda ee, p: ee.u32(p[0]).u32(p[1])))
        self._enc_trace(e)  # recovery-round span context when tracing

    def decode_payload(self, d: Decoder) -> None:
        self._dec_head(d)
        self.reads = d.seq(lambda dd: (dd.s32(), dd.string(), dd.u64(),
                                       dd.u64()))
        if self.struct_v >= 2:
            self.runs = d.seq(lambda dd: dd.seq(
                lambda x: (x.u32(), x.u32())))
        else:  # v1 sender: every row is a whole-chunk read
            self.runs = [[] for _ in self.reads]
        self._dec_trace(d)


@register
class MECSubReadVecReply(_PGMessage):
    """One reply per peer per window: every requested chunk/extent with
    its per-shard meta (attrs/omap ride along like MECSubReadReply, so
    the primary can reconstruct without any local shard).  Rows answer
    the request rows in order: (shard, oid, data, result, attrs,
    omap); a shard this peer can't serve answers its row with EIO
    instead of going silent (the sender's gather bookkeeping needs
    every row accounted).

    v2 appends a per-row served flag: 1 = the data blob is exactly the
    REQUESTED sub-chunk runs concatenated in run order, 0 = the whole
    chunk.  A v1 (or run-ignorant) peer's replies default every flag
    to 0, so the primary can always tell which layout it got — the
    explicit disambiguator that makes the legacy whole-chunk fallback
    safe without guessing from blob sizes."""

    TYPE = 51
    VERSION = 2

    def __init__(self, pgid=(0, 0), epoch=0,
                 rows: Optional[List[Tuple]] = None,
                 served: Optional[List[int]] = None) -> None:
        super().__init__(pgid, epoch)
        # [(shard, oid, data, result, attrs, omap), ...]
        self.rows = rows or []
        # per-row flag: 1 = blob holds the requested runs, 0 = whole
        self.served = served if served is not None else [
            0 for _ in self.rows]

    def encode_payload(self, e: Encoder) -> None:
        self._enc_head(e)

        def _row(enc: Encoder, r) -> None:
            enc.s32(r[0]).string(r[1]).blob(r[2]).s32(r[3])
            enc.mapping(r[4], lambda ee, k: ee.string(k),
                        lambda ee, v: ee.blob(v))
            enc.mapping(r[5], lambda ee, k: ee.string(k),
                        lambda ee, v: ee.blob(v))

        e.seq(self.rows, _row)
        served = self.served if len(self.served) == len(self.rows) else [
            0 for _ in self.rows]
        e.seq(served, lambda enc, f: enc.u8(1 if f else 0))

    def decode_payload(self, d: Decoder) -> None:
        self._dec_head(d)

        def _row(dd: Decoder):
            return (dd.s32(), dd.string(), dd.blob(), dd.s32(),
                    dd.mapping(lambda x: x.string(), lambda x: x.blob()),
                    dd.mapping(lambda x: x.string(), lambda x: x.blob()))

        self.rows = d.seq(_row)
        if self.struct_v >= 2:
            self.served = d.seq(lambda dd: dd.u8())
        else:  # v1 sender: whole-chunk rows
            self.served = [0 for _ in self.rows]


@register
class MECSubReadReply(_PGMessage):
    """Chunk payload + the shard's object metadata (attrs/omap ride
    along so the primary can reconstruct without any local shard)."""

    TYPE = 17

    def __init__(self, pgid=(0, 0), epoch=0, shard: int = -1,
                 oid: str = "", data: bytes = b"", result: int = 0,
                 attrs: Optional[Dict[str, bytes]] = None,
                 omap: Optional[Dict[str, bytes]] = None) -> None:
        super().__init__(pgid, epoch)
        self.shard = shard
        self.oid = oid
        self.data = data
        self.result = result
        self.attrs = attrs or {}
        self.omap = omap or {}

    def encode_payload(self, e: Encoder) -> None:
        self._enc_head(e)
        e.s32(self.shard).string(self.oid).blob(self.data).s32(self.result)
        e.mapping(self.attrs, lambda enc, k: enc.string(k),
                  lambda enc, v: enc.blob(v))
        e.mapping(self.omap, lambda enc, k: enc.string(k),
                  lambda enc, v: enc.blob(v))

    def decode_payload(self, d: Decoder) -> None:
        self._dec_head(d)
        self.shard = d.s32()
        self.oid = d.string()
        self.data = d.blob()
        self.result = d.s32()
        self.attrs = d.mapping(lambda dd: dd.string(), lambda dd: dd.blob())
        self.omap = d.mapping(lambda dd: dd.string(), lambda dd: dd.blob())


@register
class MPGQuery(_PGMessage):
    """Primary -> peer: send me your pg_info (+log after `since`)."""

    TYPE = 18

    def __init__(self, pgid=(0, 0), epoch=0,
                 since: EVersion = EVersion()) -> None:
        super().__init__(pgid, epoch)
        self.since = since

    def encode_payload(self, e: Encoder) -> None:
        self._enc_head(e)
        self.since.encode(e)

    def decode_payload(self, d: Decoder) -> None:
        self._dec_head(d)
        self.since = EVersion.decode(d)


@register
class MPGInfo(_PGMessage):
    TYPE = 19

    def __init__(self, pgid=(0, 0), epoch=0,
                 info: Optional[PGInfo] = None,
                 entries: Optional[List[LogEntry]] = None) -> None:
        super().__init__(pgid, epoch)
        self.info = info or PGInfo()
        self.entries = entries or []

    def encode_payload(self, e: Encoder) -> None:
        self._enc_head(e)
        self.info.encode(e)
        e.seq(self.entries, lambda enc, en: en.encode(enc))

    def decode_payload(self, d: Decoder) -> None:
        self._dec_head(d)
        self.info = PGInfo.decode(d)
        self.entries = d.seq(LogEntry.decode)


@register
class MPGPush(_PGMessage):
    """Recovery push: full object (replicated) or one shard chunk (EC)
    with attrs+omap (reference PushOp, src/osd/osd_types.h)."""

    TYPE = 20

    def __init__(self, pgid=(0, 0), epoch=0, oid: str = "",
                 version: EVersion = EVersion(), data: bytes = b"",
                 attrs: Optional[Dict[str, bytes]] = None,
                 omap: Optional[Dict[str, bytes]] = None,
                 shard: int = -1, deleted: bool = False,
                 off: int = 0, total: int = -1,
                 more: bool = False) -> None:
        super().__init__(pgid, epoch)
        self.oid = oid
        self.version = version
        self.data = data
        self.attrs = attrs or {}
        self.omap = omap or {}
        self.shard = shard
        self.deleted = deleted
        # chunked recovery (reference ObjectRecoveryProgress,
        # ECBackend.cc:590-620): byte offset of this chunk, total bytes
        # of the copy, and whether more chunks follow
        self.off = off
        self.total = total if total >= 0 else len(data)
        self.more = more

    def encode_payload(self, e: Encoder) -> None:
        self._enc_head(e)
        e.string(self.oid)
        self.version.encode(e)
        e.blob(self.data).s32(self.shard).boolean(self.deleted)
        e.mapping(self.attrs, lambda enc, k: enc.string(k),
                  lambda enc, v: enc.blob(v))
        e.mapping(self.omap, lambda enc, k: enc.string(k),
                  lambda enc, v: enc.blob(v))
        e.u64(self.off).u64(self.total).boolean(self.more)

    def decode_payload(self, d: Decoder) -> None:
        self._dec_head(d)
        self.oid = d.string()
        self.version = EVersion.decode(d)
        self.data = d.blob()
        self.shard = d.s32()
        self.deleted = d.boolean()
        self.attrs = d.mapping(lambda dd: dd.string(), lambda dd: dd.blob())
        self.omap = d.mapping(lambda dd: dd.string(), lambda dd: dd.blob())
        if d.remaining_in_frame():
            self.off = d.u64()
            self.total = d.u64()
            self.more = d.boolean()
        else:
            self.off, self.total, self.more = 0, len(self.data), False


@register
class MPGRecoveryProbe(_PGMessage):
    """Primary -> peer: how far did a prior (interrupted) push of this
    object get?  Resumable recovery starts from the answer instead of
    byte 0 (reference ObjectRecoveryProgress.data_recovered_to)."""

    TYPE = 26

    def __init__(self, pgid=(0, 0), epoch=0, oid: str = "",
                 version: EVersion = EVersion(), shard: int = -1) -> None:
        super().__init__(pgid, epoch)
        self.oid = oid
        self.version = version
        self.shard = shard

    def encode_payload(self, e: Encoder) -> None:
        self._enc_head(e)
        e.string(self.oid)
        self.version.encode(e)
        e.s32(self.shard)

    def decode_payload(self, d: Decoder) -> None:
        self._dec_head(d)
        self.oid = d.string()
        self.version = EVersion.decode(d)
        self.shard = d.s32()


@register
class MPGRecoveryProbeReply(_PGMessage):
    TYPE = 27

    def __init__(self, pgid=(0, 0), epoch=0, oid: str = "",
                 recovered_to: int = 0) -> None:
        super().__init__(pgid, epoch)
        self.oid = oid
        self.recovered_to = recovered_to

    def encode_payload(self, e: Encoder) -> None:
        self._enc_head(e)
        e.string(self.oid).u64(self.recovered_to)

    def decode_payload(self, d: Decoder) -> None:
        self._dec_head(d)
        self.oid = d.string()
        self.recovered_to = d.u64()


@register
class MPGPushReply(_PGMessage):
    TYPE = 21

    def __init__(self, pgid=(0, 0), epoch=0, oid: str = "",
                 result: int = 0) -> None:
        super().__init__(pgid, epoch)
        self.oid = oid
        self.result = result

    def encode_payload(self, e: Encoder) -> None:
        self._enc_head(e)
        e.string(self.oid).s32(self.result)

    def decode_payload(self, d: Decoder) -> None:
        self._dec_head(d)
        self.oid = d.string()
        self.result = d.s32()


@register
class MOSDPing(Message):
    """OSD<->OSD heartbeat (src/messages/MOSDPing.h)."""

    TYPE = 22
    PING = 0
    PING_REPLY = 1

    def __init__(self, op: int = 0, stamp: float = 0.0,
                 epoch: int = 0) -> None:
        super().__init__()
        self.op = op
        self.stamp = stamp
        self.epoch = epoch

    def encode_payload(self, e: Encoder) -> None:
        e.u8(self.op).f64(self.stamp).u32(self.epoch)

    def decode_payload(self, d: Decoder) -> None:
        self.op = d.u8()
        self.stamp = d.f64()
        self.epoch = d.u32()


@register
class MPGPull(_PGMessage):
    """Recovering peer -> authoritative peer: push me these objects
    (reference PullOp, src/osd/osd_types.h)."""

    TYPE = 23

    def __init__(self, pgid=(0, 0), epoch=0,
                 oids: Optional[List[str]] = None) -> None:
        super().__init__(pgid, epoch)
        self.oids = oids or []

    def encode_payload(self, e: Encoder) -> None:
        self._enc_head(e)
        e.seq(self.oids, lambda enc, s: enc.string(s))

    def decode_payload(self, d: Decoder) -> None:
        self._dec_head(d)
        self.oids = d.seq(lambda dd: dd.string())


@register
class MScrub(_PGMessage):
    """Primary -> replica: send your scrub map (build_scrub_map_chunk
    role, src/osd/PG.cc:4662).

    ``deep`` rides as a remaining_in_frame-gated tail (v1 blobs carry
    no flag and decode deep=True — the only map older primaries ever
    asked for was the byte-reading one): deep maps digest object DATA
    + metadata; shallow maps digest metadata only (size, attr-version,
    user attrs, omap — no data read), so silent data rot passes a
    shallow scrub and is caught by the deep one."""

    TYPE = 24

    def __init__(self, pgid=(0, 0), epoch=0, deep: bool = True) -> None:
        super().__init__(pgid, epoch)
        self.deep = deep

    def encode_payload(self, e: Encoder) -> None:
        self._enc_head(e)
        e.u8(1 if self.deep else 0)

    def decode_payload(self, d: Decoder) -> None:
        self._dec_head(d)
        if d.remaining_in_frame():
            self.deep = bool(d.u8())
        else:
            self.deep = True


@register
class MScrubMap(_PGMessage):
    TYPE = 25

    def __init__(self, pgid=(0, 0), epoch=0,
                 digests: Optional[Dict[str, int]] = None,
                 unreadable: Optional[List[str]] = None) -> None:
        super().__init__(pgid, epoch)
        self.digests = digests or {}
        # objects present but the store refused the read (at-rest csum
        # failure): distinct from absent — they vote "exists" during
        # repair auth selection but can never be authoritative
        self.unreadable = unreadable or []

    def encode_payload(self, e: Encoder) -> None:
        self._enc_head(e)
        e.mapping(self.digests, lambda enc, k: enc.string(k),
                  lambda enc, v: enc.u32(v))
        e.seq(self.unreadable, lambda enc, s: enc.string(s))

    def decode_payload(self, d: Decoder) -> None:
        self._dec_head(d)
        self.digests = d.mapping(lambda dd: dd.string(), lambda dd: dd.u32())
        if d.remaining_in_frame():
            self.unreadable = d.seq(lambda dd: dd.string())
        else:
            self.unreadable = []


@register
class MWatchNotify(_PGMessage):
    """primary -> watcher client: a notify fired on a watched object
    (reference MWatchNotify over the Watch/Notify machinery,
    src/osd/Watch.cc)."""

    TYPE = 28

    def __init__(self, pgid=(0, 0), epoch=0, oid: str = "",
                 notify_id: int = 0, cookie: int = 0,
                 payload: bytes = b"") -> None:
        super().__init__(pgid, epoch)
        self.oid = oid
        self.notify_id = notify_id
        self.cookie = cookie
        self.payload = payload

    def encode_payload(self, e: Encoder) -> None:
        self._enc_head(e)
        e.string(self.oid).u64(self.notify_id).u64(self.cookie)
        e.blob(self.payload)

    def decode_payload(self, d: Decoder) -> None:
        self._dec_head(d)
        self.oid = d.string()
        self.notify_id = d.u64()
        self.cookie = d.u64()
        self.payload = d.blob()


@register
class MWatchNotifyAck(_PGMessage):
    """watcher client -> primary: notify delivered (with reply blob)."""

    TYPE = 29

    def __init__(self, pgid=(0, 0), epoch=0, oid: str = "",
                 notify_id: int = 0, cookie: int = 0,
                 reply: bytes = b"") -> None:
        super().__init__(pgid, epoch)
        self.oid = oid
        self.notify_id = notify_id
        self.cookie = cookie
        self.reply = reply

    def encode_payload(self, e: Encoder) -> None:
        self._enc_head(e)
        e.string(self.oid).u64(self.notify_id).u64(self.cookie)
        e.blob(self.reply)

    def decode_payload(self, d: Decoder) -> None:
        self._dec_head(d)
        self.oid = d.string()
        self.notify_id = d.u64()
        self.cookie = d.u64()
        self.reply = d.blob()


@register
class MPGCommand(_PGMessage):
    """mon/operator -> primary OSD: run a maintenance action on one PG
    ("scrub" | "repair" — the reference's MOSDScrub instructing the
    primary, src/messages/MOSDScrub.h, issued by `ceph pg repair`)."""

    TYPE = 41

    def __init__(self, pgid=(0, 0), epoch=0, action: str = "scrub") -> None:
        super().__init__(pgid, epoch)
        self.action = action

    def encode_payload(self, e: Encoder) -> None:
        self._enc_head(e)
        e.string(self.action)

    def decode_payload(self, d: Decoder) -> None:
        self._dec_head(d)
        self.action = d.string()


@register
class MPGRollback(_PGMessage):
    """Primary -> peer during peering: rewind your log to `to_version`,
    undoing each divergent entry's shard mutation from its persisted
    rollback record (the divergent-entry handling of the reference's
    PGLog merge: entries the authoritative log never saw are rolled
    BACK, not re-replicated).  The peer answers with an MPGInfo
    carrying its post-rollback info so the primary's peer view stays
    current without a second query round."""

    TYPE = 46

    def __init__(self, pgid=(0, 0), epoch=0,
                 to_version: Optional[EVersion] = None) -> None:
        super().__init__(pgid, epoch)
        self.to_version = to_version or EVersion()

    def encode_payload(self, e: Encoder) -> None:
        self._enc_head(e)
        self.to_version.encode(e)

    def decode_payload(self, d: Decoder) -> None:
        self._dec_head(d)
        self.to_version = EVersion.decode(d)


@register
class MECCommitNote(_PGMessage):
    """Primary -> acting EC shards, fired the moment an op gets its
    LAST shard ack (before the client reply): "entries <= committed_to
    are acked — never roll them back".  The piggyback on the next
    sub-write is not enough on its own: an acked write followed by the
    primary's death leaves the watermark ONLY on the dead primary, and
    the next peering round would count < k holders and rewind an
    acknowledged write.  Shards
    persist the watermark so it survives their own restart."""

    TYPE = 47

    def __init__(self, pgid=(0, 0), epoch=0,
                 committed_to: Optional[EVersion] = None) -> None:
        super().__init__(pgid, epoch)
        self.committed_to = committed_to or EVersion()
        self._init_trace()

    def encode_payload(self, e: Encoder) -> None:
        self._enc_head(e)
        self.committed_to.encode(e)
        self._enc_trace(e)  # the gated op's span context when tracing

    def decode_payload(self, d: Decoder) -> None:
        self._dec_head(d)
        self.committed_to = EVersion.decode(d)
        self._dec_trace(d)


@register
class MECCommitNoteAck(_PGMessage):
    """Shard -> primary: the commit-note watermark at `committed_to`
    is PERSISTED here.  Sent only for notes carrying a tid — the
    durable-ack gate of a DEGRADED commit, where the client reply must
    not fire until the watermark can outlive the primary (the
    acked-write-vs-rollback loss class: an acked entry whose watermark
    lived solely in the dead primary's memory counted < k holders at
    the next whole-set arbitration and was rewound).  Advisory
    (tid-less) notes stay fire-and-forget, so mixed-version peers that
    never ack merely keep the old unprotected window."""

    TYPE = 52

    def __init__(self, pgid=(0, 0), epoch=0,
                 committed_to: Optional[EVersion] = None,
                 last_update: Optional[EVersion] = None) -> None:
        super().__init__(pgid, epoch)
        self.committed_to = committed_to or EVersion()
        # the acker's log head: lets a REPLAY gate count how many
        # members actually HOLD the replayed entry (pg logs are
        # contiguous, so last_update >= v implies the v entry) — a
        # resend must never be answered result=0 for a write whose
        # data never reached k shards
        self.last_update = last_update or EVersion()
        self._init_trace()

    def encode_payload(self, e: Encoder) -> None:
        self._enc_head(e)
        self.committed_to.encode(e)
        self.last_update.encode(e)
        self._enc_trace(e)  # echoed from the note: correlates the ack

    def decode_payload(self, d: Decoder) -> None:
        self._dec_head(d)
        self.committed_to = EVersion.decode(d)
        self.last_update = EVersion.decode(d)
        self._dec_trace(d)
