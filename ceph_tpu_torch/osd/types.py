"""OSD core types: pg ids, versions, object info, log entries, ops.

Port of ``ceph_tpu/osd/types.py``, byte for byte on the port's
``core/encoding.py`` (v1 blobs decode with their tails defaulted).
Reference: src/osd/osd_types.{h,cc} — eversion_t (epoch, version),
pg_info_t, pg_log_entry_t, object_info_t — plus the client op model
(OSDOp / ceph_osd_op in src/include/rados.h; the opcode interpreter is
PrimaryLogPG::do_osd_ops, src/osd/PrimaryLogPG.cc:5651).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from ceph_tpu_torch.core.encoding import Decoder, Encoder

PGId = Tuple[int, int]  # (pool, seed)


def pgid_str(pgid: PGId) -> str:
    return f"{pgid[0]}.{pgid[1]:x}"


@dataclass(frozen=True, order=True)
class EVersion:
    """eversion_t: (map epoch, monotonically increasing version)."""

    epoch: int = 0
    version: int = 0

    def encode(self, e: Encoder) -> None:
        e.u32(self.epoch).u64(self.version)

    @classmethod
    def decode(cls, d: Decoder) -> "EVersion":
        return cls(d.u32(), d.u64())

    def __str__(self) -> str:
        return f"{self.epoch}'{self.version}"


# log entry op kinds (reference pg_log_entry_t::op)
LOG_MODIFY = 1
LOG_DELETE = 3
LOG_ERROR = 6


@dataclass
class LogEntry:
    """pg_log_entry_t: one committed mutation of one object."""

    op: int
    oid: str
    version: EVersion
    prior_version: EVersion
    mtime: float = 0.0
    payload: bytes = b""  # opaque per-backend extra (e.g. EC shard info)
    reqid: str = ""  # client reqid for exactly-once resend replay (v2)

    def encode(self, e: Encoder) -> None:
        e.start(2, 1)
        e.u8(self.op).string(self.oid)
        self.version.encode(e)
        self.prior_version.encode(e)
        e.f64(self.mtime).blob(self.payload)
        e.string(self.reqid)
        e.finish()

    @classmethod
    def decode(cls, d: Decoder) -> "LogEntry":
        v = d.start(2)
        out = cls(
            op=d.u8(),
            oid=d.string(),
            version=EVersion.decode(d),
            prior_version=EVersion.decode(d),
            mtime=d.f64(),
            payload=d.blob(),
            reqid=d.string() if v >= 2 else "",
        )
        d.end()
        return out


@dataclass
class PGInfo:
    """pg_info_t: summary a peer needs to judge log-based recoverability."""

    pgid: PGId = (0, 0)
    last_update: EVersion = field(default_factory=EVersion)
    last_complete: EVersion = field(default_factory=EVersion)
    log_tail: EVersion = field(default_factory=EVersion)
    epoch_created: int = 0
    # roll-forward watermark (the reference's last_update_applied /
    # roll_forward_to role): every acting shard is known to have
    # committed entries <= committed_to, so divergent-entry rollback
    # during peering must never rewind past it — those writes were
    # acked to clients.  Advanced by the primary when an op's last
    # shard ack lands; lazily persisted (a crash regresses it, which
    # only makes rollback MORE reliant on the holder-count rule).
    committed_to: EVersion = field(default_factory=EVersion)

    def encode(self, e: Encoder) -> None:
        e.start(2, 1)
        e.s64(self.pgid[0]).u32(self.pgid[1])
        self.last_update.encode(e)
        self.last_complete.encode(e)
        self.log_tail.encode(e)
        e.u32(self.epoch_created)
        self.committed_to.encode(e)
        e.finish()

    @classmethod
    def decode(cls, d: Decoder) -> "PGInfo":
        v = d.start(2)
        out = cls(
            pgid=(d.s64(), d.u32()),
            last_update=EVersion.decode(d),
            last_complete=EVersion.decode(d),
            log_tail=EVersion.decode(d),
            epoch_created=d.u32(),
        )
        if v >= 2:
            out.committed_to = EVersion.decode(d)
        d.end()
        return out


@dataclass
class PGStat:
    """One PG's stat row in the osd -> mon MPGStats feed (reference
    pg_stat_t, src/osd/osd_types.h): the PGMap digest's unit of
    aggregation.  Versioned codec so later fields ride as gated tails
    the way PGInfo v2 does.

    ``cl_*``/``rec_*`` are WINDOWED deltas since this osd's previous
    report (the reporting daemon differences its cumulative per-PG
    counters), so the mon's snapshot-ring can rate-derive client
    IOPS/BW and recovery objects/s without daemon clock coupling.

    v2 tail (scrub attribution for the PG_DAMAGED /
    PG_NOT_DEEP_SCRUBBED health checks): ``last_scrub`` /
    ``last_deep_scrub`` wall stamps (0.0 = never) + the count of
    inconsistent objects the PG's latest scrub left unrepaired.  v1
    blobs decode with the tail defaulted."""

    pgid: PGId = (0, 0)
    state: str = ""
    primary: bool = False
    num_objects: int = 0
    num_bytes: int = 0        # locally stored bytes (shard bytes for EC)
    log_size: int = 0
    degraded: int = 0         # object copies missing from the acting set
    misplaced: int = 0        # copies on osds the up set doesn't want
    unfound: int = 0          # objects with no live source anywhere
    last_update: EVersion = field(default_factory=EVersion)
    cl_wr_ops: int = 0        # client writes since the last report
    cl_wr_bytes: int = 0
    cl_rd_ops: int = 0
    cl_rd_bytes: int = 0
    rec_ops: int = 0          # objects recovered since the last report
    rec_bytes: int = 0
    last_scrub: float = 0.0       # v2: wall stamp of the last scrub
    last_deep_scrub: float = 0.0  # v2: wall stamp of the last DEEP scrub
    scrub_errors: int = 0         # v2: unrepaired scrub inconsistencies

    def encode(self, e: Encoder) -> None:
        e.start(2, 1)
        e.s64(self.pgid[0]).u32(self.pgid[1])
        e.string(self.state)
        e.u8(1 if self.primary else 0)
        e.u64(self.num_objects).u64(self.num_bytes).u64(self.log_size)
        e.u64(self.degraded).u64(self.misplaced).u64(self.unfound)
        self.last_update.encode(e)
        e.u64(self.cl_wr_ops).u64(self.cl_wr_bytes)
        e.u64(self.cl_rd_ops).u64(self.cl_rd_bytes)
        e.u64(self.rec_ops).u64(self.rec_bytes)
        e.f64(self.last_scrub).f64(self.last_deep_scrub)
        e.u64(self.scrub_errors)
        e.finish()

    @classmethod
    def decode(cls, d: Decoder) -> "PGStat":
        v = d.start(2)
        out = cls(
            pgid=(d.s64(), d.u32()),
            state=d.string(),
            primary=bool(d.u8()),
            num_objects=d.u64(),
            num_bytes=d.u64(),
            log_size=d.u64(),
            degraded=d.u64(),
            misplaced=d.u64(),
            unfound=d.u64(),
            last_update=EVersion.decode(d),
            cl_wr_ops=d.u64(),
            cl_wr_bytes=d.u64(),
            cl_rd_ops=d.u64(),
            cl_rd_bytes=d.u64(),
            rec_ops=d.u64(),
            rec_bytes=d.u64(),
        )
        if v >= 2:
            out.last_scrub = d.f64()
            out.last_deep_scrub = d.f64()
            out.scrub_errors = d.u64()
        d.end()
        return out

    def as_legacy(self) -> tuple:
        """The thin 7-tuple older MPGStats consumers read (pool, ps,
        state, num_objects, lu_epoch, lu_version, primary)."""
        return (self.pgid[0], self.pgid[1], self.state, self.num_objects,
                self.last_update.epoch, self.last_update.version,
                self.primary)


# -- client op model --------------------------------------------------------

OP_READ = 1
OP_STAT = 2
OP_WRITE = 3          # extent write
OP_WRITEFULL = 4      # replace object content
OP_APPEND = 5
OP_DELETE = 6
OP_TRUNCATE = 7
OP_ZERO = 8
OP_GETXATTR = 9
OP_SETXATTR = 10
OP_RMXATTR = 11
OP_GETXATTRS = 12
OP_OMAP_GET = 13
OP_OMAP_SET = 14
OP_OMAP_RM = 15
OP_CREATE = 16
OP_CALL = 17          # object class method (cls plugins)
OP_NOTIFY = 18
OP_WATCH = 19
OP_SNAPTRIM = 20      # drop one clone of one object (snap trimmer role)
OP_PGLS = 21          # list this PG's objects (reference CEPH_OSD_OP_PGLS)
OP_SNAPTRIMPG = 22    # trim EVERY clone of one snap in this PG
                      # (the snap-trimmer work queue role, SnapMapper-fed)

WRITE_OPS = {OP_WRITE, OP_WRITEFULL, OP_APPEND, OP_DELETE, OP_TRUNCATE,
             OP_ZERO, OP_SETXATTR, OP_RMXATTR, OP_OMAP_SET, OP_OMAP_RM,
             OP_CREATE}


@dataclass
class OSDOp:
    """One sub-op of a client request (reference OSDOp)."""

    op: int
    off: int = 0
    length: int = 0
    data: bytes = b""
    name: str = ""               # xattr name / cls "class.method"
    kv: Dict[str, bytes] = field(default_factory=dict)
    keys: List[str] = field(default_factory=list)

    # filled on the reply path:
    out_data: bytes = b""
    out_kv: Dict[str, bytes] = field(default_factory=dict)
    rval: int = 0

    def encode(self, e: Encoder) -> None:
        e.start(1, 1)
        e.u8(self.op).u64(self.off).u64(self.length).blob(self.data)
        e.string(self.name)
        e.mapping(self.kv, lambda enc, k: enc.string(k),
                  lambda enc, v: enc.blob(v))
        e.seq(self.keys, lambda enc, k: enc.string(k))
        e.blob(self.out_data)
        e.mapping(self.out_kv, lambda enc, k: enc.string(k),
                  lambda enc, v: enc.blob(v))
        e.s32(self.rval)
        e.finish()

    @classmethod
    def decode(cls, d: Decoder) -> "OSDOp":
        d.start(1)
        op, off, length = d.u8(), d.u64(), d.u64()
        # WRITEFULL bodies decode as zero-copy views into the frame
        # buffer (the small-object data path's receive side): the op
        # path stages them into the pinned pool — or the store copies
        # once at txn build — without an intermediate bytes dup here
        data = d.blob_view() if op == OP_WRITEFULL else d.blob()
        out = cls(
            op=op, off=off, length=length, data=data,
            name=d.string(),
            kv=d.mapping(lambda dd: dd.string(), lambda dd: dd.blob()),
            keys=d.seq(lambda dd: dd.string()),
        )
        out.out_data = d.blob()
        out.out_kv = d.mapping(lambda dd: dd.string(), lambda dd: dd.blob())
        out.rval = d.s32()
        d.end()
        return out

    def encode_reply(self, e: Encoder) -> None:
        """Reply-path encoding: op identity + OUTPUTS only.  The input
        payload (`data`, `kv`, `keys`) stays out — the client already
        holds its request, and echoing a 64 KiB write body back doubled
        the write path's wire bytes and crc work (the reference's
        MOSDOpReply likewise returns ops without indata)."""
        e.start(1, 1)
        e.u8(self.op).u64(self.off).u64(self.length)
        e.string(self.name)
        e.blob(self.out_data)
        e.mapping(self.out_kv, lambda enc, k: enc.string(k),
                  lambda enc, v: enc.blob(v))
        e.s32(self.rval)
        e.finish()

    @classmethod
    def decode_reply(cls, d: Decoder) -> "OSDOp":
        d.start(1)
        out = cls(op=d.u8(), off=d.u64(), length=d.u64())
        out.name = d.string()
        out.out_data = d.blob()
        out.out_kv = d.mapping(lambda dd: dd.string(), lambda dd: dd.blob())
        out.rval = d.s32()
        d.end()
        return out

    def is_write(self) -> bool:
        return self.op in WRITE_OPS
