"""Monitor wire messages (election, paxos, commands, subscriptions, the
OSD's boot, failure and map traffic, cephx, stats and the MDS boot).

Port of ``ceph_tpu/mon/messages.py``, type for type and byte for byte.
Reference: src/messages/MMonElection.h, MMonPaxos.h, MMonCommand.h,
MMonSubscribe.h, MOSDMap.h, MOSDBoot.h, MOSDFailure.h.  MOSDMapMsg
carries ``osd.map_codec`` full maps and ``osd.map_inc`` incrementals.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.core.encoding import Decoder, Encoder
from ceph_tpu_torch.msg.message import Message, register


@register
class MMonElection(Message):
    TYPE = 30
    PROPOSE = 1
    ACK = 2
    VICTORY = 3

    def __init__(self, op: int = 0, epoch: int = 0, rank: int = -1) -> None:
        super().__init__()
        self.op = op
        self.epoch = epoch
        self.rank = rank

    def encode_payload(self, e: Encoder) -> None:
        e.u8(self.op).u32(self.epoch).s32(self.rank)

    def decode_payload(self, d: Decoder) -> None:
        self.op = d.u8()
        self.epoch = d.u32()
        self.rank = d.s32()


@register
class MMonPaxos(Message):
    """Multi-instance Paxos (reference MMonPaxos ops: collect/last/
    begin/accept/commit/lease)."""

    TYPE = 31
    COLLECT = 1   # phase 1a (leader -> peons)
    LAST = 2      # phase 1b (peon -> leader, with last accepted)
    BEGIN = 3     # phase 2a (leader proposes value for version)
    ACCEPT = 4    # phase 2b
    COMMIT = 5    # learn
    LEASE = 6     # leader extends read lease
    CATCHUP_REQ = 7  # peon -> leader: inc had no base, need the full map
    CATCHUP = 8      # leader -> peon: full current map
    SYNC_REQ = 9     # lagging mon: send me your service-state snapshot
    SYNC = 10        # reply: JSON snapshot of every PaxosService state

    def __init__(self, op: int = 0, pn: int = 0, version: int = 0,
                 value: bytes = b"", first_committed: int = 0,
                 last_committed: int = 0,
                 uncommitted_pn: int = 0,
                 uncommitted_v: int = 0,
                 uncommitted_value: bytes = b"") -> None:
        super().__init__()
        self.op = op
        self.pn = pn
        self.version = version
        self.value = value
        self.first_committed = first_committed
        self.last_committed = last_committed
        self.uncommitted_pn = uncommitted_pn
        self.uncommitted_v = uncommitted_v
        self.uncommitted_value = uncommitted_value

    def encode_payload(self, e: Encoder) -> None:
        e.u8(self.op).u64(self.pn).u64(self.version).blob(self.value)
        e.u64(self.first_committed).u64(self.last_committed)
        e.u64(self.uncommitted_pn).u64(self.uncommitted_v)
        e.blob(self.uncommitted_value)

    def decode_payload(self, d: Decoder) -> None:
        self.op = d.u8()
        self.pn = d.u64()
        self.version = d.u64()
        self.value = d.blob()
        self.first_committed = d.u64()
        self.last_committed = d.u64()
        self.uncommitted_pn = d.u64()
        self.uncommitted_v = d.u64()
        self.uncommitted_value = d.blob()


@register
class MMonCommand(Message):
    """JSON command (the `ceph` CLI path, reference MMonCommand)."""

    TYPE = 32

    def __init__(self, cmd: Optional[dict] = None) -> None:
        super().__init__()
        self.cmd = cmd or {}

    def encode_payload(self, e: Encoder) -> None:
        e.string(json.dumps(self.cmd))

    def decode_payload(self, d: Decoder) -> None:
        self.cmd = json.loads(d.string())


@register
class MMonCommandReply(Message):
    TYPE = 33

    def __init__(self, code: int = 0, out: Optional[dict] = None) -> None:
        super().__init__()
        self.code = code
        self.out = out or {}

    def encode_payload(self, e: Encoder) -> None:
        e.s32(self.code).string(json.dumps(self.out))

    def decode_payload(self, d: Decoder) -> None:
        self.code = d.s32()
        self.out = json.loads(d.string())


@register
class MMonSubscribe(Message):
    """Subscribe to map updates (reference MMonSubscribe: what/since)."""

    TYPE = 34

    def __init__(self, what: str = "osdmap", since: int = 0) -> None:
        super().__init__()
        self.what = what
        self.since = since

    def encode_payload(self, e: Encoder) -> None:
        e.string(self.what).u32(self.since)

    def decode_payload(self, d: Decoder) -> None:
        self.what = d.string()
        self.since = d.u32()


@register
class MOSDMapMsg(Message):
    """osdmap push (reference MOSDMap): either the full map (`data`,
    first subscribe / out-of-window) or a chain of incrementals
    (`incs`, applied in order) — O(delta) bytes per map change."""

    TYPE = 35

    def __init__(self, epoch: int = 0, data: bytes = b"") -> None:
        super().__init__()
        self.epoch = epoch
        self.data = data
        self.incs = []  # type: list[bytes]

    def encode_payload(self, e: Encoder) -> None:
        e.u32(self.epoch).blob(self.data)
        e.seq(self.incs, lambda enc, b: enc.blob(b))

    def decode_payload(self, d: Decoder) -> None:
        self.epoch = d.u32()
        self.data = d.blob()
        self.incs = (d.seq(lambda dd: dd.blob())
                     if d.remaining_in_frame() else [])


@register
class MOSDBoot(Message):
    """osd -> mon: I'm up at this address (reference MOSDBoot)."""

    TYPE = 36

    def __init__(self, osd_id: int = -1, ip: str = "", port: int = 0,
                 hb_ip: str = "", hb_port: int = 0) -> None:
        super().__init__()
        self.osd_id = osd_id
        self.ip = ip
        self.port = port
        self.hb_ip = hb_ip
        self.hb_port = hb_port

    def encode_payload(self, e: Encoder) -> None:
        e.s32(self.osd_id).string(self.ip).u32(self.port)
        e.string(self.hb_ip).u32(self.hb_port)

    def decode_payload(self, d: Decoder) -> None:
        self.osd_id = d.s32()
        self.ip = d.string()
        self.port = d.u32()
        self.hb_ip = d.string()
        self.hb_port = d.u32()


@register
class MOSDFailure(Message):
    """osd -> mon: peer missed heartbeats (reference MOSDFailure;
    decided by OSDMonitor::prepare_failure, OSDMonitor.cc:2643)."""

    TYPE = 37

    def __init__(self, target: int = -1, failed_for: float = 0.0) -> None:
        super().__init__()
        self.target = target
        self.failed_for = failed_for

    def encode_payload(self, e: Encoder) -> None:
        e.s32(self.target).f64(self.failed_for)

    def decode_payload(self, d: Decoder) -> None:
        self.target = d.s32()
        self.failed_for = d.f64()


@register
class MAuth(Message):
    """client/daemon -> mon: cephx handshake (reference MAuth over
    src/auth/cephx/CephxProtocol.h ops)."""

    TYPE = 38
    GET_CHALLENGE = 1
    REQUEST = 2

    def __init__(self, op: int = 0, name: str = "",
                 client_challenge: bytes = b"", proof: bytes = b"") -> None:
        super().__init__()
        self.op = op
        self.name = name
        self.client_challenge = client_challenge
        self.proof = proof

    def encode_payload(self, e: Encoder) -> None:
        e.u8(self.op).string(self.name)
        e.blob(self.client_challenge).blob(self.proof)

    def decode_payload(self, d: Decoder) -> None:
        self.op = d.u8()
        self.name = d.string()
        self.client_challenge = d.blob()
        self.proof = d.blob()


@register
class MAuthReply(Message):
    """mon -> client: challenge or (sealed session key + ticket)."""

    TYPE = 39

    def __init__(self, result: int = 0, challenge: bytes = b"",
                 sealed_client: bytes = b"",
                 ticket_blob: bytes = b"") -> None:
        super().__init__()
        self.result = result
        self.challenge = challenge
        self.sealed_client = sealed_client
        self.ticket_blob = ticket_blob

    def encode_payload(self, e: Encoder) -> None:
        e.s32(self.result).blob(self.challenge)
        e.blob(self.sealed_client).blob(self.ticket_blob)

    def decode_payload(self, d: Decoder) -> None:
        self.result = d.s32()
        self.challenge = d.blob()
        self.sealed_client = d.blob()
        self.ticket_blob = d.blob()


@register
class MPGStats(Message):
    """Per-OSD PG stats report (reference MPGStats, the mgr/mon stats
    feed behind `ceph pg dump` and the PG health checks).  Stats are
    TRANSIENT on the mon (mgr-style), never paxos-committed."""

    TYPE = 40

    def __init__(self, osd: int = -1, epoch: int = 0,
                 pgs: Optional[list] = None, used_bytes: int = 0,
                 total_bytes: int = 0, stats: Optional[list] = None,
                 slow_ops: int = 0, heartbeat_misses: int = 0) -> None:
        super().__init__()
        self.osd = osd
        self.epoch = epoch
        # [(pool, ps, state, num_objects, last_update_epoch,
        #   last_update_version, is_primary)] — the legacy thin rows,
        # still carried so pre-PGStat consumers keep working
        self.pgs = pgs or []
        # store fullness (ObjectStore::statfs — the nearfull/full feed)
        self.used_bytes = used_bytes
        self.total_bytes = total_bytes
        # v2 tail: rich PGStat rows (osd/types.py) + daemon health
        # signals — slow-ring depth (SLOW_OPS) and the cumulative
        # heartbeat-miss counter (OSD_SLOW_HEARTBEAT)
        self.stats = stats or []
        self.slow_ops = slow_ops
        self.heartbeat_misses = heartbeat_misses

    def encode_payload(self, e: Encoder) -> None:
        e.s32(self.osd).u32(self.epoch)
        e.seq(self.pgs, lambda en, p: (
            en.s64(p[0]), en.u32(p[1]), en.string(p[2]), en.u64(p[3]),
            en.u32(p[4]), en.u64(p[5]), en.u8(1 if p[6] else 0)))
        e.u64(self.used_bytes).u64(self.total_bytes)
        e.seq(self.stats, lambda en, s: s.encode(en))
        e.u32(self.slow_ops).u64(self.heartbeat_misses)

    def decode_payload(self, d: Decoder) -> None:
        from ceph_tpu_torch.osd.types import PGStat

        self.osd = d.s32()
        self.epoch = d.u32()
        self.pgs = d.seq(lambda dd: (
            dd.s64(), dd.u32(), dd.string(), dd.u64(), dd.u32(),
            dd.u64(), bool(dd.u8())))
        self.used_bytes = d.u64()
        self.total_bytes = d.u64()
        # v2 tail (absent in pre-telemetry blobs)
        if d.remaining_in_frame():
            self.stats = d.seq(lambda dd: PGStat.decode(dd))
            self.slow_ops = d.u32()
            self.heartbeat_misses = d.u64()


@register
class MMDSBoot(Message):
    """mds -> mon: rank R serves at this address (reference MMDSBeacon
    boot, src/messages/MMDSBeacon.h — the FSMap feed).

    `nonce` identifies the boot INCARNATION (the reference beacon's
    gid/seq role): beacons are resent until committed AND ride
    lossless sessions, so a replayed stale beacon can arrive after an
    `mds fail` — the FSMap must not let it resurrect the failed
    incarnation.  Decodes nonce=0 from blobs without the field (corpus
    back-compat)."""

    TYPE = 45

    def __init__(self, rank: int = -1, ip: str = "", port: int = 0,
                 boot_nonce: int = 0) -> None:
        super().__init__()
        self.rank = rank
        self.ip = ip
        self.port = port
        # NOT named `nonce`: the messenger stamps msg.nonce with its
        # own session nonce on every send (messenger.py), which would
        # clobber this field
        self.boot_nonce = boot_nonce

    def encode_payload(self, e: Encoder) -> None:
        e.s32(self.rank).string(self.ip).u32(self.port)
        e.u64(self.boot_nonce)

    def decode_payload(self, d: Decoder) -> None:
        self.rank = d.s32()
        self.ip = d.string()
        self.port = d.u32()
        self.boot_nonce = (d.u64() if d.remaining_in_frame() >= 8
                           else 0)
