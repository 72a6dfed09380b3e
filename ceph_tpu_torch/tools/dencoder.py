"""ceph-dencoder — encoding inspection and cross-version corpus checks.

Port of ``tools/dencoder.py`` (reference: src/tools/ceph-dencoder/ with
the ceph-object-corpus discipline) over the port's message registry:
the OSD's messages (``osd.messages``), the monitor's (``mon.messages``)
and the messenger's own (MPing, MAck), plus two versioned structs (the
CRUSH map and a pool, ``osd.map_codec``).  Every registered type can be
listed, encoded from a representative example, decoded and round-trip
checked; ``corpus generate`` archives today's encodings and ``corpus
verify`` proves this build still decodes archived ones.  The blobs of
the cephfs messages (MClientCaps, MClientReply, MClientRequest) are
reported as waiting for their slice (ROADMAP queue 1 item 6), not as
passes.  It runs on the host alone.

Example:
  python -m ceph_tpu_torch.tools.dencoder corpus verify tests/corpus
"""

from __future__ import annotations

import argparse
import binascii
import os
import sys

from ceph_tpu_torch.msg.message import MSG_REGISTRY, EntityName, Message
from ceph_tpu_torch.osd import messages as om  # noqa: F401 (registers types)
from ceph_tpu_torch.mon import messages as mm  # noqa: F401 (registers types)
from ceph_tpu_torch.osd.types import EVersion, LogEntry, OSDOp

# archived blobs of types this build does not register yet
WAITING = {name: "waits for ROADMAP queue 1 item 6 (cephfs)"
           for name in ("MClientCaps", "MClientReply", "MClientRequest")}


def _example(cls: type) -> Message:
    """A representative instance: defaults plus generically populated
    common fields, so encodings carry real content."""
    msg = cls()
    msg.tid = 42
    msg.seq = 7
    msg.src = EntityName("client", 4242)
    for name, val in (
        ("oid", "corpus-object"), ("epoch", 33), ("pgid", (2, 5)),
        ("data", b"corpus-payload"), ("txn", b"\x01\x02\x03"),
        ("shard", 1), ("result", 0), ("version", EVersion(3, 9)),
        ("ops", [OSDOp(3, off=8, data=b"x")]),
        ("entries", [LogEntry(op=1, oid="e", version=EVersion(3, 9),
                              prior_version=EVersion(3, 8),
                              reqid="client.1:5")]),
        ("reqid", "client.1:5"), ("name", "osd.0"),
        ("value", b"paxos-value"), ("cmd", {"prefix": "status"}),
        ("what", "osdmap:127.0.0.1:1234"),
    ):
        if hasattr(msg, name):
            cur = getattr(msg, name)
            # only where the example has the field's type (MMonPaxos's
            # version is an int, not an EVersion)
            if cur is None or isinstance(val, type(cur)):
                try:
                    setattr(msg, name, val)
                except Exception:  # noqa: BLE001 — a read-only field
                    pass
    return msg


def type_names():
    return sorted(c.__name__ for c in MSG_REGISTRY.values())


def _cls(name: str) -> type:
    for c in MSG_REGISTRY.values():
        if c.__name__ == name:
            return c
    raise SystemExit(f"unknown type {name!r}; see `list`")


def roundtrip(cls: type) -> bytes:
    blob = _example(cls).to_bytes()
    blob2 = Message.from_bytes(blob).to_bytes()
    if blob != blob2:
        raise SystemExit(
            f"{cls.__name__}: re-encode differs after decode "
            f"({len(blob)}B vs {len(blob2)}B)")
    return blob


# -- struct corpus (versioned non-message encodings) -----------------------


def _sample_crush_bytes() -> bytes:
    from ceph_tpu_torch.core.encoding import Encoder
    from ceph_tpu_torch.crush import map as cmap
    from ceph_tpu_torch.osd.map_codec import encode_crush

    m = cmap.CrushMap()
    m.add_bucket(cmap.ALG_STRAW2, 1, [0, 1], [0x10000, 0x20000], id=-1)
    m.add_bucket(cmap.ALG_LIST, 1, [2, 3], [0x10000, 0x10000], id=-2)
    m.add_bucket(cmap.ALG_STRAW2, 10, [-1, -2], [0x30000, 0x20000],
                 id=-3)
    m.bucket_names = {-1: "host-a", -2: "host-b", -3: "default"}
    m.add_rule(cmap.Rule("corpus", [(cmap.OP_TAKE, -3, 0),
                                    (cmap.OP_CHOOSELEAF_FIRSTN, 0, 1),
                                    (cmap.OP_EMIT, 0, 0)],
                         min_size=1, max_size=10))
    m.choose_args = {"0": {-3: [0x10000, 0x40000]}}
    e = Encoder()
    encode_crush(e, m)
    return e.bytes()


def _decode_crush_bytes(blob: bytes) -> None:
    from ceph_tpu_torch.core.encoding import Decoder
    from ceph_tpu_torch.osd.map_codec import decode_crush

    m = decode_crush(Decoder(blob))
    if (m.bucket_names[-3] != "default"
            or m.choose_args["0"][-3] != [0x10000, 0x40000]
            or m.rules[0].max_size != 10):
        raise ValueError("crush map fields differ from the sample's")


def _sample_pool_bytes() -> bytes:
    from ceph_tpu_torch.core.encoding import Encoder
    from ceph_tpu_torch.osd.map_codec import _enc_pool
    from ceph_tpu_torch.osd.osdmap import PGPool

    e = Encoder()
    _enc_pool(e, PGPool(pool_id=7, pg_num=16, pgp_num=8, name="corpus",
                        hit_set_count=4, hit_set_period=1.5,
                        hit_set_target_size=777, hit_set_fpp=0.02))
    return e.bytes()


def _decode_pool_bytes(blob: bytes) -> None:
    from ceph_tpu_torch.core.encoding import Decoder
    from ceph_tpu_torch.osd.map_codec import _dec_pool

    p = _dec_pool(Decoder(blob))
    if p.name != "corpus" or p.hit_set_count != 4 or p.pgp_num != 8:
        raise ValueError("pool fields differ from the sample's")


STRUCTS = {
    "struct_CrushMap": (_sample_crush_bytes, _decode_crush_bytes),
    "struct_PGPool": (_sample_pool_bytes, _decode_pool_bytes),
}


def corpus(action: str, path: str) -> int:
    """``generate`` writes one blob per registered type and struct into
    ``path``; ``verify`` decodes every archived blob of a type this
    build registers.  Returns the count of failures."""
    os.makedirs(path, exist_ok=True)
    bad = 0
    for cls in sorted(MSG_REGISTRY.values(), key=lambda c: c.__name__):
        blob_path = os.path.join(path, cls.__name__ + ".bin")
        if action == "generate":
            with open(blob_path, "wb") as f:
                f.write(_example(cls).to_bytes())
            print(f"wrote {blob_path}")
            continue
        if not os.path.exists(blob_path):
            print(f"skip {cls.__name__}: no archived encoding")
            continue
        with open(blob_path, "rb") as f:
            blob = f.read()
        try:
            msg = Message.from_bytes(blob)
            if type(msg) is not cls:
                raise ValueError(f"decoded as {type(msg).__name__}")
            print(f"{cls.__name__}: decodes ok")
        except Exception as ex:  # noqa: BLE001 — reported, then counted
            print(f"FAIL {cls.__name__}: {ex!r}")
            bad += 1
    for name, (gen, check) in sorted(STRUCTS.items()):
        blob_path = os.path.join(path, name + ".bin")
        if action == "generate":
            with open(blob_path, "wb") as f:
                f.write(gen())
            print(f"wrote {blob_path}")
        elif os.path.exists(blob_path):
            with open(blob_path, "rb") as f:
                blob = f.read()
            try:
                check(blob)
                print(f"{name}: decodes ok")
            except Exception as ex:  # noqa: BLE001 — reported, counted
                print(f"FAIL {name}: {ex!r}")
                bad += 1
        else:
            print(f"skip {name}: no archived encoding")
    if action == "verify":
        for name, why in sorted(WAITING.items()):
            if os.path.exists(os.path.join(path, name + ".bin")):
                print(f"wait {name}: {why}")
    return bad


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ceph-dencoder")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list")
    e = sub.add_parser("encode")
    e.add_argument("type")
    d = sub.add_parser("decode")
    d.add_argument("hexfile")
    sub.add_parser("roundtrip-all")
    c = sub.add_parser("corpus")
    c.add_argument("action", choices=["generate", "verify"])
    c.add_argument("dir")
    args = p.parse_args(argv)

    if args.cmd == "list":
        for n in type_names():
            print(n)
        return 0
    if args.cmd == "encode":
        print(binascii.hexlify(_example(_cls(args.type)).to_bytes())
              .decode())
        return 0
    if args.cmd == "decode":
        with open(args.hexfile) as f:
            blob = binascii.unhexlify(f.read().strip())
        msg = Message.from_bytes(blob)
        print(type(msg).__name__, vars(msg))
        return 0
    if args.cmd == "roundtrip-all":
        for cls in sorted(MSG_REGISTRY.values(), key=lambda c: c.__name__):
            print(f"{cls.__name__}: ok ({len(roundtrip(cls))}B)")
        return 0
    return 1 if corpus(args.action, args.dir) else 0


if __name__ == "__main__":
    sys.exit(main())
