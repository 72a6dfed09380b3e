"""ceph-objectstore-tool — offline PG surgery on a stopped OSD's store.

Port of ``tools/objectstore_tool.py``: the same ops, output and export
file, over the port's ``store.create``.  It touches no device.  An
export of either package's tool imports with the other's.

Reference: src/tools/ceph_objectstore_tool.cc — operate directly on the
ObjectStore directory of a DOWN osd: list pgs, list objects, dump an
object, export a whole PG to a portable file, import it into another
osd's store, remove a PG.  The export format is this framework's own
encoding (versioned frame: pg meta attrs + per-object data/xattrs/omap),
so exports survive store-backend changes (filestore <-> blockstore).

Examples (``python -m ceph_tpu_torch.tools.objectstore_tool`` ...):
  --data-path osd0 --type blockstore --op list-pgs
  --data-path osd0 --op list --pgid 1.0
  --data-path osd0 --op export --pgid 1.0 --file pg.exp
  --data-path osd1 --op import --file pg.exp
  --data-path osd0 --op remove --pgid 1.0
  --data-path osd0 --op info --pgid 1.0
"""

from __future__ import annotations

import argparse
import json
import sys

from ceph_tpu_torch.core.encoding import Decoder, Encoder
from ceph_tpu_torch.store import create
from ceph_tpu_torch.store.objectstore import Collection, GHObject, Transaction

EXPORT_MAGIC = b"CTOSEXP1"


def open_store(path: str, kind: str):
    s = create(kind, path=path)
    s.mount()
    return s


def pg_collections(store):
    return [c for c in store.list_collections()
            if c.name.endswith("_head") and c.name != "meta"]


def op_list_pgs(store, args) -> int:
    for c in pg_collections(store):
        print(c.name[: -len("_head")])
    return 0


def _coll(args) -> Collection:
    if not args.pgid:
        print("--pgid required", file=sys.stderr)
        raise SystemExit(2)
    return Collection(args.pgid + "_head")


def op_list(store, args) -> int:
    coll = _coll(args)
    for o in store.collection_list(coll):
        print(json.dumps({"oid": o.name, "snap": o.snap,
                          "shard": o.shard}))
    return 0


def op_dump(store, args) -> int:
    coll = _coll(args)
    oid = GHObject(args.oid, snap=args.snap, shard=args.shard)
    out = {
        "oid": args.oid,
        "size": store.stat(coll, oid),
        "xattrs": {k: v.hex() for k, v in store.getattrs(coll,
                                                         oid).items()},
        "omap": {k: v.hex() for k, v in store.omap_get(coll, oid).items()},
    }
    print(json.dumps(out, indent=1))
    return 0


def op_export(store, args) -> int:
    coll = _coll(args)
    e = Encoder()
    e.start(1, 1)
    e.string(coll.name)
    objs = store.collection_list(coll)
    e.u32(len(objs))
    for o in objs:
        o.encode(e)
        e.blob(store.read(coll, o))
        e.mapping(store.getattrs(coll, o), lambda en, k: en.string(k),
                  lambda en, v: en.blob(v))
        e.mapping(store.omap_get(coll, o), lambda en, k: en.string(k),
                  lambda en, v: en.blob(v))
    e.finish()
    with open(args.file, "wb") as f:
        f.write(EXPORT_MAGIC + e.bytes())
    print(f"exported {len(objs)} objects from {args.pgid} to {args.file}")
    return 0


def read_export(path: str):
    """An export file's collection name and its objects, each
    ``(GHObject, data, xattrs, omap)``; None if the file is not an
    objectstore export."""
    with open(path, "rb") as f:
        raw = f.read()
    if not raw.startswith(EXPORT_MAGIC):
        return None
    d = Decoder(raw[len(EXPORT_MAGIC):])
    d.start(1)
    cname = d.string()
    objs = []
    for _ in range(d.u32()):
        o = GHObject.decode(d)
        data = d.blob()
        xattrs = d.mapping(lambda dd: dd.string(), lambda dd: dd.blob())
        omap = d.mapping(lambda dd: dd.string(), lambda dd: dd.blob())
        objs.append((o, data, xattrs, omap))
    d.end()
    return cname, objs


def op_import(store, args) -> int:
    got = read_export(args.file)
    if got is None:
        print("not an objectstore export", file=sys.stderr)
        return 1
    cname, objs = got
    coll = Collection(cname)
    if store.collection_exists(coll):
        print(f"collection {cname} already exists; refusing to import "
              "(remove the PG first)", file=sys.stderr)
        return 1
    t = Transaction()
    t.create_collection(coll)
    store.queue_transaction(t)
    for o, data, xattrs, omap in objs:
        t = Transaction()
        t.touch(coll, o)
        if data:
            t.write(coll, o, 0, data)
        if xattrs:
            t.setattrs(coll, o, xattrs)
        if omap:
            t.omap_setkeys(coll, o, omap)
        store.queue_transaction(t)
    print(f"imported {len(objs)} objects into {cname}")
    return 0


def op_remove(store, args) -> int:
    coll = _coll(args)
    objs = store.collection_list(coll)
    for o in objs:
        t = Transaction()
        t.remove(coll, o)
        store.queue_transaction(t)
    t = Transaction()
    t.remove_collection(coll)
    store.queue_transaction(t)
    print(f"removed {args.pgid} ({len(objs)} objects)")
    return 0


def op_info(store, args) -> int:
    coll = _coll(args)
    meta = GHObject("_pgmeta_")
    out = {"pgid": args.pgid,
           "objects": len(store.collection_list(coll))}
    if store.exists(coll, meta):
        try:
            from ceph_tpu_torch.osd.types import PGInfo

            info = PGInfo.decode(
                Decoder(store.getattr(coll, meta, "info")))
            out["last_update"] = list(info.last_update)
            out["epoch_created"] = info.epoch_created
        except Exception:
            pass
        out["log_entries"] = len(store.omap_get(coll, meta))
    print(json.dumps(out, indent=1))
    return 0


OPS = {
    "list-pgs": op_list_pgs,
    "list": op_list,
    "dump": op_dump,
    "export": op_export,
    "import": op_import,
    "remove": op_remove,
    "info": op_info,
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="objectstore-tool")
    p.add_argument("--data-path", required=True)
    p.add_argument("--type", default="filestore",
                   choices=["filestore", "blockstore", "memstore"])
    p.add_argument("--op", required=True, choices=sorted(OPS))
    p.add_argument("--pgid", default="")
    p.add_argument("--oid", default="")
    p.add_argument("--snap", type=int, default=-2)
    p.add_argument("--shard", type=int, default=-1)
    p.add_argument("--file", default="")
    args = p.parse_args(argv)
    store = open_store(args.data_path, args.type)
    try:
        return OPS[args.op](store, args)
    finally:
        store.umount()


if __name__ == "__main__":
    sys.exit(main())
