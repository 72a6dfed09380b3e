"""rados — object CLI over the client library (reference src/tools/rados).

Port of ``tools/rados.py``: the same subcommands and output, over the
port's ``VStartCluster`` and ``RadosClient``.  Subcommands (reference
flag shapes): mkpool, put, get, ls, rm, stat, setxattr, getxattr, df,
bench, export, import.  `--vstart N_MONSxN_OSDS` spins an ephemeral
in-process cluster (the vstart.sh role) on ``--device`` and runs the
command sequence against it — one invocation IS a whole cluster
session, so `--script` takes multiple semicolon-separated commands:

  python -m ceph_tpu_torch.tools.rados --vstart 1x3 --pool data \\
      --script "mkpool; put obj1 /etc/hostname; stat obj1; ls; bench 2 write"

With no ``--device`` the cluster runs on the card, and the tool raises
when there is none; ``--device cpu`` runs each kernel's plain version.
Against a durable dir (--data-dir), state survives across invocations.
:func:`run_script` runs a command sequence on a cluster the caller
already has.
"""

from __future__ import annotations

import argparse
import shlex
import sys
import time

from ceph_tpu_torch.tools.rados_bench import ObjBencher


def cmd_put(io, args, cluster) -> int:
    oid, path = args[0], args[1]
    data = sys.stdin.buffer.read() if path == "-" else open(path, "rb").read()
    io.write_full(oid, data)
    return 0


def cmd_get(io, args, cluster) -> int:
    oid = args[0]
    data = io.read(oid)
    if len(args) > 1 and args[1] != "-":
        with open(args[1], "wb") as f:
            f.write(data)
    else:
        sys.stdout.buffer.write(data)
    return 0


def cmd_ls(io, args, cluster) -> int:
    for oid in sorted(io.list_objects()):
        print(oid)
    return 0


def cmd_rm(io, args, cluster) -> int:
    io.remove(args[0])
    return 0


def cmd_stat(io, args, cluster) -> int:
    size = io.stat(args[0])
    print(f"{args[0]} size {size}")
    return 0


def cmd_setxattr(io, args, cluster) -> int:
    io.setxattr(args[0], args[1], args[2].encode())
    return 0


def cmd_getxattr(io, args, cluster) -> int:
    print(io.getxattr(args[0], args[1]).decode())
    return 0


def cmd_df(io, args, cluster) -> int:
    code, out = cluster.command({"prefix": "status"})
    print(f"pools: {len(out.get('pools', {}))}  "
          f"osds: {out.get('num_up_osds')}/{out.get('num_osds')} up  "
          f"epoch: {out.get('osdmap_epoch')}")
    return 0


def cmd_bench(io, args, cluster) -> int:
    seconds = float(args[0]) if args else 2.0
    mode = args[1] if len(args) > 1 else "write"
    b = ObjBencher(io)
    if mode == "write":
        r = b.write(seconds=seconds, threads=8, size=65536)
    else:
        b.write(seconds=min(1.0, seconds), threads=8, size=65536)
        r = b.seq(seconds=seconds, threads=8)
    print(f"{mode}: {r['total_ops']} ops, {r['mb_per_sec']:.2f} MB/s, "
          f"avg lat {r['avg_latency_s'] * 1000:.2f} ms, "
          f"errors {r['errors']}")
    b.cleanup()
    return 0


def cmd_export(io, args, cluster) -> int:
    """export <dir> — archive every object (data + xattrs + omap) of
    the pool to a directory (reference `rados export`)."""
    import base64
    import json as _json
    import os as _os

    out_dir = args[0]
    _os.makedirs(out_dir, exist_ok=True)
    names = sorted(io.list_objects())
    index = []
    for i, oid in enumerate(names):
        data = io.read(oid)
        try:
            xattrs = {k: base64.b64encode(v).decode()
                      for k, v in io.getxattrs(oid).items()}
        except Exception:
            xattrs = {}
        try:
            omap = {k: base64.b64encode(v).decode()
                    for k, v in io.omap_get(oid).items()}
        except Exception:
            omap = {}
        with open(_os.path.join(out_dir, f"obj_{i:08d}.bin"), "wb") as f:
            f.write(data)
        index.append({"oid": oid, "file": f"obj_{i:08d}.bin",
                      "xattrs": xattrs, "omap": omap})
    with open(_os.path.join(out_dir, "INDEX.json"), "w") as f:
        _json.dump(index, f)
    print(f"exported {len(names)} objects to {out_dir}")
    return 0


def cmd_import(io, args, cluster) -> int:
    """import <dir> — restore an exported pool archive."""
    import base64
    import json as _json
    import os as _os

    src = args[0]
    with open(_os.path.join(src, "INDEX.json")) as f:
        index = _json.load(f)
    for ent in index:
        with open(_os.path.join(src, ent["file"]), "rb") as f:
            io.write_full(ent["oid"], f.read())
        for k, v in ent.get("xattrs", {}).items():
            io.setxattr(ent["oid"], k, base64.b64decode(v))
        omap = {k: base64.b64decode(v)
                for k, v in ent.get("omap", {}).items()}
        if omap:
            io.omap_set(ent["oid"], omap)
    print(f"imported {len(index)} objects from {src}")
    return 0


COMMANDS = {
    "put": cmd_put, "get": cmd_get, "ls": cmd_ls, "rm": cmd_rm,
    "stat": cmd_stat, "setxattr": cmd_setxattr, "getxattr": cmd_getxattr,
    "df": cmd_df, "bench": cmd_bench, "export": cmd_export,
    "import": cmd_import,
}


def run_script(cluster, scripts, pool: str = "rbd", pool_size: int = 2,
               ec_profile: str = "") -> int:
    """Run the command lines ``scripts`` on ``cluster`` (a
    ``VStartCluster``) through one client of it, as the CLI does; the
    first nonzero return code, else 0."""
    client = cluster.client()

    def _wait_pool(pid):
        # the CLIENT's own subscribed map must carry the pool
        # before ops can target it
        cluster.wait_for(
            lambda: client.objecter.osdmap is not None
            and pid in client.objecter.osdmap.pools,
            what=f"pool {pid} on client")

    pool_type = "erasure" if ec_profile else "replicated"
    io = None
    rc = 0
    for line in scripts:
        parts = shlex.split(line)
        name, rest = parts[0], parts[1:]
        if name == "mkpool":
            pool_id = cluster.create_pool(
                rest[0] if rest else pool, size=pool_size,
                pool_type=pool_type, ec_profile=ec_profile)
            print(f"pool {rest[0] if rest else pool} id {pool_id}")
            _wait_pool(pool_id)
            io = client.ioctx(pool_id)
            continue
        if name not in COMMANDS:
            print(f"unknown command {name!r}", file=sys.stderr)
            return 22
        if io is None:
            # resolve the pool by name from the map, else create it
            m = cluster.leader().osdmap
            by_name = {pl.name: pid for pid, pl in m.pools.items()}
            if pool in by_name:
                pool_id = by_name[pool]
            else:
                pool_id = cluster.create_pool(
                    pool, size=pool_size, pool_type=pool_type,
                    ec_profile=ec_profile)
            _wait_pool(pool_id)
            io = client.ioctx(pool_id)
        t0 = time.time()
        rc = COMMANDS[name](io, rest, cluster)
        if rc != 0:
            print(f"{name}: rc={rc} ({time.time() - t0:.2f}s)",
                  file=sys.stderr)
            return rc
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rados")
    p.add_argument("--vstart", default="1x3",
                   help="ephemeral cluster geometry MONSxOSDS")
    p.add_argument("--data-dir", default=None,
                   help="durable osd stores (state survives invocations)")
    p.add_argument("--pool", "-p", default="rbd")
    p.add_argument("--pool-size", type=int, default=2)
    p.add_argument("--ec-profile", default="",
                   help="make --pool erasure-coded with this profile")
    p.add_argument("--cephx", action="store_true")
    p.add_argument("--script", default="",
                   help="semicolon-separated command sequence")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu (the plain versions)")
    p.add_argument("command", nargs="*", help="single command + args")
    args = p.parse_args(argv)

    from ceph_tpu_torch.vstart import VStartCluster

    n_mons, n_osds = (int(v) for v in args.vstart.split("x"))
    scripts = ([s.strip() for s in args.script.split(";") if s.strip()]
               if args.script else [" ".join(args.command)])
    if not scripts or not scripts[0]:
        p.error("no command given")

    with VStartCluster(n_mons=n_mons, n_osds=n_osds,
                       data_dir=args.data_dir, keyring=args.cephx,
                       device=args.device) as cluster:
        return run_script(cluster, scripts, pool=args.pool,
                          pool_size=args.pool_size,
                          ec_profile=args.ec_profile)


if __name__ == "__main__":
    sys.exit(main())
