"""ceph — cluster admin CLI (reference src/ceph.in + mon command table).

Port of ``tools/ceph.py``: the same command table (``_parse``), routing
and output, over the port's ``VStartCluster`` and mgr.  Covers the admin
surface the mon + services expose: status, health (+mute/unmute), osd
dump/tree/out/in/down/reweight, osd pool create, osd
erasure-code-profile set/ls, config set/get/rm/dump, auth
get-or-create/get/ls/rm, log/log last, mon dump/add/rm; the mgr-module
commands (``MGR_PREFIXES``) go to the cluster's mgr, started on demand,
and ``daemon osd.N device warmup [budget=S]`` and ``daemon osd.N device
compile dump`` (its device watch's table; the reference routes only the
warmup) to the daemon itself.

Like the port's ``rados`` tool, `--vstart MxN` runs the command sequence
against an ephemeral in-process cluster (`--script "a; b; c"`), or over
a durable --data-dir, on ``--device``: the card unless ``--device cpu``
asks for the plain versions, and with no ``--device`` and no card the
tool raises before any daemon starts.  Commands are the same JSON-prefix
commands the mon's _do_command consumes — this CLI is the human front
end.  :func:`dispatch` runs one command line on a cluster the caller
already has, and :func:`run_script` a sequence of them as the CLI
prints them.

    python -m ceph_tpu_torch.tools.ceph --vstart 1x3 \
        --script "status; health; osd tree; mgr status"
"""

from __future__ import annotations

import argparse
import json
import shlex
import sys
from typing import Any, List, Tuple

# mgr-module commands (the `ceph progress` / `ceph prometheus`
# surface): routed to an in-process mgr started on demand — the
# reference forwards these mon->mgr; here the CLI owns the hop
MGR_PREFIXES = {"progress", "prometheus export", "mgr status",
                "ops dump_slow", "ops dump_in_flight",
                "ops latency", "crash ls", "crash info",
                "device compile dump", "qos status", "qos set"}


class NoSuchDaemon(Exception):
    """A ``daemon`` command named a daemon the cluster does not have."""


def _parse(tokens):
    """CLI tokens -> mon command dict (the ceph.in argparse role)."""
    t = tokens
    joined = " ".join(t)
    if joined.startswith("osd pool create"):
        cmd = {"prefix": "osd pool create", "pool": t[3]}
        if len(t) > 4:
            cmd["pg_num"] = int(t[4])
        for extra in t[5:]:
            if extra == "erasure":
                cmd["pool_type"] = "erasure"
            elif "=" in extra:
                k, v = extra.split("=", 1)
                cmd[k] = v
        return cmd
    if joined.startswith("osd erasure-code-profile set"):
        return {"prefix": "osd erasure-code-profile set", "name": t[3],
                "profile": " ".join(t[4:])}
    if joined.startswith("osd erasure-code-profile ls"):
        return {"prefix": "osd erasure-code-profile ls"}
    if t[0] == "osd" and t[1] in ("out", "in", "down"):
        return {"prefix": f"osd {t[1]}", "id": int(t[2])}
    if t[0] == "osd" and t[1] == "reweight":
        return {"prefix": "osd reweight", "id": int(t[2]),
                "weight": float(t[3])}
    if t[0] == "osd" and t[1] == "dump":
        return {"prefix": "osd dump"}
    if t[0] == "osd" and t[1] == "df":
        return {"prefix": "osd df"}
    if t[0] == "pg" and t[1] == "dump":
        return {"prefix": "pg dump"}
    if t[0] == "pg" and t[1] in ("scrub", "deep-scrub", "repair"):
        return {"prefix": f"pg {t[1]}", "pgid": t[2]}
    if t[0] == "fs" and t[1] == "status":
        return {"prefix": "fs status"}
    if t[0] == "mds" and t[1] == "fail":
        return {"prefix": "mds fail", "rank": t[2]}
    if t[0] == "osd" and t[1] == "tree":
        return {"prefix": "osd tree"}
    if t[0] == "df":
        return {"prefix": "df"}
    if t[0] in ("status", "-s"):
        return {"prefix": "status"}
    if t[0] == "health":
        if len(t) > 1 and t[1] in ("mute", "unmute"):
            return {"prefix": f"health {t[1]}", "check": t[2]}
        if len(t) > 1 and t[1] == "detail":
            return {"prefix": "health detail"}
        return {"prefix": "health"}
    if t[0] == "progress":
        return {"prefix": "progress"}
    if t[0] == "crash":
        if t[1] == "ls":
            return {"prefix": "crash ls"}
        if t[1] == "info":
            return {"prefix": "crash info", "id": t[2]}
    if t[:3] == ["device", "compile", "dump"]:
        return {"prefix": "device compile dump"}
    if t[:2] == ["prometheus", "export"]:
        return {"prefix": "prometheus export"}
    if t[:2] == ["ops", "dump_slow"]:
        return {"prefix": "ops dump_slow"}
    if t[:2] == ["ops", "dump_in_flight"]:
        return {"prefix": "ops dump_in_flight"}
    if t[:2] == ["ops", "latency"]:
        return {"prefix": "ops latency"}
    if t[:2] == ["qos", "status"]:
        return {"prefix": "qos status"}
    if t[:2] == ["qos", "set"]:
        # qos set <class|tenant:<entity>|pool:<id>> <r> <w> <l>
        return {"prefix": "qos set", "class": t[2],
                "reservation": float(t[3]), "weight": float(t[4]),
                "limit": float(t[5])}
    if t[:2] == ["mgr", "status"]:
        return {"prefix": "mgr status"}
    if t[0] == "config":
        if t[1] == "set":
            return {"prefix": "config set", "who": t[2], "name": t[3],
                    "value": " ".join(t[4:])}
        if t[1] == "rm":
            return {"prefix": "config rm", "who": t[2], "name": t[3]}
        if t[1] == "get":
            return {"prefix": "config get", "who": t[2]}
        if t[1] == "dump":
            return {"prefix": "config dump"}
    if t[0] == "auth":
        if t[1] == "get-or-create":
            return {"prefix": "auth get-or-create", "entity": t[2]}
        if t[1] == "get":
            return {"prefix": "auth get", "entity": t[2]}
        if t[1] == "ls":
            return {"prefix": "auth ls"}
        if t[1] == "rm":
            return {"prefix": "auth rm", "entity": t[2]}
    if t[0] == "log":
        if len(t) > 1 and t[1] == "last":
            return {"prefix": "log last",
                    "num": int(t[2]) if len(t) > 2 else 20}
        return {"prefix": "log", "logtext": " ".join(t[1:])}
    if t[0] == "mon":
        if t[1] == "dump":
            return {"prefix": "mon dump"}
        if t[1] == "add":
            ip, port = t[2].rsplit(":", 1)
            return {"prefix": "mon add", "addr": [ip, int(port)]}
        if t[1] == "rm":
            return {"prefix": "mon rm", "rank": int(t[2])}
    raise ValueError(f"unknown command: {joined!r}")


def _osd_tree(cluster) -> dict:
    """Rendered CRUSH hierarchy (crushtool/osd tree role) straight off
    the leader's map."""
    m = cluster.leader().osdmap
    cm = m.crush
    names = dict(cm.bucket_names)
    out = []

    def walk(item, depth):
        if item >= 0:
            up = bool(m.osd_state_up[item])
            w = int(m.osd_weight[item]) / 0x10000
            out.append({"indent": depth, "name": f"osd.{item}",
                        "up": up, "reweight": w})
            return
        b = cm.buckets[item]
        out.append({"indent": depth,
                    "name": names.get(item, f"bucket{-item}"),
                    "type": cm.type_names.get(b.type, str(b.type)),
                    "weight": b.weight / 0x10000})
        for it in b.items:
            walk(it, depth + 1)

    roots = set(cm.buckets) - {
        it for b in cm.buckets.values() for it in b.items if it < 0}
    for r in sorted(roots, reverse=True):
        walk(r, 0)
    return {"nodes": out}


def dispatch(cluster, tokens: List[str]) -> Tuple[int, Any, str]:
    """One command line's ``tokens`` run on ``cluster`` (a
    ``VStartCluster``): ``(code, out, text)``, ``out`` the command's
    answer (a dict; the exposition body for ``prometheus export``) and
    ``text`` what the CLI prints for it.  Raises ``ValueError`` or
    ``IndexError`` for a line ``_parse`` does not know and
    ``NoSuchDaemon`` for a ``daemon`` command to a daemon the cluster
    does not have."""
    if tokens[:2] == ["osd", "tree"]:
        tree = _osd_tree(cluster)
        return 0, tree, json.dumps(tree, indent=1)
    # `ceph daemon osd.N device warmup [budget=S]` — the per-daemon
    # admin surface (reference `ceph daemon`); the daemons live
    # in-process here, so route directly instead of over an asok
    if (tokens[:1] == ["daemon"] and len(tokens) >= 4
            and tokens[1].startswith("osd.")
            and tokens[2:4] == ["device", "warmup"]):
        osd_id = int(tokens[1][4:])
        budget = None
        for extra in tokens[4:]:
            if extra.startswith("budget="):
                budget = float(extra.split("=", 1)[1])
        svc = cluster.osds.get(osd_id)
        if svc is None:
            raise NoSuchDaemon(f"no such daemon osd.{osd_id}")
        out = svc.device_warmup(budget)
        return 0, out, json.dumps({"rc": 0, **out}, indent=1, default=str)
    # `ceph daemon osd.N device compile dump` — the daemon's admin
    # command of that name: its device watch's table (process-wide)
    if (tokens[:1] == ["daemon"] and tokens[1:2]
            and tokens[1].startswith("osd.")
            and tokens[2:5] == ["device", "compile", "dump"]):
        svc = cluster.osds.get(int(tokens[1][4:]))
        if svc is None:
            raise NoSuchDaemon(f"no such daemon {tokens[1]}")
        out = svc._devwatch.dump()
        return 0, out, json.dumps({"rc": 0, **out}, indent=1, default=str)
    cmd = _parse(tokens)
    if cmd["prefix"] in MGR_PREFIXES:
        mgr = cluster.mgr if cluster.mgr is not None \
            else cluster.start_mgr()
        code, out = mgr.handle_command(cmd)
    else:
        code, out = cluster.command(cmd)
    if cmd["prefix"] == "prometheus export" and code == 0:
        body = out.get("body", "")
        return code, body, body
    return code, out, json.dumps({"rc": code, **out}, indent=1,
                                 default=str)


def run_script(cluster, scripts: List[str]) -> int:
    """Run the command lines ``scripts`` on ``cluster``, printing each
    answer as the CLI does; 22 at a line it does not know, else the
    last failed command's code (0 if none failed)."""
    rc = 0
    for line in scripts:
        try:
            code, _out, text = dispatch(cluster, shlex.split(line))
        except NoSuchDaemon as e:
            print(e, file=sys.stderr)
            rc = 2
            continue
        except (ValueError, IndexError) as e:
            print(str(e), file=sys.stderr)
            return 22
        print(text)
        if code != 0:
            rc = abs(code)
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ceph")
    p.add_argument("--vstart", default="1x3")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--cephx", action="store_true")
    p.add_argument("--script", default="")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu (the plain versions)")
    # the classic `ceph -s` spelling: argparse would otherwise reject
    # it as an unknown flag before the command tokens are seen
    p.add_argument("-s", dest="status_alias", action="store_true",
                   help="alias for the status command")
    p.add_argument("command", nargs="*")
    args = p.parse_args(argv)
    if args.status_alias and not args.command and not args.script:
        args.command = ["status"]

    from ceph_tpu_torch.vstart import VStartCluster

    n_mons, n_osds = (int(v) for v in args.vstart.split("x"))
    scripts = ([s.strip() for s in args.script.split(";") if s.strip()]
               if args.script else [" ".join(args.command)])
    if not scripts or not scripts[0]:
        p.error("no command given")

    with VStartCluster(n_mons=n_mons, n_osds=n_osds,
                       data_dir=args.data_dir, keyring=args.cephx,
                       device=args.device) as cluster:
        return run_script(cluster, scripts)


if __name__ == "__main__":
    sys.exit(main())
