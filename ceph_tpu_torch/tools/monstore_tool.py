"""ceph-monstore-tool — offline mon store inspection/surgery.

Port of ``tools/monstore_tool.py``: the same ops and output, over the
port's ``store.lsm.LSMStore`` and map codec.  It touches no device: the
map ``show-osdmap`` prints is decoded on the CPU and walks no rule.

Reference: src/tools/ceph_monstore_tool.cc — operate on a monitor's
KV store while the mon is DOWN: list keys, fetch values, show the
paxos range and the stored osdmap, and rewrite single keys (the
disaster-recovery escape hatch).

Works on the LSM mon stores vstart writes under --data-dir
(<data-dir>/mon<rank>).

    python -m ceph_tpu_torch.tools.monstore_tool <store-path> dump-keys
    ... <store-path> get <prefix> <key> [--out FILE]
    ... <store-path> show-paxos
    ... <store-path> show-osdmap
    ... <store-path> set <prefix> <key> <hex>
    ... <store-path> rm <prefix> <key>
"""

from __future__ import annotations

import argparse
import binascii
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="monstore-tool")
    p.add_argument("store", help="mon store dir (e.g. data/mon0)")
    p.add_argument("op", choices=["dump-keys", "get", "show-paxos",
                                  "show-osdmap", "set", "rm"])
    p.add_argument("args", nargs="*")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)

    from ceph_tpu_torch.store.kv import WriteBatch
    from ceph_tpu_torch.store.lsm import LSMStore

    db = LSMStore(a.store)
    db.open()
    try:
        if a.op == "dump-keys":
            # prefixes are discovered by scanning known spaces the mon
            # writes (kv keys are namespaced "<prefix>\\0<key>")
            for prefix in ("paxos", "paxos_values", "mon", "monmap",
                           "svc_config", "svc_logm", "svc_health",
                           "svc_auth", "svc_monmap", "svc_mdsmap"):
                for k, v in db.iterate(prefix):
                    print(f"{prefix}/{k} ({len(v)} bytes)")
            return 0
        if a.op == "get":
            prefix, key = a.args[0], a.args[1]
            v = db.get(prefix, key)
            if v is None:
                print("no such key", file=sys.stderr)
                return 2
            if a.out:
                with open(a.out, "wb") as f:
                    f.write(v)
                print(f"wrote {len(v)} bytes to {a.out}")
            else:
                print(binascii.hexlify(v).decode())
            return 0
        if a.op == "show-paxos":
            for key in ("last_pn", "accepted_pn", "last_committed"):
                v = db.get("paxos", key)
                print(f"{key}: {int(v) if v else 0}")
            lc = int(db.get("paxos", "last_committed") or 0)
            have = sum(1 for v in range(1, lc + 1)
                       if db.get("paxos_values", str(v)) is not None)
            print(f"stored values: {have}/{lc}")
            fv = db.get("mon", "latest_full_v")
            print(f"full-map anchor at version: {int(fv) if fv else 0}")
            return 0
        if a.op == "show-osdmap":
            from ceph_tpu_torch.osd import map_codec, map_inc

            raw = db.get("mon", "latest_full")
            if raw is None:
                print("no full-map anchor in this store",
                      file=sys.stderr)
                return 2
            m = map_codec.decode_osdmap(raw, device="cpu")
            # replay committed values on top of the anchor (the same
            # discipline as the mon's boot) to show the CURRENT map
            fv = int(db.get("mon", "latest_full_v") or 0)
            lc = int(db.get("paxos", "last_committed") or 0)
            for v in range(fv + 1, lc + 1):
                data = db.get("paxos_values", str(v))
                if not data:
                    continue
                try:
                    nm = map_inc.decode_value(data, m, device="cpu")
                    if nm.epoch > m.epoch:
                        m = nm
                except Exception:
                    continue  # service values / stale bases
            print(f"epoch {m.epoch}")
            print(f"max_osd {m.max_osd}")
            up = [i for i in range(m.max_osd) if m.is_up(i)]
            print(f"up osds: {up}")
            for pid, pool in sorted(m.pools.items()):
                print(f"pool {pid} '{pool.name}' pg_num {pool.pg_num} "
                      f"size {pool.size}")
            return 0
        if a.op == "set":
            prefix, key, hexval = a.args[0], a.args[1], a.args[2]
            b = WriteBatch()
            b.set(prefix, key, binascii.unhexlify(hexval))
            db.submit(b, sync=True)
            print("ok")
            return 0
        if a.op == "rm":
            prefix, key = a.args[0], a.args[1]
            b = WriteBatch()
            b.rmkey(prefix, key)
            db.submit(b, sync=True)
            print("ok")
            return 0
    finally:
        db.close()
    return 22


if __name__ == "__main__":
    sys.exit(main())
