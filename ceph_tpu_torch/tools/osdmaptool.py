"""osdmaptool — inspect and optimize OSD maps, on the card.

Port of ``tools/osdmaptool.py``, flag for flag (reference:
src/tools/osdmaptool.cc): --createsimple, --test-map-pgs (per-OSD PG
distribution over the full-pool sweep, one launch of the rule-walk
kernel per pool) and --upmap (emit balancer upmap entries, reference
osdmaptool --upmap over OSDMap::calc_pg_upmaps).  The map walks its
rules on CUDA unless ``--device cpu`` asks for the plain version; the
JSON is the reference tool's.

Example:
  python -m ceph_tpu_torch.tools.osdmaptool --createsimple 1024 \\
      --pg_num 16384 --test-map-pgs
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ceph_tpu_torch.crush import map as cmap
from ceph_tpu_torch.mgr import UpmapBalancer
from ceph_tpu_torch.osd import map_codec
from ceph_tpu_torch.osd.osdmap import (
    CRUSH_ITEM_NONE,
    OSDMap,
    PGPool,
    POOL_REPLICATED,
)


def createsimple(num_osd: int, pg_num: int, device=None) -> OSDMap:
    hosts = max(1, num_osd // 4)
    cm, root = cmap.build_flat_cluster(num_osd, hosts=hosts)
    cm.add_simple_rule("replicated_rule", root, 1, mode="firstn")
    m = OSDMap(cm, max_osd=num_osd, device=device)
    m.add_pool(PGPool(1, POOL_REPLICATED, size=3, min_size=2,
                      pg_num=pg_num, pgp_num=pg_num, crush_rule=0,
                      name="rbd"))
    return m


def test_map_pgs(m: OSDMap, pool_id: int | None) -> dict:
    pools = [pool_id] if pool_id is not None else list(m.pools)
    counts = np.zeros(m.max_osd, dtype=np.int64)
    primaries = np.zeros(m.max_osd, dtype=np.int64)
    total = 0
    for pid in pools:
        sweep = m.map_pgs(pid)
        up = sweep["up"]
        valid = (up != CRUSH_ITEM_NONE) & (up >= 0)
        counts += np.bincount(up[valid], minlength=m.max_osd)
        prim = sweep["up_primary"]
        pv = prim >= 0
        primaries += np.bincount(prim[pv], minlength=m.max_osd)
        total += up.shape[0]
    in_osds = counts[np.asarray(m.osd_weight) > 0]
    return {
        "pool_pgs_examined": total,
        "osd_pg_counts": {f"osd.{i}": int(c)
                          for i, c in enumerate(counts)},
        "primary_counts": {f"osd.{i}": int(c)
                           for i, c in enumerate(primaries)},
        "summary": {
            "min": int(in_osds.min()) if len(in_osds) else 0,
            "max": int(in_osds.max()) if len(in_osds) else 0,
            "avg": round(float(in_osds.mean()), 2) if len(in_osds) else 0,
            "stddev": round(float(in_osds.std()), 2) if len(in_osds)
            else 0,
        },
    }


def do_upmap(m: OSDMap, max_moves: int, deviation: float) -> dict:
    bal = UpmapBalancer(m, max_deviation=deviation, max_moves=max_moves)
    reports = bal.optimize()
    return {
        "upmaps": [
            {"pgid": f"{pgid[0]}.{pgid[1]:x}",
             "mappings": [{"from": f, "to": t} for f, t in pairs]}
            for rep in reports for pgid, pairs in rep.moves
        ],
        "stddev": {f"pool.{rep.pool_id}":
                   {"before": round(rep.before_stddev, 3),
                    "after": round(rep.after_stddev, 3)}
                   for rep in reports},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="osdmaptool")
    p.add_argument("mapfn", nargs="?", help="osdmap file")
    p.add_argument("--createsimple", type=int, metavar="NUM_OSD")
    p.add_argument("--pg_num", type=int, default=128)
    p.add_argument("--test-map-pgs", action="store_true")
    p.add_argument("--pool", type=int)
    p.add_argument("--upmap", action="store_true")
    p.add_argument("--upmap-max", type=int, default=64)
    p.add_argument("--upmap-deviation", type=float, default=1.0)
    p.add_argument("-o", "--outfn")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu (the plain version)")
    args = p.parse_args(argv)

    if args.createsimple:
        m = createsimple(args.createsimple, args.pg_num, args.device)
    elif args.mapfn:
        with open(args.mapfn, "rb") as f:
            m = map_codec.decode_osdmap(f.read(), device=args.device)
    else:
        print("need --createsimple or a map file", file=sys.stderr)
        return 1

    if args.test_map_pgs:
        print(json.dumps(test_map_pgs(m, args.pool), indent=1))
    if args.upmap:
        print(json.dumps(
            do_upmap(m, args.upmap_max, args.upmap_deviation), indent=1))
    out = args.outfn or (args.mapfn if args.createsimple else None)
    if out:
        with open(out, "wb") as f:
            f.write(map_codec.encode_osdmap(m))
        print(f"wrote osdmap to {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
